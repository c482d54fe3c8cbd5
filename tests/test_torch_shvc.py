"""Two-layer SHVC through the port on the CPU, bit-exact, and X3, its
inter-layer upsample.

X3 (``torch_backend/upsample.py``) against the JAX package's gather form
(``tpu/upsample.py::upsample_plane_jit``), its matrix form
(``upsample_plane_mxu``, against chip_smoke.py's yardstick
``upsample_plane_mm``), ``band_matrix`` and its NumPy model
(``model/upsample.py``), at depths 8 to 14, ratios 2x and 1.5x (and the
arbitrary and 3x ratios of tests/test_upsample.py), luma and chroma,
tolerance 0; the CUDA kernel's window plan over ratios from 1x to 8x, and
its tiling modelled in NumPy; ``OPENHEVC_UPSAMPLE``, which the port does
not read.  ``ShvcDecoder`` with each layer on its own
``CudaBackend(device="cpu")`` (the kernels' plain versions, the upsample
on torch tensors) against the encoder's reconstruction of both layers and
the JAX package's ``ShvcDecoder`` (NumPy), every decoded-picture-hash SEI
checked, in cases that mirror tests/test_shvc.py.
"""

import glob
import os
import re
import struct

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from openhevc_tpu.encoder import EncoderConfig
from openhevc_tpu.encoder.shvc import ShvcEncoder
from openhevc_tpu.decoder.shvc import ShvcDecoder as RefShvcDecoder
from openhevc_tpu.model.upsample import (UpsampleInfo, upsample_frame,
                                         upsample_plane as model_plane)
from openhevc_tpu.tpu import upsample as ref_up
from tests.util_e2e import make_source, assert_frames_equal

from openhevc_tpu_torch.decoder.shvc import ShvcDecoder
from openhevc_tpu_torch.torch_backend import CudaBackend
from openhevc_tpu_torch.torch_backend import upsample as x3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RATIOS = [((32, 24), (64, 48)),      # 2x
          ((32, 24), (48, 36)),      # 1.5x
          ((40, 32), (56, 44)),      # arbitrary
          ((24, 16), (72, 48))]      # 3x


# ---------------------------------------------------------------------------
# X3
# ---------------------------------------------------------------------------

def _axis_plans(info, w_src, h_src, w_el, h_el, c_idx, module):
    """The (idx_x, coef_x, idx_y, coef_y) tap plans of one plane: the
    layers' scales from the luma geometry (info), the plane's sizes."""
    ntaps = 8 if c_idx == 0 else 4
    ax = info.add_x if c_idx == 0 else info.add_xc
    ay = info.add_y if c_idx == 0 else info.add_yc
    return (module.plan_axis(w_el, w_src, info.scale_x, ax, ntaps) +
            module.plan_axis(h_el, h_src, info.scale_y, ay, ntaps,
                             v_chroma=c_idx > 0))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("dims", RATIOS, ids=["2x", "1.5x", "arb", "3x"])
def test_x3_upsample_plane_vs_reference(dims, c_idx, bd):
    """One plane: the tap plans equal the reference's, and the upsample
    equals upsample_plane_jit and the NumPy model, including the int16
    wrap of the intermediate that 10-bit inputs reach."""
    (w_bl, h_bl), (w_el, h_el) = dims
    info = UpsampleInfo(w_bl, h_bl, w_el, h_el)
    # chroma planes are half-size but share the luma-derived scales
    sub = 1 if c_idx else 0
    w_bl, h_bl, w_el, h_el = (v >> sub for v in (w_bl, h_bl, w_el, h_el))
    mine = _axis_plans(info, w_bl, h_bl, w_el, h_el, c_idx, x3)
    ref = _axis_plans(info, w_bl, h_bl, w_el, h_el, c_idx, ref_up)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(bd + c_idx + w_el)
    src = rng.integers(0, 1 << bd, (h_bl, w_bl)).astype(np.int32)
    src[0, :4] = (1 << bd) - 1          # extremes that wrap at depth 10
    ix, cx, iy, cy = mine
    got = x3.upsample_plane(torch.as_tensor(src), torch.as_tensor(ix).long(),
                            torch.as_tensor(cx), torch.as_tensor(iy).long(),
                            torch.as_tensor(cy), bit_depth=bd)
    want = np.asarray(ref_up.upsample_plane_jit(
        jnp.asarray(src), *[jnp.asarray(a) for a in ref], bit_depth=bd))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), model_plane(src, w_el, h_el, info, c_idx, bd))


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("dims", RATIOS, ids=["2x", "1.5x", "arb", "3x"])
def test_x3_band_matrix_vs_reference(dims, c_idx):
    """band_matrix equals the reference's on every plane's tap plans."""
    (w_bl, h_bl), (w_el, h_el) = dims
    info = UpsampleInfo(w_bl, h_bl, w_el, h_el)
    sub = 1 if c_idx else 0
    w_bl, h_bl, w_el, h_el = (v >> sub for v in (w_bl, h_bl, w_el, h_el))
    ix, cx, iy, cy = _axis_plans(info, w_bl, h_bl, w_el, h_el, c_idx, x3)
    for idx, coef, n in ((ix, cx, w_bl), (iy, cy, h_bl)):
        got = x3.band_matrix(idx, coef, n)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref_up.band_matrix(idx, coef, n))


def _extreme_source(rng, kind, bd, shape):
    mx = (1 << bd) - 1
    if kind == "max":
        return np.full(shape, mx, np.int32)
    if kind == "alt":                   # 0 / max in a checkerboard
        yy, xx = np.indices(shape)
        return (((yy + xx) & 1) * mx).astype(np.int32)
    return rng.integers(0, mx + 1, shape).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10, 12, 14])
@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("dims", RATIOS, ids=["2x", "1.5x", "arb", "3x"])
def test_x3_mm_vs_mxu_and_gather(dims, c_idx, bd):
    """chip_smoke.upsample_plane_mm (float32 products of the band
    matrices, X3's library yardstick) equals
    the reference's upsample_plane_mxu (bf16 hi/lo products on JAX CPU)
    and the gather form, at depths 8-14, on random, all-maximum and
    alternating 0/maximum sources (the last two drive the int16 wrap)."""
    (w_bl, h_bl), (w_el, h_el) = dims
    info = UpsampleInfo(w_bl, h_bl, w_el, h_el)
    sub = 1 if c_idx else 0
    w_bl, h_bl, w_el, h_el = (v >> sub for v in (w_bl, h_bl, w_el, h_el))
    ix, cx, iy, cy = _axis_plans(info, w_bl, h_bl, w_el, h_el, c_idx, x3)
    mx = x3.band_matrix(ix, cx, w_bl)
    my = np.ascontiguousarray(x3.band_matrix(iy, cy, h_bl).T)
    rng = np.random.default_rng(bd * 7 + c_idx + w_el)
    for kind in ("random", "max", "alt"):
        src = _extreme_source(rng, kind, bd, (h_bl, w_bl))
        got = chip_smoke.upsample_plane_mm(torch.as_tensor(src),
                                           torch.as_tensor(
                                               mx, dtype=torch.float32),
                                           torch.as_tensor(
                                               my, dtype=torch.float32),
                                           bit_depth=bd)
        want = np.asarray(ref_up.upsample_plane_mxu(
            jnp.asarray(src), jnp.asarray(mx, jnp.bfloat16),
            jnp.asarray(my, jnp.bfloat16), bit_depth=bd))
        gather = x3.upsample_plane(
            torch.as_tensor(src), torch.as_tensor(ix), torch.as_tensor(cx),
            torch.as_tensor(iy), torch.as_tensor(cy), bit_depth=bd)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=kind)
        np.testing.assert_array_equal(gather.numpy(), want, err_msg=kind)


def test_x3_mm_refuses_reduced_precision(monkeypatch):
    """The band-matrix form raises rather than run reduced-precision
    float32 products, and sets no global itself."""
    src = torch.zeros((4, 4), dtype=torch.int32)
    m = torch.zeros((4, 8), dtype=torch.float32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full float32"):
        chip_smoke.upsample_plane_mm(src, m, m.T.contiguous())
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            chip_smoke.upsample_plane_mm(src, m, m.T.contiguous())
    finally:
        torch.set_float32_matmul_precision(prev)
    assert torch.get_float32_matmul_precision() == prev


def _window_cases():
    """(BL size, EL size, phase_align): the ratios of the X3 tests, ratios
    from just above 1x to 8x, EL sizes that are no multiple of the tile,
    tiny planes, and phase_align 1."""
    cases = [(bl, el, 0) for bl, el in RATIOS]
    for bl in ((1920, 1080), (640, 360), (96, 48)):
        for num, den in ((65, 64), (9, 8), (4, 3), (3, 2), (5, 3), (2, 1),
                         (7, 3), (8, 3), (3, 1), (4, 1), (8, 1)):
            el = tuple(-(-(v * num // den) // 8) * 8 for v in bl)
            cases.append((bl, el, 0))
    cases += [((16, 8), (24, 16), 0), ((16, 8), (128, 64), 0),
              ((1920, 1080), (3840, 2160), 1), ((960, 544), (1416, 816), 1)]
    return cases


def _layouts():
    """(c_idx, (hs, vs)): luma, and chroma in 4:2:0, 4:2:2 and 4:4:4."""
    return ((0, (0, 0)), (1, (1, 1)), (1, (1, 0)), (1, (0, 0)))


def test_x3_window_plan_covers_every_tap():
    """The kernel's host-side tables: every tap of every TILE x TILE tile
    lies in its tile's window, which the TMA box (at most 256 a side)
    holds from the window's first column rounded down to a multiple of 4
    (a 16-byte boundary, where TMA needs a box to start); the windows are
    no wider than the taps need; the packed taps decode to the tap tables;
    and the kernel's shared memory fits, for luma and the three chroma
    layouts at every case."""
    up = x3.CudaUpsampler()
    for (w_bl, h_bl), (w_el, h_el), pa in _window_cases():
        info = UpsampleInfo(w_bl, h_bl, w_el, h_el, pa)
        if info.is_snr:
            continue
        for c_idx, sub in _layouts():
            sbl = (h_bl >> sub[1], w_bl >> sub[0])
            ix, cx, iy, cy = up.axis_plans(sbl, w_el >> sub[0],
                                           h_el >> sub[1], c_idx, info)
            taps = ix.shape[1]
            host, at, (tiles_y, tiles_x), (box_h, box_w) = \
                x3.kernel_tables(ix, cx, iy, cy)
            assert x3.smem_bytes(box_h, box_w, taps) <= x3.SMEM_MAX
            assert box_w % 4 == 0 and max(box_h, box_w) <= x3.MAX_BOX
            assert (tiles_y, tiles_x) == (-(-iy.shape[0] // x3.TILE),
                                          -(-ix.shape[0] // x3.TILE))
            xt = host[at[0]:at[1]].reshape(tiles_x * x3.TILE, taps)
            yt = host[at[1]:at[2]].reshape(tiles_y * x3.TILE, taps)
            c0 = host[at[2]:at[3]]
            win_y = host[at[3]:].reshape(tiles_y, 2)
            win_x = x3.window_plan(ix)
            np.testing.assert_array_equal(c0, win_x[:, 0] // 4 * 4)
            np.testing.assert_array_equal(win_y, x3.window_plan(iy))
            need = (win_x.sum(1) - c0).max()
            assert need <= box_w < need + 4
            assert win_y[:, 1].max() == box_h
            for idx, coef, tab, win, n_src, step, start in (
                    (ix, cx, xt, win_x, sbl[1], 1, c0),
                    (iy, cy, yt, win_y, sbl[0], x3.TILE, win_y[:, 0])):
                t = np.arange(idx.shape[0]) // x3.TILE
                lo, cnt = win[t, 0][:, None], win[t, 1][:, None]
                assert (idx >= lo).all() and (idx < lo + cnt).all()
                assert (win[:, 0] >= 0).all()
                assert (win[:, 0] + win[:, 1] <= n_src).all()
                for k in range(len(win)):
                    seg = idx[k * x3.TILE:(k + 1) * x3.TILE]
                    assert seg.min() == win[k, 0]
                    assert seg.max() == win[k, 0] + win[k, 1] - 1
                off, c = tab[:len(idx)] >> 16, tab[:len(idx)].astype(np.int16)
                np.testing.assert_array_equal(off, (idx - start[t][:, None])
                                              * step)
                np.testing.assert_array_equal(c, coef)


# csrc/upsample.cu X3Plane's fields after its tensor map, as _PLANE packs
# them, and X3Frame's after its planes
PLANE_FIELDS = ("src", "out", "xtab", "ytab", "wx", "wy", "h_bl", "w_bl",
                "h_el", "w_el", "taps", "tiles_x", "first_tile", "box_w",
                "box_h", "tma")
FRAME_FIELDS = ("n_planes", "n_tiles", "max_val")


def _frame_fields(desc):
    """pack_frame's bytes, read back as the kernel reads them."""
    n_planes, n_tiles, max_val = x3._TAIL.unpack_from(
        desc, x3.MAX_PLANES * x3._PLANE.size)
    planes = [dict(zip(PLANE_FIELDS,
                       x3._PLANE.unpack_from(desc, k * x3._PLANE.size)))
              for k in range(n_planes)]
    return planes, n_tiles, max_val


def _block_tile(planes, b):
    """The kernel's block b -> (plane, tile row, tile column)."""
    pi = 0
    while pi + 1 < len(planes) and b >= planes[pi + 1]["first_tile"]:
        pi += 1
    P = planes[pi]
    ty, tx = divmod(b - P["first_tile"], P["tiles_x"])
    return pi, ty, tx


def _kernel_model(fplan, srcs, bd):
    """The kernel's loops in NumPy, block by block, from the frame
    descriptor and the packed tables its pointers name: the block's plane
    and tile; the TMA box at (r0, c0), zeros beyond the plane; the
    horizontal pass a tile column at a time, wrapped and kept as int16;
    the vertical pass by strips of 4 columns, rows 16 apart, each sample
    written once.  Checks the kernel's indexing on the CPU; its
    arithmetic is the gather form's."""
    planes, n_tiles, _ = _frame_fields(fplan.desc)
    outs = [np.full((P["h_el"], P["w_el"]), -1, np.int64) for P in planes]
    written = [np.zeros(o.shape, np.int64) for o in outs]
    T_ = x3.TILE
    for b in range(n_tiles):
        pi, ty, tx = _block_tile(planes, b)
        P, kp, src = planes[pi], fplan.planes[pi][4], srcs[pi]
        tab = kp.tab.numpy()

        def el(ptr):
            return (ptr - kp.tab.data_ptr()) // 4
        T, bw, bh = P["taps"], P["box_w"], P["box_h"]
        c0 = tab[el(P["wx"]) + tx]
        r0, nr = tab[el(P["wy"]) + 2 * ty:el(P["wy"]) + 2 * ty + 2]
        assert nr <= bh
        S = np.zeros((bh, bw), np.int64)
        box = src[r0:r0 + bh, c0:c0 + bw]
        S[:box.shape[0], :box.shape[1]] = box
        xt = tab[el(P["xtab"]) + tx * T_ * T:][:T_ * T].reshape(T_, T)
        ox, cx = xt >> 16, xt.astype(np.int16).astype(np.int64)
        assert (c0 + ox < P["w_bl"]).all()      # never a zero of the box
        M = (S[:nr][:, ox] * cx[None]).sum(-1)
        M = ((M + 0x8000) & 0xFFFF) - 0x8000    # kept as int16
        Mflat = M.ravel()
        yt = tab[el(P["ytab"]) + ty * T_ * T:][:T_ * T].reshape(T_, T)
        oy, cy = yt >> 16, yt.astype(np.int16).astype(np.int64)
        for st in range(T_ // 4):
            gx = tx * T_ + 4 * st
            if gx >= P["w_el"]:
                continue
            cols = 4 * st + np.arange(4)
            for yy in range(T_):            # rows g + 16 j of the strip
                gy = ty * T_ + yy
                if gy >= P["h_el"]:
                    break
                at = oy[yy][:, None] + cols[None, :]
                assert (at < nr * T_).all()
                acc = (cy[yy][:, None] * Mflat[at]).sum(0)
                v = np.clip((acc + x3.I_OFFSET) >> x3.N_SHIFT, 0,
                            (1 << bd) - 1)
                n = min(4, P["w_el"] - gx)
                outs[pi][gy, gx:gx + n] = v[:n]
                written[pi][gy, gx:gx + n] += 1
    for w in written:
        assert (w == 1).all()
    return outs


@pytest.mark.parametrize("bd", [8, 14])
@pytest.mark.parametrize("dims", [((72, 40), (144, 80)),     # 2x
                                  ((96, 48), (144, 72)),     # 1.5x
                                  ((80, 56), (136, 88))],    # arbitrary
                         ids=["2x", "1.5x", "arb"])
def test_x3_kernel_tiling_model(dims, bd):
    """The kernel's tile list, windows, strips and int16 intermediate,
    modelled on the CPU over a whole 4:2:0 picture (one launch), equal the
    gather form on EL planes that are no multiple of the tile, extreme
    inputs included; and so does the kernel's wrapper on CPU tensors."""
    (w_bl, h_bl), (w_el, h_el) = dims
    up = x3.CudaUpsampler()
    rng = np.random.default_rng(bd + w_el)
    shapes = [(h_bl, w_bl)] + [(h_bl // 2, w_bl // 2)] * 2
    for kind in ("random", "max", "alt"):
        srcs = [_extreme_source(rng, kind, bd, s) for s in shapes]
        planes, fplan = up._planes([torch.as_tensor(p) for p in srcs],
                                   w_el, h_el, 1, 0)
        want = [x3.upsample_plane(p, *plan[:4], bit_depth=bd).numpy()
                for p, plan in zip(planes, fplan.planes)]
        got = _kernel_model(fplan, [p.astype(np.int64) for p in srcs], bd)
        wrapped = x3.upsample_frame_x3(planes, fplan, bit_depth=bd)
        for c in range(3):
            np.testing.assert_array_equal(got[c], want[c],
                                          err_msg=f"{c} {kind}")
            np.testing.assert_array_equal(wrapped[c].numpy(), want[c])


def test_x3_tile_list_covers_every_sample_once():
    """The frame descriptor's blocks map one to one onto the TILE x TILE
    tiles of every plane, luma first, whose rectangles partition each EL
    plane: every output sample of every plane lies in exactly one block,
    at every case in 4:2:0, 4:2:2 and 4:4:4."""
    up = x3.CudaUpsampler()
    for (w_bl, h_bl), (w_el, h_el), pa in _window_cases():
        for cfmt in (1, 2, 3):
            hs, vs = (1 if cfmt in (1, 2) else 0), (1 if cfmt == 1 else 0)
            shapes = ((h_bl, w_bl),) + ((h_bl >> vs, w_bl >> hs),) * 2
            fplan = up._frame(shapes, w_el, h_el, cfmt, pa,
                              torch.device("cpu"))
            if fplan is None:
                assert UpsampleInfo(w_bl, h_bl, w_el, h_el, pa).is_snr
                continue
            planes, n_tiles, _ = _frame_fields(fplan.desc)
            assert n_tiles == fplan.n_tiles and len(planes) == 3
            assert [(P["h_el"], P["w_el"]) for P in planes] == [
                (h_el, w_el)] + [(h_el >> vs, w_el >> hs)] * 2
            assert [P["taps"] for P in planes] == [8, 4, 4]
            seen = [set() for _ in planes]
            for b in range(n_tiles):
                pi, ty, tx = _block_tile(planes, b)
                assert (ty, tx) not in seen[pi]
                seen[pi].add((ty, tx))
            for P, tiles in zip(planes, seen):
                ty_n = -(-P["h_el"] // x3.TILE)
                tx_n = -(-P["w_el"] // x3.TILE)
                assert tiles == {(a, c) for a in range(ty_n)
                                 for c in range(tx_n)}
                for n, k in ((P["h_el"], ty_n), (P["w_el"], tx_n)):
                    cover = np.concatenate([
                        np.arange(t * x3.TILE, min(n, (t + 1) * x3.TILE))
                        for t in range(k)])
                    np.testing.assert_array_equal(cover, np.arange(n))


def test_x3_plan_built_once_per_geometry(monkeypatch):
    """CudaUpsampler builds the tap tables, kernel tables and frame
    descriptor once per geometry and device: the U and V planes share one
    plane plan, a second picture reuses everything (no plan_axis call),
    and a new geometry builds its own."""
    calls = []
    inner = x3.plan_axis

    def counted(*a, **kw):
        calls.append(a)
        return inner(*a, **kw)
    monkeypatch.setattr(x3, "plan_axis", counted)
    up = x3.CudaUpsampler()
    rng = np.random.default_rng(3)
    bl = [torch.as_tensor(rng.integers(0, 256, s).astype(np.int32))
          for s in ((40, 72), (20, 36), (20, 36))]
    first = up.upsample_frame(bl, 144, 80)
    assert len(calls) == 4 and len(up._plans) == 2 and len(up._frames) == 1
    plans = up.frame_plans(bl, 144, 80)
    second = up.upsample_frame(bl, 144, 80)
    assert len(calls) == 4 and len(up._frames) == 1
    assert all(a[1] is b[1] for a, b in zip(plans,
                                            up.frame_plans(bl, 144, 80)))
    assert plans[1][1] is plans[2][1]           # U and V: one plan
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    up.upsample_frame(bl, 108, 60)
    assert len(calls) == 8 and len(up._plans) == 4 and len(up._frames) == 2
    up.upsample_frame(bl, 144, 80, phase_align_flag=1)
    assert len(calls) == 12 and len(up._frames) == 3


def _c_layout(src, name):
    """[(field, offset)] and sizeof of struct ``name`` in ``src``, by the
    C layout rules for its member types (CUtensorMap: 128 bytes, aligned
    to 64; pointers 8; int 4; X3Plane arrays)."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    kinds = {"CUtensorMap": (128, 64), "int": (4, 4), "ptr": (8, 8)}
    if name == "X3Frame":
        kinds["X3Plane"] = _c_layout(src, "X3Plane")[1:]
    fields, at, align = [], 0, 1
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(?:const )?(\w+)(\*?) (.+);", line)
        for decl in m.group(3).split(","):
            decl = decl.strip()
            count = 1
            arr = re.fullmatch(r"(\w+)\[(\w+)\]", decl)
            if arr:
                decl, count = arr.group(1), x3.MAX_PLANES
                assert arr.group(2) == "kMaxPlanes"
            size, al = kinds["ptr" if m.group(2) else m.group(1)]
            at = -(-at // al) * al
            fields.append((decl, at))
            at += size * count
            align = max(align, al)
    return fields, -(-at // align) * align, align


def test_x3_frame_descriptor_matches_the_c_structs():
    """_PLANE and _FRAME_SIZE, the bytes pack_frame writes and the
    launcher's ohk_upsample_frame_size (which cuda_lib.check_size holds
    them to on the card), follow csrc/upsample.cu's X3Plane and X3Frame
    field by field; and a picture's descriptor holds its planes' tables
    and geometry."""
    with open(os.path.join(ROOT, "openhevc_tpu_torch", "csrc",
                           "upsample.cu")) as f:
        src = f.read()
    plane, plane_size, _ = _c_layout(src, "X3Plane")
    frame, frame_size, _ = _c_layout(src, "X3Frame")
    assert plane_size == x3._PLANE.size and frame_size == x3._FRAME_SIZE
    assert [n for n, _ in plane] == ["map"] + list(PLANE_FIELDS)
    assert [n for n, _ in frame] == ["p"] + list(FRAME_FIELDS)
    types = "P" * 6 + "i" * 10
    assert x3._PLANE.format == f"@128x{types[:6]}{types[6:]}40x".replace(
        "PPPPPP", "6P").replace("iiiiiiiiii", "10i")
    assert [o for _, o in plane] == [0] + [
        struct.calcsize("@128x" + types[:k + 1]) - struct.calcsize(types[k])
        for k in range(len(types))]
    assert [o for _, o in frame] == [0] + [
        x3.MAX_PLANES * x3._PLANE.size + 4 * k for k in range(3)]
    assert dict(plane)["src"] == 128            # where _SRC_OUT writes
    up = x3.CudaUpsampler()
    bl = [torch.zeros(s, dtype=torch.int32)
          for s in ((40, 72), (20, 36), (20, 36))]
    planes, fplan = up._planes(bl, 144, 80, 1, 0)
    assert len(fplan.desc) == x3._FRAME_SIZE
    fields, n_tiles, max_val = _frame_fields(fplan.desc)
    assert (n_tiles, max_val) == (3 * 2 + 2 * 2 * 1, 0)
    for P, (p, plan) in zip(fields, zip(planes, fplan.planes)):
        kp = plan[4]
        base = kp.tab.data_ptr()
        assert [P[k] for k in ("xtab", "ytab", "wx", "wy")] == [
            base + 4 * a for a in kp.at]
        assert (P["src"], P["out"], P["tma"]) == (0, 0, 0)
        assert (P["h_bl"], P["w_bl"]) == tuple(p.shape) == kp.shape_bl
        assert (P["h_el"], P["w_el"]) == kp.shape_el
        assert (P["box_h"], P["box_w"], P["taps"]) == kp.box + (kp.taps,)
    assert [P["first_tile"] for P in fields] == [0, 6, 8]


def test_x3_path_follows_openhevc_upsample(monkeypatch):
    """The reference's TpuUpsampler reads OPENHEVC_UPSAMPLE ("mxu" and
    "gather" by name, else its backend's default); the port departs from
    it by design and reads nothing: CudaUpsampler always takes X3's
    kernel (its plain version on the CPU), so its frames are the same
    whatever the variable says and equal the gather form run on the
    kernel's own int32 tables."""
    for env in ("mxu", "gather"):
        monkeypatch.setenv("OPENHEVC_UPSAMPLE", env)
        assert ref_up.TpuUpsampler().path == env
    rng = np.random.default_rng(5)
    bl = [torch.as_tensor(rng.integers(0, 1024, s).astype(np.int32))
          for s in ((24, 32), (12, 16), (12, 16))]
    outs = []
    for env in (None, "", "mxu", "gather", "bogus"):
        if env is None:
            monkeypatch.delenv("OPENHEVC_UPSAMPLE", raising=False)
        else:
            monkeypatch.setenv("OPENHEVC_UPSAMPLE", env)
        up = x3.CudaUpsampler()
        assert not hasattr(up, "path")
        outs.append(up.upsample_frame(bl, 48, 36, bit_depth=10))
    plans = up.frame_plans(bl, 48, 36)
    want = [x3.upsample_plane(p, *plan[:4], bit_depth=10)
            for p, plan in plans]
    for p, plan in plans:
        assert all(t.dtype == torch.int32 for t in plan[:4] + (plan[4].tab,))
    for got in outs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bd", [8, 10])
def test_x3_upsample_frame_vs_model(bd):
    """Whole 4:2:0 frames at every ratio, and SNR (same size) passing the
    planes through, against model/upsample.py::upsample_frame."""
    rng = np.random.default_rng(11 + bd)
    up = x3.CudaUpsampler()
    for (w_bl, h_bl), (w_el, h_el) in RATIOS + [((32, 24), (32, 24))]:
        bl = [rng.integers(0, 1 << bd, s).astype(np.int32)
              for s in ((h_bl, w_bl), (h_bl // 2, w_bl // 2),
                        (h_bl // 2, w_bl // 2))]
        got = up.upsample_frame([torch.as_tensor(p) for p in bl], w_el, h_el,
                                bit_depth=bd)
        want = upsample_frame(bl, w_el, h_el, bit_depth=bd)
        for c in range(3):
            assert got[c].dtype == torch.int32
            np.testing.assert_array_equal(got[c].numpy(), want[c])


# ---------------------------------------------------------------------------
# ShvcDecoder
# ---------------------------------------------------------------------------

def _encode(cfg_bl, cfg_el, pattern="IPPP", seed=42):
    enc = ShvcEncoder(cfg_bl, cfg_el)
    stream = b"".join(enc.parameter_set_nals())
    rng = np.random.default_rng(seed)
    src_bl = make_source(rng, cfg_bl.width, cfg_bl.height, cfg_bl.bit_depth)
    src_el = make_source(rng, cfg_el.width, cfg_el.height, cfg_el.bit_depth)
    bl_recons, el_recons = [], []
    for i, t in enumerate(pattern):
        sb = [np.roll(p, i, 0) for p in src_bl]
        se = [np.roll(p, i, 1) for p in src_el]
        au, rb, re = enc.encode_frame(sb, se, t)
        stream += au
        bl_recons.append([np.asarray(p).astype(np.int32) for p in rb])
        el_recons.append([np.asarray(p).astype(np.int32) for p in re])
    return stream, bl_recons, el_recons


def _planes(frames):
    return [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
            for f in frames]


def _cpu_layers():
    return CudaBackend(device="cpu")


def _cfgs(bl, el, **kw):
    return (EncoderConfig(width=bl[0], height=bl[1], qp=bl[2],
                          rng_seed=bl[3], **kw),
            EncoderConfig(width=el[0], height=el[1], qp=el[2],
                          rng_seed=el[3], **kw))


# (name, (BL w, h, qp, seed), (EL ...), pattern, extra config)
CASES = [
    ("x2_spatial", (48, 32, 30, 7), (96, 64, 30, 11), "IPPP", {}),
    ("x1_5_spatial", (64, 32, 31, 3), (96, 48, 29, 5), "IPPP", {}),
    ("snr", (64, 48, 34, 13), (64, 48, 26, 17), "IPPP", {}),
    ("bframes", (48, 32, 30, 19), (96, 64, 30, 23), "IPBPB", {}),
    ("tmvp_through_il_ref", (48, 32, 30, 29), (96, 64, 30, 31), "IPPPP",
     dict(temporal_mvp=True)),
    ("main10", (48, 32, 30, 37), (96, 64, 30, 41), "IPP",
     dict(bit_depth=10)),
]


@pytest.mark.parametrize("name,bl,el,pattern,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_port_shvc_matches_reference(name, bl, el, pattern, kw,
                                     monkeypatch):
    """Both layers on their own CPU CudaBackend, the inter-layer upsample
    on torch tensors: equal to the encoder's reconstruction and to the
    reference's two-layer decoder, every MD5 of both layers passing."""
    cfg_bl, cfg_el = _cfgs(bl, el, **kw)
    stream, bl_recons, el_recons = _encode(cfg_bl, cfg_el, pattern)
    calls = []
    inner = x3.CudaUpsampler.upsample_frame

    def counted(self, planes, *a, **k):
        calls.append(all(isinstance(p, torch.Tensor) for p in planes))
        return inner(self, planes, *a, **k)
    monkeypatch.setattr(x3.CudaUpsampler, "upsample_frame", counted)
    dec = ShvcDecoder(backend=_cpu_layers, check_md5=True)
    outs = dec.decode_stream(stream)
    n = len(pattern)
    assert dec.md5_ok == 6 * n and dec.md5_fail == 0
    assert isinstance(outs[0][0].planes[0], torch.Tensor)
    assert calls and all(calls)     # the EL pictures' IL references
    mine_bl, mine_el = _planes(outs[0]), _planes(outs[1])
    assert_frames_equal(mine_bl, bl_recons, f"{name}: BL port-vs-recon")
    assert_frames_equal(mine_el, el_recons, f"{name}: EL port-vs-recon")
    ref = RefShvcDecoder(check_md5=True).decode_stream(stream)
    assert_frames_equal(mine_el, [[np.asarray(p) for p in f.planes]
                                  for f in ref[1]], f"{name}: EL port-vs-ref")
    assert_frames_equal(mine_bl, [[np.asarray(p) for p in f.planes]
                                  for f in ref[0]], f"{name}: BL port-vs-ref")


@pytest.mark.parametrize("backend", ["numpy", "el_only"])
def test_port_shvc_other_backends(backend):
    """backend="numpy" reconstructs both layers on the host (NumPy
    upsample); a backend object keeps the reference's meaning, the EL on
    it and the BL on the host."""
    cfg_bl, cfg_el = _cfgs((48, 32, 30, 7), (96, 64, 30, 11))
    stream, bl_recons, el_recons = _encode(cfg_bl, cfg_el, "IPP")
    be = "numpy" if backend == "numpy" else CudaBackend(device="cpu")
    dec = ShvcDecoder(backend=be, check_md5=True)
    outs = dec.decode_stream(stream)
    assert dec.md5_ok == 18 and dec.md5_fail == 0
    assert dec.decoders[0].backend is None
    assert dec.decoders[1].backend is (None if backend == "numpy" else be)
    assert_frames_equal(_planes(outs[0]), bl_recons, "BL")
    assert_frames_equal(_planes(outs[1]), el_recons, "EL")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_port_shvc_default_needs_the_card():
    """ShvcDecoder() puts both layers on the card: without one it raises,
    it does not fall back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShvcDecoder()


@pytest.mark.slow
def test_shvc_bench_stream_cpu():
    """The committed SHVC bench stream, both layers (1080p base, 4K
    enhancement, 4 pictures each) through the port's CPU path: every MD5
    of both layers passes."""
    (path,) = glob.glob(os.path.join(ROOT, "streams",
                                     "bench_shvc_4k60_*.265"))
    with open(path, "rb") as f:
        data = f.read()
    dec = ShvcDecoder(backend=_cpu_layers, check_md5=True)
    outs = dec.decode_stream(data)
    assert [len(o) for o in outs] == [4, 4]
    assert dec.md5_ok == 24 and dec.md5_fail == 0
    assert [tuple(p.shape) for p in outs[1][0].host_planes()] == \
        [(2160, 3840), (1080, 1920), (1080, 1920)]
