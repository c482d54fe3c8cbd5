"""The port's kernel modules against the JAX package, bit-exact.

Each kernel's plain PyTorch version (what a CPU tensor runs) is held
against the reference's Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU, and against the reference's XLA
path or scalar model.  The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py).  Tolerance is 0 everywhere: the pipeline is
integer.
"""

import struct

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openhevc_tpu.tpu import intra_pallas as ip
from openhevc_tpu.tpu import filter_pallas as fp
from openhevc_tpu.tpu import residual as ref_residual
from openhevc_tpu.tpu import sao as ref_sao
from openhevc_tpu.tpu.mc import mc_batch
from openhevc_tpu.tpu.mc_pallas import (mc_batch_pallas, pad_refs,
                                        clamp_starts, band_paint,
                                        band_pad_shape)

from openhevc_tpu_torch.torch_backend import filter as flt
from openhevc_tpu_torch.torch_backend import intra, paint, residual
from openhevc_tpu_torch.torch_backend import mc as tmc
from openhevc_tpu_torch.torch_backend.plan_compile import TILE_SIZES
from openhevc_tpu.encoder import EncoderConfig

_QP_C = [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37]


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# K1 intra
# ---------------------------------------------------------------------------

class _Op:
    pass


def _mk(x, y, n, mode, flg, c_idx=0):
    op = _Op()
    op.c_idx = c_idx
    op.x, op.y, op.size, op.mode = x, y, n, mode
    (op.cand_bottom_left, op.cand_left, op.cand_up_left, op.cand_up,
     op.cand_up_right) = flg
    return op


def _k1_pallas(plane, resid, ops, H, W, bd, strong, c444, c_idx):
    meta = ip.build_meta(ops, c_idx, c444)
    return np.asarray(ip.intra_seq(
        jnp.asarray(plane), jnp.asarray(resid), jnp.asarray(meta),
        H, W, min(c_idx, 1), bd, strong, c444, interpret=True)), meta


def _k1_cases():
    rng = np.random.default_rng(1)
    mixed = [(0, 0, 8, 0, (0, 0, 0, 0, 0)), (8, 0, 8, 26, (0, 1, 0, 0, 0)),
             (16, 16, 16, 11, (1, 1, 1, 1, 0)),
             (16, 32, 4, 30, (1, 1, 1, 1, 1)),
             (88, 56, 8, 1, (0, 1, 1, 1, 1)),
             (32, 0, 32, 14, (0, 1, 0, 0, 0)),
             (0, 32, 32, 0, (1, 0, 1, 1, 1)),
             (64, 32, 32, 2, (0, 1, 1, 1, 0)),
             (20, 32, 4, 8, (0, 1, 1, 1, 0)),
             (64, 0, 16, 33, (0, 1, 0, 0, 0)),
             (80, 16, 16, 10, (0, 1, 1, 1, 0)),
             (48, 16, 8, 18, (1, 1, 1, 1, 1))]
    yield "mixed", 64, 96, 8, False, 0, [_mk(*c) for c in mixed]
    modes = rng.integers(0, 35, (4, 6))
    dense = [_mk(bx * 8, by * 8, 8, int(modes[by, bx]),
                 (int(by < 3 and bx > 0), int(bx > 0), int(bx > 0 and by > 0),
                  int(by > 0), int(by > 0 and bx < 5)))
             for by in range(4) for bx in range(6)]
    yield "dense_edges", 32, 48, 8, False, 0, dense
    chroma = [_mk(x, y, n, m, f, c_idx=1) for (x, y, n, m, f) in
              ((0, 0, 8, 1, (0, 0, 0, 0, 0)), (8, 0, 8, 10, (0, 1, 0, 0, 0)),
               (0, 8, 16, 34, (0, 0, 1, 1, 1)), (16, 8, 4, 2, (1, 1, 1, 1, 1)),
               (28, 28, 4, 26, (0, 1, 1, 1, 0)))]
    yield "chroma", 32, 32, 8, False, 1, chroma
    strong = [_mk(32, 32, 32, 30, (0, 1, 1, 1, 0)),
              _mk(64, 32, 32, 0, (0, 1, 1, 1, 0))]
    yield "strong_10bit", 64, 128, 10, True, 0, strong


@pytest.mark.parametrize("case", list(_k1_cases()), ids=lambda c: c[0])
def test_k1_intra_plain_vs_pallas(case, monkeypatch):
    monkeypatch.setattr(ip, "CHUNK", 16)
    name, H, W, bd, strong, c_idx, ops = case
    rng = np.random.default_rng(len(ops))
    plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    resid = rng.integers(-30, 30, (H, W)).astype(np.int32)
    if strong:
        plane[31, :] = np.linspace(100, 200, W).astype(np.int32)
    want, meta = _k1_pallas(plane, resid, ops, H, W, bd, strong, False,
                            c_idx)
    (got,), errors = intra.intra_planes([_t(plane)], [_t(resid)], [_t(meta)],
                                        [min(c_idx, 1)], bd, strong, False)
    assert errors is None           # the plain version has no error word
    np.testing.assert_array_equal(got.numpy(), want)


def test_k1_build_meta_matches_reference(monkeypatch):
    ops = [_mk(x, y, n, m, f, c) for (x, y, n, m, f, c) in
           ((0, 0, 8, 0, (0, 0, 0, 0, 0), 0), (8, 0, 16, 26, (1, 1, 0, 0, 1), 0),
            (4, 4, 4, 18, (1, 1, 1, 1, 1), 1), (0, 8, 32, 2, (0, 1, 1, 1, 0), 0),
            (16, 0, 32, 34, (0, 1, 0, 1, 1), 0))]
    for c444 in (False, True):
        for c_idx in (0, 1):
            for smooth_off in (False, True):
                want = ip.build_meta(ops, c_idx, c444, smooth_off)
                got = intra.build_meta(ops, c_idx, c444, smooth_off)
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# K1's wavefront schedule (intra_schedule): the CUDA kernel rebuilds blocks
# as their dependencies complete, so any order that respects the levels
# must give the sequential result
# ---------------------------------------------------------------------------

class _PlanRecorder:
    """Backend stand-in: records the plans, reconstructs on the CPU."""

    wire_fmt = None

    def __init__(self):
        from openhevc_tpu_torch.torch_backend import CudaBackend
        self.inner = CudaBackend(device="cpu")
        self.plans = []

    def decode_frame(self, plan, dpb):
        self.plans.append(plan)
        return self.inner.decode_frame(plan, dpb)


def _encoder_metas(cfg, pattern, seed):
    """(c_idx, H, W, meta) of every frame's intra planes in an encoder-made
    stream, packed as CudaBackend packs them."""
    from openhevc_tpu.encoder import Encoder
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.torch_backend import CudaBackend
    from tests.util_e2e import make_source
    rng = np.random.default_rng(seed)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, cfg.width, cfg.height)
    for i, st in enumerate(pattern):
        src = [np.roll(np.roll(base[0], i, 0), 2 * i, 1),
               np.roll(base[1], i, 0), np.roll(base[2], i, 0)]
        stream += enc.encode_frame(src, st)[0]
    rec = _PlanRecorder()
    Decoder(backend=rec, check_md5=True).decode_stream(stream)
    packer = CudaBackend(device="cpu")
    out = []
    for plan in rec.plans:
        _plan, host, prof, _refs = packer.prepare_host(plan)
        for (c, _bands) in prof["ipal"]:
            sh = 1 if c else 0
            out.append((min(c, 1), plan.height >> sh, plan.width >> sh,
                        host[("ipal", c, 0)]))
    return out


def _dense_edges_ops(valid_order):
    """The dense_edges case: 6x4 blocks of 8x8 in raster order.  As written
    above, its bottom-left flags name blocks that come later in raster
    order; valid_order clears them (raster order never has them)."""
    (_name, H, W, bd, strong, c_idx, ops), = [
        c for c in _k1_cases() if c[0] == "dense_edges"]
    if valid_order:
        for op in ops:
            op.cand_bottom_left = 0
    return H, W, bd, strong, c_idx, ops


def _k1_level_cases():
    yield "enc_I_128x64", lambda: _encoder_metas(
        EncoderConfig(width=128, height=64, qp=30, log2_ctb=6,
                      rng_seed=41), "I", 1)
    yield "enc_IP_192x128", lambda: _encoder_metas(
        EncoderConfig(width=192, height=128, qp=32, log2_ctb=6,
                      p_intra_in_inter=0.5, rng_seed=43), "IP", 2)

    def dense():
        H, W, bd, strong, c_idx, ops = _dense_edges_ops(True)
        return [(c_idx, H, W, ip.build_meta(ops, c_idx, False))]
    yield "dense_edges_raster", dense


@pytest.mark.parametrize("case", list(_k1_level_cases()),
                         ids=lambda c: c[0])
def test_k1_level_order_matches_sequential(case, monkeypatch):
    """Each block's step (intra_block_plain_) run in intra_schedule's level
    order, reversed inside each level, equals the sequential plain version
    and the Pallas kernel in interpret mode."""
    monkeypatch.setattr(ip, "CHUNK", 16)
    name, make = case
    planes = make()
    assert planes, name
    rng = np.random.default_rng(len(name))
    for c_idx, H, W, meta in planes:
        plane = rng.integers(0, 256, (H, W)).astype(np.int32)
        resid = rng.integers(-30, 30, (H, W)).astype(np.int32)
        level = intra.intra_schedule(meta, H, W, c_idx)
        rows = meta.reshape(-1, intra.NF)
        assert (level >= 0).sum() == (rows[:, 7] != 0).sum()
        order = sorted(np.nonzero(level >= 0)[0],
                       key=lambda b: (level[b], -b))
        out = _t(plane).clone()
        res = _t(resid).to(torch.int64)
        for b in order:
            intra.intra_block_plain_(out, res, rows[b].tolist(), c_idx, 8,
                                     True, False)
        seq = intra.intra_plane_plain(_t(plane), _t(resid), _t(meta), c_idx,
                                      8, True, False)
        want = np.asarray(ip.intra_seq(
            jnp.asarray(plane), jnp.asarray(resid),
            jnp.asarray(rows.reshape(-1, 16, intra.NF)), H, W, c_idx, 8,
            True, False, interpret=True))
        np.testing.assert_array_equal(out.numpy(), seq.numpy())
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("case", ["forward_dense_edges", "overlap"])
def test_k1_schedule_rejects(case):
    """Metadata the wavefront cannot schedule: dense_edges as written
    (bottom-left flags on later blocks), and two blocks writing one 4x4
    unit.  The sequential plain version still gives the reference's
    result for both; intra_schedule, like the kernel, refuses them."""
    H, W, bd, strong, c_idx, ops = _dense_edges_ops(case == "overlap")
    if case == "overlap":
        ops = ops + [_mk(4, 8, 8, 10, (0, 1, 1, 1, 0))]
    meta = ip.build_meta(ops, c_idx, False)
    msg = "later block" if case != "overlap" else "one 4x4 unit"
    with pytest.raises(ValueError, match=msg):
        intra.intra_schedule(meta, H, W, c_idx)


# ---------------------------------------------------------------------------
# K2 MC
# ---------------------------------------------------------------------------

def _mc_inputs(rng, w, h, is_luma, far, n=9, H=72, W=96, R=2):
    refs = rng.integers(0, 256, (R, H, W)).astype(np.int32)
    xs = (rng.integers(0, W // w, n) * w).astype(np.int32)
    ys = (rng.integers(0, H // h, n) * h).astype(np.int32)
    fbits = 2 if is_luma else 3
    lim = 4000 if far else 6
    mvx = rng.integers(-lim << fbits, lim << fbits, n).astype(np.int32)
    mvy = rng.integers(-lim << fbits, lim << fbits, n).astype(np.int32)
    sel = rng.integers(0, R, n).astype(np.int32)
    return refs, sel, xs, ys, mvx, mvy


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("is_luma", [True, False])
def test_k2_mc_plain_vs_xla(is_luma, far):
    """Every tile size, motion vectors up to 4000 samples outside the
    picture: per-pixel clamping (tpu/mc.py::mc_batch, the spec's edge
    emulation)."""
    rng = np.random.default_rng(7 + is_luma + 2 * far)
    for (w, h) in TILE_SIZES:
        if not is_luma:
            w, h = w // 2, h // 2
        refs, sel, xs, ys, mvx, mvy = _mc_inputs(rng, w, h, is_luma, far)
        want = np.asarray(mc_batch(jnp.asarray(refs), jnp.asarray(sel),
                                   jnp.asarray(xs), jnp.asarray(ys),
                                   jnp.asarray(mvx), jnp.asarray(mvy), w, h,
                                   is_luma, 8))
        got = tmc.mc(_t(refs), *[_t(a) for a in (sel, xs, ys, mvx, mvy)],
                     w, h, is_luma, 8)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{w}x{h}")


@pytest.mark.parametrize("is_luma", [True, False])
def test_k2_mc_plain_vs_pallas(is_luma):
    """Against the Pallas kernel in interpret mode: every tile size with
    motion inside its 32-sample replicate border, and the 16/8/4-wide
    tiles (windows of at most 32 samples) with far-out vectors too.  The
    Pallas kernel clamps its window origin to the border, which differs
    from per-pixel clamping for 32/64-wide windows that start more than
    32 samples outside (ROADMAP.md section 3); the port follows the spec."""
    rng = np.random.default_rng(11 + is_luma)
    for (w, h) in TILE_SIZES:
        if not is_luma:
            w, h = w // 2, h // 2
        fars = (False, True) if (w + 7 <= 32 and h + 7 <= 32) else (False,)
        for far in fars:
            refs, sel, xs, ys, mvx, mvy = _mc_inputs(rng, w, h, is_luma, far,
                                                     n=5)
            sy, sx, ro, co, fx, fy = clamp_starts(
                jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(mvx),
                jnp.asarray(mvy), w, h, refs.shape[2], refs.shape[1],
                is_luma, 32)
            want = np.asarray(mc_batch_pallas(
                pad_refs(jnp.asarray(refs), 32), jnp.asarray(sel), sy, sx,
                ro, co, fx, fy, w, h, is_luma, 8, interpret=True))
            got = tmc.mc(_t(refs), *[_t(a) for a in (sel, xs, ys, mvx, mvy)],
                         w, h, is_luma, 8)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{w}x{h} far={far}")


def _mc_mixed_pass(rng, far, bd=8, n=7, H=72, W=96, R=2):
    """One frame's pass: every tile size on the luma plane and both 4:2:0
    chroma planes, the chroma groups sharing the luma work vectors
    (shifted on the device), as frame_step builds it."""
    refs = [rng.integers(0, 1 << bd, (R, h, w)).astype(np.int32)
            for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    groups = []
    for (w, h) in TILE_SIZES:
        _, sel, xs, ys, mvx, mvy = _mc_inputs(rng, w, h, True, far, n=n,
                                              H=H, W=W, R=R)
        vecs = [_t(a) for a in (sel, xs, ys, mvx, mvy)]
        for c in range(3):
            s_ = 1 if c else 0
            groups.append(tmc.McGroup(_t(refs[c]), *vecs, w >> s_, h >> s_,
                                      c == 0, bd, 1, 1, s_, s_))
    return refs, groups


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("far", [False, True])
def test_k2_mc_pass_plain_vs_xla(far, bd):
    """mc_pass_plain over a mixed pass (18 groups) equals each group
    through mc_plain and through the XLA mc_batch."""
    rng = np.random.default_rng(31 + far + bd)
    refs, groups = _mc_mixed_pass(rng, far, bd)
    got = tmc.mc_pass(groups)
    assert len(got) == len(groups) == 3 * len(TILE_SIZES)
    for g, out, c in zip(groups, got, [0, 1, 2] * len(TILE_SIZES)):
        xs, ys = g.xs >> g.sx, g.ys >> g.sy
        single = tmc.mc_plain(g.refs, g.sel, xs, ys, g.mvx, g.mvy, g.w, g.h,
                              g.is_luma, bd)
        want = np.asarray(mc_batch(
            jnp.asarray(refs[c]), *[jnp.asarray(a.numpy()) for a in (
                g.sel, xs, ys, g.mvx, g.mvy)], g.w, g.h, g.is_luma, bd))
        np.testing.assert_array_equal(out.numpy(), single.numpy())
        np.testing.assert_array_equal(out.numpy(), want,
                                      err_msg=f"{g.w}x{g.h} plane {c}")


def test_k2_pass_descriptor_covers_every_item_once():
    """pack_pass's bytes, read back as the kernel reads them: a thread
    block finds its group by the prefix sums and takes items
    [b * ipc, min((b + 1) * ipc, N)); over the pass every item of every
    group is taken exactly once, and each block's shared memory fits."""
    rng = np.random.default_rng(33)
    _, groups = _mc_mixed_pass(rng, False, n=300)
    outs = [torch.empty((g.xs.shape[0], g.h, g.w), dtype=torch.int32)
            for g in groups]
    desc, n_ctas, smem = tmc.pack_pass(groups, outs)
    assert smem <= tmc.SMEM_MAX
    fields = [tmc._GROUP.unpack_from(desc, k * tmc._GROUP.size)
              for k in range(len(groups))]
    n_groups, n = struct.unpack_from("@2i", desc,
                                     tmc.MAX_GROUPS * tmc._GROUP.size)
    assert (n_groups, n) == (len(groups), n_ctas)
    taken = [np.zeros(g.xs.shape[0], int) for g in groups]
    for b in range(n_ctas):
        gi = 0
        while gi + 1 < n_groups and b >= fields[gi + 1][-1]:
            gi += 1
        f = fields[gi]
        N, ipc, first = f[10], f[-2], f[-1]
        item0 = (b - first) * ipc
        assert 0 <= item0 < N
        taken[gi][item0:min(item0 + ipc, N)] += 1
    for g, out, f, t in zip(groups, outs, fields, taken):
        assert (t == 1).all()
        assert f[6] == out.data_ptr()
        assert (1 << f[11], 1 << f[12], f[13]) == (g.w, g.h,
                                                   8 if g.is_luma else 4)
        ipc = f[-2]
        assert ipc * g.w * g.h <= max(tmc.OUT_PER_CTA, g.w * g.h)


# ---------------------------------------------------------------------------
# K3 paint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_k3_paint_plain_vs_pallas(dtype):
    """band_paint paints into the band-padded plane; the port paints the
    (H, W) plane directly: equal after cropping."""
    rng = np.random.default_rng(0)
    H, W = 100, 300
    Hp, Wp = band_pad_shape(H, W)
    plane = rng.integers(0, 1023, (Hp, Wp)).astype(dtype)
    mine = _t(plane[:H, :W].copy())
    for (h, w) in ((16, 16), (4, 16), (16, 4), (4, 4), (32, 32), (64, 64)):
        cols, rows = W // w, H // h
        picks = rng.permutation(rows * cols)[:10]
        ys = (picks // cols * h).astype(np.int32)
        xs = (picks % cols * w).astype(np.int32)
        valid = rng.integers(0, 2, len(picks)).astype(np.int32)
        tiles = rng.integers(0, 1023, (len(picks), h, w)).astype(dtype)
        plane = np.asarray(band_paint(
            jnp.asarray(plane), jnp.asarray(tiles), jnp.asarray(xs),
            jnp.asarray(ys), jnp.asarray(valid), h, w, interpret=True))
        paint.paint_groups_([(mine, _t(tiles), _t(xs), _t(ys), _t(valid))])
    np.testing.assert_array_equal(mine.numpy(), plane[:H, :W])


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_k3_paint_pass_plain_vs_pallas(dtype):
    """One mixed pass (every tile shape, two planes of one dtype, as
    frame_step paints them): paint_groups_plain_ equals each group through
    band_paint in interpret mode, and each group through paint_plain_."""
    rng = np.random.default_rng(2)
    shapes = ((128, 264), (64, 132))
    padded = [rng.integers(0, 1023, band_pad_shape(*s)).astype(dtype)
              for s in shapes]
    mine = [_t(p[:s[0], :s[1]].copy()) for p, s in zip(padded, shapes)]
    single = [m.clone() for m in mine]
    taken = [np.zeros(s, bool) for s in shapes]
    groups = []
    for (h, w) in TILE_SIZES:
        for k, (H, W) in enumerate(shapes):
            cells = [(y, x) for y in range(0, H - h + 1, h)
                     for x in range(0, W - w + 1, w)
                     if not taken[k][y:y + h, x:x + w].any()]
            picks = rng.permutation(len(cells))[:3]
            if not len(picks):
                continue
            ys = np.array([cells[i][0] for i in picks], np.int32)
            xs = np.array([cells[i][1] for i in picks], np.int32)
            for y, x in zip(ys, xs):
                taken[k][y:y + h, x:x + w] = True
            valid = rng.integers(0, 2, len(picks)).astype(np.int32)
            tiles = rng.integers(0, 1023, (len(picks), h, w)).astype(dtype)
            padded[k] = np.asarray(band_paint(
                jnp.asarray(padded[k]), jnp.asarray(tiles), jnp.asarray(xs),
                jnp.asarray(ys), jnp.asarray(valid), h, w, interpret=True))
            vecs = (_t(tiles), _t(xs), _t(ys), _t(valid))
            groups.append((mine[k],) + vecs)
            paint.paint_plain_(single[k], *vecs)
    assert len({g[1].shape[1:] for g in groups}) == len(TILE_SIZES)
    paint.paint_groups_plain_(groups)
    for m, s1, p, (H, W) in zip(mine, single, padded, shapes):
        np.testing.assert_array_equal(m.numpy(), p[:H, :W])
        np.testing.assert_array_equal(m.numpy(), s1.numpy())


def test_k3_paint_drops_outside_samples():
    plane = torch.zeros((8, 8), dtype=torch.int32)
    tiles = torch.arange(32, dtype=torch.int32).reshape(2, 4, 4) + 1
    xs = torch.tensor([6, 0], dtype=torch.int32)
    ys = torch.tensor([6, 0], dtype=torch.int32)
    valid = torch.tensor([1, 0], dtype=torch.int32)
    paint.paint_groups_([(plane, tiles, xs, ys, valid)])
    want = np.zeros((8, 8), np.int32)
    want[6:, 6:] = np.arange(1, 17).reshape(4, 4)[:2, :2]
    np.testing.assert_array_equal(plane.numpy(), want)


# ---------------------------------------------------------------------------
# K4 deblock + SAO, and the grid builders
# ---------------------------------------------------------------------------

def _rand_maps(rng, H, W):
    vbs = rng.integers(0, 3, (H // 4, W // 8)).astype(np.int32)
    hbs = rng.integers(0, 3, (H // 8, W // 4)).astype(np.int32)
    qp = rng.integers(20, 45, (H // 8, W // 8)).astype(np.int32)
    nfm = (rng.random((H // 4, W // 4)) < 0.05).astype(np.int32)
    return vbs, hbs, qp, nfm


def _rand_sao(rng, gr, gc):
    tm = rng.integers(0, 3, (gr, gc)).astype(np.int32)
    bm = rng.integers(0, 32, (gr, gc)).astype(np.int32)
    em = rng.integers(0, 4, (gr, gc)).astype(np.int32)
    om = rng.integers(-7, 8, (gr, gc, 5)).astype(np.int32)
    return tm, bm, em, om


def _smooth_plane(rng, H, W, hi):
    base = rng.integers(hi // 4, 3 * hi // 4, (H // 8 + 1, W // 8 + 1))
    base = base.repeat(8, 0).repeat(8, 1)[:H, :W]
    return (base + rng.integers(-3, 4, (H, W))).astype(np.int32)


def _eq_grids(got, want):
    for gg, gw in zip(got, want):
        for a, b in zip(gg, gw):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("H,W,boff,toff", [(64, 96, 0, 0), (40, 80, 2, -2)])
def test_k4_luma_plain_vs_pallas(H, W, boff, toff):
    rng = np.random.default_rng(W + boff)
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    plane = _smooth_plane(rng, H, W, 256)
    vbs, hbs, qp, nfm = _rand_maps(rng, Hp, Wp)
    ctb = 64
    tm, bm, em, om = _rand_sao(rng, -(-H // ctb), -(-W // ctb))
    restore = (rng.random((H, W)) < 0.05).astype(np.int8)
    vg, hg = fp.build_luma_grids(jnp.asarray(vbs), jnp.asarray(hbs),
                                 jnp.asarray(qp), boff, toff,
                                 jnp.asarray(nfm), 8, Hp, Wp)
    mvg, mhg = flt.build_luma_grids(_t(vbs), _t(hbs), _t(qp), boff, toff,
                                    _t(nfm), 8, Hp, Wp)
    _eq_grids((mvg, mhg), (vg, hg))
    sg = (jnp.asarray(tm), jnp.asarray(bm), jnp.asarray(em),
          jnp.asarray(om).transpose(0, 2, 1))
    for db, sao, rs in ((True, True, restore), (True, False, None),
                        (False, True, None)):
        want = np.asarray(fp.fused_filter_plane(
            jnp.asarray(plane), vg, hg, sg if sao else None,
            None if rs is None else jnp.asarray(rs), luma=True, bd=8,
            deblock_on=db, sao_on=sao, csx=ctb, csy=ctb, H=H, W=W,
            interpret=True))
        got = flt.filter_plane(
            _t(plane), mvg, mhg, tuple(_t(g) for g in (tm, bm, em, om)),
            None if rs is None else _t(rs), luma=True, bd=8, deblock_on=db,
            sao_on=sao, csx=ctb, csy=ctb)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"db={db} sao={sao}")


def test_k4_chroma_plain_vs_pallas():
    rng = np.random.default_rng(7)
    HL, WL = 64, 128
    Hc, Wc = HL // 2, WL // 2
    plane = _smooth_plane(rng, Hc, Wc, 256)
    vbs, hbs, qp, nfm = _rand_maps(rng, HL, WL)
    ctb = 64
    csx = csy = ctb // 2
    tm, bm, em, om = _rand_sao(rng, -(-Hc // csy), -(-Wc // csx))
    qpc = jnp.asarray(_QP_C, jnp.int32)
    vg, hg = fp.build_chroma_grids(
        jnp.asarray(vbs), jnp.asarray(hbs), jnp.asarray(qp), 1, 0, 0,
        jnp.asarray(nfm), qpc, 8, Hc, Wc, 2, 2, True)
    mvg, mhg = flt.build_chroma_grids(
        _t(vbs), _t(hbs), _t(qp), 1, 0, 0, _t(nfm),
        torch.tensor(_QP_C, dtype=torch.int32), 8, Hc, Wc, 2, 2, True)
    _eq_grids((mvg, mhg), (vg, hg))
    want = np.asarray(fp.fused_filter_plane(
        jnp.asarray(plane), vg, hg,
        (jnp.asarray(tm), jnp.asarray(bm), jnp.asarray(em),
         jnp.asarray(om).transpose(0, 2, 1)), None,
        luma=False, bd=8, deblock_on=True, sao_on=True, csx=csx, csy=csy,
        H=Hc, W=Wc, interpret=True))
    got = flt.filter_plane(
        _t(plane), mvg, mhg, tuple(_t(g) for g in (tm, bm, em, om)), None,
        luma=False, bd=8, deblock_on=True, sao_on=True, csx=csx, csy=csy)
    np.testing.assert_array_equal(got.numpy(), want)


# -- K4's decomposition, emulated in torch: one CTB tile and its halo ----

_KHALO = 4          # csrc/filter.cu kHalo


def _tile_params(grids, luma, vertical, first_g, k0, n_g, n_e):
    """The (n_g + 1, n_e) edge parameters of one tile pass in the plain
    pass's layout: group row 0 is the pad group in front of the tile, row
    i >= 1 is plane group first_g + i - 1; column j is grid edge k0 + j.
    Edges outside the grids get tc = 0 (not filtered), as in the kernel."""
    g = first_g - 1 + torch.arange(n_g + 1)[:, None]
    k = k0 + torch.arange(n_e)[None, :]
    t = grids[0]
    if vertical:
        ok = (g >= first_g) & (g >= 0) & (g < t.shape[0] - 4) & \
            (k >= 1) & (k < t.shape[1])
        idx = lambda a: a[(g + 2).clamp(0, t.shape[0] - 1),  # noqa: E731
                          k.clamp(0, t.shape[1] - 1)]
    else:
        ok = (g >= first_g) & (g >= 0) & (g < t.shape[1]) & \
            (k >= 1) & (k < t.shape[0])
        idx = lambda a: a[k.clamp(0, t.shape[0] - 1),  # noqa: E731
                          g.clamp(0, t.shape[1] - 1)]
    ps = list(grids) if luma else [grids[0], grids[0], grids[1], grids[2]]
    return tuple(torch.where(ok, idx(a), 0) for a in ps)


def filter_tiled_plain(plane, vg, hg, sg, restore, *, luma, bd, deblock_on,
                       sao_on, csx, csy, halo=_KHALO):
    """The kernel's decomposition on the CPU: for each CTB, cut the tile
    and a halo of 4 from the zero-padded plane (samples outside a smaller
    `halo` zeroed, as a kernel that loaded less would see them), run the
    vertical then the horizontal deblocking pass and SAO on the tile
    alone, and keep the CTB."""
    H, W = plane.shape
    P = _KHALO
    padded = torch.nn.functional.pad(plane, (P, P + csx, P, P + csy))
    out = torch.empty_like(plane)
    for y0 in range(0, H, csy):
        for x0 in range(0, W, csx):
            tile = padded[y0:y0 + csy + 2 * P, x0:x0 + csx + 2 * P].clone()
            if halo < P:
                ring = torch.ones_like(tile, dtype=torch.bool)
                ring[P - halo:P + csy + halo, P - halo:P + csx + halo] = False
                tile[ring] = 0
            if deblock_on:
                # a pad group in front, so the tile's edges fall at 8(j+1)
                T = torch.nn.functional.pad(tile, (4, 0, 4, 0))
                n_v, n_h = csy // 4 + 2, csx // 4 + 2
                flt._deblock_pass_plain(
                    T, n_v + 1, csx // 8 + 1,
                    _tile_params(vg, luma, True, y0 // 4 - 1, x0 // 8, n_v,
                                 csx // 8 + 1), luma, True, bd)
                flt._deblock_pass_plain(
                    T, n_h + 1, csy // 8 + 1,
                    _tile_params(hg, luma, False, x0 // 4 - 1, y0 // 8, n_h,
                                 csy // 8 + 1), luma, False, bd)
                tile = T[4:, 4:]
            ya, xa = max(y0 - P, 0), max(x0 - P, 0)
            yb, xb = min(y0 + csy + P, H), min(x0 + csx + P, W)
            sub = tile[ya - y0 + P:yb - y0 + P, xa - x0 + P:xb - x0 + P]
            if sao_on:
                cell = tuple(g[y0 // csy:y0 // csy + 1,
                               x0 // csx:x0 // csx + 1] for g in sg)
                rs = None if restore is None else restore[ya:yb, xa:xb]
                sub = flt._sao_plain(sub, *cell, sub.shape[1], sub.shape[0],
                                     rs, bd)
            out[y0:y0 + csy, x0:x0 + csx] = \
                sub[y0 - ya:y0 - ya + csy, x0 - xa:x0 - xa + csx]
    return out


def _k4_case(rng, H, W, ctb, luma):
    """A luma (H, W) plane or the chroma plane of an (H, W) luma picture,
    with grids from random maps over the padded geometry (so edges past
    the picture carry nonzero tc), random SAO grids and a restore mask.
    -> (plane, (vg, hg) torch, (vg, hg) JAX, sao grids, restore, cs)."""
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    vbs, hbs, qp, nfm = _rand_maps(rng, Hp, Wp)
    if luma:
        h, w, cs = H, W, ctb
        jv, jh = fp.build_luma_grids(jnp.asarray(vbs), jnp.asarray(hbs),
                                     jnp.asarray(qp), 1, -1,
                                     jnp.asarray(nfm), 8, Hp, Wp)
        tv, th = flt.build_luma_grids(_t(vbs), _t(hbs), _t(qp), 1, -1,
                                      _t(nfm), 8, Hp, Wp)
    else:
        h, w, cs = H // 2, W // 2, ctb // 2
        jv, jh = fp.build_chroma_grids(
            jnp.asarray(vbs), jnp.asarray(hbs), jnp.asarray(qp), 1, 0, 0,
            jnp.asarray(nfm), jnp.asarray(_QP_C, jnp.int32), 8, Hp // 2,
            Wp // 2, 2, 2, True)
        tv, th = flt.build_chroma_grids(
            _t(vbs), _t(hbs), _t(qp), 1, 0, 0, _t(nfm),
            torch.tensor(_QP_C, dtype=torch.int32), 8, Hp // 2, Wp // 2, 2,
            2, True)
    plane = _smooth_plane(rng, h, w, 256)
    sg = _rand_sao(rng, -(-h // cs), -(-w // cs))
    restore = (rng.random((h, w)) < 0.05).astype(np.int32)
    return plane, (tv, th), (jv, jh), sg, restore, cs


# (name, H, W, CTB, luma, deblock, SAO, restore): H and W of the luma
# picture; none of the shapes is a multiple of its CTB
_TILED = [
    ("luma", 72, 136, 64, True, True, True, True),
    ("luma_ctb32", 88, 104, 32, True, True, True, False),
    ("chroma", 80, 144, 64, False, True, True, True),
    ("luma_deblock_only", 72, 136, 64, True, True, False, False),
    ("luma_sao_only", 72, 136, 32, True, False, True, True),
    ("chroma_deblock_only", 80, 144, 32, False, True, False, False),
]


@pytest.mark.parametrize("case", _TILED, ids=[c[0] for c in _TILED])
def test_k4_tiled_matches_plain_and_pallas(case):
    """K4's decomposition (a CTB tile with a halo of 4, both deblocking
    passes and SAO on the tile alone) equals the whole-plane plain
    version and the Pallas kernel in interpret mode."""
    name, H, W, ctb, luma, db, sao, rs = case
    rng = np.random.default_rng(len(name) + H)
    plane, (tv, th), (jv, jh), sg, restore, cs = _k4_case(rng, H, W, ctb,
                                                          luma)
    restore = restore if rs else None
    tsg = tuple(_t(g) for g in sg)
    trs = None if restore is None else _t(restore)
    kw = dict(luma=luma, bd=8, deblock_on=db, sao_on=sao, csx=cs, csy=cs)
    got = filter_tiled_plain(_t(plane), tv, th, tsg, trs, **kw)
    plain = flt.filter_plane_plain(_t(plane), tv, th, tsg, trs, **kw)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    tm, bm, em, om = sg
    want = np.asarray(fp.fused_filter_plane(
        jnp.asarray(plane), jv if db else None, jh if db else None,
        (jnp.asarray(tm), jnp.asarray(bm), jnp.asarray(em),
         jnp.asarray(om).transpose(0, 2, 1)) if sao else None,
        None if restore is None else jnp.asarray(restore.astype(np.int8)),
        H=plane.shape[0], W=plane.shape[1], interpret=True, **kw))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k4_tiled_halo_of_3_is_seen():
    """A halo of 3 is too small, and the emulation shows it: on a seeded
    case it differs from the plain version (so the halo-4 test above
    could see a kernel that loaded too little)."""
    rng = np.random.default_rng(5)
    plane, (tv, th), _, sg, _, cs = _k4_case(rng, 72, 136, 32, True)
    kw = dict(luma=True, bd=8, deblock_on=True, sao_on=True, csx=cs, csy=cs)
    tsg = tuple(_t(g) for g in sg)
    plain = flt.filter_plane_plain(_t(plane), tv, th, tsg, None, **kw)
    four = filter_tiled_plain(_t(plane), tv, th, tsg, None, **kw)
    three = filter_tiled_plain(_t(plane), tv, th, tsg, None, halo=3, **kw)
    np.testing.assert_array_equal(four.numpy(), plain.numpy())
    assert (three != plain).any()


def _k4_frame(rng, H, W, ctb):
    """A frame's three planes (4:2:0) with their grids, SAO grids and
    restore masks, as frame_step passes them to filter_planes."""
    cases = [_k4_case(rng, H, W, ctb, c == 0) for c in range(3)]
    planes = [_t(c[0]) for c in cases]
    grids = [c[1] for c in cases]
    sao = [tuple(_t(g) for g in c[3]) for c in cases]
    restores = [_t(cases[0][4]), None, _t(cases[2][4])]
    return planes, grids, sao, restores


@pytest.mark.parametrize("db,sao", [(True, True), (True, False),
                                    (False, True), (False, False)])
def test_k4_filter_planes_matches_per_plane(db, sao):
    """filter_planes on CPU tensors (one call for the frame) equals
    filter_plane_plain on each plane."""
    rng = np.random.default_rng(9)
    planes, grids, sg, rs = _k4_frame(rng, 72, 136, 64)
    got = flt.filter_planes(planes, grids if db else None,
                            sg if sao else None, rs if sao else None, bd=8,
                            deblock_on=db, sao_on=sao, ctb=64, hs=1, vs=1)
    for c in range(3):
        cs = 64 >> min(c, 1)
        want = flt.filter_plane_plain(
            planes[c], *grids[c], sg[c], rs[c] if sao else None,
            luma=(c == 0), bd=8, deblock_on=db, sao_on=sao, csx=cs, csy=cs)
        np.testing.assert_array_equal(got[c].numpy(), want.numpy())
        assert got[c] is not planes[c]


def test_k4_filter_planes_raises_on_what_the_kernel_does_not_take():
    rng = np.random.default_rng(10)
    planes, grids, sg, rs = _k4_frame(rng, 72, 136, 64)
    kw = dict(bd=8, deblock_on=True, sao_on=True, ctb=64, hs=1, vs=1)
    bad_grid = [grids[0], (tuple(g.long() for g in grids[1][0]),
                           grids[1][1]), grids[2]]
    bad_sao = [sg[0], sg[1][:3] + (sg[1][3][..., :4],), sg[2]]
    for args in ((planes, bad_grid, sg, rs), (planes, grids, bad_sao, rs),
                 ([planes[0].t()] + planes[1:], grids, sg, rs),
                 (planes, grids, sg, [rs[0][:-1]] + rs[1:])):
        with pytest.raises(ValueError):
            flt.filter_planes(*args, **kw)


def test_k4_frame_descriptor_covers_every_ctb_once():
    """pack_frame's bytes, read back as the kernel reads them: the thread
    blocks map one to one onto the CTBs of the three planes."""
    rng = np.random.default_rng(11)
    planes, grids, sg, rs = _k4_frame(rng, 200, 264, 64)
    jobs = flt._plane_jobs(planes, grids, sg, rs, 64, 1, 1)
    desc, n_ctas = flt.pack_frame(jobs, planes, bd=8, deblock_on=True,
                                  sao_on=True)
    assert len(desc) == flt._FRAME_SIZE
    fields = [flt._PLANE.unpack_from(desc, k * flt._PLANE.size)
              for k in range(3)]
    n_planes, n, bd, db, sao = struct.unpack_from(
        "@5i", desc, flt.MAX_PLANES * flt._PLANE.size)
    assert (n_planes, n, bd, db, sao) == (3, n_ctas, 8, 1, 1)
    seen = set()
    for b in range(n_ctas):
        pi = 0
        while pi + 1 < n_planes and b >= fields[pi + 1][-2]:
            pi += 1
        (H, W, vrows, vcols, hrows, hcols, csx, csy, log2csx, cols, gcols,
         first, luma) = fields[pi][15:]
        assert (H, W) == tuple(planes[pi].shape) and 1 << log2csx == csx
        assert (vrows, vcols) == tuple(grids[pi][0][0].shape)
        assert (hrows, hcols) == tuple(grids[pi][1][0].shape)
        assert gcols == sg[pi][0].shape[1] and luma == (pi == 0)
        t = b - first
        by, bx = divmod(t, cols)
        assert by * csy < H and bx * csx < W
        seen.add((pi, by, bx))
    want = {(c, by, bx) for c in range(3)
            for by in range(-(-planes[c].shape[0] // (64 >> min(c, 1))))
            for bx in range(-(-planes[c].shape[1] // (64 >> min(c, 1))))}
    assert seen == want and len(want) == n_ctas


def test_sao_grids_match_reference():
    class _Plan:
        pass
    rng = np.random.default_rng(3)
    plan = _Plan()
    plan.sao = None
    plan.sao_raw = rng.integers(-7, 32, (6 * 8, 24)).astype(np.int32)
    for c in range(3):
        for a, b in zip(flt.build_sao_grids(plan, c, (6, 8)),
                        ref_sao.build_sao_grids(plan, c, (6, 8))):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# X1 residual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_residual_batch_matches_reference(n):
    rng = np.random.default_rng(n)
    N = 24
    levels = rng.integers(-300, 300, (N, n, n)).astype(np.int32)
    levels[0] = rng.integers(-32768, 32767, (n, n))     # saturating block
    levels[1] = 0
    levels[1, 0, 0] = 7                                  # DC only
    qp = rng.integers(0, 52, N).astype(np.int32)
    kinds = [0, 3, 4] + ([1] if n == 4 else [])
    kind = rng.choice(kinds, N).astype(np.int32)
    xtra = (rng.integers(0, 3, N) | (rng.integers(0, 2, N) << 2)) \
        .astype(np.int32)
    xtra[:N // 2] = 0
    want = np.asarray(ref_residual.residual_batch(
        jnp.asarray(levels), jnp.asarray(qp), jnp.asarray(kind), n, 8,
        xtra=jnp.asarray(xtra)))
    got = residual.residual_batch(_t(levels), _t(qp), _t(kind), n, 8,
                                  xtra=_t(xtra))
    np.testing.assert_array_equal(got.numpy(), want)
