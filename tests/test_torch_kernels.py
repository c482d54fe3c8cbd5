"""The port's kernel modules against the JAX package, bit-exact.

Each kernel's plain PyTorch version (what a CPU tensor runs) is held
against the reference's Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU, and against the reference's XLA
path or scalar model.  The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py).  Tolerance is 0 everywhere: the pipeline is
integer.
"""

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
    got = intra.intra_planes([_t(plane)], [_t(resid)], [_t(meta)],
                             [min(c_idx, 1)], bd, strong, False)[0]
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
