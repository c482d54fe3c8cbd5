"""The kernels' plain versions at the variants that depths 10-14 and RExt
4:2:2 / 4:4:4 add, on the CPU, against the JAX package, tolerance 0.

K1 with 4:4:4 chroma (32x32 blocks, reference smoothing), on 4:2:2 chroma
planes (a TU split into two square blocks stacked in decode order) and at
depths 10-14, against the Pallas kernel in interpret mode, and its
wavefront schedule on encoder-made 4:2:2 and 4:4:4 streams; K2 with the
(1, 0) and (0, 0) chroma phases at depths 8-14 against the XLA
``mc_batch``; K4 with ``four20=False`` chroma grids on 32x64 and 64x64
tiles and at depths 12-14 against the Pallas kernel in interpret mode and
the kernel's tile decomposition.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from openhevc_tpu.encoder import EncoderConfig
from openhevc_tpu.tpu import filter_pallas as fp
from openhevc_tpu.tpu import intra_pallas as ip
from openhevc_tpu.tpu.mc import mc_batch
from tests.test_torch_kernels import (_mk, _rand_maps, _rand_sao,
                                      _smooth_plane, _eq_grids,
                                      filter_tiled_plain, _QP_C)
from tests.test_torch_formats import _encode, _subs
from tests.test_torch_kernels import _PlanRecorder, _t
import chip_smoke

from openhevc_tpu_torch.decoder.frontend import Decoder
from openhevc_tpu_torch.torch_backend import (CudaBackend, intra,
                                              filter as flt, mc as tmc)
from openhevc_tpu_torch.torch_backend.plan_compile import TILE_SIZES


# ---------------------------------------------------------------------------
# K1: 4:4:4 chroma, 4:2:2 chroma planes, depths 10-14
# ---------------------------------------------------------------------------

def _with_flags(blocks, H, W):
    """(x, y, n, mode) blocks in decode order -> _mk rows whose five
    availability flags are set exactly where every sample of that
    neighbour segment lies inside the plane and an earlier block wrote
    it, as a real stream's are (chip_smoke.k1_flags)."""
    flags, _later = chip_smoke.k1_flags([b[:3] for b in blocks], H, W)
    return [(x, y, n, mode, tuple((f >> i) & 1 for i in range(5)))
            for (x, y, n, mode), f in zip(blocks, flags)]


def _k1_cases():
    # 4:4:4 chroma: 32x32 blocks and reference smoothing, as luma has
    c444 = _with_flags([(0, 0, 32, 0), (32, 0, 32, 26), (0, 32, 16, 18),
                        (16, 32, 16, 2), (0, 48, 8, 34), (8, 48, 8, 10),
                        (16, 48, 16, 5), (32, 32, 32, 14)], 64, 64)
    yield "c444_chroma", 64, 64, 8, False, 1, True, c444
    yield "c444_chroma_bd14", 64, 64, 14, False, 1, True, c444
    # 4:2:2 chroma: a TU of 8x16 is two square 8x8 blocks stacked in
    # decode order, the lower one reading the upper one's last row
    c422 = _with_flags([(0, 0, 8, 1), (0, 8, 8, 26), (8, 0, 8, 10),
                        (8, 8, 8, 30), (0, 16, 16, 0), (0, 32, 16, 18),
                        (16, 16, 4, 2), (16, 20, 4, 34), (20, 16, 4, 6),
                        (20, 20, 4, 22), (16, 24, 8, 13), (24, 16, 8, 23),
                        (16, 32, 16, 27)], 64, 32)
    yield "chroma_422", 64, 32, 8, False, 1, False, c422
    yield "chroma_422_bd10", 64, 32, 10, False, 1, False, c422
    luma = _with_flags([(0, 0, 32, 30), (32, 0, 32, 0), (0, 32, 32, 1),
                        (32, 32, 16, 11), (48, 32, 16, 25)], 64, 64)
    for bd in (10, 12, 14):
        yield f"luma_strong_bd{bd}", 64, 64, bd, True, 0, False, luma


@pytest.mark.parametrize("case", list(_k1_cases()), ids=lambda c: c[0])
def test_k1_formats_plain_vs_pallas(case, monkeypatch):
    monkeypatch.setattr(ip, "CHUNK", 16)
    name, H, W, bd, strong, c_idx, c444, rows = case
    ops = [_mk(*r, c_idx=c_idx) for r in rows]
    rng = np.random.default_rng(len(name) + bd)
    yy, xx = np.mgrid[0:H, 0:W]
    hi = 1 << bd
    plane = np.clip(hi // 4 + (yy + xx) * (hi // 256)
                    + rng.integers(-2, 3, (H, W)), 0, hi - 1).astype(np.int32)
    resid = rng.integers(-30, 30, (H, W)).astype(np.int32)
    meta = ip.build_meta(ops, c_idx, c444)
    np.testing.assert_array_equal(                  # rows, not padding
        intra.build_meta(ops, c_idx, c444).reshape(-1, intra.NF)[:len(ops)],
        meta.reshape(-1, intra.NF)[:len(ops)])
    want = np.asarray(ip.intra_seq(
        jnp.asarray(plane), jnp.asarray(resid), jnp.asarray(meta), H, W,
        min(c_idx, 1), bd, strong, c444, interpret=True))
    (got,), errors = intra.intra_planes([_t(plane)], [_t(resid)], [_t(meta)],
                                        [min(c_idx, 1)], bd, strong, c444)
    assert errors is None
    np.testing.assert_array_equal(got.numpy(), want)
    intra.intra_schedule(meta, H, W, c_idx, c444)      # must not raise


@pytest.mark.parametrize("cfmt,bd", [(2, 8), (3, 10)])
def test_k1_levels_rext_streams(cfmt, bd, monkeypatch):
    """Every intra plane of encoder-made 4:2:2 and 4:4:4 streams (NxN
    heavy, I then P): intra_schedule accepts the metadata, and each block
    rebuilt in the schedule's level order (reversed inside a level)
    equals the sequential plain version and the Pallas kernel."""
    monkeypatch.setattr(ip, "CHUNK", 16)
    cfg = EncoderConfig(width=48, height=32, qp=30, rng_seed=19,
                        chroma_format=cfmt, bit_depth=bd, p_split=0.8,
                        p_nxn=0.8, p_intra_in_inter=0.5)
    stream, _ = _encode(cfg, "IP", 19, "noise")
    rec = _PlanRecorder()
    Decoder(backend=rec, check_md5=True).decode_stream(stream)
    packer = CudaBackend(device="cpu")
    hs, vs = _subs(cfmt)
    rng = np.random.default_rng(cfmt)
    seen = 0
    for plan in rec.plans:
        _plan, host, prof, _refs = packer.prepare_host(plan)
        for (c, _bands) in prof["ipal"]:
            H, W = plan.height >> (vs if c else 0), plan.width >> (hs if c
                                                                  else 0)
            meta = np.asarray(host[("ipal", c, 0)]).astype(np.int32)
            c_idx, c444 = min(c, 1), cfmt == 3
            plane = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
            resid = rng.integers(-30, 30, (H, W)).astype(np.int32)
            level = intra.intra_schedule(meta, H, W, c_idx, c444)
            rows = meta.reshape(-1, intra.NF)
            order = sorted(np.nonzero(level >= 0)[0],
                           key=lambda b: (level[b], -b))
            out = _t(plane).clone()
            res = _t(resid).to(torch.int64)
            for b in order:
                intra.intra_block_plain_(out, res, rows[b].tolist(), c_idx,
                                         bd, True, c444)
            seq = intra.intra_plane_plain(_t(plane), _t(resid), _t(meta),
                                          c_idx, bd, True, c444)
            want = np.asarray(ip.intra_seq(
                jnp.asarray(plane), jnp.asarray(resid),
                jnp.asarray(rows.reshape(-1, 16, intra.NF)), H, W, c_idx, bd,
                True, c444, interpret=True))
            np.testing.assert_array_equal(out.numpy(), seq.numpy())
            np.testing.assert_array_equal(out.numpy(), want)
            seen += c > 0
    assert seen, "no chroma intra plane in the stream"


# ---------------------------------------------------------------------------
# K2: the (1, 0) and (0, 0) chroma phases, depths 8-14
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bd", [8, 10, 12, 14])
@pytest.mark.parametrize("hs,vs", [(1, 0), (0, 0)])
def test_k2_chroma_formats_plain_vs_xla(hs, vs, bd):
    """One frame's pass in 4:2:2 or 4:4:4: every tile size on both chroma
    planes (the luma work vectors shifted by hs/vs, a quarter of the
    motion far outside the picture) and on luma, through mc_pass_plain
    and the XLA mc_batch."""
    rng = np.random.default_rng(100 * hs + 10 * vs + bd)
    H, W, R, n = 64, 96, 2, 6
    shapes = [(H, W), (H >> vs, W >> hs), (H >> vs, W >> hs)]
    refs = [rng.integers(0, 1 << bd, (R,) + s).astype(np.int32)
            for s in shapes]
    groups, planes = [], []
    for (w, h) in TILE_SIZES:
        sel = rng.integers(0, R, n).astype(np.int32)
        xs = (rng.integers(0, W // w, n) * w).astype(np.int32)
        ys = (rng.integers(0, H // h, n) * h).astype(np.int32)
        mv = rng.integers(-40, 41, (2, n)).astype(np.int32)
        far = rng.random(n) < 0.25
        mv[:, far] = rng.integers(-4000, 4000, (2, int(far.sum())))
        vecs = [_t(a) for a in (sel, xs, ys, mv[0], mv[1])]
        for c in range(3):
            sh_, sv_ = (hs, vs) if c else (0, 0)
            groups.append(tmc.McGroup(_t(refs[c]), *vecs, w >> sh_, h >> sv_,
                                      c == 0, bd, hs, vs, sh_, sv_))
            planes.append(c)
    got = tmc.mc_pass(groups)
    for g, out, c in zip(groups, got, planes):
        xs, ys = (g.xs >> g.sx).numpy(), (g.ys >> g.sy).numpy()
        want = np.asarray(mc_batch(
            jnp.asarray(refs[c]), jnp.asarray(g.sel.numpy()),
            jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(g.mvx.numpy()),
            jnp.asarray(g.mvy.numpy()), g.w, g.h, g.is_luma, bd, hs=hs,
            vs=vs))
        np.testing.assert_array_equal(out.numpy(), want,
                                      err_msg=f"{g.w}x{g.h} plane {c}")


# ---------------------------------------------------------------------------
# K4: four20=False chroma grids, 32x64 and 64x64 chroma tiles, depths 12-14
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfmt,bd", [(2, 8), (3, 8), (2, 12), (3, 14)])
def test_k4_chroma_formats_plain_vs_pallas(cfmt, bd):
    """The chroma plane of a 4:2:2 (CTB tiles 32x64) or 4:4:4 (64x64, luma
    geometry) picture with CTB 64: the grids with four20=False equal the
    reference's, and the plain version equals the Pallas kernel and the
    kernel's tile decomposition (a halo of 4), picture sizes not
    multiples of the CTB."""
    rng = np.random.default_rng(cfmt * 16 + bd)
    HL, WL, ctb = 144, 208, 64
    hs, vs = _subs(cfmt)
    Hp, Wp = -(-HL // 16) * 16, -(-WL // 16) * 16
    Hc, Wc = HL >> vs, WL >> hs
    csx, csy = ctb >> hs, ctb >> vs
    vbs, hbs, qp, nfm = _rand_maps(rng, Hp, Wp)
    plane = _smooth_plane(rng, Hc, Wc, 1 << bd)
    sg = _rand_sao(rng, -(-Hc // csy), -(-Wc // csx))
    restore = (rng.random((Hc, Wc)) < 0.05).astype(np.int32)
    vg, hg = fp.build_chroma_grids(
        jnp.asarray(vbs), jnp.asarray(hbs), jnp.asarray(qp), 3, 1, 1,
        jnp.asarray(nfm), jnp.asarray(_QP_C, jnp.int32), bd, Hp >> vs,
        Wp >> hs, 1 << hs, 1 << vs, False)
    mvg, mhg = flt.build_chroma_grids(
        _t(vbs), _t(hbs), _t(qp), 3, 1, 1, _t(nfm),
        torch.tensor(_QP_C, dtype=torch.int32), bd, Hp >> vs, Wp >> hs,
        1 << hs, 1 << vs, False)
    _eq_grids((mvg, mhg), (vg, hg))
    tsg = tuple(_t(g) for g in sg)
    kw = dict(luma=False, bd=bd, deblock_on=True, sao_on=True, csx=csx,
              csy=csy)
    got = flt.filter_plane(_t(plane), mvg, mhg, tsg, _t(restore), **kw)
    tiled = filter_tiled_plain(_t(plane), mvg, mhg, tsg, _t(restore), **kw)
    tm, bm, em, om = sg
    want = np.asarray(fp.fused_filter_plane(
        jnp.asarray(plane), vg, hg,
        (jnp.asarray(tm), jnp.asarray(bm), jnp.asarray(em),
         jnp.asarray(om).transpose(0, 2, 1)),
        jnp.asarray(restore.astype(np.int8)), H=Hc, W=Wc, interpret=True,
        **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tiled.numpy(), want)


@pytest.mark.parametrize("bd", [12, 14])
def test_k4_luma_depths_plain_vs_pallas(bd):
    """Luma at depths 12 and 14 (tc and beta scaled by 2^(bd-8), the SAO
    band shift bd-5, clips at 2^bd-1)."""
    rng = np.random.default_rng(bd)
    H, W, ctb = 72, 136, 64
    Hp, Wp = -(-H // 16) * 16, -(-W // 16) * 16
    plane = _smooth_plane(rng, H, W, 1 << bd)
    vbs, hbs, qp, nfm = _rand_maps(rng, Hp, Wp)
    sg = _rand_sao(rng, -(-H // ctb), -(-W // ctb))
    vg, hg = fp.build_luma_grids(jnp.asarray(vbs), jnp.asarray(hbs),
                                 jnp.asarray(qp), 2, 1, jnp.asarray(nfm),
                                 bd, Hp, Wp)
    mvg, mhg = flt.build_luma_grids(_t(vbs), _t(hbs), _t(qp), 2, 1, _t(nfm),
                                    bd, Hp, Wp)
    _eq_grids((mvg, mhg), (vg, hg))
    tm, bm, em, om = sg
    kw = dict(luma=True, bd=bd, deblock_on=True, sao_on=True, csx=ctb,
              csy=ctb)
    got = flt.filter_plane(_t(plane), mvg, mhg, tuple(_t(g) for g in sg),
                           None, **kw)
    want = np.asarray(fp.fused_filter_plane(
        jnp.asarray(plane), vg, hg,
        (jnp.asarray(tm), jnp.asarray(bm), jnp.asarray(em),
         jnp.asarray(om).transpose(0, 2, 1)), None, H=H, W=W,
        interpret=True, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
