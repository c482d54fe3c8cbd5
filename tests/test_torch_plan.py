"""CudaBackend's plan arrays and constant tables against the reference.

``CudaBackend.frame_arrays(plan)`` must hold, for the same FramePlan,
exactly the arrays that the reference's ``frame_step._unpack`` reads from
``TpuBackend.prepare_host``'s packed blob (sequential-intra and fused-
filter paths, as the TPU runs them), frame after frame.  The port ships
the coefficient levels as whole int16 values where the reference ships
nibbles and escape sections, so the reference's levels are compared
after its escapes are applied (``_apply_ref_escapes``).
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from openhevc_tpu.encoder import Encoder, EncoderConfig
from openhevc_tpu.tpu import TpuBackend
from openhevc_tpu.tpu.frame_step import _unpack, _QP_C
from tests.util_e2e import make_source

from openhevc_tpu_torch.decoder.frontend import Decoder
from openhevc_tpu_torch.torch_backend import CudaBackend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = os.path.join(ROOT, "streams", "bench_1080p_main_8b78bd6db7.265")


class _Recorder:
    """Backend stand-in that records the plans and reconstructs through the
    port on the CPU (later plans need the DPB)."""

    def __init__(self):
        self.inner = CudaBackend(device="cpu")
        self.plans = []
        self.wire_fmt = None

    def decode_frame(self, plan, dpb):
        self.plans.append(plan)
        return self.inner.decode_frame(plan, dpb)


def _plans(stream):
    rec = _Recorder()
    Decoder(backend=rec, check_md5=True).decode_stream(stream)
    return rec.plans


def _reference_arrays(tb, plan):
    _plan, blob, prof, _refs = tb.prepare_host(plan)
    layout, layout8, n16 = prof[17], prof[26], prof[27]
    packed = jnp.asarray(blob[:2 * n16].view(np.int16))
    out = _unpack(packed, layout)
    out.update(_unpack(jnp.asarray(blob[2 * n16:]), layout8))
    return {k: np.asarray(v) for k, v in out.items()}, prof


def _apply_ref_escapes(want, resid_keys):
    """The reference's levels with its escapes applied, as its frame_step
    does (openhevc_tpu/tpu/frame_step.py:270-291): the int8-value escapes
    (delta-coded indices, idx = cumsum(d) - 1) added, then the int16
    escapes (idx = hi << 16 | lo) set; indices outside the bucket drop.
    The escape sections are removed from want."""
    for (c, n, _N, E, E8) in resid_keys:
        lv = want[("resid", c, n, "levels")].astype(np.int32)
        flat = lv.reshape(-1)
        if E8:
            dd = want.pop(("rese", c, n, "d")).astype(np.int64) & 0xFFFF
            val = want.pop(("rese", c, n, "val")).astype(np.int32)
            idx = np.cumsum(dd) - 1
            ok = (idx >= 0) & (idx < flat.size)
            np.add.at(flat, idx[ok], val[ok])
        if E:
            lo = want.pop(("resc", c, n, "lo")).astype(np.int64) & 0xFFFF
            hi = want.pop(("resc", c, n, "hi")).astype(np.int64)
            val = want.pop(("resc", c, n, "val")).astype(np.int32)
            idx = (hi << 16) | lo
            ok = (idx >= 0) & (idx < flat.size)
            flat[idx[ok]] = val[ok]
        want[("resid", c, n, "levels")] = lv


def _check_plans(plans, monkeypatch):
    monkeypatch.setenv("OPENHEVC_IPAL", "interp")
    monkeypatch.setenv("OPENHEVC_FFILT", "interp")
    monkeypatch.delenv("OPENHEVC_CAP_STORE", raising=False)
    # the reference backend takes the CTB size once; the port reads it
    # from each plan
    tb = TpuBackend(ctb_log2=plans[0].log2_ctb_size)
    cb = CudaBackend(device="cpu")
    twin = CudaBackend(device="cpu")   # for the profile
    for i, plan in enumerate(plans):
        want, rprof = _reference_arrays(tb, plan)
        _apply_ref_escapes(want, rprof[8])
        got = cb.frame_arrays(plan)
        assert set(got) == set(want), f"frame {i}: keys differ: " \
            f"{sorted(set(got) ^ set(want), key=str)}"
        for k in want:
            np.testing.assert_array_equal(
                got[k].numpy(), want[k].astype(np.int32),
                err_msg=f"frame {i} {k}")
        # the static profile entries the port's frame_step reads
        prof = twin.prepare_host(plan)[2]
        assert (prof["bd"], prof["strong"], prof["cfmt"], prof["H"],
                prof["W"], prof["inter_sizes"], prof["resid_keys"],
                prof["deblock_on"], prof["sao_on"], prof["beta_off"],
                prof["tc_off"], prof["cb_off"], prof["cr_off"],
                prof["log2_ctb"], prof["ipal"]) == \
            (rprof[0], rprof[1], rprof[2], rprof[3], rprof[4], rprof[5],
             tuple(k[:3] for k in rprof[8]), rprof[9], rprof[10], rprof[11],
             rprof[12], rprof[13], rprof[14], rprof[18], rprof[19]), \
            f"frame {i}: profile"


def _stream(cfg, pattern, seed):
    rng = np.random.default_rng(seed)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, cfg.width, cfg.height)
    for i, st in enumerate(pattern):
        src = [np.roll(np.roll(base[0], i, 0), 2 * i, 1),
               np.roll(base[1], i, 0), np.roll(base[2], i, 0)]
        nal, _, _ = enc.encode_frame(src, st)
        stream += nal
    return stream


@pytest.mark.parametrize("cfg,pattern", [
    (EncoderConfig(width=128, height=64, qp=30, sao=True, wpp=True,
                   rng_seed=51), "IPP"),
    (EncoderConfig(width=128, height=128, qp=24, log2_ctb=6, sao=True,
                   rng_seed=52), "IP"),
], ids=["ctb32_wpp_sao", "ctb64_sao"])
def test_frame_arrays_match_reference(cfg, pattern, monkeypatch):
    plans = _plans(_stream(cfg, pattern, 3))
    assert len(plans) == len(pattern)
    _check_plans(plans, monkeypatch)


def test_frame_arrays_match_reference_1080p_clip(monkeypatch):
    """The slice's own plans: the first I and P frames of the 1080p clip."""
    import chip_smoke
    with open(CLIP, "rb") as f:
        data = chip_smoke._first_pictures(f.read(), 2)
    rec = _Recorder()
    dec = Decoder(backend="numpy", check_md5=True)
    # parse only: reconstructing 1080p on the CPU belongs to the slow tier
    dec._reconstruct = lambda plan: rec.plans.append(plan) or \
        _fake_frame(plan)
    dec.check_md5 = False
    dec.decode_stream(data)
    assert [p.slice_type for p in rec.plans] == [2, 1]
    assert rec.plans[0].log2_ctb_size == 6
    _check_plans(rec.plans, monkeypatch)


def _fake_frame(plan):
    from openhevc_tpu_torch.decoder.refs import Frame
    hs = [(plan.height, plan.width)] + [(plan.height // 2,
                                         plan.width // 2)] * 2
    return Frame(poc=plan.poc, planes=[np.zeros(s, np.int32) for s in hs],
                 mvf_mv=plan.mvf_mv, mvf_poc=plan.mvf_poc,
                 mvf_pred=plan.mvf_pred, mvf_ref_idx=plan.mvf_ref_idx,
                 rpl=plan.rpl, rpl_lt=plan.rpl_lt)


def test_constant_tables_match_reference():
    from openhevc_tpu.model import mc as rmc, intra as rintra
    from openhevc_tpu.model import filters as rfilt, transforms as rtr
    from openhevc_tpu.tpu import mc_pallas, residual as rres, plan_soa as rsoa
    from openhevc_tpu_torch.torch_backend import (mc, residual, plan_soa,
                                                  frame_step, filter as flt)
    from openhevc_tpu_torch.model import intra as tintra
    np.testing.assert_array_equal(mc.QPEL, mc_pallas._QPEL)
    np.testing.assert_array_equal(mc.EPEL, mc_pallas._EPEL)
    np.testing.assert_array_equal(mc.QPEL[1:], rmc.QPEL_FILTERS)
    np.testing.assert_array_equal(tintra.INTRA_PRED_ANGLE,
                                  rintra.INTRA_PRED_ANGLE)
    np.testing.assert_array_equal(tintra.INV_ANGLE, rintra.INV_ANGLE)
    np.testing.assert_array_equal(plan_soa._ANGLE_TAB, rsoa._ANGLE_TAB)
    np.testing.assert_array_equal(plan_soa._INV_TAB, rsoa._INV_TAB)
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(residual._MATS[n], np.asarray(rres._T[n]))
        np.testing.assert_array_equal(residual._MATS[n], rtr.dct_matrix(n))
    np.testing.assert_array_equal(residual._DST, np.asarray(rres._TDST))
    np.testing.assert_array_equal(residual._LEVEL_SCALE,
                                  np.asarray(rres._LEVEL_SCALE))
    np.testing.assert_array_equal(frame_step.QP_C, np.asarray(_QP_C))
    np.testing.assert_array_equal(flt._BETA, np.asarray(rfilt.BETA_TABLE))
    np.testing.assert_array_equal(flt._TC, np.asarray(rfilt.TC_TABLE))
