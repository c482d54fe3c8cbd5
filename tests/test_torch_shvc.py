"""Two-layer SHVC through the port on the CPU, bit-exact, and X3, its
inter-layer upsample.

X3 (``torch_backend/upsample.py``) against the JAX package's gather form
(``tpu/upsample.py::upsample_plane_jit``) and its NumPy model
(``model/upsample.py``), at depths 8 and 10, ratios 2x and 1.5x (and the
arbitrary and 3x ratios of tests/test_upsample.py), luma and chroma,
tolerance 0.  ``ShvcDecoder`` with each layer on its own
``CudaBackend(device="cpu")`` (the kernels' plain versions, the upsample
on torch tensors) against the encoder's reconstruction of both layers and
the JAX package's ``ShvcDecoder`` (NumPy), every decoded-picture-hash SEI
checked, in cases that mirror tests/test_shvc.py.
"""

import glob
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

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
