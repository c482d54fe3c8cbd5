"""Depths 9-14, RExt 4:2:2 / 4:4:4 and the RExt tools through the port on
the CPU, bit-exact against the JAX package.

Wires: the 10-, 12- and 16-bit output wires read back to the planes
through the port's and the reference's ``Frame.host_planes``.  Whole
decodes: ``Decoder(backend=CudaBackend(device="cpu"))`` (the kernels'
plain versions) against the encoder's reconstruction and the JAX
package's ``Decoder(backend=None)``, every decoded-picture-hash SEI
checked, in cases that mirror tests/test_e2e_main10.py,
test_tpu_backend.py's Main-10 and Main-14 wire tests,
tests/test_rext_chroma.py and tests/test_rext_tools.py; the committed
RExt bench streams through ``PipelinedDecoder``.  The kernels' variants
are in test_torch_format_kernels.py.
"""

import glob
import os

import numpy as np
import pytest
import torch

from openhevc_tpu.encoder import Encoder, EncoderConfig
from openhevc_tpu.decoder.frontend import Decoder as RefDecoder
from openhevc_tpu.decoder.refs import Frame as RefFrame
from tests.util_e2e import make_source, assert_frames_equal
from tests.test_torch_kernels import _PlanRecorder, _t

from openhevc_tpu_torch.decoder.frontend import Decoder
from openhevc_tpu_torch.decoder.refs import Frame
from openhevc_tpu_torch.runtime import PipelinedDecoder
from openhevc_tpu_torch.torch_backend import (CudaBackend, frame_step,
                                              intra)
from openhevc_tpu_torch.torch_backend.wire import Wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _subs(cfmt):
    return (1 if cfmt in (1, 2) else 0), (1 if cfmt == 1 else 0)


# ---------------------------------------------------------------------------
# the output wires
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 96), (17, 21)],
                         ids=["divides", "odd_size"])
@pytest.mark.parametrize("bd", [8, 9, 10, 12, 14])
def test_output_wire_reads_back(bd, shape):
    """frame_step's output wire: raw bytes at depth 8, 4 samples in 5
    bytes at 10 and 2 in 3 at 12 where every plane's size divides, 16-bit
    samples otherwise.  The port's Frame.host_planes and the reference's
    (which reads the JAX frame_step's wire) both give the planes back."""
    rng = np.random.default_rng(bd)
    H, W = shape
    planes = [_t(rng.integers(0, 1 << bd, s).astype(np.int32))
              for s in ((H, W), (H, W // 2), (H, W // 2))]
    planes[0][0, :4] = torch.tensor([0, (1 << bd) - 1, 1 << (bd - 1), 3])
    wire = frame_step.output_wire(planes, bd)
    n = sum(p.numel() for p in planes)
    if bd == 8:
        assert wire.dtype == torch.uint8 and wire.numel() == n
    elif (bd, shape) in ((10, (64, 96)), (12, (64, 96))):
        assert wire.dtype == torch.uint8
        assert wire.numel() == (n * 5 // 4 if bd == 10 else n * 3 // 2)
    else:
        assert wire.dtype == torch.int16 and wire.numel() == n
    host = Wire(wire, None).cpu().numpy()
    if bd > 8:
        assert host.dtype in (np.uint8, np.uint16)
    want = [p.numpy() for p in planes]
    mine = Frame(poc=0, planes=planes, wire=Wire(wire, None),
                 bit_depth=bd).host_planes()
    ref = RefFrame(poc=0, planes=want, wire=host, bit_depth=bd).host_planes()
    for c in range(3):
        np.testing.assert_array_equal(np.asarray(mine[c]), want[c])
        np.testing.assert_array_equal(np.asarray(ref[c]), want[c])
        assert np.asarray(mine[c]).dtype == np.asarray(ref[c]).dtype


@pytest.mark.slow
@pytest.mark.parametrize("bd", [10, 12, 14])
def test_wire_planes_match_jax_frame_step(bd):
    """A depth-bd stream (I then P, SAO) through the JAX package's
    TpuBackend on the CPU (its fused frame_step and output wire, read
    back by the reference's Frame.host_planes, in a subprocess as
    tests/test_tpu_backend.py runs it) and through the port: the same
    planes.  The 64x64 planes take the packed wire at depths 10 and 12
    and the 16-bit wire at 14."""
    from tests.test_tpu_backend import _decode_tpu_subprocess
    cfg = _cfg(qp=30, bit_depth=bd, sao=True, rng_seed=41 + bd)
    stream, recons = _encode(cfg, "IP", bd, "smooth")
    want = _decode_tpu_subprocess(stream)
    dec = Decoder(backend=CudaBackend(device="cpu"), check_md5=True)
    mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
            for f in dec.decode_stream(stream)]
    assert dec.md5_ok == 6 and dec.md5_fail == 0
    assert_frames_equal(mine, recons, "port-vs-recon")
    assert_frames_equal(mine, want, "port-vs-jax-frame-step")


# ---------------------------------------------------------------------------
# whole decodes
# ---------------------------------------------------------------------------

def _encode(cfg, pattern, seed, source):
    """An encoder-made stream and its reconstruction.  source "smooth":
    tests/test_e2e_main10.py's make_source (4:2:0); "noise": the RExt
    tests' uniform planes at the configuration's chroma format."""
    rng = np.random.default_rng(seed)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    if source == "smooth":
        base = make_source(rng, cfg.width, cfg.height, cfg.bit_depth)
    else:
        hs, vs = _subs(cfg.chroma_format)
        h, w, hi = cfg.height, cfg.width, 1 << cfg.bit_depth
        base = [rng.integers(0, hi, s).astype(np.int32)
                for s in ((h, w), (h >> vs, w >> hs), (h >> vs, w >> hs))]
    recons = []
    for i, st in enumerate(pattern):
        src = [np.roll(p, i, 0) for p in base]
        nal, recon, _ = enc.encode_frame(src, st)
        stream += nal
        recons.append([np.asarray(p).copy() for p in recon])
    return stream, recons


def _cfg(w=64, h=64, **kw):
    return EncoderConfig(width=w, height=h, **kw)


_REXT = dict(w=96, h=64, rng_seed=7)
# (name, config, pattern, seed, source)
CASES = [
    # tests/test_e2e_main10.py
    ("main10_intra", _cfg(qp=30, bit_depth=10, rng_seed=51), "I", 1,
     "smooth"),
    ("main10_inter", _cfg(96, qp=27, bit_depth=10, rng_seed=52), "IPP", 2,
     "smooth"),
    ("main10_sao_qp45", _cfg(qp=45, bit_depth=10, sao=True, rng_seed=53),
     "IP", 3, "smooth"),
    ("transform_skip_main10", _cfg(qp=33, bit_depth=10, transform_skip=True,
                                   rng_seed=55), "I", 5, "smooth"),
    ("main9_ipp", _cfg(qp=30, bit_depth=9, sao=True, rng_seed=56), "IPP", 6,
     "smooth"),
    ("main12_ipb", _cfg(qp=30, bit_depth=12, sao=True, rng_seed=58), "IPB",
     8, "smooth"),
    # at depth 14 the MC rounding offsets are 0 (the reference's BIT_DEPTH
    # 14 template): 1 << (14 - bd - 1) would be a negative shift there
    ("main14_ipp", _cfg(qp=33, bit_depth=14, sao=True, rng_seed=57), "IPP",
     7, "smooth"),
    # tests/test_tpu_backend.py: the 10-bit packed and the 16-bit wires
    ("main10_packed_wire", _cfg(qp=30, bit_depth=10, sao=True, rng_seed=41),
     "IP", 11, "smooth"),
    ("main14_wire", _cfg(qp=33, bit_depth=14, sao=True, rng_seed=43), "IP",
     13, "smooth"),
    # tests/test_rext_chroma.py
    *[(f"rext{c}_ipb", _cfg(qp=30, rng_seed=7, chroma_format=c), "IPPB", 7,
       "noise") for c in (2, 3)],
    *[(f"rext{c}_sao", _cfg(qp=30, rng_seed=17, chroma_format=c, sao=True),
       "IPPB", 17, "noise") for c in (2, 3)],
    *[(f"rext{c}_nxn_heavy", _cfg(qp=30, rng_seed=19, chroma_format=c,
                                  p_split=0.8, p_nxn=0.8, p_cbf_zero=0.3),
       "IP", 19, "noise") for c in (2, 3)],
    *[(f"rext{c}_main10", _cfg(qp=30, rng_seed=23, chroma_format=c,
                               bit_depth=10), "IP", 23, "noise")
      for c in (2, 3)],
    *[(f"rext{c}_ts_sdh", _cfg(qp=30, rng_seed=29, chroma_format=c,
                               transform_skip=True, sign_data_hiding=True),
       "IP", 29, "noise") for c in (2, 3)],
    # tests/test_rext_tools.py
    ("cross_component", _cfg(chroma_format=3, cross_component=True, qp=30,
                             **_REXT), "IPP", 7, "noise"),
    ("implicit_rdpcm", _cfg(transform_skip=True, implicit_rdpcm=True, qp=30,
                            **_REXT), "IPP", 7, "noise"),
    ("explicit_rdpcm", _cfg(explicit_rdpcm=True, transform_skip=True,
                            transquant_bypass=0.3, qp=30, **_REXT), "IPPP",
     7, "noise"),
    ("ts_rotation_context", _cfg(transform_skip=True,
                                 transform_skip_rotation=True,
                                 transform_skip_context=True, qp=30,
                                 **_REXT), "IPP", 7, "noise"),
    ("transquant_bypass", _cfg(transquant_bypass=0.4, qp=30, **_REXT), "IPP",
     7, "noise"),
    ("smoothing_disabled", _cfg(intra_smoothing_disabled=True, qp=30,
                                **_REXT), "IPP", 7, "noise"),
    ("chroma_qp_offset_lists", _cfg(
        chroma_qp_offsets=((2, -2), (5, 1), (-3, 4)), cu_qp_delta=True,
        qp=30, **_REXT), "IPP", 7, "noise"),
    ("persistent_rice_wpp", _cfg(persistent_rice=True, transform_skip=True,
                                 wpp=True, qp=22, **_REXT), "IPP", 7,
     "noise"),
    ("rext_combo", _cfg(w=96, h=64, rng_seed=11, chroma_format=3,
                        cross_component=True, transform_skip=True,
                        persistent_rice=True, implicit_rdpcm=True,
                        explicit_rdpcm=True, transform_skip_rotation=True,
                        transform_skip_context=True, transquant_bypass=0.2,
                        sign_data_hiding=True, qp=27), "IPBP", 11, "noise"),
]


@pytest.mark.parametrize("name,cfg,pattern,seed,source", CASES,
                         ids=[c[0] for c in CASES])
def test_port_formats_match_reference(name, cfg, pattern, seed, source):
    stream, recons = _encode(cfg, pattern, seed, source)
    dec = Decoder(backend=CudaBackend(device="cpu"), check_md5=True)
    frames = dec.decode_stream(stream)
    mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
            for f in frames]
    assert dec.md5_ok == 3 * len(pattern) and dec.md5_fail == 0
    assert_frames_equal(mine, recons, f"{name}: port-vs-recon")
    ref = RefDecoder(backend=None, check_md5=True).decode_stream(stream)
    assert_frames_equal(mine, [[np.asarray(p) for p in f.planes]
                               for f in ref], f"{name}: port-vs-reference")


def test_cross_component_reaches_the_frame_step():
    """The cross-component case carries alpha maps to the device: the
    plan's chroma planes get a ("ccmap", c) array and has_cc."""
    cfg = _cfg(chroma_format=3, cross_component=True, qp=30, **_REXT)
    stream, _ = _encode(cfg, "I", 7, "noise")
    rec = _PlanRecorder()
    Decoder(backend=rec, check_md5=True).decode_stream(stream)
    _plan, host, prof, _ = CudaBackend(device="cpu").prepare_host(
        rec.plans[0])
    assert prof["has_cc"]
    maps = [np.asarray(host[("ccmap", c)]) for c in (1, 2)
            if ("ccmap", c) in host]
    assert maps and all(m.shape == (64, 96) and m.any() for m in maps)


# ---------------------------------------------------------------------------
# the committed bench streams
# ---------------------------------------------------------------------------

def _bench(name):
    (path,) = glob.glob(os.path.join(ROOT, "streams", f"bench_{name}_*.265"))
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,shape", [
    ("rext_422", [(480, 832), (480, 416), (480, 416)]),
    ("rext_444", [(480, 832), (480, 832), (480, 832)])])
def test_rext_bench_stream_pipelined(name, shape, monkeypatch):
    """Every frame of the committed RExt bench stream through the port's
    PipelinedDecoder on the CPU: every MD5 passes, and intra_schedule (K1's
    rule on the card) accepts every frame's intra metadata."""
    calls = []
    inner = frame_step.intra_planes

    def checked(planes, resids, metas, c_idxs, bd, strong, c444):
        for p, m, c in zip(planes, metas, c_idxs):
            intra.intra_schedule(m.numpy(), p.shape[0], p.shape[1], c, c444)
        calls.append(len(planes))
        return inner(planes, resids, metas, c_idxs, bd, strong, c444)
    monkeypatch.setattr(frame_step, "intra_planes", checked)
    dec = PipelinedDecoder(backend=CudaBackend(device="cpu"))
    frames = list(dec.frames(_bench(name)))
    assert len(frames) == 8 and len(calls) == 8
    assert dec.md5_ok == 24 and dec.md5_fail == 0
    assert [tuple(p.shape) for p in frames[0].host_planes()] == shape


@pytest.mark.slow
def test_main10_bench_stream_cpu():
    """The committed Main-10 bench stream (1080p, 20 frames) through the
    port's CPU path: every MD5 passes (about 16 s)."""
    dec = Decoder(backend=CudaBackend(device="cpu"), check_md5=True)
    frames = dec.decode_stream(_bench("1080p_main10"))
    assert len(frames) == 20 and dec.md5_ok == 60 and dec.md5_fail == 0
