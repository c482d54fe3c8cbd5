"""The port on a card: CUDA kernels against their plain versions, and
encoder-made streams decoded through the kernels: 8-bit 4:2:0, 4:2:2,
4:4:4 with cross-component prediction, depths 12 and 14, and two-layer
SHVC.

Marked ``cuda``; skips where there is no card.  The machine with the card
has no JAX, and tests/conftest.py imports it, so run this file there with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.  The
JAX package's encoder and test helpers import no JAX.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from openhevc_tpu.encoder import Encoder, EncoderConfig
from util_e2e import make_source, assert_frames_equal   # tests/ dir


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k1_rejects", "k2", "k3", "k4",
                                    "k1_formats", "k2_formats",
                                    "k3_formats", "k4_formats"])
def test_kernel_matches_plain_on_card(kernel):
    """K1-K4 on seeded inputs at small shapes, tolerance 0 (the checks of
    chip_smoke.py's kernel phase): K1 on quadtrees in valid decode order,
    and its forward-dependency and overlap cases, which must raise; K2 on
    one pass of every tile size and plane, depths 8 and 10; K3 on a mixed
    pass of every tile shape, int32 and int16; K4 on three-plane frames,
    sizes that are not multiples of the CTB among them, depths 8 and
    10.  The *_formats checks: K1 at depths 10-14, on 4:2:2 chroma planes
    and with c444; K2 for each chroma subsampling at depths 8-14; K3 on
    4:2:2 and 4:4:4 plane shapes; K4 at depths 12 and 14 and with 4:2:2
    and 4:4:4 chroma grids."""
    _need_card()
    rng = np.random.default_rng(chip_smoke.SEED)
    check = getattr(chip_smoke, f"check_{kernel}")
    assert check(rng, torch.device("cuda")) == 0


CASES = [
    ("slice_shape", EncoderConfig(width=192, height=128, qp=32, log2_ctb=6,
                                  wpp=True, sao=True, rng_seed=36), "IPPP"),
    ("inter_b_sao", EncoderConfig(width=128, height=64, qp=31, sao=True,
                                  rng_seed=36), "IPBB"),
    ("amp", EncoderConfig(width=128, height=128, qp=30, amp=True, p_amp=0.8,
                          p_skip=0.1, log2_ctb=6, rng_seed=42), "IPP"),
    ("intra_qp0", EncoderConfig(width=128, height=64, qp=0, rng_seed=33),
     "I"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,pattern", CASES, ids=[c[0] for c in CASES])
def test_port_decode_on_card(name, cfg, pattern):
    """Whole decodes through the kernels, on the card by default: the
    encoder's reconstruction and every SEI MD5 must match, every kernel
    the frames need ran, K3 painted at most two passes a frame, K2 ran
    at most once a frame that predicts from references, and K4 exactly
    once a frame."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.torch_backend import device
    rng = np.random.default_rng(len(name))
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, cfg.width, cfg.height)
    recons = []
    for i, st in enumerate(pattern):
        src = [np.roll(np.roll(base[0], i, 0), 2 * i, 1),
               np.roll(base[1], i, 0), np.roll(base[2], i, 0)]
        nal, recon, _ = enc.encode_frame(src, st)
        stream += nal
        recons.append([np.asarray(p).copy() for p in recon])
    device.reset_launches()
    dec = Decoder(check_md5=True)
    frames = dec.decode_stream(stream)
    counts = device.launches()
    mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
            for f in frames]
    assert dec.md5_ok == 3 * len(pattern) and dec.md5_fail == 0
    assert_frames_equal(mine, recons, name)
    assert counts["intra"] > 0 and counts["paint"] > 0 and \
        counts["filter"] > 0
    assert counts["paint"] <= 2 * len(pattern)
    assert counts["filter"] == len(pattern)
    inter = sum(st in "PB" for st in pattern)
    assert counts["mc"] <= inter
    if inter:
        assert counts["mc"] > 0


@pytest.mark.cuda
def test_pipelined_matches_serial_on_card():
    """An encoder-made IPPBP stream (TMVP, SAO) through PipelinedDecoder()
    and through Decoder(), both on the card by default: the same frames
    in the same order, plane for plane, tolerance 0, every SEI MD5
    passing, with one plan upload a frame in the pipeline."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.runtime import PipelinedDecoder
    from openhevc_tpu_torch.torch_backend import device
    cfg = EncoderConfig(width=192, height=128, qp=30, log2_ctb=6, sao=True,
                        temporal_mvp=True, rng_seed=37)
    rng = np.random.default_rng(37)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, cfg.width, cfg.height)
    for i, st in enumerate("IPPBP"):
        src = [np.roll(np.roll(base[0], i, 0), 2 * i, 1),
               np.roll(base[1], i, 0), np.roll(base[2], i, 0)]
        stream += enc.encode_frame(src, st)[0]
    serial = Decoder(check_md5=True)
    want = [[np.asarray(p) for p in f.host_planes()]
            for f in serial.decode_stream(stream)]
    dec = PipelinedDecoder(check_md5=True)
    device.reset_launches()
    got = [[np.asarray(p) for p in f.host_planes()]
           for f in dec.frames(stream)]
    assert device.h2d_copies() == 5
    assert dec.md5_ok == 15 and dec.md5_fail == 0 and serial.md5_ok == 15
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _noise_stream(cfg, pattern, seed):
    """An encoder-made stream of uniform planes at the configuration's
    chroma format and depth (the RExt tests' source), and its
    reconstruction."""
    rng = np.random.default_rng(seed)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    hs = 1 if cfg.chroma_format in (1, 2) else 0
    vs = 1 if cfg.chroma_format == 1 else 0
    h, w, hi = cfg.height, cfg.width, 1 << cfg.bit_depth
    base = [rng.integers(0, hi, s).astype(np.int32)
            for s in ((h, w), (h >> vs, w >> hs), (h >> vs, w >> hs))]
    recons = []
    for i, st in enumerate(pattern):
        nal, recon, _ = enc.encode_frame([np.roll(p, i, 0) for p in base],
                                         st)
        stream += nal
        recons.append([np.asarray(p).copy() for p in recon])
    return stream, recons


FORMAT_CASES = [
    ("rext_422_sao", EncoderConfig(width=96, height=64, qp=30, rng_seed=17,
                                   chroma_format=2, sao=True), "IPPB"),
    ("rext_444_cross_component", EncoderConfig(
        width=96, height=64, qp=30, rng_seed=7, chroma_format=3,
        cross_component=True, transform_skip=True, implicit_rdpcm=True),
     "IPP"),
    ("main12", EncoderConfig(width=96, height=64, qp=30, bit_depth=12,
                             sao=True, rng_seed=58), "IPB"),
    ("main14", EncoderConfig(width=96, height=64, qp=33, bit_depth=14,
                             sao=True, rng_seed=57), "IPP"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,pattern", FORMAT_CASES,
                         ids=[c[0] for c in FORMAT_CASES])
def test_port_formats_on_card(name, cfg, pattern):
    """RExt chroma formats (4:4:4 with cross-component prediction) and
    depths 12 and 14 through the kernels on the card: the encoder's
    reconstruction and every SEI MD5 must match, every kernel ran."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.torch_backend import device
    stream, recons = _noise_stream(cfg, pattern, len(name))
    device.reset_launches()
    dec = Decoder(check_md5=True)
    frames = dec.decode_stream(stream)
    counts = device.launches()
    mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
            for f in frames]
    assert dec.md5_ok == 3 * len(pattern) and dec.md5_fail == 0
    assert_frames_equal(mine, recons, name)
    assert min(counts.values()) > 0
    assert counts["filter"] == len(pattern)


@pytest.mark.cuda
def test_shvc_on_card():
    """A two-layer 2x spatial SHVC stream (IPBP, TMVP) through
    ShvcDecoder(): both layers on the card, the inter-layer upsample on
    the device; both layers equal the encoder's reconstruction, every MD5
    of both layers passes, every kernel ran."""
    _need_card()
    from openhevc_tpu.encoder.shvc import ShvcEncoder
    from openhevc_tpu_torch.decoder.shvc import ShvcDecoder
    from openhevc_tpu_torch.torch_backend import device
    cfg_bl = EncoderConfig(width=48, height=32, qp=30, rng_seed=29,
                           temporal_mvp=True)
    cfg_el = EncoderConfig(width=96, height=64, qp=30, rng_seed=31,
                           temporal_mvp=True)
    enc = ShvcEncoder(cfg_bl, cfg_el)
    stream = b"".join(enc.parameter_set_nals())
    rng = np.random.default_rng(42)
    src_bl = make_source(rng, 48, 32)
    src_el = make_source(rng, 96, 64)
    want = [[], []]
    for i, t in enumerate("IPBP"):
        au, rb, re = enc.encode_frame([np.roll(p, i, 0) for p in src_bl],
                                      [np.roll(p, i, 1) for p in src_el], t)
        stream += au
        want[0].append([np.asarray(p).astype(np.int32) for p in rb])
        want[1].append([np.asarray(p).astype(np.int32) for p in re])
    device.reset_launches()
    dec = ShvcDecoder(check_md5=True)
    outs = dec.decode_stream(stream)
    assert dec.md5_ok == 24 and dec.md5_fail == 0
    assert min(device.launches().values()) > 0
    for lid in (0, 1):
        assert outs[lid][0].planes[0].device.type == "cuda"
        mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
                for f in outs[lid]]
        assert_frames_equal(mine, want[lid], f"layer {lid}")
