"""The port on a card: CUDA kernels against their plain versions, and
encoder-made streams decoded through the kernels.

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
@pytest.mark.parametrize("kernel", ["k1", "k1_rejects", "k2", "k3", "k4"])
def test_kernel_matches_plain_on_card(kernel):
    """K1-K4 on seeded inputs at small shapes, tolerance 0 (the checks of
    chip_smoke.py's kernel phase): K1 on quadtrees in valid decode order,
    and its forward-dependency and overlap cases, which must raise; K2 on
    one pass of every tile size and plane, depths 8 and 10; K3 on a mixed
    pass of every tile shape, int32 and int16; K4 on three-plane frames,
    sizes that are not multiples of the CTB among them, depths 8 and
    10."""
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
