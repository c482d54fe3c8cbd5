"""The port's Decoder runs on the card unless the caller names another
reconstruction.

``Decoder()`` builds ``CudaBackend()``, which picks ``cuda`` and raises
where there is no card; ``backend="numpy"`` names the host NumPy
reconstruction (``recon_np``).  Whether a card is present is decided
inside each test, never at import.
"""

import numpy as np
import pytest
import torch

from openhevc_tpu.encoder import Encoder, EncoderConfig
from tests.util_e2e import make_source, assert_frames_equal

from openhevc_tpu_torch.decoder.frontend import Decoder


@pytest.mark.parametrize("kwargs", [{}, {"backend": None}],
                         ids=["default", "backend_none"])
def test_decoder_defaults_to_the_card(kwargs):
    if torch.cuda.is_available():
        dec = Decoder(**kwargs)
        assert dec.backend.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Decoder(**kwargs)


def test_decoder_numpy_by_name_decodes_exactly():
    cfg = EncoderConfig(width=128, height=64, qp=30, rng_seed=35)
    rng = np.random.default_rng(5)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, cfg.width, cfg.height)
    recons = []
    for i, st in enumerate("IP"):
        src = [np.roll(base[0], i, 0), np.roll(base[1], i, 0),
               np.roll(base[2], i, 0)]
        nal, recon, _ = enc.encode_frame(src, st)
        stream += nal
        recons.append([np.asarray(p).copy() for p in recon])
    dec = Decoder(backend="numpy", check_md5=True)
    assert dec.backend is None
    frames = dec.decode_stream(stream)
    assert dec.md5_ok == 6 and dec.md5_fail == 0
    assert_frames_equal([[np.asarray(p) for p in f.planes] for f in frames],
                        recons, "numpy by name")


def test_decoder_rejects_unknown_backend_name():
    with pytest.raises(ValueError, match="unknown backend"):
        Decoder(backend="cpu")
