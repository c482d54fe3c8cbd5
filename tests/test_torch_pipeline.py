"""The port's pipelined decoder on the CPU, against the reference.

``openhevc_tpu_torch.runtime.PipelinedDecoder`` runs the parser thread, the
dispatcher thread and the output queue of
``openhevc_tpu/runtime/pipeline.py``.  Its frames must equal the JAX
package's serial ``Decoder(backend=None)`` (the exact NumPy pipeline),
plane for plane, with every decoded-picture-hash SEI checked; the
committed bench streams decode through it with every MD5 passing; an error
in the dispatcher reaches the caller and ends both threads; K1's error
word raises, naming the frame's POC, when the frame is fetched or handed
out (by the pipeline, or by the serial decoder's ``decode_stream``).
"""

import os
import threading

import numpy as np
import pytest
import torch

from openhevc_tpu.encoder import Encoder, EncoderConfig
from openhevc_tpu.decoder.frontend import Decoder as RefDecoder
from tests.util_e2e import make_source

from openhevc_tpu_torch.decoder.frontend import Decoder
from openhevc_tpu_torch.decoder.refs import Frame
from openhevc_tpu_torch.runtime import PipelinedDecoder
from openhevc_tpu_torch.torch_backend import CudaBackend, upload
from openhevc_tpu_torch.torch_backend.intra import IntraErrors
from openhevc_tpu_torch.torch_backend.wire import Wire

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = os.path.join(ROOT, "streams")
THREADS = ("pipeline-parser", "pipeline-dispatcher")


def _stream():
    """tests/test_pipeline.py's stream: TMVP, long-term references, SAO,
    IPPBPPIPP with a mid-stream IDR."""
    rng = np.random.default_rng(5)
    enc = Encoder(EncoderConfig(width=96, height=64, qp=30, rng_seed=13,
                                temporal_mvp=True, long_term=True, sao=True))
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, 96, 64)
    for i, t in enumerate("IPPBPPIPP"):
        src = [np.roll(p, i, 0) for p in base]
        nal, _, _ = enc.encode_frame(src, t)
        stream += nal
    return stream


def _np(p):
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def _backend_with_k1_error(poc):
    """A CPU backend whose frame `poc` carries a set K1 error word."""
    be = CudaBackend(device="cpu")
    inner = be.decode_frame

    def with_error(plan, dpb):
        planes, wire = inner(plan, dpb)
        if plan.poc == poc:
            wire.errors = IntraErrors(torch.tensor([1], dtype=torch.int32))
        return planes, wire
    be.decode_frame = with_error
    return be


def _no_pipeline_threads():
    return not any(t.name in THREADS and t.is_alive()
                   for t in threading.enumerate())


@pytest.mark.parametrize("backend,use_native", [
    ("numpy", False), ("numpy", True), ("cuda_backend_cpu", True)])
def test_pipelined_matches_serial(backend, use_native):
    """The mirror of tests/test_pipeline.py::test_pipelined_matches_serial,
    tolerance 0, against the reference's serial NumPy decoder."""
    stream = _stream()
    serial = RefDecoder(backend=None, check_md5=True)
    ref = serial.decode_stream(stream)
    be = CudaBackend(device="cpu") if backend == "cuda_backend_cpu" \
        else backend
    dec = PipelinedDecoder(backend=be, check_md5=True, use_native=use_native)
    got = dec.decode_stream(stream)
    assert len(got) == len(ref)
    assert dec.md5_fail == 0 and dec.md5_ok == 3 * len(ref)
    for a, b in zip(got, ref):
        assert a.poc == b.poc
        for pa, pb in zip(a.planes, b.planes):
            np.testing.assert_array_equal(_np(pa), np.asarray(pb))
    assert _no_pipeline_threads()


def _bench(name):
    (path,) = [os.path.join(STREAMS, f) for f in os.listdir(STREAMS)
               if f.startswith(f"bench_{name}_") and f.endswith(".265")]
    with open(path, "rb") as f:
        return f.read()


BENCH = [
    pytest.param("bqmall_480p", 16, (480, 832), id="bqmall_480p"),
    pytest.param("shvc_4k60", 4, (1080, 1920), id="shvc_4k60_base"),
    pytest.param("4k_main", 10, (2160, 3840), id="4k_main",
                 marks=pytest.mark.slow),
]


@pytest.mark.parametrize("name,n_frames,shape", BENCH)
def test_pipelined_bench_stream(name, n_frames, shape):
    """A committed 8-bit 4:2:0 bench stream through the pipeline and the
    kernels' plain versions: every frame, every MD5 (the SHVC stream's
    base layer only)."""
    dec = PipelinedDecoder(backend=CudaBackend(device="cpu"),
                           check_md5=True)
    frames = dec.decode_stream(_bench(name))
    assert len(frames) == n_frames
    assert dec.md5_ok == 3 * n_frames and dec.md5_fail == 0
    half = (shape[0] // 2, shape[1] // 2)
    assert [tuple(p.shape) for p in frames[0].host_planes()] == \
        [shape, half, half]


def test_dispatcher_error_reaches_caller():
    """A dispatcher that raises in mid-stream: the error reaches the
    caller, and both threads end."""
    dec = PipelinedDecoder(backend="numpy", check_md5=True)
    inner = dec._reconstruct
    seen = []

    def failing(plan):
        seen.append(plan.poc)
        if len(seen) == 3:
            raise ValueError("dispatch failed on purpose")
        return inner(plan)
    dec._reconstruct = failing
    result = {}

    def run():
        try:
            dec.decode_stream(_stream())
        except ValueError as e:
            result["error"] = e
    watchdog = threading.Thread(target=run)
    watchdog.start()
    watchdog.join(timeout=60)
    assert not watchdog.is_alive(), "the pipeline did not end"
    assert "on purpose" in str(result.get("error"))
    assert len(seen) == 3
    assert _no_pipeline_threads()


def test_wire_raises_on_k1_error_word():
    """R1's plumbing: a wire whose K1 error word is set makes
    host_planes() raise, naming the frame's POC, and raise again when
    asked again."""
    planes = [torch.zeros(8, 8, dtype=torch.int32),
              torch.zeros(4, 4, dtype=torch.int32),
              torch.zeros(4, 4, dtype=torch.int32)]
    wire = torch.cat([p.to(torch.uint8).reshape(-1) for p in planes])
    errors = IntraErrors(torch.tensor([2], dtype=torch.int32))
    frame = Frame(poc=7, planes=planes, wire=Wire(wire, None, errors, 7))
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"POC 7\).*later block"):
            frame.host_planes()
    ok = Frame(poc=8, planes=planes, wire=Wire(
        wire, None, IntraErrors(torch.tensor([0], dtype=torch.int32)), 8))
    assert [p.shape for p in ok.host_planes()] == [(8, 8), (4, 4), (4, 4)]


def test_pipeline_hands_out_k1_error():
    """A frame that is never fetched (no MD5 check, no wire prefetch) still
    raises at the latest when the pipeline hands it to the caller."""
    dec = PipelinedDecoder(backend=_backend_with_k1_error(2),
                           check_md5=False, prefetch_wire=False)
    with pytest.raises(RuntimeError, match="POC 2"):
        for _f in dec.frames(_stream()):
            pass
    assert _no_pipeline_threads()


def test_serial_decoder_hands_out_k1_error():
    """The serial Decoder too: a frame that is never fetched raises at the
    latest when decode_stream returns it."""
    dec = Decoder(backend=_backend_with_k1_error(2), check_md5=False,
                  prefetch_wire=False)
    with pytest.raises(RuntimeError, match="POC 2"):
        dec.decode_stream(_stream())


def test_plan_layout_one_buffer():
    """Every array of a frame in one buffer: sections by dtype, 16-byte
    aligned; arrays aligned to four elements; the int32 views that the
    upload returns hold the values written."""
    rng = np.random.default_rng(3)
    arrays = {("a",): rng.integers(-999, 999, (5, 3)).astype(np.int16),
              ("b",): rng.integers(-99, 99, 7).astype(np.int8),
              ("c",): rng.integers(0, 2, (3, 3)).astype(np.uint8),
              ("d",): rng.integers(-999, 999, 9).astype(np.int16)}
    layout, nbytes = upload.plan_layout(
        {k: (a.dtype, a.shape) for k, a in arrays.items()})
    assert [s[0] for s in layout] == list(upload.SECTIONS)
    for dt, start, n, items in layout:
        assert start % 16 == 0 and start + n * dt.itemsize <= nbytes
        assert all(off % 4 == 0 for _k, off, _s in items)
    host = upload.host_plan(layout, nbytes)
    for k, a in arrays.items():
        host[k][...] = a
    got = upload.to_device(host, torch.device("cpu"))
    for k, a in arrays.items():
        assert got[k].dtype == torch.int32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), a.astype(np.int32))


@pytest.mark.parametrize("kwargs", [{}, {"backend": None}],
                         ids=["default", "backend_none"])
def test_pipeline_defaults_to_the_card(kwargs):
    """PipelinedDecoder() reconstructs on the card (where the reference's
    None means NumPy) and raises where there is none."""
    if torch.cuda.is_available():
        dec = PipelinedDecoder(**kwargs)
        assert dec.backend.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelinedDecoder(**kwargs)


def test_pipeline_backend_names():
    assert PipelinedDecoder(backend="numpy").backend is None
    with pytest.raises(ValueError, match="unknown backend"):
        PipelinedDecoder(backend="cpu")
