"""openhevc_tpu_torch: the HEVC/H.265 decoder on PyTorch and CUDA.

A port of ``openhevc_tpu`` (JAX on a TPU) to an NVIDIA H100.  The host
front-end (NAL/RBSP, parameter sets, the C++ CABAC walk, FramePlan, DPB)
is this package's own copy of the reference's; the device back-end is
``torch_backend`` with hand-written CUDA kernels under ``csrc/``.  Nothing
here imports JAX or the ``openhevc_tpu`` package.

    from openhevc_tpu_torch.decoder.frontend import Decoder
    frames = Decoder(check_md5=True).decode_stream(data)     # on the card

``Decoder(backend=CudaBackend(device="cpu"))`` runs the same frame step
with the kernels' plain PyTorch versions, ``Decoder(backend="numpy")`` the
host NumPy reconstruction; ``Decoder()`` raises where there is no card.
"""

__version__ = "0.1.0"
