"""Device choice, numeric guards and kernel launch counters.

Entry points run on ``cuda`` unless the caller asks for ``cpu`` (the
tests do).  A CUDA tensor always goes through its hand-written kernel; the
plain PyTorch versions serve CPU tensors only, so a run on the card can
never fall back to them silently.  The counters are the one piece of
module state: each kernel wrapper adds one where it launches its kernel,
and the plan upload one for each host-to-device copy it makes, so a caller
can show that a decode really went through the kernels, with one upload a
frame.
"""

import numpy as np
import torch

KERNELS = ("intra", "mc", "paint", "filter")
LAUNCHES = {k: 0 for k in KERNELS}
H2D = "h2d"             # host-to-device copies, counted beside the kernels
LAUNCHES[H2D] = 0


def pick_device(device=None):
    """``cuda`` by default; raises when no card is present unless ``cpu``
    was asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    check_exact_math()
    return dev


def check_exact_math():
    """The residual transform relies on exact matmul products; TF32 would
    round them.  Refuse to run with TF32 matmul enabled.  The port calls no
    cuDNN operation, so cuDNN's TF32 flag (on by default in PyTorch) cannot
    touch its results, and a process-wide setting is left to the caller."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is enabled; the integer-exact "
                           "transforms need it off")


def table(values, dev, dtype=None):
    """A constant table as a tensor on dev (counted as a host-to-device
    copy on the card).  Callers cache it: one copy a table and device, not
    one a frame."""
    if dev.type == "cuda":
        count(H2D)
    return torch.as_tensor(np.asarray(values, dtype), device=dev)


def count(kernel):
    LAUNCHES[kernel] += 1


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches():
    """-> {kernel: launches} for the four kernels."""
    return {k: LAUNCHES[k] for k in KERNELS}


def h2d_copies():
    return LAUNCHES[H2D]
