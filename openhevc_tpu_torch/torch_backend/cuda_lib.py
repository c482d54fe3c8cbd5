"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Every source compiles with its own ``nvcc`` process, all started together,
into an object file; one more ``nvcc`` links them into
``openhevc_tpu_torch/build/libohk.so``.  The library has a plain C
interface (one ``extern "C"`` launcher per kernel, returning
``cudaGetLastError()``) and loads with ``ctypes``: no PyTorch headers are
compiled, so a cold build takes seconds, not minutes.  The build is cached
by a hash of the sources and flags and happens at first CUDA use, never at
import.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB = os.path.join(BUILD, "libohk.so")
_STAMP = os.path.join(BUILD, "libohk.stamp")

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int

# launcher name -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    # launch (host struct, copied into the launches), stream
    "ohk_intra": [_P, _P],
    "ohk_intra_size": [],
    # pass (host struct, copied into the launch), shared bytes, stream
    "ohk_mc_pass": [_P, _I, _P],
    "ohk_mc_pass_size": [],
    # pass (host struct, copied into the launch), element bytes, stream
    "ohk_paint_pass": [_P, _I, _P],
    "ohk_paint_pass_size": [],
    # frame (host struct; the launcher encodes its tensor maps), stream
    "ohk_filter_frame": [_P, _P],
    "ohk_filter_frame_size": [],
    # frame (host struct; the launcher encodes its tensor maps), stream
    "ohk_upsample_frame": [_P, _P],
    "ohk_upsample_frame_size": [],
}

_lib = None
_lock = threading.Lock()


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    cand = "/usr/local/cuda/bin/nvcc"
    return cand if os.path.exists(cand) else "nvcc"


def _want():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build(force=False):
    """Compile ``csrc/*.cu`` into ``build/libohk.so`` unless the cached
    build matches the sources and flags.  Returns the library path."""
    os.makedirs(BUILD, exist_ok=True)
    want = _want()
    have = ""
    if os.path.exists(_STAMP):
        with open(_STAMP) as f:
            have = f.read().strip()
    if not force and have == want and os.path.exists(LIB):
        return LIB
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    procs = []
    objs = []
    for src in cus:
        obj = os.path.join(BUILD, os.path.basename(src)[:-3] + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc] + FLAGS + ["-I", CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{os.path.basename(src)}:\n{out.decode()}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = LIB + f".tmp{os.getpid()}"
    subprocess.run([nvcc] + ARCH + ["-shared", "-o", tmp] + objs,
                   check=True)
    os.replace(tmp, LIB)
    with open(_STAMP, "w") as f:
        f.write(want)
    return LIB


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name, dev, *args):
    """Call launcher ``name`` with ``dev`` (the tensors' device) current in
    this thread, so that what the launcher asks of the runtime (the SM
    count, the launch itself) concerns that device whatever device the
    thread had current; raise when it reports a CUDA error."""
    fn = getattr(lib(), name)
    with torch.cuda.device(dev):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")


@functools.cache
def check_size(name, size):
    """Launcher ``name`` copies a host struct that Python packs with
    ``struct``; the library exports the struct's C size as ``name_size``.
    Raise unless the two agree."""
    if getattr(lib(), name + "_size")() != size:
        raise RuntimeError(f"{name}: the struct packed in Python does not "
                           f"match its layout in csrc/")


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream
