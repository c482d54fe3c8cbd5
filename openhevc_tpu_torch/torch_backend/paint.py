"""K3: paint passes of disjoint tiles into planes (csrc/paint.cu), and the
plain version.

Counterpart of ``openhevc_tpu/tpu/mc_pallas.py::band_paint``, without the
band padding: tiles land straight in the (H, W) plane, samples outside it
are dropped.  A pass is a list of groups ``(plane, tiles, xs, ys, valid)``
of one dtype, painted by one kernel launch: frame_step paints all MC
predictions of a frame as one pass and its residual canvas as another.
Planes are updated in place (the tiles of a pass are disjoint, and the
caller owns a fresh buffer in every use), which saves a copy of the plane
per call.
"""

import struct

import torch

from . import cuda_lib, device

MAX_GROUPS = 24     # csrc/paint.cu kMaxGroups
THREADS = 256       # csrc/paint.cu kThreads
# csrc/paint.cu PaintGroup: tiles, xs, ys, valid, plane pointers; H, W,
# log2h, log2w, log2c, items, first_cta; padding to 8 bytes
_GROUP = struct.Struct("@5P7i4x")
# PaintPass: MAX_GROUPS groups, n_groups, n_ctas
_PASS_SIZE = MAX_GROUPS * _GROUP.size + 8


def paint_plain_(plane, tiles, xs, ys, valid):
    """Plain version of one group: write tiles (N, h, w) at (ys, xs) into
    plane (H, W), in place, for rows with valid != 0."""
    H, W = plane.shape
    n, h, w = tiles.shape
    keep = valid != 0
    gy = ys.long()[:, None, None] + torch.arange(h, device=plane.device)[
        None, :, None]
    gx = xs.long()[:, None, None] + torch.arange(w, device=plane.device)[
        None, None, :]
    inside = keep[:, None, None] & (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
    gy, gx = torch.broadcast_to(gy, tiles.shape), torch.broadcast_to(
        gx, tiles.shape)
    plane[gy[inside], gx[inside]] = tiles[inside]
    return plane


def paint_groups_plain_(groups):
    """Plain version of a pass: each group through paint_plain_."""
    for g in groups:
        paint_plain_(*g)


def _check(groups):
    dev, dt = groups[0][0].device, groups[0][0].dtype
    if dt not in (torch.int32, torch.int16):
        raise ValueError("paint: int32 or int16 planes only")
    for plane, tiles, xs, ys, valid in groups:
        if plane.dtype != dt or tiles.dtype != dt:
            raise ValueError("paint: one dtype for every plane and tile "
                             "of a pass")
        if plane.dim() != 2 or tiles.dim() != 3:
            raise ValueError("paint: (H, W) planes and (N, h, w) tiles "
                             "expected")
        n = tiles.shape[:1]
        for v in (xs, ys, valid):
            if v.dtype != torch.int32 or v.shape != n:
                raise ValueError("paint: (N,) int32 vectors expected")
        for t in (plane, tiles, xs, ys, valid):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("paint: contiguous tensors on one device "
                                 "expected")
    return dev, dt


def _log2(v):
    if v < 1 or v & (v - 1):
        raise ValueError("paint: the kernel takes power-of-two tile shapes")
    return v.bit_length() - 1


def paint_groups_(groups):
    """Paint one pass, in place: every group ``(plane, tiles, xs, ys,
    valid)`` writes its tiles (N, h, w) at (ys, xs) into its plane (H, W)
    for rows with valid != 0.  Planes may repeat across groups (the tiles
    must be disjoint).  One dtype, int32 or int16, per pass.  CPU tensors
    take the plain version; CUDA tensors one launch of the kernel."""
    if not groups:
        return
    dev, dt = _check(groups)
    groups = [g for g in groups if g[1].shape[0] > 0]
    if not groups:
        return
    if dev.type == "cpu":
        return paint_groups_plain_(groups)
    if dev.type != "cuda":
        raise ValueError(f"paint: unsupported device {dev}")
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"paint: at most {MAX_GROUPS} groups a pass")
    cuda_lib.check_size("ohk_paint_pass", _PASS_SIZE)
    elem = groups[0][0].element_size()
    vec = 16 // elem
    desc = bytearray(_PASS_SIZE)
    cta = 0
    for k, (plane, tiles, xs, ys, valid) in enumerate(groups):
        n, h, w = tiles.shape
        log2c = _log2(max(w // vec, 1))
        items = n * h << log2c
        if items >= 1 << 31:
            raise ValueError("paint: group too large")
        H, W = plane.shape
        _GROUP.pack_into(desc, k * _GROUP.size, tiles.data_ptr(),
                         xs.data_ptr(), ys.data_ptr(), valid.data_ptr(),
                         plane.data_ptr(), H, W, _log2(h), _log2(w), log2c,
                         items, cta)
        cta += -(-items // THREADS)
    struct.pack_into("@2i", desc, MAX_GROUPS * _GROUP.size, len(groups), cta)
    cuda_lib.launch("ohk_paint_pass", bytes(desc), elem,
                    cuda_lib.stream_ptr(dev))
    device.count("paint")
