"""K2: motion-compensation interpolation of a frame's MC pass (csrc/mc.cu,
one launch for every tile size and plane) and its plain version.

Counterpart of ``openhevc_tpu/tpu/mc_pallas.py::mc_batch_pallas`` with the
semantics of ``tpu/mc.py::mc_batch`` (the XLA path): every window
coordinate clamps into the picture, so motion vectors may point any
distance outside it.
"""

import struct
from typing import NamedTuple

import numpy as np
import torch

from ..model.mc import QPEL_FILTERS, EPEL_FILTERS
from . import cuda_lib, device

QPEL = np.vstack([[0, 0, 0, 64, 0, 0, 0, 0], QPEL_FILTERS]).astype(np.int32)
EPEL = np.vstack([[0, 64, 0, 0], EPEL_FILTERS]).astype(np.int32)


def _phases(xs, ys, mvx, mvy, is_luma, hs, vs):
    if is_luma:
        return (mvx & 3, mvy & 3, xs + (mvx >> 2) - 3, ys + (mvy >> 2) - 3)
    return ((mvx & ((1 << (2 + hs)) - 1)) << (1 - hs),
            (mvy & ((1 << (2 + vs)) - 1)) << (1 - vs),
            xs + (mvx >> (2 + hs)) - 1, ys + (mvy >> (2 + vs)) - 1)


def mc_plain(refs, sel, xs, ys, mvx, mvy, w, h, is_luma, bd, hs=1, vs=1):
    """Plain version: (N, h, w) int32 14-bit intermediates."""
    _, H, W = refs.shape
    taps = 8 if is_luma else 4
    table = torch.as_tensor(QPEL if is_luma else EPEL, device=refs.device)
    fx, fy, bx, by = _phases(xs.long(), ys.long(), mvx.long(), mvy.long(),
                             is_luma, hs, vs)
    rows = torch.clamp(by[:, None] + torch.arange(h + taps - 1,
                                                  device=refs.device), 0, H - 1)
    cols = torch.clamp(bx[:, None] + torch.arange(w + taps - 1,
                                                  device=refs.device), 0, W - 1)
    win = refs[sel.long()[:, None, None], rows[:, :, None], cols[:, None, :]]
    hf = table[fx]
    tmp = torch.zeros((xs.shape[0], h + taps - 1, w), dtype=torch.int32,
                      device=refs.device)
    for t in range(taps):
        tmp += hf[:, t][:, None, None] * win[:, :, t:t + w]
    tmp = tmp >> (bd - 8)
    vf = table[fy]
    out = torch.zeros((xs.shape[0], h, w), dtype=torch.int32,
                      device=refs.device)
    for t in range(taps):
        out += vf[:, t][:, None, None] * tmp[:, t:t + h, :]
    return out >> 6


class McGroup(NamedTuple):
    """One group of a pass: N work items of one (w, h) tile shape on one
    plane.  refs (R, H, W) int32; sel/xs/ys/mvx/mvy (N,) int32; the item's
    origin is (xs >> sx, ys >> sy) (chroma planes share the luma work
    vectors); hs/vs subsample the motion's fraction (4:2:0: 1, 1)."""
    refs: torch.Tensor
    sel: torch.Tensor
    xs: torch.Tensor
    ys: torch.Tensor
    mvx: torch.Tensor
    mvy: torch.Tensor
    w: int
    h: int
    is_luma: bool
    bd: int
    hs: int = 1
    vs: int = 1
    sx: int = 0
    sy: int = 0


def mc_pass_plain(groups):
    """Plain version of mc_pass: each group through mc_plain."""
    return [mc_plain(g.refs, g.sel, g.xs >> g.sx, g.ys >> g.sy, g.mvx, g.mvy,
                     g.w, g.h, g.is_luma, g.bd, g.hs, g.vs) for g in groups]


MAX_GROUPS = 24          # csrc/mc.cu kMaxGroups
OUT_PER_CTA = 1024       # output samples a thread block aims at
SMEM_MAX = 48 * 1024     # without the opt-in attribute
_TABLES = 64             # csrc/mc.cu kTables
# csrc/mc.cu McGroup: refs, sel, xs, ys, mvx, mvy, out pointers; R, H, W,
# N, log2w, log2h, taps, sx, sy, hs, vs, bd, ipc, first_cta
_GROUP = struct.Struct("@7P14i")
# McPass: MAX_GROUPS groups, n_groups, n_ctas
_PASS_SIZE = MAX_GROUPS * _GROUP.size + 8


def items_per_cta(w, h, taps):
    """-> (items a thread block takes, its shared memory in bytes): about
    OUT_PER_CTA output samples, within SMEM_MAX."""
    # int32 an item: its window, its horizontal pass, 5 metadata words
    per = (h + taps - 1) * (w + taps - 1) + (h + taps - 1) * w + 5
    ipc = max(1, OUT_PER_CTA // (w * h))
    while ipc > 1 and (_TABLES + ipc * per) * 4 > SMEM_MAX:
        ipc //= 2
    return ipc, (_TABLES + ipc * per) * 4


def _log2(v):
    if v < 1 or v > 64 or v & (v - 1):
        raise ValueError("mc: tile sides must be powers of two up to 64")
    return v.bit_length() - 1


def _check(groups):
    """The kernel's contract; raises (converts nothing)."""
    dev = groups[0].refs.device
    for g in groups:
        if (g.refs.dim() != 3 or g.refs.dtype != torch.int32
                or g.refs.device != dev or not g.refs.is_contiguous()):
            raise ValueError("mc: refs must be contiguous (R, H, W) int32 "
                             "on one device")
        n = g.xs.shape[0]
        for v in (g.sel, g.xs, g.ys, g.mvx, g.mvy):
            if (v.dtype != torch.int32 or v.shape != (n,) or v.device != dev
                    or not v.is_contiguous()):
                raise ValueError("mc: contiguous (N,) int32 index vectors "
                                 "on the refs' device expected")
        _log2(g.w)
        _log2(g.h)
        if not (8 <= g.bd <= 14 and g.hs in (0, 1) and g.vs in (0, 1)
                and g.sx >= 0 and g.sy >= 0):
            raise ValueError("mc: unsupported arguments")
    return dev


def pack_pass(groups, outs):
    """The kernel's McPass for the non-empty groups and their outputs.
    -> (bytes, number of thread blocks, shared memory bytes a block)."""
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"mc: at most {MAX_GROUPS} groups a pass")
    desc = bytearray(_PASS_SIZE)
    cta = smem = 0
    for k, (g, out) in enumerate(zip(groups, outs)):
        taps = 8 if g.is_luma else 4
        ipc, sm = items_per_cta(g.w, g.h, taps)
        R, H, W = g.refs.shape
        n = g.xs.shape[0]
        _GROUP.pack_into(desc, k * _GROUP.size, g.refs.data_ptr(),
                         g.sel.data_ptr(), g.xs.data_ptr(), g.ys.data_ptr(),
                         g.mvx.data_ptr(), g.mvy.data_ptr(), out.data_ptr(),
                         R, H, W, n, _log2(g.w), _log2(g.h), taps, g.sx, g.sy,
                         g.hs, g.vs, g.bd, ipc, cta)
        cta += -(-n // ipc)
        smem = max(smem, sm)
    struct.pack_into("@2i", desc, MAX_GROUPS * _GROUP.size, len(groups), cta)
    return bytes(desc), cta, smem


def mc_pass(groups):
    """A frame's MC pass: a list of McGroup -> a list of (N, h, w) int32
    predictions, one a group (views of one buffer on the card).  CPU
    tensors take the plain version; CUDA tensors one kernel launch."""
    if not groups:
        return []
    dev = _check(groups)
    if dev.type == "cpu":
        return mc_pass_plain(groups)
    if dev.type != "cuda":
        raise ValueError(f"mc: unsupported device {dev}")
    sizes = [g.xs.shape[0] * g.h * g.w for g in groups]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    outs = [v.view(g.xs.shape[0], g.h, g.w)
            for v, g in zip(torch.split(buf, sizes), groups)]
    live = [(g, o) for g, o in zip(groups, outs) if o.numel()]
    if live:
        cuda_lib.check_size("ohk_mc_pass", _PASS_SIZE)
        desc, _, smem = pack_pass(*zip(*live))
        cuda_lib.launch("ohk_mc_pass", desc, smem, cuda_lib.stream_ptr(dev))
        device.count("mc")
    return outs


def mc(refs, sel, xs, ys, mvx, mvy, w, h, is_luma, bd, hs=1, vs=1):
    """refs (R, H, W) int32; sel/xs/ys/mvx/mvy (N,) int32 -> (N, h, w):
    a pass of one group."""
    return mc_pass([McGroup(refs, sel, xs, ys, mvx, mvy, w, h, is_luma, bd,
                            hs, vs)])[0]
