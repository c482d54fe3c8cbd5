"""X3: the SHVC inter-layer upsample on the device (csrc/upsample.cu) and
its plain version.

Port of ``openhevc_tpu/tpu/upsample.py`` (``plan_axis``, ``band_matrix``,
the gather form ``upsample_plane_jit`` and ``TpuUpsampler``), bit-exact with
``model/upsample.py`` (the reference's upsample_base_layer_frame,
hevcdsp_template.c:2164-2440): a separable polyphase FIR, 8-tap luma and
4-tap chroma, horizontal then vertical, the intermediate wrapped to int16
as the reference's ``int16_t``, then ``(acc + I_OFFSET) >> N_SHIFT`` and a
clip.  The tap indices and coefficients depend only on the layer geometry;
they go to the device once per geometry.

Two forms of one function, both exact:

- the kernel (``upsample_frame_x3``), the accelerator path and the only
  one ``CudaUpsampler`` takes on the card: one launch of
  ``csrc/upsample.cu`` a picture, a block per TILE x TILE output tile of
  any of its planes, which loads its base-layer window once into shared
  memory (``kernel_tables``);
- the gather form (``upsample_plane``): one gather and one multiply-add
  torch op a tap and pass.  It is the kernel's plain version, which the
  kernel's wrapper takes for CPU tensors.

The reference's ``OPENHEVC_UPSAMPLE=gather`` (its XLA gather form on the
accelerator) has no counterpart: it computes what the kernel computes.
``band_matrix`` is the reference's, for its band-matrix form
(``upsample_plane_mxu``).  Everything is exact in int32: a source sample
below 2^14 times the taps' absolute sum (at most 112) stays below 2^21,
the wrapped intermediate below 2^15, the vertical sum below 2^22.
"""

import dataclasses
import struct

import numpy as np
import torch

from ..model.upsample import (UpsampleInfo, UP_FILTER_LUMA, UP_FILTER_CHROMA,
                              N_SHIFT, I_OFFSET, _phase_positions)
from . import cuda_lib, device

TILE = 64                   # csrc/upsample.cu kTile: an EL tile, TILE x TILE
SMEM_MAX = 48 * 1024        # csrc/upsample.cu kMaxSmem
MAX_BOX = 256               # csrc/upsample.cu kMaxBox: a TMA box side
MAX_PLANES = 3
# csrc/upsample.cu X3Plane: a 128-byte CUtensorMap (left blank; the
# launcher encodes it), src, out, xtab, ytab, wx, wy pointers; h_bl, w_bl,
# h_el, w_el, taps, tiles_x, first_tile, box_w, box_h, tma; padding to its
# 64-byte alignment
_PLANE = struct.Struct("@128x6P10i40x")
_SRC_OUT = struct.Struct("@2P")             # src, out at offset 128
# X3Frame: MAX_PLANES planes, then n_planes, n_tiles, max_val; padding
_TAIL = struct.Struct("@3i")
_FRAME_SIZE = 832


def plan_axis(n_el, n_src, scale, add, ntaps, v_chroma=False):
    """-> (idx (n_el, ntaps) clamped source indices, coef (n_el, ntaps))."""
    table = UP_FILTER_LUMA if ntaps == 8 else UP_FILTER_CHROMA
    refpos, phase = _phase_positions(n_el, scale, add, ntaps,
                                     v_chroma=v_chroma)
    k = np.arange(ntaps)
    idx = np.clip(refpos[:, None] + k[None, :], 0, n_src - 1)
    coef = table[phase]
    return idx.astype(np.int32), coef.astype(np.int32)


def band_matrix(idx, coef, n_src):
    """(n_el, T) tap plan -> dense (n_src, n_el) band matrix.

    Border-clamped taps hit duplicate source indices; accumulating them
    reproduces the clamp exactly (sum_k c[j,k]*src[clip(idx)] regrouped
    by unique source row)."""
    n_el, ntaps = idx.shape
    m = np.zeros((n_src, n_el), np.int32)
    cols = np.repeat(np.arange(n_el), ntaps)
    np.add.at(m, (idx.ravel(), cols), coef.ravel())
    return m


def _pad(a, tile):
    """Rows of ``a`` to a multiple of ``tile``, repeating the last one."""
    return np.concatenate([a, np.repeat(a[-1:], -len(a) % tile, 0)])


def window_plan(idx):
    """(n_el, T) clamped source indices -> (tiles, 2) int32: for each run
    of TILE outputs, the first source index its taps read and how many
    (the window a block of the kernel loads), from the tables themselves
    (the last tile, short, repeats its last row)."""
    seg = _pad(idx, TILE).reshape(-1, TILE * idx.shape[1])
    lo, hi = seg.min(1), seg.max(1)
    return np.stack([lo, hi - lo + 1], 1).astype(np.int32)


def smem_bytes(box_h, box_w, taps):
    """The kernel's shared memory for a plane: the source window (int32,
    box_h x box_w), the horizontal pass's sums (int16, box_h x TILE), the
    tile's row taps (int32, TILE x taps) and 128 bytes to align the
    window for TMA (csrc/upsample.cu smem_bytes)."""
    return 4 * box_h * box_w + 2 * box_h * TILE + 4 * TILE * taps + 128


def _packed(off, coef):
    """A tap as the kernel reads it: offset << 16 | coefficient & 0xffff."""
    return ((off.astype(np.int64) << 16) | (coef & 0xFFFF)).astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class KernelPlan:
    """One plane geometry's tables for X3's kernel.  ``tab`` is the packed
    int32 table on the plane's device and ``at`` the element offsets in it
    of xtab ((tiles_x * TILE, taps) column taps,
    offset from the tile column's window), ytab ((tiles_y * TILE, taps)
    row taps, offset from the tile row's window in rows of TILE), wx
    ((tiles_x,) windows' first columns, each rounded down to a multiple of
    4) and wy ((tiles_y, 2) windows' first rows and row counts); ``box``
    (rows, columns) is the largest window, its columns from the rounded
    start and rounded up to 4 (the TMA box)."""
    tab: torch.Tensor
    at: tuple
    shape_bl: tuple
    shape_el: tuple
    taps: int
    tiles: tuple
    box: tuple


def kernel_tables(idx_x, coef_x, idx_y, coef_y):
    """-> (packed table, at, tiles, box) of ``KernelPlan`` from a plane's
    tap tables; raises when the largest window does not fit a TMA box or
    the kernel's shared memory (never at upsampling ratios, 1x and up)."""
    taps = idx_x.shape[1]
    win_x, win_y = window_plan(idx_x), window_plan(idx_y)
    # a TMA box starts on a 16-byte boundary of its row: 4 int32 columns
    c0 = win_x[:, 0] & ~3
    box = (int(win_y[:, 1].max()),
           -(-int((win_x.sum(1) - c0).max()) // 4) * 4)
    if max(box) > MAX_BOX or smem_bytes(*box, taps) > SMEM_MAX:
        raise ValueError(f"X3: a {box[0]}x{box[1]} window exceeds the "
                         f"kernel's shared memory")
    xt = _packed(_pad(idx_x, TILE) - np.repeat(c0, TILE)[:, None],
                 _pad(coef_x, TILE))
    yt = _packed((_pad(idx_y, TILE) - np.repeat(win_y[:, 0], TILE)[:, None])
                 * TILE, _pad(coef_y, TILE))
    parts = [xt.ravel(), yt.ravel(), c0, win_y.ravel()]
    at = tuple(int(v) for v in np.cumsum([0] + [len(p) for p in parts[:-1]]))
    return (np.concatenate(parts).astype(np.int32), at,
            (len(win_y), len(win_x)), box)


def upsample_plane(src, idx_x, coef_x, idx_y, coef_y, bit_depth=8):
    """The gather form, X3's plain version: src (H_BL, W_BL) int32 ->
    (H_EL, W_EL) int32.  idx_* are integer (n_el, T) source indices,
    coef_* int32 (n_el, T) taps, all on src's device."""
    tmp = None
    for k in range(idx_x.shape[1]):
        term = src[:, idx_x[:, k]] * coef_x[:, k]
        tmp = term if tmp is None else tmp + term
    # the reference's int16_t intermediate wraps for >8-bit inputs
    tmp = ((tmp + 0x8000) & 0xFFFF) - 0x8000
    acc = None
    for k in range(idx_y.shape[1]):
        term = tmp[idx_y[:, k]] * coef_y[:, k][:, None]
        acc = term if acc is None else acc + term
    return torch.clamp((acc + I_OFFSET) >> N_SHIFT, 0, (1 << bit_depth) - 1)


def pack_frame(kplans):
    """The kernel's X3Frame for planes of these ``KernelPlan``s (luma
    first): everything but the src and out pointers, the tensor maps, the
    tma flags and max_val, which stay blank.  -> (bytearray, number of
    thread blocks: one an EL tile)."""
    if not 1 <= len(kplans) <= MAX_PLANES:
        raise ValueError(f"X3: 1 to {MAX_PLANES} planes")
    desc = bytearray(_FRAME_SIZE)
    first = 0
    for k, kp in enumerate(kplans):
        base = kp.tab.data_ptr()
        _PLANE.pack_into(desc, k * _PLANE.size, 0, 0,
                         *(base + 4 * a for a in kp.at), *kp.shape_bl,
                         *kp.shape_el, kp.taps, kp.tiles[1], first,
                         kp.box[1], kp.box[0], 0)
        first += kp.tiles[0] * kp.tiles[1]
    _TAIL.pack_into(desc, MAX_PLANES * _PLANE.size, len(kplans), first, 0)
    return desc, first


@dataclasses.dataclass(frozen=True, eq=False)
class FramePlan:
    """A picture geometry's plans on one device: for each plane (idx_x,
    coef_x, idx_y, coef_y, KernelPlan), the first four the gather form's
    int32 tables; ``desc`` is ``pack_frame``'s X3Frame over them."""
    planes: tuple
    desc: bytes
    n_tiles: int


def upsample_frame_x3(planes, fplan, bit_depth=8):
    """X3's kernel: int32 base-layer planes -> their int32 EL planes, one
    launch of csrc/upsample.cu for all of them on a CUDA tensor; CPU
    tensors take the plain version.  ``fplan`` is the ``FramePlan`` of
    the planes' geometry on their device (``CudaUpsampler``); only the
    planes are checked here, the tables were at plan time."""
    dev = planes[0].device
    if dev.type == "cpu":
        return [upsample_plane(p, *plan[:4], bit_depth=bit_depth)
                for p, plan in zip(planes, fplan.planes)]
    if dev.type != "cuda":
        raise ValueError(f"X3: unsupported device {dev}")
    if len(planes) != len(fplan.planes):
        raise ValueError("X3: one plan a plane")
    for p, plan in zip(planes, fplan.planes):
        kp = plan[4]
        if p.dtype != torch.int32 or tuple(p.shape) != kp.shape_bl or \
                p.device != dev or kp.tab.device != dev or \
                not p.is_contiguous():
            raise ValueError(f"X3: planes must be contiguous int32 "
                             f"{kp.shape_bl} on the plan's device")
    outs = [torch.empty(plan[4].shape_el, dtype=torch.int32, device=dev)
            for plan in fplan.planes]
    desc = bytearray(fplan.desc)
    for k, (p, o) in enumerate(zip(planes, outs)):
        _SRC_OUT.pack_into(desc, k * _PLANE.size + 128, p.data_ptr(),
                           o.data_ptr())
    _TAIL.pack_into(desc, MAX_PLANES * _PLANE.size, len(planes),
                    fplan.n_tiles, (1 << bit_depth) - 1)
    cuda_lib.check_size("ohk_upsample_frame", _FRAME_SIZE)
    cuda_lib.launch("ohk_upsample_frame", dev, bytes(desc),
                    cuda_lib.stream_ptr(dev))
    device.count(device.X3)
    return outs


class CudaUpsampler:
    """Caches per-geometry plans on each device: the tap tables, the
    kernel's packed tables and its frame descriptor; upsamples a frame's
    planes where they lie, through X3's kernel on the card, one launch a
    picture (its plain version on the CPU, for the tests)."""

    def __init__(self):
        self._plans = {}        # a plane's geometry and device -> plan
        self._frames = {}       # a picture's -> FramePlan (None: SNR)

    def axis_plans(self, shape_bl, w_el, h_el, c_idx, info):
        """-> (idx_x, coef_x, idx_y, coef_y) host tables of one plane."""
        h_bl, w_bl = shape_bl
        ntaps = 8 if c_idx == 0 else 4
        ax = info.add_x if c_idx == 0 else info.add_xc
        ay = info.add_y if c_idx == 0 else info.add_yc
        idx_x, coef_x = plan_axis(w_el, w_bl, info.scale_x, ax, ntaps)
        idx_y, coef_y = plan_axis(h_el, h_bl, info.scale_y, ay, ntaps,
                                  v_chroma=c_idx > 0)
        return idx_x, coef_x, idx_y, coef_y

    def _plan(self, shape_bl, w_el, h_el, c_idx, info, phase_align, dev):
        key = (shape_bl, w_el, h_el, c_idx, phase_align, str(dev))
        if key not in self._plans:
            tables = self.axis_plans(shape_bl, w_el, h_el, c_idx, info)
            host, at, tiles, box = kernel_tables(*tables)
            tabs = [device.table(a, dev, np.int32) for a in tables + (host,)]
            self._plans[key] = tuple(tabs[:4]) + (KernelPlan(
                tabs[4], at, shape_bl, (h_el, w_el),
                tables[0].shape[1], tiles, box),)
        return self._plans[key]

    def _frame(self, shapes, width_el, height_el, chroma_format_idc,
               phase_align, dev):
        key = (shapes, width_el, height_el, chroma_format_idc, phase_align,
               str(dev))
        if key not in self._frames:
            h_bl, w_bl = shapes[0]
            info = UpsampleInfo(w_bl, h_bl, width_el, height_el, phase_align)
            fplan = None
            if not info.is_snr:
                hs = 1 if chroma_format_idc in (1, 2) else 0
                vs = 1 if chroma_format_idc == 1 else 0
                plans = tuple(self._plan(
                    shapes[c], width_el >> (hs if c else 0),
                    height_el >> (vs if c else 0), min(c, 1), info,
                    phase_align, dev) for c in range(len(shapes)))
                desc, n_tiles = pack_frame([p[4] for p in plans])
                fplan = FramePlan(plans, bytes(desc), n_tiles)
            self._frames[key] = fplan
        return self._frames[key]

    def _planes(self, bl_planes, width_el, height_el, chroma_format_idc,
                phase_align_flag):
        planes = [p.to(torch.int32).contiguous() for p in bl_planes]
        return planes, self._frame(
            tuple(tuple(p.shape) for p in planes), width_el, height_el,
            chroma_format_idc, phase_align_flag, planes[0].device)

    def frame_plans(self, bl_planes, width_el, height_el,
                    chroma_format_idc=1, phase_align_flag=0):
        """[Y, U, V] base-layer tensors -> [(int32 plane, its plan)], the
        plan (idx_x, coef_x, idx_y, coef_y, KernelPlan) on the plane's
        device; None for SNR scalability (same size)."""
        planes, fplan = self._planes(bl_planes, width_el, height_el,
                                     chroma_format_idc, phase_align_flag)
        return None if fplan is None else list(zip(planes, fplan.planes))

    def upsample_frame(self, bl_planes, width_el, height_el, bit_depth=8,
                       chroma_format_idc=1, phase_align_flag=0):
        """[Y, U, V] base-layer tensors -> EL-size int32 tensors on the
        same device (SNR scalability passes the planes through)."""
        planes, fplan = self._planes(bl_planes, width_el, height_el,
                                     chroma_format_idc, phase_align_flag)
        if fplan is None:
            return planes
        return upsample_frame_x3(planes, fplan, bit_depth)
