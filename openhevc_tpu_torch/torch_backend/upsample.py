"""X3: the SHVC inter-layer upsample on the device, in integer torch ops.

Port of ``openhevc_tpu/tpu/upsample.py`` (``plan_axis``, the gather form
``upsample_plane_jit`` and ``TpuUpsampler``), bit-exact with
``model/upsample.py`` (the reference's upsample_base_layer_frame,
hevcdsp_template.c:2164-2440): a separable polyphase FIR, 8-tap luma and
4-tap chroma, horizontal then vertical, the intermediate wrapped to int16
as the reference's ``int16_t``, then ``(acc + I_OFFSET) >> N_SHIFT`` and a
clip.  The tap indices and coefficients depend only on the layer geometry;
they go to the device once per geometry.

Everything is int32 and exact: a source sample below 2^14 times the taps'
absolute sum (at most 112) stays below 2^21, the wrapped intermediate
below 2^15, the vertical sum below 2^22.  The TPU's matmul form
(``upsample_plane_mxu``) is not ported: bf16 products there would be TF32
here, which is not exact.  Each tap is one gather and one multiply-add
over the output, so no (rows, cols, taps) intermediate is built.  This is
XLA glue in the reference, not a Pallas kernel, so it stays torch ops.
"""

import numpy as np
import torch

from ..model.upsample import (UpsampleInfo, UP_FILTER_LUMA, UP_FILTER_CHROMA,
                              N_SHIFT, I_OFFSET, _phase_positions)
from . import device


def plan_axis(n_el, n_src, scale, add, ntaps, v_chroma=False):
    """-> (idx (n_el, ntaps) clamped source indices, coef (n_el, ntaps))."""
    table = UP_FILTER_LUMA if ntaps == 8 else UP_FILTER_CHROMA
    refpos, phase = _phase_positions(n_el, scale, add, ntaps,
                                     v_chroma=v_chroma)
    k = np.arange(ntaps)
    idx = np.clip(refpos[:, None] + k[None, :], 0, n_src - 1)
    coef = table[phase]
    return idx.astype(np.int32), coef.astype(np.int32)


def upsample_plane(src, idx_x, coef_x, idx_y, coef_y, bit_depth=8):
    """src (H_BL, W_BL) int32 -> (H_EL, W_EL) int32.  idx_* are int64
    (n_el, T) source indices, coef_* int32 (n_el, T) taps, all on src's
    device."""
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


class CudaUpsampler:
    """Caches per-geometry tap plans on each device; upsamples a frame's
    planes where they lie (the card, or the CPU for the tests)."""

    def __init__(self):
        self._plans = {}

    def _plan(self, shape_bl, w_el, h_el, c_idx, info, dev):
        key = (shape_bl, w_el, h_el, c_idx, str(dev))
        if key not in self._plans:
            h_bl, w_bl = shape_bl
            ntaps = 8 if c_idx == 0 else 4
            ax = info.add_x if c_idx == 0 else info.add_xc
            ay = info.add_y if c_idx == 0 else info.add_yc
            idx_x, coef_x = plan_axis(w_el, w_bl, info.scale_x, ax, ntaps)
            idx_y, coef_y = plan_axis(h_el, h_bl, info.scale_y, ay, ntaps,
                                      v_chroma=c_idx > 0)
            self._plans[key] = (device.table(idx_x, dev, np.int64),
                                device.table(coef_x, dev, np.int32),
                                device.table(idx_y, dev, np.int64),
                                device.table(coef_y, dev, np.int32))
        return self._plans[key]

    def upsample_frame(self, bl_planes, width_el, height_el, bit_depth=8,
                       chroma_format_idc=1, phase_align_flag=0):
        """[Y, U, V] base-layer tensors -> EL-size int32 tensors on the
        same device (SNR scalability passes the planes through)."""
        h_bl, w_bl = bl_planes[0].shape
        info = UpsampleInfo(w_bl, h_bl, width_el, height_el, phase_align_flag)
        if info.is_snr:
            return [p.to(torch.int32) for p in bl_planes]
        hs = 1 if chroma_format_idc in (1, 2) else 0
        vs = 1 if chroma_format_idc == 1 else 0
        out = []
        for c in range(3):
            p = bl_planes[c].to(torch.int32)
            w = width_el >> (hs if c else 0)
            h = height_el >> (vs if c else 0)
            plan = self._plan(tuple(p.shape), w, h, min(c, 1), info,
                              p.device)
            out.append(upsample_plane(p, *plan, bit_depth=bit_depth))
        return out
