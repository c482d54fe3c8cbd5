"""Batched dequant + inverse transform (X1), as plain torch ops.

Counterpart of ``openhevc_tpu/tpu/residual.py::residual_batch``: one call
per transform size; a batch mixes DCT / DST / skip / bypass blocks selected
per block with masks.  Exactness: the two transform stages are float64
matrix products.  Every operand is an integer (coefficients clipped to
int16, matrix entries |m| <= 90) and every partial sum is bounded by
32 * 90 * 2^15 < 2^27, far inside float64's exact-integer range (2^53), so
the products are exact on the CPU and on the card (TF32 does not apply to
float64; device.check_exact_math guards the float32 settings anyway).
"""

import functools

import numpy as np
import torch

from ..model.transforms import dct_matrix, TDST4, LEVEL_SCALE
from .device import table

KIND_DCT = 0
KIND_DST = 1
KIND_DC = 2
KIND_SKIP = 3
KIND_BYPASS = 4

_MATS = {n: np.asarray(dct_matrix(n), np.float64) for n in (4, 8, 16, 32)}
_DST = np.asarray(TDST4, np.float64)
_LEVEL_SCALE = np.asarray(LEVEL_SCALE, np.int64)


def _clip16(x):
    return torch.clamp(x, -32768, 32767)


def _inv_stage(mat, coeffs, shift):
    """clip16((mat^T @ coeffs + add) >> shift) over a batch (N, n, n)."""
    acc = torch.matmul(mat.t(), coeffs.to(torch.float64)).to(torch.int64)
    return _clip16((acc + (1 << (shift - 1))) >> shift)


@functools.lru_cache(maxsize=None)
def tables(dev):
    """The constant tables of residual_batch on dev, made once a device."""
    return dict(level_scale=table(_LEVEL_SCALE, dev), dst=table(_DST, dev),
                mats={n: table(m, dev) for n, m in _MATS.items()})


def residual_batch(levels, qp, kind, n, bit_depth=8, xtra=None):
    """levels (N, n, n), qp (N,), kind (N,) int -> (N, n, n) int32 residuals.

    Flat dequant only: scaling lists are not ported yet (the caller raises
    NotImplementedError for frames that carry them).  xtra (N,) packs the
    RExt per-block transforms: bits 0-1 rdpcm, bit 2 transform-skip
    rotation.
    """
    consts = tables(levels.device)
    lv = levels.to(torch.int64)
    qp = qp.to(torch.int64)
    kind = kind.to(torch.int64)
    shift = bit_depth + (n.bit_length() - 1) - 5
    ls = consts["level_scale"]
    scale = (ls[qp % 6] << (qp // 6))[:, None, None]
    # (lv*scale*16 + 1<<(shift-1)) >> shift, the x16 folded into the shift;
    # clamp lv so lv*scale stays < 2^30 (clamps saturate identically)
    lim = (1 << 30) // scale
    lv_c = torch.maximum(torch.minimum(lv, lim), -lim)
    deq = _clip16((lv_c * scale + (1 << (shift - 5))) >> (shift - 4))

    mat = consts["mats"][n]
    tmp = _inv_stage(mat, deq, 7)
    out = _inv_stage(mat, tmp.transpose(1, 2), 20 - bit_depth).transpose(1, 2)
    if n == 4:
        dmat = consts["dst"]
        tmp_d = _inv_stage(dmat, deq, 7)
        dst = _inv_stage(dmat, tmp_d.transpose(1, 2),
                         20 - bit_depth).transpose(1, 2)
        out = torch.where((kind == KIND_DST)[:, None, None], dst, out)

    deq_s = deq
    if xtra is not None and n == 4:
        rot = ((xtra.to(torch.int64) >> 2) & 1)[:, None, None]
        deq_s = torch.where(rot == 1, torch.flip(deq, (1, 2)), deq)
    ts_shift = 15 - bit_depth - (n.bit_length() - 1)
    if ts_shift > 0:
        skip = (deq_s + (1 << (ts_shift - 1))) >> ts_shift
    else:
        skip = deq_s << -ts_shift
    out = torch.where((kind == KIND_SKIP)[:, None, None], skip, out)
    out = torch.where((kind == KIND_BYPASS)[:, None, None], lv, out)
    if xtra is not None:
        rd = (xtra.to(torch.int64) & 3)[:, None, None]

        def wrap(v):
            return ((v + 0x8000) & 0xFFFF) - 0x8000
        out = torch.where(rd == 1, wrap(torch.cumsum(out, dim=2)),
                          torch.where(rd == 2, wrap(torch.cumsum(out, dim=1)),
                                      out))
    return out.to(torch.int32)
