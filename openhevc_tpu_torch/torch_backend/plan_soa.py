"""Vectorized plan batching: native SoA op arrays -> frame_step tensors.

Port of openhevc_tpu/tpu/plan_soa.py (numpy only); canonical_resid_keys
comes along from tpu/wavefront.py, which imports JAX.

The C front-end emits flat per-type op rows (native.split_ops); this module
builds the packed-plan batches with numpy array ops only — no per-op Python
objects — replacing plan_compile.compile_plan + wavefront.schedule_slots +
intra_pallas.build_meta on the TPU fast path (the sequential Pallas intra
kernel needs no wavefront analysis: blocks run in decode order on-chip).
"""

import numpy as np

from ..model.intra import INTRA_PRED_ANGLE, INV_ANGLE
from .residual import KIND_DCT, KIND_DST, KIND_SKIP, KIND_BYPASS
from .intra import CHUNK, NF

_KIND_TAB = np.asarray([KIND_DCT, KIND_DST, KIND_SKIP, KIND_BYPASS], np.int32)
_ANGLE_TAB = np.zeros(35, np.int32)
_ANGLE_TAB[2:] = INTRA_PRED_ANGLE
_INV_TAB = np.zeros(35, np.int32)
_INV_TAB[11:26] = INV_ANGLE


def canonical_resid_keys(chroma_format_idc):
    """The fixed (plane, transform size) residual buckets of a frame."""
    keys = []
    for c in (0, 1, 2):
        sizes = (4, 8, 16, 32) if (c == 0 or chroma_format_idc == 3) \
            else (4, 8, 16)
        for n in sizes:
            keys.append((c, n))
    return tuple(sorted(keys))


def ref_pocs_and_slots(inter):
    """Unique reference POCs (sorted) + per-row l0/l1 slot indices."""
    pf = inter[:, 4]
    p0 = inter[pf & 1 != 0, 5]
    p1 = inter[pf & 2 != 0, 8]
    pocs = np.unique(np.concatenate([p0, p1]))
    s0 = np.searchsorted(pocs, inter[:, 5])
    s1 = np.searchsorted(pocs, inter[:, 8])
    # rows without that direction may hold junk POCs; clamp to a valid slot
    s0 = np.where(pf & 1 != 0, s0, 0).astype(np.int32)
    s1 = np.where(pf & 2 != 0, s1, 0).astype(np.int32)
    return [int(p) for p in pocs], s0, s1


def tile_buckets(inter, s0, s1):
    """Decompose PUs into the canonical tile sizes (plan_compile._tile_pu
    semantics, vectorized).  Returns {(tw, th): batch-dict}."""
    x, y, w, h = inter[:, 0], inter[:, 1], inter[:, 2], inter[:, 3]
    w16 = w - w % 16
    h16 = h - h % 16
    cols = dict(pf=inter[:, 4], s0=s0, mvx0=inter[:, 6], mvy0=inter[:, 7],
                s1=s1, mvx1=inter[:, 9], mvy1=inter[:, 10],
                wden=inter[:, 11:13], w0=inter[:, 13:19], w1=inter[:, 19:25])
    out = {}

    def emit(key, txs, tys, idxs):
        if not txs:
            return
        xs = np.concatenate(txs)
        ys = np.concatenate(tys)
        idx = np.concatenate(idxs)
        b = dict(xs=xs.astype(np.int32), ys=ys.astype(np.int32))
        for f, v in cols.items():
            b[f] = np.ascontiguousarray(v[idx])
        out[key] = b

    idx_all = np.arange(len(inter))
    wmax = int(w.max(initial=0))
    hmax = int(h.max(initial=0))
    w64 = w - w % 64
    h64 = h - h % 64
    w32 = w - w % 32
    h32 = h - h % 32

    # (64, 64) / (32, 32): greedy large tiles over the aligned interior
    # (one MC DMA window per 64x64 skip PU instead of sixteen 16x16 ones)
    txs, tys, tis = [], [], []
    for b in range(0, hmax, 64):
        for a in range(0, wmax, 64):
            m = (a < w64) & (b < h64)
            if m.any():
                txs.append(x[m] + a)
                tys.append(y[m] + b)
                tis.append(idx_all[m])
    emit((64, 64), txs, tys, tis)

    txs, tys, tis = [], [], []
    for b in range(0, hmax, 32):
        for a in range(0, wmax, 32):
            m = (a < w32) & (b < h32) & ~((a < w64) & (b < h64))
            if m.any():
                txs.append(x[m] + a)
                tys.append(y[m] + b)
                tis.append(idx_all[m])
    emit((32, 32), txs, tys, tis)

    # (16, 16): remainder grid not covered by the 64/32 tiles
    txs, tys, tis = [], [], []
    for b in range(0, hmax, 16):
        for a in range(0, wmax, 16):
            m = (a < w16) & (b < h16) & ~((a < w32) & (b < h32))
            if m.any():
                txs.append(x[m] + a)
                tys.append(y[m] + b)
                tis.append(idx_all[m])
    emit((16, 16), txs, tys, tis)

    # strip/corner tiles live at per-PU offsets (a = w16 + da), so loop
    # over the <=4x4 offset grid on pre-filtered subsets instead of the
    # full position grid with whole-batch masks (O(16) small passes vs
    # O(256) full-length ones; same tile cover)

    # (4, 16): right strip of full-height rows
    sR = np.flatnonzero(w % 16 > 0)
    if len(sR):
        xs_, ys_ = x[sR], y[sR]
        w16s, h16s, wr = w16[sR], h16[sR], (w % 16)[sR]
        txs, tys, tis = [], [], []
        for b in range(0, int(h16s.max(initial=0)), 16):
            mb = b < h16s
            for da in range(0, 16, 4):
                m = mb & (da < wr)
                if m.any():
                    txs.append(xs_[m] + w16s[m] + da)
                    tys.append(ys_[m] + b)
                    tis.append(sR[m])
        emit((4, 16), txs, tys, tis)

    # (16, 4): bottom strip, full-width columns
    sB = np.flatnonzero(h % 16 > 0)
    if len(sB):
        xs_, ys_ = x[sB], y[sB]
        w16s, h16s, hr = w16[sB], h16[sB], (h % 16)[sB]
        txs, tys, tis = [], [], []
        for a in range(0, int(w16s.max(initial=0)), 16):
            ma = a < w16s
            for db in range(0, 16, 4):
                m = ma & (db < hr)
                if m.any():
                    txs.append(xs_[m] + a)
                    tys.append(ys_[m] + h16s[m] + db)
                    tis.append(sB[m])
        emit((16, 4), txs, tys, tis)

    # (4, 4): bottom-right corner
    sC = np.flatnonzero((w % 16 > 0) & (h % 16 > 0))
    if len(sC):
        xs_, ys_ = x[sC], y[sC]
        w16s, h16s = w16[sC], h16[sC]
        wr, hr = (w % 16)[sC], (h % 16)[sC]
        txs, tys, tis = [], [], []
        for db in range(0, 16, 4):
            mb = db < hr
            for da in range(0, 16, 4):
                m = mb & (da < wr)
                if m.any():
                    txs.append(xs_[m] + w16s[m] + da)
                    tys.append(ys_[m] + h16s[m] + db)
                    tis.append(sC[m])
        emit((4, 4), txs, tys, tis)
    return out


def resid_fields(resid, chroma_format_idc):
    """Whole-frame residual batches per (plane, size), decode order —
    WITHOUT the levels gather: on the fast path the native pack_levels
    writes int8 levels straight into the wire buffer
    (native/frontend.cc pack_levels), so the (N, n, n) int32 gather the
    old resid_buckets did (the dominant host cost at 4K) never happens."""
    c = resid[:, 0]
    log2n = resid[:, 3]
    kraw = resid[:, 5]
    rext = resid[:, 7]
    out = {}
    for key in canonical_resid_keys(chroma_format_idc):
        kc, n = key
        m = (c == kc) & (log2n == n.bit_length() - 1)
        rows = resid[m]
        out[key] = dict(
            xs=np.ascontiguousarray(rows[:, 1]),
            ys=np.ascontiguousarray(rows[:, 2]),
            qp=np.ascontiguousarray(rows[:, 4]),
            kind=_KIND_TAB[kraw[m] & 7],
            mid=((kraw[m] >> 3) - 1).astype(np.int32),
            xtra=(rext[m] & 7).astype(np.int32))
    return out


def cc_alpha_maps(resid, height, width):
    """RExt 4:4:4 cross-component alpha maps per chroma plane (or None)."""
    alpha = ((resid[:, 7] >> 8) & 63) - 16
    maps = [None, None]
    for c in (1, 2):
        m = (resid[:, 0] == c) & (alpha != 0)
        if not m.any():
            continue
        amap = np.zeros((height, width), np.int32)
        for x, y, l2, a in zip(resid[m, 1], resid[m, 2], resid[m, 3],
                               alpha[m]):
            nn = 1 << l2
            amap[y:y + nn, x:x + nn] = a
        maps[c - 1] = amap
    return maps


def intra_meta_bands(intra, c_idx, bands, chroma_444, smoothing_off=False):
    """Vectorized intra_pallas.build_meta + band split.

    intra: (N, 10) SoA rows [c,x,y,size,mode,f0..f4] in decode order.
    Returns one (n_chunks, CHUNK, NF) int32 array (or None) per band, with
    y rebased to the band buffer.
    """
    rows = intra[intra[:, 0] == c_idx]
    x = rows[:, 1]
    y = rows[:, 2]
    n = rows[:, 3]
    mode = rows[:, 4]
    angle = _ANGLE_TAB[np.clip(mode, 0, 34)]
    inv = _INV_TAB[np.clip(mode, 0, 34)]
    flags = (rows[:, 5] | (rows[:, 6] << 1) | (rows[:, 7] << 2)
             | (rows[:, 8] << 3) | (rows[:, 9] << 4))
    if (c_idx == 0 or chroma_444) and not smoothing_off:
        thresh = np.select([n == 8, n == 16, n == 32], [7, 1, 0], default=-1)
        do = ((mode != 1) & (n != 4) &
              (np.minimum(np.abs(mode - 26), np.abs(mode - 10)) > thresh))
        flags = flags | np.where(do, 32, 0)
    log2n = np.int32(np.log2(np.maximum(n, 1))).astype(np.int32)
    out = []
    for (s, e) in bands:
        base = 0 if s == 0 else s - 8
        m = (y >= s) & (y < e)
        if not m.any():
            out.append(None)
            continue
        k = int(m.sum())
        n_chunks = 1
        while n_chunks * CHUNK < k:
            n_chunks *= 2
        meta = np.zeros((n_chunks * CHUNK, NF), np.int32)
        meta[:k, 0] = x[m]
        meta[:k, 1] = y[m] - base
        meta[:k, 2] = log2n[m]
        meta[:k, 3] = mode[m]
        meta[:k, 4] = angle[m]
        meta[:k, 5] = inv[m]
        meta[:k, 6] = flags[m]
        meta[:k, 7] = 1
        out.append(meta.reshape(n_chunks, CHUNK, NF))
    return out
