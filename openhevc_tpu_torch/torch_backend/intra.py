"""K1: intra reconstruction as a dataflow wavefront (csrc/intra.cu), its
plain version, and the plain version of its schedule.

Counterpart of ``openhevc_tpu/tpu/intra_pallas.py``.  Every intra block of
a plane is rebuilt from the plane's current samples, with the sequential
kernel's arithmetic.  The plain version walks the blocks in decode order;
the CUDA kernel walks them as a wavefront across the card, each block
waiting only for the blocks that wrote the samples it reads
(``intra_schedule`` is that rule in plain Python).  Metadata rows are
``(x, y, log2n, mode, angle, inv, flags, valid)``; flags bits 0-4 are the
availabilities (bottom-left, left, up-left, up, up-right) and bit 5
requests reference smoothing.

Reads outside the picture clamp their coordinates; that is the edge
replication the TPU kernel kept in a 64-sample apron.
"""

import struct

import numpy as np
import torch

from ..model.intra import INTRA_PRED_ANGLE, INV_ANGLE
from . import cuda_lib, device

CHUNK = 128        # blocks per metadata chunk (the reference's layout)
NF = 8             # meta fields: x, y, log2n, mode, angle, inv, flags, valid


def build_meta(ops, c_idx, chroma_444, smoothing_off=False):
    """Pack one plane's IntraOps (in decode order) into (n_chunks, CHUNK, NF)
    int32 metadata, n_chunks a power of two; None when the plane has no
    intra blocks.  Same layout as the reference's build_meta."""
    rows = []
    for op in ops:
        if op.c_idx != c_idx:
            continue
        n = op.size
        mode = op.mode
        angle = INTRA_PRED_ANGLE[mode - 2] if mode >= 2 else 0
        inv = INV_ANGLE[mode - 11] if 11 <= mode <= 25 else 0
        flags = ((1 if op.cand_bottom_left else 0)
                 | (2 if op.cand_left else 0)
                 | (4 if op.cand_up_left else 0)
                 | (8 if op.cand_up else 0)
                 | (16 if op.cand_up_right else 0))
        if (c_idx == 0 or chroma_444) and not smoothing_off:
            thresh = {8: 7, 16: 1, 32: 0}.get(n, -1)
            if (mode != 1 and n != 4
                    and min(abs(mode - 26), abs(mode - 10)) > thresh):
                flags |= 32
        log2n = n.bit_length() - 1
        rows.append((op.x, op.y, log2n, mode, angle, inv, flags, 1))
    if not rows:
        return None
    n_chunks = 1
    while n_chunks * CHUNK < len(rows):
        n_chunks *= 2
    meta = np.zeros((n_chunks * CHUNK, NF), np.int32)
    meta[:len(rows)] = rows
    return meta.reshape(n_chunks, CHUNK, NF)


# ---------------------------------------------------------------------------
# plain version: the same arithmetic, one block at a time
# ---------------------------------------------------------------------------

def _refs(P, x, y, n, flags, bd):
    """Substituted (top, left) reference lists [0..2n] (index 0 = corner)."""
    H, W = P.shape
    mid = 1 << (bd - 1)
    yt, xl = max(y - 1, 0), max(x - 1, 0)
    cols = torch.clamp(torch.arange(x, x + 2 * n, device=P.device), max=W - 1)
    rows = torch.clamp(torch.arange(y, y + 2 * n, device=P.device), max=H - 1)
    raw = P[yt, cols].tolist()
    lrow = P[rows, xl].tolist()
    cr = int(P[yt, xl])
    cbl, cl, cul = flags & 1, flags & 2, flags & 4
    cu, cur = flags & 8, flags & 16
    fill_bl = (lrow[n - 1] if cl else cr if cul else raw[0] if cu
               else raw[n] if cur else mid)
    fill_l = cr if cul else raw[0] if cu else raw[n] if cur else mid
    lh0 = lrow[n] if cbl else fill_bl
    ll0_res = lrow[0] if cl else (lh0 if cbl else fill_l)
    corner = (cr if cul else ll0_res if (cl or cbl) else raw[0] if cu
              else raw[n] if cur else mid)
    topn_res = raw[n - 1] if cu else corner
    top = [corner] + [raw[i - 1] if cu else corner for i in range(1, n + 1)] \
        + [raw[i - 1] if cur else topn_res for i in range(n + 1, 2 * n + 1)]
    left = [corner] + [lrow[i - 1] if cl else (lh0 if cbl else fill_l)
                       for i in range(1, n + 1)] \
        + [lrow[i - 1] if cbl else fill_bl for i in range(n + 1, 2 * n + 1)]
    return top, left


def _smooth(top, left, n, c_idx, bd, strong):
    fcorner = (left[1] + 2 * top[0] + top[1] + 2) >> 2

    def f121(r):
        return [fcorner] + [(r[i + 1] + 2 * r[i] + r[i - 1] + 2) >> 2
                            for i in range(1, 2 * n)] + [r[2 * n]]
    if strong and n == 32 and c_idx == 0:
        th = 1 << (bd - 5)
        if (abs(top[0] + top[64] - 2 * top[32]) < th and
                abs(left[0] + left[64] - 2 * left[32]) < th):
            def lerp(r):
                return [r[0]] + [((64 - i) * r[0] + i * r[64] + 32) >> 6
                                 for i in range(1, 64)] + [r[64]]
            return lerp(top), lerp(left)
    return f121(top), f121(left)


def _predict(top, left, n, mode, angle, inv, c_idx, bd, dev):
    """(n, n) int64 prediction from the reference lists."""
    log2n = n.bit_length() - 1
    maxv = (1 << bd) - 1
    T = torch.tensor(top + [0] * 2, dtype=torch.int64, device=dev)
    L = torch.tensor(left + [0] * 2, dtype=torch.int64, device=dev)
    r = torch.arange(n, device=dev)[:, None]
    c = torch.arange(n, device=dev)[None, :]
    if mode == 0:
        return ((n - 1 - c) * L[r + 1] + (c + 1) * T[n + 1] +
                (n - 1 - r) * T[c + 1] + (r + 1) * L[n + 1] + n) >> (log2n + 1)
    if mode == 1:
        dc = (sum(top[1:n + 1]) + sum(left[1:n + 1]) + n) >> (log2n + 1)
        out = torch.full((n, n), dc, dtype=torch.int64, device=dev)
        if c_idx == 0 and n < 32:
            out[0, 1:] = (T[2:n + 1] + 3 * dc + 2) >> 2
            out[1:, 0] = (L[2:n + 1] + 3 * dc + 2) >> 2
            out[0, 0] = (left[1] + 2 * dc + top[1] + 2) >> 2
        return out
    is_ver = mode >= 18
    main, side = (T, L) if is_ver else (L, T)
    yy, xx = r, c
    pos = (yy + 1) * angle
    idx, fact = pos >> 5, pos & 31

    def ref(k):
        proj = side[torch.clamp((k * inv + 128) >> 8, 0, 2 * n)]
        mk = torch.where(k <= 2 * n, main[torch.clamp(k, 0, 2 * n)], 0)
        return torch.where(k >= 0, mk, proj)
    k0 = xx + idx + 1
    a = ref(k0)
    b = ref(k0 + 1)
    pv = torch.where(fact != 0, ((32 - fact) * a + fact * b + 16) >> 5, a)
    if c_idx == 0 and n < 32 and mode in (26, 10):
        col = torch.clamp(main[1] + ((side[1:n + 1] - side[0]) >> 1), 0, maxv)
        pv[:, 0] = col
    return pv if is_ver else pv.t()


def intra_block_plain_(out, res, row, c_idx, bd, strong, c444):
    """Rebuild one metadata row's block of ``out`` in place (``res`` is the
    int64 residual canvas): the per-block step of the plain version."""
    x, y, log2n, mode, angle, inv, flags, valid = row
    if not valid:
        return
    big = c_idx == 0 or c444
    n = 1 << min(max(log2n, 2), 5 if big else 4)
    top, left = _refs(out, x, y, n, flags, bd)
    if big and n != 4 and flags & 32:
        top, left = _smooth(top, left, n, c_idx, bd, strong)
    pred = _predict(top, left, n, mode, angle, inv, c_idx, bd, out.device)
    H, W = out.shape
    h_, w_ = min(n, H - y), min(n, W - x)
    val = torch.clamp(pred[:h_, :w_] + res[y:y + h_, x:x + w_], 0,
                      (1 << bd) - 1)
    out[y:y + h_, x:x + w_] = val.to(out.dtype)


def intra_plane_plain(plane, resid, meta, c_idx, bd, strong, c444):
    """Plain version of one plane: the blocks in decode order.  Returns the
    reconstructed (H, W) int32 plane (the input is not modified)."""
    out = plane.clone()
    res = resid.to(torch.int64)
    for row in meta.reshape(-1, NF).tolist():
        intra_block_plain_(out, res, row, c_idx, bd, strong, c444)
    return out


# ---------------------------------------------------------------------------
# the schedule: which earlier blocks each block waits for
# ---------------------------------------------------------------------------

ERRORS = {1: "two blocks write one 4x4 unit",
          2: "a block reads a sample that a later block writes",
          4: "a wait for a neighbour ran out of time",
          8: "a block lies off the 4-sample grid"}


def intra_schedule(meta, H, W, c_idx, c444=False):
    """The kernel's dependency rule in plain Python, for one plane.

    Each valid block owns the 4x4 units it writes inside the (H, W) plane.
    A block depends on the owners of the units holding the neighbour
    samples it reads: under its five availability flags, at the clamped
    coordinates it reads.  Units that no block owns are final at launch; a
    block's own units are read before it writes them.  Returns each row's
    level (0: depends on no block; -1: row not valid); a block's level is
    one more than its deepest dependency, so the depth of the wavefront is
    ``max + 1``.  Raises ValueError where the kernel sets its error word: a
    block off the 4-sample grid, two blocks owning one unit, or a block
    reading a unit that a later block writes."""
    m = np.asarray(meta).reshape(-1, NF)
    max_log2 = 5 if (c_idx == 0 or c444) else 4
    UW = -(-W // 4)
    owner = np.zeros((-(-H // 4), UW), np.int64)      # 1 + row
    level = np.full(len(m), -1, np.int64)
    rows = np.nonzero(m[:, 7] != 0)[0]
    for b in rows:
        x, y = int(m[b, 0]), int(m[b, 1])
        if x < 0 or y < 0 or x % 4 or y % 4:
            raise ValueError(f"intra_schedule: row {b}: {ERRORS[8]}")
        n = 1 << min(max(int(m[b, 2]), 2), max_log2)
        units = owner[y // 4:-(-min(y + n, H) // 4),
                      x // 4:-(-min(x + n, W) // 4)]
        if units.any():
            raise ValueError(f"intra_schedule: row {b}: {ERRORS[1]}")
        units[...] = b + 1
    for b in rows:
        x, y, flags = int(m[b, 0]), int(m[b, 1]), int(m[b, 6])
        n = 1 << min(max(int(m[b, 2]), 2), max_log2)
        yt, xl = max(y - 1, 0), max(x - 1, 0)
        ys, xs = [], []
        for bit, lo, top in ((8, 0, True), (16, n, True), (2, 0, False),
                             (1, n, False)):
            if flags & bit:
                k = np.arange(lo, lo + n)
                if top:
                    ys.append(np.full(n, yt))
                    xs.append(np.minimum(x + k, W - 1))
                else:
                    ys.append(np.minimum(y + k, H - 1))
                    xs.append(np.full(n, xl))
        if flags & 4:
            ys.append(np.array([yt]))
            xs.append(np.array([xl]))
        if not ys:
            level[b] = 0
            continue
        o = owner[np.concatenate(ys) // 4, np.concatenate(xs) // 4] - 1
        if (o > b).any():
            raise ValueError(f"intra_schedule: row {b}: {ERRORS[2]}")
        deps = o[(o >= 0) & (o != b)]
        level[b] = 1 + level[deps].max() if deps.size else 0
    return level


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

# csrc/intra.cu IntraLaunch: three Planes (px, res, meta, owner, px_in
# pointers; n_meta, H, W, c_idx), the tickets and error pointers, n_planes,
# bd, strong, c444
_LAUNCH = struct.Struct("@" + "5P4i" * 3 + "2P4i")


class IntraErrors:
    """K1's error word on its way to the host: a copy into pinned host
    memory behind an event on the launch's stream, so the launch never
    waits.  ``check`` waits for that event and raises where the kernel
    met metadata it cannot schedule."""

    def __init__(self, word, event=None):
        self.word = word            # (1,) int32 host tensor
        self.event = event          # None: the word is already there

    def check(self, poc=None):
        if self.event is not None:
            self.event.synchronize()
        err = int(self.word[0])
        if err:
            where = "" if poc is None else f" (frame POC {poc})"
            raise RuntimeError(
                f"intra: metadata the wavefront cannot schedule{where}: "
                + "; ".join(v for k, v in ERRORS.items() if err & k))


def intra_planes(planes, resids, metas, c_idxs, bd, strong, c444):
    """Reconstruct the intra blocks of up to three planes.

    planes/resids: (H, W) int32 tensors; metas: (n_chunks, CHUNK, NF) int32
    tensors in decode order; c_idxs: the plane indices.  Returns (new
    planes, errors).  CPU tensors take the plain version (decode order,
    any metadata), and errors is None.  CUDA tensors take the wavefront
    kernel (all planes in one call); errors is an IntraErrors whose
    ``check`` raises on metadata the kernel could not schedule (see
    intra_schedule).  Nothing here waits for the device.
    """
    if not planes:
        return [], None
    dev = planes[0].device
    for p, r, m in zip(planes, resids, metas):
        for t in (p, r, m):
            if t.device != dev or t.dtype != torch.int32:
                raise ValueError("intra: int32 tensors on one device "
                                 "expected")
            if not t.is_contiguous():
                raise ValueError("intra: contiguous tensors expected")
        if r.shape != p.shape or m.shape[-1] != NF or p.dim() != 2:
            raise ValueError("intra: bad shapes")
    if not 8 <= bd <= 14 or len(planes) > 3:
        raise ValueError("intra: unsupported arguments")
    if dev.type == "cpu":
        return [intra_plane_plain(p, r, m, c, bd, strong, c444)
                for p, r, m, c in zip(planes, resids, metas, c_idxs)], None
    if dev.type != "cuda":
        raise ValueError(f"intra: unsupported device {dev}")
    cuda_lib.check_size("ohk_intra", _LAUNCH.size)
    outs = [p.clone() for p in planes]
    units = [-(-o.shape[0] // 4) * -(-o.shape[1] // 4) for o in outs]
    # owner maps, three ticket counters, the error word
    scratch = torch.zeros(sum(units) + 4, dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    fields, owner = [], 0
    for o, p, r, m, c, u in zip(outs, planes, resids, metas, c_idxs, units):
        fields += [o.data_ptr(), r.data_ptr(), m.data_ptr(),
                   base + 4 * owner, p.data_ptr(), m.numel() // NF,
                   o.shape[0], o.shape[1], c]
        owner += u
    fields += [0] * 9 * (3 - len(planes))
    q = _LAUNCH.pack(*fields, base + 4 * owner, base + 4 * (owner + 3),
                     len(planes), bd, int(bool(strong)), int(bool(c444)))
    stream = torch.cuda.current_stream(dev)
    cuda_lib.launch("ohk_intra", q, stream.cuda_stream)
    device.count("intra")
    word = torch.empty(1, dtype=torch.int32, pin_memory=True)
    word.copy_(scratch[-1:], non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return outs, IntraErrors(word, event)
