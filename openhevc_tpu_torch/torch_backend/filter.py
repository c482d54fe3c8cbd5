"""K4: deblocking + SAO of a frame's planes (csrc/filter.cu), its plain
version, and the per-edge / per-CTB parameter grids.

Counterpart of ``openhevc_tpu/tpu/filter_pallas.py``: per plane, the
vertical edges filter first, then the horizontal edges of that output,
then SAO on the deblocked samples with the picture-border exclusions,
then the PCM/bypass restore mask.  On the card, ``filter_planes`` runs all
three planes of a frame in one launch, one thread block a CTB, and the
kernel reads the grids in the layout the builders return.  The grid
builders keep the reference's padded layout exactly (V grids:
((Hp+16)/4, Wp/8) with two zero group-rows above and column k = edge at
x = 8k; H grids: (Hp/8, Wp/4) with row k = edge at y = 8k), so the tests
hold them against the reference array for array.
"""

import functools
import struct

import numpy as np
import torch

from ..model.filters import BETA_TABLE, TC_TABLE
from . import cuda_lib, device

HALO = 8
_BETA = np.asarray(BETA_TABLE, np.int32)
_TC = np.asarray(TC_TABLE, np.int32)


@functools.lru_cache(maxsize=None)
def tables(dev):
    """The constant tables of the grid builders on dev, made once a
    device."""
    return dict(beta=device.table(_BETA, dev), tc=device.table(_TC, dev))


def _b2(x, axis):
    return torch.repeat_interleave(x, 2, dim=axis)


def build_luma_grids(vbs, hbs, qp_map, beta_off, tc_off, nfm, bd, Hp, Wp):
    """-> ((v_tc, v_beta, v_nop, v_noq), (h_tc, h_beta, h_nop, h_noq)).

    Scalar beta/tc offsets only (per-CTB offset maps are not ported yet).
    """
    if isinstance(beta_off, tuple) or isinstance(tc_off, tuple):
        raise NotImplementedError("per-CTB deblocking offset maps")
    dev = qp_map.device
    consts = tables(dev)
    beta_t, tc_t = consts["beta"], consts["tc"]
    ne = Wp // 8 - 1
    bs4 = vbs[:, 1:ne + 1]
    qp8 = (qp_map[:, 0:ne] + qp_map[:, 1:ne + 1] + 1) >> 1
    qp4 = _b2(qp8, 0)
    beta4 = beta_t[torch.clamp(qp4 + beta_off, 0, 51).long()] << (bd - 8)
    tc4 = torch.where(
        bs4 > 0, tc_t[torch.clamp(qp4 + 2 * (bs4 - 1) + tc_off, 0, 53).long()],
        0) << (bd - 8)
    nop4 = nfm[:, 1:2 * ne:2]
    noq4 = nfm[:, 2:2 * ne + 2:2]

    def vfin(g):
        return torch.nn.functional.pad(g, (1, 0, HALO // 4, HALO // 4))

    neh = Hp // 8 - 1
    bs4h = hbs[1:neh + 1, :]
    qp8h = (qp_map[0:neh, :] + qp_map[1:neh + 1, :] + 1) >> 1
    qp4h = _b2(qp8h, 1)
    beta4h = beta_t[torch.clamp(qp4h + beta_off, 0, 51).long()] << (bd - 8)
    tc4h = torch.where(
        bs4h > 0,
        tc_t[torch.clamp(qp4h + 2 * (bs4h - 1) + tc_off, 0, 53).long()],
        0) << (bd - 8)
    yq2 = torch.arange(1, neh + 1, device=dev) * 2
    nop4h = nfm[yq2 - 1, :]
    noq4h = nfm[yq2, :]

    def hfin(g):
        return torch.nn.functional.pad(g, (0, 0, 1, 0))

    return ((vfin(tc4), vfin(beta4), vfin(nop4), vfin(noq4)),
            (hfin(tc4h), hfin(beta4h), hfin(nop4h), hfin(noq4h)))


def _chroma_qpc(qpj, qp_off, qpc_table, four20):
    qpi = torch.clamp(qpj + qp_off, 0, 57)
    if four20:
        return torch.where(qpi < 30, qpi, torch.where(
            qpi > 43, qpi - 6, qpc_table[torch.clamp(qpi - 30, 0, 13).long()]))
    return torch.clamp(qpi, max=51)


def build_chroma_grids(vbs, hbs, qp_map, qp_off, tc_off_v, tc_off_h, nfm,
                       qpc_table, bd, Hc, Wc, hsub, vsub, four20):
    """Chroma-plane grids: ((v_tc, v_nop, v_noq), (h_tc, h_nop, h_noq))."""
    dev = qp_map.device
    tc_t = tables(dev)["tc"]
    ar = lambda n: torch.arange(n, device=dev)   # noqa: E731
    ne = Wc // 8 - 1
    ex = (ar(ne) + 1) * hsub
    y4 = vsub * ar(Hc // 4)
    bs4 = vbs[y4[:, None], ex[None, :]]
    qy = y4 >> 1
    qpj = (qp_map[qy[:, None], ex[None, :] - 1] +
           qp_map[qy[:, None], ex[None, :]] + 1) >> 1
    qpc = _chroma_qpc(qpj, qp_off, qpc_table, four20)
    tc4 = torch.where(bs4 == 2,
                      tc_t[torch.clamp(qpc + 2 + tc_off_v, 0, 53).long()],
                      0) << (bd - 8)
    x4 = ex * 2
    nop4 = nfm[y4[:, None], (x4 - 1)[None, :]]
    noq4 = nfm[y4[:, None], x4[None, :]]

    def vfin(g):
        return torch.nn.functional.pad(g, (1, 0, HALO // 4, HALO // 4))

    neh = Hc // 8 - 1
    ey = (ar(neh) + 1) * vsub
    x4l = hsub * ar(Wc // 4)
    bs4h = hbs[ey[:, None], x4l[None, :]]
    qx = x4l >> 1
    qpjh = (qp_map[(ey - 1)[:, None], qx[None, :]] +
            qp_map[ey[:, None], qx[None, :]] + 1) >> 1
    qpch = _chroma_qpc(qpjh, qp_off, qpc_table, four20)
    tc4h = torch.where(bs4h == 2,
                       tc_t[torch.clamp(qpch + 2 + tc_off_h, 0, 53).long()],
                       0) << (bd - 8)
    y4l = ey * 2
    nop4h = nfm[(y4l - 1)[:, None], x4l[None, :]]
    noq4h = nfm[y4l[:, None], x4l[None, :]]

    def hfin(g):
        return torch.nn.functional.pad(g, (0, 0, 1, 0))

    return ((vfin(tc4), vfin(nop4), vfin(noq4)),
            (hfin(tc4h), hfin(nop4h), hfin(noq4h)))


def build_sao_grids(plan, c_idx, grid_shape):
    """Host-side: per-CTB SAO params -> per-CTB grids (rows, cols): type,
    band position, edge class, and the 5 offsets.  Copied from the
    reference's tpu/sao.py (which imports JAX)."""
    rows, cols = grid_shape
    raw = getattr(plan, "sao_raw", None)
    if raw is not None and raw.shape[0] == rows * cols:
        r = np.asarray(raw).reshape(rows, cols, 24)
        return (np.ascontiguousarray(r[:, :, 0 + c_idx]),
                np.ascontiguousarray(r[:, :, 3 + c_idx]),
                np.ascontiguousarray(r[:, :, 6 + c_idx]),
                np.ascontiguousarray(r[:, :, 9:24].reshape(
                    rows, cols, 3, 5)[:, :, c_idx]))
    type_g = np.zeros((rows, cols), np.int32)
    band_g = np.zeros((rows, cols), np.int32)
    eo_g = np.zeros((rows, cols), np.int32)
    off_g = np.zeros((rows, cols, 5), np.int32)
    if plan.sao is None:
        return type_g, band_g, eo_g, off_g
    for (rx, ry), sao in plan.sao.items():
        if rx >= cols or ry >= rows:
            continue
        type_g[ry, rx] = int(sao.sao_type[c_idx])
        band_g[ry, rx] = int(sao.sao_band_position[c_idx])
        eo_g[ry, rx] = int(sao.sao_eo_class[c_idx])
        off_g[ry, rx, :] = np.asarray(sao.sao_offsets[c_idx], np.int32)
    return type_g, band_g, eo_g, off_g


# ---------------------------------------------------------------------------
# per-pass edge parameters: (G, K) int32, group g of 4 lines, edge k+1
# ---------------------------------------------------------------------------

def _edge_params(vgrids, hgrids, luma):
    """-> ((PH, PW), [(vertical, G, K, (tc, beta, nop, noq))]).

    Deblocking runs on the plane zero-padded to the grids' geometry
    (PH, PW), as the reference's kernel does; every grid edge is visited
    (edges outside the picture carry tc = 0 in real plans)."""
    vt, ht = vgrids[0], hgrids[0]
    Gv, Kv = vt.shape[0] - HALO // 2, vt.shape[1] - 1
    Kh, Gh = ht.shape[0] - 1, ht.shape[1]
    half = 4 if luma else 2
    geom = (max(4 * Gv, 8 * Kh + half), max(8 * Kv + half, 4 * Gh))
    out = []
    for vertical, grids, G, K in ((True, vgrids, Gv, Kv),
                                  (False, hgrids, Gh, Kh)):
        if vertical:
            sel = lambda g: g[HALO // 4:HALO // 4 + G, 1:1 + K]  # noqa: E731
        else:
            sel = lambda g: g[1:1 + K, :G].t()  # noqa: E731
        if luma:
            ps = tuple(sel(g) for g in grids)
        else:
            ps = (sel(grids[0]), sel(grids[0]), sel(grids[1]), sel(grids[2]))
        out.append((vertical, G, K,
                    tuple(p.to(torch.int32).contiguous() for p in ps)))
    return geom, out


def _padded(plane, geom):
    H, W = plane.shape
    PH, PW = max(H, geom[0]), max(W, geom[1])
    return torch.nn.functional.pad(plane, (0, PW - W, 0, PH - H))


def _deblock_pass_plain(P, G, K, params, luma, vertical, bd):
    """One pass on plane P (in place): edges at 8*(k+1), groups of 4 lines."""
    if G <= 0 or K <= 0:
        return P
    maxv = (1 << bd) - 1
    A = P if vertical else P.t()
    tc, beta, nop, noq = (p.long() for p in params)
    dev = P.device
    lines = 4 * G
    cols = 8 * (torch.arange(K, device=dev) + 1)
    half = 4 if luma else 2
    taps = cols[None, :] + torch.arange(-half, half, device=dev)[:, None]
    S = A[:lines].long()[:, taps]              # (lines, 2*half, K)

    def ex(g):                                 # (G, K) -> (lines, K)
        return torch.repeat_interleave(g, 4, dim=0)
    tcl = ex(tc)
    if not luma:
        p1, p0, q0, q1 = (S[:, i] for i in range(4))
        delta = torch.clamp((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tcl, tcl)
        act = tcl > 0
        np0 = torch.where(act & (ex(nop) == 0),
                          torch.clamp(p0 + delta, 0, maxv), p0)
        nq0 = torch.where(act & (ex(noq) == 0),
                          torch.clamp(q0 - delta, 0, maxv), q0)
        new = torch.stack([p1, np0, nq0, q1], 1)
    else:
        p3, p2, p1, p0, q0, q1, q2, q3 = (S[:, i] for i in range(8))
        betal = ex(beta)
        dp = (p2 - 2 * p1 + p0).abs()
        dq = (q2 - 2 * q1 + q0).abs()
        sd = (p3 - p0).abs() + (q3 - q0).abs()
        pq = (p0 - q0).abs()

        def grp(v, pick):                      # line `pick` of each group
            return ex(v.reshape(G, 4, K)[:, pick])
        dp0, dp3, dq0, dq3 = grp(dp, 0), grp(dp, 3), grp(dq, 0), grp(dq, 3)
        d0, d3 = dp0 + dq0, dp3 + dq3
        active = (d0 + d3 < betal) & (tcl > 0)
        beta3, beta2 = betal >> 3, betal >> 2
        tc25 = (tcl * 5 + 1) >> 1
        strong = ((grp(sd, 0) < beta3) & (grp(pq, 0) < tc25) &
                  (grp(sd, 3) < beta3) & (grp(pq, 3) < tc25) &
                  ((d0 << 1) < beta2) & ((d3 << 1) < beta2))
        nd_p = (dp0 + dp3) < ((betal + (betal >> 1)) >> 3)
        nd_q = (dq0 + dq3) < ((betal + (betal >> 1)) >> 3)
        t2 = tcl << 1
        cl = lambda v, t: torch.maximum(torch.minimum(v, t), -t)  # noqa
        sp0 = p0 + cl(((p2 + 2*p1 + 2*p0 + 2*q0 + q1 + 4) >> 3) - p0, t2)
        sp1 = p1 + cl(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, t2)
        sp2 = p2 + cl(((2*p3 + 3*p2 + p1 + p0 + q0 + 4) >> 3) - p2, t2)
        sq0 = q0 + cl(((p1 + 2*p0 + 2*q0 + 2*q1 + q2 + 4) >> 3) - q0, t2)
        sq1 = q1 + cl(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, t2)
        sq2 = q2 + cl(((2*q3 + 3*q2 + q1 + q0 + p0 + 4) >> 3) - q2, t2)
        tch = tcl >> 1
        delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        apply_n = delta0.abs() < 10 * tcl
        d0c = cl(delta0, tcl)
        np0 = torch.clamp(p0 + d0c, 0, maxv)
        nq0 = torch.clamp(q0 - d0c, 0, maxv)
        np1 = torch.clamp(p1 + cl((((p2 + p0 + 1) >> 1) - p1 + d0c) >> 1, tch),
                          0, maxv)
        nq1 = torch.clamp(q1 + cl((((q2 + q0 + 1) >> 1) - q1 - d0c) >> 1, tch),
                          0, maxv)
        okp, okq = ex(nop) == 0, ex(noq) == 0
        s = strong & active
        nrm = ~strong & active & apply_n
        W_ = torch.where
        fp0 = W_(s & okp, sp0, W_(nrm & okp, np0, p0))
        fp1 = W_(s & okp, sp1, W_(nrm & okp & nd_p, np1, p1))
        fp2 = W_(s & okp, sp2, p2)
        fq0 = W_(s & okq, sq0, W_(nrm & okq, nq0, q0))
        fq1 = W_(s & okq, sq1, W_(nrm & okq & nd_q, nq1, q1))
        fq2 = W_(s & okq, sq2, q2)
        new = torch.stack([p3, fp2, fp1, fp0, fq0, fq1, fq2, q3], 1)
    rows = torch.arange(lines, device=dev)[:, None, None]
    A[rows, taps[None]] = new.to(A.dtype)
    return P


def _sao_plain(src, tm, bm, em, om, csx, csy, restore, bd):
    H, W = src.shape
    dev = src.device
    cy = torch.arange(H, device=dev) // csy
    cx = torch.arange(W, device=dev) // csx
    t = tm[cy[:, None], cx[None, :]]
    bmp = bm[cy[:, None], cx[None, :]]
    emp = em[cy[:, None], cx[None, :]]
    off = om[cy[:, None], cx[None, :]]               # (H, W, 5)
    maxv = (1 << bd) - 1
    v = src.long()
    band_idx = ((v >> (bd - 5)) - bmp) & 31
    boff = torch.zeros_like(v)
    for k in range(4):
        boff = boff + torch.where(band_idx == k, off[..., k + 1], 0)
    band_out = torch.clamp(v + boff, 0, maxv)
    pad = torch.nn.functional.pad(v[None, None].double(), (1, 1, 1, 1),
                                  mode="replicate")[0, 0].long()
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    border_x = ((xs == 0) | (xs == W - 1))[None, :]
    border_y = ((ys == 0) | (ys == H - 1))[:, None]
    edge_out = v
    for cls, (dx, dy) in enumerate(((-1, 0), (0, -1), (-1, -1), (1, -1))):
        n0 = pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        n1 = pad[1 - dy:1 - dy + H, 1 - dx:1 - dx + W]
        s2 = torch.sign(v - n0) + torch.sign(v - n1)
        o = torch.where(s2 == -2, off[..., 1], torch.where(
            s2 == -1, off[..., 2], torch.where(
                s2 == 1, off[..., 3], torch.where(s2 == 2, off[..., 4], 0))))
        filt = torch.clamp(v + o, 0, maxv)
        if cls != 1:
            filt = torch.where(border_x, v, filt)
        if cls != 0:
            filt = torch.where(border_y, v, filt)
        edge_out = torch.where(emp == cls, filt, edge_out)
    out = torch.where(t == 1, band_out, torch.where(t == 2, edge_out, v))
    if restore is not None:
        out = torch.where(restore != 0, v, out)
    return out.to(torch.int32)


def _filter_plain(plane, deblock, sao, restore, luma, bd, csx, csy):
    H, W = plane.shape
    out = plane
    if deblock is not None:
        geom, passes = deblock
        buf = _padded(plane, geom)
        for vertical, G, K, ps in passes:
            _deblock_pass_plain(buf, G, K, ps, luma, vertical, bd)
        out = buf[:H, :W].contiguous()
    if sao is not None:
        out = _sao_plain(out, *sao, csx, csy, restore, bd)
    return out.clone() if out is plane else out


def filter_plane_plain(plane, vgrids, hgrids, sao_grids, restore, *, luma,
                       bd, deblock_on, sao_on, csx, csy):
    """Plain version of one plane of the kernel, on any device (the
    wrappers take it for CPU tensors only)."""
    deblock = _edge_params(vgrids, hgrids, luma) if deblock_on else None
    sao = (tuple(g.to(torch.int32) for g in sao_grids) if sao_on else None)
    if restore is not None:
        restore = restore.to(torch.int32)
    return _filter_plain(plane, deblock, sao, restore, luma, bd, csx, csy)


def _plane_jobs(planes, grids, sao_grids, restores, ctb, hs, vs):
    """filter_planes' arguments -> one (plane, vgrids, hgrids, sao grids,
    restore, luma, csx, csy) job a plane; plane 0 is luma."""
    n = len(planes)
    grids = grids if grids is not None else [(None, None)] * n
    sao_grids = sao_grids if sao_grids is not None else [None] * n
    restores = restores if restores is not None else [None] * n
    if not (len(grids) == len(sao_grids) == len(restores) == n):
        raise ValueError("filter: one entry a plane in every list")
    return [(p, g[0], g[1], s, r, c == 0, ctb >> (hs if c else 0),
             ctb >> (vs if c else 0))
            for c, (p, g, s, r) in enumerate(zip(planes, grids, sao_grids,
                                                  restores))]


def _plain_jobs(jobs, *, bd, deblock_on, sao_on):
    return [filter_plane_plain(p, vg, hg, sg, rs, luma=luma, bd=bd,
                               deblock_on=deblock_on, sao_on=sao_on,
                               csx=csx, csy=csy)
            for (p, vg, hg, sg, rs, luma, csx, csy) in jobs]


def filter_planes_plain(planes, grids, sao_grids, restores, *, bd,
                        deblock_on, sao_on, ctb, hs, vs):
    """Plain version of filter_planes: each plane through
    filter_plane_plain."""
    return _plain_jobs(
        _plane_jobs(planes, grids, sao_grids, restores, ctb, hs, vs),
        bd=bd, deblock_on=deblock_on, sao_on=sao_on)


# csrc/filter.cu FilterPlane: a 128-byte CUtensorMap (left blank; the
# launcher encodes it), src, dst, 4 + 4 grid, 4 SAO and the restore
# pointers; H, W, vrows, vcols, hrows, hcols, csx, csy, log2csx, cols,
# gcols, first_cta, luma; padding to its 64-byte alignment
_PLANE = struct.Struct("@128x15P13i20x")
MAX_PLANES = 3
# FilterFrame: MAX_PLANES planes, n_planes, n_ctas, bd, deblock, sao
_FRAME_SIZE = 1024
MAX_CTB = 64


def _check_grid(g, shape, dev, what):
    if (g.dtype != torch.int32 or g.device != dev or not g.is_contiguous()
            or (shape is not None and tuple(g.shape) != shape)):
        raise ValueError(f"filter: {what} must be contiguous int32 "
                         f"{shape if shape else ''} on the planes' device")


def _check_jobs(jobs, deblock_on, sao_on, bd):
    """The kernel's contract, checked on every device; raises (converts
    nothing).  -> the device."""
    if not 8 <= bd <= 14:
        raise ValueError("filter: unsupported bit depth")
    if not 1 <= len(jobs) <= MAX_PLANES:
        raise ValueError(f"filter: 1 to {MAX_PLANES} planes")
    dev = jobs[0][0].device
    for (plane, vg, hg, sg, rs, luma, csx, csy) in jobs:
        if plane.dim() != 2:
            raise ValueError("filter: (H, W) planes expected")
        _check_grid(plane, None, dev, "planes")
        H, W = plane.shape
        if not (8 <= csx <= MAX_CTB and 8 <= csy <= MAX_CTB
                and csx & (csx - 1) == 0 and csy % 8 == 0):
            raise ValueError("filter: CTB of 8 to 64 samples expected")
        if deblock_on:
            n = 4 if luma else 3
            if len(vg) != n or len(hg) != n:
                raise ValueError(f"filter: {n} vertical and {n} horizontal "
                                 f"grids expected")
            for g in vg:
                _check_grid(g, tuple(vg[0].shape), dev, "vertical grids")
            for g in hg:
                _check_grid(g, tuple(hg[0].shape), dev, "horizontal grids")
            if vg[0].dim() != 2 or hg[0].dim() != 2 or vg[0].shape[0] < 4:
                raise ValueError("filter: grids in the builders' layout "
                                 "expected")
        if sao_on:
            tm = sg[0]
            rows, cols = -(-H // csy), -(-W // csx)
            if tm.dim() != 2 or tm.shape[0] < rows or tm.shape[1] < cols:
                raise ValueError("filter: SAO grids must cover the CTBs")
            for g in sg[:3]:
                _check_grid(g, tuple(tm.shape), dev, "SAO grids")
            _check_grid(sg[3], tuple(tm.shape) + (5,), dev, "SAO offsets")
            if rs is not None:
                _check_grid(rs, (H, W), dev, "the restore mask")
    return dev


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def pack_frame(jobs, outs, *, bd, deblock_on, sao_on):
    """The kernel's FilterFrame for these planes and output planes (tensor
    maps blank).  -> (bytes, number of thread blocks: one a CTB)."""
    desc = bytearray(_FRAME_SIZE)
    cta = 0
    for k, ((plane, vg, hg, sg, rs, luma, csx, csy), out) in enumerate(
            zip(jobs, outs)):
        H, W = plane.shape
        cols = -(-W // csx)
        if deblock_on:                     # chroma: tc in the beta slot
            vgp, hgp = ([g.data_ptr() for g in (gs if luma else
                                                  (gs[0],) + tuple(gs))]
                        for gs in (vg, hg))
        else:
            vgp = hgp = [0] * 4
        vshape = tuple(vg[0].shape) if deblock_on else (0, 0)
        hshape = tuple(hg[0].shape) if deblock_on else (0, 0)
        sp = [_ptr(g) for g in sg] if sao_on else [0] * 4
        _PLANE.pack_into(
            desc, k * _PLANE.size, plane.data_ptr(), out.data_ptr(),
            *vgp, *hgp, *sp, _ptr(rs) if sao_on else 0, H, W, *vshape,
            *hshape, csx, csy, csx.bit_length() - 1, cols,
            sg[0].shape[1] if sao_on else 0, cta, int(bool(luma)))
        cta += -(-H // csy) * cols
    struct.pack_into("@5i", desc, MAX_PLANES * _PLANE.size, len(jobs), cta,
                     bd, int(bool(deblock_on)), int(bool(sao_on)))
    return bytes(desc), cta


def _filter_jobs(jobs, *, bd, deblock_on, sao_on):
    dev = _check_jobs(jobs, deblock_on, sao_on, bd)
    if dev.type == "cpu":
        return _plain_jobs(jobs, bd=bd, deblock_on=deblock_on, sao_on=sao_on)
    if dev.type != "cuda":
        raise ValueError(f"filter: unsupported device {dev}")
    if not (deblock_on or sao_on):
        return [j[0].clone() for j in jobs]
    for j in jobs:
        if j[0].shape[1] % 4 or j[0].data_ptr() % 16:
            raise ValueError("filter: the kernel's tensor map needs rows of "
                             "a multiple of 16 bytes, 16-byte aligned")
    cuda_lib.check_size("ohk_filter_frame", _FRAME_SIZE)
    outs = [torch.empty_like(j[0]) for j in jobs]
    desc, _ = pack_frame(jobs, outs, bd=bd, deblock_on=deblock_on,
                         sao_on=sao_on)
    cuda_lib.launch("ohk_filter_frame", desc, cuda_lib.stream_ptr(dev))
    device.count("filter")
    return outs


def filter_planes(planes, grids, sao_grids, restores, *, bd, deblock_on,
                  sao_on, ctb, hs, vs):
    """A frame's planes (luma first) -> deblocked + SAO planes (new
    tensors), in one kernel launch on the card.

    planes: (H, W) int32; grids: a (vgrids, hgrids) pair a plane from
    build_{luma,chroma}_grids (None without deblocking); sao_grids: a
    (tm, bm, em, om) tuple a plane, (rows, cols) and (rows, cols, 5)
    int32 (None without SAO); restores: an (H, W) int32 mask a plane or
    None, samples that keep their deblocked value (None for none).  CTBs
    are ctb x ctb luma samples, chroma subsampled by (hs, vs).  Every
    tensor must already be contiguous int32 on the planes' device: this
    raises, it does not convert.
    """
    jobs = _plane_jobs(planes, grids, sao_grids, restores, ctb, hs, vs)
    return _filter_jobs(jobs, bd=bd, deblock_on=deblock_on, sao_on=sao_on)


def filter_plane(plane, vgrids, hgrids, sao_grids, restore, *, luma, bd,
                 deblock_on, sao_on, csx, csy):
    """One plane through the same kernel as filter_planes: (H, W) int32 ->
    deblocked + SAO plane (new tensor).  The SAO grids and the restore
    mask are widened to int32 here when they are not."""
    if plane.dim() != 2 or plane.dtype != torch.int32:
        raise ValueError("filter: (H, W) int32 plane expected")
    if sao_on:
        sao_grids = tuple(g.to(torch.int32).contiguous() for g in sao_grids)
        if restore is not None:
            restore = restore.to(torch.int32).contiguous()
    else:
        restore = None
    return _filter_jobs([(plane, vgrids, hgrids, sao_grids, restore, luma,
                          csx, csy)], bd=bd, deblock_on=deblock_on,
                        sao_on=sao_on)[0]
