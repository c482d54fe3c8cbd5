"""One frame's reconstruction on the device, through the four kernels.

Port of ``openhevc_tpu/tpu/frame_step.py::frame_step`` for the main path
(8-bit 4:2:0, unweighted prediction, flat dequant): MC through one K2 pass
and the unweighted uni/bi combine, painted by one K3 pass; the residual
escapes, X1 dequant+IDCT and the residual canvas painted by a second K3
pass; intra through K1; deblocking + SAO of all three planes through one
K4 launch; the raw 8-bit output wire.  Everything else
the reference handles raises NotImplementedError (see ROADMAP.md).
"""

import torch

from .filter import build_chroma_grids, build_luma_grids, filter_planes
from .intra import intra_planes
from .mc import McGroup, mc_pass
from .paint import paint_groups_
from .residual import residual_batch

QP_C = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


def _apply_escapes(arrays, c, n, levels, E, E8):
    """Widen the 4-bit levels with the int8-value escapes (delta-coded
    indices, scatter-add) and the int16 escapes (scatter-set); indices
    outside the bucket are padding and drop."""
    flat = levels.reshape(-1)
    size = flat.numel()
    if E8:
        dd = arrays[("rese", c, n, "d")] & 0xFFFF
        idx = torch.cumsum(dd.long(), 0) - 1
        val = arrays[("rese", c, n, "val")]
        ok = (idx >= 0) & (idx < size)
        flat = flat.index_add(0, idx[ok], val[ok])
    if E:
        lo = arrays[("resc", c, n, "lo")].long() & 0xFFFF
        hi = arrays[("resc", c, n, "hi")].long()
        idx = (hi << 16) | lo
        val = arrays[("resc", c, n, "val")]
        ok = (idx >= 0) & (idx < size)
        flat = flat.clone()
        flat[idx[ok]] = val[ok]
    return flat.reshape(levels.shape)


def frame_step(refs, arrays, prof):
    """refs: [3 stacked (R, H, W) int32 reference tensors] or None;
    arrays: frame_arrays() dict; prof: the static profile from
    prepare_host.  -> (Y, U, V int32 planes, uint8 wire)."""
    bd, cfmt, H, W = prof["bd"], prof["cfmt"], prof["H"], prof["W"]
    if bd != 8 or cfmt != 1:
        raise NotImplementedError("only 8-bit 4:2:0 is ported")
    dev = arrays[("map", "qp")].device
    hs = vs = 1
    maxv = (1 << bd) - 1
    shapes = [(H, W), (H >> vs, W >> hs), (H >> vs, W >> hs)]
    planes = [torch.zeros(s, dtype=torch.int32, device=dev) for s in shapes]

    # ---- motion compensation: one K2 pass over the compacted work batches
    # of every tile size and plane, the unweighted put_hevc_qpel_{uni,bi}
    # combine, one K3 pass ----
    off_u = 1 << (14 - bd - 1)
    off_b = 1 << (15 - bd - 1)
    batches = [{f: arrays[("inter", w, h, f)]
                for f in ("xs", "ys", "pf", "valid", "i0", "i1", "wxs", "wys",
                          "wsel", "wmvx", "wmvy")}
               for (w, h) in prof["inter_sizes"]]
    groups, uses = [], []
    for (w, h), b in zip(prof["inter_sizes"], batches):
        for c in range(3):
            sh_, sv_ = (hs, vs) if c else (0, 0)
            groups.append(McGroup(refs[c], b["wsel"], b["wxs"], b["wys"],
                                  b["wmvx"], b["wmvy"], w >> sh_, h >> sv_,
                                  c == 0, bd, hs, vs, sh_, sv_))
            uses.append((b, c, sh_, sv_))
    mc_groups = []
    for (b, c, sh_, sv_), out in zip(uses, mc_pass(groups)):
        pf = b["pf"][:, None, None]
        val0 = out[b["i0"].long()]
        val1 = out[b["i1"].long()]
        uni = torch.clamp((torch.where(pf == 1, val0, val1) + off_u)
                          >> (14 - bd), 0, maxv)
        bi = torch.clamp((val0 + val1 + off_b) >> (15 - bd), 0, maxv)
        vals = torch.where(pf == 3, bi, uni).to(torch.int32)
        mc_groups.append((planes[c], vals, b["xs"] >> sh_, b["ys"] >> sv_,
                          b["valid"]))
    paint_groups_(mc_groups)

    # ---- residual canvas: whole-frame dequant+IDCT per (plane, size),
    # int16-clipped and painted by one K3 pass ----
    rc16 = [torch.zeros(s, dtype=torch.int16, device=dev) for s in shapes]
    res_pass = []
    for (c, n, _N, E, E8) in prof["resid_keys"]:
        d = {f: arrays[("resid", c, n, f)]
             for f in ("xs", "ys", "qp", "kind", "xtra", "levels", "valid")}
        levels = _apply_escapes(arrays, c, n, d["levels"], E, E8)
        res = residual_batch(levels, d["qp"], d["kind"], n, bd,
                             xtra=d["xtra"])
        res_pass.append((rc16[c],
                         torch.clamp(res, -32768, 32767).to(torch.int16),
                         d["xs"], d["ys"], d["valid"]))
    paint_groups_(res_pass)
    rcanvas = [r.to(torch.int32) for r in rc16]
    # inter pixels become final here; intra pixels are overwritten by K1
    planes = [torch.clamp(planes[c] + rcanvas[c], 0, maxv) for c in range(3)]

    # ---- intra: K1, all planes in one launch ----
    if prof["ipal"]:
        cs = [c for (c, _bands) in prof["ipal"]]
        metas = [arrays[("ipal", c, bands[0][0])]
                 for (c, bands) in prof["ipal"]]
        got = intra_planes([planes[c] for c in cs], [rcanvas[c] for c in cs],
                           metas, [min(c, 1) for c in cs], bd,
                           prof["strong"], cfmt == 3)
        for c, p in zip(cs, got):
            planes[c] = p

    # ---- deblocking + SAO: K4, all planes in one launch ----
    deblock_on, sao_on = prof["deblock_on"], prof["sao_on"]
    if deblock_on or sao_on:
        Hp, Wp = H + (-H % 16), W + (-W % 16)
        grids = sao = restores = None
        if deblock_on:
            vbs, hbs = arrays[("map", "vbs")], arrays[("map", "hbs")]
            qp_map, nfm = arrays[("map", "qp")], arrays[("map", "nfm")]
            qpc = torch.tensor(QP_C, dtype=torch.int32, device=dev)
            grids = [build_luma_grids(vbs, hbs, qp_map, prof["beta_off"],
                                      prof["tc_off"], nfm, bd, Hp, Wp)]
            for off in (prof["cb_off"], prof["cr_off"]):
                grids.append(build_chroma_grids(
                    vbs, hbs, qp_map, off, prof["tc_off"], prof["tc_off"],
                    nfm, qpc, bd, Hp >> vs, Wp >> hs, 1 << hs, 1 << vs,
                    four20=True))
        if sao_on:
            sao = [tuple(arrays[("sao", c, f)]
                         for f in ("tm", "bm", "em", "om")) for c in range(3)]
            restores = [arrays.get(("sao", c, "restore")) for c in range(3)]
        planes = filter_planes(planes, grids, sao, restores, bd=bd,
                               deblock_on=deblock_on, sao_on=sao_on,
                               ctb=1 << (prof["log2_ctb"] or 6), hs=hs, vs=vs)

    wire = torch.cat([p.to(torch.uint8).reshape(-1) for p in planes])
    return tuple(planes) + (wire,)
