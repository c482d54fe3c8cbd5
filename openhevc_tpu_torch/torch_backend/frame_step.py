"""One frame's reconstruction on the device, through the four kernels.

Port of ``openhevc_tpu/tpu/frame_step.py::frame_step`` for depths 8 to 14
in 4:2:0, 4:2:2 and 4:4:4 with unweighted prediction and flat dequant: MC
through one K2 pass and the unweighted uni/bi combine, painted by one K3
pass; X1 dequant+IDCT and the residual canvas painted by a second K3 pass,
then the cross-component mix (RExt 4:4:4); intra through K1; deblocking +
SAO of all three planes through one K4 launch; the output wire (raw 8-bit,
10- and 12-bit packed, 16-bit otherwise).  Everything runs on the current
stream and nothing waits for the device.  What the reference handles
beyond that (weighted prediction, scaling lists, PCM, per-CTB deblocking
maps) raises NotImplementedError in prepare_host (see ROADMAP.md).
"""

import functools

import numpy as np
import torch

from .device import table
from .filter import build_chroma_grids, build_luma_grids, filter_planes
from .intra import intra_planes
from .mc import McGroup, mc_pass
from .paint import paint_groups_
from .residual import residual_batch

QP_C = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)


@functools.lru_cache(maxsize=None)
def qpc_table(dev):
    """QP_C on dev, made once a device."""
    return table(QP_C, dev, np.int32)


def frame_step(refs, arrays, prof):
    """refs: [3 stacked (R, H, W) int32 reference tensors] or None;
    arrays: frame_arrays() dict; prof: the static profile from
    prepare_host.
    -> (Y, U, V int32 planes, the output wire (uint8, or int16 samples:
    output_wire), K1's errors: an intra.IntraErrors, or None where K1 did
    not run on the card)."""
    bd, cfmt, H, W = prof["bd"], prof["cfmt"], prof["H"], prof["W"]
    dev = arrays[("map", "qp")].device
    hs = 1 if cfmt in (1, 2) else 0
    vs = 1 if cfmt == 1 else 0
    maxv = (1 << bd) - 1
    shapes = [(H, W), (H >> vs, W >> hs), (H >> vs, W >> hs)]
    planes = [torch.zeros(s, dtype=torch.int32, device=dev) for s in shapes]

    # ---- motion compensation: one K2 pass over the compacted work batches
    # of every tile size and plane, the unweighted put_hevc_qpel_{uni,bi}
    # combine, one K3 pass; the rounding offsets pin to 0 at depth 14, as
    # in the reference's BIT_DEPTH 14 template ----
    off_u = (1 << (14 - bd - 1)) if bd < 14 else 0
    off_b = (1 << (15 - bd - 1)) if bd < 14 else 0
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
    for (c, n, _N) in prof["resid_keys"]:
        d = {f: arrays[("resid", c, n, f)]
             for f in ("xs", "ys", "qp", "kind", "xtra", "levels", "valid")}
        res = residual_batch(d["levels"], d["qp"], d["kind"], n, bd,
                             xtra=d["xtra"])
        res_pass.append((rc16[c],
                         torch.clamp(res, -32768, 32767).to(torch.int16),
                         d["xs"], d["ys"], d["valid"]))
    paint_groups_(res_pass)
    rcanvas = [r.to(torch.int32) for r in rc16]
    # cross-component prediction (RExt 4:4:4): the scaled luma residual
    # joins each chroma canvas in its flagged TUs, with int16 wraparound
    if prof["has_cc"]:
        for c in (1, 2):
            amap = arrays.get(("ccmap", c))
            if amap is not None:
                mixed = rcanvas[c] + ((amap * rcanvas[0]) >> 3)
                rcanvas[c] = ((mixed + 0x8000) & 0xFFFF) - 0x8000
    # inter pixels become final here; intra pixels are overwritten by K1
    planes = [torch.clamp(planes[c] + rcanvas[c], 0, maxv) for c in range(3)]

    # ---- intra: K1, all planes in one launch ----
    errors = None
    if prof["ipal"]:
        cs = [c for (c, _bands) in prof["ipal"]]
        metas = [arrays[("ipal", c, bands[0][0])]
                 for (c, bands) in prof["ipal"]]
        got, errors = intra_planes(
            [planes[c] for c in cs], [rcanvas[c] for c in cs], metas,
            [min(c, 1) for c in cs], bd, prof["strong"], cfmt == 3)
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
            grids = [build_luma_grids(vbs, hbs, qp_map, prof["beta_off"],
                                      prof["tc_off"], nfm, bd, Hp, Wp)]
            for off in (prof["cb_off"], prof["cr_off"]):
                grids.append(build_chroma_grids(
                    vbs, hbs, qp_map, off, prof["tc_off"], prof["tc_off"],
                    nfm, qpc_table(dev), bd, Hp >> vs, Wp >> hs, 1 << hs,
                    1 << vs, four20=(cfmt == 1)))
        if sao_on:
            sao = [tuple(arrays[("sao", c, f)]
                         for f in ("tm", "bm", "em", "om")) for c in range(3)]
            restores = [arrays.get(("sao", c, "restore")) for c in range(3)]
        planes = filter_planes(planes, grids, sao, restores, bd=bd,
                               deblock_on=deblock_on, sao_on=sao_on,
                               ctb=1 << (prof["log2_ctb"] or 6), hs=hs, vs=vs)

    return tuple(planes) + (output_wire(planes, bd), errors)


def output_wire(planes, bd):
    """The planes as one flat buffer for the host (refs.Frame.host_planes
    reads it back): raw uint8 at depth 8; at depth 10, 4 samples in 5
    bytes; at depth 12, 2 samples in 3 bytes (where every plane's size
    divides); 16-bit samples otherwise, carried as int16 (every sample is
    below 2^14) and read back as uint16 (wire.Wire).  The packing runs in
    int64: the 10-bit word's top bits would set int32's sign."""
    if bd == 8:
        return torch.cat([p.to(torch.uint8).reshape(-1) for p in planes])
    if bd == 10 and all(p.numel() % 4 == 0 for p in planes):
        def pack(p):
            s = p.reshape(-1, 4).long()
            lo = (s[:, 0] | (s[:, 1] << 10) | (s[:, 2] << 20) |
                  ((s[:, 3] & 3) << 30))
            return [lo & 255, (lo >> 8) & 255, (lo >> 16) & 255,
                    (lo >> 24) & 255, s[:, 3] >> 2]
    elif bd == 12 and all(p.numel() % 2 == 0 for p in planes):
        def pack(p):
            s = p.reshape(-1, 2).long()
            lo = s[:, 0] | (s[:, 1] << 12)
            return [lo & 255, (lo >> 8) & 255, (lo >> 16) & 255]
    else:
        return torch.cat([p.to(torch.int16).reshape(-1) for p in planes])
    return torch.cat([torch.stack(pack(p), 1).to(torch.uint8).reshape(-1)
                      for p in planes])
