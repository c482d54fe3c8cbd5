"""CudaBackend: the FramePlan -> device reconstruction back-end.

Port of ``openhevc_tpu/tpu/backend.py::TpuBackend`` for the main path: the
host half (``prepare_host``) turns a FramePlan from the native front-end
into named plan arrays, keyed as the reference's ``frame_step._unpack``
keys its output, written straight into one buffer (``upload.py``: pinned
memory from a small ring on the card); ``upload`` moves that buffer with
one host-to-device copy on a copy stream and widens it to int32 on the
compute stream; ``frame_step`` reconstructs the frame with the
hand-written kernels; the output wire comes back through ``wire.Wire``.
The reference's nibble-and-escape coding of the coefficient levels
existed for a ~40 MB/s host link and is not rebuilt: the levels travel as
int16.  Nothing in the dispatch of a frame waits for the device.

Paths are chosen from this backend's device, not from a global backend:
the intra kernel (K1) and the fused deblock+SAO kernel always run
(``ipal``/``ffilt`` in the reference's terms); the reference's XLA
wavefront-scan intra path, the d5 output wire and sharding are not
ported.
"""

import numpy as np
import torch

from ..decoder.plan import FramePlan
from . import plan_soa, upload
from .device import pick_device
from .filter import build_sao_grids
from .frame_step import frame_step
from .plan_compile import TILE_SIZES, pad_batch
from .wire import Wire


def _pow2(x):
    p = 8
    while p < x:
        p *= 2
    return p


def _quant(x):
    """Next size of the form 2^k * {1, 1.25, 1.5, 1.75} (>= 8)."""
    p = _pow2(x)
    if p > 8:
        for m in (10, 12, 14):
            c = (p >> 4) * m
            if c >= x:
                return c
    return p


class CudaBackend:
    """Decoder back-end on one device (``cuda`` unless ``device="cpu"``).

    Sticky batch capacities follow the reference (batches only grow across
    frames of one family), so ``frame_arrays`` matches the reference's plan
    arrays frame for frame.  On the card the backend owns three streams:
    ``copy_stream`` carries the plan uploads, ``d2h_stream`` the output
    wires, and ``compute_stream`` is there for a caller that runs the
    frames' device work off the default stream (runtime/pipeline.py); the
    kernels run on whatever stream is current.
    """

    def __init__(self, device=None):
        self.device = pick_device(device)
        self._inter_caps = {}
        self._work_caps = {}
        self._resid_len = {"I": {}, "PB": {}}
        self._ipal_chunks = {"I": {}, "PB": {}}
        dev = self.device
        if dev.type == "cuda":
            self.copy_stream = torch.cuda.Stream(dev)
            self.compute_stream = torch.cuda.Stream(dev)
            self.d2h_stream = torch.cuda.Stream(dev)
            self._ring = upload.PinnedRing()
        else:
            self.copy_stream = self.compute_stream = self.d2h_stream = None
            self._ring = None

    # ---- frame entry points (decoder/frontend.py calls decode_frame) ----

    def decode_frame(self, plan: FramePlan, dpb):
        """-> ([Y, U, V] device int32 planes, the frame's Wire)."""
        return self.decode_prepared(self.prepare_host(plan), dpb)

    def decode_prepared(self, prep, dpb):
        """Device half: upload the plan arrays, gather the reference planes
        from the DPB, run frame_step on the current stream."""
        plan, host, prof, ref_pocs = prep
        refs = self._build_refs(plan, ref_pocs, dpb) if ref_pocs else None
        *planes, wire, errors = frame_step(refs, self.upload(host), prof)
        return list(planes), Wire(wire, self.d2h_stream, errors, plan.poc)

    def frame_arrays(self, plan: FramePlan):
        """The plan arrays of one frame as int32 device tensors."""
        return self.upload(self.prepare_host(plan)[1])

    def upload(self, host):
        """A HostPlan -> {key: int32 tensor on the device}: one copy."""
        return upload.to_device(host, self.device, self.copy_stream,
                                self._ring)

    def _build_refs(self, plan, ref_pocs, dpb):
        from ..decoder.refs import get_or_synth
        rframes = [get_or_synth(dpb, p, plan.width, plan.height,
                                plan.bit_depth, plan.chroma_format_idc)
                   for p in ref_pocs]
        out = []
        for c in range(3):
            ps = [torch.as_tensor(f.planes[c], device=self.device)
                  .to(torch.int32) for f in rframes]
            out.append(torch.stack(ps))
        return out

    # ---- host half ----

    def prepare_host(self, plan: FramePlan):
        """-> (plan, HostPlan {path: ndarray}, prof, ref_pocs).

        The arrays hold the values the reference's blob carries (int16
        fields cast through int16, int8 fields through int8), except the
        coefficient levels, which are whole int16 values where the
        reference carries nibbles and escapes.  They are views into one
        buffer (upload.HostPlan) laid out as ``prof["layout"]`` says; on
        the card the buffer belongs to the backend's pinned ring and is
        reused a few frames later, so upload it before preparing more.
        """
        bd = plan.bit_depth
        cfmt = plan.chroma_format_idc
        hs = 1 if cfmt in (1, 2) else 0
        vs = 1 if cfmt == 1 else 0
        fam = "I" if plan.slice_type == 2 else "PB"
        soa = getattr(plan, "soa", None)
        if soa is None:
            raise NotImplementedError(
                "CudaBackend needs plans from the native front-end "
                "(Decoder(use_native=True))")
        if plan.scaling is not None:
            raise NotImplementedError("scaling lists")
        if cfmt not in (1, 2, 3) or not 8 <= bd <= 14:
            raise NotImplementedError("monochrome, or a depth outside 8-14")
        if len(soa["pcm"]):
            raise NotImplementedError("PCM base canvas")
        if plan.deblock_beta_map is not None:
            raise NotImplementedError("per-CTB deblocking offset maps")

        out = {}                            # path -> (dtype, array)

        def add(path, arr):                 # int16 fields
            out[path] = (np.int16, np.asarray(arr))

        def add8(path, arr):                # int8 fields
            out[path] = (np.int8, np.asarray(arr))

        def addu(path, arr):                # 2-bit / 1-bit fields
            out[path] = (np.uint8, np.asarray(arr))

        # ---- inter batches (compacted MC work form) ----
        if len(soa["inter"]):
            ref_pocs, s0, s1 = plan_soa.ref_pocs_and_slots(soa["inter"])
            inter = plan_soa.tile_buckets(soa["inter"], s0, s1)
        else:
            ref_pocs, inter = [], {}
        inter_sizes = []
        if inter:
            ident = np.array([1, 0, 1, 0, 1, 0], np.int32)
            for (w, h) in TILE_SIZES:
                batch = inter.get((w, h))
                if batch is None:
                    b = dict(xs=np.zeros(8, np.int32),
                             ys=np.zeros(8, np.int32),
                             pf=np.ones(8, np.int32),
                             s0=np.zeros(8, np.int32),
                             mvx0=np.zeros(8, np.int32),
                             mvy0=np.zeros(8, np.int32),
                             s1=np.zeros(8, np.int32),
                             mvx1=np.zeros(8, np.int32),
                             mvy1=np.zeros(8, np.int32))
                    valid = np.zeros(8, bool)
                else:
                    b, valid = pad_batch(batch)
                    tgt = max(len(valid), self._inter_caps.get((w, h), 8))
                    if tgt > len(valid):
                        pad = tgt - len(valid)
                        b = {k: np.concatenate(
                            [v, np.repeat(v[-1:], pad, axis=0)])
                            for k, v in b.items()}
                        valid = np.concatenate([valid, np.zeros(pad, bool)])
                    self._inter_caps[(w, h)] = len(valid)
                    if (np.any(np.asarray(b["wden"])) or
                            np.any(np.asarray(b["w0"]) != ident) or
                            np.any(np.asarray(b["w1"]) != ident)):
                        raise NotImplementedError("weighted prediction")
                b["valid"] = valid.astype(np.int32)
                b.update(self._work_form(b, valid, (w, h)))
                for f in ("xs", "ys", "i0", "i1", "wxs", "wys", "wmvx",
                          "wmvy"):
                    add(("inter", w, h, f), b[f])
                for f in ("pf", "valid", "wsel"):
                    add8(("inter", w, h, f), b[f])
                inter_sizes.append((w, h))

        # ---- intra metadata (K1, one band per plane) ----
        ipal = ()
        for c in range(3):
            hc = plan.height >> (vs if c else 0)
            (meta,) = plan_soa.intra_meta_bands(
                soa["intra"], c, [(0, hc)], cfmt == 3,
                smoothing_off=bool(plan.intra_smoothing_disabled))
            if meta is None:
                continue
            tgt = max(meta.shape[0], self._ipal_chunks[fam].get((c, 0), 1))
            if meta.shape[0] < tgt:
                meta = np.concatenate(
                    [meta, np.zeros((tgt - meta.shape[0],) + meta.shape[1:],
                                    np.int32)])
            self._ipal_chunks[fam][(c, 0)] = tgt
            add(("ipal", c, 0), meta)
            ipal += ((c, ((0, 0, hc, tgt),)),)

        # ---- whole-frame residual batches ----
        resid = plan_soa.resid_fields(soa["resid"], cfmt)
        resid_keys = []
        lv_specs = []
        for key in sorted(resid.keys()):
            c, n = key
            d = resid[key]
            n_rows = len(d["xs"])
            tgt = max(_quant(max(1, n_rows)), self._resid_len[fam].get(key, 1))
            self._resid_len[fam][key] = tgt
            valid = np.zeros(tgt, np.int32)
            valid[:n_rows] = 1
            for f in ("xs", "ys", "qp", "kind", "mid", "xtra"):
                v = d[f]
                if len(v) < tgt:
                    v = np.concatenate(
                        [v, np.zeros((tgt - len(v),) + v.shape[1:], v.dtype)])
                (add if f in ("xs", "ys") else add8)(("resid", c, n, f), v)
            add8(("resid", c, n, "valid"), valid)
            lv_specs.append((key, n_rows, tgt))
            resid_keys.append((c, n, tgt))

        # ---- cross-component alpha maps (RExt 4:4:4) ----
        has_cc = False
        if cfmt == 3:
            amaps = plan_soa.cc_alpha_maps(soa["resid"], plan.height,
                                           plan.width)
            for c in (1, 2):
                if amaps[c - 1] is not None:
                    add8(("ccmap", c), amaps[c - 1])
                    has_cc = True

        # ---- deblocking maps ----
        deblock_on = not plan.deblock_disable
        ph = -plan.height % 16
        pw = -plan.width % 16

        def padmap(m, dy, dx):
            return np.pad(np.asarray(m), ((0, dy), (0, dx)))

        nfm0 = (plan.no_filter_map if plan.no_filter_map is not None
                else np.zeros((plan.height // 4, plan.width // 4), np.int32))
        addu(("map", "vbs"), padmap(plan.vertical_bs, ph // 4, pw // 8))
        addu(("map", "hbs"), padmap(plan.horizontal_bs, ph // 8, pw // 4))
        add8(("map", "qp"), padmap(plan.qp_map, ph // 8, pw // 8))
        addu(("map", "nfm"), padmap(nfm0, ph // 4, pw // 4).astype(bool))

        # ---- SAO grids ----
        sao_on = plan.sao is not None and (plan.sao_luma or plan.sao_chroma)
        if sao_on:
            ctb = 1 << plan.log2_ctb_size
            restore_any = ((plan.no_filter_map is not None and
                            np.asarray(plan.no_filter_map).any()) or
                           plan.sao_restore is not None)
            grid = (-(-plan.height // ctb), -(-plan.width // ctb))
            for c in range(3):
                shape = (plan.height >> (vs if c else 0),
                         plan.width >> (hs if c else 0))
                tm, bm, em, om = build_sao_grids(plan, c, grid)
                add8(("sao", c, "tm"), tm)
                add8(("sao", c, "bm"), bm)
                add8(("sao", c, "em"), em)
                add8(("sao", c, "om"), om)
                if restore_any:
                    rep_y = 4 >> (vs if c else 0)
                    rep_x = 4 >> (hs if c else 0)
                    mask = np.repeat(np.repeat(np.asarray(
                        plan.no_filter_map if plan.no_filter_map is not None
                        else np.zeros((plan.height // 4, plan.width // 4))),
                        rep_y, 0), rep_x, 1)[:shape[0], :shape[1]] \
                        .astype(bool)
                    if plan.sao_restore is not None:
                        mask = mask | np.asarray(plan.sao_restore[c],
                                                 bool)[:shape[0], :shape[1]]
                    addu(("sao", c, "restore"), mask)

        prof = dict(bd=bd, strong=bool(plan.strong_intra_smoothing),
                    cfmt=cfmt, H=plan.height, W=plan.width,
                    inter_sizes=tuple(inter_sizes),
                    resid_keys=tuple(resid_keys), deblock_on=deblock_on,
                    sao_on=sao_on, beta_off=plan.beta_offset,
                    tc_off=plan.tc_offset, cb_off=plan.cb_qp_offset,
                    cr_off=plan.cr_qp_offset, log2_ctb=plan.log2_ctb_size,
                    ipal=ipal, has_cc=has_cc)
        host = self._write_host(out, lv_specs, soa["resid"], plan.raw_levels)
        prof["layout"] = host.layout
        return (plan, host, prof, list(ref_pocs))

    def _write_host(self, out, lv_specs, resid_rows, raw_levels):
        """The frame's arrays written into one HostPlan: the fields from
        out, and the coefficient levels, one int16 (N, n, n) bucket a
        (plane, size), gathered straight from the front-end's raw levels
        (padding rows zero)."""
        specs = {k: (dt, a.shape) for k, (dt, a) in out.items()}
        for ((c, n), _rows, tgt) in lv_specs:
            specs[("resid", c, n, "levels")] = (np.int16, (tgt, n, n))
        layout, nbytes = upload.plan_layout(specs)
        host = upload.host_plan(layout, nbytes, self._ring)
        for k, (_dt, a) in out.items():
            host[k][...] = a
        if lv_specs:
            sec = host.section(np.dtype(np.int16))
            offs = {key: off for dt, _start, _n, items in layout
                    if dt == np.int16 for key, off, _shape in items}
            bucket_base = np.zeros(12, np.int64)
            for ((c, n), n_rows, _tgt) in lv_specs:
                key = ("resid", c, n, "levels")
                host[key][n_rows:] = 0
                bucket_base[c * 4 + n.bit_length() - 3] = offs[key]
            from ..native import gather_levels_native
            gather_levels_native(resid_rows, raw_levels, bucket_base, sec)
        return host

    def _work_form(self, b, valid, key):
        """Compacted MC work batch: one entry per needed (PU, direction),
        and per-row indices i0/i1 that gather the results back."""
        pf = np.asarray(b["pf"])
        v = valid.astype(bool)
        m0 = ((pf & 1) != 0) & v
        m1 = ((pf & 2) != 0) & v
        n0, n1 = int(m0.sum()), int(m1.sum())
        nw = n0 + n1

        def cat(f0, f1):
            return np.concatenate([np.asarray(b[f0])[m0],
                                   np.asarray(b[f1])[m1]])
        wf = dict(wxs=cat("xs", "xs"), wys=cat("ys", "ys"),
                  wsel=cat("s0", "s1"), wmvx=cat("mvx0", "mvx1"),
                  wmvy=cat("mvy0", "mvy1"))
        tgt = max(nw, self._work_caps.get(key, 8))
        self._work_caps[key] = tgt
        pad = tgt - nw
        if pad:
            for f in wf:
                last = wf[f][-1:] if nw else np.zeros(1, np.int32)
                wf[f] = np.concatenate([wf[f], np.repeat(last, pad, axis=0)])
        i0 = np.zeros(len(pf), np.int32)
        i0[m0] = np.arange(n0)
        i1 = np.zeros(len(pf), np.int32)
        i1[m1] = n0 + np.arange(n1)
        wf["i0"] = i0
        wf["i1"] = i1
        return wf
