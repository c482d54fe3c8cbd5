"""Host front-end: annex-B bytes -> parameter sets -> per-frame FramePlan.

This is the sequential CPU stage of the two-phase decoder (SURVEY.md §7):
NAL demux, PS/slice-header parsing and full CABAC entropy decode happen here;
the returned FramePlan contains only batched tensor work for the back-end.
Mirrors the reference's decode_nal_units / hls_slice_data flow
(libavcodec/hevc.c:3831/3017).
"""

import numpy as np

from ..bitstream import nal as nalmod
from ..bitstream.bits import BitReader
from ..bitstream.nal import split_annexb
from ..cabac import CabacDecoder, ContextSet
from ..ps.params import parse_vps, parse_sps, parse_pps
from .slice import parse_slice_header, I_SLICE, P_SLICE, B_SLICE
from .plan import FramePlan
from ..syntax.ctu import FrameState, code_ctu, expand_qp_map
from ..syntax.io import CabacIO
from .refs import DPB, Frame, construct_rpl, resolve_lt_pocs, get_or_synth
from . import recon_np


class LazySaoDict:
    """Dict-like view over the native per-CTB SAO grid: materializes the
    per-CTB CtbFilterParams objects only when a scalar consumer actually
    iterates/indexes them (the TPU path reads plan.sao_raw instead)."""

    def __init__(self, raw, ctb_width, nctb):
        self._raw = raw
        self._cw = ctb_width
        self._n = nctb
        self._d = None

    def _mat(self):
        if self._d is None:
            from .plan import CtbFilterParams
            d = {}
            for rs in range(self._n):
                row = self._raw[rs]
                d[(rs % self._cw, rs // self._cw)] = CtbFilterParams(
                    sao_type=row[0:3].copy(),
                    sao_band_position=row[3:6].copy(),
                    sao_eo_class=row[6:9].copy(),
                    sao_offsets=row[9:24].reshape(3, 5).copy())
            self._d = d
        return self._d

    def items(self):
        return self._mat().items()

    def __getitem__(self, k):
        return self._mat()[k]

    def get(self, k, default=None):
        return self._mat().get(k, default)

    def __contains__(self, k):
        return k in self._mat()

    def __iter__(self):
        return iter(self._mat())

    def __len__(self):
        return self._n

    def __bool__(self):
        return True


class Frontend:
    """Stateful bitstream front-end; call decode_au() per access unit."""

    def __init__(self, dpb=None, use_native=False, layer_id=0,
                 parse_threads=1):
        self.use_native = use_native
        # host threads for WPP substream entropy decode (hevc.c:2751-2832)
        self.parse_threads = parse_threads
        self.layer_id = layer_id    # decoder-id ≙ nuh_layer_id it decodes
        self.vps_list = {}
        self.sps_list = {}
        self.pps_list = {}
        self.sps = None
        self.pps = None
        self.dpb = dpb
        self.sei_picture_hash = None
        # parsed display-metadata SEIs (reference hevc_sei.c:52-180)
        self.sei_frame_packing = None       # frame_packing_arrangement
        self.sei_picture_struct = None      # pic_timing picture_struct
        self.sei_active_sps_id = 0          # active_parameter_sets
        self._cur = None            # open (partially decoded) picture
        # RASL gating after a broken/initial random access point
        # (reference max_ra, hevc.c:3375-3397); None == INT_MAX
        self.max_ra = None
        self._skip_pic = False
        # SHVC: callable returning the base layer's decoded Frame for the
        # current AU (the il-mailbox analog, pthread_frame.c:516-624)
        self.il_source = None
        # selective encryption (crypto.cpp parity); python walker only
        self.encrypt_params = 0
        self.crypto = None

    def decode_bytes(self, data: bytes):
        """Decode a whole annex-B stream -> list of FramePlan."""
        plans = []
        for nal in split_annexb(data):
            plan = self.decode_nal(nal)
            if plan is not None:
                plans.append(plan)
        plan = self.end_picture()
        if plan is not None:
            plans.append(plan)
        return plans

    def decode_nal(self, nal):
        t = nal.type
        # layer routing (decode_nal_unit, hevc.c:3303): this decoder handles
        # only its own layer's NALs, except VPS/SPS which are global
        if nal.layer_id != self.layer_id and \
                t not in (nalmod.NAL_VPS, nalmod.NAL_SPS):
            return None
        if t == nalmod.NAL_VPS:
            v = parse_vps(nal.rbsp)
            self.vps_list[v.vps_id] = v
        elif t == nalmod.NAL_SPS:
            s = parse_sps(nal.rbsp, layer_id=nal.layer_id,
                          vps_list=self.vps_list)
            self.sps_list[s.sps_id] = s
        elif t == nalmod.NAL_PPS:
            p = parse_pps(nal.rbsp, layer_id=nal.layer_id,
              sps_list=self.sps_list)
            self.pps_list[p.pps_id] = p
        elif t in (nalmod.NAL_SEI_PREFIX, nalmod.NAL_SEI_SUFFIX):
            from .sei import parse_sei
            try:
                for kind, payload in parse_sei(
                        nal.rbsp, t, sps=self.sps, sps_list=self.sps_list,
                        active_sps_id=self.sei_active_sps_id):
                    if kind == "picture_hash":
                        if self._cur is not None:       # suffix SEI
                            self._cur["md5"] = payload
                        else:                           # prefix SEI
                            self.sei_picture_hash = payload
                    elif kind == "frame_packing":
                        # mirrors s->sei_frame_packing_present (hevc_sei.c:58)
                        self.sei_frame_packing = payload
                    elif kind == "pic_timing" and payload is not None:
                        self.sei_picture_struct = \
                            payload["picture_struct"]
                    elif kind == "active_parameter_sets":
                        self.sei_active_sps_id = \
                            payload["active_seq_parameter_set_id"]
            except Exception:
                pass        # non-hash SEIs are display metadata; ignore
        elif t in (nalmod.NAL_AUD, nalmod.NAL_EOS_NUT, nalmod.NAL_EOB_NUT,
                   nalmod.NAL_FD_NUT):
            pass
        elif nalmod.is_vcl(t):
            return self._decode_slice(nal)
        return None

    def _decode_slice(self, nal):
        r = BitReader(nal.rbsp)
        # peek pps id to resolve sps before the full parse
        save = r.pos
        r.u1()
        if nalmod.is_irap(nal.type):
            r.u1()
        pps_id = r.ue()
        r.pos = save
        pps = self.pps_list[pps_id]
        sps = self.sps_list[pps.sps_id]
        if pps.ctb_addr_rs_to_ts is None or self.sps is not sps:
            pps.finalize(sps)
        self.sps, self.pps = sps, pps

        vps = self.vps_list.get(sps.vps_id)
        sh = parse_slice_header(r, nal.type, sps, pps,
                                layer_id=self.layer_id, vps=vps)
        if not sh.first_slice_in_pic:
            if self._skip_pic:
                return None             # non-first slice of a skipped RASL
            return self._continue_slice(nal, r, sps, pps, sh)
        done = self.end_picture()       # emit the previous picture, if any
        poc = self._compute_poc(nal.type, sh, sps, nal.temporal_id)

        # SHVC enhancement layer: fetch the BL picture, inherit its POC, and
        # install the upsampled inter-layer reference in the DPB under the
        # current POC — the slot the decoded EL picture will replace, exactly
        # the reference's IL-ref lifetime (hevc.c:3219-3243, 3471)
        il_pocs = ()
        if self.layer_id > 0 and self.il_source is not None:
            bl = self.il_source()
            if bl is None:
                raise ValueError("BL reference frame does not exist")
            poc = bl.poc
            if sh.inter_layer_pred_enabled and self.dpb is not None:
                from .shvc import make_il_ref
                il = make_il_ref(bl, sps, nalmod.is_irap(nal.type),
                                 nb_list=2 if sh.slice_type == B_SLICE else 1,
                                 el_dpb=self.dpb,
                                 phase_align=vps.ext.phase_align
                                 if vps and vps.ext else 0)
                il.poc = poc
                self.dpb.frames[poc] = il
                il_pocs = (poc,)

        # random-access gating (hevc.c:3375-3397): after a CRA/BLA entry
        # point, RASL pictures reference pre-entry frames and must be skipped
        self._skip_pic = False
        if self.max_ra is None:
            if nal.type in (nalmod.NAL_CRA_NUT, nalmod.NAL_BLA_W_LP,
                            nalmod.NAL_BLA_W_RADL, nalmod.NAL_BLA_N_LP):
                self.max_ra = poc
            elif nalmod.is_idr(nal.type):
                self.max_ra = float("-inf")
        if nal.type in (nalmod.NAL_RASL_N, nalmod.NAL_RASL_R) and \
                self.max_ra is not None and poc <= self.max_ra:
            self._skip_pic = True
            return done
        if nal.type == nalmod.NAL_RASL_R and self.max_ra is not None and \
                poc > self.max_ra:
            self.max_ra = float("-inf")

        plan = FramePlan(poc=poc, width=sps.width, height=sps.height,
                         bit_depth=sps.bit_depth,
                         log2_ctb_size=sps.log2_ctb_size,
                         num_reorder_pics=sps.num_reorder_pics[-1],
                         conf_win=tuple(sps.conf_win),
                         chroma_format_idc=sps.chroma_format_idc,
                         strong_intra_smoothing=bool(sps.strong_intra_smoothing_enabled),
                         intra_smoothing_disabled=bool(
                             sps.intra_smoothing_disabled),
                         sao_luma=bool(sh.sao_luma), sao_chroma=bool(sh.sao_chroma),
                         deblock_disable=bool(sh.deblocking_filter_disabled),
                         beta_offset=sh.beta_offset, tc_offset=sh.tc_offset,
                         # deblock chroma tc ignores slice-level offsets
                         # (chroma_tc, hevc_filter.c:69-73)
                         cb_qp_offset=pps.cb_qp_offset,
                         cr_qp_offset=pps.cr_qp_offset)
        init_type = 0
        if sh.slice_type == P_SLICE:
            init_type = 2 if sh.cabac_init_flag else 1
        elif sh.slice_type == B_SLICE:
            init_type = 1 if sh.cabac_init_flag else 2

        # sticky pcm/bypass map (reference is_pcm is only cleared on SPS
        # (re)activation, never per frame — see FrameState docstring)
        if getattr(self, "_pcm_sps", None) is not sps:
            self._pcm_sticky = np.zeros((sps.height >> 2, sps.width >> 2),
                                        np.uint8)
            self._pcm_sps = sps
        st = FrameState(sps, pps, sh, plan, init_type=init_type,
                        pcm_map=self._pcm_sticky)
        # stale lc->pu intra modes persist across pictures in the
        # reference's single-threaded local context (hevc.c:1472)
        st._pu_stale = getattr(self, '_pu_stale_carry', (0, 0))
        if self.encrypt_params:
            raise NotImplementedError("encrypted streams are not ported")
        if sps.scaling_list_enabled:
            plan.scaling = self._scaling_factors(sps, pps)
        st.level_provider = None
        st.cur_poc = poc
        lt_pocs = resolve_lt_pocs(
            sh, poc, 1 << sps.log2_max_poc_lsb,
            sorted(self.dpb.frames) if self.dpb is not None else ())
        if sh.slice_type != I_SLICE:
            st.rpl, st.rpl_lt = construct_rpl(sh, poc, lt_pocs,
                                              il_pocs=il_pocs)
            plan.rpl = st.rpl
            plan.rpl_lt = st.rpl_lt
            if sh.temporal_mvp_enabled and self.dpb is not None and \
                    st.rpl[sh.collocated_list]:
                st.collocated_frame = get_or_synth(
                    self.dpb,
                    st.rpl[sh.collocated_list][sh.collocated_ref_idx],
                    sps.width, sps.height, sps.bit_depth,
                    sps.chroma_format_idc)
        # RPS-driven DPB unreferencing (hevc_refs.c ff_hevc_frame_rps):
        # frames outside this picture's RPS can never be referenced again
        keep = {poc}
        if sh.slice_rps is not None:
            keep.update(poc + d for d in sh.slice_rps.delta_poc)
        keep.update(p for p, _ in lt_pocs)
        plan.ref_keep = sorted(keep)
        if self.dpb is not None:
            self.dpb.retain(keep)

        # CABAC payload starts at the next byte after the slice header
        assert r.byte_aligned()
        data_start = r.pos >> 3
        payload = nal.rbsp[data_start:]

        self._cur = dict(plan=plan, st=st, sps=sps, pps=pps, sh0=sh,
                         sh_last=sh, init_type=init_type, native_pic=None,
                         ctx_cont=None, md5=self.sei_picture_hash, next_ts=0,
                         il_pocs=il_pocs,
                         segments=[(int(pps.ctb_addr_rs_to_ts[
                             sh.slice_segment_addr]), sh)])
        self.sei_picture_hash = None
        plan.slice_type = sh.slice_type
        self.nal_type = nal.type
        self._decode_slice_ctbs(sh, payload, init_type,
                                data_start, nal.skipped_bytes)
        return done

    def _continue_slice(self, nal, r, sps, pps, sh):
        """Non-first slice segment of the current picture."""
        cur = self._cur
        assert cur is not None, "non-first slice without an open picture"
        if sh.dependent_slice_segment:
            # dependent segment: inherit everything but the segment address
            # from the previous slice header (spec 7.4.7.1); CABAC contexts
            # carry over (reference ff_hevc_cabac_init skips init_state)
            import copy as _copy
            prev = cur["sh_last"]
            full = _copy.copy(prev)
            full.first_slice_in_pic = 0
            full.dependent_slice_segment = 1
            full.slice_segment_addr = sh.slice_segment_addr
            full.slice_addr = prev.slice_addr
            full.num_entry_point_offsets = sh.num_entry_point_offsets
            full.entry_point_offsets = sh.entry_point_offsets
            sh = full
        st = cur["st"]
        assert sps is cur["sps"] and pps is cur["pps"], \
            "parameter sets changed mid-picture"
        # per-slice state reset (reference hls_slice_header side effects)
        st.sh = sh
        st.qp_y = sh.slice_qp
        st.qp_y_pred = sh.slice_qp
        st.first_qp_group = 1
        st.is_cu_qp_delta_coded = 0
        st.cu_qp_delta = 0
        st.cu_qp_offset_cb = 0                   # hevc.c:1091-1092
        st.cu_qp_offset_cr = 0
        if sh.slice_type != I_SLICE:
            poc0 = cur["plan"].poc
            lt_pocs = resolve_lt_pocs(
                sh, poc0, 1 << sps.log2_max_poc_lsb,
                sorted(self.dpb.frames) if self.dpb is not None else ())
            st.rpl, st.rpl_lt = construct_rpl(
                sh, poc0, lt_pocs, il_pocs=cur.get("il_pocs", ()))
            if sh.temporal_mvp_enabled and self.dpb is not None and \
                    st.rpl[sh.collocated_list]:
                st.collocated_frame = get_or_synth(
                    self.dpb,
                    st.rpl[sh.collocated_list][sh.collocated_ref_idx],
                    sps.width, sps.height, sps.bit_depth,
                    sps.chroma_format_idc)
        init_type = 0
        if sh.slice_type == P_SLICE:
            init_type = 2 if sh.cabac_init_flag else 1
        elif sh.slice_type == B_SLICE:
            init_type = 1 if sh.cabac_init_flag else 2
        cur["sh_last"] = sh
        cur["segments"].append(
            (int(pps.ctb_addr_rs_to_ts[sh.slice_segment_addr]), sh))
        assert r.byte_aligned()
        data_start = r.pos >> 3
        payload = nal.rbsp[data_start:]
        self._decode_slice_ctbs(sh, payload, init_type,
                                data_start, nal.skipped_bytes)
        return None

    def _decode_slice_ctbs(self, sh, payload, init_type,
                           data_start=0, skipped=()):
        """Decode one slice segment's CTBs into the open picture."""
        cur = self._cur
        sps, pps, st = cur["sps"], cur["pps"], cur["st"]
        ts0 = int(pps.ctb_addr_rs_to_ts[sh.slice_segment_addr])
        assert ts0 == cur["next_ts"], \
            f"slice starts at ts {ts0}, expected {cur['next_ts']}"
        if self.use_native:
            cur["next_ts"] = self._decode_slice_native(
                sh, sps, pps, init_type, payload, cur,
                data_start, skipped) + 1
            return
        from .substreams import _substream_bounds, _substream_ctx_rules
        nctbs = sps.pic_size_in_ctbs
        if sh.entry_point_offsets:
            bounds = _substream_bounds(sps, pps)
            offsets = nalmod.substream_rbsp_offsets(
                sh.entry_point_offsets, data_start, skipped, len(payload))
            if len(offsets) != len(bounds) + 1:
                # multi-slice picture: this slice carries only its own
                # whole substreams, starting at its slice address
                # (hls_decode_entry_wpp decodes num_entry_points+1 rows)
                bounds = [(max(a, ts0), b) for (a, b) in bounds
                          if b >= ts0][:len(offsets) - 1]
            assert len(offsets) == len(bounds) + 1, "entry point count mismatch"
        else:
            bounds = [(ts0, nctbs - 1)]
            offsets = [0, len(payload)]
        loads, saves = _substream_ctx_rules(sps, pps, bounds)
        # the WPP row snapshot carries across slice segments of a picture
        # (ff_hevc_save_states stores per row, not per slice)
        saved_ctx = cur.get("wpp_saved_ctx")
        prev_ctx = cur["ctx_cont"]
        for si, (b0, b1) in enumerate(bounds):
            if si == 0 and sh.dependent_slice_segment and \
                    cur["ctx_cont"] is not None:
                ctx = cur["ctx_cont"]       # contexts carry over
            else:
                ctx = ContextSet(init_type=init_type, qp=sh.slice_qp)
            if loads[si] and saved_ctx is not None:
                ctx.load(saved_ctx)
                # WPP rows have no cabac_init_state: the persistent-rice
                # stats continue from the previous substream in decode
                # order (single-threaded reference semantics)
                if prev_ctx is not None and ctx is not prev_ctx:
                    ctx.stat_coeff[:] = prev_ctx.stat_coeff
            prev_ctx = ctx
            cur["ctx_cont"] = ctx
            dec = CabacDecoder(payload[offsets[si]:offsets[si + 1]], ctx)
            io = CabacIO(dec=dec)
            for ts in range(b0, b1 + 1):
                rs = int(pps.ctb_addr_ts_to_rs[ts])
                x_ctb = (rs % sps.ctb_width) << sps.log2_ctb_size
                y_ctb = (rs // sps.ctb_width) << sps.log2_ctb_size
                code_ctu(io, st, x_ctb, y_ctb, ts)
                eos = io.terminate()
                if eos:
                    if si != len(bounds) - 1 and ts != b1:
                        raise ValueError(f"premature end_of_slice at {ts}")
                    cur["next_ts"] = ts + 1
                    return
                if saves[si] and ts == b0 + 1:
                    saved_ctx = ctx.save()
                    cur["wpp_saved_ctx"] = saved_ctx
        raise ValueError("missing end_of_slice flag")

    def end_picture(self):
        """Finalize and return the open picture's FramePlan (or None)."""
        cur = self._cur
        if cur is None:
            return None
        self._cur = None
        plan, st, sps = cur["plan"], cur["st"], cur["sps"]
        sh0 = cur["sh0"]
        plan.md5 = cur["md5"]
        self._pu_stale_carry = getattr(st, "_pu_stale", (0, 0))
        if cur["native_pic"] is not None:
            self._finish_native(plan, sps, cur)
            self._apply_slice_filter_maps(plan, cur)
            return plan
        plan.qp_map = expand_qp_map(st, sps)
        plan.vertical_bs = st.vertical_bs
        plan.horizontal_bs = st.horizontal_bs
        any_sao = any(sh.sao_luma or sh.sao_chroma
                      for _, sh in cur["segments"])
        plan.sao = st.sao_ctbs if any_sao else None
        plan.no_filter_map = st.is_pcm_or_bypass.copy()
        plan.mvf_mv = st.mvf_mv
        plan.mvf_poc = st.mvf_poc
        plan.mvf_pred = st.mvf_pred
        plan.mvf_ref_idx = st.mvf_ref_idx
        self._apply_slice_filter_maps(plan, cur)
        return plan

    def _apply_slice_filter_maps(self, plan, cur):
        """Per-slice filter parameters + boundary masking artifacts
        (hevc.c:2677 s->deblock[ctb] fill; sao_filter_CTB edge flags)."""
        segments = cur.get("segments") or ()
        if not segments:
            return
        sps, pps = cur["sps"], cur["pps"]
        from .slicefilters import (build_filter_param_maps,
                                   build_sao_boundary_restore)
        maps = build_filter_param_maps(segments, sps, pps)
        plan.sao_luma = any(sh.sao_luma for _, sh in segments)
        plan.sao_chroma = any(sh.sao_chroma for _, sh in segments)
        plan.deblock_disable = not maps["any_deblock"]
        if not maps["uniform"]:
            plan.deblock_beta_map = maps["beta_map"]
            plan.deblock_tc_map = maps["tc_map"]
        else:
            # canonical scalars: the first ENABLED slice's offsets (slice 0
            # may be deblock-disabled with meaningless offsets)
            plan.beta_offset = maps["beta0"]
            plan.tc_offset = maps["tc0"]
        if plan.sao is not None:
            plan.sao_restore = build_sao_boundary_restore(
                plan, sps, pps, maps["lfase_map"], maps["slice_addr_map"])

    def _scaling_factors(self, sps, pps):
        """Active ScalingFactor matrices (PPS lists override SPS; absent
        explicit data means the spec default lists — hevc_cabac.c:1485)."""
        key = (id(sps), id(pps))
        if getattr(self, "_sf_key", None) != key:
            from ..ps.scaling import ScalingList, build_scaling_factors
            if pps.scaling_list_data_present and pps.scaling_list is not None:
                sl = pps.scaling_list
            elif sps.scaling_list is not None:
                sl = sps.scaling_list
            else:
                sl = ScalingList()
            self._sf = build_scaling_factors(sl)
            self._sf_key = key
        return self._sf

    def _decode_slice_native(self, sh, sps, pps, init_type, payload, cur,
                             data_start=0, skipped=()):
        """One slice segment through the C front-end; returns last CTB ts."""
        from ..native import decode_slice_native, alloc_pic_buffers
        st, plan = cur["st"], cur["plan"]
        collocated = None
        if sh.temporal_mvp_enabled and self.dpb is not None and st.rpl and \
                st.rpl[sh.collocated_list]:
            collocated = get_or_synth(
                self.dpb, st.rpl[sh.collocated_list][sh.collocated_ref_idx],
                sps.width, sps.height, sps.bit_depth, sps.chroma_format_idc)
        if cur["native_pic"] is None:
            cur["native_pic"] = alloc_pic_buffers(sps, pps, sh,
                                                  pcm_map=self._pcm_sticky)
        ts0 = int(pps.ctb_addr_rs_to_ts[sh.slice_segment_addr])
        if not hasattr(self, "_native_rext"):
            import numpy as _np
            self._native_rext = _np.zeros(6, _np.int32)
        out = decode_slice_native(sps, pps, sh, self.nal_type, payload,
                                  plan.poc, st.rpl, collocated, init_type,
                                  ts0, sps.pic_size_in_ctbs - 1,
                                  pic=cur["native_pic"], rpl_lt=st.rpl_lt,
                                  data_start=data_start, skipped=skipped,
                                  rext_state=self._native_rext,
                                  threads=self.parse_threads)
        cur["native_out"] = out
        return out["last_ts"]

    def _finish_native(self, plan, sps, cur):
        from ..native import split_ops, LazyOps
        from .plan import CtbFilterParams
        out = cur["native_out"]
        sh0 = cur["sh0"]
        has_wp = sh0.wp is not None
        # per-op plan objects materialize lazily; the TPU fast path batches
        # straight from the SoA arrays (tpu/plan_soa.py)
        raw_ops = np.ascontiguousarray(out["ops"])
        raw_lv = np.ascontiguousarray(out["levels"])
        plan.soa = split_ops(raw_ops, has_wp=has_wp)
        plan.raw_levels = raw_lv
        plan.ops = LazyOps(raw_ops, raw_lv, sps, has_wp)
        rep = 1 << (sps.log2_min_cb_size - 3)
        qpm = out["qp_y_tab"].astype(np.int32)
        if rep > 1:
            qpm = np.repeat(np.repeat(qpm, rep, 0), rep, 1)
        plan.qp_map = qpm
        plan.vertical_bs = out["vbs"]
        plan.horizontal_bs = out["hbs"]
        plan.no_filter_map = out["pcm_map"].copy()
        plan.mvf_mv = out["mvf_mv"]
        plan.mvf_poc = out["mvf_poc"]
        plan.mvf_pred = out["mvf_pred"]
        plan.mvf_ref_idx = out["mvf_ref_idx"]
        if any(sh.sao_luma or sh.sao_chroma
               for _, sh in (cur.get("segments") or [(0, sh0)])):
            # the TPU path consumes the raw per-CTB grid (tpu/sao.py reads
            # sao_raw); the per-CTB CtbFilterParams dict — ~2000 small
            # numpy copies per 1080p frame — materializes only if a scalar
            # consumer (recon_np / slicefilters) actually iterates it
            plan.sao_raw = np.ascontiguousarray(out["sao"])
            plan.sao = LazySaoDict(plan.sao_raw, sps.ctb_width,
                                   sps.pic_size_in_ctbs)
        else:
            plan.sao = None

    def _compute_poc(self, nal_type, sh, sps, temporal_id=0):
        """POC derivation (spec 8.3.1; reference hevc_refs.c:763)."""
        if nalmod.is_idr(nal_type):
            self.prev_poc = 0
            return 0
        max_lsb = 1 << sps.log2_max_poc_lsb
        prev = getattr(self, "prev_poc", 0)
        prev_lsb = prev & (max_lsb - 1)
        prev_msb = prev - prev_lsb
        lsb = sh.pic_order_cnt_lsb
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        if nal_type in (nalmod.NAL_BLA_W_LP, nalmod.NAL_BLA_W_RADL,
                        nalmod.NAL_BLA_N_LP):
            msb = 0         # BLA resets the POC MSB (hevc_refs.c:778-782)
        poc = msb + lsb
        # prevTid0Pic (hevc.c:793-802): only a temporal_id==0 picture that is
        # neither a RASL/RADL nor a sub-layer non-reference picture updates
        # the predictor
        if temporal_id == 0 and nal_type not in (
                nalmod.NAL_TRAIL_N, nalmod.NAL_TSA_N, nalmod.NAL_STSA_N,
                nalmod.NAL_RADL_N, nalmod.NAL_RADL_R,
                nalmod.NAL_RASL_N, nalmod.NAL_RASL_R):
            self.prev_poc = poc
        return poc


class Decoder:
    """Full decoder: front-end + device back-end + DPB.

    ``backend=None`` (the default) reconstructs on the card through
    ``torch_backend.CudaBackend()``, which raises when no CUDA device is
    present.  ``CudaBackend(device="cpu")`` runs the same frame step with
    the kernels' plain PyTorch versions; ``backend="numpy"`` names the
    host NumPy reconstruction (``recon_np``), the exact reference
    pipeline.
    """

    def __init__(self, backend=None, check_md5=True, use_native=True,
                 encrypt_params=0, prefetch_wire=True):
        if backend is None:
            # imported here: torch_backend imports decoder at load time
            from ..torch_backend import CudaBackend
            backend = CudaBackend()
        elif isinstance(backend, str):
            if backend != "numpy":
                raise ValueError(f"unknown backend {backend!r}")
            backend = None      # _reconstruct: recon_np
        # False = this decoder's pictures are not host-output (e.g. the
        # SHVC base layer, consumed on device by the IL upsample): don't
        # start D2H wire transfers that nobody reads — they compete with
        # the output layer's fetch for the same host link
        self.prefetch_wire = prefetch_wire
        self.dpb = DPB()
        # the C front-end has no keystream support; encrypted streams use
        # the python walker (the reference gates crypto behind a build flag)
        self.fe = Frontend(dpb=self.dpb,
                           use_native=use_native and not encrypt_params)
        self.fe.encrypt_params = encrypt_params
        self.backend = backend
        self.check_md5 = check_md5
        self.md5_ok = 0
        self.md5_fail = 0
        from ..log import DecodeStats
        self.stats = DecodeStats()

    def decode_stream(self, data: bytes):
        """Decode an annex-B stream -> frames in output order (POC order
        within each IDR segment; segments in decode order)."""
        from ..bitstream.nal import split_annexb
        from ..bitstream import nal as nalmod
        from ..log import logger
        self.stats.bytes_in += len(data)
        out = []
        seg = []
        for nal in split_annexb(data):
            if nal.layer_id != self.fe.layer_id and \
                    nal.type not in (nalmod.NAL_VPS, nalmod.NAL_SPS):
                continue        # other layers' NALs (decode_nal's filter)
            if nalmod.is_vcl(nal.type) and (nal.rbsp[0] >> 7):
                # first slice of a new picture: emit the pending one first
                # (its reconstruction may read refs an IDR clear would drop)
                plan = self.fe.end_picture()
                if plan is not None:
                    seg.append(self._emit(plan))
                if nalmod.is_idr(nal.type):
                    # POC resets: drain the previous segment in POC order
                    out.extend(sorted(seg, key=lambda f: f.poc))
                    seg = []
                    self.dpb.clear()
            self.fe.decode_nal(nal)
            self.stats.nals += 1
        plan = self.fe.end_picture()
        if plan is not None:
            seg.append(self._emit(plan))
        out.extend(sorted(seg, key=lambda f: f.poc))
        for f in out:
            # K1's error word: a frame nobody fetched raises here too
            if f.wire is not None:
                f.wire.check()
        return out

    def _emit(self, plan):
        import time as _time
        from ..log import logger
        t0 = _time.monotonic()
        frame = self._reconstruct(plan)
        self.dpb.add(frame)
        if self.check_md5 and plan.md5 is not None:
            self._verify_md5(frame, plan.md5)
        self.stats.frames_decoded += 1
        self.stats.decode_time_s += _time.monotonic() - t0
        logger.debug("decoded poc %d type %d in %.1f ms", plan.poc,
                     plan.slice_type, (_time.monotonic() - t0) * 1e3)
        return frame

    def _verify_md5(self, frame, expected):
        tally_md5(self, frame, expected, self.fe.sps.bit_depth,
                  raise_on_mismatch=True)

    def _reconstruct(self, plan) -> Frame:
        return reconstruct(self.backend, plan, self.dpb, self.prefetch_wire)


def reconstruct(backend, plan, dpb, prefetch_wire) -> Frame:
    """One plan's frame, for the serial and the pipelined decoder: on the
    backend (its output wire's copy to the host started at once where
    prefetch_wire, so it runs behind the frame's device work), or on the
    host through recon_np where backend is None."""
    wire = None
    if backend is not None:
        planes, wire = backend.decode_frame(plan, dpb)
        if prefetch_wire:
            wire.copy_to_host_async()
    else:
        planes = recon_np.execute_plan(plan, dpb=dpb)
        recon_np.deblock_frame(plan, planes)
        planes = recon_np.sao_frame(plan, planes, 1 << plan.log2_ctb_size)
    return Frame(poc=plan.poc, planes=planes, wire=wire,
                 mvf_mv=plan.mvf_mv, mvf_poc=plan.mvf_poc,
                 mvf_pred=plan.mvf_pred, mvf_ref_idx=plan.mvf_ref_idx,
                 rpl=plan.rpl, rpl_lt=plan.rpl_lt, md5=plan.md5,
                 bit_depth=plan.bit_depth, conf_win=plan.conf_win,
                 chroma_format_idc=plan.chroma_format_idc)


def tally_md5(dec, frame, expected, bit_depth, raise_on_mismatch):
    """Each plane's MD5 against the stream's SEI, counted on dec (md5_ok,
    md5_fail and its stats).  The serial decoder raises on a mismatch; the
    pipelined one, like the reference's, only counts."""
    from .sei import plane_md5
    for c, hp in enumerate(frame.host_planes()):    # the narrow wire fetch
        got = plane_md5(np.asarray(hp), bit_depth)
        if got == expected[c]:
            dec.md5_ok += 1
            dec.stats.md5_ok += 1
            continue
        dec.md5_fail += 1
        dec.stats.md5_fail += 1
        if raise_on_mismatch:
            raise AssertionError(
                f"MD5 mismatch poc {frame.poc} plane {c}: "
                f"{got.hex()} != {expected[c].hex()}")
