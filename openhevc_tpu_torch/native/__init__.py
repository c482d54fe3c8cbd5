"""Native (C++) slice-data front-end: build + ctypes bindings.

Replaces the Python CABAC/CTU walk with frontend.cc (same semantics, ~100x
faster); the tests diff both paths op-by-op.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libhevcfe.so")
_CC = os.path.join(_DIR, "frontend.cc")
_TABLES = os.path.join(_DIR, "tables.h")
_STAMP = os.path.join(_DIR, ".build_stamp")

_lib = None

_PARAM_FIELDS = [
    "width", "height", "bit_depth", "chroma_format_idc",
    "log2_ctb", "log2_min_cb", "log2_min_tb", "log2_max_tb",
    "max_tt_depth_intra", "max_tt_depth_inter",
    "amp_enabled", "sao_enabled_sps", "strong_intra_smoothing", "pcm_enabled",
    "pcm_log2_min", "pcm_log2_max", "pcm_bit_depth", "pcm_bit_depth_chroma",
    "pcm_loop_filter_disabled", "scaling_list_enabled",
    "qp_bd_offset",
    "sign_data_hiding", "cabac_init_present", "cu_qp_delta_enabled",
    "diff_cu_qp_delta_depth",
    "cb_qp_offset", "cr_qp_offset", "transquant_bypass_enabled",
    "transform_skip_enabled",
    "tiles_enabled", "entropy_coding_sync", "loop_filter_across_tiles",
    "log2_parallel_merge_level",
    "slice_type", "slice_qp", "sao_luma", "sao_chroma",
    "num_ref_idx0", "num_ref_idx1", "max_num_merge_cand", "mvd_l1_zero",
    "collocated_list", "collocated_ref_idx", "sh_tmvp_enabled",
    "loop_filter_across_slices", "deblocking_disabled",
    "slice_addr", "cur_poc", "init_type",
    "ctb_width", "ctb_height", "mtb_w", "mtb_h",
    "has_collocated", "col_poc", "first_ctb_ts", "last_ctb_ts",
    "init_state", "slice_start", "stop_at_eos", "ctx_load", "wpp_save_ctx",
    "save_ctx_end",
    "has_wp", "wp_denom_y", "wp_denom_c",
    "implicit_rdpcm", "explicit_rdpcm", "persistent_rice", "ts_context",
    "ts_rotation", "cross_component",
    "cu_chroma_qp_offset_enabled", "diff_cu_chroma_qp_offset_depth",
    "chroma_qp_offset_list_len", "lv_base",
]


class SliceParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_int32) for f in _PARAM_FIELDS] + \
        [("wp_w", ctypes.c_int32 * 3 * 16 * 2),
         ("wp_o", ctypes.c_int32 * 3 * 16 * 2),
         ("rpl_lt", ctypes.c_int32 * 16 * 2),
         ("col_lt", ctypes.c_int32 * 16 * 2),
         ("cb_qp_offset_list", ctypes.c_int32 * 6),
         ("cr_qp_offset_list", ctypes.c_int32 * 6)]


def _source_hash():
    h = hashlib.sha256()
    for path in (_CC, _TABLES):
        if os.path.exists(path):
            h.update(open(path, "rb").read())
    return h.hexdigest()


def _build_flags():
    """Compiler flags: -O3 -march=native -funroll-loops (A/B'd on the
    bench streams: unroll is +4-8%).  PGO support stays wired for
    tools/pgo_train.py experiments, but no profile ships: measured
    CONSISTENTLY SLOWER (~10%) — the CABAC hot loops are branchless by
    design and PGO's block reordering degrades them."""
    flags = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
             "-std=c++17", "-pthread"]
    pgo_dir = os.path.join(_DIR, "pgo")
    has_gcda = os.path.isdir(pgo_dir) and any(
        f.endswith(".gcda")
        for _r, _d, files in os.walk(pgo_dir) for f in files)
    if has_gcda:
        flags += [f"-fprofile-use={pgo_dir}", "-fprofile-correction",
                  "-Wno-missing-profile", "-Wno-coverage-mismatch"]
    extra = os.environ.get("OPENHEVC_CFLAGS")
    if extra:
        flags += extra.split()
    return flags


def build_lib(force=False):
    """Compile the native front-end (cached by source hash + flags)."""
    if not os.path.exists(_TABLES):
        from .gen_tables import generate
        generate(_TABLES)
    flags = _build_flags()
    want = _source_hash() + " " + " ".join(flags)
    have = open(_STAMP).read().strip() if os.path.exists(_STAMP) else ""
    if force or not os.path.exists(_SO) or have != want:
        # build to a private name and rename: concurrent builders (test
        # workers) never load a half-written library
        tmp = f"{_SO}.tmp{os.getpid()}"
        subprocess.run(["g++"] + flags + [_CC, "-o", tmp], check=True)
        os.replace(tmp, _SO)
        with open(_STAMP, "w") as f:
            f.write(want)
    return _SO


def get_lib():
    global _lib
    if _lib is None:
        so = os.environ.get("OPENHEVC_NATIVE_SO") or build_lib()
        _lib = ctypes.CDLL(so)
        _lib.decode_slice_data.restype = ctypes.c_int64
    return _lib


def _ptr(a, dtype):
    if a is None:
        return None
    a = np.ascontiguousarray(a, dtype)
    return a, a.ctypes.data_as(ctypes.c_void_p)


def alloc_pic_buffers(sps, pps, sh, pcm_map=None):
    """Per-picture output buffers, shared across the picture's slices."""
    W, H = sps.width, sps.height
    w4, h4 = W >> 2, H >> 2
    w8, h8 = W >> 3, H >> 3
    mcw, mch = sps.min_cb_width, sps.min_cb_height
    mth = sps.min_tb_height
    nctb = sps.pic_size_in_ctbs
    ops_cap = 64 * 1024 * 64
    lv_cap = 64 * 1024 * 256
    return dict(
        ops=np.zeros(ops_cap, np.int32), ops_cap=ops_cap, ops_total=0,
        levels=np.zeros(lv_cap, np.int32), lv_cap=lv_cap, lv_total=0,
        mvf_mv=np.zeros((h4, w4, 2, 2), np.int32),
        mvf_poc=np.zeros((h4, w4, 2), np.int32),
        mvf_pred=np.zeros((h4, w4), np.uint8),
        mvf_ref_idx=np.zeros((h4, w4, 2), np.int8),
        vbs=np.zeros((h4, w8), np.uint8),
        hbs=np.zeros((h8, w4), np.uint8),
        qp_y_tab=np.full((mch, mcw), sh.slice_qp, np.int8),
        pcm_map=(pcm_map if pcm_map is not None
                 else np.zeros((h4, w4), np.uint8)),
        sao_out=np.zeros((nctb, 24), np.int32),
        cbf_luma=np.zeros((mth, pps.min_tb_addr_zs.shape[1]), np.uint8),
        scratch=np.zeros(mcw * mch * 2 + w4 * h4 + nctb * 4 + 64, np.uint8),
        ctx_io=np.zeros(2 * 256, np.uint8), first_slice=True, last_ts=-1)


def _dump_slice_call(dump_dir, p, seg, *arrays):
    """Serialize one decode_slice_data call for the C profiling harness
    (tools/fe_profile.cc).  Format: [i64 params_size][params bytes] then for
    each array [i64 nbytes][bytes]; scalars ride as 8-byte ints."""
    os.makedirs(dump_dir, exist_ok=True)
    idx = len([f for f in os.listdir(dump_dir) if f.endswith(".slice")])
    import struct
    with open(os.path.join(dump_dir, f"{idx:04d}.slice"), "wb") as f:
        pb = ctypes.string_at(ctypes.byref(p), ctypes.sizeof(p))
        f.write(struct.pack("<q", len(pb)))
        f.write(pb)
        f.write(struct.pack("<q", len(seg)))
        f.write(seg)
        for a in arrays:
            if isinstance(a, (int, np.integer)):
                f.write(struct.pack("<q", -8))
                f.write(struct.pack("<q", int(a)))
            else:
                b = np.ascontiguousarray(a).tobytes()
                f.write(struct.pack("<q", len(b)))
                f.write(b)


def decode_slice_native(sps, pps, sh, nal_type, payload: bytes, cur_poc,
                        rpl, collocated, init_type, first_ts, last_ts,
                        pcm_map=None, pic=None, stop_at_eos=False,
                        rpl_lt=None, data_start=0, skipped=(),
                        rext_state=None, threads=1):
    """Run the native CTU walk; returns raw output arrays.

    -> dict with ops, levels, mvf_*, vbs, hbs, qp_y_tab, pcm_map, sao, err,
    last_ts.  Pass `pic` (from alloc_pic_buffers) to accumulate several
    slices of one picture; `stop_at_eos` decodes until the end_of_slice flag
    instead of a fixed CTB range (multi-slice pictures).
    """
    lib = get_lib()
    if rext_state is None:
        rext_state = np.zeros(6, np.int32)
    p = SliceParams()
    p.width, p.height = sps.width, sps.height
    p.bit_depth = sps.bit_depth
    p.chroma_format_idc = sps.chroma_format_idc
    p.log2_ctb = sps.log2_ctb_size
    p.log2_min_cb = sps.log2_min_cb_size
    p.log2_min_tb = sps.log2_min_tb_size
    p.log2_max_tb = sps.log2_max_tb_size
    p.max_tt_depth_intra = sps.max_transform_hierarchy_depth_intra
    p.max_tt_depth_inter = sps.max_transform_hierarchy_depth_inter
    p.amp_enabled = sps.amp_enabled
    p.sao_enabled_sps = sps.sao_enabled
    p.strong_intra_smoothing = sps.strong_intra_smoothing_enabled
    p.implicit_rdpcm = sps.implicit_rdpcm_enabled
    p.explicit_rdpcm = sps.explicit_rdpcm_enabled
    p.persistent_rice = sps.persistent_rice_adaptation_enabled
    p.ts_context = sps.transform_skip_context_enabled
    p.ts_rotation = sps.transform_skip_rotation_enabled
    p.pcm_enabled = sps.pcm_enabled
    p.pcm_log2_min = sps.pcm_log2_min_size
    p.pcm_log2_max = sps.pcm_log2_max_size
    p.pcm_bit_depth = sps.pcm_bit_depth
    p.pcm_bit_depth_chroma = sps.pcm_bit_depth_chroma
    p.pcm_loop_filter_disabled = sps.pcm_loop_filter_disabled
    p.scaling_list_enabled = sps.scaling_list_enabled
    p.qp_bd_offset = sps.qp_bd_offset
    p.sign_data_hiding = pps.sign_data_hiding
    p.cabac_init_present = pps.cabac_init_present
    p.cu_qp_delta_enabled = pps.cu_qp_delta_enabled
    p.diff_cu_qp_delta_depth = pps.diff_cu_qp_delta_depth
    p.cb_qp_offset = pps.cb_qp_offset + sh.slice_cb_qp_offset
    p.cr_qp_offset = pps.cr_qp_offset + sh.slice_cr_qp_offset
    if pps.chroma_qp_offset_list_enabled and sh.cu_chroma_qp_offset_enabled:
        p.cu_chroma_qp_offset_enabled = 1
        p.diff_cu_chroma_qp_offset_depth = pps.diff_cu_chroma_qp_offset_depth
        p.chroma_qp_offset_list_len = len(pps.cb_qp_offset_list)
        for i, (cb, cr) in enumerate(zip(pps.cb_qp_offset_list[:6],
                                         pps.cr_qp_offset_list[:6])):
            p.cb_qp_offset_list[i] = cb
            p.cr_qp_offset_list[i] = cr
    p.transquant_bypass_enabled = pps.transquant_bypass_enabled
    p.transform_skip_enabled = pps.transform_skip_enabled
    p.cross_component = pps.cross_component_prediction_enabled
    p.tiles_enabled = pps.tiles_enabled
    p.entropy_coding_sync = pps.entropy_coding_sync_enabled
    p.loop_filter_across_tiles = pps.loop_filter_across_tiles_enabled
    p.log2_parallel_merge_level = pps.log2_parallel_merge_level
    p.slice_type = sh.slice_type
    p.slice_qp = sh.slice_qp
    p.sao_luma = sh.sao_luma
    p.sao_chroma = sh.sao_chroma
    p.num_ref_idx0 = sh.num_ref_idx[0]
    p.num_ref_idx1 = sh.num_ref_idx[1]
    p.max_num_merge_cand = sh.max_num_merge_cand
    p.mvd_l1_zero = sh.mvd_l1_zero
    p.collocated_list = sh.collocated_list
    p.collocated_ref_idx = sh.collocated_ref_idx
    p.sh_tmvp_enabled = sh.temporal_mvp_enabled
    p.loop_filter_across_slices = sh.loop_filter_across_slices
    p.deblocking_disabled = sh.deblocking_filter_disabled
    p.slice_addr = sh.slice_addr
    p.cur_poc = cur_poc
    p.init_type = init_type
    p.ctb_width, p.ctb_height = sps.ctb_width, sps.ctb_height
    if sh.wp is not None:
        p.has_wp = 1
        p.wp_denom_y = sh.wp.luma_log2_denom
        p.wp_denom_c = sh.wp.chroma_log2_denom
        for lst in range(2):
            for i in range(len(sh.wp.luma_weight[lst])):
                p.wp_w[lst][i][0] = sh.wp.luma_weight[lst][i]
                p.wp_o[lst][i][0] = sh.wp.luma_offset[lst][i]
                p.wp_w[lst][i][1] = sh.wp.chroma_weight[lst][i][0]
                p.wp_o[lst][i][1] = sh.wp.chroma_offset[lst][i][0]
                p.wp_w[lst][i][2] = sh.wp.chroma_weight[lst][i][1]
                p.wp_o[lst][i][2] = sh.wp.chroma_offset[lst][i][1]
    zs = pps.min_tb_addr_zs
    p.mtb_h, p.mtb_w = zs.shape

    nctb = sps.pic_size_in_ctbs
    if pic is None:
        pic = alloc_pic_buffers(sps, pps, sh, pcm_map=pcm_map)
    ops, levels = pic["ops"], pic["levels"]
    ops_cap, lv_cap = pic["ops_cap"], pic["lv_cap"]
    mvf_mv, mvf_poc = pic["mvf_mv"], pic["mvf_poc"]
    mvf_pred, mvf_ref_idx = pic["mvf_pred"], pic["mvf_ref_idx"]
    vbs, hbs, qp_y_tab = pic["vbs"], pic["hbs"], pic["qp_y_tab"]
    pcm_map, sao_out = pic["pcm_map"], pic["sao_out"]
    cbf_luma, scratch = pic["cbf_luma"], pic["scratch"]
    out_sizes = np.zeros(4, np.int64)

    rpl0 = np.zeros(16, np.int32)
    rpl1 = np.zeros(16, np.int32)
    if rpl:
        rpl0[:len(rpl[0])] = rpl[0]
        rpl1[:len(rpl[1])] = rpl[1]
    if rpl_lt:
        for lst in range(2):
            for i, f in enumerate(rpl_lt[lst][:16]):
                p.rpl_lt[lst][i] = 1 if f else 0

    if collocated is not None:
        p.has_collocated = 1
        p.col_poc = collocated.poc
        if getattr(collocated, "rpl_lt", None):
            for lst in range(2):
                for i, f in enumerate(collocated.rpl_lt[lst][:16]):
                    p.col_lt[lst][i] = 1 if f else 0
        col_mv = np.ascontiguousarray(collocated.mvf_mv, np.int32)
        col_poc_a = np.ascontiguousarray(collocated.mvf_poc, np.int32)
        col_pred = np.ascontiguousarray(collocated.mvf_pred, np.uint8)
        col_ri = np.ascontiguousarray(collocated.mvf_ref_idx, np.int8)
        col_rpl0 = np.zeros(16, np.int32)
        col_rpl1 = np.zeros(16, np.int32)
        if collocated.rpl:
            col_rpl0[:len(collocated.rpl[0])] = collocated.rpl[0]
            col_rpl1[:len(collocated.rpl[1])] = collocated.rpl[1]
    else:
        col_mv = np.zeros(1, np.int32)
        col_poc_a = np.zeros(1, np.int32)
        col_pred = np.zeros(1, np.uint8)
        col_ri = np.zeros(1, np.int8)
        col_rpl0 = np.zeros(16, np.int32)
        col_rpl1 = np.zeros(16, np.int32)

    p.first_ctb_ts = first_ts
    p.last_ctb_ts = last_ts

    def cp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rs2ts = np.ascontiguousarray(pps.ctb_addr_rs_to_ts, np.int32)
    ts2rs = np.ascontiguousarray(pps.ctb_addr_ts_to_rs, np.int32)
    tid = np.ascontiguousarray(pps.tile_id, np.int32)
    zsc = np.ascontiguousarray(zs, np.int32)
    ctx_io = pic["ctx_io"]

    # substream layout (WPP rows / tiles / single / open-ended slice)
    if not sh.entry_point_offsets:
        # open-ended: decode until the end_of_slice flag (single- and
        # multi-slice pictures alike)
        bounds = [(first_ts, nctb - 1)]
        offsets = [0, len(payload)]
        p.stop_at_eos = 1
    else:
        from ..decoder.substreams import _substream_bounds, _substream_ctx_rules
        from ..bitstream.nal import substream_rbsp_offsets
        bounds = _substream_bounds(sps, pps)
        offsets = substream_rbsp_offsets(
            sh.entry_point_offsets, data_start, skipped, len(payload))
        if len(offsets) != len(bounds) + 1:
            # multi-slice picture: this slice carries only its own whole
            # substreams from its start address (hls_decode_entry_wpp
            # decodes num_entry_point_offsets+1 rows per slice)
            bounds = [(max(a, first_ts), b) for (a, b) in bounds
                      if b >= first_ts][:len(offsets) - 1]
        assert len(offsets) == len(bounds) + 1, "entry point mismatch"
        p.stop_at_eos = 0

    first_slice = pic["first_slice"]
    pic["first_slice"] = False
    ops_total = pic["ops_total"]
    lv_total = pic["lv_total"]
    if sh.entry_point_offsets:
        from ..decoder.substreams import _substream_ctx_rules
        loads, saves = _substream_ctx_rules(sps, pps, bounds)
    else:
        loads = saves = [False]

    # host-parallel WPP decode (reference analog hevc.c:2751-2832): pure
    # WPP rows of a fresh picture, no substream-chained state (persistent
    # rice stats / RDPCM stale-mode reads)
    # ctb_width > 1: 1-CTB-wide rows load the previous row's snapshot,
    # but the snapshot is saved at a row's 2nd CTB and so never exists
    # (the w>1 rule in _substream_ctx_rules / hevc_cabac.c save_states);
    # those pictures take the serial loop, which re-inits per row
    if (threads > 1 and len(bounds) > 1 and not p.stop_at_eos and
            pps.entropy_coding_sync_enabled and not pps.tiles_enabled and
            sps.ctb_width > 1 and
            first_slice and not sps.persistent_rice_adaptation_enabled and
            not sps.explicit_rdpcm_enabled and
            not sps.implicit_rdpcm_enabled and
            not os.environ.get("OPENHEVC_DUMP_SLICE")):
        lib = get_lib()
        if not hasattr(lib, "_wpp_ready"):
            lib.decode_substreams_wpp.restype = ctypes.c_int64
            lib._wpp_ready = True
        p.init_state = 1
        p.slice_start = 1
        sub_off = np.asarray(offsets, np.int64)
        sub_ts = np.asarray(bounds, np.int32).reshape(-1)
        # the parallel attempt partially writes the per-picture maps on
        # failure; keep the sticky pcm map's pre-attempt state for the
        # serial redo (the other buffers re-allocate fresh)
        pcm_saved = pcm_map.copy()
        err = lib.decode_substreams_wpp(
            ctypes.byref(p), payload, cp(sub_off), cp(sub_ts),
            ctypes.c_int32(len(bounds)), ctypes.c_int32(threads),
            cp(rs2ts), cp(ts2rs), cp(tid), cp(zsc), cp(rpl0), cp(rpl1),
            cp(col_mv), cp(col_poc_a), cp(col_pred), cp(col_ri),
            cp(col_rpl0), cp(col_rpl1),
            cp(ops), ctypes.c_int64(ops_cap),
            cp(levels), ctypes.c_int64(lv_cap),
            cp(mvf_mv), cp(mvf_poc), cp(mvf_pred), cp(mvf_ref_idx),
            cp(vbs), cp(hbs), cp(qp_y_tab), cp(pcm_map), cp(sao_out),
            cp(cbf_luma), cp(scratch), cp(out_sizes))
        if err == 0:
            pic["ops_total"] = int(out_sizes[0])
            pic["lv_total"] = int(out_sizes[1])
            pic["last_ts"] = int(out_sizes[3])
            return dict(ops=ops[:pic["ops_total"]],
                        levels=levels[:pic["lv_total"]],
                        mvf_mv=mvf_mv, mvf_poc=mvf_poc, mvf_pred=mvf_pred,
                        mvf_ref_idx=mvf_ref_idx, vbs=vbs, hbs=hbs,
                        qp_y_tab=qp_y_tab, pcm_map=pcm_map, sao=sao_out,
                        last_ts=pic["last_ts"])
        # a disproportionately dense row can overflow its equal per-row
        # ops/levels carve (err 5) even when the global caps would fit the
        # slice: redo serially into fresh buffers (the serial loop checks
        # only the global totals, matching the reference's behavior)
        from ..log import logger
        logger.warning("parallel WPP decode failed (err %d); "
                       "falling back to serial substream decode", int(err))
        # the sticky pcm map is caller-owned (frontend._pcm_sticky carries
        # across pictures): restore it in place, keep the same array
        pcm_map[:] = pcm_saved
        fresh = alloc_pic_buffers(sps, pps, sh, pcm_map=pcm_map)
        for k in ("ops", "levels", "mvf_mv", "mvf_poc", "mvf_pred",
                  "mvf_ref_idx", "vbs", "hbs", "qp_y_tab", "pcm_map",
                  "sao_out", "cbf_luma", "scratch", "ctx_io"):
            pic[k] = fresh[k]
        ops, levels = pic["ops"], pic["levels"]
        mvf_mv, mvf_poc = pic["mvf_mv"], pic["mvf_poc"]
        mvf_pred, mvf_ref_idx = pic["mvf_pred"], pic["mvf_ref_idx"]
        vbs, hbs, qp_y_tab = pic["vbs"], pic["hbs"], pic["qp_y_tab"]
        pcm_map, sao_out = pic["pcm_map"], pic["sao_out"]
        cbf_luma, scratch = pic["cbf_luma"], pic["scratch"]
        ctx_io = pic["ctx_io"]
    save_ctx_end = 1 if (pps.dependent_slice_segments_enabled and
                         not pps.entropy_coding_sync_enabled) else 0
    if not os.environ.get("OPENHEVC_DUMP_SLICE"):
        # fused serial decode: all of this slice's substreams in ONE C
        # call (ctypes marshals the ~28 pointer args once per slice, not
        # once per WPP row/tile — ~5 ms/frame at 1080p WPP, and a third
        # of the whole parse cost at 480p)
        lib = get_lib()
        if not hasattr(lib, "_serial_ready"):
            lib.decode_substreams_serial.restype = ctypes.c_int64
            lib._serial_ready = True
        p.lv_base = lv_total
        p.init_state = 1 if first_slice else 0
        p.slice_start = 1
        p.save_ctx_end = save_ctx_end
        flags = np.zeros(2 * len(bounds), np.uint8)
        for si in range(len(bounds)):
            flags[2 * si] = 1 if (loads[si] or (
                si == 0 and sh.dependent_slice_segment)) else 0
            flags[2 * si + 1] = 1 if saves[si] else 0
        sub_off = np.asarray(offsets, np.int64)
        sub_ts = np.asarray(bounds, np.int32).reshape(-1)
        err = lib.decode_substreams_serial(
            ctypes.byref(p), payload, cp(sub_off), cp(sub_ts), cp(flags),
            ctypes.c_int32(len(bounds)),
            cp(rs2ts), cp(ts2rs), cp(tid), cp(zsc), cp(rpl0), cp(rpl1),
            cp(col_mv), cp(col_poc_a), cp(col_pred), cp(col_ri),
            cp(col_rpl0), cp(col_rpl1),
            cp(ops[ops_total:]), ctypes.c_int64(ops_cap - ops_total),
            cp(levels[lv_total:]), ctypes.c_int64(lv_cap - lv_total),
            cp(mvf_mv), cp(mvf_poc), cp(mvf_pred), cp(mvf_ref_idx),
            cp(vbs), cp(hbs), cp(qp_y_tab), cp(pcm_map), cp(sao_out),
            cp(cbf_luma), cp(scratch), cp(ctx_io), cp(rext_state),
            cp(out_sizes))
        if out_sizes[2] != 0 or ops_total + out_sizes[0] > ops_cap or \
                lv_total + out_sizes[1] > lv_cap:
            raise RuntimeError(f"native front-end error {out_sizes[2]}")
        pic["ops_total"] = ops_total + int(out_sizes[0])
        pic["lv_total"] = lv_total + int(out_sizes[1])
        pic["last_ts"] = int(out_sizes[3])
        return dict(ops=ops[:pic["ops_total"]], levels=levels[:pic["lv_total"]],
                    mvf_mv=mvf_mv, mvf_poc=mvf_poc, mvf_pred=mvf_pred,
                    mvf_ref_idx=mvf_ref_idx, vbs=vbs, hbs=hbs,
                    qp_y_tab=qp_y_tab, pcm_map=pcm_map, sao=sao_out,
                    last_ts=pic["last_ts"])
    for si, (ts0, ts1) in enumerate(bounds):
        p.first_ctb_ts, p.last_ctb_ts = ts0, ts1
        p.lv_base = lv_total        # emitted level offsets come out absolute
        p.init_state = 1 if (si == 0 and first_slice) else 0
        p.slice_start = 1 if si == 0 else 0
        p.ctx_load = 1 if (loads[si] or
                           (si == 0 and sh.dependent_slice_segment)) else 0
        p.wpp_save_ctx = 1 if saves[si] else 0
        p.save_ctx_end = save_ctx_end
        seg = payload[offsets[si]:offsets[si + 1]]
        dump_dir = os.environ.get("OPENHEVC_DUMP_SLICE")
        if dump_dir:
            _dump_slice_call(dump_dir, p, seg, rs2ts, ts2rs, tid, zsc,
                             rpl0, rpl1, col_mv, col_poc_a, col_pred, col_ri,
                             col_rpl0, col_rpl1, ops_cap - ops_total,
                             lv_cap - lv_total, mvf_mv, mvf_poc, mvf_pred,
                             mvf_ref_idx, vbs, hbs, qp_y_tab, pcm_map,
                             sao_out, cbf_luma, scratch, ctx_io, rext_state)
        err = get_lib().decode_slice_data(
            ctypes.byref(p), seg, ctypes.c_int64(len(seg)),
            cp(rs2ts), cp(ts2rs), cp(tid), cp(zsc), cp(rpl0), cp(rpl1),
            cp(col_mv), cp(col_poc_a), cp(col_pred), cp(col_ri),
            cp(col_rpl0), cp(col_rpl1),
            cp(ops[ops_total:]), ctypes.c_int64(ops_cap - ops_total),
            cp(levels[lv_total:]), ctypes.c_int64(lv_cap - lv_total),
            cp(mvf_mv), cp(mvf_poc), cp(mvf_pred), cp(mvf_ref_idx),
            cp(vbs), cp(hbs), cp(qp_y_tab), cp(pcm_map), cp(sao_out),
            cp(cbf_luma), cp(scratch), cp(ctx_io), cp(rext_state),
            cp(out_sizes))
        if out_sizes[2] != 0 or ops_total + out_sizes[0] > ops_cap or \
                lv_total + out_sizes[1] > lv_cap:
            raise RuntimeError(f"native front-end error {out_sizes[2]}")
        ops_total += out_sizes[0]
        lv_total += out_sizes[1]
        pic["last_ts"] = int(out_sizes[3])
    pic["ops_total"] = ops_total
    pic["lv_total"] = lv_total
    return dict(ops=ops[:ops_total], levels=levels[:lv_total],
                mvf_mv=mvf_mv, mvf_poc=mvf_poc, mvf_pred=mvf_pred,
                mvf_ref_idx=mvf_ref_idx, vbs=vbs, hbs=hbs,
                qp_y_tab=qp_y_tab, pcm_map=pcm_map, sao=sao_out,
                last_ts=pic["last_ts"])


def gather_levels_native(resid_rows, raw_levels, bucket_base, lv16):
    """One C pass over the resid SoA rows: each TU's coefficient levels,
    clipped to int16, written straight into its (plane, size) bucket of
    `lv16` (int16, bucket regions at ELEMENT offsets `bucket_base`)."""
    lib = get_lib()

    def cp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    resid_rows = np.ascontiguousarray(resid_rows, np.int32)
    raw = np.ascontiguousarray(raw_levels, np.int32)
    bb = np.ascontiguousarray(bucket_base, np.int64)
    if lv16.dtype != np.int16 or not lv16.flags.c_contiguous:
        raise ValueError("gather_levels: contiguous int16 buffer expected")
    lib.gather_levels(cp(resid_rows), ctypes.c_int64(len(resid_rows)),
                      cp(raw), cp(bb), cp(lv16))


def unpack_d5_native(wire, shapes, caps):
    """C inverse of the "d5" delta output wire (frontend.cc unpack_d5):
    -> list of uint8 planes, or None on escape-cap overflow (the caller
    falls back to a raw plane fetch).  One fused pass per row replaces
    the numpy unpack+scatter+cumsum chain (~6x on this 1-core image)."""
    lib = get_lib()
    if not hasattr(lib, "_d5_ready"):
        lib.unpack_d5.restype = ctypes.c_int
        lib._d5_ready = True
    wire = np.ascontiguousarray(wire, np.uint8)
    hw = np.asarray([d for s in shapes for d in s], np.int64)
    cp2 = np.asarray([d for c in caps for d in c], np.int64)
    total = int(sum(h * w for h, w in shapes))
    out = np.empty(total, np.uint8)
    scratch = np.empty(max(h * w for h, w in shapes), np.int16)
    r = lib.unpack_d5(wire.ctypes.data_as(ctypes.c_void_p),
                      hw.ctypes.data_as(ctypes.c_void_p),
                      cp2.ctypes.data_as(ctypes.c_void_p),
                      ctypes.c_int(len(shapes)),
                      out.ctypes.data_as(ctypes.c_void_p),
                      scratch.ctypes.data_as(ctypes.c_void_p))
    if r:
        return None
    planes = []
    off = 0
    for h, w in shapes:
        planes.append(out[off:off + h * w].reshape(h, w))
        off += h * w
    return planes


def unpack_px_native(wire, n, bits):
    """C inverse of the bit-packed 10/12-bit output wire for one plane
    (frontend.cc unpack_px) -> flat uint16 array of n samples."""
    lib = get_lib()
    if not hasattr(lib, "_px_ready"):
        lib.unpack_px.restype = None
        lib._px_ready = True
    wire = np.ascontiguousarray(wire, np.uint8)
    out = np.empty(int(n), np.uint16)
    lib.unpack_px(wire.ctypes.data_as(ctypes.c_void_p),
                  ctypes.c_int64(int(n)), ctypes.c_int(int(bits)),
                  out.ctypes.data_as(ctypes.c_void_p))
    return out


def split_ops(raw_ops, has_wp=False):
    """One C pass over the tagged op stream -> per-type SoA row arrays.

    Returns dict(intra=(ni,10) [c,x,y,size,mode,f0..f4],
                 resid=(nr,8)  [c,x,y,log2n,qp,kind,off,rext],
                 inter=(nm,25) [x,y,w,h,pf,s0,mvx0,mvy0,s1,mvx1,mvy1,
                                dy,dc,w0(6),w1(6)] (identity weights filled
                                when the slice has no WP),
                 pcm=(np,5)    [c,x,y,size,off]).
    """
    lib = get_lib()
    if not hasattr(lib, "_split_ready"):
        lib.split_ops.restype = ctypes.c_int64
        lib._split_ready = True
    n = len(raw_ops)
    intra = np.empty((n // 11 + 1, 10), np.int32)
    resid = np.empty((n // 9 + 1, 8), np.int32)
    inter = np.empty((n // 12 + 1, 25), np.int32)
    pcm = np.empty((n // 6 + 1, 5), np.int32)
    counts = np.zeros(4, np.int64)
    raw = np.ascontiguousarray(raw_ops, np.int32)

    def cp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.split_ops(cp(raw), ctypes.c_int64(n),
                       ctypes.c_int32(1 if has_wp else 0),
                       cp(intra), cp(resid), cp(inter), cp(pcm), cp(counts))
    if rc != 0:
        raise ValueError("bad op tag in native op stream")
    return dict(intra=intra[:counts[0]], resid=resid[:counts[1]],
                inter=inter[:counts[2]], pcm=pcm[:counts[3]])


class LazyOps:
    """List-like view over the native op stream; materializes per-op plan
    objects only when something actually iterates/indexes it (the TPU fast
    path reads the SoA arrays instead)."""

    def __init__(self, raw_ops, raw_levels, sps, has_wp):
        self._args = (raw_ops, raw_levels, sps, has_wp)
        self._ops = None

    def _mat(self):
        if self._ops is None:
            self._ops = ops_to_plan_ops(*self._args)
            self._args = None
        return self._ops

    def __iter__(self):
        return iter(self._mat())

    def __len__(self):
        return len(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __bool__(self):
        return len(self._mat()) > 0

    def append(self, v):
        self._mat().append(v)


def ops_to_plan_ops(raw_ops, raw_levels, sps, has_wp=False):
    """Convert the flat native op stream to plan op objects."""
    from ..decoder.plan import IntraOp, ResidualOp, InterOp, PcmOp
    out = []
    i = 0
    n = len(raw_ops)
    o = raw_ops
    W, H = sps.width, sps.height
    while i < n:
        t = o[i]
        if t == 1:
            c_idx, x, y, size, mode = (int(o[i+1]), int(o[i+2]), int(o[i+3]),
                                       int(o[i+4]), int(o[i+5]))
            fl = [bool(o[i+6+k]) for k in range(5)]
            hs = 1 if (c_idx and sps.chroma_format_idc != 3) else 0
            vs = 1 if (c_idx and sps.chroma_format_idc == 1) else 0
            sil_v = size << vs
            sil_h = size << hs
            yl = y << vs
            xl = x << hs
            bls = (min(yl + 2 * sil_v, H) - (yl + sil_v)) >> vs
            trs = (min(xl + 2 * sil_h, W) - (xl + sil_h)) >> hs
            out.append(IntraOp(c_idx=c_idx, x=x, y=y, size=size, mode=mode,
                               cand_bottom_left=fl[0], cand_left=fl[1],
                               cand_up_left=fl[2], cand_up=fl[3],
                               cand_up_right=fl[4],
                               bottom_left_size=max(0, bls),
                               top_right_size=max(0, trs)))
            i += 11
        elif t == 2:
            c_idx, x, y, log2n, qp, kind, off, rext = (
                int(o[i+1]), int(o[i+2]), int(o[i+3]), int(o[i+4]),
                int(o[i+5]), int(o[i+6]), int(o[i+7]), int(o[i+8]))
            nn = 1 << log2n
            lv = raw_levels[off:off + nn * nn].reshape(nn, nn)
            mid = (kind >> 3) - 1           # packed matrix id, -1 = flat
            kind &= 7
            out.append(ResidualOp(c_idx=c_idx, x=x, y=y, log2_size=log2n,
                                  levels=lv, qp=qp,
                                  transform_skip=(kind == 2),
                                  use_dst=(kind == 1),
                                  transquant_bypass=(kind == 3),
                                  rdpcm_dir=(rext & 3) - 1,
                                  rot=bool(rext & 4),
                                  cc_alpha=((rext >> 8) & 63) - 16,
                                  matrix_id=mid))
            i += 9
        elif t == 3:
            x, y, w, h, pf = (int(o[i+1]), int(o[i+2]), int(o[i+3]),
                              int(o[i+4]), int(o[i+5]))
            l0 = (int(o[i+6]), int(o[i+7]), int(o[i+8])) if pf & 1 else None
            l1 = (int(o[i+9]), int(o[i+10]), int(o[i+11])) if pf & 2 else None
            i += 12
            weights = None
            if has_wp:
                dy, dc = int(o[i]), int(o[i+1])
                s0 = tuple(int(v) for v in o[i+2:i+8])
                s1 = tuple(int(v) for v in o[i+8:i+14])
                weights = (dy, dc, s0, s1)
                i += 14
            out.append(InterOp(c_idx=-1, x=x, y=y, w=w, h=h, l0=l0, l1=l1,
                               weights=weights))
        elif t == 4:
            c_idx, x, y, size, off = (int(o[i+1]), int(o[i+2]), int(o[i+3]),
                                      int(o[i+4]), int(o[i+5]))
            vs = 1 if (c_idx and sps.chroma_format_idc == 1) else 0
            hs = 1 if (c_idx and sps.chroma_format_idc != 3) else 0
            h = (size << hs) >> vs      # square except 4:2:2 chroma
            samples = raw_levels[off:off + size * h].reshape(h, size)
            out.append(PcmOp(c_idx=c_idx, x=x, y=y, size=size,
                             samples=samples))
            i += 6
        else:
            raise ValueError(f"bad op tag {t} at {i}")
    return out

