// Native HEVC slice-data front-end: CABAC + CTU syntax -> plan tensors.
//
// Mirrors the (reference-verified) Python front-end in openhevc_tpu/syntax/
// exactly; the Python glue diffs both on every test stream.  Single
// substream (WPP/tile entry points parsed by the caller per substream).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 frontend.cc -o libhevcfe.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <array>
#include <atomic>
#include <memory>
#include <thread>
#include <vector>
#include "tables.h"

#ifdef FE_STATS
static int64_t fe_nbin = 0, fe_nbyp = 0, fe_nbypbits = 0, fe_nrem = 0,
               fe_ntu = 0, fe_ncoeff = 0, fe_tsc_last = 0, fe_tsc_sig = 0,
               fe_tsc_lvl = 0, fe_tsc_other = 0;
static inline uint64_t fe_rdtsc() {
    unsigned lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return ((uint64_t)hi << 32) | lo;
}
#define FE_CNT(x) (x)
#else
#define FE_CNT(x)
#endif

// fused CABAC transition tables over the packed (state<<1 | mps) byte
static uint8_t NEXT_MPS[128], NEXT_LPS[128];
// round-up reciprocals: for range in [256,510] and numerators < 2^25,
// q = (n * RECIP[range]) >> 34 == n / range exactly (k >= 25+9 bound)
static uint32_t RECIP[511];
static const int _init_packed_tables = [] {
    for (int st = 0; st < 64; st++)
        for (int m = 0; m < 2; m++) {
            int s = (st << 1) | m;
            NEXT_MPS[s] = (TRANS_IDX_MPS[st] << 1) | m;
            NEXT_LPS[s] = (TRANS_IDX_LPS[st] << 1) | (st == 0 ? m ^ 1 : m);
        }
    for (int d = 256; d <= 510; d++)
        RECIP[d] = (uint32_t)(((1ull << 34) + d - 1) / d);
    return 0;
}();

// ---------------------------------------------------------------------------
// CABAC decoder (spec 9.3.4.3; matches cabac/engine.py)
// ---------------------------------------------------------------------------

struct Cabac {
    // 64-bit cached bitreader: upcoming bits sit MSB-first in `cache`
    // (top `cache_n` bits valid); refills load 4 bytes at once and bits
    // past the payload read as 0 (same as the bit-at-a-time reader).
    const uint8_t *data;
    int64_t nbytes, bytepos;
    uint64_t cache;
    int cache_n;
    uint32_t range, offset;
    // packed context state: (state_idx << 1) | mps — one load + one store
    // per bin, with fused transition tables (NEXT_MPS / NEXT_LPS)
    uint8_t pst[NUM_CONTEXTS];

    inline void refill32() {
        uint32_t w;
        if (bytepos + 4 <= nbytes) {
            memcpy(&w, data + bytepos, 4);
            w = __builtin_bswap32(w);
        } else {
            w = 0;
            for (int i = 0; i < 4; i++) {
                uint8_t b = (bytepos + i < nbytes) ? data[bytepos + i] : 0;
                w = (w << 8) | b;
            }
        }
        cache |= (uint64_t)w << (32 - cache_n);
        bytepos += 4;
        cache_n += 32;
    }
    inline uint32_t take(int n) {        // 1 <= n <= 32
        if (cache_n < n) refill32();
        uint32_t v = (uint32_t)(cache >> (64 - n));
        cache <<= n;
        cache_n -= n;
        return v;
    }
    inline int bit() { return (int)take(1); }
    void init_engine(const uint8_t *d, int64_t size) {
        data = d; nbytes = size; bytepos = 0; cache = 0; cache_n = 0;
        range = 510;
        offset = take(9);
    }
    void init_contexts(int init_type, int qp) {
        const uint8_t *row = INIT_VALUES[init_type];
        if (qp < 0) qp = 0; if (qp > 51) qp = 51;
        for (int i = 0; i < NUM_CONTEXTS; i++) {
            int iv = row[i];
            int slope = (iv >> 4) * 5 - 45;
            int off = ((iv & 15) << 3) - 16;
            int pre = ((slope * qp) >> 4) + off;
            if (pre < 1) pre = 1; if (pre > 126) pre = 126;
            if (pre <= 63) pst[i] = (63 - pre) << 1;
            else pst[i] = ((pre - 64) << 1) | 1;
        }
    }
    inline int decode_bin(int ctx) {
        FE_CNT(fe_nbin++);
        // branchless MPS/LPS select (cmov): residual bins carry ~1 bit of
        // entropy each, so a branch here mispredicts near 50% of the time
        int s = pst[ctx];
        uint32_t lps = LPS_RANGE[(s & ~1) * 2 + ((range >> 6) & 3)];
        uint32_t rmps = range - lps;
        uint32_t is_lps = offset >= rmps;       // 0 / 1
        range = is_lps ? lps : rmps;
        offset -= is_lps ? rmps : 0;
        int v = (s & 1) ^ (int)is_lps;
        pst[ctx] = is_lps ? NEXT_LPS[s] : NEXT_MPS[s];
        // unified renorm: 0..7 shifts (0 when range >= 256); take(0)-safe
        int sh = __builtin_clz(range) - 23;
        if (cache_n < sh) refill32();
        range <<= sh;
        offset = (offset << sh) | (uint32_t)((cache >> (63 - sh)) >> 1);
        cache <<= sh;
        cache_n -= sh;
        return v;
    }
    inline int bypass() {
        FE_CNT((fe_nbyp++, fe_nbypbits++));
        offset = (offset << 1) | take(1);
        if (offset >= range) { offset -= range; return 1; }
        return 0;
    }
    // n bypass bins in one division: each bypass step computes one binary
    // digit of offset/range (offset' = 2*offset+b - bin*range keeps
    // offset < range), so n steps yield exactly
    //   bins = (offset<<n | bits) / range,  offset' = (...) % range.
    inline uint32_t bypass_chunk(int n) {     // 1 <= n <= 16
        FE_CNT((fe_nbyp++, fe_nbypbits += n));
        uint64_t off2 = ((uint64_t)offset << n) | take(n);
        // exact n<=16: off2 < range<<16 < 2^25, RECIP bound covers it
        uint32_t q = (uint32_t)((off2 * RECIP[range]) >> 34);
        offset = (uint32_t)(off2 - (uint64_t)q * range);
        return q;
    }
    inline uint32_t bypass_bits(int n) {
        uint32_t v = 0;
        while (n > 16) { v = (v << 16) | bypass_chunk(16); n -= 16; }
        if (n) v = (v << n) | bypass_chunk(n);
        return v;
    }
    // up to n bypass bins of a unary prefix (1-bins then a 0).  Returns the
    // count of 1-bins; *stopped set when the terminating 0 was consumed.
    inline int bypass_unary(int n, bool *stopped) {
        if (cache_n < n) refill32();
        uint32_t bits = (uint32_t)(cache >> (64 - n));
        uint64_t off2 = ((uint64_t)offset << n) | bits;
        uint32_t q = (uint32_t)((off2 * RECIP[range]) >> 34);
        uint32_t inv = (~q) & ((1u << n) - 1);
        if (inv == 0) {                      // all ones: consume every bin
            offset = (uint32_t)(off2 - (uint64_t)q * range);
            cache <<= n; cache_n -= n;
            *stopped = false;
            return n;
        }
        int ones = n - 1 - (31 - __builtin_clz(inv));
        int consume = ones + 1;              // prefix ones + the 0 bin
        uint32_t bits2 = (uint32_t)(cache >> (64 - consume));
        uint64_t off2b = ((uint64_t)offset << consume) | bits2;
        uint32_t q2 = q >> (n - consume);    // == (1<<consume) - 2
        offset = (uint32_t)(off2b - (uint64_t)q2 * range);
        cache <<= consume; cache_n -= consume;
        *stopped = true;
        return ones;
    }
    inline int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        if (range < 256) {
            int s = __builtin_clz(range) - 23;
            range <<= s;
            offset = (offset << s) | take(s);
        }
        return 0;
    }
    // PCM: byte-align, raw fixed-length reads, then engine re-init with
    // contexts preserved (spec 9.3.1; cabac/engine.py pcm_reinit)
    inline void pcm_align() {
        int rem = (int)((bytepos * 8 - cache_n) & 7);   // consumed bits % 8
        if (rem) take(8 - rem);
    }
    inline uint32_t read_raw(int n) {
        uint32_t v = 0;
        while (n > 24) { v = (v << 24) | take(24); n -= 24; }
        if (n) v = (v << n) | take(n);
        return v;
    }
    inline void pcm_reinit() {
        pcm_align();
        range = 510;
        offset = take(9);
    }
};

// ---------------------------------------------------------------------------
// parameters + frame context
// ---------------------------------------------------------------------------

struct SliceParams {                 // keep in sync with native/__init__.py
    int32_t width, height, bit_depth, chroma_format_idc;
    int32_t log2_ctb, log2_min_cb, log2_min_tb, log2_max_tb;
    int32_t max_tt_depth_intra, max_tt_depth_inter;
    int32_t amp_enabled, sao_enabled_sps, strong_intra_smoothing, pcm_enabled;
    int32_t pcm_log2_min, pcm_log2_max, pcm_bit_depth, pcm_bit_depth_chroma,
        pcm_loop_filter_disabled;
    int32_t scaling_list_enabled;
    int32_t qp_bd_offset;
    int32_t sign_data_hiding, cabac_init_present, cu_qp_delta_enabled,
        diff_cu_qp_delta_depth;
    int32_t cb_qp_offset, cr_qp_offset, transquant_bypass_enabled,
        transform_skip_enabled;
    int32_t tiles_enabled, entropy_coding_sync, loop_filter_across_tiles,
        log2_parallel_merge_level;
    int32_t slice_type, slice_qp, sao_luma, sao_chroma;
    int32_t num_ref_idx0, num_ref_idx1, max_num_merge_cand, mvd_l1_zero,
        collocated_list, collocated_ref_idx, sh_tmvp_enabled;
    int32_t loop_filter_across_slices, deblocking_disabled;
    int32_t slice_addr, cur_poc, init_type;
    int32_t ctb_width, ctb_height;
    int32_t mtb_w, mtb_h;            // min-tb grid dims
    int32_t has_collocated, col_poc;
    int32_t first_ctb_ts, last_ctb_ts;   // substream CTB range (inclusive)
    int32_t init_state;                  // 1 = clear persistent syntax state
    int32_t slice_start;                 // 1 = first substream of a slice
    int32_t stop_at_eos;                 // 1 = stop at end_of_slice flag
    int32_t ctx_load;                    // 1 = load contexts from ctx_io
    int32_t wpp_save_ctx;                // 1 = save ctx after 2nd CTB
    int32_t save_ctx_end;                // 1 = save ctx at end of segment
                                         //     (dependent slice segments)
    int32_t has_wp, wp_denom_y, wp_denom_c;
    // RExt tool enables (sps/pps range extensions)
    int32_t implicit_rdpcm, explicit_rdpcm, persistent_rice, ts_context,
        ts_rotation, cross_component;
    // chroma-QP offset lists (hevc.c:1247-1263; slice flag hevc.c:957)
    int32_t cu_chroma_qp_offset_enabled, diff_cu_chroma_qp_offset_depth,
        chroma_qp_offset_list_len;
    int32_t lv_base;   // absolute base for emitted level offsets (multi-
                       // substream pictures: replaces the python rebase)
    int32_t wp_w[2][16][3];              // [list][ref][y/cb/cr] weights
    int32_t wp_o[2][16][3];              // offsets
    int32_t rpl_lt[2][16];               // long-term flag per (list, ref)
    int32_t col_lt[2][16];               // same for the collocated frame
    int32_t cb_qp_offset_list[6];        // PPS chroma-QP offset pairs
    int32_t cr_qp_offset_list[6];
};

struct Ctx {
    const SliceParams *p;
    Cabac cc;
    // derived tables (borrowed)
    const int32_t *rs_to_ts, *ts_to_rs, *tile_id, *min_tb_zs;
    const int32_t *rpl0, *rpl1;     // POC lists
    // collocated frame motion (borrowed, may be null)
    const int32_t *col_mv;          // (h4, w4, 2, 2)
    const int32_t *col_poc_arr;     // (h4, w4, 2)
    const uint8_t *col_pred;        // (h4, w4)
    const int8_t *col_refidx;       // (h4, w4, 2)
    const int32_t *col_rpl0, *col_rpl1;
    // outputs (borrowed)
    int32_t *ops; int64_t ops_pos, ops_cap;
    int32_t *levels; int64_t lv_pos, lv_cap, lv_base;
    int32_t *mvf_mv;                // (h4, w4, 2, 2)
    int32_t *mvf_poc;               // (h4, w4, 2)
    uint8_t *mvf_pred;
    int8_t *mvf_ref_idx;
    uint8_t *vbs, *hbs;             // (h4, w8), (h8, w4)
    int8_t *qp_y_tab;               // min_cb grid
    uint8_t *is_pcm_or_bypass;      // (h4, w4)
    int32_t *sao_out;               // per ctb: 24 ints
    // internal state
    uint8_t *ct_depth;              // min_cb grid
    uint8_t *tab_ipm;               // (h4, w4)
    uint8_t *skip_flag;             // min_cb grid
    uint8_t *cbf_luma;              // min-tb grid
    int32_t *slice_addr_tab;        // per ctb rs
    // per-ctb neighbour flags
    int ctb_left, ctb_up, ctb_upleft, ctb_upright;
    int end_of_tiles_x, end_of_tiles_y;
    int boundary_up, boundary_left; // slice|tile<<1
    int qp_y, qp_y_pred, first_qp_group, is_cu_qp_delta_coded, cu_qp_delta;
    int is_cu_chroma_qp_offset_coded, cu_qp_offset_cb, cu_qp_offset_cr;
    // persistent RExt state (borrowed, decoder lifetime):
    // [0..3] stat_coeff, [4] stale pu intra mode, [5] stale pu chroma mode
    int32_t *rext;
    int cur_cu_x0, cur_cu_y0;
    int ct_depth_cur;
    int min_cb_w, min_cb_h, w4, h4, w8, h8;
    int err;
};

static const int QPC[14] = {29,30,31,32,33,33,34,34,35,35,36,36,37,37};

static inline int av_clip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline void emit(Ctx &c, int32_t v) {
    if (c.ops_pos < c.ops_cap) c.ops[c.ops_pos] = v;
    c.ops_pos++;
}

// ---------------------------------------------------------------------------
// neighbour availability (syntax/ctu.py FrameState)
// ---------------------------------------------------------------------------

static void decode_neighbour(Ctx &c, int x_ctb, int y_ctb, int ctb_ts) {
    const SliceParams *p = c.p;
    int ctb_size = 1 << p->log2_ctb;
    int rs = c.ts_to_rs[ctb_ts];
    int in_slice = rs - p->slice_addr;
    c.slice_addr_tab[rs] = p->slice_addr;

    if (p->entropy_coding_sync) {
        if (x_ctb == 0) c.first_qp_group = 1;
        c.end_of_tiles_x = p->width;
    }
    else if (p->tiles_enabled) {
        if (ctb_ts && c.tile_id[ctb_ts] != c.tile_id[ctb_ts - 1]) {
            c.first_qp_group = 1;
            // find the tile column width: walk right until tile id changes
            int cx = x_ctb >> p->log2_ctb;
            int wcols = 0;
            int row = rs / p->ctb_width;
            for (int x = cx; x < p->ctb_width; x++) {
                if (c.tile_id[c.rs_to_ts[row * p->ctb_width + x]] ==
                    c.tile_id[ctb_ts]) wcols++;
                else break;
            }
            c.end_of_tiles_x = x_ctb + (wcols << p->log2_ctb);
        }
    } else c.end_of_tiles_x = p->width;
    c.end_of_tiles_y = y_ctb + ctb_size;
    if (c.end_of_tiles_y > p->height) c.end_of_tiles_y = p->height;

    int tile_left = 0, tile_up = 0, slice_left, slice_up;
    if (p->tiles_enabled) {
        tile_left = x_ctb > 0 &&
            c.tile_id[ctb_ts] != c.tile_id[c.rs_to_ts[rs - 1]];
        tile_up = y_ctb > 0 &&
            c.tile_id[ctb_ts] != c.tile_id[c.rs_to_ts[rs - p->ctb_width]];
        slice_left = x_ctb > 0 &&
            c.slice_addr_tab[rs] != c.slice_addr_tab[rs - 1];
        slice_up = y_ctb > 0 &&
            c.slice_addr_tab[rs] != c.slice_addr_tab[rs - p->ctb_width];
    } else {
        slice_left = in_slice <= 0;
        slice_up = in_slice < p->ctb_width;
    }
    c.boundary_left = (slice_left ? 1 : 0) | (tile_left ? 2 : 0);
    c.boundary_up = (slice_up ? 1 : 0) | (tile_up ? 2 : 0);
    c.ctb_left = x_ctb > 0 && in_slice > 0 && !tile_left;
    c.ctb_up = y_ctb > 0 && in_slice >= p->ctb_width && !tile_up;
    c.ctb_upright = 0;
    if (y_ctb > 0 && in_slice + 1 >= p->ctb_width &&
        (rs % p->ctb_width) + 1 < p->ctb_width)
        c.ctb_upright = c.tile_id[ctb_ts] ==
            c.tile_id[c.rs_to_ts[rs + 1 - p->ctb_width]];
    c.ctb_upleft = x_ctb > 0 && y_ctb > 0 && in_slice - 1 >= p->ctb_width &&
        c.tile_id[ctb_ts] == c.tile_id[c.rs_to_ts[rs - 1 - p->ctb_width]];
}

struct Avail { int bl, l, ul, u, ur, ur_sap; };

static Avail neighbour_avail(Ctx &c, int x0, int y0, int w, int h) {
    const SliceParams *p = c.p;
    int mask = (1 << p->log2_ctb) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    Avail a;
    a.u = c.ctb_up || y0b;
    a.l = c.ctb_left || x0b;
    a.ul = (!x0b && !y0b) ? c.ctb_upleft : (a.l && a.u);
    a.ur_sap = ((x0b + w) == (1 << p->log2_ctb)) ? (c.ctb_upright && !y0b)
                                                  : a.u;
    a.ur = a.ur_sap && (x0 + w) < c.end_of_tiles_x;
    a.bl = ((y0 + h) >= c.end_of_tiles_y) ? 0 : a.l;
    return a;
}

static inline int zs_at(Ctx &c, int x, int y) {
    return c.min_tb_zs[(y >> c.p->log2_min_tb) * c.p->mtb_w +
                       (x >> c.p->log2_min_tb)];
}

static int z_scan_avail(Ctx &c, int xc, int yc, int xn, int yn) {
    const SliceParams *p = c.p;
    if ((yn >> p->log2_ctb) < (yc >> p->log2_ctb) ||
        (xn >> p->log2_ctb) < (xc >> p->log2_ctb)) return 1;
    return zs_at(c, xn, yn) <= zs_at(c, xc, yc);
}

// intra reference availability incl. z-order checks (FrameState.intra_avail)
static void intra_avail(Ctx &c, int x0, int y0, int log2n, int c_idx,
                        const Avail &na, int out[5]) {
    const SliceParams *p = c.p;
    int hs = (c_idx && p->chroma_format_idc != 3) ? 1 : 0;
    int vs = (c_idx && p->chroma_format_idc == 1) ? 1 : 0;
    int n = 1 << log2n;
    int sil_h = n << hs, sil_v = n << vs;
    int stb_h = sil_h >> p->log2_min_tb, stb_v = sil_v >> p->log2_min_tb;
    int x_tb = x0 >> p->log2_min_tb, y_tb = y0 >> p->log2_min_tb;
    int cur = c.min_tb_zs[y_tb * p->mtb_w + x_tb];
    int bl = na.bl, ur = na.ur;
    if (bl) {
        int ybl = y_tb + stb_v;
        bl = ybl < p->mtb_h && x_tb > 0 &&
             cur > c.min_tb_zs[ybl * p->mtb_w + (x_tb - 1)];
    }
    if (ur) {
        int xur = x_tb + stb_h;
        ur = xur < p->mtb_w && y_tb > 0 &&
             cur > c.min_tb_zs[(y_tb - 1) * p->mtb_w + xur];
    }
    out[0] = bl; out[1] = na.l; out[2] = na.ul; out[3] = na.u; out[4] = ur;
}

static int chroma_qp(Ctx &c, int qp_y, int c_idx) {
    const SliceParams *p = c.p;
    int offset = c_idx == 1 ? p->cb_qp_offset + c.cu_qp_offset_cb
                            : p->cr_qp_offset + c.cu_qp_offset_cr;
    int qp_i = av_clip(qp_y + offset, -p->qp_bd_offset, 57);
    int qp;
    if (p->chroma_format_idc == 1) {
        if (qp_i < 30) qp = qp_i;
        else if (qp_i > 43) qp = qp_i - 6;
        else qp = QPC[qp_i - 30];
    } else {
        qp = qp_i > 51 ? 51 : qp_i;
    }
    return qp + p->qp_bd_offset;
}

// ---------------------------------------------------------------------------
// residual coding (syntax/residual.py; hevc_cabac.c:1372)
// ---------------------------------------------------------------------------

static const uint8_t CTX_IDX_MAP[5][16] = {
    {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8},
    {1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0},
    {2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0, 2, 1, 0, 0},
    {2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2},
};

// sig-flag context per scan position, pre-fused through the 4x4 subblock
// scan order: MAPPED_SIG[scan][map][sn] = CTX_IDX_MAP[map][pos4x4(sn)]
// (removes two table loads + address arithmetic from the hottest loop)
static uint8_t MAPPED_SIG[3][5][16];
// lv[] write offset within a 4x4 group: cy*4 + cx in scan order
static uint8_t SCAN_POS4[3][16];
static const int _init_sig_tables = [] {
    const uint8_t *cxs[3] = {SCAN_DIAG_2_CX, SCAN_HORIZ_2_CX, SCAN_VERT_2_CX};
    const uint8_t *cys[3] = {SCAN_DIAG_2_CY, SCAN_HORIZ_2_CY, SCAN_VERT_2_CY};
    for (int s = 0; s < 3; s++)
        for (int sn = 0; sn < 16; sn++) {
            int pos = (cys[s][sn] << 2) + cxs[s][sn];
            SCAN_POS4[s][sn] = (uint8_t)pos;
            for (int m = 0; m < 5; m++)
                MAPPED_SIG[s][m][sn] = CTX_IDX_MAP[m][pos];
        }
    return 0;
}();

struct ScanSet {
    const uint8_t *cx, *cy, *gx, *gy;
    const int16_t *inv;
};

static ScanSet get_scans(int scan_idx, int log2n) {
    ScanSet s;
    switch (scan_idx * 8 + log2n) {
#define CASE(si, name, l) case si * 8 + l: \
        s.cx = SCAN_##name##_##l##_CX; s.cy = SCAN_##name##_##l##_CY; \
        s.gx = SCAN_##name##_##l##_GX; s.gy = SCAN_##name##_##l##_GY; \
        s.inv = SCAN_##name##_##l##_INV; break;
    CASE(0, DIAG, 2) CASE(0, DIAG, 3) CASE(0, DIAG, 4) CASE(0, DIAG, 5)
    CASE(1, HORIZ, 2) CASE(1, HORIZ, 3)
    CASE(2, VERT, 2) CASE(2, VERT, 3)
#undef CASE
    default: s.cx = s.cy = s.gx = s.gy = nullptr; s.inv = nullptr;
    }
    return s;
}

static inline int decode_remaining(Cabac &cc, int rice) {
    FE_CNT(fe_nrem++);
    // fast path: when the unary prefix is 0-2 (the common case once the
    // rice parameter has adapted), the prefix AND the whole rice suffix
    // fit one bypass division — read 3+rice bins as a single quotient,
    // locate the terminating 0 in the top 3, roll back the unconsumed
    // tail (same remainder algebra as bypass_unary)
    if (rice <= 12) {
        int n = 3 + rice;
        if (cc.cache_n < n) cc.refill32();
        uint32_t bits = (uint32_t)(cc.cache >> (64 - n));
        uint64_t off2 = ((uint64_t)cc.offset << n) | bits;
        uint32_t q = (uint32_t)((off2 * RECIP[cc.range]) >> 34);
        uint32_t top3 = q >> rice;
        if (top3 != 7) {
            static const int8_t ONES3[8] = {0, 0, 0, 0, 1, 1, 2, -1};
            int ones = ONES3[top3];
            int drop = 2 - ones;          // unconsumed trailing bins
            uint32_t qc = q >> drop;
            uint64_t off2c = ((uint64_t)cc.offset << (n - drop)) |
                             (bits >> drop);
            cc.offset = (uint32_t)(off2c - (uint64_t)qc * cc.range);
            cc.cache <<= (n - drop);
            cc.cache_n -= (n - drop);
            FE_CNT((fe_nbyp++, fe_nbypbits += n - drop));
            return (ones << rice) | (qc & ((1u << rice) - 1));
        }
    }
    int prefix = 0;
    bool stopped = false;
    while (prefix < 31 && !stopped) {
        int n = 31 - prefix; if (n > 12) n = 12;
        prefix += cc.bypass_unary(n, &stopped);
    }
    if (prefix < 3) return (prefix << rice) + cc.bypass_bits(rice);
    int pm3 = prefix - 3;
    return (((1 << pm3) + 2) << rice) + cc.bypass_bits(pm3 + rice);
}

// returns transform_skip flag; levels written (n*n int32, row-major);
// out_rot/out_rdir receive the RExt post-transforms (rot 0/1, rdir -1/0/1)
static int decode_residual(Ctx &c, int c_idx, int log2n, int scan_idx,
                           int tq_bypass, int is_intra, int pred_intra,
                           int32_t *lv, int *out_rot, int *out_rdir) {
    const SliceParams *p = c.p;
    Cabac &cc = c.cc;
    int n = 1 << log2n;
    memset(lv, 0, sizeof(int32_t) * n * n);

    int tskip = 0;
    if (!tq_bypass && p->transform_skip_enabled && log2n <= 2)
        tskip = cc.decode_bin(CTX_TRANSFORM_SKIP_FLAG + (c_idx ? 1 : 0));

    // explicit RDPCM (inter, transform-skip/bypass; hevc_cabac.c:1502-1508)
    int erd_flag = 0, erd_dir = 0;
    if (!is_intra && p->explicit_rdpcm && (tskip || tq_bypass)) {
        erd_flag = cc.decode_bin(CTX_EXPLICIT_RDPCM_FLAG + (c_idx ? 1 : 0));
        if (erd_flag)
            erd_dir = cc.decode_bin(CTX_EXPLICIT_RDPCM_DIR_FLAG +
                                    (c_idx ? 1 : 0));
    }

    // last significant position
    int offset_c, shift_c;
    if (c_idx == 0) {
        offset_c = 3 * (log2n - 2) + ((log2n - 1) >> 2);
        shift_c = (log2n + 1) >> 2;
    } else { offset_c = 15; shift_c = log2n - 2; }
    FE_CNT(fe_ntu++);
#ifdef FE_STATS
    uint64_t _t0 = fe_rdtsc();
#endif
    int maxv = (log2n << 1) - 1;
    int lx = 0, ly = 0;
    while (lx < maxv &&
           cc.decode_bin(CTX_LAST_SIGNIFICANT_COEFF_X_PREFIX +
                         (lx >> shift_c) + offset_c)) lx++;
    while (ly < maxv &&
           cc.decode_bin(CTX_LAST_SIGNIFICANT_COEFF_Y_PREFIX +
                         (ly >> shift_c) + offset_c)) ly++;
    if (lx > 3) {
        int len = (lx >> 1) - 1;
        lx = (1 << len) * (2 + (lx & 1)) + cc.bypass_bits(len);
    }
    if (ly > 3) {
        int len = (ly >> 1) - 1;
        ly = (1 << len) * (2 + (ly & 1)) + cc.bypass_bits(len);
    }
    if (scan_idx == 2) { int t = lx; lx = ly; ly = t; }

    FE_CNT((fe_tsc_last += fe_rdtsc() - _t0, _t0 = fe_rdtsc()));
    ScanSet sc = get_scans(scan_idx, log2n);
    int num_coeff = sc.inv[ly * n + lx] + 1;
    int num_last_subset = (num_coeff - 1) >> 4;
    int x_cg_last = lx >> 2, y_cg_last = ly >> 2;
    int ncg = n > 4 ? (n >> 2) : 1;
    uint8_t csbf[8][8];
    memset(csbf, 0, sizeof(csbf));
    int greater1_ctx = 0;

    for (int i = num_last_subset; i >= 0; i--) {
        int x_cg = sc.gx[i], y_cg = sc.gy[i];
        int off = i << 4;
        int implicit_nz = 0;
        if (i < num_last_subset && i > 0) {
            int ctx_cg = 0;
            if (x_cg < ncg - 1) ctx_cg += csbf[y_cg][x_cg + 1];
            if (y_cg < ncg - 1) ctx_cg += csbf[y_cg + 1][x_cg];
            int inc = (ctx_cg > 1 ? 1 : ctx_cg) + (c_idx ? 2 : 0);
            csbf[y_cg][x_cg] =
                cc.decode_bin(CTX_SIGNIFICANT_COEFF_GROUP_FLAG + inc);
            implicit_nz = 1;
        } else {
            csbf[y_cg][x_cg] = (x_cg == x_cg_last && y_cg == y_cg_last) ||
                               (x_cg == 0 && y_cg == 0);
        }
        int last_scan_pos = num_coeff - off - 1;
        int sig_idx[16];
        int n_sig = 0;
        int n_end;
        if (i == num_last_subset) {
            n_end = last_scan_pos - 1;
            sig_idx[n_sig++] = last_scan_pos;
        } else n_end = 15;

        int prev_sig = 0;
        if (x_cg < ((n - 1) >> 2)) prev_sig = csbf[y_cg][x_cg + 1] ? 1 : 0;
        if (y_cg < ((n - 1) >> 2)) prev_sig += csbf[y_cg + 1][x_cg] ? 2 : 0;

        if (csbf[y_cg][x_cg] && n_end >= 0) {
            int map_id;
            int scf_offset = c_idx ? 27 : 0;
            int ts_ctx = p->ts_context && (tskip || tq_bypass);
            if (ts_ctx) {
                // transform-skip sig contexts (hevc_cabac.c:1633-1640)
                map_id = 4;
                scf_offset = c_idx ? 14 + 27 : 40;
            } else if (log2n == 2) map_id = 0;
            else {
                map_id = prev_sig + 1;
                if (c_idx == 0) {
                    if (x_cg > 0 || y_cg > 0) scf_offset += 3;
                    if (log2n == 3)
                        scf_offset += scan_idx == 0 ? 9 : 15;
                    else scf_offset += 21;
                } else {
                    scf_offset += log2n == 3 ? 9 : 12;
                }
            }
            // branchless sig loop: the flag carries ~1 bit of entropy, so
            // a data-dependent branch here mispredicted half the time
            const uint8_t *mrow = MAPPED_SIG[scan_idx][map_id];
            int sig_base = CTX_SIGNIFICANT_COEFF_FLAG + scf_offset;
            for (int sn = n_end; sn > 0; sn--) {
                int b = cc.decode_bin(sig_base + mrow[sn]);
                sig_idx[n_sig] = sn;
                n_sig += b;
                implicit_nz &= b ^ 1;
            }
            if (implicit_nz == 0) {
                int off0;
                if (ts_ctx) off0 = c_idx ? 16 + 27 : 42;
                else if (i == 0) off0 = c_idx ? 27 : 0;
                else off0 = 2 + scf_offset;
                if (cc.decode_bin(CTX_SIGNIFICANT_COEFF_FLAG + off0))
                    sig_idx[n_sig++] = 0;
            } else sig_idx[n_sig++] = 0;
        }
        FE_CNT((fe_tsc_sig += fe_rdtsc() - _t0, _t0 = fe_rdtsc()));
        if (!n_sig) { FE_CNT(_t0 = fe_rdtsc()); continue; }

        int ctx_set = (i > 0 && c_idx == 0) ? 2 : 0;
        if (i != num_last_subset && greater1_ctx == 0) ctx_set++;
        greater1_ctx = 1;
        int last_nz = sig_idx[0];
        int first_nz = sig_idx[n_sig - 1];

        int g1[8];
        int first_g1 = -1;
        int ng1 = n_sig > 8 ? 8 : n_sig;
        int g1_base = CTX_COEFF_ABS_LEVEL_GREATER1_FLAG + (ctx_set << 2) +
                      (c_idx ? 16 : 0);
        for (int m = 0; m < ng1; m++) {
            int b = cc.decode_bin(g1_base + greater1_ctx);
            g1[m] = b;
            // branchless ctx walk (cmovs): 0 on a 1-bin, saturating ++ else
            int bumped = greater1_ctx + (greater1_ctx > 0 &&
                                         greater1_ctx < 3);
            greater1_ctx = b ? 0 : bumped;
            first_g1 = (b && first_g1 < 0) ? m : first_g1;
        }
        int sign_hidden;
        if (tq_bypass || erd_flag ||
            (is_intra && p->implicit_rdpcm && tskip &&
             (pred_intra == 10 || pred_intra == 26)))
            sign_hidden = 0;
        else sign_hidden = (last_nz - first_nz) >= 4;
        if (first_g1 != -1)
            g1[first_g1] += cc.decode_bin(CTX_COEFF_ABS_LEVEL_GREATER2_FLAG +
                                          ctx_set + (c_idx ? 4 : 0));
        int hide = p->sign_data_hiding && sign_hidden;
        int nb_signs = n_sig - (hide ? 1 : 0);
        uint32_t signs = cc.bypass_bits(nb_signs) << (16 - nb_signs);

        int c_rice = 0, sb_type = 0, rice_done = 0;
        if (p->persistent_rice) {
            sb_type = 2 * (c_idx == 0 ? 1 : 0) +
                      ((tskip || tq_bypass) ? 1 : 0);
            c_rice = c.rext[sb_type] / 4;
        }
        int64_t sum_abs = 0;
        for (int m = 0; m < n_sig; m++) {
            int sn = sig_idx[m];
            int xc = (x_cg << 2) + sc.cx[sn];
            int yc = (y_cg << 2) + sc.cy[sn];
            int64_t level;
            int rem = -1;
            if (m < 8) {
                level = 1 + g1[m];
                int esc = (m == first_g1) ? 3 : 2;
                if (level == esc) {
                    rem = decode_remaining(cc, c_rice);
                    level += rem;
                }
            } else {
                rem = decode_remaining(cc, c_rice);
                level = 1 + rem;
            }
            if (rem >= 0) {
                if (level > (3 << c_rice))
                    c_rice = p->persistent_rice ? c_rice + 1
                                                : (c_rice < 4 ? c_rice + 1
                                                              : c_rice);
                // once-per-subset stat adaptation (hevc_cabac.c:1780-1788)
                if (p->persistent_rice && !rice_done) {
                    int ci = c.rext[sb_type] / 4;
                    if (rem >= (3 << ci)) c.rext[sb_type]++;
                    else if (2 * rem < (1 << ci) && c.rext[sb_type] > 0)
                        c.rext[sb_type]--;
                    rice_done = 1;
                }
            }
            sum_abs += level;
            if (m == n_sig - 1 && hide) {
                // hidden sign: the scan-first nonzero (decoded last) takes
                // its sign from the subset's level-sum parity; its explicit
                // sign bit was never coded (nb_signs = n_sig - 1)
                if (sum_abs & 1) level = -level;
            } else {
                // branchless sign apply: the sign bit carries a full bit of
                // entropy, so `if (neg) level = -level` mispredicted ~50%
                // of the time on dense residuals
                int64_t sgn = -(int64_t)(signs >> 15);
                signs = (signs << 1) & 0xFFFF;
                level = (level ^ sgn) - sgn;
            }
            if (level > 32767) level = 32767;
            if (level < -32768) level = -32768;
            lv[(yc << log2n) + xc] = (int32_t)level;
            FE_CNT(fe_ncoeff++);
        }
        FE_CNT((fe_tsc_lvl += fe_rdtsc() - _t0, _t0 = fe_rdtsc()));
    }
    // RExt post-transform derivation (hevc_cabac.c:1868-1895; the fork
    // gates the transform-skip implicit path on ts_ROTATION, mirrored)
    int rot = 0, rdir = -1;
    if (tq_bypass) {
        if (erd_flag || (p->implicit_rdpcm &&
                         (pred_intra == 10 || pred_intra == 26)))
            rdir = p->implicit_rdpcm ? (pred_intra == 26) : erd_dir;
    } else if (tskip) {
        rot = p->ts_rotation && log2n == 2 && is_intra;
        if (erd_flag || (p->ts_rotation && is_intra &&
                         (pred_intra == 10 || pred_intra == 26)))
            rdir = erd_flag ? erd_dir : (pred_intra == 26);
    }
    *out_rot = rot;
    *out_rdir = rdir;
    return tskip;
}

// cross-component ResScaleVal (hls_cross_component_pred, hevc.c:1186-1196)
static int decode_cc_alpha(Ctx &c, int idx) {
    Cabac &cc = c.cc;
    int i = 0;
    while (i < 4 && cc.decode_bin(CTX_LOG2_RES_SCALE_ABS + 4 * idx + i)) i++;
    if (!i) return 0;
    int sign = cc.decode_bin(CTX_RES_SCALE_SIGN_FLAG + idx);
    return (1 << (i - 1)) * (1 - 2 * sign);
}

// ---------------------------------------------------------------------------
// motion vectors (syntax/pu.py; hevc_mvs.c)
// ---------------------------------------------------------------------------

struct MvField {
    int32_t mv[2][2];
    int32_t poc[2];
    int8_t ref_idx[2];
    uint8_t pred;                    // 0 intra, 1 L0, 2 L1, 3 BI
};

static inline MvField mvf_at(Ctx &c, int x4, int y4) {
    MvField f;
    int64_t base = ((int64_t)y4 * c.w4 + x4);
    f.pred = c.mvf_pred[base];
    for (int l = 0; l < 2; l++) {
        f.mv[l][0] = c.mvf_mv[base * 4 + l * 2 + 0];
        f.mv[l][1] = c.mvf_mv[base * 4 + l * 2 + 1];
        f.poc[l] = c.mvf_poc[base * 2 + l];
        f.ref_idx[l] = c.mvf_ref_idx[base * 2 + l];
    }
    return f;
}

static void store_mvf(Ctx &c, int x0, int y0, int w, int h, const MvField &f) {
    int xp = x0 >> 2, yp = y0 >> 2;
    int nw = w >> 2 ? w >> 2 : 1, nh = h >> 2 ? h >> 2 : 1;
    for (int y = yp; y < yp + nh; y++)
        for (int x = xp; x < xp + nw; x++) {
            int64_t base = (int64_t)y * c.w4 + x;
            c.mvf_pred[base] = f.pred;
            for (int l = 0; l < 2; l++) {
                c.mvf_mv[base * 4 + l * 2 + 0] = f.mv[l][0];
                c.mvf_mv[base * 4 + l * 2 + 1] = f.mv[l][1];
                c.mvf_poc[base * 2 + l] = f.poc[l];
                c.mvf_ref_idx[base * 2 + l] = f.ref_idx[l];
            }
        }
}

static int compare_mv_ref(const MvField &a, const MvField &b) {
    if (a.pred != b.pred) return 0;
    if (a.pred == 3)
        return a.poc[0] == b.poc[0] && a.mv[0][0] == b.mv[0][0] &&
               a.mv[0][1] == b.mv[0][1] && a.poc[1] == b.poc[1] &&
               a.mv[1][0] == b.mv[1][0] && a.mv[1][1] == b.mv[1][1];
    if (a.pred == 1)
        return a.poc[0] == b.poc[0] && a.mv[0][0] == b.mv[0][0] &&
               a.mv[0][1] == b.mv[0][1];
    if (a.pred == 2)
        return a.poc[1] == b.poc[1] && a.mv[1][0] == b.mv[1][0] &&
               a.mv[1][1] == b.mv[1][1];
    return 0;
}

static inline int clip16i(int64_t v) {
    return v < -32768 ? -32768 : (v > 32767 ? 32767 : (int)v);
}

static void mv_scale(int32_t dst[2], const int32_t src[2], int td, int tb) {
    td = av_clip(td, -128, 127);
    tb = av_clip(tb, -128, 127);
    int atd = td < 0 ? -td : td;
    int q = (0x4000 + atd / 2) / atd;
    int tx = td > 0 ? q : -q;
    int scale = av_clip((tb * tx + 32) >> 6, -4096, 4095);
    int64_t x = (int64_t)scale * src[0];
    int64_t y = (int64_t)scale * src[1];
    dst[0] = clip16i((x + 127 + (x < 0 ? 1 : 0)) >> 8);
    dst[1] = clip16i((y + 127 + (y < 0 ? 1 : 0)) >> 8);
}

// temporal MV (hevc_mvs.c:173-285); returns 1 on available
static int derive_temporal_mv(Ctx &c, const MvField &t, int ref_idx_lx, int X,
                              int32_t out[2]) {
    const SliceParams *p = c.p;
    const int32_t *rplx = X == 0 ? c.rpl0 : c.rpl1;

    auto check = [&](int lst) -> int {
        const int32_t *col_rpl = lst == 0 ? c.col_rpl0 : c.col_rpl1;
        int cur_lt = p->rpl_lt[X][ref_idx_lx];
        int col_lt = p->col_lt[lst][t.ref_idx[lst]];
        if (cur_lt != col_lt) {           // spec 8.5.3.1.8 / check_mvset
            out[0] = 0; out[1] = 0;
            return 0;
        }
        int col_poc_diff = p->col_poc - col_rpl[t.ref_idx[lst]];
        int cur_poc_diff = p->cur_poc - rplx[ref_idx_lx];
        if (cur_lt || col_poc_diff == cur_poc_diff || !col_poc_diff) {
            out[0] = t.mv[lst][0]; out[1] = t.mv[lst][1];
        } else {
            mv_scale(out, t.mv[lst], col_poc_diff, cur_poc_diff);
        }
        return 1;
    };

    if (t.pred == 0) return 0;
    if (!(t.pred & 1)) return check(1);
    if (t.pred == 1) return check(0);
    // BI
    int diff = 0;
    for (int j = 0; j < 2 && !diff; j++) {
        const int32_t *rpl = j == 0 ? c.rpl0 : c.rpl1;
        int nr = j == 0 ? p->num_ref_idx0 : p->num_ref_idx1;
        for (int i = 0; i < nr; i++)
            if (rpl[i] > p->cur_poc) { diff = 1; break; }
    }
    if (!diff) return check(X == 0 ? 0 : 1);
    return check(p->collocated_list == 1 ? 0 : 1);
}

static int temporal_mv(Ctx &c, int x0, int y0, int w, int h, int ref_idx_lx,
                       int X, int32_t out[2]) {
    const SliceParams *p = c.p;
    if (!p->has_collocated) return 0;

    auto try_pos = [&](int x, int y) -> int {
        int x4 = x >> 2, y4 = y >> 2;
        int64_t base = (int64_t)y4 * c.w4 + x4;
        MvField t;
        t.pred = c.col_pred[base];
        for (int l = 0; l < 2; l++) {
            t.mv[l][0] = c.col_mv[base * 4 + l * 2 + 0];
            t.mv[l][1] = c.col_mv[base * 4 + l * 2 + 1];
            t.poc[l] = c.col_poc_arr[base * 2 + l];
            t.ref_idx[l] = c.col_refidx[base * 2 + l];
        }
        return derive_temporal_mv(c, t, ref_idx_lx, X, out);
    };

    int x = x0 + w, y = y0 + h;
    if ((y0 >> p->log2_ctb) == (y >> p->log2_ctb) && y < p->height &&
        x < p->width) {
        if (try_pos((x >> 4) << 4, (y >> 4) << 4)) return 1;
    }
    x = x0 + (w >> 1);
    y = y0 + (h >> 1);
    return try_pos((x >> 4) << 4, (y >> 4) << 4);
}

static inline int is_diff_mer(Ctx &c, int xn, int yn, int xp, int yp) {
    int pl = c.p->log2_parallel_merge_level;
    return (xn >> pl) == (xp >> pl) && (yn >> pl) == (yp >> pl);
}

// combined bi-pred candidate order
static const int L0L1[12][2] = {{0,1},{1,0},{0,2},{2,0},{1,2},{2,1},
                                {0,3},{3,0},{1,3},{3,1},{2,3},{3,2}};

struct CuInfo {
    int x0, y0, log2, part_mode, pred_mode, tq_bypass, skip, intra_split;
    int rqt_root_cbf, merge_flag0, pcm;
    int intra_modes[4], intra_mode_c, chroma_mode;
    int intra_modes_c[4];   // 4:4:4 NxN: per-partition (hevc.c:2286)
    int chroma_modes[4];    // chroma-mode SYNTAX values (4 = DM)
};

// spec 8.5.3.1.2 spatial merge candidates -> list (up to max_num_merge_cand)
static MvField merge_mode(Ctx &c, CuInfo &cu, int x0, int y0, int w, int h,
                          int log2_cb, int part_idx, int merge_idx) {
    const SliceParams *p = c.p;
    int w2 = w, h2 = h;
    int single_mcl = 0;
    if (p->log2_parallel_merge_level > 2 && (1 << log2_cb) == 8) {
        single_mcl = 1;
        x0 = cu.x0; y0 = cu.y0; w = h = 1 << log2_cb; part_idx = 0;
    }
    Avail na = neighbour_avail(c, x0, y0, w, h);
    int mask = (1 << p->log2_ctb) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    int ur_sap = ((x0b + w) == (1 << p->log2_ctb))
                     ? (c.ctb_upright && !y0b) : na.u;

    MvField cands[5];
    int nc = 0;
    int nb_refs = p->slice_type == 1 ? p->num_ref_idx0
                  : (p->num_ref_idx0 < p->num_ref_idx1 ? p->num_ref_idx0
                                                        : p->num_ref_idx1);
    int xA1 = x0 - 1, yA1 = y0 + h - 1;
    int xB1 = x0 + w - 1, yB1 = y0 - 1;
    int xB0 = x0 + w, yB0 = y0 - 1;
    int xA0 = x0 - 1, yA0 = y0 + h;
    int xB2 = x0 - 1, yB2 = y0 - 1;

    MvField a1, b1;
    int has_a1 = 0, has_b1 = 0;
    int pm = cu.part_mode;
    // A1
    if (!((!single_mcl && part_idx == 1 && (pm == 2 || pm == 6 || pm == 7)) ||
          is_diff_mer(c, xA1, yA1, x0, y0))) {
        if (na.l && c.mvf_pred[(int64_t)(yA1 >> 2) * c.w4 + (xA1 >> 2)] != 0) {
            a1 = mvf_at(c, xA1 >> 2, yA1 >> 2);
            has_a1 = 1;
            cands[nc] = a1;
            if (merge_idx == nc) goto done;
            nc++;
        }
    }
    // B1
    if (!((!single_mcl && part_idx == 1 && (pm == 1 || pm == 4 || pm == 5)) ||
          is_diff_mer(c, xB1, yB1, x0, y0))) {
        if (na.u && c.mvf_pred[(int64_t)(yB1 >> 2) * c.w4 + (xB1 >> 2)] != 0) {
            b1 = mvf_at(c, xB1 >> 2, yB1 >> 2);
            has_b1 = 1;
            if (!(has_a1 && compare_mv_ref(b1, a1))) {
                cands[nc] = b1;
                if (merge_idx == nc) goto done;
                nc++;
            }
        }
    }
    // B0
    if (ur_sap && xB0 < p->width && z_scan_avail(c, x0, y0, xB0, yB0) &&
        !is_diff_mer(c, xB0, yB0, x0, y0) &&
        c.mvf_pred[(int64_t)(yB0 >> 2) * c.w4 + (xB0 >> 2)] != 0) {
        MvField b0 = mvf_at(c, xB0 >> 2, yB0 >> 2);
        if (!(has_b1 && compare_mv_ref(b0, b1))) {
            cands[nc] = b0;
            if (merge_idx == nc) goto done;
            nc++;
        }
    }
    // A0
    if (na.bl && yA0 < p->height && z_scan_avail(c, x0, y0, xA0, yA0) &&
        !is_diff_mer(c, xA0, yA0, x0, y0) &&
        c.mvf_pred[(int64_t)(yA0 >> 2) * c.w4 + (xA0 >> 2)] != 0) {
        MvField a0 = mvf_at(c, xA0 >> 2, yA0 >> 2);
        if (!(has_a1 && compare_mv_ref(a0, a1))) {
            cands[nc] = a0;
            if (merge_idx == nc) goto done;
            nc++;
        }
    }
    // B2
    if (na.ul && !is_diff_mer(c, xB2, yB2, x0, y0) && nc != 4 &&
        c.mvf_pred[(int64_t)(yB2 >> 2) * c.w4 + (xB2 >> 2)] != 0) {
        MvField b2 = mvf_at(c, xB2 >> 2, yB2 >> 2);
        if (!((has_a1 && compare_mv_ref(b2, a1)) ||
              (has_b1 && compare_mv_ref(b2, b1)))) {
            cands[nc] = b2;
            if (merge_idx == nc) goto done;
            nc++;
        }
    }
    // temporal
    if (p->sh_tmvp_enabled && nc < p->max_num_merge_cand) {
        int32_t mv0[2], mv1[2];
        int av0 = temporal_mv(c, x0, y0, w, h, 0, 0, mv0);
        int av1 = p->slice_type == 0 ? temporal_mv(c, x0, y0, w, h, 0, 1, mv1)
                                     : 0;
        if (av0 || av1) {
            MvField f;
            memset(&f, 0, sizeof(f));
            f.pred = (av0 ? 1 : 0) + (av1 ? 2 : 0);
            if (av0) {
                f.mv[0][0] = mv0[0]; f.mv[0][1] = mv0[1];
                f.ref_idx[0] = 0; f.poc[0] = c.rpl0[0];
            }
            if (av1) {
                f.mv[1][0] = mv1[0]; f.mv[1][1] = mv1[1];
                f.ref_idx[1] = 0; f.poc[1] = c.rpl1[0];
            }
            cands[nc] = f;
            if (merge_idx == nc) goto done;
            nc++;
        }
    }
    {
        // combined bi-pred
        int nb_orig = nc;
        if (p->slice_type == 0 && nb_orig > 1 &&
            nb_orig < p->max_num_merge_cand) {
            for (int ci = 0; ci < nb_orig * (nb_orig - 1) &&
                             nc < p->max_num_merge_cand; ci++) {
                MvField &l0c = cands[L0L1[ci][0]];
                MvField &l1c = cands[L0L1[ci][1]];
                if ((l0c.pred & 1) && (l1c.pred & 2) &&
                    (l0c.poc[0] != l1c.poc[1] ||
                     l0c.mv[0][0] != l1c.mv[1][0] ||
                     l0c.mv[0][1] != l1c.mv[1][1])) {
                    MvField f;
                    memset(&f, 0, sizeof(f));
                    f.pred = 3;
                    f.mv[0][0] = l0c.mv[0][0]; f.mv[0][1] = l0c.mv[0][1];
                    f.mv[1][0] = l1c.mv[1][0]; f.mv[1][1] = l1c.mv[1][1];
                    f.poc[0] = l0c.poc[0]; f.poc[1] = l1c.poc[1];
                    f.ref_idx[0] = l0c.ref_idx[0]; f.ref_idx[1] = l1c.ref_idx[1];
                    cands[nc] = f;
                    if (merge_idx == nc) goto done;
                    nc++;
                }
            }
        }
        // zero candidates
        int zero_idx = 0;
        while (nc < p->max_num_merge_cand) {
            MvField f;
            memset(&f, 0, sizeof(f));
            f.pred = 1 + (p->slice_type == 0 ? 2 : 0);
            int ri = zero_idx < nb_refs ? zero_idx : 0;
            f.ref_idx[0] = ri; f.ref_idx[1] = ri;
            f.poc[0] = p->num_ref_idx0 ? c.rpl0[ri] : 0;
            f.poc[1] = p->num_ref_idx1 ? c.rpl1[ri] : 0;
            cands[nc] = f;
            if (merge_idx == nc) goto done;
            nc++;
            zero_idx++;
        }
    }
done:
    MvField mv = cands[merge_idx];
    if (mv.pred == 3 && (w2 + h2) == 12) mv.pred = 1;
    return mv;
}

// AMVP (hevc_mvs.c:623)
static void mvp_mode(Ctx &c, int x0, int y0, int w, int h, MvField &mv,
                     int mvp_flag, int LX, int32_t out[2]) {
    const SliceParams *p = c.p;
    Avail na = neighbour_avail(c, x0, y0, w, h);
    int mask = (1 << p->log2_ctb) - 1;
    int x0b = x0 & mask, y0b = y0 & mask;
    int ur_sap = ((x0b + w) == (1 << p->log2_ctb))
                     ? (c.ctb_upright && !y0b) : na.u;
    int ref_idx = mv.ref_idx[LX];
    int pf0 = LX, pf1 = 1 - LX;
    const int32_t *rplx = LX == 0 ? c.rpl0 : c.rpl1;
    int target_poc = rplx[ref_idx];
    int target_lt = p->rpl_lt[LX][ref_idx];

    auto mp_mx = [&](const MvField &f, int idx, int32_t o[2]) -> int {
        if ((f.pred & (1 << idx)) && f.poc[idx] == target_poc) {
            o[0] = f.mv[idx][0]; o[1] = f.mv[idx][1];
            return 1;
        }
        return 0;
    };
    auto mp_mx_lt = [&](const MvField &f, int idx, int32_t o[2]) -> int {
        if (f.pred & (1 << idx)) {
            int cand_lt = p->rpl_lt[idx][f.ref_idx[idx]];
            if (cand_lt != target_lt) return 0;   // mv_mp_mode_mx_lt
            o[0] = f.mv[idx][0]; o[1] = f.mv[idx][1];
            int ref_poc_e = f.poc[idx];
            if (!target_lt && ref_poc_e != target_poc) {
                int td = p->cur_poc - ref_poc_e;
                if (td == 0) td = 1;
                int32_t tmp[2] = {o[0], o[1]};
                mv_scale(o, tmp, td, p->cur_poc - target_poc);
            }
            return 1;
        }
        return 0;
    };

    int xA0 = x0 - 1, yA0 = y0 + h;
    int xA1 = x0 - 1, yA1 = y0 + h - 1;
    int is_a0 = na.bl && yA0 < p->height && z_scan_avail(c, x0, y0, xA0, yA0) &&
                c.mvf_pred[(int64_t)(yA0 >> 2) * c.w4 + (xA0 >> 2)] != 0;
    int is_a1 = na.l &&
                c.mvf_pred[(int64_t)(yA1 >> 2) * c.w4 + (xA1 >> 2)] != 0;
    int is_scaled = is_a0 || is_a1;

    int32_t mxA[2];
    int hasA = 0;
    for (int pass = 0; pass < 2 && !hasA; pass++) {
        for (int cand = 0; cand < 2 && !hasA; cand++) {
            int avail = cand == 0 ? is_a0 : is_a1;
            if (!avail) continue;
            MvField f = mvf_at(c, (cand == 0 ? xA0 : xA1) >> 2,
                               (cand == 0 ? yA0 : yA1) >> 2);
            if (pass == 0) {
                hasA = mp_mx(f, pf0, mxA);
                if (!hasA) hasA = mp_mx(f, pf1, mxA);
            } else {
                hasA = mp_mx_lt(f, pf0, mxA);
                if (!hasA) hasA = mp_mx_lt(f, pf1, mxA);
            }
        }
    }
    if (hasA && !mvp_flag) { out[0] = mxA[0]; out[1] = mxA[1]; return; }

    int xB0 = x0 + w, yB0 = y0 - 1;
    int xB1 = x0 + w - 1, yB1 = y0 - 1;
    int xB2 = x0 - 1, yB2 = y0 - 1;
    int is_b0 = ur_sap && xB0 < p->width && z_scan_avail(c, x0, y0, xB0, yB0) &&
                c.mvf_pred[(int64_t)(yB0 >> 2) * c.w4 + (xB0 >> 2)] != 0;
    int is_b1 = na.u &&
                c.mvf_pred[(int64_t)(yB1 >> 2) * c.w4 + (xB1 >> 2)] != 0;
    int is_b2 = na.ul &&
                c.mvf_pred[(int64_t)(yB2 >> 2) * c.w4 + (xB2 >> 2)] != 0;

    int bx[3] = {xB0, xB1, xB2}, by[3] = {yB0, yB1, yB2};
    int bav[3] = {is_b0, is_b1, is_b2};
    int32_t mxB[2];
    int hasB = 0;
    for (int cand = 0; cand < 3 && !hasB; cand++) {
        if (!bav[cand]) continue;
        MvField f = mvf_at(c, bx[cand] >> 2, by[cand] >> 2);
        hasB = mp_mx(f, pf0, mxB);
        if (!hasB) hasB = mp_mx(f, pf1, mxB);
    }
    if (!is_scaled) {
        if (hasB) { mxA[0] = mxB[0]; mxA[1] = mxB[1]; hasA = 1; }
        hasB = 0;
        for (int cand = 0; cand < 3 && !hasB; cand++) {
            if (!bav[cand]) continue;
            MvField f = mvf_at(c, bx[cand] >> 2, by[cand] >> 2);
            hasB = mp_mx_lt(f, pf0, mxB);
            if (!hasB) hasB = mp_mx_lt(f, pf1, mxB);
        }
    }

    int32_t list[2][2];
    int nl = 0;
    if (hasA) { list[nl][0] = mxA[0]; list[nl][1] = mxA[1]; nl++; }
    if (hasB && (!hasA || mxA[0] != mxB[0] || mxA[1] != mxB[1])) {
        list[nl][0] = mxB[0]; list[nl][1] = mxB[1]; nl++;
    }
    if (nl < 2 && p->sh_tmvp_enabled && mvp_flag == nl) {
        int32_t mvc[2];
        if (temporal_mv(c, x0, y0, w, h, ref_idx, LX, mvc)) {
            list[nl][0] = mvc[0]; list[nl][1] = mvc[1]; nl++;
        }
    }
    while (nl < 2) { list[nl][0] = 0; list[nl][1] = 0; nl++; }
    out[0] = list[mvp_flag][0];
    out[1] = list[mvp_flag][1];
}

// ---------------------------------------------------------------------------
// PU syntax
// ---------------------------------------------------------------------------

static int code_merge_idx(Ctx &c) {
    int i = c.cc.decode_bin(CTX_MERGE_IDX);
    if (i) {
        while (i < c.p->max_num_merge_cand - 1 && c.cc.bypass()) i++;
    }
    return i;
}

static int code_ref_idx(Ctx &c, int nb_refs) {
    int maxv = nb_refs - 1;
    int max_ctx = maxv < 2 ? maxv : 2;
    int i = 0;
    while (i < max_ctx && c.cc.decode_bin(CTX_REF_IDX_L0 + i)) i++;
    if (i == 2) {
        while (i < maxv && c.cc.bypass()) i++;
    }
    return i;
}

static int decode_mvd_value(Ctx &c, int g) {
    if (g == 0) return 0;
    if (g == 1) return c.cc.bypass() ? -1 : 1;
    int ret = 2, k = 1;
    bool stopped = false;
    while (k < 31 && !stopped) {
        int n = 31 - k; if (n > 12) n = 12;
        int ones = c.cc.bypass_unary(n, &stopped);
        for (int i = 0; i < ones; i++) { ret += 1 << k; k++; }
    }
    ret += c.cc.bypass_bits(k);
    return c.cc.bypass() ? -ret : ret;
}

static void code_mvd(Ctx &c, int mvd[2]) {
    int gx = c.cc.decode_bin(CTX_ABS_MVD_GREATER0_FLAG);
    int gy = c.cc.decode_bin(CTX_ABS_MVD_GREATER0_FLAG);
    if (gx) gx += c.cc.decode_bin(CTX_ABS_MVD_GREATER1_FLAG + 1);
    if (gy) gy += c.cc.decode_bin(CTX_ABS_MVD_GREATER1_FLAG + 1);
    mvd[0] = decode_mvd_value(c, gx);
    mvd[1] = decode_mvd_value(c, gy);
}

static void emit_inter_op(Ctx &c, int x0, int y0, int w, int h,
                          const MvField &f) {
    const SliceParams *p = c.p;
    store_mvf(c, x0, y0, w, h, f);
    emit(c, 3); emit(c, x0); emit(c, y0); emit(c, w); emit(c, h);
    emit(c, f.pred);
    emit(c, f.poc[0]); emit(c, f.mv[0][0]); emit(c, f.mv[0][1]);
    emit(c, f.poc[1]); emit(c, f.mv[1][0]); emit(c, f.mv[1][1]);
    if (p->has_wp) {
        emit(c, p->wp_denom_y); emit(c, p->wp_denom_c);
        for (int lst = 0; lst < 2; lst++) {
            int use = f.pred & (1 << lst);
            int ri = f.ref_idx[lst];
            for (int comp = 0; comp < 3; comp++) {
                int d = comp == 0 ? p->wp_denom_y : p->wp_denom_c;
                if (use) {
                    emit(c, p->wp_w[lst][ri][comp]);
                    emit(c, p->wp_o[lst][ri][comp]);
                } else {
                    emit(c, 1 << d); emit(c, 0);
                }
            }
        }
    }
}

static void code_prediction_unit(Ctx &c, CuInfo &cu, int x0, int y0, int w,
                                 int h, int log2_cb, int part_idx,
                                 int is_skip) {
    const SliceParams *p = c.p;
    Cabac &cc = c.cc;
    if (is_skip) {
        int merge_idx = 0;
        if (p->max_num_merge_cand > 1) merge_idx = code_merge_idx(c);
        MvField f = merge_mode(c, cu, x0, y0, w, h, log2_cb, part_idx,
                               merge_idx);
        emit_inter_op(c, x0, y0, w, h, f);
        return;
    }
    int merge_flag = cc.decode_bin(CTX_MERGE_FLAG);
    if (part_idx == 0) cu.merge_flag0 = merge_flag;
    if (merge_flag) {
        int merge_idx = 0;
        if (p->max_num_merge_cand > 1) merge_idx = code_merge_idx(c);
        MvField f = merge_mode(c, cu, x0, y0, w, h, log2_cb, part_idx,
                               merge_idx);
        emit_inter_op(c, x0, y0, w, h, f);
        return;
    }
    MvField f;
    memset(&f, 0, sizeof(f));
    int inter_pred_idc = 0;      // PRED_L0
    if (p->slice_type == 0) {
        if (w + h == 12) {
            inter_pred_idc = cc.decode_bin(CTX_INTER_PRED_IDC + 4) ? 1 : 0;
        } else {
            if (cc.decode_bin(CTX_INTER_PRED_IDC + c.ct_depth_cur))
                inter_pred_idc = 2;
            else
                inter_pred_idc = cc.decode_bin(CTX_INTER_PRED_IDC + 4) ? 1 : 0;
        }
    }
    if (inter_pred_idc != 1) {   // uses L0
        int ri = 0;
        if (p->num_ref_idx0 > 1) ri = code_ref_idx(c, p->num_ref_idx0);
        f.ref_idx[0] = ri;
        f.pred = 1;
        int mvd[2];
        code_mvd(c, mvd);
        int mvp_flag = cc.decode_bin(CTX_MVP_LX_FLAG);
        int32_t mvp[2];
        mvp_mode(c, x0, y0, w, h, f, mvp_flag, 0, mvp);
        f.mv[0][0] = clip16i((int64_t)mvp[0] + mvd[0]);
        f.mv[0][1] = clip16i((int64_t)mvp[1] + mvd[1]);
        f.poc[0] = c.rpl0[ri];
    }
    if (inter_pred_idc != 0) {   // uses L1
        int ri = 0;
        if (p->num_ref_idx1 > 1) ri = code_ref_idx(c, p->num_ref_idx1);
        f.ref_idx[1] = ri;
        int mvd[2] = {0, 0};
        if (!(p->mvd_l1_zero && inter_pred_idc == 2)) code_mvd(c, mvd);
        f.pred += 2;
        int mvp_flag = cc.decode_bin(CTX_MVP_LX_FLAG);
        int32_t mvp[2];
        mvp_mode(c, x0, y0, w, h, f, mvp_flag, 1, mvp);
        f.mv[1][0] = clip16i((int64_t)mvp[0] + mvd[0]);
        f.mv[1][1] = clip16i((int64_t)mvp[1] + mvd[1]);
        f.poc[1] = c.rpl1[ri];
    }
    emit_inter_op(c, x0, y0, w, h, f);
}

// part geometry in quarters of the CB (syntax/pu.py _PART_GEOM)
static const int PART_GEOM[8][4][4] = {
    {{0,0,4,4}},
    {{0,0,4,2},{0,2,4,2}},
    {{0,0,2,4},{2,0,2,4}},
    {{0,0,2,2},{2,0,2,2},{0,2,2,2},{2,2,2,2}},
    {{0,0,4,1},{0,1,4,3}},
    {{0,0,4,3},{0,3,4,1}},
    {{0,0,1,4},{1,0,3,4}},
    {{0,0,3,4},{3,0,1,4}},
};
static const int PART_COUNT[8] = {1,2,2,4,2,2,2,2};

// ---------------------------------------------------------------------------
// deblock boundary strengths (syntax/ctu.py compute_bs; hevc_filter.c:805)
// ---------------------------------------------------------------------------

static int boundary_strength(Ctx &c, int xq4, int yq4, int xp4, int yp4) {
    MvField q = mvf_at(c, xq4, yq4);
    MvField pp = mvf_at(c, xp4, yp4);
    auto big = [](const int32_t a[2], const int32_t b[2]) {
        int dx = a[0] - b[0], dy = a[1] - b[1];
        if (dx < 0) dx = -dx;
        if (dy < 0) dy = -dy;
        return dx >= 4 || dy >= 4;
    };
    if (q.pred == 3 && pp.pred == 3) {
        if (q.poc[0] == pp.poc[0] && q.poc[0] == q.poc[1] &&
            pp.poc[0] == pp.poc[1]) {
            if ((big(pp.mv[0], q.mv[0]) || big(pp.mv[1], q.mv[1])) &&
                (big(pp.mv[1], q.mv[0]) || big(pp.mv[0], q.mv[1])))
                return 1;
            return 0;
        }
        if (pp.poc[0] == q.poc[0] && pp.poc[1] == q.poc[1])
            return (big(pp.mv[0], q.mv[0]) || big(pp.mv[1], q.mv[1])) ? 1 : 0;
        if (pp.poc[1] == q.poc[0] && pp.poc[0] == q.poc[1])
            return (big(pp.mv[1], q.mv[0]) || big(pp.mv[0], q.mv[1])) ? 1 : 0;
        return 1;
    }
    if (q.pred != 3 && pp.pred != 3) {
        const int32_t *a = (q.pred & 1) ? q.mv[0] : q.mv[1];
        int ref_a = (q.pred & 1) ? q.poc[0] : q.poc[1];
        const int32_t *b = (pp.pred & 1) ? pp.mv[0] : pp.mv[1];
        int ref_b = (pp.pred & 1) ? pp.poc[0] : pp.poc[1];
        if (ref_a == ref_b) return big(a, b) ? 1 : 0;
        return 1;
    }
    return 1;
}

static void compute_bs(Ctx &c, int x0, int y0, int log2n) {
    const SliceParams *p = c.p;
    // per-slice deblock disable: no BS derivation (hevc.c:1577)
    if (p->deblocking_disabled)
        return;
    int size = 1 << log2n;
    int is_intra_cu = c.mvf_pred[(int64_t)(y0 >> 2) * c.w4 + (x0 >> 2)] == 0;
    int ctb_mask = (1 << p->log2_ctb) - 1;
    int lmt = p->log2_min_tb;
    int mtw = p->mtb_w;

    if (y0 > 0 && (y0 & 7) == 0) {
        int bd_ctby = y0 & ctb_mask;
        int bd_slice = p->loop_filter_across_slices || !(c.boundary_up & 1);
        int bd_tiles = p->loop_filter_across_tiles || !(c.boundary_up & 2);
        if ((bd_slice && bd_tiles) || bd_ctby) {
            int yp4 = (y0 - 1) >> 2, yq4 = y0 >> 2;
            int yp_t = (y0 - 1) >> lmt, yq_t = y0 >> lmt;
            for (int i = 0; i < size; i += 4) {
                int x4 = (x0 + i) >> 2;
                int xt = (x0 + i) >> lmt;
                int bs;
                if (c.mvf_pred[(int64_t)yq4 * c.w4 + x4] == 0 ||
                    c.mvf_pred[(int64_t)yp4 * c.w4 + x4] == 0) bs = 2;
                else if (c.cbf_luma[yq_t * mtw + xt] ||
                         c.cbf_luma[yp_t * mtw + xt]) bs = 1;
                else bs = boundary_strength(c, x4, yq4, x4, yp4);
                c.hbs[(int64_t)(y0 >> 3) * c.w4 + x4] = bs;
            }
        }
    }
    if (x0 > 0 && (x0 & 7) == 0) {
        int bd_ctbx = x0 & ctb_mask;
        int bd_slice = p->loop_filter_across_slices || !(c.boundary_left & 1);
        int bd_tiles = p->loop_filter_across_tiles || !(c.boundary_left & 2);
        if ((bd_slice && bd_tiles) || bd_ctbx) {
            int xp4 = (x0 - 1) >> 2, xq4 = x0 >> 2;
            int xp_t = (x0 - 1) >> lmt, xq_t = x0 >> lmt;
            for (int i = 0; i < size; i += 4) {
                int y4 = (y0 + i) >> 2;
                int yt = (y0 + i) >> lmt;
                int bs;
                if (c.mvf_pred[(int64_t)y4 * c.w4 + xq4] == 0 ||
                    c.mvf_pred[(int64_t)y4 * c.w4 + xp4] == 0) bs = 2;
                else if (c.cbf_luma[yt * mtw + xq_t] ||
                         c.cbf_luma[yt * mtw + xp_t]) bs = 1;
                else bs = boundary_strength(c, xq4, y4, xp4, y4);
                c.vbs[(int64_t)y4 * c.w8 + (x0 >> 3)] = bs;
            }
        }
    }
    if (log2n > 2 && !is_intra_cu) {
        for (int i = 0; i < size; i += 4) {
            int x4 = (x0 + i) >> 2;
            int yp4 = (y0 + 8 - 1) >> 2;
            for (int j = 8; j < size; j += 8) {
                int yq4 = (y0 + j) >> 2;
                c.hbs[(int64_t)((y0 + j) >> 3) * c.w4 + x4] =
                    boundary_strength(c, x4, yq4, x4, yp4);
                yp4 = yq4;
            }
        }
        for (int j = 0; j < size; j += 4) {
            int y4 = (y0 + j) >> 2;
            int xp4 = (x0 + 8 - 1) >> 2;
            for (int i = 8; i < size; i += 8) {
                int xq4 = (x0 + i) >> 2;
                c.vbs[(int64_t)y4 * c.w8 + ((x0 + i) >> 3)] =
                    boundary_strength(c, xq4, y4, xp4, y4);
                xp4 = xq4;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// intra prediction info (MPM) + op emission
// ---------------------------------------------------------------------------

static const int INTRA_CHROMA_TABLE[4] = {0, 26, 10, 1};

static void mpm_candidates(Ctx &c, int x0, int y0, int cands[3]) {
    const SliceParams *p = c.p;
    int x_pu = x0 >> 2, y_pu = y0 >> 2;
    int mask = (1 << p->log2_ctb) - 1;
    int cand_up = (c.ctb_up || (y0 & mask))
                      ? c.tab_ipm[(int64_t)(y_pu - 1) * c.w4 + x_pu] : 1;
    int cand_left = (c.ctb_left || (x0 & mask))
                        ? c.tab_ipm[(int64_t)y_pu * c.w4 + (x_pu - 1)] : 1;
    int y_ctb = (y0 >> p->log2_ctb) << p->log2_ctb;
    if (y0 - 1 < y_ctb) cand_up = 1;
    if (cand_left == cand_up) {
        if (cand_left < 2) {
            cands[0] = 0; cands[1] = 1; cands[2] = 26;
        } else {
            cands[0] = cand_left;
            cands[1] = 2 + ((cand_left - 2 - 1 + 32) & 31);
            cands[2] = 2 + ((cand_left - 2 + 1) & 31);
        }
    } else {
        cands[0] = cand_left;
        cands[1] = cand_up;
        if (cand_left != 0 && cand_up != 0) cands[2] = 0;
        else if (cand_left != 1 && cand_up != 1) cands[2] = 1;
        else cands[2] = 26;
    }
}

static void emit_intra_op(Ctx &c, int x0, int y0, int log2n, int c_idx,
                          int mode, int w_luma, int h_luma) {
    const SliceParams *p = c.p;
    Avail na = neighbour_avail(c, x0, y0, w_luma, h_luma);
    int fl[5];
    intra_avail(c, x0, y0, log2n, c_idx, na, fl);
    int hs = (c_idx && p->chroma_format_idc != 3) ? 1 : 0;
    int vs = (c_idx && p->chroma_format_idc == 1) ? 1 : 0;
    emit(c, 1); emit(c, c_idx); emit(c, x0 >> hs); emit(c, y0 >> vs);
    emit(c, 1 << log2n); emit(c, mode);
    emit(c, fl[0]); emit(c, fl[1]); emit(c, fl[2]); emit(c, fl[3]);
    emit(c, fl[4]);
}

// scaling-list matrix id packed into the kind field at bit 3 (mid+1)
// (syntax/ctu.py _scaling_mid; reference hevc_cabac.c:1484-1494)
static inline int pack_mid(const SliceParams *p, int pred_mode, int c_idx,
                           int tq_bypass, int tskip, int log2n, int kind) {
    if (!p->scaling_list_enabled || tq_bypass || (tskip && log2n > 2))
        return kind;
    int mid = 3 * (pred_mode == 1 ? 0 : 1) + c_idx;
    return kind | ((mid + 1) << 3);
}

static void emit_resid_op(Ctx &c, int c_idx, int x, int y, int log2n, int qp,
                          int kind, const int32_t *lv, int rot = 0,
                          int rdir = -1, int alpha = 0) {
    int n = 1 << log2n;
    // rext word: bits 0-1 rdpcm_dir+1, bit 2 rotation, bits 8-13 alpha+16
    int rext = (rdir + 1) | (rot ? 4 : 0) | ((alpha + 16) << 8);
    emit(c, 2); emit(c, c_idx); emit(c, x); emit(c, y); emit(c, log2n);
    emit(c, qp); emit(c, kind); emit(c, (int32_t)(c.lv_base + c.lv_pos));
    emit(c, rext);
    if (c.lv_pos + n * n <= c.lv_cap)
        memcpy(c.levels + c.lv_pos, lv, sizeof(int32_t) * n * n);
    c.lv_pos += n * n;
}

// ---------------------------------------------------------------------------
// transform tree / unit (syntax/ctu.py)
// ---------------------------------------------------------------------------

static int get_qpy_pred(Ctx &c, int x_base, int y_base) {
    const SliceParams *p = c.p;
    int ctb_mask = (1 << p->log2_ctb) - 1;
    int qg_mask = (1 << (p->log2_ctb - p->diff_cu_qp_delta_depth)) - 1;
    int xqg = x_base - (x_base & qg_mask);
    int yqg = y_base - (y_base & qg_mask);
    int x_cb = xqg >> p->log2_min_cb;
    int y_cb = yqg >> p->log2_min_cb;
    int avail_a = (x_base & ctb_mask) && (xqg & ctb_mask);
    int avail_b = (y_base & ctb_mask) && (yqg & ctb_mask);
    int pred;
    if (c.first_qp_group || (!xqg && !yqg)) {
        c.first_qp_group = !c.is_cu_qp_delta_coded;
        pred = p->slice_qp;
    } else pred = c.qp_y_pred;
    int qp_a = avail_a ? c.qp_y_tab[(int64_t)y_cb * c.min_cb_w + x_cb - 1] : pred;
    int qp_b = avail_b ? c.qp_y_tab[(int64_t)(y_cb - 1) * c.min_cb_w + x_cb] : pred;
    return (qp_a + qp_b + 1) >> 1;
}

static void set_qpy(Ctx &c, int x_base, int y_base, int delta) {
    int pred = get_qpy_pred(c, x_base, y_base);
    int off = c.p->qp_bd_offset;
    if (delta) {
        int m = 52 + off;
        int v = (pred + delta + 52 + 2 * off) % m;
        c.qp_y = v - off;
    } else c.qp_y = pred;
}

static void decode_cu_qp_delta(Ctx &c, CuInfo &cu) {
    Cabac &cc = c.cc;
    int prefix = 0;
    int inc = 0;
    while (prefix < 5 && cc.decode_bin(CTX_CU_QP_DELTA + inc)) {
        prefix++;
        inc = 1;
    }
    int val;
    if (prefix >= 5) {
        int k = 0;
        bool stopped = false;
        while (k < 31 && !stopped) {
            int n = 31 - k; if (n > 12) n = 12;
            k += cc.bypass_unary(n, &stopped);
        }
        val = (1 << k) + 4 + (int)cc.bypass_bits(k);
    } else val = prefix;
    if (val && cc.bypass()) val = -val;
    c.cu_qp_delta = val;
    c.is_cu_qp_delta_coded = 1;
    set_qpy(c, c.cur_cu_x0, c.cur_cu_y0, val);
}

static void code_transform_unit(Ctx &c, CuInfo &cu, int x0, int y0,
                                int x_base, int y_base, int log2_tt,
                                int depth, int blk_idx, int cbf_luma,
                                const int cbf_cb[2], const int cbf_cr[2],
                                int cur_mode, int cur_mode_c, int cur_cm_c) {
    const SliceParams *p = c.p;
    int hs1 = p->chroma_format_idc != 3 ? 1 : 0;
    int vs1 = p->chroma_format_idc == 1 ? 1 : 0;
    int log2_tt_c = log2_tt - hs1;
    int size = 1 << log2_tt;
    int mode = cur_mode;
    int mode_c = cur_mode_c;
    // 4:2:2 codes two stacked square chroma TUs (hevc.c:1302-1363)
    int nblk_c = p->chroma_format_idc == 2 ? 2 : 1;
    int32_t lv[32 * 32];

    if (cu.pred_mode == 1)   // intra luma pred
        emit_intra_op(c, x0, y0, log2_tt, 0, mode, size, size);

    int any_cbf = cbf_luma || cbf_cb[0] || cbf_cr[0] ||
        (p->chroma_format_idc == 2 && (cbf_cb[1] || cbf_cr[1]));

    int scan_idx = 0, scan_idx_c = 0;
    if (cu.pred_mode == 1 && log2_tt < 4) {
        if (mode >= 6 && mode <= 14) scan_idx = 2;
        else if (mode >= 22 && mode <= 30) scan_idx = 1;
        if (mode_c >= 6 && mode_c <= 14) scan_idx_c = 2;
        else if (mode_c >= 22 && mode_c <= 30) scan_idx_c = 1;
    }

    if (any_cbf) {
        if (p->cu_qp_delta_enabled && !c.is_cu_qp_delta_coded)
            decode_cu_qp_delta(c, cu);
        // cu_chroma_qp_offset_flag/_idx once per chroma-QP group
        // (hevc.c:1247-1263; idx unary on one ctx, hevc_cabac.c:766-774)
        int cbf_chroma = cbf_cb[0] || cbf_cr[0] ||
            (p->chroma_format_idc == 2 && (cbf_cb[1] || cbf_cr[1]));
        if (p->cu_chroma_qp_offset_enabled && cbf_chroma &&
            !cu.tq_bypass && !c.is_cu_chroma_qp_offset_coded) {
            if (c.cc.decode_bin(CTX_CU_CHROMA_QP_OFFSET_FLAG)) {
                int idx = 0;
                if (p->chroma_qp_offset_list_len > 1) {
                    // the reference's FFMAX(5, len-1) quirk
                    int c_max = p->chroma_qp_offset_list_len - 1;
                    if (c_max < 5) c_max = 5;
                    while (idx < c_max &&
                           c.cc.decode_bin(CTX_CU_CHROMA_QP_OFFSET_IDX))
                        idx++;
                }
                c.cu_qp_offset_cb = p->cb_qp_offset_list[idx];
                c.cu_qp_offset_cr = p->cr_qp_offset_list[idx];
            } else {
                c.cu_qp_offset_cb = 0;
                c.cu_qp_offset_cr = 0;
            }
            c.is_cu_chroma_qp_offset_coded = 1;
        }
        int qp_y = c.qp_y + p->qp_bd_offset;
        if (cbf_luma) {
            int rot, rdir;
            int tskip = decode_residual(c, 0, log2_tt, scan_idx,
                                        cu.tq_bypass, cu.pred_mode == 1,
                                        mode, lv, &rot, &rdir);
            int kind = cu.tq_bypass ? 3 : (tskip ? 2 :
                       (cu.pred_mode == 1 && log2_tt == 2 ? 1 : 0));
            kind = pack_mid(p, cu.pred_mode, 0, cu.tq_bypass, tskip,
                            log2_tt, kind);
            emit_resid_op(c, 0, x0, y0, log2_tt, qp_y, kind, lv, rot, rdir);
        }
        if (log2_tt > 2 || p->chroma_format_idc == 3) {
            int tsz_h = 1 << (log2_tt_c + hs1);
            int tsz_v = 1 << (log2_tt_c + vs1);
            // cross-component prediction (4:4:4 only; hevc.c:1295-1298);
            // the intra gate tests the chroma-mode SYNTAX value (4 = DM)
            int cross_pf = p->cross_component && cbf_luma &&
                           p->chroma_format_idc == 3 &&
                           (cu.pred_mode != 1 || cur_cm_c == 4);
            for (int ci = 1; ci <= 2; ci++) {
                const int *cbf = ci == 1 ? cbf_cb : cbf_cr;
                int alpha = 0;
                if (cross_pf) alpha = decode_cc_alpha(c, ci - 1);
                for (int i = 0; i < nblk_c; i++) {
                    int yb = y0 + (i << log2_tt_c);
                    if (cu.pred_mode == 1)
                        emit_intra_op(c, x0, yb, log2_tt_c, ci, mode_c,
                                      tsz_h, tsz_v);
                    if (cbf[i]) {
                        int rot, rdir;
                        int tskip = decode_residual(c, ci, log2_tt_c,
                                                    scan_idx_c,
                                                    cu.tq_bypass,
                                                    cu.pred_mode == 1,
                                                    mode_c, lv, &rot, &rdir);
                        int kind = cu.tq_bypass ? 3 : (tskip ? 2 : 0);
                        kind = pack_mid(p, cu.pred_mode, ci, cu.tq_bypass,
                                        tskip, log2_tt_c, kind);
                        emit_resid_op(c, ci, x0 >> hs1, yb >> vs1, log2_tt_c,
                                      chroma_qp(c, c.qp_y, ci), kind, lv,
                                      rot, rdir, alpha);
                    } else if (cross_pf && alpha) {
                        // scaled luma residual alone (hevc.c:1315-1330)
                        memset(lv, 0, sizeof(int32_t) << (2 * log2_tt_c));
                        emit_resid_op(c, ci, x0 >> hs1, yb >> vs1, log2_tt_c,
                                      chroma_qp(c, c.qp_y, ci), 0, lv,
                                      0, -1, alpha);
                    }
                }
            }
        } else if (blk_idx == 3) {
            int tsz_h = 1 << (log2_tt + 1);
            int tsz_v = 1 << (log2_tt + vs1);
            for (int ci = 1; ci <= 2; ci++) {
                const int *cbf = ci == 1 ? cbf_cb : cbf_cr;
                for (int i = 0; i < nblk_c; i++) {
                    int yb = y_base + (i << log2_tt);
                    if (cu.pred_mode == 1)
                        emit_intra_op(c, x_base, yb, log2_tt, ci, mode_c,
                                      tsz_h, tsz_v);
                    if (cbf[i]) {
                        int rot, rdir;
                        int tskip = decode_residual(c, ci, log2_tt,
                                                    scan_idx_c,
                                                    cu.tq_bypass,
                                                    cu.pred_mode == 1,
                                                    mode_c, lv, &rot, &rdir);
                        int kind = cu.tq_bypass ? 3 : (tskip ? 2 : 0);
                        kind = pack_mid(p, cu.pred_mode, ci, cu.tq_bypass,
                                        tskip, log2_tt, kind);
                        emit_resid_op(c, ci, x_base >> hs1, yb >> vs1,
                                      log2_tt, chroma_qp(c, c.qp_y, ci),
                                      kind, lv, rot, rdir);
                    }
                }
            }
        }
    } else if (cu.pred_mode == 1) {
        int nblk_c2 = p->chroma_format_idc == 2 ? 2 : 1;
        if (log2_tt > 2 || p->chroma_format_idc == 3) {
            int tsz_h = 1 << (log2_tt_c + hs1);
            int tsz_v = 1 << (log2_tt_c + vs1);
            for (int ci = 1; ci <= 2; ci++)
                for (int i = 0; i < nblk_c2; i++)
                    emit_intra_op(c, x0, y0 + (i << log2_tt_c), log2_tt_c,
                                  ci, mode_c, tsz_h, tsz_v);
        } else if (blk_idx == 3) {
            int tsz_h = 1 << (log2_tt + 1);
            int tsz_v = 1 << (log2_tt + vs1);
            for (int ci = 1; ci <= 2; ci++)
                for (int i = 0; i < nblk_c2; i++)
                    emit_intra_op(c, x_base, y_base + (i << log2_tt),
                                  log2_tt, ci, mode_c, tsz_h, tsz_v);
        }
    }
}

static void code_transform_tree(Ctx &c, CuInfo &cu, int x0, int y0,
                                int x_base, int y_base, int log2_tt,
                                int depth, int blk_idx,
                                const int pcb[2], const int pcr[2],
                                int max_depth, int cur_mode,
                                int cur_mode_c) {
    const SliceParams *p = c.p;
    Cabac &cc = c.cc;
    int cbf_cb[2] = {pcb[0], pcb[1]};
    int cbf_cr[2] = {pcr[0], pcr[1]};
    int cur_cm_c = cu.chroma_modes[0];
    if (cu.intra_split) {
        if (depth == 1) {
            cur_mode = cu.intra_modes[blk_idx];
            if (p->chroma_format_idc == 3) {
                cur_mode_c = cu.intra_modes_c[blk_idx];
                cur_cm_c = cu.chroma_modes[blk_idx];
            } else cur_mode_c = cu.intra_modes_c[0];
        }
    } else if (cu.pred_mode == 1) {
        cur_mode = cu.intra_modes[0];
        cur_mode_c = cu.intra_modes_c[0];
    } else {
        // inter CUs read the STALE lc->pu modes of the last intra CU
        // (hevc.c:1472-1474) — reachable via RExt bypass-RDPCM gates
        cur_mode = c.rext[4];
        cur_mode_c = c.rext[5];
    }

    int split;
    if (log2_tt <= p->log2_max_tb && log2_tt > p->log2_min_tb &&
        depth < max_depth && !(cu.intra_split && depth == 0)) {
        split = cc.decode_bin(CTX_SPLIT_TRANSFORM_FLAG + 5 - log2_tt);
    } else {
        int inter_split = p->max_tt_depth_inter == 0 && cu.pred_mode == 0 &&
                          cu.part_mode != 0 && depth == 0;
        split = log2_tt > p->log2_max_tb ||
                (cu.intra_split && depth == 0) || inter_split;
    }
    int two_chroma = p->chroma_format_idc == 2 && (!split || log2_tt == 3);
    if (log2_tt > 2 || p->chroma_format_idc == 3) {
        if (depth == 0 || pcb[0]) {
            cbf_cb[0] = cc.decode_bin(CTX_CBF_CB_CR + depth);
            if (two_chroma) cbf_cb[1] = cc.decode_bin(CTX_CBF_CB_CR + depth);
        }
        if (depth == 0 || pcr[0]) {
            cbf_cr[0] = cc.decode_bin(CTX_CBF_CB_CR + depth);
            if (two_chroma) cbf_cr[1] = cc.decode_bin(CTX_CBF_CB_CR + depth);
        }
    }
    if (split) {
        int half = 1 << (log2_tt - 1);
        code_transform_tree(c, cu, x0, y0, x0, y0, log2_tt - 1, depth + 1, 0,
                            cbf_cb, cbf_cr, max_depth, cur_mode, cur_mode_c);
        code_transform_tree(c, cu, x0 + half, y0, x0, y0, log2_tt - 1,
                            depth + 1, 1, cbf_cb, cbf_cr, max_depth, cur_mode,
                            cur_mode_c);
        code_transform_tree(c, cu, x0, y0 + half, x0, y0, log2_tt - 1,
                            depth + 1, 2, cbf_cb, cbf_cr, max_depth, cur_mode,
                            cur_mode_c);
        code_transform_tree(c, cu, x0 + half, y0 + half, x0, y0, log2_tt - 1,
                            depth + 1, 3, cbf_cb, cbf_cr, max_depth, cur_mode,
                            cur_mode_c);
        return;
    }
    int cbf_luma = 1;
    if (cu.pred_mode == 1 || depth != 0 || cbf_cb[0] || cbf_cr[0] ||
        (p->chroma_format_idc == 2 && (cbf_cb[1] || cbf_cr[1])))
        cbf_luma = cc.decode_bin(CTX_CBF_LUMA + (depth == 0 ? 1 : 0));
    code_transform_unit(c, cu, x0, y0, x_base, y_base, log2_tt, depth,
                        blk_idx, cbf_luma, cbf_cb, cbf_cr, cur_mode,
                        cur_mode_c, cur_cm_c);
    if (cbf_luma) {
        int lmt = c.p->log2_min_tb;
        int ntb = (1 << log2_tt) >> lmt;
        int xt = x0 >> lmt, yt = y0 >> lmt;
        for (int y = yt; y < yt + ntb; y++)
            for (int x = xt; x < xt + ntb; x++)
                c.cbf_luma[y * p->mtb_w + x] = 1;
    }
    compute_bs(c, x0, y0, log2_tt);
}

// ---------------------------------------------------------------------------
// coding unit / quadtree / SAO / slice loop
// ---------------------------------------------------------------------------

static void intra_default(Ctx &c, CuInfo &cu, int x0, int y0, int cb_size) {
    int n = cb_size >> 2 ? cb_size >> 2 : 1;
    int xp = x0 >> 2, yp = y0 >> 2;
    for (int y = yp; y < yp + n; y++)
        for (int x = xp; x < xp + n; x++)
            c.tab_ipm[(int64_t)y * c.w4 + x] = 1;
}

static void set_pcm_or_bypass(Ctx &c, int x0, int y0, int cb_size) {
    const SliceParams *p = c.p;
    int xe = x0 + cb_size > p->width ? p->width : x0 + cb_size;
    int ye = y0 + cb_size > p->height ? p->height : y0 + cb_size;
    for (int y = y0 >> 2; y < ye >> 2; y++)
        for (int x = x0 >> 2; x < xe >> 2; x++)
            c.is_pcm_or_bypass[(int64_t)y * c.w4 + x] = 1;
}

static int code_part_mode(Ctx &c, CuInfo &cu, int log2_cb) {
    const SliceParams *p = c.p;
    Cabac &cc = c.cc;
    if (cc.decode_bin(CTX_PART_MODE)) return 0;            // 2Nx2N
    if (log2_cb == p->log2_min_cb) {
        if (cu.pred_mode == 1) return 3;                   // NxN
        if (cc.decode_bin(CTX_PART_MODE + 1)) return 1;    // 2NxN
        if (log2_cb == 3) return 2;                        // Nx2N
        if (cc.decode_bin(CTX_PART_MODE + 2)) return 2;
        return 3;
    }
    if (!p->amp_enabled)
        return cc.decode_bin(CTX_PART_MODE + 1) ? 1 : 2;
    if (cc.decode_bin(CTX_PART_MODE + 1)) {
        if (cc.decode_bin(CTX_PART_MODE + 3)) return 1;
        return cc.bypass() ? 5 : 4;                        // 2NxnD : 2NxnU
    }
    if (cc.decode_bin(CTX_PART_MODE + 3)) return 2;
    return cc.bypass() ? 7 : 6;                            // nRx2N : nLx2N
}

static void code_intra_pred_info(Ctx &c, CuInfo &cu, int x0, int y0,
                                 int log2_cb) {
    const SliceParams *p = c.p;
    Cabac &cc = c.cc;
    int split = cu.part_mode == 3;
    int side = split ? 2 : 1;
    int pb = (1 << log2_cb) >> (split ? 1 : 0);
    int npus = split ? 4 : 1;
    int prev[4];
    for (int i = 0; i < npus; i++)
        prev[i] = cc.decode_bin(CTX_PREV_INTRA_LUMA_PRED_MODE);
    int k = 0;
    for (int i = 0; i < side; i++) {
        for (int j = 0; j < side; j++) {
            int px = x0 + pb * j, py = y0 + pb * i;
            int cands[3];
            mpm_candidates(c, px, py, cands);
            int mode;
            if (prev[k]) {
                int idx = 0;
                while (idx < 2 && cc.bypass()) idx++;
                mode = cands[idx];
            } else {
                int rem = cc.bypass_bits(5);
                // sort candidates
                int s0 = cands[0], s1 = cands[1], s2 = cands[2], t;
                if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
                if (s0 > s2) { t = s0; s0 = s2; s2 = t; }
                if (s1 > s2) { t = s1; s1 = s2; s2 = t; }
                mode = rem;
                if (mode >= s0) mode++;
                if (mode >= s1) mode++;
                if (mode >= s2) mode++;
            }
            cu.intra_modes[k] = mode;
            int n = pb >> 2 ? pb >> 2 : 1;
            for (int yy = py >> 2; yy < (py >> 2) + n; yy++)
                for (int xx = px >> 2; xx < (px >> 2) + n; xx++)
                    c.tab_ipm[(int64_t)yy * c.w4 + xx] = mode;
            k++;
        }
    }
    if (side == 1)
        cu.intra_modes[1] = cu.intra_modes[2] = cu.intra_modes[3] =
            cu.intra_modes[0];
    if (p->chroma_format_idc == 3) {
        // one intra_chroma_pred_mode per partition (hevc.c:2286-2297)
        for (int kk = 0; kk < side * side; kk++) {
            int cm;
            if (!cc.decode_bin(CTX_INTRA_CHROMA_PRED_MODE)) cm = 4;
            else cm = cc.bypass_bits(2);
            int mc;
            if (cm != 4) {
                if (cu.intra_modes[kk] == INTRA_CHROMA_TABLE[cm]) mc = 34;
                else mc = INTRA_CHROMA_TABLE[cm];
            } else mc = cu.intra_modes[kk];
            cu.intra_modes_c[kk] = mc;
            cu.chroma_modes[kk] = cm;
            if (kk == 0) cu.chroma_mode = cm;
        }
        if (side == 1) {
            cu.intra_modes_c[1] = cu.intra_modes_c[2] = cu.intra_modes_c[3] =
                cu.intra_modes_c[0];
            cu.chroma_modes[1] = cu.chroma_modes[2] = cu.chroma_modes[3] =
                cu.chroma_modes[0];
        }
        cu.intra_mode_c = cu.intra_modes_c[0];
        c.rext[4] = cu.intra_modes[0];
        c.rext[5] = cu.intra_modes_c[0];
        return;
    }
    int chroma_mode;
    if (!cc.decode_bin(CTX_INTRA_CHROMA_PRED_MODE)) chroma_mode = 4;
    else chroma_mode = cc.bypass_bits(2);
    cu.chroma_mode = chroma_mode;
    int mode_c;
    if (chroma_mode != 4) {
        if (cu.intra_modes[0] == INTRA_CHROMA_TABLE[chroma_mode]) mode_c = 34;
        else mode_c = INTRA_CHROMA_TABLE[chroma_mode];
    } else mode_c = cu.intra_modes[0];
    if (p->chroma_format_idc == 2) {
        static const int TAB[35] = {0,1,2,2,2,2,3,5,7,8,10,12,13,15,17,18,
                                    19,20,21,22,23,23,24,24,25,25,26,27,27,
                                    28,28,29,29,30,31};
        mode_c = TAB[mode_c];
    }
    cu.intra_mode_c = mode_c;
    for (int kk = 0; kk < 4; kk++) {
        cu.intra_modes_c[kk] = mode_c;
        cu.chroma_modes[kk] = chroma_mode;
    }
    c.rext[4] = cu.intra_modes[0];
    c.rext[5] = cu.intra_modes_c[0];
}

// pcm_sample (syntax/ctu.py _code_pcm; reference hls_pcm_sample hevc.c:1587)
static void code_pcm(Ctx &c, CuInfo &cu, int x0, int y0, int log2_cb) {
    const SliceParams *p = c.p;
    int cb_size = 1 << log2_cb;
    intra_default(c, cu, x0, y0, cb_size);
    compute_bs(c, x0, y0, log2_cb);
    if (p->pcm_loop_filter_disabled) set_pcm_or_bypass(c, x0, y0, cb_size);
    c.cc.pcm_align();
    int hs = p->chroma_format_idc == 3 ? 0 : 1;
    int vs = p->chroma_format_idc >= 2 ? 0 : 1;
    for (int ci = 0; ci < 3; ci++) {
        int pbd = ci ? p->pcm_bit_depth_chroma : p->pcm_bit_depth;
        int shift = p->bit_depth - pbd;
        int w = ci ? (cb_size >> hs) : cb_size;
        int h = ci ? (cb_size >> vs) : cb_size;
        emit(c, 4); emit(c, ci);
        emit(c, ci ? (x0 >> hs) : x0); emit(c, ci ? (y0 >> vs) : y0);
        emit(c, w); emit(c, (int32_t)(c.lv_base + c.lv_pos));
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++) {
                int32_t v = (int32_t)c.cc.read_raw(pbd) << shift;
                if (c.lv_pos < c.lv_cap) c.levels[c.lv_pos] = v;
                c.lv_pos++;
            }
    }
    c.cc.pcm_reinit();
}

static void code_cu(Ctx &c, int x0, int y0, int log2_cb, int depth) {
    const SliceParams *p = c.p;
    Cabac &cc = c.cc;
    int cb_size = 1 << log2_cb;
    int x_cb = x0 >> p->log2_min_cb, y_cb = y0 >> p->log2_min_cb;
    int length = cb_size >> p->log2_min_cb;
    CuInfo cu;
    memset(&cu, 0, sizeof(cu));
    cu.x0 = x0; cu.y0 = y0; cu.log2 = log2_cb;
    c.cur_cu_x0 = x0; c.cur_cu_y0 = y0;
    cu.pred_mode = 1;
    cu.rqt_root_cbf = 1;

    if (p->transquant_bypass_enabled) {
        cu.tq_bypass = cc.decode_bin(CTX_CU_TRANSQUANT_BYPASS_FLAG);
        if (cu.tq_bypass) set_pcm_or_bypass(c, x0, y0, cb_size);
    }
    if (p->slice_type != 2) {
        int mask = (1 << p->log2_ctb) - 1;
        int inc = 0;
        if (c.ctb_left || (x0 & mask))
            inc += c.skip_flag[(int64_t)y_cb * c.min_cb_w + x_cb - 1];
        if (c.ctb_up || (y0 & mask))
            inc += c.skip_flag[(int64_t)(y_cb - 1) * c.min_cb_w + x_cb];
        cu.skip = cc.decode_bin(CTX_SKIP_FLAG + inc);
        for (int y = y_cb; y < y_cb + length; y++)
            memset(c.skip_flag + (int64_t)y * c.min_cb_w + x_cb, cu.skip,
                   length);
        cu.pred_mode = cu.skip ? 0 : 0;
    } else {
        for (int y = y_cb; y < y_cb + length; y++)
            memset(c.skip_flag + (int64_t)y * c.min_cb_w + x_cb, 0, length);
        cu.pred_mode = 1;
    }

    if (cu.skip) {
        code_prediction_unit(c, cu, x0, y0, cb_size, cb_size, log2_cb, 0, 1);
        intra_default(c, cu, x0, y0, cb_size);
        compute_bs(c, x0, y0, log2_cb);
    } else {
        if (p->slice_type != 2)
            cu.pred_mode = cc.decode_bin(CTX_PRED_MODE) ? 1 : 0;
        if (cu.pred_mode != 1 || log2_cb == p->log2_min_cb)
            cu.part_mode = code_part_mode(c, cu, log2_cb);
        cu.intra_split = cu.part_mode == 3 && cu.pred_mode == 1;

        if (cu.pred_mode == 1) {
            if (cu.part_mode == 0 && p->pcm_enabled &&
                log2_cb >= p->pcm_log2_min && log2_cb <= p->pcm_log2_max)
                cu.pcm = cc.terminate();
            if (cu.pcm)
                code_pcm(c, cu, x0, y0, log2_cb);
            else
                code_intra_pred_info(c, cu, x0, y0, log2_cb);
        } else {
            intra_default(c, cu, x0, y0, cb_size);
            int q = cb_size >> 2;
            for (int pi = 0; pi < PART_COUNT[cu.part_mode]; pi++) {
                const int *g = PART_GEOM[cu.part_mode][pi];
                code_prediction_unit(c, cu, x0 + g[0] * q, y0 + g[1] * q,
                                     g[2] * q, g[3] * q, log2_cb, pi, 0);
            }
        }
        if (cu.pred_mode != 1 &&
            !(cu.part_mode == 0 && cu.merge_flag0))
            cu.rqt_root_cbf = cc.decode_bin(CTX_NO_RESIDUAL_DATA_FLAG);
        if (cu.pcm) {
            // edges + samples handled in code_pcm
        } else if (cu.rqt_root_cbf) {
            int max_depth = cu.pred_mode == 1
                ? p->max_tt_depth_intra + (cu.intra_split ? 1 : 0)
                : p->max_tt_depth_inter;
            int cbf0[2] = {0, 0};  // base cbf (hevc.c:2473)
            code_transform_tree(c, cu, x0, y0, x0, y0, log2_cb, 0, 0,
                                cbf0, cbf0, max_depth, cu.intra_modes[0],
                                cu.intra_modes_c[0]);
        } else {
            compute_bs(c, x0, y0, log2_cb);
        }
    }
    if (p->cu_qp_delta_enabled && !c.is_cu_qp_delta_coded)
        set_qpy(c, x0, y0, 0);
    for (int y = y_cb; y < y_cb + length; y++)
        for (int x = x_cb; x < x_cb + length; x++) {
            c.qp_y_tab[(int64_t)y * c.min_cb_w + x] = (int8_t)c.qp_y;
            c.ct_depth[(int64_t)y * c.min_cb_w + x] = (uint8_t)depth;
        }
    int qg_mask = (1 << (p->log2_ctb - p->diff_cu_qp_delta_depth)) - 1;
    if (((x0 + cb_size) & qg_mask) == 0 && ((y0 + cb_size) & qg_mask) == 0)
        c.qp_y_pred = c.qp_y;
}

static void code_quadtree(Ctx &c, int x0, int y0, int log2_cb, int depth) {
    const SliceParams *p = c.p;
    if (c.err) return;
    int can_split = log2_cb > p->log2_min_cb;
    int inside = x0 + (1 << log2_cb) <= p->width &&
                 y0 + (1 << log2_cb) <= p->height;
    if (p->cu_qp_delta_enabled &&
        log2_cb >= p->log2_ctb - p->diff_cu_qp_delta_depth) {
        c.is_cu_qp_delta_coded = 0;
        c.cu_qp_delta = 0;
    }
    if (p->cu_chroma_qp_offset_enabled &&
        log2_cb >= p->log2_ctb - p->diff_cu_chroma_qp_offset_depth)
        c.is_cu_chroma_qp_offset_coded = 0;   // hevc.c:2531-2534
    int split;
    if (inside && can_split) {
        int mask = (1 << p->log2_ctb) - 1;
        int x0b = x0 & mask, y0b = y0 & mask;
        int x_cb = x0 >> p->log2_min_cb, y_cb = y0 >> p->log2_min_cb;
        int inc = 0;
        if (c.ctb_left || x0b)
            inc += c.ct_depth[(int64_t)y_cb * c.min_cb_w + x_cb - 1] > depth;
        if (c.ctb_up || y0b)
            inc += c.ct_depth[(int64_t)(y_cb - 1) * c.min_cb_w + x_cb] > depth;
        split = c.cc.decode_bin(CTX_SPLIT_CODING_UNIT_FLAG + inc);
    } else if (can_split && !inside) split = 1;
    else split = 0;

    if (split) {
        int half = 1 << (log2_cb - 1);
        int xs[4] = {x0, x0 + half, x0, x0 + half};
        int ys[4] = {y0, y0, y0 + half, y0 + half};
        for (int i = 0; i < 4; i++)
            if (xs[i] < p->width && ys[i] < p->height)
                code_quadtree(c, xs[i], ys[i], log2_cb - 1, depth + 1);
        return;
    }
    c.ct_depth_cur = depth;
    code_cu(c, x0, y0, log2_cb, depth);
}

// SAO params: sao_out layout per CTB (rs): [type0..2, bp0..2, eo0..2,
// off[3][5]] = 24 int32
static void code_sao(Ctx &c, int rx, int ry) {
    const SliceParams *p = c.p;
    Cabac &cc = c.cc;
    int rs = ry * p->ctb_width + rx;
    int32_t *out = c.sao_out + (int64_t)rs * 24;
    memset(out, 0, 24 * sizeof(int32_t));
    if (!(p->sao_luma || p->sao_chroma)) return;

    int merge_left = 0, merge_up = 0;
    if (rx > 0 && c.ctb_left) merge_left = cc.decode_bin(CTX_SAO_MERGE_FLAG);
    if (ry > 0 && !merge_left && c.ctb_up)
        merge_up = cc.decode_bin(CTX_SAO_MERGE_FLAG);
    if (merge_left) {
        memcpy(out, c.sao_out + (int64_t)(rs - 1) * 24, 24 * sizeof(int32_t));
        return;
    }
    if (merge_up) {
        memcpy(out, c.sao_out + (int64_t)(rs - p->ctb_width) * 24,
               24 * sizeof(int32_t));
        return;
    }
    int cmax = (1 << ((p->bit_depth < 10 ? p->bit_depth : 10) - 5)) - 1;
    for (int ci = 0; ci < 3; ci++) {
        int enabled = ci == 0 ? p->sao_luma : p->sao_chroma;
        if (!enabled) { out[ci] = 0; continue; }
        if (ci == 2) {
            out[2] = out[1];
            out[6 + 2] = out[6 + 1];        // eo class
        } else {
            if (!cc.decode_bin(CTX_SAO_TYPE_IDX)) { out[ci] = 0; continue; }
            out[ci] = cc.bypass() ? 2 : 1;
        }
        if (out[ci] == 0) continue;
        int absv[4];
        for (int i = 0; i < 4; i++) {
            int v = 0;
            while (v < cmax && cc.bypass()) v++;
            absv[i] = v;
        }
        int signs[4] = {0, 0, 0, 0};
        if (out[ci] == 1) {                  // band
            for (int i = 0; i < 4; i++)
                if (absv[i]) signs[i] = cc.bypass();
            out[3 + ci] = cc.bypass_bits(5);
        } else if (ci != 2) {
            out[6 + ci] = cc.bypass_bits(2);
        }
        int32_t *off = out + 9 + ci * 5;
        off[0] = 0;
        for (int i = 0; i < 4; i++) {
            int v = absv[i];
            if (out[ci] == 2) { if (i > 1) v = -v; }
            else if (signs[i]) v = -v;
            off[i + 1] = v;
        }
    }
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

// shared per-picture buffers, bundled so serial and parallel entry points
// set up their Ctx identically
struct SharedBufs {
    const int32_t *rs_to_ts, *ts_to_rs, *tile_id, *min_tb_zs;
    const int32_t *rpl0, *rpl1, *col_mv, *col_poc_arr;
    const uint8_t *col_pred; const int8_t *col_refidx;
    const int32_t *col_rpl0, *col_rpl1;
    int32_t *mvf_mv, *mvf_poc; uint8_t *mvf_pred; int8_t *mvf_ref_idx;
    uint8_t *vbs, *hbs; int8_t *qp_y_tab; uint8_t *is_pcm_or_bypass;
    int32_t *sao_out; uint8_t *cbf_luma; uint8_t *scratch;
};

static void setup_ctx(Ctx &c, const SliceParams *p, const SharedBufs &b,
                      int32_t *ops, int64_t ops_cap,
                      int32_t *levels, int64_t lv_cap, int32_t *rext) {
    memset(&c, 0, sizeof(c));
    c.p = p;
    c.rs_to_ts = b.rs_to_ts; c.ts_to_rs = b.ts_to_rs; c.tile_id = b.tile_id;
    c.min_tb_zs = b.min_tb_zs;
    c.rpl0 = b.rpl0; c.rpl1 = b.rpl1;
    c.col_mv = b.col_mv; c.col_poc_arr = b.col_poc_arr;
    c.col_pred = b.col_pred;
    c.col_refidx = b.col_refidx; c.col_rpl0 = b.col_rpl0;
    c.col_rpl1 = b.col_rpl1;
    c.ops = ops; c.ops_cap = ops_cap;
    c.levels = levels; c.lv_cap = lv_cap;
    c.lv_base = p->lv_base;
    c.mvf_mv = b.mvf_mv; c.mvf_poc = b.mvf_poc; c.mvf_pred = b.mvf_pred;
    c.mvf_ref_idx = b.mvf_ref_idx;
    c.vbs = b.vbs; c.hbs = b.hbs; c.qp_y_tab = b.qp_y_tab;
    c.is_pcm_or_bypass = b.is_pcm_or_bypass;
    c.sao_out = b.sao_out;
    c.cbf_luma = b.cbf_luma;
    c.min_cb_w = p->width >> p->log2_min_cb;
    c.min_cb_h = p->height >> p->log2_min_cb;
    c.w4 = p->width >> 2; c.h4 = p->height >> 2;
    c.w8 = p->width >> 3; c.h8 = p->height >> 3;
    c.qp_y = p->slice_qp;
    c.qp_y_pred = p->slice_qp;
    c.rext = rext;
    c.first_qp_group = (p->init_state || p->slice_start) ? 1 : 0;
    c.is_cu_chroma_qp_offset_coded = 0;      // hevc.c:1091-1092
    c.cu_qp_offset_cb = 0;
    c.cu_qp_offset_cr = 0;
    c.end_of_tiles_x = p->width;
    c.end_of_tiles_y = p->height;
    // scratch layout: ct_depth | tab_ipm | skip_flag | slice_addr_tab
    uint8_t *s = b.scratch;
    c.ct_depth = s; s += (int64_t)c.min_cb_w * c.min_cb_h;
    c.tab_ipm = s; s += (int64_t)c.w4 * c.h4;
    c.skip_flag = s; s += (int64_t)c.min_cb_w * c.min_cb_h;
    c.slice_addr_tab = (int32_t *)s;
}

static void init_pic_scratch(Ctx &c) {
    memset(c.ct_depth, 0, (int64_t)c.min_cb_w * c.min_cb_h);
    memset(c.skip_flag, 0, (int64_t)c.min_cb_w * c.min_cb_h);
    memset(c.tab_ipm, 1, (int64_t)c.w4 * c.h4);
    for (int64_t i = 0; i < (int64_t)c.p->ctb_width * c.p->ctb_height; i++)
        c.slice_addr_tab[i] = -1;
}

// wavefront progress sync (the TPU-native analog of the reference's
// ff_thread_await_progress2, pthread_slice.c:238-263): the previous row
// publishes its completed-CTB count, this row spins until it leads by the
// standard 2-CTB WPP skew (hevc.c:2782, SHIFT_CTB_WPP)
struct WppSync {
    std::atomic<int32_t> *prev; int prev_len;
    std::atomic<int32_t> *mine;
    std::atomic<int32_t> *err_flag;
};

static inline void cpu_pause() {
#if defined(__x86_64__) || defined(__i386__)
    __builtin_ia32_pause();
#endif
}

// run one CABAC substream over its CTB range.  ctx_load_src/ctx_save_dst:
// WPP context snapshot buffers (load before start / save after 2nd CTB).
static void run_substream(Ctx &c, const uint8_t *data, int64_t data_size,
                          const uint8_t *ctx_load_src, uint8_t *ctx_save_dst,
                          WppSync *sync, int64_t *last_ts_out) {
    const SliceParams *p = c.p;
    c.cc.init_engine(data, data_size);
    // the previous row's context snapshot (written after its 2nd CTB) must
    // exist before it can be loaded: take the k=0 wavefront wait up front
    if (sync && sync->prev) {
        int need = 2 < sync->prev_len ? 2 : sync->prev_len;
        while (sync->prev->load(std::memory_order_acquire) < need) {
            if (sync->err_flag->load(std::memory_order_relaxed)) {
                c.err = 7;              // wavefront poisoned (wpp_err analog)
                break;
            }
            cpu_pause();
        }
    }
    if (!c.err) {
        if (p->ctx_load) {
            memcpy(c.cc.pst, ctx_load_src, NUM_CONTEXTS);
        } else {
            c.cc.init_contexts(p->init_type, av_clip(p->slice_qp, 0, 51));
        }
    }
    int64_t last_ts = p->first_ctb_ts - 1;
    int k = 0;
    for (int ts = p->first_ctb_ts; ts <= p->last_ctb_ts && !c.err;
         ts++, k++) {
        if (sync && sync->prev && k > 0) {
            int need = k + 2 < sync->prev_len ? k + 2 : sync->prev_len;
            while (sync->prev->load(std::memory_order_acquire) < need) {
                if (sync->err_flag->load(std::memory_order_relaxed)) {
                    c.err = 7;
                    break;
                }
                cpu_pause();
            }
            if (c.err) break;
        }
        int rs = c.ts_to_rs[ts];
        int x_ctb = (rs % p->ctb_width) << p->log2_ctb;
        int y_ctb = (rs / p->ctb_width) << p->log2_ctb;
        decode_neighbour(c, x_ctb, y_ctb, ts);
        code_sao(c, x_ctb >> p->log2_ctb, y_ctb >> p->log2_ctb);
        code_quadtree(c, x_ctb, y_ctb, p->log2_ctb, 0);
        last_ts = ts;
        int eos = c.cc.terminate();
        if (p->wpp_save_ctx && ts == p->first_ctb_ts + 1 && ctx_save_dst) {
            memcpy(ctx_save_dst, c.cc.pst, NUM_CONTEXTS);
        }
        if (sync && sync->mine)
            sync->mine->store(k + 1, std::memory_order_release);
        if (eos) {
            if (!p->stop_at_eos && ts != p->last_ctb_ts) c.err = 3;
            break;
        }
        if (p->stop_at_eos && ts == p->last_ctb_ts) c.err = 4;  // missing eos
    }
    if (!c.err && (c.ops_pos > c.ops_cap || c.lv_pos > c.lv_cap))
        c.err = 5;                       // per-substream buffer overflow
    if (sync) {
        if (c.err)
            sync->err_flag->store(c.err, std::memory_order_relaxed);
        if (sync->mine)    // release any waiter, error or not (hevc.c:3276)
            sync->mine->store(INT32_MAX / 2, std::memory_order_release);
    }
    *last_ts_out = last_ts;
}

extern "C" int64_t decode_slice_data(
    const SliceParams *p, const uint8_t *data, int64_t data_size,
    const int32_t *rs_to_ts, const int32_t *ts_to_rs, const int32_t *tile_id,
    const int32_t *min_tb_zs, const int32_t *rpl0, const int32_t *rpl1,
    const int32_t *col_mv, const int32_t *col_poc_arr,
    const uint8_t *col_pred, const int8_t *col_refidx,
    const int32_t *col_rpl0, const int32_t *col_rpl1,
    int32_t *ops, int64_t ops_cap, int32_t *levels, int64_t lv_cap,
    int32_t *mvf_mv, int32_t *mvf_poc, uint8_t *mvf_pred, int8_t *mvf_ref_idx,
    uint8_t *vbs, uint8_t *hbs, int8_t *qp_y_tab, uint8_t *is_pcm_or_bypass,
    int32_t *sao_out, uint8_t *cbf_luma_buf, uint8_t *scratch,
    uint8_t *ctx_io, int32_t *rext_state,
    int64_t *out_sizes /* [ops, levels, err, last_ts] */)
{
    SharedBufs b = {rs_to_ts, ts_to_rs, tile_id, min_tb_zs, rpl0, rpl1,
                    col_mv, col_poc_arr, col_pred, col_refidx, col_rpl0,
                    col_rpl1, mvf_mv, mvf_poc, mvf_pred, mvf_ref_idx,
                    vbs, hbs, qp_y_tab, is_pcm_or_bypass, sao_out,
                    cbf_luma_buf, scratch};
    Ctx c;
    setup_ctx(c, p, b, ops, ops_cap, levels, lv_cap, rext_state);
    // context init clears the persistent-rice stats (hevc_cabac.c:602-604);
    // the stale pu intra modes survive (lc->pu is never cleared)
    if (p->init_state) {
        for (int i = 0; i < 4; i++) c.rext[i] = 0;
        init_pic_scratch(c);
    }
    int64_t last_ts = p->first_ctb_ts - 1;
    run_substream(c, data, data_size, ctx_io, ctx_io, nullptr, &last_ts);
    if (p->save_ctx_end) {
        memcpy(ctx_io, c.cc.pst, NUM_CONTEXTS);
    }
    out_sizes[0] = c.ops_pos;
    out_sizes[1] = c.lv_pos;
    out_sizes[2] = c.err;
    out_sizes[3] = last_ts;
    return c.err;
}

// Fused serial substream decode: the whole slice's entry-point substreams
// (WPP rows / tiles) in ONE call.  Semantically identical to calling
// decode_slice_data once per substream (the per-substream ctx load/save
// flags arrive precomputed), but the ctypes argument marshalling — ~28
// pointer conversions per call, which at 1080p WPP means ~17 calls/frame
// — happens once per slice.  This is the 1-core serial path; the
// multi-core wavefront path is decode_substreams_wpp below.
extern "C" int64_t decode_substreams_serial(
    const SliceParams *pb, const uint8_t *payload,
    const int64_t *sub_off,           // nsubs+1 byte offsets into payload
    const int32_t *sub_ts,            // nsubs * 2: (first_ts, last_ts)
    const uint8_t *sub_flags,         // nsubs * 2: (ctx_load, wpp_save_ctx)
    int32_t nsubs,
    const int32_t *rs_to_ts, const int32_t *ts_to_rs, const int32_t *tile_id,
    const int32_t *min_tb_zs, const int32_t *rpl0, const int32_t *rpl1,
    const int32_t *col_mv, const int32_t *col_poc_arr,
    const uint8_t *col_pred, const int8_t *col_refidx,
    const int32_t *col_rpl0, const int32_t *col_rpl1,
    int32_t *ops, int64_t ops_cap, int32_t *levels, int64_t lv_cap,
    int32_t *mvf_mv, int32_t *mvf_poc, uint8_t *mvf_pred, int8_t *mvf_ref_idx,
    uint8_t *vbs, uint8_t *hbs, int8_t *qp_y_tab, uint8_t *is_pcm_or_bypass,
    int32_t *sao_out, uint8_t *cbf_luma_buf, uint8_t *scratch,
    uint8_t *ctx_io, int32_t *rext_state,
    int64_t *out_sizes /* [ops, levels, err, last_ts] */)
{
    SharedBufs b = {rs_to_ts, ts_to_rs, tile_id, min_tb_zs, rpl0, rpl1,
                    col_mv, col_poc_arr, col_pred, col_refidx, col_rpl0,
                    col_rpl1, mvf_mv, mvf_poc, mvf_pred, mvf_ref_idx,
                    vbs, hbs, qp_y_tab, is_pcm_or_bypass, sao_out,
                    cbf_luma_buf, scratch};
    int64_t ops_n = 0, lv_n = 0, last_ts = pb->first_ctb_ts - 1;
    for (int i = 0; i < nsubs; i++) {
        SliceParams ps = *pb;
        ps.first_ctb_ts = sub_ts[2 * i];
        ps.last_ctb_ts = sub_ts[2 * i + 1];
        ps.lv_base = pb->lv_base + (int32_t)lv_n;
        ps.init_state = (i == 0) ? pb->init_state : 0;
        ps.slice_start = (i == 0) ? pb->slice_start : 0;
        ps.ctx_load = sub_flags[2 * i];
        ps.wpp_save_ctx = sub_flags[2 * i + 1];
        Ctx c;
        setup_ctx(c, &ps, b, ops + ops_n, ops_cap - ops_n,
                  levels + lv_n, lv_cap - lv_n, rext_state);
        if (ps.init_state) {
            // context init clears the persistent-rice stats, matching
            // decode_slice_data (hevc_cabac.c:602-604); slots 4-5 (stale
            // pu intra modes) survive by design
            for (int j = 0; j < 4; j++) c.rext[j] = 0;
            init_pic_scratch(c);
        }
        int64_t lts = ps.first_ctb_ts - 1;
        run_substream(c, payload + sub_off[i], sub_off[i + 1] - sub_off[i],
                      ctx_io, ctx_io, nullptr, &lts);
        if (ps.save_ctx_end) memcpy(ctx_io, c.cc.pst, NUM_CONTEXTS);
        if (c.err) {
            out_sizes[0] = ops_n; out_sizes[1] = lv_n;
            out_sizes[2] = c.err; out_sizes[3] = lts;
            return c.err;
        }
        ops_n += c.ops_pos;
        lv_n += c.lv_pos;
        last_ts = lts;
    }
    out_sizes[0] = ops_n;
    out_sizes[1] = lv_n;
    out_sizes[2] = 0;
    out_sizes[3] = last_ts;
    return 0;
}

// Host-parallel WPP decode: one thread pool pass over a slice's CTB-row
// substreams with the 2-CTB wavefront skew (the reference decodes these
// rows on its pthread job pool, hevc.c:2751-2832 + pthread_slice.c:44-236).
// Rows write into private ops/levels carve-outs that are compacted back
// into decode order after the join, so the output is byte-identical to the
// serial path.  Requires: pure WPP (no tiles), fresh picture, no
// persistent-rice adaptation (whose stats chain substreams serially).
extern "C" int64_t decode_substreams_wpp(
    const SliceParams *pb, const uint8_t *payload,
    const int64_t *sub_off,           // nsubs+1 byte offsets into payload
    const int32_t *sub_ts,            // nsubs * 2: (first_ts, last_ts)
    int32_t nsubs, int32_t nthreads,
    const int32_t *rs_to_ts, const int32_t *ts_to_rs, const int32_t *tile_id,
    const int32_t *min_tb_zs, const int32_t *rpl0, const int32_t *rpl1,
    const int32_t *col_mv, const int32_t *col_poc_arr,
    const uint8_t *col_pred, const int8_t *col_refidx,
    const int32_t *col_rpl0, const int32_t *col_rpl1,
    int32_t *ops, int64_t ops_cap, int32_t *levels, int64_t lv_cap,
    int32_t *mvf_mv, int32_t *mvf_poc, uint8_t *mvf_pred, int8_t *mvf_ref_idx,
    uint8_t *vbs, uint8_t *hbs, int8_t *qp_y_tab, uint8_t *is_pcm_or_bypass,
    int32_t *sao_out, uint8_t *cbf_luma_buf, uint8_t *scratch,
    int64_t *out_sizes /* [ops, levels, err, last_ts] */)
{
    SharedBufs b = {rs_to_ts, ts_to_rs, tile_id, min_tb_zs, rpl0, rpl1,
                    col_mv, col_poc_arr, col_pred, col_refidx, col_rpl0,
                    col_rpl1, mvf_mv, mvf_poc, mvf_pred, mvf_ref_idx,
                    vbs, hbs, qp_y_tab, is_pcm_or_bypass, sao_out,
                    cbf_luma_buf, scratch};
    std::vector<SliceParams> ps(nsubs);
    std::vector<Ctx> cs(nsubs);
    std::vector<int64_t> row_last(nsubs);
    std::vector<std::array<uint8_t, NUM_CONTEXTS>> snaps(nsubs);
    std::vector<std::array<int32_t, 6>> rexts(nsubs);
    std::unique_ptr<std::atomic<int32_t>[]> prog(
        new std::atomic<int32_t>[nsubs]);
    std::atomic<int32_t> err_flag{0};
    const int64_t ops_per = ops_cap / nsubs, lv_per = lv_cap / nsubs;
    for (int i = 0; i < nsubs; i++) {
        prog[i].store(0, std::memory_order_relaxed);
        ps[i] = *pb;
        ps[i].first_ctb_ts = sub_ts[2 * i];
        ps[i].last_ctb_ts = sub_ts[2 * i + 1];
        ps[i].init_state = 0;
        ps[i].slice_start = (i == 0 && pb->slice_start) ? 1 : 0;
        ps[i].ctx_load = i > 0;
        ps[i].wpp_save_ctx = i < nsubs - 1;
        ps[i].stop_at_eos = 0;
        ps[i].save_ctx_end = 0;
        rexts[i].fill(0);
        setup_ctx(cs[i], &ps[i], b, ops + i * ops_per, ops_per,
                  levels + i * lv_per, lv_per, rexts[i].data());
    }
    if (pb->init_state) init_pic_scratch(cs[0]);

    int T = nthreads < nsubs ? nthreads : nsubs;
    if (T < 1) T = 1;
    auto worker = [&](int t) {
        for (int i = t; i < nsubs; i += T) {
            WppSync sync;
            sync.prev = i ? &prog[i - 1] : nullptr;
            sync.prev_len = i ? (sub_ts[2 * i - 1] - sub_ts[2 * i - 2] + 1)
                              : 0;
            sync.mine = &prog[i];
            sync.err_flag = &err_flag;
            run_substream(cs[i], payload + sub_off[i],
                          sub_off[i + 1] - sub_off[i],
                          i ? snaps[i - 1].data() : nullptr, snaps[i].data(),
                          &sync, &row_last[i]);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < T; t++) pool.emplace_back(worker, t);
    worker(0);
    for (auto &th : pool) th.join();

    int err = err_flag.load(std::memory_order_relaxed);
    for (int i = 0; i < nsubs && !err; i++) err = cs[i].err;
    if (err) {
        out_sizes[0] = out_sizes[1] = 0;
        out_sizes[2] = err;
        out_sizes[3] = -1;
        return err;
    }
    // compact row carve-outs into decode order, rebasing level offsets
    // (the op-stream walk mirrors split_ops)
    int64_t ops_n = cs[0].ops_pos, lv_n = cs[0].lv_pos;
    for (int i = 1; i < nsubs; i++) {
        int32_t *src = ops + i * ops_per;
        const int64_t n = cs[i].ops_pos, lv_delta = lv_n;
        memmove(ops + ops_n, src, n * sizeof(int32_t));
        int32_t *o = ops + ops_n;
        int64_t j = 0;
        while (j < n) {
            switch (o[j]) {
            case 1: j += 11; break;
            case 2: o[j + 7] += (int32_t)lv_delta; j += 9; break;
            case 3: j += 12 + (pb->has_wp ? 14 : 0); break;
            case 4: o[j + 5] += (int32_t)lv_delta; j += 6; break;
            default: out_sizes[2] = 6; return 6;
            }
        }
        memmove(levels + lv_n, levels + i * lv_per,
                cs[i].lv_pos * sizeof(int32_t));
        ops_n += n;
        lv_n += cs[i].lv_pos;
    }
    out_sizes[0] = ops_n;
    out_sizes[1] = lv_n;
    out_sizes[2] = 0;
    out_sizes[3] = row_last[nsubs - 1];
    return 0;
}

// ---------------------------------------------------------------------------
// split_ops: one pass over the tagged op stream -> per-type SoA row arrays
// (the Python side batches those with vectorized numpy instead of building
// per-op objects; see native/__init__.py split_ops)
// ---------------------------------------------------------------------------

#ifdef FE_STATS
extern "C" void fe_stats_print(double secs) {
    fprintf(stderr,
        "bins: reg=%lld byp_calls=%lld byp_bits=%lld rem=%lld tu=%lld "
        "coeff=%lld\n", (long long)fe_nbin, (long long)fe_nbyp,
        (long long)fe_nbypbits, (long long)fe_nrem, (long long)fe_ntu,
        (long long)fe_ncoeff);
    fprintf(stderr, "tsc: last=%lld sig=%lld lvl=%lld\n",
        (long long)fe_tsc_last, (long long)fe_tsc_sig,
        (long long)fe_tsc_lvl);
    fe_nbin = fe_nbyp = fe_nbypbits = fe_nrem = fe_ntu = fe_ncoeff = 0;
    fe_tsc_last = fe_tsc_sig = fe_tsc_lvl = 0;
}
#endif

extern "C" int64_t split_ops(const int32_t *ops, int64_t n, int32_t has_wp,
                             int32_t *intra_out,   // (ni, 10)
                             int32_t *resid_out,   // (nr, 8)
                             int32_t *inter_out,   // (nm, 25)
                             int32_t *pcm_out,     // (np, 5)
                             int64_t *counts) {    // ni, nr, nm, np
    static const int32_t ident_w[14] = {0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0,
                                        1, 0};
    int64_t ni = 0, nr = 0, nm = 0, npc = 0;
    int64_t i = 0;
    while (i < n) {
        int t = ops[i];
        if (t == 1) {
            memcpy(intra_out + ni * 10, ops + i + 1, 10 * 4);
            ni++; i += 11;
        } else if (t == 2) {
            memcpy(resid_out + nr * 8, ops + i + 1, 8 * 4);
            nr++; i += 9;
        } else if (t == 3) {
            memcpy(inter_out + nm * 25, ops + i + 1, 11 * 4);
            memcpy(inter_out + nm * 25 + 11,
                   has_wp ? ops + i + 12 : ident_w, 14 * 4);
            nm++; i += 12 + (has_wp ? 14 : 0);
        } else if (t == 4) {
            memcpy(pcm_out + npc * 5, ops + i + 1, 5 * 4);
            npc++; i += 6;
        } else {
            return -1;
        }
    }
    counts[0] = ni; counts[1] = nr; counts[2] = nm; counts[3] = npc;
    return 0;
}

// Gather per-TU coefficient levels into int16 (N, n, n) buckets, one pass
// in decode order (the order torch_backend/plan_soa.py resid_fields keeps
// its rows in), each level clipped to the spec's int16 coefficient range.
// Buckets are (c_idx, log2n): b = c*4+log2n-2.  bucket_base holds ELEMENT
// offsets of each bucket in lv16; buckets may be PADDED (sticky caps) and
// padding is left untouched (the caller pre-zeroes).
extern "C" void gather_levels(
    const int32_t *resid, int64_t nr,    // (nr, 8) rows, decode order
    const int32_t *raw_levels,
    const int64_t *bucket_base,          // 12 element offsets into lv16
    int16_t *lv16)
{
    int64_t fill[12] = {0};
    for (int64_t r = 0; r < nr; r++) {
        const int32_t *row = resid + r * 8;
        int b = row[0] * 4 + (row[3] - 2);
        int nn = 1 << (2 * row[3]);
        const int32_t *src = raw_levels + row[6];
        int16_t *dst = lv16 + bucket_base[b] + fill[b] * nn;
        for (int k = 0; k < nn; k++) {
            int32_t v = src[k];
            if (v > 32767) v = 32767;
            if (v < -32768) v = -32768;
            dst[k] = (int16_t)v;
        }
        fill[b]++;
    }
}

// Invert the "d5" delta output wire (tpu/frame_step.py tail): 24-byte
// escape-count header, then per plane 5-bit-packed horizontal deltas
// (8 samples / 5 bytes) plus two (3-byte index, value) escape channels.
// out receives the planes' uint8 pixels back-to-back.  Returns 0, or 1 on
// escape-cap overflow (caller falls back to a raw plane fetch).  ~6x the
// vectorized numpy inverse on this image's single core (the cumsum and
// nibble unpack fuse into one pass per row).
extern "C" int unpack_d5(const uint8_t *wire, const int64_t *hw,
                         const int64_t *caps, int nplanes, uint8_t *out,
                         int16_t *scratch)
{
    const int32_t *cnts = (const int32_t *)wire;
    for (int c = 0; c < nplanes; c++)
        if (cnts[2 * c] > caps[2 * c] || cnts[2 * c + 1] > caps[2 * c + 1])
            return 1;
    int64_t off = 8LL * nplanes;        // count header (2 int32 per plane)
    uint8_t *dst = out;
    for (int c = 0; c < nplanes; c++) {
        int64_t h = hw[2 * c], w = hw[2 * c + 1], n = h * w;
        int16_t *y = scratch;
        const uint8_t *b = wire + off;
        for (int64_t g = 0; g < n / 8; g++) {
            const uint8_t *p = b + g * 5;
            uint32_t lo = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                          ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
            uint32_t hi = p[4];
            int16_t *q = y + g * 8;
            for (int k = 0; k < 6; k++) {
                int v = (lo >> (5 * k)) & 31;
                q[k] = (int16_t)(v - ((v & 16) << 1));
            }
            int v6 = ((lo >> 30) & 3) | ((hi & 7) << 2);
            q[6] = (int16_t)(v6 - ((v6 & 16) << 1));
            int v7 = (hi >> 3) & 31;
            q[7] = (int16_t)(v7 - ((v7 & 16) << 1));
        }
        off += n / 8 * 5;
        // escape channels: int8 values then int16 values
        for (int wch = 0; wch < 2; wch++) {
            int64_t cap = caps[2 * c + wch], cnt = cnts[2 * c + wch];
            const uint8_t *i3 = wire + off;
            off += cap * 3;
            const uint8_t *vb = wire + off;
            off += cap * (wch + 1);
            for (int64_t e = 0; e < cnt; e++) {
                int64_t idx = (int64_t)i3[e * 3] |
                              ((int64_t)i3[e * 3 + 1] << 8) |
                              ((int64_t)i3[e * 3 + 2] << 16);
                int16_t v = wch ? (int16_t)(vb[e * 2] | (vb[e * 2 + 1] << 8))
                                : (int16_t)(int8_t)vb[e];
                if (idx < n) y[idx] = v;
            }
        }
        for (int64_t r = 0; r < h; r++) {
            const int16_t *q = y + r * w;
            uint8_t *o = dst + r * w;
            int acc = 128;
            for (int64_t x = 0; x < w; x++) {
                acc += q[x];
                o[x] = (uint8_t)acc;
            }
        }
        dst += n;
    }
    return 0;
}

// Invert the bit-packed 10/12-bit output wire (tpu/frame_step.py pack10 /
// pack12) for one plane: 10-bit packs 4 samples into 5 bytes, 12-bit packs
// 2 into 3.  Replaces the vectorized numpy shift chain in
// refs.host_planes (~10 ms -> ~1.5 ms per 1080p Main-10 frame on this
// image's single core — CPU the parse thread gets back).
extern "C" void unpack_px(const uint8_t *wire, int64_t n, int bits,
                          uint16_t *out)
{
    if (bits == 10) {
        for (int64_t g = 0; g < n / 4; g++) {
            const uint8_t *p = wire + g * 5;
            uint32_t lo = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                          ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
            uint16_t *q = out + g * 4;
            q[0] = (uint16_t)(lo & 1023);
            q[1] = (uint16_t)((lo >> 10) & 1023);
            q[2] = (uint16_t)((lo >> 20) & 1023);
            q[3] = (uint16_t)(((lo >> 30) & 3) | ((uint32_t)p[4] << 2));
        }
    } else {                            // 12
        for (int64_t g = 0; g < n / 2; g++) {
            const uint8_t *p = wire + g * 3;
            uint32_t lo = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                          ((uint32_t)p[2] << 16);
            uint16_t *q = out + g * 2;
            q[0] = (uint16_t)(lo & 4095);
            q[1] = (uint16_t)((lo >> 12) & 4095);
        }
    }
}
