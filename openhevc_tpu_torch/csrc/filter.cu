// K4: deblocking (vertical then horizontal edges) and SAO of a frame's
// planes, in one launch: one thread block per CTB of each plane.
//
// Replaces the Pallas kernel openhevc_tpu/tpu/filter_pallas.py:290
// (_kernel, launched at :556 by fused_filter_plane).  Per plane, in this
// order: the vertical 8-px edges of the plane zero-padded to the grids'
// geometry, the horizontal edges of that result, SAO (band/edge offsets
// with the picture-border exclusions) on the deblocked samples, and the
// PCM/bypass restore mask.
//
// What bounds it here: bytes.  The function reads each sample once and
// writes it once (about 30 integer operations a sample at most).  The
// design keeps every intermediate on the chip: a block copies its CTB
// plus a halo of 4 samples on every side (72x72 int32 for a 64x64 luma
// CTB) into shared memory with one TMA load, runs the vertical pass, the
// horizontal pass and SAO there, and writes only its own CTB, once, to a
// separate output plane.  So the plane crosses device memory once each
// way, plus the halo's re-read (27% for a luma CTB, mostly from L2).
//
// Why a halo of 4 is exact: an edge at 8k reads samples 8k-4..8k+3 and
// writes 8k-3..8k+2.  SAO needs the deblocked samples at +-1 around the
// CTB; the horizontal edges at y0..y0+S reach them and read rows
// y0-4..y0+S+3 over the 4-column groups that cover x0-4..x0+S+3; the
// vertical edges at x0..x0+S that produce those columns read
// x0-4..x0+S+3, and their decisions (lines 0 and 3 of each 4-line group)
// stay inside the 4-aligned rows y0-4..y0+S+3.  Halo edges are computed
// by the blocks on both sides, identically; no block writes another's
// tile.  The tensor map spans the plane's true (H, W), and TMA fills
// everything outside it with zeros: exactly the reference's zero-padded
// geometry.  Deblocking in place inside the tile is exact because no edge
// reads what another edge of the same pass writes.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 4;
constexpr int kMaxCtb = 64;
constexpr int kMaxTile = kMaxCtb + 2 * kHalo;
constexpr int kMaxPlanes = 3;

struct FilterPlane {
  CUtensorMap map;          // over src (H, W), box (csy+8, csx+8); filled
                            // by the launcher
  const int* src;           // (H, W) input plane
  int* dst;                 // (H, W) output plane
  const int* vg[4];         // vertical-edge grids tc, beta (chroma: tc
                            // again), nop, noq:
                            // (vrows, vcols); row g+2 = 4-line group g,
                            // column k = edge at x = 8k
  const int* hg[4];         // horizontal-edge grids (hrows, hcols): row
                            // k = edge at y = 8k, column g = group g
  const int* sao[4];        // type, band, class (rows, gcols); offsets
                            // (rows, gcols, 5)
  const int* restore;       // (H, W) or null
  int H, W;
  int vrows, vcols, hrows, hcols;
  int csx, csy, log2csx;    // CTB (tile) shape
  int cols;                 // CTBs a row: ceil(W / csx)
  int gcols;                // the SAO grids' row length
  int first_cta;
  int luma;
};

struct FilterFrame {
  FilterPlane p[kMaxPlanes];
  int n_planes, n_ctas, bd, deblock, sao;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int signi(int v) { return (v > 0) - (v < 0); }

// One edge of 4 lines.  q points at sample q0 of line 0; `along` steps
// across the edge (taps), `line` along it.
__device__ void deblock_edge(int* q, int along, int line, int tc, int beta,
                             int nop, int noq, bool luma, int maxv) {
  if (!luma) {
    for (int l = 0; l < 4; ++l) {
      int* s = q + l * line;
      const int p1 = s[-2 * along], p0 = s[-along];
      const int q0 = s[0], q1 = s[along];
      const int delta = clampi((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc);
      if (nop == 0) s[-along] = clampi(p0 + delta, 0, maxv);
      if (noq == 0) s[0] = clampi(q0 - delta, 0, maxv);
    }
    return;
  }
  int P[4][4], Q[4][4];   // [line][i]: P[l][i] = p_i, Q[l][i] = q_i
  for (int l = 0; l < 4; ++l) {
    const int* s = q + l * line;
    for (int i = 0; i < 4; ++i) {
      P[l][i] = s[-(i + 1) * along];
      Q[l][i] = s[i * along];
    }
  }
  const int dp0 = absi(P[0][2] - 2 * P[0][1] + P[0][0]);
  const int dp3 = absi(P[3][2] - 2 * P[3][1] + P[3][0]);
  const int dq0 = absi(Q[0][2] - 2 * Q[0][1] + Q[0][0]);
  const int dq3 = absi(Q[3][2] - 2 * Q[3][1] + Q[3][0]);
  const int d0 = dp0 + dq0, d3 = dp3 + dq3;
  if (!(d0 + d3 < beta)) return;
  const int beta3 = beta >> 3, beta2 = beta >> 2;
  const int tc25 = (tc * 5 + 1) >> 1;
  const int sd0 = absi(P[0][3] - P[0][0]) + absi(Q[0][3] - Q[0][0]);
  const int sd3 = absi(P[3][3] - P[3][0]) + absi(Q[3][3] - Q[3][0]);
  const int pq0 = absi(P[0][0] - Q[0][0]), pq3 = absi(P[3][0] - Q[3][0]);
  const bool strong = sd0 < beta3 && pq0 < tc25 && sd3 < beta3 &&
                      pq3 < tc25 && (d0 << 1) < beta2 && (d3 << 1) < beta2;
  const bool nd_p = (dp0 + dp3) < ((beta + (beta >> 1)) >> 3);
  const bool nd_q = (dq0 + dq3) < ((beta + (beta >> 1)) >> 3);
  const int tc2 = tc << 1, tch = tc >> 1;
  for (int l = 0; l < 4; ++l) {
    int* s = q + l * line;
    const int p0 = P[l][0], p1 = P[l][1], p2 = P[l][2], p3 = P[l][3];
    const int q0 = Q[l][0], q1 = Q[l][1], q2 = Q[l][2], q3 = Q[l][3];
    if (strong) {
      if (nop == 0) {
        s[-along] = p0 + clampi(((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >>
                                 3) - p0, -tc2, tc2);
        s[-2 * along] =
            p1 + clampi(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -tc2, tc2);
        s[-3 * along] = p2 + clampi(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >>
                                     3) - p2, -tc2, tc2);
      }
      if (noq == 0) {
        s[0] = q0 + clampi(((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) -
                           q0, -tc2, tc2);
        s[along] = q1 + clampi(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, -tc2, tc2);
        s[2 * along] = q2 + clampi(((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >>
                                    3) - q2, -tc2, tc2);
      }
    } else {
      const int delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (absi(delta0) < 10 * tc) {
        const int d = clampi(delta0, -tc, tc);
        if (nop == 0) {
          s[-along] = clampi(p0 + d, 0, maxv);
          if (nd_p)
            s[-2 * along] = clampi(
                p1 + clampi((((p2 + p0 + 1) >> 1) - p1 + d) >> 1, -tch, tch),
                0, maxv);
        }
        if (noq == 0) {
          s[0] = clampi(q0 - d, 0, maxv);
          if (nd_q)
            s[along] = clampi(
                q1 + clampi((((q2 + q0 + 1) >> 1) - q1 - d) >> 1, -tch, tch),
                0, maxv);
        }
      }
    }
  }
}

// One deblocking pass over the tile (TH, TW), origin (y0-4, x0-4) in the
// plane.  Edges at tile offset 4 + 8j across, j = 0..S/8; 4-line groups
// along.  Grid lookups follow the builders' layout; an edge outside the
// grids is not filtered, as in the plain version.
__device__ void deblock_pass(int* tile, int TW, const FilterPlane& P, int bx,
                             int by, bool vertical, int maxv) {
  const int S = vertical ? P.csx : P.csy;          // across the edges
  const int L = (vertical ? P.csy : P.csx) + 2 * kHalo;   // along them
  const int n_e = (S >> 3) + 1, n_g = L >> 2;
  const int k0 = vertical ? (bx * P.csx) >> 3 : (by * P.csy) >> 3;
  const int g0 = ((vertical ? by * P.csy : bx * P.csx) >> 2) - 1;
  const int* const* grid = vertical ? P.vg : P.hg;
  const int along = vertical ? 1 : TW, line = vertical ? TW : 1;
  for (int it = threadIdx.x; it < n_e * n_g; it += kThreads) {
    const int gi = it / n_e, j = it - gi * n_e;
    const int k = k0 + j, g = g0 + gi;
    int idx;
    if (vertical) {
      if (k < 1 || k >= P.vcols || g < 0 || g >= P.vrows - 4) continue;
      idx = (g + 2) * P.vcols + k;
    } else {
      if (k < 1 || k >= P.hrows || g < 0 || g >= P.hcols) continue;
      idx = k * P.hcols + g;
    }
    const int tc = __ldg(grid[0] + idx);
    if (tc <= 0) continue;
    const int beta = P.luma ? __ldg(grid[1] + idx) : 0;
    const int nop = __ldg(grid[2] + idx), noq = __ldg(grid[3] + idx);
    int* q = vertical ? tile + (4 * gi) * TW + kHalo + 8 * j
                      : tile + (kHalo + 8 * j) * TW + 4 * gi;
    deblock_edge(q, along, line, tc, beta, nop, noq, P.luma != 0, maxv);
  }
}

__global__ void __launch_bounds__(kThreads)
filter_frame_kernel(const __grid_constant__ FilterFrame f) {
  __shared__ __align__(128) int tile[kMaxTile * kMaxTile];
  __shared__ __align__(8) uint64_t bar;
  int pi = 0;
  while (pi + 1 < f.n_planes && (int)blockIdx.x >= f.p[pi + 1].first_cta)
    ++pi;
  const FilterPlane& P = f.p[pi];
  const int t = blockIdx.x - P.first_cta;
  const int by = t / P.cols, bx = t - by * P.cols;
  const int x0 = bx * P.csx, y0 = by * P.csy;
  const int TW = P.csx + 2 * kHalo, TH = P.csy + 2 * kHalo;

  // the tile and its halo: one TMA load, zeros outside the plane
  const uint32_t b = ohk::smem_addr(&bar);
  if (threadIdx.x == 0) ohk::mbar_init(b);
  __syncthreads();
  if (threadIdx.x == 0)
    ohk::tma_load_2d(ohk::smem_addr(tile), &P.map, x0 - kHalo, y0 - kHalo, b,
                     TW * TH * 4);
  ohk::mbar_wait(b, 0);

  const int maxv = (1 << f.bd) - 1;
  if (f.deblock) {
    deblock_pass(tile, TW, P, bx, by, true, maxv);
    __syncthreads();
    deblock_pass(tile, TW, P, bx, by, false, maxv);
    __syncthreads();
  }

  // SAO on the deblocked tile, the restore mask, one write of the CTB
  int type = 0, band = 0, cls = 0, off[5] = {0, 0, 0, 0, 0};
  if (f.sao) {
    const int cell = by * P.gcols + bx;
    type = __ldg(P.sao[0] + cell);
    band = __ldg(P.sao[1] + cell);
    cls = __ldg(P.sao[2] + cell);
    for (int i = 0; i < 5; ++i) off[i] = __ldg(P.sao[3] + 5 * cell + i);
  }
  const int dx = cls == 0 ? -1 : (cls == 1 ? 0 : (cls == 2 ? -1 : 1));
  const int dy = cls == 0 ? 0 : -1;
  const int n = P.csx * P.csy;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = k >> P.log2csx, c = k & (P.csx - 1);
    const int y = y0 + r, x = x0 + c;
    if (y >= P.H || x >= P.W) continue;
    const int* s = tile + (r + kHalo) * TW + (c + kHalo);
    const int v = s[0];
    int out = v;
    if (type == 1) {
      const int bi = ((v >> (f.bd - 5)) - band) & 31;
      if (bi < 4) out = clampi(v + off[bi + 1], 0, maxv);
    } else if (type == 2 && cls >= 0 && cls <= 3) {
      const bool bxe = (x == 0 || x == P.W - 1) && cls != 1;
      const bool bye = (y == 0 || y == P.H - 1) && cls != 0;
      if (!bxe && !bye) {
        const int n0 = s[dy * TW + dx], n1 = s[-dy * TW - dx];
        const int s2 = signi(v - n0) + signi(v - n1);
        const int o = s2 == -2 ? off[1] : s2 == -1 ? off[2]
                    : s2 == 1 ? off[3] : s2 == 2 ? off[4] : 0;
        out = clampi(v + o, 0, maxv);
      }
    }
    const size_t at = (size_t)y * P.W + x;
    if (f.sao && P.restore != nullptr && __ldg(P.restore + at) != 0) out = v;
    P.dst[at] = out;
  }
}

}  // namespace

extern "C" int ohk_filter_frame_size() { return (int)sizeof(FilterFrame); }

// frame: a host FilterFrame with its tensor maps left blank; the launcher
// encodes one map a plane and copies the whole struct into the launch's
// parameters.  Returns a CUDA error, or -1 when the driver has no
// cuTensorMapEncodeTiled, or -(1000 + CUresult) when encoding failed.
extern "C" int ohk_filter_frame(const void* frame, void* stream) {
  FilterFrame f;
  memcpy(&f, frame, sizeof f);
  if (f.n_planes < 1 || f.n_planes > kMaxPlanes || f.n_ctas < 1)
    return (int)cudaErrorInvalidValue;
  ohk::EncodeTiled encode = ohk::encode_tiled();
  if (encode == nullptr) return -1;
  for (int i = 0; i < f.n_planes; ++i) {
    FilterPlane& P = f.p[i];
    if (P.csx > kMaxCtb || P.csy > kMaxCtb || (P.W * 4) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const CUresult r = ohk::encode_int32_2d(
        encode, &P.map, P.src, P.H, P.W, P.csy + 2 * kHalo,
        P.csx + 2 * kHalo);
    if (r != CUDA_SUCCESS) return -(1000 + (int)r);
  }
  filter_frame_kernel<<<f.n_ctas, kThreads, 0, (cudaStream_t)stream>>>(f);
  return (int)cudaGetLastError();
}
