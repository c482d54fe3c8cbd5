// X3: the SHVC inter-layer upsample of a picture's planes, in one launch.
//
// Replaces the reference's accelerator form of X3,
// openhevc_tpu/tpu/upsample.py:61 (upsample_plane_mxu: XLA products of
// the band matrices that band_matrix, :47, builds), and computes what its
// gather form upsample_plane_jit (:82) and the NumPy model
// (model/upsample.py, the reference's upsample_base_layer_frame,
// hevcdsp_template.c:2164-2440) compute: a separable polyphase FIR, 8-tap
// luma or 4-tap chroma, from per-output-position tables of clamped source
// indices and coefficients (plan_axis); the horizontal pass, its sum
// wrapped to int16 (the reference's int16_t intermediate, reached above
// depth 8); the vertical pass, then (acc + I_OFFSET) >> N_SHIFT and a clip
// to the bit depth.  Output int32, exact.
//
// What bounds it here: bytes.  A 1920x1080 to 3840x2160 4:2:0 picture
// reads 12.4 MB of int32 base planes and writes 49.8 MB of int32 EL
// planes (62,208,000 bytes, 0.0186 ms at 3.35 TB/s); its integer
// operations (a multiply and an add a tap, both passes, 248,832,000) take
// 0.0037 ms at 67 Top/s.  The band-matrix form would spend 99% of its
// products on zeros, so it is not the design.  The design:
//   - One launch a picture: one block per kTile x kTile tile of EL output
//     over the planes of one X3Frame (luma tiles first), each block on its
//     plane's 8-tap or 4-tap path.  The host computes, from the clamped
//     index tables themselves (not from the geometry), the first source
//     row/column each tile row/column reads and how many rows
//     (torch_backend/upsample.py kernel_tables), so picture borders,
//     phase offsets and any ratio come out right; it packs each tap's
//     window-relative offset and coefficient into one int32.
//   - The block's base-layer window arrives by one TMA load (a 2-D tensor
//     map a plane, encoded by the launcher; the box is the plane's largest
//     window, from its first column rounded down to a multiple of 4, since
//     a box must start on a 16-byte boundary of its row, and its width
//     rounded up to 4) on an mbarrier, while the threads
//     fetch their column taps and stage the tile's row taps in shared
//     memory.  A plane whose rows TMA cannot map (not a multiple of 16
//     bytes, or not 16-byte aligned) takes 4-byte cp.async copies by the
//     block's threads instead.
//   - Horizontal pass: a thread a tile column, its taps in registers, over
//     every window row; the sum wrapped to int16 and kept as int16 in
//     shared memory (exact: the wrap comes before the store).
//   - Vertical pass: a thread a strip of 4 adjacent output columns over 4
//     rows kRowStep apart.  A tap reads the strip's 4 intermediate samples
//     in one 8-byte shared load and its row's offset and coefficient from
//     the staged table (a broadcast); the strip ends in one 16-byte store,
//     or scalar stores at a ragged right edge or on a row that does not
//     start 16-byte aligned.
//   - Five blocks a streaming multiprocessor (kBlocksPerSm) overlap one
//     tile's load with another's passes and stores; the grid needs no
//     persistent loop for that.
// The reference's hi/lo bf16 split existed for the TPU's matrix unit and
// is not needed: the arithmetic is int32 throughout.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                       // EL tile: kTile x kTile
constexpr int kStrips = kTile / 4;              // 4-column strips a row
constexpr int kRowStep = kThreads / kStrips;    // vertical pass: rows apart
constexpr int kColRows = kThreads / kTile;      // horizontal: rows at once
constexpr int kNShift = 12;                     // model/upsample.py N_SHIFT
constexpr int kIOffset = 1 << (kNShift - 1);
constexpr int kMaxSmem = 48 * 1024;             // no opt-in attribute
constexpr int kMaxBox = 256;                    // a TMA box side
constexpr int kMaxPlanes = 3;
// blocks resident on an SM: caps registers at 48 a thread (no spills), 40
// warps an SM to keep stores in flight
constexpr int kBlocksPerSm = 5;

struct X3Plane {
  CUtensorMap map;      // over src (h_bl, w_bl), box (box_h, box_w);
                        // encoded by the launcher when tma
  const int* src;       // (h_bl, w_bl) base-layer plane
  int* out;             // (h_el, w_el)
  const int* xtab;      // (tiles_x * kTile, taps): (column - c0) << 16 |
                        // coefficient & 0xffff
  const int* ytab;      // (tiles_y * kTile, taps): (row - r0) * kTile << 16
                        // | coefficient & 0xffff
  const int* wx;        // (tiles_x): c0, a tile column's first source
                        // column rounded down to a multiple of 4
  const int* wy;        // (tiles_y, 2): r0, rows: a tile row's window
  int h_bl, w_bl, h_el, w_el;
  int taps;             // 8 (luma) or 4 (chroma)
  int tiles_x;
  int first_tile;       // this plane's first block
  int box_w, box_h;     // the largest window; box_w a multiple of 4
  int tma;              // set by the launcher: the window by TMA
};

struct X3Frame {
  X3Plane p[kMaxPlanes];
  int n_planes, n_tiles;
  int max_val;          // (1 << bit_depth) - 1
};

// the plane's shared memory: window (int32), horizontal sums (int16), the
// tile's row taps (int32), and room to align the window to 128 bytes
int smem_bytes(const X3Plane& P) {
  return 4 * P.box_h * P.box_w + 2 * P.box_h * kTile + 4 * kTile * P.taps +
         128;
}

__device__ __forceinline__ int lo16(int v) { return (int)(int16_t)v; }

template <int T>
__device__ __forceinline__ void upsample_tile(const X3Plane& P,
                                              const CUtensorMap* map, int t,
                                              int max_val, unsigned char* sm,
                                              uint32_t bar) {
  const int ty = t / P.tiles_x, tx = t - ty * P.tiles_x;
  const int c0 = __ldg(P.wx + tx);
  const int r0 = __ldg(P.wy + 2 * ty), nr = __ldg(P.wy + 2 * ty + 1);
  int* S = reinterpret_cast<int*>(sm);                  // box_h x box_w
  int16_t* M = reinterpret_cast<int16_t*>(S + P.box_h * P.box_w);
  int* Y = reinterpret_cast<int*>(M + P.box_h * kTile); // kTile x T

  // the window: one TMA box (zeros beyond the plane, never read), or
  // 4-byte cp.async copies of the rows and columns that lie in it
  if (P.tma) {
    if (threadIdx.x == 0)
      ohk::tma_load_2d(ohk::smem_addr(S), map, c0, r0, bar,
                       4 * P.box_h * P.box_w);
  } else {
    const int nc = min(P.box_w, P.w_bl - c0);
    for (int i = threadIdx.x; i < nr * nc; i += kThreads) {
      const int r = i / nc, c = i - r * nc;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(ohk::smem_addr(S + r * P.box_w + c)),
                      "l"(P.src + (size_t)(r0 + r) * P.w_bl + c0 + c)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // meanwhile: this thread's column taps, and the tile's row taps
  const int x = threadIdx.x % kTile;
  int ox[T], cx[T];
  {
    const int4* xt =
        reinterpret_cast<const int4*>(P.xtab + (size_t)(tx * kTile + x) * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const int4 v = __ldg(xt + q);
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ox[4 * q + j] = w[j] >> 16;
        cx[4 * q + j] = lo16(w[j]);
      }
    }
  }
  {
    const int4* yt =
        reinterpret_cast<const int4*>(P.ytab + (size_t)ty * kTile * T);
    for (int i = threadIdx.x; i < kTile * T / 4; i += kThreads)
      reinterpret_cast<int4*>(Y)[i] = __ldg(yt + i);
  }
  __syncthreads();
  if (P.tma) ohk::mbar_wait(bar, 0);

  // horizontal pass over the window rows; unsigned sums wrap as the plain
  // version's int32 arithmetic does, then the int16 wrap
  for (int r = threadIdx.x / kTile; r < nr; r += kColRows) {
    const int* row = S + r * P.box_w;
    unsigned s = 0;
#pragma unroll
    for (int k = 0; k < T; ++k) s += (unsigned)cx[k] * (unsigned)row[ox[k]];
    M[r * kTile + x] = (int16_t)s;
  }
  __syncthreads();

  // vertical pass: a strip of 4 columns, rows kRowStep apart
  const int st = threadIdx.x % kStrips;
  const int gx = tx * kTile + 4 * st;
  if (gx >= P.w_el) return;
  const int16_t* Ms = M + 4 * st;
  for (int yy = threadIdx.x / kStrips; yy < kTile; yy += kRowStep) {
    const int gy = ty * kTile + yy;
    if (gy >= P.h_el) break;
    const int4* yr = reinterpret_cast<const int4*>(Y + yy * T);
    int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const int4 v = yr[q];
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lo16(w[j]);
        const int2 m = *reinterpret_cast<const int2*>(Ms + (w[j] >> 16));
        a0 += c * lo16(m.x);
        a1 += c * (m.x >> 16);
        a2 += c * lo16(m.y);
        a3 += c * (m.y >> 16);
      }
    }
    const int v0 = min(max((a0 + kIOffset) >> kNShift, 0), max_val);
    const int v1 = min(max((a1 + kIOffset) >> kNShift, 0), max_val);
    const int v2 = min(max((a2 + kIOffset) >> kNShift, 0), max_val);
    const int v3 = min(max((a3 + kIOffset) >> kNShift, 0), max_val);
    int* o = P.out + (size_t)gy * P.w_el + gx;
    if (gx + 4 <= P.w_el && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
      *reinterpret_cast<int4*>(o) = make_int4(v0, v1, v2, v3);
    } else {
      o[0] = v0;
      if (gx + 1 < P.w_el) o[1] = v1;
      if (gx + 2 < P.w_el) o[2] = v2;
      if (gx + 3 < P.w_el) o[3] = v3;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
upsample_frame_kernel(const __grid_constant__ X3Frame f) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  int pi = 0;
  while (pi + 1 < f.n_planes && (int)blockIdx.x >= f.p[pi + 1].first_tile)
    ++pi;
  const X3Plane& P = f.p[pi];
  // the map's address in the kernel's parameters, whatever copy of the
  // plane's other fields the compiler makes
  const CUtensorMap* map =
      pi == 0 ? &f.p[0].map : (pi == 1 ? &f.p[1].map : &f.p[2].map);
  unsigned char* sm =
      smem_raw + ((128 - (ohk::smem_addr(smem_raw) & 127)) & 127);
  const uint32_t b = ohk::smem_addr(&bar);
  if (P.tma) {
    if (threadIdx.x == 0) ohk::mbar_init(b);
    __syncthreads();
  }
  const int t = blockIdx.x - P.first_tile;
  if (P.taps == 8)
    upsample_tile<8>(P, map, t, f.max_val, sm, b);
  else
    upsample_tile<4>(P, map, t, f.max_val, sm, b);
}

}  // namespace

extern "C" int ohk_upsample_frame_size() { return (int)sizeof(X3Frame); }

// frame: a host X3Frame with its tensor maps and tma flags left blank; the
// launcher decides per plane whether TMA can map it, encodes those maps
// and copies the whole struct into the launch's parameters.  Returns a
// CUDA error, or -1 when the driver has no cuTensorMapEncodeTiled, or
// -(1000 + CUresult) when encoding failed.
extern "C" int ohk_upsample_frame(const void* frame, void* stream) {
  X3Frame f;
  memcpy(&f, frame, sizeof f);
  if (f.n_planes < 1 || f.n_planes > kMaxPlanes || f.n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  for (int i = 0; i < f.n_planes; ++i) {
    X3Plane& P = f.p[i];
    if ((P.taps != 4 && P.taps != 8) || P.h_el < 1 || P.w_el < 1 ||
        P.tiles_x < 1 || P.box_h < 1 || P.box_h > kMaxBox || P.box_w < 4 ||
        P.box_w > kMaxBox || P.box_w % 4 != 0 ||
        P.first_tile >= f.n_tiles || (i == 0 && P.first_tile != 0))
      return (int)cudaErrorInvalidValue;
    smem = std::max(smem, smem_bytes(P));
    P.tma = P.w_bl % 4 == 0 && (reinterpret_cast<uintptr_t>(P.src) & 15) == 0;
    if (P.tma) {
      ohk::EncodeTiled encode = ohk::encode_tiled();
      if (encode == nullptr) return -1;
      const CUresult r = ohk::encode_int32_2d(encode, &P.map, P.src, P.h_bl,
                                              P.w_bl, P.box_h, P.box_w);
      if (r != CUDA_SUCCESS) return -(1000 + (int)r);
    }
  }
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  upsample_frame_kernel<<<f.n_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      f);
  return (int)cudaGetLastError();
}
