// K3: paint one pass of tile groups into their planes, in one launch.
//
// Replaces the Pallas kernel openhevc_tpu/tpu/mc_pallas.py:230
// (_band_paint_kernel, launched at :292 by band_paint).  A pass is up to
// kMaxGroups groups; a group writes N disjoint (h, w) tiles at (ys, xs)
// into its (H, W) plane.  Rows whose valid flag is 0 are skipped; samples
// that fall outside the plane are dropped (the TPU version painted into a
// band-padded plane and cropped).  Planes are updated in place: the tiles
// of a pass are disjoint, so no two threads write one sample.
//
// What bounds it here: bytes (each tile sample read once and written once)
// and, at the main path's sizes (a few hundred KB a pass), the launch.
// The design therefore paints a whole pass per launch: the MC predictions
// of every tile size of all three planes, or every (plane, size) of the
// residual canvas.  The group descriptors travel by value in the kernel's
// parameters (a __grid_constant__ struct of ~1.7 KB), so no descriptor
// table is copied to the device.  A thread paints one 16-byte chunk of one
// tile row (4 int32 or 8 int16 samples): neighbouring threads store
// neighbouring addresses, a 4x4 tile takes 4 threads instead of a thread
// block, and tile shapes are powers of two so (tile, row, chunk) come
// from shifts, not divides.  Each group starts on a fresh thread block
// (first_cta is the prefix sum of the groups' block counts), so a block
// finds its group once, uniformly, by a scan of at most kMaxGroups
// entries.  Rows that start unaligned or cross the plane's edge fall back
// to scalar stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 24;

struct PaintGroup {
  const void* tiles;    // (N, h, w), the pass's element type
  const int* xs;        // (N,)
  const int* ys;        // (N,)
  const int* valid;     // (N,)
  void* plane;          // (H, W)
  int H, W;
  int log2h, log2w;     // tile shape
  int log2c;            // 16-byte chunks per tile row
  int items;            // N * h * chunks
  int first_cta;        // first thread block of this group
};

struct PaintPass {
  PaintGroup g[kMaxGroups];
  int n_groups;
  int n_ctas;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paint_pass_kernel(const __grid_constant__ PaintPass p) {
  int gi = 0;
  while (gi + 1 < p.n_groups && (int)blockIdx.x >= p.g[gi + 1].first_cta)
    ++gi;
  const PaintGroup& G = p.g[gi];
  const int j = ((int)blockIdx.x - G.first_cta) * kThreads + threadIdx.x;
  if (j >= G.items) return;
  constexpr int V = 16 / sizeof(T);
  const int row = j >> G.log2c;                 // tile row, over all tiles
  const int i = row >> G.log2h;                 // tile
  if (__ldg(G.valid + i) == 0) return;
  const int y = __ldg(G.ys + i) + (row & ((1 << G.log2h) - 1));
  if (y < 0 || y >= G.H) return;
  const int w = 1 << G.log2w;
  const int c0 = (j & ((1 << G.log2c) - 1)) * V;
  const int x = __ldg(G.xs + i) + c0;
  const T* src = (const T*)G.tiles + ((size_t)row << G.log2w) + c0;
  const size_t d = (size_t)y * G.W;
  T* plane = (T*)G.plane;
  const int n = min(V, w - c0);
  if (n == V && x >= 0 && x + V <= G.W &&
      ((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(plane + d + x)) & 15) == 0) {
    *reinterpret_cast<int4*>(plane + d + x) =
        __ldg(reinterpret_cast<const int4*>(src));
    return;
  }
  for (int k = 0; k < n; ++k) {
    if (x + k >= 0 && x + k < G.W) plane[d + (x + k)] = src[k];
  }
}

}  // namespace

extern "C" int ohk_paint_pass_size() { return (int)sizeof(PaintPass); }

// pass: a host PaintPass, copied into the launch's parameters.
extern "C" int ohk_paint_pass(const void* pass, int elem_bytes,
                              void* stream) {
  const PaintPass& p = *static_cast<const PaintPass*>(pass);
  if (p.n_groups < 1 || p.n_groups > kMaxGroups || p.n_ctas < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    paint_pass_kernel<int32_t><<<p.n_ctas, kThreads, 0, s>>>(p);
  else if (elem_bytes == 2)
    paint_pass_kernel<int16_t><<<p.n_ctas, kThreads, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
