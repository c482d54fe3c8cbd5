// K2: motion-compensation interpolation of a frame's whole MC pass (every
// tile size of every plane) in one launch.
//
// Replaces the Pallas kernel openhevc_tpu/tpu/mc_pallas.py:43 (_mc_kernel,
// launched at :127 by mc_batch_pallas).  Per work item (reference slot,
// block origin, motion vector): take the (h+taps-1) x (w+taps-1) window of
// the reference plane with every coordinate clamped into the picture
// (HEVC's edge emulation), run the horizontal 8-tap qpel (luma) or 4-tap
// epel (chroma) FIR, shift by bit_depth-8, then the vertical FIR and >> 6.
// Output: (N, h, w) int32 14-bit intermediates, as put_hevc_qpel/epel.
//
// What bounds it here: bytes.  Each item reads its window once from the
// reference (L2-resident at 1080p) and writes h*w int32; the FIR is ~16
// integer operations per output sample.  The design:
//   - A pass is up to kMaxGroups groups (one tile size of one plane each),
//     described by value in the kernel's parameters (__grid_constant__),
//     as K3's PaintPass is.  Each group starts on a fresh thread block
//     (first_cta, a prefix sum), so a block finds its group by one uniform
//     scan.
//   - A block takes `ipc` consecutive items of its group, chosen on the
//     host so that a block computes about 1K output samples: one 64x64
//     item, or 256 2x2 chroma items.  A 2x2 item alone would leave 252 of
//     256 threads idle.
//   - Every window is staged into shared memory with 4-byte cp.async from
//     the clamped address (the clamp is per sample, so TMA's zero fill
//     cannot stand in for it, and windows start at arbitrary unaligned
//     origins).  The horizontal pass goes to shared memory, the vertical
//     pass to registers, stored coalesced: a block's outputs are one
//     contiguous run of the group's (N, h, w) buffer.
//   - Tile shapes are powers of two, so output indexing is shifts; the
//     window and horizontal-pass rows are not, and their indices divide by
//     a per-block multiply-high (exact at these sizes), never by a divide
//     per sample.
// The TPU kernel's DMA ring, tile-aligned window starts, rolls and SMEM
// chunking are not needed; clamping every coordinate replaces the
// replicate-padded reference stack and is exact for motion vectors that
// point arbitrarily far outside the picture.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 24;
constexpr int kTables = 64;      // qpel 4x8, then epel 8x4

struct McGroup {
  const int* refs;      // (R, H, W)
  const int* sel;       // (N,) reference slot
  const int* xs;        // (N,) origin, before the >> sx / >> sy below
  const int* ys;
  const int* mvx;       // (N,) quarter-sample luma motion
  const int* mvy;
  int* out;             // (N, h, w) inside the pass's buffer
  int R, H, W, N;
  int log2w, log2h, taps;
  int sx, sy;           // the plane's shift of xs / ys (chroma)
  int hs, vs;           // chroma subsampling of the motion's fraction
  int bd;
  int ipc;              // items a thread block
  int first_cta;
};

struct McPass {
  McGroup g[kMaxGroups];
  int n_groups;
  int n_ctas;
};

__constant__ int kFir[kTables] = {
    0, 0, 0, 64, 0, 0, 0, 0,        -1, 4, -10, 58, 17, -5, 1, 0,
    -1, 4, -11, 40, 40, -11, 4, -1, 0, 1, -5, 17, 58, -10, 4, -1,
    0, 64, 0, 0,   -2, 58, 10, -2,  -4, 54, 16, -2,  -6, 46, 28, -4,
    -4, 36, 36, -4, -4, 28, 46, -6, -2, 16, 54, -4,  -2, 10, 58, -2};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ceil(2^32 / d): __umulhi(k, m) == k / d for every k < 2^32 / d
__device__ __forceinline__ unsigned magic(unsigned d) {
  return 0xFFFFFFFFu / d + 1u;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

// Shared memory: the FIR tables, then per item (bx, by, fx, fy, ref
// offset), then the windows (n, WH, WW), then the horizontal pass
// (n, WH, w).
template <int T>
__device__ void mc_items(const McGroup& G, int item0, int n, int* smem) {
  const int log2w = G.log2w, w = 1 << log2w, h = 1 << G.log2h;
  const int WW = w + T - 1, WH = h + T - 1;
  int* tab = smem;
  int* m_bx = tab + kTables;
  int* m_by = m_bx + G.ipc;
  int* m_fx = m_by + G.ipc;
  int* m_fy = m_fx + G.ipc;
  int* m_ro = m_fy + G.ipc;
  int* win = m_ro + G.ipc;
  const int wsz = WH * WW, tsz = WH << log2w;
  int* tmp = win + n * wsz;
  for (int i = threadIdx.x; i < kTables; i += kThreads) tab[i] = kFir[i];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int it = item0 + i;
    const int mx = __ldg(G.mvx + it), my = __ldg(G.mvy + it);
    const int x = __ldg(G.xs + it) >> G.sx, y = __ldg(G.ys + it) >> G.sy;
    if (T == 8) {
      m_fx[i] = 8 * (mx & 3);
      m_fy[i] = 8 * (my & 3);
      m_bx[i] = x + (mx >> 2) - 3;
      m_by[i] = y + (my >> 2) - 3;
    } else {
      m_fx[i] = 32 + 4 * ((mx & ((1 << (2 + G.hs)) - 1)) << (1 - G.hs));
      m_fy[i] = 32 + 4 * ((my & ((1 << (2 + G.vs)) - 1)) << (1 - G.vs));
      m_bx[i] = x + (mx >> (2 + G.hs)) - 1;
      m_by[i] = y + (my >> (2 + G.vs)) - 1;
    }
    m_ro[i] = __ldg(G.sel + it) * G.H * G.W;
  }
  __syncthreads();

  // the clamped windows, 4 bytes a cp.async
  const unsigned mw = magic(WW), ms = magic(wsz);
  for (int k = threadIdx.x; k < n * wsz; k += kThreads) {
    const int i = __umulhi(k, ms), rem = k - i * wsz;
    const int r = __umulhi(rem, mw), c = rem - r * WW;
    const int yy = clampi(m_by[i] + r, 0, G.H - 1);
    const int xx = clampi(m_bx[i] + c, 0, G.W - 1);
    cp_async4(win + k, G.refs + m_ro[i] + (size_t)yy * G.W + xx);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // horizontal pass: (n, WH, w) into shared memory
  const int sh1 = G.bd - 8;
  const unsigned mt = magic(tsz);
  for (int k = threadIdx.x; k < n * tsz; k += kThreads) {
    const int i = __umulhi(k, mt), rem = k - i * tsz;
    const int r = rem >> log2w, c = rem & (w - 1);
    const int* s = win + i * wsz + r * WW + c;
    const int* f = tab + m_fx[i];
    int acc = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) acc += f[t] * s[t];
    tmp[k] = acc >> sh1;
  }
  __syncthreads();

  // vertical pass to registers; the block's outputs are contiguous
  const int log2o = log2w + G.log2h;
  int* out = G.out + ((size_t)item0 << log2o);
  for (int o = threadIdx.x; o < n << log2o; o += kThreads) {
    const int i = o >> log2o, r = (o >> log2w) & (h - 1), c = o & (w - 1);
    const int* s = tmp + i * tsz + (r << log2w) + c;
    const int* f = tab + m_fy[i];
    int acc = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) acc += f[t] * s[t << log2w];
    out[o] = acc >> 6;
  }
}

__global__ void __launch_bounds__(kThreads)
mc_pass_kernel(const __grid_constant__ McPass p) {
  extern __shared__ int smem[];
  int gi = 0;
  while (gi + 1 < p.n_groups && (int)blockIdx.x >= p.g[gi + 1].first_cta)
    ++gi;
  const McGroup& G = p.g[gi];
  const int item0 = ((int)blockIdx.x - G.first_cta) * G.ipc;
  const int n = min(G.ipc, G.N - item0);
  if (G.taps == 8)
    mc_items<8>(G, item0, n, smem);
  else
    mc_items<4>(G, item0, n, smem);
}

}  // namespace

extern "C" int ohk_mc_pass_size() { return (int)sizeof(McPass); }

// pass: a host McPass, copied into the launch's parameters; smem: the
// largest group's shared memory in bytes (computed by the host).
extern "C" int ohk_mc_pass(const void* pass, int smem, void* stream) {
  const McPass& p = *static_cast<const McPass*>(pass);
  if (p.n_groups < 1 || p.n_groups > kMaxGroups || p.n_ctas < 1 ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  mc_pass_kernel<<<p.n_ctas, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
