// K1: intra reconstruction of whole planes as a dataflow wavefront.
//
// Replaces the Pallas kernel openhevc_tpu/tpu/intra_pallas.py:341 (_kernel,
// launched at :558 by _intra_seq_raw).  Per intra block: fetch the 4n+1
// neighbours under five availability flags, run the substitution cascade,
// [1 2 1] or strong bilinear smoothing, predict planar / DC (luma edge
// filter) / angular (inverse-angle projection, luma edge fix), add the
// residual canvas, clip and store.  The arithmetic is the sequential
// kernel's; only the schedule differs.
//
// What bounds it here: latency.  A block reads samples that earlier blocks
// wrote, so the blocks of a plane form a dependency graph, but not a chain:
// a 1080p I frame's 3,249 luma blocks are 665 dependent steps deep, and the
// three planes are independent.  The design walks that graph with a
// persistent grid of workers (64-thread blocks, up to kWorkersPerSm on
// every SM: enough that the blocks in flight, in decode order, span the
// wavefront).  A worker takes the next block of a plane, in decode order,
// from a ticket counter per plane; reads the neighbour samples it uses
// (under its flags, at the coordinates the reads clamp to) as soon as the
// blocks that write them have; rebuilds the block with its references and
// residual in shared memory (the residual is copied asynchronously while
// the worker waits); and stores it.  A block waits only on blocks with
// smaller tickets, which running workers already hold, so the walk cannot
// deadlock.
//
// Two launches per call.  owner_kernel fills an owner map per 4x4 unit
// (1 + the metadata row that writes the unit; 0 where no intra block
// writes, whose samples are final at launch: inter pixels and the residual
// canvas are painted first) and marks every sample an intra block will
// write with -1, which no reconstructed sample takes (they are clipped to
// [0, 2^bd - 1]).  wavefront_kernel then walks the blocks.
//
// Memory ordering: each sample is written once, by one strong store
// (st.relaxed.gpu), and a reader polls the very sample it needs with a
// strong load (ld.relaxed.gpu, served by L2: L1 is not coherent across
// SMs) until it is no longer -1.  A value other than -1 is therefore the
// final one, and no fence or flag is needed between writer and reader.
// (A done flag per block, published after __threadfence() with a release
// store and polled with acquire loads, was slower on an H100: it puts a
// fence and a second L2 round trip on every step of the chain; PERF.md.)
// A block's own samples, and samples no block writes, are read from the
// plane as it was at launch.
//
// Metadata it cannot schedule sets bits of the error word and never hangs:
// two blocks writing one unit, or a block off the 4-sample grid (owner
// pass; the walk is then skipped), a block reading a unit that a later
// block writes (the block goes on and stores, so nobody waits forever),
// and a wait that runs out of time (kWaitNs; waits also stop once the
// error word is set).  The wrapper reads the word and raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;                       // one worker
// resident workers an SM: about 2,100 on an H100, so that the blocks in
// flight (in decode order) span the 1080p I frame's wavefront
constexpr int kWorkersPerSm = 16;
constexpr int kRef = 2 * 32 + 2;                   // ref[0..2n] (+1 guard)
constexpr int kOwnerThreads = 256;                 // 4 rows x 64 units
constexpr long long kWaitNs = 1000000000LL;        // 1 s per wait
constexpr unsigned kSleepCapNs = 256;              // poll back-off cap

enum { kErrOverlap = 1, kErrForward = 2, kErrTimeout = 4, kErrPlace = 8 };

struct Plane {
  int* px;             // (H, W), updated in place
  const int* res;      // (H, W) residual canvas
  const int* meta;     // (n_meta, 8) rows in decode order
  int* owner;          // (ceil(H/4), ceil(W/4)), zeroed
  const int* px_in;    // (H, W), the plane at launch (px's source)
  int n_meta, H, W, c_idx;
};

struct IntraLaunch {
  Plane p[3];
  int* tickets;        // (3,), zeroed
  int* error;          // (1,), zeroed
  int n_planes, bd, strong, c444;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int absi(int v) { return v < 0 ? -v : v; }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;"
               ::: "memory");
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int block_log2(int log2n, int c_idx, int c444) {
  return clampi(log2n, 2, (c_idx == 0 || c444) ? 5 : 4);
}

__global__ void __launch_bounds__(kOwnerThreads)
owner_kernel(const __grid_constant__ IntraLaunch q) {
  const Plane& P = q.p[blockIdx.y];
  const int row = blockIdx.x * (kOwnerThreads / 64) + (threadIdx.x >> 6);
  if (row >= P.n_meta) return;
  const int* m = P.meta + 8 * row;
  if (m[7] == 0) return;
  const int x = m[0], y = m[1];
  const int slot = threadIdx.x & 63;
  if (x < 0 || y < 0 || ((x | y) & 3)) {
    if (slot == 0) atomicOr(q.error, kErrPlace);
    return;
  }
  const int n = 1 << block_log2(m[2], P.c_idx, q.c444);
  const int uw = (min(x + n, P.W) - x + 3) >> 2;   // units inside the plane
  const int uh = (min(y + n, P.H) - y + 3) >> 2;
  const int du = slot >> 3, dv = slot & 7;
  if (du >= uh || dv >= uw) return;
  int* o = P.owner + ((y >> 2) + du) * ((P.W + 3) >> 2) + (x >> 2) + dv;
  if (atomicCAS(o, 0, row + 1) != 0) {
    atomicOr(q.error, kErrOverlap);
    return;
  }
  const int y0 = y + 4 * du, x0 = x + 4 * dv;     // mark: not yet written
  for (int r = y0; r < min(y0 + 4, P.H); ++r)
    for (int c = x0; c < min(x0 + 4, P.W); ++c) P.px[r * P.W + c] = -1;
}

// Block b reads sample (yy, xx): its final value.  Samples that no block
// writes are final at launch; b's own are read as they were at launch (b
// reads before it writes, as the sequential walk does); samples of an
// earlier block are polled until that block has stored them.
__device__ int read_final(const Plane& P, int b, int yy, int xx, int* err) {
  const int i = yy * P.W + xx;
  const int o = __ldg(P.owner + (yy >> 2) * ((P.W + 3) >> 2) + (xx >> 2)) - 1;
  if (o < 0 || o == b) return __ldg(P.px_in + i);
  if (o > b) {
    atomicOr(err, kErrForward);
    return __ldg(P.px_in + i);
  }
  int v = ld_relaxed(P.px + i);
  if (v >= 0) return v;
  const long long t0 = globaltimer();
  unsigned sleep = 32;
  for (unsigned k = 1;; ++k) {
    __nanosleep(sleep);
    sleep = min(sleep * 2, kSleepCapNs);
    v = ld_relaxed(P.px + i);
    if (v >= 0) return v;
    if ((k & 63) == 0) {
      if (ld_acquire(err)) return 0;
      if (globaltimer() - t0 > kWaitNs) {
        atomicOr(err, kErrTimeout);
        return 0;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const __grid_constant__ IntraLaunch q) {
  const int tid = threadIdx.x;
  const int maxv = (1 << q.bd) - 1;
  const int mid = 1 << (q.bd - 1);

  // the task, (plane << 24) | row or -1 when no block is left, and its
  // metadata, double-buffered so that thread 0 may take the next block
  // while the others still store the current one
  __shared__ int s_task2[2];
  __shared__ int s_meta2[2][8];
  __shared__ int raw[kRef];        // raw[i] = P[yt, x+i]      (i < 2n)
  __shared__ int lrow[kRef];       // lrow[j] = P[y+j, xl]     (j < 2n)
  __shared__ int s_corner;         // P[yt, xl]
  __shared__ int refT[kRef], refL[kRef];   // final references [0..2n]
  __shared__ int s_res[32 * 32];           // the block's residual

  if (ld_acquire(q.error)) return;          // the owner pass failed
  int next_plane = blockIdx.x % q.n_planes;  // thread 0's round robin
  int exhausted = 0;
  const int all = (1 << q.n_planes) - 1;

  for (int it = 0;; it ^= 1) {
    int* s_meta = s_meta2[it];
    // ---- take the next block, in decode order, of the next plane ----
    if (tid == 0) {
      int task = -1;
      while (task < 0 && exhausted != all) {
        const int pl = next_plane;
        next_plane = pl + 1 == q.n_planes ? 0 : pl + 1;
        if ((exhausted >> pl) & 1) continue;
        const int t = atomicAdd(q.tickets + pl, 1);
        if (t >= q.p[pl].n_meta) {
          exhausted |= 1 << pl;
          continue;
        }
        const int* m = q.p[pl].meta + 8 * t;
        if (m[7] == 0) continue;
        for (int f = 0; f < 8; ++f) s_meta[f] = m[f];
        task = (pl << 24) | t;
      }
      s_task2[it] = task;
    }
    __syncthreads();
    const int task = s_task2[it];
    if (task < 0) return;
    const int b = task & 0xFFFFFF;
    const Plane& P = q.p[task >> 24];
    const int H = P.H, W = P.W, c_idx = P.c_idx;
    const bool big = (c_idx == 0) || q.c444;
    const int x = s_meta[0], y = s_meta[1];
    const int log2n = block_log2(s_meta[2], c_idx, q.c444);
    const int mode = s_meta[3], angle = s_meta[4], inv = s_meta[5];
    const int flags = s_meta[6];
    const int n = 1 << log2n, nn = n * n;

    // ---- the residual is final at launch: copy it while waiting ----
    for (int k = tid; k < nn; k += kThreads) {
      const int gy = y + (k >> log2n), gx = x + (k & (n - 1));
      if (gy < H && gx < W) cp_async4(s_res + k, P.res + gy * W + gx);
    }

    // ---- 1. each used neighbour, once its writer has stored it ----
    const bool cbl = flags & 1, cl = flags & 2, cul = flags & 4,
               cu = flags & 8, cur = flags & 16;
    const int yt = max(y - 1, 0), xl = max(x - 1, 0);
    for (int k = tid; k <= 4 * n; k += kThreads) {
      int yy, xx;
      bool used;
      int* dst;
      if (k < 2 * n) {
        yy = yt;
        xx = min(x + k, W - 1);
        used = k < n ? cu : cur;
        dst = raw + k;
      } else if (k < 4 * n) {
        const int j = k - 2 * n;
        yy = min(y + j, H - 1);
        xx = xl;
        used = j < n ? cl : cbl;
        dst = lrow + j;
      } else {
        yy = yt;
        xx = xl;
        used = cul;
        dst = &s_corner;
      }
      if (used) *dst = read_final(P, b, yy, xx, q.error);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- 2. substitution cascade (intra_pallas.py:206-242) and
    // reference smoothing (spec 8.4.4.2.3); unread entries are unused ----
    const int cr = s_corner;
    const int fill_bl = cl ? lrow[n - 1] : cul ? cr : cu ? raw[0]
                      : cur ? raw[n] : mid;
    const int fill_l = cul ? cr : cu ? raw[0] : cur ? raw[n] : mid;
    const int lh0 = cbl ? lrow[n] : fill_bl;
    const int ll0_res = cl ? lrow[0] : (cbl ? lh0 : fill_l);
    const int corner = cul ? cr : (cl || cbl) ? ll0_res
                     : cu ? raw[0] : cur ? raw[n] : mid;
    const int topn_res = cu ? raw[n - 1] : corner;
    auto top = [&](int i) {
      return i == 0 ? corner : i <= n ? (cu ? raw[i - 1] : corner)
                                      : (cur ? raw[i - 1] : topn_res);
    };
    auto left = [&](int i) {
      return i == 0 ? corner : i <= n ? (cl ? lrow[i - 1]
                                            : (cbl ? lh0 : fill_l))
                                      : (cbl ? lrow[i - 1] : fill_bl);
    };
    const bool filt = big && n != 4 && (flags & 32);
    bool bil = false;
    if (filt && q.strong && n == 32 && c_idx == 0) {
      const int th = 1 << (q.bd - 5);
      bil = absi(top(0) + top(64) - 2 * top(32)) < th &&
            absi(left(0) + left(64) - 2 * left(32)) < th;
    }
    for (int i = tid; i <= 2 * n; i += kThreads) {
      int t, l;
      if (!filt || i == 2 * n || (bil && i == 0)) {
        t = top(i);
        l = left(i);
      } else if (bil) {
        t = ((64 - i) * corner + i * top(64) + 32) >> 6;
        l = ((64 - i) * corner + i * left(64) + 32) >> 6;
      } else if (i == 0) {
        t = l = (left(1) + 2 * corner + top(1) + 2) >> 2;
      } else {
        t = (top(i + 1) + 2 * top(i) + top(i - 1) + 2) >> 2;
        l = (left(i + 1) + 2 * left(i) + left(i - 1) + 2) >> 2;
      }
      refT[i] = t;
      refL[i] = l;
    }
    __syncthreads();

    // ---- 3. prediction + residual + clip + store ----
    const int* T = refT;
    const int* L = refL;
    int dc = 0;
    if (mode == 1) {
      int s = n;
      for (int i = 1; i <= n; ++i) s += T[i] + L[i];
      dc = s >> (log2n + 1);
    }
    const bool is_ver = mode >= 18;
    const int* mainr = is_ver ? T : L;
    const int* side = is_ver ? L : T;
    for (int k = tid; k < nn; k += kThreads) {
      const int r = k >> log2n, c = k & (n - 1);
      int pred;
      if (mode == 0) {
        pred = ((n - 1 - c) * L[r + 1] + (c + 1) * T[n + 1] +
                (n - 1 - r) * T[c + 1] + (r + 1) * L[n + 1] + n) >>
               (log2n + 1);
      } else if (mode == 1) {
        pred = dc;
        if (c_idx == 0 && n < 32) {
          if (r == 0 && c == 0)
            pred = (L[1] + 2 * dc + T[1] + 2) >> 2;
          else if (r == 0)
            pred = (T[c + 1] + 3 * dc + 2) >> 2;
          else if (c == 0)
            pred = (L[r + 1] + 3 * dc + 2) >> 2;
        }
      } else {
        const int yy = is_ver ? r : c, xx = is_ver ? c : r;
        if (c_idx == 0 && n < 32 && (mode == 26 || mode == 10) && xx == 0) {
          pred = clampi(mainr[1] + ((side[yy + 1] - side[0]) >> 1), 0, maxv);
        } else {
          const int pos = (yy + 1) * angle;
          const int idx = pos >> 5, fact = pos & 31;
          // ref[k] = main[k] (k >= 0), else the projected side sample
          const int k0 = xx + idx + 1;
          int a = k0 >= 0 ? (k0 <= 2 * n ? mainr[k0] : 0)
                          : side[clampi((k0 * inv + 128) >> 8, 0, 2 * n)];
          if (fact != 0) {
            const int k1 = k0 + 1;
            const int b1 = k1 >= 0 ? (k1 <= 2 * n ? mainr[k1] : 0)
                                   : side[clampi((k1 * inv + 128) >> 8, 0,
                                                 2 * n)];
            a = ((32 - fact) * a + fact * b1 + 16) >> 5;
          }
          pred = a;
        }
      }
      const int gy = y + r, gx = x + c;
      if (gy < H && gx < W)
        st_relaxed(P.px + gy * W + gx, clampi(pred + s_res[k], 0, maxv));
    }
  }
}

// Resident workers: every SM holds min(occupancy, kWorkersPerSm) of them.
int workers() {
  static int sms = 0, occ = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, wavefront_kernel,
                                                  kThreads, 0);
  }
  return max(sms, 1) * max(min(occ, kWorkersPerSm), 1);
}

}  // namespace

extern "C" int ohk_intra_size() { return (int)sizeof(IntraLaunch); }

// launch: a host IntraLaunch, copied into both launches' parameters.
extern "C" int ohk_intra(const void* launch, void* stream) {
  const IntraLaunch& q = *static_cast<const IntraLaunch*>(launch);
  if (q.n_planes < 1 || q.n_planes > 3) return (int)cudaErrorInvalidValue;
  int rows = 0, most = 0;
  for (int i = 0; i < q.n_planes; ++i) {
    if (q.p[i].n_meta < 0 || q.p[i].n_meta >= (1 << 24))
      return (int)cudaErrorInvalidValue;
    rows += q.p[i].n_meta;
    most = max(most, q.p[i].n_meta);
  }
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 og((most + kOwnerThreads / 64 - 1) / (kOwnerThreads / 64),
                q.n_planes);
  owner_kernel<<<og, kOwnerThreads, 0, s>>>(q);
  int err = (int)cudaGetLastError();
  if (err) return err;
  wavefront_kernel<<<min(workers(), rows), kThreads, 0, s>>>(q);
  return (int)cudaGetLastError();
}
