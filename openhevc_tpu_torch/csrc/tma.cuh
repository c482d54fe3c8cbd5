// 2-D tiles by the Tensor Memory Accelerator, for the kernels that load
// them (K4 in filter.cu, X3 in upsample.cu): the driver's
// cuTensorMapEncodeTiled, looked up once, a map over an int32 plane, and
// the mbarrier and bulk-tensor instructions one load needs.
#pragma once

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace ohk {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda);
// looked up once, under a once flag (launches come from several threads);
// null when the driver has none
inline EncodeTiled encode_tiled() {
  static std::once_flag once;
  static EncodeTiled fn = nullptr;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A map over the int32 plane (rows, cols) at src, rows of cols * 4 bytes
// (a multiple of 16), boxes of (box_rows, box_cols) (box_cols * 4 a
// multiple of 16, both sides at most 256); TMA fills what lies outside the
// plane with zeros.
inline CUresult encode_int32_2d(EncodeTiled encode, CUtensorMap* map,
                                const void* src, int rows, int cols,
                                int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(src),
                dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread: an mbarrier that one arrival (with its bytes) completes
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: the box at (x, y) of `map` into shared memory at dst, its
// `bytes` reported to the mbarrier at bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar)
      : "memory");
}

// every thread that reads the box: wait for phase `parity` of bar
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

}  // namespace ohk
