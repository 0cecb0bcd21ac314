// Shared definitions for the ParaQAOA CUDA kernels (sm_90a).
//
// Every entry point has a plain C interface: device pointers and the
// stream arrive as void*, sizes as int64/int. An entry point launches on
// the stream it is given, never synchronises, allocates nothing (the
// Python wrapper allocates outputs and temporary buffers), and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// Below the butterfly, the staging helpers of the persistent kernels
// (betagrad.cu, mixer.cu): mbarriers, bulk and TMA copies between device
// memory and shared memory, and the 3-D tensor map over runs of a row.
#pragma once

#include <cuda.h>  // CUtensorMap (encoded through the runtime's driver entry point)
#include <cuda_runtime.h>
#include <stdint.h>

#define PQ_EXPORT extern "C" __attribute__((visibility("default")))

namespace pq {

constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kTile = 4096;    // amplitudes a mixer block holds in shared memory

// Insert a zero bit at position q of v: maps a pair index onto the index
// of the pair's bit-q-clear element.
__device__ __forceinline__ int insert_zero_bit(int v, int q) {
  const int low = v & ((1 << q) - 1);
  return ((v >> q) << (q + 1)) | low;
}

// One RX(2 beta) = [[c, -i s], [-i s, c]] butterfly on the amplitude pair
// (r0 + i m0, r1 + i m1), the second with the target qubit set; c =
// cos(beta), s = sin(beta). k such butterflies, one per qubit, apply
// RX(2 beta)^{⊗k}: 6 flops per amplitude per qubit, where the dense
// 2^k x 2^k product would take 8 * 2^k.
__device__ __forceinline__ void rx(float& r0, float& m0, float& r1, float& m1, float c,
                                   float s) {
  const float a0 = r0, b0 = m0, a1 = r1, b1 = m1;
  r0 = c * a0 + s * b1;
  m0 = c * b0 - s * a1;
  r1 = c * a1 + s * b0;
  m1 = c * b1 - s * a0;
}

// `rx` on the pair (i0, i1) of a shared-memory tile.
__device__ __forceinline__ void rx_pair(float* s_re, float* s_im, int i0,
                                        int i1, float c, float s) {
  float r0 = s_re[i0], m0 = s_im[i0], r1 = s_re[i1], m1 = s_im[i1];
  rx(r0, m0, r1, m1, c, s);
  s_re[i0] = r0;
  s_im[i0] = m0;
  s_re[i1] = r1;
  s_im[i1] = m1;
}

// a copy that never lands (a refused tensor map) traps after ~10 s of
// cycles instead of hanging the card
constexpr long long kWaitCycles = 20000000000LL;
constexpr int kMaxBox = 256;  // TMA box extent

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > kWaitCycles) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// device memory -> shared memory, one contiguous run
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// device memory -> shared memory, one box of a 3-D tensor map
__device__ __forceinline__ void tma_3d(float* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// shared memory -> device memory, one box of a 3-D tensor map, in the
// issuing thread's current bulk group
__device__ __forceinline__ void tma_3d_store(const CUtensorMap* map, const float* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the threads' writes to shared memory, ordered before a bulk copy reads them
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of the issuing thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until every bulk group of the issuing thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (box_inner, Y / box_inner, rows) f32 map of a plane whose rows are
// y_dim long: a box is the (box_inner, lanes / box_inner, box_rows) block,
// so it lands in shared memory as box_rows rows of `lanes`. False where
// the driver refuses it.
inline bool encode_runs(CUtensorMap* map, const void* base, int64_t y_dim, int64_t rows,
                        int64_t lanes, int box_inner, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(box_inner),
                              static_cast<cuuint64_t>(y_dim / box_inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(box_inner * sizeof(float)),
                                 static_cast<cuuint64_t>(y_dim * sizeof(float))};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(lanes / box_inner),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace pq
