// The diagonal cost layer and its expectation, batched over subgraphs.
//
// pq_apply_phase replaces src/repro/kernels/phase.py::_phase_kernel
// (pallas_call at phase.py:45), an elementwise pass over one statevector
// with one gamma. It computes, per batch row b with its own gamma[b]:
//   (re, im) <- (re cos(gamma c) + im sin(gamma c), im cos(gamma c) - re sin(gamma c)).
// Bound on the H100: bytes. It reads re, im, c (12 bytes per amplitude)
// and writes re, im (8 bytes), against one sincos and 7 flops.
// Design: a one-dimensional grid of (B * dim) / tile blocks; a block owns
// `tile` consecutive amplitudes of one row (tile divides dim, so no block
// straddles two rows and each reads one gamma). Neighbouring threads take
// neighbouring amplitudes, so every load and store is coalesced. The angle
// is rounded as the plain version rounds it (__fmul_rn, then the
// full-precision sincosf), and the products and sums are not contracted
// into FMAs, so every tile gives the same bits.
//
// pq_expectation replaces src/repro/kernels/phase.py::_exp_kernel
// (pallas_call at phase.py:90), which carries one running sum across the
// sequential TPU grid. It computes out[b] = sum_x (re^2 + im^2) * c, f32.
// Bound on the H100: bytes. It reads 12 bytes per amplitude and does
// 4 flops on them.
// Design: GPU blocks run in no order, so the running sum becomes a
// deterministic two-pass reduction with no atomics. Pass 1: `parts`
// blocks per batch row each sum a contiguous chunk (grid-stride per
// thread, then a fixed shared-memory tree) into partial[b, p]. Pass 2:
// one block per row sums its `parts` partials the same way. The order of
// every addition depends only on the shapes and `parts`, so the same
// inputs give the same bits on every run. The product and sum per element
// are rounded as the plain version rounds them (__fmul_rn/__fadd_rn, no
// FMA contraction).
//
// pq_phase_grad is the phase rule's gamma cotangent of the layer backward
// (and of the standalone phase), which the JAX package leaves to XLA
// (jnp.sum(cutv * t) at src/repro/kernels/ops.py:263 and :431). It
// computes out[b] = sum_x c * (im * g_re - re * g_im), f32: five planes
// read (20 bytes per amplitude), 4 flops. A torch reduction over the row
// picks its block shape and its split across blocks from the number of
// rows, so its bits would depend on the batch a row is solved in; this
// one sums in the expectation's two passes, whose order depends only on
// the row length and `parts`.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pq::kThreads)
apply_phase_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ cutv,
                   const float* __restrict__ gamma, float* __restrict__ ore,
                   float* __restrict__ oim, int64_t blocks_per_row,
                   int64_t tile) {
  const float g = gamma[blockIdx.x / blocks_per_row];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  for (int64_t e = threadIdx.x; e < tile; e += pq::kThreads) {
    const int64_t i = base + e;
    float s, c;
    sincosf(__fmul_rn(g, cutv[i]), &s, &c);
    const float x = re[i], y = im[i];
    ore[i] = __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
    oim[i] = __fsub_rn(__fmul_rn(y, c), __fmul_rn(x, s));
  }
}

__device__ __forceinline__ float block_sum(float v, float* s_buf) {
  s_buf[threadIdx.x] = v;
  __syncthreads();
  for (int stride = pq::kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s_buf[threadIdx.x] += s_buf[threadIdx.x + stride];
    __syncthreads();
  }
  return s_buf[0];
}

__global__ void __launch_bounds__(pq::kThreads)
expectation_partial_kernel(const float* __restrict__ re,
                           const float* __restrict__ im,
                           const float* __restrict__ cutv,
                           float* __restrict__ partial, int64_t dim,
                           int64_t parts) {
  __shared__ float s_buf[pq::kThreads];
  const int64_t b = blockIdx.x / parts;
  const int64_t p = blockIdx.x % parts;
  const int64_t chunk = dim / parts;
  const int64_t begin = b * dim + p * chunk;
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < chunk; i += pq::kThreads) {
    const float x = re[begin + i], y = im[begin + i];
    const float prob = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
    acc = __fadd_rn(acc, __fmul_rn(prob, cutv[begin + i]));
  }
  const float total = block_sum(acc, s_buf);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(pq::kThreads)
phase_grad_partial_kernel(const float* __restrict__ re,
                          const float* __restrict__ im,
                          const float* __restrict__ g_re,
                          const float* __restrict__ g_im,
                          const float* __restrict__ cutv,
                          float* __restrict__ partial, int64_t dim,
                          int64_t parts) {
  __shared__ float s_buf[pq::kThreads];
  const int64_t b = blockIdx.x / parts;
  const int64_t p = blockIdx.x % parts;
  const int64_t chunk = dim / parts;
  const int64_t begin = b * dim + p * chunk;
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < chunk; i += pq::kThreads) {
    const int64_t j = begin + i;
    const float t = __fsub_rn(__fmul_rn(im[j], g_re[j]), __fmul_rn(re[j], g_im[j]));
    acc = __fadd_rn(acc, __fmul_rn(cutv[j], t));
  }
  const float total = block_sum(acc, s_buf);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(pq::kThreads)
expectation_final_kernel(const float* __restrict__ partial,
                         float* __restrict__ out, int64_t parts) {
  __shared__ float s_buf[pq::kThreads];
  const float* row = partial + static_cast<int64_t>(blockIdx.x) * parts;
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < parts; i += pq::kThreads) acc += row[i];
  const float total = block_sum(acc, s_buf);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

}  // namespace

// re, im, cutv, ore, oim (B, dim) f32; gamma (B,) f32; tile divides dim.
PQ_EXPORT int pq_apply_phase(const void* re, const void* im, const void* cutv,
                             const void* gamma, void* ore, void* oim,
                             int64_t batch, int64_t dim, int64_t tile,
                             void* stream) {
  const int64_t blocks_per_row = dim / tile;
  apply_phase_kernel<<<static_cast<unsigned>(batch * blocks_per_row),
                       pq::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(cutv), static_cast<const float*>(gamma),
      static_cast<float*>(ore), static_cast<float*>(oim), blocks_per_row,
      tile);
  return static_cast<int>(cudaGetLastError());
}

// re, im, cutv (B, dim) f32; partial (B, parts) f32 temporary; out (B,) f32.
// parts divides dim.
PQ_EXPORT int pq_expectation(const void* re, const void* im, const void* cutv,
                             void* partial, void* out, int64_t batch,
                             int64_t dim, int64_t parts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  expectation_partial_kernel<<<static_cast<unsigned>(batch * parts),
                               pq::kThreads, 0, st>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(cutv), static_cast<float*>(partial), dim,
      parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expectation_final_kernel<<<static_cast<unsigned>(batch), pq::kThreads, 0,
                             st>>>(static_cast<const float*>(partial),
                                   static_cast<float*>(out), parts);
  return static_cast<int>(cudaGetLastError());
}

// re, im, g_re, g_im, cutv (B, dim) f32; partial (B, parts) f32 temporary;
// out (B,) f32. parts divides dim.
PQ_EXPORT int pq_phase_grad(const void* re, const void* im, const void* g_re,
                            const void* g_im, const void* cutv, void* partial,
                            void* out, int64_t batch, int64_t dim,
                            int64_t parts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  phase_grad_partial_kernel<<<static_cast<unsigned>(batch * parts),
                              pq::kThreads, 0, st>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(g_re), static_cast<const float*>(g_im),
      static_cast<const float*>(cutv), static_cast<float*>(partial), dim,
      parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expectation_final_kernel<<<static_cast<unsigned>(batch), pq::kThreads, 0,
                             st>>>(static_cast<const float*>(partial),
                                   static_cast<float*>(out), parts);
  return static_cast<int>(cudaGetLastError());
}
