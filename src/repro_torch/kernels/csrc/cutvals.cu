// Diagonal objective of every basis state, batched over subgraphs.
//
// Replaces: src/repro/kernels/cutvals.py::_kernel (pallas_call at
// cutvals.py:78), which recasts the sum as a (tile x E) bit plane times
// a weight vector on the MXU.
//
// Computes: c[b, x] = sum_e w[b, e] * (((x >> i_e) ^ (x >> j_e)) & 1) for
// every basis index x < 2^n of every batch row b. Linear terms arrive as
// appended (v, 30, h_v) rows; padding rows (0, 0, 0) add zero.
//
// Bound on the H100: operations, not bytes. It writes 4 bytes per basis
// state but does ~6 integer/float operations per (state, edge) pair, and
// a 24-qubit subgraph carries a few hundred edge rows.
//
// Design: one thread per basis state, so no reduction across threads and
// no atomics. A block stages its batch row's edge list in shared memory,
// chunk by chunk; every thread reads the same edge at the same time, a
// broadcast with no bank conflict. Each thread accumulates in f32 in edge
// order, as the plain version does (ref.cutvals), so the two agree bit
// for bit and integer weights give exact integers. The product w * bit is
// exact (bit is 0 or 1), so contracting it into an FMA changes nothing.
#include "common.cuh"

namespace {

constexpr int kEdgeChunk = 1024;

__global__ void __launch_bounds__(pq::kThreads)
cutvals_kernel(const int32_t* __restrict__ edges,
               const float* __restrict__ weights, float* __restrict__ out,
               int64_t n_edges, int log2_dim, int64_t blocks_per_row) {
  __shared__ int32_t s_i[kEdgeChunk];
  __shared__ int32_t s_j[kEdgeChunk];
  __shared__ float s_w[kEdgeChunk];
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t blk = blockIdx.x % blocks_per_row;
  const int64_t dim = int64_t(1) << log2_dim;
  const int64_t pos = blk * pq::kThreads + threadIdx.x;
  const int32_t x = static_cast<int32_t>(pos);
  const int32_t* e = edges + row * n_edges * 2;
  const float* w = weights + row * n_edges;
  float acc = 0.f;
  for (int64_t base = 0; base < n_edges; base += kEdgeChunk) {
    const int cnt = static_cast<int>(
        n_edges - base < kEdgeChunk ? n_edges - base : kEdgeChunk);
    __syncthreads();  // previous chunk fully consumed
    for (int t = threadIdx.x; t < cnt; t += pq::kThreads) {
      s_i[t] = e[2 * (base + t)];
      s_j[t] = e[2 * (base + t) + 1];
      s_w[t] = w[base + t];
    }
    __syncthreads();
    if (pos < dim) {
      for (int t = 0; t < cnt; ++t) {
        const int crossed = ((x >> s_i[t]) ^ (x >> s_j[t])) & 1;
        acc = acc + s_w[t] * static_cast<float>(crossed);
      }
    }
  }
  if (pos < dim) out[row * dim + pos] = acc;
}

}  // namespace

// edges (B, E, 2) int32, weights (B, E) f32, out (B, 2^log2_dim) f32.
PQ_EXPORT int pq_cutvals(const void* edges, const void* weights, void* out,
                         int64_t batch, int64_t n_edges, int log2_dim,
                         void* stream) {
  const int64_t dim = int64_t(1) << log2_dim;
  const int64_t blocks_per_row = (dim + pq::kThreads - 1) / pq::kThreads;
  cutvals_kernel<<<static_cast<unsigned>(batch * blocks_per_row), pq::kThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edges), static_cast<const float*>(weights),
      static_cast<float*>(out), n_edges, log2_dim, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}
