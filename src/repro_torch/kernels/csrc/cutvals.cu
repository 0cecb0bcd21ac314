// Diagonal objective of basis states, batched over subgraphs: of every
// state (pq_cutvals) or of the states an index table names (pq_cutvals_at).
//
// Replaces: src/repro/kernels/cutvals.py::_kernel (pallas_call at
// cutvals.py:78) and cutvals.py::_at_kernel (pallas_call at :141), which
// recast the sum as a (tile x E) bit plane times a weight vector on the MXU.
//
// Computes: c[r, p] = sum_e w[b, e] * (((x >> i_e) ^ (x >> j_e)) & 1) with
//   pq_cutvals:    r = b, x = p, for every p < 2^n;
//   pq_cutvals_at: r = b * S + s, x = idx[s, p], for an (S, L) int32 table
//                  shared by every edge row b (the sharded statevector's
//                  layout-A/B maps depend on the shard, not the subgraph).
// Linear terms arrive as appended (v, 30, h_v) rows; padding rows (0, 0, 0)
// add zero.
//
// Bound on the H100: integer issue, not bytes. It writes 4 bytes per state
// (and pq_cutvals_at reads 4 bytes of index) but does ~6 integer/float
// operations per (state, edge) pair, and a 24-26-qubit subgraph carries a
// few dozen edge rows.
//
// Design: one thread per state, so no reduction across threads and no
// atomics. A block stages its batch row's edge list in shared memory,
// chunk by chunk; every thread reads the same edge at the same time, a
// broadcast with no bank conflict. Each thread accumulates in f32 in edge
// order, as the plain version does (ref.cutvals_at), so the two agree bit
// for bit and integer weights give exact integers. The product w * bit is
// exact (bit is 0 or 1), so contracting it into an FMA changes nothing.
#include "common.cuh"

namespace {

constexpr int kEdgeChunk = 1024;

// kIndexed: the state comes from idx[(row % idx_rows) * width + pos] and
// the edge row is row / idx_rows; otherwise the state is pos itself.
template <bool kIndexed>
__global__ void __launch_bounds__(pq::kThreads)
cutvals_kernel(const int32_t* __restrict__ idx,
               const int32_t* __restrict__ edges,
               const float* __restrict__ weights, float* __restrict__ out,
               int64_t n_edges, int64_t width, int64_t idx_rows,
               int64_t blocks_per_row) {
  __shared__ int32_t s_i[kEdgeChunk];
  __shared__ int32_t s_j[kEdgeChunk];
  __shared__ float s_w[kEdgeChunk];
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t blk = blockIdx.x % blocks_per_row;
  const int64_t pos = blk * pq::kThreads + threadIdx.x;
  const int64_t edge_row = kIndexed ? row / idx_rows : row;
  int32_t x = static_cast<int32_t>(pos);
  if (kIndexed && pos < width) x = idx[(row % idx_rows) * width + pos];
  const int32_t* e = edges + edge_row * n_edges * 2;
  const float* w = weights + edge_row * n_edges;
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
    if (pos < width) {
      for (int t = 0; t < cnt; ++t) {
        const int crossed = ((x >> s_i[t]) ^ (x >> s_j[t])) & 1;
        acc = acc + s_w[t] * static_cast<float>(crossed);
      }
    }
  }
  if (pos < width) out[row * width + pos] = acc;
}

template <bool kIndexed>
int launch(const void* idx, const void* edges, const void* weights,
           void* out, int64_t rows, int64_t n_edges, int64_t width,
           int64_t idx_rows, void* stream) {
  const int64_t blocks_per_row = (width + pq::kThreads - 1) / pq::kThreads;
  cutvals_kernel<kIndexed>
      <<<static_cast<unsigned>(rows * blocks_per_row), pq::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(idx),
          static_cast<const int32_t*>(edges),
          static_cast<const float*>(weights), static_cast<float*>(out),
          n_edges, width, idx_rows, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// edges (B, E, 2) int32, weights (B, E) f32, out (B, 2^log2_dim) f32.
PQ_EXPORT int pq_cutvals(const void* edges, const void* weights, void* out,
                         int64_t batch, int64_t n_edges, int log2_dim,
                         void* stream) {
  return launch<false>(nullptr, edges, weights, out, batch, n_edges,
                       int64_t(1) << log2_dim, 1, stream);
}

// idx (S, L) int32, edges (B, E, 2) int32, weights (B, E) f32,
// out (B * S, L) f32: row b * S + s holds edge row b at the states idx[s].
PQ_EXPORT int pq_cutvals_at(const void* idx, const void* edges,
                            const void* weights, void* out, int64_t batch,
                            int64_t idx_rows, int64_t width, int64_t n_edges,
                            void* stream) {
  return launch<true>(idx, edges, weights, out, batch * idx_rows, n_edges,
                      width, idx_rows, stream);
}
