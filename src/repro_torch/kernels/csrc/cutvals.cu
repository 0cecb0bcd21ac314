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
// Design: a block scores `tile_b` consecutive states of one row, with
// min(tile_b, 256) threads that each own tile_b / threads of them (1, 2,
// 4 or 8 states, strided by the thread count so stores stay coalesced),
// so no reduction across threads and no atomics. A block stages its edge
// row in shared memory, `edge_chunk` edges at a time; every thread reads
// the same edge at the same time, a broadcast with no bank conflict, and
// applies it to each of its states, so a thread with several states reads
// shared memory less often per (state, edge) pair. Each state accumulates
// in f32 in edge order, as the plain version does (ref.cutvals_at), so the
// two agree bit for bit whatever tile_b and edge_chunk are, and integer
// weights give exact integers. The product w * bit is exact (bit is 0 or
// 1), so contracting it into an FMA changes nothing. Defaults (the
// wrapper's, with tuning off): tile_b 256, edge_chunk 1024.
#include "common.cuh"

namespace {

constexpr int kEdgeChunk = 1024;  // largest edge_chunk: the shared arrays' size

// kIndexed: the state comes from idx[(row % idx_rows) * width + pos] and
// the edge row is row / idx_rows; otherwise the state is pos itself.
// kPer: states per thread.
template <bool kIndexed, int kPer>
__global__ void __launch_bounds__(pq::kThreads)
cutvals_kernel(const int32_t* __restrict__ idx,
               const int32_t* __restrict__ edges,
               const float* __restrict__ weights, float* __restrict__ out,
               int64_t n_edges, int64_t width, int64_t idx_rows,
               int64_t blocks_per_row, int edge_chunk) {
  __shared__ int32_t s_i[kEdgeChunk];
  __shared__ int32_t s_j[kEdgeChunk];
  __shared__ float s_w[kEdgeChunk];
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t blk = blockIdx.x % blocks_per_row;
  const int64_t first = blk * blockDim.x * kPer + threadIdx.x;
  const int64_t edge_row = kIndexed ? row / idx_rows : row;
  int32_t x[kPer];
  float acc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t pos = first + static_cast<int64_t>(u) * blockDim.x;
    x[u] = static_cast<int32_t>(pos);
    if (kIndexed && pos < width) x[u] = idx[(row % idx_rows) * width + pos];
    acc[u] = 0.f;
  }
  const int32_t* e = edges + edge_row * n_edges * 2;
  const float* w = weights + edge_row * n_edges;
  for (int64_t base = 0; base < n_edges; base += edge_chunk) {
    const int cnt = static_cast<int>(
        n_edges - base < edge_chunk ? n_edges - base : edge_chunk);
    __syncthreads();  // previous chunk fully consumed
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      s_i[t] = e[2 * (base + t)];
      s_j[t] = e[2 * (base + t) + 1];
      s_w[t] = w[base + t];
    }
    __syncthreads();
    for (int t = 0; t < cnt; ++t) {
      const int32_t ei = s_i[t], ej = s_j[t];
      const float ew = s_w[t];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int crossed = ((x[u] >> ei) ^ (x[u] >> ej)) & 1;
        acc[u] = acc[u] + ew * static_cast<float>(crossed);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t pos = first + static_cast<int64_t>(u) * blockDim.x;
    if (pos < width) out[row * width + pos] = acc[u];
  }
}

template <bool kIndexed, int kPer>
void launch_per(const void* idx, const void* edges, const void* weights,
                void* out, int64_t rows, int64_t n_edges, int64_t width,
                int64_t idx_rows, int threads, int edge_chunk,
                cudaStream_t st) {
  const int64_t tile_b = static_cast<int64_t>(threads) * kPer;
  const int64_t blocks_per_row = (width + tile_b - 1) / tile_b;
  cutvals_kernel<kIndexed, kPer>
      <<<static_cast<unsigned>(rows * blocks_per_row), threads, 0, st>>>(
          static_cast<const int32_t*>(idx),
          static_cast<const int32_t*>(edges),
          static_cast<const float*>(weights), static_cast<float*>(out),
          n_edges, width, idx_rows, blocks_per_row, edge_chunk);
}

// tile_b: a power of two in [32, 8 * kThreads]; edge_chunk in [1, kEdgeChunk]
template <bool kIndexed>
int launch(const void* idx, const void* edges, const void* weights,
           void* out, int64_t rows, int64_t n_edges, int64_t width,
           int64_t idx_rows, int64_t tile_b, int64_t edge_chunk,
           void* stream) {
  if (tile_b < 32 || tile_b > 8 * pq::kThreads || (tile_b & (tile_b - 1)) ||
      edge_chunk < 1 || edge_chunk > kEdgeChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads =
      static_cast<int>(tile_b < pq::kThreads ? tile_b : pq::kThreads);
  const int per = static_cast<int>(tile_b / threads);
  const int chunk = static_cast<int>(edge_chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: launch_per<kIndexed, 1>(idx, edges, weights, out, rows, n_edges,
                                    width, idx_rows, threads, chunk, st); break;
    case 2: launch_per<kIndexed, 2>(idx, edges, weights, out, rows, n_edges,
                                    width, idx_rows, threads, chunk, st); break;
    case 4: launch_per<kIndexed, 4>(idx, edges, weights, out, rows, n_edges,
                                    width, idx_rows, threads, chunk, st); break;
    default: launch_per<kIndexed, 8>(idx, edges, weights, out, rows, n_edges,
                                     width, idx_rows, threads, chunk, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// edges (B, E, 2) int32, weights (B, E) f32, out (B, 2^log2_dim) f32.
PQ_EXPORT int pq_cutvals(const void* edges, const void* weights, void* out,
                         int64_t batch, int64_t n_edges, int log2_dim,
                         int64_t tile_b, int64_t edge_chunk, void* stream) {
  return launch<false>(nullptr, edges, weights, out, batch, n_edges,
                       int64_t(1) << log2_dim, 1, tile_b, edge_chunk, stream);
}

// idx (S, L) int32, edges (B, E, 2) int32, weights (B, E) f32,
// out (B * S, L) f32: row b * S + s holds edge row b at the states idx[s].
PQ_EXPORT int pq_cutvals_at(const void* idx, const void* edges,
                            const void* weights, void* out, int64_t batch,
                            int64_t idx_rows, int64_t width, int64_t n_edges,
                            int64_t tile_b, int64_t edge_chunk, void* stream) {
  return launch<true>(idx, edges, weights, out, batch * idx_rows, n_edges,
                      width, idx_rows, tile_b, edge_chunk, stream);
}
