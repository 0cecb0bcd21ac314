// Cut values of a batch of ±1 spin rows through the dense adjacency.
//
// Replaces: src/repro/kernels/cutbatch.py::_kernel (pallas_call at
// cutbatch.py:58), which walks the K axis of S·A on the MXU into a VMEM
// accumulator carried across the sequential grid, then contracts the
// accumulator with the spin rows in an epilogue.
//
// Computes: out[b] = (W - 0.5 * q[b]) * 0.5 with q[b] = s_b^T A s_b, for
// spins S (B, V) f32 in {-1, +1}, A (V, V) f32 and W = sum w (one f32 on
// the device, so the wrapper never reads it back to the host).
//
// Bound on the H100: operations. 2 * B * V^2 flops on the CUDA cores in
// f32 (no TF32, no tensor cores: the port computes in f32 throughout),
// against 4 * (B * V + V^2) bytes.
//
// Design: a tiled f32 product with the quadratic-form epilogue fused. A
// block owns `batch_tile` rows (BM) and one span of 128 columns; 256
// threads each hold a register tile of BM / 16 rows by 8 columns (rows
// ty + 16 i, columns tx + 16 j). The block walks K in `k_chunk` slices
// (BK), staging the spin slice (transposed) and the adjacency slab in
// shared memory. After the last slice each thread multiplies its tile by
// the spin rows of its columns, sums its 8 columns in order, and the 16
// threads of a row add their sums by a fixed xor-shuffle tree into one
// partial per (row, span). A second pass sums each row's partials over the
// spans in index order and applies the epilogue: no atomics, and the
// order of every addition depends only on V (the K walk is sequential per
// output, the epilogue's order is fixed by the 128-column span), so the
// result is the same bits under every (batch_tile, k_chunk). Spin rows
// and columns of A past B or V read as 0: no padded copies (a padded A at
// V = 16,000 would copy 1 GB). With ±1 spins and integer weights every
// sum is an integer below 2^24 at the shapes used here (|q| <= 2 * sum|w|),
// so the result is exact.
#include "common.cuh"

namespace {

constexpr int kBN = 128;  // columns per span
constexpr int kTN = 8;    // columns per thread: tx + 16 j

template <int BM, int BK>
__global__ void __launch_bounds__(pq::kThreads)
cut_batch_kernel(const float* __restrict__ spins,
                 const float* __restrict__ adj, float* __restrict__ partial,
                 int64_t batch, int64_t v, int64_t row_tiles,
                 int64_t n_spans) {
  constexpr int kTM = BM / 16;
  __shared__ float s_a[BK][BM + 1];  // spin slice, K-major; +1 against conflicts
  __shared__ float s_b[BK][kBN];     // adjacency slab
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t rt = blockIdx.x % row_tiles;
  const int64_t span = blockIdx.x / row_tiles;
  const int64_t row0 = rt * BM, col0 = span * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < v; k0 += BK) {
    for (int e = tid; e < BM * BK; e += pq::kThreads) {
      const int r = e / BK, kk = e % BK;
      const int64_t gr = row0 + r, gk = k0 + kk;
      s_a[kk][r] = (gr < batch && gk < v) ? spins[gr * v + gk] : 0.f;
    }
    for (int e = tid; e < BK * kBN; e += pq::kThreads) {
      const int kk = e / kBN, c = e % kBN;
      const int64_t gk = k0 + kk, gc = col0 + c;
      s_b[kk][c] = (gk < v && gc < v) ? adj[gk * v + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = s_a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = s_b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t gr = row0 + ty + 16 * i;
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t gc = col0 + tx + 16 * j;
      const float s = (gr < batch && gc < v) ? spins[gr * v + gc] : 0.f;
      p = __fadd_rn(p, __fmul_rn(acc[i][j], s));
    }
    // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
    if (tx == 0 && gr < batch) partial[gr * n_spans + span] = p;
  }
}

__global__ void __launch_bounds__(pq::kThreads)
cut_batch_epilogue(const float* __restrict__ partial,
                   const float* __restrict__ wtot, float* __restrict__ out,
                   int64_t batch, int64_t n_spans) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * pq::kThreads + threadIdx.x;
  if (row >= batch) return;
  float q = 0.f;
  for (int64_t s = 0; s < n_spans; ++s)
    q = __fadd_rn(q, partial[row * n_spans + s]);
  out[row] = __fmul_rn(__fsub_rn(wtot[0], __fmul_rn(0.5f, q)), 0.5f);
}

template <int BM, int BK>
void launch_tile(const float* spins, const float* adj, float* partial,
                 int64_t batch, int64_t v, int64_t n_spans, cudaStream_t st) {
  const int64_t row_tiles = (batch + BM - 1) / BM;
  cut_batch_kernel<BM, BK>
      <<<static_cast<unsigned>(row_tiles * n_spans), pq::kThreads, 0, st>>>(
          spins, adj, partial, batch, v, row_tiles, n_spans);
}

template <int BM>
bool launch_bm(int k_chunk, const float* spins, const float* adj,
               float* partial, int64_t batch, int64_t v, int64_t n_spans,
               cudaStream_t st) {
  switch (k_chunk) {
    case 8: launch_tile<BM, 8>(spins, adj, partial, batch, v, n_spans, st); return true;
    case 16: launch_tile<BM, 16>(spins, adj, partial, batch, v, n_spans, st); return true;
    case 32: launch_tile<BM, 32>(spins, adj, partial, batch, v, n_spans, st); return true;
  }
  return false;
}

}  // namespace

// spins (B, V) f32, adj (V, V) f32, wtot (1,) f32, partial (B, ceil(V/128))
// f32 temporary, out (B,) f32. batch_tile in {32, 64, 128}, k_chunk in
// {8, 16, 32}.
PQ_EXPORT int pq_cut_batch_dense(const void* spins, const void* adj,
                                 const void* wtot, void* partial, void* out,
                                 int64_t batch, int64_t v, int batch_tile,
                                 int k_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_spans = (v + kBN - 1) / kBN;
  const float* s = static_cast<const float*>(spins);
  const float* a = static_cast<const float*>(adj);
  float* p = static_cast<float*>(partial);
  bool ok = false;
  switch (batch_tile) {
    case 32: ok = launch_bm<32>(k_chunk, s, a, p, batch, v, n_spans, st); break;
    case 64: ok = launch_bm<64>(k_chunk, s, a, p, batch, v, n_spans, st); break;
    case 128: ok = launch_bm<128>(k_chunk, s, a, p, batch, v, n_spans, st); break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cut_batch_epilogue<<<static_cast<unsigned>((batch + pq::kThreads - 1) /
                                             pq::kThreads),
                       pq::kThreads, 0, st>>>(
      p, static_cast<const float*>(wtot), static_cast<float*>(out), batch,
      n_spans);
  return static_cast<int>(cudaGetLastError());
}
