// Diagonal objective of basis states, batched over subgraphs: of every
// state (pq_cutvals) or of the states an index table names (pq_cutvals_at),
// both from the tables of one table pass (pq_cutvals_tables).
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
// Both are a table lookup, O(l) work a state where an edge-order kernel
// does O(E). Split x < 2^n into lo = its low l = min(n, 12) bits and
// hi = the rest. Then
//   c(x) = T_lo[lo] + T_hi[hi] + sum_{j < l, bit j of lo set} D[hi, j]
// where, edge by edge (a ^ b = a + b - 2ab for bits):
//   both ends in lo:  w * (bit_i ^ bit_j) into T_lo (2^l f32);
//   both ends in hi:  w * (bit_i ^ bit_j) into T_hi (2^(n-l) f32);
//   i in hi, j in lo: w * bit_i into T_hi and w * (1 - 2 bit_i) into
//                     D[hi, j] (2^(n-l) x l f32);
//   one end at a bit >= n (bit 30 of a linear row (v, 30, h), or any bit
//   no index below 2^n sets): w * bit_v into T_lo or T_hi by the side v
//   lies on; i == j, or both ends >= n, adds nothing.
// cutvals_tables (one thread per lo value, one per hi value for T_hi and
// its D row) adds each entry's edges in edge order, so the tables are
// deterministic and equal ref.cutvals_split_tables bit for bit. Every
// state then adds T_lo[lo] and T_hi[hi], then D[hi, j] for the set bits j
// of lo in increasing j, as ref.cutvals_at_split does. Integer weights and
// linear terms give exact integers, equal to the edge-order plain
// version's bits; real ones agree with it within the tolerance stated in
// cutvals.py (the order of the sum changed).
//
// pq_cutvals (cutvals_fill): the states are every x < 2^n in order, so it
// reads no index. Bound on the H100: the 4 bytes it writes a state (the
// tables are 2^12 + 2^(n-12) * 16 floats a row, read from L1/L2). A block
// covers `tile_b` consecutive states of one edge row (tile_b <= 2048
// divides 2^l = 4096, or the row is 2^n < 2^12 states with hi = 0), so
// its states share one hi: the block reads the 64-byte hi record (D[hi,
// 0..11], T_hi[hi]) once, a broadcast, and keeps it in registers; T_lo
// reads and the f32 stores are coalesced. min(tile_b, 256) threads own
// tile_b / threads states each, strided by the thread count.
//
// pq_cutvals_at (cutvals_expand): bound on the H100 by the bytes of the
// cut table it writes (4 B a state and edge row, with 4 B of index a state
// read once). A block reads each of its `tile_b` indices once and writes
// every edge row's value of it: T_lo[lo] and the hi record come from
// L1/L2 (the sharded layouts' runs of consecutive indices make the T_lo
// reads coalesced and the record reads broadcasts), the record is kept in
// registers while hi repeats. An index at or above 2^n (or negative) is a
// breach of the caller's contract: the kernel stops with __trap() instead
// of reading out of bounds.
#include "common.cuh"

namespace {

constexpr int kLoMax = 12;        // l = min(n, kLoMax) low bits in T_lo
constexpr int kRecord = 16;       // floats a hi record: D[hi, 0..11], T_hi[hi], pad

// The tables of edge row b, edges in order for every entry: threads
// [0, 2^l) each write T_lo[lo]; threads [2^l, 2^l + 2^h) each write the
// 16-float record hd[hi] = (D[hi, 0..11], T_hi[hi], 0, 0, 0) (D[hi, j] = 0
// for j >= l) from one walk over the edges.
__global__ void __launch_bounds__(pq::kThreads)
cutvals_tables(const int32_t* __restrict__ edges,
               const float* __restrict__ weights, float* __restrict__ t_lo,
               float* __restrict__ hd, int64_t n_edges, int n, int l,
               int64_t blocks_per_row) {
  const int h = n - l;
  const int64_t n_lo = int64_t(1) << l, n_hi = int64_t(1) << h;
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t ent = (blockIdx.x % blocks_per_row) * blockDim.x + threadIdx.x;
  if (ent >= n_lo + n_hi) return;
  const bool is_lo = ent < n_lo;
  const int lo = is_lo ? static_cast<int>(ent) : 0;
  const int hi = is_lo ? 0 : static_cast<int>(ent - n_lo);
  const int32_t* e = edges + row * n_edges * 2;
  const float* w = weights + row * n_edges;
  float acc = 0.f, d[kLoMax];
#pragma unroll
  for (int j = 0; j < kLoMax; ++j) d[j] = 0.f;
  for (int64_t t = 0; t < n_edges; ++t) {
    int32_t i = e[2 * t], j = e[2 * t + 1];
    const float wt = w[t];
    const bool zi = i < 0 || i >= n, zj = j < 0 || j >= n;
    if (i == j || (zi && zj)) continue;
    if (zi || (!zj && i < l && j >= l)) {  // the zero or hi end goes first
      const int32_t tmp = i; i = j; j = tmp;
    }
    if (zi != zj) {  // one end (now j) is a zero bit: w * bit_i
      if (is_lo == (i < l)) {
        const int bit = is_lo ? (lo >> i) & 1 : (hi >> (i - l)) & 1;
        acc = __fadd_rn(acc, bit ? wt : 0.f);
      }
    } else if (i < l && j < l) {  // both in lo
      if (is_lo) acc = __fadd_rn(acc, ((lo >> i) ^ (lo >> j)) & 1 ? wt : 0.f);
    } else if (j >= l) {  // both in hi
      if (!is_lo)
        acc = __fadd_rn(acc, ((hi >> (i - l)) ^ (hi >> (j - l))) & 1 ? wt : 0.f);
    } else if (!is_lo) {  // cross: i in hi, j in lo
      const int bi = (hi >> (i - l)) & 1;
      acc = __fadd_rn(acc, bi ? wt : 0.f);
#pragma unroll
      for (int jj = 0; jj < kLoMax; ++jj)
        if (jj == j) d[jj] = __fadd_rn(d[jj], bi ? -wt : wt);
    }
  }
  if (is_lo) {
    t_lo[row * n_lo + lo] = acc;
    return;
  }
  float4* rec = reinterpret_cast<float4*>(hd + (row * n_hi + hi) * kRecord);
  rec[0] = make_float4(d[0], d[1], d[2], d[3]);
  rec[1] = make_float4(d[4], d[5], d[6], d[7]);
  rec[2] = make_float4(d[8], d[9], d[10], d[11]);
  rec[3] = make_float4(acc, 0.f, 0.f, 0.f);
}

// Every state x < 2^n of edge row b, from the tables; kPer states a
// thread, strided by the thread count. The block's states share one hi.
template <int kPer>
__global__ void __launch_bounds__(pq::kThreads)
cutvals_fill(const float* __restrict__ t_lo, const float* __restrict__ hd,
             float* __restrict__ out, int64_t width, int l,
             int64_t blocks_per_row) {
  const int64_t n_lo = int64_t(1) << l;
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t first = (blockIdx.x % blocks_per_row) * blockDim.x * kPer;
  const float4* rec = reinterpret_cast<const float4*>(
      hd + (row * (width >> l) + (first >> l)) * kRecord);
  const float4 q0 = __ldg(rec), q1 = __ldg(rec + 1);
  const float4 q2 = __ldg(rec + 2), q3 = __ldg(rec + 3);
  const float d[kLoMax] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                           q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
  const float* tl = t_lo + row * n_lo;
  float* o = out + row * width;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t pos = first + threadIdx.x + static_cast<int64_t>(u) * blockDim.x;
    if (pos >= width) continue;
    const int32_t lo = static_cast<int32_t>(pos & (n_lo - 1));
    float c = __fadd_rn(__ldg(tl + lo), q3.x);
#pragma unroll
    for (int j = 0; j < kLoMax; ++j)
      if ((lo >> j) & 1) c = __fadd_rn(c, d[j]);
    o[pos] = c;
  }
}

// Every edge row's value at the states idx[s, p], from the tables; kPer
// states a thread, strided by the thread count.
template <int kPer>
__global__ void __launch_bounds__(pq::kThreads)
cutvals_expand(const int32_t* __restrict__ idx, const float* __restrict__ t_lo,
               const float* __restrict__ hd, float* __restrict__ out,
               int64_t batch, int64_t idx_rows, int64_t width, int n, int l,
               int64_t blocks_per_row) {
  const int h = n - l;
  const int64_t n_lo = int64_t(1) << l, n_hi = int64_t(1) << h;
  const int64_t s = blockIdx.x / blocks_per_row;
  const int64_t first =
      (blockIdx.x % blocks_per_row) * blockDim.x * kPer + threadIdx.x;
  int32_t lo[kPer], hi[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int64_t pos = first + static_cast<int64_t>(u) * blockDim.x;
    int32_t x = 0;
    if (pos < width) {
      x = idx[s * width + pos];
      if (x < 0 || (static_cast<int64_t>(x) >> n) != 0) __trap();
    }
    lo[u] = x & static_cast<int32_t>(n_lo - 1);
    hi[u] = x >> l;
  }
  for (int64_t b = 0; b < batch; ++b) {
    const float* tl = t_lo + b * n_lo;
    const float4* rec = reinterpret_cast<const float4*>(hd + b * n_hi * kRecord);
    float* o = out + (b * idx_rows + s) * width;
    int32_t cur = -1;
    float thv = 0.f, d[kLoMax];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t pos = first + static_cast<int64_t>(u) * blockDim.x;
      if (pos >= width) continue;
      if (hi[u] != cur) {  // the record of a new hi: four 16-byte loads
        cur = hi[u];
        const float4 q0 = __ldg(rec + 4 * cur), q1 = __ldg(rec + 4 * cur + 1);
        const float4 q2 = __ldg(rec + 4 * cur + 2), q3 = __ldg(rec + 4 * cur + 3);
        d[0] = q0.x; d[1] = q0.y; d[2] = q0.z; d[3] = q0.w;
        d[4] = q1.x; d[5] = q1.y; d[6] = q1.z; d[7] = q1.w;
        d[8] = q2.x; d[9] = q2.y; d[10] = q2.z; d[11] = q2.w;
        thv = q3.x;
      }
      float c = __fadd_rn(__ldg(tl + lo[u]), thv);
#pragma unroll
      for (int j = 0; j < kLoMax; ++j)
        if ((lo[u] >> j) & 1) c = __fadd_rn(c, d[j]);
      o[pos] = c;
    }
  }
}

// tile_b a power of two in [32, 8 * kThreads]: (threads, states a thread)
bool geometry(int64_t tile_b, int* threads, int* per) {
  if (tile_b < 32 || tile_b > 8 * pq::kThreads || (tile_b & (tile_b - 1)))
    return false;
  *threads = static_cast<int>(tile_b < pq::kThreads ? tile_b : pq::kThreads);
  *per = static_cast<int>(tile_b / *threads);
  return true;
}

template <int kPer>
void launch_fill(const void* t_lo, const void* hd, void* out, int64_t batch,
                 int64_t width, int l, int threads, cudaStream_t st) {
  const int64_t tile_b = static_cast<int64_t>(threads) * kPer;
  const int64_t blocks_per_row = (width + tile_b - 1) / tile_b;
  cutvals_fill<kPer>
      <<<static_cast<unsigned>(batch * blocks_per_row), threads, 0, st>>>(
          static_cast<const float*>(t_lo), static_cast<const float*>(hd),
          static_cast<float*>(out), width, l, blocks_per_row);
}

template <int kPer>
void launch_expand(const void* idx, const void* t_lo, const void* hd, void* out,
                   int64_t batch, int64_t idx_rows, int64_t width, int n, int l,
                   int threads, cudaStream_t st) {
  const int64_t tile_b = static_cast<int64_t>(threads) * kPer;
  const int64_t blocks_per_row = (width + tile_b - 1) / tile_b;
  cutvals_expand<kPer>
      <<<static_cast<unsigned>(idx_rows * blocks_per_row), threads, 0, st>>>(
          static_cast<const int32_t*>(idx), static_cast<const float*>(t_lo),
          static_cast<const float*>(hd), static_cast<float*>(out), batch,
          idx_rows, width, n, l, blocks_per_row);
}

}  // namespace

// The tables of pq_cutvals_tables for B edge rows -> out (B, 2^n) f32,
// every state of every row; tile_b a power of two in [32, 2048].
PQ_EXPORT int pq_cutvals(const void* t_lo, const void* hd, void* out,
                         int64_t batch, int n, int64_t tile_b, void* stream) {
  int threads, per;
  if (n < 1 || n > 29 || !geometry(tile_b, &threads, &per))
    return static_cast<int>(cudaErrorInvalidValue);
  const int l = n < kLoMax ? n : kLoMax;
  const int64_t width = int64_t(1) << n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: launch_fill<1>(t_lo, hd, out, batch, width, l, threads, st); break;
    case 2: launch_fill<2>(t_lo, hd, out, batch, width, l, threads, st); break;
    case 4: launch_fill<4>(t_lo, hd, out, batch, width, l, threads, st); break;
    default: launch_fill<8>(t_lo, hd, out, batch, width, l, threads, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// edges (B, E, 2) int32, weights (B, E) f32 -> t_lo (B, 2^l) and hd
// (B, 2^(n-l), 16) f32, each record (D[hi, 0..11], T_hi[hi], 0, 0, 0),
// l = min(n, 12), 1 <= n <= 29.
PQ_EXPORT int pq_cutvals_tables(const void* edges, const void* weights,
                                void* t_lo, void* hd, int64_t batch,
                                int64_t n_edges, int n, void* stream) {
  if (n < 1 || n > 29) return static_cast<int>(cudaErrorInvalidValue);
  const int l = n < kLoMax ? n : kLoMax;
  const int64_t entries = (int64_t(1) << l) + (int64_t(1) << (n - l));
  const int64_t blocks_per_row = (entries + pq::kThreads - 1) / pq::kThreads;
  cutvals_tables<<<static_cast<unsigned>(batch * blocks_per_row), pq::kThreads,
                   0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(edges), static_cast<const float*>(weights),
      static_cast<float*>(t_lo), static_cast<float*>(hd), n_edges, n, l,
      blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}

// idx (S, L) int32 with every index below 2^n, the tables of
// pq_cutvals_tables for B edge rows, out (B * S, L) f32: row b * S + s
// holds edge row b at the states idx[s]. tile_b as pq_cutvals.
PQ_EXPORT int pq_cutvals_at(const void* idx, const void* t_lo, const void* hd,
                            void* out, int64_t batch, int64_t idx_rows,
                            int64_t width, int n, int64_t tile_b, void* stream) {
  int threads, per;
  if (n < 1 || n > 29 || !geometry(tile_b, &threads, &per))
    return static_cast<int>(cudaErrorInvalidValue);
  const int l = n < kLoMax ? n : kLoMax;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: launch_expand<1>(idx, t_lo, hd, out, batch, idx_rows, width, n, l, threads, st); break;
    case 2: launch_expand<2>(idx, t_lo, hd, out, batch, idx_rows, width, n, l, threads, st); break;
    case 4: launch_expand<4>(idx, t_lo, hd, out, batch, idx_rows, width, n, l, threads, st); break;
    default: launch_expand<8>(idx, t_lo, hd, out, batch, idx_rows, width, n, l, threads, st);
  }
  return static_cast<int>(cudaGetLastError());
}
