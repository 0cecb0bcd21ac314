// ∂β of the transverse-field mixer: the generator contraction of the QAOA
// layer's backward pass, batched over subgraphs.
//
// Replaces: the plain jnp contraction that src/repro/kernels/ops.py runs
// inside the custom_vjp of apply_layer and apply_mixer_bits
// (_neighbor_sum_bits at ops.py:291, used by _mixer_bits_bwd and
// _layer_bwd), which XLA fuses into one loop on the TPU. No Pallas kernel
// computes it.
//
// Computes, per batch row b, over the qubits q of [lo_bit, lo_bit + nbits):
//   dbeta[b] = sum_x sum_q (d_ore[b, x] * oim[b, x ^ 2^q]
//                           - d_oim[b, x] * ore[b, x ^ 2^q]),
// since each RX(2 beta) factor differentiates into -i X on its qubit.
//
// Bound on the H100: bytes. One pass reads the four (B, 2^n) f32 planes
// once (16 bytes an amplitude) against 4 flops an amplitude and qubit;
// it writes no plane. A qubit's partner lies 2^q amplitudes away, so the
// range is cut into groups (ref.beta_grad_groups) of k <= 12 qubits each,
// and every group is one pass: g groups read the planes g times (g = 3
// at n = 24: qubits 0-11, 12-18, 19-23).
//
// Design: pq_beta_grad_group runs one group on the (B, X, 2^k, Y) view of
// the planes (qubits g0 .. g0+k-1 on the middle axis, Y = 2^g0), as
// mixer.cu does. A block owns one (b, x) slab and a tile of y_tile lanes
// along Y, at most kTile = 4096 amplitudes of each of the four planes,
// staged in 64 KB of dynamic shared memory (so every pair of the group
// lies in the tile). Neighbouring threads take neighbouring y (y_tile >= 32
// where Y allows it; the lowest group is one contiguous run), so global
// loads are coalesced; a partner e ^ (y_tile << q) stays in the same or
// the next aligned run of 32 words, so shared reads have no bank
// conflict. Each amplitude forms its k products in f32 (d_ore * oim' -
// d_oim * ore', rounded as written, no FMA) and adds them as a fixed
// pairwise tree of 16 leaves (zeros past k); the amplitudes' values are
// summed in f64, the block's in a fixed warp-shuffle tree, into one f64
// partial per block. pq_beta_grad_final sums a row's partials in a fixed
// order (as expectation_final_kernel in phase.cu does), in f64, and
// rounds once to f32. No atomics: the same inputs give the same bits.
// Each term passes through at most 2 + 4 f32 roundings before the f64
// sums, so the result lies within 7 * 2^-24 of
// sum_x sum_q (|d_ore oim'| + |d_oim ore'|) of the exact sum.
#include "common.cuh"

namespace {

constexpr int kSlots = 16;  // leaves of an amplitude's tree: k <= 12 < 16
constexpr int kMaxK = 12;   // qubits a group: 2^12 amplitudes fill a tile
constexpr int kWarps = pq::kThreads / 32;

// thread 0 gets the block's sum of v, in a fixed order
__device__ __forceinline__ double block_sum(double v, double* s_warp) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  return total;
}

__global__ void __launch_bounds__(pq::kThreads)
beta_grad_group_kernel(const float* __restrict__ d_ore,
                       const float* __restrict__ d_oim,
                       const float* __restrict__ ore,
                       const float* __restrict__ oim,
                       double* __restrict__ partial, int64_t x_dim, int k,
                       int64_t y_dim, int log2_y_tile, int64_t y_tiles,
                       int64_t row_parts, int64_t part0) {
  extern __shared__ float s_planes[];  // d_ore, d_oim, ore, oim tiles
  __shared__ double s_warp[kWarps];
  const int y_tile = 1 << log2_y_tile;
  const int n_el = (1 << k) << log2_y_tile;
  float* s_dr = s_planes;
  float* s_di = s_planes + n_el;
  float* s_re = s_planes + 2 * n_el;
  float* s_im = s_planes + 3 * n_el;
  const int64_t slab = blockIdx.x / y_tiles;  // flat (b, x)
  const int64_t yt = blockIdx.x % y_tiles;
  const int64_t b = slab / x_dim;
  const int64_t base = (slab << k) * y_dim + yt * y_tile;

  // tile element e = a * y_tile + y  <->  global base + a * Y + y
  for (int e = threadIdx.x; e < n_el; e += pq::kThreads) {
    const int64_t off =
        base + static_cast<int64_t>(e >> log2_y_tile) * y_dim + (e & (y_tile - 1));
    s_dr[e] = d_ore[off];
    s_di[e] = d_oim[off];
    s_re[e] = ore[off];
    s_im[e] = oim[off];
  }
  __syncthreads();
  double acc = 0.0;
  for (int e = threadIdx.x; e < n_el; e += pq::kThreads) {
    const float dr = s_dr[e], di = s_di[e];
    float t[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      t[q] = 0.f;
      if (q < k) {
        const int p = e ^ (y_tile << q);
        t[q] = __fsub_rn(__fmul_rn(dr, s_im[p]), __fmul_rn(di, s_re[p]));
      }
    }
#pragma unroll
    for (int s = 1; s < kSlots; s <<= 1)
#pragma unroll
      for (int i = 0; i < kSlots; i += 2 * s) t[i] = __fadd_rn(t[i], t[i + s]);
    acc += static_cast<double>(t[0]);
  }
  const double total = block_sum(acc, s_warp);
  if (threadIdx.x == 0)
    partial[b * row_parts + part0 + (slab % x_dim) * y_tiles + yt] = total;
}

__global__ void __launch_bounds__(pq::kThreads)
beta_grad_final_kernel(const double* __restrict__ partial,
                       float* __restrict__ out, int64_t parts) {
  __shared__ double s_warp[kWarps];
  const double* row = partial + static_cast<int64_t>(blockIdx.x) * parts;
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < parts; i += pq::kThreads) acc += row[i];
  const double total = block_sum(acc, s_warp);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(total);
}

}  // namespace

// One group of qubits [g0, g0 + k) on the (B, X, 2^k, Y) view of the four
// (B, 2^n) f32 planes (Y = 2^g0): partial[b, part0 + x * (Y / y_tile) + t]
// (f64, rows of row_parts) gets the tile's sum. k in [1, 12]; y_tile a
// power of two dividing Y with 2^k * y_tile <= kTile.
PQ_EXPORT int pq_beta_grad_group(const void* d_ore, const void* d_oim,
                                 const void* ore, const void* oim, void* partial,
                                 int64_t batch, int64_t x_dim, int k, int64_t y_dim,
                                 int64_t y_tile, int64_t row_parts, int64_t part0,
                                 void* stream) {
  if (k < 1 || k > kMaxK || y_tile < 1 || (y_tile & (y_tile - 1)) ||
      y_dim % y_tile || (y_tile << k) > pq::kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2_y_tile = 0;
  while ((int64_t(1) << log2_y_tile) < y_tile) ++log2_y_tile;
  const int64_t y_tiles = y_dim >> log2_y_tile;
  if (part0 + x_dim * y_tiles > row_parts)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * sizeof(float) * (static_cast<size_t>(y_tile) << k);
  cudaError_t err = cudaFuncSetAttribute(
      beta_grad_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(4 * sizeof(float) * pq::kTile));
  if (err != cudaSuccess) return static_cast<int>(err);
  beta_grad_group_kernel<<<static_cast<unsigned>(batch * x_dim * y_tiles),
                           pq::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_ore), static_cast<const float*>(d_oim),
      static_cast<const float*>(ore), static_cast<const float*>(oim),
      static_cast<double*>(partial), x_dim, k, y_dim, log2_y_tile, y_tiles,
      row_parts, part0);
  return static_cast<int>(cudaGetLastError());
}

// partial (B, parts) f64 -> out (B,) f32, each row summed in a fixed order.
PQ_EXPORT int pq_beta_grad_final(const void* partial, void* out, int64_t batch,
                                 int64_t parts, void* stream) {
  beta_grad_final_kernel<<<static_cast<unsigned>(batch), pq::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), static_cast<float*>(out), parts);
  return static_cast<int>(cudaGetLastError());
}
