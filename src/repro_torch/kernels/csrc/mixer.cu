// Transverse-field mixer group RX(2 beta)^{⊗k} on a middle axis of the
// state, batched over subgraphs.
//
// Replaces: src/repro/kernels/mixer.py::_mixer_strided_kernel (pallas_call
// at mixer.py:135), which contracts the middle axis of (tx, 2^k, ty)
// blocks with the generated 2^k x 2^k matrices.
//
// Computes, per batch row b with its own beta[b], on the (B, X, 2^k, Y)
// view of the state (qubits lo_bit .. lo_bit+k-1 on the middle axis,
// Y = 2^lo_bit): out[b, x, a, y] = sum_c U[a, c] in[b, x, c, y] with
// U[a, c] = cos(beta)^(k-d) (-i sin(beta))^d, d = popcount(a ^ c).
//
// Bound on the H100: bytes. It reads and writes re and im once:
// 16 bytes per amplitude, against 6 * k flops per amplitude.
//
// Design: a block owns one (b, x) slab and a tile of y_tile lanes along
// Y, the 2^k x y_tile sub-block of at most 4096 amplitudes (32 KB of
// shared memory for both planes); y_tile is the wrapper's `tile_y` knob,
// 2^(12-k) clamped to Y unless the tuning table says otherwise. Neighbouring threads take neighbouring y, so every
// global load and store is coalesced, and the butterfly passes read
// shared memory without bank conflicts once y_tile >= 32. RX^{⊗k} is
// applied as k butterflies in shared memory (6k flops per amplitude, not
// 8 * 2^k). The grid is one dimension: (B, X, Y-tiles) folded into
// blockIdx.x, because Y reaches 2^21 and X falls to 1 at 24 qubits while
// gridDim.y and gridDim.z stop at 65,535.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pq::kThreads)
mixer_strided_kernel(const float* __restrict__ re,
                     const float* __restrict__ im,
                     const float* __restrict__ beta, float* __restrict__ ore,
                     float* __restrict__ oim, int64_t x_dim, int k,
                     int64_t y_dim, int log2_y_tile, int64_t y_tiles) {
  __shared__ float s_re[pq::kTile];
  __shared__ float s_im[pq::kTile];
  const int dk = 1 << k;
  const int y_tile = 1 << log2_y_tile;
  const int n_el = dk * y_tile;
  const int64_t slab = blockIdx.x / y_tiles;  // flat (b, x)
  const int64_t yt = blockIdx.x % y_tiles;
  const int64_t b = slab / x_dim;
  const int64_t base = slab * dk * y_dim + yt * y_tile;
  float sb, cb;
  sincosf(beta[b], &sb, &cb);

  // tile element e = a * y_tile + y  <->  global base + a * Y + y
  for (int e = threadIdx.x; e < n_el; e += pq::kThreads) {
    const int64_t off =
        base + static_cast<int64_t>(e >> log2_y_tile) * y_dim +
        (e & (y_tile - 1));
    s_re[e] = re[off];
    s_im[e] = im[off];
  }
  __syncthreads();
  const int half = n_el >> 1;
  for (int q = 0; q < k; ++q) {
    for (int p = threadIdx.x; p < half; p += pq::kThreads) {
      // qubit q of the group is bit (q + log2_y_tile) of the tile index
      const int i0 = pq::insert_zero_bit(p, q + log2_y_tile);
      pq::rx_pair(s_re, s_im, i0, i0 | (y_tile << q), cb, sb);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n_el; e += pq::kThreads) {
    const int64_t off =
        base + static_cast<int64_t>(e >> log2_y_tile) * y_dim +
        (e & (y_tile - 1));
    ore[off] = s_re[e];
    oim[off] = s_im[e];
  }
}

}  // namespace

// re, im, ore, oim (B, X, 2^k, Y) f32 contiguous; beta (B,) f32; Y a power
// of two, k in [1, 12]; y_tile a power of two dividing Y with
// 2^k * y_tile <= kTile.
PQ_EXPORT int pq_mixer_strided(const void* re, const void* im,
                               const void* beta, void* ore, void* oim,
                               int64_t batch, int64_t x_dim, int k,
                               int64_t y_dim, int64_t y_tile, void* stream) {
  if (y_tile < 1 || (y_tile & (y_tile - 1)) || y_dim % y_tile ||
      (y_tile << k) > pq::kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  int log2_y_tile = 0;
  while ((int64_t(1) << log2_y_tile) < y_tile) ++log2_y_tile;
  const int64_t y_tiles = y_dim >> log2_y_tile;
  mixer_strided_kernel<<<static_cast<unsigned>(batch * x_dim * y_tiles),
                         pq::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(beta), static_cast<float*>(ore),
      static_cast<float*>(oim), x_dim, k, y_dim, log2_y_tile, y_tiles);
  return static_cast<int>(cudaGetLastError());
}
