// Fused QAOA cost phase + first mixer group (pq_fused_phase_mixer), and
// the same mixer group without the phase (pq_mixer_trailing), batched
// over subgraphs.
//
// Replaces: src/repro/kernels/fused_layer.py::_kernel (pallas_call at
// fused_layer.py:83), which applies the phase and then right-multiplies
// an (R, 2^k) row tile by the generated 2^k x 2^k RX-group matrices; and
// src/repro/kernels/mixer.py::_mixer_kernel (pallas_call at mixer.py:91),
// the same right-multiplication without the phase (the trailing group of
// `apply_mixer_bits` with lo_bit == 0).
//
// Computes, per batch row b with its own gamma[b], beta[b], on the
// (B, R, 2^k) view of the state (group = qubits 0..k-1, the contiguous
// axis):  psi <- RX(2 beta)^{⊗k} e^{-i gamma c} psi.  With reverse != 0
// the order is mixer first, then phase; called at (-gamma, -beta) that is
// the adjoint of the forward pass, which the layer backward runs. The
// trailing mixer is the kPhase = false instance: psi <- RX(2 beta)^{⊗k} psi.
//
// Bound on the H100: bytes. The fused pass reads re, im, cutv and writes
// re, im: 20 bytes per amplitude, against ~50 flops per amplitude (one
// sincos, 6 phase flops, 6 per mixer qubit). The trailing mixer moves 16
// bytes per amplitude for 6k flops.
//
// Design: no 2^k x 2^k matrix anywhere. A block loads a tile of whole
// rows (`tile_rows` rows of 2^k, at most 4096 amplitudes, 32 KB of shared
// memory for both planes; 4096 >> k rows clamped to R unless the tuning
// table says otherwise) with
// coalesced loads, applies the phase in registers on the way in (or on
// the way out, reversed), and applies RX^{⊗k} as k butterfly passes over
// the tile in shared memory: k * 6 flops per amplitude instead of
// 8 * 2^k for the dense product, and exactly the same unitary. A tile
// never straddles two batch rows (its row count divides R), so each block
// reads one gamma and one beta.
#include "common.cuh"

namespace {

template <bool kPhase>
__global__ void __launch_bounds__(pq::kThreads)
fused_kernel(const float* __restrict__ re, const float* __restrict__ im,
             const float* __restrict__ cutv, const float* __restrict__ gamma,
             const float* __restrict__ beta, float* __restrict__ ore,
             float* __restrict__ oim, int64_t blocks_per_batch, int k,
             int tile_rows, int reverse) {
  __shared__ float s_re[pq::kTile];
  __shared__ float s_im[pq::kTile];
  const int dk = 1 << k;
  const int n_el = tile_rows * dk;
  const int64_t b = blockIdx.x / blocks_per_batch;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_el;
  const float g = kPhase ? gamma[b] : 0.f;
  float sb, cb;
  sincosf(beta[b], &sb, &cb);

  for (int e = threadIdx.x; e < n_el; e += pq::kThreads) {
    float x = re[base + e], y = im[base + e];
    if (kPhase && !reverse) {
      float s, c;
      sincosf(g * cutv[base + e], &s, &c);
      const float nx = x * c + y * s;
      y = y * c - x * s;
      x = nx;
    }
    s_re[e] = x;
    s_im[e] = y;
  }
  __syncthreads();
  const int half = n_el >> 1;
  for (int q = 0; q < k; ++q) {
    for (int p = threadIdx.x; p < half; p += pq::kThreads) {
      const int i0 = pq::insert_zero_bit(p, q);  // row-major: a is fastest
      pq::rx_pair(s_re, s_im, i0, i0 | (1 << q), cb, sb);
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n_el; e += pq::kThreads) {
    float x = s_re[e], y = s_im[e];
    if (kPhase && reverse) {
      float s, c;
      sincosf(g * cutv[base + e], &s, &c);
      const float nx = x * c + y * s;
      y = y * c - x * s;
      x = nx;
    }
    ore[base + e] = x;
    oim[base + e] = y;
  }
}

template <bool kPhase>
int launch(const void* re, const void* im, const void* cutv,
           const void* gamma, const void* beta, void* ore, void* oim,
           int64_t batch, int64_t rows_per_batch, int k, int reverse,
           int64_t tile_rows, void* stream) {
  if (tile_rows < 1 || rows_per_batch % tile_rows ||
      (tile_rows << k) > pq::kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks_per_batch = rows_per_batch / tile_rows;
  fused_kernel<kPhase><<<static_cast<unsigned>(batch * blocks_per_batch),
                         pq::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(cutv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(ore),
      static_cast<float*>(oim), blocks_per_batch, k,
      static_cast<int>(tile_rows), reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im, cutv, ore, oim (B, R, 2^k) f32; gamma, beta (B,) f32; R and 2^k
// powers of two, k in [1, 12]; tile_rows divides R, tile_rows * 2^k <= kTile.
PQ_EXPORT int pq_fused_phase_mixer(const void* re, const void* im,
                                   const void* cutv, const void* gamma,
                                   const void* beta, void* ore, void* oim,
                                   int64_t batch, int64_t rows_per_batch,
                                   int k, int reverse, int64_t tile_rows,
                                   void* stream) {
  return launch<true>(re, im, cutv, gamma, beta, ore, oim, batch,
                      rows_per_batch, k, reverse, tile_rows, stream);
}

// re, im, ore, oim (B, R, 2^k) f32; beta (B,) f32; R and 2^k powers of
// two, k in [1, 12]; tile_rows divides R, tile_rows * 2^k <= kTile.
PQ_EXPORT int pq_mixer_trailing(const void* re, const void* im,
                                const void* beta, void* ore, void* oim,
                                int64_t batch, int64_t rows_per_batch, int k,
                                int64_t tile_rows, void* stream) {
  return launch<false>(re, im, nullptr, nullptr, beta, ore, oim, batch,
                       rows_per_batch, k, 0, tile_rows, stream);
}
