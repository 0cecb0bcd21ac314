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
// re, im: 20 bytes per amplitude, against ~50-80 flops per amplitude (one
// sincos, 6 phase flops, 6 per mixer qubit). The trailing mixer moves 16
// bytes per amplitude for 6k flops.
//
// Design: no 2^k x 2^k matrix anywhere, and no butterfly in shared
// memory. A block owns a tile of whole rows (`tile_rows` rows of 2^k, at
// most kTile = 4096 amplitudes, so k <= 12; 4096 >> k rows clamped to R
// unless the tuning table says otherwise). Each of the 256 threads holds
// 16 amplitudes of each plane in registers: 4 of the tile index's 12
// bits are its register index, the other 8 its thread index. RX on a
// qubit whose bit is a register bit is 8 butterflies inside the thread.
// The tile passes through three layouts, each holding 4 other bits in
// registers, so that every bit is a register bit in one of them:
//
//   A (load):  lane -> bits 0-4, register -> 5-8, warp -> 9-11
//   B:         lane -> bits 0,1,5,6,7, register -> 2,3,4,9, warp -> 8,10,11
//   C (store): register -> bits 0,1 (a float4) and 10,11, lane -> 2-6,
//              warp -> 7-9
//
// A's loads read 128 contiguous bytes a warp instruction, C's stores
// write 512; the two changes of layout go through shared memory, 32 B an
// amplitude in all (k shared-memory butterfly passes moved 16 + 16k B),
// behind two __syncthreads. A word's address folds index bits 5-7 onto
// bits 2-4 (`word`), so each layout's accesses hit 32 distinct banks.
// The phase is applied in registers in layout A on the way in (forward),
// or in layout C on the way out (reverse; its cost values are loaded at
// the start, in flight during the butterflies). Bits >= k are row bits
// and take no butterfly. Exactly the same unitary as the dense product;
// only the order of the qubits' butterflies differs. A tile never
// straddles two batch rows (its row count divides R), so each block reads
// one gamma and one beta; a tile of fewer than 4096 amplitudes masks the
// elements past its end.
#include "common.cuh"

namespace {

constexpr int kRegs = pq::kTile / pq::kThreads;  // amplitudes a thread holds

// tile element of register r of thread (lane, warp), in each layout
__device__ __forceinline__ int elem_a(int lane, int warp, int r) {
  return lane | r << 5 | warp << 9;
}
__device__ __forceinline__ int elem_b(int lane, int warp, int r) {
  return (lane & 3) | (r & 7) << 2 | (lane >> 2) << 5 | (warp & 1) << 8 |
         (r >> 3) << 9 | (warp >> 1) << 10;
}
__device__ __forceinline__ int elem_c(int lane, int warp, int r) {
  return (r & 3) | lane << 2 | warp << 7 | (r >> 2) << 10;
}

// shared-memory word of tile element e: bits 5-7 XORed onto bits 2-4.
// Layout A's lanes vary bits 0-4 (the XOR is fixed), B's bits 0,1 and
// 5-7 (which the XOR spreads over bits 2-4), and C's float4 reads, 8
// lanes a wavefront, bits 2-4 with 5-7 fixed: 32 banks each time. Bits
// 0 and 1 are kept, so a float4 stays whole and aligned.
__device__ __forceinline__ int word(int e) { return e ^ ((e >> 3) & 0x1C); }

// RX(2 beta) = [[c, -i s], [-i s, c]] on the qubit register bit J
// carries: 8 butterflies over the thread's 16 amplitudes
template <int J>
__device__ __forceinline__ void rx_regs(float (&x)[kRegs], float (&y)[kRegs],
                                        float c, float s) {
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    if (r & (1 << J)) continue;
    const int r1 = r | (1 << J);
    const float x0 = x[r], y0 = y[r], x1 = x[r1], y1 = y[r1];
    x[r] = c * x0 + s * y1;
    y[r] = c * y0 - s * x1;
    x[r1] = c * x1 + s * y0;
    y[r1] = c * y1 - s * x0;
  }
}

// the butterflies of one layout: register bit j carries tile bit q_j,
// a qubit of the group where q_j < k (else a row bit)
__device__ __forceinline__ void rx_layout(float (&x)[kRegs],
                                          float (&y)[kRegs], int q0, int q1,
                                          int q2, int q3, int k, float c,
                                          float s) {
  if (q0 < k) rx_regs<0>(x, y, c, s);
  if (q1 < k) rx_regs<1>(x, y, c, s);
  if (q2 < k) rx_regs<2>(x, y, c, s);
  if (q3 < k) rx_regs<3>(x, y, c, s);
}

// e^{-i angle} on one amplitude
__device__ __forceinline__ void rotate(float& x, float& y, float angle) {
  float s, c;
  sincosf(angle, &s, &c);
  const float nx = x * c + y * s;
  y = y * c - x * s;
  x = nx;
}

template <bool kPhase>
__global__ void __launch_bounds__(pq::kThreads, 2)
fused_kernel(const float* __restrict__ re, const float* __restrict__ im,
             const float* __restrict__ cutv, const float* __restrict__ gamma,
             const float* __restrict__ beta, float* __restrict__ ore,
             float* __restrict__ oim, int64_t blocks_per_batch, int k,
             int tile_rows, int reverse, int vec) {
  __shared__ __align__(16) float s_re[pq::kTile];
  __shared__ __align__(16) float s_im[pq::kTile];
  const int n_el = tile_rows << k;
  const bool full = n_el == pq::kTile;
  const int64_t b = blockIdx.x / blocks_per_batch;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_el;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float g = kPhase ? gamma[b] : 0.f;
  float sb, cb;
  sincosf(beta[b], &sb, &cb);
  float x[kRegs], y[kRegs], cv[kRegs];

#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int e = elem_a(lane, warp, r);
    const bool in = full || e < n_el;
    x[r] = in ? re[base + e] : 0.f;
    y[r] = in ? im[base + e] : 0.f;
    if (kPhase && !reverse) cv[r] = in ? cutv[base + e] : 0.f;
  }
  if (kPhase && reverse) {  // layout C's cost values, used at the end
    if (vec) {
#pragma unroll
      for (int j = 0; j < kRegs / 4; ++j) {
        const int e = elem_c(lane, warp, 4 * j);
        const float4 c4 = full || e < n_el
            ? *reinterpret_cast<const float4*>(cutv + base + e)
            : make_float4(0.f, 0.f, 0.f, 0.f);
        cv[4 * j] = c4.x;
        cv[4 * j + 1] = c4.y;
        cv[4 * j + 2] = c4.z;
        cv[4 * j + 3] = c4.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        const int e = elem_c(lane, warp, r);
        cv[r] = e < n_el ? cutv[base + e] : 0.f;
      }
    }
  }
  if (kPhase && !reverse) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) rotate(x[r], y[r], g * cv[r]);
  }
  rx_layout(x, y, 5, 6, 7, 8, k, cb, sb);
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int w = word(elem_a(lane, warp, r));
    s_re[w] = x[r];
    s_im[w] = y[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int w = word(elem_b(lane, warp, r));
    x[r] = s_re[w];
    y[r] = s_im[w];
  }
  rx_layout(x, y, 2, 3, 4, 9, k, cb, sb);
  // back to the words this thread read: no other thread reads them
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int w = word(elem_b(lane, warp, r));
    s_re[w] = x[r];
    s_im[w] = y[r];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRegs / 4; ++j) {
    const int w = word(elem_c(lane, warp, 4 * j));
    const float4 r4 = *reinterpret_cast<const float4*>(s_re + w);
    const float4 i4 = *reinterpret_cast<const float4*>(s_im + w);
    x[4 * j] = r4.x;
    x[4 * j + 1] = r4.y;
    x[4 * j + 2] = r4.z;
    x[4 * j + 3] = r4.w;
    y[4 * j] = i4.x;
    y[4 * j + 1] = i4.y;
    y[4 * j + 2] = i4.z;
    y[4 * j + 3] = i4.w;
  }
  rx_layout(x, y, 0, 1, 10, 11, k, cb, sb);
  if (kPhase && reverse) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) rotate(x[r], y[r], g * cv[r]);
  }
  if (vec) {
#pragma unroll
    for (int j = 0; j < kRegs / 4; ++j) {
      const int e = elem_c(lane, warp, 4 * j);
      if (full || e < n_el) {
        *reinterpret_cast<float4*>(ore + base + e) =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
        *reinterpret_cast<float4*>(oim + base + e) =
            make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int e = elem_c(lane, warp, r);
      if (e < n_el) {
        ore[base + e] = x[r];
        oim[base + e] = y[r];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kPhase>
int launch(const void* re, const void* im, const void* cutv,
           const void* gamma, const void* beta, void* ore, void* oim,
           int64_t batch, int64_t rows_per_batch, int k, int reverse,
           int64_t tile_rows, void* stream) {
  if (k < 1 || k > 12 || tile_rows < 1 || rows_per_batch % tile_rows ||
      (tile_rows << k) > pq::kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks_per_batch = rows_per_batch / tile_rows;
  // float4 stores (and reversed cost loads) where every tile starts on 16 B
  const int vec = (tile_rows << k) % 4 == 0 && aligned16(ore) &&
                  aligned16(oim) && (!kPhase || !reverse || aligned16(cutv));
  fused_kernel<kPhase><<<static_cast<unsigned>(batch * blocks_per_batch),
                         pq::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(cutv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(ore),
      static_cast<float*>(oim), blocks_per_batch, k,
      static_cast<int>(tile_rows), reverse, vec);
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
