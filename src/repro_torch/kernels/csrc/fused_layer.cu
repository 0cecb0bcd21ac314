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
// pq_fused_layer_grads is the reversed pass of the layer backward with the
// layer's gradients (no Pallas kernel: the JAX package leaves ∂γ and ∂β to
// XLA in apply_layer's custom_vjp, src/repro/kernels/ops.py:407-451): it
// also reads the layer's input and writes each tile's f64 partials of ∂γ
// and of ∂β over its k qubits (the kernel's own note, below).
//
// Bound on the H100: bytes. The fused pass reads re, im, cutv and writes
// re, im: 20 bytes per amplitude, against ~50-80 flops per amplitude (one
// sincos, 6 phase flops, 6 per mixer qubit); the gradient pass reads two
// planes more, 28 bytes, against ~3k more flops. The trailing mixer moves
// 16 bytes per amplitude for 6k flops.
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

// the tile's elements of one plane in layout C: float4s where vec, else
// one at a time; zeros past the tile's end
__device__ __forceinline__ void load_c(float (&v)[kRegs],
                                       const float* __restrict__ p,
                                       int64_t base, int lane, int warp,
                                       int n_el, bool full, int vec) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < kRegs / 4; ++j) {
      const int e = elem_c(lane, warp, 4 * j);
      const float4 c4 = full || e < n_el
          ? *reinterpret_cast<const float4*>(p + base + e)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * j] = c4.x;
      v[4 * j + 1] = c4.y;
      v[4 * j + 2] = c4.z;
      v[4 * j + 3] = c4.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int e = elem_c(lane, warp, r);
      v[r] = e < n_el ? p[base + e] : 0.f;
    }
  }
}

// the planes x, y from layout C to the tile's elements, none past its end
__device__ __forceinline__ void store_c(const float (&x)[kRegs],
                                        const float (&y)[kRegs],
                                        float* __restrict__ ore,
                                        float* __restrict__ oim, int64_t base,
                                        int lane, int warp, int n_el,
                                        bool full, int vec) {
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

// The mixer on the tile: x, y arrive in layout A and leave in layout C,
// RX(2 beta) applied on every qubit below k on the way
__device__ __forceinline__ void mix_tile(float (&x)[kRegs], float (&y)[kRegs],
                                         float* s_re, float* s_im, int lane,
                                         int warp, int k, float cb, float sb) {
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
  // layout C's cost values, used at the end
  if (kPhase && reverse) load_c(cv, cutv, base, lane, warp, n_el, full, vec);
  if (kPhase && !reverse) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) rotate(x[r], y[r], g * cv[r]);
  }
  mix_tile(x, y, s_re, s_im, lane, warp, k, cb, sb);
  if (kPhase && reverse) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) rotate(x[r], y[r], g * cv[r]);
  }
  store_c(x, y, ore, oim, base, lane, warp, n_el, full, vec);
}

// one gradient term, rounded as written (no FMA)
__device__ __forceinline__ float term(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// The reversed pass with the layer's gradients: an overload of the same
// template, so that the forward instance keeps its registers and a trace
// names this one fused_kernel<true> too. Run at the pass's angles
// (-gamma, -beta) on the cotangent d that the strided adjoint passes have
// carried back to it, beside the layer's input `in`. After its
// butterflies a tile holds w = U_M^† d, every qubit's RX undone, and it
// forms v = e^{-i gamma c} in, the state before the mixer, from the sincos
// its phase takes anyway. X_q commutes with every RX factor, so the ∂β
// term of qubit q, Im<d|X_q|o> at the layer's output, is Im<w|X_q|v>
// here; each tile writes one f64 partial of
//   ∂γ = sum_x c (in_im g_re - in_re g_im),   g = e^{i gamma c} w
//       (the phase rule on the pass's own output, as pq_phase_grad has it)
//   ∂β = sum_x sum_{q<k} (w_re v_im[x ^ 2^q] - w_im v_re[x ^ 2^q]).
// The input is loaded in layout C beside the cost values, in flight during
// the butterflies. v's partners in layout C: bits 0, 1, 10 and 11 in the
// thread, 2-6 from the lane's neighbour (__shfl_xor_sync), 7-9 from
// another warp's words of shared memory. Each term is rounded as written;
// an amplitude's k terms fill leaves 0..k-1 of a pairwise f32 tree of 16
// leaves (zeros past k), summed in f64 in a fixed order a thread, a warp
// and the tile. A partial's place is its tile's in the row, never the
// batch's.
template <bool kPhase>
__global__ void __launch_bounds__(pq::kThreads, 2)
fused_kernel(const float* __restrict__ d_re, const float* __restrict__ d_im,
             const float* __restrict__ cutv, const float* __restrict__ gamma,
             const float* __restrict__ beta, const float* __restrict__ in_re,
             const float* __restrict__ in_im, float* __restrict__ ore,
             float* __restrict__ oim, double* __restrict__ beta_part,
             double* __restrict__ gamma_part, int64_t beta_parts,
             int64_t blocks_per_batch, int k, int tile_rows, int vec) {
  static_assert(kPhase, "the gradients are those of the phase pass");
  __shared__ __align__(16) float s_re[pq::kTile];
  __shared__ __align__(16) float s_im[pq::kTile];
  __shared__ double s_sum[2][pq::kThreads / 32];
  const int n_el = tile_rows << k;
  const bool full = n_el == pq::kTile;
  const int64_t b = blockIdx.x / blocks_per_batch;
  const int64_t tile = blockIdx.x - b * blocks_per_batch;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_el;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float g = gamma[b];
  float sb, cb;
  sincosf(beta[b], &sb, &cb);
  float x[kRegs], y[kRegs], cv[kRegs], vr[kRegs], vi[kRegs];

#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int e = elem_a(lane, warp, r);
    const bool in = full || e < n_el;
    x[r] = in ? d_re[base + e] : 0.f;
    y[r] = in ? d_im[base + e] : 0.f;
  }
  load_c(cv, cutv, base, lane, warp, n_el, full, vec);
  load_c(vr, in_re, base, lane, warp, n_el, full, vec);
  load_c(vi, in_im, base, lane, warp, n_el, full, vec);
  mix_tile(x, y, s_re, s_im, lane, warp, k, cb, sb);

  // x, y hold w. Per amplitude: g (to the output), its ∂γ term, then v in
  // the input's registers: e^{-i a} w and e^{+i a} in, a = g c
  double acc_g = 0.0;
#pragma unroll
  for (int j = 0; j < kRegs / 4; ++j) {
    float gr[4], gi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = 4 * j + u;
      float s, c;
      sincosf(g * cv[r], &s, &c);
      gr[u] = x[r] * c + y[r] * s;
      gi[u] = y[r] * c - x[r] * s;
      acc_g += static_cast<double>(__fmul_rn(cv[r], term(vi[r], gr[u], vr[r], gi[u])));
      const float nr = __fsub_rn(__fmul_rn(vr[r], c), __fmul_rn(vi[r], s));
      vi[r] = __fadd_rn(__fmul_rn(vi[r], c), __fmul_rn(vr[r], s));
      vr[r] = nr;
    }
    const int e = elem_c(lane, warp, 4 * j);
    if (vec) {
      if (full || e < n_el) {
        *reinterpret_cast<float4*>(ore + base + e) = make_float4(gr[0], gr[1], gr[2], gr[3]);
        *reinterpret_cast<float4*>(oim + base + e) = make_float4(gi[0], gi[1], gi[2], gi[3]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (e + u < n_el) {
          ore[base + e + u] = gr[u];
          oim[base + e + u] = gi[u];
        }
      }
    }
  }

  // v to the words of shared memory this thread read in layout C (no
  // other thread's), for the partners across warps
#pragma unroll
  for (int j = 0; j < kRegs / 4; ++j) {
    const int w = word(elem_c(lane, warp, 4 * j));
    *reinterpret_cast<float4*>(s_re + w) =
        make_float4(vr[4 * j], vr[4 * j + 1], vr[4 * j + 2], vr[4 * j + 3]);
    *reinterpret_cast<float4*>(s_im + w) =
        make_float4(vi[4 * j], vi[4 * j + 1], vi[4 * j + 2], vi[4 * j + 3]);
  }
  __syncthreads();
  double acc_b = 0.0;
#pragma unroll
  for (int j = 0; j < kRegs / 4; ++j) {
    // lv[u][l]: the open block of 2^l leaves of amplitude u's tree
    float lv[4][4];
#pragma unroll
    for (int q = 0; q < 12; ++q) {
      float pr[4] = {0.f, 0.f, 0.f, 0.f}, pi[4] = {0.f, 0.f, 0.f, 0.f};
      if (q < k) {  // the same for every thread: shuffles stay whole
        if (q < 2) {  // bits 0-1: the float4's other components
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            pr[u] = vr[4 * j + (u ^ (1 << q))];
            pi[u] = vi[4 * j + (u ^ (1 << q))];
          }
        } else if (q < 7) {  // bits 2-6: the lane's neighbour
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            pr[u] = __shfl_xor_sync(~0u, vr[4 * j + u], 1 << (q - 2));
            pi[u] = __shfl_xor_sync(~0u, vi[4 * j + u], 1 << (q - 2));
          }
        } else if (q < 10) {  // bits 7-9: another warp's words
          const int w = word(elem_c(lane, warp ^ (1 << (q - 7)), 4 * j));
          const float4 r4 = *reinterpret_cast<const float4*>(s_re + w);
          const float4 i4 = *reinterpret_cast<const float4*>(s_im + w);
          pr[0] = r4.x; pr[1] = r4.y; pr[2] = r4.z; pr[3] = r4.w;
          pi[0] = i4.x; pi[1] = i4.y; pi[2] = i4.z; pi[3] = i4.w;
        } else {  // bits 10-11: this thread's other chunks
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            pr[u] = vr[4 * (j ^ (1 << (q - 10))) + u];
            pi[u] = vi[4 * (j ^ (1 << (q - 10))) + u];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float t = q < k ? term(x[4 * j + u], pi[u], y[4 * j + u], pr[u]) : 0.f;
        // close every block that leaf q completes
        if (!(q & 1)) {
          lv[u][0] = t;
        } else {
          t = __fadd_rn(lv[u][0], t);
          if (!(q & 2)) {
            lv[u][1] = t;
          } else {
            t = __fadd_rn(lv[u][1], t);
            if (!(q & 4)) {
              lv[u][2] = t;
            } else {
              lv[u][3] = __fadd_rn(lv[u][2], t);
            }
          }
        }
      }
    }
    // leaves 0-7, then 8-11 beside the four zero leaves 12-15
#pragma unroll
    for (int u = 0; u < 4; ++u)
      acc_b += static_cast<double>(__fadd_rn(lv[u][3], __fadd_rn(lv[u][2], 0.f)));
  }
  // the tile's sums, in a fixed order: a warp's shuffle tree, then warps
  for (int off = 16; off > 0; off >>= 1) {
    acc_b += __shfl_down_sync(0xffffffffu, acc_b, off);
    acc_g += __shfl_down_sync(0xffffffffu, acc_g, off);
  }
  if (lane == 0) {
    s_sum[0][warp] = acc_b;
    s_sum[1][warp] = acc_g;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tb = 0.0, tg = 0.0;
    for (int i = 0; i < pq::kThreads / 32; ++i) {
      tb += s_sum[0][i];
      tg += s_sum[1][i];
    }
    beta_part[b * beta_parts + tile] = tb;
    gamma_part[b * blocks_per_batch + tile] = tg;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks a batch row, or -1 on a geometry the kernel does not take.
int64_t blocks_per_batch_of(int64_t rows_per_batch, int k, int64_t tile_rows) {
  if (k < 1 || k > 12 || tile_rows < 1 || rows_per_batch % tile_rows ||
      (tile_rows << k) > pq::kTile)
    return -1;
  return rows_per_batch / tile_rows;
}

template <bool kPhase>
int launch(const void* re, const void* im, const void* cutv,
           const void* gamma, const void* beta, void* ore, void* oim,
           int64_t batch, int64_t rows_per_batch, int k, int reverse,
           int64_t tile_rows, void* stream) {
  const int64_t blocks_per_batch = blocks_per_batch_of(rows_per_batch, k, tile_rows);
  if (blocks_per_batch < 0) return static_cast<int>(cudaErrorInvalidValue);
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

// The layer backward's reversed pass with its gradients. d_re, d_im (the
// cotangent at the pass), cutv, re, im (the layer's input), ore, oim (B,
// R, 2^k) f32; gamma, beta (B,) f32, the pass's angles (the layer's
// negated); geometry as pq_fused_phase_mixer's. Tile t of row b writes
// its ∂β over qubits [0, k) to beta_part[b * beta_parts + t] and its ∂γ
// to gamma_part[b * (R / tile_rows) + t], f64; beta_parts >= R / tile_rows.
PQ_EXPORT int pq_fused_layer_grads(const void* d_re, const void* d_im,
                                   const void* cutv, const void* gamma,
                                   const void* beta, const void* re,
                                   const void* im, void* ore, void* oim,
                                   void* beta_part, void* gamma_part,
                                   int64_t beta_parts, int64_t batch,
                                   int64_t rows_per_batch, int k,
                                   int64_t tile_rows, void* stream) {
  const int64_t blocks_per_batch = blocks_per_batch_of(rows_per_batch, k, tile_rows);
  if (blocks_per_batch < 0 || beta_parts < blocks_per_batch)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (tile_rows << k) % 4 == 0 && aligned16(ore) &&
                  aligned16(oim) && aligned16(cutv) && aligned16(re) &&
                  aligned16(im);
  fused_kernel<true><<<static_cast<unsigned>(batch * blocks_per_batch),
                       pq::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_re), static_cast<const float*>(d_im),
      static_cast<const float*>(cutv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(re),
      static_cast<const float*>(im), static_cast<float*>(ore),
      static_cast<float*>(oim), static_cast<double*>(beta_part),
      static_cast<double*>(gamma_part), beta_parts, blocks_per_batch, k,
      static_cast<int>(tile_rows), vec);
  return static_cast<int>(cudaGetLastError());
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
