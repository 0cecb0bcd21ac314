// Cut values of a batch of ±1 spin rows through the dense adjacency, on the
// tensor cores.
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
// Bound on the H100: at (2^18, 400) the bytes of the spins (0.13 ms at
// 3.35 TB/s); at (4096, 16000) the 2 * B * V^2 * t operations at the bf16
// dense tensor-core rate (989 TFLOP/s), t the number of nonzero planes
// below (1 on unit weights).
//
// Design, on one stream:
// 1. The split (pq_cut_batch_split) writes A as three bf16 planes with
//    A1 + A2 + A3 = A: A1 = bf16(A), A2 = bf16(A - A1), A3 = bf16(A - A1 -
//    A2). Each residual is exact in f32 and holds at most 16, then 8
//    significant bits, so A3 is exact and the sum is A (for |A| above
//    bf16's subnormal range). Integers |w| <= 256 leave A2 = A3 = 0. The
//    planes are padded with zeros to (round_up(V, 128), round_up(V, 64)),
//    so tiles of A need no mask. Pass 1 writes A1 and one flag a plane
//    (atomicOr, once a block) saying whether it holds a nonzero entry;
//    pass 2 writes A2 and A3 only where their flags are set, so unit
//    weights write one plane. The host never reads the flags.
// 2. cut_batch_cast copies the spins to bf16 (exact for ±1), padded with
//    zeros to (round_up(B, 128), round_up(V, 64)), so the product's K loop
//    has no masks and reads 2 bytes a spin.
//    cut_batch_mma: a block owns `batch_tile` spin rows (BM) and a span of
//    128 columns c of P = S A^T, whose quadratic form with S is s^T A s for
//    any A: so the second ("col") operand of the product is A row-major,
//    with no transpose and no assumption of symmetry. 8 warps as 2 x 4,
//    each a (BM / 2) x 32 tile of m16n8k16 bf16 products with f32
//    accumulators (at most 64 a thread, at most 128 registers: two blocks
//    an SM). The block walks K in `k_chunk` slices (BK) for each plane
//    whose flag is set (a uniform branch on a device value: unit weights
//    pay for one product), through a ring of 4 (BK 32) or 3 (BK 64) stages
//    of shared memory that cp.async fills while earlier slices are
//    multiplied; both operands' fragments come from ldmatrix (rows padded
//    by 16 bytes: no bank conflicts). Blocks are rastered in groups of 64
//    row tiles, so the row tiles that share a span of A, and the spans that
//    share a row tile, are in flight together and read each other's
//    operands from L2.
// 3. The epilogue multiplies each accumulator by the spin of its (row,
//    column), adds a thread's 8 columns of a row in order, the 4 threads of
//    a quad by a fixed xor-shuffle tree and the 4 warps of a span through
//    shared memory in order: one partial per (row, span). cut_batch_epilogue
//    sums a row's partials over the spans in index order and applies
//    (W - q/2)/2. No atomics on the sums.
//
// Exactness: with integer weights every product and partial sum is an
// integer below 2^24, so the result is exact and equal to the plain
// version's bits, under every (batch_tile, k_chunk): the order of every
// addition depends only on V. With real weights the terms s_r A_rc s_c are
// exact, and the two sums differ only in their order: the plain version
// and this kernel each carry a rounding error of a few units of 2^-24 of
// sum |A| (the sum of the terms' magnitudes, the quadratic form's
// condition scale). The stated tolerance on a cut value is
// CUT_BATCH_RTOL * sum |A| with CUT_BATCH_RTOL = 8 * 2^-24 (cutbatch.py).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBN = 128;      // columns per span
constexpr int kGroupM = 64;   // row tiles per raster group
constexpr int kPlanes = 3;
constexpr int kRowAlign = 128;  // plane rows padded to a span
constexpr int kColAlign = 64;   // plane columns padded to the largest BK

// The three bf16 parts of a: a1 = bf16(a), a2 = bf16(r1), a3 = bf16(r2)
// with r1 = a - a1 and r2 = r1 - a2, each exact in f32.
struct Split {
  __nv_bfloat16 a1, a2, a3;
  float r1, r2;
  __device__ __forceinline__ explicit Split(float a) {
    a1 = __float2bfloat16_rn(a);
    r1 = __fsub_rn(a, __bfloat162float(a1));
    a2 = __float2bfloat16_rn(r1);
    r2 = __fsub_rn(r1, __bfloat162float(a2));
    a3 = __float2bfloat16_rn(r2);
  }
};

// Four consecutive entries of row r of a (rows, v) row-major f32 array from
// column c, zeros past its edges; vec4: v % 4 == 0 and the array 16-byte
// aligned, so a group lies wholly inside or past column v.
__device__ __forceinline__ float4 load4(const float* __restrict__ a, int64_t rows,
                                        int64_t v, int64_t r, int64_t c, bool vec4) {
  if (r >= rows || c >= v) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec4) return *reinterpret_cast<const float4*>(a + r * v + c);
  const float* p = a + r * v;
  return make_float4(p[c], c + 1 < v ? p[c + 1] : 0.f, c + 2 < v ? p[c + 2] : 0.f,
                     c + 3 < v ? p[c + 3] : 0.f);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, __nv_bfloat16 x,
                                       __nv_bfloat16 y, __nv_bfloat16 z,
                                       __nv_bfloat16 w) {
  __nv_bfloat162 lo, hi;
  lo.x = x; lo.y = y; hi.x = z; hi.y = w;
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Pass 1 of the split: A1 over the padded plane, four columns a thread,
// and the three flags (A2 and A3 are nonzero where r1 and r2 are).
__global__ void __launch_bounds__(pq::kThreads)
cut_batch_split_hi(const float* __restrict__ adj, __nv_bfloat16* __restrict__ planes,
                   int* __restrict__ flags, int64_t v, int64_t vn, int64_t vk,
                   bool vec4) {
  bool nz[kPlanes] = {false, false, false};
  for (int64_t r = blockIdx.x; r < vn; r += gridDim.x) {
    for (int64_t c = 4 * threadIdx.x; c < vk; c += 4 * blockDim.x) {
      const float4 a = load4(adj, v, v, r, c, vec4);
      const Split x(a.x), y(a.y), z(a.z), w(a.w);
      store4(planes + r * vk + c, x.a1, y.a1, z.a1, w.a1);
      nz[0] |= a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
      nz[1] |= x.r1 != 0.f || y.r1 != 0.f || z.r1 != 0.f || w.r1 != 0.f;
      nz[2] |= x.r2 != 0.f || y.r2 != 0.f || z.r2 != 0.f || w.r2 != 0.f;
    }
  }
#pragma unroll
  for (int t = 0; t < kPlanes; ++t)
    if (__syncthreads_or(nz[t]) && threadIdx.x == 0) atomicOr(flags + t, 1);
}

// Pass 2: A2 and A3, each only where its flag is set (a plane whose flag is
// clear is never read); on unit weights every block returns at once.
__global__ void __launch_bounds__(pq::kThreads)
cut_batch_split_lo(const float* __restrict__ adj, __nv_bfloat16* __restrict__ planes,
                   const int* __restrict__ flags, int64_t v, int64_t vn,
                   int64_t vk, bool vec4) {
  const bool w2 = flags[1] != 0, w3 = flags[2] != 0;
  if (!w2 && !w3) return;
  const int64_t plane = vn * vk;
  for (int64_t r = blockIdx.x; r < vn; r += gridDim.x) {
    for (int64_t c = 4 * threadIdx.x; c < vk; c += 4 * blockDim.x) {
      const float4 a = load4(adj, v, v, r, c, vec4);
      const Split x(a.x), y(a.y), z(a.z), w(a.w);
      if (w2) store4(planes + plane + r * vk + c, x.a2, y.a2, z.a2, w.a2);
      if (w3) store4(planes + 2 * plane + r * vk + c, x.a3, y.a3, z.a3, w.a3);
    }
  }
}

// Spins (B, V) f32 -> (Bp, Vk) bf16, zero past B and V (exact for ±1).
__global__ void __launch_bounds__(pq::kThreads)
cut_batch_cast(const float* __restrict__ spins, __nv_bfloat16* __restrict__ sb,
               int64_t batch, int64_t v, int64_t bp, int64_t vk, bool vec4) {
  for (int64_t r = blockIdx.x; r < bp; r += gridDim.x) {
    for (int64_t c = 4 * threadIdx.x; c < vk; c += 4 * blockDim.x) {
      const float4 x = load4(spins, batch, v, r, c, vec4);
      store4(sb + r * vk + c, __float2bfloat16_rn(x.x), __float2bfloat16_rn(x.y),
             __float2bfloat16_rn(x.z), __float2bfloat16_rn(x.w));
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// four 8x8 b16 matrices from shared memory; lane L gives the row address of
// matrix L / 8, row L % 8; register m holds (row T / 4, cols 2 (T % 4), +1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BK>
struct Tile {
  static constexpr int kStages = BK == 32 ? 4 : 3;
  static constexpr int kLd = BK + 8;  // bf16: row stride = 16 bytes mod 128
  static constexpr int kStageBytes = (BM + kBN) * kLd * 2;
  static constexpr int kSmem = kStages * kStageBytes;
};

template <int BM, int BK>
__global__ void __launch_bounds__(pq::kThreads, 2)
cut_batch_mma(const __nv_bfloat16* __restrict__ sb,
              const __nv_bfloat16* __restrict__ planes,
              const int* __restrict__ flags, float* __restrict__ partial,
              int64_t batch, int64_t v, int64_t vn, int64_t vk,
              int64_t row_tiles, int64_t n_spans) {
  using T = Tile<BM, BK>;
  constexpr int kMI = BM / 32;  // m16 tiles a warp: BM / 2 rows
  constexpr int kNI = 4;        // n8 tiles a warp: 32 columns
  extern __shared__ __align__(16) unsigned char smem[];

  // grouped raster: within a group of kGroupM row tiles, row tile fastest
  const int64_t tile = blockIdx.x;
  const int64_t group = tile / (kGroupM * n_spans);
  const int64_t first = group * kGroupM;
  const int64_t gm = row_tiles - first < kGroupM ? row_tiles - first : kGroupM;
  const int64_t local = tile % (kGroupM * n_spans);
  const int64_t rt = first + local % gm, span = local / gm;
  const int64_t row0 = rt * BM, col0 = span * kBN;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tg = lane % 4;

  // the planes to multiply, in order (a uniform branch on device values)
  int act[kPlanes], n_act = 0;
#pragma unroll
  for (int t = 0; t < kPlanes; ++t)
    if (flags[t]) act[n_act++] = t;
  const int nk = static_cast<int>(vk / BK);
  const int n_tiles = n_act * nk;

  auto stage_a = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * T::kStageBytes);
  };
  auto stage_b = [&](int s) { return stage_a(s) + BM * T::kLd; };
  // K slice `it` (plane act[it / nk], columns (it % nk) * BK ...) into
  // stage s: both operands padded with zeros, so no masks
  auto load = [&](int it, int s) {
    const int64_t k0 = static_cast<int64_t>(it % nk) * BK;
    __nv_bfloat16* sa = stage_a(s);
    for (int e = tid; e < BM * BK / 8; e += pq::kThreads) {
      const int r = e / (BK / 8), kk = (e % (BK / 8)) * 8;
      cp_async16(sa + r * T::kLd + kk, sb + (row0 + r) * vk + k0 + kk);
    }
    const __nv_bfloat16* pl = planes + act[it / nk] * vn * vk;
    __nv_bfloat16* sp = stage_b(s);
    for (int e = tid; e < kBN * BK / 8; e += pq::kThreads) {
      const int r = e / (BK / 8), kk = (e % (BK / 8)) * 8;
      cp_async16(sp + r * T::kLd + kk, pl + (col0 + r) * vk + k0 + kk);
    }
  };

  float acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  const int m = lane / 8;  // the ldmatrix sub-matrix this lane addresses
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // slice `it` landed; every warp is done with it - 1
    const int nxt = it + T::kStages - 1;
    if (nxt < n_tiles) load(nxt, nxt % T::kStages);
    cp_async_commit();
    const __nv_bfloat16* sa = stage_a(it % T::kStages);
    const __nv_bfloat16* sp = stage_b(it % T::kStages);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // B fragments of n-tiles (2 jp, 2 jp + 1): matrices (n, k lo), (n, k hi)
      uint32_t bfr[kNI][2];
#pragma unroll
      for (int jp = 0; jp < kNI / 2; ++jp) {
        uint32_t d[4];
        ldmatrix_x4(d, sp + (wn * 32 + (2 * jp + m / 2) * 8 + lane % 8) * T::kLd +
                           kk + (m % 2) * 8);
        bfr[2 * jp][0] = d[0];
        bfr[2 * jp][1] = d[1];
        bfr[2 * jp + 1][0] = d[2];
        bfr[2 * jp + 1][1] = d[3];
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        // A fragment: matrices (rows 0-7, k lo), (8-15, k lo), (0-7, k hi), (8-15, k hi)
        uint32_t af[4];
        ldmatrix_x4(af, sa + (wm * (BM / 2) + i * 16 + (m % 2) * 8 + lane % 8) * T::kLd +
                            kk + (m / 2) * 8);
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_bf16(acc[i][j], af, bfr[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: the row sums reuse them

  // epilogue: accumulator c_r of tile (i, j) sits at row g (+8 for r >= 2)
  // and column 2 tg + (r & 1) of the tile; spins from the bf16 copy (±1,
  // zero past B and V)
  float* s_red = reinterpret_cast<float*>(smem);  // [BM][4]
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * (BM / 2) + i * 16 + g + 8 * h;
      const __nv_bfloat16* srow = sb + (row0 + lr) * vk + col0 + wn * 32 + 2 * tg;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        // spans reach round_up(V, 128) columns, the copy round_up(V, 64)
        const bool in = col0 + wn * 32 + j * 8 < vk;
        const float2 s2 = in ? __bfloat1622float2(
                                   *reinterpret_cast<const __nv_bfloat162*>(srow + j * 8))
                             : make_float2(0.f, 0.f);
        p = __fadd_rn(p, __fmul_rn(acc[i][j][2 * h], s2.x));
        p = __fadd_rn(p, __fmul_rn(acc[i][j][2 * h + 1], s2.y));
      }
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 1));
      p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, 2));
      if (tg == 0) s_red[lr * 4 + wn] = p;
    }
  }
  __syncthreads();
  for (int r = tid; r < BM; r += pq::kThreads) {
    const int64_t gr = row0 + r;
    if (gr < batch)
      partial[gr * n_spans + span] =
          __fadd_rn(__fadd_rn(s_red[r * 4], s_red[r * 4 + 1]),
                    __fadd_rn(s_red[r * 4 + 2], s_red[r * 4 + 3]));
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
cudaError_t launch_tile(const __nv_bfloat16* sb, const __nv_bfloat16* planes,
                        const int* flags, float* partial, int64_t batch,
                        int64_t v, int64_t vn, int64_t vk, int64_t n_spans,
                        cudaStream_t st) {
  const int64_t row_tiles = (batch + BM - 1) / BM;
  constexpr int kSmem = Tile<BM, BK>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      cut_batch_mma<BM, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cut_batch_mma<BM, BK>
      <<<static_cast<unsigned>(row_tiles * n_spans), pq::kThreads, kSmem, st>>>(
          sb, planes, flags, partial, batch, v, vn, vk, row_tiles, n_spans);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// adj (V, V) f32 -> planes (3, vn, vk) bf16 with vn = round_up(V, 128),
// vk = round_up(V, 64), and flags (3,) int32 (zeroed here, then set);
// planes 2 and 3 are written only where their flags are set.
PQ_EXPORT int pq_cut_batch_split(const void* adj, void* planes, void* flags,
                                 int64_t v, int64_t vn, int64_t vk,
                                 void* stream) {
  if (vn % kRowAlign || vk % kColAlign || vn < v || vk < v)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, kPlanes * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(vn < 4096 ? vn : 4096);
  const float* a = static_cast<const float*>(adj);
  __nv_bfloat16* pl = static_cast<__nv_bfloat16*>(planes);
  const bool vec4 = v % 4 == 0 && aligned16(adj);
  cut_batch_split_hi<<<blocks, pq::kThreads, 0, st>>>(
      a, pl, static_cast<int*>(flags), v, vn, vk, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cut_batch_split_lo<<<blocks, pq::kThreads, 0, st>>>(
      a, pl, static_cast<const int*>(flags), v, vn, vk, vec4);
  return static_cast<int>(cudaGetLastError());
}

// spins (B, V) f32; sb (round_up(B, 128), vk) bf16 scratch; planes and
// flags from pq_cut_batch_split; wtot (1,) f32; partial (B, ceil(V/128))
// f32 scratch; out (B,) f32. batch_tile in {64, 128}, k_chunk in {32, 64}.
PQ_EXPORT int pq_cut_batch_dense(const void* spins, void* sb, const void* planes,
                                 const void* flags, const void* wtot,
                                 void* partial, void* out, int64_t batch,
                                 int64_t v, int64_t vn, int64_t vk,
                                 int batch_tile, int k_chunk, void* stream) {
  if (vn % kRowAlign || vk % kColAlign || vn < v || vk < v ||
      (batch_tile != 64 && batch_tile != 128) || (k_chunk != 32 && k_chunk != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_spans = (v + kBN - 1) / kBN;
  const int64_t bp = (batch + kRowAlign - 1) / kRowAlign * kRowAlign;
  __nv_bfloat16* s = static_cast<__nv_bfloat16*>(sb);
  cut_batch_cast<<<static_cast<unsigned>(bp < 4096 ? bp : 4096), pq::kThreads, 0,
                   st>>>(static_cast<const float*>(spins), s, batch, v, bp, vk,
                         v % 4 == 0 && aligned16(spins));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const __nv_bfloat16* pl = static_cast<const __nv_bfloat16*>(planes);
  const int* fl = static_cast<const int*>(flags);
  float* p = static_cast<float*>(partial);
  if (batch_tile == 64 && k_chunk == 32)
    err = launch_tile<64, 32>(s, pl, fl, p, batch, v, vn, vk, n_spans, st);
  else if (batch_tile == 64)
    err = launch_tile<64, 64>(s, pl, fl, p, batch, v, vn, vk, n_spans, st);
  else if (k_chunk == 32)
    err = launch_tile<128, 32>(s, pl, fl, p, batch, v, vn, vk, n_spans, st);
  else
    err = launch_tile<128, 64>(s, pl, fl, p, batch, v, vn, vk, n_spans, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cut_batch_epilogue<<<static_cast<unsigned>((batch + pq::kThreads - 1) /
                                             pq::kThreads),
                       pq::kThreads, 0, st>>>(
      p, static_cast<const float*>(wtot), static_cast<float*>(out), batch,
      n_spans);
  return static_cast<int>(cudaGetLastError());
}
