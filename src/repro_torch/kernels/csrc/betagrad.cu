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
// Bound on the H100: bytes. A launch reads the four (B, 2^n) f32 planes
// once (16 bytes an amplitude) against 4 flops an amplitude and qubit,
// and writes no plane. A qubit's partner lies 2^q amplitudes away, so the
// range is cut into groups (ref.beta_grad_launches), and a launch reads
// the planes once for one group or two: 2 launches at n = 24, one for
// qubits 0-11 and one for 12-17 and 18-23.
//
// Design. A group of k qubits [g0, g0 + k) is a pass on the (B, X, 2^k, Y)
// view (Y = 2^g0): a tile is all 2^k combinations of the group's qubits
// times L lanes of Y (times S consecutive x where the tile takes all of
// Y), at most 4096 amplitudes, staged in one CTA's shared memory. Above
// qubit 11 a group cannot hold 12 qubits beside runs of at least 64 bytes
// (16 lanes; 32-byte runs and tiles spread over a thread-block cluster
// both measured slower on the H100), so the upper 12 qubits at n = 24 are
// two groups of 6 on runs of 64 lanes (256 bytes), fused into one launch:
// its jobs go region by region, a region holding every amplitude that one
// tile of either group holds, so the two groups' tiles of a region run
// side by side and the second read of each line hits L2. Only equal halves
// are fused: at n = 23, halves of 6 and 5 qubits (the second on half
// tiles, through the generic instance) made ∂β take 10.0 ms on the H100
// against 3.5 ms at n = 24, so an odd count goes group by group.
//  - Staging is asynchronous: a persistent CTA walks its jobs with three
//    stages of shared memory (3 x 64 KB) and one mbarrier each; thread 0
//    issues the copies of the job two ahead (one cp.async.bulk a plane
//    where a tile is contiguous, a 3-D TMA tensor map over rows of Y where
//    it is runs of L lanes) before the CTA computes on this one, so the
//    loads overlap the math.
//  - Pairs meet in registers where they can: a thread holds 16
//    amplitudes, four float4s (element bits 0-1) 128 elements apart (bits
//    7-8); bits 2-6 are the lane, paired by __shfl_xor_sync; only bits
//    9-11 (the warp) read shared memory. A launch whose groups fill their
//    tiles at element bits [lo, 12) runs an instance of its own for that
//    lo (twelve), with no select and no add of a leaf known to be zero.
//  - Numerics: each amplitude's term of group qubit q, d_ore * oim' -
//    d_oim * ore', is rounded as written (no FMA) into leaf log2(L) + q of
//    a fixed pairwise tree of 16 f32 leaves (zeros elsewhere); the tree's
//    values are summed in f64 in a fixed order a thread, a warp and a CTA,
//    into one partial a tile, whose place in a row's partials depends on
//    the tile alone, never on B. pq_beta_grad_final sums a row's partials
//    in a fixed order, in f64, and rounds once to f32. No atomics: the same
//    inputs give the same bits, and a row gives the same bits alone and in
//    a batch. Each term passes through at most 2 + 4 f32 roundings before
//    the f64 sums, so the result lies within 7 * 2^-24 of
//    sum_x sum_q (|d_ore oim'| + |d_oim ore'|) of the exact sum.
#include "common.cuh"

#include <cstring>

namespace {

constexpr int kLogTile = 12;
constexpr int kTile = 1 << kLogTile;  // amplitudes of a plane a CTA stages
constexpr int kLogChunks = 2;
constexpr int kChunks = 1 << kLogChunks;  // float4s a thread holds, 128 elements apart
constexpr int kThreads = kTile / (4 * kChunks);  // 256: 8 warps, 16 amplitudes each
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 4;  // d_ore, d_oim, ore, oim
constexpr int kStages = 3;
constexpr int kSmem = kStages * kPlanes * kTile * static_cast<int>(sizeof(float));
constexpr int kSlots = 16;    // leaves of an amplitude's tree
constexpr int kMaxK = 12;     // qubits a group
using pq::bulk_copy;
using pq::kMaxBox;
using pq::mbar_arrive;
using pq::mbar_expect;
using pq::mbar_init;
using pq::mbar_wait;
using pq::tma_3d;

// One group: qubits [g0, g0 + k) on the (B, X, 2^k, Y) view.
struct Pass {
  int64_t dim;      // 2^n
  int64_t x_dim;    // X
  int64_t y_dim;    // Y = 2^g0
  int64_t slabs;    // S: consecutive x a tile (L == Y), else 1
  int64_t x_tiles;  // X / S
  int64_t y_tiles;  // Y / L
  int log2_x_tiles, log2_y_tiles;  // tile indices by shifts, not 64-bit division
  int64_t tiles;    // B * x_tiles * y_tiles
  int64_t part0;    // its first partial in a row
  int k, log2_lanes;
  int elems;  // E = 2^k * L * S amplitudes a tile
  int mode;   // 0 plain loads, 1 bulk copies, 2 TMA tensor maps
  int box_inner, box_rows, boxes_rows;  // mode 2: a box is (box_inner, L / box_inner, box_rows)
};

// One launch: one group, or two (the second's g0 = the first's g0 + k,
// the same lanes) whose jobs interleave region by region.
struct Launch {
  Pass p0, p1;
  int npass;
  int64_t row_parts;
  int64_t jobs;
  uint32_t per0, per1;  // tiles of each group a region (fused; jobs < 2^31)
  int log2_y_tiles0;     // regions a (row, x of the second group): 2^this
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the term of one pair, rounded as written
__device__ __forceinline__ float term(float dr, float di, float pre, float pim) {
  return __fsub_rn(__fmul_rn(dr, pim), __fmul_rn(di, pre));
}

// Job -> (group w, its tile ct). Fused: region r = (b, x of the second
// group, lane tile of the first) holds per0 tiles of the first group (one
// a combination of the second group's qubits) and per1 of the second (one
// a combination of the first's), the same amplitudes.
__device__ __forceinline__ void job_at(const Launch& L, int64_t job, int& w, int64_t& ct) {
  if (L.npass == 1) {
    w = 0;
    ct = job;
    return;
  }
  const uint32_t j32 = static_cast<uint32_t>(job), per = L.per0 + L.per1;
  const uint32_t r = j32 / per, i = j32 - r * per;
  const int64_t yt = r & ((1u << L.log2_y_tiles0) - 1), bx = r >> L.log2_y_tiles0;
  if (i < L.per0) {
    w = 0;
    ct = ((bx * L.per0 + i) << L.log2_y_tiles0) + yt;
  } else {
    w = 1;
    ct = (bx << L.p1.log2_y_tiles) + (static_cast<int64_t>(i - L.per0) << L.log2_y_tiles0) + yt;
  }
}

// Where tile ct of a group starts: row b, slab tile xs, lane tile yt.
struct TileAt {
  int64_t b, xs, yt;
};

__device__ __forceinline__ TileAt tile_at(const Pass& p, int64_t ct) {
  TileAt t;
  t.yt = ct & (p.y_tiles - 1);
  const int64_t r = ct >> p.log2_y_tiles;
  t.xs = r & (p.x_tiles - 1);
  t.b = r >> p.log2_x_tiles;
  return t;
}

// Thread 0: the copies of tile ct into one stage (mode 0: the barrier's
// arrival alone; the threads load the tile themselves).
__device__ void issue_tile(const Pass& p, int64_t ct, float* stage, uint64_t* bar,
                           const float* const* planes, const CUtensorMap* const* maps) {
  if (p.mode == 0) {
    mbar_arrive(bar);
    return;
  }
  const TileAt t = tile_at(p, ct);
  mbar_expect(bar, static_cast<uint32_t>(kPlanes * p.elems * sizeof(float)));
  if (p.mode == 1) {  // contiguous: S slabs of 2^k * Y
    const int64_t start = t.b * p.dim + (t.xs * p.slabs << p.k) * p.y_dim;
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl)
      bulk_copy(stage + pl * kTile, planes[pl] + start,
                static_cast<uint32_t>(p.elems * sizeof(float)), bar);
  } else {  // runs of L lanes: rows (b, x, a) of Y in the 3-D map
    const int64_t row0 = (t.b * p.x_dim + t.xs) << p.k;
    const int lanes = 1 << p.log2_lanes;
    const int c1 = static_cast<int>(t.yt * (lanes / p.box_inner));
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl)
      for (int rb = 0; rb < p.boxes_rows; ++rb)
        tma_3d(stage + pl * kTile + rb * p.box_rows * lanes, maps[pl], 0, c1,
               static_cast<int>(row0 + rb * p.box_rows), bar);
  }
}

// All threads: tile ct by plain loads (shapes no copy engine takes).
__device__ void load_tile(const Pass& p, int64_t ct, float* stage, const float* const* planes) {
  const TileAt t = tile_at(p, ct);
  const int lanes = 1 << p.log2_lanes;
  const int rounded = (p.elems + 3) & ~3;  // zeros up to a whole float4
  for (int e = threadIdx.x; e < rounded; e += kThreads) {
    const int y = e & (lanes - 1);
    const int a = (e >> p.log2_lanes) & ((1 << p.k) - 1);
    const int64_t s = e >> (p.log2_lanes + p.k);
    const int64_t off =
        t.b * p.dim + (((t.xs * p.slabs + s) << p.k) + a) * p.y_dim + t.yt * lanes + y;
#pragma unroll
    for (int pl = 0; pl < kPlanes; ++pl)
      stage[pl * kTile + e] = e < p.elems ? planes[pl][off] : 0.f;
  }
}

// LO: where the launch's groups fill their tiles, their element bits
// [LO, 12) fixed at compile time (no selects, no adds of leaves known to be
// zero); LO = -1 where the bits are read from the pass.
template <int LO>
__global__ void __launch_bounds__(kThreads, 1)
beta_grad_kernel(const float* __restrict__ d_ore, const float* __restrict__ d_oim,
                 const float* __restrict__ ore, const float* __restrict__ oim,
                 double* __restrict__ partial, const __grid_constant__ Launch L,
                 const __grid_constant__ CUtensorMap m0_dr,
                 const __grid_constant__ CUtensorMap m0_di,
                 const __grid_constant__ CUtensorMap m0_re,
                 const __grid_constant__ CUtensorMap m0_im,
                 const __grid_constant__ CUtensorMap m1_dr,
                 const __grid_constant__ CUtensorMap m1_di,
                 const __grid_constant__ CUtensorMap m1_re,
                 const __grid_constant__ CUtensorMap m1_im) {
  extern __shared__ __align__(128) float smem[];  // [stage][plane][kTile]
  __shared__ __align__(8) uint64_t bar[kStages];
  __shared__ double s_warp[kWarps];
  const float* planes[kPlanes] = {d_ore, d_oim, ore, oim};
  const CUtensorMap* maps0[kPlanes] = {&m0_dr, &m0_di, &m0_re, &m0_im};
  const CUtensorMap* maps1[kPlanes] = {&m1_dr, &m1_di, &m1_re, &m1_im};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int w;
  int64_t ct;
  if (tid == 0)  // the first kStages - 1 jobs' copies
    for (int i = 0; i < kStages - 1; ++i) {
      const int64_t job = blockIdx.x + static_cast<int64_t>(i) * gridDim.x;
      if (job >= L.jobs) break;
      job_at(L, job, w, ct);
      issue_tile(w ? L.p1 : L.p0, ct, smem + i * kPlanes * kTile, &bar[i], planes,
                 w ? maps1 : maps0);
    }

  int it = 0;
  for (int64_t job = blockIdx.x; job < L.jobs; job += gridDim.x, ++it) {
    job_at(L, job, w, ct);
    const Pass p = w ? L.p1 : L.p0;
    const int s = it % kStages;
    float* stage = smem + s * kPlanes * kTile;
    if (p.mode == 0) load_tile(p, ct, stage, planes);
    mbar_wait(&bar[s], (it / kStages) & 1);
    // the tile is here, and every thread is done with the last one, whose
    // stage takes the copies of the job kStages - 1 ahead
    __syncthreads();
    const int64_t ahead = job + static_cast<int64_t>(kStages - 1) * gridDim.x;
    if (tid == 0 && ahead < L.jobs) {
      const int sa = (it + kStages - 1) % kStages;
      int w2;
      int64_t ct2;
      job_at(L, ahead, w2, ct2);
      issue_tile(w2 ? L.p1 : L.p0, ct2, smem + sa * kPlanes * kTile, &bar[sa], planes,
                 w2 ? maps1 : maps0);
    }

    const float* s_dr = stage;
    const float* s_di = stage + kTile;
    const float* s_re = stage + 2 * kTile;
    const float* s_im = stage + 3 * kTile;
    // the group's element bits: [lo_e, hi_e)
    const int lo_e = LO >= 0 ? LO : p.log2_lanes;
    const int hi_e = LO >= 0 ? kLogTile : p.log2_lanes + p.k;
    // element of (chunk c, component v): warp * 512 + c * 128 + lane * 4 + v
    const int e0 = warp * (128 * kChunks) + lane * 4;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 re[kChunks], im[kChunks];
    bool ok[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      // a fixed instance's groups fill the tile: 4096 amplitudes
      ok[c] = LO >= 0 || e0 + c * 128 < p.elems;
      re[c] = ok[c] ? ld4(s_re + e0 + c * 128) : z;
      im[c] = ok[c] ? ld4(s_im + e0 + c * 128) : z;
    }
    double acc = 0.0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int e = e0 + c * 128;
      const float4 dr = ok[c] ? ld4(s_dr + e) : z;
      const float4 di = ok[c] ? ld4(s_di + e) : z;
      // the pairwise tree of each component, leaf by leaf: lv[v][l] holds
      // the sum of the open block of 2^l leaves, lv[v][4] the root; a block
      // of leaves outside the group is zero (nz false) and is not added, as
      // adding +0 would not change the sum (only a -0 into +0)
      float lv[4][5];
      bool nz[5];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const bool grp = j >= lo_e && j < hi_e;
        float4 pre = z, pim = z;
        if (grp) {
          if (j < 2) {  // element bits 0-1: the float4's other components
            pre = make_float4(comp(re[c], 0 ^ (1 << j)), comp(re[c], 1 ^ (1 << j)),
                              comp(re[c], 2 ^ (1 << j)), comp(re[c], 3 ^ (1 << j)));
            pim = make_float4(comp(im[c], 0 ^ (1 << j)), comp(im[c], 1 ^ (1 << j)),
                              comp(im[c], 2 ^ (1 << j)), comp(im[c], 3 ^ (1 << j)));
          } else if (j < 7) {  // bits 2-6: the lane's neighbour in the warp
            const int m = 1 << (j - 2);
            pre = make_float4(__shfl_xor_sync(~0u, re[c].x, m), __shfl_xor_sync(~0u, re[c].y, m),
                              __shfl_xor_sync(~0u, re[c].z, m), __shfl_xor_sync(~0u, re[c].w, m));
            pim = make_float4(__shfl_xor_sync(~0u, im[c].x, m), __shfl_xor_sync(~0u, im[c].y, m),
                              __shfl_xor_sync(~0u, im[c].z, m), __shfl_xor_sync(~0u, im[c].w, m));
          } else if (j < 7 + kLogChunks) {  // bits 7-8: this thread's other chunks
            pre = re[c ^ (1 << (j - 7))];
            pim = im[c ^ (1 << (j - 7))];
          } else if (j < kLogTile) {  // bits 9-11: another warp's, in shared memory
            pre = ok[c] ? ld4(s_re + (e ^ (1 << j))) : z;
            pim = ok[c] ? ld4(s_im + (e ^ (1 << j))) : z;
          }
        }
        bool nzx = grp;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float x = grp ? term(comp(dr, v), comp(di, v), comp(pre, v), comp(pim, v)) : 0.f;
          nzx = grp;
#pragma unroll
          for (int l = 0; l < 4; ++l) {  // close every block that leaf j completes
            if (!(j & (1 << l))) {
              lv[v][l] = x;
              nz[l] = nzx;
              break;
            }
            if (nz[l]) x = nzx ? __fadd_rn(lv[v][l], x) : lv[v][l];
            nzx = nzx || nz[l];
          }
          if (j == kSlots - 1) lv[v][4] = x;
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) acc += static_cast<double>(lv[v][4]);
    }
    // the tile's sum, in a fixed order: a warp's shuffle tree, then warps
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) s_warp[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      double total = 0.0;
      for (int i = 0; i < kWarps; ++i) total += s_warp[i];
      const TileAt at = tile_at(p, ct);
      partial[at.b * L.row_parts + p.part0 + (at.xs << p.log2_y_tiles) + at.yt] = total;
    }
  }
}

__global__ void __launch_bounds__(pq::kThreads)
beta_grad_final_kernel(const double* __restrict__ partial, float* __restrict__ out,
                       int64_t parts) {
  constexpr int kFinalWarps = pq::kThreads / 32;
  __shared__ double s_warp[kFinalWarps];
  const double* row = partial + static_cast<int64_t>(blockIdx.x) * parts;
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < parts; i += pq::kThreads) acc += row[i];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kFinalWarps; ++w) total += s_warp[w];
    out[blockIdx.x] = static_cast<float>(total);
  }
}

// the (box_inner, Y / box_inner, rows) map of one plane: a box is the
// (box_inner, L / box_inner, box_rows) block, so it lands as rows of L
bool encode_plane(CUtensorMap* map, const void* base, int64_t rows, const Pass& p) {
  return pq::encode_runs(map, base, p.y_dim, rows, int64_t(1) << p.log2_lanes, p.box_inner,
                         p.box_rows);
}

int log2_exact(int64_t v) {
  int l = 0;
  while ((int64_t(1) << l) < v) ++l;
  return (int64_t(1) << l) == v ? l : -1;
}

// Fill one group's Pass and, in mode 2, its four tensor maps; false on a
// geometry the kernel does not take.
bool make_pass(Pass* p, CUtensorMap* maps, const void* const* planes, int64_t batch, int n,
               int g0, int k, int64_t lanes, int64_t slabs, int64_t part0) {
  p->log2_lanes = log2_exact(lanes);
  if (k < 1 || k > kMaxK || g0 < 0 || g0 + k > n || p->log2_lanes < 0 ||
      lanes > (int64_t(1) << g0) || slabs < 1 || log2_exact(slabs) < 0 ||
      (slabs > 1 && lanes != (int64_t(1) << g0)) || p->log2_lanes + k > kSlots)
    return false;
  const int64_t elems = (int64_t(1) << k) * lanes * slabs;
  p->k = k;
  p->y_dim = int64_t(1) << g0;
  p->x_dim = int64_t(1) << (n - g0 - k);
  if (elems > kTile || p->x_dim % slabs) return false;
  p->elems = static_cast<int>(elems);
  p->dim = int64_t(1) << n;
  p->slabs = slabs;
  p->x_tiles = p->x_dim / slabs;
  p->y_tiles = p->y_dim / lanes;
  p->log2_x_tiles = log2_exact(p->x_tiles);
  p->log2_y_tiles = log2_exact(p->y_tiles);
  p->tiles = batch * p->x_tiles * p->y_tiles;
  p->part0 = part0;
  // the copy engine: one bulk copy a plane where a tile is one run, a 3-D
  // tensor map over rows of Y where it is runs of lanes, plain loads for
  // what neither takes (tiles under 16 bytes, unaligned planes)
  bool aligned = true;
  for (int pl = 0; pl < kPlanes; ++pl)
    aligned = aligned && (reinterpret_cast<uintptr_t>(planes[pl]) % 16 == 0);
  p->mode = 0;
  if (aligned && lanes == p->y_dim && elems % 4 == 0) {
    p->mode = 1;
  } else if (aligned && lanes < p->y_dim && lanes % 4 == 0) {
    const int64_t rows_tile = int64_t(1) << k;
    p->box_inner = static_cast<int>(lanes < kMaxBox ? lanes : kMaxBox);
    p->box_rows = static_cast<int>(rows_tile < kMaxBox ? rows_tile : kMaxBox);
    p->boxes_rows = static_cast<int>(rows_tile / p->box_rows);
    const int64_t rows = batch * p->dim / p->y_dim;
    bool encoded = rows <= INT32_MAX;
    for (int pl = 0; pl < kPlanes && encoded; ++pl)
      encoded = encode_plane(&maps[pl], planes[pl], rows, *p);
    if (encoded) p->mode = 2;
  }
  return true;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, double*,
                          const Launch, const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap);

// one instance a lowest element bit of a full tile, then the generic one
constexpr int kGeneric = kLogTile;
const KernelFn kKernels[kGeneric + 1] = {
    beta_grad_kernel<0>, beta_grad_kernel<1>, beta_grad_kernel<2>,  beta_grad_kernel<3>,
    beta_grad_kernel<4>, beta_grad_kernel<5>, beta_grad_kernel<6>,  beta_grad_kernel<7>,
    beta_grad_kernel<8>, beta_grad_kernel<9>, beta_grad_kernel<10>, beta_grad_kernel<11>,
    beta_grad_kernel<-1>};

// Set once an instance, before any capture into a CUDA graph (the warm-up
// does it): its shared memory, and the CTAs the card holds at once.
int launch_kernel(int which, const Launch& L, CUtensorMap (*maps)[kPlanes], const void* d_ore,
                  const void* d_oim, const void* ore, const void* oim, void* partial,
                  cudaStream_t stream) {
  static int max_ctas[kGeneric + 1] = {};
  const KernelFn fn = kKernels[which];
  cudaError_t err;
  if (max_ctas[which] == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    max_ctas[which] = per_sm * sms;
  }
  const int64_t ctas = L.jobs < max_ctas[which] ? L.jobs : max_ctas[which];
  fn<<<static_cast<unsigned>(ctas), kThreads, kSmem, stream>>>(
      static_cast<const float*>(d_ore), static_cast<const float*>(d_oim),
      static_cast<const float*>(ore), static_cast<const float*>(oim),
      static_cast<double*>(partial), L, maps[0][0], maps[0][1], maps[0][2], maps[0][3],
      maps[1][0], maps[1][1], maps[1][2], maps[1][3]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One read of the four (B, 2^n) f32 planes for one group of qubits
// [g0_a, g0_a + k_a), or two (npass = 2: [g0_b, g0_b + k_b) with g0_b =
// g0_a + k_a and lanes_b = lanes_a, fused region by region). A group's
// tiles are 2^k x lanes amplitudes (times slabs consecutive x where lanes
// == 2^g0); partial[b, part0 + xt * (2^g0 / lanes) + yt] (f64, rows of
// row_parts) gets tile (xt, yt)'s sum. k in [1, 12]; lanes a power of two
// dividing 2^g0; 2^k * lanes * slabs <= 4096 and log2(lanes) + k <= 16.
PQ_EXPORT int pq_beta_grad_pass(const void* d_ore, const void* d_oim, const void* ore,
                                const void* oim, void* partial, int64_t batch, int n,
                                int64_t row_parts, int npass, int g0_a, int k_a,
                                int64_t lanes_a, int64_t slabs_a, int64_t part0_a, int g0_b,
                                int k_b, int64_t lanes_b, int64_t slabs_b, int64_t part0_b,
                                void* stream) {
  const void* planes[kPlanes] = {d_ore, d_oim, ore, oim};
  Launch L;
  memset(&L, 0, sizeof(L));
  CUtensorMap maps[2][kPlanes];
  memset(maps, 0, sizeof(maps));
  if (npass < 1 || npass > 2 ||
      !make_pass(&L.p0, maps[0], planes, batch, n, g0_a, k_a, lanes_a, slabs_a, part0_a))
    return static_cast<int>(cudaErrorInvalidValue);
  L.npass = npass;
  L.row_parts = row_parts;
  L.jobs = L.p0.tiles;
  int64_t parts_end = part0_a + L.p0.x_tiles * L.p0.y_tiles;
  if (npass == 2) {
    if (!make_pass(&L.p1, maps[1], planes, batch, n, g0_b, k_b, lanes_b, slabs_b, part0_b) ||
        g0_b != g0_a + k_a || lanes_b != lanes_a || slabs_a != 1 || slabs_b != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    L.per0 = 1u << k_b;
    L.per1 = 1u << k_a;
    L.log2_y_tiles0 = L.p0.log2_y_tiles;
    L.jobs = L.p0.tiles + L.p1.tiles;
    if (L.jobs > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t end_b = part0_b + L.p1.x_tiles * L.p1.y_tiles;
    parts_end = parts_end > end_b ? parts_end : end_b;
  }
  if (parts_end > row_parts) return static_cast<int>(cudaErrorInvalidValue);

  // the instance: groups that fill their tiles at the same element bits
  // [lo, 12) have one of their own (every read of a layer's backward at n
  // >= 12), else the generic one (tiles of slabs, or under 4096 amplitudes)
  const int lo = L.p0.log2_lanes, hi = L.p0.log2_lanes + L.p0.k;
  const bool same = npass == 1 || (L.p1.log2_lanes == lo && L.p1.k == L.p0.k);
  const int which = same && hi == kLogTile ? lo : kGeneric;
  return launch_kernel(which, L, maps, d_ore, d_oim, ore, oim, partial,
                       static_cast<cudaStream_t>(stream));
}

// partial (B, parts) f64 -> out (B,) f32, each row summed in a fixed order.
PQ_EXPORT int pq_beta_grad_final(const void* partial, void* out, int64_t batch,
                                 int64_t parts, void* stream) {
  beta_grad_final_kernel<<<static_cast<unsigned>(batch), pq::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), static_cast<float*>(out), parts);
  return static_cast<int>(cudaGetLastError());
}
