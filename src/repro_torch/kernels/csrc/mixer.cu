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
// Design. A tile is all 2^k combinations of the group's qubits times L
// lanes of Y: 2^k rows of L contiguous amplitudes (times S consecutive x
// where L = Y), and RX^{⊗k} is k butterflies on it (6k flops per
// amplitude, not 8 * 2^k), qubit 0 first, each with `pq::rx`: so a row's
// bits depend neither on the tiling nor on its batch.
//  - The staged path: a tile of kStageAmps = 8192 amplitudes, L =
//    8192 >> k lanes clamped to Y (256-byte runs at k = 7; above qubit 11
//    such runs were the H100's best for ∂β too, betagrad.cu), the wrapper's
//    `tile_y`. Persistent CTAs, one an SM, walk the tiles in strides of the
//    grid, lane tile fastest, so the CTAs in flight take neighbouring runs
//    of the same rows. Three stages of shared memory (3 x 64 KB), one
//    mbarrier each: thread 0 loads a tile's planes by a 3-D TMA tensor map
//    over runs of L lanes two tiles ahead of the math, and after the math
//    stores them from the same stage by TMA (a fence.proxy.async orders the
//    threads' writes before it; wait_group.read lets the stage be refilled
//    once the store has read it), so tile i's store overlaps tile i+1's
//    butterflies and tile i+2's load. The butterflies run in registers: a
//    thread holds 32 amplitudes of each plane along five consecutive bits
//    of the tile index, the next five of the group's qubits, and applies
//    them in place; ⌈k / 5⌉ such round trips through shared memory (two at
//    k = 7, where the block body made seven). Neighbouring threads take
//    neighbouring lanes, so a warp reads 32 banks where L >= 32.
//  - The block body, for the shapes whose tile cannot fill a stage or has
//    runs under 16 bytes (L < 4: Y < 4, or k = 12): a block owns one
//    tile of at most 4096 amplitudes (32 KB of shared memory), loads it by
//    scalar loads, runs k butterfly passes in shared memory behind a
//    __syncthreads each, and stores it. Its grid is one dimension, (B, X,
//    Y-tiles) folded into blockIdx.x, because Y reaches 2^21 and X falls
//    to 1 while gridDim.y and gridDim.z stop at 65,535.
// The wrapper picks the path and the lanes from (X, Y, k) alone
// (mixer.strided_geometry); both launch a kernel named mixer_strided_kernel.
#include "common.cuh"

namespace {

// ---- the block body -----------------------------------------------------

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

// ---- the staged path ----------------------------------------------------

constexpr int kLogStage = 13;
constexpr int kStageAmps = 1 << kLogStage;  // amplitudes of a plane a stage holds
constexpr int kLogRegs = 5;
constexpr int kRegs = 1 << kLogRegs;  // amplitudes of a plane a thread holds
constexpr int kRegQubits = kLogRegs;  // qubits a round trip applies
constexpr int kThreadBits = kLogStage - kLogRegs;
constexpr int kStagedThreads = 1 << kThreadBits;  // 256
constexpr int kStages = 3;
constexpr uint32_t kPlaneBytes = kStageAmps * sizeof(float);
constexpr int kSmem = kStages * 2 * kPlaneBytes;  // 192 KB
constexpr int kMaxPasses = 3;  // round trips at k = 11, the most a 4-lane tile takes

// One launch's tiles: tile ct is lane tile yt = ct % (Y / L) of rows
// [r * 2^log2_rows, (r + 1) * 2^log2_rows) of the (B * X * 2^k, Y) view,
// r = ct / (Y / L), in row b = r / x_tiles.
struct Staged {
  int64_t tiles;    // B * x_tiles * (Y / L)
  int64_t x_tiles;  // X / S
  int log2_y_tiles, log2_rows, log2_lanes, k;
  int box_inner, lane_boxes, box_rows, row_boxes;  // a box: (box_inner, lane_boxes, box_rows)
};

// RX(2 beta) on the qubit register bit J carries: 16 butterflies over
// the thread's 32 amplitudes
template <int J>
__device__ __forceinline__ void rx_regs(float (&x)[kRegs], float (&y)[kRegs], float c,
                                        float s) {
#pragma unroll
  for (int r = 0; r < kRegs; ++r)
    if (!(r & (1 << J))) pq::rx(x[r], y[r], x[r | (1 << J)], y[r | (1 << J)], c, s);
}

// Thread 0: the TMA loads of tile ct into a stage, completing on its barrier.
__device__ __forceinline__ void load_tile(const Staged& S, int64_t ct, float* stage,
                                          uint64_t* bar, const CUtensorMap* m_re,
                                          const CUtensorMap* m_im) {
  const int c1 = static_cast<int>((ct & ((int64_t(1) << S.log2_y_tiles) - 1)) * S.lane_boxes);
  const int64_t row0 = (ct >> S.log2_y_tiles) << S.log2_rows;
  pq::mbar_expect(bar, 2 * kPlaneBytes);
  for (int rb = 0; rb < S.row_boxes; ++rb) {
    const int off = (rb * S.box_rows) << S.log2_lanes;
    const int c2 = static_cast<int>(row0 + rb * S.box_rows);
    pq::tma_3d(stage + off, m_re, 0, c1, c2, bar);
    pq::tma_3d(stage + kStageAmps + off, m_im, 0, c1, c2, bar);
  }
}

// Thread 0: the TMA stores of tile ct from its stage, as one bulk group.
__device__ __forceinline__ void store_tile(const Staged& S, int64_t ct, const float* stage,
                                           const CUtensorMap* m_ore, const CUtensorMap* m_oim) {
  const int c1 = static_cast<int>((ct & ((int64_t(1) << S.log2_y_tiles) - 1)) * S.lane_boxes);
  const int64_t row0 = (ct >> S.log2_y_tiles) << S.log2_rows;
  for (int rb = 0; rb < S.row_boxes; ++rb) {
    const int off = (rb * S.box_rows) << S.log2_lanes;
    const int c2 = static_cast<int>(row0 + rb * S.box_rows);
    pq::tma_3d_store(m_ore, stage + off, 0, c1, c2);
    pq::tma_3d_store(m_oim, stage + kStageAmps + off, 0, c1, c2);
  }
  pq::bulk_commit();
}

// kPasses = ⌈k / 5⌉ round trips of the tile through registers.
template <int kPasses>
__global__ void __launch_bounds__(kStagedThreads, 1)
mixer_strided_kernel(const float* __restrict__ beta, const __grid_constant__ Staged S,
                     const __grid_constant__ CUtensorMap m_re,
                     const __grid_constant__ CUtensorMap m_im,
                     const __grid_constant__ CUtensorMap m_ore,
                     const __grid_constant__ CUtensorMap m_oim) {
  extern __shared__ __align__(128) float smem[];  // [stage][plane][kStageAmps]
  __shared__ __align__(8) uint64_t bar[kStages];
  const int tid = threadIdx.x;
  const int l = S.log2_lanes, k = S.k;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) pq::mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)  // the first kStages - 1 tiles' loads
    for (int i = 0; i < kStages - 1; ++i) {
      const int64_t ct = blockIdx.x + static_cast<int64_t>(i) * gridDim.x;
      if (ct >= S.tiles) break;
      load_tile(S, ct, smem + i * 2 * kStageAmps, &bar[i], &m_re, &m_im);
    }

  int it = 0;
  for (int64_t ct = blockIdx.x; ct < S.tiles; ct += gridDim.x, ++it) {
    const int s = it % kStages;
    float* s_re = smem + s * 2 * kStageAmps;
    float* s_im = s_re + kStageAmps;
    float sb, cb;
    sincosf(beta[(ct >> S.log2_y_tiles) / S.x_tiles], &sb, &cb);
    pq::mbar_wait(&bar[s], (it / kStages) & 1);
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      // registers r hold tile elements e0 + r * 2^w: index bits [w, w + 5),
      // the lowest window that holds qubits 5j .. min(5j + 5, k) - 1 (tile
      // index bit l + q); the thread index gives the other eight bits
      const int w = min(l + kRegQubits * j, kThreadBits);
      const int e0 = (tid & ((1 << w) - 1)) | ((tid >> w) << (w + kLogRegs));
      float x[kRegs], y[kRegs];
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        x[r] = s_re[e0 + (r << w)];
        y[r] = s_im[e0 + (r << w)];
      }
      // register bit i is qubit w + i - l: apply i in [lo, hi), in order
      const int lo = l + kRegQubits * j - w;
      const int hi = min(l + k - w, kLogRegs);
      if (lo <= 0 && 0 < hi) rx_regs<0>(x, y, cb, sb);
      if (lo <= 1 && 1 < hi) rx_regs<1>(x, y, cb, sb);
      if (lo <= 2 && 2 < hi) rx_regs<2>(x, y, cb, sb);
      if (lo <= 3 && 3 < hi) rx_regs<3>(x, y, cb, sb);
      if (lo <= 4 && 4 < hi) rx_regs<4>(x, y, cb, sb);
      // back to the words this thread read: no other thread reads them
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        s_re[e0 + (r << w)] = x[r];
        s_im[e0 + (r << w)] = y[r];
      }
      if (j + 1 < kPasses) __syncthreads();
    }
    // every thread's writes, then the stores that read them
    pq::fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      store_tile(S, ct, s_re, &m_ore, &m_oim);
      const int64_t ahead = ct + static_cast<int64_t>(kStages - 1) * gridDim.x;
      if (ahead < S.tiles) {
        // the stage of the tile before this one takes the tile two ahead,
        // once that tile's stores have read it
        pq::bulk_wait_read<1>();
        const int sa = (it + kStages - 1) % kStages;
        load_tile(S, ahead, smem + sa * 2 * kStageAmps, &bar[sa], &m_re, &m_im);
      }
    }
  }
  if (tid == 0) pq::bulk_wait_all();  // no store may outlive the CTA's shared memory
}

using StagedFn = void (*)(const float*, const Staged, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap, const CUtensorMap);
const StagedFn kStagedKernels[kMaxPasses] = {
    mixer_strided_kernel<1>, mixer_strided_kernel<2>, mixer_strided_kernel<3>};

int log2_of(int64_t v) {
  int l = 0;
  while ((int64_t(1) << l) < v) ++l;
  return l;
}

// Set once an instance, before any capture into a CUDA graph (the warm-up
// does it): its shared memory, and the CTAs the card holds at once.
int launch_staged(const void* re, const void* im, const void* beta, void* ore, void* oim,
                  int64_t batch, int64_t x_dim, int k, int64_t y_dim, int64_t lanes,
                  cudaStream_t stream) {
  static int max_ctas[kMaxPasses] = {};
  const int log2_lanes = log2_of(lanes);
  if (lanes < 4 || log2_lanes + k > kLogStage)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows_tile = int64_t(1) << (kLogStage - log2_lanes);
  const int64_t slabs = rows_tile >> k;
  if (slabs > 1 && (lanes != y_dim || x_dim % slabs))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* planes[4] = {re, im, ore, oim};
  for (const void* p : planes)
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = (batch * x_dim) << k;  // of Y amplitudes
  if (rows > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);

  Staged S;
  S.x_tiles = x_dim / slabs;
  S.log2_y_tiles = log2_of(y_dim / lanes);
  S.tiles = batch * S.x_tiles * (y_dim / lanes);
  S.log2_rows = kLogStage - log2_lanes;
  S.log2_lanes = log2_lanes;
  S.k = k;
  S.box_inner = static_cast<int>(lanes < pq::kMaxBox ? lanes : pq::kMaxBox);
  S.lane_boxes = static_cast<int>(lanes / S.box_inner);
  S.box_rows = static_cast<int>(rows_tile < pq::kMaxBox ? rows_tile : pq::kMaxBox);
  S.row_boxes = static_cast<int>(rows_tile / S.box_rows);
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (!pq::encode_runs(&maps[i], planes[i], y_dim, rows, lanes, S.box_inner, S.box_rows))
      return static_cast<int>(cudaErrorInvalidValue);

  const int which = (k + kRegQubits - 1) / kRegQubits - 1;
  const StagedFn fn = kStagedKernels[which];
  cudaError_t err;
  if (max_ctas[which] == 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kStagedThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm * sms < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    max_ctas[which] = per_sm * sms;
  }
  const int64_t ctas = S.tiles < max_ctas[which] ? S.tiles : max_ctas[which];
  fn<<<static_cast<unsigned>(ctas), kStagedThreads, kSmem, stream>>>(
      static_cast<const float*>(beta), S, maps[0], maps[1], maps[2], maps[3]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// re, im, ore, oim (B, X, 2^k, Y) f32 contiguous; beta (B,) f32; Y a power
// of two, k in [1, 12]; y_tile (lanes) a power of two dividing Y.
// staged != 0: the staged path, whose tile fills a stage: y_tile >= 4,
// 2^k * y_tile <= 8192, and S = 8192 / (2^k * y_tile) consecutive x a tile
// (S > 1 only where y_tile == Y, and S divides X); the planes 16-byte
// aligned. staged == 0: the block body, 2^k * y_tile <= kTile.
PQ_EXPORT int pq_mixer_strided(const void* re, const void* im,
                               const void* beta, void* ore, void* oim,
                               int64_t batch, int64_t x_dim, int k,
                               int64_t y_dim, int64_t y_tile, int staged,
                               void* stream) {
  if (y_tile < 1 || (y_tile & (y_tile - 1)) || y_dim % y_tile || k < 1 || k > 12)
    return static_cast<int>(cudaErrorInvalidValue);
  if (staged)
    return launch_staged(re, im, beta, ore, oim, batch, x_dim, k, y_dim, y_tile,
                         static_cast<cudaStream_t>(stream));
  if ((y_tile << k) > pq::kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int log2_y_tile = log2_of(y_tile);
  const int64_t y_tiles = y_dim >> log2_y_tile;
  mixer_strided_kernel<<<static_cast<unsigned>(batch * x_dim * y_tiles),
                         pq::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(beta), static_cast<float*>(ore),
      static_cast<float*>(oim), x_dim, k, y_dim, log2_y_tile, y_tiles);
  return static_cast<int>(cudaGetLastError());
}
