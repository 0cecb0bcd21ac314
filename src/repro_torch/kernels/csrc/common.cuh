// Shared definitions for the ParaQAOA CUDA kernels (sm_90a).
//
// Every entry point has a plain C interface: device pointers and the
// stream arrive as void*, sizes as int64/int. An entry point launches on
// the stream it is given, never synchronises, allocates nothing (the
// Python wrapper allocates outputs and temporary buffers), and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define PQ_EXPORT extern "C" __attribute__((visibility("default")))

namespace pq {

constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kTile = 4096;    // amplitudes a mixer block holds in shared memory

// Insert a zero bit at position q of v: maps a pair index onto the index
// of the pair's bit-q-clear element.
__device__ __forceinline__ int insert_zero_bit(int v, int q) {
  const int low = v & ((1 << q) - 1);
  return ((v >> q) << (q + 1)) | low;
}

// One RX(2 beta) = [[c, -i s], [-i s, c]] butterfly on the amplitude pair
// (i0, i1) of a shared-memory tile, where i1 is i0 with the target qubit
// set; c = cos(beta), s = sin(beta). k such butterflies, one per qubit,
// apply RX(2 beta)^{⊗k}: 6 flops per amplitude per qubit, where the dense
// 2^k x 2^k product would take 8 * 2^k.
__device__ __forceinline__ void rx_pair(float* s_re, float* s_im, int i0,
                                        int i1, float c, float s) {
  const float r0 = s_re[i0], m0 = s_im[i0];
  const float r1 = s_re[i1], m1 = s_im[i1];
  s_re[i0] = c * r0 + s * m1;
  s_im[i0] = c * m0 - s * r1;
  s_re[i1] = c * r1 + s * m0;
  s_im[i1] = c * m1 - s * r0;
}

}  // namespace pq
