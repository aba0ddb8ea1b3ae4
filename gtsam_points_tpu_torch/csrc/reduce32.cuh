// Block-wide sums of up to 32 values a thread, in a fixed order and without
// atomics, for K3 (csrc/linearize_fused.cu) and K2
// (csrc/vgicp_unary_batch.cu).
//
// A shuffle tree per value costs 5 shuffles a value, 145 a warp for 29
// values. Recursive halving costs 31: at each of five steps a lane keeps half
// of its values, sends the other half to its partner lane and adds what it
// receives, so lane l ends with the warp's sum of value l. Each sum is formed
// once, in one lane, by the same tree on every call, so results are the same
// bit for bit from run to run.
//
// A library is keyed on its .cu file and every csrc/*.cuh (see _build.py), so
// an edit here rebuilds each source.

#pragma once

#include <cuda_runtime.h>

namespace {

// One step of warp_sum_32: lanes whose bit kHalf is set keep values
// kHalf..2 kHalf-1 of the current 2 kHalf and send the rest; the others keep
// 0..kHalf-1. Every index is a compile-time constant, so v stays in
// registers.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float send = upper ? v[k] : v[k + kHalf];
    const float keep = upper ? v[k + kHalf] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// v[0..31] summed over the warp's lanes; lane l returns the sum of value l.
__device__ __forceinline__ float warp_sum_32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// The block's sum of vals[0..kN) into row[0..kN) (global or shared memory):
// each warp by warp_sum_32, then the warps in order. Every thread of the
// block must call it; row is written by threads 0..kN-1 after a barrier.
template <int kWarps, int kN>
__device__ __forceinline__ void block_sum_32(const float (&vals)[kN], float (&s_warp)[kWarps][32],
                                             float* __restrict__ row) {
  static_assert(kN <= 32, "at most 32 values a thread");
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < kN ? vals[k] : 0.0f;
  s_warp[threadIdx.x >> 5][threadIdx.x & 31] = warp_sum_32(v);
  __syncthreads();
  if (threadIdx.x < kN) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_warp[w][threadIdx.x];
    row[threadIdx.x] = s;
  }
}

}  // namespace
