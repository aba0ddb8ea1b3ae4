// Unary VGICP linearize over the dense view (K5) for NVIDIA Hopper, sm_90a.
//
// Replaces: _vgicp_unary_dense_kernel in gtsam_points_tpu/ops/pallas_linearize.py:817
// (reached through _vgicp_unary_dense_call and linearize_vgicp_unary_dense,
// pallas_call at :890). Its callers are bench.py's single-scan race (the
// `unary_dense` route) and the dense gate of scripts/tpu_parity.py.
//
// What it computes: K1's function without weights (csrc/vgicp_unary.cu). For
// N source points p [3,N] with the raw moment row of the voxel each one
// probed (momT [10,N]), a found flag and optional source covariances C_s
// [6,N], at the relative pose delta, the 29 sums of the source block (h11,
// sA, A, p x u, u, error, inlier count), point by point with add_point from
// csrc/unary_point.cuh, the per-point math K1 and K2 run too.
//
// The TPU kernel pads the planes to a multiple of 4096 points, views each as
// [k, 8, N/8] so that every vector operation fills the VPU's 8 sublanes, and
// adds per-row sums to an [8,128] accumulator carried across its sequential
// grid. Neither the sublanes nor the carried accumulator exist here.
//
// What bounds it on an H100: each point reads p (12 B), momT (40 B), the
// found byte and C_s (24 B) when given: 77 B a point, 1.93 MB at the
// 25088-slot scan, 0.58 us at 3.35 TB/s; about 270 fp32 operations a point
// that passes the gate, 0.1 us at 67 TFLOP/s. Both lie below the latency of
// one launch. What the card shows instead is the latency of the eight points
// each thread handles in series (see PERF.md).
//
// Design:
// - The dense view, read by columns. Thread c of the grid takes column c of
//   the [8, N8] view of each plane (N8 = ceil(N/8)): points c + r N8 for
//   r = 0..7, in that order, into 29 sums in registers. Adjacent threads read
//   adjacent points, so every load is coalesced. Where the TPU pads with
//   zeros, the kernel tests i < N.
// - The reduction is K1's (csrc/unary_point.cuh): each block reduces its 29
//   sums (warp shuffles, then the block's warps in order) into its row of
//   partial sums, and unary_final sums the rows in block order. There are no
//   atomics and no state kept between launches, so two calls on the same
//   input agree bit for bit, and the pair can be captured in a CUDA graph.
//   A one-launch variant, in which the block that drew the last ticket of an
//   atomic counter summed the rows, took 4.40-4.47 us at N = 1 on an H100
//   against 3.95-4.03 us for K1's pair (PERF.md), so it was not kept.
// - The pose is read from a device pointer, so a call reads nothing back to
//   the host. Covariances or eps is a template flag, as in K1, where a
//   runtime test per point cost registers. A null pointer for C_s selects
//   the eps mode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unary_point.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows of the dense view: points per thread

template <bool kSrcCovs>
__global__ void __launch_bounds__(kThreads)
unary_dense_partial(const float* __restrict__ p, const float* __restrict__ mom, const uint8_t* __restrict__ found,
                    const float* __restrict__ sc, const float* __restrict__ delta, float min_points, float eps,
                    float* __restrict__ partial, int n) {
  __shared__ float s_warp[kWarps][kOut];
  float R[3][3], t[3];
  load_pose(delta, R, t);

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const int n8 = (n - 1) / kRows + 1;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c < n8) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = c + r * n8;
      if (i < n) add_point<kSrcCovs>(acc, R, t, p, mom, sc, found[i] ? 1.0f : 0.0f, min_points, eps, i, n);
    }
  }
  block_sum(acc, s_warp, partial + blockIdx.x * kOut);
}

}  // namespace

extern "C" {

int gpt_vgicp_unary_dense_threads() { return kThreads; }
int gpt_vgicp_unary_dense_rows() { return kRows; }
int gpt_vgicp_unary_dense_out_len() { return kOut; }

// p [3,n], mom [10,n], found [n] bytes, sc [6,n] or null (null: eps mode),
// delta [4,4]; partial: [num_blocks, 29] scratch; out: [29]. num_blocks must
// be ceil(ceil(n / 8) / 128) for n >= 1. Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for another grid. Does
// not synchronize.
int gpt_vgicp_unary_dense(const void* p, const void* mom, const void* found, const void* sc,
                          const void* delta, float min_points, float eps, void* partial, void* out, int n,
                          int num_blocks, void* stream) {
  if (n < 1 || num_blocks != ((n - 1) / kRows) / kThreads + 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fmom = static_cast<const float*>(mom);
  const uint8_t* ffound = static_cast<const uint8_t*>(found);
  const float* fsc = static_cast<const float*>(sc);
  const float* fdelta = static_cast<const float*>(delta);
  float* fpartial = static_cast<float*>(partial);
  if (fsc != nullptr) {
    unary_dense_partial<true><<<num_blocks, kThreads, 0, s>>>(fp, fmom, ffound, fsc, fdelta, min_points, eps,
                                                              fpartial, n);
  } else {
    unary_dense_partial<false><<<num_blocks, kThreads, 0, s>>>(fp, fmom, ffound, fsc, fdelta, min_points, eps,
                                                               fpartial, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unary_final<<<1, kFinalThreads, 0, s>>>(fpartial, num_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
