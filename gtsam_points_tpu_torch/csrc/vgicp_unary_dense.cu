// Unary VGICP linearize over the dense view (K5) for NVIDIA Hopper, sm_90a.
//
// Replaces: _vgicp_unary_dense_kernel in gtsam_points_tpu/ops/pallas_linearize.py:817
// (reached through _vgicp_unary_dense_call and linearize_vgicp_unary_dense,
// pallas_call at :890). Its callers are bench.py's single-scan race (the
// `unary_dense` route) and the dense gate of scripts/tpu_parity.py.
//
// What it computes: K1's function without weights (csrc/vgicp_unary.cu). For
// N >= 1 source points p [3,N] with the raw moment row of the voxel each one
// probed (momT [10,N]), a found flag and optional source covariances C_s
// [6,N], at the relative pose delta, the 29 sums of the source block (h11,
// sA, A, p x u, u, error, inlier count).
//
// Where the code lives: this file holds K5's C entry only. It launches K1's
// partial kernel, unary_partial<kSrcCovs, false> in csrc/unary_point.cuh, on
// K1's grid (unary_blocks, exported here as gpt_vgicp_unary_num_blocks),
// then the final pass unary_final that K1 and K2 run too. So K5 equals K1
// called without weights bit for bit, at every N.
//
// The dense view is gone. The TPU kernel pads the planes to a multiple of
// 4096 points and views each as [k, 8, N/8] so that every vector operation
// fills the VPU's 8 sublanes (pallas_linearize.py:859-890), adding per-row
// sums to an [8,128] accumulator carried across its sequential grid. The
// first port copied the view: a thread walked the eight points of one
// column in series on 128-thread blocks, 25 blocks at N = 25088, so 107 of
// the 132 SMs sat idle and it took 23.2-23.6 us per launch pair on an H100
// (PERF.md). The sublanes mean nothing on this card, and the function
// is a sum over points, free in its order within the tolerance the JAX repo
// allows between kernel and XLA; one point a thread on K1's grid computes it.
//
// What bounds it on an H100: each point reads p (12 B), momT (40 B), the
// found byte and C_s (24 B) when given: 77 B a point, 1.93 MB at the
// 25088-slot scan, 0.58 us at 3.35 TB/s; about 270 fp32 operations a point
// that passes the gate, 0.1 us at 67 TFLOP/s. Both lie below the latency of
// one launch; csrc/vgicp_unary.cu says what the design does about it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unary_point.cuh"

extern "C" {

int gpt_vgicp_unary_dense_threads() { return kUnaryThreads; }
int gpt_vgicp_unary_dense_out_len() { return kOut; }
int gpt_vgicp_unary_num_blocks(int n) { return unary_blocks(n); }

// p [3,n], mom [10,n], found [n] bytes, sc [6,n] or null (null: eps mode),
// delta [4,4]; partial: [num_blocks, 29] scratch with num_blocks =
// gpt_vgicp_unary_num_blocks(n); out: [29]. Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for n < 1 or
// another num_blocks. Does not synchronize.
int gpt_vgicp_unary_dense(const void* p, const void* mom, const void* found, const void* sc,
                          const void* delta, float min_points, float eps, void* partial, void* out, int n,
                          int num_blocks, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_unary<false>(p, mom, found, nullptr, sc, delta, min_points, eps, partial, out, n, num_blocks,
                             stream);
}

}  // extern "C"
