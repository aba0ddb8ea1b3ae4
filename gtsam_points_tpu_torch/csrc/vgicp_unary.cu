// Unary VGICP linearize from raw voxel moments (K1) for NVIDIA Hopper, sm_90a.
//
// Replaces: _vgicp_unary_kernel in gtsam_points_tpu/ops/pallas_linearize.py:500
// (reached through _vgicp_unary_call and linearize_vgicp_unary, pallas_call at
// :555). The per-point math is _unary_quantities (:656-735).
//
// Where the code lives: this file holds K1's C entry. Its two kernels are in
// csrc/unary_point.cuh: the partial kernel unary_partial<kSrcCovs, kWeights>,
// which K5 (csrc/vgicp_unary_dense.cu) launches too, with weights off, and
// the final pass unary_final, which K5 and K2 (csrc/vgicp_unary_batch.cu)
// run too. The grid, unary_blocks(n), is there as well; this library exports
// it as gpt_vgicp_unary_num_blocks.
//
// What it computes. For N source points p [3,N] with the raw moment row of
// the voxel each one probed (momT [10,N]: count, sum p (3), sum ppᵀ upper
// (6)), a found flag, optional per-point weights w and optional source
// covariances C_s [6,N], at the relative pose delta = [R t; 0 1]:
//   m    = found * w, zeroed unless count >= min_voxel_points,
//   mu   = sum p / count,  C_t = sum ppᵀ / count - mu muᵀ,
//   F    = Rᵀ C_t R + C_s   (or + eps I without source covariances),
//   A    = m * F⁻¹          (0 when F is degenerate, the rule of _sym_inv_rows),
//   r'   = p + Rᵀ (t - mu),  u = A r',
// and the 29 sums over the points of
//   h11 = skew(p) A skew(p)ᵀ (6, upper), sA = skew(p) A (9), A (6),
//   p × u (3), u (3), u·r' (error), m (weighted inlier count),
// in the order of the TPU kernel's accumulator column. The wrapper unpacks
// them into the 6x6 source block H_ss = [h11 sA; sAᵀ A] and b_s = -[p×u; u].
//
// What bounds it on an H100: each point reads p (12 B), momT (40 B), the found
// byte, and C_s (24 B) and w (4 B) when given: at most 81 B a point, 2.0 MB at
// the full 25088-slot scan, 0.58 us at 3.35 TB/s, and 0.07 us at the
// pyramid's stride-8 stage (N = 3136). The arithmetic is about 270 fp32
// operations a point that passes the gate, 0.1 us at 67 TFLOP/s. Both lie
// far below the latency of one launch (two launches take about 4 us at
// N = 1), so the design spends nothing on wgmma, TMA or cp.async: there is
// no matrix product to feed, and each thread issues its one point's loads at
// once, so there is no stream of tiles for a copy engine to keep ahead of
// the arithmetic. What is left to cut is the latency of one pass: the chain
// of a thread's loads, its arithmetic, the block reduction and the final
// pass. The TPU kernel's [32,128] VMEM accumulator and its [1,T] lane
// layout are not carried over.
//
// Design:
// - One point a thread, blocks of 128 threads, unary_blocks(n) = ceil(n /
//   128) blocks, at most 256 (a grid-stride loop beyond): 25, 49, 98 and 196
//   blocks at the pyramid's four stages (N = 3136, 6272, 12544, 25088), so
//   even the stride-8 stage spreads over a fifth of the 132 SMs. The grid
//   depends on n alone, so a shape always sums in the same order.
// - Every load of a point (the found byte, the weight, the ten moment rows,
//   p and C_s) is issued before the gate is tested, so a thread waits on one
//   trip to memory, not two. The raw-moment differences stay FMA-free
//   (sub_prod) and points with m <= 0 are skipped (a branch: every sum is
//   scaled by m, so they add nothing; weights must be non-negative).
// - A block sums its threads' 29 values with block_sum_32 (csrc/reduce32.cuh:
//   recursive halving, 31 shuffles a warp where a shuffle tree a column
//   takes 145), then the warps in order, into one row.
// - The final pass stages the rows in shared memory, one row a thread, and
//   sums them with block_sum_32 again: a fixed tree. No atomics and no state
//   between calls, so two calls on the same input agree bit for bit and the
//   pair can be replayed in a CUDA graph. The pose is read from a device
//   pointer, so a Gauss-Newton loop never reads it to the host.
// - Two launches, not one. A one-launch variant, in which the block that drew
//   the last ticket of an atomic counter summed the rows, took 4.40-4.47 us
//   at N = 1 on an H100 against 3.95-4.03 us for the pair (PERF.md), and its
//   counter breaks a replayed CUDA graph. A one-launch variant on a cluster
//   of blocks summing through distributed shared memory read slower for K3
//   (csrc/linearize_fused.cu); for K1 it is unmeasured.
//
// The first design (one point a thread on 256-thread blocks, 13 blocks at
// stride 8 and 98 at N = 25088; the nine moment loads issued after the count
// came back; a shuffle tree per column; one warp summing the rows in series)
// took 10.3-11.8 us per launch pair at N = 25088 and 5.9-6.1 us at stride 8
// on an H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "unary_point.cuh"

extern "C" {

int gpt_vgicp_unary_threads() { return kUnaryThreads; }
int gpt_vgicp_unary_out_len() { return kOut; }
int gpt_vgicp_unary_num_blocks(int n) { return unary_blocks(n); }

// p [3,n], mom [10,n], found [n] bytes, weights [n] or null (null: unit
// weights), sc [6,n] or null (null: eps mode), delta [4,4]; partial:
// [num_blocks, 29] scratch with num_blocks = gpt_vgicp_unary_num_blocks(n);
// out: [29]. Returns cudaGetLastError() after the launches (0 on success),
// or cudaErrorInvalidValue for n < 0 or another num_blocks. Does not
// synchronize.
int gpt_vgicp_unary(const void* p, const void* mom, const void* found, const void* weights,
                    const void* sc, const void* delta, float min_points, float eps, void* partial,
                    void* out, int n, int num_blocks, void* stream) {
  return weights != nullptr
             ? launch_unary<true>(p, mom, found, weights, sc, delta, min_points, eps, partial, out, n, num_blocks,
                                  stream)
             : launch_unary<false>(p, mom, found, weights, sc, delta, min_points, eps, partial, out, n, num_blocks,
                                   stream);
}

}  // extern "C"
