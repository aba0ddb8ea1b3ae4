// Unary VGICP linearize from raw voxel moments (K1) for NVIDIA Hopper, sm_90a.
//
// Replaces: _vgicp_unary_kernel in gtsam_points_tpu/ops/pallas_linearize.py:500
// (reached through _vgicp_unary_call and linearize_vgicp_unary, pallas_call at
// :555). The per-point math is _unary_quantities (:656-735); here it is
// add_point in csrc/unary_point.cuh, which K2 (csrc/vgicp_unary_batch.cu) and
// K5 (csrc/vgicp_unary_dense.cu) call too, so the three cannot drift;
// block_sum and unary_final, the reduction that ends the launch, live there
// as well.
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
// byte, and C_s (24 B) or w (4 B) when given: at most 81 B a point, 2.0 MB at
// the full 25088-slot scan, 0.6 us at 3.35 TB/s (0.08 us at a stride-8 stage).
// The arithmetic is about 250 fp32 operations a point, 0.1 us at 67 TFLOP/s.
// Both lie far below the few microseconds of a launch, so K1 is bound by
// launch latency and the design spends nothing on tiling, TMA or tensor
// cores: the TPU kernel's [32,128] VMEM accumulator and its [1,T] lane layout
// are not carried over.
//
// Design: one thread per point in a grid-stride loop, the 29 running sums in
// registers (every index is a compile-time constant after unrolling). A
// warp-shuffle reduction and a shared-memory reduction over the block's warps
// write one partial row per block, and a second kernel sums the rows in block
// order. The partial kernel still reads its lane from blockIdx.y, which is
// always 0: it was K2's kernel too until K2 got kernels of its own, and it is
// kept as it was so that K1's results do not move by a bit. There are no
// atomics, so two registrations from the same input give the same pose bit
// for bit. The pose is read from a device pointer, so a Gauss-Newton loop
// never reads it to the host between iterations. A null pointer for C_s
// selects the eps mode; a null pointer for w means unit weights. Points with
// m <= 0 are skipped: every sum is scaled by m, so they contribute nothing
// (weights must be non-negative).
//
// The voxel covariance comes from raw moments, s6/count - mu muᵀ, which
// cancels in f32 far from the origin. Those six differences are rounded as
// separate products and differences (no fused multiply-add), as the plain
// PyTorch version computes them, so the kernel does not move the result of
// that cancellation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "unary_point.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// K1's blocks for lane blockIdx.y (always 0, see the note above), with the
// pose, moment rows, found flags and weights (null: unit weights); one row of
// partial sums per block. Weights are a template flag, not a runtime test: a
// runtime test takes the unweighted eps kernel to 93 registers, 2 blocks an
// SM instead of 3 at 80.
template <bool kSrcCovs, bool kWeights>
__global__ void __launch_bounds__(kThreads)
unary_partial(const float* __restrict__ p, const float* __restrict__ mom_b,
              const uint8_t* __restrict__ found_b, const float* __restrict__ weights_b,
              const float* __restrict__ sc, const float* __restrict__ deltas, float min_points,
              float eps, float* __restrict__ partial, int n) {
  __shared__ float s_warp[kWarps][kOut];
  const size_t b = blockIdx.y;
  const float* __restrict__ mom = mom_b + b * 10 * n;
  const uint8_t* __restrict__ found = found_b + b * n;
  const float* __restrict__ weights = kWeights ? weights_b + b * n : nullptr;
  float R[3][3], t[3];
  load_pose(deltas + 16 * b, R, t);

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float m = found[i] ? (kWeights ? weights[i] : 1.0f) : 0.0f;
    add_point<kSrcCovs>(acc, R, t, p, mom, sc, m, min_points, eps, i, n);
  }
  block_sum(acc, s_warp, partial + (b * gridDim.x + blockIdx.x) * kOut);
}

template <bool kSrcCovs, bool kWeights>
void launch_partial(dim3 grid, cudaStream_t s, const float* p, const float* mom_b, const uint8_t* found_b,
                    const float* weights_b, const float* sc, const float* deltas, float min_points, float eps,
                    float* partial, int n) {
  unary_partial<kSrcCovs, kWeights><<<grid, kThreads, 0, s>>>(p, mom_b, found_b, weights_b, sc, deltas,
                                                              min_points, eps, partial, n);
}

}  // namespace

extern "C" {

int gpt_vgicp_unary_threads() { return kThreads; }
int gpt_vgicp_unary_out_len() { return kOut; }

// p [3,n], mom [10,n], found [n] bytes, weights [n] or null, sc [6,n] or null
// (null: eps mode), delta [4,4]; partial: [num_blocks, 29] scratch; out: [29].
// Returns cudaGetLastError() after the launches (0 on success). Does not
// synchronize.
int gpt_vgicp_unary(const void* p, const void* mom, const void* found, const void* weights,
                    const void* sc, const void* delta, float min_points, float eps, void* partial,
                    void* out, int n, int num_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fmom = static_cast<const float*>(mom);
  const uint8_t* ffound = static_cast<const uint8_t*>(found);
  const float* fw = static_cast<const float*>(weights);
  const float* fsc = static_cast<const float*>(sc);
  const float* fdelta = static_cast<const float*>(delta);
  float* fpartial = static_cast<float*>(partial);
  const dim3 grid(num_blocks, 1);
  auto* partial_kernel = fsc != nullptr ? (fw != nullptr ? launch_partial<true, true> : launch_partial<true, false>)
                                        : (fw != nullptr ? launch_partial<false, true> : launch_partial<false, false>);
  partial_kernel(grid, s, fp, fmom, ffound, fw, fsc, fdelta, min_points, eps, fpartial, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unary_final<<<1, kFinalThreads, 0, s>>>(fpartial, num_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
