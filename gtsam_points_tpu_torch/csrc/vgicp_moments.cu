// Moments-fused VGICP linearize (K4) for NVIDIA Hopper, sm_90a.
//
// Replaces: _vgicp_moments_kernel in gtsam_points_tpu/ops/pallas_linearize.py:275
// (reached through _vgicp_moments_call and linearize_vgicp_moments; pallas_call
// at :406; the single-scan entry is vgicp_scan_linearize, :1111).
//
// What it computes. For N source points p [3,N] with the raw moment row of
// the voxel each one probed (momT [10,N]: count, sum p (3), sum ppᵀ upper
// (6)), a found flag and optional source covariances C_s [6,N], at the
// relative pose delta = [R t; 0 1], over the points with found and
// count >= min_voxel_points:
//   mu  = sum p / count,  C_t = sum ppᵀ / count - mu muᵀ,
//   F   = C_t + R C_s Rᵀ   (or C_t + eps I without source covariances),
//         the fused covariance in the target frame,
//   W   = F⁻¹             (0 when F is degenerate, the rule of _sym_inv_rows;
//                          the point still counts as an inlier),
//   pm  = R p + t,  r = pm - mu,
//   J_t = [skew(pm) | -I],  J_s = [-R skew(p) | R]   (J = [J_t | J_s], 3x12),
//   H = sum Jᵀ W J (12x12),  g = sum Jᵀ W r,  err = sum rᵀ W r,  count.
// The output is 92 floats in K3's layout (csrc/linearize_fused.cu): the upper
// triangle of H in row-major order (78), g (12), err, count. The wrapper
// forms b = -g. The TPU kernel's [16,128] output block held the same numbers.
//
// What bounds it on an H100: each point reads p (12 B), momT (40 B), the
// found byte and C_s (24 B) when given: at most 77 B a point, 1.9 MB at the
// 25088-slot scan, about 0.58 us at 3.35 TB/s. The arithmetic is about 930
// fp32 operations a point that passes the gate, about 0.35 us at 67 TFLOP/s.
// Both lie far below the few microseconds of a launch, so the kernel is bound
// by launch latency, and the design spends nothing on tiling, TMA or tensor
// cores: the TPU kernel's sequential grid over a [16,128] VMEM accumulator and
// its [16,T] Jacobian row planes for the MXU are not carried over.
//
// Design: K3's pattern. One thread per point in a grid-stride loop; the
// finalize, the fused covariance and its inverse run in registers in front of
// the 92 running sums (every index a compile-time constant after unrolling).
// A warp-shuffle reduction and a shared-memory reduction over the block's
// warps write one partial row per block, and a second single-block kernel
// sums the rows in block order. There are no atomics, so the result is the
// same bit for bit from run to run. The pose is read from a device pointer;
// min_voxel_points and eps go by value. A null pointer for C_s selects the
// eps mode.
//
// The voxel covariance comes from raw moments, s6/count - mu muᵀ, which
// cancels in f32 far from the origin. Those six differences are rounded as
// separate products and differences (no fused multiply-add), as the plain
// PyTorch version computes them, so the kernel does not move the result of
// that cancellation (as K1, csrc/vgicp_unary.cu).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDim = 12;
constexpr int kTri = kDim * (kDim + 1) / 2;  // 78
constexpr int kOut = kTri + kDim + 2;        // 92
constexpr int kFinalThreads = 128;

// Position of H[a][b], a <= b, in the row-major upper triangle.
__host__ __device__ constexpr int tri(int a, int b) {
  return a * kDim - a * (a - 1) / 2 + (b - a);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// s - a * b, each step rounded on its own.
__device__ __forceinline__ float sub_prod(float s, float a, float b) {
  return __fsub_rn(s, __fmul_rn(a, b));
}

template <bool kSrcCovs>
__global__ void __launch_bounds__(kThreads)
moments_partial(const float* __restrict__ p, const float* __restrict__ mom,
                const uint8_t* __restrict__ found, const float* __restrict__ sc,
                const float* __restrict__ delta, float min_points, float eps,
                float* __restrict__ partial, int n) {
  __shared__ float s_warp[kWarps][kOut];

  float R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = __ldg(delta + 4 * i + j);
    t[i] = __ldg(delta + 4 * i + 3);
  }

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float cnt = mom[i];
    if (!found[i] || !(cnt >= min_points)) continue;

    // voxel mean and covariance from the raw moments
    const float safe = fmaxf(cnt, 1.0f);
    const float mu[3] = {mom[n + i] / safe, mom[2 * n + i] / safe, mom[3 * n + i] / safe};
    float fxx = sub_prod(mom[4 * n + i] / safe, mu[0], mu[0]);
    float fxy = sub_prod(mom[5 * n + i] / safe, mu[0], mu[1]);
    float fxz = sub_prod(mom[6 * n + i] / safe, mu[0], mu[2]);
    float fyy = sub_prod(mom[7 * n + i] / safe, mu[1], mu[1]);
    float fyz = sub_prod(mom[8 * n + i] / safe, mu[1], mu[2]);
    float fzz = sub_prod(mom[9 * n + i] / safe, mu[2], mu[2]);

    // F = C_t + R C_s Rᵀ (or + eps I), the fused covariance in the target frame
    if (kSrcCovs) {
      const float sxx = sc[i], sxy = sc[n + i], sxz = sc[2 * n + i];
      const float syy = sc[3 * n + i], syz = sc[4 * n + i], szz = sc[5 * n + i];
      const float C[3][3] = {{sxx, sxy, sxz}, {sxy, syy, syz}, {sxz, syz, szz}};
      float M[3][3];  // M = C Rᵀ
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) M[a][b] = C[a][0] * R[b][0] + C[a][1] * R[b][1] + C[a][2] * R[b][2];
      }
#define ROT_ENTRY(a, b) (R[a][0] * M[0][b] + R[a][1] * M[1][b] + R[a][2] * M[2][b])
      fxx += ROT_ENTRY(0, 0);
      fxy += ROT_ENTRY(0, 1);
      fxz += ROT_ENTRY(0, 2);
      fyy += ROT_ENTRY(1, 1);
      fyz += ROT_ENTRY(1, 2);
      fzz += ROT_ENTRY(2, 2);
#undef ROT_ENTRY
    } else {
      fxx += eps;
      fyy += eps;
      fzz += eps;
    }

    // W = F⁻¹ by cofactors; degenerate F (|det| <= 1e-9 scale³ + 1e-30) -> 0
    const float co_xx = fyy * fzz - fyz * fyz;
    const float co_xy = -(fxy * fzz - fyz * fxz);
    const float co_xz = fxy * fyz - fyy * fxz;
    const float det = fxx * co_xx + fxy * co_xy + fxz * co_xz;
    const float scale = (fabsf(fxx) + fabsf(fyy) + fabsf(fzz)) / 3.0f;
    const bool bad = fabsf(det) <= 1e-9f * scale * scale * scale + 1e-30f;
    const float inv_det = bad ? 0.0f : 1.0f / det;
    const float wxx = co_xx * inv_det, wxy = co_xy * inv_det, wxz = co_xz * inv_det;
    const float wyy = (fxx * fzz - fxz * fxz) * inv_det;
    const float wyz = -(fxx * fyz - fxy * fxz) * inv_det;
    const float wzz = (fxx * fyy - fxy * fxy) * inv_det;
    const float W[3][3] = {{wxx, wxy, wxz}, {wxy, wyy, wyz}, {wxz, wyz, wzz}};

    const float p0 = p[i], p1 = p[n + i], p2 = p[2 * n + i];
    float pm[3], r[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      pm[d] = R[d][0] * p0 + R[d][1] * p1 + R[d][2] * p2 + t[d];
      r[d] = pm[d] - mu[d];
    }

    // J[d][k]: row d of the per-point 3x12 Jacobian.
    float J[3][kDim];
    // columns 0..2: skew(pm)
    J[0][0] = 0.0f;   J[1][0] = pm[2];  J[2][0] = -pm[1];
    J[0][1] = -pm[2]; J[1][1] = 0.0f;   J[2][1] = pm[0];
    J[0][2] = pm[1];  J[1][2] = -pm[0]; J[2][2] = 0.0f;
    // columns 6..8: -R skew(p); sk[c] is column c of skew(p)
    const float sk[3][3] = {{0.0f, p2, -p1}, {-p2, 0.0f, p0}, {p1, -p0, 0.0f}};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        J[d][3 + c] = (d == c) ? -1.0f : 0.0f;  // columns 3..5: -I
        J[d][6 + c] = -(R[d][0] * sk[c][0] + R[d][1] * sk[c][1] + R[d][2] * sk[c][2]);
        J[d][9 + c] = R[d][c];  // columns 9..11: R
      }
    }

    float Wr[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) Wr[d] = W[d][0] * r[0] + W[d][1] * r[1] + W[d][2] * r[2];

#pragma unroll
    for (int b = 0; b < kDim; ++b) {
      float WJb[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) WJb[d] = W[d][0] * J[0][b] + W[d][1] * J[1][b] + W[d][2] * J[2][b];
#pragma unroll
      for (int a = 0; a <= b; ++a)
        acc[tri(a, b)] += J[0][a] * WJb[0] + J[1][a] * WJb[1] + J[2][a] * WJb[2];
    }
#pragma unroll
    for (int a = 0; a < kDim; ++a)
      acc[kTri + a] += J[0][a] * Wr[0] + J[1][a] * Wr[1] + J[2][a] * Wr[2];
    acc[kTri + kDim] += r[0] * Wr[0] + r[1] * Wr[1] + r[2] * Wr[2];
    acc[kTri + kDim + 1] += 1.0f;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) s_warp[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_warp[w][threadIdx.x];
    partial[blockIdx.x * kOut + threadIdx.x] = s;
  }
}

// Sums the per-block rows in block order: a fixed order, so deterministic.
__global__ void __launch_bounds__(kFinalThreads)
moments_final(const float* __restrict__ partial, int num_blocks, float* __restrict__ out) {
  const int k = threadIdx.x;
  if (k < kOut) {
    float s = 0.0f;
    for (int b = 0; b < num_blocks; ++b) s += partial[b * kOut + k];
    out[k] = s;
  }
}

}  // namespace

extern "C" {

int gpt_vgicp_moments_threads() { return kThreads; }
int gpt_vgicp_moments_out_len() { return kOut; }

// p [3,n], mom [10,n], found [n] bytes, sc [6,n] or null (null: eps mode),
// delta [4,4]; partial: [num_blocks, 92] scratch; out: [92]. Returns
// cudaGetLastError() after the launches (0 on success). Does not synchronize.
int gpt_vgicp_moments(const void* p, const void* mom, const void* found, const void* sc,
                      const void* delta, float min_points, float eps, void* partial, void* out,
                      int n, int num_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fmom = static_cast<const float*>(mom);
  const uint8_t* ffound = static_cast<const uint8_t*>(found);
  const float* fsc = static_cast<const float*>(sc);
  const float* fdelta = static_cast<const float*>(delta);
  float* fpartial = static_cast<float*>(partial);
  if (fsc != nullptr) {
    moments_partial<true><<<num_blocks, kThreads, 0, s>>>(fp, fmom, ffound, fsc, fdelta, min_points,
                                                          eps, fpartial, n);
  } else {
    moments_partial<false><<<num_blocks, kThreads, 0, s>>>(fp, fmom, ffound, fsc, fdelta, min_points,
                                                           eps, fpartial, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_final<<<1, kFinalThreads, 0, s>>>(fpartial, num_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
