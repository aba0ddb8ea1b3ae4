// The per-point math of the unary VGICP linearize and its block-ordered
// reduction, shared by K1 and K2 (csrc/vgicp_unary.cu) and K5
// (csrc/vgicp_unary_dense.cu).
//
// It is the port of _unary_quantities in
// gtsam_points_tpu/ops/pallas_linearize.py:656-735, which serves the three TPU
// kernels alike. Keeping one copy keeps the FMA-free raw-moment differences
// (sub_prod) and every other rounding the same in all three, so K1, K2 and K5
// differ only in the order in which they sum the points. The reduction is
// shared too: each block writes one row of partial sums (block_sum) and a
// second kernel sums the rows in block order (unary_final), so every result
// is deterministic without atomics.
//
// A library is keyed on its .cu file and every csrc/*.cuh (see _build.py), so
// an edit here rebuilds each source that includes it.

#pragma once

#include <cuda_runtime.h>

namespace {

// the sums per point: h11 (6), sA (9), A (6), p x u (3), u (3), error, count
constexpr int kOut = 29;
constexpr int kFinalThreads = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// s - a * b, each step rounded on its own.
__device__ __forceinline__ float sub_prod(float s, float a, float b) {
  return __fsub_rn(s, __fmul_rn(a, b));
}

// Adds point i's 29 terms into acc. m is the point's found flag times its
// weight; the point is skipped unless its voxel holds min_points and m > 0.
// mom and sc are planar with row stride n.
template <bool kSrcCovs>
__device__ __forceinline__ void add_point(float (&acc)[kOut], const float (&R)[3][3], const float (&t)[3],
                                          const float* __restrict__ p, const float* __restrict__ mom,
                                          const float* __restrict__ sc, float m, float min_points,
                                          float eps, int i, int n) {
  const float cnt = mom[i];
  if (!(cnt >= min_points)) m = 0.0f;
  if (!(m > 0.0f)) return;

  const float safe = fmaxf(cnt, 1.0f);
  const float mu0 = mom[n + i] / safe, mu1 = mom[2 * n + i] / safe, mu2 = mom[3 * n + i] / safe;
  const float cxx = sub_prod(mom[4 * n + i] / safe, mu0, mu0);
  const float cxy = sub_prod(mom[5 * n + i] / safe, mu0, mu1);
  const float cxz = sub_prod(mom[6 * n + i] / safe, mu0, mu2);
  const float cyy = sub_prod(mom[7 * n + i] / safe, mu1, mu1);
  const float cyz = sub_prod(mom[8 * n + i] / safe, mu1, mu2);
  const float czz = sub_prod(mom[9 * n + i] / safe, mu2, mu2);
  const float Ct[3][3] = {{cxx, cxy, cxz}, {cxy, cyy, cyz}, {cxz, cyz, czz}};

  // F = Rᵀ C_t R (+ C_s or eps I), the fused covariance in the source frame
  float CtR[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) CtR[a][b] = Ct[a][0] * R[0][b] + Ct[a][1] * R[1][b] + Ct[a][2] * R[2][b];
  }
#define ROT_ENTRY(a, b) (R[0][a] * CtR[0][b] + R[1][a] * CtR[1][b] + R[2][a] * CtR[2][b])
  float fxx = ROT_ENTRY(0, 0), fxy = ROT_ENTRY(0, 1), fxz = ROT_ENTRY(0, 2);
  float fyy = ROT_ENTRY(1, 1), fyz = ROT_ENTRY(1, 2), fzz = ROT_ENTRY(2, 2);
#undef ROT_ENTRY
  if (kSrcCovs) {
    fxx += sc[i];
    fxy += sc[n + i];
    fxz += sc[2 * n + i];
    fyy += sc[3 * n + i];
    fyz += sc[4 * n + i];
    fzz += sc[5 * n + i];
  } else {
    fxx += eps;
    fyy += eps;
    fzz += eps;
  }

  // A = m F⁻¹ by cofactors; degenerate F (|det| <= 1e-9 scale³ + 1e-30) -> 0
  const float co_xx = fyy * fzz - fyz * fyz;
  const float co_xy = -(fxy * fzz - fyz * fxz);
  const float co_xz = fxy * fyz - fyy * fxz;
  const float det = fxx * co_xx + fxy * co_xy + fxz * co_xz;
  const float scale = (fabsf(fxx) + fabsf(fyy) + fabsf(fzz)) / 3.0f;
  const bool bad = fabsf(det) <= 1e-9f * scale * scale * scale + 1e-30f;
  const float inv_det = bad ? 0.0f : 1.0f / det;
  const float co_yy = fxx * fzz - fxz * fxz;
  const float co_yz = -(fxx * fyz - fxy * fxz);
  const float co_zz = fxx * fyy - fxy * fxy;
  const float axx = co_xx * inv_det * m, axy = co_xy * inv_det * m, axz = co_xz * inv_det * m;
  const float ayy = co_yy * inv_det * m, ayz = co_yz * inv_det * m, azz = co_zz * inv_det * m;

  // r' = p + Rᵀ (t - mu), u = A r', error u·r'
  const float p0 = p[i], p1 = p[n + i], p2 = p[2 * n + i];
  const float d0 = t[0] - mu0, d1 = t[1] - mu1, d2 = t[2] - mu2;
  const float r0 = p0 + R[0][0] * d0 + R[1][0] * d1 + R[2][0] * d2;
  const float r1 = p1 + R[0][1] * d0 + R[1][1] * d1 + R[2][1] * d2;
  const float r2 = p2 + R[0][2] * d0 + R[1][2] * d1 + R[2][2] * d2;
  const float u0 = axx * r0 + axy * r1 + axz * r2;
  const float u1 = axy * r0 + ayy * r1 + ayz * r2;
  const float u2 = axz * r0 + ayz * r1 + azz * r2;

  // sA = skew(p) A, skew rows (0, -p2, p1), (p2, 0, -p0), (-p1, p0, 0)
  const float s00 = -p2 * axy + p1 * axz, s01 = -p2 * ayy + p1 * ayz, s02 = -p2 * ayz + p1 * azz;
  const float s10 = p2 * axx - p0 * axz, s11 = p2 * axy - p0 * ayz, s12 = p2 * axz - p0 * azz;
  const float s20 = -p1 * axx + p0 * axy, s21 = -p1 * axy + p0 * ayy, s22 = -p1 * axz + p0 * ayz;

  // h11 = sA skew(p)ᵀ, upper triangle
  acc[0] += -p2 * s01 + p1 * s02;
  acc[1] += p2 * s00 - p0 * s02;
  acc[2] += -p1 * s00 + p0 * s01;
  acc[3] += p2 * s10 - p0 * s12;
  acc[4] += -p1 * s10 + p0 * s11;
  acc[5] += -p1 * s20 + p0 * s21;
  acc[6] += s00;
  acc[7] += s01;
  acc[8] += s02;
  acc[9] += s10;
  acc[10] += s11;
  acc[11] += s12;
  acc[12] += s20;
  acc[13] += s21;
  acc[14] += s22;
  acc[15] += axx;
  acc[16] += axy;
  acc[17] += axz;
  acc[18] += ayy;
  acc[19] += ayz;
  acc[20] += azz;
  acc[21] += p1 * u2 - p2 * u1;
  acc[22] += p2 * u0 - p0 * u2;
  acc[23] += p0 * u1 - p1 * u0;
  acc[24] += u0;
  acc[25] += u1;
  acc[26] += u2;
  acc[27] += u0 * r0 + u1 * r1 + u2 * r2;
  acc[28] += m;
}

// The pose [4,4], row-major, at delta.
__device__ __forceinline__ void load_pose(const float* __restrict__ delta, float (&R)[3][3], float (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = __ldg(delta + 4 * i + j);
    t[i] = __ldg(delta + 4 * i + 3);
  }
}

// The block's sum of acc into row[0..28]: each warp by shuffles, then the
// warps in order.
template <int kWarps>
__device__ __forceinline__ void block_sum(const float (&acc)[kOut], float (&s_warp)[kWarps][kOut],
                                          float* __restrict__ row) {
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
    row[threadIdx.x] = s;
  }
}

// Lane blockIdx.x's rows [num_blocks, 29] summed in block order: a fixed
// order, so deterministic.
__global__ void __launch_bounds__(kFinalThreads)
unary_final(const float* __restrict__ partial, int num_blocks, float* __restrict__ out) {
  const size_t b = blockIdx.x;
  const int k = threadIdx.x;
  if (k < kOut) {
    const float* __restrict__ rows = partial + b * num_blocks * kOut;
    float s = 0.0f;
    for (int r = 0; r < num_blocks; ++r) s += rows[r * kOut + k];
    out[b * kOut + k] = s;
  }
}

}  // namespace
