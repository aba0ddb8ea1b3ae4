// The unary VGICP linearize's per-point math, its partial kernel and its
// final pass, shared by K1 (csrc/vgicp_unary.cu), K5
// (csrc/vgicp_unary_dense.cu) and K2 (csrc/vgicp_unary_batch.cu).
//
// - add_point_terms is the port of _unary_quantities in
//   gtsam_points_tpu/ops/pallas_linearize.py:656-735, which serves the three
//   TPU kernels alike. One copy keeps the FMA-free raw-moment differences
//   (sub_prod), the determinant rule and every other rounding the same in
//   K1, K2 and K5. It takes values the caller already loaded, through an
//   accessor (HeldPoint here, QuadPoint in K2), so every load of a point is
//   in flight before its gate is tested.
// - unary_partial<kSrcCovs, kWeights> is K1's partial kernel. K5 launches
//   the same template with kWeights false, so K5 equals K1 without weights
//   bit for bit. Its grid, unary_blocks(n), depends on n alone; each
//   library exports it (gpt_vgicp_unary_num_blocks), and the wrapper
//   (ops/fused_linearize.py) checks it against its own when it loads the
//   library. launch_unary launches the pair.
// - unary_final sums the partial rows of each lane: K1 and K5 launch it with
//   one lane, K2 with B. Its rows are staged in shared memory, one row a
//   thread, so a grid has at most kFinalRows blocks a lane.
// Every sum is taken in a fixed order without atomics, so two calls on the
// same input agree bit for bit.
//
// A library is keyed on its .cu file and every csrc/*.cuh (see _build.py), so
// an edit here rebuilds each source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose.cuh"
#include "reduce32.cuh"

namespace {

// the sums per point: h11 (6), sA (9), A (6), p x u (3), u (3), error, count
constexpr int kOut = 29;

// The final pass: one block of kFinalThreads a lane, one partial row a
// thread, so at most kFinalRows rows (blocks) a lane.
constexpr int kFinalThreads = 256;
constexpr int kFinalRows = kFinalThreads;

// K1's and K5's partial kernel: one point a thread on blocks of
// kUnaryThreads, at most kFinalRows blocks, a grid-stride loop beyond.
constexpr int kUnaryThreads = 128;
constexpr int kUnaryWarps = kUnaryThreads / 32;

// s - a * b, each step rounded on its own.
__device__ __forceinline__ float sub_prod(float s, float a, float b) {
  return __fsub_rn(s, __fmul_rn(a, b));
}

// Adds one point's 29 terms into acc. m is the point's found flag times its
// weight; the point is skipped unless its voxel holds min_points and m > 0.
// `pt` gives the point's moment row (mom_at, k = 0..9), its coordinates
// (p_at) and its source covariance (sc_at), all values the caller already
// loaded: HeldPoint for K1 and K5, K2's QuadPoint for one point of a quad.
template <bool kSrcCovs, class Point>
__device__ __forceinline__ void add_point_terms(float (&acc)[kOut], const float (&R)[3][3], const float (&t)[3],
                                                const Point& pt, float m, float min_points, float eps) {
  const float cnt = pt.mom_at(0);
  if (!(cnt >= min_points)) m = 0.0f;
  if (!(m > 0.0f)) return;

  const float safe = fmaxf(cnt, 1.0f);
  const float mu0 = pt.mom_at(1) / safe, mu1 = pt.mom_at(2) / safe, mu2 = pt.mom_at(3) / safe;
  const float cxx = sub_prod(pt.mom_at(4) / safe, mu0, mu0);
  const float cxy = sub_prod(pt.mom_at(5) / safe, mu0, mu1);
  const float cxz = sub_prod(pt.mom_at(6) / safe, mu0, mu2);
  const float cyy = sub_prod(pt.mom_at(7) / safe, mu1, mu1);
  const float cyz = sub_prod(pt.mom_at(8) / safe, mu1, mu2);
  const float czz = sub_prod(pt.mom_at(9) / safe, mu2, mu2);
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
    fxx += pt.sc_at(0);
    fxy += pt.sc_at(1);
    fxz += pt.sc_at(2);
    fyy += pt.sc_at(3);
    fyz += pt.sc_at(4);
    fzz += pt.sc_at(5);
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
  const float p0 = pt.p_at(0), p1 = pt.p_at(1), p2 = pt.p_at(2);
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

// One point's inputs, held in registers (K1, K5); sc is read only with
// source covariances.
struct HeldPoint {
  float mom[10];
  float p[3];
  float sc[6];
  __device__ __forceinline__ float mom_at(int k) const { return mom[k]; }
  __device__ __forceinline__ float p_at(int k) const { return p[k]; }
  __device__ __forceinline__ float sc_at(int k) const { return sc[k]; }
};

// Blocks of unary_partial for n points: one point a thread, at least 1, at
// most kFinalRows. A function of n alone, so a shape always sums in the same
// order.
constexpr int unary_blocks(int n) {
  return n < 1 ? 1 : ((n - 1) / kUnaryThreads + 1 < kFinalRows ? (n - 1) / kUnaryThreads + 1 : kFinalRows);
}

// K1's partial kernel (K5's with kWeights false): the pose, planar p [3,n],
// moment rows mom [10,n], found bytes [n], weights [n] (kWeights) and source
// covariances sc [6,n] (kSrcCovs, else eps I); one row of 29 partial sums a
// block. Weights are a template flag, not a runtime test: a runtime test
// took the unweighted eps kernel of the first design to 93 registers.
template <bool kSrcCovs, bool kWeights>
__global__ void __launch_bounds__(kUnaryThreads)
unary_partial(const float* __restrict__ p, const float* __restrict__ mom, const uint8_t* __restrict__ found,
              const float* __restrict__ weights, const float* __restrict__ sc, const float* __restrict__ delta,
              float min_points, float eps, float* __restrict__ partial, int n) {
  __shared__ float s_warp[kUnaryWarps][32];
  float R[3][3], t[3];
  load_pose(delta, R, t);

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const int stride = gridDim.x * kUnaryThreads;
  for (int i = blockIdx.x * kUnaryThreads + threadIdx.x; i < n; i += stride) {
    // every load of the point is issued before its gate is tested
    const uint8_t f = __ldg(found + i);
    const float w = kWeights ? __ldg(weights + i) : 1.0f;
    HeldPoint pt;
#pragma unroll
    for (int k = 0; k < 10; ++k) pt.mom[k] = __ldg(mom + k * n + i);
#pragma unroll
    for (int k = 0; k < 3; ++k) pt.p[k] = __ldg(p + k * n + i);
    if constexpr (kSrcCovs) {
#pragma unroll
      for (int k = 0; k < 6; ++k) pt.sc[k] = __ldg(sc + k * n + i);
    }
    add_point_terms<kSrcCovs>(acc, R, t, pt, f ? w : 0.0f, min_points, eps);
  }
  block_sum_32(acc, s_warp, partial + blockIdx.x * kOut);
}

// Lane blockIdx.x's rows [num_blocks, 29], num_blocks <= kFinalRows, staged
// in shared memory with coalesced loads; thread t holds row t and the rows
// are summed as the partial kernels sum their threads (block_sum_32): a
// fixed tree.
__global__ void __launch_bounds__(kFinalThreads)
unary_final(const float* __restrict__ partial, int num_blocks, float* __restrict__ out) {
  __shared__ float s_rows[kFinalRows * kOut];
  __shared__ float s_warp[kFinalThreads / 32][32];
  const size_t b = blockIdx.x;
  const float* __restrict__ rows = partial + b * num_blocks * kOut;
  // unrolled and guarded, so every load is in flight before the first store
#pragma unroll
  for (int j = 0; j < kFinalRows * kOut / kFinalThreads; ++j) {
    const int k = threadIdx.x + j * kFinalThreads;
    if (k < num_blocks * kOut) s_rows[k] = rows[k];
  }
  __syncthreads();
  const int t = threadIdx.x;
  float row[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) row[k] = t < num_blocks ? s_rows[t * kOut + k] : 0.0f;
  block_sum_32(row, s_warp, out + b * kOut);
}

static_assert(kFinalThreads % 32 == 0, "the final pass is whole warps");
static_assert(kFinalRows * kOut % kFinalThreads == 0, "the staging loop covers every row");

// K1's pair on stream s: unary_partial on num_blocks = unary_blocks(n)
// blocks, then unary_final. weights is read only with kWeights; a null sc
// selects the eps mode. -> cudaGetLastError() after the launches (0 on
// success), or cudaErrorInvalidValue for n < 0 or another num_blocks. Does
// not synchronize.
template <bool kWeights>
int launch_unary(const void* p, const void* mom, const void* found, const void* weights, const void* sc,
                 const void* delta, float min_points, float eps, void* partial, void* out, int n, int num_blocks,
                 void* stream) {
  if (n < 0 || num_blocks != unary_blocks(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fmom = static_cast<const float*>(mom);
  const uint8_t* ffound = static_cast<const uint8_t*>(found);
  const float* fw = static_cast<const float*>(weights);
  const float* fsc = static_cast<const float*>(sc);
  const float* fdelta = static_cast<const float*>(delta);
  float* fpartial = static_cast<float*>(partial);
  if (fsc != nullptr) {
    unary_partial<true, kWeights><<<num_blocks, kUnaryThreads, 0, s>>>(fp, fmom, ffound, fw, fsc, fdelta, min_points,
                                                                       eps, fpartial, n);
  } else {
    unary_partial<false, kWeights><<<num_blocks, kUnaryThreads, 0, s>>>(fp, fmom, ffound, fw, fsc, fdelta, min_points,
                                                                        eps, fpartial, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unary_final<<<1, kFinalThreads, 0, s>>>(fpartial, num_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
