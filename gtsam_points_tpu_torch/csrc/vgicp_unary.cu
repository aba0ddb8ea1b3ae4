// Unary VGICP linearize from raw voxel moments for NVIDIA Hopper, sm_90a:
// K1 for one pose, K2 for B poses over one shared source.
//
// Replaces: _vgicp_unary_kernel in gtsam_points_tpu/ops/pallas_linearize.py:500
// (reached through _vgicp_unary_call and linearize_vgicp_unary, pallas_call at
// :555) and _vgicp_unary_kernel_batched (:626, reached through
// _vgicp_unary_call_b and linearize_vgicp_unary_batch, pallas_call at :776).
// The per-point math of both is _unary_quantities (:656-735); here it is
// add_point, called by both kernels, so the two cannot drift.
//
// What it computes. For N source points p [3,N] with the raw moment row of
// the voxel each one probed (momT [10,N]: count, sum p (3), sum ppᵀ upper
// (6)), a found flag, optional per-point weights w (K1 only) and optional
// source covariances C_s [6,N], at the relative pose delta = [R t; 0 1]:
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
// K2 computes the same 29 sums for each of B lanes: lane b has its own pose
// deltas[b], moment rows momT_b[b] and found flags found_b[b]; p and C_s are
// shared by all lanes.
//
// What bounds it on an H100: each point reads p (12 B), momT (40 B), the found
// byte, and C_s (24 B) or w (4 B) when given: at most 81 B a point, 2.0 MB at
// the full 25088-slot scan, 0.6 us at 3.35 TB/s (0.08 us at a stride-8 stage).
// The arithmetic is about 250 fp32 operations a point, 0.1 us at 67 TFLOP/s.
// Both lie far below the few microseconds of a launch, so K1 is bound by
// launch latency and the design spends nothing on tiling, TMA or tensor
// cores: the TPU kernel's [32,128] VMEM accumulator and its [1,T] lane layout
// are not carried over. K2 is not: at B = 64 lanes of 25088 points each lane
// reads its own moment rows and flags, 65.8 MB in all, about 20 us at 3.35
// TB/s, while the shared p and C_s (0.9 MB) stay in the 50 MB L2 across the
// lanes. K2 is bound by those bytes; the kernel reads them once, coalesced,
// and does not yet stage them through shared memory.
//
// Design: one thread per point in a grid-stride loop, the 29 running sums in
// registers (every index is a compile-time constant after unrolling). A
// warp-shuffle reduction and a shared-memory reduction over the block's warps
// write one partial row per block, and a second kernel sums the rows in block
// order. The lanes run on blockIdx.y of the first kernel and blockIdx.x of
// the second; K1 is the launch of the same two kernels with one lane, so
// lane b of K2 runs K1's code over K1's blocks in K1's order and gives K1's
// result on lane b's inputs bit for bit. There are no atomics, so two registrations from the same input give
// the same pose bit for bit. The poses are read from a device pointer, so a
// Gauss-Newton loop never reads them to the host between iterations. A null
// pointer for C_s selects the eps mode; a null pointer for w means unit
// weights. Points with m <= 0 are skipped: every sum is scaled by m, so they
// contribute nothing (weights must be non-negative).
//
// The voxel covariance comes from raw moments, s6/count - mu muᵀ, which
// cancels in f32 far from the origin. Those six differences are rounded as
// separate products and differences (no fused multiply-add), as the plain
// PyTorch version computes them, so the kernel does not move the result of
// that cancellation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// K1 and K2: K1's blocks for lane blockIdx.y, with that lane's pose, moment
// rows, found flags and weights (null: unit weights); one row of partial sums
// per block and lane. K1 is the one-lane launch, so lane b of K2 and K1 on
// lane b's inputs run the same code over the same blocks. Weights are a
// template flag, not a runtime test: a runtime test takes the unweighted eps
// kernel to 93 registers, 2 blocks an SM instead of 3 at 80.
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

template <bool kSrcCovs, bool kWeights>
void launch_partial(dim3 grid, cudaStream_t s, const float* p, const float* mom_b, const uint8_t* found_b,
                    const float* weights_b, const float* sc, const float* deltas, float min_points, float eps,
                    float* partial, int n) {
  unary_partial<kSrcCovs, kWeights><<<grid, kThreads, 0, s>>>(p, mom_b, found_b, weights_b, sc, deltas,
                                                              min_points, eps, partial, n);
}

// Both kernels for `lanes` lanes; cudaGetLastError() after the launches.
int launch(const void* p, const void* mom_b, const void* found_b, const void* weights_b, const void* sc,
           const void* deltas, float min_points, float eps, void* partial, void* out, int n,
           int num_blocks, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fmom = static_cast<const float*>(mom_b);
  const uint8_t* ffound = static_cast<const uint8_t*>(found_b);
  const float* fw = static_cast<const float*>(weights_b);
  const float* fsc = static_cast<const float*>(sc);
  const float* fdeltas = static_cast<const float*>(deltas);
  float* fpartial = static_cast<float*>(partial);
  const dim3 grid(num_blocks, lanes);
  auto* partial_kernel = fsc != nullptr ? (fw != nullptr ? launch_partial<true, true> : launch_partial<true, false>)
                                        : (fw != nullptr ? launch_partial<false, true> : launch_partial<false, false>);
  partial_kernel(grid, s, fp, fmom, ffound, fw, fsc, fdeltas, min_points, eps, fpartial, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unary_final<<<lanes, kFinalThreads, 0, s>>>(fpartial, num_blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gpt_vgicp_unary_threads() { return kThreads; }
int gpt_vgicp_unary_out_len() { return kOut; }
// K2's lanes run on gridDim.y, whose limit this is.
int gpt_vgicp_unary_batch_max_lanes() { return 65535; }

// p [3,n], mom [10,n], found [n] bytes, weights [n] or null, sc [6,n] or null
// (null: eps mode), delta [4,4]; partial: [num_blocks, 29] scratch; out: [29].
// Returns cudaGetLastError() after the launches (0 on success). Does not
// synchronize.
int gpt_vgicp_unary(const void* p, const void* mom, const void* found, const void* weights,
                    const void* sc, const void* delta, float min_points, float eps, void* partial,
                    void* out, int n, int num_blocks, void* stream) {
  return launch(p, mom, found, weights, sc, delta, min_points, eps, partial, out, n, num_blocks, 1, stream);
}

// K2. p [3,n] and sc [6,n] or null (null: eps mode) shared by the lanes;
// mom_b [lanes,10,n], found_b [lanes,n] bytes, deltas [lanes,4,4]; partial:
// [lanes, num_blocks, 29] scratch; out: [lanes, 29]. Returns
// cudaGetLastError() after the launches (0 on success), or cudaErrorInvalidValue
// for lanes outside 1 .. gpt_vgicp_unary_batch_max_lanes(). Does not
// synchronize.
int gpt_vgicp_unary_batch(const void* p, const void* mom_b, const void* found_b, const void* sc,
                          const void* deltas, float min_points, float eps, void* partial, void* out,
                          int n, int num_blocks, int lanes, void* stream) {
  if (lanes < 1 || lanes > gpt_vgicp_unary_batch_max_lanes()) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, mom_b, found_b, nullptr, sc, deltas, min_points, eps, partial, out, n, num_blocks, lanes,
                stream);
}

}  // extern "C"
