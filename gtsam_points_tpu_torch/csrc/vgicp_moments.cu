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
// 25088-slot scan, about 0.58 us at 3.35 TB/s. The arithmetic is about 270
// fp32 operations a point that passes the gate (K1's), 0.1 us at 67
// TFLOP/s, and about 2000 once a call for the expansion. Both lie far below
// the few microseconds of two launches, so the kernel is bound by latency,
// and the design spends nothing on tiling, TMA or tensor cores: the TPU
// kernel's sequential grid over a [16,128] VMEM accumulator and its [16,T]
// Jacobian row planes for the MXU are not carried over.
//
// Design: K1's sums, then K3's expansion.
// - The 12x12 system follows from the 6x6 source block that K1 sums
//   (csrc/vgicp_unary.cu), in the source frame with A = (Rᵀ C_t R + C_s)⁻¹
//   = Rᵀ W R and r' = Rᵀ r (with eps I: Rᵀ (C_t + eps I) R = Rᵀ C_t R +
//   eps I). J_s = R [-skew(p) | I], so K1's block is this system's H_ss and
//   its b_s exactly. With D = diag(R, R) and N = [I 0; -skew(t) I] as in
//   K3, the rotated-source block is H~ = D H_ss Dᵀ and g~ = D g_s, and
//   K3's expansion gives H_tt = Nᵀ H~ N, H_ts = -Nᵀ D H_ss and g_t =
//   -Nᵀ g~.
// - So the partial kernel is K1's: unary_partial<kSrcCovs, false> of
//   csrc/unary_point.cuh on K1's grid (unary_blocks, exported here as
//   gpt_vgicp_unary_num_blocks), as K5 runs it. One point a thread on
//   blocks of 128, every load in flight before the gate, 29 sums a point,
//   block_sum_32 (csrc/reduce32.cuh) into one row a block. The 182-register
//   per-point code of the first design (92 sums a point, 13 blocks of 256
//   at most 1024) is gone.
// - moments_final is this file's own: it stages and sums the rows as
//   unary_final does (the same fixed tree), then expands the 29 sums into
//   the 92 outputs in shared memory. H_ss, g_s, the error and the count are
//   K1's sums themselves, bit for bit.
// - The degeneracy test of F⁻¹ now runs on Rᵀ F R, in the source frame. The
//   determinant and the trace are rotation-invariant only in exact
//   arithmetic, so a voxel whose F lies at the threshold can be kept here
//   and dropped by the plain version, or the other way round
//   (tests/test_torch_moments.py shows such a voxel and bounds what it
//   moves). The raw-moment differences stay FMA-free (sub_prod), as the
//   plain PyTorch version computes them.
// There are no atomics and no state between calls, so two calls on the same
// input agree bit for bit. The pose is read from a device pointer;
// min_voxel_points and eps go by value. A null pointer for C_s selects the
// eps mode.
//
// The first design summed the 92 direct terms a point (182 registers) and
// took 12.7-14.6 us per launch pair at N = 25088 on an H100 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "unary_point.cuh"

namespace {

constexpr int kDim = 12;
constexpr int kTri = kDim * (kDim + 1) / 2;         // 78
constexpr int kMomentsOut = kTri + kDim + 2;        // 92
constexpr int kFinalWarps = kFinalThreads / 32;

static_assert(kMomentsOut <= kFinalThreads, "one thread an output");

// Position of H_ss[a][b] in the 29 sums: [[h11, sA], [sAᵀ, A]], h11 and A
// upper triangles (K1's layout).
__device__ __forceinline__ int h_index(int a, int b) {
  if (a < 3 && b < 3) {
    const int r = min(a, b), c = max(a, b);
    return r * 3 - r * (r - 1) / 2 + c - r;
  }
  if (a < 3) return 6 + 3 * a + (b - 3);
  if (b < 3) return 6 + 3 * b + (a - 3);
  const int r = min(a, b) - 3, c = max(a, b) - 3;
  return 15 + r * 3 - r * (r - 1) / 2 + c - r;
}

// Scratch of the expansion, in shared memory.
struct Expansion {
  float D[6][6], N[6][6], DH[6][6], Ht[6][6], HN[6][6], gt[6];
};

// Sums the partial rows [num_blocks, 29] as unary_final does (staged in
// shared memory, thread t holds row t, block_sum_32), then expands the 29
// sums into the 92 outputs:
//   DH = D H_ss, g~ = D g_s;  H~ = DH Dᵀ;  H~N = H~ N;
//   H_tt = Nᵀ (H~ N),  H_ts = -Nᵀ DH,  H_ss,  g_t = -Nᵀ g~,  g_s,  err,  count.
__global__ void __launch_bounds__(kFinalThreads)
moments_final(const float* __restrict__ partial, int num_blocks, const float* __restrict__ delta,
              float* __restrict__ out) {
  __shared__ float s_rows[kFinalRows * kOut];
  __shared__ float s_warp[kFinalWarps][32];
  __shared__ float s_sum[kOut];
  __shared__ Expansion e;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kFinalRows * kOut / kFinalThreads; ++j) {
    const int k = tid + j * kFinalThreads;
    if (k < num_blocks * kOut) s_rows[k] = partial[k];
  }
  if (tid < 36) {
    const int a = tid / 6, b = tid % 6;
    const float t0 = __ldg(delta + 3), t1 = __ldg(delta + 7), t2 = __ldg(delta + 11);
    const float skew_t[3][3] = {{0.0f, -t2, t1}, {t2, 0.0f, -t0}, {-t1, t0, 0.0f}};
    float nv = a == b ? 1.0f : 0.0f;
    if (a >= 3 && b < 3) nv = -skew_t[a - 3][b];
    e.N[a][b] = nv;
    e.D[a][b] = (a < 3) == (b < 3) ? __ldg(delta + 4 * (a % 3) + b % 3) : 0.0f;
  }
  __syncthreads();
  float row[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) row[k] = tid < num_blocks ? s_rows[tid * kOut + k] : 0.0f;
  block_sum_32(row, s_warp, s_sum);
  __syncthreads();

  if (tid < 36) {  // DH = D H_ss
    const int a = tid / 6, b = tid % 6;
    float h = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) h += e.D[a][i] * s_sum[h_index(i, b)];
    e.DH[a][b] = h;
  } else if (tid < 42) {  // g~ = D g_s; g_s = (p x u, u) = sums[21..26]
    const int a = tid - 36;
    float g = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) g += e.D[a][i] * s_sum[21 + i];
    e.gt[a] = g;
  }
  __syncthreads();
  if (tid < 36) {  // H~ = DH Dᵀ
    const int a = tid / 6, b = tid % 6;
    float h = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) h += e.DH[a][i] * e.D[b][i];
    e.Ht[a][b] = h;
  }
  __syncthreads();
  if (tid < 36) {  // H~ N
    const int a = tid / 6, b = tid % 6;
    float h = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) h += e.Ht[a][i] * e.N[i][b];
    e.HN[a][b] = h;
  }
  __syncthreads();

  float o = 0.0f;
  if (tid < kTri) {
    // (a, b), a <= b, at position tid of the row-major upper triangle
    int a = 0, rem = tid;
    while (rem >= kDim - a) {
      rem -= kDim - a;
      ++a;
    }
    const int b = a + rem;
    if (b < 6) {  // H_tt
#pragma unroll
      for (int i = 0; i < 6; ++i) o += e.N[i][a] * e.HN[i][b];
    } else if (a < 6) {  // H_ts
#pragma unroll
      for (int i = 0; i < 6; ++i) o += e.N[i][a] * e.DH[i][b - 6];
      o = -o;
    } else {  // H_ss, K1's sums
      o = s_sum[h_index(a - 6, b - 6)];
    }
  } else if (tid < kTri + 6) {  // g_t
    const int a = tid - kTri;
#pragma unroll
    for (int i = 0; i < 6; ++i) o += e.N[i][a] * e.gt[i];
    o = -o;
  } else if (tid < kTri + kDim) {  // g_s
    o = s_sum[21 + tid - kTri - 6];
  } else if (tid < kMomentsOut) {  // error, count
    o = s_sum[27 + tid - kTri - kDim];
  }
  if (tid < kMomentsOut) out[tid] = o;
}

}  // namespace

extern "C" {

int gpt_vgicp_moments_threads() { return kUnaryThreads; }
int gpt_vgicp_moments_out_len() { return kMomentsOut; }
int gpt_vgicp_unary_num_blocks(int n) { return unary_blocks(n); }

// p [3,n], mom [10,n], found [n] bytes, sc [6,n] or null (null: eps mode),
// delta [4,4]; partial: [num_blocks, 29] scratch with num_blocks =
// gpt_vgicp_unary_num_blocks(n); out: [92]. Returns cudaGetLastError() after
// the launches (0 on success), or cudaErrorInvalidValue for n < 0 or another
// num_blocks. Does not synchronize.
int gpt_vgicp_moments(const void* p, const void* mom, const void* found, const void* sc,
                      const void* delta, float min_points, float eps, void* partial, void* out,
                      int n, int num_blocks, void* stream) {
  if (n < 0 || num_blocks != unary_blocks(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fmom = static_cast<const float*>(mom);
  const uint8_t* ffound = static_cast<const uint8_t*>(found);
  const float* fsc = static_cast<const float*>(sc);
  const float* fdelta = static_cast<const float*>(delta);
  float* fpartial = static_cast<float*>(partial);
  if (fsc != nullptr) {
    unary_partial<true, false><<<num_blocks, kUnaryThreads, 0, s>>>(fp, fmom, ffound, nullptr, fsc, fdelta,
                                                                    min_points, eps, fpartial, n);
  } else {
    unary_partial<false, false><<<num_blocks, kUnaryThreads, 0, s>>>(fp, fmom, ffound, nullptr, fsc, fdelta,
                                                                     min_points, eps, fpartial, n);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_final<<<1, kFinalThreads, 0, s>>>(fpartial, num_blocks, fdelta, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
