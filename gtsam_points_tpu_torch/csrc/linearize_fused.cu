// Fused point linearization (K3) for NVIDIA Hopper, sm_90a.
//
// Replaces: _linearize_kernel in gtsam_points_tpu/ops/pallas_linearize.py:107
// (reached through _linearize_call and linearize_fused; pallas_call at :189).
//
// What it computes, over N planar points with a frozen correspondence
// payload (p, mu [3,N]; W6 [6,N] symmetric weights; mask [N]) and the
// relative pose delta = [R t; 0 1]:
//   pm = R p + t,  r = pm - mu,
//   J_t = [skew(pm) | -I],  J_s = [-R skew(p) | R]   (J = [J_t | J_s], 3x12)
//   H = sum J^T W J (12x12),  g = sum J^T W r,  err = sum r^T W r,  count,
// over masked-in points only. The output is 92 floats: the upper triangle of
// H in row-major order (78), g (12), err, count. The wrapper forms b = -g.
//
// What bounds it on an H100: each point reads p (12 B), mu (12 B), W6 (24 B)
// and one mask byte, 49 B/point, so 1.2 MB at the main path's N = 25k, which
// is about 0.37 us at 3.35 TB/s. Both that and the arithmetic lie far below
// the few microseconds of two launches, so the kernel is bound by latency:
// the launches, one trip to memory, the block reduction and the final pass.
// Launched back to back on an H100 the pair takes about 3.9 us at N = 1 and
// 4.8 us at N = 25k (PERF.md), so the two launches are most of it.
//
// The first design summed all 92 terms per point (182 registers, one block
// of 8 warps an SM), four points a thread in series on 25 blocks at N = 25k,
// reduced 92 columns a block and summed the block rows in series in one
// 128-thread block: 11.0-11.6 us per launch pair on an H100 (PERF.md).
//
// Design:
// - 29 sums, not 92. With q = R p (the source point rotated, not moved),
//   J~ = [-skew(q) | I] and the blocks D = diag(R, R), N = [I 0; -skew(t) I]
//   (6x6), the two Jacobians are J_s = J~ D and J_t = -J~ N, since
//   R skew(p) = skew(q) R and skew(pm) = skew(q) + skew(t). So with
//   H~ = sum J~^T W J~ and g~ = sum J~^T W r:
//     H_ss = D^T H~ D,  H_tt = N^T H~ N,  H_ts = -N^T H~ D,
//     g_s = D^T g~,     g_t = -N^T g~.
//   H~ and g~ have K1's layout (csrc/unary_point.cuh): h11 = skew(q) W
//   skew(q)^T (6), sA = skew(q) W (9), W (6), q x u (3), u = W r (3), then
//   the error r.u and the count. A point costs about 124 fp32 operations
//   (790 before), with no per-point rotation of W. Against the direct sums
//   in float64 it reads as the 92-sum design did on the far and
//   near-optimum payloads of chip_smoke.py's phase 3 (1.3e-5 and 1.0e-4 x
//   max|ref|, both designs, on an H100; PERF.md): near the optimum the
//   float32 rounding of r at |pm| = 20-50 m sets that error, in any order
//   of the sums. 72 registers (182 before).
// - One point a thread, kThreads = 128 a block, num_blocks = ceil(N / 128)
//   up to kMaxBlocks (196 blocks at N = 25k, on all 132 SMs), a grid-stride
//   loop beyond. Every load of a point is issued before its mask is tested;
//   a masked-out point adds exact zeros (its W, q and r are selected to 0).
//   A block reduces its 29 sums into one row (block_sum_32 in
//   csrc/reduce32.cuh: recursive halving in each warp, 31 shuffles a warp
//   where a shuffle tree a column takes 145, then the warps in order).
// - The final pass, one block of kFinalThreads: thread t loads block row t
//   straight into registers (29 loads a thread, all in flight at once, from
//   the L2 the partial kernel just wrote), and the rows are summed by
//   block_sum_32 again: a fixed tree. Then H~ and g~ are expanded to the 92
//   outputs with N and D built from the pose. Staging the rows in 30 KB of
//   shared memory with coalesced loads, and reading H~'s layout from a
//   __constant__ table, were both tried and read slower on an H100, most
//   inside the host-bound race, where the final pass runs after other
//   kernels. That reading came from variants no longer in the tree; no
//   kept script measures it, so the choice rests on it qualitatively.
// - One launch was tried on a cluster of 8 or 16 blocks that summed the rows
//   through distributed shared memory. It read slower on an H100 (8-16 SMs
//   stream the payload more slowly than the second launch costs), again
//   from a variant no kept script measures: qualitative, not a figure.
// There are no atomics and no state between calls, so the result is the
// same bit for bit from run to run, which the LM accept gate relies on when
// it compares errors, and the pair can be replayed in a CUDA graph. The pose
// is read from a device pointer, so the host never reads it before a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pose.cuh"
#include "reduce32.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 256;
constexpr int kSums = 29;  // h11 (6), sA (9), W (6), q x u (3), u (3), error, count
constexpr int kDim = 12;
constexpr int kTri = kDim * (kDim + 1) / 2;  // 78
constexpr int kOut = kTri + kDim + 2;        // 92
constexpr int kFinalThreads = 256;
constexpr int kFinalWarps = kFinalThreads / 32;

static_assert(kMaxBlocks <= kFinalThreads, "the final pass holds one block row a thread");
static_assert(kOut <= kFinalThreads, "one thread an output");

// Position of H~[a][b] in the 29 sums: [[h11, sA], [sA^T, W]], h11 and W
// upper triangles.
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

// Adds point i's 29 terms into acc. Every load is issued before the mask is
// tested; a masked-out point adds exact zeros (its W, q and r are 0).
__device__ __forceinline__ void add_point(float (&acc)[kSums], const float (&R)[3][3], const float (&t)[3],
                                          const float* __restrict__ p, const float* __restrict__ mu,
                                          const float* __restrict__ w6, const uint8_t* __restrict__ mask,
                                          int i, int n) {
  const bool in = mask[i] != 0;
  const float p0 = p[i], p1 = p[n + i], p2 = p[2 * n + i];
  const float mus[3] = {mu[i], mu[n + i], mu[2 * n + i]};
  float w[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) w[k] = w6[k * n + i];
#pragma unroll
  for (int k = 0; k < 6; ++k) w[k] = in ? w[k] : 0.0f;
  const float wxx = w[0], wxy = w[1], wxz = w[2], wyy = w[3], wyz = w[4], wzz = w[5];

  // q = R p; r = (q + t) - mu
  float q[3], r[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float qd = R[d][0] * p0 + R[d][1] * p1 + R[d][2] * p2;
    q[d] = in ? qd : 0.0f;
    r[d] = in ? (qd + t[d]) - mus[d] : 0.0f;
  }
  const float q0 = q[0], q1 = q[1], q2 = q[2];

  // u = W r
  const float u0 = wxx * r[0] + wxy * r[1] + wxz * r[2];
  const float u1 = wxy * r[0] + wyy * r[1] + wyz * r[2];
  const float u2 = wxz * r[0] + wyz * r[1] + wzz * r[2];

  // sA = skew(q) W, skew rows (0, -q2, q1), (q2, 0, -q0), (-q1, q0, 0)
  const float s00 = -q2 * wxy + q1 * wxz, s01 = -q2 * wyy + q1 * wyz, s02 = -q2 * wyz + q1 * wzz;
  const float s10 = q2 * wxx - q0 * wxz, s11 = q2 * wxy - q0 * wyz, s12 = q2 * wxz - q0 * wzz;
  const float s20 = -q1 * wxx + q0 * wxy, s21 = -q1 * wxy + q0 * wyy, s22 = -q1 * wxz + q0 * wyz;

  // h11 = sA skew(q)^T, upper triangle
  acc[0] += -q2 * s01 + q1 * s02;
  acc[1] += q2 * s00 - q0 * s02;
  acc[2] += -q1 * s00 + q0 * s01;
  acc[3] += q2 * s10 - q0 * s12;
  acc[4] += -q1 * s10 + q0 * s11;
  acc[5] += -q1 * s20 + q0 * s21;
  acc[6] += s00;
  acc[7] += s01;
  acc[8] += s02;
  acc[9] += s10;
  acc[10] += s11;
  acc[11] += s12;
  acc[12] += s20;
  acc[13] += s21;
  acc[14] += s22;
  acc[15] += wxx;
  acc[16] += wxy;
  acc[17] += wxz;
  acc[18] += wyy;
  acc[19] += wyz;
  acc[20] += wzz;
  acc[21] += q1 * u2 - q2 * u1;
  acc[22] += q2 * u0 - q0 * u2;
  acc[23] += q0 * u1 - q1 * u0;
  acc[24] += u0;
  acc[25] += u1;
  acc[26] += u2;
  acc[27] += u0 * r[0] + u1 * r[1] + u2 * r[2];
  acc[28] += in ? 1.0f : 0.0f;
}

// Scratch of the expansion, in shared memory.
struct Expansion {
  float N[6][6], D[6][6], HN[6][6], HD[6][6];
};

// N = [I 0; -skew(t) I] and D = diag(R, R) into e, by threads 0..35. The
// caller synchronizes before expand reads them.
__device__ __forceinline__ void pose_blocks(const float* __restrict__ delta, Expansion& e) {
  const int tid = threadIdx.x;
  if (tid < 36) {
    const int a = tid / 6, b = tid % 6;
    const float t0 = __ldg(delta + 3), t1 = __ldg(delta + 7), t2 = __ldg(delta + 11);
    const float skew_t[3][3] = {{0.0f, -t2, t1}, {t2, 0.0f, -t0}, {-t1, t0, 0.0f}};
    float nv = a == b ? 1.0f : 0.0f;
    if (a >= 3 && b < 3) nv = -skew_t[a - 3][b];
    e.N[a][b] = nv;
    e.D[a][b] = (a < 3) == (b < 3) ? __ldg(delta + 4 * (a % 3) + b % 3) : 0.0f;
  }
}

// The 29 sums in shared memory -> the 92 outputs, by threads 0..91 of a
// block of at least 92 threads (every thread must call it): H~ N and H~ D,
// then H_tt = N^T (H~ N), H_ts = -N^T (H~ D), H_ss = D^T (H~ D), g_t = -N^T g~,
// g_s = D^T g~, the error and the count.
__device__ __forceinline__ void expand(const float* sums, Expansion& e, float* __restrict__ out) {
  const int tid = threadIdx.x;
  if (tid < 72) {
    const int a = (tid % 36) / 6, b = tid % 6;
    const float(*M)[6] = tid < 36 ? e.N : e.D;
    float h = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) h += sums[h_index(a, i)] * M[i][b];
    (tid < 36 ? e.HN : e.HD)[a][b] = h;
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
      for (int i = 0; i < 6; ++i) o += e.N[i][a] * e.HD[i][b - 6];
      o = -o;
    } else {  // H_ss
#pragma unroll
      for (int i = 0; i < 6; ++i) o += e.D[i][a - 6] * e.HD[i][b - 6];
    }
  } else if (tid < kTri + 6) {  // g_t; g~ = (q x u, u) = sums[21..26]
    const int a = tid - kTri;
#pragma unroll
    for (int i = 0; i < 6; ++i) o += e.N[i][a] * sums[21 + i];
    o = -o;
  } else if (tid < kTri + kDim) {  // g_s
    const int a = tid - kTri - 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) o += e.D[i][a] * sums[21 + i];
  } else if (tid < kOut) {  // error, count
    o = sums[27 + tid - kTri - kDim];
  }
  if (tid < kOut) out[tid] = o;
}

__global__ void __launch_bounds__(kThreads)
linearize_partial(const float* __restrict__ p, const float* __restrict__ mu,
                  const float* __restrict__ w6, const uint8_t* __restrict__ mask,
                  const float* __restrict__ delta, float* __restrict__ partial, int n) {
  __shared__ float s_warp[kWarps][32];
  float R[3][3], t[3];
  load_pose(delta, R, t);
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  const int stride = gridDim.x * kThreads;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) add_point(acc, R, t, p, mu, w6, mask, i, n);
  block_sum_32(acc, s_warp, partial + blockIdx.x * kSums);
}

// Sums the block rows in a fixed tree (thread t loads row t; the rows are
// summed as the partial kernel sums its threads), then expands the 29 sums
// into the 12x12 system.
__global__ void __launch_bounds__(kFinalThreads)
linearize_final(const float* __restrict__ partial, int num_blocks, const float* __restrict__ delta,
                float* __restrict__ out) {
  __shared__ float s_warp[kFinalWarps][32];
  __shared__ float s_sum[kSums];
  __shared__ Expansion s_e;
  const int tid = threadIdx.x;
  pose_blocks(delta, s_e);
  float row[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) row[k] = tid < num_blocks ? partial[tid * kSums + k] : 0.0f;
  block_sum_32(row, s_warp, s_sum);  // its barrier also publishes pose_blocks' writes
  __syncthreads();
  expand(s_sum, s_e, out);
}

}  // namespace

extern "C" {

int gpt_linearize_fused_threads() { return kThreads; }
int gpt_linearize_fused_max_blocks() { return kMaxBlocks; }
int gpt_linearize_fused_out_len() { return kOut; }

// partial: [num_blocks, 29] scratch, 1 <= num_blocks <= kMaxBlocks; out:
// [92]. Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for num_blocks out of range. Does not synchronize.
int gpt_linearize_fused(const void* p, const void* mu, const void* w6, const void* mask,
                        const void* delta, void* partial, void* out, int n, int num_blocks,
                        void* stream) {
  if (num_blocks < 1 || num_blocks > kMaxBlocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  linearize_partial<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(p), static_cast<const float*>(mu), static_cast<const float*>(w6),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(delta),
      static_cast<float*>(partial), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linearize_final<<<1, kFinalThreads, 0, s>>>(static_cast<const float*>(partial), num_blocks,
                                               static_cast<const float*>(delta), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
