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
// is about 0.37 us at 3.35 TB/s. The arithmetic is about 800 fp32 operations
// a point, about 0.3 us at 67 TFLOP/s. Both are far below the few
// microseconds of a launch, so at this size the kernel is bound by launch
// latency. The design therefore spends nothing on tiling or tensor cores (the
// TPU kernel's 48x48 MXU contraction and [16,128] lane padding have no use
// here) and keeps the work to two small launches.
//
// Design: one thread per point in a grid-stride loop. Each thread keeps its
// 92 running sums in registers; every index is a compile-time constant after
// unrolling, so J, W J and the sums never leave registers. A warp-shuffle
// reduction and a shared-memory reduction over the block's warps write one
// partial row per block, and a second single-block kernel sums the rows in a
// fixed order. There are no atomics, so the result is the same bit for bit
// from run to run, which the LM accept gate relies on when it compares
// errors. The pose is read from a device pointer to the 4x4 delta, so the
// host never reads the pose before a launch.

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

__global__ void __launch_bounds__(kThreads)
linearize_partial(const float* __restrict__ p, const float* __restrict__ mu,
                  const float* __restrict__ w6, const uint8_t* __restrict__ mask,
                  const float* __restrict__ delta, float* __restrict__ partial, int n) {
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
    if (!mask[i]) continue;
    const float p0 = p[i], p1 = p[n + i], p2 = p[2 * n + i];
    float pm[3], r[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      pm[d] = R[d][0] * p0 + R[d][1] * p1 + R[d][2] * p2 + t[d];
      r[d] = pm[d] - mu[d * n + i];
    }
    const float wxx = w6[i], wxy = w6[n + i], wxz = w6[2 * n + i];
    const float wyy = w6[3 * n + i], wyz = w6[4 * n + i], wzz = w6[5 * n + i];
    const float W[3][3] = {{wxx, wxy, wxz}, {wxy, wyy, wyz}, {wxz, wyz, wzz}};

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
linearize_final(const float* __restrict__ partial, int num_blocks, float* __restrict__ out) {
  const int k = threadIdx.x;
  if (k < kOut) {
    float s = 0.0f;
    for (int b = 0; b < num_blocks; ++b) s += partial[b * kOut + k];
    out[k] = s;
  }
}

}  // namespace

extern "C" {

int gpt_linearize_fused_threads() { return kThreads; }
int gpt_linearize_fused_out_len() { return kOut; }

// partial: [num_blocks, 92] scratch; out: [92]. Returns cudaGetLastError()
// after the launches (0 on success). Does not synchronize.
int gpt_linearize_fused(const void* p, const void* mu, const void* w6, const void* mask,
                        const void* delta, void* partial, void* out, int n, int num_blocks,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  linearize_partial<<<num_blocks, kThreads, 0, s>>>(
      static_cast<const float*>(p), static_cast<const float*>(mu), static_cast<const float*>(w6),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(delta),
      static_cast<float*>(partial), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  linearize_final<<<1, kFinalThreads, 0, s>>>(static_cast<const float*>(partial), num_blocks,
                                               static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
