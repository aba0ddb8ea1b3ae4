// Batched unary VGICP linearize (K2) for NVIDIA Hopper, sm_90a: K1's 29 sums
// for B poses over one shared source, in one launch pair.
//
// Replaces: _vgicp_unary_kernel_batched in
// gtsam_points_tpu/ops/pallas_linearize.py:626 (reached through
// _vgicp_unary_call_b and linearize_vgicp_unary_batch, pallas_call at :776).
//
// What it computes: for each lane b, K1's function (csrc/vgicp_unary.cu)
// without weights on lane b's pose deltas[b], moment rows momT_b[b] [10,N]
// and found flags found_b[b] [N]; the source points p [3,N] and covariances
// C_s [6,N] (or the eps mode) are shared by all lanes. Each point's terms come
// from add_point_terms in csrc/unary_point.cuh, the code K1 and K5 run, so
// the FMA-free moment differences, the determinant rule and the skip of
// points with m <= 0 (a branch) are K1's; only the order of the sums differs.
//
// What bounds it on an H100: at B = 64 lanes of N = 25088 points each lane
// reads its own moment rows and flags, 41 B a point, 65.8 MB in all, 19.6 us
// at 3.35 TB/s, while the shared p and C_s (0.9 MB) stay in the 50 MB L2. A
// point that passes the gate costs about 270 fp32 operations (chip_smoke.py's
// count), ten of them IEEE divisions that each issue a sequence of
// instructions, over 1.4 million points: instruction issue takes a share of
// the time beside the bytes, and the design keeps both busy at once.
//
// The first design was K1's grid once per lane: one point a thread, 98 blocks
// of 256 a lane, each ending in a 29-column shuffle tree, and a thread issued
// the nine moment loads only after its count load came back. It took
// 110-120 us per pair on an H100 (PERF.md).
//
// Design:
// - Quads. A thread takes four consecutive points (a quad) and issues all of
//   their loads before it tests any count: the ten moment rows (one 16-byte
//   load a row where N is a multiple of 4 and the planes are aligned, else
//   four guarded scalar loads), the four found bytes (one 4-byte load), p (3
//   rows) and C_s (6 rows). The moment rows and flags are read once, so they
//   are loaded with the streaming hint (__ldcs); p and C_s are read by every
//   lane and go through the cache (__ldg).
// - Grid. A lane has batch_blocks(N) blocks of 64 threads on blockIdx.x, one
//   quad a thread, in a grid-stride loop beyond 256 blocks (98 blocks a lane
//   at N = 25088, 6272 at B = 64); lanes run on blockIdx.y. The grid of a lane
//   depends on N alone, never on B, so lane b's result is the same bit for
//   bit whichever lanes share the launch. Small blocks let the block
//   scheduler balance the card: with 13 blocks of 128 threads a lane (four
//   quads a thread) the last of about two waves of blocks ran mostly empty
//   and the pair read slower on an H100. __launch_bounds__ caps the
//   registers at 128, so 16 warps fit an SM; with source covariances that
//   spills 24 bytes a thread (36 with scalar loads; nvcc -Xptxas -v, phase 2
//   of chip_smoke.py), which read faster than 145 registers and 12 warps.
//   Both readings came from variants no longer in the tree and no kept
//   script measures them: they are qualitative, not figures.
// - Two load paths: the 16-byte loads need N % 4 == 0 and aligned planes;
//   otherwise (odd N, or a view off a 16-byte boundary) each row takes four
//   guarded scalar loads. They load the same values into the same
//   registers, so the sums agree bit for bit; phase 11 of chip_smoke.py
//   checks that and times both at B = 64, N = 25088: on an H100 the scalar
//   path took 52.1 us a pair with covariances and 45.8 us in eps mode,
//   against 35.9 and 35.4 us with 16-byte loads (PERF.md).
// - Each block sums its threads' 29 sums into one row (block_sum_32 in
//   csrc/reduce32.cuh: recursive halving in each warp, 31 shuffles where a
//   shuffle tree a column takes 145, then the warps in order).
// - Final pass. One block of 256 threads per lane stages the lane's rows in
//   shared memory with coalesced loads, all in flight at once; thread t takes
//   row t and the rows are summed by block_sum_32 again: a fixed tree. No
//   atomics and no state between calls, so two calls on the same input agree
//   bit for bit and the pair can be replayed in a CUDA graph.
// - Staging through shared memory (cp.async or TMA) is not used: the quads
//   already put 41 B a point in flight per thread before any arithmetic, the
//   pair is within 2x of its byte bound (PERF.md), and a ring of tiles would
//   add no bytes in flight that 16 warps of registers do not already hold.

#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce32.cuh"
#include "unary_point.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocksPerSM = 8;  // caps the registers at 128: 16 warps an SM
constexpr int kQuadsPerThread = 1;  // 4 points a thread, before the grid strides
constexpr int kMaxBlocks = 256;     // blocks a lane; the final pass holds one row a thread
constexpr int kBatchFinalThreads = kMaxBlocks;
constexpr int kMaxLanes = 65535;  // lanes run on gridDim.y

// Blocks a lane for n points: about kQuadsPerThread quads a thread, at most
// kMaxBlocks. A function of n alone.
constexpr int batch_blocks(int n) {
  const int quads = (n + 3) / 4;
  const int blocks = (quads + kThreads * kQuadsPerThread - 1) / (kThreads * kQuadsPerThread);
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// Point J of a quad whose inputs the thread holds in registers.
template <int J>
struct QuadPoint {
  const float (&mom)[10][4];
  const float (&p)[3][4];
  const float (&sc)[6][4];
  __device__ __forceinline__ float mom_at(int k) const { return mom[k][J]; }
  __device__ __forceinline__ float p_at(int k) const { return p[k][J]; }
  __device__ __forceinline__ float sc_at(int k) const { return sc[k][J]; }
};

// Points i0 .. i0+3 of one planar row: one 16-byte load (kVec: the caller
// guarantees i0 + 3 < n and alignment), else guarded scalar loads with 0
// past n. kStream selects the streaming hint over the read-only cache.
template <bool kVec, bool kStream>
__device__ __forceinline__ void load_quad(const float* __restrict__ row, int i0, int n, float (&v)[4]) {
  if (kVec) {
    const float4* q = reinterpret_cast<const float4*>(row + i0);
    const float4 x = kStream ? __ldcs(q) : __ldg(q);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i0 + j < n ? (kStream ? __ldcs(row + i0 + j) : __ldg(row + i0 + j)) : 0.0f;
  }
}

template <bool kSrcCovs, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
unary_batch_partial(const float* __restrict__ p, const float* __restrict__ mom_b,
                    const uint8_t* __restrict__ found_b, const float* __restrict__ sc,
                    const float* __restrict__ deltas, float min_points, float eps,
                    float* __restrict__ partial, int n) {
  __shared__ float s_warp[kWarps][32];
  const size_t b = blockIdx.y;
  const float* __restrict__ mom = mom_b + b * 10 * n;
  const uint8_t* __restrict__ found = found_b + b * n;
  float R[3][3], t[3];
  load_pose(deltas + 16 * b, R, t);

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const int quads = (n + 3) / 4;
  const int stride = gridDim.x * kThreads;
  for (int q = blockIdx.x * kThreads + threadIdx.x; q < quads; q += stride) {
    const int i0 = 4 * q;
    // every load of the quad is issued before any count is tested
    float qm[10][4], qp[3][4], qs[6][4];
#pragma unroll
    for (int k = 0; k < 10; ++k) load_quad<kVec, true>(mom + k * n, i0, n, qm[k]);
    uint32_t f;
    if (kVec) {
      f = __ldcs(reinterpret_cast<const unsigned int*>(found + i0));
    } else {
      f = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) f |= i0 + j < n ? static_cast<uint32_t>(__ldcs(found + i0 + j)) << (8 * j) : 0u;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) load_quad<kVec, false>(p + k * n, i0, n, qp[k]);
    if (kSrcCovs) {
#pragma unroll
      for (int k = 0; k < 6; ++k) load_quad<kVec, false>(sc + k * n, i0, n, qs[k]);
    }
    // points past n have a zero found byte, so add_point_terms skips them
    add_point_terms<kSrcCovs>(acc, R, t, QuadPoint<0>{qm, qp, qs}, (f & 0xffu) ? 1.0f : 0.0f, min_points, eps);
    add_point_terms<kSrcCovs>(acc, R, t, QuadPoint<1>{qm, qp, qs}, (f & 0xff00u) ? 1.0f : 0.0f, min_points, eps);
    add_point_terms<kSrcCovs>(acc, R, t, QuadPoint<2>{qm, qp, qs}, (f & 0xff0000u) ? 1.0f : 0.0f, min_points, eps);
    add_point_terms<kSrcCovs>(acc, R, t, QuadPoint<3>{qm, qp, qs}, (f & 0xff000000u) ? 1.0f : 0.0f, min_points, eps);
  }
  block_sum_32(acc, s_warp, partial + (b * gridDim.x + blockIdx.x) * kOut);
}

// Lane blockIdx.x's rows [num_blocks, 29], staged in shared memory with
// coalesced loads; thread t holds row t and the rows are summed as the
// partial kernel sums its threads (block_sum_32): a fixed tree.
__global__ void __launch_bounds__(kBatchFinalThreads)
unary_batch_final(const float* __restrict__ partial, int num_blocks, float* __restrict__ out) {
  __shared__ float s_rows[kMaxBlocks * kOut];
  __shared__ float s_warp[kBatchFinalThreads / 32][32];
  const size_t b = blockIdx.x;
  const float* __restrict__ rows = partial + b * num_blocks * kOut;
  // unrolled and guarded, so every load is in flight before the first store
#pragma unroll
  for (int j = 0; j < kMaxBlocks * kOut / kBatchFinalThreads; ++j) {
    const int k = threadIdx.x + j * kBatchFinalThreads;
    if (k < num_blocks * kOut) s_rows[k] = rows[k];
  }
  __syncthreads();
  const int t = threadIdx.x;
  float row[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) row[k] = t < num_blocks ? s_rows[t * kOut + k] : 0.0f;
  block_sum_32(row, s_warp, out + b * kOut);
}

template <bool kSrcCovs, bool kVec>
void launch_partial(dim3 grid, cudaStream_t s, const float* p, const float* mom_b, const uint8_t* found_b,
                    const float* sc, const float* deltas, float min_points, float eps, float* partial, int n) {
  unary_batch_partial<kSrcCovs, kVec><<<grid, kThreads, 0, s>>>(p, mom_b, found_b, sc, deltas, min_points, eps,
                                                                partial, n);
}

static_assert(kBatchFinalThreads % 32 == 0, "the final pass is whole warps");
static_assert(kMaxBlocks * kOut % kBatchFinalThreads == 0, "the staging loop covers every row");

}  // namespace

extern "C" {

int gpt_vgicp_unary_batch_threads() { return kThreads; }
int gpt_vgicp_unary_batch_out_len() { return kOut; }
int gpt_vgicp_unary_batch_max_lanes() { return kMaxLanes; }

// p [3,n] and sc [6,n] or null (null: eps mode) shared by the lanes;
// mom_b [lanes,10,n], found_b [lanes,n] bytes, deltas [lanes,4,4]; partial:
// [lanes, num_blocks, 29] scratch; out: [lanes, 29]. num_blocks must be
// batch_blocks(n) (unary_batch_num_blocks in the wrapper). Returns cudaGetLastError() after the
// launches (0 on success), or cudaErrorInvalidValue for n < 0, another
// num_blocks, or lanes outside 1 .. gpt_vgicp_unary_batch_max_lanes(). Does
// not synchronize.
int gpt_vgicp_unary_batch(const void* p, const void* mom_b, const void* found_b, const void* sc,
                          const void* deltas, float min_points, float eps, void* partial, void* out,
                          int n, int num_blocks, int lanes, void* stream) {
  if (n < 0 || num_blocks != batch_blocks(n) || lanes < 1 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(p);
  const float* fmom = static_cast<const float*>(mom_b);
  const uint8_t* ffound = static_cast<const uint8_t*>(found_b);
  const float* fsc = static_cast<const float*>(sc);
  // 16-byte loads need every row of every plane on a 16-byte boundary: n a
  // multiple of 4 and aligned bases (found_b's rows then lie on 4 bytes)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(fp) | reinterpret_cast<uintptr_t>(fmom) |
                          reinterpret_cast<uintptr_t>(fsc);
  const bool vec = n % 4 == 0 && bases % 16 == 0 && reinterpret_cast<uintptr_t>(ffound) % 4 == 0;
  const dim3 grid(num_blocks, lanes);
  auto* partial_kernel = fsc != nullptr ? (vec ? launch_partial<true, true> : launch_partial<true, false>)
                                        : (vec ? launch_partial<false, true> : launch_partial<false, false>);
  partial_kernel(grid, s, fp, fmom, ffound, fsc, static_cast<const float*>(deltas), min_points, eps,
                 static_cast<float*>(partial), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unary_batch_final<<<lanes, kBatchFinalThreads, 0, s>>>(static_cast<const float*>(partial), num_blocks,
                                                    static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
