// The relative pose delta = [R t; 0 1] read from a device pointer, shared by
// K3 (csrc/linearize_fused.cu) and, through csrc/unary_point.cuh, by K1, K2
// and K5. Every kernel reads the pose on the card, so no launch waits for the
// host to read it.
//
// A library is keyed on its .cu file and every csrc/*.cuh (see _build.py), so
// an edit here rebuilds each source.

#pragma once

#include <cuda_runtime.h>

namespace {

// The pose [4,4], row-major, at delta: R = delta[0..2][0..2], t = delta[0..2][3].
__device__ __forceinline__ void load_pose(const float* __restrict__ delta, float (&R)[3][3], float (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = __ldg(delta + 4 * i + j);
    t[i] = __ldg(delta + 4 * i + 3);
  }
}

}  // namespace
