// The fused joint's lattice cells as the rows of a ring (sm_90): one map
// from a flat cell to its z rows and its label, shared by the forward's
// row policy (joint_fwd.cu, K1) and the backward's (joint_bwd.cu, K2-A and
// K2-B). The cells of the (B, T, U+1) lattice are flattened t-major:
//   cell r = (b T + t) (U+1) + u,
//   z's f row  b T + t     = r / (U+1),
//   z's g row  b (U+1) + u = (r / (T (U+1))) (U+1) + r % (U+1),
//   the label  labels[b U + u] for u < U, -1 at u = U.

#pragma once

#include <cuda_runtime.h>

struct JointMap {
  long long TU;  // T * U1
  int U1;
  __device__ long long f_row(long long r) const { return r / U1; }
  __device__ long long g_row(long long r) const {
    return (r / TU) * U1 + r % U1;
  }
  // labels (B, U1 - 1) int32
  __device__ int label(const int* __restrict__ labels, long long r) const {
    const int u = (int)(r % U1);
    return u < U1 - 1 ? labels[(r / TU) * (U1 - 1) + u] : -1;
  }
};
