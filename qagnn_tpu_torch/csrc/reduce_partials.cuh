// Sum of per-block partials, the second step of every grid-wide reduction of
// the backward kernels (the TPU kernels accumulate in one resident block over
// a sequential grid; blocks run in parallel here, so each writes its partial
// once and this adds them up in a fixed order).
#pragma once
#include <cuda_runtime.h>

namespace {

// out[c] = sum over p < P of part[p, c]; a block takes 32 columns with 8
// rows of threads striding over p. Launch with dim3(32, 8) threads and
// (n + 31) / 32 blocks.
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int P,
                                       int n) {
  __shared__ float s[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float v = 0.0f;
  if (c < n)
    for (int p = threadIdx.y; p < P; p += 8) v += part[(long long)p * n + c];
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && c < n) {
    for (int t = 1; t < 8; ++t) v += s[t][threadIdx.x];
    out[c] = v;
  }
}

}  // namespace
