// Feature moments of the masked edge slots, the data-only input of the edge
// encoder's analytic train-mode BatchNorm statistics:
//     hist[f]   = number of masked slots whose feature row sets f
//     M[f, f']  = number of masked slots whose row sets both f and f'
//     n         = number of masked slots
// where a slot's row is [onehot(rel) | onehot(type[src]) | onehot(type[dst])],
// so it sets exactly three features.
//
// Replaces the TPU kernel `_moments_kernel`
// (qagnn_tpu/ops/pallas_edge_encoder.py:93, launched by
// `edge_feature_moments` :144), which builds the (F, T) one-hot tile and takes
// feat feat^T on the matrix unit, accumulating over a sequential grid.
//
// Here it is a histogram: 3 increments of hist and 9 of M per masked slot,
// into a per-block integer histogram in shared memory (F + F*F + 1 counters,
// 9 KB at F = 47) that is flushed, where not zero, with integer atomics into
// the int32 outputs. Integer sums do not depend on the order, so the result
// is deterministic and exact (at most G*E = 262,144 per counter). The
// wrapper converts the counts to f32.
//
// Bound on the H100: bytes, the four (G, E) int32 / bool arrays read once
// (3.4 MB at G=64, E=4096: about 1 us); in practice the launch and the
// shared-memory atomics on the few hot counters (the 16 type-type pairs)
// set the time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void edge_moments_kernel(const int32_t* __restrict__ etype,
                                    const int32_t* __restrict__ src,
                                    const int32_t* __restrict__ dst,
                                    const int32_t* __restrict__ ntype,
                                    const uint8_t* __restrict__ mask,
                                    int* __restrict__ counts,
                                    long long n_edges, int E, int N, int F,
                                    int n_rel, int n_ntype) {
  extern __shared__ int s_counts[];       // hist (F), M (F, F), n (1)
  const int total = F + F * F + 1;
  for (int i = threadIdx.x; i < total; i += blockDim.x) s_counts[i] = 0;
  __syncthreads();
  int* s_hist = s_counts;
  int* s_m = s_counts + F;
  for (long long edge = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       edge < n_edges; edge += (long long)gridDim.x * blockDim.x) {
    if (!mask[edge]) continue;
    const long long g = edge / E;
    const int f[3] = {etype[edge], n_rel + ntype[g * N + src[edge]],
                      n_rel + n_ntype + ntype[g * N + dst[edge]]};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicAdd(&s_hist[f[i]], 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) atomicAdd(&s_m[f[i] * F + f[j]], 1);
    }
    atomicAdd(&s_counts[total - 1], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += blockDim.x)
    if (s_counts[i] != 0) atomicAdd(&counts[i], s_counts[i]);
}

}  // namespace

// counts: F + F*F + 1 int32, zeroed by the caller: hist, then M row-major,
// then n. Feature indices must lie in [0, F): rel < n_rel, types < n_ntype.
extern "C" int edge_moments_launch(const void* etype, const void* src,
                                   const void* dst, const void* ntype,
                                   const void* mask, void* counts, int G,
                                   int E, int N, int n_rel, int n_ntype,
                                   void* stream) {
  const int F = n_rel + 2 * n_ntype;
  const size_t smem = sizeof(int) * (F + F * F + 1);
  if (F <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long n_edges = (long long)G * E;
  if (n_edges == 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long want = (n_edges + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 528 ? want : 528);
  edge_moments_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)ntype, (const uint8_t*)mask, (int*)counts, n_edges, E,
      N, F, n_rel, n_ntype);
  return (int)cudaGetLastError();
}
