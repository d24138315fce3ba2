// Edge-encoder hidden pass for every edge slot:
//     h[g, e, :] = relu(a * (W0^T feat(g, e) + b0) + b)
// where feat = [onehot(rel) | onehot(type[src]) | onehot(type[dst])] and
// (a, b) is the folded eval-mode BatchNorm affine.
//
// Replaces the TPU kernel `_hidden_fwd_kernel`
// (qagnn_tpu/ops/pallas_edge_encoder.py:164, launched by `_hidden_impl` :234).
//
// Bound on the H100: bytes. The (G, E, D) output in the compute dtype is the
// only large array (105 MB in bf16 at G=64, E=4096, D=200); the inputs are
// three int32 per edge and a (F, D) f32 weight that stays in L1/L2.
//
// Design: the feature row is three one-hots, so W0^T feat is the sum of three
// rows of W0 -- three indexed loads, no matmul and no one-hot. As on the TPU
// the rows are rounded to the compute dtype before an f32 sum. A thread owns
// VEC consecutive columns (VEC = 8 in bf16, 4 in f32) and walks edges with a
// grid stride: b0, a and b sit in its registers, each W0 row slice is read
// with 16-byte loads from L1 (W0 is 38 KB), and each output slice is one
// 16-byte store; neighbouring threads own neighbouring slices, so the stores
// coalesce. (A first version loaded every value with its own 4-byte load at
// a 32-byte lane stride, eight L1 wavefronts each, and ran at a tenth of the
// bytes bound.) The layout is the port's (G, E, D), not the TPU's (G, D, E).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive f32 values at p, as float4 loads when VEC is a multiple
// of 4 (the caller then guarantees 16-byte alignment)
template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}

// blockDim = (D / VEC, rows): thread x owns columns [x*VEC, x*VEC + VEC) of
// every edge its row visits, so b0, a and b are loaded once per thread.
template <typename T, int VEC>
__global__ void edge_hidden_kernel(const int32_t* __restrict__ etype,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   const int32_t* __restrict__ ntype,
                                   const float* __restrict__ w0,
                                   const float* __restrict__ b0,
                                   const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   T* __restrict__ out, long long n_edges,
                                   int E, int N, int D, int n_rel, int n_ntype) {
  const int c0 = threadIdx.x * VEC;
  float b0v[VEC], av[VEC], bv[VEC];
  load_vec<VEC>(b0 + c0, b0v);
  load_vec<VEC>(a + c0, av);
  load_vec<VEC>(b + c0, bv);
  for (long long edge = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       edge < n_edges; edge += (long long)gridDim.x * blockDim.y) {
    const long long g = edge / E;
    float r0[VEC], r1[VEC], r2[VEC];
    load_vec<VEC>(w0 + (long long)etype[edge] * D + c0, r0);
    load_vec<VEC>(w0 + (long long)(n_rel + ntype[g * N + src[edge]]) * D + c0,
                  r1);
    load_vec<VEC>(
        w0 + (long long)(n_rel + n_ntype + ntype[g * N + dst[edge]]) * D + c0,
        r2);
    alignas(16) T v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float x = round_to<T>(r0[j]) + round_to<T>(r1[j]) +
                      round_to<T>(r2[j]) + b0v[j];
      v[j] = from_float<T>(fmaxf(av[j] * x + bv[j], 0.0f));
    }
    T* dst_row = out + edge * D + c0;
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(dst_row) = *reinterpret_cast<const uint4*>(v);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst_row[j] = v[j];
    }
  }
}

template <typename T, int VEC>
int launch(const void* etype, const void* src, const void* dst,
           const void* ntype, const void* w0, const void* b0, const void* a,
           const void* b, void* out, int G, int E, int N, int D, int n_rel,
           int n_ntype, cudaStream_t stream) {
  const long long n_edges = (long long)G * E;
  const int chunks = D / VEC;
  if (chunks > 1024) return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return (int)cudaSuccess;
  const int rows = chunks >= 256 ? 1 : 256 / chunks;
  // one wave of resident blocks, each row of threads walking many edges
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, edge_hidden_kernel<T, VEC>, chunks * rows, 0);
  const long long want = (n_edges + rows - 1) / rows;
  const long long wave = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(want < wave ? want : wave);
  edge_hidden_kernel<T, VEC><<<blocks, dim3(chunks, rows), 0, stream>>>(
      (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)ntype, (const float*)w0, (const float*)b0,
      (const float*)a, (const float*)b, (T*)out, n_edges, E, N, D, n_rel,
      n_ntype);
  return (int)cudaSuccess;
}

}  // namespace

// dtype: 0 = float32 output, 1 = bfloat16 output.
extern "C" int edge_hidden_launch(const void* etype, const void* src,
                                  const void* dst, const void* ntype,
                                  const void* w0, const void* b0,
                                  const void* a, const void* b, void* out,
                                  int G, int E, int N, int D, int n_rel,
                                  int n_ntype, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // the vector paths need 16-byte aligned rows
  const bool aligned = ((uintptr_t)w0 | (uintptr_t)b0 | (uintptr_t)a |
                        (uintptr_t)b | (uintptr_t)out) % 16 == 0;
  int err;
  if (dtype == 1)
    err = aligned && D % 8 == 0
              ? launch<__nv_bfloat16, 8>(etype, src, dst, ntype, w0, b0, a, b,
                                         out, G, E, N, D, n_rel, n_ntype, s)
              : launch<__nv_bfloat16, 1>(etype, src, dst, ntype, w0, b0, a, b,
                                         out, G, E, N, D, n_rel, n_ntype, s);
  else
    err = aligned && D % 4 == 0
              ? launch<float, 4>(etype, src, dst, ntype, w0, b0, a, b, out, G,
                                 E, N, D, n_rel, n_ntype, s)
              : launch<float, 1>(etype, src, dst, ntype, w0, b0, a, b, out, G,
                                 E, N, D, n_rel, n_ntype, s);
  return err != 0 ? err : (int)cudaGetLastError();
}
