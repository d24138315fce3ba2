// Edge-encoder hidden pass for every edge slot:
//     h[g, e, :] = relu(a * (W0^T feat(g, e) + b0) + b)
// where feat = [onehot(rel) | onehot(type[src]) | onehot(type[dst])] and
// (a, b) is the folded eval-mode BatchNorm affine.
//
// Replaces the TPU kernel `_hidden_fwd_kernel`
// (qagnn_tpu/ops/pallas_edge_encoder.py:164, launched by `_hidden_impl` :234),
// and its backward `_hidden_bwd_kernel` (:179, launched by `_hidden_bwd_impl`
// :291); see edge_hidden_bwd_kernel below.
//
// Bound on the H100: bytes. The (G, E, D) output in the compute dtype is the
// only large array (105 MB in bf16 at G=64, E=4096, D=200); the inputs are
// three int32 per edge and a (F, D) f32 weight that stays in L1/L2.
//
// Design: the feature row is three one-hots, so W0^T feat is the sum of three
// rows of W0 -- three indexed loads, no matmul and no one-hot. A relation id
// outside [0, n_rel) sets no relation feature (the TPU kernel's one-hot is a
// comparison with the feature ids, `_feat_onehot` :72-78): its relation row
// is zeros and no load reads past W0's relation rows. As on the TPU
// the rows are rounded to the compute dtype before an f32 sum. A thread owns
// VEC consecutive columns (VEC = 8 in bf16, 4 in f32) and walks edges with a
// grid stride: b0, a and b sit in its registers, each W0 row slice is read
// with 16-byte loads from L1 (W0 is 38 KB), and each output slice is one
// 16-byte store; neighbouring threads own neighbouring slices, so the stores
// coalesce. (A first version loaded every value with its own 4-byte load at
// a 32-byte lane stride, eight L1 wavefronts each, and ran at a tenth of the
// bytes bound.) The layout is the port's (G, E, D), not the TPU's (G, D, E).
//
// Two routes behind each entry point: route 1, bf16 at the widths tc_fits
// names (every preset), runs the kernels of edge_hidden_tc.cuh; route 0 the
// kernels below, for f32 (the TPU contracts f32 d_x0 there, which bf16 tensor
// cores would round) and any other width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_hidden_tc.cuh"
#include "reduce_partials.cuh"

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
    const int rel = etype[edge];
    if ((unsigned)rel < (unsigned)n_rel) {
      load_vec<VEC>(w0 + (long long)rel * D + c0, r0);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) r0[j] = 0.0f;
    }
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

// Backward of the hidden pass, over every edge slot (masked ones too: the
// forward emits h for all of them). With x0 = W0^T feat + b0 and
// pre = a * x0 + b recomputed from the integers:
//     d_pre = dh * [pre > 0];  db = sum d_pre;  da = sum d_pre * x0;
//     d_x0 = d_pre * a;        db0 = sum d_x0;
//     dW0[f] += d_x0 (rounded to the compute dtype) for the slot's three
//     feature rows f (two where its relation id is out of range).
// On the TPU one resident block accumulates the four sums over a sequential
// grid. Here a block takes a range of slots and a thread one column d (the
// slots' feature rows are staged in shared memory a tile at a time): the
// block's dW0 (F x D f32, 37.6 KB at F=47, D=200) lives in shared memory and
// the thread alone touches its column of it, so nothing needs an atomic;
// da, db, db0 stay in registers. Each block writes its partials once and
// reduce_partials_kernel adds them up, so the result does not depend on the
// order in which blocks ran. Bound on the H100: bytes, the (G, E, D) dh read
// once (105 MB in bf16, 32 us).
constexpr int BWD_TILE = 128;      // slots whose feature rows are staged at once

template <typename T>
__global__ void edge_hidden_bwd_kernel(
    const int32_t* __restrict__ etype, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ ntype,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ a, const float* __restrict__ b,
    const T* __restrict__ dh, float* __restrict__ part, long long n_edges,
    long long chunk, int E, int N, int D, int F, int n_rel, int n_ntype) {
  extern __shared__ float s_dw0[];                 // (F, D)
  __shared__ int s_rows[3][BWD_TILE];
  const int row_len = (F + 3) * D;                 // a block's partials
  for (int i = threadIdx.x; i < F * D; i += blockDim.x) s_dw0[i] = 0.0f;
  const long long begin = blockIdx.x * chunk;
  const long long end = begin + chunk < n_edges ? begin + chunk : n_edges;
  const int c = threadIdx.x;
  const bool live = c < D;
  const float b0c = live ? b0[c] : 0.0f, ac = live ? a[c] : 0.0f,
              bc = live ? b[c] : 0.0f;
  float da = 0.0f, db = 0.0f, db0 = 0.0f;
  for (long long t0 = begin; t0 < end; t0 += BWD_TILE) {
    const int n = end - t0 < BWD_TILE ? (int)(end - t0) : BWD_TILE;
    __syncthreads();
    // the tile's feature rows, computed once for all columns; -1 for a
    // relation id out of range
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const long long edge = t0 + i, g = edge / E;
      const int rel = etype[edge];
      s_rows[0][i] = (unsigned)rel < (unsigned)n_rel ? rel : -1;
      s_rows[1][i] = n_rel + ntype[g * N + src[edge]];
      s_rows[2][i] = n_rel + n_ntype + ntype[g * N + dst[edge]];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const int r0 = s_rows[0][i], r1 = s_rows[1][i], r2 = s_rows[2][i];
      const float x0 = (r0 >= 0 ? round_to<T>(w0[(long long)r0 * D + c])
                                : 0.0f) +
                       round_to<T>(w0[(long long)r1 * D + c]) +
                       round_to<T>(w0[(long long)r2 * D + c]) + b0c;
      const float d_pre =
          ac * x0 + bc > 0.0f ? to_float(dh[(t0 + i) * D + c]) : 0.0f;
      db += d_pre;
      da += d_pre * x0;
      const float d_x0 = d_pre * ac;
      db0 += d_x0;
      const float dxc = round_to<T>(d_x0);
      if (r0 >= 0) s_dw0[r0 * D + c] += dxc;
      s_dw0[r1 * D + c] += dxc;
      s_dw0[r2 * D + c] += dxc;
    }
  }
  __syncthreads();                 // a block with no slots still zeroed s_dw0
  if (!live) return;
  float* row = part + (long long)blockIdx.x * row_len;
  for (int f = 0; f < F; ++f) row[f * D + c] = s_dw0[f * D + c];
  row[F * D + c] = db0;
  row[(F + 1) * D + c] = da;
  row[(F + 2) * D + c] = db;
}

template <typename T>
int launch_bwd(const void* etype, const void* src, const void* dst,
               const void* ntype, const void* w0, const void* b0,
               const void* a, const void* b, const void* dh, void* part,
               void* out, int G, int E, int N, int D, int F, int n_rel,
               int n_ntype, int n_blocks, cudaStream_t stream) {
  const long long n_edges = (long long)G * E;
  const size_t smem = sizeof(float) * F * D;
  if (n_blocks <= 0 || D > 1024 || smem > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_hidden_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long chunk = (n_edges + n_blocks - 1) / n_blocks;
  const int threads = (D + 31) / 32 * 32;
  edge_hidden_bwd_kernel<T><<<n_blocks, threads, smem, stream>>>(
      (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)ntype, (const float*)w0, (const float*)b0,
      (const float*)a, (const float*)b, (const T*)dh, (float*)part, n_edges,
      chunk, E, N, D, F, n_rel, n_ntype);
  const int n = (F + 3) * D;
  reduce_partials_kernel<<<(n + 31) / 32, dim3(32, 8), 0, stream>>>(
      (const float*)part, (float*)out, n_blocks, n);
  return (int)cudaSuccess;
}

// route 1, forward: one wave of resident blocks, a warp for every tile at
// most
int launch_tc(const void* etype, const void* src, const void* dst,
              const void* ntype, const void* w0, const void* b0, const void* a,
              const void* b, void* out, int G, int E, int N, int D, int F,
              int n_rel, int n_ntype, cudaStream_t stream) {
  const long long n_edges = (long long)G * E;
  if (n_edges == 0) return (int)cudaSuccess;
  const int smem = eh_w0_bytes(F, D) + eh_u_bytes(D, n_ntype);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_hidden_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_hidden_tc_kernel,
                                                EHF_THREADS, smem);
  const long long wave =
      (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int warps = EHF_THREADS / 32;
  const long long want = ((n_edges + EH_TILE - 1) / EH_TILE + warps - 1) / warps;
  const unsigned blocks = (unsigned)(want < wave ? want : wave);
  edge_hidden_tc_kernel<<<blocks, EHF_THREADS, smem, stream>>>(
      (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)ntype, (const float*)w0, (const float*)b0,
      (const float*)a, (const float*)b, (bf16*)out, n_edges, E, N, D, F, n_rel,
      n_ntype);
  return (int)cudaSuccess;
}

// route 1, backward: the packed rows and masks, n_blocks persistent blocks,
// then the partials' sum
template <int NT>
int launch_bwd_tc(const void* etype, const void* src, const void* dst,
                  const void* ntype, const void* w0, const void* b0,
                  const void* a, const void* b, const void* dh, void* part,
                  void* rows, void* out, int G, int E, int N, int D, int F,
                  int n_rel, int n_ntype, int n_blocks, cudaStream_t stream) {
  const int smem = ehb_smem_bytes(F, D, n_ntype);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_hidden_bwd_tc_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_edges = (long long)G * E;
  const long long n_pad = (n_edges + EH_TILE - 1) / EH_TILE * EH_TILE;
  uint2* masks = (uint2*)((int*)rows + n_pad);
  edge_rows_kernel<<<(unsigned)((n_pad + 255) / 256), 256, 0, stream>>>(
      (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)ntype, (int*)rows, masks, n_edges, n_pad, E, N, n_rel,
      n_ntype);
  edge_hidden_bwd_tc_kernel<NT><<<n_blocks, (D + 15) / 16 * 32, smem,
                                  stream>>>(
      (const int*)rows, masks, (const float*)w0, (const float*)b0,
      (const float*)a, (const float*)b, (const bf16*)dh, (float*)part,
      n_edges, D, F, n_rel, n_ntype);
  const int n = (F + 3) * D;
  reduce_partials_kernel<<<(n + 31) / 32, dim3(32, 8), 0, stream>>>(
      (const float*)part, (float*)out, n_blocks, n);
  return (int)cudaSuccess;
}

// what route 1 takes: bf16, D % 8 == 0, D <= 256, F <= 64, a type table of
// at most EH_MAX_U floats, 16-byte rows
bool tc_fits(int dtype, int D, int n_rel, int n_ntype, uintptr_t ptrs) {
  return dtype == 1 && D % 8 == 0 && D > 0 && D <= EH_MAX_D &&
         n_rel + 2 * n_ntype <= EH_MAX_F && n_ntype * n_ntype * D <= EH_MAX_U &&
         ptrs % 16 == 0;
}

}  // namespace

// dtype: 0 = float32 output, 1 = bfloat16 output. route: 0 = the CUDA-core
// kernel, 1 = edge_hidden_tc_kernel (see tc_fits).
extern "C" int edge_hidden_launch(const void* etype, const void* src,
                                  const void* dst, const void* ntype,
                                  const void* w0, const void* b0,
                                  const void* a, const void* b, void* out,
                                  int G, int E, int N, int D, int n_rel,
                                  int n_ntype, int dtype, int route,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t ptrs = (uintptr_t)w0 | (uintptr_t)b0 | (uintptr_t)a |
                         (uintptr_t)b | (uintptr_t)out;
  if (route == 1) {
    if (!tc_fits(dtype, D, n_rel, n_ntype, ptrs))
      return (int)cudaErrorInvalidValue;
    const int err = launch_tc(etype, src, dst, ntype, w0, b0, a, b, out, G, E,
                              N, D, n_rel + 2 * n_ntype, n_rel, n_ntype, s);
    return err != 0 ? err : (int)cudaGetLastError();
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  // the vector paths need 16-byte aligned rows
  const bool aligned = ptrs % 16 == 0;
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

// dh: (G, E, D) in the forward's output dtype (dtype as above). part is
// scratch, (n_blocks, F + 3, D) f32; out (F + 3, D) f32 receives dW0 (F, D),
// then db0, da, db. route as above; on route 1 n_blocks is the number of
// persistent blocks (one an SM at most) and rows scratch of 3 int32 for each
// of G * E slots rounded up to a multiple of 16 (unused on route 0).
extern "C" int edge_hidden_bwd_launch(const void* etype, const void* src,
                                      const void* dst, const void* ntype,
                                      const void* w0, const void* b0,
                                      const void* a, const void* b,
                                      const void* dh, void* part, void* rows,
                                      void* out,
                                      int G, int E, int N, int D, int F,
                                      int n_rel, int n_ntype, int n_blocks,
                                      int dtype, int route, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)G * E == 0 || F != n_rel + 2 * n_ntype || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  int err;
  if (route == 1) {
    const uintptr_t ptrs = (uintptr_t)w0 | (uintptr_t)b0 | (uintptr_t)a |
                           (uintptr_t)b | (uintptr_t)dh | (uintptr_t)rows;
    if (!tc_fits(dtype, D, n_rel, n_ntype, ptrs))
      return (int)cudaErrorInvalidValue;
    const int nt = (F + 15) / 16 * 2;          // 8-column tiles, even
    auto go = [&](auto launcher) {
      return launcher(etype, src, dst, ntype, w0, b0, a, b, dh, part, rows,
                      out, G, E, N, D, F, n_rel, n_ntype, n_blocks, s);
    };
    err = nt <= 2   ? go(launch_bwd_tc<2>)
          : nt <= 4 ? go(launch_bwd_tc<4>)
          : nt <= 6 ? go(launch_bwd_tc<6>)
                    : go(launch_bwd_tc<8>);
  } else if (route == 0) {
    err = dtype == 1
              ? launch_bwd<__nv_bfloat16>(etype, src, dst, ntype, w0, b0, a,
                                          b, dh, part, out, G, E, N, D, F,
                                          n_rel, n_ntype, n_blocks, s)
              : launch_bwd<float>(etype, src, dst, ntype, w0, b0, a, b, dh,
                                  part, out, G, E, N, D, F, n_rel, n_ntype,
                                  n_blocks, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
