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
// Two routes behind each entry point: route 1, bf16 and f32 at every width
// with F <= 64 (tc_fits), runs the kernels of edge_hidden_tc.cuh; route 0 the
// kernels below, for F > 64 and to be timed beside route 1. Both run D's
// columns as slices of `width` columns (the wrapper's plan), each reading and
// writing its columns in place at the rows' stride D.
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

// blockDim = (cols / VEC, rows): thread x owns columns [x*VEC, x*VEC + VEC)
// of every edge its row visits, so b0, a and b are loaded once per thread.
// w0, b0, a, b and out point at the slice's first column; rows of w0 and
// out are D apart.
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
           const void* ntype, const float* w0, const float* b0,
           const float* a, const float* b, T* out, int G, int E, int N, int D,
           int cols, int n_rel, int n_ntype, cudaStream_t stream) {
  const long long n_edges = (long long)G * E;
  const int chunks = cols / VEC;
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
      (const int32_t*)ntype, w0, b0, a, b, out, n_edges, E, N, D, n_rel,
      n_ntype);
  return (int)cudaSuccess;
}

// route 0, forward: a launch a slice of `width` columns (a multiple of VEC)
template <typename T, int VEC>
int launch_slices(const void* etype, const void* src, const void* dst,
                  const void* ntype, const void* w0, const void* b0,
                  const void* a, const void* b, void* out, int G, int E,
                  int N, int D, int width, int n_rel, int n_ntype,
                  cudaStream_t stream) {
  if (width % VEC != 0) return (int)cudaErrorInvalidValue;
  for (int c0 = 0; c0 < D; c0 += width) {
    const int err = launch<T, VEC>(
        etype, src, dst, ntype, (const float*)w0 + c0, (const float*)b0 + c0,
        (const float*)a + c0, (const float*)b + c0, (T*)out + c0, G, E, N, D,
        min(width, D - c0), n_rel, n_ntype, stream);
    if (err != 0) return err;
  }
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
// once (105 MB in bf16, 32 us). A launch takes a slice of `cols` columns: w0,
// b0, a, b, dh and part point at its first one, and rows of w0, dh and each
// block's partials are D apart.
constexpr int BWD_TILE = 128;      // slots whose feature rows are staged at once

template <typename T>
__global__ void edge_hidden_bwd_kernel(
    const int32_t* __restrict__ etype, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ ntype,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ a, const float* __restrict__ b,
    const T* __restrict__ dh, float* __restrict__ part, long long n_edges,
    long long chunk, int E, int N, int D, int cols, int F, int n_rel,
    int n_ntype) {
  extern __shared__ float s_dw0[];                 // (F, cols)
  __shared__ int s_rows[3][BWD_TILE];
  for (int i = threadIdx.x; i < F * cols; i += blockDim.x) s_dw0[i] = 0.0f;
  const long long begin = blockIdx.x * chunk;
  const long long end = begin + chunk < n_edges ? begin + chunk : n_edges;
  const int c = threadIdx.x;
  const bool live = c < cols;
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
      if (r0 >= 0) s_dw0[r0 * cols + c] += dxc;
      s_dw0[r1 * cols + c] += dxc;
      s_dw0[r2 * cols + c] += dxc;
    }
  }
  __syncthreads();                 // a block with no slots still zeroed s_dw0
  if (!live) return;
  float* row = part + (long long)blockIdx.x * (F + 3) * D;
  for (int f = 0; f < F; ++f) row[(long long)f * D + c] = s_dw0[f * cols + c];
  row[(long long)F * D + c] = db0;
  row[(long long)(F + 1) * D + c] = da;
  row[(long long)(F + 2) * D + c] = db;
}

// route 0, backward: a launch a slice of `width` columns, then the sum of
// the partials of all of D
template <typename T>
int launch_bwd(const void* etype, const void* src, const void* dst,
               const void* ntype, const void* w0, const void* b0,
               const void* a, const void* b, const void* dh, void* part,
               void* out, int G, int E, int N, int D, int F, int n_rel,
               int n_ntype, int n_blocks, int width, cudaStream_t stream) {
  const long long n_edges = (long long)G * E;
  const size_t smem = sizeof(float) * F * width;
  if (n_blocks <= 0 || width > 1024 || smem > 200 * 1024)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_hidden_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long chunk = (n_edges + n_blocks - 1) / n_blocks;
  for (int c0 = 0; c0 < D; c0 += width) {
    const int cols = min(width, D - c0);
    edge_hidden_bwd_kernel<T><<<n_blocks, (cols + 31) / 32 * 32,
                                sizeof(float) * F * cols, stream>>>(
        (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
        (const int32_t*)ntype, (const float*)w0 + c0, (const float*)b0 + c0,
        (const float*)a + c0, (const float*)b + c0, (const T*)dh + c0,
        (float*)part + c0, n_edges, chunk, E, N, D, cols, F, n_rel, n_ntype);
  }
  const int n = (F + 3) * D;
  reduce_partials_kernel<<<(n + 31) / 32, dim3(32, 8), 0, stream>>>(
      (const float*)part, (float*)out, n_blocks, n);
  return (int)cudaSuccess;
}

// route 1, forward: one wave of resident blocks over the slices of `width`
// columns, a warp for every tile of a slice at most
template <typename T, int PIECE, bool WINDOWS>
int launch_tc(const void* etype, const void* src, const void* dst,
              const void* ntype, const void* w0, const void* b0, const void* a,
              const void* b, void* out, int G, int E, int N, int D, int F,
              int n_rel, int n_ntype, int width, cudaStream_t stream) {
  const long long n_edges = (long long)G * E;
  if (n_edges == 0) return (int)cudaSuccess;
  const int smem = eh_tables_bytes<T>(F, eh_round8(width), n_ntype);
  if (smem > EH_FWD_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_hidden_tc_kernel<T, PIECE, WINDOWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, edge_hidden_tc_kernel<T, PIECE, WINDOWS>, EHF_THREADS, smem);
  const int n_slices = (D + width - 1) / width;
  const long long wave =
      (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1) / n_slices;
  const int warps = EHF_THREADS / 32;
  const long long want = ((n_edges + EH_TILE - 1) / EH_TILE + warps - 1) / warps;
  const unsigned blocks =
      (unsigned)(want < wave ? want : wave > 0 ? wave : 1);
  edge_hidden_tc_kernel<T, PIECE, WINDOWS>
      <<<dim3(blocks, n_slices), EHF_THREADS, smem, stream>>>(
      (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)ntype, (const float*)w0, (const float*)b0,
      (const float*)a, (const float*)b, (T*)out, n_edges, E, N, D, F, n_rel,
      n_ntype, width);
  return (int)cudaSuccess;
}

// route 1, backward: the packed rows and masks once, n_blocks persistent
// blocks for each slice of `width` columns, then the partials' sum
template <typename T, int NT, int PIECE>
int launch_bwd_tc(const void* etype, const void* src, const void* dst,
                  const void* ntype, const void* w0, const void* b0,
                  const void* a, const void* b, const void* dh, void* part,
                  void* rows, void* out, int G, int E, int N, int D, int F,
                  int n_rel, int n_ntype, int n_blocks, int width,
                  cudaStream_t stream) {
  const int smem = ehb_smem_bytes<T>(F, width, n_ntype);
  if (smem > EH_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_hidden_bwd_tc_kernel<T, NT, PIECE>,
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
  edge_hidden_bwd_tc_kernel<T, NT, PIECE>
      <<<dim3(n_blocks, (D + width - 1) / width), (width + 15) / 16 * 32, smem,
         stream>>>(
      (const int*)rows, masks, (const float*)w0, (const float*)b0,
      (const float*)a, (const float*)b, (const T*)dh, (float*)part, n_edges,
      D, F, n_rel, n_ntype, width);
  const int n = (F + 3) * D;
  reduce_partials_kernel<<<(n + 31) / 32, dim3(32, 8), 0, stream>>>(
      (const float*)part, (float*)out, n_blocks, n);
  return (int)cudaSuccess;
}

template <int P> struct Piece { static constexpr int value = P; };

// f(Piece<eh_piece(D, sizeof(T))>()): the template of the rows' piece size
template <typename T, typename Fn>
int by_piece(int D, Fn f) {
  switch (eh_piece(D, (int)sizeof(T))) {
    case 16: return f(Piece<16>());
    case 8: return f(Piece<8>());
    case 4: return f(Piece<4>());
    default:
      if constexpr (sizeof(T) == 2) return f(Piece<2>());
      return (int)cudaErrorInvalidValue;
  }
}

// what route 1 takes: bf16 or f32, F <= 64, 16-byte aligned w0, b0, a, b
// and h / dh, slices of a multiple of 8 columns (16 in the backward, at most
// EH_BWD_COLS) or one slice of all of D
bool tc_fits(int dtype, int D, int F, int width, int mult, uintptr_t ptrs) {
  return (dtype == 0 || dtype == 1) && D > 0 && F <= EH_MAX_F &&
         width > 0 && (width % mult == 0 || width >= D) && ptrs % 16 == 0;
}

}  // namespace

// dtype: 0 = float32 output, 1 = bfloat16 output. route: 0 = the CUDA-core
// kernel, 1 = edge_hidden_tc_kernel (see tc_fits). width: the columns of a
// slice of D (every slice but the last): on route 0 at most 1024 vectors, a
// multiple of the vector; on route 1 a multiple of 8 whose tables fit.
extern "C" int edge_hidden_launch(const void* etype, const void* src,
                                  const void* dst, const void* ntype,
                                  const void* w0, const void* b0,
                                  const void* a, const void* b, void* out,
                                  int G, int E, int N, int D, int n_rel,
                                  int n_ntype, int dtype, int route,
                                  int width, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t ptrs = (uintptr_t)w0 | (uintptr_t)b0 | (uintptr_t)a |
                         (uintptr_t)b | (uintptr_t)out;
  const int F = n_rel + 2 * n_ntype;
  if (width <= 0) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (!tc_fits(dtype, D, F, width, 8, ptrs))
      return (int)cudaErrorInvalidValue;
    // more than 32 chunks of 16 bytes to a row of the widest slice
    const bool windows = width * (dtype == 1 ? 2 : 4) > 32 * 16;
    auto go = [&](auto t, auto piece) {
      constexpr int P = decltype(piece)::value;
      auto launch = [&](auto launcher) {
        return launcher(etype, src, dst, ntype, w0, b0, a, b, out, G, E, N, D,
                        F, n_rel, n_ntype, width, s);
      };
      return windows ? launch(launch_tc<decltype(t), P, true>)
                     : launch(launch_tc<decltype(t), P, false>);
    };
    const int err =
        dtype == 1
            ? by_piece<bf16>(D, [&](auto piece) { return go(bf16(), piece); })
            : by_piece<float>(D, [&](auto piece) { return go(0.0f, piece); });
    return err != 0 ? err : (int)cudaGetLastError();
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  // the vector paths need 16-byte aligned rows
  const bool aligned = ptrs % 16 == 0;
  int err;
  if (dtype == 1)
    err = aligned && D % 8 == 0
              ? launch_slices<__nv_bfloat16, 8>(etype, src, dst, ntype, w0,
                                                b0, a, b, out, G, E, N, D,
                                                width, n_rel, n_ntype, s)
              : launch_slices<__nv_bfloat16, 1>(etype, src, dst, ntype, w0,
                                                b0, a, b, out, G, E, N, D,
                                                width, n_rel, n_ntype, s);
  else
    err = aligned && D % 4 == 0
              ? launch_slices<float, 4>(etype, src, dst, ntype, w0, b0, a, b,
                                        out, G, E, N, D, width, n_rel,
                                        n_ntype, s)
              : launch_slices<float, 1>(etype, src, dst, ntype, w0, b0, a, b,
                                        out, G, E, N, D, width, n_rel,
                                        n_ntype, s);
  return err != 0 ? err : (int)cudaGetLastError();
}

// dh: (G, E, D) in the forward's output dtype (dtype as above). part is
// scratch, (n_blocks, F + 3, D) f32; out (F + 3, D) f32 receives dW0 (F, D),
// then db0, da, db. route and width as above (on route 0 at most 1024
// columns and an F x width f32 dW0 in 200 KiB; on route 1 a multiple of 16,
// at most EH_BWD_COLS); on route 1 n_blocks is the number of persistent
// blocks of a slice and rows scratch of 3 int32 for each of G * E slots
// rounded up to a multiple of 16 (unused on route 0).
extern "C" int edge_hidden_bwd_launch(const void* etype, const void* src,
                                      const void* dst, const void* ntype,
                                      const void* w0, const void* b0,
                                      const void* a, const void* b,
                                      const void* dh, void* part, void* rows,
                                      void* out,
                                      int G, int E, int N, int D, int F,
                                      int n_rel, int n_ntype, int n_blocks,
                                      int dtype, int route, int width,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)G * E == 0 || F != n_rel + 2 * n_ntype || n_blocks <= 0 ||
      width <= 0)
    return (int)cudaErrorInvalidValue;
  int err;
  if (route == 1) {
    const uintptr_t ptrs = (uintptr_t)w0 | (uintptr_t)b0 | (uintptr_t)a |
                           (uintptr_t)b | (uintptr_t)dh | (uintptr_t)rows;
    if (!tc_fits(dtype, D, F, width, 16, ptrs) || width > EH_BWD_COLS)
      return (int)cudaErrorInvalidValue;
    const int nt = (F + 15) / 16 * 2;          // 8-column tiles, even
    auto go = [&](auto t, auto piece) {
      using T = decltype(t);
      constexpr int P = decltype(piece)::value;
      auto launch = [&](auto launcher) {
        return launcher(etype, src, dst, ntype, w0, b0, a, b, dh, part, rows,
                        out, G, E, N, D, F, n_rel, n_ntype, n_blocks, width,
                        s);
      };
      return nt <= 2   ? launch(launch_bwd_tc<T, 2, P>)
             : nt <= 4 ? launch(launch_bwd_tc<T, 4, P>)
             : nt <= 6 ? launch(launch_bwd_tc<T, 6, P>)
                       : launch(launch_bwd_tc<T, 8, P>);
    };
    err = dtype == 1
              ? by_piece<bf16>(D, [&](auto piece) { return go(bf16(), piece); })
              : by_piece<float>(D,
                                [&](auto piece) { return go(0.0f, piece); });
  } else if (route == 0) {
    err = dtype == 1
              ? launch_bwd<__nv_bfloat16>(etype, src, dst, ntype, w0, b0, a,
                                          b, dh, part, out, G, E, N, D, F,
                                          n_rel, n_ntype, n_blocks, width, s)
              : launch_bwd<float>(etype, src, dst, ntype, w0, b0, a, b, dh,
                                  part, out, G, E, N, D, F, n_rel, n_ntype,
                                  n_blocks, width, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
