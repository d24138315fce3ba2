// The unprojected relational GAT op, forward and backward: the per-edge key
// and message biases ekb, emb (G, E, HD) arrive precomputed, so no kernel
// here holds a matrix product. Edges are batched per graph, (G, E) with local
// node indices and a mask; heads are head-major (feature h * dph + j).
//
// Replaces the TPU kernels of qagnn_tpu/ops/pallas_gat.py
//   `_scores_kernel` (:331, via `_fwd_impl` :421) -> gat_unproj_scores
//   `_denom_kernel`  (:346, via `_fwd_impl` :445) -> gat_unproj_denoms
//   `_aggr_kernel`   (:373, via `_fwd_impl` :460) -> gat_unproj_aggr
//   `_bwd1_kernel`   (:481, via `_bwd_impl` :589) -> gat_unproj_bwd1
//   `_bwd2_kernel`   (:517, via `_bwd_impl` :617) -> gat_unproj_bwd2
//
// scores: s[g, h, e] = sum over head h of nq[src] * (nk[dst] + ekb[e]) and
//   the max over masked edges per (graph, head) by an atomic max on the
//   float; a masked slot's score is written as 0 and enters no max.
// denoms, once the torch glue has folded the self-loop scores into gmax:
//   e = exp(min(s - gmax, 0)) over masked edges, 0 elsewhere, WRITTEN as
//   e_edge (G, H, E) (the backward reads it; the projected op recomputes it
//   from the scores instead); denom[src] += e and deg[src] += 1 by atomicAdd.
// aggr: out[dst] += round(e * scale[src] * (nm[src] + emb[e])) over masked
//   edges by 16-byte atomicAdd into the f32 accumulator that the caller
//   seeded with the self-loop term; the weighted message is rounded to the
//   compute dtype first, as on the TPU.
// bwd1, g being the output cotangent in the compute dtype:
//   d_msg = e * scale[src] * g[dst], written as demb for EVERY slot (zeros
//   where masked); dnm[src] += round(d_msg); d_alpha = sum over the head of
//   (nm[src] + emb[e]) * g[dst] (0 where masked); dscale[src] += d_alpha * e.
// bwd2: d_s = (d_alpha * scale[src] + d_denom[src]) * e;
//   dekb = d_s * nq[src], written for every slot (zeros where masked);
//   dnq[src] += round(d_s * (nk[dst] + ekb[e])); dnk[dst] += round(dekb).
// The node accumulators dnm, dscale, dnq, dnk arrive seeded with the
// self-loop cotangents.
//
// The TPU kernels gather and scatter by one-hot products and sum heads by a
// selector product because the MXU is what that machine has; here a gather is
// an indexed 16-byte load, a head sum a warp reduction, a scatter an atomic.
//
// Bound on the H100: bytes. Each pass reads or writes one or two (G, E, HD)
// arrays once (105 MB each at G=64, E=4096, HD=200 in bf16) beside node
// arrays that stay in L2, and does a few operations per element. The node
// rows are gathered and the f32 rows scattered per edge, though, so the
// traffic on the L2 side is several times the bytes from device memory, and
// that is what the passes' times follow in this version. Design: a
// block takes UE = 32 consecutive edges of one graph, a warp one edge at a
// time, a lane 8 consecutive columns (one 16-byte load in bf16, two in f32;
// 25 lanes carry HD = 200). The per-head sums are warp shuffles over
// per-lane partials selected by the column's head, so a lane's columns may
// straddle heads and any head width works. The head-major (G, H, E) arrays
// (scores, e_edge, d_alpha) are staged through shared memory so that a block
// reads and writes them as runs of 32 consecutive floats per head.
#include "gat_common.cuh"

namespace {

constexpr int UE = 32;                  // edges per block
constexpr int UWARPS = 8;               // warps per block
constexpr int UTHREADS = 32 * UWARPS;
constexpr unsigned FULL = 0xffffffffu;

// sums[h] = the warp's total of the products p[j] whose column lies in head
// h, at every lane. Lanes past HD hand in zeros.
__device__ __forceinline__ void warp_head_sums(const float p[8],
                                               const int head[8], int H,
                                               float sums[MAX_H]) {
#pragma unroll
  for (int h = 0; h < MAX_H; ++h) {
    float v = 0.0f;
    if (h < H) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v += head[j] == h ? p[j] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    }
    sums[h] = v;
  }
}

// lane 0 files the warp's per-head sums of edge `el` head-major
__device__ __forceinline__ void file_head_sums(float (*s_out)[UE], int el,
                                               const float sums[MAX_H],
                                               int H) {
#pragma unroll
  for (int h = 0; h < MAX_H; ++h)
    if (h < H) s_out[h][el] = sums[h];
}

template <typename T>
__global__ void __launch_bounds__(UTHREADS)
scores_kernel(const T* __restrict__ nq, const T* __restrict__ nk,
              const T* __restrict__ ekb, const int32_t* __restrict__ src,
              const int32_t* __restrict__ dst,
              const uint8_t* __restrict__ mask, float* __restrict__ scores,
              float* __restrict__ m_edge, int E, int N, int HD, int H) {
  __shared__ float s_sc[MAX_H][UE];
  __shared__ float s_max[MAX_H];
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * UE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = 8 * lane, dph = HD / H;
  int head[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) head[j] = (c0 + j) / dph;
  if (tid < MAX_H) s_max[tid] = NEG;

  for (int el = warp; el < UE; el += UWARPS) {
    const int e = e0 + el;
    float sums[MAX_H];
#pragma unroll
    for (int h = 0; h < MAX_H; ++h) sums[h] = 0.0f;
    if (e < E && mask[g * E + e]) {        // uniform over the warp
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = 0.0f;
      if (c0 < HD) {
        float q[8], k[8], b[8];
        load_row<T, 8>(nq + (g * N + src[g * E + e]) * HD + c0, q);
        load_row<T, 8>(nk + (g * N + dst[g * E + e]) * HD + c0, k);
        load_row<T, 8>(ekb + (g * E + e) * HD + c0, b);
#pragma unroll
        for (int j = 0; j < 8; ++j) p[j] = q[j] * (k[j] + b[j]);
      }
      warp_head_sums(p, head, H, sums);
    }
    if (lane == 0) file_head_sums(s_sc, el, sums, H);
  }
  __syncthreads();
  for (int idx = tid; idx < H * UE; idx += UTHREADS) {
    const int h = idx / UE, el = idx % UE, e = e0 + el;
    if (e >= E) continue;
    const float v = s_sc[h][el];
    scores[(g * H + h) * E + e] = v;
    if (mask[g * E + e]) atomic_max_float(&s_max[h], v);
  }
  __syncthreads();
  if (tid < H && s_max[tid] > NEG)
    atomic_max_float(&m_edge[g * H + tid], s_max[tid]);
}

__global__ void denoms_kernel(const float* __restrict__ scores,
                              const float* __restrict__ gmax,
                              const int32_t* __restrict__ src,
                              const uint8_t* __restrict__ mask,
                              float* __restrict__ e_edge,
                              float* __restrict__ denom,
                              float* __restrict__ deg, long long n_edges,
                              int E, int N, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_edges) return;
  const long long g = i / E;
  const int e = (int)(i % E);
  const bool live = mask[i];
  const long long node = live ? g * N + src[i] : 0;
  for (int h = 0; h < H; ++h) {
    float v = 0.0f;
    if (live) {
      v = expf(fminf(scores[(g * H + h) * E + e] - gmax[g * H + h], 0.0f));
      atomicAdd(&denom[node * H + h], v);
    }
    e_edge[(g * H + h) * E + e] = v;
  }
  if (live) atomicAdd(&deg[node], 1.0f);
}

template <typename T>
__global__ void __launch_bounds__(UTHREADS)
aggr_kernel(const T* __restrict__ nm, const T* __restrict__ emb,
            const float* __restrict__ e_edge, const float* __restrict__ scale,
            const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
            const uint8_t* __restrict__ mask, float* __restrict__ out, int E,
            int N, int HD, int H) {
  __shared__ float s_alpha[UE][MAX_H];
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * UE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = 8 * lane, dph = HD / H;

  // alpha per (edge, head); 0 for masked and padded slots
  for (int idx = tid; idx < H * UE; idx += UTHREADS) {
    const int h = idx / UE, el = idx % UE, e = e0 + el;
    float a = 0.0f;
    if (e < E && mask[g * E + e])
      a = e_edge[(g * H + h) * E + e] *
          scale[(g * N + src[g * E + e]) * H + h];
    s_alpha[el][h] = a;
  }
  __syncthreads();
  if (c0 >= HD) return;
  int head[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) head[j] = (c0 + j) / dph;
  for (int el = warp; el < UE; el += UWARPS) {
    const int e = e0 + el;
    if (e >= E || !mask[g * E + e]) continue;
    float m[8], b[8], v[8];
    load_row<T, 8>(nm + (g * N + src[g * E + e]) * HD + c0, m);
    load_row<T, 8>(emb + (g * E + e) * HD + c0, b);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = round_to<T>(s_alpha[el][head[j]] * (m[j] + b[j]));
    float* row = out + (g * N + dst[g * E + e]) * HD + c0;
    atomicAdd(reinterpret_cast<float4*>(row),
              make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(reinterpret_cast<float4*>(row + 4),
              make_float4(v[4], v[5], v[6], v[7]));
  }
}

template <typename T>
__global__ void __launch_bounds__(UTHREADS)
bwd1_kernel(const T* __restrict__ gout, const T* __restrict__ nm,
            const T* __restrict__ emb, const float* __restrict__ e_edge,
            const float* __restrict__ scale, const int32_t* __restrict__ src,
            const int32_t* __restrict__ dst, const uint8_t* __restrict__ mask,
            T* __restrict__ demb, float* __restrict__ dalpha,
            float* __restrict__ dscale, float* __restrict__ dnm, int E, int N,
            int HD, int H) {
  __shared__ float s_e[UE][MAX_H];
  __shared__ float s_alpha[UE][MAX_H];
  __shared__ float s_da[MAX_H][UE];
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * UE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = 8 * lane, dph = HD / H;
  int head[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) head[j] = (c0 + j) / dph;

  // e and alpha per (edge, head); 0 for masked and padded slots
  for (int idx = tid; idx < H * UE; idx += UTHREADS) {
    const int h = idx / UE, el = idx % UE, e = e0 + el;
    float ee = 0.0f, a = 0.0f;
    if (e < E && mask[g * E + e]) {
      ee = e_edge[(g * H + h) * E + e];
      a = ee * scale[(g * N + src[g * E + e]) * H + h];
    }
    s_e[el][h] = ee;
    s_alpha[el][h] = a;
  }
  __syncthreads();

  for (int el = warp; el < UE; el += UWARPS) {
    const int e = e0 + el;
    if (e >= E) continue;                  // uniform over the warp
    float sums[MAX_H], dm[8];
#pragma unroll
    for (int h = 0; h < MAX_H; ++h) sums[h] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) dm[j] = 0.0f;
    if (mask[g * E + e]) {                 // uniform over the warp
      float p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = 0.0f;
      if (c0 < HD) {
        const long long s_row = (g * N + src[g * E + e]) * HD + c0;
        float m[8], b[8], gd[8];
        load_row<T, 8>(nm + s_row, m);
        load_row<T, 8>(emb + (g * E + e) * HD + c0, b);
        load_row<T, 8>(gout + (g * N + dst[g * E + e]) * HD + c0, gd);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p[j] = (m[j] + b[j]) * gd[j];
          dm[j] = round_to<T>(s_alpha[el][head[j]] * gd[j]);
        }
        atomicAdd(reinterpret_cast<float4*>(dnm + s_row),
                  make_float4(dm[0], dm[1], dm[2], dm[3]));
        atomicAdd(reinterpret_cast<float4*>(dnm + s_row + 4),
                  make_float4(dm[4], dm[5], dm[6], dm[7]));
      }
      warp_head_sums(p, head, H, sums);
    }
    if (c0 < HD) {
      T* row = demb + (g * E + e) * HD + c0;
      store_row4<T>(row, dm);
      store_row4<T>(row + 4, dm + 4);
    }
    if (lane == 0) file_head_sums(s_da, el, sums, H);
  }
  __syncthreads();
  for (int idx = tid; idx < H * UE; idx += UTHREADS) {
    const int h = idx / UE, el = idx % UE, e = e0 + el;
    if (e >= E) continue;
    const float v = s_da[h][el];
    dalpha[(g * H + h) * E + e] = v;
    if (mask[g * E + e])
      atomicAdd(&dscale[(g * N + src[g * E + e]) * H + h], v * s_e[el][h]);
  }
}

template <typename T>
__global__ void __launch_bounds__(UTHREADS)
bwd2_kernel(const T* __restrict__ nq, const T* __restrict__ nk,
            const T* __restrict__ ekb, const float* __restrict__ e_edge,
            const float* __restrict__ dalpha, const float* __restrict__ scale,
            const float* __restrict__ d_denom,
            const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
            const uint8_t* __restrict__ mask, T* __restrict__ dekb,
            float* __restrict__ dnq, float* __restrict__ dnk, int E, int N,
            int HD, int H) {
  __shared__ float s_ds[UE][MAX_H];
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * UE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = 8 * lane, dph = HD / H;

  // d_s per (edge, head); 0 for masked and padded slots
  for (int idx = tid; idx < H * UE; idx += UTHREADS) {
    const int h = idx / UE, el = idx % UE, e = e0 + el;
    float ds = 0.0f;
    if (e < E && mask[g * E + e]) {
      const long long node = (g * N + src[g * E + e]) * H + h;
      const long long ghe = (g * H + h) * E + e;
      ds = (dalpha[ghe] * scale[node] + d_denom[node]) * e_edge[ghe];
    }
    s_ds[el][h] = ds;
  }
  __syncthreads();
  if (c0 >= HD) return;
  int head[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) head[j] = (c0 + j) / dph;
  for (int el = warp; el < UE; el += UWARPS) {
    const int e = e0 + el;
    if (e >= E) continue;
    float dk[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[j] = 0.0f;
    if (mask[g * E + e]) {
      const long long s_row = (g * N + src[g * E + e]) * HD + c0;
      const long long d_row = (g * N + dst[g * E + e]) * HD + c0;
      float q[8], k[8], b[8], dq[8];
      load_row<T, 8>(nq + s_row, q);
      load_row<T, 8>(nk + d_row, k);
      load_row<T, 8>(ekb + (g * E + e) * HD + c0, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ds = s_ds[el][head[j]];
        dk[j] = round_to<T>(ds * q[j]);
        dq[j] = round_to<T>(ds * (k[j] + b[j]));
      }
      atomicAdd(reinterpret_cast<float4*>(dnq + s_row),
                make_float4(dq[0], dq[1], dq[2], dq[3]));
      atomicAdd(reinterpret_cast<float4*>(dnq + s_row + 4),
                make_float4(dq[4], dq[5], dq[6], dq[7]));
      atomicAdd(reinterpret_cast<float4*>(dnk + d_row),
                make_float4(dk[0], dk[1], dk[2], dk[3]));
      atomicAdd(reinterpret_cast<float4*>(dnk + d_row + 4),
                make_float4(dk[4], dk[5], dk[6], dk[7]));
    }
    T* row = dekb + (g * E + e) * HD + c0;
    store_row4<T>(row, dk);
    store_row4<T>(row + 4, dk + 4);
  }
}

bool shapes_ok(int HD, int H) {
  return HD > 0 && HD % 8 == 0 && HD <= MAX_HD && H > 0 && H <= MAX_H &&
         HD % H == 0;
}

dim3 edge_grid(int G, int E) { return dim3((E + UE - 1) / UE, G); }

}  // namespace

// dtype: 0 = float32 node and edge arrays, 1 = bfloat16. All take
// HD % 8 == 0, HD <= 256, H <= 8 dividing HD, and 16-byte aligned arrays.

// m_edge (G, H) arrives filled with -1e30.
extern "C" int gat_unproj_scores(const void* nq, const void* nk,
                                 const void* ekb, const void* src,
                                 const void* dst, const void* mask,
                                 void* scores, void* m_edge, int G, int N,
                                 int E, int HD, int H, int dtype,
                                 void* stream) {
  if (!shapes_ok(HD, H) || !aligned16(nq) || !aligned16(nk) ||
      !aligned16(ekb))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    scores_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const int32_t*)src,
        (const int32_t*)dst, (const uint8_t*)mask, (float*)scores,
        (float*)m_edge, E, N, HD, H);
  } else {
    typedef float T;
    scores_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const int32_t*)src,
        (const int32_t*)dst, (const uint8_t*)mask, (float*)scores,
        (float*)m_edge, E, N, HD, H);
  }
  return (int)cudaGetLastError();
}

// denom (G, N, H) and deg (G, N) arrive zeroed; e_edge (G, H, E) is written
// whole.
extern "C" int gat_unproj_denoms(const void* scores, const void* gmax,
                                 const void* src, const void* mask,
                                 void* e_edge, void* denom, void* deg, int G,
                                 int N, int E, int H, void* stream) {
  const long long n_edges = (long long)G * E;
  if (n_edges == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_edges + threads - 1) / threads);
  denoms_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)gmax, (const int32_t*)src,
      (const uint8_t*)mask, (float*)e_edge, (float*)denom, (float*)deg,
      n_edges, E, N, H);
  return (int)cudaGetLastError();
}

// out (G, N, HD) f32 arrives seeded and is added to in place.
extern "C" int gat_unproj_aggr(const void* nm, const void* emb,
                               const void* e_edge, const void* scale,
                               const void* src, const void* dst,
                               const void* mask, void* out, int G, int N,
                               int E, int HD, int H, int dtype,
                               void* stream) {
  if (!shapes_ok(HD, H) || !aligned16(nm) || !aligned16(emb) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    aggr_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (float*)out, E, N, HD, H);
  } else {
    typedef float T;
    aggr_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (float*)out, E, N, HD, H);
  }
  return (int)cudaGetLastError();
}

// demb (G, E, HD) and dalpha (G, H, E) are written whole; dscale (G, N, H)
// and dnm (G, N, HD) f32 arrive seeded and are added to in place.
extern "C" int gat_unproj_bwd1(const void* gout, const void* nm,
                               const void* emb, const void* e_edge,
                               const void* scale, const void* src,
                               const void* dst, const void* mask, void* demb,
                               void* dalpha, void* dscale, void* dnm, int G,
                               int N, int E, int HD, int H, int dtype,
                               void* stream) {
  if (!shapes_ok(HD, H) || !aligned16(gout) || !aligned16(nm) ||
      !aligned16(emb) || !aligned16(demb) || !aligned16(dnm))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    bwd1_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)gout, (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (T*)demb, (float*)dalpha, (float*)dscale,
        (float*)dnm, E, N, HD, H);
  } else {
    typedef float T;
    bwd1_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)gout, (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (T*)demb, (float*)dalpha, (float*)dscale,
        (float*)dnm, E, N, HD, H);
  }
  return (int)cudaGetLastError();
}

// dekb (G, E, HD) is written whole; dnq and dnk (G, N, HD) f32 arrive seeded
// and are added to in place.
extern "C" int gat_unproj_bwd2(const void* nq, const void* nk,
                               const void* ekb, const void* e_edge,
                               const void* dalpha, const void* scale,
                               const void* d_denom, const void* src,
                               const void* dst, const void* mask, void* dekb,
                               void* dnq, void* dnk, int G, int N, int E,
                               int HD, int H, int dtype, void* stream) {
  if (!shapes_ok(HD, H) || !aligned16(nq) || !aligned16(nk) ||
      !aligned16(ekb) || !aligned16(dekb) || !aligned16(dnq) ||
      !aligned16(dnk))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    bwd2_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const float*)e_edge,
        (const float*)dalpha, (const float*)scale, (const float*)d_denom,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (T*)dekb, (float*)dnq, (float*)dnk, E, N, HD, H);
  } else {
    typedef float T;
    bwd2_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const float*)e_edge,
        (const float*)dalpha, (const float*)scale, (const float*)d_denom,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (T*)dekb, (float*)dnq, (float*)dnk, E, N, HD, H);
  }
  return (int)cudaGetLastError();
}
