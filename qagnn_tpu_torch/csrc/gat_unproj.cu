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
// Each has two routes: route 0 the kernels just below (a block per 32 slots
// and a warp per edge; denoms a thread per slot), route 1 the kernels further
// down: aggr, bwd1 and bwd2 over each graph's slots sorted by node
// (aggr_graph_kernel, bwd1_graph_kernel, bwd2_graph_kernel, on
// node_sort.cuh), scores a block per range of a graph's live slots
// (scores_range_kernel), denoms a block per graph (denoms_graph_kernel).
//
// scores: s[g, h, e] = sum over head h of nq[src] * (nk[dst] + ekb[e]) and
//   the max over masked edges per (graph, head) by an atomic max on the
//   float; a masked slot's score is written as 0 and enters no max.
// denoms, once the torch glue has folded the self-loop scores into gmax:
//   e = exp(min(s - gmax, 0)) over masked edges, 0 elsewhere, WRITTEN as
//   e_edge (G, H, E) (the backward reads it; the projected op recomputes it
//   from the scores instead); denom[src] += e and deg[src] += 1 (route 0 by
//   global atomicAdd, route 1 in a graph's shared memory).
// aggr: out[dst] += round(e * scale[src] * (nm[src] + emb[e])) over masked
//   edges into the f32 accumulator that the caller seeded with the
//   self-loop term; the weighted message is rounded to the compute dtype
//   first, as on the TPU.
// bwd1, g being the output cotangent in the compute dtype:
//   d_msg = e * scale[src] * g[dst], written as demb for EVERY slot (zeros
//   where masked); dnm[src] += round(d_msg); d_alpha = sum over the head of
//   (nm[src] + emb[e]) * g[dst] (0 where masked); dscale[src] += d_alpha * e.
// bwd2: d_s = (d_alpha * scale[src] + d_denom[src]) * e;
//   dekb = d_s * nq[src], written for every slot (zeros where masked);
//   dnq[src] += round(d_s * (nk[dst] + ekb[e])); dnk[dst] += round(dekb).
// The node accumulators dnm, dscale, dnq, dnk arrive seeded with the
// self-loop cotangents.
// scores and bwd1 sum over a head's columns; a head wider than a launch's
// 256 columns runs as column slices (`part`, gat_common.cuh): each slice
// adds its f32 sums to those the slices before it wrote in the same output,
// and only the last takes the max over the whole scores or adds the whole
// d_alpha * e into dscale. aggr and bwd2 work per column already.
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
// that is what route 0's times follow. Route 0's design: a
// block takes UE = 32 consecutive edges of one graph, a warp one edge at a
// time, a lane 8 consecutive columns (one 16-byte load in bf16, two in f32;
// 25 lanes carry HD = 200). The per-head sums are warp shuffles over
// per-lane partials selected by the column's head, so a lane's columns may
// straddle heads and any head width works. The head-major (G, H, E) arrays
// (scores, e_edge, d_alpha) are staged through shared memory so that a block
// reads and writes them as runs of 32 consecutive floats per head.
#include "node_sort.cuh"

namespace {

constexpr int UE = 32;                  // edges per block
constexpr int UWARPS = 8;               // warps per block
constexpr int UTHREADS = 32 * UWARPS;

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
              float* __restrict__ m_edge, int E, int N, int HD, int H,
              int lq, int lk, int lb, int part) {
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
        load_row<T, 8>(nq + (g * N + src[g * E + e]) * lq + c0, q);
        load_row<T, 8>(nk + (g * N + dst[g * E + e]) * lk + c0, k);
        load_row<T, 8>(ekb + (g * E + e) * lb + c0, b);
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
    float v = s_sc[h][el];
    if (part & PART_ADD) v += scores[(g * H + h) * E + e];
    scores[(g * H + h) * E + e] = v;
    if (!(part & PART_OPEN) && mask[g * E + e])
      atomic_max_float(&s_max[h], v);
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
            int N, int HD, int H, int lm, int lb, int lo) {
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
    load_row<T, 8>(nm + (g * N + src[g * E + e]) * lm + c0, m);
    load_row<T, 8>(emb + (g * E + e) * lb + c0, b);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = round_to<T>(s_alpha[el][head[j]] * (m[j] + b[j]));
    float* row = out + (g * N + dst[g * E + e]) * lo + c0;
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
            int HD, int H, int lg, int lm, int lb, int ld, int ldn,
            int part) {
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
        const long long s_node = g * N + src[g * E + e];
        float* dnm_row = dnm + s_node * ldn + c0;
        float m[8], b[8], gd[8];
        load_row<T, 8>(nm + s_node * lm + c0, m);
        load_row<T, 8>(emb + (g * E + e) * lb + c0, b);
        load_row<T, 8>(gout + (g * N + dst[g * E + e]) * lg + c0, gd);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p[j] = (m[j] + b[j]) * gd[j];
          dm[j] = round_to<T>(s_alpha[el][head[j]] * gd[j]);
        }
        atomicAdd(reinterpret_cast<float4*>(dnm_row),
                  make_float4(dm[0], dm[1], dm[2], dm[3]));
        atomicAdd(reinterpret_cast<float4*>(dnm_row + 4),
                  make_float4(dm[4], dm[5], dm[6], dm[7]));
      }
      warp_head_sums(p, head, H, sums);
    }
    if (c0 < HD) {
      T* row = demb + (g * E + e) * ld + c0;
      store_row4<T>(row, dm);
      store_row4<T>(row + 4, dm + 4);
    }
    if (lane == 0) file_head_sums(s_da, el, sums, H);
  }
  __syncthreads();
  for (int idx = tid; idx < H * UE; idx += UTHREADS) {
    const int h = idx / UE, el = idx % UE, e = e0 + el;
    if (e >= E) continue;
    float v = s_da[h][el];
    if (part & PART_ADD) v += dalpha[(g * H + h) * E + e];
    dalpha[(g * H + h) * E + e] = v;
    if (!(part & PART_OPEN) && mask[g * E + e])
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
            int HD, int H, int lq, int lk, int lb, int lde, int ldq,
            int ldk) {
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
      const long long s_node = g * N + src[g * E + e];
      const long long d_node = g * N + dst[g * E + e];
      float* dq_row = dnq + s_node * ldq + c0;
      float* dk_row = dnk + d_node * ldk + c0;
      float q[8], k[8], b[8], dq[8];
      load_row<T, 8>(nq + s_node * lq + c0, q);
      load_row<T, 8>(nk + d_node * lk + c0, k);
      load_row<T, 8>(ekb + (g * E + e) * lb + c0, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ds = s_ds[el][head[j]];
        dk[j] = round_to<T>(ds * q[j]);
        dq[j] = round_to<T>(ds * (k[j] + b[j]));
      }
      atomicAdd(reinterpret_cast<float4*>(dq_row),
                make_float4(dq[0], dq[1], dq[2], dq[3]));
      atomicAdd(reinterpret_cast<float4*>(dq_row + 4),
                make_float4(dq[4], dq[5], dq[6], dq[7]));
      atomicAdd(reinterpret_cast<float4*>(dk_row),
                make_float4(dk[0], dk[1], dk[2], dk[3]));
      atomicAdd(reinterpret_cast<float4*>(dk_row + 4),
                make_float4(dk[4], dk[5], dk[6], dk[7]));
    }
    T* row = dekb + (g * E + e) * lde + c0;
    store_row4<T>(row, dk);
    store_row4<T>(row + 4, dk + 4);
  }
}

// ---------------------------------------------------------------------------
// bwd2, route 1: a graph's slots grouped by node, its node rows owned.
//
// Route 0 (bwd2_kernel above) scatters every live edge's dnq and dnk rows
// with 16-byte global atomics and gathers its nq and nk rows through L2: at
// G=64 x E=4096, HD=200, 75% live that is about 315 MB of L2 atomic traffic
// and 157 MB of gathers beside the 210 MB of ekb and dekb that device memory
// has to move, and the atomics set its time. Here one block owns graph g and
// a slice of CW columns (a multiple of 8; the last slice may be narrower).
// It stages the slice of nq and nk (by cp.async, behind the sort) and the
// slice's heads' scale and d_denom in shared memory, computes every slot's
// d_s for those heads into a table, and sorts the live slots by source and
// by destination (a counting sort in shared memory, on native integer
// atomics). Then three passes, no atomics on floats anywhere (a shared f32
// atomicAdd compiles to a compare-and-swap loop on this card, and a first
// version that accumulated with it ran 2.4x slower than route 0):
//   1. each group of threads takes a run of whole source nodes and sums
//      their slots' dnq terms, round(d_s * (nk[dst] + ekb)), in registers,
//      with the next slots' ekb slices in flight; it adds each node's sum
//      onto the node's seeded row, read ahead, which no other thread
//      touches;
//   2. the same over destination nodes for dnk, round(d_s * nq[src]), from
//      shared memory alone;
//   3. dekb = round(d_s * nq[src]) for every slot in slot order (zeros where
//      masked), so that the stores run along the block's slice of
//      consecutive rows: written per slot in source order, as a first
//      version did, they cost more than the whole ekb read.
// A third of the warps start with each pass, so that an SM reads, writes
// and computes at the same time. What is left to move is ekb in (by row
// slices in source order) and dekb out, the node rows, and the indices,
// mask, e_edge and d_alpha that every slice reads again.
//
// Bound on the H100: bytes, ekb read and dekb written once (210 MB in bf16
// at the shapes above) beside the node arrays and the per-slot terms. This
// version runs at about 2.8x that (PERF.md): the sort and the d_s table are
// a serial prologue of every block, and the source-ordered ekb reads touch
// a few 32-byte sectors of a row at a time.
//
// Threads: nch = CW / 8 threads a slot, 8 consecutive columns a thread (one
// 16-byte load in bf16, two in f32), BU slots of a node in flight. A
// thread's 8 columns span at most two heads (heads of at least 8 features),
// so it reads d_s for one or two heads a slot.
constexpr int BT = 256;                 // threads of a route-1 block
constexpr int BU = 4;                   // slots a thread has in flight

// n = 8 values as T at p (16-byte aligned); STREAM: by st.global.cs, for
// rows that are written once and not read again here
template <typename T, bool STREAM = false>
__device__ __forceinline__ void store_row8(T* __restrict__ p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = make_float4(v[0], v[1], v[2], v[3]);
    const float4 b = make_float4(v[4], v[5], v[6], v[7]);
    float4* q = reinterpret_cast<float4*>(p);
    if (STREAM) {
      __stcs(q, a);
      __stcs(q + 1, b);
    } else {
      q[0] = a;
      q[1] = b;
    }
  } else {
    alignas(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);
    const uint4 w = *reinterpret_cast<const uint4*>(h);
    if (STREAM) __stcs(reinterpret_cast<uint4*>(p), w);
    else *reinterpret_cast<uint4*>(p) = w;
  }
}

// a node's 8 seeded f32 values at p (16-byte aligned), read ahead of its
// sum, and the sum written back
__device__ __forceinline__ void load_seed8(const float* __restrict__ p,
                                           float4 (&seed)[2]) {
  seed[0] = reinterpret_cast<const float4*>(p)[0];
  seed[1] = reinterpret_cast<const float4*>(p)[1];
}
__device__ __forceinline__ void store_sum8(float* __restrict__ p,
                                           const float4 (&a)[2],
                                           const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(a[0].x + v[0], a[0].y + v[1], a[0].z + v[2],
                     a[0].w + v[3]);
  q[1] = make_float4(a[1].x + v[4], a[1].y + v[5], a[1].z + v[6],
                     a[1].w + v[7]);
}

// heads that the slice [c0, c0 + cw) touches
__host__ __device__ inline int slice_heads(int c0, int cw, int dph) {
  return (c0 + cw - 1) / dph - c0 / dph + 1;
}

// dynamic shared memory of a route-1 block of width cw with hs heads: the
// nq and nk slices; (scale, d_denom) per node and head, whose room the two
// sorts' uint16 permutations take over once d_s is made; d_s per slot and
// head; each slot's (src, dst); the sorts' offsets and cursors
__host__ __device__ inline size_t bwd2_shared_room(int N, int E, int hs) {
  const size_t a = (size_t)N * hs * sizeof(float2), b = (size_t)E * 4;
  return ((a > b ? a : b) + 15) / 16 * 16;
}
__host__ __device__ inline size_t bwd2_smem(int N, int E, int cw, int hs,
                                            int elem) {
  return (size_t)N * cw * 2 * elem + bwd2_shared_room(N, E, hs) +
         (size_t)E * hs * sizeof(float) + (size_t)E * sizeof(uint32_t) +
         (size_t)(4 * N + 2) * sizeof(int);
}

// the slots v .. v + BU - 1 of a permutation (e = -1 past vend) and their
// ekb pieces of 8 columns, as raw 16-byte words
template <typename T, int NV>
__device__ __forceinline__ void fetch_slots(const uint16_t* perm, int v,
                                            int vend,
                                            const T* __restrict__ ekb_g,
                                            int ld, int col, int (&ev)[BU],
                                            uint4 (&raw)[BU][NV]) {
#pragma unroll
  for (int u = 0; u < BU; ++u) {
    ev[u] = v + u < vend ? perm[v + u] : -1;
    if (ev[u] >= 0) {
      const uint4* p =
          reinterpret_cast<const uint4*>(ekb_g + (long long)ev[u] * ld + col);
#pragma unroll
      for (int j = 0; j < NV; ++j) raw[u][j] = p[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BT)
bwd2_graph_kernel(const T* __restrict__ nq, const T* __restrict__ nk,
                  const T* __restrict__ ekb, const float* __restrict__ e_edge,
                  const float* __restrict__ dalpha,
                  const float* __restrict__ scale,
                  const float* __restrict__ d_denom,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const uint8_t* __restrict__ mask, T* __restrict__ dekb,
                  float* __restrict__ dnq, float* __restrict__ dnk, int E,
                  int N, int HD, int H, int lq, int lk, int lb, int lde,
                  int ldq, int ldk, int CW) {
  constexpr int NV = 8 * sizeof(T) / 16;  // 16-byte words of 8 values
  extern __shared__ __align__(16) unsigned char smem[];
  const long long g = blockIdx.y;
  const int c0 = blockIdx.x * CW;
  const int cw = min(CW, HD - c0), nch = cw / 8;
  const int dph = HD / H, h_lo = c0 / dph, hs = slice_heads(c0, cw, dph);
  T* s_nq = reinterpret_cast<T*>(smem);
  T* s_nk = s_nq + N * cw;
  unsigned char* room = reinterpret_cast<unsigned char*>(s_nk + N * cw);
  float2* s_term = reinterpret_cast<float2*>(room);         // scale, d_denom
  uint16_t* perm_s = reinterpret_cast<uint16_t*>(room);     // E, later
  uint16_t* perm_d = perm_s + E;                            // E, later
  float* s_ds = reinterpret_cast<float*>(room + bwd2_shared_room(N, E, hs));
  uint32_t* s_sd = reinterpret_cast<uint32_t*>(s_ds + E * hs);  // src, dst
  int* off_s = reinterpret_cast<int*>(s_sd + E);             // N + 1
  int* off_d = off_s + N + 1;                                // N + 1
  int* cur_s = off_d + N + 1;                                // N
  int* cur_d = cur_s + N;                                    // N
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* g_src = src + g * E;
  const int32_t* g_dst = dst + g * E;
  const uint8_t* g_mask = mask + g * E;
  T* dekb_g = dekb + g * E * lde;

  // stage the slice by cp.async, which lands while the slots are counted
  // and sorted below; the heads' terms by plain loads; zero the counts
  stage_slice<T, BT>(s_nq, nq + g * N * lq, N, lq, c0, cw);
  stage_slice<T, BT>(s_nk, nk + g * N * lk, N, lk, c0, cw);
  cp_async_commit();
#pragma unroll 4
  for (int i = tid; i < N * hs; i += BT) {
    const long long node = (g * N + i / hs) * H + h_lo + i % hs;
    s_term[i] = make_float2(scale[node], d_denom[node]);
  }
  for (int i = tid; i < N; i += BT) cur_s[i] = cur_d[i] = 0;
  __syncthreads();
  pack_slots<BT, true, true>(g_src, g_dst, g_mask, E, s_sd, cur_s, cur_d);
  __syncthreads();
  // d_s per slot and slice head (0 where masked), PB a thread at once
  for (int i0 = tid; i0 < E * hs; i0 += PB * BT) {
    float da[PB], ee[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * BT;
      if (i < E * hs) {
        const long long ghe = (g * H + h_lo + i / E) * E + i % E;
        da[k] = dalpha[ghe];
        ee[k] = e_edge[ghe];
      }
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = i0 + k * BT;
      if (i >= E * hs) break;
      const int hh = i / E, e = i % E;
      const uint32_t sd = s_sd[e];
      float ds = 0.0f;
      if (sd != DEAD) {
        const float2 t = s_term[(sd & 0xffff) * hs + hh];
        ds = (da[k] * t.x + t.y) * ee[k];
      }
      s_ds[e * hs + hh] = ds;
    }
  }
  __syncthreads();
  if (warp == 0) warp_offsets(cur_s, off_s, cur_s, N, lane);
  if (warp == 1) warp_offsets(cur_d, off_d, cur_d, N, lane);
  __syncthreads();
  // s_term's room becomes the permutations
  place_slots<0, BT>(s_sd, E, 0, N, cur_s, perm_s);
  place_slots<1, BT>(s_sd, E, 0, N, cur_d, perm_d);
  cp_async_wait<0>();                    // this thread's staged words
  __syncthreads();

  const int groups = BT / nch;           // groups of nch threads
  const int grp = tid / nch, ch = tid % nch;
  if (grp >= groups) return;
  const int col = c0 + 8 * ch;           // the thread's first column
  const int hA = col / dph, hB = (col + 7) / dph;
  const int kb = (hA + 1) * dph - col;   // columns k < kb lie in head hA
  const int lA = hA - h_lo, lB = hB - h_lo;
  const int n_live = off_s[N];

  // pass 1, slots by source, a group's whole nodes as one run with the
  // next BU slots' ekb in flight: dnq rows summed in registers
  auto pass1 = [&]() {
    int n = part_start(off_s, N, 0, n_live, grp, groups);
    const int a = off_s[n],
              b = off_s[part_start(off_s, N, 0, n_live, grp + 1, groups)];
    int end = a;                         // forces the first node's set-up
    bool held = false;                   // acc holds node n's sum
    float q[8], acc[8];
    float4 seed[2];                      // node n's dnq row, read ahead
    int ev[BU];
    uint4 raw[BU][NV];
    if (a < b) fetch_slots<T, NV>(perm_s, a, b, ekb + g * E * lb, lb, col, ev,
                                  raw);
    for (int v = a; v < b; v += BU) {
      int ev_n[BU];
      uint4 raw_n[BU][NV];
      fetch_slots<T, NV>(perm_s, v + BU, b, ekb + g * E * lb, lb, col, ev_n,
                         raw_n);
#pragma unroll
      for (int u = 0; u < BU; ++u) {
        if (ev[u] < 0) break;
        const int vv = v + u;
        if (vv >= end) {
          if (held) store_sum8(dnq + (g * N + n) * ldq + col, seed, acc);
          while (off_s[n + 1] <= vv) ++n;  // the node that holds vv
          end = off_s[n + 1];
          load_row<T, 8>(s_nq + n * cw + 8 * ch, q);
          load_seed8(dnq + (g * N + n) * ldq + col, seed);
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
          held = true;
        }
        const int e = ev[u];
        const float dsA = s_ds[e * hs + lA], dsB = s_ds[e * hs + lB];
        float kk[8], bb[8];
        load_row<T, 8>(s_nk + (s_sd[e] >> 16) * cw + 8 * ch, kk);
        load_row<T, 8>(reinterpret_cast<const T*>(raw[u]), bb);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[k] += round_to<T>((k < kb ? dsA : dsB) * (kk[k] + bb[k]));
      }
#pragma unroll
      for (int u = 0; u < BU; ++u) {
        ev[u] = ev_n[u];
#pragma unroll
        for (int j = 0; j < NV; ++j) raw[u][j] = raw_n[u][j];
      }
    }
    if (held) store_sum8(dnq + (g * N + n) * ldq + col, seed, acc);
  };

  // pass 2, slots by destination, a group's whole nodes as one run: dnk
  // rows summed in registers
  auto pass2 = [&]() {
    int n = part_start(off_d, N, 0, n_live, grp, groups);
    const int a = off_d[n],
              b = off_d[part_start(off_d, N, 0, n_live, grp + 1, groups)];
    int end = a;
    bool held = false;
    float acc[8];
    float4 seed[2];                      // node n's dnk row, read ahead
    for (int v = a; v < b; ++v) {
      if (v >= end) {
        if (held) store_sum8(dnk + (g * N + n) * ldk + col, seed, acc);
        while (off_d[n + 1] <= v) ++n;
        end = off_d[n + 1];
        load_seed8(dnk + (g * N + n) * ldk + col, seed);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
        held = true;
      }
      const int e = perm_d[v];
      const float dsA = s_ds[e * hs + lA], dsB = s_ds[e * hs + lB];
      float q[8];
      load_row<T, 8>(s_nq + (s_sd[e] & 0xffff) * cw + 8 * ch, q);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] += round_to<T>((k < kb ? dsA : dsB) * q[k]);
    }
    if (held) store_sum8(dnk + (g * N + n) * ldk + col, seed, acc);
  };

  // pass 3, slots in order: dekb = round(d_s * nq[src]), zeros where
  // masked, so that a block's stores run along its slice of each row
  auto pass3 = [&]() {
    for (int e0 = grp; e0 < E; e0 += BU * groups) {
#pragma unroll
      for (int u = 0; u < BU; ++u) {
        const int e = e0 + u * groups;
        if (e >= E) break;
        const uint32_t sd = s_sd[e];
        float dk[8];
        if (sd == DEAD) {
#pragma unroll
          for (int k = 0; k < 8; ++k) dk[k] = 0.0f;
        } else {
          const float dsA = s_ds[e * hs + lA], dsB = s_ds[e * hs + lB];
          float q[8];
          load_row<T, 8>(s_nq + (sd & 0xffff) * cw + 8 * ch, q);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            dk[k] = round_to<T>((k < kb ? dsA : dsB) * q[k]);
        }
        store_row8<T>(dekb_g + (long long)e * lde + col, dk);
      }
    }
  };

  // a third of the warps start with each pass, so that an SM reads ekb,
  // writes dekb and works from shared memory at the same time (by warp,
  // not by group: the lanes of a warp take one pass at a time)
  for (int step = 0; step < 3; ++step) {
    const int pass = (step + warp) % 3;
    if (pass == 0) pass1();
    else if (pass == 1) pass2();
    else pass3();
  }
}

// ---------------------------------------------------------------------------
// aggr and bwd1, route 1: a graph's live slots sorted by the node they sum
// into, whole node runs a warp.
//
// Route 0 (aggr_kernel, bwd1_kernel above) adds every live slot's 8 columns
// a lane into the f32 node rows with 16-byte global atomics (aggr into
// out[dst], bwd1 into dnm[src] and dscale[src]), and those atomics, with the
// per-edge node gathers, set its time. Here a block owns graph g and part k
// of the graph's live slots sorted by that node (aggr: destination; bwd1:
// source; node_sort.cuh), the parts cut at node boundaries so that each
// holds about as many slots; a warp takes a run of whole nodes of its
// block's part, cut the same way, and a lane 8 consecutive columns of every
// row, as in route 0 (25 lanes at HD = 200). The warp sums a node's terms in
// registers and adds them onto the node's seeded row, read ahead, once: no
// atomics on floats, and no other thread touches the row. Every row is read
// or written whole (400 bytes in bf16 at HD = 200), bwd1's demb rows too,
// where column slices (bwd2's route 1, or a cluster of slice blocks that
// trade their partial head sums through distributed shared memory, which
// ran 2.3x slower here) would move pieces of rows; a head's sums are then
// whole within the warp.
//
// A warp keeps RD slots in flight (8 in bf16, 4 in f32: the same bytes) by
// cp.async into its own ring in shared memory: each slot's rows (aggr:
// nm[src], emb; bwd1: g[dst], emb, and nm[src] with a node's first slot)
// and its heads' terms, each lane its own 16-byte pieces, so no lane waits
// for another (a first version that held 4 slots in registers and waited
// for them in turn ran aggr at 1.5x the time). Lane 4h holds head h's
// per-slot terms (e_edge, scale, alpha, d_alpha) and shares alpha by
// shuffles; bwd1's head sums are one prefix scan over the lanes, read at
// the heads' boundaries.
//
// What bwd1 stores per slot costs more than what it reads: its demb rows
// and d_alpha values land in source order, scattered over the graph's
// rows, and the masked slots' zero rows are scattered too (PERF.md, PR 8:
// without those stores the kernel takes 0.6x the time). A pass that wrote
// demb in slot order, gathering g[dst] again, cost more than it saved. The
// zero rows are written once a warp's run is done, so that they overlap
// the other warps' reads, and the rows by st.global.cs.
//
// The grid is G x parts with about two blocks an SM (the prologue, each
// block reading and sorting the graph's indices anew, takes about 7 us).
// Bound on the H100: bytes, emb read for the live slots beside demb
// written for every slot (bwd1), with the node rows gathered through L2.
constexpr int RT = 256;                 // threads of a node-run block
constexpr int RW = RT / 32;             // its warps

// slots a warp has in flight: the same bytes in bf16 and f32
__host__ __device__ constexpr int ring_depth(int elem) {
  return elem == 2 ? 8 : 4;
}

// a ring stage: `rows` rows of HD values of elem bytes, then two floats a
// head (e_edge, scale); a multiple of 16 bytes for HD % 8 == 0
__host__ __device__ inline size_t stage_bytes(int HD, int elem, int rows) {
  return (size_t)rows * HD * elem + 2 * MAX_H * sizeof(float);
}

// dynamic shared memory of a node-run block: its warps' rings; each slot's
// packed (src, dst); the node offsets and cursors (int32); the permutation
// (uint16)
__host__ __device__ inline size_t sorted_smem(int N, int E, int HD, int elem,
                                              int rows) {
  return (size_t)RW * ring_depth(elem) * stage_bytes(HD, elem, rows) +
         (size_t)E * sizeof(uint32_t) + (size_t)(2 * N + 1) * sizeof(int) +
         (size_t)E * sizeof(uint16_t);
}

// 4-byte asynchronous copy, global to shared
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :
               : "r"(shared_addr(smem)), "l"(gmem)
               : "memory");
}

// a node-run block's shared memory, and the prologue that fills its
// tables: the graph's live slots sorted by node (KEY, node_sort.cuh) as
// far as this block's part of the nodes needs; the first node wn of this
// warp's run of slots [va, vb)
struct NodeRun {
  unsigned char* ring;                   // this warp's
  size_t stage;                          // bytes of a ring stage
  uint32_t* s_sd;                        // E
  int* off;                              // N + 1
  int* cur;                              // N
  uint16_t* perm;                        // E
  int wn, va, vb;

  template <int KEY, int RD>
  static __device__ __forceinline__ NodeRun make(
      unsigned char* smem, const int32_t* __restrict__ g_src,
      const int32_t* __restrict__ g_dst, const uint8_t* __restrict__ g_mask,
      int E, int N, int parts, size_t stage) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    NodeRun r;
    r.stage = stage;
    r.ring = smem + warp * RD * stage;
    r.s_sd = reinterpret_cast<uint32_t*>(smem + RW * RD * stage);
    r.off = reinterpret_cast<int*>(r.s_sd + E);
    r.cur = r.off + N + 1;
    r.perm = reinterpret_cast<uint16_t*>(r.cur + N);
    for (int i = tid; i < N; i += RT) r.cur[i] = 0;
    __syncthreads();
    pack_slots<RT, KEY == 0, KEY == 1>(g_src, g_dst, g_mask, E, r.s_sd,
                                       r.cur, r.cur);
    __syncthreads();
    if (warp == 0) warp_offsets(r.cur, r.off, r.cur, N, lane);
    __syncthreads();
    const int n_live = r.off[N], k = blockIdx.x;
    const int n0 = part_start(r.off, N, 0, n_live, k, parts);
    const int n1 = part_start(r.off, N, 0, n_live, k + 1, parts);
    place_slots<KEY, RT>(r.s_sd, E, n0, n1, r.cur, r.perm);
    __syncthreads();
    const int a = r.off[n0], b = r.off[n1];
    r.wn = part_start(r.off, N, a, b, warp, RW);
    r.va = r.off[r.wn];
    r.vb = r.off[part_start(r.off, N, a, b, warp + 1, RW)];
    return r;
  }
};

// per-head totals over the warp of a slot's products, from each lane's
// partials pA (its columns below kb, head hA) and pB (the rest, head hB):
// one inclusive scan of pA + pB over the lanes; the prefix at a head
// boundary is read at the lane that holds it (the lane's exclusive prefix,
// plus pA where the boundary falls inside the lane), and lane 4h takes
// head h's total as the prefix at its end less the prefix at its start.
// 8 shuffles for any number of heads. A lane holds at most one boundary
// (heads of at least 8 features); the end of the row, column HD, lies on
// the first lane past it, or past the warp at HD = 256 (the warp's total).
struct HeadScan {
  bool starts;                           // a head starts at the lane's c0
  int la, lb;                            // lanes of head my_h's boundaries
  __device__ __forceinline__ HeadScan(int c0, int dph, int my_h, int HD)
      : starts(c0 % dph == 0),
        la(min(my_h * dph, HD) / 8),
        lb(min((my_h + 1) * dph, HD) / 8) {}
  __device__ __forceinline__ float total(float pA, float pB, int lane) const {
    const float q = pA + pB;
    float s = q;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += t;
    }
    const float at = starts ? s - q : s - q + pA;
    const float start = __shfl_sync(FULL, at, la & 31);
    const float end = __shfl_sync(FULL, at, lb & 31);
    const float all = __shfl_sync(FULL, s, 31);
    return (lb == 32 ? all : end) - start;
  }
};

// a lane's 8 columns from c0 (heads of at least 8 features): the head of
// the first kb of them and of the rest; lanes past HD name head H - 1
struct LaneHeads {
  int hA, hB, kb;
  __device__ __forceinline__ LaneHeads(int c0, int dph, int H)
      : hA(min(c0 / dph, H - 1)),
        hB(min((c0 + 7) / dph, H - 1)),
        kb(min((c0 / dph + 1) * dph - c0, 8)) {}
};

// a lane's 8 values of a row (elem bytes each) into shared memory
template <typename T>
__device__ __forceinline__ void cp_async_row8(T* s, const T* __restrict__ p) {
#pragma unroll
  for (int j = 0; j < 8 * (int)sizeof(T) / 16; ++j)
    cp_async16(s + j * (16 / sizeof(T)), p + j * (16 / sizeof(T)));
}

template <typename T>
__global__ void __launch_bounds__(RT, 2)
aggr_graph_kernel(const T* __restrict__ nm, const T* __restrict__ emb,
                  const float* __restrict__ e_edge,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const uint8_t* __restrict__ mask, float* __restrict__ out,
                  int E, int N, int HD, int H, int lm, int lb, int lo,
                  int parts) {
  constexpr int RD = ring_depth(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const long long g = blockIdx.y;
  const NodeRun r = NodeRun::template make<1, RD>(
      smem, src + g * E, dst + g * E, mask + g * E, E, N, parts,
      stage_bytes(HD, sizeof(T), 2));
  const int lane = threadIdx.x & 31;
  const int c0 = 8 * lane, my_h = lane / 4;
  const bool on = c0 < HD, head_lane = (lane & 3) == 0 && my_h < H;
  const LaneHeads lh(c0, HD / H, H);
  const T* nm_g = nm + g * N * lm + c0;
  const T* emb_g = emb + g * E * lb + c0;
  const float* e_g = e_edge + (g * H + my_h) * E;
  const float* sc_g = scale + g * N * H + my_h;
  float* out_g = out + g * N * lo + c0;

  // slot v's nm[src] and emb rows and its head's (e_edge, scale) into
  // stage v % RD; one commit group a slot for every lane
  auto issue = [&](int v) {
    if (v < r.vb) {
      const int e = r.perm[v];
      const int s = slot_node<0>(r.s_sd[e]);
      T* rows = reinterpret_cast<T*>(r.ring + (v % RD) * r.stage);
      if (on) {
        cp_async_row8<T>(rows + c0, nm_g + s * lm);
        cp_async_row8<T>(rows + HD + c0, emb_g + (long long)e * lb);
      }
      if (head_lane) {
        float* vals = reinterpret_cast<float*>(rows + 2 * HD);
        cp_async4(vals + my_h, e_g + e);
        cp_async4(vals + MAX_H + my_h, sc_g + s * H);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < RD; ++i) issue(r.va + i);

  int n = r.wn, end = r.va;              // end: forces the first set-up
  bool held = false;                     // acc holds node n's sum
  float acc[8];
  float4 seed[2];                        // node n's out row, read ahead
  for (int v = r.va; v < r.vb; ++v) {
    if (v >= end) {
      if (held && on) store_sum8(out_g + n * lo, seed, acc);
      while (r.off[n + 1] <= v) ++n;     // the node that holds v
      end = r.off[n + 1];
      if (on) load_seed8(out_g + n * lo, seed);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
      held = true;
    }
    cp_async_wait<RD - 1>();             // this lane's pieces of slot v
    const T* rows = reinterpret_cast<const T*>(r.ring + (v % RD) * r.stage);
    const float* vals = reinterpret_cast<const float*>(rows + 2 * HD);
    const float al = head_lane ? vals[my_h] * vals[MAX_H + my_h] : 0.0f;
    const float aA = __shfl_sync(FULL, al, 4 * lh.hA);
    const float aB = __shfl_sync(FULL, al, 4 * lh.hB);
    if (on) {
      float m[8], b[8];
      load_row<T, 8>(rows + c0, m);
      load_row<T, 8>(rows + HD + c0, b);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc[k] += round_to<T>((k < lh.kb ? aA : aB) * (m[k] + b[k]));
    }
    issue(v + RD);                       // into the stage just read
  }
  cp_async_wait<0>();
  if (held && on) store_sum8(out_g + n * lo, seed, acc);
}

// SPLIT: a column slice of a wide head (`part`); a whole head's launch is
// compiled without the partial mode, which sits in its per-slot loop
template <typename T, bool SPLIT>
__global__ void __launch_bounds__(RT, 2)
bwd1_graph_kernel(const T* __restrict__ gout, const T* __restrict__ nm,
                  const T* __restrict__ emb, const float* __restrict__ e_edge,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ src,
                  const int32_t* __restrict__ dst,
                  const uint8_t* __restrict__ mask, T* __restrict__ demb,
                  float* __restrict__ dalpha, float* __restrict__ dscale,
                  float* __restrict__ dnm, int E, int N, int HD, int H,
                  int lg, int lm, int lb, int ld, int ldn, int part,
                  int parts) {
  constexpr int RD = ring_depth(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const long long g = blockIdx.y;
  const NodeRun r = NodeRun::template make<0, RD>(
      smem, src + g * E, dst + g * E, mask + g * E, E, N, parts,
      stage_bytes(HD, sizeof(T), 3));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = 8 * lane, my_h = lane / 4;
  const bool on = c0 < HD, head_lane = (lane & 3) == 0 && my_h < H;
  const LaneHeads lh(c0, HD / H, H);
  const HeadScan hs(c0, HD / H, my_h, HD);
  const T* gout_g = gout + g * N * lg + c0;
  const T* nm_g = nm + g * N * lm + c0;
  const T* emb_g = emb + g * E * lb + c0;
  T* demb_g = demb + g * E * ld + c0;
  const float* e_g = e_edge + (g * H + my_h) * E;
  const float* sc_g = scale + g * N * H + my_h;
  float* da_g = dalpha + (g * H + my_h) * E;
  float* ds_g = dscale + g * N * H + my_h;
  float* dnm_g = dnm + g * N * ldn + c0;

  // slot v's g[dst] and emb rows, with a node's first slot also the
  // node's nm row and its head's scale, and its head's e_edge into stage
  // v % RD; one commit group a slot for every lane
  auto issue = [&](int v) {
    if (v < r.vb) {
      const int e = r.perm[v];
      const uint32_t sd = r.s_sd[e];
      const int s = slot_node<0>(sd);
      const bool first = r.off[s] == v;
      T* rows = reinterpret_cast<T*>(r.ring + (v % RD) * r.stage);
      if (on) {
        cp_async_row8<T>(rows + c0, gout_g + slot_node<1>(sd) * lg);
        cp_async_row8<T>(rows + HD + c0, emb_g + (long long)e * lb);
        if (first) cp_async_row8<T>(rows + 2 * HD + c0, nm_g + s * lm);
      }
      if (head_lane) {
        float* vals = reinterpret_cast<float*>(rows + 3 * HD);
        cp_async4(vals + my_h, e_g + e);
        if (first) cp_async4(vals + MAX_H + my_h, sc_g + s * H);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < RD; ++i) issue(r.va + i);

  int n = r.wn, end = r.va;              // end: forces the first set-up
  bool held = false;                     // the sums hold node n's
  float m[8], acc[8], sc = 0.0f, acc_ds = 0.0f, seed_ds = 0.0f;
  float4 seed[2];                        // node n's dnm row, read ahead
  for (int v = r.va; v < r.vb; ++v) {
    cp_async_wait<RD - 1>();             // this lane's pieces of slot v
    const T* rows = reinterpret_cast<const T*>(r.ring + (v % RD) * r.stage);
    const float* vals = reinterpret_cast<const float*>(rows + 3 * HD);
    if (v >= end) {
      if (held) {
        if (on) store_sum8(dnm_g + n * ldn, seed, acc);
        if (head_lane) ds_g[n * H] = seed_ds + acc_ds;
      }
      while (r.off[n + 1] <= v) ++n;     // the node that holds v
      end = r.off[n + 1];
      if (on) {
        load_row<T, 8>(rows + 2 * HD + c0, m);
        load_seed8(dnm_g + n * ldn, seed);
      }
      if (head_lane) {
        sc = vals[MAX_H + my_h];
        seed_ds = ds_g[n * H];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
      acc_ds = 0.0f;
      held = true;
    }
    const int e = r.perm[v];
    const float ee = head_lane ? vals[my_h] : 0.0f;
    const float al = ee * sc;            // alpha of head lane / 4
    const float aA = __shfl_sync(FULL, al, 4 * lh.hA);
    const float aB = __shfl_sync(FULL, al, 4 * lh.hB);
    float pA = 0.0f, pB = 0.0f;
    if (on) {
      float gd[8], b[8], dm[8];
      load_row<T, 8>(rows + c0, gd);
      load_row<T, 8>(rows + HD + c0, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dm[j] = round_to<T>((j < lh.kb ? aA : aB) * gd[j]);
        acc[j] += dm[j];
        const float p = (m[j] + b[j]) * gd[j];
        if (j < lh.kb) pA += p; else pB += p;
      }
      store_row8<T, true>(demb_g + (long long)e * ld, dm);
    }
    issue(v + RD);                       // into the stage just read
    float da = hs.total(pA, pB, lane);  // head lane / 4's
    if (head_lane) {
      if (SPLIT && (part & PART_ADD)) da += da_g[e];
      da_g[e] = da;
      if (!SPLIT || !(part & PART_OPEN)) acc_ds += da * ee;
    }
  }
  cp_async_wait<0>();
  if (held) {
    if (on) store_sum8(dnm_g + n * ldn, seed, acc);
    if (head_lane) ds_g[n * H] = seed_ds + acc_ds;
  }

  // the masked slots of this block's share of the slot indices, a warp
  // every RW-th slot once its run is done (so that these scattered stores
  // overlap the other warps' reads): demb and d_alpha 0
  const float zero[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const int z1 = (int)((long long)E * (blockIdx.x + 1) / parts);
  for (int e = (int)((long long)E * blockIdx.x / parts) + warp; e < z1;
       e += RW) {
    if (r.s_sd[e] != DEAD) continue;     // uniform over the warp
    if (on) store_row8<T, true>(demb_g + (long long)e * ld, zero);
    if (head_lane) da_g[e] = 0.0f;
  }
}

// ---------------------------------------------------------------------------
// scores, route 1: a block per range of SR slots of one graph, its live
// slots listed and their rows loaded into registers ahead of their use.
//
// Route 0 (scores_kernel above) gives a block 32 slots and a warp one slot
// at a time, each a chain of dependent loads (the mask, then src and dst,
// then three rows) that the warp waits on in turn, four times before the
// block ends (111 us at G=64 x E=4096, HD=200 in bf16, against a bound of
// 28). Here a block stages its range's src, dst and mask in one coalesced
// pass, writes the masked slots' scores as 0 without touching their rows,
// and lists the live slots (a warp ballot and one shared atomic a warp);
// each warp takes an even share of the list and loads a slot's nq[src],
// nk[dst] and ekb rows, each lane its own 16-byte pieces, AHEAD slots
// before it uses them (2 in bf16, 1 in f32: the same bytes). The head sums
// are one prefix scan over the lanes (HeadScan). Scores are staged
// head-major in shared memory and written as runs; each head lane keeps its
// head's max in a register, and a block does one global atomic max a head.
// The slots need no sort: scores are written in slot order and the max does
// not depend on order.
//
// What holds it back is the work a warp does per slot, not bytes: with no
// row loaded at all, the slots' loop took two thirds of the time, while
// halving a slot's rows saved a tenth (PERF.md, PR 9). A cp.async ring of
// 8 slots a warp, as aggr_graph_kernel has, took 1.15x the time in bf16
// and 1.4x in f32 (each slot's rows cross shared memory twice, and each
// copy waits on its index load); more, smaller blocks (four an SM, which
// the registers allow) are what moved it most.
//
// Bound on the H100: bytes, ekb's live rows (79 MB of the 95 MB the bound
// counts at the shapes above) beside the node rows, which L2 holds.
constexpr int SR = 512;                 // slots of a scores block's range

// slots whose rows a warp holds ahead of their use: the same bytes in bf16
// and f32
__host__ __device__ constexpr int scores_ahead(int elem) {
  return elem == 2 ? 2 : 1;
}

// dynamic shared memory of a scores block: the range's scores, head-major;
// the live list's src and dst (int32) and slot offset in the range (uint16)
__host__ __device__ inline size_t scores_smem(int H) {
  return (size_t)H * SR * sizeof(float) +
         (size_t)SR * (2 * sizeof(int) + sizeof(uint16_t));
}

template <typename T>
__global__ void __launch_bounds__(RT, 4)
scores_range_kernel(const T* __restrict__ nq, const T* __restrict__ nk,
                    const T* __restrict__ ekb,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ dst,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ scores, float* __restrict__ m_edge,
                    int E, int N, int HD, int H, int lq, int lk, int lb,
                    int part) {
  constexpr int AHEAD = scores_ahead(sizeof(T));
  constexpr int NV = 8 * sizeof(T) / 16;  // 16-byte words of 8 values
  constexpr int K = SR / RT;             // slots a thread stages
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_max[MAX_H];
  __shared__ int s_n;                    // live slots listed
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * SR, ne = min(SR, E - e0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* s_sc = reinterpret_cast<float*>(smem);            // H x SR
  int* s_src = reinterpret_cast<int*>(s_sc + H * SR);
  int* s_dst = s_src + SR;
  uint16_t* s_el = reinterpret_cast<uint16_t*>(s_dst + SR);
  if (tid < MAX_H) s_max[tid] = NEG;
  if (tid == 0) s_n = 0;

  // the range's slots, K a thread, their loads all issued before any is
  // used; slot el = tid + k * RT, so a warp's lanes hold 32 consecutive
  const int32_t* g_src = src + g * E + e0;
  const int32_t* g_dst = dst + g * E + e0;
  const uint8_t* g_mask = mask + g * E + e0;
  bool lv[K];
  int sv[K], dv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int el = tid + k * RT;
    lv[k] = el < ne && g_mask[el];
    sv[k] = el < ne ? g_src[el] : 0;
    dv[k] = el < ne ? g_dst[el] : 0;
  }
  __syncthreads();                       // s_n is zeroed
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int el = tid + k * RT;
    const unsigned live = __ballot_sync(FULL, lv[k]);
    int base = 0;
    if (lane == 0 && live) base = atomicAdd(&s_n, __popc(live));
    base = __shfl_sync(FULL, base, 0);
    if (lv[k]) {
      const int i = base + __popc(live & ((1u << lane) - 1));
      s_src[i] = sv[k];
      s_dst[i] = dv[k];
      s_el[i] = (uint16_t)el;
    } else if (el < ne) {
      for (int h = 0; h < H; ++h) s_sc[h * SR + el] = 0.0f;
    }
  }
  __syncthreads();

  const int n_live = s_n;
  const int va = (int)((long long)n_live * warp / RW);
  const int vb = (int)((long long)n_live * (warp + 1) / RW);
  const int c0 = 8 * lane, my_h = lane / 4;
  const bool on = c0 < HD, head_lane = (lane & 3) == 0 && my_h < H;
  const LaneHeads lh(c0, HD / H, H);
  const HeadScan hs(c0, HD / H, my_h, HD);
  const T* nq_g = nq + g * N * lq + c0;
  const T* nk_g = nk + g * N * lk + c0;
  const T* ekb_g = ekb + (g * E + e0) * lb + c0;

  // listed slot v's three rows, the lane's 16-byte words of each
  uint4 rows[AHEAD][3][NV];
  auto fetch = [&](int v, uint4 (&r)[3][NV]) {
    if (v < vb && on) {
      const uint4* q = reinterpret_cast<const uint4*>(
          nq_g + (long long)s_src[v] * lq);
      const uint4* k = reinterpret_cast<const uint4*>(
          nk_g + (long long)s_dst[v] * lk);
      const uint4* b = reinterpret_cast<const uint4*>(
          ekb_g + (long long)s_el[v] * lb);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        r[0][j] = __ldg(q + j);
        r[1][j] = __ldg(k + j);
        r[2][j] = __ldg(b + j);
      }
    }
  };
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) fetch(va + u, rows[u]);

  float mx = NEG;                        // head lane / 4's max
  for (int v0 = va; v0 < vb; v0 += AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int v = v0 + u;
      if (v >= vb) break;                // uniform over the warp
      float pA = 0.0f, pB = 0.0f;
      if (on) {
        float q[8], k[8], b[8];
        load_row<T, 8>(reinterpret_cast<const T*>(rows[u][0]), q);
        load_row<T, 8>(reinterpret_cast<const T*>(rows[u][1]), k);
        load_row<T, 8>(reinterpret_cast<const T*>(rows[u][2]), b);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = q[j] * (k[j] + b[j]);
          if (j < lh.kb) pA += p; else pB += p;
        }
      }
      fetch(v + AHEAD, rows[u]);         // into the registers just read
      const float s = hs.total(pA, pB, lane);
      if (head_lane) {
        s_sc[my_h * SR + s_el[v]] = s;
        mx = fmaxf(mx, s);
      }
    }
  }
  if (head_lane && va < vb && part == 0) atomic_max_float(&s_max[my_h], mx);
  __syncthreads();

  // the range's scores as runs of consecutive slots, head by head; a
  // column slice adds the slices' sums before it, and the last takes the
  // max over the whole sums (part is the same for the whole grid)
  for (int i = tid; i < H * ne; i += RT) {
    const int h = i / ne, el = i % ne;
    float v = s_sc[h * SR + el];
    if (part != 0) {
      if (part & PART_ADD) v += scores[(g * H + h) * E + e0 + el];
      if (!(part & PART_OPEN) && g_mask[el]) atomic_max_float(&s_max[h], v);
    }
    scores[(g * H + h) * E + e0 + el] = v;
  }
  if (part != 0) __syncthreads();
  if (!(part & PART_OPEN) && tid < H && s_max[tid] > NEG)
    atomic_max_float(&m_edge[g * H + tid], s_max[tid]);
}

// ---------------------------------------------------------------------------
// denoms, route 1: a block per graph, each source's exponentials gathered
// into a run in shared memory and summed there.
//
// Route 0 (denoms_kernel above) runs a thread per slot and adds each live
// slot's H exponentials and its degree into global floats by atomicAdd
// (about 0.97 million atomics at G=64 x E=4096, H=4), into arrays that two
// zero-fill launches have cleared first. Here block g owns graph g and does
// a counting sort of its live slots by source (node_sort.cuh's way, on
// native shared integer atomics): it counts them (the counts are the
// out-degrees), turns the counts into offsets, then writes each slot's H
// exponentials at its source's next place in a (H, E) table, and e_edge in
// slot order. Each (source, head) then sums its run of the table in
// registers, and denom and deg are written whole, once: no zero fills, no
// float atomics (a shared f32 atomicAdd is a compare-and-swap loop on
// sm_90a; summing with it, the first version of this kernel, took 1.5x the
// time). A thread holds a quad of slots in registers, with their scores
// loaded while the slots are counted; graphs with more than 4 x DT slots
// read the rest again after the count. The graph's sources, masks and scores
// are read as 16-byte vectors where E % 4 == 0.
//
// Bound on the H100: bytes, the scores read and e_edge written (4.2 MB each
// at the shapes above); a launch's fixed cost is most of the time.
constexpr int DT = 1024;                // threads of a denoms block

// dynamic shared memory of a denoms block: the exponentials grouped by
// source (f32, H x E), the offsets (N + 1) and the counts, later the next
// places (N), int32
__host__ __device__ inline size_t denoms_smem(int N, int E, int H) {
  return (size_t)H * E * sizeof(float) + (size_t)(2 * N + 1) * sizeof(int);
}

// four consecutive values at p, of which the first n < 4 lie in the array:
// one 16-byte load where VEC (n == 4 and p aligned), else one a value
template <bool VEC, typename V>
__device__ __forceinline__ void load4(const V* __restrict__ p, int n,
                                      V (&v)[4]) {
  if constexpr (VEC) {
    static_assert(sizeof(V) == 4, "16-byte words of four 4-byte values");
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const V* a = reinterpret_cast<const V*>(&w);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = a[j];
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < n ? p[j] : V(0);
  }
}

// a thread's quad of slots in chunk c: sources, masks (0 past E) and,
// where `scores`, the H rows' scores
template <bool VEC>
struct SlotQuad {
  int src[4];
  uint8_t live[4];
  float s[MAX_H][4];

  __device__ __forceinline__ static int first(int c) {
    return 4 * (c * DT + (int)threadIdx.x);
  }
  __device__ __forceinline__ void load(int c, bool scores,
                                       const int32_t* __restrict__ g_src,
                                       const uint8_t* __restrict__ g_mask,
                                       const float* __restrict__ g_s, int E,
                                       int H) {
    const int e0 = first(c), n = max(0, min(4, E - e0));
#pragma unroll
    for (int j = 0; j < 4; ++j) live[j] = 0;
    if (n == 0) return;
    load4<VEC>(g_src + e0, n, src);
    if constexpr (VEC) {
      const uchar4 w = *reinterpret_cast<const uchar4*>(g_mask + e0);
      live[0] = w.x; live[1] = w.y; live[2] = w.z; live[3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) live[j] = j < n ? g_mask[e0 + j] : 0;
    }
    if (scores) {
#pragma unroll
      for (int h = 0; h < MAX_H; ++h)
        if (h < H) load4<VEC>(g_s + h * E + e0, n, s[h]);
    }
  }
};

template <bool VEC>
__global__ void __launch_bounds__(DT)
denoms_graph_kernel(const float* __restrict__ scores,
                    const float* __restrict__ gmax,
                    const int32_t* __restrict__ src,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ e_edge, float* __restrict__ denom,
                    float* __restrict__ deg, int E, int N, int H) {
  extern __shared__ __align__(16) float s_e[];             // H x E
  int* off = reinterpret_cast<int*>(s_e + H * E);          // N + 1
  int* cur = off + N + 1;                                  // N
  const long long g = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t* g_src = src + g * E;
  const uint8_t* g_mask = mask + g * E;
  const float* g_s = scores + g * H * E;
  float* e_g = e_edge + g * H * E;
  const int chunks = (E + 4 * DT - 1) / (4 * DT);
  for (int i = tid; i < N; i += DT) cur[i] = 0;
  __syncthreads();

  // count the live slots by source; chunk 0's scores load meanwhile
  SlotQuad<VEC> sq;
  for (int c = 0; c < chunks; ++c) {
    sq.load(c, c == 0, g_src, g_mask, g_s, E, H);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (sq.live[j]) atomicAdd(&cur[sq.src[j]], 1);
  }
  float gm[MAX_H];
#pragma unroll
  for (int h = 0; h < MAX_H; ++h) gm[h] = h < H ? gmax[g * H + h] : 0.0f;
  __syncthreads();
  if (tid < 32) warp_offsets(cur, off, cur, N, tid);
  __syncthreads();

  // each live slot's exponentials at its source's next place; e_edge whole
  for (int c = 0; c < chunks; ++c) {
    // chunk 0's scores are still held; its slots too where it is the only
    if (c > 0 || chunks > 1) sq.load(c, c > 0, g_src, g_mask, g_s, E, H);
    const int e0 = SlotQuad<VEC>::first(c);
    if (e0 >= E) continue;
    int at[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      at[j] = sq.live[j] ? atomicAdd(&cur[sq.src[j]], 1) : 0;
#pragma unroll
    for (int h = 0; h < MAX_H; ++h) {
      if (h >= H) break;
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = sq.live[j] ? expf(fminf(sq.s[h][j] - gm[h], 0.0f)) : 0.0f;
        if (sq.live[j]) s_e[h * E + at[j]] = x[j];
      }
      float* p = e_g + h * E + e0;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e0 + j < E) p[j] = x[j];
      }
    }
  }
  __syncthreads();

  // each (source, head) sums its run; the runs' lengths are the degrees
  for (int i = tid; i < N * H; i += DT) {
    const int n = i / H;
    const float* run = s_e + (i % H) * E;
    float sum = 0.0f;
#pragma unroll 4
    for (int v = off[n]; v < off[n + 1]; ++v) sum += run[v];
    denom[g * N * H + i] = sum;
  }
  for (int i = tid; i < N; i += DT) deg[g * N + i] = (float)(off[i + 1] - off[i]);
}

// the parts of each graph's live slots a node-run grid takes: about two
// blocks an SM over the G graphs, and at least 16 slots a warp
int graph_parts(int G, int E) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(1, min(2 * sms / G, E / (16 * RW)));
}

// what a node-run kernel with `rows` rows a ring stage takes: heads of at
// least 8 features, N and E within its uint16 indices, its shared memory
// within a block's
bool sorted_ok(int N, int E, int HD, int H, int elem, int rows) {
  return N > 0 && N <= 65536 && E <= 65536 && HD / H >= 8 &&
         sorted_smem(N, E, HD, elem, rows) <= 227 * 1024;
}

// a node-run kernel's launch: (parts, G) blocks of RT threads
template <typename K, typename... Args>
cudaError_t launch_sorted(K kernel, int G, size_t smem, int E, cudaStream_t s,
                          Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int parts = graph_parts(G, E);
  kernel<<<dim3(parts, G), RT, smem, s>>>(args..., parts);
  return cudaGetLastError();
}

// opt a route-1 kernel into its dynamic shared memory, and ask for the
// largest shared-memory carveout, so that two blocks share an SM where their
// tables fit (CUDA may otherwise pick a carveout that holds one)
template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

bool shapes_ok(int HD, int H) {
  return HD > 0 && HD % 8 == 0 && HD <= MAX_HD && H > 0 && H <= MAX_H &&
         HD % H == 0;
}

dim3 edge_grid(int G, int E) { return dim3((E + UE - 1) / UE, G); }

// a launch's (G, E, .) or (G, N, .) array of values of elem bytes: rows of
// HD values ld apart (the row stride in elements: HD for an array of its
// own, more for a view of some of a wider array's columns), each row's
// first value 16-byte aligned, as the kernels' 16-byte row pieces need
bool rows_ok(const void* p, int ld, int HD, int elem) {
  return aligned16(p) && ld >= HD && (long long)ld * elem % 16 == 0;
}

}  // namespace

// dtype: 0 = float32 node and edge arrays, 1 = bfloat16. All take
// HD % 8 == 0, HD <= 256, H <= 8 dividing HD, and 16-byte aligned arrays.
// Every (G, E, .) and (G, N, .) array of rows 1, 3, 4 and 5 comes with its
// row stride in elements (`l..`, after H): the array itself (HD) or a view
// of HD of a wider array's columns, read and written in place (a split
// head's column launches, a head group's launch); each must pass rows_ok.

// m_edge (G, H) arrives filled with -1e30. route 0: a block per 32 slots, a
// warp per edge; route 1: a block per range of SR slots of a graph, which
// takes heads of at least 8 features. part (PART_ADD | PART_OPEN, 0 for a
// whole head): a column slice of a wider head, which adds to the scores
// the slices before it wrote; all but the last leave m_edge as it is.
extern "C" int gat_unproj_scores(const void* nq, const void* nk,
                                 const void* ekb, const void* src,
                                 const void* dst, const void* mask,
                                 void* scores, void* m_edge, int G, int N,
                                 int E, int HD, int H, int lq, int lk,
                                 int lb, int dtype, int route, int part,
                                 void* stream) {
  const int el = dtype == 1 ? 2 : 4;
  if (!shapes_ok(HD, H) || !rows_ok(nq, lq, HD, el) ||
      !rows_ok(nk, lk, HD, el) || !rows_ok(ekb, lb, HD, el) ||
      (route != 0 && route != 1) ||
      (route == 1 && HD / H < 8) || part < 0 || part > 3)
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const dim3 grid((E + SR - 1) / SR, G);
    if (dtype == 1) {
      typedef __nv_bfloat16 T;
      scores_range_kernel<T><<<grid, RT, scores_smem(H), s>>>(
          (const T*)nq, (const T*)nk, (const T*)ekb, (const int32_t*)src,
          (const int32_t*)dst, (const uint8_t*)mask, (float*)scores,
          (float*)m_edge, E, N, HD, H, lq, lk, lb, part);
    } else {
      typedef float T;
      scores_range_kernel<T><<<grid, RT, scores_smem(H), s>>>(
          (const T*)nq, (const T*)nk, (const T*)ekb, (const int32_t*)src,
          (const int32_t*)dst, (const uint8_t*)mask, (float*)scores,
          (float*)m_edge, E, N, HD, H, lq, lk, lb, part);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    scores_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const int32_t*)src,
        (const int32_t*)dst, (const uint8_t*)mask, (float*)scores,
        (float*)m_edge, E, N, HD, H, lq, lk, lb, part);
  } else {
    typedef float T;
    scores_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const int32_t*)src,
        (const int32_t*)dst, (const uint8_t*)mask, (float*)scores,
        (float*)m_edge, E, N, HD, H, lq, lk, lb, part);
  }
  return (int)cudaGetLastError();
}

// e_edge (G, H, E) is written whole. route 0: a thread per slot, global
// atomics into denom (G, N, H) and deg (G, N), which arrive zeroed; route
// 1: a block per graph, which writes denom and deg whole and takes the
// shared memory of denoms_smem.
extern "C" int gat_unproj_denoms(const void* scores, const void* gmax,
                                 const void* src, const void* mask,
                                 void* e_edge, void* denom, void* deg, int G,
                                 int N, int E, int H, int route,
                                 void* stream) {
  if (H <= 0 || H > MAX_H || N < 0 || (route != 0 && route != 1) ||
      (route == 1 && denoms_smem(N, E, H) > 227 * 1024))
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (G == 0) return (int)cudaGetLastError();
    const size_t smem = denoms_smem(N, E, H);
    const bool vec = E % 4 == 0 && aligned16(scores) && aligned16(src) &&
                     aligned16(e_edge) && (uintptr_t)mask % 4 == 0;
    const auto kernel =
        vec ? denoms_graph_kernel<true> : denoms_graph_kernel<false>;
    const cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<G, DT, smem, (cudaStream_t)stream>>>(
        (const float*)scores, (const float*)gmax, (const int32_t*)src,
        (const uint8_t*)mask, (float*)e_edge, (float*)denom, (float*)deg, E,
        N, H);
    return (int)cudaGetLastError();
  }
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

// out (G, N, HD) f32 arrives seeded and is added to in place. route 0: the
// warp-per-edge kernel; route 1: a block per (graph, part of its slots
// sorted by destination), which takes heads of at least 8 features, N and E
// up to 65536 and the shared memory of sorted_smem (rows = 2).
extern "C" int gat_unproj_aggr(const void* nm, const void* emb,
                               const void* e_edge, const void* scale,
                               const void* src, const void* dst,
                               const void* mask, void* out, int G, int N,
                               int E, int HD, int H, int lm, int lb, int lo,
                               int dtype, int route, void* stream) {
  const int el = dtype == 1 ? 2 : 4;
  if (!shapes_ok(HD, H) || !rows_ok(nm, lm, HD, el) ||
      !rows_ok(emb, lb, HD, el) || !rows_ok(out, lo, HD, 4) ||
      (route != 0 && route != 1) ||
      (route == 1 && !sorted_ok(N, E, HD, H, dtype == 1 ? 2 : 4, 2)))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype == 1) {
      typedef __nv_bfloat16 T;
      return (int)launch_sorted(
          aggr_graph_kernel<T>, G, sorted_smem(N, E, HD, 2, 2), E, s,
          (const T*)nm, (const T*)emb,
          (const float*)e_edge, (const float*)scale, (const int32_t*)src,
          (const int32_t*)dst, (const uint8_t*)mask, (float*)out, E, N, HD,
          H, lm, lb, lo);
    }
    typedef float T;
    return (int)launch_sorted(
        aggr_graph_kernel<T>, G, sorted_smem(N, E, HD, 4, 2), E, s,
        (const T*)nm, (const T*)emb,
        (const float*)e_edge, (const float*)scale, (const int32_t*)src,
        (const int32_t*)dst, (const uint8_t*)mask, (float*)out, E, N, HD, H,
        lm, lb, lo);
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    aggr_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (float*)out, E, N, HD, H, lm, lb, lo);
  } else {
    typedef float T;
    aggr_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (float*)out, E, N, HD, H, lm, lb, lo);
  }
  return (int)cudaGetLastError();
}

// demb (G, E, HD) and dalpha (G, H, E) are written whole; dscale (G, N, H)
// and dnm (G, N, HD) f32 arrive seeded and are added to in place. route 0:
// the warp-per-edge kernel; route 1: a block per (graph, part of its slots
// sorted by source), which takes what route 1 of gat_unproj_aggr takes,
// with sorted_smem's rows = 3. part as in gat_unproj_scores: a column slice
// adds its d_alpha to the slices' before it, and only the last adds the
// whole d_alpha * e into dscale.
extern "C" int gat_unproj_bwd1(const void* gout, const void* nm,
                               const void* emb, const void* e_edge,
                               const void* scale, const void* src,
                               const void* dst, const void* mask, void* demb,
                               void* dalpha, void* dscale, void* dnm, int G,
                               int N, int E, int HD, int H, int lg, int lm,
                               int lb, int ld, int ldn, int dtype, int route,
                               int part, void* stream) {
  const int el = dtype == 1 ? 2 : 4;
  if (!shapes_ok(HD, H) || !rows_ok(gout, lg, HD, el) ||
      !rows_ok(nm, lm, HD, el) || !rows_ok(emb, lb, HD, el) ||
      !rows_ok(demb, ld, HD, el) || !rows_ok(dnm, ldn, HD, 4) ||
      (route != 0 && route != 1) || part < 0 || part > 3 ||
      (route == 1 && !sorted_ok(N, E, HD, H, dtype == 1 ? 2 : 4, 3)))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype == 1) {
      typedef __nv_bfloat16 T;
      return (int)launch_sorted(
          part ? bwd1_graph_kernel<T, true> : bwd1_graph_kernel<T, false>, G,
          sorted_smem(N, E, HD, 2, 3), E, s,
          (const T*)gout, (const T*)nm,
          (const T*)emb, (const float*)e_edge, (const float*)scale,
          (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
          (T*)demb, (float*)dalpha, (float*)dscale, (float*)dnm, E, N, HD,
          H, lg, lm, lb, ld, ldn, part);
    }
    typedef float T;
    return (int)launch_sorted(
        part ? bwd1_graph_kernel<T, true> : bwd1_graph_kernel<T, false>, G,
        sorted_smem(N, E, HD, 4, 3), E, s,
        (const T*)gout, (const T*)nm,
        (const T*)emb, (const float*)e_edge, (const float*)scale,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (T*)demb, (float*)dalpha, (float*)dscale, (float*)dnm, E, N, HD, H,
        lg, lm, lb, ld, ldn, part);
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    bwd1_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)gout, (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (T*)demb, (float*)dalpha, (float*)dscale,
        (float*)dnm, E, N, HD, H, lg, lm, lb, ld, ldn, part);
  } else {
    typedef float T;
    bwd1_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)gout, (const T*)nm, (const T*)emb, (const float*)e_edge,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (T*)demb, (float*)dalpha, (float*)dscale,
        (float*)dnm, E, N, HD, H, lg, lm, lb, ld, ldn, part);
  }
  return (int)cudaGetLastError();
}

// dekb (G, E, HD) is written whole; dnq and dnk (G, N, HD) f32 arrive seeded
// and are added to in place. route 0: the warp-per-edge kernel; route 1: a
// block per (graph, slice of cw columns), which takes heads of at least 8
// features, E <= 65536 and the shared memory of bwd2_smem.
extern "C" int gat_unproj_bwd2(const void* nq, const void* nk,
                               const void* ekb, const void* e_edge,
                               const void* dalpha, const void* scale,
                               const void* d_denom, const void* src,
                               const void* dst, const void* mask, void* dekb,
                               void* dnq, void* dnk, int G, int N, int E,
                               int HD, int H, int lq, int lk, int lb,
                               int lde, int ldq, int ldk, int dtype,
                               int route, int cw, void* stream) {
  const int el = dtype == 1 ? 2 : 4;
  if (!shapes_ok(HD, H) || !rows_ok(nq, lq, HD, el) ||
      !rows_ok(nk, lk, HD, el) || !rows_ok(ekb, lb, HD, el) ||
      !rows_ok(dekb, lde, HD, el) || !rows_ok(dnq, ldq, HD, 4) ||
      !rows_ok(dnk, ldk, HD, 4) || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const int dph = HD / H;
    if (N <= 0 || N > 65536 || E > 65536 || cw <= 0 || cw % 8 || dph < 8)
      return (int)cudaErrorInvalidValue;
    int hs = 1;
    for (int c0 = 0; c0 < HD; c0 += cw)
      hs = max(hs, slice_heads(c0, min(cw, HD - c0), dph));
    const size_t smem = bwd2_smem(N, E, cw, hs, dtype == 1 ? 2 : 4);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    const dim3 grid((HD + cw - 1) / cw, G);
    if (dtype == 1) {
      typedef __nv_bfloat16 T;
      const cudaError_t err = set_smem(bwd2_graph_kernel<T>, smem);
      if (err != cudaSuccess) return (int)err;
      bwd2_graph_kernel<T><<<grid, BT, smem, s>>>(
          (const T*)nq, (const T*)nk, (const T*)ekb, (const float*)e_edge,
          (const float*)dalpha, (const float*)scale, (const float*)d_denom,
          (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
          (T*)dekb, (float*)dnq, (float*)dnk, E, N, HD, H, lq, lk, lb, lde,
          ldq, ldk, cw);
    } else {
      typedef float T;
      const cudaError_t err = set_smem(bwd2_graph_kernel<T>, smem);
      if (err != cudaSuccess) return (int)err;
      bwd2_graph_kernel<T><<<grid, BT, smem, s>>>(
          (const T*)nq, (const T*)nk, (const T*)ekb, (const float*)e_edge,
          (const float*)dalpha, (const float*)scale, (const float*)d_denom,
          (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
          (T*)dekb, (float*)dnq, (float*)dnk, E, N, HD, H, lq, lk, lb, lde,
          ldq, ldk, cw);
    }
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    bwd2_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const float*)e_edge,
        (const float*)dalpha, (const float*)scale, (const float*)d_denom,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (T*)dekb, (float*)dnq, (float*)dnk, E, N, HD, H, lq, lk, lb, lde,
        ldq, ldk);
  } else {
    typedef float T;
    bwd2_kernel<T><<<edge_grid(G, E), UTHREADS, 0, s>>>(
        (const T*)nq, (const T*)nk, (const T*)ekb, (const float*)e_edge,
        (const float*)dalpha, (const float*)scale, (const float*)d_denom,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (T*)dekb, (float*)dnq, (float*)dnk, E, N, HD, H, lq, lk, lb, lde,
        ldq, ldk);
  }
  return (int)cudaGetLastError();
}
