// Route 1 of the edge-encoder hidden pass and its backward, in bfloat16 and
// float32, at every width D >= 1 and F <= 64 (the one-hot mask is 64 bits).
//
// Replace, beside the CUDA-core kernels of edge_hidden.cu, the TPU kernels
// `_hidden_fwd_kernel` (qagnn_tpu/ops/pallas_edge_encoder.py:164, launched
// by `_hidden_impl` :234) and `_hidden_bwd_kernel` (:179, launched by
// `_hidden_bwd_impl` :291).
//
// Bound on the H100: bytes, both ways. The forward writes h (G, E, D) once
// (105 MB in bf16 at G=64, E=4096, D=200: 31 us at 3.35 TB/s; twice that in
// f32), the backward reads dh of the same size once; three int32 per slot
// and the (F, D) W0 are small beside it.
//
// Both kernels work on a column slice [c0, c0 + w) of D (blockIdx.y; the
// wrapper plans the slices, `tc_fwd_slices` / `tc_bwd_slices` in
// ops/edge_encoder_kernels.py) and hold that slice of W0, in the compute
// dtype (rounded to bf16 in bf16, as the TPU's one-hot contraction rounds
// it), and a type table U in shared memory, rows padded with zeros to
// Wp = w rounded up to 8 columns: U[ts * n_ntype + td] = W0[n_rel + ts] +
// W0[n_rel + n_ntype + td] + b0 (f32), so a slot's x0 is its relation's W0
// row plus one U row (the sum in another order than the plain version's,
// f32 rounding apart). A relation id outside [0, n_rel) sets no relation
// feature, as in the TPU kernel's one-hot: it is packed as row F, a row of
// zeros after W0's F rows in shared memory, and its one-hot mask has no
// relation bit, so no read falls outside W0 and dW0 gets nothing for it.
// They walk tiles of 16 consecutive slots of the flattened (G * E) slot
// axis. A slot's relation r and type pair t are packed into one int; they
// come from a chain of dependent loads (the slot's ints, then the two node
// types). A lane works on chunks of columns (the forward's 16 bytes of h, 8
// columns in bf16 and 4 in f32, so that a warp's store is one contiguous
// span; the backward's 8 columns), padded past w; a row of h or dh is
// D * sizeof(T) bytes, so a chunk starts at a multiple of the largest power
// of two up to 16 that divides that (`eh_piece`, a template parameter: as
// a run-time value its branches doubled the loops' instructions): the
// kernels move h and dh in pieces of that size, and the columns past w of
// the last chunk are neither stored nor read.
//
// Forward (`edge_hidden_tc_kernel<T>`): persistent warps, each on every n-th
// tile of the n warps of its slice, so that the warps write neighbouring
// tiles at any moment (the card took longer with a contiguous range a
// warp). Lanes 0..15 run the chain of loads two tiles ahead in registers (a
// tile's ints are loaded one tile before their node types are gathered, and
// those one tile before they are packed and used), so no load is waited on
// in the tile where it was issued. The warp walks a tile's rows window by
// window, 32 chunks (256 columns in bf16, 128 in f32) a window; in a window
// of c < 32 chunks it takes 32 / c slots at once, a lane on one chunk. So
// the chain runs once a slot at any width whose tables fit: a slice is all
// of D unless W0 and U at D need more than half the SM's shared memory
// (`EH_FWD_SMEM`: two blocks of 8 warps an SM), and then the fewest slices
// whose tables fit. Rows of one window (every preset) run a kernel of their
// own, whose loop is the one-window loop alone.
//
// Backward (`edge_hidden_bwd_tc_kernel<T, NT>`): `edge_rows_kernel` first
// runs the chain once for every slot (packed row and the 64-bit mask of its
// one-hot feature row, 12 bytes a slot), once for all slices. Then the
// blocks of each slice, at most `EH_BWD_COLS` = 256 columns (one warp for
// each 16-column m-tile, 16 at most), walk contiguous ranges of tiles; every
// warp goes through every tile alone, with no barrier between warps. Lane l
// takes slot l / 2 and 8-column chunk l % 2 of its warp's m-tile: its
// chunk of dh, read in place at dh's row stride D, and its slot's row and
// mask arrive by cp.async in a private ring cell EHB_STAGES - 1 tiles ahead
// (the lane alone reads its cell). cp.async moves 4, 8 or 16 bytes, so the
// chunk comes as 16 / 8 / 4-byte pieces where rows are aligned so (D % 8,
// D % 4, D % 2 == 0 in bf16; every D in f32): one ring for every width at no
// cost where D % 8 == 0. A bf16 row of odd D starts on a 2-byte boundary,
// which no cp.async takes: there the lane loads its chunk's values itself
// when it reaches the tile (no width of any preset is odd). The lane forms
// x0, the relu mask, d_pre and d_x0 in f32, folds db, da and db0 into
// registers from the unrounded values (as the CUDA-core kernel does) and
// writes d_x0 into the warp's 16 x 16 tile. Then dW0^T (16 columns x F) +=
// dxc^T (16 x 16 slots) onehot (16 slots x F) on tensor cores, NT x 4
// accumulators a lane, B the one-hot built in registers from the masks
// (1.0 where the column is one of the slot's three rows):
//   * bf16: the tile holds bf16(d_x0), A is read with ldmatrix.trans and
//     multiplied by mma.sync m16n8k16 into the accumulators; a product of
//     1.0 and a bf16 value summed in f32 is the sum the TPU's one-hot
//     dot_general forms (pallas_edge_encoder.py:208-210), up to order;
//   * f32: the plain version does not round d_x0, so the tile holds it in
//     f32 and the product is mma.sync m16n8k8 on tf32: 1.0 is exact in
//     tf32, so only d_x0 is split (hi = tf32(d_x0), lo = d_x0 - hi; two
//     products, lo then hi, where the GAT passes need three). The tensor
//     core's own f32 sum truncates (mma_tile.cuh `mma_split_tf32`), so a
//     tile's products go into a fresh accumulator that FADD then adds to
//     the running one.
// It replaces three shared read-modify-writes per slot and column. Each
// block writes one partial row of (F + 3) x D once (each warp its own
// columns of its slice), and reduce_partials_kernel adds the blocks' rows,
// so the result does not depend on the order the blocks ran in.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned EH_FULL = 0xffffffffu;
constexpr int EH_TILE = 16;              // slots of a tile
constexpr int EH_MAX_F = 64;             // rows of W0: bits of a slot's mask
constexpr int EH_SMEM = 232448;          // shared memory a block may opt into
constexpr int EH_FWD_SMEM = EH_SMEM / 2;  // forward tables: two blocks an SM
constexpr int EH_BWD_COLS = 256;         // backward slice: 16 warps of 16

constexpr int EHF_THREADS = 256;         // forward block

// backward: tiles in a lane's ring and the ring cell (the lane's 8 values
// of dh, then its slot's packed row at +8 sizeof(T) and mask at +8
// sizeof(T) + 8); f32 cells hold twice the bytes, so half the tiles
template <typename T> struct Ehb;
template <> struct Ehb<bf16> {
  static constexpr int STAGES = 8, CELL = 32, XLD = 24;  // tile pitch, bf16
};
template <> struct Ehb<float> {
  static constexpr int STAGES = 4, CELL = 48, XLD = 24;  // tile pitch, f32
};

__host__ __device__ constexpr int eh_round8(int x) { return (x + 7) / 8 * 8; }

// the bytes at which a row of D values of `size` bytes starts: the largest
// power of two up to 16 that divides D * size
__host__ __device__ constexpr int eh_piece(int D, int size) {
  return (D * size) % 16 == 0 ? 16 : (D * size) % 8 == 0 ? 8
         : (D * size) % 4 == 0 ? 4 : 2;
}

// The slot's relation and the flat indices of its two nodes' types (-1
// where the slot does not exist or `live` is false).
__device__ __forceinline__ void eh_load_ints(
    const int32_t* __restrict__ etype, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, bool live, long long s,
    long long n_edges, int E, int N, int& et, long long& si,
    long long& di) {
  et = 0;
  si = di = -1;
  if (live && s < n_edges) {
    const long long g = s / E;
    et = etype[s];
    si = g * N + src[s];
    di = g * N + dst[s];
  }
}

__device__ __forceinline__ void eh_gather(const int32_t* __restrict__ ntype,
                                          long long si, long long di,
                                          int& ts, int& td) {
  ts = si >= 0 ? ntype[si] : -1;
  td = di >= 0 ? ntype[di] : 0;
}

// shared memory of both kernels at Wp columns: W0 (T) and a zero row after
// it, then the type table U (f32)
template <typename T>
__host__ __device__ constexpr int eh_w0_bytes(int F, int Wp) {
  return ((F + 1) * Wp * (int)sizeof(T) + 15) / 16 * 16;
}
__host__ __device__ constexpr int eh_u_bytes(int Wp, int n_ntype) {
  return n_ntype * n_ntype * Wp * 4;
}
template <typename T>
__host__ __device__ constexpr int eh_tables_bytes(int F, int Wp,
                                                  int n_ntype) {
  return eh_w0_bytes<T>(F, Wp) + eh_u_bytes(Wp, n_ntype);
}

// v[j] = p[j] for j < n (n <= W, W 4 or 8), 0 past it; 16-byte loads
// where `vec` says p is 16-byte aligned and n is W
template <int W>
__device__ __forceinline__ void eh_gload(const float* __restrict__ p, int n,
                                         bool vec, float (&v)[W]) {
  if (vec && n == W) {
#pragma unroll
    for (int k = 0; k < W; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = j < n ? p[j] : 0.0f;
  }
}

// 8 values of a shared row of T at p (16-byte aligned), as f32, and back
// (the word is copied into registers first: unpacked where it lies, it is
// read as eight 2-byte loads)
__device__ __forceinline__ void eh_sload(const bf16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  unpack_bf16x8(q, v);
}
template <int W>
__device__ __forceinline__ void eh_sload(const float* p, float (&v)[W]) {
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + k);
    v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
  }
}
__device__ __forceinline__ void eh_sstore8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(v);
}
__device__ __forceinline__ void eh_sstore8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// The slice [c0, c0 + w) of W0 (F, D) f32 -> sW (F + 1, Wp) T, row F and
// the columns past w zeros (the relation row of an id out of range), and
// the type table sU (n_ntype^2, Wp) f32, U[ts * n_ntype + td] =
// W0[n_rel + ts] + W0[n_rel + n_ntype + td] + b0 (the rows as sW holds them,
// summed in f32): then x0 = W0[r] + U[t]. The whole block; the caller
// synchronises.
template <typename T>
__device__ __forceinline__ void eh_load_tables(T* sW, float* sU,
                                               const float* __restrict__ w0,
                                               const float* __restrict__ b0,
                                               int F, int D, int c0, int w,
                                               int n_rel, int n_ntype) {
  const int Wp = eh_round8(w), chunks = Wp / 8;
  if (w == D && D % 8 == 0) {
    // the slice is all of W0: its rows are sW's, one flat copy
    for (int i = threadIdx.x; i < (F + 1) * chunks; i += blockDim.x) {
      float v[8];
      eh_gload(w0 + 8 * i, i < F * chunks ? 8 : 0, true, v);
      eh_sstore8(sW + 8 * i, v);
    }
  } else {
    const bool vec = D % 4 == 0;
    for (int i = threadIdx.x; i < (F + 1) * chunks; i += blockDim.x) {
      const int r = i / chunks, c8 = i % chunks * 8;
      float v[8];
      eh_gload(w0 + (long long)r * D + c0 + c8, r < F ? min(8, w - c8) : 0,
               vec, v);
      eh_sstore8(sW + r * Wp + c8, v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_ntype * n_ntype * chunks; i += blockDim.x) {
    const int t = i / chunks, c8 = i % chunks * 8;
    float r1[8], r2[8], bb[8];
    eh_sload(sW + (n_rel + t / n_ntype) * Wp + c8, r1);
    eh_sload(sW + (n_rel + n_ntype + t % n_ntype) * Wp + c8, r2);
    eh_gload(b0 + c0 + c8, min(8, w - c8), true, bb);
    float u[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) u[j] = r1[j] + r2[j] + bb[j];
    eh_sstore8(sU + t * Wp + c8, u);
  }
}

// x0 of the lane's W columns (8 in bf16; 4 or 8 in f32) from column c of
// a slot packed as r | t << 8: its relation's W0 row and its type pair's U
// row
template <typename T, int W>
__device__ __forceinline__ void eh_x0(const T* sW, const float* sU, int Wp,
                                      int c, int p, float (&x0)[W]) {
  float w[W];
  eh_sload(sW + (p & 255) * Wp + c, w);
  const float* u = sU + (p >> 8) * Wp + c;
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(u + k);
    x0[k] = w[k] + q.x; x0[k + 1] = w[k + 1] + q.y;
    x0[k + 2] = w[k + 2] + q.z; x0[k + 3] = w[k + 3] + q.w;
  }
}

// a slot's relation row r (its id, or F, the zero row, for an id outside
// [0, n_rel)) and type pair t = ts * n_ntype + td as r | t << 8 (0 for a
// slot that does not exist: nothing reads it)
__device__ __forceinline__ int eh_pack(int et, int ts, int td, int n_rel,
                                       int n_ntype) {
  const int r = (unsigned)et < (unsigned)n_rel ? et : n_rel + 2 * n_ntype;
  return ts < 0 ? 0 : r | (ts * n_ntype + td) << 8;
}

// ---------------------------------------------------------------------------
// forward: h = relu(a * x0 + b) in T
// ---------------------------------------------------------------------------

// The first n (a multiple of PIECE / sizeof(T)) of a lane's 16 bytes of
// values (8 bf16, 4 f32) to dst, a row chunk that starts on a multiple of
// PIECE bytes, in pieces of that size
template <int PIECE>
__device__ __forceinline__ void eh_store(bf16* dst, const float (&h)[8],
                                         int n) {
  const uint4 q = pack_bf16x8(h);
  if constexpr (PIECE == 16) {
    *reinterpret_cast<uint4*>(dst) = q;
  } else if constexpr (PIECE == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(q.x, q.y);
    if (n > 4) *reinterpret_cast<uint2*>(dst + 4) = make_uint2(q.z, q.w);
  } else if constexpr (PIECE == 4) {
    const uint32_t v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (2 * k < n) *reinterpret_cast<uint32_t*>(dst + 2 * k) = v[k];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < n) dst[k] = __float2bfloat16(h[k]);
  }
}
template <int PIECE>
__device__ __forceinline__ void eh_store(float* dst, const float (&h)[4],
                                         int n) {
  if constexpr (PIECE == 16) {
    *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
  } else if constexpr (PIECE == 8) {
    *reinterpret_cast<float2*>(dst) = make_float2(h[0], h[1]);
    if (n > 2) *reinterpret_cast<float2*>(dst + 2) = make_float2(h[2], h[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < n) dst[k] = h[k];
  }
}

// persistent blocks, blockIdx.y the column slice of `width` columns; warp w
// of the slice's n walks tiles w, w + n, ..., so that the warps' stores at
// any moment fall on neighbouring tiles. PIECE: eh_piece(D, sizeof(T));
// WINDOWS: a row of the slice is more than 32 chunks (a separate kernel, so
// that the one-window loop stays as lean as it can be).
template <typename T, int PIECE, bool WINDOWS>
__global__ void __launch_bounds__(EHF_THREADS)
edge_hidden_tc_kernel(const int32_t* __restrict__ etype,
                      const int32_t* __restrict__ src,
                      const int32_t* __restrict__ dst,
                      const int32_t* __restrict__ ntype,
                      const float* __restrict__ w0,
                      const float* __restrict__ b0,
                      const float* __restrict__ a,
                      const float* __restrict__ b, T* __restrict__ out,
                      long long n_edges, int E, int N, int D, int F,
                      int n_rel, int n_ntype, int width) {
  extern __shared__ __align__(16) unsigned char eh_smem[];
  const int c0 = blockIdx.y * width, w = min(width, D - c0);
  const int Wp = eh_round8(w);
  T* sW = reinterpret_cast<T*>(eh_smem);
  float* sU = reinterpret_cast<float*>(eh_smem + eh_w0_bytes<T>(F, Wp));
  eh_load_tables(sW, sU, w0, b0, F, D, c0, w, n_rel, n_ntype);
  __syncthreads();

  // a lane's chunk: 16 bytes of a row of h, CW columns
  constexpr int CW = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31;
  const int chunks = (w + CW - 1) / CW, n_win = (chunks + 31) / 32;
  // the lane's place in a window of cw chunks: chunk lane % cw of slot
  // lane / cw of each group of rows_per slots
  int cw, ci, sl, rows_per;
  float av[CW], bv[CW];
  auto window = [&](int win) {
    cw = min(32, chunks - 32 * win);
    rows_per = min(32 / cw, EH_TILE);
    ci = lane % cw;
    sl = lane / cw;
    const int c = (32 * win + ci) * CW, n = max(0, min(CW, w - c));
    eh_gload(a + c0 + c, n, true, av);
    eh_gload(b + c0 + c, n, true, bv);
  };
  window(0);

  const long long n_tiles = (n_edges + EH_TILE - 1) / EH_TILE;
  const long long n_warps = (long long)gridDim.x * (blockDim.x / 32);
  const long long warp = (long long)blockIdx.x * (blockDim.x / 32) +
                         threadIdx.x / 32;
  if (warp >= n_tiles) return;

  // the pipeline of packed slots: `packed` of this warp's tile t, (etB,
  // tsB, tdB) of its next tile gathered, (etC, siC, diC) of the one after
  // loaded
  const bool row_lane = lane < EH_TILE;
  int etB, tsB, tdB, etC;
  long long siC, diC;
  auto load_c = [&](long long t) {
    eh_load_ints(etype, src, dst, row_lane && t < n_tiles, t * EH_TILE + lane,
                 n_edges, E, N, etC, siC, diC);
  };
  auto gather_b = [&]() {
    etB = etC;
    eh_gather(ntype, siC, diC, tsB, tdB);
  };
  load_c(warp);
  gather_b();
  int packed = eh_pack(etB, tsB, tdB, n_rel, n_ntype);
  load_c(warp + n_warps);
  gather_b();
  load_c(warp + 2 * n_warps);

  // the slots of tile t in the lane's chunk of window `win`, then the
  // pipeline a tile on
  auto slots = [&](long long t, int win) {
    const long long base = t * EH_TILE;
    const int n = n_edges - base < EH_TILE ? (int)(n_edges - base) : EH_TILE;
    const int c = (32 * win + ci) * CW, nc = min(CW, w - c);
    const bool col_live = sl < rows_per;
#pragma unroll 4
    for (int s = sl; s < EH_TILE + sl; s += rows_per) {
      const int p = __shfl_sync(EH_FULL, packed, s & (EH_TILE - 1));
      if (col_live && s < n) {
        float x0[CW], h[CW];
        eh_x0(sW, sU, Wp, c, p, x0);
#pragma unroll
        for (int j = 0; j < CW; ++j)
          h[j] = fmaxf(av[j] * x0[j] + bv[j], 0.0f);
        eh_store<PIECE>(out + (base + s) * D + c0 + c, h, nc);
      }
    }
  };
  auto advance = [&](long long t) {
    packed = eh_pack(etB, tsB, tdB, n_rel, n_ntype);
    gather_b();
    load_c(t + 3 * n_warps);
  };
  if (!WINDOWS) {            // a and b of the lane's one chunk stay loaded
    for (long long t = warp; t < n_tiles; t += n_warps) {
      slots(t, 0);
      advance(t);
    }
    return;
  }
  for (long long t = warp; t < n_tiles; t += n_warps) {
    for (int win = 0; win < n_win; ++win) {
      window(win);
      slots(t, win);
    }
    advance(t);
  }
}

// ---------------------------------------------------------------------------
// backward: dW0, db0, da, db from dh
// ---------------------------------------------------------------------------

// Shared memory: W0 and U, then per warp a ring of Ehb<T>::STAGES cells of
// its 32 lanes and a 16 x 16 tile of d_x0 in T (pitch Ehb<T>::XLD).
template <typename T>
__host__ __device__ constexpr int ehb_warp_bytes() {
  return Ehb<T>::STAGES * 32 * Ehb<T>::CELL +
         EH_TILE * Ehb<T>::XLD * (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int ehb_smem_bytes(int F, int width,
                                                 int n_ntype) {
  return eh_tables_bytes<T>(F, eh_round8(width), n_ntype) +
         (width + 15) / 16 * ehb_warp_bytes<T>();
}

// Every slot's relation and type pair, packed by eh_pack, and its one-hot
// feature row as a 64-bit mask (bits r where 0 <= r < n_rel,
// n_rel + ts, n_rel + n_ntype + td); both 0 from n_edges to n_pad. The
// backward's chain of dependent loads, run once before it (one thread a
// slot) so that a tile's rows arrive by cp.async beside its dh.
__global__ void edge_rows_kernel(const int32_t* __restrict__ etype,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ dst,
                                 const int32_t* __restrict__ ntype,
                                 int* __restrict__ rows,
                                 uint2* __restrict__ masks, long long n_edges,
                                 long long n_pad, int E, int N, int n_rel,
                                 int n_ntype) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_pad) return;
  int et, ts, td;
  long long si, di;
  eh_load_ints(etype, src, dst, true, s, n_edges, E, N, et, si, di);
  eh_gather(ntype, si, di, ts, td);
  const unsigned long long rel_bit =
      (unsigned)et < (unsigned)n_rel ? 1ull << et : 0ull;
  const unsigned long long m =
      ts < 0 ? 0ull
             : rel_bit | 1ull << (n_rel + ts) |
                   1ull << (n_rel + n_ntype + td);
  rows[s] = eh_pack(et, ts, td, n_rel, n_ntype);
  masks[s] = make_uint2((unsigned)m, (unsigned)(m >> 32));
}

// The first `bytes` (a multiple of PIECE) of 8 values of T from global
// src to shared dst, both aligned to PIECE (16, 8 or 4), by cp.async
template <typename T, int PIECE>
__device__ __forceinline__ void eh_cp_async(unsigned char* dst,
                                            const T* src, int bytes) {
  const char* s = reinterpret_cast<const char*>(src);
#pragma unroll
  for (int o = 0; o < 8 * (int)sizeof(T); o += PIECE) {
    if (o < bytes) {
      if constexpr (PIECE == 16)
        cp_async16(dst + o, s + o);
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                     :
                     : "r"(shared_addr(dst + o)), "l"(s + o), "n"(PIECE)
                     : "memory");
    }
  }
}

// the lane's 8 values of dh, 0 past n: from its ring cell, or, for a bf16
// row that starts on a 2-byte boundary (PIECE 2), from dh itself at `row`
template <int PIECE>
__device__ __forceinline__ void eh_cell_dh(const unsigned char* cell,
                                           const bf16* row, int n,
                                           float (&d)[8]) {
  if constexpr (PIECE == 2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) d[j] = j < n ? __bfloat162float(row[j]) : 0.0f;
  } else {
    eh_sload(reinterpret_cast<const bf16*>(cell), d);
    if constexpr (PIECE != 16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = j < n ? d[j] : 0.0f;
    }
  }
}
template <int PIECE>
__device__ __forceinline__ void eh_cell_dh(const unsigned char* cell,
                                           const float*, int n,
                                           float (&d)[8]) {
  eh_sload(reinterpret_cast<const float*>(cell), d);
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = j < n ? d[j] : 0.0f;
}

// the lane's d_x0 values into the warp's tile, slot row `slot`, columns
// 8 (lane & 1) on
__device__ __forceinline__ void eh_tile_store(bf16* xt, int slot, int lane,
                                              const float (&v)[8]) {
  *reinterpret_cast<uint4*>(xt + slot * Ehb<bf16>::XLD + (lane & 1) * 8) =
      pack_bf16x8(v);
}
__device__ __forceinline__ void eh_tile_store(float* xt, int slot, int lane,
                                              const float (&v)[8]) {
  eh_sstore8(xt + slot * Ehb<float>::XLD + (lane & 1) * 8, v);
}

// dW0^T (this m-tile's 16 columns) += dxc^T onehot over the tile's 16
// slots. bf16: the lane's B fragments hold column f = 8 j + lane / 4 of
// slots k0, k0 + 1, k0 + 8, k0 + 9 (k0 = 2 (lane % 4)), whose masks sit with
// lanes 2 k. f32: those of slots t, t + 4, t + 8, t + 12 (t = lane % 4).
template <int NT>
__device__ __forceinline__ void eh_onehot_product(const bf16* xt, int lane,
                                                  const uint2& m,
                                                  float (&acc)[NT][4]) {
  const int k0 = 2 * (lane & 3), q = lane >> 2;
  uint2 mk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int src = 2 * (k0 + (i & 1) + (i >> 1) * 8);
    mk[i].x = __shfl_sync(EH_FULL, m.x, src);
    mk[i].y = __shfl_sync(EH_FULL, m.y, src);
  }
  uint32_t af[4];
  ldmatrix_x4_trans(af, a_frag_ptr_trans(xt, Ehb<bf16>::XLD, lane));
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint32_t one = 0x3F80u;
    auto bit = [&](const uint2& v) {
      return ((j < 4 ? v.x : v.y) >> (8 * (j & 3) + q) & 1u) * one;
    };
    mma_bf16_16x8x16(acc[j], af, bit(mk[0]) | bit(mk[1]) << 16,
                     bit(mk[2]) | bit(mk[3]) << 16);
  }
}
template <int NT>
__device__ __forceinline__ void eh_onehot_product(const float* xt, int lane,
                                                  const uint2& m,
                                                  float (&acc)[NT][4]) {
  constexpr int L = Ehb<float>::XLD;
  const int t = lane & 3, g = lane >> 2;
  uint2 mk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mk[i].x = __shfl_sync(EH_FULL, m.x, 2 * (t + 4 * i));
    mk[i].y = __shfl_sync(EH_FULL, m.y, 2 * (t + 4 * i));
  }
  // A (column d, slot k) = tile[k][d]: a0..a3 at (g, t), (g + 8, t),
  // (g, t + 4), (g + 8, t + 4) of each 8-slot step
  uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float* r0 = xt + (8 * s + t) * L;
    const float* r1 = xt + (8 * s + t + 4) * L;
    const float v[4] = {r0[g], r0[g + 8], r1[g], r1[g + 8]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], a_hi[s][i], a_lo[s][i]);
  }
  float fresh[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) fresh[j][r] = 0.0f;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t one = 0x3F800000u;
      auto bit = [&](const uint2& v) {
        return ((j < 4 ? v.x : v.y) >> (8 * (j & 3) + g) & 1u) * one;
      };
      const uint32_t b0 = bit(mk[2 * s]), b1 = bit(mk[2 * s + 1]);
      mma_tf32_16x8x8(fresh[j], a_lo[s], b0, b1);
      mma_tf32_16x8x8(fresh[j], a_hi[s], b0, b1);
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] += fresh[j][r];
}

// NT: 8-column tiles of F (F <= 8 NT). rows, masks: edge_rows_kernel's.
// blockIdx.y the column slice of `width` columns, one warp for each
// 16-column m-tile of it; every warp of a block walks the block's tiles
// alone, lane l on slot l / 2 and 8-column chunk l % 2 of its m-tile.
// PIECE: eh_piece(D, sizeof(T)).
template <typename T, int NT, int PIECE>
__global__ void __launch_bounds__(512, 1)
edge_hidden_bwd_tc_kernel(const int* __restrict__ rows_in,
                          const uint2* __restrict__ masks_in,
                          const float* __restrict__ w0,
                          const float* __restrict__ b0,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const T* __restrict__ dh,
                          float* __restrict__ part, long long n_edges, int D,
                          int F, int n_rel, int n_ntype, int width) {
  constexpr int STAGES = Ehb<T>::STAGES, CELL = Ehb<T>::CELL;
  extern __shared__ __align__(16) unsigned char eh_smem[];
  const int c0 = blockIdx.y * width, w = min(width, D - c0);
  const int Wp = eh_round8(w);
  T* sW = reinterpret_cast<T*>(eh_smem);
  float* sU = reinterpret_cast<float*>(eh_smem + eh_w0_bytes<T>(F, Wp));
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  unsigned char* mine = eh_smem + eh_tables_bytes<T>(F, Wp, n_ntype) +
                        warp * ehb_warp_bytes<T>();
  T* xt = reinterpret_cast<T*>(mine + STAGES * 32 * CELL);
  eh_load_tables(sW, sU, w0, b0, F, D, c0, w, n_rel, n_ntype);
  __syncthreads();
  if (warp * 16 >= w) return;          // a warp past the last slice's end

  const int slot = lane >> 1;
  const int c8 = (2 * warp + (lane & 1)) * 8;
  const int nc = max(0, min(8, w - c8));
  const bool live = nc > 0;
  float av[8], bv[8], s_db0[8], s_da[8], s_db[8];
  eh_gload(a + c0 + c8, nc, true, av);
  eh_gload(b + c0 + c8, nc, true, bv);
#pragma unroll
  for (int j = 0; j < 8; ++j) s_db0[j] = s_da[j] = s_db[j] = 0.0f;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;

  const long long n_tiles = (n_edges + EH_TILE - 1) / EH_TILE;
  const long long t0 = (long long)blockIdx.x * n_tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * n_tiles / gridDim.x;

  // the lane's dh chunk and its slot's packed row and mask of tile t -> its
  // cell of stage (t - t0) % STAGES, as one cp.async group; only the lane
  // itself reads the cell
  auto prefetch = [&](long long t) {
    if (t < t1) {
      const long long s = t * EH_TILE + slot;
      unsigned char* cell =
          mine + ((int)((t - t0) % STAGES) * 32 + lane) * CELL;
      if (PIECE > 2 && live && s < n_edges)
        eh_cp_async<T, PIECE>(cell, dh + s * D + c0 + c8,
                              nc * (int)sizeof(T));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :
                   : "r"(shared_addr(cell + 8 * sizeof(T))), "l"(rows_in + s)
                   : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :
                   : "r"(shared_addr(cell + 8 * sizeof(T) + 8)),
                     "l"(masks_in + s)
                   : "memory");
    }
    cp_async_commit();
  };
  for (int k = 0; k < STAGES - 1; ++k) prefetch(t0 + k);

  for (long long t = t0; t < t1; ++t) {
    cp_async_wait<STAGES - 2>();
    const unsigned char* cell =
        mine + ((int)((t - t0) % STAGES) * 32 + lane) * CELL;
    const int p = *reinterpret_cast<const int*>(cell + 8 * sizeof(T));
    const uint2 m = *reinterpret_cast<const uint2*>(cell + 8 * sizeof(T) + 8);
    const long long s = t * EH_TILE + slot;
    const bool valid = live && s < n_edges;
    float d[8];
    if (valid) eh_cell_dh<PIECE>(cell, dh + s * D + c0 + c8, nc, d);
    prefetch(t + STAGES - 1);

    // elementwise: d_x0 -> the warp's tile, the f32 sums in registers
    float dxc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dxc[j] = 0.0f;
    if (valid) {
      float x0[8];
      eh_x0(sW, sU, Wp, c8, p, x0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d_pre = av[j] * x0[j] + bv[j] > 0.0f ? d[j] : 0.0f;
        s_db[j] += d_pre;
        s_da[j] += d_pre * x0[j];
        dxc[j] = d_pre * av[j];
        s_db0[j] += dxc[j];
      }
    }
    eh_tile_store(xt, slot, lane, dxc);
    __syncwarp();
    eh_onehot_product<NT>(xt, lane, m, acc);
    __syncwarp();
  }
  cp_async_wait<0>();

  // the block's partial row: this warp's columns of dW0, then its chunks'
  // vector sums over the 16 slot lanes
  float* row = part + (long long)blockIdx.x * (F + 3) * D + c0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dd = warp * 16 + (lane >> 2) + (k >> 1) * 8;
      const int f = 8 * j + 2 * (lane & 3) + (k & 1);
      if (dd < w && f < F) row[(long long)f * D + dd] = acc[j][k];
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
      s_db0[j] += __shfl_xor_sync(EH_FULL, s_db0[j], off);
      s_da[j] += __shfl_xor_sync(EH_FULL, s_da[j], off);
      s_db[j] += __shfl_xor_sync(EH_FULL, s_db[j], off);
    }
  if (lane < 2)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nc) {
        row[(long long)F * D + c8 + j] = s_db0[j];
        row[(long long)(F + 1) * D + c8 + j] = s_da[j];
        row[(long long)(F + 2) * D + c8 + j] = s_db[j];
      }
}

}  // namespace
