// The bfloat16 routes of the edge-encoder hidden pass and its backward, for
// D % 8 == 0, D <= 256 and F <= 64 (every preset: D = 200, F = 47 or 43).
//
// Replace, beside the CUDA-core kernels of edge_hidden.cu, the TPU kernels
// `_hidden_fwd_kernel` (qagnn_tpu/ops/pallas_edge_encoder.py:164, launched
// by `_hidden_impl` :234) and `_hidden_bwd_kernel` (:179, launched by
// `_hidden_bwd_impl` :291).
//
// Bound on the H100: bytes, both ways. The forward writes h (G, E, D) bf16
// once (105 MB at G=64, E=4096, D=200: 31 us at 3.35 TB/s), the backward
// reads dh of the same size once; three int32 per slot and the (F, D) W0 are
// small beside it.
//
// Both kernels hold W0, rounded to bf16, and a type table U in shared memory
// (18.8 + 12.8 KB at F=47, D=200, 4 node types): U[ts * n_ntype + td] =
// W0[n_rel + ts] + W0[n_rel + n_ntype + td] + b0, so a slot's x0 is its
// relation's W0 row plus one U row (two 16-byte loads where three W0 rows
// and b0 were four; the sum in another order than the plain version's, f32
// rounding apart). A relation id outside [0, n_rel) sets no relation
// feature, as in the TPU kernel's one-hot: it is packed as row F, a row of
// zeros after W0's F rows in shared memory, and its one-hot mask has no
// relation bit, so no read falls outside W0 and dW0 gets nothing for it.
// They walk tiles of 16 consecutive slots of the flattened
// (G * E) slot axis: a tile's rows of h or dh are 16 x D x 2 contiguous
// bytes. A slot's relation r and type pair t are packed into one int; they
// come from a chain of dependent loads (the slot's ints, then the two node
// types).
//
// Forward (`edge_hidden_tc_kernel`): persistent warps, each on every n-th
// tile of the n warps, so that the warps write neighbouring tiles at any
// moment (the card took longer with a contiguous range a warp). Lanes 0..15
// run the chain of loads two tiles ahead in registers (a tile's ints are
// loaded one tile before their node types are gathered, and those one tile
// before they are packed and used), so no load is waited on in the tile
// where it was issued. A lane owns one
// 8-column chunk for good (a and b of its columns in its registers), the
// warp's lanes cover the row with consecutive 16-byte chunks, and each slot
// costs a lane three 16-byte shared loads and one 16-byte store. (The
// CUDA-core kernel waits on the chain of loads for every slot before its
// one store.)
//
// Backward (`edge_hidden_bwd_tc_kernel`): `edge_rows_kernel` first runs the
// chain once for every slot (packed row and the 64-bit mask of its one-hot
// feature row, 12 bytes a slot). Then one persistent block an SM holds one
// warp for each 16-column m-tile of D (13 at D=200) and walks a contiguous
// range of tiles; every warp goes through every tile alone, with no barrier
// between warps. Lane l takes slot l / 2 and 8-column chunk l % 2 of its
// warp's m-tile: its 16 bytes of dh and its slot's row and mask arrive by
// cp.async in a private ring cell EHB_STAGES - 1 tiles ahead (the lane alone
// reads its cell); it forms x0, the relu mask, d_pre and d_x0 in f32, folds
// db, da and db0 into registers from the unrounded values (as the CUDA-core
// kernel does) and writes bf16(d_x0) into the warp's 16 x 16 tile. Then
// dW0^T (16 columns x F) += dxc^T (16 x 16 slots) onehot (16 slots x F) on
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators): A is the
// tile read with ldmatrix.trans, B the one-hot built in registers from the
// masks (bf16 1.0 where the column is one of the slot's three rows), NT x 4
// accumulators a lane. A product of 1.0 and a bf16 value summed in f32 is
// the sum the TPU's one-hot dot_general forms (pallas_edge_encoder.py:
// 208-210), up to order; it replaces three shared read-modify-writes per
// slot and column. Each block writes one partial row of (F + 3) x D once
// (each warp its own columns), and reduce_partials_kernel adds the blocks'
// rows, so the result does not depend on the order the blocks ran in.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr unsigned EH_FULL = 0xffffffffu;
constexpr int EH_TILE = 16;              // slots of a tile
constexpr int EH_MAX_D = 256, EH_MAX_F = 64;
constexpr int EH_MAX_U = 8192;           // n_ntype^2 x D of the type table

constexpr int EHF_THREADS = 256;         // forward block

constexpr int EHB_STAGES = 8;            // backward: tiles in a lane's ring

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

// shared memory of both kernels: W0 (bf16) and a zero row after it, then
// the type table U (f32)
__host__ __device__ constexpr int eh_w0_bytes(int F, int D) {
  return ((F + 1) * D * 2 + 15) / 16 * 16;
}
__host__ __device__ constexpr int eh_u_bytes(int D, int n_ntype) {
  return n_ntype * n_ntype * D * 4;
}

// W0 (F, D) f32 -> sW (F + 1, D) bf16, row F zeros (the relation row of an
// id out of range), the whole block; the caller synchronises
__device__ __forceinline__ void eh_load_w0(bf16* sW,
                                           const float* __restrict__ w0,
                                           int F, int D) {
  const float4* w = reinterpret_cast<const float4*>(w0);
  for (int i = threadIdx.x; i < (F + 1) * D / 8; i += blockDim.x) {
    if (i < F * D / 8) {
      const float4 lo = w[2 * i], hi = w[2 * i + 1];
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      reinterpret_cast<uint4*>(sW)[i] = pack_bf16x8(v);
    } else {
      reinterpret_cast<uint4*>(sW)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void eh_load8(const float* __restrict__ p,
                                         float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// ---------------------------------------------------------------------------
// forward: h = relu(a * x0 + b) in bf16
// ---------------------------------------------------------------------------

// W0 (F, D) f32 -> sW (F, D) bf16 and the type table sU (n_ntype^2, D) f32,
// U[ts * n_ntype + td] = W0[n_rel + ts] + W0[n_rel + n_ntype + td] + b0 (the
// rows rounded to bf16 as in x0, summed in f32): then x0 = W0[r] + U[t]. The
// whole block; the caller synchronises.
__device__ __forceinline__ void eh_load_tables(bf16* sW, float* sU,
                                               const float* __restrict__ w0,
                                               const float* __restrict__ b0,
                                               int F, int D, int n_rel,
                                               int n_ntype) {
  eh_load_w0(sW, w0, F, D);
  __syncthreads();
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < n_ntype * n_ntype * chunks; i += blockDim.x) {
    const int t = i / chunks, c8 = i % chunks * 8;
    const uint4 q1 = *reinterpret_cast<const uint4*>(
        sW + (n_rel + t / n_ntype) * D + c8);
    const uint4 q2 = *reinterpret_cast<const uint4*>(
        sW + (n_rel + n_ntype + t % n_ntype) * D + c8);
    float r1[8], r2[8], bb[8];
    unpack_bf16x8(q1, r1);
    unpack_bf16x8(q2, r2);
    eh_load8(b0 + c8, bb);
    float* u = sU + t * D + c8;
    *reinterpret_cast<float4*>(u) = make_float4(
        r1[0] + r2[0] + bb[0], r1[1] + r2[1] + bb[1], r1[2] + r2[2] + bb[2],
        r1[3] + r2[3] + bb[3]);
    *reinterpret_cast<float4*>(u + 4) = make_float4(
        r1[4] + r2[4] + bb[4], r1[5] + r2[5] + bb[5], r1[6] + r2[6] + bb[6],
        r1[7] + r2[7] + bb[7]);
  }
}

// x0 of the lane's 8 columns of a slot packed as r | t << 8: one 16-byte
// load of its relation's W0 row (bf16) and two of its type pair's U row
__device__ __forceinline__ void eh_x0(const bf16* sW, const float* sU, int D,
                                      int c8, int p, float (&x0)[8]) {
  const uint4 wq = *reinterpret_cast<const uint4*>(sW + (p & 255) * D + c8);
  const float* u = sU + (p >> 8) * D + c8;
  const float4 u0 = *reinterpret_cast<const float4*>(u);
  const float4 u1 = *reinterpret_cast<const float4*>(u + 4);
  float w[8];
  unpack_bf16x8(wq, w);
  x0[0] = w[0] + u0.x; x0[1] = w[1] + u0.y; x0[2] = w[2] + u0.z;
  x0[3] = w[3] + u0.w; x0[4] = w[4] + u1.x; x0[5] = w[5] + u1.y;
  x0[6] = w[6] + u1.z; x0[7] = w[7] + u1.w;
}

// a slot's relation row r (its id, or F, the zero row, for an id outside
// [0, n_rel)) and type pair t = ts * n_ntype + td as r | t << 8 (0 for a
// slot that does not exist: nothing reads it)
__device__ __forceinline__ int eh_pack(int et, int ts, int td, int n_rel,
                                       int n_ntype) {
  const int r = (unsigned)et < (unsigned)n_rel ? et : n_rel + 2 * n_ntype;
  return ts < 0 ? 0 : r | (ts * n_ntype + td) << 8;
}

// persistent blocks; warp w of the grid's n walks tiles w, w + n, ..., so
// that the warps' stores at any moment fall on neighbouring tiles
__global__ void __launch_bounds__(EHF_THREADS)
edge_hidden_tc_kernel(const int32_t* __restrict__ etype,
                      const int32_t* __restrict__ src,
                      const int32_t* __restrict__ dst,
                      const int32_t* __restrict__ ntype,
                      const float* __restrict__ w0,
                      const float* __restrict__ b0,
                      const float* __restrict__ a,
                      const float* __restrict__ b, bf16* __restrict__ out,
                      long long n_edges, int E, int N, int D, int F,
                      int n_rel, int n_ntype) {
  extern __shared__ __align__(16) unsigned char eh_smem[];
  bf16* sW = reinterpret_cast<bf16*>(eh_smem);
  float* sU = reinterpret_cast<float*>(eh_smem + eh_w0_bytes(F, D));
  eh_load_tables(sW, sU, w0, b0, F, D, n_rel, n_ntype);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int chunks = D / 8;
  const int rows_per = 32 / chunks < EH_TILE ? 32 / chunks : EH_TILE;
  const int c8 = lane % chunks * 8, sl = lane / chunks;
  const bool col_live = sl < rows_per;
  float av[8], bv[8];
  eh_load8(a + c8, av);
  eh_load8(b + c8, bv);

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

  for (long long t = warp; t < n_tiles; t += n_warps) {
    const long long base = t * EH_TILE;
    const int n = n_edges - base < EH_TILE ? (int)(n_edges - base) : EH_TILE;
#pragma unroll 4
    for (int s = sl; s < EH_TILE + sl; s += rows_per) {
      const int p = __shfl_sync(EH_FULL, packed, s & (EH_TILE - 1));
      if (col_live && s < n) {
        float x0[8], h[8];
        eh_x0(sW, sU, D, c8, p, x0);
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = fmaxf(av[j] * x0[j] + bv[j], 0.0f);
        *reinterpret_cast<uint4*>(out + (base + s) * D + c8) = pack_bf16x8(h);
      }
    }
    packed = eh_pack(etB, tsB, tdB, n_rel, n_ntype);
    gather_b();
    load_c(t + 3 * n_warps);
  }
}

// ---------------------------------------------------------------------------
// backward: dW0, db0, da, db from dh
// ---------------------------------------------------------------------------

// Shared memory: W0 and U, then per warp a ring of EHB_STAGES cells of its
// 32 lanes, a cell holding the lane's 16 bytes of dh and its slot's packed
// row and mask (32 bytes), and a 16 x 16 bf16 tile of d_x0 (pitch 24).
constexpr int EHB_CELL = 32;
constexpr int EHB_XLD = 24;
__host__ __device__ constexpr int ehb_warp_bytes() {
  return EHB_STAGES * 32 * EHB_CELL + EH_TILE * EHB_XLD * 2;
}
__host__ __device__ constexpr int ehb_smem_bytes(int F, int D, int n_ntype) {
  return eh_w0_bytes(F, D) + eh_u_bytes(D, n_ntype) +
         (D + 15) / 16 * ehb_warp_bytes();
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

// NT: 8-column tiles of F (F <= 8 NT). rows, masks: edge_rows_kernel's.
// One warp for each 16-column m-tile of D; every warp of a block walks the
// block's tiles alone, lane l on slot l / 2 and 8-column chunk l % 2 of its
// m-tile.
template <int NT>
__global__ void __launch_bounds__(512, 1)
edge_hidden_bwd_tc_kernel(const int* __restrict__ rows_in,
                          const uint2* __restrict__ masks_in,
                          const float* __restrict__ w0,
                          const float* __restrict__ b0,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const bf16* __restrict__ dh,
                          float* __restrict__ part, long long n_edges, int D,
                          int F, int n_rel, int n_ntype) {
  extern __shared__ __align__(16) unsigned char eh_smem[];
  bf16* sW = reinterpret_cast<bf16*>(eh_smem);
  float* sU = reinterpret_cast<float*>(eh_smem + eh_w0_bytes(F, D));
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  unsigned char* mine = eh_smem + eh_w0_bytes(F, D) + eh_u_bytes(D, n_ntype) +
                        warp * ehb_warp_bytes();
  bf16* xt = reinterpret_cast<bf16*>(mine + EHB_STAGES * 32 * EHB_CELL);
  eh_load_tables(sW, sU, w0, b0, F, D, n_rel, n_ntype);
  __syncthreads();

  const int slot = lane >> 1;
  const int c8 = (2 * warp + (lane & 1)) * 8;
  const bool live = c8 < D;
  float av[8], bv[8], s_db0[8], s_da[8], s_db[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    av[j] = live ? a[c8 + j] : 0.0f;
    bv[j] = live ? b[c8 + j] : 0.0f;
    s_db0[j] = s_da[j] = s_db[j] = 0.0f;
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.0f;

  const long long n_tiles = (n_edges + EH_TILE - 1) / EH_TILE;
  const long long t0 = (long long)blockIdx.x * n_tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * n_tiles / gridDim.x;

  // the lane's dh chunk and its slot's packed row and mask of tile t -> its
  // cell of stage (t - t0) % EHB_STAGES, as one cp.async group; only the
  // lane itself reads the cell
  auto prefetch = [&](long long t) {
    if (t < t1) {
      const long long s = t * EH_TILE + slot;
      unsigned char* cell =
          mine + ((int)((t - t0) % EHB_STAGES) * 32 + lane) * EHB_CELL;
      if (live && s < n_edges) cp_async16(cell, dh + s * D + c8);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :
                   : "r"(shared_addr(cell + 16)), "l"(rows_in + s)
                   : "memory");
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :
                   : "r"(shared_addr(cell + 24)), "l"(masks_in + s)
                   : "memory");
    }
    cp_async_commit();
  };
  for (int k = 0; k < EHB_STAGES - 1; ++k) prefetch(t0 + k);

  for (long long t = t0; t < t1; ++t) {
    cp_async_wait<EHB_STAGES - 2>();
    const unsigned char* cell =
        mine + ((int)((t - t0) % EHB_STAGES) * 32 + lane) * EHB_CELL;
    const uint4 dq = *reinterpret_cast<const uint4*>(cell);
    const int p = *reinterpret_cast<const int*>(cell + 16);
    const uint2 m = *reinterpret_cast<const uint2*>(cell + 24);
    const bool valid = live && t * EH_TILE + slot < n_edges;
    prefetch(t + EHB_STAGES - 1);

    // elementwise: bf16(d_x0) -> the warp's tile, the f32 sums in registers
    uint4 packed_dxc = make_uint4(0, 0, 0, 0);
    if (valid) {
      float x0[8], d[8], dxc[8];
      eh_x0(sW, sU, D, c8, p, x0);
      unpack_bf16x8(dq, d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d_pre = av[j] * x0[j] + bv[j] > 0.0f ? d[j] : 0.0f;
        s_db[j] += d_pre;
        s_da[j] += d_pre * x0[j];
        dxc[j] = d_pre * av[j];
        s_db0[j] += dxc[j];
      }
      packed_dxc = pack_bf16x8(dxc);
    }
    *reinterpret_cast<uint4*>(xt + slot * EHB_XLD + (lane & 1) * 8) =
        packed_dxc;
    __syncwarp();

    // dW0^T (this m-tile's 16 columns) += dxc^T onehot: the lane's B
    // fragments hold column f = 8 j + lane / 4 of slots k0, k0 + 1, k0 + 8,
    // k0 + 9, whose masks sit with lanes 2 k
    const int k0 = 2 * (lane & 3), q = lane >> 2;
    uint2 mk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int src = 2 * (k0 + (i & 1) + (i >> 1) * 8);
      mk[i].x = __shfl_sync(EH_FULL, m.x, src);
      mk[i].y = __shfl_sync(EH_FULL, m.y, src);
    }
    uint32_t af[4];
    ldmatrix_x4_trans(af, a_frag_ptr_trans(xt, EHB_XLD, lane));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int sh = 8 * (j & 3) + q;
      auto bit = [&](const uint2& v) {
        return ((j < 4 ? v.x : v.y) >> sh & 1u) * 0x3F80u;
      };
      mma_bf16_16x8x16(acc[j], af, bit(mk[0]) | bit(mk[1]) << 16,
                       bit(mk[2]) | bit(mk[3]) << 16);
    }
    __syncwarp();
  }
  cp_async_wait<0>();

  // the block's partial row: this warp's columns of dW0, then its chunks'
  // vector sums over the 16 slot lanes
  float* row = part + (long long)blockIdx.x * (F + 3) * D;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = warp * 16 + (lane >> 2) + (k >> 1) * 8;
      const int f = 8 * j + 2 * (lane & 3) + (k & 1);
      if (d < D && f < F) row[f * D + d] = acc[j][k];
    }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
      s_db0[j] += __shfl_xor_sync(EH_FULL, s_db0[j], off);
      s_da[j] += __shfl_xor_sync(EH_FULL, s_da[j], off);
      s_db[j] += __shfl_xor_sync(EH_FULL, s_db[j], off);
    }
  if (lane < 2 && live)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      row[F * D + c8 + j] = s_db0[j];
      row[(F + 1) * D + c8 + j] = s_da[j];
      row[(F + 2) * D + c8 + j] = s_db[j];
    }
}

}  // namespace
