// The bfloat16 route of the projected GAT op's backward passes 1 and 2: the
// three per-edge products of each pass on tensor cores (mma_tile.cuh). What
// the passes compute, and the source note with the design and its times, are
// at the head of gat_bwd.cu; the f32 route there stays on CUDA cores.
//
// Launch 1, `edge_pass_tc_kernel<PASS, PAIRS>`: persistent blocks, one per
// SM. A block loads W once, rounded to bf16 and zero-padded, into shared
// memory ([D][HD], used as it lies for emb W and read as [column][depth] for
// cot W^T: no transposed copy). Its warps then work alone, each on units of
// 16 consecutive edges of one graph, with a private stage in shared memory
// and only warp barriers:
//   a. the unit's emb rows -> stage (cp.async), depth zero-padded; the
//      unit's nodes were fetched during the unit before;
//   b. product 1: emb W in f32 accumulators (a row's columns lie in one quad);
//   c. the accumulators -> stage as f32 rows (over the consumed emb rows);
//   d. the row-wise epilogue of the CUDA-core kernels, a lane on 8 adjacent
//      columns, four rows at a time: 16-byte gathers of the node rows (the
//      next four rows' are in flight meanwhile), the cotangent with the same
//      rounding points, 16-byte atomicAdd scatters, and pass 1's per-head
//      sums for any head width, the 16 or 32 (row, head) sums of a group in
//      one butterfly of as many shuffles; the group's bf16 cotangent rows
//      are written IN PLACE over the first halves of their f32 rows (every
//      lane has read its floats by then) and once to device memory for the
//      dW launch;
//   e. product 2: cot W^T from that tile -> stage as f32 rows; demb = rows
//      (+ carry, or + pass 1's demb in place), 16 bytes a lane, all of a
//      lane's loads before its stores.
// Each lane keeps the bias gradient of its 8 columns over all its units (f32
// values before rounding); a block writes one partial row at its end.
//
// Past D = 256 rows W no longer fits (a 512 x 256 tile is 264 KB): the
// edge kernel runs once for each slice of DS <= 256 of W's rows, in order,
// with that slice resident. Product 1's depth is then the slice: a launch
// adds the projection summed over the slices before it (f32, `proj`, (G, E,
// HD)) into its stage and hands the sum on to the next, and only the last
// launch, which holds the whole projection, runs the epilogue's node-side
// work (the scatters, d_alpha, dscale, the cotangent's copy for dW and the
// bias partials). Every launch forms the cotangent rows, which do not
// depend on the projection, for product 2 against its slice: demb's
// columns of that slice, written once, with no atomics between slices. The
// dW launch takes the slices as a grid dimension. The
// tile counts of both products are compile-time (PAIRS): with a run-time
// count every pair of tiles sat behind a branch, the loads of a pair's B
// fragments could not move ahead of the pair before it, and the products
// took twice as long.
//
// Launch 2, `dw_tc_kernel`: dW = emb^T cot over all G * E slots, the slots
// being the depth: a block takes one range of slots and every row of dW for
// up to 128 of its columns (HD = 200: two blocks of 104 and 96 columns, which
// run side by side, so emb comes from device memory once), stages slices of 64
// slots of both operands through a four-deep cp.async ring, and writes its
// f32 partial once. Launches 3 and 4 add up the dW and db partials
// (reduce_partials.cuh): no atomics on dW or db.
//
// The parts that the forward's tensor-core route shares (the W loader, the
// unit's nodes, the accumulator stage, the head sums) are in
// gat_tc_common.cuh.
#pragma once
#include "gat_tc_common.cuh"
#include "reduce_partials.cuh"

namespace {

// The per-warp tables of the edge kernel beside its stage (floats). The
// stage holds in turn the emb rows (bf16, pitch TcShape::ld16), the f32
// projection rows (pitch TcShape::ld32 floats), the bf16 cotangent rows in
// place (pitch 2 * ld32 elements: 64 PAIRS + 16 bytes, an odd multiple of 16)
// and the f32 rows of cot W^T.
constexpr int TC_SMALL_FLOATS = 3 * TC_ROWS * MAX_H + 2 * TC_ROWS;

struct TcArgs {
  // pass 1: rows_src = nm, rows_dst = gout; pass 2: rows_src = nq,
  // rows_dst = nk
  const bf16* rows_src;
  const bf16* rows_dst;
  const bf16* emb;
  const float* w;
  const float* bias;
  const float* scores;
  const float* gmax;
  const float* scale;
  const float* dalpha_in;     // pass 2
  const float* d_denom;       // pass 2
  const int32_t* src;
  const int32_t* dst;
  const uint8_t* mask;
  const bf16* add;            // carry (may be null) or demb itself
  bf16* cot;                  // (G, E, HD) scratch for the dW launch
  bf16* demb;
  float* dalpha_out;          // pass 1
  float* acc_src;             // pass 1: dnm; pass 2: dnq
  float* acc_dst;             // pass 2: dnk
  float* dscale;              // pass 1
  float* db_part;             // (gridDim.x, HD)
  float* proj;                // (G, E, HD) f32 scratch, with slices of W
  int G, N, E, D, HD, H;
  int DS;                     // rows of a slice of W, dividing D
  int d0, first, last;        // this launch's slice: its first row, and
                              // whether it is the first / last slice
  int part;                   // pass 1: PART_ADD | PART_OPEN (gat_common.cuh)
};

__device__ __forceinline__ float tc_edge_exp(const TcArgs& a, long long g,
                                             int h, int e) {
  return expf(fminf(a.scores[(g * a.H + h) * a.E + e] - a.gmax[g * a.H + h],
                    0.0f));
}

template <int PASS, int PAIRS>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS, 1)
edge_pass_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  typedef TcShape<PAIRS, TC_SMALL_FLOATS> S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int E = a.E, N = a.N, D = a.D, HD = a.HD, H = a.H, DS = a.DS;
  const int d0 = a.d0;
  const bool last = a.last;
  bf16* sW = reinterpret_cast<bf16*>(tc_smem);
  unsigned char* mine = tc_smem + S::w_bytes + warp * S::warp_bytes;
  bf16* s_emb = reinterpret_cast<bf16*>(mine);
  float* s_rows = reinterpret_cast<float*>(mine);
  bf16* s_cot = reinterpret_cast<bf16*>(mine);
  constexpr int ldc = 2 * S::ld32;
  const int Dp = round_up16(DS), HDp = round_up16(HD);
  float* s_small = reinterpret_cast<float*>(mine + S::stage_bytes);
  // pass 1: alpha, pass 2: d_s, per (edge, head)
  float (*s_wt)[MAX_H] = reinterpret_cast<float (*)[MAX_H]>(s_small);
  float (*s_e)[MAX_H] =
      reinterpret_cast<float (*)[MAX_H]>(s_small + TC_ROWS * MAX_H);
  float (*s_da)[TC_ROWS] =
      reinterpret_cast<float (*)[TC_ROWS]>(s_small + 2 * TC_ROWS * MAX_H);
  int* s_src = reinterpret_cast<int*>(s_small + 3 * TC_ROWS * MAX_H);
  int* s_dst = s_src + TC_ROWS;

  // the slice's rows of W, rounded to bf16; zeros wherever either product
  // reaches past DS or HD
  tc_load_w<S>(sW, a.w + (long long)d0 * HD, DS, HD);
  __syncthreads();

  const int c0 = 8 * lane, dph = HD / H;
  const bool active = c0 < HD;
  int head[8];
  float bias[8], dbsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    head[j] = (c0 + j) / dph;
    bias[j] = active ? a.bias[c0 + j] : 0.0f;
    dbsum[j] = 0.0f;
  }
  float acc[S::NT][4];

  const int units_per_graph = (E + TC_ROWS - 1) / TC_ROWS;
  const long long n_units = (long long)a.G * units_per_graph;
  const long long stride = (long long)gridDim.x * nwarps;
  long long u = (long long)blockIdx.x * nwarps + warp;
  int next_src, next_dst;         // the nodes of the unit after this one
  tc_unit_nodes(a.mask, a.src, a.dst, E, u, n_units, units_per_graph, lane,
                next_src, next_dst);
  for (; u < n_units; u += stride) {
    const long long g = u / units_per_graph;
    const int e0 = (int)(u % units_per_graph) * TC_ROWS;

    // a. the unit's emb rows, a lane on one 16-byte chunk of every row;
    // zeros past E and in the depth padding
    if (c0 < Dp) {
#pragma unroll 4
      for (int r = 0; r < TC_ROWS; ++r) {
        bf16* to = s_emb + r * S::ld16 + c0;
        if (e0 + r < E && c0 < DS)
          cp_async16(to, a.emb + ((g * E + e0 + r) * D + d0 + c0));
        else
          *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
    // the unit's nodes, fetched during the unit before, and the next one's
    if (lane < TC_ROWS) {
      s_src[lane] = next_src;
      s_dst[lane] = next_dst;
    }
    tc_unit_nodes(a.mask, a.src, a.dst, E, u + stride, n_units,
                  units_per_graph, lane, next_src, next_dst);
    __syncwarp();
    // per-(edge, head) weights, 0 for dead slots
    for (int idx = lane; idx < TC_ROWS * H; idx += 32) {
      const int h = idx / TC_ROWS, el = idx % TC_ROWS, e = e0 + el;
      const int s_node = s_src[el];
      float ee = 0.0f, wt = 0.0f;
      if (s_node >= 0) {
        const long long node = (g * N + s_node) * H + h;
        ee = tc_edge_exp(a, g, h, e);
        // rounded where the TPU rounds (gat_bwd.cu's head note)
        if (PASS == 1)
          wt = round_to<bf16>(ee * round_to<bf16>(a.scale[node]));
        else
          wt = round_to<bf16>((a.dalpha_in[(g * H + h) * E + e] *
                                   round_to<bf16>(a.scale[node]) +
                               round_to<bf16>(a.d_denom[node])) * ee);
      }
      s_wt[el][h] = wt;
      if (PASS == 1) s_e[el][h] = ee;
    }
    cp_async_wait<0>();
    __syncwarp();

    // b. product 1: the projection emb W over the slice
    zero_acc(acc);
    warp_rows_product<true>(s_emb, S::ld16, sW, S::ld16, Dp / 16, acc);
    __syncwarp();
    // c. accumulators -> f32 rows over the consumed emb rows; with slices
    // of W, plus the earlier slices' sum, and on to the next slice
    tc_stage_acc(acc, s_rows, S::ld32, lane);
    __syncwarp();
    if (!(a.first && last) && active) {
#pragma unroll 4
      for (int r = 0; r < TC_ROWS; ++r) {
        if (e0 + r >= E) break;
        float4* row = reinterpret_cast<float4*>(s_rows + r * S::ld32 + c0);
        float4* keep = reinterpret_cast<float4*>(a.proj +
                                                 (g * E + e0 + r) * HD + c0);
        float4 v0 = row[0], v1 = row[1];
        if (!a.first) {
          const float4 k0 = keep[0], k1 = keep[1];
          v0.x += k0.x; v0.y += k0.y; v0.z += k0.z; v0.w += k0.w;
          v1.x += k1.x; v1.y += k1.y; v1.z += k1.z; v1.w += k1.w;
          row[0] = v0;
          row[1] = v1;
        }
        if (!last) {
          keep[0] = v0;
          keep[1] = v1;
        }
      }
    }
    __syncwarp();

    // d. the row-wise epilogue, TC_GROUP rows at a time: the next group's
    // node rows are in flight while a group is worked on, and a group's
    // bf16 cotangent rows go over its f32 rows once every lane has read
    // its floats of them (zeros in the depth padding and in dead rows).
    // Before the last slice of W only the cotangent rows are formed.
    uint4 cur_s[TC_GROUP], cur_d[TC_GROUP], next_s[TC_GROUP],
        next_d[TC_GROUP];
    auto gather = [&](int r0, uint4 (&to_s)[TC_GROUP],
                      uint4 (&to_d)[TC_GROUP]) {
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i) {
        if (active && s_src[r0 + i] >= 0) {
          to_s[i] = *reinterpret_cast<const uint4*>(
              a.rows_src + (g * N + s_src[r0 + i]) * HD + c0);
          to_d[i] = *reinterpret_cast<const uint4*>(
              a.rows_dst + (g * N + s_dst[r0 + i]) * HD + c0);
        } else {
          to_s[i] = to_d[i] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    };
    gather(0, next_s, next_d);
#pragma unroll 1
    for (int r0 = 0; r0 < TC_ROWS; r0 += TC_GROUP) {
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i) {
        cur_s[i] = next_s[i];
        cur_d[i] = next_d[i];
      }
      if (r0 + TC_GROUP < TC_ROWS) gather(r0 + TC_GROUP, next_s, next_d);
      uint4 packed[TC_GROUP];
      float p[TC_GROUP][8];    // pass 1: msg * g[dst] (unused in pass 2)
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i) {
        const int r = r0 + i;
        const int s_node = s_src[r], d_node = s_dst[r];
        float cot[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) cot[j] = 0.0f;
        if (PASS == 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) p[i][j] = 0.0f;
        }
        if (s_node >= 0) {                     // uniform over the warp
          if (active) {
            const long long s_row = (g * N + s_node) * HD + c0;
            const long long d_row = (g * N + d_node) * HD + c0;
            float vs[8], vd[8], proj[8];
            unpack_bf16x8(cur_s[i], vs);
            unpack_bf16x8(cur_d[i], vd);
            const float4 p0 =
                *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0);
            const float4 p1 =
                *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0 + 4);
            proj[0] = p0.x; proj[1] = p0.y; proj[2] = p0.z; proj[3] = p0.w;
            proj[4] = p1.x; proj[5] = p1.y; proj[6] = p1.z; proj[7] = p1.w;
            if (PASS == 1) {
              // vs = nm[src], vd = g[dst]
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                p[i][j] = (vs[j] + proj[j] + bias[j]) * vd[j];
                const float d = s_wt[r][head[j]] * vd[j];
                dbsum[j] += d;
                cot[j] = round_to<bf16>(d);
              }
              if (last) {
                atomicAdd(reinterpret_cast<float4*>(a.acc_src + s_row),
                          make_float4(cot[0], cot[1], cot[2], cot[3]));
                atomicAdd(reinterpret_cast<float4*>(a.acc_src + s_row + 4),
                          make_float4(cot[4], cot[5], cot[6], cot[7]));
              }
            } else {
              // vs = nq[src], vd = nk[dst]
              float dq[8];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float ds = s_wt[r][head[j]];
                const float d = ds * vs[j];
                dbsum[j] += d;
                cot[j] = round_to<bf16>(d);
                dq[j] = round_to<bf16>(ds * (vd[j] + proj[j] + bias[j]));
              }
              if (last) {
                atomicAdd(reinterpret_cast<float4*>(a.acc_src + s_row),
                          make_float4(dq[0], dq[1], dq[2], dq[3]));
                atomicAdd(reinterpret_cast<float4*>(a.acc_src + s_row + 4),
                          make_float4(dq[4], dq[5], dq[6], dq[7]));
                atomicAdd(reinterpret_cast<float4*>(a.acc_dst + d_row),
                          make_float4(cot[0], cot[1], cot[2], cot[3]));
                atomicAdd(reinterpret_cast<float4*>(a.acc_dst + d_row + 4),
                          make_float4(cot[4], cot[5], cot[6], cot[7]));
              }
            }
          }
        }
        packed[i] = pack_bf16x8(cot);
        // the cotangent's one trip to device memory, for the dW launch
        if (last && active && e0 + r < E)
          *reinterpret_cast<uint4*>(a.cot + (g * E + e0 + r) * HD + c0) =
              packed[i];
      }
      if (PASS == 1 && last) {
        if (H <= 4)
          tc_group_head_sums<4>(p, head, H, r0, lane, s_da);
        else
          tc_group_head_sums<8>(p, head, H, r0, lane, s_da);
      }
      __syncwarp();
      if (c0 < HDp) {
#pragma unroll
        for (int i = 0; i < TC_GROUP; ++i)
          *reinterpret_cast<uint4*>(s_cot + (r0 + i) * ldc + c0) = packed[i];
      }
    }
    __syncwarp();
    if (PASS == 1 && last) {
      for (int idx = lane; idx < TC_ROWS * H; idx += 32) {
        const int h = idx / TC_ROWS, el = idx % TC_ROWS, e = e0 + el;
        if (e >= E) continue;
        float v = s_da[h][el];
        if (a.part & PART_ADD) v += a.dalpha_out[(g * H + h) * E + e];
        a.dalpha_out[(g * H + h) * E + e] = v;
        if (s_src[el] >= 0 && !(a.part & PART_OPEN))
          atomicAdd(&a.dscale[(g * N + s_src[el]) * H + h],
                    round_to<bf16>(v * s_e[el][h]));
      }
    }

    // e. product 2: cot W^T -> f32 rows over the consumed cotangent rows,
    // then demb = product (+ add) row by row, 16 bytes a lane, in the
    // slice's columns. All of a lane's loads of `add` come before its
    // stores: `add` may be demb.
    zero_acc(acc);
    warp_rows_product<false>(s_cot, ldc, sW, S::ld16, HDp / 16, acc);
    __syncwarp();
    tc_stage_acc(acc, s_rows, S::ld32, lane);
    __syncwarp();
    if (c0 < DS) {
      bf16* out = a.demb + (g * E + e0) * D + d0 + c0;
      const bf16* add = a.add == nullptr ? nullptr
                                         : a.add + (g * E + e0) * D + d0 + c0;
      uint4 carried[TC_ROWS];
      if (add != nullptr) {
#pragma unroll
        for (int r = 0; r < TC_ROWS; ++r)
          if (e0 + r < E)
            carried[r] = *reinterpret_cast<const uint4*>(add + (long long)r * D);
      }
#pragma unroll
      for (int r = 0; r < TC_ROWS; ++r) {
        if (e0 + r < E) {
          const float4 p0 =
              *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0);
          const float4 p1 =
              *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0 + 4);
          float v[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          if (add != nullptr) {
            float c[8];
            unpack_bf16x8(carried[r], c);
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] += c[j];
          }
          *reinterpret_cast<uint4*>(out + (long long)r * D) = pack_bf16x8(v);
        }
      }
    }
    __syncwarp();     // the stage is free for the next unit's emb rows
  }

  // the block's partial bias gradient, through the warps' stages (the last
  // slice's launch; the flag is the same for the whole grid)
  if (!last) return;
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s_rows[c0 + j] = dbsum[j];
  }
  __syncthreads();
  for (int c = tid; c < HD; c += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < nwarps; ++w)
      v += reinterpret_cast<const float*>(tc_smem + S::w_bytes +
                                          w * S::warp_bytes)[c];
    a.db_part[(long long)blockIdx.x * HD + c] = v;
  }
}

constexpr int DWT_K = 64;          // slots of one staged slice
constexpr int DWT_STAGES = 4;
constexpr int DWT_MAX_NT = 16;     // 8-column tiles of a block

// n-tiles of one column block: the HD / 8 tiles spread evenly over the
// fewest blocks of at most DWT_MAX_NT
inline int dw_block_tiles(int HD) {
  const int nt = HD / 8, blocks = (nt + DWT_MAX_NT - 1) / DWT_MAX_NT;
  return (nt + blocks - 1) / blocks;
}

// the kernel is compiled for these counts of tile pairs per column block
inline int dw_pairs(int ntb) {
  return ntb <= 4 ? 2 : ntb <= 8 ? 4 : ntb <= 14 ? 7 : 8;
}

// part[s, d, c] = sum over the slots r of range s of emb[r, d] * cot[r, c]:
// emb (R, D), cot (R, HD) over all graphs' slots, a block on the DS rows d
// of slice blockIdx.z of W's rows. Warp w takes the 16-row tile w of the
// slice (WARPS = 8 for DS <= 128, else 16: sixteen warps on one tile each
// hide more latency than eight on two, 139 against 168 us at D = HD = 200)
// times all 2 NP column tiles of its block, of which the last ones may lie
// past the block's columns and are not stored.
template <int NP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS, 1)
dw_tc_kernel(const bf16* __restrict__ emb, const bf16* __restrict__ cot,
             float* __restrict__ part, long long R, long long chunk, int D,
             int DS, int HD, int ntb) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  constexpr int NT = 2 * NP, ldb = 16 * NP + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.z * DS;
  const int lda = tile_pitch(DS);
  const int a_bytes = DWT_K * lda * 2, stage_bytes = a_bytes + DWT_K * ldb * 2;
  const int col0 = blockIdx.x * ntb * 8;
  const int nt = min(ntb, (HD - col0) / 8);
  const long long r_begin = blockIdx.y * chunk;
  const long long r_end = r_begin + chunk < R ? r_begin + chunk : R;
  const int n_slices =
      r_begin < r_end ? (int)((r_end - r_begin + DWT_K - 1) / DWT_K) : 0;
  const bool has_tile = warp < (DS + 15) / 16;    // the warp's row tile of dW

  auto load_slice = [&](int slice) {
    unsigned char* stage = dw_smem + (slice % DWT_STAGES) * stage_bytes;
    bf16* sA = reinterpret_cast<bf16*>(stage);
    bf16* sB = reinterpret_cast<bf16*>(stage + a_bytes);
    const long long r0 = r_begin + (long long)slice * DWT_K;
    // a warp on every WARPS-th slot, a lane on one 16-byte chunk of its row
    // (DS / 8 <= 32 chunks of emb, nt <= 16 of cot)
#pragma unroll
    for (int r = warp; r < DWT_K; r += WARPS) {
      const bool in = r0 + r < r_end;
      if (8 * lane < DS) {
        bf16* to = sA + r * lda + 8 * lane;
        if (in)
          cp_async16(to, emb + (r0 + r) * D + d0 + 8 * lane);
        else
          *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      }
      if (lane < nt) {
        bf16* to = sB + r * ldb + 8 * lane;
        if (in)
          cp_async16(to, cot + (r0 + r) * HD + col0 + 8 * lane);
        else
          *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float acc[NT][4];
  zero_acc(acc);

  // one commit per slot of the ring, loaded or not, keeps the group count
  // the same for every thread
  for (int s = 0; s < DWT_STAGES - 1; ++s) {
    if (s < n_slices) load_slice(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<DWT_STAGES - 2>();
    __syncthreads();       // slice s has landed; slice s - 1 is consumed
    if (s + DWT_STAGES - 1 < n_slices) load_slice(s + DWT_STAGES - 1);
    cp_async_commit();
    const unsigned char* stage = dw_smem + (s % DWT_STAGES) * stage_bytes;
    const bf16* sA = reinterpret_cast<const bf16*>(stage);
    const bf16* sB = reinterpret_cast<const bf16*>(stage + a_bytes);
    if (!has_tile) continue;
#pragma unroll
    for (int ks = 0; ks < DWT_K / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4_trans(
          af, a_frag_ptr_trans(sA + ks * 16 * lda + warp * 16, lda, lane));
      const bf16* b_ptr = b_frag_ptr_trans(sB + ks * 16 * ldb, ldb, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, b_ptr + j * 8);
        mma_bf16_16x8x16(acc[j], af, b[0], b[1]);
        mma_bf16_16x8x16(acc[j + 1], af, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  if (!has_tile) return;
  const int row = warp * 16 + (lane >> 2);       // of the slice
  float* p = part + ((long long)blockIdx.y * D + d0 + row) * HD + col0 +
             2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      if (row < DS)
        *reinterpret_cast<float2*>(p + 8 * j) =
            make_float2(acc[j][0], acc[j][1]);
      if (row + 8 < DS)
        *reinterpret_cast<float2*>(p + 8 * j + 8LL * HD) =
            make_float2(acc[j][2], acc[j][3]);
    }
  }
}

template <int PASS, int PAIRS>
cudaError_t launch_edge_tc(const TcArgs& a, int warps, int n_blocks,
                           cudaStream_t s) {
  typedef TcShape<PAIRS, TC_SMALL_FLOATS> S;
  const size_t smem = (size_t)S::w_bytes + (size_t)warps * S::warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      edge_pass_tc_kernel<PASS, PAIRS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  edge_pass_tc_kernel<PASS, PAIRS><<<n_blocks, 32 * warps, smem, s>>>(a);
  return cudaSuccess;
}

template <int NP, int WARPS>
cudaError_t launch_dw_tc(const TcArgs& a, float* dw_part, int n_split,
                         int ntb, cudaStream_t s) {
  const size_t smem = (size_t)DWT_STAGES * DWT_K *
                      (tile_pitch(a.DS) + 16 * NP + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      dw_tc_kernel<NP, WARPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long R = (long long)a.G * a.E;
  long long chunk = (R + n_split - 1) / n_split;
  chunk = (chunk + DWT_K - 1) / DWT_K * DWT_K;
  dw_tc_kernel<NP, WARPS>
      <<<dim3((a.HD / 8 + ntb - 1) / ntb, n_split, a.D / a.DS), 32 * WARPS,
         smem, s>>>(a.emb, a.cot, dw_part, R, chunk, a.D, a.DS, a.HD, ntb);
  return cudaSuccess;
}

template <int NP>
cudaError_t launch_dw_rows(const TcArgs& a, float* dw_part, int n_split,
                           int ntb, cudaStream_t s) {
  return a.DS > 128 ? launch_dw_tc<NP, 16>(a, dw_part, n_split, ntb, s)
                    : launch_dw_tc<NP, 8>(a, dw_part, n_split, ntb, s);
}

// The launches of a pass on the tensor-core route: the edge kernel once a
// slice of W's rows (D / DS of them, in order), dW and the two reductions.
// `warps` and `n_blocks` are the caller's (the partial arrays are sized
// from them).
template <int PASS>
int launch_pass_tc(TcArgs a, float* dw_part, float* dw, float* db,
                   int n_split, int warps, int n_blocks, cudaStream_t s) {
  if (warps < 1 || warps > TC_MAX_WARPS || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const int n_slices = a.D / a.DS;
  for (int z = 0; z < n_slices && err == cudaSuccess; ++z) {
    a.d0 = z * a.DS;
    a.first = z == 0;
    a.last = z == n_slices - 1;
    switch (tc_pairs(a.DS, a.HD)) {
      case 4: err = launch_edge_tc<PASS, 4>(a, warps, n_blocks, s); break;
      case 8: err = launch_edge_tc<PASS, 8>(a, warps, n_blocks, s); break;
      case 13: err = launch_edge_tc<PASS, 13>(a, warps, n_blocks, s); break;
      default: err = launch_edge_tc<PASS, 16>(a, warps, n_blocks, s); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int D = a.D, HD = a.HD, ntb = dw_block_tiles(HD);
  switch (dw_pairs(ntb)) {
    case 2: err = launch_dw_rows<2>(a, dw_part, n_split, ntb, s); break;
    case 4: err = launch_dw_rows<4>(a, dw_part, n_split, ntb, s); break;
    case 7: err = launch_dw_rows<7>(a, dw_part, n_split, ntb, s); break;
    default: err = launch_dw_rows<8>(a, dw_part, n_split, ntb, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(D * HD + 31) / 32, dim3(32, 8), 0, s>>>(
      dw_part, dw, n_split, D * HD);
  reduce_partials_kernel<<<(HD + 31) / 32, dim3(32, 8), 0, s>>>(
      a.db_part, db, n_blocks, HD);
  return (int)cudaGetLastError();
}

}  // namespace
