// The bfloat16 route of the projected GAT op's forward passes A (scores) and
// C (aggregation): the per-edge projection emb W on tensor cores
// (mma_tile.cuh). What the passes compute, and the source note with the
// design and its times, are at the head of gat_fwd.cu; the f32 route there
// stays on CUDA cores.
//
// `fwd_pass_tc_kernel<PASS, PAIRS>`, one launch: persistent blocks, one per
// SM. A block loads W (w_ke or w_me) once, rounded to bf16 and zero-padded,
// into shared memory. Each warp then works alone on one contiguous range of
// units of 16 consecutive edge slots (so its graph changes rarely), with a
// private stage in shared memory and only warp barriers:
//   a. the unit's nodes, fetched during the unit before, and the next unit's
//      fetched now; the live rows of emb -> stage (cp.async), zeros in masked
//      rows and in the depth padding; pass C also the unit's alpha per
//      (edge, head) meanwhile; the node rows of the epilogue's first group
//      gathered into registers, in flight during the product;
//   b. emb W in f32 accumulators (a row's columns lie in one quad);
//   c. the accumulators -> stage as f32 rows (over the consumed emb rows);
//   d. the row-wise epilogue, a lane on 8 adjacent columns, four rows at a
//      time, the next four rows' node gathers in flight. Pass A: the products
//      nq[src] * (nk[dst] + proj + b_ke), their per-head sums for any head
//      width (tc_group_head_sums), then the unit's scores, 16 slots a head,
//      and a running max per head over the live slots that goes to m_edge by
//      an atomic max whenever the warp's graph changes and at its end.
//      Pass C: round(alpha * (nm[src] + proj + b_me)) added at out[dst] by
//      16-byte atomicAdd.
// Masked slots skip their gathers: pass A writes 0 as their score (nothing
// reads it), pass C adds nothing for them.
#pragma once
#include "gat_tc_common.cuh"

namespace {

// per warp beside the stage: pass A's scores [head][row] or pass C's alpha
// [row][head], then the unit's source and destination nodes
constexpr int TC_FWD_SMALL_FLOATS = TC_ROWS * MAX_H + 2 * TC_ROWS;

struct TcFwdArgs {
  const bf16* rows_src;       // pass A: nq; pass C: nm
  const bf16* rows_dst;       // pass A: nk
  const bf16* emb;
  const float* w;
  const float* bias;
  const float* scores;        // pass C
  const float* gmax;          // pass C
  const float* scale;         // pass C
  const int32_t* src;
  const int32_t* dst;
  const uint8_t* mask;
  float* scores_out;          // pass A
  float* m_edge;              // pass A
  float* out;                 // pass C
  int G, N, E, D, HD, H;
};

// PASS 1: pass A (scores), PASS 3: pass C (aggregation)
template <int PASS, int PAIRS>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS, 1)
fwd_pass_tc_kernel(const TcFwdArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  typedef TcShape<PAIRS, TC_FWD_SMALL_FLOATS> S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int E = a.E, N = a.N, D = a.D, HD = a.HD, H = a.H;
  bf16* sW = reinterpret_cast<bf16*>(tc_smem);
  unsigned char* mine = tc_smem + S::w_bytes + warp * S::warp_bytes;
  bf16* s_emb = reinterpret_cast<bf16*>(mine);
  float* s_rows = reinterpret_cast<float*>(mine);
  const int Dp = round_up16(D);
  float* s_small = reinterpret_cast<float*>(mine + S::stage_bytes);
  float (*s_sc)[TC_ROWS] = reinterpret_cast<float (*)[TC_ROWS]>(s_small);
  float (*s_alpha)[MAX_H] = reinterpret_cast<float (*)[MAX_H]>(s_small);
  int* s_src = reinterpret_cast<int*>(s_small + TC_ROWS * MAX_H);
  int* s_dst = s_src + TC_ROWS;

  tc_load_w<S>(sW, a.w, D, HD);
  __syncthreads();

  const int c0 = 8 * lane, dph = HD / H;
  const bool active = c0 < HD;
  int head[8];
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    head[j] = (c0 + j) / dph;
    bias[j] = active ? a.bias[c0 + j] : 0.0f;
  }
  float acc[S::NT][4];

  // the warp's units: one contiguous range of them
  const int units_per_graph = (E + TC_ROWS - 1) / TC_ROWS;
  const long long n_units = (long long)a.G * units_per_graph;
  const long long all_warps = (long long)gridDim.x * nwarps;
  const long long wid = (long long)blockIdx.x * nwarps + warp;
  const long long u_begin = n_units * wid / all_warps;
  const long long u_end = n_units * (wid + 1) / all_warps;

  // pass A: the lane's running max over live slots of heads 2 k + lane / 16
  // (the heads whose scores it writes) in graph run_g
  float run_max[MAX_H / 2];
#pragma unroll
  for (int k = 0; k < MAX_H / 2; ++k) run_max[k] = NEG;
  long long run_g = u_begin / units_per_graph;
  auto fold_max = [&]() {
#pragma unroll
    for (int k = 0; k < MAX_H / 2; ++k) {
      if (2 * k >= H) break;                  // uniform over the warp
      float m = run_max[k];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      const int h = 2 * k + (lane >> 4);
      if ((lane & 15) == 0 && h < H && m > NEG)
        atomic_max_float(&a.m_edge[run_g * H + h], m);
      run_max[k] = NEG;
    }
  };

  int next_src, next_dst;         // the nodes of the unit after this one
  tc_unit_nodes(a.mask, a.src, a.dst, E, u_begin, u_end, units_per_graph,
                lane, next_src, next_dst);
  for (long long u = u_begin; u < u_end; ++u) {
    const long long g = u / units_per_graph;
    const int e0 = (int)(u % units_per_graph) * TC_ROWS;
    if (PASS == 1 && g != run_g) {            // uniform over the warp
      fold_max();
      run_g = g;
    }

    // a. the unit's nodes and the next one's; the live emb rows, a lane on
    // one 16-byte chunk of every row
    if (lane < TC_ROWS) {
      s_src[lane] = next_src;
      s_dst[lane] = next_dst;
    }
    tc_unit_nodes(a.mask, a.src, a.dst, E, u + 1, u_end, units_per_graph,
                  lane, next_src, next_dst);
    __syncwarp();
    if (c0 < Dp) {
#pragma unroll 4
      for (int r = 0; r < TC_ROWS; ++r) {
        bf16* to = s_emb + r * S::ld16 + c0;
        if (s_src[r] >= 0 && c0 < D)
          cp_async16(to, a.emb + ((g * E + e0 + r) * D + c0));
        else
          *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
    if (PASS == 3) {
      // alpha = round(e * round(scale[src])), 0 for dead slots: the TPU
      // kernel packs the scale into the compute-dtype node plane and rounds
      // alpha before its broadcast
      for (int idx = lane; idx < TC_ROWS * H; idx += 32) {
        const int h = idx / TC_ROWS, el = idx % TC_ROWS, e = e0 + el;
        const int s_node = s_src[el];
        float al = 0.0f;
        if (s_node >= 0) {
          const float x = a.scores[(g * H + h) * E + e] - a.gmax[g * H + h];
          al = round_to<bf16>(
              expf(fminf(x, 0.0f)) *
              round_to<bf16>(a.scale[(g * N + s_node) * H + h]));
        }
        s_alpha[el][h] = al;
      }
    }
    // the first group's node rows, in flight during the product
    uint4 cur_s[TC_GROUP], cur_d[TC_GROUP], next_s[TC_GROUP],
        next_d[TC_GROUP];
    auto gather = [&](int r0, uint4 (&to_s)[TC_GROUP],
                      uint4 (&to_d)[TC_GROUP]) {
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i) {
        to_s[i] = to_d[i] = make_uint4(0u, 0u, 0u, 0u);
        if (active && s_src[r0 + i] >= 0) {
          to_s[i] = *reinterpret_cast<const uint4*>(
              a.rows_src + (g * N + s_src[r0 + i]) * HD + c0);
          if (PASS == 1)
            to_d[i] = *reinterpret_cast<const uint4*>(
                a.rows_dst + (g * N + s_dst[r0 + i]) * HD + c0);
        }
      }
    };
    gather(0, next_s, next_d);
    cp_async_wait<0>();
    __syncwarp();

    // b. the projection emb W
    zero_acc(acc);
    warp_rows_product<true>(s_emb, S::ld16, sW, S::ld16, Dp / 16, acc);
    __syncwarp();
    // c. accumulators -> f32 rows over the consumed emb rows
    tc_stage_acc(acc, s_rows, S::ld32, lane);
    __syncwarp();

    // d. the row-wise epilogue, TC_GROUP rows at a time, the next group's
    // node rows in flight
#pragma unroll 1
    for (int r0 = 0; r0 < TC_ROWS; r0 += TC_GROUP) {
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i) {
        cur_s[i] = next_s[i];
        cur_d[i] = next_d[i];
      }
      if (r0 + TC_GROUP < TC_ROWS) gather(r0 + TC_GROUP, next_s, next_d);
      float p[TC_GROUP][8];        // pass A: q * key per column
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i) {
        const int r = r0 + i;
        if (PASS == 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j) p[i][j] = 0.0f;
        }
        if (s_src[r] < 0 || !active) continue;
        float vs[8], proj[8];
        unpack_bf16x8(cur_s[i], vs);
        const float4 p0 =
            *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0);
        const float4 p1 =
            *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0 + 4);
        proj[0] = p0.x; proj[1] = p0.y; proj[2] = p0.z; proj[3] = p0.w;
        proj[4] = p1.x; proj[5] = p1.y; proj[6] = p1.z; proj[7] = p1.w;
        if (PASS == 1) {
          // vs = nq[src], vd = nk[dst]
          float vd[8];
          unpack_bf16x8(cur_d[i], vd);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            p[i][j] = vs[j] * (vd[j] + (proj[j] + bias[j]));
        } else {
          // vs = nm[src]; the weighted message rounded to bf16, as the TPU
          // kernel rounds it before its scatter
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = round_to<bf16>(s_alpha[r][head[j]] *
                                  (vs[j] + (proj[j] + bias[j])));
          float* to = a.out + (g * N + s_dst[r]) * HD + c0;
          atomicAdd(reinterpret_cast<float4*>(to),
                    make_float4(v[0], v[1], v[2], v[3]));
          atomicAdd(reinterpret_cast<float4*>(to + 4),
                    make_float4(v[4], v[5], v[6], v[7]));
        }
      }
      if (PASS == 1) {
        if (H <= 4)
          tc_group_head_sums<4>(p, head, H, r0, lane, s_sc);
        else
          tc_group_head_sums<8>(p, head, H, r0, lane, s_sc);
      }
    }
    __syncwarp();
    if (PASS == 1) {
      // the unit's scores, 16 slots a head (lane l on slot l % 16 of heads
      // 2 k + l / 16), and the running max over its live slots
#pragma unroll
      for (int k = 0; k < MAX_H / 2; ++k) {
        const int h = 2 * k + (lane >> 4), el = lane & 15, e = e0 + el;
        if (h < H && e < E) {
          const float v = s_sc[h][el];
          a.scores_out[(g * H + h) * E + e] = v;
          if (s_src[el] >= 0) run_max[k] = fmaxf(run_max[k], v);
        }
      }
    }
    __syncwarp();     // the stage is free for the next unit's emb rows
  }
  if (PASS == 1 && u_begin < u_end) fold_max();
}

template <int PASS, int PAIRS>
cudaError_t launch_fwd_tc_pairs(const TcFwdArgs& a, int warps, int n_blocks,
                                cudaStream_t s) {
  typedef TcShape<PAIRS, TC_FWD_SMALL_FLOATS> S;
  const size_t smem = (size_t)S::w_bytes + (size_t)warps * S::warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_pass_tc_kernel<PASS, PAIRS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fwd_pass_tc_kernel<PASS, PAIRS><<<n_blocks, 32 * warps, smem, s>>>(a);
  return cudaGetLastError();
}

// The pass's one launch on the tensor-core route; `warps` and `n_blocks` are
// the caller's plan.
template <int PASS>
int launch_fwd_tc(const TcFwdArgs& a, int warps, int n_blocks,
                  cudaStream_t s) {
  if (warps < 1 || warps > TC_MAX_WARPS || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  switch (tc_pairs(a.D, a.HD)) {
    case 4: return (int)launch_fwd_tc_pairs<PASS, 4>(a, warps, n_blocks, s);
    case 8: return (int)launch_fwd_tc_pairs<PASS, 8>(a, warps, n_blocks, s);
    case 13: return (int)launch_fwd_tc_pairs<PASS, 13>(a, warps, n_blocks, s);
    default: return (int)launch_fwd_tc_pairs<PASS, 16>(a, warps, n_blocks, s);
  }
}

}  // namespace
