// The tensor-core route of the projected GAT op's forward passes A (scores)
// and C (aggregation): the per-edge projection emb W on tensor cores
// (mma_tile.cuh), bf16 products in bfloat16, split-TF32 products (three
// tf32 products a step, f32-accurate) in float32. What the passes compute,
// and the source note with the design and its times, are at the head of
// gat_fwd.cu; route 0, the CUDA-core kernels, is there too.
//
// `fwd_pass_tc_kernel<PASS, PAIRS, STREAM, T>`, one launch: persistent blocks,
// one per SM. At D <= 256 (STREAM false) a block loads W (w_ke or w_me) once,
// rounded to bf16 and zero-padded, into shared memory. Each warp then works
// alone on one contiguous range of units of 16 consecutive edge slots (so
// its graph changes rarely), with a private stage in shared memory and only
// warp barriers:
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
//
// At D > 256 (STREAM true) W does not fit beside the warps' stages. The
// wrapper hands it rounded to bf16 (ws; the launch streams exactly when it
// is given), and the block streams its rows
// through a shared ring of TC_STAGES chunks of TC_KC rows by cp.async, its
// tile's columns sized from HD alone (`TcStreamShape`). The warps take
// their units in lockstep, one unit each a round, as many rounds as the
// longest range: in step b each round walks D in chunks, one block barrier
// a chunk, the next chunk's W rows (the whole block) and emb columns (each
// warp its unit's) in flight during this one's product, the f32
// accumulators kept in registers across the chunks; the warp's emb chunks
// ride in its stage, under the f32 rows of step c. Steps a, c and d are as
// above; a warp whose range has ended still loads its share of W and meets
// the barriers. W's rows are read from L2 once a round a block, so the
// more slots a round, the fewer bytes: up to 144 columns a block runs 12
// warps (`tc_stream_warps`), wider tiles 8.
//
// On the H100 (NVIDIA H100 80GB HBM3, 700 W; G=64, N=200, E=4096, 25% of
// slots masked; torch.profiler's time a launch): 481 and 488 us a launch of
// passes A and C at D x HD = 512 x 256, 479 and 448 at 1040 x 136, against
// 2,400 and 3,421 us on the CUDA-core kernels. Variants timed while it was
// designed: each of the epilogue, the products and W's loads, taken out
// alone, shortened a launch by a large share, so the lockstep runs the
// products, held back by W's bytes from L2, and then the epilogue, each in
// turn. Chunks of 32 rows (two or three stages), two blocks of 4 warps an
// SM (each block streams W itself) and issuing the next round's first W
// chunk during the epilogue all lost; at 128-136 columns 12 warps beat 8
// and 10, and 14 or 16 (128 registers, spills) lost.
//
// float32 (T = float, the last template argument): the streaming form at
// every D (W's f32 rows whole would take 180 KB of shared memory at D = HD
// = 200, room for three warps), on the f32 ring of TcStream32Shape, the
// backward's: chunks of TC_KC32 = 32 of W's rows, handed by the wrapper as
// W itself and never rounded, in w32_col's layout; the tile's columns from
// HD alone (tc_stream_pairs); 8 warps a block at every tile
// (tc_fwd_max_warps: the split products and the f32 node rows in flight
// take 200-255 registers a lane). Each warp's emb chunks ride in its stage
// in f32; step b is the split-TF32 warp_rows_product (the emb fragment
// split once a step for every tile, W's values as they are read, a fresh
// accumulator every 16 of depth); the epilogue gathers the node rows as
// f32, two 16-byte loads a lane for its 8 columns; pass C's three rounding
// points are the identity. The first group's node rows are gathered after
// the product and the lane's heads and biases taken again after it, so
// that the product has the registers: on the H100 gathering the rows
// before it took the preset's launch of pass A / C from 0.68 / 0.64 ms to
// 0.83 / 0.75, and holding the heads and biases across it a call at
// gnn_dim 512 from 3.66 / 3.72 ms to 3.90 / 3.77 (PERF.md PR 21; times at
// the head of gat_fwd.cu).
#pragma once
#include "gat_tc_common.cuh"

namespace {

// per warp beside the stage: pass A's scores [head][row] or pass C's alpha
// [row][head], then the unit's source and destination nodes
constexpr int TC_FWD_SMALL_FLOATS = TC_ROWS * MAX_H + 2 * TC_ROWS;

// T: the node and edge arrays' type, bf16 or float
template <typename T>
struct TcFwdArgs {
  const T* rows_src;          // pass A: nq; pass C: nm
  const T* rows_dst;          // pass A: nk
  const T* emb;
  const float* w;             // W (D, HD) f32, which the resident kernel rounds
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
  int part;                   // pass A: PART_ADD | PART_OPEN (gat_common.cuh)
  // W (D, HD) as the kernel streams it, or null (bf16 at D <= 256: W
  // resident): W rounded to bf16 in bf16, W itself in f32
  const T* ws;
};

template <typename T, bool STREAM, int PAIRS>
struct FwdShape {
  typedef TcShape<PAIRS, TC_FWD_SMALL_FLOATS> type;
};
template <int PAIRS>
struct FwdShape<bf16, true, PAIRS> {
  typedef TcStreamShape<PAIRS, TC_FWD_SMALL_FLOATS> type;
};
template <int PAIRS>
struct FwdShape<float, true, PAIRS> {
  typedef TcStream32Shape<PAIRS, TC_FWD_SMALL_FLOATS> type;
};

// Warps a block of the forward kernel may run: the bf16 streaming kernel's
// by its tile (tc_stream_warps), TC_MAX_WARPS for the resident kernel and
// for f32 at every tile (its split products take more registers a lane,
// and its node rows twice as many)
__host__ __device__ constexpr int tc_fwd_max_warps(bool f32, bool stream,
                                                   int pairs) {
  return f32 || !stream ? TC_MAX_WARPS : tc_stream_warps(pairs);
}

// PASS 1: pass A (scores), PASS 3: pass C (aggregation); STREAM: W's rows
// streamed in chunks (a.ws given); T: bf16 (W resident or streamed) or float
// (streamed, split-TF32 products)
template <int PASS, int PAIRS, bool STREAM, typename T>
__global__ void __launch_bounds__(
    32 * tc_fwd_max_warps(sizeof(T) == 4, STREAM, PAIRS), 1)
fwd_pass_tc_kernel(const TcFwdArgs<T> a) {
  static_assert(STREAM || sizeof(T) == 2, "f32 streams W at every D");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  typedef typename FwdShape<T, STREAM, PAIRS>::type S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int E = a.E, N = a.N, D = a.D, HD = a.HD, H = a.H;
  T* sW = reinterpret_cast<T*>(tc_smem);           // W, or its ring (STREAM)
  unsigned char* mine = tc_smem + S::w_bytes + warp * S::warp_bytes;
  T* s_emb = reinterpret_cast<T*>(mine);           // STREAM: the emb ring
  float* s_rows = reinterpret_cast<float*>(mine);
  const int Dp = round_up16(D);
  float* s_small = reinterpret_cast<float*>(mine + S::stage_bytes);
  float (*s_sc)[TC_ROWS] = reinterpret_cast<float (*)[TC_ROWS]>(s_small);
  float (*s_alpha)[MAX_H] = reinterpret_cast<float (*)[MAX_H]>(s_small);
  int* s_src = reinterpret_cast<int*>(s_small + TC_ROWS * MAX_H);
  int* s_dst = s_src + TC_ROWS;

  if constexpr (STREAM)
    tc_zero_ring<S>(sW);
  else
    tc_load_w<S>(sW, a.w, D, HD);
  __syncthreads();

  const int c0 = 8 * lane, dph = HD / H;
  const bool active = c0 < HD;
  // the heads and biases of the lane's 8 columns: kept across units in
  // bf16; in f32 taken again after each unit's product, whose split
  // operands need the registers
  int head[8];
  float bias[8];
  auto columns = [&]() {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      head[j] = (c0 + j) / dph;
      bias[j] = active ? a.bias[c0 + j] : 0.0f;
    }
  };
  if constexpr (sizeof(T) == 2) columns();
  float acc[S::NT][4];

  // the warp's units: one contiguous range of them
  const int units_per_graph = (E + TC_ROWS - 1) / TC_ROWS;
  const long long n_units = (long long)a.G * units_per_graph;
  const long long all_warps = (long long)gridDim.x * nwarps;
  const long long wid = (long long)blockIdx.x * nwarps + warp;
  const long long u_begin = n_units * wid / all_warps;
  const long long u_end = n_units * (wid + 1) / all_warps;
  // STREAM: the rounds of the lockstep, the longest range's units
  const long long u_stop =
      STREAM ? u_begin + (n_units + all_warps - 1) / all_warps : u_end;
  int ring = 0;                   // STREAM: the ring's stage of chunk 0

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
      if ((lane & 15) == 0 && h < H && m > NEG && !(a.part & PART_OPEN))
        atomic_max_float(&a.m_edge[run_g * H + h], m);
      run_max[k] = NEG;
    }
  };

  int next_src, next_dst;         // the nodes of the unit after this one
  tc_unit_nodes(a.mask, a.src, a.dst, E, u_begin, u_end, units_per_graph,
                lane, next_src, next_dst);
  for (long long u = u_begin; u < u_stop; ++u) {
    const bool has_unit = !STREAM || u < u_end;  // uniform over the warp
    const long long g = u / units_per_graph;
    const int e0 = (int)(u % units_per_graph) * TC_ROWS;
    if (PASS == 1 && has_unit && g != run_g) {   // uniform over the warp
      fold_max();
      run_g = g;
    }

    // a. the unit's nodes and the next one's; the live emb rows, a lane on
    // one 16-byte chunk of every row (STREAM: chunk by chunk in step b)
    if (has_unit) {
      if (lane < TC_ROWS) {
        s_src[lane] = next_src;
        s_dst[lane] = next_dst;
      }
      tc_unit_nodes(a.mask, a.src, a.dst, E, u + 1, u_end, units_per_graph,
                    lane, next_src, next_dst);
      __syncwarp();
      if constexpr (!STREAM) {
        if (c0 < Dp) {
#pragma unroll 4
          for (int r = 0; r < TC_ROWS; ++r) {
            T* to = s_emb + r * S::ld16 + c0;
            if (s_src[r] >= 0 && c0 < D)
              cp_async16(to, a.emb + ((g * E + e0 + r) * D + c0));
            else
              *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        cp_async_commit();
      }
      if (PASS == 3) {
        // alpha = round(e * round(scale[src])), 0 for dead slots: the TPU
        // kernel packs the scale into the compute-dtype node plane and rounds
        // alpha before its broadcast (the identity in f32)
        for (int idx = lane; idx < TC_ROWS * H; idx += 32) {
          const int h = idx / TC_ROWS, el = idx % TC_ROWS, e = e0 + el;
          const int s_node = s_src[el];
          float al = 0.0f;
          if (s_node >= 0) {
            const float x = a.scores[(g * H + h) * E + e] - a.gmax[g * H + h];
            al = round_to<T>(expf(fminf(x, 0.0f)) *
                             round_to<T>(a.scale[(g * N + s_node) * H + h]));
          }
          s_alpha[el][h] = al;
        }
      }
    }
    // the first group's node rows, in flight during the product (a lane's
    // 8 columns: one 16-byte load in bf16, two in f32)
    Vec8<T> cur_s[TC_GROUP], cur_d[TC_GROUP], next_s[TC_GROUP],
        next_d[TC_GROUP];
    auto gather = [&](int r0, Vec8<T> (&to_s)[TC_GROUP],
                      Vec8<T> (&to_d)[TC_GROUP]) {
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i) {
        to_s[i] = to_d[i] = zero8<T>();
        if (active && s_src[r0 + i] >= 0) {
          to_s[i] = load8(a.rows_src + (g * N + s_src[r0 + i]) * HD + c0);
          if (PASS == 1)
            to_d[i] = load8(a.rows_dst + (g * N + s_dst[r0 + i]) * HD + c0);
        }
      }
    };
    // (f32: after the product, whose split operands leave no registers for
    // eight rows of f32 in flight)
    if (has_unit && sizeof(T) == 2) gather(0, next_s, next_d);

    // b. the projection emb W
    if constexpr (STREAM) {
      // W's rows and the emb columns in chunks of S::KC: chunk k in stage
      // (ring + k) % TC_STAGES, the next TC_STAGES - 1 in flight
      zero_acc(acc);
      const int n_chunks = (D + S::KC - 1) / S::KC;
      const T* rows = a.emb + (g * E + e0) * D;
      auto load_chunk = [&](int k) {
        const int st = (ring + k) % TC_STAGES;
        tc_load_w_chunk<S>(sW + st * S::w_chunk, a.ws, k * S::KC, D, HD);
        if (has_unit)
          tc_load_emb_chunk<S>(s_emb + st * S::emb_chunk, rows, k * S::KC,
                               D, s_src, lane);
      };
#pragma unroll
      for (int k = 0; k < TC_STAGES - 1; ++k) {
        if (k < n_chunks) load_chunk(k);
        cp_async_commit();
      }
#pragma unroll 1
      for (int k = 0; k < n_chunks; ++k) {
        // chunk k landed for every thread, and every warp is done with
        // chunk k - 1, whose stage the load below refills
        cp_async_wait<TC_STAGES - 2>();
        __syncthreads();
        if (k + TC_STAGES - 1 < n_chunks) load_chunk(k + TC_STAGES - 1);
        cp_async_commit();
        if (has_unit) {
          const int st = (ring + k) % TC_STAGES;
          const int ksteps = min(S::KC, Dp - k * S::KC) / 16;
          warp_rows_product<true>(s_emb + st * S::emb_chunk, S::ldk,
                                  sW + st * S::w_chunk, S::ldw, ksteps, acc);
        }
      }
      ring = (ring + n_chunks) % TC_STAGES;
      if (!has_unit) continue;                 // uniform over the warp
    } else {
      cp_async_wait<0>();
      __syncwarp();
      zero_acc(acc);
      warp_rows_product<true>(s_emb, S::ld16, sW, S::ld16, Dp / 16, acc);
    }
    if constexpr (sizeof(T) == 4) {
      gather(0, next_s, next_d);
      columns();
    }
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
        unpack8(cur_s[i], vs);
        const float4 p0 =
            *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0);
        const float4 p1 =
            *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0 + 4);
        proj[0] = p0.x; proj[1] = p0.y; proj[2] = p0.z; proj[3] = p0.w;
        proj[4] = p1.x; proj[5] = p1.y; proj[6] = p1.z; proj[7] = p1.w;
        if (PASS == 1) {
          // vs = nq[src], vd = nk[dst]
          float vd[8];
          unpack8(cur_d[i], vd);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            p[i][j] = vs[j] * (vd[j] + (proj[j] + bias[j]));
        } else {
          // vs = nm[src]; the weighted message rounded to the compute
          // dtype, as the TPU kernel rounds it before its scatter
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = round_to<T>(s_alpha[r][head[j]] *
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
          float v = s_sc[h][el];
          if (a.part & PART_ADD) v += a.scores_out[(g * H + h) * E + e];
          a.scores_out[(g * H + h) * E + e] = v;
          if (s_src[el] >= 0) run_max[k] = fmaxf(run_max[k], v);
        }
      }
    }
    __syncwarp();     // the stage is free for the next unit's emb rows
  }
  if (PASS == 1 && u_begin < u_end) fold_max();
}

template <int PASS, int PAIRS, bool STREAM, typename T>
int launch_fwd_shape(const TcFwdArgs<T>& a, int warps, int n_blocks,
                     cudaStream_t s) {
  typedef typename FwdShape<T, STREAM, PAIRS>::type S;
  const size_t smem = (size_t)S::w_bytes + (size_t)warps * S::warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_pass_tc_kernel<PASS, PAIRS, STREAM, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fwd_pass_tc_kernel<PASS, PAIRS, STREAM, T>
      <<<n_blocks, 32 * warps, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The streaming kernel at the tile of HD's columns (tc_stream_pairs)
template <int PASS, typename T>
int launch_fwd_stream(const TcFwdArgs<T>& a, int warps, int n_blocks,
                      cudaStream_t s) {
  switch (tc_stream_pairs(a.HD)) {
    case 4: return launch_fwd_shape<PASS, 4, true>(a, warps, n_blocks, s);
    case 8: return launch_fwd_shape<PASS, 8, true>(a, warps, n_blocks, s);
    case 9: return launch_fwd_shape<PASS, 9, true>(a, warps, n_blocks, s);
    case 13: return launch_fwd_shape<PASS, 13, true>(a, warps, n_blocks, s);
    default: return launch_fwd_shape<PASS, 16, true>(a, warps, n_blocks, s);
  }
}

// The pass's one launch on the tensor-core route; `warps` and `n_blocks` are
// the caller's plan. W streamed in chunks of its rows when the caller hands
// it to stream (a.ws: rounded to bf16 in bf16, which the wrapper does past
// D = 256; W itself in f32, always), else resident, which takes bf16 at
// D <= 256. A call the kernel does not take is refused.
template <int PASS, typename T>
int launch_fwd_tc(const TcFwdArgs<T>& a, int warps, int n_blocks,
                  cudaStream_t s) {
  constexpr bool f32 = sizeof(T) == 4;
  const bool stream = a.ws != nullptr;
  const int max_warps =
      tc_fwd_max_warps(f32, stream, tc_stream_pairs(a.HD));
  if (warps < 1 || warps > max_warps || n_blocks < 1 ||
      (stream ? !aligned16(a.ws) : f32 || a.D > MAX_HD))
    return (int)cudaErrorInvalidValue;
  if (stream) return launch_fwd_stream<PASS>(a, warps, n_blocks, s);
  if constexpr (!f32) {
    switch (tc_pairs(a.D, a.HD)) {
      case 4: return launch_fwd_shape<PASS, 4, false>(a, warps, n_blocks, s);
      case 8: return launch_fwd_shape<PASS, 8, false>(a, warps, n_blocks, s);
      case 13: return launch_fwd_shape<PASS, 13, false>(a, warps, n_blocks, s);
      default: return launch_fwd_shape<PASS, 16, false>(a, warps, n_blocks, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
