// The tensor-core route of the projected GAT op's backward passes 1 and 2:
// the three per-edge products of each pass on tensor cores (mma_tile.cuh),
// bf16 products in bfloat16, split-TF32 products (three tf32 products a
// step, f32-accurate) in float32. What the passes compute, and the source
// note with the design and its times, are at the head of gat_bwd.cu; route
// 0, the CUDA-core kernels, is there too.
//
// Launch 1, `edge_pass_tc_kernel<PASS, PAIRS, STREAM>`: persistent blocks,
// one per SM. At D <= 256 (STREAM false) a block loads W once, rounded to
// bf16 and zero-padded, into shared memory ([D][HD], used as it lies for emb
// W and read as [column][depth] for cot W^T: no transposed copy). Its warps
// then work alone, each on units of 16 consecutive edges of one graph, with
// a private stage in shared memory and only warp barriers:
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
// values before rounding); a block writes one partial row at its end. The
// tile counts of both products are compile-time (PAIRS): with a run-time
// count every pair of tiles sat behind a branch, the loads of a pair's B
// fragments could not move ahead of the pair before it, and the products
// took twice as long. Steps a and d are one device function each
// (tc_bwd_unit_weights, tc_bwd_epilogue), which the streaming kernel below
// calls too.
//
// Past D = 256 W no longer fits beside the stages (a 512 x 256 tile is 264
// KB). STREAM true: the wrapper hands W rounded to bf16 (ws; the launch
// streams exactly when it is given), and the block streams its rows twice a
// round through the forward's shared ring of TC_STAGES chunks of TC_KC rows
// (TcStreamShape, gat_tc_common.cuh), the tile's columns sized from HD
// alone, 128 at least. The warps take one unit each a round, in lockstep, a
// warp with no unit left still loading its share of W and meeting the
// barriers:
//   a. the unit's nodes and per-(edge, head) weights, as above;
//   b. product 1 walks D in chunks, one block barrier a chunk, the next
//      chunk's W rows (the whole block) and emb columns (each warp its
//      unit's, masked rows zeros) in flight during this one's product, the
//      f32 accumulators in registers across the chunks: the (G, E, HD) f32
//      projection never goes to device memory;
//   c., d. as above, once, on the whole projection;
//   e. product 2 walks W's chunks again, in reverse: chunk c's 64 rows are
//      demb's columns 64 c .. 64 c + 63, staged as f32 rows beside the
//      cotangent tile in the stage's rows and written 16 bytes a lane (+
//      carry, or + pass 1's demb in place, those loaded a chunk ahead).
//      The walk starts on the two chunks product 1 left in the ring and
//      ends on chunks 1 and 0, where the next round's product 1 starts:
//      2 n - 4 chunk loads a round for n chunks, not 2 n.
// The dW launch takes W's rows in slices of DS <= 256 (a grid dimension).
// Bound: a call's three products at the tensor-core peak (1.29 ms at
// gnn_dim 1040, 8 column launches; 0.31 ms at 512, 2); in bytes a launch
// reads the live slots' emb rows and demb (or the carry) once and writes
// demb once, about 1.5 GB (0.45 ms) at 1040 x 136. On the H100 (NVIDIA
// H100 80GB HBM3, 700 W; G=64, N=200, E=4096, 25% of slots masked;
// torch.profiler's time a launch) an edge launch takes 0.98-1.01 ms at 512
// x 256 and 1.08-1.12 ms at 1040 x 136 / 128, where the sliced design this
// replaced ran 5 launches of 0.42-0.44 ms a column launch with the f32
// projection's round trips through device memory. Variants timed while it was designed: writing demb from
// the accumulators, 4 bytes a lane, cost the largest single share, which
// staging the rows to write 16 bytes a lane took back in part; then the
// epilogue; each product and W's stream from L2 a smaller one; 8 warps a
// block at 136 columns lost to 12.
//
// Launch 2, `dw_tc_kernel`: dW = emb^T cot over all G * E slots, the slots
// being the depth: a block takes one range of slots and every row of dW for
// up to 128 of its columns (HD = 200: two blocks of 104 and 96 columns, which
// run side by side, so emb comes from device memory once), stages slices of 64
// slots of both operands through a four-deep cp.async ring, and writes its
// f32 partial once. Launches 3 and 4 add up the dW and db partials
// (reduce_partials.cuh): no atomics on dW or db.
//
// float32 (T = float, the last template argument of both kernels): the
// streaming edge kernel at every D (W's f32 rows whole would take 170 KB of
// shared memory at D = HD = 200, room for three warps) on the f32 ring of
// TcStream32Shape: chunks of 32 rows, tiles sized from HD alone
// (tc_stream_pairs, 64 columns up), 8 warps a block; every product the
// split-TF32 one of mma_tile.cuh, W's tile in w32_col's layout; the emb
// chunks, the projection and cotangent rows and the cotangent scratch in
// f32, the rounding points the identity. Product 2's output goes from the
// accumulators to demb (+ add, read at the same places before the
// product), a quad's 32 bytes a row: the f32 cotangent fills its rows of
// the stage. The dW launch runs the split product too, on slices of 32
// slots (the bytes of bf16's 64), with column blocks of 10 tiles beside
// bf16's ladder (dw_pairs). Both launches' split products sum each 16 of
// depth in a fresh accumulator (mma_split_tf32): the tensor core's
// truncating sum had put the passes 1.3e-5 of max|want| from their plain
// versions at the preset, 7e-7 since, for 6-15% more time a call (PERF.md
// PR 21). The variants timed while it was designed (gat_variants.py, then
// bwd_variants.py; PERF.md PR 20): the edge launch's time at D = HD = 200
// is about half its two products, a quarter its epilogue and a quarter the
// ring's streams and demb's read-modify-write, which the warps' lockstep
// keeps from overlapping; 64-row chunks at 144 and 208 columns gained too
// little to keep.
//
// The parts that the forward's tensor-core route shares (the W loader, the
// unit's nodes, the accumulator stage, the head sums) are in
// gat_tc_common.cuh.
#pragma once
#include "gat_tc_common.cuh"
#include "reduce_partials.cuh"

namespace {

// The per-warp tables of the edge kernel beside its stage (floats). The
// stage holds in turn the emb rows (bf16, pitch TcShape::ld16; streaming:
// the ring of emb chunks), the f32 projection rows (pitch TcShape::ld32
// floats), the bf16 cotangent rows in place (pitch 2 * ld32 elements: 64
// PAIRS + 16 bytes, an odd multiple of 16) and the f32 rows of cot W^T.
constexpr int TC_SMALL_FLOATS = 3 * TC_ROWS * MAX_H + 2 * TC_ROWS;

template <typename T, bool STREAM, int PAIRS>
struct BwdShape {
  typedef TcShape<PAIRS, TC_SMALL_FLOATS> type;
};
template <int PAIRS>
struct BwdShape<bf16, true, PAIRS> {
  typedef TcStreamShape<PAIRS, TC_SMALL_FLOATS> type;
};
template <int PAIRS>
struct BwdShape<float, true, PAIRS> {
  typedef TcStream32Shape<PAIRS, TC_SMALL_FLOATS> type;
};

// The streaming edge kernel's tile for a launch of HD columns: the
// forward's (tc_stream_pairs), but never narrower than 128 columns, so that
// a row of the stage holds product 2's f32 output of a chunk (TC_KC floats)
// beside the row's cotangent (HD bf16).
inline int tc_bwd_stream_pairs(int HD) {
  const int pairs = tc_stream_pairs(HD);
  return pairs < 8 ? 8 : pairs;
}

// Warps a block of the streaming edge kernel may run, by its tile's pairs:
// 12 up to 144 columns (168 registers a lane, no spill), 8 past that.
__host__ __device__ constexpr int tc_bwd_stream_warps(int pairs) {
  return pairs <= 9 ? 12 : TC_MAX_WARPS;
}

// Warps a block of the edge kernel may run: the f32 kernel TC_MAX_WARPS at
// every tile (its split products take more registers a lane)
__host__ __device__ constexpr int tc_bwd_max_warps(bool f32, bool stream,
                                                   int pairs) {
  return f32 || !stream ? TC_MAX_WARPS : tc_bwd_stream_warps(pairs);
}

// T: the node and edge arrays' type, bf16 or float
template <typename T>
struct TcArgs {
  // pass 1: rows_src = nm, rows_dst = gout; pass 2: rows_src = nq,
  // rows_dst = nk
  const T* rows_src;
  const T* rows_dst;
  const T* emb;
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
  const T* add;               // carry (may be null) or demb itself
  T* cot;                     // (G, E, HD) rows for the dW launch
  T* demb;                    // null: no product 2 (gat_demb.cu's)
  float* dalpha_out;          // pass 1
  float* acc_src;             // pass 1: dnm; pass 2: dnq
  float* acc_dst;             // pass 2: dnk
  float* dscale;              // pass 1
  float* db_part;             // (gridDim.x, HD)
  int G, N, E, D, HD, H;
  int DS;                     // rows of a slice of W in dW, dividing D
  int part;                   // pass 1: PART_ADD | PART_OPEN (gat_common.cuh)
  int ldc;                    // cot's row stride, elements (HD or wider)
  // W (D, HD) as the kernel streams it, or null (bf16: W resident): W
  // rounded to bf16 in bf16, W itself in f32
  const T* ws;
};

// A warp's small tables beside its stage: per (edge, head) the weight of
// the cotangent (pass 1: alpha, pass 2: d_s) and pass 1's exp, per (head,
// edge) pass 1's d_alpha, and the unit's nodes.
struct TcBwdTables {
  float (*wt)[MAX_H];
  float (*e)[MAX_H];
  float (*da)[TC_ROWS];
  int* src;
  int* dst;
  __device__ __forceinline__ explicit TcBwdTables(float* small)
      : wt(reinterpret_cast<float (*)[MAX_H]>(small)),
        e(reinterpret_cast<float (*)[MAX_H]>(small + TC_ROWS * MAX_H)),
        da(reinterpret_cast<float (*)[TC_ROWS]>(small +
                                                2 * TC_ROWS * MAX_H)),
        src(reinterpret_cast<int*>(small + 3 * TC_ROWS * MAX_H)),
        dst(src + TC_ROWS) {}
};

template <typename T>
__device__ __forceinline__ float tc_edge_exp(const TcArgs<T>& a, long long g,
                                             int h, int e) {
  return expf(fminf(a.scores[(g * a.H + h) * a.E + e] - a.gmax[g * a.H + h],
                    0.0f));
}

// Step a of a unit: its nodes (fetched during the unit before) into the
// tables, the next unit's fetched, and the per-(edge, head) weights, 0 for
// dead slots, rounded where the TPU rounds (gat_bwd.cu's head note).
template <typename T, int PASS>
__device__ __forceinline__ void tc_bwd_unit_weights(
    const TcArgs<T>& a, const TcBwdTables& t, long long g, int e0, long long u,
    long long stride, long long n_units, int units_per_graph, int lane,
    int& next_src, int& next_dst) {
  if (lane < TC_ROWS) {
    t.src[lane] = next_src;
    t.dst[lane] = next_dst;
  }
  tc_unit_nodes(a.mask, a.src, a.dst, a.E, u + stride, n_units,
                units_per_graph, lane, next_src, next_dst);
  __syncwarp();
  const int H = a.H, E = a.E;
  for (int idx = lane; idx < TC_ROWS * H; idx += 32) {
    const int h = idx / TC_ROWS, el = idx % TC_ROWS, e = e0 + el;
    const int s_node = t.src[el];
    float ee = 0.0f, wt = 0.0f;
    if (s_node >= 0) {
      const long long node = (g * a.N + s_node) * H + h;
      ee = tc_edge_exp(a, g, h, e);
      if (PASS == 1)
        wt = round_to<T>(ee * round_to<T>(a.scale[node]));
      else
        wt = round_to<T>(score_cotangent(
            a.dalpha_in[(g * H + h) * E + e], round_to<T>(a.scale[node]),
            round_to<T>(a.d_denom[node]), ee));
    }
    t.wt[el][h] = wt;
    if (PASS == 1) t.e[el][h] = ee;
  }
}

// Step d of a unit, the row-wise epilogue on the f32 projection rows
// (pitch LD32 floats), TC_GROUP rows at a time, the next group's node rows
// in flight: the cotangent with the C1 rounding points, the node scatters,
// the bias gradient kept in `dbsum`, pass 1's per-head sums, d_alpha and
// dscale, and the cotangent's one trip to device memory. A group's bf16
// cotangent rows go over its f32 rows (pitch 2 LD32 elements) once every
// lane has read its floats of them (zeros in the depth padding and in dead
// rows), for product 2. In f32 (T = float) the cotangent rows take the
// whole f32 rows (pitch LD32 floats), in place the same way.
template <typename T, int PASS, int LD32>
__device__ __forceinline__ void tc_bwd_epilogue(
    const TcArgs<T>& a, const TcBwdTables& t, float* s_rows, long long g,
    int e0, int lane, const int (&head)[8], const float (&bias)[8],
    float (&dbsum)[8]) {
  const int E = a.E, N = a.N, HD = a.HD, H = a.H;
  const int c0 = 8 * lane, HDp = round_up16(HD);
  const bool active = c0 < HD;
  T* s_cot = reinterpret_cast<T*>(s_rows);
  constexpr int ldc = LD32 * 4 / (int)sizeof(T);   // its pitch in T
  Vec8<T> cur_s[TC_GROUP], cur_d[TC_GROUP], next_s[TC_GROUP],
      next_d[TC_GROUP];
  auto gather = [&](int r0, Vec8<T> (&to_s)[TC_GROUP],
                    Vec8<T> (&to_d)[TC_GROUP]) {
#pragma unroll
    for (int i = 0; i < TC_GROUP; ++i) {
      if (active && t.src[r0 + i] >= 0) {
        to_s[i] = load8(a.rows_src + (g * N + t.src[r0 + i]) * HD + c0);
        to_d[i] = load8(a.rows_dst + (g * N + t.dst[r0 + i]) * HD + c0);
      } else {
        to_s[i] = to_d[i] = zero8<T>();
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
    Vec8<T> packed[TC_GROUP];
    float p[TC_GROUP][8];    // pass 1: msg * g[dst] (unused in pass 2)
#pragma unroll
    for (int i = 0; i < TC_GROUP; ++i) {
      const int r = r0 + i;
      const int s_node = t.src[r], d_node = t.dst[r];
      float cot[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) cot[j] = 0.0f;
      if (PASS == 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = 0.0f;
      }
      if (s_node >= 0 && active) {
        const long long s_row = (g * N + s_node) * HD + c0;
        const long long d_row = (g * N + d_node) * HD + c0;
        float vs[8], vd[8], proj[8];
        unpack8(cur_s[i], vs);
        unpack8(cur_d[i], vd);
        const float4 p0 =
            *reinterpret_cast<const float4*>(s_rows + r * LD32 + c0);
        const float4 p1 =
            *reinterpret_cast<const float4*>(s_rows + r * LD32 + c0 + 4);
        proj[0] = p0.x; proj[1] = p0.y; proj[2] = p0.z; proj[3] = p0.w;
        proj[4] = p1.x; proj[5] = p1.y; proj[6] = p1.z; proj[7] = p1.w;
        if (PASS == 1) {
          // vs = nm[src], vd = g[dst]
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            p[i][j] = (vs[j] + proj[j] + bias[j]) * vd[j];
            const float d = t.wt[r][head[j]] * vd[j];
            dbsum[j] += d;
            cot[j] = round_to<T>(d);
          }
          atomicAdd(reinterpret_cast<float4*>(a.acc_src + s_row),
                    make_float4(cot[0], cot[1], cot[2], cot[3]));
          atomicAdd(reinterpret_cast<float4*>(a.acc_src + s_row + 4),
                    make_float4(cot[4], cot[5], cot[6], cot[7]));
        } else {
          // vs = nq[src], vd = nk[dst]
          float dq[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float ds = t.wt[r][head[j]];
            const float d = ds * vs[j];
            dbsum[j] += d;
            cot[j] = round_to<T>(d);
            dq[j] = round_to<T>(ds * (vd[j] + proj[j] + bias[j]));
          }
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
      packed[i] = pack8<T>(cot);
      // the cotangent's one trip to device memory, for the dW launch
      if (active && e0 + r < E)
        store8(a.cot + (g * E + e0 + r) * a.ldc + c0, packed[i]);
    }
    if (PASS == 1) {
      if (H <= 4)
        tc_group_head_sums<4>(p, head, H, r0, lane, t.da);
      else
        tc_group_head_sums<8>(p, head, H, r0, lane, t.da);
    }
    __syncwarp();
    if (c0 < HDp) {
#pragma unroll
      for (int i = 0; i < TC_GROUP; ++i)
        store8(s_cot + (r0 + i) * ldc + c0, packed[i]);
    }
  }
  __syncwarp();
  if (PASS == 1) {
    for (int idx = lane; idx < TC_ROWS * H; idx += 32) {
      const int h = idx / TC_ROWS, el = idx % TC_ROWS, e = e0 + el;
      if (e >= E) continue;
      float v = t.da[h][el];
      if (a.part & PART_ADD) v += a.dalpha_out[(g * H + h) * E + e];
      a.dalpha_out[(g * H + h) * E + e] = v;
      if (t.src[el] >= 0 && !(a.part & PART_OPEN))
        atomicAdd(&a.dscale[(g * N + t.src[el]) * H + h],
                  round_to<T>(v * t.e[el][h]));
    }
  }
}

// T: bf16 (W resident or streamed) or float (streamed, split-TF32
// products; the head note's "float32")
template <int PASS, int PAIRS, bool STREAM, typename T>
__global__ void __launch_bounds__(
    32 * tc_bwd_max_warps(sizeof(T) == 4, STREAM, PAIRS), 1)
edge_pass_tc_kernel(const TcArgs<T> a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  typedef typename BwdShape<T, STREAM, PAIRS>::type S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int E = a.E, D = a.D, HD = a.HD, H = a.H;
  T* sW = reinterpret_cast<T*>(tc_smem);           // W, or the ring of chunks
  unsigned char* mine = tc_smem + S::w_bytes + warp * S::warp_bytes;
  T* s_emb = reinterpret_cast<T*>(mine);           // emb rows, or their ring
  float* s_rows = reinterpret_cast<float*>(mine);
  T* s_cot = reinterpret_cast<T*>(mine);
  constexpr int ldc = S::ld32 * 4 / (int)sizeof(T);
  const int Dp = round_up16(D), HDp = round_up16(HD);
  // product 2 is this launch's, or the pass leaves it to gat_demb.cu
  const bool demb_on = a.demb != nullptr;
  const TcBwdTables t(reinterpret_cast<float*>(mine + S::stage_bytes));

  // W rounded to bf16, zeros wherever either product reaches past D or HD;
  // streaming: zeros over the ring, whose columns past HD are never loaded
  if constexpr (STREAM)
    tc_zero_ring<S>(sW);
  else
    tc_load_w<S>(sW, a.w, D, HD);
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
  const long long wid = (long long)blockIdx.x * nwarps + warp;
  int next_src, next_dst;         // the nodes of the unit after this one
  tc_unit_nodes(a.mask, a.src, a.dst, E, wid, n_units, units_per_graph, lane,
                next_src, next_dst);
  if constexpr (STREAM) {
    // W's rows streamed (the head note, "Past D = 256"): unit u = wid + r *
    // (all warps) in round r; every warp runs every round, with or without
    // a unit
    static_assert(TC_STAGES == 2, "the reverse walk of product 2 reuses "
                  "the two chunks in the ring");
    const long long rounds = (n_units + stride - 1) / stride;
    const int n_chunks = (D + S::KC - 1) / S::KC;
#pragma unroll 1
    for (long long rd = 0; rd < rounds; ++rd) {
      const long long u = wid + rd * stride;
      const bool has_unit = u < n_units;          // uniform over the warp
      const long long g = u / units_per_graph;
      const int e0 = (int)(u % units_per_graph) * TC_ROWS;

      // a. (its emb rows arrive chunk by chunk in step b)
      if (has_unit)
        tc_bwd_unit_weights<T, PASS>(a, t, g, e0, u, stride, n_units,
                                     units_per_graph, lane, next_src,
                                     next_dst);

      // b. product 1, emb W over all of D: chunk k of W's rows and of the
      // unit's emb columns in stage k % 2. After the first round chunks 0
      // and 1 are still in the ring, where product 2 ended (with no product
      // 2, every chunk is loaded again).
      zero_acc(acc);
      const T* rows = a.emb + (g * E + e0) * D;
      auto load_chunk = [&](int k) {
        const int st = k % TC_STAGES;
        if (rd == 0 || k >= TC_STAGES || !demb_on)
          tc_load_w_chunk<S>(sW + st * S::w_chunk, a.ws, k * S::KC, D, HD);
        if (has_unit)
          tc_load_emb_chunk<S>(s_emb + st * S::emb_chunk, rows, k * S::KC,
                               D, t.src, lane);
      };
      load_chunk(0);
      cp_async_commit();
#pragma unroll 1
      for (int k = 0; k < n_chunks; ++k) {
        // chunk k landed for every thread, and every warp is done with
        // chunk k - 1, whose stage the load below refills
        cp_async_wait<0>();
        __syncthreads();
        if (k + 1 < n_chunks) load_chunk(k + 1);
        cp_async_commit();
        if (has_unit) {
          const int st = k % TC_STAGES;
          const int ksteps = min(S::KC, Dp - k * S::KC) / 16;
          warp_rows_product<true>(s_emb + st * S::emb_chunk, S::ldk,
                                  sW + st * S::w_chunk, S::ldw, ksteps, acc);
        }
      }

      if (has_unit) {
        // c. accumulators -> f32 rows over the emb ring; d. the epilogue
        __syncwarp();
        tc_stage_acc(acc, s_rows, S::ld32, lane);
        __syncwarp();
        tc_bwd_epilogue<T, PASS, S::ld32>(a, t, s_rows, g, e0, lane, head,
                                          bias, dbsum);
      }

      // e. product 2, cot W^T, W's chunks in reverse: chunk c's rows are
      // demb's columns c KC ..; the first two are the ones product 1 left
      // in the ring, and the walk ends on chunks 1 and 0, where the next
      // round's product 1 starts. `next_w(q)` comes before step q: chunk
      // n - 1 - q landed for every thread, and every warp is done with the
      // chunk before it, whose stage the chunk after it refills. With no
      // product 2 one barrier ends the round instead: every warp is done
      // with the ring before the next round's first chunk goes into it.
      if (!demb_on) {
        __syncthreads();
        continue;
      }
      auto next_w = [&](int q) {
        const int c = n_chunks - 1 - q;
        cp_async_wait<0>();
        __syncthreads();
        if (c > 0)
          tc_load_w_chunk<S>(sW + ((c - 1) % TC_STAGES) * S::w_chunk, a.ws,
                             (c - 1) * S::KC, D, HD);
        cp_async_commit();
      };
      if constexpr (sizeof(T) == 2) {
        // bf16: a chunk's f32 output goes to the stage beside the cotangent
        // tile (columns WIDTH .. of each row), then demb = output (+ add) 16
        // bytes a lane; the chunk's `add` values (demb itself in pass 2:
        // other columns than the stores before them) are loaded during the
        // chunk before
        static_assert(S::WIDTH * 2 + TC_KC * 4 <= S::ld32 * 4,
                      "product 2's f32 output rows fit beside the cotangent "
                      "tile");
        float* s_out = s_rows + S::WIDTH / 2;
        uint4 kept[TC_KC / 16], next_kept[TC_KC / 16];
        auto load_kept = [&](int c) {
#pragma unroll
          for (int i = 0; i < TC_KC / 16; ++i) {
            const int p = lane + 32 * i, r = p / 8;
            const int col = c * TC_KC + p % 8 * 8;
            next_kept[i] = make_uint4(0u, 0u, 0u, 0u);
            if (a.add != nullptr && col < D && e0 + r < E)
              next_kept[i] = *reinterpret_cast<const uint4*>(
                  a.add + (g * E + e0 + r) * D + col);
          }
        };
        if (has_unit) load_kept(n_chunks - 1);
#pragma unroll 1
        for (int q = 0; q < n_chunks; ++q) {
          const int c = n_chunks - 1 - q;
          if (q > 0) next_w(q);
          if (!has_unit) continue;                 // uniform over the warp
#pragma unroll
          for (int i = 0; i < TC_KC / 16; ++i) kept[i] = next_kept[i];
          if (c > 0) load_kept(c - 1);
          float out[TC_KC / 8][4];
          zero_acc(out);
          warp_rows_product<false>(s_cot, ldc,
                                   sW + (c % TC_STAGES) * S::w_chunk, S::ld16,
                                   HDp / 16, out);
          tc_stage_acc(out, s_out, S::ld32, lane);
          __syncwarp();
          // 16 rows of TC_KC columns: lane l on row l / 8 + 4 i, 8 columns
#pragma unroll
          for (int i = 0; i < TC_KC / 16; ++i) {
            const int p = lane + 32 * i, r = p / 8, cc = p % 8 * 8;
            if (c * TC_KC + cc >= D || e0 + r >= E) continue;
            const float4 p0 =
                *reinterpret_cast<const float4*>(s_out + r * S::ld32 + cc);
            const float4 p1 =
                *reinterpret_cast<const float4*>(s_out + r * S::ld32 + cc + 4);
            float v[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
            float k[8];
            unpack_bf16x8(kept[i], k);
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] += k[j];
            *reinterpret_cast<uint4*>(a.demb + (g * E + e0 + r) * D +
                                      c * TC_KC + cc) = pack_bf16x8(v);
          }
          __syncwarp();   // every lane has read the chunk's staged rows
        }
      } else {
        // f32: the cotangent fills its rows of the stage, so a chunk's
        // output goes from the accumulators to demb, a quad's 32 bytes a
        // row (lane l on rows l / 4 and l / 4 + 8, columns 2 (l % 4) and
        // the next of each 8), + add read at the same places before the
        // product: all of a lane's loads come before its stores
        constexpr int NO = S::KC / 8;
        const int rq = lane >> 2, cq = 2 * (lane & 3);
#pragma unroll 1
        for (int q = 0; q < n_chunks; ++q) {
          const int c = n_chunks - 1 - q;
          if (q > 0) next_w(q);
          if (!has_unit) continue;               // uniform over the warp
          float2 kept[NO][2];
#pragma unroll
          for (int j = 0; j < NO; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rq + 8 * h, col = c * S::KC + 8 * j + cq;
              kept[j][h] = make_float2(0.0f, 0.0f);
              if (a.add != nullptr && col < D && e0 + r < E)
                kept[j][h] = *reinterpret_cast<const float2*>(
                    a.add + (g * E + e0 + r) * D + col);
            }
          float out[NO][4];
          zero_acc(out);
          warp_rows_product<false>(s_cot, ldc,
                                   sW + (c % TC_STAGES) * S::w_chunk, S::ldw,
                                   HDp / 16, out);
#pragma unroll
          for (int j = 0; j < NO; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = rq + 8 * h, col = c * S::KC + 8 * j + cq;
              if (col < D && e0 + r < E)
                *reinterpret_cast<float2*>(a.demb + (g * E + e0 + r) * D +
                                           col) =
                    make_float2(out[j][2 * h] + kept[j][h].x,
                                out[j][2 * h + 1] + kept[j][h].y);
            }
        }
      }
      __syncwarp();     // the stage is free for the next unit's emb chunks
    }
  } else {
    // W resident: each warp on its own units, warp barriers only
    for (long long u = wid; u < n_units; u += stride) {
      const long long g = u / units_per_graph;
      const int e0 = (int)(u % units_per_graph) * TC_ROWS;

      // a. the unit's emb rows, a lane on one 16-byte chunk of every row;
      // zeros past E and in the depth padding; meanwhile its weights
      if (c0 < Dp) {
#pragma unroll 4
        for (int r = 0; r < TC_ROWS; ++r) {
          bf16* to = s_emb + r * S::ld16 + c0;
          if (e0 + r < E && c0 < D)
            cp_async16(to, a.emb + ((g * E + e0 + r) * D + c0));
          else
            *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      cp_async_commit();
      tc_bwd_unit_weights<T, PASS>(a, t, g, e0, u, stride, n_units,
                                   units_per_graph, lane, next_src,
                                   next_dst);
      cp_async_wait<0>();
      __syncwarp();

      // b. product 1: the projection emb W; c. accumulators -> f32 rows
      // over the consumed emb rows; d. the epilogue
      zero_acc(acc);
      warp_rows_product<true>(s_emb, S::ld16, sW, S::ld16, Dp / 16, acc);
      __syncwarp();
      tc_stage_acc(acc, s_rows, S::ld32, lane);
      __syncwarp();
      tc_bwd_epilogue<T, PASS, S::ld32>(a, t, s_rows, g, e0, lane, head,
                                        bias, dbsum);

      // e. product 2: cot W^T -> f32 rows over the consumed cotangent rows,
      // then demb = product (+ add) row by row, 16 bytes a lane. All of a
      // lane's loads of `add` come before its stores: `add` may be demb.
      if (!demb_on) {
        __syncwarp();   // the stage is free for the next unit's emb rows
        continue;
      }
      zero_acc(acc);
      warp_rows_product<false>(s_cot, ldc, sW, S::ld16, HDp / 16, acc);
      __syncwarp();
      tc_stage_acc(acc, s_rows, S::ld32, lane);
      __syncwarp();
      if (c0 < D) {
        T* out = a.demb + (g * E + e0) * D + c0;
        const T* add =
            a.add == nullptr ? nullptr : a.add + (g * E + e0) * D + c0;
        uint4 carried[TC_ROWS];
        if (add != nullptr) {
#pragma unroll
          for (int r = 0; r < TC_ROWS; ++r)
            if (e0 + r < E)
              carried[r] =
                  *reinterpret_cast<const uint4*>(add + (long long)r * D);
        }
#pragma unroll
        for (int r = 0; r < TC_ROWS; ++r) {
          if (e0 + r < E) {
            const float4 p0 =
                *reinterpret_cast<const float4*>(s_rows + r * S::ld32 + c0);
            const float4 p1 = *reinterpret_cast<const float4*>(
                s_rows + r * S::ld32 + c0 + 4);
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
  }

  // the block's partial bias gradient, through the warps' stages (no copy
  // is in flight: the last wait came before the last product)
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
constexpr int DWT_K32 = 32;        // in f32: the same bytes a slice
constexpr int DWT_STAGES = 4;      // slices in the ring
constexpr int DWT_MAX_NT = 16;     // 8-column tiles of a block

// slots of one staged slice of T, and slices in the ring
template <typename T>
__host__ __device__ constexpr int dwt_k() {
  return sizeof(T) == 2 ? DWT_K : DWT_K32;
}
template <typename T>
__host__ __device__ constexpr int dwt_stages() {
  return DWT_STAGES;
}

// n-tiles of one column block: the HD / 8 tiles spread evenly over the
// fewest blocks of at most DWT_MAX_NT
inline int dw_block_tiles(int HD) {
  const int nt = HD / 8, blocks = (nt + DWT_MAX_NT - 1) / DWT_MAX_NT;
  return (nt + blocks - 1) / blocks;
}

// the kernel is compiled for these counts of tile pairs per column block;
// f32 also for 5, so that a 136-column launch's blocks of 9 tiles run 10
// and not 14 (PERF.md PR 20)
inline int dw_pairs(int ntb, bool f32) {
  return ntb <= 4    ? 2
         : ntb <= 8  ? 4
         : f32 && ntb <= 10 ? 5
         : ntb <= 14 ? 7
                     : 8;
}

// part[s, d, c] = sum over the slots r of range s of emb[r, d] * cot[r, c]:
// emb (R, D), cot (R, HD, rows ldc apart) over all graphs' slots, a block
// on the DS rows d of slice blockIdx.z of W's rows. Warp w takes the 16-row
// tile w of the slice (WARPS = 8 for DS <= 128, else 16: sixteen warps on one tile each
// hide more latency than eight on two, 139 against 168 us at D = HD = 200)
// times all 2 NP column tiles of its block, of which the last ones may lie
// past the block's columns and are not stored. In f32 (T = float) the
// product is the split-TF32 one (mma_tile.cuh): emb^T's fragment read with
// 32-bit loads from the slice as it lies ([slot][d], pitch 8 or 24 floats
// modulo 32, so that rows t and columns g of a fragment fall into distinct
// banks), and cot's likewise.
template <int NP, int WARPS, typename T>
__global__ void __launch_bounds__(32 * WARPS, 1)
dw_tc_kernel(const T* __restrict__ emb, const T* __restrict__ cot,
             float* __restrict__ part, long long R, long long chunk, int D,
             int DS, int HD, int ldc, int ntb) {
  extern __shared__ __align__(16) unsigned char dw_smem[];
  constexpr int K = dwt_k<T>(), STAGES = dwt_stages<T>();
  constexpr int NT = 2 * NP, ldb = 16 * NP + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.z * DS;
  const int lda = tile_pitch(DS);
  const int a_bytes = K * lda * (int)sizeof(T);
  const int stage_bytes = a_bytes + K * ldb * (int)sizeof(T);
  const int col0 = blockIdx.x * ntb * 8;
  const int nt = min(ntb, (HD - col0) / 8);
  const long long r_begin = blockIdx.y * chunk;
  const long long r_end = r_begin + chunk < R ? r_begin + chunk : R;
  const int n_slices =
      r_begin < r_end ? (int)((r_end - r_begin + K - 1) / K) : 0;
  const bool has_tile = warp < (DS + 15) / 16;    // the warp's row tile of dW

  auto load_slice = [&](int slice) {
    unsigned char* stage = dw_smem + (slice % STAGES) * stage_bytes;
    T* sA = reinterpret_cast<T*>(stage);
    T* sB = reinterpret_cast<T*>(stage + a_bytes);
    const long long r0 = r_begin + (long long)slice * K;
    if constexpr (sizeof(T) == 2) {
      // a warp on every WARPS-th slot, a lane on one 16-byte chunk of its
      // row (DS / 8 <= 32 chunks of emb, nt <= 16 of cot)
#pragma unroll
      for (int r = warp; r < K; r += WARPS) {
        const bool in = r0 + r < r_end;
        if (8 * lane < DS) {
          T* to = sA + r * lda + 8 * lane;
          if (in)
            cp_async16(to, emb + (r0 + r) * D + d0 + 8 * lane);
          else
            *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
        }
        if (lane < nt) {
          T* to = sB + r * ldb + 8 * lane;
          if (in)
            cp_async16(to, cot + (r0 + r) * ldc + col0 + 8 * lane);
          else
            *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      // f32: DS / 4 <= 64 chunks of emb a row, 2 nt <= 32 of cot
#pragma unroll
      for (int r = warp; r < K; r += WARPS) {
        const bool in = r0 + r < r_end;
        for (int p = lane; 4 * p < DS; p += 32) {
          T* to = sA + r * lda + 4 * p;
          if (in)
            cp_async16(to, emb + (r0 + r) * D + d0 + 4 * p);
          else
            *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
        }
        if (lane < 2 * nt) {
          T* to = sB + r * ldb + 4 * lane;
          if (in)
            cp_async16(to, cot + (r0 + r) * ldc + col0 + 4 * lane);
          else
            *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };

  float acc[NT][4];
  zero_acc(acc);

  // one commit per slot of the ring, loaded or not, keeps the group count
  // the same for every thread
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices) load_slice(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();       // slice s has landed; slice s - 1 is consumed
    if (s + STAGES - 1 < n_slices) load_slice(s + STAGES - 1);
    cp_async_commit();
    const unsigned char* stage = dw_smem + (s % STAGES) * stage_bytes;
    const T* sA = reinterpret_cast<const T*>(stage);
    const T* sB = reinterpret_cast<const T*>(stage + a_bytes);
    if (!has_tile) continue;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int ks = 0; ks < K / 16; ++ks) {
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
    } else {
      // A = emb^T: a0..a3 at (row g, g + 8 of the warp's tile; depth t,
      // t + 4); B = cot: b0, b1 at (depth t, t + 4; column g)
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int k16 = 0; k16 < K / 16; ++k16) {
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float* pa =
              sA + ((2 * k16 + s) * 8 + t) * lda + warp * 16 + g;
          split_tf32(pa[0], a_hi[s][0], a_lo[s][0]);
          split_tf32(pa[8], a_hi[s][1], a_lo[s][1]);
          split_tf32(pa[4 * lda], a_hi[s][2], a_lo[s][2]);
          split_tf32(pa[4 * lda + 8], a_hi[s][3], a_lo[s][3]);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          float b[2][2][2];
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const float* pb = sB + ((2 * k16 + s) * 8 + t) * ldb + g;
            b[s][0][0] = pb[8 * j];
            b[s][0][1] = pb[4 * ldb + 8 * j];
            b[s][1][0] = pb[8 * j + 8];
            b[s][1][1] = pb[4 * ldb + 8 * j + 8];
          }
          mma_split_tf32(acc + j, a_hi, a_lo, b);
        }
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

template <int PASS, int PAIRS, bool STREAM, typename T>
cudaError_t launch_edge_tc(const TcArgs<T>& a, int warps, int n_blocks,
                           cudaStream_t s) {
  typedef typename BwdShape<T, STREAM, PAIRS>::type S;
  const size_t smem = (size_t)S::w_bytes + (size_t)warps * S::warp_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      edge_pass_tc_kernel<PASS, PAIRS, STREAM, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  edge_pass_tc_kernel<PASS, PAIRS, STREAM, T>
      <<<n_blocks, 32 * warps, smem, s>>>(a);
  return cudaSuccess;
}

// The f32 edge launch: the streaming kernel at the tile of HD's columns
// (tc_stream_pairs)
template <int PASS>
cudaError_t launch_edge_f32(const TcArgs<float>& a, int warps, int n_blocks,
                            cudaStream_t s) {
  switch (tc_stream_pairs(a.HD)) {
    case 4: return launch_edge_tc<PASS, 4, true>(a, warps, n_blocks, s);
    case 8: return launch_edge_tc<PASS, 8, true>(a, warps, n_blocks, s);
    case 9: return launch_edge_tc<PASS, 9, true>(a, warps, n_blocks, s);
    case 13: return launch_edge_tc<PASS, 13, true>(a, warps, n_blocks, s);
    default: return launch_edge_tc<PASS, 16, true>(a, warps, n_blocks, s);
  }
}

template <int NP, int WARPS, typename T>
cudaError_t launch_dw_tc(const TcArgs<T>& a, float* dw_part, int n_split,
                         int ntb, cudaStream_t s) {
  const size_t smem = (size_t)dwt_stages<T>() * dwt_k<T>() *
                      (tile_pitch(a.DS) + 16 * NP + 8) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      dw_tc_kernel<NP, WARPS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long R = (long long)a.G * a.E;
  long long chunk = (R + n_split - 1) / n_split;
  chunk = (chunk + dwt_k<T>() - 1) / dwt_k<T>() * dwt_k<T>();
  dw_tc_kernel<NP, WARPS, T>
      <<<dim3((a.HD / 8 + ntb - 1) / ntb, n_split, a.D / a.DS), 32 * WARPS,
         smem, s>>>(a.emb, a.cot, dw_part, R, chunk, a.D, a.DS, a.HD, a.ldc,
                    ntb);
  return cudaSuccess;
}

template <int NP, typename T>
cudaError_t launch_dw_rows(const TcArgs<T>& a, float* dw_part, int n_split,
                           int ntb, cudaStream_t s) {
  return a.DS > 128 ? launch_dw_tc<NP, 16>(a, dw_part, n_split, ntb, s)
                    : launch_dw_tc<NP, 8>(a, dw_part, n_split, ntb, s);
}

// The launches of a pass on the tensor-core route: the edge kernel once,
// W's rows streamed when the caller hands W to stream (a.ws: bf16 rounded,
// which the wrapper does past D = 256; f32 W itself, always in f32), else
// resident, which takes D <= 256 (one slice: DS = D); then dW over slices
// of DS of W's rows and the two reductions. `warps` and `n_blocks` are the
// caller's (the partial arrays are sized from them).
template <int PASS, typename T>
int launch_pass_tc(TcArgs<T> a, float* dw_part, float* dw, float* db,
                   int n_split, int warps, int n_blocks, cudaStream_t s) {
  constexpr bool f32 = sizeof(T) == 4;
  const bool stream = a.ws != nullptr;
  const int max_warps =
      tc_bwd_max_warps(f32, stream, tc_bwd_stream_pairs(a.HD));
  if (warps < 1 || warps > max_warps || n_blocks < 1 ||
      (stream ? !aligned16(a.ws) : f32 || a.DS != a.D))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if constexpr (f32) {
    err = launch_edge_f32<PASS>(a, warps, n_blocks, s);
  } else if (stream) {
    switch (tc_bwd_stream_pairs(a.HD)) {
      case 8:
        err = launch_edge_tc<PASS, 8, true>(a, warps, n_blocks, s);
        break;
      case 9:
        err = launch_edge_tc<PASS, 9, true>(a, warps, n_blocks, s);
        break;
      case 13:
        err = launch_edge_tc<PASS, 13, true>(a, warps, n_blocks, s);
        break;
      default:
        err = launch_edge_tc<PASS, 16, true>(a, warps, n_blocks, s);
        break;
    }
  } else {
    switch (tc_pairs(a.D, a.HD)) {
      case 4:
        err = launch_edge_tc<PASS, 4, false>(a, warps, n_blocks, s);
        break;
      case 8:
        err = launch_edge_tc<PASS, 8, false>(a, warps, n_blocks, s);
        break;
      case 13:
        err = launch_edge_tc<PASS, 13, false>(a, warps, n_blocks, s);
        break;
      default:
        err = launch_edge_tc<PASS, 16, false>(a, warps, n_blocks, s);
        break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const int D = a.D, HD = a.HD, ntb = dw_block_tiles(HD);
  switch (dw_pairs(ntb, f32)) {
    case 2: err = launch_dw_rows<2>(a, dw_part, n_split, ntb, s); break;
    case 4: err = launch_dw_rows<4>(a, dw_part, n_split, ntb, s); break;
    case 5:
      if constexpr (f32) err = launch_dw_rows<5>(a, dw_part, n_split, ntb, s);
      break;
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
