// Device code shared by the bfloat16 tensor-core routes of the projected GAT
// op: the forward passes A and C (gat_fwd_tc.cuh) and the backward passes 1
// and 2 (gat_bwd_tc.cuh). All of them run persistent blocks that load W once,
// rounded to bf16 and zero-padded, into shared memory; each warp then works
// alone on units of TC_ROWS consecutive edge slots of one graph: the unit's
// emb rows -> its stage (cp.async), emb W on tensor cores (mma_tile.cuh), the
// f32 accumulators -> the stage as rows, and a row-wise epilogue in which a
// lane owns 8 adjacent columns.
#pragma once
#include "gat_common.cuh"
#include "mma_tile.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TC_ROWS = 16;              // edges of a warp's unit
constexpr int TC_MAX_WARPS = 8;
constexpr int TC_GROUP = 4;              // rows the epilogue takes at a time
constexpr unsigned FULL = 0xffffffffu;

// The edge kernels are compiled for a few widths: PAIRS pairs of 8-column
// tiles cover the wider of D and HD, and every product runs over all of them
// (for D = HD = 200: 13 pairs, 208 columns, one tile of zeros).
inline int tc_pairs(int D, int HD) {
  const int width = D > HD ? D : HD;
  return width <= 64 ? 4 : width <= 128 ? 8 : width <= 208 ? 13 : 16;
}

// Shared memory of an edge kernel: W, 16 PAIRS squared, then per warp a
// stage and SMALL_FLOATS floats of small per-(edge, head) tables. The stage
// holds the emb rows (bf16, pitch ld16) and then the f32 projection rows
// (pitch ld32 floats) over them.
template <int PAIRS, int SMALL_FLOATS>
struct TcShape {
  static constexpr int NT = 2 * PAIRS;          // 8-column tiles
  static constexpr int WIDTH = 16 * PAIRS;
  static constexpr int ld16 = WIDTH + 8;        // pitch of W and of emb rows
  static constexpr int ld32 = WIDTH + 4;        // pitch of the f32 rows
  static constexpr int w_bytes = WIDTH * ld16 * 2;
  static constexpr int stage_bytes = TC_ROWS * ld32 * 4;
  static constexpr int warp_bytes = stage_bytes + SMALL_FLOATS * 4;
};

// W (D, HD) f32 -> sW, rounded to bf16; zeros wherever a product reaches
// past D or HD. The whole block takes part; the caller synchronises.
template <typename S>
__device__ __forceinline__ void tc_load_w(bf16* sW, const float* w, int D,
                                          int HD) {
  constexpr int quads = S::ld16 / 4;
  for (int idx = threadIdx.x; idx < S::WIDTH * quads; idx += blockDim.x) {
    const int d = idx / quads, c = (idx % quads) * 4;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (d < D && c < HD)
      q = *reinterpret_cast<const float4*>(w + (long long)d * HD + c);
    __nv_bfloat162 lo = __floats2bfloat162_rn(q.x, q.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(q.z, q.w);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(sW + d * S::ld16 + c) = v;
  }
}

// The unit's source and destination nodes, one edge per lane < TC_ROWS;
// -1 where the slot is masked or past E (or the unit at or past `n_units`).
__device__ __forceinline__ void tc_unit_nodes(const uint8_t* mask,
                                              const int32_t* src,
                                              const int32_t* dst, int E,
                                              long long u, long long n_units,
                                              int units_per_graph, int lane,
                                              int& s_node, int& d_node) {
  s_node = d_node = -1;
  if (lane < TC_ROWS && u < n_units) {
    const long long g = u / units_per_graph;
    const int e = (int)(u % units_per_graph) * TC_ROWS + lane;
    if (e < E) {
      // three independent loads, then the choice
      const bool live = mask[g * E + e];
      const int s = src[g * E + e], d = dst[g * E + e];
      s_node = live ? s : -1;
      d_node = live ? d : -1;
    }
  }
}

// the warp's accumulators -> f32 rows at `rows` (pitch ld floats)
template <int NT>
__device__ __forceinline__ void tc_stage_acc(const float (&acc)[NT][4],
                                             float* rows, int ld, int lane) {
  float* p = rows + (lane >> 2) * ld + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(p + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(p + 8 * j + 8 * ld) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

// Sums over the warp of V values at once (V a power of two up to 32): each
// step hands one half of a lane's values to the lane `off` away and adds
// what comes back to the other half, so V - 1 shuffles (+ log2(32 / V)) do
// what 5 V would. Lane l ends with the total of value l / (32 / V) in v[0].
template <int V>
__device__ __forceinline__ void warp_sums(float (&v)[V], int lane) {
  int off = 16;
#pragma unroll
  for (int n = V; n > 1; n >>= 1, off >>= 1) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
#pragma unroll
  for (int o = (32 / V) >> 1; o > 0; o >>= 1)
    v[0] += __shfl_xor_sync(FULL, v[0], o);
}

// The per-head sums of a group of rows: p[i][j] is row i's product at the
// lane's column j, of head head[j]. Files the total of (row r0 + i, head h)
// at out[h][r0 + i]. HP: the heads rounded up to 4 or 8.
template <int HP>
__device__ __forceinline__ void tc_group_head_sums(
    const float (&p)[TC_GROUP][8], const int (&head)[8], int H, int r0,
    int lane, float (*out)[TC_ROWS]) {
  float v[TC_GROUP * HP];
#pragma unroll
  for (int i = 0; i < TC_GROUP; ++i)
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) t += head[j] == h ? p[i][j] : 0.0f;
      v[i * HP + h] = t;
    }
  warp_sums(v, lane);
  constexpr int share = 32 / (TC_GROUP * HP);     // lanes holding one value
  const int value = lane / share, h = value % HP;
  if (lane % share == 0 && h < H) out[h][r0 + value / HP] = v[0];
}

}  // namespace
