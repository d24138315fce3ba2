// Device code shared by the tensor-core routes of the projected GAT op: the
// forward passes A and C (gat_fwd_tc.cuh) and the backward passes 1 and 2
// (gat_bwd_tc.cuh), each in bfloat16 and float32. All of them run
// persistent blocks in which each warp works on units of TC_ROWS
// consecutive edge slots of one graph: the unit's emb rows -> its stage
// (cp.async), emb W on tensor cores (mma_tile.cuh), the f32 accumulators ->
// the stage as rows, and a row-wise epilogue in which a lane owns 8 adjacent
// columns. In bf16 W sits in shared memory, rounded to bf16 and zero-padded:
// whole (`TcShape`, loaded once), or, at D > 256, as a ring of chunks of its
// rows that the block's warps stream through in lockstep (`TcStreamShape`;
// the backward streams it twice a round, for emb W and for cot W^T). The
// f32 routes of both directions stream W's f32 rows through the same ring
// at every D (`TcStream32Shape`), for split-TF32 products.
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
  static constexpr int ldw = ld16;              // pitch of W's rows
  static constexpr int ld32 = WIDTH + 4;        // pitch of the f32 rows
  static constexpr int w_bytes = WIDTH * ld16 * 2;
  static constexpr int stage_bytes = TC_ROWS * ld32 * 4;
  static constexpr int warp_bytes = stage_bytes + SMALL_FLOATS * 4;
};

// The streaming variant (D > 256): W's rows, rounded to bf16 in
// device memory, pass through a ring of TC_STAGES chunks of TC_KC rows, and
// each warp's emb rows through a ring of chunks of TC_KC columns. Its tile's
// columns follow from HD alone (for a column slice of 136: 9 pairs, 144).
constexpr int TC_KC = 64;
constexpr int TC_STAGES = 2;

inline int tc_stream_pairs(int HD) {
  return HD <= 64 ? 4 : HD <= 128 ? 8 : HD <= 144 ? 9 : HD <= 208 ? 13 : 16;
}

// Warps a block of the streaming variant may run. Up to 144 columns its
// accumulators take at most 72 registers a lane, and the kernel fits in 168
// with no spill, so 12 warps fill the register file: 192 slots a round
// share each pass over W. Wider tiles need about 250 registers: 8 warps.
__host__ __device__ constexpr int tc_stream_warps(int pairs) {
  return pairs <= 9 ? 12 : TC_MAX_WARPS;
}

// Shared memory of the streaming variant: the ring of W chunks (TC_KC rows
// of pitch ld16), then per warp a stage and SMALL_FLOATS floats of small
// tables. The stage holds the warp's ring of emb chunks (16 rows of TC_KC,
// pitch ldk) during the product and the f32 projection rows (pitch ld32)
// over them after it.
template <int PAIRS, int SMALL_FLOATS>
struct TcStreamShape : TcShape<PAIRS, SMALL_FLOATS> {
  typedef TcShape<PAIRS, SMALL_FLOATS> Whole;
  static constexpr int KC = TC_KC;                     // W's rows a chunk
  static constexpr int ldk = TC_KC + 8;
  static constexpr int w_chunk = TC_KC * Whole::ld16;  // elements
  static constexpr int emb_chunk = TC_ROWS * ldk;      // elements
  static constexpr int w_bytes = TC_STAGES * w_chunk * 2;
  static constexpr int ring_bytes = TC_STAGES * emb_chunk * 2;
  static constexpr int stage_bytes = Whole::stage_bytes > ring_bytes
                                         ? Whole::stage_bytes
                                         : ring_bytes;
  static constexpr int warp_bytes = stage_bytes + SMALL_FLOATS * 4;
};

// The f32 streaming variant, the split-TF32 route of both directions at
// every D: the ring holds TC_STAGES chunks of TC_KC32 rows of W in f32
// (pitch ldw = WIDTH + 8 floats, 8 or 24 modulo 32, w32_col's layout), each
// warp's ring of emb chunks TC_KC32 f32 columns (pitch ldk, 4 modulo 32),
// and the stage then the f32 projection rows and, in the backward, in
// place, the f32 cotangent rows (pitch ld32 = WIDTH + 4). Half the bf16
// chunk's rows keep 8 warps beside the ring at 256 columns (the backward's
// 214,016 bytes of 232,448, the forward's 205,824). The tiles are the bf16
// forward streaming kernel's (tc_stream_pairs): the backward's product 2
// leaves from the accumulators, so no tile needs room beside the
// cotangent.
constexpr int TC_KC32 = 32;

template <int PAIRS, int SMALL_FLOATS>
struct TcStream32Shape {
  static constexpr int NT = 2 * PAIRS;
  static constexpr int WIDTH = 16 * PAIRS;
  static constexpr int KC = TC_KC32;
  static constexpr int ldw = WIDTH + 8;
  static constexpr int ld32 = WIDTH + 4;
  static constexpr int ldk = TC_KC32 + 4;
  static constexpr int w_chunk = TC_KC32 * ldw;        // floats
  static constexpr int emb_chunk = TC_ROWS * ldk;      // floats
  static constexpr int w_bytes = TC_STAGES * w_chunk * 4;
  static constexpr int ring_bytes = TC_STAGES * emb_chunk * 4;
  static constexpr int rows_bytes = TC_ROWS * ld32 * 4;
  static constexpr int stage_bytes =
      rows_bytes > ring_bytes ? rows_bytes : ring_bytes;
  static constexpr int warp_bytes = stage_bytes + SMALL_FLOATS * 4;
};

// zeros over the whole ring of W chunks: the columns past HD are never
// loaded. The whole block takes part; the caller synchronises.
template <typename S, typename T>
__device__ __forceinline__ void tc_zero_ring(T* ring) {
  for (int idx = threadIdx.x; idx < S::w_bytes / 16; idx += blockDim.x)
    reinterpret_cast<uint4*>(ring)[idx] = make_uint4(0u, 0u, 0u, 0u);
}

// Rows d0 .. d0 + TC_KC of W (D, HD) bf16 -> a chunk of the ring by
// cp.async, zeros in the rows past D. The whole block takes part.
template <typename S>
__device__ __forceinline__ void tc_load_w_chunk(bf16* to, const bf16* w16,
                                                int d0, int D, int HD) {
  const int per_row = HD >> 3;
  for (int p = threadIdx.x; p < TC_KC * per_row; p += blockDim.x) {
    const int i = p / per_row, c = (p - i * per_row) * 8;
    bf16* at = to + i * S::ld16 + c;
    if (d0 + i < D)
      cp_async16(at, w16 + ((long long)(d0 + i) * HD + c));
    else
      *reinterpret_cast<uint4*>(at) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Columns d0 .. d0 + TC_KC of the unit's 16 emb rows (`rows`: its first,
// pitch D) -> the warp's chunk by cp.async; zeros in masked rows (s_src < 0)
// and in the columns past D.
template <typename S>
__device__ __forceinline__ void tc_load_emb_chunk(bf16* to, const bf16* rows,
                                                  int d0, int D,
                                                  const int* s_src, int lane) {
  constexpr int per_row = TC_KC / 8;
#pragma unroll
  for (int p = lane; p < TC_ROWS * per_row; p += 32) {
    const int r = p / per_row, c = (p % per_row) * 8;
    bf16* at = to + r * S::ldk + c;
    if (s_src[r] >= 0 && d0 + c < D)
      cp_async16(at, rows + ((long long)r * D + d0 + c));
    else
      *reinterpret_cast<uint4*>(at) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Rows d0 .. d0 + S::KC of W (D, HD) f32 -> a chunk of the f32 ring by
// cp.async, in w32_col's layout (a 16-byte piece stays whole: the swizzle
// flips bit 2 of its first column), zeros in the rows past D. The whole
// block takes part.
template <typename S>
__device__ __forceinline__ void tc_load_w_chunk(float* to, const float* w,
                                                int d0, int D, int HD) {
  const int per_row = HD >> 2;
  for (int p = threadIdx.x; p < S::KC * per_row; p += blockDim.x) {
    const int i = p / per_row, c = (p - i * per_row) * 4;
    float* at = to + i * S::ldw + w32_col(i, c);
    if (d0 + i < D)
      cp_async16(at, w + ((long long)(d0 + i) * HD + c));
    else
      *reinterpret_cast<uint4*>(at) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Columns d0 .. d0 + S::KC of the unit's 16 f32 emb rows -> the warp's
// chunk, as the bf16 loader above.
template <typename S>
__device__ __forceinline__ void tc_load_emb_chunk(float* to,
                                                  const float* rows, int d0,
                                                  int D, const int* s_src,
                                                  int lane) {
  constexpr int per_row = S::KC / 4;
#pragma unroll
  for (int p = lane; p < TC_ROWS * per_row; p += 32) {
    const int r = p / per_row, c = (p % per_row) * 4;
    float* at = to + r * S::ldk + c;
    if (s_src[r] >= 0 && d0 + c < D)
      cp_async16(at, rows + ((long long)r * D + d0 + c));
    else
      *reinterpret_cast<uint4*>(at) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// 8 consecutive values of a row of T (bf16 or f32): one 16-byte word or two
template <typename T>
struct Vec8 {
  uint4 q[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Vec8<T> load8(const T* p) {
  Vec8<T> v;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    v.q[i] = reinterpret_cast<const uint4*>(p)[i];
  return v;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const Vec8<T>& v) {
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    reinterpret_cast<uint4*>(p)[i] = v.q[i];
}

template <typename T>
__device__ __forceinline__ Vec8<T> zero8() {
  Vec8<T> v;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    v.q[i] = make_uint4(0u, 0u, 0u, 0u);
  return v;
}

__device__ __forceinline__ void unpack8(const Vec8<bf16>& v, float* f) {
  unpack_bf16x8(v.q[0], f);
}

__device__ __forceinline__ void unpack8(const Vec8<float>& v, float* f) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(v.q[i].x);
    f[4 * i + 1] = __uint_as_float(v.q[i].y);
    f[4 * i + 2] = __uint_as_float(v.q[i].z);
    f[4 * i + 3] = __uint_as_float(v.q[i].w);
  }
}

// 8 f32 values as T (bf16: round to nearest even)
template <typename T>
__device__ __forceinline__ Vec8<T> pack8(const float* f);

template <>
__device__ __forceinline__ Vec8<bf16> pack8<bf16>(const float* f) {
  Vec8<bf16> v;
  v.q[0] = pack_bf16x8(f);
  return v;
}

template <>
__device__ __forceinline__ Vec8<float> pack8<float>(const float* f) {
  Vec8<float> v;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v.q[i] = make_uint4(__float_as_uint(f[4 * i]),
                        __float_as_uint(f[4 * i + 1]),
                        __float_as_uint(f[4 * i + 2]),
                        __float_as_uint(f[4 * i + 3]));
  return v;
}

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
