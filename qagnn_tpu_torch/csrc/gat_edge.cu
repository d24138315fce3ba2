// Rows 8 and 9's edge launch on Hopper, bf16: route 2 of `gat_bwd_pass1` /
// `gat_bwd_pass2` (ops/gat_kernels.py `_bwd_pass1`, `_bwd_pass2`), the
// launch that route 1 runs as `edge_pass_tc_kernel` on `mma.sync`
// (gat_bwd_tc.cuh; gat_bwd.cu's head note says what the passes compute).
//
// Replaces the per-edge part of the TPU kernels `_bwd1_proj_kernel`
// (qagnn_tpu/ops/pallas_gat.py:765, called by `_proj_bwd_pass1` :1095: d_msg
// -> demb (+ carry), db_me, d_alpha, dnm and dscale) and `_bwd2_proj_kernel`
// (:849, via `_proj_bwd_pass2` :1156: d_s -> dekb, demb += dekb W_ke^T,
// db_ke, dnq, dnk); their dW products are gat_dw.cu's launch, and the demb
// product of a pass of several launches gat_demb.cu's. Per slot of a graph:
// product 1, proj = emb W (+ bias); the epilogue: the cotangent (pass 1
// d_msg = alpha g[dst], pass 2 dekb = d_s nq[src]) rounded to bf16, its row
// written once for the dW launch, the node scatters (pass 1 dnm[src], pass
// 2 dnq[src] with d_s (nk[dst] + proj) rounded, dnk[dst]), the bias
// gradient of the f32 values, pass 1's per-head d_alpha = <msg, g[dst]>
// and dscale[src] += d_alpha e rounded; product 2, demb = cot W^T (+ carry,
// or + pass 1's demb in place), summed in f32 and rounded once. Masked
// slots get zero cotangent rows, so demb there is the carry (or 0). The
// rounding points are the mma.sync kernel's.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; G = 64, N = 200,
// E = 4096, D = HD = 200, a quarter of the slots masked): the bytes, about
// 98-104 us a pass (emb and the carry or demb read once, demb written once,
// the cotangent rows, scores, nodes), against 42 us for its two products at
// the bf16 tensor-core peak; beside them the L2 traffic of the node rows'
// gathers and 16-byte scatters (the unprojected op's backward kernels take
// 0.18-0.26 ms for that traffic alone). Past D = 256 (a pass of several
// column launches, no product 2) W's rows stream from L2 for every pair of
// tiles: at gnn_dim 1040 (136 columns) 0.28 MB of W and 0.27 MB of emb a
// 128-slot pair.
//
// The design (Hopper's own path, the helpers in tma_wgmma.cuh):
// - Persistent blocks, one an SM, walk pairs of tiles: 128 consecutive
//   slots of one graph, 64 for each of two consumer warpgroups. emb comes
//   by TMA through a 3-D tensor map over (G, E, D), so a tile that runs
//   past E is zero-filled and never reads the next graph's slots.
// - Warpgroup 2 produces: one thread keeps the TMA loads in flight through
//   a ring of `stages` slots with full / empty mbarriers; its other three
//   warps fill a ring of one or two per-pair tables (each slot's nodes, -1
//   where masked or past E, and the per-(slot, head) weight of the
//   cotangent, pass 1's alpha = e scale[src], pass 2's d_s, with pass 1's
//   e), so the consumers never wait on those gathers.
// - W, rounded to bf16 by the wrapper (`_streamed_w`), in 64-column boxes of
//   its rows in the 128-byte swizzle. At D <= 256 it is loaded once a block
//   and serves both products: product 1 reads it MN-major (W's rows are the
//   depth, wgmma's transpose bit), product 2 K-major as W^T (HD is the
//   depth), with no transposed copy. Past D = 256 (no product 2) a ring slot
//   holds 64 of W's rows beside both tiles' 64 columns of emb, so the two
//   consumers share each pass over W.
// - Product 1 on wgmma into f32 accumulators, one 64-column block of HD at
//   a time (each block's product reads the slot of emb again, the slot free
//   after the last), so that one block's accumulators are live beside the
//   cotangent's registers. The epilogue stages 32 columns of a warp's 16
//   rows at a time in shared memory (float2 stores from the accumulators)
//   and runs row-wise as the mma.sync kernel's does, a lane on 8 columns of
//   two rows: 16-byte gathers of the node rows, 16-byte atomicAdd
//   scatters, the cotangent's row written 16 bytes a lane, pass 1's head
//   sums of a lane's columns over the row's four lanes by halving
//   shuffles, the bias gradient over the warp's rows likewise. The bf16 cotangent goes back over the staged
//   rows and by ldmatrix into registers: wgmma's A operand of product 2,
//   which reads only W from shared memory. Product 2 makes 64 columns of
//   demb at a time, staged the same way and written 16 bytes a lane with
//   the add (read during the product) summed in f32 and rounded once.
// - Registers bound the design: a consumer holds product 1's accumulators
//   and the cotangent's (16 NB a thread); every buffer of loads held ahead
//   beyond these spilled (PERF.md §6). Product 2 is a template parameter
//   (DEMB), so a launch without it holds no cotangent registers.
// - Where it runs: the launches of a pass of several (no product 2) by
//   default; a pass of one launch (product 2) ran 3-10% slower than the
//   mma.sync kernel on the card, so only a named route 2 launches it
//   (`_edge_route`).
// - No fallback: a map that fails to encode or a refused launch returns
//   its error, and the wrapper raises. At D > 256 with a product 2 (one
//   launch of a pass past D = 256) the host refuses: route 1 takes it.
#include <cuda_bf16.h>

#include "gat_common.cuh"
#include "reduce_partials.cuh"
#include "tma_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int EDGE_SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr int EDGE_ALIGN = 1024;         // the 128-byte swizzle's period
constexpr int EDGE_THREADS = 384;        // consumers 0 and 1, producer 2
constexpr int EDGE_ROWS = 64;            // slots of a consumer's tile
constexpr int EDGE_PAIR = 2 * EDGE_ROWS; // slots of a block's unit of work
constexpr int EDGE_BOX = 64;             // bf16 columns of a box: 128 bytes
constexpr int EDGE_BOX_BYTES = EDGE_ROWS * 128;  // a box of 64 rows
constexpr int EDGE_MAX_D = 256;          // W resident up to this D
constexpr int EDGE_MAX_COLS = 256;       // HD of a launch
constexpr int EDGE_MAX_STAGES = 4;
constexpr int EDGE_MAX_TABLES = 2;       // per-pair tables in flight
constexpr int EDGE_TAB_LD = MAX_H + 1;   // a slot's per-head row, padded
constexpr int EDGE_TABLE_WARPS = 3;
constexpr unsigned EDGE_FULL = 0xffffffffu;
// A consumer warp's staging: 16 rows of 32 f32 columns, EDGE_LDS floats
// apart (float2 stores from the accumulators and 16-byte row reads; the
// bf16 cotangent goes over the first half of each row, 2 EDGE_LDS elements
// apart, for ldmatrix)
constexpr int EDGE_LDS = 40;
constexpr int EDGE_WARP_STAGE = 16 * EDGE_LDS * 4;

// a pair's slots: nodes, and per (slot, head) the cotangent's weight (pass
// 1 alpha, pass 2 d_s) and pass 1's e
struct EdgeTable {
  int src[EDGE_PAIR];
  int dst[EDGE_PAIR];
  float wt[EDGE_PAIR * EDGE_TAB_LD];
  float e[EDGE_PAIR * EDGE_TAB_LD];
};

__host__ __device__ constexpr int edge_nb(int HD) { return (HD + 63) / 64; }

__host__ __device__ constexpr int edge_dp(int D) { return (D + 15) / 16 * 16; }

// W resident: its 64-column blocks of all D rows (rounded up to 16)
__host__ __device__ constexpr int edge_w_bytes(int D, int HD, bool stream) {
  return stream ? 0 : edge_nb(HD) * edge_dp(D) * 128;
}

// a ring slot: both tiles' emb (all of D, or 64 columns and 64 rows of W
// beside them when streaming)
__host__ __device__ constexpr int edge_stage_bytes(int D, int HD,
                                                   bool stream) {
  return stream ? (2 + edge_nb(HD)) * EDGE_BOX_BYTES
                : 2 * ((D + 63) / 64) * EDGE_BOX_BYTES;
}

// W, the ring, the tables, the consumer warps' staging (EDGE_WARP_STAGE
// bytes each), each column's bias and head, the barriers (full and empty a
// slot and a table, W's), and the slack that aligns W and the ring to the
// swizzle's period
__host__ __device__ constexpr int edge_smem_bytes(int D, int HD, bool stream,
                                                  int stages, int tables) {
  return EDGE_ALIGN + edge_w_bytes(D, HD, stream) +
         stages * edge_stage_bytes(D, HD, stream) +
         tables * (int)sizeof(EdgeTable) + 8 * EDGE_WARP_STAGE +
         EDGE_MAX_COLS * 5 + (2 * stages + 2 * tables + 1) * 8;
}

struct EdgeArgs {
  // pass 1: rows_src = nm, rows_dst = gout; pass 2: nq, nk
  const bf16* rows_src;
  const bf16* rows_dst;
  const bf16* add;             // carry (may be null) or demb itself
  const float* bias;
  const float* scores;
  const float* gmax;
  const float* scale;
  const float* dalpha_in;      // pass 2
  const float* d_denom;        // pass 2
  const int32_t* src;
  const int32_t* dst;
  const uint8_t* mask;
  bf16* cot;                   // (G, E, HD) rows ldc apart, for dW (and demb)
  bf16* demb;                  // null: no product 2 (gat_demb.cu's)
  float* dalpha_out;           // pass 1
  float* acc_src;              // pass 1: dnm; pass 2: dnq
  float* acc_dst;              // pass 2: dnk
  float* dscale;               // pass 1
  float* db_part;              // (gridDim.x, HD)
  int N, E, D, HD, H, part, ldc, stages, tables, n_pairs, pairs_per_graph;
};

// wgmma.mma_async, bf16, f32 accumulators. `ss`: product 1, d (64 x 64 NB)
// += A (64 x 16, K-major descriptor) B (16 x 64 NB, MN-major descriptor,
// the transpose bit); `rs`: product 2, d (64 x 64) += A (registers, mma.sync
// m16n8k16's fragment a warp) B (K-major descriptor). scale 0 starts the
// sum afresh. The operand lists are written out for each width.
#define EDGE_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define EDGE_D32(i)                                                      \
  EDGE_D4(i), EDGE_D4(i + 4), EDGE_D4(i + 8), EDGE_D4(i + 12),           \
      EDGE_D4(i + 16), EDGE_D4(i + 20), EDGE_D4(i + 24), EDGE_D4(i + 28)

#define EDGE_REGS_32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define EDGE_REGS_64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define EDGE_REGS_96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define EDGE_REGS_128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"

template <int NB>
struct EdgeMma;

template <>
struct EdgeMma<1> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        EDGE_REGS_32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
        : EDGE_D32(0)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        EDGE_REGS_32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : EDGE_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct EdgeMma<2> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        EDGE_REGS_64 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
        : EDGE_D32(0), EDGE_D32(32)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct EdgeMma<3> {
  static __device__ __forceinline__ void ss(float (&d)[96], uint64_t a,
                                            uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        EDGE_REGS_96 ", %96, %97, p, 1, 1, 0, 1;\n}\n"
        : EDGE_D32(0), EDGE_D32(32), EDGE_D32(64)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <>
struct EdgeMma<4> {
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t a,
                                            uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        EDGE_REGS_128 ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : EDGE_D32(0), EDGE_D32(32), EDGE_D32(64), EDGE_D32(96)
        : "l"(a), "l"(b), "r"(scale));
  }
};
#undef EDGE_D32
#undef EDGE_D4

// Sums of V values over the lanes `FIRST`, FIRST / 2, .., LAST apart (a
// power-of-two span), halving them at each step: a lane hands one half of
// its values to the lane `off` away and adds what comes back to the other
// half. Lane l ends with the totals of values o(l) .. o(l) + V / n - 1 in
// v[0 ..], where n is the number of lanes summed and o(l) the sum over the
// steps of V / 2^(step + 1) where l has the step's bit.
template <int N, int OFF, int LAST, int V>
__device__ __forceinline__ void halve_sums_from(float (&v)[V], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(EDGE_FULL, send, OFF);
  }
  if constexpr (OFF > LAST) halve_sums_from<N / 2, OFF / 2, LAST>(v, lane);
}

template <int V, int FIRST, int LAST>
__device__ __forceinline__ void halve_sums(float (&v)[V], int lane) {
  static_assert(V % (2 * FIRST / LAST) == 0, "values that halve evenly");
  halve_sums_from<V, FIRST, LAST>(v, lane);
}

// a and b rounded to bf16 (to nearest even), a in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(b), "f"(a));
  return v;
}

// the two bf16 values of a packed word, as f32 (exact)
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& q,
                                              float (&f)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = unpack_bf16x2(w[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack_bf16x8(const float (&f)[8]) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}

// 8 consecutive f32 of shared memory (16-byte aligned)
__device__ __forceinline__ void load_f32x8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// four 8 x 8 bf16 matrices of a warp's shared rows: mma.sync m16n8k16's A
// fragment of a 16 x 16 tile, wgmma's A from registers
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Columns 32 h .. 32 h + 31 of a 64-column block of wgmma accumulators
// (its 32 registers from acc[base]: rows g and g + 8 of the warp's 16,
// columns 8 j + 2 t and the next) -> the warp's staging as f32 rows
template <int R>
__device__ __forceinline__ void stage_half(const float (&acc)[R], int base,
                                           int h, float* stg, int g, int t) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int k = base + 4 * (4 * h + jj);
    *reinterpret_cast<float2*>(stg + g * EDGE_LDS + 8 * jj + 2 * t) =
        make_float2(acc[k], acc[k + 1]);
    *reinterpret_cast<float2*>(stg + (g + 8) * EDGE_LDS + 8 * jj + 2 * t) =
        make_float2(acc[k + 2], acc[k + 3]);
  }
}

// What a consumer warp knows of its pair: the tables, the graph and its
// first node row, the pair's first slot, the pair row of the warp's row 0
struct EdgePair {
  const EdgeTable* T;
  long long g, gN;
  int e0, w0;
};

// The row-wise epilogue on 32 of product 1's columns (col0 ..) of the
// warp's 16 rows, staged as f32: lane l takes rows l / 4 and l / 4 + 8,
// columns col0 + 8 (l % 4) .. + 7, as the mma.sync kernel's epilogue does
// (tc_bwd_epilogue), with 16-byte gathers of the node rows, the cotangent
// with the same rounding points, its row written once (16 bytes) for the
// dW launch, the 16-byte atomicAdd scatters, pass 1's head sums into hs
// (hs[k]: the lane's row k), and with DEMB the bf16 cotangent written back
// over the staged rows for product 2. Returns the bias gradient of column
// col0 + 8 (l % 4) + l / 4 over the warp's 16 rows (the f32 values).
template <int PASS, int HP, bool DEMB>
__device__ __forceinline__ float edge_rows(const EdgeArgs& a,
                                           const EdgePair& P, int col0,
                                           float* stg, const float* s_bias,
                                           const uint8_t* s_head,
                                           float (&hs)[2][HP], int lane) {
  const int HD = a.HD, E = a.E;
  const int q = lane >> 2, cc = 8 * (lane & 3), c = col0 + cc;
  const bool active = c < HD;
  float bias[8];
  load_f32x8(s_bias + c, bias);
  const int hA = s_head[c], hB = s_head[c + 7];
  float db8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) db8[j] = 0.0f;
  uint4 packed[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int rr = q + 8 * k, pr = P.w0 + rr, e = P.e0 + pr;
    const int sn = P.T->src[pr], dn = P.T->dst[pr];
    float proj[8], cot[8];
    load_f32x8(stg + rr * EDGE_LDS + cc, proj);
#pragma unroll
    for (int j = 0; j < 8; ++j) cot[j] = 0.0f;
    if (active && sn >= 0) {
      const long long s_row = (P.gN + sn) * HD + c, d_row = (P.gN + dn) * HD + c;
      float vs[8], vd[8], w[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(a.rows_src + s_row), vs);
      unpack_bf16x8(*reinterpret_cast<const uint4*>(a.rows_dst + d_row), vd);
      const float* wr = P.T->wt + pr * EDGE_TAB_LD;
      if (hA == hB) {
        const float x = wr[hA];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = x;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = wr[s_head[c + j]];
      }
      if (PASS == 1) {
        // vs = nm[src], vd = g[dst]
        float pv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          pv[j] = (vs[j] + proj[j] + bias[j]) * vd[j];
          const float d = w[j] * vd[j];
          db8[j] += d;
          cot[j] = round_to<bf16>(d);
        }
        if (hA == hB) {
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j) sum += pv[j];
#pragma unroll
          for (int h = 0; h < HP; ++h) hs[k][h] += hA == h ? sum : 0.0f;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int hj = s_head[c + j];
#pragma unroll
            for (int h = 0; h < HP; ++h) hs[k][h] += hj == h ? pv[j] : 0.0f;
          }
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
          const float d = w[j] * vs[j];
          db8[j] += d;
          cot[j] = round_to<bf16>(d);
          dq[j] = round_to<bf16>(w[j] * (vd[j] + proj[j] + bias[j]));
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
    packed[k] = pack_bf16x8(cot);
    // the cotangent's one trip to device memory, for the dW launch
    if (active && e < E)
      *reinterpret_cast<uint4*>(a.cot + (P.g * E + e) * a.ldc + c) =
          packed[k];
  }
  if constexpr (DEMB) {
    // every lane has read its f32 rows: the bf16 cotangent over them
    __syncwarp();
    bf16* sb = reinterpret_cast<bf16*>(stg);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      *reinterpret_cast<uint4*>(sb + (q + 8 * k) * 2 * EDGE_LDS + cc) =
          packed[k];
    __syncwarp();
  }
  halve_sums<8, 16, 4>(db8, lane);
  return db8[0];
}

// demb's columns col0 .. col0 + 31 of the warp's 16 rows from their
// staged f32 sums (lanes as in edge_rows) + the add values kept[k], rounded
// once, 16 bytes a row and lane
__device__ __forceinline__ void edge_demb_rows(const EdgeArgs& a,
                                               const EdgePair& P, int col0,
                                               const float* stg,
                                               const uint4 (&kept)[2],
                                               int lane) {
  const int q = lane >> 2, cc = 8 * (lane & 3), col = col0 + cc;
  if (col >= a.D) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = P.e0 + P.w0 + q + 8 * k;
    if (e >= a.E) continue;
    float v[8], add[8];
    load_f32x8(stg + (q + 8 * k) * EDGE_LDS + cc, v);
    unpack_bf16x8(kept[k], add);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += add[j];
    *reinterpret_cast<uint4*>(a.demb + (P.g * a.E + e) * a.D + col) =
        pack_bf16x8(v);
  }
}

// PASS 1 or 2; NB 64-column blocks of HD; STREAM: W's rows through the
// ring (D > 256, no product 2); DEMB: product 2 (W resident), so that a
// launch without it holds no cotangent registers; HP: the heads rounded up
// to 4 or 8 (pass 1's head sums). Maps: emb (G, E, D) in boxes of 64 x 64
// x 1, W (D, HD) bf16 in boxes of 64 columns x all Dp rows (resident) or
// 64 rows.
template <int PASS, int NB, bool STREAM, bool DEMB, int HP>
__global__ void __launch_bounds__(EDGE_THREADS, 1)
edge_wgmma_kernel(const __grid_constant__ CUtensorMap emb_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const EdgeArgs a) {
  static_assert(!(STREAM && DEMB), "product 2 needs W resident");
  constexpr int NK = 4 * NB;             // product 2's k-steps of 16
  const int D = a.D, HD = a.HD, H = a.H, E = a.E, N = a.N;
  const int Dp = edge_dp(D), KB = (D + 63) / 64;
  const int stage_bytes = edge_stage_bytes(D, HD, STREAM);
  const int stages = a.stages, ntab = a.tables, ppg = a.pairs_per_graph;
  extern __shared__ unsigned char edge_raw[];
  unsigned char* sw =
      edge_raw + (EDGE_ALIGN - smem_addr(edge_raw) % EDGE_ALIGN) % EDGE_ALIGN;
  unsigned char* ring = sw + edge_w_bytes(D, HD, STREAM);
  EdgeTable* tabs =
      reinterpret_cast<EdgeTable*>(ring + stages * stage_bytes);
  float* staging = reinterpret_cast<float*>(tabs + ntab);
  float* s_bias = staging + 8 * EDGE_WARP_STAGE / 4;
  uint8_t* s_head = reinterpret_cast<uint8_t*>(s_bias + EDGE_MAX_COLS);
  uint64_t* full = reinterpret_cast<uint64_t*>(s_head + EDGE_MAX_COLS);
  uint64_t* empty = full + stages;
  uint64_t* tfull = empty + stages;
  uint64_t* tempty = tfull + ntab;
  uint64_t* wbar = tempty + ntab;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);           // each consumer warp
    }
    for (int s = 0; s < ntab; ++s) {
      mbar_init(tfull + s, EDGE_TABLE_WARPS);
      mbar_init(tempty + s, 8);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < EDGE_MAX_COLS; c += EDGE_THREADS) {
    s_bias[c] = c < HD ? a.bias[c] : 0.0f;
    s_head[c] = (uint8_t)(c < HD ? c / (HD / H) : MAX_H);
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tw == 0) {
      // the loads: W once (resident), then every pair's emb (and W's rows)
      if constexpr (!STREAM) {
        mbar_expect_tx(wbar, NB * Dp * 128);
        for (int j = 0; j < NB; ++j)
          tma_load(sw + j * Dp * 128, &w_map, j * EDGE_BOX, 0, wbar);
      }
      int s = 0;
      uint32_t lap = 0;
      for (int p = blockIdx.x; p < a.n_pairs; p += gridDim.x) {
        const int g = p / ppg, e0 = p % ppg * EDGE_PAIR;
        for (int c = 0; c < (STREAM ? KB : 1); ++c) {
          mbar_wait(empty + s, lap ^ 1);
          unsigned char* st = ring + s * stage_bytes;
          mbar_expect_tx(full + s, stage_bytes);
          if constexpr (STREAM) {
            for (int w = 0; w < 2; ++w)
              tma_load_3d(st + w * EDGE_BOX_BYTES, &emb_map, c * EDGE_BOX,
                          e0 + w * EDGE_ROWS, g, full + s);
            for (int j = 0; j < NB; ++j)
              tma_load(st + (2 + j) * EDGE_BOX_BYTES, &w_map, j * EDGE_BOX,
                       c * EDGE_BOX, full + s);
          } else {
            for (int w = 0; w < 2; ++w)
              for (int b = 0; b < KB; ++b)
                tma_load_3d(st + (w * KB + b) * EDGE_BOX_BYTES, &emb_map,
                            b * EDGE_BOX, e0 + w * EDGE_ROWS, g, full + s);
          }
          if (++s == stages) {
            s = 0;
            lap ^= 1;
          }
        }
      }
    } else if (tw >= 32) {
      // the tables: a pair's nodes, then its per-(slot, head) weights
      const int tt = tw - 32, nt = 32 * EDGE_TABLE_WARPS;
      int q = 0;
      for (int p = blockIdx.x; p < a.n_pairs; p += gridDim.x, ++q) {
        const int slot = q % ntab;
        mbar_wait(tempty + slot, ((q / ntab) & 1) ^ 1);
        EdgeTable& T = tabs[slot];
        const long long g = p / ppg;
        const int e0 = p % ppg * EDGE_PAIR;
        for (int r = tt; r < EDGE_PAIR; r += nt) {
          const int e = e0 + r;
          int s_node = -1, d_node = -1;
          if (e < E) {
            // three independent loads, then the choice
            const bool live = a.mask[g * E + e];
            const int s = a.src[g * E + e], d = a.dst[g * E + e];
            s_node = live ? s : -1;
            d_node = live ? d : -1;
          }
          T.src[r] = s_node;
          T.dst[r] = d_node;
        }
        asm volatile("bar.sync 4, 96;\n" ::: "memory");
        for (int idx = tt; idx < EDGE_PAIR * H; idx += nt) {
          const int h = idx / EDGE_PAIR, r = idx % EDGE_PAIR, e = e0 + r;
          const int s_node = T.src[r];
          float ee = 0.0f, wt = 0.0f;
          if (s_node >= 0) {
            const long long node = (g * N + s_node) * H + h;
            ee = expf(fminf(a.scores[(g * H + h) * E + e] - a.gmax[g * H + h],
                            0.0f));
            if (PASS == 1)
              wt = round_to<bf16>(ee * round_to<bf16>(a.scale[node]));
            else
              wt = round_to<bf16>(score_cotangent(
                  a.dalpha_in[(g * H + h) * E + e],
                  round_to<bf16>(a.scale[node]),
                  round_to<bf16>(a.d_denom[node]), ee));
          }
          T.wt[r * EDGE_TAB_LD + h] = wt;
          if (PASS == 1) T.e[r * EDGE_TAB_LD + h] = ee;
        }
        __syncwarp();
        if ((tw & 31) == 0) mbar_arrive(tfull + slot);
      }
    }
    return;
  }

  // consumer warpgroup wg: slots wg 64 .. wg 64 + 63 of each pair, warp wq
  // of it 16 of them. Its accumulators hold rows g and g + 8 of the warp's
  // 16, columns 8 j + 2 t and the next; the epilogue runs on them staged
  // as rows (edge_rows), 32 columns at a time.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tw & 31, wq = tw >> 5, g8 = lane >> 2, t = lane & 3;
  float* stg = staging + (wg * 4 + wq) * (EDGE_WARP_STAGE / 4);
  const bf16* sb = reinterpret_cast<const bf16*>(stg);
  // a lane's row of a 16 x 16 A tile for ldmatrix (rows 0-7 and 8-15, then
  // the same for depth 8-15)
  const int lm_off =
      ((lane & 7) + 8 * ((lane >> 3) & 1)) * 2 * EDGE_LDS + 8 * (lane >> 4);
  float dbsum[NB][2];
#pragma unroll
  for (int b = 0; b < NB; ++b) dbsum[b][0] = dbsum[b][1] = 0.0f;
  if constexpr (!STREAM) mbar_wait(wbar, 0);
  int s = 0, q = 0;
  uint32_t lap = 0;
  for (int p = blockIdx.x; p < a.n_pairs; p += gridDim.x, ++q) {
    EdgePair P;
    P.g = p / ppg;
    P.gN = P.g * N;
    P.e0 = p % ppg * EDGE_PAIR;
    P.w0 = wg * EDGE_ROWS + wq * 16;
    // the pair's tables (filled ahead by the producer's warps)
    const int slot = q % ntab;
    mbar_wait(tfull + slot, (q / ntab) & 1);
    P.T = tabs + slot;
    float hs[2][HP];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < HP; ++h) hs[i][h] = 0.0f;
    uint32_t cp[DEMB ? NK : 1][4];  // the bf16 cotangent, product 2's A
    if constexpr (DEMB) {
#pragma unroll
      for (int k = 0; k < NK; ++k)
        cp[k][0] = cp[k][1] = cp[k][2] = cp[k][3] = 0u;
    }

    // block b of product 1's accumulators (from acc[base]): each half
    // staged, its epilogue, with DEMB its cotangent's two k-steps read back
    // as A
    auto epilogue = [&](const auto& acc, int base, int b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col0 = 64 * b + 32 * h;
        if (col0 >= HD) continue;             // uniform over the block
        stage_half(acc, base, h, stg, g8, t);
        __syncwarp();
        dbsum[b][h] += edge_rows<PASS, HP, DEMB>(a, P, col0, stg, s_bias,
                                                 s_head, hs, lane);
        if constexpr (DEMB) {
          ldmatrix_x4(cp[col0 / 16], sb + lm_off);
          ldmatrix_x4(cp[col0 / 16 + 1], sb + lm_off + 16);
        }
        __syncwarp();                         // the staging is free again
      }
    };

    // product 1, proj = emb W, and the epilogue on its accumulators
    if constexpr (STREAM) {
      float acc[32 * NB];
      int prev = -1;
      for (int c = 0; c < KB; ++c) {
        mbar_wait(full + s, lap);
        const unsigned char* st = ring + s * stage_bytes;
        const uint64_t da = sw128_desc(st + wg * EDGE_BOX_BYTES);
        const uint64_t db = sw128_mn_desc(st + 2 * EDGE_BOX_BYTES,
                                          EDGE_BOX_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          EdgeMma<NB>::ss(acc, da + 2 * kk, db + 128 * kk, c > 0 || kk > 0);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + prev);
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          lap ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + prev);
      wgmma_keep(acc);
#pragma unroll
      for (int b = 0; b < NB; ++b) epilogue(acc, 32 * b, b);
    } else {
      // W resident: product 1 one 64-column block of HD at a time, each
      // block's product read from the slot of emb again, so that one
      // block's accumulators are live at a time beside the cotangent's
      // registers
      mbar_wait(full + s, lap);
      const unsigned char* st =
          ring + s * stage_bytes + wg * KB * EDGE_BOX_BYTES;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float acc[32];
        const uint64_t db = sw128_mn_desc(sw + b * Dp * 128, Dp * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < EDGE_MAX_D / 16; ++kk)
          if (16 * kk < D)
            EdgeMma<1>::ss(acc,
                           sw128_desc(st + (kk / 4) * EDGE_BOX_BYTES) +
                               2 * (kk % 4),
                           db + 128 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_keep(acc);
        if (b == NB - 1 && lane == 0) mbar_arrive(empty + s);
        epilogue(acc, 0, b);
      }
      if (++s == stages) {
        s = 0;
        lap ^= 1;
      }
    }

    if constexpr (PASS == 1) {
      // d_alpha per (row, head) over the row's four lanes: lane t of them
      // ends with its row t / 2, heads (t % 2) HP / 2 ..; dalpha_out, and
      // dscale += its product with e, rounded
      float v[2 * HP];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < HP; ++h) v[i * HP + h] = hs[i][h];
      halve_sums<2 * HP, 2, 1>(v, lane);
      const int pr = P.w0 + g8 + 8 * (t >> 1), e = P.e0 + pr;
      const int sn = P.T->src[pr];
      if (e < E) {
#pragma unroll
        for (int k = 0; k < HP / 2; ++k) {
          const int h = (t & 1) * (HP / 2) + k;
          if (h >= H) continue;
          const long long at = (P.g * H + h) * E + e;
          float val = v[k];
          if (a.part & PART_ADD) val += a.dalpha_out[at];
          a.dalpha_out[at] = val;
          if (sn >= 0 && !(a.part & PART_OPEN))
            atomicAdd(&a.dscale[(P.gN + sn) * H + h],
                      round_to<bf16>(val * P.T->e[pr * EDGE_TAB_LD + h]));
        }
      }
    }
    // the tables are free for the pair after next
    __syncwarp();
    if (lane == 0) mbar_arrive(tempty + slot);

    // product 2: demb = cot W^T (+ add), 64 of demb's columns at a time,
    // the add read before the product, staged and rounded once
    if constexpr (DEMB) {
#pragma unroll 1
      for (int cn = 0; cn < KB; ++cn) {
        uint4 kept[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int col = cn * 64 + 32 * h + 8 * t;
            const int e = P.e0 + P.w0 + g8 + 8 * k;
            kept[h][k] = make_uint4(0u, 0u, 0u, 0u);
            if (a.add != nullptr && col < D && e < E)
              kept[h][k] = *reinterpret_cast<const uint4*>(
                  a.add + (P.g * E + e) * D + col);
          }
        float out[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          if (16 * kk >= HD) continue;
          EdgeMma<1>::rs(out, cp[kk],
                         sw128_desc(sw + (kk / 4) * Dp * 128 +
                                    cn * EDGE_BOX_BYTES) +
                             2 * (kk % 4),
                         kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_keep(out);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (cn * 64 + 32 * h >= D) continue;  // uniform over the block
          stage_half(out, 0, h, stg, g8, t);
          __syncwarp();
          edge_demb_rows(a, P, cn * 64 + 32 * h, stg, kept[h], lane);
          __syncwarp();
        }
      }
    }
  }

  // the block's partial bias gradient, through the ring (idle: every load
  // has been consumed and every product has completed); lane l holds
  // column 8 (l % 4) + l / 4 of each 32 of its warp's rows
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  float* red = reinterpret_cast<float*>(ring);
  const int warp8 = wg * 4 + wq;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      red[warp8 * 64 * NB + 64 * b + 32 * h + 8 * t + g8] = dbsum[b][h];
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
  for (int c = threadIdx.x; c < HD; c += 256) {
    float v = 0.0f;
    for (int w = 0; w < 8; ++w) v += red[w * 64 * NB + c];
    a.db_part[(long long)blockIdx.x * HD + c] = v;
  }
}

// ---------------------------------------------------------------------------
// host side (the maps' encoding: tma_wgmma.cuh)
// ---------------------------------------------------------------------------

template <int PASS, int NB, bool STREAM, bool DEMB, int HP>
int launch_edge(const void* emb, const void* w16, const EdgeArgs& a, int G,
                int n_blocks, cudaStream_t s) {
  CUtensorMap maps[2] = {};
  int err = encode_3d<bf16>(&maps[0], emb, G, a.E, a.D, EDGE_BOX, EDGE_ROWS);
  if (!err)
    err = encode<bf16>(&maps[1], w16, a.D, a.HD, EDGE_BOX,
                       STREAM ? EDGE_BOX : edge_dp(a.D), true);
  if (err) return err;
  const int smem = edge_smem_bytes(a.D, a.HD, STREAM, a.stages, a.tables);
  cudaError_t e = cudaFuncSetAttribute(
      edge_wgmma_kernel<PASS, NB, STREAM, DEMB, HP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  edge_wgmma_kernel<PASS, NB, STREAM, DEMB, HP>
      <<<n_blocks, EDGE_THREADS, smem, s>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

template <int PASS, bool STREAM, bool DEMB, int HP>
int launch_edge_nb(const void* emb, const void* w16, const EdgeArgs& a,
                   int G, int n_blocks, cudaStream_t s) {
  switch (edge_nb(a.HD)) {
    case 1:
      return launch_edge<PASS, 1, STREAM, DEMB, HP>(emb, w16, a, G, n_blocks,
                                                    s);
    case 2:
      return launch_edge<PASS, 2, STREAM, DEMB, HP>(emb, w16, a, G, n_blocks,
                                                    s);
    case 3:
      return launch_edge<PASS, 3, STREAM, DEMB, HP>(emb, w16, a, G, n_blocks,
                                                    s);
    default:
      return launch_edge<PASS, 4, STREAM, DEMB, HP>(emb, w16, a, G, n_blocks,
                                                    s);
  }
}

// W streamed (no product 2), or resident with or without product 2
template <int PASS, int HP>
int launch_edge_mode(const void* emb, const void* w16, const EdgeArgs& a,
                     bool streamed, int G, int n_blocks, cudaStream_t s) {
  if (streamed)
    return launch_edge_nb<PASS, true, false, HP>(emb, w16, a, G, n_blocks, s);
  if (a.demb != nullptr)
    return launch_edge_nb<PASS, false, true, HP>(emb, w16, a, G, n_blocks, s);
  return launch_edge_nb<PASS, false, false, HP>(emb, w16, a, G, n_blocks, s);
}

}  // namespace

// One edge launch of backward pass `pass` (1 or 2) in bf16 (see the head),
// then db = the sum of the blocks' partial rows (db_part, (n_blocks, HD)
// f32). Arguments as gat_bwd.cu's `gat_bwd_pass1` / `gat_bwd_pass2` take
// them for route 1: pass 1 rows_src = nm, rows_dst = gout, add = carry (or
// null), acc_src = dnm, dalpha_out, dscale, part; pass 2 rows_src = nq,
// rows_dst = nk, dalpha_in, d_denom, add = demb (pass 1's, updated in place),
// acc_src = dnq, acc_dst = dnk. w16: W (D, HD) rounded to bf16, contiguous.
// cot (G, E, HD) rows ld_cot apart gets the cotangent rows; demb null makes
// no product 2 (a launch of a pass of several; add is then not read). D and
// HD multiples of 8, HD <= 256, H <= 8 heads of at least 4 features; D >
// 256 only without product 2. nb: HD's 64-column blocks; stream: D > 256;
// hp: 4 for H <= 4, else 8; stages: the ring's slots and tables the
// per-pair tables in flight (1 or 2), within the shared memory; n_blocks:
// the persistent blocks (gat_kernels.edge_plan chooses them all).
extern "C" int gat_edge_tc(
    const void* rows_src, const void* rows_dst, const void* emb,
    const void* w16, const void* bias, const void* scores, const void* gmax,
    const void* scale, const void* dalpha_in, const void* d_denom,
    const void* src, const void* dst, const void* mask, const void* add,
    void* cot, void* demb, void* dalpha_out, void* acc_src, void* acc_dst,
    void* dscale, void* db_part, void* db, int pass, int G, int N, int E,
    int D, int HD, int H, int part, int ld_cot, int nb, int stream, int hp,
    int stages, int tables, int n_blocks, void* cuda_stream) {
  const bool streamed = stream != 0;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if ((pass != 1 && pass != 2) || G < 0 || E < 0 || N <= 0 || D <= 0 ||
      D % 8 != 0 || HD <= 0 || HD % 8 != 0 || HD > EDGE_MAX_COLS || H <= 0 ||
      H > MAX_H || HD % H != 0 || HD / H < 4 || nb != edge_nb(HD) ||
      streamed != (D > EDGE_MAX_D) || (streamed && demb != nullptr) ||
      (hp != 4 && hp != 8) || (pass == 1 && H > hp) || stages < 1 ||
      stages > EDGE_MAX_STAGES || tables < 1 || tables > EDGE_MAX_TABLES ||
      edge_smem_bytes(D, HD, streamed, stages, tables) > EDGE_SMEM_LIMIT ||
      n_blocks < 1 || ld_cot < HD || ld_cot % 8 != 0 || part < 0 ||
      part > 3 || !aligned(rows_src) || !aligned(rows_dst) || !aligned(emb) ||
      !aligned(w16) || !aligned(add) || !aligned(cot) || !aligned(demb) ||
      !aligned(acc_src) || !aligned(acc_dst) || emb == nullptr ||
      w16 == nullptr || cot == nullptr || db_part == nullptr || db == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  EdgeArgs a = {};
  a.rows_src = (const bf16*)rows_src;
  a.rows_dst = (const bf16*)rows_dst;
  a.add = demb == nullptr ? nullptr : (const bf16*)add;
  a.bias = (const float*)bias;
  a.scores = (const float*)scores;
  a.gmax = (const float*)gmax;
  a.scale = (const float*)scale;
  a.dalpha_in = (const float*)dalpha_in;
  a.d_denom = (const float*)d_denom;
  a.src = (const int32_t*)src;
  a.dst = (const int32_t*)dst;
  a.mask = (const uint8_t*)mask;
  a.cot = (bf16*)cot;
  a.demb = (bf16*)demb;
  a.dalpha_out = (float*)dalpha_out;
  a.acc_src = (float*)acc_src;
  a.acc_dst = (float*)acc_dst;
  a.dscale = (float*)dscale;
  a.db_part = (float*)db_part;
  a.N = N; a.E = E; a.D = D; a.HD = HD; a.H = H; a.part = part;
  a.ldc = ld_cot; a.stages = stages; a.tables = tables;
  a.pairs_per_graph = (E + EDGE_PAIR - 1) / EDGE_PAIR;
  if ((long long)G * a.pairs_per_graph > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.n_pairs = G * a.pairs_per_graph;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  // pass 2 sums no heads: one build whatever hp says
  const int err =
      pass == 2 ? launch_edge_mode<2, 4>(emb, w16, a, streamed, G, n_blocks, s)
      : hp == 4 ? launch_edge_mode<1, 4>(emb, w16, a, streamed, G, n_blocks, s)
                : launch_edge_mode<1, 8>(emb, w16, a, streamed, G, n_blocks,
                                         s);
  if (err) return err;
  reduce_partials_kernel<<<(HD + 31) / 32, dim3(32, 8), 0, s>>>(
      (const float*)db_part, (float*)db, n_blocks, HD);
  return (int)cudaGetLastError();
}
