// Rows 8 and 9's weight gradient on Hopper: dW = emb^T cot over every slot
// of a backward pass, in f32, one launch a pass over all of its HD columns
// (`gat_bwd_dw`'s route 1, ops/gat_kernels.py `bwd_dw`), then the sum of
// its slot ranges' partials (reduce_partials.cuh).
//
// Replaces the dW products inside the TPU kernels `_bwd1_proj_kernel`
// (qagnn_tpu/ops/pallas_gat.py:835-837, dwme_ref += emb_t d_msg_c) and
// `_bwd2_proj_kernel` (:911-913, dwke_ref += emb_t dekb_c), which carry the
// sum in a resident block over their sequential grid; here the pass's edge
// launches leave it out and this launch takes it over the cotangent rows of
// all of them. emb is (R = G E slots, D), cot (R, HD), both row-major and
// in the pass's dtype; cot's rows are zero at masked slots, so no mask is
// read. The slots are the depth, the outer dimension of both operands: A =
// emb^T is M-major and B = cot N-major, where every operand of the demb
// product (gat_demb.cu) was K-major.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; G = 64, E =
// 4096, a quarter of the slots masked): in bf16 the bytes at the preset
// (emb and cot read once, 0.21 GB, 63 us at 3.35 TB/s; 21 us of operations
// over the live slots) and the tensor cores at gnn_dim 1040 (0.58 TFLOP,
// 0.44 ms at 989 TFLOP/s over the live slots; 0.25 of bytes), beside them
// the L2-to-SM bytes of the operand tiles, (BM + BN) / (BM BN) of an
// element a product; in f32 the split-TF32 operations (three tf32 products
// a product, 495/3 TFLOP/s).
//
// The design (Hopper's own path, as gat_demb.cu; the helpers in
// tma_wgmma.cuh):
// - Tiles of BM rows of dW (emb's columns) x BN (cot's columns) over a
//   range of `chunk` slots: the slot ranges split the depth, so that the
//   few output tiles (four at the preset, 54 at gnn_dim 1040 in bf16) fill
//   the SMs;
//   persistent blocks, one an SM, walk the (tile, range) items, the tiles
//   of one range side by side and a row tile's column tiles one after
//   another (emb's slices come from L2 after their first read), the next
//   item's loads running under this item's epilogue. Each item writes its
//   f32 partial once (n_ranges, D, HD), and reduce_partials_kernel adds
//   them up in a fixed order: no atomics.
// - Operands by TMA: slices of BK slots (64 bf16, 32 f32) of 128-byte
//   column blocks (64 bf16, 32 f32) of emb and cot, in the 128-byte swizzle
//   through 2-D tensor maps, into a ring of `stages` slots with full /
//   empty mbarriers; TMA's zero fill covers the tails of R, D and HD. One
//   producer thread (warpgroup 2, its registers cut with setmaxnreg) keeps
//   the loads in flight; two consumer warpgroups, each on 64 MI of the
//   tile's rows, run wgmma.mma_async and free a slot when their products
//   on it have completed.
// - bf16: A and B straight from the slices, wgmma's transposed operands
//   (imm-trans-a, imm-trans-b 1) through MN-major descriptors
//   (`sw128_mn_desc`: the column blocks `lbo` apart, 8-row groups of slots
//   1024 bytes apart). Each group of slices of DW_FLUSH_SLOTS slots sums
//   in place into a fresh accumulator, which FADD adds to the range's sum
//   (C16: the tensor core's f32 sum truncates, so a sum in place over many
//   thousand slots drifts toward zero: on the H100 -1.45e-5 of sum |dW| at
//   gnn_dim 1040 over ranges of 20k slots, against the mma.sync kernel's
//   -9.8e-7 over its ranges of about 2k). The two sums a thread keeps halve
//   the tile a block can hold: 128 x 192, 128 x 128 or 256 x 64. Variants
//   timed on the H100 (bf16 at gnn_dim 1040; this design 1.64-1.67 ms):
//   one sum in place at 256 x 192 (1.08 ms, biased as above); adding each
//   group's sum to the partial in device memory, by the consumer threads
//   (2.75 ms: each thread's loads and stores serialized) or by TMA's
//   reduce-add from a staging block a warp (1.49 ms at groups of 2048
//   slots, 2.25 at 1024: the L2's reductions bound it); clusters of two
//   CTAs on one slice of cot, loaded once by TMA multicast (1.42-1.67 ms,
//   at 512 0.32-0.35 against 0.21, from run to run; 2.3 ms while the
//   remote release of a slot was a cluster-scope release).
// - f32, split TF32: tf32 wgmma reads only K-major operands from shared
//   memory. A (emb^T) goes from registers: each consumer reads its rows of
//   emb's slice (swizzled) and splits them into hi and lo; B (cot) is made
//   K-major by the producer warpgroup's three other warps, which transpose
//   each landed slice of cot into its slot's hi and lo tiles (mma_tile.cuh
//   `split_tf32` bit for bit), behind a proxy fence and a third mbarrier.
//   Each slice's products go into a fresh accumulator, the small ones first
//   (lo hi, hi lo for all of its depth, then hi hi), which FADD adds to the
//   range's sum once they have completed (the slice's A registers stay in
//   use until then; C16).
// - A box wholly past D or HD is not loaded: its rows or columns of dW are
//   left out of the stores, and a product's row or column reads no other.
// - No fallback: a map that fails to encode or a refused launch returns its
//   error, and the wrapper raises.

#include <cuda_bf16.h>

#include "reduce_partials.cuh"
#include "tma_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DW_SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr int DW_ALIGN = 1024;         // the 128-byte swizzle's period
constexpr int DW_THREADS = 384;        // consumers 0 and 1, producer 2
constexpr int DW_MAX_STAGES = 8;
constexpr int DW_BLOCK = 128;          // bytes of a column block's row
// bf16: the slots a sum runs in place on the tensor cores before FADD adds
// it to the range's sum (C16: the tensor core's f32 sum truncates, and its
// drift toward zero grows with the sum's length: on an H100 the signed bias
// of dW at gnn_dim 1040 was -1.45e-5 of sum |dW| over ranges of 20k slots,
// -9.7e-7 at 2k, -4.3e-7 at 1k, the mma.sync kernel's -9.8e-7 over its
// ranges of about 2k)
constexpr int DW_FLUSH_SLOTS = 1024;
// the tiles (BM, BN) each dtype's kernel is built at (held to
// ops/gat_kernels.py DW_TILES by tests/test_torch_dw_plan.py)
[[maybe_unused]] constexpr int DW_TILES_BF16[][2] = {
    {256, 64}, {128, 128}, {128, 192}};
[[maybe_unused]] constexpr int DW_TILES_F32[][2] = {
    {128, 64}, {128, 96}, {128, 128}};

// slots a slice, and a column block's columns
template <typename T>
__host__ __device__ constexpr int dw_bk() {
  return sizeof(T) == 2 ? 64 : 32;
}

template <typename T>
__host__ __device__ constexpr int dw_cols() {
  return DW_BLOCK / (int)sizeof(T);
}

// a ring slot: the slice of emb's BM columns and of cot's BN, and in f32
// cot's slice transposed, K-major, as its tf32 hi and lo tiles
template <typename T>
__host__ __device__ constexpr int dw_stage_bytes(int bm, int bn) {
  return (bm + bn) * dw_bk<T>() * (int)sizeof(T) +
         (sizeof(T) == 4 ? 2 * bn * DW_BLOCK : 0);
}

// the ring, its barriers (full, empty, split) and the slack that aligns
// the ring to the swizzle's period
template <typename T>
__host__ __device__ constexpr int dw_smem_bytes(int bm, int bn, int stages) {
  return DW_ALIGN + stages * dw_stage_bytes<T>(bm, bn) + 3 * stages * 8;
}

// wgmma.mma_async at a width N: d (64 x N f32, N / 2 registers a thread)
// = A B + (scale ? d : 0). `bf16`: A 64 x 16 and B 16 x N from MN-major
// descriptors (both transposed); `tf32`: A 64 x 8 from registers (rows g
// and g + 8 of the warp's 16, depth t and t + 4), B from a K-major
// descriptor. The operand lists are written out for each width.
#define DW_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// the accumulator registers of a width, as wgmma lists them
#define DW_REGS_32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define DW_REGS_48 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47}"
#define DW_REGS_64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DW_REGS_96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95}"
#define DW_REGS_128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"


template <int N>
struct DwMma;

template <>
struct DwMma<64> {
  static __device__ __forceinline__ void bf16(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        DW_REGS_32 ", %32, %33, p, 1, 1, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        DW_REGS_32 ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct DwMma<96> {
  static __device__ __forceinline__ void bf16(float (&d)[48], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        DW_REGS_48 ", %48, %49, p, 1, 1, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        DW_REGS_48 ", {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct DwMma<128> {
  static __device__ __forceinline__ void bf16(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        DW_REGS_64 ", %64, %65, p, 1, 1, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44),
          DW_D4(48), DW_D4(52), DW_D4(56), DW_D4(60)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        DW_REGS_64 ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44),
          DW_D4(48), DW_D4(52), DW_D4(56), DW_D4(60)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct DwMma<192> {
  static __device__ __forceinline__ void bf16(float (&d)[96], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        DW_REGS_96 ", %96, %97, p, 1, 1, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44),
          DW_D4(48), DW_D4(52), DW_D4(56), DW_D4(60), DW_D4(64), DW_D4(68),
          DW_D4(72), DW_D4(76), DW_D4(80), DW_D4(84), DW_D4(88), DW_D4(92)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
        DW_REGS_96 ", {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44),
          DW_D4(48), DW_D4(52), DW_D4(56), DW_D4(60), DW_D4(64), DW_D4(68),
          DW_D4(72), DW_D4(76), DW_D4(80), DW_D4(84), DW_D4(88), DW_D4(92)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct DwMma<256> {
  static __device__ __forceinline__ void bf16(float (&d)[128], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        DW_REGS_128 ", %128, %129, p, 1, 1, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44),
          DW_D4(48), DW_D4(52), DW_D4(56), DW_D4(60), DW_D4(64), DW_D4(68),
          DW_D4(72), DW_D4(76), DW_D4(80), DW_D4(84), DW_D4(88), DW_D4(92),
          DW_D4(96), DW_D4(100), DW_D4(104), DW_D4(108), DW_D4(112),
          DW_D4(116), DW_D4(120), DW_D4(124)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        DW_REGS_128 ", {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
        : DW_D4(0), DW_D4(4), DW_D4(8), DW_D4(12), DW_D4(16), DW_D4(20),
          DW_D4(24), DW_D4(28), DW_D4(32), DW_D4(36), DW_D4(40), DW_D4(44),
          DW_D4(48), DW_D4(52), DW_D4(56), DW_D4(60), DW_D4(64), DW_D4(68),
          DW_D4(72), DW_D4(76), DW_D4(80), DW_D4(84), DW_D4(88), DW_D4(92),
          DW_D4(96), DW_D4(100), DW_D4(104), DW_D4(108), DW_D4(112),
          DW_D4(116), DW_D4(120), DW_D4(124)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

#undef DW_D4

// a range's sum -> its partial, this consumer's rows and columns of the
// tile
template <int MI, int R>
__device__ __forceinline__ void store_partial(const float (&acc)[MI][R],
                                              float* part, int D, int HD,
                                              int row0, int col0) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + mi * 64 + wq * 16 + g + 8 * h;
      if (row >= D) continue;
      float* p = part + (long long)row * HD + col0 + 2 * t;
#pragma unroll
      for (int j = 0; j < R / 4; ++j) {
        if (col0 + 8 * j >= HD) break;
        *reinterpret_cast<float2*>(p + 8 * j) = make_float2(
            acc[mi][4 * j + 2 * h], acc[mi][4 * j + 2 * h + 1]);
      }
    }
}

// dW tiles of BM = 128 MI rows x BN columns over ranges of `chunk` slots
// (see the note at the head). Maps: emb (R, D) and cot (R, HD) in boxes
// of dw_cols x BK, swizzled. part: (n_ranges, D, HD).
template <typename T, int MI, int BN>
__global__ void __launch_bounds__(DW_THREADS, 1)
dw_wgmma_kernel(const __grid_constant__ CUtensorMap emb_map,
                const __grid_constant__ CUtensorMap cot_map,
                float* __restrict__ part, int D, int HD, int R, int chunk,
                int n_ranges, int stages) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BM = 2 * 64 * MI, BK = dw_bk<T>(), COLS = dw_cols<T>();
  constexpr int BOX = BK * DW_BLOCK;                // bytes of a box
  constexpr int A_BYTES = BM / COLS * BOX, B_BYTES = BN / COLS * BOX;
  constexpr int STAGE = dw_stage_bytes<T>(BM, BN);
  constexpr int RA = BN / 2;                        // accumulators a row block
  constexpr int FLUSH = DW_FLUSH_SLOTS / BK;        // bf16: slices a group
  static_assert(BN % COLS == 0 && BN <= 256 && (!F32 || MI == 1),
                "the tiles the kernel is built at");
  extern __shared__ unsigned char dw_raw[];
  unsigned char* ring =
      dw_raw + (DW_ALIGN - smem_addr(dw_raw) % DW_ALIGN) % DW_ALIGN;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;
  uint64_t* split = empty + stages;   // f32: the slice's B tiles are made
  const int n_col = (HD + BN - 1) / BN;
  const int n_tiles = (D + BM - 1) / BM * n_col;
  const int items = n_tiles * n_ranges;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);          // each consumer warp
      mbar_init(split + s, 3);          // each transposing warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // item -> its tile's first row and column, its first slot and slices
  auto item_of = [&](int item, int& m0, int& n0, int& r0, int& k_tiles) {
    const int range = item / n_tiles, tile = item % n_tiles;
    m0 = tile / n_col * BM;
    n0 = tile % n_col * BN;
    r0 = range * chunk;
    const int len = min(chunk, R - r0);
    k_tiles = len > 0 ? (len + BK - 1) / BK : 0;
  };

  if (wg == 2) {
    if constexpr (F32)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    int s = 0;
    uint32_t lap = 0;
    if (tw == 0) {
      // the producer: every item's slices, the boxes inside D and HD
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int m0, n0, r0, k_tiles;
        item_of(item, m0, n0, r0, k_tiles);
        const int na = min(BM, D - m0 + COLS - 1) / COLS;
        const int nb = min(BN, HD - n0 + COLS - 1) / COLS;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(empty + s, lap ^ 1);
          unsigned char* st = ring + s * STAGE;
          mbar_expect_tx(full + s, (na + nb) * BOX);
          const int y = r0 + kt * BK;
          for (int a = 0; a < na; ++a)
            tma_load(st + a * BOX, &emb_map, m0 + a * COLS, y, full + s);
          for (int b = 0; b < nb; ++b)
            tma_load(st + A_BYTES + b * BOX, &cot_map, n0 + b * COLS, y,
                     full + s);
          if (++s == stages) {
            s = 0;
            lap ^= 1;
          }
        }
      }
    } else if (F32 && tw >= 32) {
      // warps 1-3: each landed slice of cot (BK slots x BN, in column
      // blocks of 32) -> its hi and lo tiles, K-major (BN rows of BK), a
      // thread on 4 slots x 4 columns at a time, eight threads on one
      // column's row of 128 bytes
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        int m0, n0, r0, k_tiles;
        item_of(item, m0, n0, r0, k_tiles);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(full + s, lap);
          unsigned char* st = ring + s * STAGE;
          const float* raw = reinterpret_cast<const float*>(st + A_BYTES);
          uint32_t* hi = reinterpret_cast<uint32_t*>(st + A_BYTES + B_BYTES);
          uint32_t* lo = hi + BN * 32;
          for (int u = tw - 32; u < 2 * BN; u += 96) {
            const int kq = u & 7, n = 4 * (u >> 3);
            float4 v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = 4 * kq + i;
              v[i] = *reinterpret_cast<const float4*>(
                  raw + (n >> 5) * (BK * 32) + k * 32 +
                  ((((n & 31) >> 2) ^ (k & 7)) << 2));
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              uint4 h, l;
              split_tf32(j == 0 ? v[0].x : j == 1 ? v[0].y
                         : j == 2 ? v[0].z : v[0].w, h.x, l.x);
              split_tf32(j == 0 ? v[1].x : j == 1 ? v[1].y
                         : j == 2 ? v[1].z : v[1].w, h.y, l.y);
              split_tf32(j == 0 ? v[2].x : j == 1 ? v[2].y
                         : j == 2 ? v[2].z : v[2].w, h.z, l.z);
              split_tf32(j == 0 ? v[3].x : j == 1 ? v[3].y
                         : j == 2 ? v[3].z : v[3].w, h.w, l.w);
              const int row = n + j, at = row * 32 + ((kq ^ (row & 7)) << 2);
              *reinterpret_cast<uint4*>(hi + at) = h;
              *reinterpret_cast<uint4*>(lo + at) = l;
            }
          }
          fence_proxy_async();
          __syncwarp();
          if ((tw & 31) == 0) mbar_arrive(split + s);
          if (++s == stages) {
            s = 0;
            lap ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [wg 64 MI, (wg + 1) 64 MI) of each tile.
  // The registers the producer warpgroup gives up are the consumers' more:
  // 128 (168 - p) = 256 (c - 168) at the 168 a thread of 384 starts with
  // (p 40, c 232; f32, whose transposing warps need more, p 88, c 208)
  if constexpr (F32)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tw & 31, wq = tw >> 5, g = lane >> 2, t = lane & 3;
  float acc[MI][RA];
  int s = 0;
  uint32_t lap = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int m0, n0, r0, k_tiles;
    item_of(item, m0, n0, r0, k_tiles);
    const int row0 = m0 + wg * 64 * MI;
    if constexpr (F32) {
      // each slice's products into a fresh `p`, added to acc by FADD once
      // they have completed
#pragma unroll
      for (int i = 0; i < RA; ++i) acc[0][i] = 0.0f;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full + s, lap);
        mbar_wait(split + s, lap);
        const unsigned char* st = ring + s * STAGE;
        const float* a = reinterpret_cast<const float*>(st);
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4):
            // row d of dW is column d of emb's slice, depth a slot
            const int d = wg * 64 + wq * 16 + g + 8 * (q & 1);
            const int slot = 8 * k + t + 4 * (q >> 1);
            split_tf32(a[(d >> 5) * (BK * 32) + slot * 32 +
                         ((((d & 31) >> 2) ^ (slot & 7)) << 2) + (d & 3)],
                       hi[k][q], lo[k][q]);
          }
        wgmma_fence();
        const uint64_t dh = sw128_desc(st + A_BYTES + B_BYTES);
        const uint64_t dl = sw128_desc(st + A_BYTES + B_BYTES + BN * DW_BLOCK);
        float p[RA];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          DwMma<BN>::tf32(p, lo[k], dh + 2 * k, k != 0);
#pragma unroll
        for (int k = 0; k < 4; ++k) DwMma<BN>::tf32(p, hi[k], dl + 2 * k, 1);
#pragma unroll
        for (int k = 0; k < 4; ++k) DwMma<BN>::tf32(p, hi[k], dh + 2 * k, 1);
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + s);
        wgmma_keep(p);
#pragma unroll
        for (int i = 0; i < RA; ++i) acc[0][i] += p[i];
        if (++s == stages) {
          s = 0;
          lap ^= 1;
        }
      }
      store_partial<MI, RA>(acc, part + (long long)(item / n_tiles) * D * HD,
                            D, HD, row0, n0);
    } else {
      // bf16: each group of FLUSH slices summed in place into a fresh
      // `p`, which FADD adds to acc once its products have completed;
      // within a group slice kt's products are issued before slice
      // kt - 1's slot is freed
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < RA; ++i) acc[mi][i] = 0.0f;
      for (int k0 = 0; k0 < k_tiles; k0 += FLUSH) {
        const int k1 = min(k0 + FLUSH, k_tiles);
        float p[MI][RA];
        int prev = -1;
        for (int kt = k0; kt < k1; ++kt) {
          mbar_wait(full + s, lap);
          const unsigned char* st = ring + s * STAGE;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t db = sw128_mn_desc(st + A_BYTES + kk * 2048, BOX);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
              DwMma<BN>::bf16(
                  p[mi],
                  sw128_mn_desc(st + (wg * MI + mi) * BOX + kk * 2048, BOX),
                  db, !(kt == k0 && kk == 0));
          }
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
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          wgmma_keep(p[mi]);
#pragma unroll
          for (int i = 0; i < RA; ++i) acc[mi][i] += p[mi][i];
        }
      }
      store_partial<MI, RA>(acc, part + (long long)(item / n_tiles) * D * HD,
                            D, HD, row0, n0);
    }
  }
}

// ---------------------------------------------------------------------------
// host side (the maps' encoding: tma_wgmma.cuh)
// ---------------------------------------------------------------------------

template <typename T, int MI, int BN>
int launch_dw(const void* emb, const void* cot, float* part, float* dw,
              int R, int D, int HD, int chunk, int n_ranges, int stages,
              int n_sm, cudaStream_t s) {
  constexpr int BM = 128 * MI;
  CUtensorMap maps[2] = {};
  int err = encode<T>(&maps[0], emb, R, D, dw_cols<T>(), dw_bk<T>(), true);
  if (!err)
    err = encode<T>(&maps[1], cot, R, HD, dw_cols<T>(), dw_bk<T>(), true);
  if (err) return err;
  const int items = (D + BM - 1) / BM * ((HD + BN - 1) / BN) * n_ranges;
  const int smem = dw_smem_bytes<T>(BM, BN, stages);
  cudaError_t e = cudaFuncSetAttribute(
      dw_wgmma_kernel<T, MI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dw_wgmma_kernel<T, MI, BN><<<items < n_sm ? items : n_sm, DW_THREADS, smem,
                               s>>>(maps[0], maps[1], part, D, HD, R, chunk,
                                    n_ranges, stages);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_partials_kernel<<<(D * HD + 31) / 32, dim3(32, 8), 0, s>>>(
      part, dw, n_ranges, D * HD);
  return (int)cudaGetLastError();
}

}  // namespace

// dW = emb^T cot over R slots, f32 (see the head). emb (R, D), cot (R, HD),
// both contiguous, 16-byte aligned, D and HD multiples of 8; dw (D, HD) f32.
// bf16 (dtype 1) or f32 (dtype 0) operands. bm x bn: the tile, one of the
// dtype's DW_TILES; the slots in n_ranges ranges of `chunk` (a multiple of
// the dtype's BK; every range holds a slot), their partials in part
// ((n_ranges, D, HD) f32, which reduce_partials_kernel then adds up);
// stages: the ring's slots, 2 to 8, within the shared memory; n_sm: the
// blocks to run at most (gat_kernels.dw_plan chooses all of these).
extern "C" int gat_dw_tc(const void* emb, const void* cot, void* part,
                         void* dw, long long R, int D, int HD, int bm,
                         int bn, int chunk, int n_ranges, int stages,
                         int n_sm, int dtype, void* stream) {
  const bool f32 = dtype == 0;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int bk = f32 ? dw_bk<float>() : dw_bk<bf16>();
  const int smem = f32 ? dw_smem_bytes<float>(bm, bn, stages)
                       : dw_smem_bytes<bf16>(bm, bn, stages);
  if (R < 0 || R > 0x7fffffffLL || D <= 0 || D % 8 != 0 || HD <= 0 ||
      HD % 8 != 0 || (dtype != 0 && dtype != 1) || emb == nullptr ||
      cot == nullptr || dw == nullptr || !aligned(emb) || !aligned(cot) ||
      !aligned(dw) || !aligned(part) || chunk <= 0 || chunk % bk != 0 ||
      n_ranges < 1 || part == nullptr ||
      (long long)(n_ranges - 1) * chunk >= (R > 0 ? R : 1) ||
      (long long)n_ranges * chunk < R || stages < 2 ||
      stages > DW_MAX_STAGES || smem > DW_SMEM_LIMIT || n_sm <= 0 ||
      (long long)D * HD > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0)
    return (int)cudaMemsetAsync(dw, 0, (size_t)D * HD * sizeof(float), s);
  const int r = (int)R;
  float* p = (float*)part;
  float* out = (float*)dw;
#define DW_CASE(T, M, N)                                                   \
  if (bm == 128 * (M) && bn == (N))                                        \
    return launch_dw<T, M, N>(emb, cot, p, out, r, D, HD, chunk, n_ranges, \
                              stages, n_sm, s);
  if (f32) {
    DW_CASE(float, 1, 64)
    DW_CASE(float, 1, 96)
    DW_CASE(float, 1, 128)
  } else {
    DW_CASE(bf16, 2, 64)
    DW_CASE(bf16, 1, 128)
    DW_CASE(bf16, 1, 192)
  }
#undef DW_CASE
  return (int)cudaErrorInvalidValue;      // a tile the kernel is not built at
}
