// Rows 8 and 9's demb product on Hopper: demb = cot W^T (+ add), summed in
// f32 and rounded to the dtype once, the launch that ends a backward pass
// of more than one launch (ROADMAP C17; `gat_bwd_demb`'s route 1,
// ops/gat_kernels.py `bwd_demb`).
//
// Replaces the demb product inside the TPU kernels `_bwd1_proj_kernel`
// (qagnn_tpu/ops/pallas_gat.py:828-834) and `_bwd2_proj_kernel`
// (:905-910), which make it in the same launch as the rest of their pass:
// here the pass's column launches leave it out and this one launch takes it
// over all HD columns of their cotangent rows. cot (M = G E slots, HD), W
// (D, HD) and add (M, D) all lie K-major (HD, the depth, innermost), so no
// operand is transposed.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; G = 64, E =
// 4096, a quarter of the slots masked): in bf16 the bytes and the tensor
// cores about equally (at gnn_dim 1040 cot read, add read, demb written,
// 1.64 GB, 0.49 ms at 3.35 TB/s; 0.58 TFLOP, 0.58 ms at 989 TFLOP/s, 0.44
// over the live slots) and, beside them, the L2-to-SM bytes of the operand
// tiles, (BM + BN) / (BM BN) of an element a product; in f32 the
// split-TF32 operations (three tf32 products a product, 495/3 TFLOP/s).
//
// The design (Hopper's own path):
// - Operands by TMA. cot's and W's slices of 128 bytes of depth (64 bf16,
//   32 f32) come through 2-D tensor maps in the 128-byte swizzle that
//   wgmma reads; TMA's zero fill covers the tails of M, D and HD, so the
//   main loop has no masks. The maps are encoded on the host per call with
//   cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no
//   -lcuda), and passed as __grid_constant__ parameters.
// - A ring of `stages` slices with full / empty mbarriers: one producer
//   thread (warpgroup 2, its registers cut with setmaxnreg) keeps TMA loads
//   in flight; two consumer warpgroups, each on half of the tile's rows,
//   run wgmma.mma_async on the slices that have landed and free a slot when
//   their products on it have completed.
// - bf16: BM = 256 slots x BN columns a tile, each consumer two m64nBNk16
//   products a 16 of depth, A and B from shared-memory descriptors,
//   accumulated in place over the whole depth (the f64 bias of demb at
//   gnn_dim 1040 is 1e-7 of its size, its rounding's, and every element
//   lies within one bf16 step of the plain version).
// - f32, split TF32 on wgmma (m64nBNk8, tf32): the wrapper splits W into hi
//   and lo once a call, bit for bit as mma_tile.cuh `split_tf32` does, and
//   TMA reads both as B operands; each consumer splits its rows of cot's
//   slice in registers and feeds them as A from registers, three products a
//   step in mma_split_tf32's order (lo hi, hi lo, hi hi), into a fresh
//   accumulator a slice that FADD adds to the tile's (C16: the tensor
//   core's own f32 sum truncates; the f64 bias at 1040 is then 1e-11 to
//   1e-13). BM = 128.
// - BN, the tile's columns, is one of a few widths (DEMB_WIDTHS_*; wgmma
//   takes any multiple of 8 up to 256), chosen on the host per D
//   (gat_kernels.demb_plan) to cover D with the least waste and L2
//   traffic: in bf16 1040 -> 6 x 176, 512 -> 3 x 176, 200 -> 200, 104 ->
//   104; in f32 1040 -> 10 x 104, 512 -> 5 x 104.
// - Persistent blocks, one an SM, walk the tiles, a row tile's column tiles
//   one after another (cot's rows come from L2 after their first read; W
//   stays in L2), so the next tile's loads run under this tile's epilogue.
// - The epilogue, a 64-row block of a consumer's rows at a time: two more
//   producer threads bring each block's add by TMA into its consumer's
//   staging as soon as the consumer's store before has read it; each
//   consumer thread adds its accumulators to the add elements it will
//   overwrite, rounds once, writes them back, and one TMA store writes the
//   block. In place (add = demb, pass 2) is safe: a block's add has landed
//   before the same consumer stores that block, and no other block touches
//   it. Staging a block, not the whole tile, leaves room for three slices
//   in the ring at BN = 176 or 200.
// - No fallback: a map that fails to encode or a refused launch returns its
//   error, and the wrapper raises.
//
// Variants timed at gnn_dim 1040 (gat_variants.py --passes demb --widths;
// the same H100; cuBLAS's addmm of the same function 1.23-1.28 ms bf16,
// 13.3-13.6 f32; the mma.sync kernel this replaces 3.36-3.57 and 12.93-
// 12.99): staging the whole tile, bf16 1.22-1.33 ms at BN 104 or 136 (3
// slices in the ring), 1.61-1.92 at BN 152-200 (2 slices), 14.6 at BN 208
// (its 208 accumulators a thread spilled and serialized the wgmmas);
// staging a block, 1.09 at BN 176 (3 slices), 1.14-1.27 at 136-200; 64-byte
// slices (the 64-byte swizzle, 5-8 in the ring) 1.20 at best; f32 4.7-5.0
// ms at BN 104-136, 5.3-6.3 at 40-72 and at 168 (2 slices), and an f32
// accumulator kept over the whole depth wrong (A's registers rewritten
// under a wgmma still reading them) and no faster.

#include <cuda_bf16.h>

#include "tma_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int DEMB_SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr int DEMB_ALIGN = 1024;         // the 128-byte swizzle's period
constexpr int DEMB_THREADS = 384;        // consumers 0 and 1, producer 2
constexpr int DEMB_MAX_STAGES = 8;
constexpr int DEMB_SLICE = 128;          // bytes of depth a slice
// the column tile widths each dtype's kernel is built at (held to
// ops/gat_kernels.py DEMB_WIDTHS by tests/test_torch_demb_plan.py)
[[maybe_unused]] constexpr int DEMB_WIDTHS_BF16[] = {40, 72, 104, 136, 176, 200};
[[maybe_unused]] constexpr int DEMB_WIDTHS_F32[] = {40, 72, 104, 136};

template <typename T>
struct DembShape;
template <>
struct DembShape<bf16> {
  static constexpr int MI = 2;           // 64-row blocks a consumer
  static constexpr int B_TILES = 1;      // W's tiles a slice
};
template <>
struct DembShape<float> {
  static constexpr int MI = 1, B_TILES = 2;
};

template <typename T>
__host__ __device__ constexpr int demb_bm() {
  return 2 * 64 * DembShape<T>::MI;
}

template <typename T>
__host__ __device__ constexpr int demb_bk() {
  return DEMB_SLICE / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int demb_stage_bytes(int bn) {
  return (demb_bm<T>() + DembShape<T>::B_TILES * bn) * DEMB_SLICE;
}

// the ring, both consumers' staging (a 64-row block of T each) and the
// barriers, and the slack that aligns the ring to the swizzle's period
template <typename T>
__host__ __device__ constexpr int demb_smem_bytes(int bn, int stages) {
  return DEMB_ALIGN + stages * demb_stage_bytes<T>(bn) +
         2 * 64 * bn * (int)sizeof(T) + (2 * stages + 4) * 8;
}

// wgmma.mma_async at a width N: d (64 x N f32, N / 2 registers a thread)
// = A B^T + (scale ? d : 0), A 64 x 16 bf16 (`bf16`, from a descriptor) or
// 64 x 8 tf32 (`tf32`, from registers: rows g and g + 8 of the warp's 16,
// depth t and t + 4), B N x depth from a descriptor, both K-major. The
// operand lists are written out for each width the kernel is built at.
#define DEMB_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// the accumulator registers of a width, as wgmma lists them
#define DEMB_REGS_20 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19}"
#define DEMB_REGS_36 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35}"
#define DEMB_REGS_52 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51}"
#define DEMB_REGS_68 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67}"
#define DEMB_REGS_88 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87}"
#define DEMB_REGS_100 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99}"


template <int N>
struct Wgmma;

template <>
struct Wgmma<40> {
  static __device__ __forceinline__ void bf16(float (&d)[20], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        DEMB_REGS_20 ", %20, %21, p, 1, 1, 0, 0;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[20],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        DEMB_REGS_20 ", {%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct Wgmma<72> {
  static __device__ __forceinline__ void bf16(float (&d)[36], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        DEMB_REGS_36 ", %36, %37, p, 1, 1, 0, 0;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[36],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
        DEMB_REGS_36 ", {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct Wgmma<104> {
  static __device__ __forceinline__ void bf16(float (&d)[52], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
        DEMB_REGS_52 ", %52, %53, p, 1, 1, 0, 0;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[52],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
        DEMB_REGS_52 ", {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct Wgmma<136> {
  static __device__ __forceinline__ void bf16(float (&d)[68], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
        DEMB_REGS_68 ", %68, %69, p, 1, 1, 0, 0;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48), DEMB_D4(52), DEMB_D4(56),
          DEMB_D4(60), DEMB_D4(64)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[68],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 "
        DEMB_REGS_68 ", {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48), DEMB_D4(52), DEMB_D4(56),
          DEMB_D4(60), DEMB_D4(64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct Wgmma<176> {
  static __device__ __forceinline__ void bf16(float (&d)[88], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
        DEMB_REGS_88 ", %88, %89, p, 1, 1, 0, 0;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48), DEMB_D4(52), DEMB_D4(56),
          DEMB_D4(60), DEMB_D4(64), DEMB_D4(68), DEMB_D4(72), DEMB_D4(76),
          DEMB_D4(80), DEMB_D4(84)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[88],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %93, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n176k8.f32.tf32.tf32 "
        DEMB_REGS_88 ", {%88, %89, %90, %91}, %92, p, 1, 1;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48), DEMB_D4(52), DEMB_D4(56),
          DEMB_D4(60), DEMB_D4(64), DEMB_D4(68), DEMB_D4(72), DEMB_D4(76),
          DEMB_D4(80), DEMB_D4(84)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};

template <>
struct Wgmma<200> {
  static __device__ __forceinline__ void bf16(float (&d)[100], uint64_t a,
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %102, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
        DEMB_REGS_100 ", %100, %101, p, 1, 1, 0, 0;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48), DEMB_D4(52), DEMB_D4(56),
          DEMB_D4(60), DEMB_D4(64), DEMB_D4(68), DEMB_D4(72), DEMB_D4(76),
          DEMB_D4(80), DEMB_D4(84), DEMB_D4(88), DEMB_D4(92), DEMB_D4(96)
        : "l"(a), "l"(b), "r"(scale));
  }
  static __device__ __forceinline__ void tf32(float (&d)[100],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 "
        DEMB_REGS_100 ", {%100, %101, %102, %103}, %104, p, 1, 1;\n}\n"
        : DEMB_D4(0), DEMB_D4(4), DEMB_D4(8), DEMB_D4(12), DEMB_D4(16),
          DEMB_D4(20), DEMB_D4(24), DEMB_D4(28), DEMB_D4(32), DEMB_D4(36),
          DEMB_D4(40), DEMB_D4(44), DEMB_D4(48), DEMB_D4(52), DEMB_D4(56),
          DEMB_D4(60), DEMB_D4(64), DEMB_D4(68), DEMB_D4(72), DEMB_D4(76),
          DEMB_D4(80), DEMB_D4(84), DEMB_D4(88), DEMB_D4(92), DEMB_D4(96)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale));
  }
};
#undef DEMB_D4

// One consumer's products on one slice: bf16, A (its rows of cot) and B
// (W) from descriptors, 16 of depth an instruction, each 64-row block of
// its rows against all BN columns; `first` starts the sums afresh.
template <int BN, int MI>
__device__ __forceinline__ void slice_products(float (&acc)[MI][BN / 2],
                                               const unsigned char* a,
                                               const unsigned char* b,
                                               bool first) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < DEMB_SLICE / 32; ++k)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      Wgmma<BN>::bf16(acc[mi], da + mi * (64 * DEMB_SLICE >> 4) + 2 * k,
                      db + 2 * k, !(first && k == 0));
}

// f32, split TF32: the consumer's rows of cot's slice (f32, 32 of depth,
// swizzled) read from shared memory and split into hi and lo in registers,
// W's hi and lo tiles from descriptors; a step of 8 of depth is three
// products, the small terms first.
template <int BN, int MI>
__device__ __forceinline__ void slice_products(float (&acc)[MI][BN / 2],
                                               const float* a,
                                               const unsigned char* b_hi,
                                               const unsigned char* b_lo,
                                               bool first) {
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  uint32_t hi[MI][4][4], lo[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); a
        // row's 16-byte pieces lie XORed by the row (rows g and g + 8 alike)
        const int r = mi * 64 + wq * 16 + g + 8 * (q & 1);
        const int piece = (2 * k + (q >> 1)) ^ g;
        split_tf32(a[r * 32 + piece * 4 + t], hi[mi][k][q], lo[mi][k][q]);
      }
  wgmma_fence();
  const uint64_t dh = sw128_desc(b_hi), dl = sw128_desc(b_lo);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      Wgmma<BN>::tf32(acc[mi], lo[mi][k], dh + 2 * k, !(first && k == 0));
      Wgmma<BN>::tf32(acc[mi], hi[mi][k], dl + 2 * k, 1);
      Wgmma<BN>::tf32(acc[mi], hi[mi][k], dh + 2 * k, 1);
    }
}

// demb tiles of BM slots x BN columns (see the note at the head). Maps:
// cot (M, HD) in boxes of BK x BM, w and w_lo (D, HD; w_lo in f32 only) in
// boxes of BK x BN, add and out (M, D) in boxes of BN x 64 (a consumer's
// 64-row block); add's map is not read unless has_add.
template <typename T, int BN>
__global__ void __launch_bounds__(DEMB_THREADS, 1)
demb_tc_kernel(const __grid_constant__ CUtensorMap cot_map,
               const __grid_constant__ CUtensorMap w_map,
               const __grid_constant__ CUtensorMap w_lo_map,
               const __grid_constant__ CUtensorMap add_map,
               const __grid_constant__ CUtensorMap out_map, int has_add,
               int m_tiles, int n_tiles, int k_tiles, int stages) {
  typedef DembShape<T> S;
  constexpr int BM = demb_bm<T>(), HALF = BM / 2, BK = demb_bk<T>();
  constexpr int MI = S::MI, R = BN / 2;
  constexpr uint32_t A_BYTES = BM * DEMB_SLICE, B_BYTES = BN * DEMB_SLICE;
  constexpr uint32_t STAGE = demb_stage_bytes<T>(BN);
  constexpr uint32_t OUT_BYTES = 64 * BN * sizeof(T);
  static_assert(BN % 8 == 0 && BN <= 256, "wgmma's widths");
  extern __shared__ unsigned char demb_raw[];
  unsigned char* ring =
      demb_raw + (DEMB_ALIGN - smem_addr(demb_raw) % DEMB_ALIGN) % DEMB_ALIGN;
  unsigned char* staging = ring + stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * OUT_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* add_full = empty + stages;   // one a consumer
  uint64_t* add_empty = add_full + 2;
  const int tiles = m_tiles * n_tiles;
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);           // each consumer warp
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(add_full + c, 1);
      mbar_init(add_empty + c, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producers: thread 0 the slices, threads 32 and 64 the add blocks
    // of consumer 0 and 1, each as soon as the consumer's store before has
    // read its staging
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (has_add && (tw == 32 || tw == 64)) {
      const int c = tw / 32 - 1;
      uint32_t q = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int mi = 0; mi < MI; ++mi, ++q) {
          mbar_wait(add_empty + c, (q & 1) ^ 1);
          mbar_expect_tx(add_full + c, OUT_BYTES);
          tma_load(staging + c * OUT_BYTES, &add_map, tile % n_tiles * BN,
                   tile / n_tiles * BM + c * HALF + mi * 64, add_full + c);
        }
    }
    if (tw != 0) return;
    int s = 0;
    uint32_t lap = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(empty + s, lap ^ 1);
        unsigned char* st = ring + s * STAGE;
        mbar_expect_tx(full + s, STAGE);
        tma_load(st, &cot_map, kt * BK, m0, full + s);
        tma_load(st + A_BYTES, &w_map, kt * BK, n0, full + s);
        if constexpr (S::B_TILES == 2)
          tma_load(st + A_BYTES + B_BYTES, &w_lo_map, kt * BK, n0, full + s);
        if (++s == stages) {
          s = 0;
          lap ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [wg HALF, (wg + 1) HALF) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = tw & 31, wq = tw >> 5, g = lane >> 2, t = lane & 3;
  T* out = reinterpret_cast<T*>(staging + wg * OUT_BYTES);
  float acc[MI][R];
  int s = 0;
  uint32_t lap = 0, q = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    if constexpr (sizeof(T) == 4) {
      // f32: each slice's products into `part`, added to acc by FADD once
      // they have completed (the slice's A registers stay in use until
      // then)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[mi][i] = 0.0f;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full + s, lap);
        const unsigned char* st = ring + s * STAGE;
        float part[MI][R];
        slice_products<BN, MI>(
            part, reinterpret_cast<const float*>(st) + wg * HALF * 32,
            st + A_BYTES, st + A_BYTES + B_BYTES, true);
        wgmma_commit();
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          wgmma_keep(part[mi]);
#pragma unroll
          for (int i = 0; i < R; ++i) acc[mi][i] += part[mi][i];
        }
        if (++s == stages) {
          s = 0;
          lap ^= 1;
        }
      }
    } else {
      // bf16, in place over the whole depth: slice kt's products are
      // issued before slice kt - 1's slot is freed
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(full + s, lap);
        const unsigned char* st = ring + s * STAGE;
        slice_products<BN, MI>(acc, st + wg * HALF * DEMB_SLICE,
                               st + A_BYTES, kt == 0);
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
      for (int mi = 0; mi < MI; ++mi) wgmma_keep(acc[mi]);
    }

    // the epilogue, a 64-row block at a time: acc (+ add) rounded once into
    // the staging, one store
#pragma unroll
    for (int mi = 0; mi < MI; ++mi, ++q) {
      consumer_sync(wg);   // the block before's store has read the staging
      if (has_add) mbar_wait(add_full + wg, q & 1);
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wq * 16 + g + 8 * h, c = jj * 8 + 2 * t;
          float v0 = acc[mi][4 * jj + 2 * h], v1 = acc[mi][4 * jj + 2 * h + 1];
          if constexpr (sizeof(T) == 2) {
            __nv_bfloat162* p =
                reinterpret_cast<__nv_bfloat162*>(out + r * BN + c);
            if (has_add) {
              const float2 k = __bfloat1622float2(*p);
              v0 += k.x;
              v1 += k.y;
            }
            *p = __floats2bfloat162_rn(v0, v1);
          } else {
            float2* p = reinterpret_cast<float2*>(out + r * BN + c);
            if (has_add) {
              const float2 k = *p;
              v0 += k.x;
              v1 += k.y;
            }
            *p = make_float2(v0, v1);
          }
        }
      fence_proxy_async();
      consumer_sync(wg);
      if (tw == 0) {
        tma_store(&out_map, out, n0, m0 + wg * HALF + mi * 64);
        bulk_commit();
        bulk_wait_read();
        if (has_add) mbar_arrive(add_empty + wg);
      }
    }
  }
  if (tw == 0) bulk_wait();
}

// ---------------------------------------------------------------------------
// host side (the maps' encoding: tma_wgmma.cuh)
// ---------------------------------------------------------------------------

template <typename T, int BN>
int launch_demb(const void* cot, const void* w, const void* w_lo,
                const void* add, void* out, long long M, int D, int HD,
                int stages, int n_sm, cudaStream_t s) {
  constexpr int BM = demb_bm<T>(), BK = demb_bk<T>();
  CUtensorMap maps[5] = {};
  int err = encode<T>(&maps[0], cot, M, HD, BK, BM, true);
  if (!err) err = encode<T>(&maps[1], w, D, HD, BK, BN, true);
  if (!err && w_lo != nullptr)
    err = encode<T>(&maps[2], w_lo, D, HD, BK, BN, true);
  if (!err && add != nullptr)
    err = encode<T>(&maps[3], add, M, D, BN, 64, false);
  if (!err) err = encode<T>(&maps[4], out, M, D, BN, 64, false);
  if (err) return err;
  const long long m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (D + BN - 1) / BN, k_tiles = (HD + BK - 1) / BK;
  if (m_tiles * n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tiles = (int)(m_tiles * n_tiles);
  const int smem = demb_smem_bytes<T>(BN, stages);
  cudaError_t e = cudaFuncSetAttribute(
      demb_tc_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  demb_tc_kernel<T, BN><<<tiles < n_sm ? tiles : n_sm, DEMB_THREADS, smem,
                          s>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                               add != nullptr, (int)m_tiles, n_tiles,
                               k_tiles, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// demb = cot W^T (+ add), rounded to the dtype once (see the head). cot (M,
// HD), add (M, D) or null, out (M, D); add may be out (in place). D and HD
// multiples of 8, 16-byte aligned arrays. bf16 (dtype 1): w is W rounded
// to bf16, w_lo null; f32 (dtype 0): w and w_lo are W's tf32 hi and lo
// (`split_tf32`). bn: the column tile's width, one of the dtype's
// DEMB_WIDTHS; stages: the ring's slots, 2 to 8, within the shared memory
// (gat_kernels.demb_plan chooses both); n_sm: the blocks to run at most.
extern "C" int gat_demb_tc(const void* cot, const void* w, const void* w_lo,
                           const void* add, void* out, long long M, int D,
                           int HD, int bn, int stages, int n_sm, int dtype,
                           void* stream) {
  const bool f32 = dtype == 0;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int smem = f32 ? demb_smem_bytes<float>(bn, stages)
                       : demb_smem_bytes<bf16>(bn, stages);
  if (M < 0 || D <= 0 || D % 8 != 0 || HD <= 0 || HD % 8 != 0 ||
      (dtype != 0 && dtype != 1) || cot == nullptr || w == nullptr ||
      out == nullptr || (w_lo == nullptr) == f32 || !aligned(cot) ||
      !aligned(w) || !aligned(w_lo) || !aligned(add) || !aligned(out) ||
      stages < 2 || stages > DEMB_MAX_STAGES || smem > DEMB_SMEM_LIMIT ||
      n_sm <= 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) {
    switch (bn) {
#define DEMB_CASE(N)                                                       \
  case N:                                                                  \
    return launch_demb<float, N>(cot, w, w_lo, add, out, M, D, HD, stages, \
                                 n_sm, s);
      DEMB_CASE(40)
      DEMB_CASE(72)
      DEMB_CASE(104)
      DEMB_CASE(136)
#undef DEMB_CASE
    }
  } else {
    switch (bn) {
#define DEMB_CASE(N)                                                      \
  case N:                                                                 \
    return launch_demb<bf16, N>(cot, w, w_lo, add, out, M, D, HD, stages, \
                                n_sm, s);
      DEMB_CASE(40)
      DEMB_CASE(72)
      DEMB_CASE(104)
      DEMB_CASE(136)
      DEMB_CASE(176)
      DEMB_CASE(200)
#undef DEMB_CASE
    }
  }
  return (int)cudaErrorInvalidValue;      // a width the kernel is not built at
}
