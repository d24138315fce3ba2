// Tensor-core tile products for the GAT kernels: bf16 operands in shared
// memory, f32 accumulators in registers, `mma.sync.aligned.m16n8k16` fed by
// `ldmatrix`.
//
// A warp owns 16 rows of the left operand and every 8-column tile of the
// product's width (NT tiles, a compile-time count), so a row's whole output
// sits in the four lanes of one quad: lane l holds, for tile j,
// rows l/4 and l/4 + 8, columns 8j + 2(l%4) and the next one
// (acc[j][0..1] and acc[j][2..3]).
//
// Shared-memory tiles are row-major bf16 with a pitch of
// round_up(width, 16) + 8 elements: the pitch in bytes is then an odd
// multiple of 16, so the eight 16-byte rows that one ldmatrix phase reads
// fall into eight different bank groups. The depth of a product is walked in
// steps of 16; whatever pads it to a multiple of 16 must hold zeros in BOTH
// operands.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int round_up16(int x) { return (x + 15) / 16 * 16; }

// pitch, in bf16 elements, of a shared tile `width` elements wide
__host__ __device__ constexpr int tile_pitch(int width) {
  return round_up16(width) + 8;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_addr(p)));
}

// c += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16_16x8x16(float (&c)[4],
                                                 const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's ldmatrix.x4 row address of a 16 x 16 left operand stored
// [row][depth] (pitch ld) at `tile`: registers 0..3 are then the mma's a0..a3.
__device__ __forceinline__ const __nv_bfloat16* a_frag_ptr(
    const __nv_bfloat16* tile, int ld, int lane) {
  return tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// The same operand stored [depth][row]: read with .trans.
__device__ __forceinline__ const __nv_bfloat16* a_frag_ptr_trans(
    const __nv_bfloat16* tile, int ld, int lane) {
  return tile + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// The lane's ldmatrix.x4 row address of a 16 x 16 right operand (two
// 8-column tiles) stored [depth][column]: read with .trans, registers 0, 1
// are then b0, b1 of the first tile and 2, 3 those of the second.
__device__ __forceinline__ const __nv_bfloat16* b_frag_ptr_trans(
    const __nv_bfloat16* tile, int ld, int lane) {
  return tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// The same operand stored [column][depth].
__device__ __forceinline__ const __nv_bfloat16* b_frag_ptr(
    const __nv_bfloat16* tile, int ld, int lane) {
  return tile + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// acc[j] += A B[:, 8j : 8j + 8] for all NT tiles (NT even, a compile-time
// count: the loop below has no branch, so the B fragments of later tiles
// load while earlier tiles multiply). A: the warp's 16 rows, [row][depth] at
// sA (pitch lda), 16 * ksteps deep. B_DEPTH_MAJOR: B is stored
// [depth][column] at sB (pitch ldb); otherwise [column][depth], that is, the
// product with the transpose of a row-major matrix. Either way B must be
// 8 * NT wide in shared memory; columns past the product's true width hold
// zeros or feed accumulators that are not used.
template <bool B_DEPTH_MAJOR, int NT>
__device__ __forceinline__ void warp_rows_product(
    const __nv_bfloat16* sA, int lda, const __nv_bfloat16* sB, int ldb,
    int ksteps, float (&acc)[NT][4]) {
  static_assert(NT % 2 == 0, "B is read two tiles at a time");
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a_ptr = a_frag_ptr(sA, lda, lane);
  const __nv_bfloat16* b_ptr = B_DEPTH_MAJOR ? b_frag_ptr_trans(sB, ldb, lane)
                                             : b_frag_ptr(sB, ldb, lane);
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, a_ptr + ks * 16);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      if (B_DEPTH_MAJOR)
        ldmatrix_x4_trans(b, b_ptr + (ks * 16) * ldb + j * 8);
      else
        ldmatrix_x4(b, b_ptr + (j * 8) * ldb + ks * 16);
      mma_bf16_16x8x16(acc[j], a, b[0], b[1]);
      mma_bf16_16x8x16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// --- split TF32: f32 operands on the tf32 tensor cores ----------------------
//
// A tf32 product keeps 10 bits of each operand's mantissa (about 2^-11
// relative). Split each f32 operand x into hi = tf32(x) and lo = x - hi
// (split_tf32); then a b = a_lo b_hi + a_hi b_lo + a_hi b_hi up to a_lo b_lo
// and lo's own rounding, about 2^-20 relative per product at worst, each
// term accumulated in f32. The small terms go first, so that they are
// not lost under the large one. `mma.sync.aligned.m16n8k8` with tf32 inputs
// takes A 16 x 8 in four registers (rows g and g + 8, depth t and t + 4; g =
// lane / 4, t = lane % 4), B 8 x 8 in two (depth t and t + 4, column g) and
// gives the accumulator layout of the bf16 product above.

// hi = x rounded to tf32 (10 mantissa bits, to nearest, ties away: what
// cvt.rna.tf32.f32 gives, which sm_90a has no instruction for; ptxas
// writes it as four, a compare, an add, a select and a mask, which made the
// split the larger part of the products' time on an H100, PERF.md PR 20),
// and lo = x - hi, exact in f32, which the tensor core reads as tf32 by
// dropping its 13 low bits (lo's error then at most 2^-10 of lo, 2^-21 of
// x).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b: a 16 x 8 (row), b 8 x 8 (col), tf32 in, f32 accumulate; not
// volatile, so that the compiler may schedule it among the others
__device__ __forceinline__ void mma_tf32_16x8x8(float (&c)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a b[i] over 16 of depth, two steps of 8 (operands of step s:
// a_hi[s], a_lo[s], b[s][i], tile i's two B values), in f32 from the split
// operands for two tiles: in each step the two small terms, then hi hi,
// each over both tiles before the next, so that the products into one
// accumulator do not follow each other. The products go into a fresh
// accumulator t, added to c by FADD: the tensor core's own f32 sum
// truncates (rounds toward zero), and c taken through every product of the
// depth drifted toward zero by about 2^-25 of |c| a product, a bias that
// grew with the depth: at D = 1040 on an H100 the f32 passes lay up to
// 7.7e-6 (forward) and 1.4e-5 (backward) of max|want| from their plain
// versions, and the GNN's f32 gradients 3.1e-3 of the largest from an f64
// reference (PERF.md PR 21). t truncates only within its 16 of depth, and
// c is rounded to nearest.
__device__ __forceinline__ void mma_split_tf32(float (*c)[4],
                                               const uint32_t (&a_hi)[2][4],
                                               const uint32_t (&a_lo)[2][4],
                                               const float (&b)[2][2][2]) {
  constexpr int N = 2;
  float t[N][4] = {};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t b_hi[N][2], b_lo[N][2];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      split_tf32(b[s][i][0], b_hi[i][0], b_lo[i][0]);
      split_tf32(b[s][i][1], b_hi[i][1], b_lo[i][1]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      mma_tf32_16x8x8(t[i], a_lo[s], b_hi[i][0], b_hi[i][1]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      mma_tf32_16x8x8(t[i], a_hi[s], b_lo[i][0], b_lo[i][1]);
#pragma unroll
    for (int i = 0; i < N; ++i)
      mma_tf32_16x8x8(t[i], a_hi[s], b_hi[i][0], b_hi[i][1]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[i][r] += t[i][r];
}

// The column at which an f32 tile of W's rows keeps (row d, column c): bit
// 2 of c flipped in rows with bit 2 set. With a pitch of 8 or 24 floats
// modulo 32 the 32-bit loads of a [depth][column] read (rows t and t + 4,
// columns g) and the ldmatrix phases of a [column][depth] read (eight rows
// of 16 bytes) then both fall into distinct banks.
__device__ __forceinline__ int w32_col(int d, int c) { return c ^ (d & 4); }

// The split-TF32 form of warp_rows_product: acc[j] += A B[:, 8j : 8j + 8]
// for all NT tiles in f32 (error about 2^-21 of the terms' sizes), ksteps
// steps of 16 as above (two of 8 each). A: the warp's 16 rows, [row][depth]
// f32 at sA (pitch lda, lda % 32 in {4, 12, 20, 28}: an odd multiple of 16
// bytes modulo 128, so that ldmatrix, which moves the f32 words as pairs of
// 16-bit ones, reads each phase from eight bank groups); its fragment is
// split once and serves every tile. B: an f32 tile of W's rows (w32_col's
// layout, pitch ldb % 32 in {8, 24}), read as [depth][column] where
// B_DEPTH_MAJOR (32-bit loads) and as [column][depth] otherwise (ldmatrix,
// two tiles a load).
template <bool B_DEPTH_MAJOR, int NT>
__device__ __forceinline__ void warp_rows_product(
    const float* sA, int lda, const float* sB, int ldb, int ksteps,
    float (&acc)[NT][4]) {
  static_assert(NT % 2 == 0, "B is read two tiles at a time");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a_ptr =
      sA + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda + (lane >> 4) * 4;
  // depth-major: rows t (no swizzle) and t + 4 (swizzled) of column g;
  // column-major: the ldmatrix row of this lane, swizzled by its row
  const float* b0_ptr = sB + t * ldb + g;
  const float* b1_ptr = sB + (t + 4) * ldb + (g ^ 4);
  const float* bt_ptr = sB + ((lane & 7) + (lane >> 4) * 8) * ldb +
                        ((((lane >> 3) & 1) * 4) ^ (lane & 4));
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[4];
      ldmatrix_x4(a, a_ptr + (2 * ks + s) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(__uint_as_float(a[i]), a_hi[s][i], a_lo[s][i]);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      float b[2][2][2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int k8 = 2 * ks + s;
        if (B_DEPTH_MAJOR) {
          const int at = k8 * 8 * ldb + j * 8;
          b[s][0][0] = b0_ptr[at];
          b[s][0][1] = b1_ptr[at];
          b[s][1][0] = b0_ptr[at + 8];
          b[s][1][1] = b1_ptr[at + 8];
        } else {
          uint32_t r[4];
          ldmatrix_x4(r, bt_ptr + (j * 8) * ldb + k8 * 8);
          b[s][0][0] = __uint_as_float(r[0]);
          b[s][0][1] = __uint_as_float(r[1]);
          b[s][1][0] = __uint_as_float(r[2]);
          b[s][1][1] = __uint_as_float(r[3]);
        }
      }
      mma_split_tf32(acc + j, a_hi, a_lo, b);
    }
  }
}

// 16-byte asynchronous copy, global to shared (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(shared_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(n) : "memory");
}

// 8 f32 values as 8 bf16 (round to nearest even) in one 16-byte word
__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint4 r;
  __nv_bfloat162 t;
  t = __floats2bfloat162_rn(v[0], v[1]); r.x = *reinterpret_cast<uint32_t*>(&t);
  t = __floats2bfloat162_rn(v[2], v[3]); r.y = *reinterpret_cast<uint32_t*>(&t);
  t = __floats2bfloat162_rn(v[4], v[5]); r.z = *reinterpret_cast<uint32_t*>(&t);
  t = __floats2bfloat162_rn(v[6], v[7]); r.w = *reinterpret_cast<uint32_t*>(&t);
  return r;
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& q, float* v) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

}  // namespace
