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
