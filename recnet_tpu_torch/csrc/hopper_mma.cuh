// Tensor-core and async-copy helpers shared by the bf16 bodies of
// whole_decode.cu, topk_proj.cu and fused_step.cu and the f32 bodies of
// whole_decode_tf32.cu and topk_proj.cu: mma.sync m16n8k16 (bf16 in, f32
// accumulators), m16n8k8 on three-term TF32 splits of f32 operands,
// ldmatrix fragment loads from shared memory, and
// 16-byte cp.async copies from global to shared memory with their commit
// and wait.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
// A (16 x 16, row): a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] =
// (g, 2t + 8..), a[3] = (g + 8, 2t + 8..); B (16 x 8, col): b[0] =
// (2t..2t+1, g), b[1] = (2t + 8.., g); D (16 x 8): d[0..1] = (g, 2t..2t+1),
// d[2..3] = (g + 8, 2t..2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace recnet {

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The f32 route's products (whole_decode_tf32.cu, topk_proj.cu): mma.sync
// m16n8k8 on TF32 operands, f32 accumulators. Fragments (g = lane / 4, t =
// lane % 4): A (16 x 8, row): a[0] = (g, t), a[1] = (g + 8, t), a[2] =
// (g, t + 4), a[3] = (g + 8, t + 4); B (8 x 8, col): b[0] = (t, g), b[1] =
// (t + 4, g); D as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from 0,
// as cvt.rna.tf32.f32 rounds finite values: half an ulp added to the
// magnitude bits, then the low 13 bits cleared: two integer operations in
// place of a conversion instruction.
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The three-term split of an f32 operand: hi = tf32(x), lo = tf32(x - hi)
// (x - hi is exact in f32). hi lo' + lo hi' + hi hi' drops lo lo' and the
// bits past lo's: about 2^-21 of |x x'| a product.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d = a b from a zero accumulator in three TF32 products, the small terms
// first: a_lo b_hi + a_hi b_lo + a_hi b_hi. The callers add d to their sums
// in IEEE f32 on the CUDA cores.
__device__ __forceinline__ void mma_3xtf32(float d[4], const unsigned ahi[4],
                                           const unsigned alo[4],
                                           const unsigned bhi[2],
                                           const unsigned blo[2]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the four 8x8 b16 matrices whose rows lanes 0-7, 8-15, 16-23 and 24-31
// point at, as mma.sync fragments; TRANS delivers them transposed
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* row) {
  const unsigned a = smem_addr(row);
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

// two 8x8 b16 matrices whose rows lanes 0-7 and 8-15 point at
__device__ __forceinline__ void ldmatrix_x2(unsigned r[2], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row)));
}

// 16 bytes global -> shared, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy 8 bf16 at src[c..c+8) of a row with ncols columns to the 16-byte
// aligned dst, zero past ncols (and all zero when !row_ok): one 16-byte
// cp.async (in flight until the next wait) where the row's alignment
// allows it (aligned16) and the chunk is whole, else plain loads and a
// shared store.
__device__ __forceinline__ void copy_chunk(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int c,
                                           int ncols, bool row_ok,
                                           bool aligned16) {
  if (row_ok && aligned16 && c + 8 <= ncols) {
    cp_async16(dst, src + c);
    return;
  }
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c0 = c + 2 * q;
    const unsigned lo =
        row_ok && c0 < ncols ? __bfloat16_as_ushort(src[c0]) : 0u;
    const unsigned hi =
        row_ok && c0 + 1 < ncols ? __bfloat16_as_ushort(src[c0 + 1]) : 0u;
    w[q] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Copy 4 f32 at src[c..c+4) of a row with ncols columns to the 16-byte
// aligned dst, zero past ncols (all zero when !row_ok), as the bf16 copy
// above does.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           int c, int ncols, bool row_ok,
                                           bool aligned16) {
  if (row_ok && aligned16 && c + 4 <= ncols) {
    cp_async16(dst, src + c);
    return;
  }
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = row_ok && c + q < ncols ? src[c + q] : 0.f;
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// whether every row of a matrix of T with row stride ld elements at p
// starts 16-byte aligned
template <typename T>
inline bool rows_aligned16(const void* p, long long ld) {
  return ((unsigned long long)ld * sizeof(T)) % 16 == 0
         && (unsigned long long)p % 16 == 0;
}

}  // namespace recnet
