// Tensor-core building blocks shared by the tensor-core kernels of this
// directory (sm_80+ PTX, built here for sm_90a): cp.async staging with
// zero-fill (of bf16 operands, fp32 vectors and int8 codes), ldmatrix
// fragment loads, the mma.sync.m16n8k16 bf16 x bf16 -> fp32 product and
// the mma.sync.m16n8k32 s8 x s8 -> s32 product.
//
// Fragment layout of mma.m16n8k16 (lane = 4 g + t, g = lane / 4,
// t = lane % 4), each 32-bit register holding two bf16 at consecutive
// columns (the lower column in the low half):
//   A (16 x 16, row-major):  a0 (row g, k 2t..2t+1)   a1 (row g + 8, same k)
//                            a2 (row g, k 2t+8..+9)   a3 (row g + 8, same k)
//   B (16 x 8, "col"):       b0 (k 2t..2t+1, col g)   b1 (k 2t+8..+9, col g)
//   C/D (16 x 8, fp32):      c0, c1 (row g, cols 2t, 2t+1)
//                            c2, c3 (row g + 8, cols 2t, 2t+1)
// The products of two bf16 values are exact in fp32; the tensor core adds
// them, and the accumulator, in fp32.  A sequence of mma instructions
// applied to one accumulator in a fixed order gives the same bits however
// the staging around it is cut.
//
// mma.m16n8k32 on int8 (s8) holds four int8 a register, at consecutive k
// (the lowest k in the low byte):
//   A (16 x 32, row-major):  a0 (row g, k 4t..4t+3)   a1 (row g + 8, same k)
//                            a2 (row g, k 4t+16..+19) a3 (row g + 8, same k)
//   B (32 x 8, "col"):       b0 (k 4t..4t+3, col g)   b1 (k 4t+16..+19, col g)
//   C/D (16 x 8, s32):       as the fp32 C/D above
// Its sums are exact integers, so they do not depend on the order of the
// products (no overflow below 2^31: |code| <= 127).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (dst: a shared-window address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// 16 bytes global -> shared, of which only the first src_bytes (1..15) are
// read and the rest zero-filled (the ragged edge)
__device__ __forceinline__ void cp_async16_part(uint32_t dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// 16 zero bytes -> shared
__device__ __forceinline__ void st_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst),
               "r"(0));
}

// one 16-byte chunk of which the first n (<= 0: none) of its per_chunk
// elements (8 bf16, 4 fp32 or 16 int8) are valid: copied, zero-filled past
// the edge, or zeroed
__device__ __forceinline__ void cp_chunk(uint32_t dst, const void* src,
                                         int n, int per_chunk) {
  if (n >= per_chunk)
    cp_async16(dst, src);
  else if (n > 0)
    cp_async16_part(dst, src, n * (16 / per_chunk));
  else
    st_zero16(dst);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's committed groups are in flight (a
// larger n than 6 waits as for 6)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on one m16n8k16 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b on one m16n8k32 tile of int8 codes, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), packed low = lo
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// the zero of a staged element type (bf16 operands, int8 weight codes,
// fp32)
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ bf16 zero<bf16>() {
  return __ushort_as_bfloat16(0);
}
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// Stage one rows x cols tile of a row-major matrix of T (bf16, or int8
// codes; row stride ld elements) into shared memory (row stride lds
// elements, a multiple of one 16-byte chunk, 16 / sizeof(T) elements): tile
// element (r, c) is src[(r0 + r) * ld + c0 + c] where r0 + r < row_hi and
// c0 + c < col_hi, else 0.  vec: 16-byte cp.async chunks (src 16-byte
// aligned and ld a multiple of a chunk), the chunk that straddles the edge
// zero-filled through the copy's src-size, chunks past it stored as zeros;
// otherwise scalar loads and stores, so misaligned rows run the same tile
// through the same main loop.
template <int ROWS, int COLS, int NTHR, typename T>
__device__ __forceinline__ void stage_tile(T* dst, int lds, const T* src,
                                           long long ld, int r0, int row_hi,
                                           int c0, int col_hi, bool vec) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = COLS / EPC;      // chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHR) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    const int gr = r0 + r, gc = c0 + c;
    T* d = dst + r * lds + c;
    const bool row_ok = gr < row_hi;
    if (vec) {
      const int n = row_ok ? col_hi - gc : 0;
      cp_chunk(smem_addr(d), n > 0 ? src + (long long)gr * ld + gc : src, n,
               EPC);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        d[e] = (row_ok && gc + e < col_hi) ? src[(long long)gr * ld + gc + e]
                                           : zero<T>();
    }
  }
}

}  // namespace tc
