// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu, chunk_decode.cu,
// int4_matmul.cu): cp.async copies into shared memory with zero-fill,
// ldmatrix fragment loads and the mma.sync.m16n8k16 bf16 product with f32
// accumulation.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * gid + tig):
//   A (16x16, row-major) a[0]: (row gid,   cols 2tig, 2tig+1)
//                        a[1]: (row gid+8, cols 2tig, 2tig+1)
//                        a[2]: (row gid,   cols 8+2tig, 8+2tig+1)
//                        a[3]: (row gid+8, cols 8+2tig, 8+2tig+1)
//   B (16x8, col-major)  b[0]: (rows 2tig, 2tig+1 of column gid)
//                        b[1]: (rows 8+2tig, 8+2tig+1 of column gid)
//   C (16x8, f32)        c[0], c[1]: (row gid,   cols 2tig, 2tig+1)
//                        c[2], c[3]: (row gid+8, cols 2tig, 2tig+1)
// so the C fragments of two neighbouring n8 tiles are, packed to bf16, the A
// fragment of the next product: no shared memory in between.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mmu {

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
// without reading (the address must still be a valid one)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i (16 bytes each); r[i] holds (row gid, cols 2tig,
// 2tig+1) of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, each matrix transposed: r[i] holds (rows 2tig, 2tig+1 of col gid).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 2^x in one instruction (ex2.approx.ftz: within 2 ulp, denormal results
// flushed to 0), for the softmax exponents
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 -> one register of bf16x2, lo in the low 16 bits
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// two int8 values -> bf16x2 (exact: |v| <= 128 has 8 significant bits)
__device__ __forceinline__ uint32_t i8x2_bf16x2(int lo, int hi) {
  return pack_bf16x2(static_cast<float>(lo), static_cast<float>(hi));
}

}  // namespace mmu
