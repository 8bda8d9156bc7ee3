// Shared helpers of the port's CUDA kernels.  Each kernel source is built
// on its own into a shared library with a plain C interface
// (ops/kernels.py); every exported launcher returns the cudaError_t of its
// launch, and this function turns that code into text for the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* mmu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace mmu {

constexpr float kNegInf = -1e30f;  // the JAX package's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 8 bf16 values held in one 16-byte word -> f32
__device__ __forceinline__ void bf16x8_to_float(const uint4& w, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 int8 values held in one 8-byte word -> f32 (exact)
__device__ __forceinline__ void i8x8_to_float(const uint2& w, float* out) {
  const int8_t* v = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(v[i]);
}

// atomicAdd with release and acquire semantics at device scope: called by one
// thread after a block barrier, it publishes the block's earlier global
// stores and sees those of every block that added before it (the counters of
// the kernels whose last block of a tile folds the tile's split partials).
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Raise a kernel's dynamic shared memory limit past the 48 KB default.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mmu
