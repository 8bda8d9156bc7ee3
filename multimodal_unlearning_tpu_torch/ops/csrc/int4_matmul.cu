// Grouped-int4 W4A16 matmul (kernel B8) for Hopper:
//   y[M,N] = sum_g (x_lo[:, g] @ lo_g) * s_lo[g] + (x_hi[:, g] @ hi_g) * s_hi[g]
// x [M,K] bf16 row-major, x_lo = x[:, :K/2], x_hi = x[:, K/2:].  The weight is
// nibble-packed int8 q4 [K/2,N] stored with K/2 contiguous (column n's K/2
// bytes are one run): byte i of a column holds row i in its low nibble and
// row i + K/2 in its high nibble, values in [-7, 7], sign-extended by two
// arithmetic shifts ((int8)(b << 4) >> 4 and (int8)b >> 4) -- exact in bf16.
// s [K/G,N] f32 row-major: one scale per (group of G rows, column), the low
// half's K/2/G groups first.  Accumulation is f32 and the f32 scale of a
// group multiplies that group's f32 partial product, never a materialised
// weight, as in the TPU kernel.
//
// Replaces multimodal_unlearning_tpu/ops/int4_matmul.py:_kernel (launcher
// int4_matmul_pallas).
//
// What bounds it on the card: at decode (M = 8) and verify (M = 40) rows it
// reads each packed weight byte once and does 4 flops per byte with M = 8:
// far below the operations-per-byte ridge, so it is bound by the packed
// bytes (half a byte per weight plus 4/G bytes of scales).  At chunked-
// prefill and prefill rows (M = 512..1024) the bf16 tensor-core rate bounds
// it.  The design:
//   - one block of 4 warps per (128-column tile, 16/32/64-row tile, split of
//     the groups).  At decode the (N, M) tiles alone are far fewer than the
//     132 SMs (32 for N = 4096), so the groups are split among blocks
//     (split-K; ops/int4_matmul.splits_for picks ~264 blocks) and a second
//     pass sums the splits' f32 partials and casts;
//   - per stage, cp.async copies up to 128 packed rows of the block's 128
//     columns (16-byte runs of one column), the matching x columns of both
//     halves and the stage's scale rows into shared memory, two stages in
//     flight, rows >= M and columns >= N zero-filled;
//   - mma.sync m16n8k16 (bf16 x bf16 -> f32): each warp owns 32 columns.
//     The B fragment is built in registers from the packed bytes in shared
//     memory (the low or the high nibble of two byte pairs), so no unpacked
//     weight is stored anywhere.  A group's accumulator stays in registers
//     with the mma's known layout, so each thread scales its own columns by
//     s[g, n] and adds them into its running f32 accumulator.
// Later work: a ring of more stages (TMA) and wgmma at prefill rows.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NTHREADS = 128;  // 4 warps
constexpr int BN = 128;        // output columns per block, 32 per warp
constexpr int NT = BN / 4 / 8; // n8 tiles per warp
constexpr int KB = 128;        // most packed rows a stage holds
constexpr int W_STRIDE = KB + 16;             // bytes per column in shared memory
constexpr int X_STRIDE = KB + 8;              // bf16 per x row in shared memory
constexpr int MAX_GPS = KB / 16;              // most groups a stage holds (G = 16)

template <int MT>
struct Layout {
  static constexpr int BM = 16 * MT;
  static constexpr int W_BYTES = BN * W_STRIDE;
  static constexpr int X_BYTES = 2 * BM * X_STRIDE * 2;
  static constexpr int S_BYTES = 2 * MAX_GPS * BN * 4;
  static constexpr int STAGE = W_BYTES + X_BYTES + S_BYTES;
  static constexpr int SMEM = 2 * STAGE;
};

using mmu::cp_async16;
using mmu::cp_async4;
using mmu::cp_async_commit;
using mmu::cp_async_wait;
using mmu::mma_bf16;

// two packed bytes (rows k, k+1 of one column) -> bf16x2 of their low (HI =
// false) or high nibbles, row k in the low 16 bits
template <bool HI>
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t two) {
  const uint32_t u0 = two & 0xFFu, u1 = (two >> 8) & 0xFFu;
  int v0, v1;
  if (HI) {
    v0 = static_cast<int>(static_cast<int8_t>(u0)) >> 4;
    v1 = static_cast<int>(static_cast<int8_t>(u1)) >> 4;
  } else {
    v0 = static_cast<int>(static_cast<int8_t>((u0 << 4) & 0xFFu)) >> 4;
    v1 = static_cast<int>(static_cast<int8_t>((u1 << 4) & 0xFFu)) >> 4;
  }
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(v0), static_cast<float>(v1));
  return *reinterpret_cast<uint32_t*>(&h);
}

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* q4;
  const float* s;
  void* out;    // [M,N] bf16 or f32 (one split)
  float* ws;    // [splits,M,N] f32 partials (more than one split)
  int M, K2, N, G, per, splits;
};

// Copy stage (groups gs .. gs+ng-1) into shared memory at `stage`.
template <int MT>
__device__ __forceinline__ void load_stage(const Args& a, char* stage, int gs, int ng, int m0,
                                           int n0) {
  using L = Layout<MT>;
  constexpr int BM = L::BM;
  uint8_t* sw = reinterpret_cast<uint8_t*>(stage);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(stage + L::W_BYTES);
  float* ss = reinterpret_cast<float*>(stage + L::W_BYTES + L::X_BYTES);
  const int tid = threadIdx.x;
  const int kb = ng * a.G;  // packed rows of this stage
  const int gh = a.K2 / a.G;
  // packed bytes: column n's rows [gs*G, gs*G + kb), 16 bytes per copy
  const int wc = kb / 16;
  for (int i = tid; i < BN * wc; i += NTHREADS) {
    const int n = i / wc, c = i - n * wc;
    const int gn = n0 + n;
    const uint8_t* src = a.q4 + static_cast<size_t>(min(gn, a.N - 1)) * a.K2 + gs * a.G + c * 16;
    cp_async16(sw + n * W_STRIDE + c * 16, src, gn < a.N ? 16 : 0);
  }
  // x columns of both halves, 8 bf16 per copy
  const int xc = kb / 8;
  for (int i = tid; i < 2 * BM * xc; i += NTHREADS) {
    const int hr = i / xc, c = i - hr * xc;
    const int h = hr / BM, r = hr - h * BM;
    const int gm = m0 + r;
    const __nv_bfloat16* src =
        a.x + static_cast<size_t>(min(gm, a.M - 1)) * (2 * a.K2) + h * a.K2 + gs * a.G + c * 8;
    cp_async16(sx + (h * BM + r) * X_STRIDE + c * 8, src, gm < a.M ? 16 : 0);
  }
  // scale rows of the stage's groups, both halves
  for (int i = tid; i < 2 * ng * BN; i += NTHREADS) {
    const int hj = i / BN, n = i - hj * BN;
    const int h = hj / ng, j = hj - h * ng;
    const int gn = n0 + n;
    const float* src = a.s + static_cast<size_t>(h * gh + gs + j) * a.N + min(gn, a.N - 1);
    cp_async4(ss + (h * MAX_GPS + j) * BN + n, src, gn < a.N ? 4 : 0);
  }
}

template <int MT, bool HI>
__device__ __forceinline__ void group_half(const char* stage, int j, int G,
                                           float (&acc)[MT][NT][4]) {
  using L = Layout<MT>;
  constexpr int BM = L::BM;
  const uint8_t* sw = reinterpret_cast<const uint8_t*>(stage);
  const __nv_bfloat16* sx =
      reinterpret_cast<const __nv_bfloat16*>(stage + L::W_BYTES) + (HI ? BM * X_STRIDE : 0);
  const float* ss = reinterpret_cast<const float*>(stage + L::W_BYTES + L::X_BYTES) +
                    ((HI ? MAX_GPS : 0) + j) * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][t][e] = 0.f;

  for (int kk = 0; kk < G; kk += 16) {
    const int k = j * G + kk + 2 * tig;
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const __nv_bfloat16* r0 = sx + (mt * 16 + gid) * X_STRIDE + k;
      const __nv_bfloat16* r8 = r0 + 8 * X_STRIDE;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const uint8_t* col = sw + (warp * (NT * 8) + t * 8 + gid) * W_STRIDE + k;
      uint32_t bf[2];
      bf[0] = nibbles_bf16x2<HI>(*reinterpret_cast<const uint16_t*>(col));
      bf[1] = nibbles_bf16x2<HI>(*reinterpret_cast<const uint16_t*>(col + 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(part[mt][t], af[mt], bf);
    }
  }
  // the group's scale multiplies its f32 partial: this thread holds columns
  // 2*tig and 2*tig+1 of each n8 tile
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = warp * (NT * 8) + t * 8 + 2 * tig;
    const float s0 = ss[n], s1 = ss[n + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      acc[mt][t][0] += part[mt][t][0] * s0;
      acc[mt][t][1] += part[mt][t][1] * s1;
      acc[mt][t][2] += part[mt][t][2] * s0;
      acc[mt][t][3] += part[mt][t][3] * s1;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(NTHREADS) int4_matmul_kernel(Args a) {
  using L = Layout<MT>;
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * L::BM, split = blockIdx.z;
  const int gh = a.K2 / a.G;
  const int g_begin = split * a.per, g_end = min(gh, g_begin + a.per);
  const int gps = KB / a.G;  // groups per stage
  const int n_stages = (g_end - g_begin + gps - 1) / gps;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;

  load_stage<MT>(a, smem, g_begin, min(gps, g_end - g_begin), m0, n0);
  cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    const int gs = g_begin + st * gps, ng = min(gps, g_end - gs);
    if (st + 1 < n_stages) {
      const int gn = gs + gps;
      load_stage<MT>(a, smem + ((st + 1) & 1) * L::STAGE, gn, min(gps, g_end - gn), m0, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const char* stage = smem + (st & 1) * L::STAGE;
    for (int j = 0; j < ng; ++j) {
      // the same order as the TPU kernel: acc + lo partial * s_lo + hi partial * s_hi
      group_half<MT, false>(stage, j, a.G, acc);
      group_half<MT, true>(stage, j, a.G, acc);
    }
    __syncthreads();
  }

  // epilogue: rows m0 + mt*16 + gid (+8), columns n0 + warp*32 + t*8 + 2*tig (+1)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + mt * 16 + gid + 8 * half;
      if (m >= a.M) continue;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = n0 + warp * (NT * 8) + t * 8 + 2 * tig;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= a.N) continue;
          const float v = acc[mt][t][2 * half + e];
          const size_t at = static_cast<size_t>(m) * a.N + n + e;
          if (a.splits > 1)
            a.ws[static_cast<size_t>(split) * a.M * a.N + at] = v;
          else
            store<OutT>(reinterpret_cast<OutT*>(a.out) + at, v);
        }
      }
    }
  }
}

// out[i] = sum over the splits of ws[split, i], cast to the output type
template <typename OutT>
__global__ void sum_splits_kernel(const float* ws, OutT* out, int splits, long long mn) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += ws[sp * mn + i];
    store<OutT>(out + i, v);
  }
}

template <int MT, typename OutT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using L = Layout<MT>;
  cudaError_t err = mmu::allow_smem(int4_matmul_kernel<MT, OutT>, L::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + L::BM - 1) / L::BM, a.splits);
  int4_matmul_kernel<MT, OutT><<<grid, NTHREADS, L::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long mn = static_cast<long long>(a.M) * a.N;
  const int blocks = static_cast<int>(min((mn + 255) / 256, 4096LL));
  sum_splits_kernel<OutT><<<blocks, 256, 0, stream>>>(a.ws, reinterpret_cast<OutT*>(a.out),
                                                      a.splits, mn);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  if (a.M <= 16) return launch<1, OutT>(a, stream);
  if (a.M <= 32) return launch<2, OutT>(a, stream);
  return launch<4, OutT>(a, stream);
}

}  // namespace

// x [M,2*K2] bf16 contiguous; q4 [K2,N] int8 stored K2-contiguous (column n
// at q4 + n*K2), 16-byte aligned; s [2*K2/G,N] f32 contiguous; out [M,N]
// bf16 (out_f32 = 0) or f32 contiguous; ws [splits,M,N] f32 when splits > 1.
// G % 16 == 0, G <= 128, K2 % G == 0; the groups are divided into `splits`
// runs of `per` (the last may be shorter, none empty).
extern "C" int mmu_int4_matmul(const void* x, const void* q4, const float* s, void* out,
                               float* ws, int M, int K2, int N, int G, int per, int splits,
                               int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0 || G % 16 || G > KB || K2 % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gh = K2 / G;
  if (splits < 1 || per < 1 || static_cast<long long>(per) * splits < gh ||
      static_cast<long long>(per) * (splits - 1) >= gh || (splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4), s, out, ws,
               M, K2, N, G, per, splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? dispatch<float>(a, st) : dispatch<__nv_bfloat16>(a, st));
}
