// Flash-attention forward (kernel B1) for Hopper: bf16 in and out, f32
// accumulation, tensor cores through WMMA 16x16x16 bf16 fragments.
//
// Replaces multimodal_unlearning_tpu/ops/attention.py:_fwd_kernel (launcher
// _fwd).  It computes what that kernel computes, not how Mosaic laid it out:
//   o[b,h,i]   = softmax_j(s_ij) v[b,h//group,j],  s_ij = sm_scale q_i.k_j
//   lse[b,h,i] = ln sum_j exp(s_ij)   (natural log, for the backward pass)
// over the keys j with kv_mask[b,j] != 0 and, when causal, j <= q_offset+i.
// A row with no such key gives o = 0 and lse = -1e30.  GQA maps q-head h to
// kv-head h // group.  Any Sq and Sk (the ViT's 577 too); D is 64 or 128.
//
// Design: one block of 4 warps per (64 query rows, q-head, batch row); each
// warp owns 16 rows.  Key/value tiles of 64 columns stream through shared
// memory; the scores of a tile go through shared memory for the online
// softmax (log2 domain, exp2), and the output accumulator stays in shared
// memory in f32, rescaled there per row.  Causal blocks stop at the last
// tile their rows can see; a tile whose mask columns are all 0 (left
// padding) is skipped before its keys are loaded.
//
// What bounds it on the card: at the prefill shape (1,32,768,128) causal it
// does about 3.7 GFLOP on 25 MB, so the tensor cores bound it.  This first
// version spends most of its time on the shared-memory round trips of the
// scores and the accumulator, which the WMMA fragment layout forces; wgmma
// with register-resident accumulators and TMA loads are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // key columns per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
struct Layout {
  // padded leading dimensions (elements) against bank conflicts; every
  // fragment pointer stays 32-byte aligned
  static constexpr int LDQ = D + 8;   // bf16 Q, K, V tiles
  static constexpr int LDS = BK + 4;  // f32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BK * LDQ;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BK * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t mask_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t bytes = mask_off + sizeof(int) * BK;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq, int group,
                 int Sq, int Sk, long long qsb, long long qsh, long long qss, long long ksb,
                 long long ksh, long long kss, long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss, float scale_log2, int causal,
                 int q_offset) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  int* sMask = reinterpret_cast<int*>(smem + L::mask_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;  // this warp's first row in the block

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;

  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    uint4 w = zero;
    if (q0 + r < Sq) w = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qss + c * 8);
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c * 8) = w;
  }
  for (int i = tid; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;

  // online-softmax state of this warp's 16 rows, the same in every lane
  float m_r[16], l_r[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    m_r[rr] = mmu::kNegInf;
    l_r[rr] = 0.f;
  }
  __syncthreads();

  // causal: the block's last real row sees keys up to last_row + q_offset
  const int last_row = min(Sq, q0 + BQ) - 1;
  int k_end = causal ? min(Sk, last_row + q_offset + 1) : Sk;
  k_end = max(k_end, 0);
  const int nk = (k_end + BK - 1) / BK;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    int any = 0;
    for (int i = tid; i < BK; i += NTHREADS) {
      const int kk = k0 + i;
      const int ok = kk < Sk && (mb == nullptr || mb[kk] != 0);
      sMask[i] = ok;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;  // all-padding tile: nothing to see

    for (int i = tid; i < BK * CPR; i += NTHREADS) {
      const int r = i / CPR, c = i % CPR;
      uint4 kw = zero, vw = zero;
      if (k0 + r < Sk) {
        kw = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kss + c * 8);
        vw = *reinterpret_cast<const uint4*>(vb + (k0 + r) * vss + c * 8);
      }
      *reinterpret_cast<uint4*>(sK + r * L::LDQ + c * 8) = kw;
      *reinterpret_cast<uint4*>(sV + r * L::LDQ + c * 8) = vw;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + r0 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, sK + j * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(acc[j], a, bt, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(sS + r0 * L::LDS + j * 16, acc[j], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time, two key columns per lane
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      const int qpos = q0 + row + q_offset;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = lane + 32 * t;
        ok[t] = sMask[col] != 0 && (!causal || k0 + col <= qpos);
        s[t] = ok[t] ? sS[row * L::LDS + col] * scale_log2 : mmu::kNegInf;
      }
      const float m_new = fmaxf(m_r[rr], mmu::warp_max(fmaxf(s[0], s[1])));
      const float p0 = ok[0] ? exp2f(s[0] - m_new) : 0.f;
      const float p1 = ok[1] ? exp2f(s[1] - m_new) : 0.f;
      const float alpha = exp2f(m_r[rr] - m_new);
      l_r[rr] = l_r[rr] * alpha + mmu::warp_sum(p0 + p1);
      m_r[rr] = m_new;
      sP[row * L::LDP + lane] = __float2bfloat16(p0);
      sP[row * L::LDP + lane + 32] = __float2bfloat16(p1);
      for (int d = lane; d < D; d += 32) sO[row * L::LDO + d] *= alpha;
    }
    __syncwarp();

    // O += P V
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], sP + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        wmma::load_matrix_sync(oacc, sO + r0 * L::LDO + j * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
          wmma::load_matrix_sync(vf, sV + kk * 16 * L::LDQ + j * 16, L::LDQ);
          wmma::mma_sync(oacc, pa[kk], vf, oacc);
        }
        wmma::store_matrix_sync(sO + r0 * L::LDO + j * 16, oacc, L::LDO, wmma::mem_row_major);
      }
    }
    __syncthreads();  // the K, V and mask tiles are overwritten next
  }
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int row = r0 + rr;
    const int qi = q0 + row;
    if (qi >= Sq) continue;
    const float l = l_r[rr];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* orow = o + b * osb + h * osh + qi * oss;
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 f = make_float2(sO[row * L::LDO + d] * inv, sO[row * L::LDO + d + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(orow + d) = __float22bfloat162_rn(f);
    }
    if (lane == 0)
      lse[(static_cast<long long>(b) * Hq + h) * Sq + qi] =
          l > 0.f ? m_r[rr] * mmu::kLn2 + logf(l) : mmu::kNegInf;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask, void* o, float* lse,
           int B, int Hq, int Hkv, int Sq, int Sk, long long qsb, long long qsh, long long qss,
           long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
           long long vss, long long osb, long long osh, long long oss, float sm_scale,
           int causal, int q_offset, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = mmu::allow_smem(flash_fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(o), lse, Hq,
      Hq / Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
      sm_scale * mmu::kLog2e, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D], o [B,Hq,Sq,D] bf16 with the given element
// strides (the last dimension contiguous, rows 16-byte aligned); mask
// [B,Sk] int32 or null (all valid); lse [B,Hq,Sq] f32 contiguous.
extern "C" int mmu_flash_fwd_bf16(const void* q, const void* k, const void* v, const int* mask,
                                  void* o, float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                                  int D, long long qsb, long long qsh, long long qss,
                                  long long ksb, long long ksh, long long kss, long long vsb,
                                  long long vsh, long long vss, long long osb, long long osh,
                                  long long oss, float sm_scale, int causal, int q_offset,
                                  void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, mask, o, lse, B, Hq, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss,
                       vsb, vsh, vss, osb, osh, oss, sm_scale, causal, q_offset, st);
  if (D == 64)
    return launch<64>(q, k, v, mask, o, lse, B, Hq, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss,
                      vsb, vsh, vss, osb, osh, oss, sm_scale, causal, q_offset, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
