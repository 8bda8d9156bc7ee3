// Flash-attention backward, the dq half (kernel B2) for Hopper: bf16 in and
// out, f32 accumulation, tensor cores through WMMA 16x16x16 bf16 fragments.
//
// Replaces multimodal_unlearning_tpu/ops/attention.py:_bwd_dq_kernel (launched
// by _bwd).  It computes what that kernel computes, not how Mosaic laid it out:
//   p_ij  = exp(s_ij - lse_i),  s_ij = sm_scale q_i.k_j   (recomputed, never stored)
//   dp_ij = do_i.v_j
//   dq_i  = sm_scale sum_j p_ij (dp_ij - delta_i) k_j,  delta_i = sum_d do_id o_id
// over the keys j with kv_mask[b,j] != 0 and, when causal, j <= q_offset+i
// (the masking rules of flash_fwd.cu).  p is masked after the exponent, so a
// masked pair cannot contribute through an overflow.  A row whose lse is -1e30
// saw no key in the forward pass: its p is exactly 0 and its dq is 0.  GQA maps
// q-head h to kv-head h // group.  Any Sq and Sk; D is 64 or 128.
//
// Design: one block of 4 warps per (64 query rows, q-head, batch row); each
// warp owns 16 rows.  Key/value tiles of 64 columns stream through shared
// memory; s and dp of a tile go through shared memory for the elementwise
// step (log2 domain, exp2), ds is rounded to bf16 there, and dq accumulates
// in WMMA accumulator fragments in registers over the whole loop: unlike the
// forward kernel's output it is never rescaled.  Causal blocks stop at the
// last tile their rows can see; a tile whose mask columns are all 0 (left
// padding) is skipped before its keys are loaded.  No block depends on
// another and nothing is added atomically, so the result is deterministic.
//
// What bounds it on the card: at the forget step's shape (2,32,768,128) causal
// it does 6 D FLOP per visible pair, 14.5 GFLOP, on 63 MB, so bytes bound it by
// a small margin (0.019 ms against 0.015 ms).  This first version is far from
// both: the three products run through WMMA with s, dp and ds round-tripping
// shared memory, and 114 KB of shared memory per block leaves one block per
// SM.  mma.sync/wgmma with register-resident s and dp, and TMA loads, are
// later work.

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
  static constexpr int LDQ = D + 8;   // bf16 Q, dO, K, V tiles
  static constexpr int LDS = BK + 4;  // f32 s and dp
  static constexpr int LDP = BK + 8;  // bf16 ds
  static constexpr int LDO = D + 4;   // f32 dq staging (aliases the K and V tiles)
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + sizeof(__nv_bfloat16) * BQ * LDQ;
  static constexpr size_t k_off = do_off + sizeof(__nv_bfloat16) * BQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BK * LDQ;
  static constexpr size_t s_off = v_off + sizeof(__nv_bfloat16) * BK * LDQ;
  static constexpr size_t dp_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t ds_off = dp_off + sizeof(float) * BQ * LDS;
  static constexpr size_t mask_off = ds_off + sizeof(__nv_bfloat16) * BQ * LDP;
  static constexpr size_t bytes = mask_off + sizeof(int) * BK;
  static_assert(sizeof(float) * BQ * LDO <= 2 * sizeof(__nv_bfloat16) * BK * LDQ,
                "the dq staging must fit in the K and V tiles it aliases");
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Hq,
                    int group, int Sq, int Sk, long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                    long long vss, long long gsb, long long gsh, long long gss, long long dsb,
                    long long dsh, long long dss, float sm_scale, int causal, int q_offset) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  int* sMask = reinterpret_cast<int*>(smem + L::mask_off);
  float* sOut = reinterpret_cast<float*>(smem + L::k_off);  // after the loop only

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;  // this warp's first row in the block

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* gb = dout + b * gsb + h * gsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const long long row_base = (static_cast<long long>(b) * Hq + h) * Sq;

  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i % CPR;
    uint4 qw = zero, gw = zero;
    if (q0 + r < Sq) {
      qw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qss + c * 8);
      gw = *reinterpret_cast<const uint4*>(gb + (q0 + r) * gss + c * 8);
    }
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c * 8) = qw;
    *reinterpret_cast<uint4*>(sdO + r * L::LDQ + c * 8) = gw;
  }

  // lse (log2 domain) and delta of this warp's 16 rows, the same in every
  // lane; a dead row (lse = -1e30, or a row past Sq) is flagged, never
  // exponentiated
  float lse2_r[16], delta_r[16];
  bool live_r[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int qi = q0 + r0 + rr;
    const float l = qi < Sq ? lse[row_base + qi] : mmu::kNegInf;
    live_r[rr] = l > 0.5f * mmu::kNegInf;
    lse2_r[rr] = l * mmu::kLog2e;
    delta_r[rr] = qi < Sq ? delta[row_base + qi] : 0.f;
  }
  const float scale_log2 = sm_scale * mmu::kLog2e;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);
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

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
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
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sdO + r0 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
          wmma::load_matrix_sync(bt, sV + j * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(acc[j], a, bt, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(sdP + r0 * L::LDS + j * 16, acc[j], L::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // ds = p (dp - delta), one row at a time, two key columns per lane
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      const int qpos = q0 + row + q_offset;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int col = lane + 32 * t;
        const bool ok = live_r[rr] && sMask[col] != 0 && (!causal || k0 + col <= qpos);
        const float e = exp2f(sS[row * L::LDS + col] * scale_log2 - lse2_r[rr]);
        const float p = ok ? e : 0.f;  // masked after the exponent
        const float ds = p * (sdP[row * L::LDS + col] - delta_r[rr]);
        sdS[row * L::LDP + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dQ += dS K
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> da[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(da[kk], sdS + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> kf;
          wmma::load_matrix_sync(kf, sK + kk * 16 * L::LDQ + j * 16, L::LDQ);
          wmma::mma_sync(dq_acc[j], da[kk], kf, dq_acc[j]);
        }
      }
    }
    __syncthreads();  // the K, V and mask tiles are overwritten next
  }

  // every warp is past its last read of the K and V tiles: stage dq there
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int i = 0; i < dq_acc[j].num_elements; ++i) dq_acc[j].x[i] *= sm_scale;
    wmma::store_matrix_sync(sOut + r0 * L::LDO + j * 16, dq_acc[j], L::LDO, wmma::mem_row_major);
  }
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int row = r0 + rr;
    const int qi = q0 + row;
    if (qi >= Sq) continue;
    __nv_bfloat16* drow = dq + b * dsb + h * dsh + qi * dss;
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 f = make_float2(sOut[row * L::LDO + d], sOut[row * L::LDO + d + 1]);
      *reinterpret_cast<__nv_bfloat162*>(drow + d) = __float22bfloat162_rn(f);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int Hq, int Hkv, int Sq, int Sk,
           const long long* st, float sm_scale, int causal, int q_offset, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = mmu::allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<const __nv_bfloat16*>(dout), lse,
      delta, static_cast<__nv_bfloat16*>(dq), Hq, Hq / Hkv, Sq, Sk, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], st[14],
      sm_scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout, dq [B,Hq,Sq,D] and k, v [B,Hkv,Sk,D] bf16 with the given element
// strides (batch, head, row for each of q, k, v, dout, dq; the last dimension
// contiguous, rows 16-byte aligned); mask [B,Sk] int32 or null (all valid);
// lse and delta [B,Hq,Sq] f32 contiguous.
extern "C" int mmu_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const int* mask, const void* dout, const float* lse,
                                     const float* delta, void* dq, int B, int Hq, int Hkv, int Sq,
                                     int Sk, int D, long long qsb, long long qsh, long long qss,
                                     long long ksb, long long ksh, long long kss, long long vsb,
                                     long long vsh, long long vss, long long gsb, long long gsh,
                                     long long gss, long long dsb, long long dsh, long long dss,
                                     float sm_scale, int causal, int q_offset, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, gsb, gsh, gss,
                            dsb, dsh, dss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, mask, dout, lse, delta, dq, B, Hq, Hkv, Sq, Sk, st, sm_scale,
                       causal, q_offset, s);
  if (D == 64)
    return launch<64>(q, k, v, mask, dout, lse, delta, dq, B, Hq, Hkv, Sq, Sk, st, sm_scale,
                      causal, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
