// Flash-attention backward, the dk/dv half (kernel B3) for Hopper: bf16 in and
// out, f32 accumulation, tensor cores through WMMA 16x16x16 bf16 fragments.
//
// Replaces multimodal_unlearning_tpu/ops/attention.py:_bwd_dkv_kernel (launched
// by _bwd, which then sums each GQA group).  It computes what they compute:
//   p_ij  = exp(s_ij - lse_i),  s_ij = sm_scale q_i.k_j   (recomputed, never stored)
//   dv_j  = sum_i p_ij do_i
//   dk_j  = sm_scale sum_i p_ij (do_i.v_j - delta_i) q_i,  delta_i = sum_d do_id o_id
// summed over the queries i of every q-head of key head j's group, with the
// masking rules of flash_fwd.cu (kv_mask, causal with q_offset).  p is masked
// after the exponent; a query row whose lse is -1e30 saw no key in the forward
// pass and adds exactly nothing.  Any Sq and Sk; D is 64 or 128.
//
// Design: one block of 4 warps per (64 key rows, kv-head, batch row); each warp
// owns 16 key rows.  The block loops over the q-heads of its group and, for
// each, over query tiles of 64 rows, starting (when causal) at the first tile
// that can see its keys.  The transposed scores s^T and dp^T of a tile go
// through shared memory for the elementwise step, p^T and ds^T are rounded to
// bf16 there, and dk and dv accumulate in WMMA accumulator fragments in
// registers over the whole loop.
//
// GQA: the TPU launcher writes per-q-head partials in bf16 and sums each
// group afterwards.  Here the block that owns a kv-head accumulates the whole
// group in f32 and rounds once, which is closer to exact arithmetic; against
// the TPU order the two differ by the rounding of `group` bf16 partials, a few
// bf16 ulps of the result (the parity tests run in f32, where both are exact).
// No block depends on another and nothing is added atomically.
//
// What bounds it on the card: at the forget step's shape (2,32,768,128) causal
// it does 8 D FLOP per visible pair, 19.4 GFLOP, on 76 MB, so bytes bound it by
// a small margin (0.023 ms against 0.020 ms).  This first version is far from
// both: four products run through WMMA with s, dp, p and ds round-tripping
// shared memory, and 123 KB of shared memory per block leaves one block per
// SM.  mma.sync/wgmma with register-resident tiles and TMA loads are later
// work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // key rows per block
constexpr int NWARPS = BK / 16;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 K, V, Q, dO tiles
  static constexpr int LDS = BQ + 4;  // f32 s^T and dp^T
  static constexpr int LDP = BQ + 8;  // bf16 p^T and ds^T
  static constexpr int LDO = D + 4;   // f32 dk/dv staging (aliases the Q and dO tiles)
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + sizeof(__nv_bfloat16) * BK * LDQ;
  static constexpr size_t q_off = v_off + sizeof(__nv_bfloat16) * BK * LDQ;
  static constexpr size_t do_off = q_off + sizeof(__nv_bfloat16) * BQ * LDQ;
  static constexpr size_t s_off = do_off + sizeof(__nv_bfloat16) * BQ * LDQ;
  static constexpr size_t dp_off = s_off + sizeof(float) * BK * LDS;
  static constexpr size_t p_off = dp_off + sizeof(float) * BK * LDS;
  static constexpr size_t ds_off = p_off + sizeof(__nv_bfloat16) * BK * LDP;
  static constexpr size_t lse_off = ds_off + sizeof(__nv_bfloat16) * BK * LDP;
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t bytes = delta_off + sizeof(float) * BQ;
  static_assert(sizeof(float) * BK * LDO <= 2 * sizeof(__nv_bfloat16) * BQ * LDQ,
                "the dk/dv staging must fit in the Q and dO tiles it aliases");
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Hq, int group, int Sq, int Sk,
                     long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                     long long kss, long long vsb, long long vsh, long long vss, long long gsb,
                     long long gsh, long long gss, long long dksb, long long dksh,
                     long long dkss, long long dvsb, long long dvsh, long long dvss,
                     float sm_scale, int causal, int q_offset) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sdP = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  __nv_bfloat16* sdS = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta_off);
  float* sOut = reinterpret_cast<float*>(smem + L::q_off);  // after the loop only

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;  // this warp's first key row in the block

  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;

  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
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

  // validity of this warp's 16 keys, the same in every lane
  bool kvalid[16];
  int any = 0;
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int kk = k0 + r0 + rr;
    kvalid[rr] = kk < Sk && (mb == nullptr || mb[kk] != 0);
    any |= kvalid[rr];
  }
  // a tile of padding keys gets dk = dv = 0 without looking at any query
  const bool block_live = __syncthreads_or(any) != 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  const float scale_log2 = sm_scale * mmu::kLog2e;
  const int nq = (Sq + BQ - 1) / BQ;
  // causal: the first query tile that can see key k0
  const int q_start = causal ? max(0, (k0 - q_offset) / BQ) : 0;

  for (int g = 0; block_live && g < group; ++g) {
    const int h = hk * group + g;
    const __nv_bfloat16* qb = q + b * qsb + h * qsh;
    const __nv_bfloat16* gb = dout + b * gsb + h * gsh;
    const long long row_base = (static_cast<long long>(b) * Hq + h) * Sq;

    for (int qt = q_start; qt < nq; ++qt) {
      const int q0 = qt * BQ;
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
      for (int i = tid; i < BQ; i += NTHREADS) {
        const int qi = q0 + i;
        // a row past Sq counts as dead
        sLse[i] = qi < Sq ? lse[row_base + qi] : mmu::kNegInf;
        sDelta[i] = qi < Sq ? delta[row_base + qi] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
      {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BQ / 16];
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, sK + r0 * L::LDQ + kk, L::LDQ);
#pragma unroll
          for (int j = 0; j < BQ / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
            wmma::load_matrix_sync(bt, sQ + j * 16 * L::LDQ + kk, L::LDQ);
            wmma::mma_sync(acc[j], a, bt, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
          wmma::store_matrix_sync(sS + r0 * L::LDS + j * 16, acc[j], L::LDS,
                                  wmma::mem_row_major);
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, sV + r0 * L::LDQ + kk, L::LDQ);
#pragma unroll
          for (int j = 0; j < BQ / 16; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
            wmma::load_matrix_sync(bt, sdO + j * 16 * L::LDQ + kk, L::LDQ);
            wmma::mma_sync(acc[j], a, bt, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < BQ / 16; ++j)
          wmma::store_matrix_sync(sdP + r0 * L::LDS + j * 16, acc[j], L::LDS,
                                  wmma::mem_row_major);
      }
      __syncwarp();

      // p^T and ds^T = p^T (dp^T - delta): each lane keeps two query columns
      {
        float lse2_c[2], delta_c[2];
        bool live_c[2];
        int qpos_c[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = lane + 32 * t;
          const float l = sLse[col];
          live_c[t] = l > 0.5f * mmu::kNegInf;
          lse2_c[t] = l * mmu::kLog2e;
          delta_c[t] = sDelta[col];
          qpos_c[t] = q0 + col + q_offset;
        }
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) {
          const int row = r0 + rr;
          const int kpos = k0 + row;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int col = lane + 32 * t;
            const bool ok = kvalid[rr] && live_c[t] && (!causal || kpos <= qpos_c[t]);
            const float e = exp2f(sS[row * L::LDS + col] * scale_log2 - lse2_c[t]);
            const float p = ok ? e : 0.f;  // masked after the exponent
            const float ds = p * (sdP[row * L::LDS + col] - delta_c[t]);
            sP[row * L::LDP + col] = __float2bfloat16(p);
            sdS[row * L::LDP + col] = __float2bfloat16(ds);
          }
        }
      }
      __syncwarp();

      // dV += P^T dO and dK += dS^T Q
      {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa[BQ / 16];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wmma::load_matrix_sync(pa[kk], sP + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> gf;
            wmma::load_matrix_sync(gf, sdO + kk * 16 * L::LDQ + j * 16, L::LDQ);
            wmma::mma_sync(dv_acc[j], pa[kk], gf, dv_acc[j]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wmma::load_matrix_sync(pa[kk], sdS + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf;
            wmma::load_matrix_sync(qf, sQ + kk * 16 * L::LDQ + j * 16, L::LDQ);
            wmma::mma_sync(dk_acc[j], pa[kk], qf, dk_acc[j]);
          }
        }
      }
      __syncthreads();  // the Q, dO, lse and delta tiles are overwritten next
    }
  }

  // every warp is past its last read of the Q and dO tiles: stage dk, then
  // dv, in this warp's rows there
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < dk_acc[j].num_elements; ++i) dk_acc[j].x[i] *= sm_scale;
        wmma::store_matrix_sync(sOut + r0 * L::LDO + j * 16, dk_acc[j], L::LDO,
                                wmma::mem_row_major);
      } else {
        wmma::store_matrix_sync(sOut + r0 * L::LDO + j * 16, dv_acc[j], L::LDO,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();
    __nv_bfloat16* out = pass == 0 ? dk + b * dksb + hk * dksh : dv + b * dvsb + hk * dvsh;
    const long long oss = pass == 0 ? dkss : dvss;
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      const int ki = k0 + row;
      if (ki >= Sk) continue;
      __nv_bfloat16* orow = out + ki * oss;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 f = make_float2(sOut[row * L::LDO + d], sOut[row * L::LDO + d + 1]);
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __float22bfloat162_rn(f);
      }
    }
    __syncwarp();
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* mask, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B, int Hq, int Hkv,
           int Sq, int Sk, const long long* st, float sm_scale, int causal, int q_offset,
           cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = mmu::allow_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sk + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<const __nv_bfloat16*>(dout), lse,
      delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Hq, Hq / Hkv, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14], st[15], st[16], st[17], sm_scale, causal, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout [B,Hq,Sq,D] and k, v, dk, dv [B,Hkv,Sk,D] bf16 with the given element
// strides (batch, head, row for each of q, k, v, dout, dk, dv; the last
// dimension contiguous, rows 16-byte aligned); mask [B,Sk] int32 or null (all
// valid); lse and delta [B,Hq,Sq] f32 contiguous.
extern "C" int mmu_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const int* mask, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int Hq, int Hkv, int Sq,
    int Sk, int D, long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long gsb, long long gsh,
    long long gss, long long dksb, long long dksh, long long dkss, long long dvsb,
    long long dvsh, long long dvss, float sm_scale, int causal, int q_offset, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[18] = {qsb, qsh,  qss,  ksb,  ksh,  kss,  vsb,  vsh,  vss,
                            gsb, gsh,  gss,  dksb, dksh, dkss, dvsb, dvsh, dvss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, mask, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk, st,
                       sm_scale, causal, q_offset, s);
  if (D == 64)
    return launch<64>(q, k, v, mask, dout, lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk, st, sm_scale,
                      causal, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
