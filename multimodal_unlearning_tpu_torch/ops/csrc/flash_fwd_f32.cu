// Flash-attention forward in float32 (kernel B1's f32 instance) for Hopper:
// f32 in and out, f32 products by FMA on the CUDA cores.
//
// Replaces multimodal_unlearning_tpu/ops/attention.py:_fwd_kernel (launcher
// _fwd) where that kernel runs on f32 inputs: ECO's attacked model computes
// in f32 (methods/eco/attacked_model.py), and its prefill and its
// cache-less forward reach B1 at f32.  It computes what csrc/flash_fwd.cu
// computes, in f32 throughout:
//   o[b,h,i]   = softmax_j(s_ij) v[b,h//group,j],  s_ij = (q_i.k_j) sm_scale
//   lse[b,h,i] = ln sum_j exp(s_ij)   (natural log)
// over the keys j with kv_mask[b,j] != 0 and, when causal, j <= q_offset+i.
// A row with no such key gives o = 0 and lse = -1e30.  GQA maps q-head h to
// kv-head h // group.  Any Sq and Sk; D is 64, 80 or 128.  It has no
// backward: the f32 path never differentiates.
//
// No tensor-core shape takes plain f32 (mma.sync and wgmma take TF32, which
// rounds every product to a 10-bit mantissa: not what the f32 reference
// computes), so both products run as FMAs on the CUDA cores, whose f32 peak
// (67 TFLOP/s on an H100 SXM) bounds the kernel at long rows; at ECO's
// shapes (8, 32, 128, 128) the bytes (q, k, v and o once, 4 bytes each)
// are the larger bound.  A simple tile design, written to be right:
//   - one block of 4 warps per (32 query rows, q-head, batch row); each warp
//     owns 8 rows.  The block's q rows sit in shared memory; K and V arrive
//     in tiles of 32 columns (K's rows padded to D+1 floats, so that lane c
//     reading column c's element d falls on its own bank);
//   - lane c scores column c of the tile against the warp's 8 rows, the
//     online softmax (natural exp, as the reference) updates each row's
//     running max and sum through warp reductions, the probabilities go to
//     shared memory, and lane c accumulates output dims c, c+32, ... of the
//     8 rows from them and the V tile;
//   - a causal block stops at its last row's last visible column, and a
//     tile no row of the warp sees leaves the warp's state as it was.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RW = 8;               // query rows per warp
constexpr int BQ = NWARPS * RW;     // query rows per block
constexpr int BK = 32;              // key columns per tile (one per lane)

struct Args {
  const float *q, *k, *v;
  const int* mask;
  float *o, *lse;
  int B, Hq, Hkv, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float sm_scale;
  int causal, q_offset;
};

template <int D>
struct Smem {
  static constexpr int LDK = D + 1;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * BQ * D;
  static constexpr size_t v_off = k_off + sizeof(float) * BK * LDK;
  static constexpr size_t p_off = v_off + sizeof(float) * BK * D;
  static constexpr size_t m_off = p_off + sizeof(float) * BQ * BK;
  static constexpr size_t bytes = m_off + sizeof(int) * BK;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32_kernel(const Args a) {
  using S = Smem<D>;
  constexpr int DPL = (D + 31) / 32;  // output dims per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + S::q_off);  // [BQ][D]
  float* sK = reinterpret_cast<float*>(smem + S::k_off);  // [BK][D+1]
  float* sV = reinterpret_cast<float*>(smem + S::v_off);  // [BK][D]
  float* sP = reinterpret_cast<float*>(smem + S::p_off);  // [BQ][BK]
  int* sM = reinterpret_cast<int*>(smem + S::m_off);      // [BK]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* qb = a.q + b * a.qsb + h * a.qsh;
  const float* kb = a.k + b * a.ksb + hk * a.ksh;
  const float* vb = a.v + b * a.vsb + hk * a.vsh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    sQ[i] = q0 + r < a.Sq ? qb[(q0 + r) * a.qss + d] : 0.f;
  }
  // the last key column any row of the block may see
  const int kend = a.causal ? min(a.Sk, a.q_offset + min(a.Sq, q0 + BQ)) : a.Sk;

  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }
  const int row0 = q0 + warp * RW;  // this warp's first query row

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int c = i / D, d = i % D, col = k0 + c;
      const bool in = col < a.Sk;
      sK[c * S::LDK + d] = in ? kb[col * a.kss + d] : 0.f;
      sV[c * D + d] = in ? vb[col * a.vss + d] : 0.f;
    }
    if (tid < BK) {
      const int col = k0 + tid;
      sM[tid] = col < a.Sk && (a.mask == nullptr || a.mask[b * a.Sk + col] != 0);
    }
    __syncthreads();

    // scores of column k0+lane against the warp's rows
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float* krow = sK + lane * S::LDK;
    const float* qrow = sQ + warp * RW * D;
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = fmaf(qrow[r * D + d], kd, s[r]);
    }
    const int col = k0 + lane;
    float* prow = sP + warp * RW * BK;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int i = row0 + r;
      const bool ok = sM[lane] && i < a.Sq && (!a.causal || col <= a.q_offset + i);
      const float sc = ok ? s[r] * a.sm_scale : -INFINITY;
      const float tmax = mmu::warp_max(sc);
      float p = 0.f;
      if (tmax != -INFINITY) {  // some column of the tile is visible to row i
        const float m_new = fmaxf(m[r], tmax);
        const float alpha = expf(m[r] - m_new);  // 0 while m was -inf
        p = ok ? expf(sc - m_new) : 0.f;
        l[r] = l[r] * alpha + mmu::warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
      }
      prow[r * BK + lane] = p;
    }
    __syncwarp();
    for (int c = 0; c < BK; ++c) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < D ? sV[c * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pc = prow[r * BK + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[r][j] = fmaf(pc, vv[j], acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int i = row0 + r;
    if (i >= a.Sq) continue;
    const bool live = l[r] > 0.f;
    float* orow = a.o + b * a.osb + h * a.osh + i * a.oss;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) orow[d] = live ? acc[r][j] / l[r] : 0.f;
    }
    if (lane == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + i] =
          live ? m[r] + logf(l[r]) : mmu::kNegInf;
  }
}

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = Smem<D>::bytes;
  cudaError_t err = mmu::allow_smem(flash_fwd_f32_kernel<D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  flash_fwd_f32_kernel<D><<<grid, NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] f32 with the head dim contiguous (strides
// in elements: batch, head, row); mask [B,Sk] int32 contiguous or null;
// o [B,Hq,Sq,D] f32 through its strides; lse [B,Hq,Sq] f32 contiguous.
extern "C" int mmu_flash_fwd_f32(const void* q, const void* k, const void* v, const int* mask,
                                 void* o, float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                                 int D, long long qsb, long long qsh, long long qss,
                                 long long ksb, long long ksh, long long kss, long long vsb,
                                 long long vsh, long long vss, long long osb, long long osh,
                                 long long oss, float sm_scale, int causal, int q_offset,
                                 void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk <= 0 || B <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), mask, static_cast<float*>(o), lse,
               B, Hq, Hkv, Sq, Sk, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,
               sm_scale, causal, q_offset};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(a, st);
  if (D == 80) return launch<80>(a, st);
  if (D == 64) return launch<64>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
