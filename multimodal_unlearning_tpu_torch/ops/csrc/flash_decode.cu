// Flash-decode (kernels B4, B4q, B6 and B6q) for Hopper: one query token per
// (batch row, q-head) against layer `layer` of a KV cache read in place (no
// layer slab is copied out).  Two cache layouts share one kernel body:
//   dense (B4, B4q): the stacked [L,B,Hkv,Smax,D] cache;
//   paged (B6, B6q): one pool of pages [L,Hkv,NP,P,D] shared by all rows,
//     with a block table [B,MP]: row b's logical column j lives at pool page
//     table[b, j/P], offset j%P (Smax = MP*P logical columns).
// The cache is bf16 (B4, B6) or int8 with f32 scales, one per position and
// kv-head, the position on the last axis: [L,B,Hkv,1,Smax] dense,
// [L,Hkv,NP,1,P] paged (B4q, B6q).
//
// Replaces multimodal_unlearning_tpu/ops/decode_attention.py:_kernel (B4)
// and :_kernel_q8 (B4q) (launcher _pallas_decode), and
// multimodal_unlearning_tpu/ops/paged_attention.py:_paged_kernel (B6) and
// :_paged_kernel_q8 (B6q) (launcher _pallas_paged).  It computes
//   o[b,h] = softmax_j(sm_scale q[b,h].k[l,b,h//G,j]) v[l,b,h//G,j]
// over the logical columns j with valid[b,j] != 0.  On an int8 cache the scales
// stay outside both dot products, as in the TPU kernel:
//   s_j = (q.K_int[j]) k_s[j],   o = sum_j (p_j v_s[j]) V_int[j] / sum_j p_j,
// so no dequantized K or V is ever formed.  A row with no valid column
// gives o = 0 -- the documented rule for fully-masked rows, which the XLA
// path of decode_attention follows; the Pallas kernels return the mean of
// V there instead.
//
// What bounds it on the card: it streams the valid K and V columns once
// (bytes), with 2 flops per loaded element -- far below the card's
// operations-per-byte ridge.  The design therefore serves bandwidth only:
// one block per (kv-head, batch row) first compacts the row's valid columns
// into shared memory, so that invalid columns cost no load at all (on a
// paged cache the compaction also resolves each column through the block
// table, which the block keeps in shared memory, into its row of the pool:
// pages past the row's extent and all-invalid gap pages are never touched,
// and the rest of the kernel is the dense one, in the same arithmetic order,
// so a paged row gives the dense row's result bit for bit); then
// every group of D/8 lanes scores one key with 16-byte loads (a whole key
// row per group, coalesced) while each warp keeps 4 key groups of K and V
// loads in flight, with an online softmax per lane group in the log2
// domain.  The per-group partial states are merged in shared memory at the
// end.  The GQA group (G q-heads per kv-head) shares every loaded byte.
// On an int8 cache a lane loads its 8 dims as 8 bytes, so a valid column
// costs D bytes of K, D of V and 8 of scales instead of 4D: the bound is
// about half of B4's.  Splitting a long row across blocks (flash-decoding's
// split-K) is later work.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;  // key groups a warp keeps in flight per iteration

// 8 cache elements of one lane: 16 bytes of bf16 or 8 bytes of int8
template <typename T>
struct Lane8;
template <>
struct Lane8<__nv_bfloat16> {
  using Word = uint4;
  static constexpr bool kQ8 = false;
  static __device__ __forceinline__ Word zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void to_float(const Word& w, float* out) {
    mmu::bf16x8_to_float(w, out);
  }
};
template <>
struct Lane8<int8_t> {
  using Word = uint2;
  static constexpr bool kQ8 = true;
  static __device__ __forceinline__ Word zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void to_float(const Word& w, float* out) {
    mmu::i8x8_to_float(w, out);
  }
};

template <int D, int G>
struct DecLayout {
  static constexpr int LPK = D / 8;     // lanes per key, 8 dims (16 bytes) each
  static constexpr int KPW = 32 / LPK;  // keys a warp scores at once
  static constexpr int NSLOT = NWARPS * KPW;
  static size_t bytes(int Smax) {
    return sizeof(int) * Smax + sizeof(float) * NSLOT * G * (2 + D);
  }
};

// PAGED: `table` is the [B,MP] block table of a pool of NP pages of P
// columns (Smax = MP*P); otherwise table is null and MP, P, NP unused.
template <typename T, int D, int G, bool PAGED>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ valid,
                    const int* __restrict__ table, __nv_bfloat16* __restrict__ o, int B,
                    int Hkv, int Smax, int layer, int MP, int P, int NP, float scale_log2) {
  using L = DecLayout<D, G>;
  using E = Lane8<T>;
  constexpr int LPK = L::LPK;
  constexpr int KPW = L::KPW;
  extern __shared__ __align__(16) unsigned char smem[];
  // [Smax] compacted valid columns, each as its row in the layer's K/V
  // rows of this (row, kv-head): the logical column (dense) or
  // page*P + offset in the pool (paged)
  int* sIdx = reinterpret_cast<int*>(smem);
  float* sM = reinterpret_cast<float*>(sIdx + Smax);  // [NSLOT][G]
  float* sL = sM + L::NSLOT * G;                      // [NSLOT][G]
  float* sAcc = sL + L::NSLOT * G;                    // [NSLOT][G][D]
  int* sTable = reinterpret_cast<int*>(sAcc + L::NSLOT * G * D);  // [MP] (paged)
  __shared__ int sCount[NWARPS];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int Hq = Hkv * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane / LPK;   // which of the warp's KPW keys
  const int part = lane % LPK;  // which 8 dims of the key
  const int slot = warp * KPW + sub;

  // 0. paged: this row's block table (no scalar prefetch on this card)
  if (PAGED) {
    for (int i = tid; i < MP; i += NTHREADS) sTable[i] = table[static_cast<long long>(b) * MP + i];
    __syncthreads();
  }

  // 1. compact the row's valid columns (ascending) into sIdx
  const int* vrow = valid + static_cast<long long>(b) * Smax;
  int nvalid = 0;
  for (int base = 0; base < Smax; base += NTHREADS) {
    const int c = base + tid;
    const int flag = c < Smax && vrow[c] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) sCount[warp] = __popc(ballot);
    __syncthreads();
    int off = nvalid, total = 0;
    for (int w = 0; w < NWARPS; ++w) {
      if (w < warp) off += sCount[w];
      total += sCount[w];
    }
    if (flag)
      sIdx[off + __popc(ballot & ((1u << lane) - 1u))] = PAGED ? sTable[c / P] * P + c % P : c;
    nvalid += total;
    __syncthreads();  // sCount is rewritten next round
  }

  // 2. this lane's 8 dims of the G queries, scaled into the log2 domain
  float qv[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 w = *reinterpret_cast<const uint4*>(
        q + (static_cast<long long>(b) * Hq + hk * G + g) * D + part * 8);
    mmu::bf16x8_to_float(w, qv[g]);
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[g][e] *= scale_log2;
  }

  // 3. online softmax over this lane group's share of the valid columns
  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = mmu::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  // the first of this (layer, row, kv-head)'s K/V rows that sIdx counts
  // from: its [Smax, D] slab (dense) or its head's [NP*P, D] pool (paged)
  const long long row0 = PAGED ? (static_cast<long long>(layer) * Hkv + hk) * NP * P
                               : ((static_cast<long long>(layer) * B + b) * Hkv + hk) * Smax;
  const T* kb = kc + row0 * D + part * 8;
  const T* vb = vc + row0 * D + part * 8;
  // int8 cache: the scales of those rows, one per position
  const float* ksr = E::kQ8 ? ks + row0 : nullptr;
  const float* vsr = E::kQ8 ? vs + row0 : nullptr;
  for (int base = warp * KPW * UNROLL; base < nvalid; base += NWARPS * KPW * UNROLL) {
    typename E::Word kw[UNROLL], vw[UNROLL];
    float kscale[UNROLL], vscale[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * KPW + sub;
      ok[u] = i < nvalid;
      kw[u] = E::zero();
      vw[u] = kw[u];
      kscale[u] = 1.f;
      vscale[u] = 1.f;
      if (ok[u]) {
        const long long col = sIdx[i];
        kw[u] = *reinterpret_cast<const typename E::Word*>(kb + col * D);
        vw[u] = *reinterpret_cast<const typename E::Word*>(vb + col * D);
        if (E::kQ8) {
          kscale[u] = ksr[col];
          vscale[u] = vsr[col];
        }
      }
    }
    float s[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[8];
      E::to_float(kw[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part_dot = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part_dot = fmaf(qv[g][e], kf[e], part_dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
        // the key's scale multiplies the finished dot product
        s[u][g] = ok[u] ? part_dot * kscale[u] : mmu::kNegInf;
      }
    }
    float vf[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) E::to_float(vw[u], vf[u]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) m_new = fmaxf(m_new, s[u][g]);
      const float alpha = exp2f(m[g] - m_new);
      float p[UNROLL], psum = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        p[u] = ok[u] ? exp2f(s[u][g] - m_new) : 0.f;
        psum += p[u];
      }
      l[g] = l[g] * alpha + psum;
      // the value's scale multiplies p, outside the second product
      float pv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) pv[u] = p[u] * vscale[u];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) a = fmaf(pv[u], vf[u][e], a);
        acc[g][e] = a;
      }
      m[g] = m_new;
    }
  }

  // 4. merge the NSLOT partial states of each q-head
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (part == 0) {
      sM[slot * G + g] = m[g];
      sL[slot * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sAcc[(slot * G + g) * D + part * 8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float mx = mmu::kNegInf;
    for (int s2 = 0; s2 < L::NSLOT; ++s2) mx = fmaxf(mx, sM[s2 * G + g]);
    float den = 0.f, num = 0.f;
    for (int s2 = 0; s2 < L::NSLOT; ++s2) {
      const float w = exp2f(sM[s2 * G + g] - mx);
      den += w * sL[s2 * G + g];
      num += w * sAcc[(s2 * G + g) * D + d];
    }
    o[(static_cast<long long>(b) * Hq + hk * G + g) * D + d] =
        __float2bfloat16(den > 0.f ? num / den : 0.f);
  }
}

struct Args {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  const int* valid;
  const int* table;  // paged only
  void* o;
  int B, Hkv, Smax, layer;
  int MP, P, NP;  // paged only
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int D, int G, bool PAGED>
int launch(const Args& a) {
  const size_t bytes = DecLayout<D, G>::bytes(a.Smax) + (PAGED ? sizeof(int) * a.MP : 0);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mmu::allow_smem(flash_decode_kernel<T, D, G, PAGED>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.Hkv, a.B);
  flash_decode_kernel<T, D, G, PAGED><<<grid, NTHREADS, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.ks, a.vs, a.valid, a.table,
      static_cast<__nv_bfloat16*>(a.o), a.B, a.Hkv, a.Smax, a.layer, a.MP, a.P, a.NP,
      a.sm_scale * mmu::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool PAGED>
int launch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, D, 1, PAGED>(a);
    case 2: return launch<T, D, 2, PAGED>(a);
    case 4: return launch<T, D, 4, PAGED>(a);
    case 8: return launch<T, D, 8, PAGED>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool PAGED>
int dispatch(const Args& a, int L, int Hq, int D) {
  if (a.Hkv <= 0 || Hq % a.Hkv != 0 || a.layer < 0 || a.layer >= L || a.B <= 0 || a.Smax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (a.table == nullptr || a.P <= 0 || a.MP <= 0 || a.NP <= 0 || a.MP * a.P != a.Smax))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / a.Hkv;
  if (D == 128) return launch_g<T, 128, PAGED>(G, a);
  if (D == 64) return launch_g<T, 64, PAGED>(G, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/o [B,Hq,1,D] bf16 contiguous; k/v cache [L,B,Hkv,Smax,D] bf16
// contiguous; valid [B,Smax] int32 contiguous; 0 <= layer < L.
extern "C" int mmu_flash_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                                     const int* valid, void* o, int L, int B, int Hq, int Hkv,
                                     int Smax, int D, int layer, float sm_scale, void* stream) {
  const Args a{q,     k_cache, v_cache, nullptr, nullptr, valid, nullptr, o, B, Hkv, Smax,
               layer, 0,       0,       0,       sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<__nv_bfloat16, false>(a, L, Hq, D);
}

// As mmu_flash_decode_bf16 on an int8 cache [L,B,Hkv,Smax,D] with f32 scales
// k_s, v_s [L,B,Hkv,1,Smax], all contiguous.
extern "C" int mmu_flash_decode_q8(const void* q, const void* k_cache, const void* v_cache,
                                   const float* k_s, const float* v_s, const int* valid, void* o,
                                   int L, int B, int Hq, int Hkv, int Smax, int D, int layer,
                                   float sm_scale, void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k_cache, v_cache, k_s, v_s,      valid, nullptr, o, B, Hkv, Smax,
               layer, 0,       0,       0,   sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<int8_t, false>(a, L, Hq, D);
}

// Paged (B6): q/o [B,Hq,1,D] bf16 contiguous; k/v pools [L,Hkv,NP,P,D] bf16
// contiguous; table [B,MP] int32 contiguous, every entry in [0, NP);
// valid [B,MP*P] int32 contiguous over logical columns; 0 <= layer < L.
extern "C" int mmu_paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                     const int* valid, const int* table, void* o, int L, int B,
                                     int Hq, int Hkv, int NP, int P, int MP, int D, int layer,
                                     float sm_scale, void* stream) {
  const Args a{q,     k_pool, v_pool, nullptr, nullptr,  valid, table, o, B, Hkv, MP * P,
               layer, MP,     P,      NP,      sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<__nv_bfloat16, true>(a, L, Hq, D);
}

// As mmu_paged_decode_bf16 on int8 pools with f32 scales k_s, v_s
// [L,Hkv,NP,1,P], all contiguous (B6q).
extern "C" int mmu_paged_decode_q8(const void* q, const void* k_pool, const void* v_pool,
                                   const float* k_s, const float* v_s, const int* valid,
                                   const int* table, void* o, int L, int B, int Hq, int Hkv,
                                   int NP, int P, int MP, int D, int layer, float sm_scale,
                                   void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k_pool, v_pool, k_s, v_s,      valid, table, o, B, Hkv, MP * P,
               layer, MP,     P,      NP,  sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<int8_t, true>(a, L, Hq, D);
}
