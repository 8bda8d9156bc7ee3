// Flash-decode (kernels B4, B4q, B6 and B6q) for Hopper: one query token per
// (batch row, q-head) against layer `layer` of a KV cache read in place (no
// layer slab is copied out).  Two cache layouts share one kernel body:
//   dense (B4, B4q): the stacked [L,B,Hkv,Smax,D] cache;
//   paged (B6, B6q): one pool of pages [L,Hkv,NP,P,D] shared by all rows,
//     with a block table [B,MP]: row b's logical column j lives at pool page
//     table[b, j/P], offset j%P (Smax = MP*P logical columns).
// The kernel looks at the first S <= Smax logical columns of each row only:
// columns at and past S are not attended (a caller that knows every row's
// extent, as the serving engine does, passes a mask narrowed to it).
// The cache is bf16 (B4, B6) or int8 with f32 scales, one per position and
// kv-head, the position on the last axis: [L,B,Hkv,1,Smax] dense,
// [L,Hkv,NP,1,P] paged (B4q, B6q); B4 also has an f32 instance, an f32
// query and output on an f32 cache (ECO's f32 decode steps), whose lanes
// hold 4 floats of 16 bytes and otherwise run the bf16 body.
//
// Replaces multimodal_unlearning_tpu/ops/decode_attention.py:_kernel (B4)
// and :_kernel_q8 (B4q) (launcher _pallas_decode), and
// multimodal_unlearning_tpu/ops/paged_attention.py:_paged_kernel (B6) and
// :_paged_kernel_q8 (B6q) (launcher _pallas_paged).  It computes
//   o[b,h] = softmax_j(sm_scale q[b,h].k[l,b,h//G,j]) v[l,b,h//G,j]
// over the logical columns j < S with valid[b,j] != 0.  On an int8 cache the scales
// stay outside both dot products, as in the TPU kernel:
//   s_j = (q.K_int[j]) k_s[j],   o = sum_j (p_j v_s[j]) V_int[j] / sum_j p_j,
// so no dequantized K or V is ever formed.  A row with no valid column
// gives o = 0 -- the documented rule for fully-masked rows, which the XLA
// path of decode_attention follows; the Pallas kernels return the mean of
// V there instead.
//
// What bounds it on the card: it streams the valid K and V columns once
// (bytes), with 2 flops per loaded element -- far below the card's
// operations-per-byte ridge.  The design serves bandwidth only:
//   - split-K over logical columns: the columns [0, S) of each row are cut
//     into `splits` runs of `per` (ops/decode_attention.decode_split_plan, a
//     pure function of shapes), one block per (kv-head, row, run), so that
//     the engine's ragged rows do not leave the card idle behind the Hkv
//     blocks of the longest row.  Each block compacts only its run's valid
//     columns into shared memory (on a paged cache resolving each through the
//     block table into its row of the pool: pages past the row's extent and
//     all-invalid gap pages are never touched); a run with no valid column
//     writes l = 0 and stops there, which is what makes the split cheap on
//     short rows;
//   - every group of lanes scores one key with 16-byte loads (a whole key row
//     per group, coalesced: 8 bf16 dims a lane, or 16 int8 dims at GQA groups
//     of 1-2, so an int8 warp keeps as many bytes in flight as a bf16 one;
//     the lane layout is a function of D alone, and a lane loops over the G
//     q-heads of its kv-head, so any G works, Qwen2-VL-2B's 6 included:
//     G = 1, 2, 4, 6 and 8 are instantiated, and no head is padded)
//     while each warp keeps 4 key groups of K and V loads in flight (on a
//     bf16 cache at GQA groups of 1-2 the next 4 too while it scores these),
//     with an online softmax per lane group in the log2 domain.  int8 values
//     become f32 by a byte permute and one subtraction, not the quarter-rate
//     int-to-float conversion.  The per-group states are merged in shared
//     memory into the run's f32 partial (m, l, unnormalised o).  The GQA
//     group (G q-heads per kv-head) shares every loaded byte;
//   - the last block of each (row, kv-head) to finish (a self-resetting
//     counter in a persistent buffer) merges the runs' partials in run order
//     by the log-sum-exp rule (decode_attention.chunk_attention_split_reference
//     states it); with one split the block writes the output directly.
// The paged instances run the dense instances' arithmetic in the same order
// on the same plan, so a paged row gives the dense row's result bit for bit.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;  // key groups a warp keeps in flight per iteration

// 4 int8 values of one word -> f32, exactly, without the quarter-rate
// int-to-float conversion: b ^ 0x80 = b + 128 placed in the mantissa of
// 2^23 gives the float 2^23 + 128 + b, and one subtraction leaves b.
__device__ __forceinline__ void i8x4_to_float(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// DL cache elements of one lane: 16 bytes of bf16 (8) or of int8 (16), or 8
// bytes of int8 (8, at GQA groups of 3 and more, where 16 dims a lane would
// take too many registers)
template <typename T, int DL>
struct Lane;
template <>
struct Lane<__nv_bfloat16, 8> {
  using Word = uint4;
  static constexpr bool kQ8 = false;
  static __device__ __forceinline__ Word zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void to_float(const Word& w, float* out) {
    mmu::bf16x8_to_float(w, out);
  }
};
template <>
struct Lane<float, 4> {
  using Word = uint4;
  static constexpr bool kQ8 = false;
  static __device__ __forceinline__ Word zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void to_float(const Word& w, float* out) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  }
};
template <>
struct Lane<int8_t, 8> {
  using Word = uint2;
  static constexpr bool kQ8 = true;
  static __device__ __forceinline__ Word zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ void to_float(const Word& w, float* out) {
    i8x4_to_float(w.x, out);
    i8x4_to_float(w.y, out + 4);
  }
};
template <>
struct Lane<int8_t, 16> {
  using Word = uint4;
  static constexpr bool kQ8 = true;
  static __device__ __forceinline__ Word zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void to_float(const Word& w, float* out) {
    i8x4_to_float(w.x, out);
    i8x4_to_float(w.y, out + 4);
    i8x4_to_float(w.z, out + 8);
    i8x4_to_float(w.w, out + 12);
  }
};

template <typename T, int G>
constexpr int lane_dims() {
  return sizeof(T) == 4 ? 4 : sizeof(T) == 1 && G <= 2 ? 16 : 8;
}

// the query and the output are f32 beside an f32 cache, bf16 otherwise; a
// lane loads its N dims of a query row with 16-byte loads
template <typename T>
struct QO {
  using type = __nv_bfloat16;
  template <int N>
  static __device__ __forceinline__ void load(const type* p, float* out) {
#pragma unroll
    for (int h = 0; h < N / 8; ++h)
      mmu::bf16x8_to_float(*reinterpret_cast<const uint4*>(p + h * 8), out + h * 8);
  }
  static __device__ __forceinline__ void store(type* p, float x) { *p = __float2bfloat16(x); }
};
template <>
struct QO<float> {
  using type = float;
  template <int N>
  static __device__ __forceinline__ void load(const type* p, float* out) {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 w = *reinterpret_cast<const float4*>(p + h * 4);
      out[h * 4] = w.x;
      out[h * 4 + 1] = w.y;
      out[h * 4 + 2] = w.z;
      out[h * 4 + 3] = w.w;
    }
  }
  static __device__ __forceinline__ void store(type* p, float x) { *p = x; }
};

template <typename T, int D, int G>
struct DecLayout {
  static constexpr int DL = lane_dims<T, G>();
  static constexpr int LPK = D / DL;    // lanes per key
  static constexpr int KPW = 32 / LPK;  // keys a warp scores at once
  static constexpr int NSLOT = NWARPS * KPW;
  static size_t bytes(int per) { return sizeof(int) * per + sizeof(float) * NSLOT * G * (2 + D); }
};

struct Args {
  const void* q;  // bf16, or f32 beside an f32 cache
  const void *kc, *vc;
  const float *ks, *vs;
  const int* valid;
  const int* table;  // paged only
  void* o;
  float* ws;      // [splits,B,Hq,D+2] f32 partials: o (unnormalised), m, l (splits > 1)
  int* counters;  // [B*Hkv], 0 between calls (splits > 1)
  int B, Hkv, Smax, layer;
  int S, vstride;  // columns looked at (S <= Smax); valid's row stride
  int MP, P, NP;  // paged only
  int per, splits;
  float scale_log2;
};

// PAGED: `table` is the [B,MP] block table of a pool of NP pages of P
// columns (Smax = MP*P); otherwise table is null and MP, P, NP unused.
template <typename T, int D, int G, bool PAGED>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(const Args a) {
  using L = DecLayout<T, D, G>;
  using E = Lane<T, L::DL>;
  using Q = QO<T>;
  const auto* q = static_cast<const typename Q::type*>(a.q);
  auto* o = static_cast<typename Q::type*>(a.o);
  constexpr int DL = L::DL;
  constexpr int LPK = L::LPK;
  constexpr int KPW = L::KPW;
  extern __shared__ __align__(16) unsigned char smem[];
  // [per] compacted valid columns of this run, each as its row in the
  // layer's K/V rows of this (row, kv-head): the logical column (dense) or
  // page*P + offset in the pool (paged)
  int* sIdx = reinterpret_cast<int*>(smem);
  float* sM = reinterpret_cast<float*>(sIdx + a.per);  // [NSLOT][G]
  float* sL = sM + L::NSLOT * G;                       // [NSLOT][G]
  float* sAcc = sL + L::NSLOT * G;                     // [NSLOT][G][D]
  __shared__ int sCount[NWARPS];
  __shared__ int sLast;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int Hq = a.Hkv * G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane / LPK;   // which of the warp's KPW keys
  const int part = lane % LPK;  // which DL dims of the key
  const int slot = warp * KPW + sub;
  const int c0 = split * a.per, c1 = min(a.S, c0 + a.per);
  const long long qrow = static_cast<long long>(b) * Hq + hk * G;  // first q-head row

  // 1. compact the run's valid columns (ascending) into sIdx
  const int* vrow = a.valid + static_cast<long long>(b) * a.vstride;
  const int* trow = PAGED ? a.table + static_cast<long long>(b) * a.MP : nullptr;
  int nvalid = 0;
  for (int base = c0; base < c1; base += NTHREADS) {
    const int c = base + tid;
    const int flag = c < c1 && vrow[c] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) sCount[warp] = __popc(ballot);
    __syncthreads();
    int off = nvalid, total = 0;
    for (int w = 0; w < NWARPS; ++w) {
      if (w < warp) off += sCount[w];
      total += sCount[w];
    }
    if (flag)
      sIdx[off + __popc(ballot & ((1u << lane) - 1u))] =
          PAGED ? __ldg(trow + c / a.P) * a.P + c % a.P : c;
    nvalid += total;
    __syncthreads();  // sCount is rewritten next round
  }

  if (nvalid > 0) {
    // 2. this lane's DL dims of the G queries, scaled into the log2 domain
    float qv[G][DL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Q::template load<DL>(q + (qrow + g) * D + part * DL, qv[g]);
#pragma unroll
      for (int e = 0; e < DL; ++e) qv[g][e] *= a.scale_log2;
    }

    // 3. online softmax over this lane group's share of the run's columns
    float m[G], l[G], acc[G][DL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = mmu::kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
    }
    // the first of this (layer, row, kv-head)'s K/V rows that sIdx counts
    // from: its [Smax, D] slab (dense) or its head's [NP*P, D] pool (paged)
    const long long row0 =
        PAGED ? (static_cast<long long>(a.layer) * a.Hkv + hk) * a.NP * a.P
              : ((static_cast<long long>(a.layer) * a.B + b) * a.Hkv + hk) * a.Smax;
    const T* kb = static_cast<const T*>(a.kc) + row0 * D + part * DL;
    const T* vb = static_cast<const T*>(a.vc) + row0 * D + part * DL;
    // int8 cache: the scales of those rows, one per position
    const float* ksr = E::kQ8 ? a.ks + row0 : nullptr;
    const float* vsr = E::kQ8 ? a.vs + row0 : nullptr;
    // key group `base` of this lane group: K and V words, scales, in range
    auto fetch = [&](int base, typename E::Word(&kw)[UNROLL], typename E::Word(&vw)[UNROLL],
                     float(&kscale)[UNROLL], float(&vscale)[UNROLL], bool(&ok)[UNROLL]) {
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
    };
    // a bf16 or f32 cache at GQA groups of 1-2 fetches the next key group
    // while it scores this one; int8 lanes (twice the keys per load) and the
    // larger groups' queries and accumulators leave no registers for it
    constexpr bool PREFETCH = G <= 2 && sizeof(T) != 1;
    constexpr int STEP = NWARPS * KPW * UNROLL;
    typename E::Word kw[UNROLL], vw[UNROLL];
    float kscale[UNROLL], vscale[UNROLL];
    bool ok[UNROLL];
    if (PREFETCH) fetch(warp * KPW * UNROLL, kw, vw, kscale, vscale, ok);
    for (int base = warp * KPW * UNROLL; base < nvalid; base += STEP) {
      typename E::Word kn[UNROLL], vn[UNROLL];
      float kscn[UNROLL], vscn[UNROLL];
      bool okn[UNROLL];
      if constexpr (PREFETCH)
        fetch(base + STEP, kn, vn, kscn, vscn, okn);
      else
        fetch(base, kw, vw, kscale, vscale, ok);
      float s[UNROLL][G];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float kf[DL];
        E::to_float(kw[u], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part_dot = 0.f;
#pragma unroll
          for (int e = 0; e < DL; ++e) part_dot = fmaf(qv[g][e], kf[e], part_dot);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
          // the key's scale multiplies the finished dot product
          s[u][g] = ok[u] ? part_dot * kscale[u] : mmu::kNegInf;
        }
      }
      float pv[G][UNROLL];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) m_new = fmaxf(m_new, s[u][g]);
        const float alpha = exp2f(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float p = ok[u] ? exp2f(s[u][g] - m_new) : 0.f;
          psum += p;
          pv[g][u] = p * vscale[u];  // the value's scale multiplies p, outside the product
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float vf[DL];
        E::to_float(vw[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[g][e] = fmaf(pv[g][u], vf[e], acc[g][e]);
      }
      if constexpr (PREFETCH) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          kw[u] = kn[u];
          vw[u] = vn[u];
          kscale[u] = kscn[u];
          vscale[u] = vscn[u];
          ok[u] = okn[u];
        }
      }
    }

    // 4. merge the NSLOT partial states of each q-head into the run's
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (part == 0) {
        sM[slot * G + g] = m[g];
        sL[slot * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e) sAcc[(slot * G + g) * D + part * DL + e] = acc[g][e];
    }
  }
  __syncthreads();
  const size_t part_stride = static_cast<size_t>(a.B) * Hq * (D + 2);
  float* wrun = a.ws + split * part_stride;  // this run's partials (splits > 1)
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float mx = mmu::kNegInf, den = 0.f, num = 0.f;
    if (nvalid > 0) {
      for (int s2 = 0; s2 < L::NSLOT; ++s2) mx = fmaxf(mx, sM[s2 * G + g]);
      for (int s2 = 0; s2 < L::NSLOT; ++s2) {
        const float w = exp2f(sM[s2 * G + g] - mx);
        den += w * sL[s2 * G + g];
        num += w * sAcc[(s2 * G + g) * D + d];
      }
    }
    if (a.splits == 1) {
      Q::store(o + (qrow + g) * D + d, den > 0.f ? num / den : 0.f);
    } else {
      float* w = wrun + (qrow + g) * (D + 2);
      w[d] = num;
      if (d == 0) {
        w[D] = mx;
        w[D + 1] = den;
      }
    }
  }
  if (a.splits == 1) return;

  // 5. the last run of this (row, kv-head) to finish merges the runs' partials
  // (the barrier orders the block's partial stores before thread 0's release)
  __syncthreads();
  const int tile = b * a.Hkv + hk;
  if (tid == 0) sLast = mmu::atomic_add_acq_rel(a.counters + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!sLast) return;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    const float* w0 = a.ws + (qrow + g) * (D + 2);
    float mx = mmu::kNegInf;
    for (int sp = 0; sp < a.splits; ++sp) {
      const float* w = w0 + sp * part_stride;
      if (__ldcg(w + D + 1) > 0.f) mx = fmaxf(mx, __ldcg(w + D));
    }
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < a.splits; ++sp) {
      const float* w = w0 + sp * part_stride;
      const float ls = __ldcg(w + D + 1);
      if (ls > 0.f) {
        const float f = exp2f(__ldcg(w + D) - mx);
        den += f * ls;
        num += f * __ldcg(w + d);
      }
    }
    Q::store(o + (qrow + g) * D + d, den > 0.f ? num / den : 0.f);
  }
  if (tid == 0) a.counters[tile] = 0;
}

template <typename T, int D, int G, bool PAGED>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = DecLayout<T, D, G>::bytes(a.per);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mmu::allow_smem(flash_decode_kernel<T, D, G, PAGED>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.Hkv, a.B, a.splits);
  flash_decode_kernel<T, D, G, PAGED><<<grid, NTHREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool PAGED>
int launch_g(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1, PAGED>(a, st);
    case 2: return launch<T, D, 2, PAGED>(a, st);
    case 4: return launch<T, D, 4, PAGED>(a, st);
    case 6: return launch<T, D, 6, PAGED>(a, st);
    case 8: return launch<T, D, 8, PAGED>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool PAGED>
int dispatch(const Args& a, int L, int Hq, int D, void* stream) {
  if (a.Hkv <= 0 || Hq % a.Hkv != 0 || a.layer < 0 || a.layer >= L || a.B <= 0 || a.Smax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (a.table == nullptr || a.P <= 0 || a.MP <= 0 || a.NP <= 0 || a.MP * a.P != a.Smax))
    return static_cast<int>(cudaErrorInvalidValue);
  // runs of `per` columns cover [0, S) and none is empty
  if (a.S < 1 || a.S > a.Smax || a.vstride < a.S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.per < 1 || a.splits < 1 || static_cast<long long>(a.per) * a.splits < a.S ||
      static_cast<long long>(a.per) * (a.splits - 1) >= a.S ||
      (a.splits > 1 && (a.ws == nullptr || a.counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / a.Hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch_g<T, 128, PAGED>(G, a, st);
  if (D == 64) return launch_g<T, 64, PAGED>(G, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Arguments shared by the four launchers: the first S <= Smax logical
// columns of each row are looked at, valid [B,S] int32 with its columns
// contiguous and rows `vstride` ints apart (a narrowed view of a [B,Smax]
// mask); runs of `per` of them, `splits` runs (ops/decode_attention.
// decode_split_plan over S); with splits > 1, ws [splits,B,Hq,D+2] f32 and
// counters [B*Hkv] int32, all 0 (the kernel leaves them 0), on the launch's
// stream alone.
//
// q/o [B,Hq,1,D] bf16 contiguous; k/v cache [L,B,Hkv,Smax,D] bf16
// contiguous; 0 <= layer < L.
extern "C" int mmu_flash_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                                     const int* valid, void* o, float* ws, int* counters, int L,
                                     int B, int Hq, int Hkv, int Smax, int D, int layer, int S,
                                     int vstride, int per, int splits, float sm_scale,
                                     void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, valid,
               nullptr, o, ws, counters, B, Hkv, Smax, layer, S,
               vstride, 0, 0, 0, per, splits, sm_scale * mmu::kLog2e};
  return dispatch<__nv_bfloat16, false>(a, L, Hq, D, stream);
}

// As mmu_flash_decode_bf16 in f32 throughout: q/o [B,Hq,1,D] and the k/v
// cache [L,B,Hkv,Smax,D] f32 contiguous (B4's f32 instance, ECO's decode).
extern "C" int mmu_flash_decode_f32(const void* q, const void* k_cache, const void* v_cache,
                                    const int* valid, void* o, float* ws, int* counters, int L,
                                    int B, int Hq, int Hkv, int Smax, int D, int layer, int S,
                                    int vstride, int per, int splits, float sm_scale,
                                    void* stream) {
  const Args a{q, k_cache, v_cache, nullptr, nullptr, valid, nullptr, o, ws, counters, B, Hkv,
               Smax, layer, S, vstride, 0, 0, 0, per, splits, sm_scale * mmu::kLog2e};
  return dispatch<float, false>(a, L, Hq, D, stream);
}

// As mmu_flash_decode_bf16 on an int8 cache [L,B,Hkv,Smax,D] with f32 scales
// k_s, v_s [L,B,Hkv,1,Smax], all contiguous (B4q).
extern "C" int mmu_flash_decode_q8(const void* q, const void* k_cache, const void* v_cache,
                                   const float* k_s, const float* v_s, const int* valid, void* o,
                                   float* ws, int* counters, int L, int B, int Hq, int Hkv,
                                   int Smax, int D, int layer, int S, int vstride, int per,
                                   int splits, float sm_scale, void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_cache, v_cache, k_s, v_s, valid, nullptr,
               o, ws, counters, B, Hkv, Smax, layer, S, vstride, 0,
               0, 0, per, splits, sm_scale * mmu::kLog2e};
  return dispatch<int8_t, false>(a, L, Hq, D, stream);
}

// Paged (B6): q/o [B,Hq,1,D] bf16 contiguous; k/v pools [L,Hkv,NP,P,D] bf16
// contiguous; table [B,MP] int32 contiguous, every entry in [0, NP);
// valid over logical columns (S <= MP*P); 0 <= layer < L.
extern "C" int mmu_paged_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                     const int* valid, const int* table, void* o, float* ws,
                                     int* counters, int L, int B, int Hq, int Hkv, int NP, int P,
                                     int MP, int D, int layer, int S, int vstride, int per,
                                     int splits, float sm_scale, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, valid,
               table, o, ws, counters, B, Hkv, MP * P, layer, S,
               vstride, MP, P, NP, per, splits, sm_scale * mmu::kLog2e};
  return dispatch<__nv_bfloat16, true>(a, L, Hq, D, stream);
}

// As mmu_paged_decode_bf16 on int8 pools with f32 scales k_s, v_s
// [L,Hkv,NP,1,P], all contiguous (B6q).
extern "C" int mmu_paged_decode_q8(const void* q, const void* k_pool, const void* v_pool,
                                   const float* k_s, const float* v_s, const int* valid,
                                   const int* table, void* o, float* ws, int* counters, int L,
                                   int B, int Hq, int Hkv, int NP, int P, int MP, int D,
                                   int layer, int S, int vstride, int per, int splits,
                                   float sm_scale, void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_s, v_s, valid, table,
               o, ws, counters, B, Hkv, MP * P, layer, S, vstride,
               MP, P, NP, per, splits, sm_scale * mmu::kLog2e};
  return dispatch<int8_t, true>(a, L, Hq, D, stream);
}
