// Verify-chunk attention (kernels B5, B5q, B7 and B7q) for Hopper: C query
// tokens per batch row against layer `layer` of a KV cache read in place.
// Two cache layouts share one kernel body:
//   dense (B5, B5q): the stacked cache read through element strides (a
//     slot's or a prefill slab's columns are views);
//   paged (B7, B7q): a pool of pages [L,Hkv,NP,P,D] shared by all rows with
//     a block table [B,MP]: row b's logical column j lives at pool page
//     table[b, j/P], offset j%P (Smax = MP*P logical columns).
// The cache is bf16 (B5, B7) or int8 with f32 scales, one per position and
// kv-head, the position axis contiguous (B5q, B7q).
//
// Replaces multimodal_unlearning_tpu/ops/decode_attention.py:_chunk_kernel
// (B5) and :_chunk_kernel_q8 (B5q) (launcher _pallas_chunk_decode), and
// multimodal_unlearning_tpu/ops/paged_attention.py:_paged_chunk_kernel (B7)
// and :_paged_chunk_kernel_q8 (B7q) (launcher paged_chunk_decode_attention).
// Row b's queries sit at logical columns offset[b] .. offset[b]+C-1, already
// written;
// query c sees column j iff
//   valid[b,j] != 0  ||  offset[b] <= j <= offset[b] + c,
// so the accepted prefix is admitted by `valid` alone, the chunk is causal
// within itself, and stale columns (rejected drafts past the chunk, left
// padding below offset) stay invisible.  It computes
//   o[b,h,c] = softmax_j(sm_scale q[b,h,c].k[j]) v[j]  over the visible j,
// and on an int8 cache keeps the scales outside both products, as the TPU
// kernel does: s_j = (q.K_int[j]) k_s[j], and the probabilities are scaled
// by v_s[j] before the second product, o = sum_j (p_j v_s[j]) V_int[j] /
// sum_j p_j.  int8 -> bf16 is exact, so the products see the stored
// integers.  A row that sees nothing (possible only with offset[b] >= Smax)
// gives o = 0.
//
// Design: the JAX kernel scores a whole [G*C, Smax] panel in one pass; at
// C = 512 and Smax = 2048 that panel is 4 MB of f32, far past a Hopper
// block.  This kernel is B1's tiling instead: one block of 4 warps per (64
// query rows, kv-head, batch row), the GQA group folded into the rows as
// m = g*C + c so that a block's K/V tiles serve its whole group; 64-column
// K/V tiles stream through shared memory (int8 tiles converted to bf16 on
// the way in); WMMA 16x16x16 bf16 products with f32 accumulation; an
// online softmax in the log2 domain with the scores and the output
// accumulator in shared memory.  A tile whose columns no row can see is
// skipped before its keys are loaded, and within a tile an invisible column
// is not loaded at all (zeros are stored in its place).  On a paged cache the
// block keeps its row of the block table in shared memory and resolves each
// tile column through it to its row of the pool while it decides the
// column's visibility, so a 64-column tile may span pages of any size (P =
// 16 or 32: 4 or 2 pages; P >= 64: one page); the visibility rule uses
// logical columns, and tiles past both the valid prefix and the chunk (and
// all-invalid gap pages) are skipped like any invisible tile.  Everything
// after the address is the dense kernel's arithmetic, in the same order.
//
// What bounds it on the card: two regimes share it.  The speculative verify
// round (C = K+1 = 5, 8 rows) reads each row's visible K/V once and does 4D
// flops per visible (query, column) pair: it is bound by bytes, like B4, and
// the 64-row tiles are mostly padding there (compute is not what limits it).
// A chunked-prefill or prefix-suffix pass (C = 512, one row, a slab of
// 1,536 columns) does ~4D flops per pair on 512 queries: bound by the tensor
// cores, where the shared-memory round trips of the WMMA layout cost what
// they cost B1.  mma.sync/wgmma with register accumulators, and fewer rows
// per block for small C, are later work.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // query rows (m = g*C + c) per block
constexpr int BK = 64;  // cache columns per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;

template <int D>
struct Layout {
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
  static constexpr size_t flag_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t ks_off = flag_off + sizeof(int) * BK;
  static constexpr size_t vs_off = ks_off + sizeof(float) * BK;
  static constexpr size_t crow_off = vs_off + sizeof(float) * BK;
  static constexpr size_t row_off = crow_off + sizeof(int) * BQ;
  static constexpr size_t table_off = row_off + sizeof(int) * BK;
  static constexpr size_t bytes = table_off;  // + MP ints of block table (paged)
};

// One 16-byte word of a cache row -> bf16 in shared memory.
template <typename T>
struct Row16;
template <>
struct Row16<__nv_bfloat16> {
  static constexpr int kPerWord = 8;  // elements in 16 bytes
  static constexpr bool kQ8 = false;
  static __device__ __forceinline__ void store(const uint4& w, __nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = w;
  }
};
template <>
struct Row16<int8_t> {
  static constexpr int kPerWord = 16;
  static constexpr bool kQ8 = true;
  static __device__ __forceinline__ void store(const uint4& w, __nv_bfloat16* dst) {
    const int8_t* v = reinterpret_cast<const int8_t*>(&w);
    uint4 lo, hi;  // int8 -> bf16 is exact
    __nv_bfloat162* pl = reinterpret_cast<__nv_bfloat162*>(&lo);
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pl[i] = __floats2bfloat162_rn(static_cast<float>(v[2 * i]),
                                    static_cast<float>(v[2 * i + 1]));
      ph[i] = __floats2bfloat162_rn(static_cast<float>(v[8 + 2 * i]),
                                    static_cast<float>(v[9 + 2 * i]));
    }
    *reinterpret_cast<uint4*>(dst) = lo;
    *reinterpret_cast<uint4*>(dst + 8) = hi;
  }
};

struct Args {
  const void* q;
  const void *kc, *vc;
  const float *ks, *vs;
  const int* valid;
  const int* offset;
  void* o;
  int B, Hq, Hkv, C, Smax, layer;
  long long sL, sB, sH, sS;  // cache element strides (D contiguous)
  long long tL, tB, tH;      // scale element strides (positions contiguous)
  float sm_scale;
  cudaStream_t stream;
  const int* table;  // paged only: [B,MP] block table of pages of P columns
  int MP, P;
};

// PAGED: the strides describe the pool [L,Hkv,NP,P,D] seen as [L,1,Hkv,NP*P,D]
// (cB = tB = 0), and a logical column j is read at pool row
// table[b, j/P]*P + j%P; dense: at row j of the strided view.
template <typename T, int D, bool PAGED>
__global__ void __launch_bounds__(NTHREADS)
chunk_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ valid,
                    const int* __restrict__ offset, const int* __restrict__ table,
                    __nv_bfloat16* __restrict__ o, int Hq, int G, int C, int Smax, int layer,
                    long long cL, long long cB, long long cH, long long cS, long long tL,
                    long long tB, long long tH, int MP, int P, float scale_log2) {
  using L = Layout<D>;
  using E = Row16<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  int* sFlag = reinterpret_cast<int*>(smem + L::flag_off);  // 1 valid, 2 in-chunk only
  float* sKs = reinterpret_cast<float*>(smem + L::ks_off);
  float* sVs = reinterpret_cast<float*>(smem + L::vs_off);
  int* sCrow = reinterpret_cast<int*>(smem + L::crow_off);  // chunk index c of a row, -1 pad
  int* sRow = reinterpret_cast<int*>(smem + L::row_off);  // cache row of a tile column
  int* sTable = reinterpret_cast<int*>(smem + L::table_off);  // [MP] (paged)

  const int m0 = blockIdx.x * BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int M = G * C;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;
  const bool warp_live = m0 + r0 < M;

  const int off = offset[b];
  const int* vrow = valid + static_cast<long long>(b) * Smax;
  const long long kvbase = layer * cL + b * cB + hk * cH;
  const T* kb = kc + kvbase;
  const T* vb = vc + kvbase;
  const float* ksr = E::kQ8 ? ks + layer * tL + b * tB + hk * tH : nullptr;
  const float* vsr = E::kQ8 ? vs + layer * tL + b * tB + hk * tH : nullptr;

  // the block's query rows: m = g*C + c -> q[b, hk*G + g, c]
  constexpr int CPR = D / 8;  // 16-byte bf16 chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < BQ * CPR; i += NTHREADS) {
    const int r = i / CPR, cc = i % CPR;
    const int m = m0 + r;
    uint4 w = zero;
    if (m < M) {
      const long long row = (static_cast<long long>(b) * Hq + hk * G + m / C) * C + m % C;
      w = *reinterpret_cast<const uint4*>(q + row * D + cc * 8);
    }
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + cc * 8) = w;
  }
  for (int r = tid; r < BQ; r += NTHREADS) sCrow[r] = m0 + r < M ? (m0 + r) % C : -1;
  for (int i = tid; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;
  if (PAGED)  // this row's block table (no scalar prefetch on this card)
    for (int i = tid; i < MP; i += NTHREADS) sTable[i] = table[static_cast<long long>(b) * MP + i];

  float m_r[16], l_r[16];
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    m_r[rr] = mmu::kNegInf;
    l_r[rr] = 0.f;
  }
  __syncthreads();

  // the last chunk column any row of this block may see
  const int m_last = min(M, m0 + BQ) - 1;
  const int c_max = (m0 / C == m_last / C) ? m_last % C : C - 1;
  const long long chunk_hi = static_cast<long long>(off) + c_max;

  constexpr int WPR = D / E::kPerWord;  // 16-byte cache words per row
  for (int k0 = 0; k0 < Smax; k0 += BK) {
    int any = 0;
    for (int i = tid; i < BK; i += NTHREADS) {
      const int j = k0 + i;
      int f = 0;
      if (j < Smax) f = vrow[j] != 0 ? 1 : (j >= off && j <= chunk_hi ? 2 : 0);
      sFlag[i] = f;
      sRow[i] = PAGED ? (f != 0 ? sTable[j / P] * P + j % P : 0) : j;
      any |= f;
    }
    if (!__syncthreads_or(any)) continue;  // no row sees any column of this tile

    // K and V tiles; an invisible column is stored as zeros, not loaded
    for (int i = tid; i < BK * WPR; i += NTHREADS) {
      const int r = i / WPR, w = i % WPR;
      uint4 kw = zero, vw = zero;
      if (sFlag[r] != 0) {
        const long long at = sRow[r] * cS + w * E::kPerWord;
        kw = *reinterpret_cast<const uint4*>(kb + at);
        vw = *reinterpret_cast<const uint4*>(vb + at);
      }
      E::store(kw, sK + r * L::LDQ + w * E::kPerWord);
      E::store(vw, sV + r * L::LDQ + w * E::kPerWord);
    }
    if (E::kQ8) {
      for (int i = tid; i < BK; i += NTHREADS) {
        const bool vis = sFlag[i] != 0;
        sKs[i] = vis ? ksr[sRow[i]] : 0.f;
        sVs[i] = vis ? vsr[sRow[i]] : 0.f;
      }
    }
    __syncthreads();

    // a warp whose 16 rows are all padding (C = 5: three of four) skips the
    // products and the softmax; it still loads tiles and meets every barrier
    if (warp_live) {
      // S = Q K^T for this warp's 16 rows x 64 columns
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

      // online softmax, one row at a time, two columns per lane
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int row = r0 + rr;
        const long long see_to = static_cast<long long>(off) + sCrow[row];  // in-chunk limit
        float s[2], pscale[2];
        bool ok[2];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int col = lane + 32 * t;
          const int f = sFlag[col];
          ok[t] = f == 1 || (f == 2 && k0 + col <= see_to);
          const float kscale = E::kQ8 ? sKs[col] : 1.f;
          pscale[t] = E::kQ8 ? sVs[col] : 1.f;
          s[t] = ok[t] ? sS[row * L::LDS + col] * kscale * scale_log2 : mmu::kNegInf;
        }
        const float m_new = fmaxf(m_r[rr], mmu::warp_max(fmaxf(s[0], s[1])));
        const float p0 = ok[0] ? exp2f(s[0] - m_new) : 0.f;
        const float p1 = ok[1] ? exp2f(s[1] - m_new) : 0.f;
        const float alpha = exp2f(m_r[rr] - m_new);
        l_r[rr] = l_r[rr] * alpha + mmu::warp_sum(p0 + p1);
        m_r[rr] = m_new;
        // the value scale multiplies p before the second product
        sP[row * L::LDP + lane] = __float2bfloat16(p0 * pscale[0]);
        sP[row * L::LDP + lane + 32] = __float2bfloat16(p1 * pscale[1]);
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
    }  // warp_live
    __syncthreads();  // the tiles, flags and scales are overwritten next
  }
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int row = r0 + rr;
    const int m = m0 + row;
    if (m >= M) continue;
    const float l = l_r[rr];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const long long orow = (static_cast<long long>(b) * Hq + hk * G + m / C) * C + m % C;
    __nv_bfloat16* op = o + orow * D;
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 f = make_float2(sO[row * L::LDO + d] * inv, sO[row * L::LDO + d + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(op + d) = __float22bfloat162_rn(f);
    }
  }
}

template <typename T, int D, bool PAGED>
int launch(const Args& a) {
  const size_t bytes = Layout<D>::bytes + (PAGED ? sizeof(int) * a.MP : 0);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mmu::allow_smem(chunk_decode_kernel<T, D, PAGED>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.Hq / a.Hkv;
  const dim3 grid((G * a.C + BQ - 1) / BQ, a.Hkv, a.B);
  chunk_decode_kernel<T, D, PAGED><<<grid, NTHREADS, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.ks, a.vs, a.valid, a.offset, a.table,
      static_cast<__nv_bfloat16*>(a.o), a.Hq, G, a.C, a.Smax, a.layer, a.sL, a.sB, a.sH, a.sS,
      a.tL, a.tB, a.tH, a.MP, a.P, a.sm_scale * mmu::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool PAGED>
int dispatch(const Args& a, int D) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B <= 0 || a.C <= 0 || a.Smax <= 0 || a.layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (a.table == nullptr || a.P <= 0 || a.MP <= 0 || a.MP * a.P != a.Smax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128) return launch<T, 128, PAGED>(a);
  if (D == 64) return launch<T, 64, PAGED>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* kc, const void* vc, const float* ks, const float* vs,
               const int* valid, const int* offset, void* o, int B, int Hq, int Hkv, int C,
               int Smax, int layer, long long sL, long long sB, long long sH, long long sS,
               long long tL, long long tB, long long tH, float sm_scale, void* stream) {
  return Args{q,  kc, vc, ks, vs, valid, offset, o,  B,  Hq,       Hkv,
              C,  Smax, layer, sL, sB, sH, sS, tL, tB, tH, sm_scale,
              static_cast<cudaStream_t>(stream), nullptr, 0, 0};
}

// The paged pool [L,Hkv,NP,P,D] (contiguous) as strides of the kernel's
// [L,1,Hkv,NP*P,D] view, and its scales [L,Hkv,NP,1,P] likewise.
Args paged_args(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
                const int* valid, const int* offset, const int* table, void* o, int B, int Hq,
                int Hkv, int C, int NP, int P, int MP, int D, int layer, float sm_scale,
                void* stream) {
  const long long rows = static_cast<long long>(NP) * P;
  Args a = make_args(q, kp, vp, ks, vs, valid, offset, o, B, Hq, Hkv, C, MP * P, layer,
                     Hkv * rows * D, 0, rows * D, D, Hkv * rows, 0, rows, sm_scale, stream);
  a.table = table;
  a.MP = MP;
  a.P = P;
  return a;
}

}  // namespace

// q/o [B,Hq,C,D] bf16 contiguous; k/v: layer `layer` of a bf16 cache with
// element strides (sL, sB, sH, sS) and D contiguous, rows 16-byte aligned;
// valid [B,Smax] int32 contiguous; offset [B] int32.  The scale arguments
// are unused (pass null and zeros).
extern "C" int mmu_chunk_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                                     const float* k_s, const float* v_s, const int* valid,
                                     const int* offset, void* o, int B, int Hq, int Hkv, int C,
                                     int Smax, int D, int layer, long long sL, long long sB,
                                     long long sH, long long sS, long long tL, long long tB,
                                     long long tH, float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(
      make_args(q, k_cache, v_cache, nullptr, nullptr, valid, offset, o, B, Hq, Hkv, C, Smax,
                layer, sL, sB, sH, sS, 0, 0, 0, sm_scale, stream),
      D);
}

// As mmu_chunk_decode_bf16 on an int8 cache with f32 scales k_s, v_s of
// element strides (tL, tB, tH) over (layer, row, kv-head), positions
// contiguous.
extern "C" int mmu_chunk_decode_q8(const void* q, const void* k_cache, const void* v_cache,
                                   const float* k_s, const float* v_s, const int* valid,
                                   const int* offset, void* o, int B, int Hq, int Hkv, int C,
                                   int Smax, int D, int layer, long long sL, long long sB,
                                   long long sH, long long sS, long long tL, long long tB,
                                   long long tH, float sm_scale, void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t, false>(make_args(q, k_cache, v_cache, k_s, v_s, valid, offset, o, B,
                                           Hq, Hkv, C, Smax, layer, sL, sB, sH, sS, tL, tB, tH,
                                           sm_scale, stream),
                                 D);
}

// Paged (B7): q/o [B,Hq,C,D] bf16 contiguous; k/v pools [L,Hkv,NP,P,D] bf16
// contiguous; valid [B,MP*P] int32 contiguous over logical columns; offset
// [B] int32 logical columns; table [B,MP] int32 contiguous, every entry in
// [0, NP).  The scale arguments are unused (pass null).
extern "C" int mmu_paged_chunk_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const float* k_s, const float* v_s, const int* valid,
                                    const int* offset, const int* table, void* o, int B, int Hq,
                                    int Hkv, int C, int NP, int P, int MP, int D, int layer,
                                    float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16, true>(
      paged_args(q, k_pool, v_pool, nullptr, nullptr, valid, offset, table, o, B, Hq, Hkv, C, NP,
                 P, MP, D, layer, sm_scale, stream),
      D);
}

// As mmu_paged_chunk_bf16 on int8 pools with f32 scales k_s, v_s
// [L,Hkv,NP,1,P], contiguous (B7q).
extern "C" int mmu_paged_chunk_q8(const void* q, const void* k_pool, const void* v_pool,
                                  const float* k_s, const float* v_s, const int* valid,
                                  const int* offset, const int* table, void* o, int B, int Hq,
                                  int Hkv, int C, int NP, int P, int MP, int D, int layer,
                                  float sm_scale, void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t, true>(paged_args(q, k_pool, v_pool, k_s, v_s, valid, offset, table, o,
                                           B, Hq, Hkv, C, NP, P, MP, D, layer, sm_scale, stream),
                                D);
}
