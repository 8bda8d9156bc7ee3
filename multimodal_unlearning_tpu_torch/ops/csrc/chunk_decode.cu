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
// written; query c sees column j iff
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
// What bounds it on the card, and the design.  The GQA group is folded into
// the rows, m = g*C + c, so that one K/V tile serves the whole group; the M
// = G*C rows of a (batch row, kv-head) meet the cache's columns in 64-column
// tiles.  Two regimes:
//   - long chunks (M > 32: chunked prefill and prefix suffixes, C = 512):
//     ~4D flops per visible (query, column) pair on 512 queries, bound by
//     the tensor cores (512 queries behind 1,024 columns: 10.7 GFLOP on 34
//     MB, 0.0109 ms at the bf16 peak).  B1's core: one block of 4 warps per 64 rows, each
//     warp 16 rows, its score tile S and output accumulator O in registers
//     in the mma.sync layout, masks, scales and alpha applied by each thread
//     to the entries it holds, P passed from the C to the A fragment in
//     registers.
//   - short chunks (M <= 32: the speculative verify round, C = K+1 = 5; 20
//     rows under GQA): 4D flops per pair on a handful of queries, bound by
//     the bytes of the visible K/V columns, like decode (8 rows, 32 heads:
//     ~162 MB, 0.0485 ms at 3.35 TB/s).  A block holds one
//     or two m16 row tiles, and each of its 4 warps takes 16 of every
//     tile's 64 columns for those rows, so no warp idles and none repeats
//     another's products.  The columns are also split across blocks
//     (split-KV, `per` logical columns each, chunk_split_plan in
//     ops/decode_attention.py) so that B x Hkv x splits blocks fill the
//     card.  Each warp of each split writes its f32 partial (unnormalised o,
//     running max m in the log2 domain, sum l) to scratch, and a second
//     kernel in the same call merges the partials by the log-sum-exp rule
//     in a fixed order, with no atomics.
// In both, K/V tiles arrive through a ring of cp.async stages, the next live
// tiles' copies in flight during this tile's products; an invisible column is
// zero-filled by the copy itself (src-size 0), not read; a tile no row of the
// block can see is never copied.  Before any copy the block reads its split's
// visibility once into shared memory (a flag byte per column) and lists its
// live tiles, so no copy waits on a global read.  An int8 tile is copied as
// bytes and converted to bf16 once per tile in shared memory, so every warp
// reads its fragments with ldmatrix.  On a paged cache the block keeps its row
// of the block table in shared memory and resolves each column through it
// (a shift and a mask for the power-of-two page sizes) while it copies the
// column, so a tile may span pages of any size; everything else is the dense
// arithmetic in the same order, and the split plan is in logical columns, so
// the paged kernels equal the dense ones bit for bit on the same columns.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int TILE = 64;  // the split plan's column alignment (chunk_split_plan)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kQ8 = false;
  static constexpr int kPerWord = 8;  // elements in 16 bytes
};
template <>
struct Elem<int8_t> {
  static constexpr bool kQ8 = true;
  static constexpr int kPerWord = 16;
};

// RT m16 row tiles per block, tiles of BK cache columns, a ring of NS stages
template <typename T, int D, int RT, int BK, int NS>
struct Layout {
  static constexpr bool kQ8 = Elem<T>::kQ8;
  static constexpr int BR = 16 * RT;                            // query rows per block
  static constexpr int LD = D + 8;                              // bf16 per shared row
  static constexpr int RAW_LD = static_cast<int>(sizeof(T)) * D + 16;  // bytes per copied row
  static constexpr size_t raw_tile = static_cast<size_t>(BK) * RAW_LD;
  static constexpr size_t bf_tile = sizeof(__nv_bfloat16) * BK * LD;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BR * LD;  // NS stages
  static constexpr size_t v_off = k_off + NS * raw_tile;                     // NS stages
  static constexpr size_t cvt_off = v_off + NS * raw_tile;  // int8: K, V tiles in bf16
  static constexpr size_t scale_off = cvt_off + (kQ8 ? 2 * bf_tile : 0);  // int8: NS x (k_s, v_s)
  static constexpr size_t table_off = scale_off + (kQ8 ? sizeof(float) * NS * 2 * BK : 0);
  // + the block table (paged), the live-tile list, and a flag byte per column
  static size_t bytes(int MP, int n_tiles) {
    return table_off + sizeof(int) * (MP + n_tiles) + static_cast<size_t>(n_tiles) * BK;
  }
};

struct Args {
  const void* q;
  const void *kc, *vc;
  const float *ks, *vs;
  const int* valid;
  const int* offset;
  void* o;
  float* ws;  // f32 partials (more than one): o [parts,R,D] then (m, l) [parts,R,2]
  int B, Hq, Hkv, C, Smax, layer, per, splits;
  long long sL, sB, sH, sS;  // cache element strides (D contiguous)
  long long tL, tB, tH;      // scale element strides (positions contiguous)
  float sm_scale;
  cudaStream_t stream;
  const int* table;  // paged only: [B,MP] block table of pages of P columns
  int MP, P;
};

// CSPLIT: the short-chunk regime (RT <= 2 row tiles shared by the 4 warps,
// each warp 16 of a tile's 64 columns, its partial written as a split of its
// own); else the long one (RT = 4, a row tile per warp, all of a tile's columns).
// PAGED: the strides describe the pool [L,Hkv,NP,P,D] seen as
// [L,1,Hkv,NP*P,D] (cB = tB = 0), and a logical column j is read at pool row
// table[b, j/P]*P + j%P; dense: at row j of the strided view.
template <typename T, int D, bool PAGED, int RT, bool CSPLIT, int BK, int NS, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB)
chunk_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ valid,
                    const int* __restrict__ offset, const int* __restrict__ table,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ ws, int Hq, int G, int C,
                    int Smax, int layer, long long cL, long long cB, long long cH, long long cS,
                    long long tL, long long tB, long long tH, int MP, int P, int per, int splits,
                    float scale_log2) {
  using L = Layout<T, D, RT, BK, NS>;
  static_assert(!CSPLIT || BK == 64, "short chunks: 4 warps x 16 columns");
  constexpr bool kQ8 = L::kQ8;
  constexpr int LD = L::LD;
  constexpr int BR = L::BR;
  constexpr int NR = CSPLIT ? RT : 1;     // row tiles per warp
  constexpr int CW = CSPLIT ? 16 : BK;    // tile columns per warp
  constexpr bool QREG = !CSPLIT;          // Q fragments held in registers
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_live;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  unsigned char* sKr = smem + L::k_off;
  unsigned char* sVr = smem + L::v_off;
  __nv_bfloat16* sKc = reinterpret_cast<__nv_bfloat16*>(smem + L::cvt_off);
  __nv_bfloat16* sVc = sKc + BK * LD;
  float* sScale = reinterpret_cast<float*>(smem + L::scale_off);
  int* sTable = reinterpret_cast<int*>(smem + L::table_off);  // [MP] (paged)
  int* sList = sTable + (PAGED ? MP : 0);

  const int nrb = gridDim.x / splits;
  const int rb = blockIdx.x % nrb, sp = blockIdx.x / nrb;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int M = G * C;
  const int m0 = rb * BR;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int c_begin = sp * per;
  const int c_end = min(Smax, c_begin + per);

  const int off = offset[b];
  const int* vrow = valid + static_cast<long long>(b) * Smax;
  const long long kvbase = layer * cL + b * cB + hk * cH;
  const T* kb = kc + kvbase;
  const T* vb = vc + kvbase;
  const float* ksr = kQ8 ? ks + layer * tL + b * tB + hk * tH : nullptr;
  const float* vsr = kQ8 ? vs + layer * tL + b * tB + hk * tH : nullptr;

  // the last chunk column any row of this block may see
  const int m_last = min(M, m0 + BR) - 1;
  const int c_max = (m0 / C == m_last / C) ? m_last % C : C - 1;
  const long long chunk_hi = static_cast<long long>(off) + c_max;
  auto flag_of = [&](int j) -> int {
    if (j >= Smax) return 0;
    return vrow[j] != 0 ? 1 : (j >= off && j <= chunk_hi ? 2 : 0);
  };

  // the split's live tiles, in order, and each column's flag (1 valid, 2
  // in-chunk only, 0 invisible) for the copies and the masks
  const int nt = (c_end - c_begin + BK - 1) / BK;
  unsigned char* sColF = reinterpret_cast<unsigned char*>(sList + nt);
  // a logical column's row of the cache view (paged: through the table)
  const int pshift = PAGED && (P & (P - 1)) == 0 ? __ffs(P) - 1 : -1;
  auto row_of = [&](int j) -> long long {
    if (!PAGED) return j;
    if (pshift >= 0) return (static_cast<long long>(sTable[j >> pshift]) << pshift) | (j & (P - 1));
    return static_cast<long long>(sTable[j / P]) * P + j % P;
  };

  if (PAGED)  // this row's block table (no scalar prefetch on this card)
    for (int i = tid; i < MP; i += NTHREADS) sTable[i] = table[static_cast<long long>(b) * MP + i];
  for (int t = tid; t < nt; t += NTHREADS) sList[t] = 0;
  __syncthreads();
  for (int i = tid; i < nt * BK; i += NTHREADS) {
    const int j = c_begin + i;
    const int f = j < c_end ? flag_of(j) : 0;
    sColF[i] = static_cast<unsigned char>(f);
    if (f != 0) sList[i / BK] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < nt; ++t)
      if (sList[t]) sList[n++] = t;
    s_live = n;
  }

  // the K, V (and scales) of tile t into stage st; invisible columns zero-filled
  auto load_tile = [&](int st, int t) {
    const int k0 = c_begin + t * BK;
    const unsigned char* cf = sColF + t * BK;
    constexpr int WPR = D / Elem<T>::kPerWord;  // 16-byte words per cache row
    unsigned char* dk = sKr + st * L::raw_tile;
    unsigned char* dv = sVr + st * L::raw_tile;
    for (int i = tid; i < BK * WPR; i += NTHREADS) {
      const int r = i / WPR, w = i % WPR;
      const bool vis = cf[r] != 0;
      const long long at = (vis ? row_of(k0 + r) : 0) * cS + w * Elem<T>::kPerWord;
      mmu::cp_async16(dk + r * L::RAW_LD + w * 16, kb + at, vis ? 16 : 0);
      mmu::cp_async16(dv + r * L::RAW_LD + w * 16, vb + at, vis ? 16 : 0);
    }
    if (kQ8) {
      for (int i = tid; i < BK; i += NTHREADS) {
        const bool vis = cf[i] != 0;
        const long long row = vis ? row_of(k0 + i) : 0;
        mmu::cp_async4(sScale + st * 2 * BK + i, ksr + row, vis ? 4 : 0);
        mmu::cp_async4(sScale + st * 2 * BK + BK + i, vsr + row, vis ? 4 : 0);
      }
    }
  };

  // the block's query rows: m = g*C + c -> q[b, hk*G + g, c]; rows >= M zero
  for (int i = tid; i < BR * (D / 8); i += NTHREADS) {
    const int r = i / (D / 8), cc = i % (D / 8);
    const int m = m0 + r;
    const int mm = m < M ? m : 0;
    const long long row = (static_cast<long long>(b) * Hq + hk * G + mm / C) * C + mm % C;
    mmu::cp_async16(sQ + r * LD + cc * 8, q + row * D + cc * 8, m < M ? 16 : 0);
  }
  __syncthreads();  // s_live and the list
  const int n_live = s_live;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_live) load_tile(i, sList[i]);
    mmu::cp_async_commit();  // one group per stage, empty past the last tile
  }
  mmu::cp_async_wait<NS - 2>();
  __syncthreads();

  // each row's in-chunk limit, and (long regime) the warp's Q fragments
  uint32_t qf[QREG ? D / 16 : 1][4];
  long long see_to[NR][2];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int rt = CSPLIT ? i : warp;
    if constexpr (QREG) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mmu::ldmatrix_x4(qf[kk], sQ + (rt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + rt * 16 + gid + 8 * hf;
      see_to[i][hf] = static_cast<long long>(off) + (m < M ? m % C : -1);
    }
  }
  float oacc[NR][D / 8][4];
  float m_r[NR][2], l_r[NR][2];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[i][n][e] = 0.f;
    m_r[i][0] = m_r[i][1] = mmu::kNegInf;
    l_r[i][0] = l_r[i][1] = 0.f;
  }
  const int c0w = CSPLIT ? warp * CW : 0;  // the warp's first column in a tile
  // a warp whose 16 rows are all padding skips the products (long regime)
  const bool warp_live = CSPLIT || m0 + warp * 16 < M;

  for (int it = 0; it < n_live; ++it) {
    const int st = it % NS;
    // tile it+NS-1 into the stage tile it-1 held; in flight during the products
    if (it + NS - 1 < n_live) load_tile((it + NS - 1) % NS, sList[it + NS - 1]);
    mmu::cp_async_commit();
    const __nv_bfloat16* tk;
    const __nv_bfloat16* tv;
    if (kQ8) {
      // the stage's int8 bytes -> bf16 tiles, once per tile (exact)
      for (int i = tid; i < 2 * BK * (D / 16); i += NTHREADS) {
        const int tsel = i / (BK * (D / 16));
        const int rem = i - tsel * (BK * (D / 16));
        const int r = rem / (D / 16), w = rem % (D / 16);
        const unsigned char* src = (tsel ? sVr : sKr) + st * L::raw_tile + r * L::RAW_LD + w * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
        uint4 lo, hi;
        uint32_t* pl = reinterpret_cast<uint32_t*>(&lo);
        uint32_t* ph = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pl[e] = mmu::i8x2_bf16x2(x[2 * e], x[2 * e + 1]);
          ph[e] = mmu::i8x2_bf16x2(x[8 + 2 * e], x[9 + 2 * e]);
        }
        __nv_bfloat16* dst = (tsel ? sVc : sKc) + r * LD + w * 16;
        *reinterpret_cast<uint4*>(dst) = lo;
        *reinterpret_cast<uint4*>(dst + 8) = hi;
      }
      __syncthreads();
      tk = sKc;
      tv = sVc;
    } else {
      tk = reinterpret_cast<const __nv_bfloat16*>(sKr + st * L::raw_tile);
      tv = reinterpret_cast<const __nv_bfloat16*>(sVr + st * L::raw_tile);
    }
    const int k0 = c_begin + sList[it] * BK;
    const unsigned char* tf = sColF + sList[it] * BK;
    const float* tks = sScale + st * 2 * BK;
    const float* tvs = tks + BK;

    if (warp_live) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int rt = CSPLIT ? i : warp;
        // S = Q K^T: 16 rows x the warp's CW columns
        float s[CW / 8][4];
#pragma unroll
        for (int n = 0; n < CW / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4];
          const uint32_t* a;
          if constexpr (QREG) {
            a = qf[kk];
          } else {
            mmu::ldmatrix_x4(qa, sQ + (rt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
            a = qa;
          }
#pragma unroll
          for (int np = 0; np < CW / 16; ++np) {
            uint32_t r[4];
            mmu::ldmatrix_x4(r, tk + (c0w + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                                    kk * 16 + ((lane >> 3) & 1) * 8);
            mmu::mma_bf16(s[2 * np], a, r);
            mmu::mma_bf16(s[2 * np + 1], a, r + 2);
          }
        }
        // visibility, the key scale, row max over the quad
        float mx[2] = {m_r[i][0], m_r[i][1]};
#pragma unroll
        for (int n = 0; n < CW / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0w + 8 * n + 2 * tig + e;
            const int f = tf[col];
            const long long j = k0 + col;
            const float kscale = kQ8 ? tks[col] : 1.f;
            const bool ok0 = f == 1 || (f == 2 && j <= see_to[i][0]);
            const bool ok1 = f == 1 || (f == 2 && j <= see_to[i][1]);
            s[n][e] = ok0 ? s[n][e] * kscale * scale_log2 : mmu::kNegInf;
            s[n][2 + e] = ok1 ? s[n][2 + e] * kscale * scale_log2 : mmu::kNegInf;
            mx[0] = fmaxf(mx[0], s[n][e]);
            mx[1] = fmaxf(mx[1], s[n][2 + e]);
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          alpha[hf] = mmu::exp2_approx(m_r[i][hf] - mx[hf]);
          m_r[i][hf] = mx[hf];
        }
        const bool dead0 = mx[0] == mmu::kNegInf, dead1 = mx[1] == mmu::kNegInf;
#pragma unroll
        for (int n = 0; n < CW / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = dead0 ? 0.f : mmu::exp2_approx(s[n][e] - mx[0]);
            const float p1 = dead1 ? 0.f : mmu::exp2_approx(s[n][2 + e] - mx[1]);
            rs[0] += p0;
            rs[1] += p1;
            // the value scale multiplies p before the second product
            const float vscale = kQ8 ? tvs[c0w + 8 * n + 2 * tig + e] : 1.f;
            s[n][e] = p0 * vscale;
            s[n][2 + e] = p1 * vscale;
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l_r[i][hf] = l_r[i][hf] * alpha[hf] + rs[hf];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          oacc[i][n][0] *= alpha[0];
          oacc[i][n][1] *= alpha[0];
          oacc[i][n][2] *= alpha[1];
          oacc[i][n][3] *= alpha[1];
        }
        // O += P V over the warp's columns
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = mmu::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = mmu::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = mmu::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = mmu::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t r[4];
            mmu::ldmatrix_x4_trans(
                r, tv + (c0w + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                       (lane >> 4) * 8);
            mmu::mma_bf16(oacc[i][2 * dp], pa, r);
            mmu::mma_bf16(oacc[i][2 * dp + 1], pa, r + 2);
          }
        }
      }
    }
    mmu::cp_async_wait<NS - 2>();
    __syncthreads();  // the next tile has landed; this stage may be overwritten
  }

  // the output (one partial in all: long chunks, one split), or this split's
  // partial (short chunks: one per warp, partial sp*4 + warp)
  const long long R = static_cast<long long>(gridDim.z) * Hq * C;  // output rows
  const int parts = CSPLIT ? splits * NWARPS : splits;
  const int part = CSPLIT ? sp * NWARPS + warp : sp;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int rt = CSPLIT ? i : warp;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_r[i][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int m = m0 + rt * 16 + gid + 8 * hf;
      if (!warp_live || m >= M) continue;
      const long long orow = (static_cast<long long>(b) * Hq + hk * G + m / C) * C + m % C;
      if (parts == 1) {
        const float inv = l > 0.f ? 1.f / l : 0.f;
        __nv_bfloat16* op = o + orow * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * n + 2 * tig) =
              __floats2bfloat162_rn(oacc[i][n][2 * hf] * inv, oacc[i][n][2 * hf + 1] * inv);
      } else {
        float* po = ws + (part * R + orow) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<float2*>(po + 8 * n + 2 * tig) =
              make_float2(oacc[i][n][2 * hf], oacc[i][n][2 * hf + 1]);
        if (tig == 0) {
          float* pml = ws + parts * R * D + (part * R + orow) * 2;
          pml[0] = m_r[i][hf];
          pml[1] = l;
        }
      }
    }
  }
}

// o[r] = sum_s w_s o_s[r] / sum_s w_s l_s[r], w_s = exp2(m_s - max m), over
// the partials that saw a column, in partial order; 0 where none did.  One
// warp per output row.
template <int D>
__global__ void __launch_bounds__(128)
chunk_combine_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ o, long long R,
                     int parts) {
  constexpr int E = D / 32;  // output columns per lane
  const long long row = static_cast<long long>(blockIdx.x) * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const float* ml = ws + parts * R * D;
  float mx = mmu::kNegInf;
  for (int s = 0; s < parts; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(ml + (s * R + row) * 2);
    if (p.y > 0.f) mx = fmaxf(mx, p.x);
  }
  float acc[E], l = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int s = 0; s < parts; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(ml + (s * R + row) * 2);
    if (!(p.y > 0.f)) continue;
    const float w = mmu::exp2_approx(p.x - mx);
    l += w * p.y;
    const float* po = ws + (s * R + row) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += w * po[e];
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat16* op = o + row * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(op + e) =
        __floats2bfloat162_rn(acc[e] * inv, acc[e + 1] * inv);
}

// the partials a call merges: one per warp and split for short chunks
int partials(const Args& a) {
  return (a.Hq / a.Hkv) * a.C <= 32 ? a.splits * NWARPS : a.splits;
}

template <typename T, int D, bool PAGED, int RT, bool CSPLIT, int BK, int NS, int MINB>
int launch_mode(const Args& a) {
  using L = Layout<T, D, RT, BK, NS>;
  const size_t bytes = L::bytes(PAGED ? a.MP : 0, (a.per + BK - 1) / BK);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      mmu::allow_smem(chunk_decode_kernel<T, D, PAGED, RT, CSPLIT, BK, NS, MINB>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.Hq / a.Hkv;
  const int nrb = (G * a.C + L::BR - 1) / L::BR;
  const dim3 grid(nrb * a.splits, a.Hkv, a.B);
  chunk_decode_kernel<T, D, PAGED, RT, CSPLIT, BK, NS, MINB>
      <<<grid, NTHREADS, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.ks, a.vs, a.valid, a.offset, a.table,
      static_cast<__nv_bfloat16*>(a.o), a.ws, a.Hq, G, a.C, a.Smax, a.layer, a.sL, a.sB, a.sH,
      a.sS, a.tL, a.tB, a.tH, a.MP, a.P, a.per, a.splits, a.sm_scale * mmu::kLog2e);
  err = cudaGetLastError();
  const int parts = partials(a);
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const long long R = static_cast<long long>(a.B) * a.Hq * a.C;
  chunk_combine_kernel<D><<<static_cast<unsigned>((R + 3) / 4), 128, 0, a.stream>>>(
      a.ws, static_cast<__nv_bfloat16*>(a.o), R, parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool PAGED>
int launch(const Args& a) {
  const int M = (a.Hq / a.Hkv) * a.C;
  if (M <= 16) return launch_mode<T, D, PAGED, 1, true, 64, 2, 1>(a);
  if (M <= 32) return launch_mode<T, D, PAGED, 2, true, 64, 2, 1>(a);
  // long chunks: B1's tiling (a bf16 cache at D 128: 32-column tiles, a ring
  // of 3, 3 blocks per SM, as B1; int8 converts 64-column tiles)
  if (D == 128 && !Elem<T>::kQ8) return launch_mode<T, D, PAGED, 4, false, 32, 3, 3>(a);
  return launch_mode<T, D, PAGED, 4, false, 64, 2, 1>(a);
}

template <typename T, bool PAGED>
int dispatch(const Args& a, int D) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.B <= 0 || a.C <= 0 || a.Smax <= 0 || a.layer < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (PAGED && (a.table == nullptr || a.P <= 0 || a.MP <= 0 || a.MP * a.P != a.Smax))
    return static_cast<int>(cudaErrorInvalidValue);
  // the split plan: runs of `per` columns (a multiple of the tile), none empty
  if (a.per <= 0 || a.per % TILE || a.splits < 1 ||
      static_cast<long long>(a.per) * a.splits < a.Smax ||
      static_cast<long long>(a.per) * (a.splits - 1) >= a.Smax ||
      (partials(a) > 1 && a.ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128) return launch<T, 128, PAGED>(a);
  if (D == 64) return launch<T, 64, PAGED>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* kc, const void* vc, const float* ks, const float* vs,
               const int* valid, const int* offset, void* o, float* ws, int B, int Hq, int Hkv,
               int C, int Smax, int layer, int per, int splits, long long sL, long long sB,
               long long sH, long long sS, long long tL, long long tB, long long tH,
               float sm_scale, void* stream) {
  return Args{q,     kc,  vc,  ks,  vs,  valid, offset,   o,
              ws,    B,   Hq,  Hkv, C,   Smax,  layer,    per,
              splits, sL, sB,  sH,  sS,  tL,    tB,       tH,
              sm_scale, static_cast<cudaStream_t>(stream), nullptr, 0, 0};
}

// The paged pool [L,Hkv,NP,P,D] (contiguous) as strides of the kernel's
// [L,1,Hkv,NP*P,D] view, and its scales [L,Hkv,NP,1,P] likewise.
Args paged_args(const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
                const int* valid, const int* offset, const int* table, void* o, float* ws, int B,
                int Hq, int Hkv, int C, int NP, int P, int MP, int D, int layer, int per,
                int splits, float sm_scale, void* stream) {
  const long long rows = static_cast<long long>(NP) * P;
  Args a = make_args(q, kp, vp, ks, vs, valid, offset, o, ws, B, Hq, Hkv, C, MP * P, layer, per,
                     splits, Hkv * rows * D, 0, rows * D, D, Hkv * rows, 0, rows, sm_scale,
                     stream);
  a.table = table;
  a.MP = MP;
  a.P = P;
  return a;
}

}  // namespace

// q/o [B,Hq,C,D] bf16 contiguous; k/v: layer `layer` of a bf16 cache with
// element strides (sL, sB, sH, sS) and D contiguous, rows 16-byte aligned;
// valid [B,Smax] int32 contiguous; offset [B] int32.  The columns are cut
// into `splits` runs of `per` (a multiple of 64; the last may be shorter,
// none empty).  Partials: 4 per split where (Hq/Hkv)*C <= 32, else 1 per
// split; with more than one, ws holds parts*B*Hq*C*(D+2) f32 of scratch and
// a second kernel merges them.  The scale arguments are unused (pass null
// and zeros).
extern "C" int mmu_chunk_decode_bf16(const void* q, const void* k_cache, const void* v_cache,
                                     const float* k_s, const float* v_s, const int* valid,
                                     const int* offset, void* o, float* ws, int B, int Hq,
                                     int Hkv, int C, int Smax, int D, int layer, int per,
                                     int splits, long long sL, long long sB, long long sH,
                                     long long sS, long long tL, long long tB, long long tH,
                                     float sm_scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(
      make_args(q, k_cache, v_cache, nullptr, nullptr, valid, offset, o, ws, B, Hq, Hkv, C, Smax,
                layer, per, splits, sL, sB, sH, sS, 0, 0, 0, sm_scale, stream),
      D);
}

// As mmu_chunk_decode_bf16 on an int8 cache with f32 scales k_s, v_s of
// element strides (tL, tB, tH) over (layer, row, kv-head), positions
// contiguous.
extern "C" int mmu_chunk_decode_q8(const void* q, const void* k_cache, const void* v_cache,
                                   const float* k_s, const float* v_s, const int* valid,
                                   const int* offset, void* o, float* ws, int B, int Hq, int Hkv,
                                   int C, int Smax, int D, int layer, int per, int splits,
                                   long long sL, long long sB, long long sH, long long sS,
                                   long long tL, long long tB, long long tH, float sm_scale,
                                   void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t, false>(make_args(q, k_cache, v_cache, k_s, v_s, valid, offset, o, ws,
                                           B, Hq, Hkv, C, Smax, layer, per, splits, sL, sB, sH,
                                           sS, tL, tB, tH, sm_scale, stream),
                                 D);
}

// Paged (B7): q/o [B,Hq,C,D] bf16 contiguous; k/v pools [L,Hkv,NP,P,D] bf16
// contiguous; valid [B,MP*P] int32 contiguous over logical columns; offset
// [B] int32 logical columns; table [B,MP] int32 contiguous, every entry in
// [0, NP); per, splits and ws as for the dense call, over logical columns.
// The scale arguments are unused (pass null).
extern "C" int mmu_paged_chunk_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const float* k_s, const float* v_s, const int* valid,
                                    const int* offset, const int* table, void* o, float* ws,
                                    int B, int Hq, int Hkv, int C, int NP, int P, int MP, int D,
                                    int layer, int per, int splits, float sm_scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16, true>(
      paged_args(q, k_pool, v_pool, nullptr, nullptr, valid, offset, table, o, ws, B, Hq, Hkv, C,
                 NP, P, MP, D, layer, per, splits, sm_scale, stream),
      D);
}

// As mmu_paged_chunk_bf16 on int8 pools with f32 scales k_s, v_s
// [L,Hkv,NP,1,P], contiguous (B7q).
extern "C" int mmu_paged_chunk_q8(const void* q, const void* k_pool, const void* v_pool,
                                  const float* k_s, const float* v_s, const int* valid,
                                  const int* offset, const int* table, void* o, float* ws, int B,
                                  int Hq, int Hkv, int C, int NP, int P, int MP, int D, int layer,
                                  int per, int splits, float sm_scale, void* stream) {
  if (k_s == nullptr || v_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t, true>(paged_args(q, k_pool, v_pool, k_s, v_s, valid, offset, table, o,
                                           ws, B, Hq, Hkv, C, NP, P, MP, D, layer, per, splits,
                                           sm_scale, stream),
                                D);
}
