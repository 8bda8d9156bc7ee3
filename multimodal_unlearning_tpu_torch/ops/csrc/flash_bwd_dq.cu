// Flash-attention backward, the dq half (kernel B2) for Hopper: bf16 in and
// out, f32 accumulation on the tensor cores through mma.sync.m16n8k16.
//
// Replaces multimodal_unlearning_tpu/ops/attention.py:_bwd_dq_kernel (launched
// by _bwd).  It computes what that kernel computes, not how Mosaic laid it out:
//   p_ij  = exp(s_ij - lse_i),  s_ij = sm_scale q_i.k_j   (recomputed, never stored)
//   dp_ij = do_i.v_j
//   dq_i  = sm_scale sum_j p_ij (dp_ij - delta_i) k_j,  delta_i = sum_d do_id o_id
// over the keys j with kv_mask[b,j] != 0 and, when causal, j <= q_offset+i
// (the masking rules of flash_fwd.cu).  p is masked after the exponent, so a
// masked pair cannot contribute through an overflow.  A row whose lse is -1e30
// saw no key in the forward pass: its p is exactly 0 (its exponent is -inf)
// and its dq is 0.  GQA maps q-head h to kv-head h // group.  Any Sq and Sk;
// D is 64, 80 (the Qwen2-VL towers' heads, 1280 / 16) or 128.  No block depends on another and nothing is added
// atomically, so the result is the same bits on every run.
//
// What bounds it on the card: at the forget step's (2,32,768,128) causal it
// does 6 D FLOP per visible pair, 14.5 GFLOP, on 63 MB of q, do, k, v, dq,
// lse and delta: the bytes bound is the larger (0.0189 ms at 3.35 TB/s), the
// operations bound close behind (0.0147 ms at the bf16 peak).
// The design (FlashAttention-2's dq pass, on the core of flash_fwd.cu):
//   - one block of 4 warps per (64 query rows, q-head, batch row); each warp
//     owns 16 rows.  A causal grid pairs row block i with row block nrb-1-i
//     in one block, so that every block does about the same work (unless a
//     long q_offset evens the blocks already: then pairing would only halve
//     the grid).
//   - Q and dO stay in shared memory and are read per k-step by ldmatrix; the
//     warp's 16-row tiles S = Q K^T and dP = dO V^T, its dq accumulator and
//     the log2-domain lse and delta of its rows gid and gid+8 live in
//     registers in the mma layout (mma.cuh).  Each thread exponentiates
//     (ex2.approx), masks and forms dS = P (dP - delta) on the entries it
//     holds, and the f32 C fragments of dS, rounded to bf16, are the A
//     fragments of dS K, with K read through ldmatrix.trans.  Nothing of S, dP
//     or dS goes through shared memory.
//   - K and V tiles arrive through a ring of cp.async stages, the next live
//     tiles' copies in flight during this tile's three products; rows are
//     padded to D+8 elements, so every ldmatrix reads 8 rows on distinct bank
//     groups.  At D 128: 32-column tiles in a ring of 2 (70 KB) with at most
//     168 registers a thread, nothing spilled, so 3 blocks share an SM and the
//     forget step's 384 paired blocks run in one wave; at D 64: 64-column
//     tiles in a ring of 2.  D 80 is 5 k-steps of 16 in S and dP and 10 n8
//     tiles in dq, on D 64's tiling (68 KB) with a register bound of 2 blocks
//     an SM: its accumulator is 8 registers wider.
//   - before any load the block lists its live tiles (a column the mask
//     admits, up to its last causal column), marking those the mask admits
//     whole, so all-padding tiles are never copied and inner tiles skip the
//     per-column mask; a warp whose rows end before a tile's first column
//     skips its products on it.
// What still holds it back (later work): every warp re-reads the whole K and
// V tile through ldmatrix for its 16 rows and runs its loads and 16x8x16
// products in turn; wgmma on 64-row tiles, with the elementwise step of one
// tile overlapping the products of the next, is the lever, as for
// flash_fwd.cu.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int FULL = 1 << 30;  // a live-tile entry whose columns the mask all admits

// 64 query rows per block, tiles of BK key columns, a ring of NS stages
template <int D, int BK, int NS>
struct Layout {
  static constexpr int BQ = 64;
  static constexpr int LD = D + 8;   // bf16 per shared row (16 bytes of padding)
  static constexpr int CPR = D / 8;  // 16-byte chunks per row
  static constexpr size_t rows = sizeof(__nv_bfloat16) * BQ * LD;
  static constexpr size_t tile = sizeof(__nv_bfloat16) * BK * LD;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + rows;
  static constexpr size_t k_off = do_off + rows;       // NS stages
  static constexpr size_t v_off = k_off + NS * tile;   // NS stages
  static constexpr size_t mask_off = v_off + NS * tile;  // NS x BK ints
  static constexpr size_t list_off = mask_off + sizeof(int) * NS * BK;
  static size_t bytes(int n_tiles) { return list_off + sizeof(int) * n_tiles; }
};

template <int D, int BK, int NS, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Hq,
                    int group, int Sq, int Sk, long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kss, long long vsb, long long vsh,
                    long long vss, long long gsb, long long gsh, long long gss, long long dsb,
                    long long dsh, long long dss, float sm_scale, int causal, int q_offset) {
  using L = Layout<D, BK, NS>;
  constexpr int BQ = L::BQ;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_live;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  int* sMask = reinterpret_cast<int*>(smem + L::mask_off);
  int* sList = reinterpret_cast<int*>(smem + L::list_off);

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr0 = warp * 16;  // this warp's first row in the block
  const float scale_log2 = sm_scale * mmu::kLog2e;

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* gb = dout + b * gsb + h * gsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;
  const long long row_base = (static_cast<long long>(b) * Hq + h) * Sq;

  const int nrb = (Sq + BQ - 1) / BQ;
  // a causal grid pairs row block i with row block nrb-1-i (flash_fwd.cu)
  const bool paired = static_cast<int>(gridDim.x) < nrb;
  for (int pass = 0; pass < (paired ? 2 : 1); ++pass) {
    const int rb = paired ? (pass == 0 ? nrb - 1 - blockIdx.x : blockIdx.x)
                          : gridDim.x - 1 - blockIdx.x;
    if (pass == 1 && rb == nrb - 1 - rb) break;  // the middle block of an odd count: once
    const int q0 = rb * BQ;

    // causal: the block's last real row sees keys up to last_row + q_offset
    const int last_row = min(Sq, q0 + BQ) - 1;
    const int k_end = max(causal ? min(Sk, last_row + q_offset + 1) : Sk, 0);
    const int nk = (k_end + BK - 1) / BK;

    // the live tiles, in order, marked FULL where the mask admits every column
    for (int t = warp; t < nk; t += NWARPS) {
      bool any = false, all = true;
#pragma unroll
      for (int i = 0; i < BK / 32; ++i) {
        const int j = t * BK + lane + 32 * i;
        const bool ok = j < Sk && (mb == nullptr || mb[j] != 0);
        any |= ok;
        all &= ok;
      }
      any = __any_sync(0xffffffffu, any);
      all = __all_sync(0xffffffffu, all);
      if (lane == 0) sList[t] = any ? (all ? 2 : 1) : 0;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int t = 0; t < nk; ++t)
        if (sList[t]) sList[n++] = t | (sList[t] == 2 ? FULL : 0);
      s_live = n;
    }

    // K, V and mask of tile t into stage st; rows past Sk are zero-filled
    auto load_tile = [&](int st, int t) {
      const int k0 = t * BK;
      __nv_bfloat16* tk = sK + st * BK * LD;
      __nv_bfloat16* tv = sV + st * BK * LD;
      for (int i = tid; i < BK * L::CPR; i += NTHREADS) {
        const int r = i / L::CPR, c = i % L::CPR;
        const int kr = k0 + r;
        const int row = kr < Sk ? kr : 0;
        const int n = kr < Sk ? 16 : 0;
        mmu::cp_async16(tk + r * LD + c * 8, kb + row * kss + c * 8, n);
        mmu::cp_async16(tv + r * LD + c * 8, vb + row * vss + c * 8, n);
      }
      int* tm = sMask + st * BK;
      for (int i = tid; i < BK; i += NTHREADS) {
        const int kr = k0 + i;
        if (mb != nullptr)
          mmu::cp_async4(tm + i, mb + min(kr, Sk - 1), kr < Sk ? 4 : 0);
        else
          tm[i] = kr < Sk;
      }
    };

    // Q and dO (rows past Sq zero-filled), then the first NS-1 live tiles
    for (int i = tid; i < BQ * L::CPR; i += NTHREADS) {
      const int r = i / L::CPR, c = i % L::CPR;
      const int qr = q0 + r;
      const int row = min(qr, Sq - 1);
      const int n = qr < Sq ? 16 : 0;
      mmu::cp_async16(sQ + r * LD + c * 8, qb + row * qss + c * 8, n);
      mmu::cp_async16(sdO + r * LD + c * 8, gb + row * gss + c * 8, n);
    }
    __syncthreads();  // s_live and the list
    const int n_live = s_live;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < n_live) load_tile(i, sList[i] & ~FULL);
      mmu::cp_async_commit();  // one group per stage, empty past the last tile
    }

    // lse (log2 domain) and delta of rows gid and gid + 8; a dead row (lse
    // -1e30, or a row past Sq) gets lse2 = +inf, so its p is exp2(-inf) = 0
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + wr0 + gid + 8 * i;
      const float l = qi < Sq ? lse[row_base + qi] : mmu::kNegInf;
      lse2[i] = l > 0.5f * mmu::kNegInf ? l * mmu::kLog2e : INFINITY;
      dlt[i] = qi < Sq ? delta[row_base + qi] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const int qpos0 = q0 + wr0 + gid + q_offset;  // row gid's position; row gid+8: +8
    const int warp_first = q0 + wr0 + q_offset;   // the warp's first and last row
    const int warp_last = warp_first + 15;
    // the lane's rows of the warp's Q and dO (A operands), and its row offsets
    // into a tile for the B operands, plain and transposed
    const __nv_bfloat16* aq = sQ + (wr0 + (lane & 15)) * LD + (lane >> 4) * 8;
    const __nv_bfloat16* ado = sdO + (wr0 + (lane & 15)) * LD + (lane >> 4) * 8;
    const int b_off = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
    const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
    mmu::cp_async_wait<NS - 2>();
    __syncthreads();

    for (int it = 0; it < n_live; ++it) {
      const int st = it % NS;
      // tile it+NS-1 into the stage tile it-1 held; in flight meanwhile
      if (it + NS - 1 < n_live) load_tile((it + NS - 1) % NS, sList[it + NS - 1] & ~FULL);
      mmu::cp_async_commit();
      const int entry = sList[it];
      const int k0 = (entry & ~FULL) * BK;
      if (!causal || k0 <= warp_last) {
        const __nv_bfloat16* tk = sK + st * BK * LD;
        const __nv_bfloat16* tv = sV + st * BK * LD;
        const int* tm = sMask + st * BK;
        const bool need_mask = !(entry & FULL) || (causal && k0 + BK - 1 > warp_first);

        // S = Q K^T and dP = dO V^T: 16 rows x BK columns each
        float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4], da[4];
          mmu::ldmatrix_x4(qa, aq + 16 * kk);
          mmu::ldmatrix_x4(da, ado + 16 * kk);
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            const int off = np * 16 * LD + kk * 16 + b_off;
            uint32_t r[4];
            mmu::ldmatrix_x4(r, tk + off);
            mmu::mma_bf16(s[2 * np], qa, r);
            mmu::mma_bf16(s[2 * np + 1], qa, r + 2);
            mmu::ldmatrix_x4(r, tv + off);
            mmu::mma_bf16(dp[2 * np], da, r);
            mmu::mma_bf16(dp[2 * np + 1], da, r + 2);
          }
        }

        // P = exp2(S scale_log2 - lse2), masked after the exponent, and
        // dS = P (dP - delta), left in s
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p0 = mmu::exp2_approx(fmaf(s[n][e], scale_log2, -lse2[0]));
            float p1 = mmu::exp2_approx(fmaf(s[n][2 + e], scale_log2, -lse2[1]));
            if (need_mask) {
              const int col = 8 * n + 2 * tig + e;
              const bool in = tm[col] != 0;
              const int kcol = k0 + col;
              p0 = in && (!causal || kcol <= qpos0) ? p0 : 0.f;
              p1 = in && (!causal || kcol <= qpos0 + 8) ? p1 : 0.f;
            }
            s[n][e] = p0 * (dp[n][e] - dlt[0]);
            s[n][2 + e] = p1 * (dp[n][2 + e] - dlt[1]);
          }
        }

        // dQ += dS K: dS's C fragments are, in bf16, the A fragments; K is
        // read transposed, as flash_fwd.cu reads V
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = mmu::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = mmu::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = mmu::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = mmu::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            uint32_t r[4];
            mmu::ldmatrix_x4_trans(r, tk + kk * 16 * LD + dd * 16 + t_off);
            mmu::mma_bf16(acc[2 * dd], pa, r);
            mmu::mma_bf16(acc[2 * dd + 1], pa, r + 2);
          }
        }
      }
      mmu::cp_async_wait<NS - 2>();
      __syncthreads();  // the next tile has landed; this stage may be overwritten
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + wr0 + gid + 8 * i;
      if (qi >= Sq) continue;
      __nv_bfloat16* drow = dq + b * dsb + h * dsh + qi * dss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(drow + 8 * n + 2 * tig) =
            __floats2bfloat162_rn(acc[n][2 * i] * sm_scale, acc[n][2 * i + 1] * sm_scale);
    }
    __syncthreads();  // the next pass reuses the shared buffers
  }
}

struct Args {
  const void *q, *k, *v;
  const int* mask;
  const void* dout;
  const float *lse, *delta;
  void* dq;
  int B, Hq, Hkv, Sq, Sk;
  const long long* st;  // q, k, v, dout, dq: batch, head, row strides
  float sm_scale;
  int causal, q_offset;
  cudaStream_t stream;
};

template <int D, int BK, int NS, int MINB>
int launch(const Args& a) {
  using L = Layout<D, BK, NS>;
  const size_t bytes = L::bytes((a.Sk + BK - 1) / BK);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mmu::allow_smem(flash_bwd_dq_kernel<D, BK, NS, MINB>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // causal: pair the row blocks where their work is uneven (the first block
  // sees under half the keys of the last); where a long q_offset gives every
  // block about the same keys, pairing would only halve the grid
  const int nrb = (a.Sq + L::BQ - 1) / L::BQ;
  const int lightest = min(a.Sk, min(a.Sq, L::BQ) + a.q_offset);
  const int heaviest = min(a.Sk, a.Sq + a.q_offset);
  const bool pair = a.causal && nrb > 1 && 2 * lightest < heaviest;
  const dim3 grid(pair ? (nrb + 1) / 2 : nrb, a.Hq, a.B);
  const long long* st = a.st;
  flash_bwd_dq_kernel<D, BK, NS, MINB><<<grid, NTHREADS, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.mask, static_cast<const __nv_bfloat16*>(a.dout),
      a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq), a.Hq, a.Hq / a.Hkv, a.Sq, a.Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], a.sm_scale, a.causal, a.q_offset);
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
  const Args a{q,  k,  v,   mask, dout,     lse,    delta,    dq, B, Hq, Hkv, Sq, Sk,
               st, sm_scale, causal, q_offset, static_cast<cudaStream_t>(stream)};
  // D 128: 32-column tiles, ring of 2, <= 168 registers (3 blocks per SM);
  // D 64: 64-column tiles, ring of 2; D 80: the same, 2 blocks per SM
  if (D == 128) return launch<128, 32, 2, 3>(a);
  if (D == 64) return launch<64, 64, 2, 3>(a);
  if (D == 80) return launch<80, 64, 2, 2>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
