// Flash-attention backward, the dk/dv half (kernel B3) for Hopper: bf16 in and
// out, f32 accumulation on the tensor cores through mma.sync.m16n8k16.
//
// Replaces multimodal_unlearning_tpu/ops/attention.py:_bwd_dkv_kernel (launched
// by _bwd, which then sums each GQA group).  It computes what they compute:
//   p_ij  = exp(s_ij - lse_i),  s_ij = sm_scale q_i.k_j   (recomputed, never stored)
//   dv_j  = sum_i p_ij do_i
//   dk_j  = sm_scale sum_i p_ij (do_i.v_j - delta_i) q_i,  delta_i = sum_d do_id o_id
// summed over the queries i of every q-head of key head j's group, with the
// masking rules of flash_fwd.cu (kv_mask, causal with q_offset).  p is masked
// after the exponent; a query row whose lse is -1e30 saw no key in the forward
// pass and adds exactly nothing (its exponent is -inf); a key the mask refuses
// gets dk = dv = 0.  Any Sq and Sk; D is 64, 80 (the Qwen2-VL towers' heads,
// 1280 / 16) or 128.
//
// GQA: the TPU launcher writes per-q-head partials in bf16 and sums each
// group afterwards.  Here the block that owns a kv-head accumulates the whole
// group in f32 and rounds once, which is closer to exact arithmetic; against
// the TPU order the two differ by the rounding of `group` bf16 partials, a few
// bf16 ulps of the result (the parity tests run in f32, where both are exact).
// No block depends on another and nothing is added atomically, so the result
// is the same bits on every run.
//
// What bounds it on the card: at the forget step's (2,32,768,128) causal it
// does 8 D FLOP per visible pair, 19.4 GFLOP, on 76 MB of q, do, k, v, dk, dv,
// lse and delta: the bytes bound is the larger (0.0227 ms at 3.35 TB/s), the
// operations bound close behind (0.0196 ms at the bf16 peak).
// The design (FlashAttention-2's dk/dv pass, on the core of flash_fwd.cu):
//   - one block of 4 warps per (64 key rows, kv-head, batch row); each warp
//     owns 16 key rows.  A causal grid pairs key block j with key block
//     nkb-1-j in one block: an early key block is seen by many query tiles,
//     a late one by few, so every block does about the same work (where the
//     last is seen by under half the queries that see the first).
//   - the block walks the q-heads of its group and, for each, the query tiles
//     from the first one that can see its keys, as one sequence: Q, dO, lse
//     and delta tiles arrive through a ring of cp.async stages (cp_async4 for
//     the f32 rows), the next tiles' copies in flight during this tile's four
//     products, across q-head boundaries too.
//   - K and V stay in shared memory and are read per k-step by ldmatrix as the
//     A operands of S^T = K Q^T and dP^T = V dO^T; the B operands are the Q
//     and dO rows (ldmatrix, as flash_fwd.cu reads K).  S^T, dP^T and the dk
//     and dv accumulators live in registers in the mma layout (mma.cuh):
//     each thread reads the lse and delta of its own columns from the staged
//     tile, exponentiates (ex2.approx), masks and forms dS^T = P^T (dP^T -
//     delta) on the entries it holds, and the f32 C fragments of P^T and dS^T,
//     rounded to bf16, are the A fragments of P^T dO and dS^T Q, with dO and Q
//     read through ldmatrix.trans.  Nothing of S, dP, P or dS goes through
//     shared memory.
//   - the kv mask is a property of the key rows a thread owns, so it is
//     applied once, when dk and dv are written: each row of P^T feeds only its
//     own key's dk and dv.  Per tile only the causal rule remains, and only on
//     tiles that straddle the diagonal; a warp whose keys all come after a
//     tile's last query skips its products on it.  A block whose keys the mask
//     all refuses writes zeros and reads nothing else.
//   - at D 128 the two 16x128 f32 accumulators are 128 registers a thread, so
//     tiles of 64 query rows in a ring of 2 (104 KB) are taken in slices of 32
//     columns: S^T and dP^T of one slice are 32 more registers, at most 255 a
//     thread with nothing spilled, and 2 blocks share an SM.  At D 64: slices
//     of 64 columns.  At D 80 (5 k-steps of 16 in S^T and dP^T, 10 n8 tiles
//     in dk and dv) the accumulators are 80 registers and slices of 64
//     columns 64 more: fewer than D 128's 128 + 32, so D 64's tiling holds
//     (68 KB of shared memory, 2 blocks an SM).
// What still holds it back (later work): only 8 warps share an SM, each
// running its ldmatrix loads and 16x8x16 products in turn and re-reading the
// whole Q and dO slice for its 16 keys.  The paired grid of the forget step
// (384 blocks on 264 resident slots) takes 1.45 waves; an unpaired grid with
// the heaviest key blocks first, which the block scheduler balances, ran
// faster in a tile study.  wgmma on 64-row tiles with the accumulators split
// across two warpgroups is the lever.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

// 64 key rows per block, tiles of BQ query rows, a ring of NS stages
template <int D, int BQ, int NS>
struct Layout {
  static constexpr int BK = 64;
  static constexpr int LD = D + 8;   // bf16 per shared row (16 bytes of padding)
  static constexpr int CPR = D / 8;  // 16-byte chunks per row
  static constexpr size_t keys = sizeof(__nv_bfloat16) * BK * LD;
  static constexpr size_t tile = sizeof(__nv_bfloat16) * BQ * LD;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + keys;
  static constexpr size_t q_off = v_off + keys;         // NS stages
  static constexpr size_t do_off = q_off + NS * tile;   // NS stages
  static constexpr size_t lse_off = do_off + NS * tile;  // NS x BQ floats
  static constexpr size_t delta_off = lse_off + sizeof(float) * NS * BQ;
  static constexpr size_t bytes = delta_off + sizeof(float) * NS * BQ;
};

// each tile's queries are taken in slices of BC columns
template <int D, int BQ, int BC, int NS, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB)
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
  using L = Layout<D, BQ, NS>;
  constexpr int BK = L::BK;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sdO = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta_off);

  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wk0 = warp * 16;  // this warp's first key row in the block
  const float scale_log2 = sm_scale * mmu::kLog2e;

  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;

  const int nkb = (Sk + BK - 1) / BK;
  const int nq = (Sq + BQ - 1) / BQ;
  // a causal grid pairs key block j with key block nkb-1-j
  const bool paired = static_cast<int>(gridDim.x) < nkb;
  for (int pass = 0; pass < (paired ? 2 : 1); ++pass) {
    const int bx = blockIdx.x;
    const int kblk = pass == 0 ? bx : nkb - 1 - bx;
    if (pass == 1 && kblk == bx) break;  // the middle block of an odd count: once
    const int k0 = kblk * BK;
    const int kpos0 = k0 + wk0 + gid;  // the key of row gid; row gid+8: +8

    // the mask's verdict on this thread's keys; a block it refuses whole
    // writes zeros
    bool kvalid[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kpos0 + 8 * i;
      kvalid[i] = kr < Sk && (mb == nullptr || mb[kr] != 0);
    }
    const bool live = __syncthreads_or(kvalid[0] || kvalid[1]) != 0;

    // causal: the first query tile that can see key k0; the sequence of tiles
    // runs over the group's q-heads, nqe tiles each
    const int q_start = causal ? max(0, (k0 - q_offset) / BQ) : 0;
    const int nqe = max(nq - q_start, 0);
    const int n_tiles = live ? group * nqe : 0;

    // Q, dO, lse and delta of tile t into stage st; rows past Sq are
    // zero-filled and their lse is -1e30, so they count as dead rows
    auto load_tile = [&](int st, int t) {
      const int h = hk * group + t / nqe;
      const int q0 = (q_start + t % nqe) * BQ;
      const __nv_bfloat16* qb = q + b * qsb + h * qsh;
      const __nv_bfloat16* gb = dout + b * gsb + h * gsh;
      __nv_bfloat16* tq = sQ + st * BQ * LD;
      __nv_bfloat16* tg = sdO + st * BQ * LD;
      for (int i = tid; i < BQ * L::CPR; i += NTHREADS) {
        const int r = i / L::CPR, c = i % L::CPR;
        const int qr = q0 + r;
        const int row = min(qr, Sq - 1);
        const int n = qr < Sq ? 16 : 0;
        mmu::cp_async16(tq + r * LD + c * 8, qb + row * qss + c * 8, n);
        mmu::cp_async16(tg + r * LD + c * 8, gb + row * gss + c * 8, n);
      }
      const long long row_base = (static_cast<long long>(b) * Hq + h) * Sq;
      for (int i = tid; i < BQ; i += NTHREADS) {
        const int qr = q0 + i;
        if (qr < Sq) {
          mmu::cp_async4(sLse + st * BQ + i, lse + row_base + qr, 4);
          mmu::cp_async4(sDelta + st * BQ + i, delta + row_base + qr, 4);
        } else {
          sLse[st * BQ + i] = mmu::kNegInf;
          sDelta[st * BQ + i] = 0.f;
        }
      }
    };

    // K and V (rows past Sk zero-filled) with the first NS-1 tiles
    if (live) {
      for (int i = tid; i < BK * L::CPR; i += NTHREADS) {
        const int r = i / L::CPR, c = i % L::CPR;
        const int kr = k0 + r;
        const int row = kr < Sk ? kr : 0;
        const int n = kr < Sk ? 16 : 0;
        mmu::cp_async16(sK + r * LD + c * 8, kb + row * kss + c * 8, n);
        mmu::cp_async16(sV + r * LD + c * 8, vb + row * vss + c * 8, n);
      }
    }
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < n_tiles) load_tile(i, i);
      mmu::cp_async_commit();  // one group per stage, empty past the last tile
    }

    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
    // the lane's rows of the warp's K and V (A operands), and its row offsets
    // into a tile for the B operands, plain and transposed
    const __nv_bfloat16* ak = sK + (wk0 + (lane & 15)) * LD + (lane >> 4) * 8;
    const __nv_bfloat16* av = sV + (wk0 + (lane & 15)) * LD + (lane >> 4) * 8;
    const int b_off = ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
    const int t_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
    const int warp_first = k0 + wk0;  // the warp's first and last key
    const int warp_last = warp_first + 15;
    mmu::cp_async_wait<NS - 2>();
    __syncthreads();

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % NS;
      // tile it+NS-1 into the stage tile it-1 held; in flight meanwhile
      if (it + NS - 1 < n_tiles) load_tile((it + NS - 1) % NS, it + NS - 1);
      mmu::cp_async_commit();
      const int qpos = (q_start + it % nqe) * BQ + q_offset;  // the tile's first query
      const __nv_bfloat16* tq = sQ + st * BQ * LD;
      const __nv_bfloat16* tg = sdO + st * BQ * LD;
      const float* tl = sLse + st * BQ;
      const float* td = sDelta + st * BQ;
      // the tile's queries in slices of BC columns: S^T, dP^T, P^T and dS^T of
      // one slice live in registers at a time
#pragma unroll
      for (int c0 = 0; c0 < BQ; c0 += BC) {
        if (causal && warp_first > qpos + c0 + BC - 1) continue;  // all masked
        const bool need_mask = causal && warp_last > qpos + c0;

        // S^T = K Q^T and dP^T = V dO^T: 16 keys x BC queries each
        float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
        for (int n = 0; n < BC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[4], va[4];
          mmu::ldmatrix_x4(ka, ak + 16 * kk);
          mmu::ldmatrix_x4(va, av + 16 * kk);
#pragma unroll
          for (int np = 0; np < BC / 16; ++np) {
            const int off = (c0 + np * 16) * LD + kk * 16 + b_off;
            uint32_t r[4];
            mmu::ldmatrix_x4(r, tq + off);
            mmu::mma_bf16(s[2 * np], ka, r);
            mmu::mma_bf16(s[2 * np + 1], ka, r + 2);
            mmu::ldmatrix_x4(r, tg + off);
            mmu::mma_bf16(dp[2 * np], va, r);
            mmu::mma_bf16(dp[2 * np + 1], va, r + 2);
          }
        }

        // P^T = exp2(S^T scale_log2 - lse2[col]), masked after the exponent,
        // left in s; dS^T = P^T (dP^T - delta[col]), left in dp
#pragma unroll
        for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * n + 2 * tig + e;
            const float l = tl[col];
            const float l2 = l > 0.5f * mmu::kNegInf ? l * mmu::kLog2e : INFINITY;
            const float dl = td[col];
            float p0 = mmu::exp2_approx(fmaf(s[n][e], scale_log2, -l2));
            float p1 = mmu::exp2_approx(fmaf(s[n][2 + e], scale_log2, -l2));
            if (need_mask) {
              p0 = kpos0 <= qpos + col ? p0 : 0.f;
              p1 = kpos0 + 8 <= qpos + col ? p1 : 0.f;
            }
            s[n][e] = p0;
            s[n][2 + e] = p1;
            dp[n][e] = p0 * (dp[n][e] - dl);
            dp[n][2 + e] = p1 * (dp[n][2 + e] - dl);
          }
        }

        // dV += P^T dO and dK += dS^T Q: the C fragments are, in bf16, the A
        // fragments; dO and Q are read transposed, as flash_fwd.cu reads V
#pragma unroll
        for (int kk = 0; kk < BC / 16; ++kk) {
          uint32_t pa[4], da[4];
          pa[0] = mmu::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = mmu::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = mmu::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = mmu::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          da[0] = mmu::pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
          da[1] = mmu::pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
          da[2] = mmu::pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          da[3] = mmu::pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            const int off = (c0 + kk * 16) * LD + dd * 16 + t_off;
            uint32_t r[4];
            mmu::ldmatrix_x4_trans(r, tg + off);
            mmu::mma_bf16(dva[2 * dd], pa, r);
            mmu::mma_bf16(dva[2 * dd + 1], pa, r + 2);
            mmu::ldmatrix_x4_trans(r, tq + off);
            mmu::mma_bf16(dka[2 * dd], da, r);
            mmu::mma_bf16(dka[2 * dd + 1], da, r + 2);
          }
        }
      }
      mmu::cp_async_wait<NS - 2>();
      __syncthreads();  // the next tile has landed; this stage may be overwritten
    }

    // dk = sm_scale sum ds q and dv; a key the mask refuses gets exactly 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = kpos0 + 8 * i;
      if (kr >= Sk) continue;
      const bool ok = kvalid[i];  // a select, not a product: 0 even past an overflow
      __nv_bfloat16* krow = dk + b * dksb + hk * dksh + kr * dkss;
      __nv_bfloat16* vrow = dv + b * dvsb + hk * dvsh + kr * dvss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n + 2 * tig) = __floats2bfloat162_rn(
            ok ? dka[n][2 * i] * sm_scale : 0.f, ok ? dka[n][2 * i + 1] * sm_scale : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n + 2 * tig) = __floats2bfloat162_rn(
            ok ? dva[n][2 * i] : 0.f, ok ? dva[n][2 * i + 1] : 0.f);
      }
    }
    __syncthreads();  // the next pass reuses the shared buffers
  }
}

struct Args {
  const void *q, *k, *v;
  const int* mask;
  const void* dout;
  const float *lse, *delta;
  void *dk, *dv;
  int B, Hq, Hkv, Sq, Sk;
  const long long* st;  // q, k, v, dout, dk, dv: batch, head, row strides
  float sm_scale;
  int causal, q_offset;
  cudaStream_t stream;
};

template <int D, int BQ, int BC, int NS, int MINB>
int launch(const Args& a) {
  using L = Layout<D, BQ, NS>;
  cudaError_t err = mmu::allow_smem(flash_bwd_dkv_kernel<D, BQ, BC, NS, MINB>, L::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // causal: pair the key blocks where their work is uneven (the last block is
  // seen by under half the queries that see the first), as flash_bwd_dq.cu
  const int nkb = (a.Sk + L::BK - 1) / L::BK;
  const int lightest = a.Sq - min(max((nkb - 1) * L::BK - a.q_offset, 0), a.Sq);
  const bool pair = a.causal && nkb > 1 && 2 * lightest < a.Sq;
  const dim3 grid(pair ? (nkb + 1) / 2 : nkb, a.Hkv, a.B);
  const long long* st = a.st;
  flash_bwd_dkv_kernel<D, BQ, BC, NS, MINB><<<grid, NTHREADS, L::bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.mask, static_cast<const __nv_bfloat16*>(a.dout),
      a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.Hq,
      a.Hq / a.Hkv, a.Sq, a.Sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16], st[17], a.sm_scale,
      a.causal, a.q_offset);
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
  const Args a{q,  k,  v,        mask,   dout,     lse, delta, dk, dv, B, Hq, Hkv, Sq, Sk,
               st, sm_scale, causal, q_offset, static_cast<cudaStream_t>(stream)};
  // D 128: 64 query rows per stage, ring of 2, slices of 32 (2 blocks per SM);
  // D 64 and 80: 64 rows, ring of 2, one slice
  if (D == 128) return launch<128, 64, 32, 2, 2>(a);
  if (D == 64) return launch<64, 64, 64, 2, 2>(a);
  if (D == 80) return launch<80, 64, 64, 2, 2>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
