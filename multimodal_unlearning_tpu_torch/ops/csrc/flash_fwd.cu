// Flash-attention forward (kernel B1) for Hopper: bf16 in and out, f32
// accumulation on the tensor cores through mma.sync.m16n8k16.
//
// Replaces multimodal_unlearning_tpu/ops/attention.py:_fwd_kernel (launcher
// _fwd).  It computes what that kernel computes, not how Mosaic laid it out:
//   o[b,h,i]   = softmax_j(s_ij) v[b,h//group,j],  s_ij = sm_scale q_i.k_j
//   lse[b,h,i] = ln sum_j exp(s_ij)   (natural log, for the backward pass)
// over the keys j with kv_mask[b,j] != 0 and, when causal, j <= q_offset+i.
// A row with no such key gives o = 0 and lse = -1e30.  GQA maps q-head h to
// kv-head h // group.  Any Sq and Sk (the ViT's 577 too); D is 64, 80 (the
// Qwen2-VL towers' heads, 1280 / 16) or 128.
//
// What bounds it on the card: at the forget step's (2,32,768,128) causal it
// does 9.7 GFLOP on 50 MB of q, k, v and o, at the prefill's (1,32,768,128)
// 3.7 GFLOP on 25 MB: ~190 operations per byte, just under the H100's ridge
// (~295), so the bytes bound is the larger (0.0151 and 0.0075 ms at 3.35
// TB/s) and the operations bound close behind (0.0098 and 0.0037 ms at the
// bf16 peak); the ViT's (1,16,577,64) likewise.  Both are far below what an
// attention kernel reaches: in practice the tensor-core issue rate and the
// softmax between the two products limit it.
// The design (FlashAttention-2's, on mma.sync):
//   - one block of 4 warps per (64 query rows, q-head, batch row); each warp
//     owns 16 rows.  A causal grid pairs row block i with row block nrb-1-i
//     in one block, so that every block does about the same work.
//   - the warp's Q fragments, its 16-row score tile S and its 16xD output
//     accumulator O live in registers in the mma layout (mma.cuh): each
//     thread masks and exponentiates (ex2.approx) the scores it holds, row
//     max and row sum reduce over the 4 lanes of a quad (__shfl_xor 1, 2),
//     alpha rescales O in registers (skipped where no row's max moved), and
//     the f32 C fragments of S, rounded to bf16, are the A fragments of P.V.
//     Nothing of S or O goes through shared memory.
//   - K and V tiles arrive through a ring of cp.async stages, the next live
//     tiles' copies in flight during this tile's two products: at D 128,
//     32-column tiles in a ring of 3 (70 KB) with at most 168 registers a
//     thread, so 3 blocks share an SM; at D 64, 64-column tiles in a ring of
//     2, and at D 80 likewise.  Rows are padded to D+8 elements, so each
//     ldmatrix (K, and V transposed) reads 8 rows that fall on distinct bank
//     groups: a row of (D+8)*2 bytes is 272, 144 or 176 bytes, 4, 4 or 12
//     words past a multiple of 32 banks, and 8 rows at 4r or 12r mod 32 cover
//     the 32 banks once.  D 80 is 5 k-steps of 16 and 10 n8 tiles: the loops
//     below run over D/16 and D/8 and need no power of two.
//   - before any load the block lists its live tiles (a column the mask
//     admits, up to its last causal column), marking those the mask admits
//     whole, so all-padding tiles are never copied and inner tiles skip the
//     per-column mask; a warp whose rows end before a tile's first column
//     skips its products on it.
// What still holds it back (later work): mma.sync issues one 16x8x16
// product at a time from each warp, so the score and output chains and the
// softmax between them run in turn; wgmma with the softmax of one tile
// overlapping the products of the next is the lever.

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
  static constexpr int LD = D + 8;  // bf16 per shared row (16 bytes of padding)
  static constexpr int CPR = D / 8; // 16-byte chunks per row
  static constexpr size_t tile = sizeof(__nv_bfloat16) * BK * LD;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(__nv_bfloat16) * BQ * LD;  // NS stages
  static constexpr size_t v_off = k_off + NS * tile;                         // NS stages
  static constexpr size_t mask_off = v_off + NS * tile;                      // NS x BK ints
  static constexpr size_t list_off = mask_off + sizeof(int) * NS * BK;
  static size_t bytes(int n_tiles) { return list_off + sizeof(int) * n_tiles; }
};

template <int D, int BK, int NS, int MINB>
__global__ void __launch_bounds__(NTHREADS, MINB)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq, int group,
                 int Sq, int Sk, long long qsb, long long qsh, long long qss, long long ksb,
                 long long ksh, long long kss, long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss, float scale_log2, int causal,
                 int q_offset) {
  using L = Layout<D, BK, NS>;
  constexpr int BQ = L::BQ;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_live;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
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

  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + hk * ksh;
  const __nv_bfloat16* vb = v + b * vsb + hk * vsh;
  const int* mb = mask == nullptr ? nullptr : mask + static_cast<long long>(b) * Sk;

  const int nrb = (Sq + BQ - 1) / BQ;
  // a causal grid pairs row block i with row block nrb-1-i, so that every
  // block does about the same work; otherwise the heaviest blocks go first
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

    // the live tiles, in order: those with a column the mask admits, marked
    // FULL where it admits all of them (no per-column mask needed there)
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
      __nv_bfloat16* dk = sK + st * BK * LD;
      __nv_bfloat16* dv = sV + st * BK * LD;
      for (int i = tid; i < BK * L::CPR; i += NTHREADS) {
        const int r = i / L::CPR, c = i % L::CPR;
        const int kr = k0 + r;
        const int row = kr < Sk ? kr : 0;
        const int n = kr < Sk ? 16 : 0;
        mmu::cp_async16(dk + r * LD + c * 8, kb + row * kss + c * 8, n);
        mmu::cp_async16(dv + r * LD + c * 8, vb + row * vss + c * 8, n);
      }
      int* dm = sMask + st * BK;
      for (int i = tid; i < BK; i += NTHREADS) {
        const int kr = k0 + i;
        if (mb != nullptr)
          mmu::cp_async4(dm + i, mb + min(kr, Sk - 1), kr < Sk ? 4 : 0);
        else
          dm[i] = kr < Sk;
      }
    };

    // Q (rows past Sq zero-filled) and the first NS-1 live tiles
    for (int i = tid; i < BQ * L::CPR; i += NTHREADS) {
      const int r = i / L::CPR, c = i % L::CPR;
      const int qr = q0 + r;
      mmu::cp_async16(sQ + r * LD + c * 8, qb + min(qr, Sq - 1) * qss + c * 8, qr < Sq ? 16 : 0);
    }
    __syncthreads();  // s_live and the list
    const int n_live = s_live;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      if (i < n_live) load_tile(i, sList[i] & ~FULL);
      mmu::cp_async_commit();  // one group per stage, empty past the last tile
    }
    mmu::cp_async_wait<NS - 2>();
    __syncthreads();

    // the warp's Q fragments, kept in registers for the whole key loop
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mmu::ldmatrix_x4(qf[kk], sQ + (wr0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

    float oacc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    // online-softmax state of rows gid and gid + 8 (log2 domain); l is this
    // thread's partial sum over its own columns, reduced over the quad at the end
    float m_r[2] = {mmu::kNegInf, mmu::kNegInf};
    float l_r[2] = {0.f, 0.f};
    const int qpos0 = q0 + wr0 + gid + q_offset;  // row gid's position; row gid+8: +8
    const int warp_first = q0 + wr0 + q_offset;   // the warp's first and last row
    const int warp_last = warp_first + 15;

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
        // the tile needs no per-column mask where the mask admits all of it and
        // every row of the warp sees its last column
        const bool need_mask = !(entry & FULL) || (causal && k0 + BK - 1 > warp_first);

        // S = Q K^T: 16 rows x BK columns
        float s[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int np = 0; np < BK / 16; ++np) {
            uint32_t r[4];
            mmu::ldmatrix_x4(r, tk + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                                    ((lane >> 3) & 1) * 8);
            mmu::mma_bf16(s[2 * np], qf[kk], r);
            mmu::mma_bf16(s[2 * np + 1], qf[kk], r + 2);
          }
        }

        // mask, scale, row max over the quad
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (need_mask) {
              const int col = 8 * n + 2 * tig + e;
              const bool in = tm[col] != 0;
              const int kcol = k0 + col;
              const bool ok0 = in && (!causal || kcol <= qpos0);
              const bool ok1 = in && (!causal || kcol <= qpos0 + 8);
              s[n][e] = ok0 ? s[n][e] * scale_log2 : mmu::kNegInf;
              s[n][2 + e] = ok1 ? s[n][2 + e] * scale_log2 : mmu::kNegInf;
            } else {
              s[n][e] *= scale_log2;
              s[n][2 + e] *= scale_log2;
            }
            mx[0] = fmaxf(mx[0], s[n][e]);
            mx[1] = fmaxf(mx[1], s[n][2 + e]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        }
        // p = exp2(s - m) (0 where masked; a row that has seen nothing keeps 0)
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          alpha[i] = mmu::exp2_approx(m_r[i] - mx[i]);
          m_r[i] = mx[i];
        }
        const bool dead0 = mx[0] == mmu::kNegInf, dead1 = mx[1] == mmu::kNegInf;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[n][e] = dead0 ? 0.f : mmu::exp2_approx(s[n][e] - mx[0]);
            s[n][2 + e] = dead1 ? 0.f : mmu::exp2_approx(s[n][2 + e] - mx[1]);
            rs[0] += s[n][e];
            rs[1] += s[n][2 + e];
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + rs[i];
        // rescale O only where a row's max moved (late causal tiles rarely move it)
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            oacc[n][0] *= alpha[0];
            oacc[n][1] *= alpha[0];
            oacc[n][2] *= alpha[1];
            oacc[n][3] *= alpha[1];
          }
        }

        // O += P V: P's C fragments are, in bf16, the A fragments
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = mmu::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = mmu::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = mmu::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = mmu::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t r[4];
            mmu::ldmatrix_x4_trans(
                r, tv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                       (lane >> 4) * 8);
            mmu::mma_bf16(oacc[2 * dp], pa, r);
            mmu::mma_bf16(oacc[2 * dp + 1], pa, r + 2);
          }
        }
      }
      mmu::cp_async_wait<NS - 2>();
      __syncthreads();  // the next tile has landed; this stage may be overwritten
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_r[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int qi = q0 + wr0 + gid + 8 * i;
      if (qi >= Sq) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
      __nv_bfloat16* orow = o + b * osb + h * osh + qi * oss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * tig) =
            __floats2bfloat162_rn(oacc[n][2 * i] * inv, oacc[n][2 * i + 1] * inv);
      if (tig == 0)
        lse[(static_cast<long long>(b) * Hq + h) * Sq + qi] =
            l > 0.f ? m_r[i] * mmu::kLn2 + logf(l) : mmu::kNegInf;
    }
    __syncthreads();  // the next pass reuses the shared buffers
  }
}

struct Args {
  const void *q, *k, *v;
  const int* mask;
  void* o;
  float* lse;
  int B, Hq, Hkv, Sq, Sk;
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss;
  float sm_scale;
  int causal, q_offset;
  cudaStream_t stream;
};

template <int D, int BK, int NS, int MINB>
int launch(const Args& a) {
  using L = Layout<D, BK, NS>;
  const size_t bytes = L::bytes((a.Sk + BK - 1) / BK);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = mmu::allow_smem(flash_fwd_kernel<D, BK, NS, MINB>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nrb = (a.Sq + L::BQ - 1) / L::BQ;
  const dim3 grid(a.causal && nrb > 1 ? (nrb + 1) / 2 : nrb, a.Hq, a.B);
  flash_fwd_kernel<D, BK, NS, MINB><<<grid, NTHREADS, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.mask, static_cast<__nv_bfloat16*>(a.o), a.lse,
      a.Hq, a.Hq / a.Hkv, a.Sq, a.Sk, a.qsb, a.qsh, a.qss, a.ksb, a.ksh, a.kss, a.vsb, a.vsh,
      a.vss, a.osb, a.osh, a.oss, a.sm_scale * mmu::kLog2e, a.causal, a.q_offset);
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
  const Args a{q,   k,   v,   mask, o,   lse, B,   Hq,  Hkv,      Sq,     Sk,       qsb,
               qsh, qss, ksb, ksh,  kss, vsb, vsh, vss, osb,      osh,    oss,      sm_scale,
               causal, q_offset, static_cast<cudaStream_t>(stream)};
  // D 128: 32-column tiles in a ring of 3 (70 KB) and at most 168 registers,
  // so 3 blocks share an SM; D 64 and 80: 64-column tiles, 2 stages (57 KB
  // at D 80)
  if (D == 128) return launch<128, 32, 3, 3>(a);
  if (D == 80) return launch<80, 64, 2, 1>(a);
  if (D == 64) return launch<64, 64, 2, 1>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
