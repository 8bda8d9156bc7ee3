// Grouped-int4 W4A16 matmul (kernel B8) for Hopper:
//   y[M,N] = sum_g (x_lo[:, g] @ lo_g) * s_lo[g] + (x_hi[:, g] @ hi_g) * s_hi[g]
// x [M,K] bf16 row-major, x_lo = x[:, :K/2], x_hi = x[:, K/2:].  The weight is
// nibble-packed int8 q4 [K/2,N] stored with K/2 contiguous (column n's K/2
// bytes are one run): byte i of a column holds row i in its low nibble and
// row i + K/2 in its high nibble, signed int4 values.  s [K/G,N] f32
// row-major: one scale per (group of G rows, column), the low half's K/2/G
// groups first.  Each group's partial is an f32 product of exact int4
// values, and the f32 scale of the group multiplies that partial, never a
// materialised weight, as in the TPU kernel; accumulation is f32.
//
// Replaces multimodal_unlearning_tpu/ops/int4_matmul.py:_kernel (launcher
// int4_matmul_pallas).
//
// Nibble to bf16 without a conversion instruction: n ^ 8 maps a signed
// nibble n in [-8, 7] to [0, 15]; ORed into the mantissa of bf16 128.0
// (0x4300) it gives the bf16 136 + n exactly, and one bf16x2 subtraction of
// 136 leaves n.  (w & 0x000F000F) ^ 0x43084308 does the mask, the XOR and
// the OR for two values in one LOP3; shifting the word by 4, 8 or 12 first
// picks the other nibbles.
//
// Two kernels, chosen by the rows M (ops/int4_matmul.TILES mirrors the
// table in tile_rows below), each one launch per call:
//   rows kernel, M <= 64 (decode, verify rounds): bound by the packed bytes
//     (half a byte per weight, 4 flops per byte at M = 8).  The product is
//     taken transposed: a 16-column slice of the weight is the 16-row A
//     operand of mma.m16n8k16 and 8 rows of x the B operand, so decode's 8
//     rows fill it with no padded row; a block takes 8, 16 or 32 rows (33-64
//     rows run as two 32-row tiles).  Four warps, 128 columns; a cp.async
//     ring of 3 stages of 128 packed rows (two in flight while one computes;
//     23-37 KB a stage, 2-3 blocks per SM).  The weight fragments are built
//     in registers: one 32-bit shared load of 4 packed rows of a column gives
//     the low half's fragment (low nibbles) and the high half's (high
//     nibbles), because the k order inside each 16-row step is permuted --
//     physical rows p, p+2 are the fragment's k 2t, 2t+1 and p+1, p+3 its
//     k 2t+8, 2t+9 -- and the x fragment follows the same permutation (one
//     64-bit load and two byte permutes).  Nothing unpacked is stored.
//   wgmma kernel, 64 < M <= 1024 (chunked prefill, prefill): bound by
//     operations.  Eight warps on 128 rows by 128 columns; the K loop walks
//     units (group j, low half), (group j, high half), ...; each stage of up
//     to 64 packed rows is converted ONCE per block into a bf16 tile in
//     shared memory (the unit's nibble), so the conversion is shared by all
//     of the block's rows; two converted tiles, so stage st+1 is converted
//     while stage st's products run.  Hopper's warpgroup product: two
//     warpgroups, each m64n128k16 with x from registers (ldmatrix) and the
//     converted tile read through a shared-memory descriptor; the products of
//     a stage run asynchronously while the block converts the next stage.  A
//     unit's f32 partial stays in registers and is scaled into the
//     accumulator at the unit's end; a 4-stage cp.async ring carries packed
//     bytes, x and the unit's scale row.
// Split-K: where the (N, M) tiles are fewer than the card wants blocks,
// ops/int4_matmul.splits_for divides the groups among blocks.  Each block
// writes its f32 partial; the last block of a tile to finish (a per-tile
// counter in a persistent buffer, which that block resets to 0) sums the
// splits' partials in split order and writes the output.  Two calls give
// the same bits.  Launches that share a workspace and counters run in order
// on one stream (ops/kernels.fold_buffers keeps a pair per stream).

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BN = 128;  // output columns per block

using mmu::cp_async16;
using mmu::cp_async4;
using mmu::cp_async_commit;
using mmu::cp_async_wait;
using mmu::mma_bf16;

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* q4;
  const float* s;
  void* out;      // [M,N] bf16 or f32
  float* ws;      // [splits,M,N] f32 partials (splits > 1)
  int* counters;  // one per (N, M) tile, 0 between calls (splits > 1)
  int M, K2, N, G, per, splits;
};

// low nibbles of bytes 0 and 2 of w -> bf16x2 of their signed values
__device__ __forceinline__ uint32_t nib02_bf16x2(uint32_t w) {
  const uint32_t biased = (w & 0x000F000Fu) ^ 0x43084308u;  // bf16 136 + n, twice
  const uint32_t k136 = 0x43084308u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <typename T>
__device__ __forceinline__ void store(T* p, float v);
template <>
__device__ __forceinline__ void store<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One fragment element pair of the epilogue: rows m, columns n, n+1 of the
// tile, to the output (one split) or the workspace (several).
template <typename OutT>
__device__ __forceinline__ void put(const Args& a, int split, int m, int n, float v0, float v1) {
  if (m >= a.M) return;
  const size_t at = static_cast<size_t>(m) * a.N + n;
  if (a.splits > 1) {
    float* w = a.ws + static_cast<size_t>(split) * a.M * a.N + at;
    if (n < a.N) w[0] = v0;
    if (n + 1 < a.N) w[1] = v1;
  } else {
    OutT* o = reinterpret_cast<OutT*>(a.out) + at;
    if (n < a.N) store<OutT>(o, v0);
    if (n + 1 < a.N) store<OutT>(o + 1, v1);
  }
}

// After every block of a tile wrote its partial: the last one to arrive sums
// the partials in split order, writes the output and resets the counter.
// The block's barrier orders its threads' partial stores before thread 0's
// release of the count; the last block acquires it before reading, with
// every partial load of a thread (up to 8 splits of 2 x 4 columns) in flight
// before the first sum.
template <typename OutT>
__device__ __forceinline__ void fold_splits(const Args& a, int m0, int bm, int n0) {
  __shared__ int last;
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = mmu::atomic_add_acq_rel(a.counters + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  const int rows = min(bm, a.M - m0), cols = min(BN, a.N - n0);
  const size_t mn = static_cast<size_t>(a.M) * a.N;
  OutT* out = reinterpret_cast<OutT*>(a.out);
  if (a.N % 4 == 0) {  // 16-byte loads: cols is a multiple of 4 too
    const int groups = cols / 4, total = rows * groups;
    for (int i0 = threadIdx.x; i0 < total; i0 += 2 * blockDim.x) {
      size_t at[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = min(i0 + e * static_cast<int>(blockDim.x), total - 1);
        const int r = i / groups, c = (i - r * groups) * 4;
        at[e] = static_cast<size_t>(m0 + r) * a.N + n0 + c;
      }
      float4 v[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      for (int sp0 = 0; sp0 < a.splits; sp0 += 8) {
        float4 p[8][2];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (sp0 + u < a.splits)
              p[u][e] = __ldcg(reinterpret_cast<const float4*>(a.ws + (sp0 + u) * mn + at[e]));
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (sp0 + u < a.splits) {
              v[e].x += p[u][e].x;
              v[e].y += p[u][e].y;
              v[e].z += p[u][e].z;
              v[e].w += p[u][e].w;
            }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (i0 + e * static_cast<int>(blockDim.x) >= total) break;
        store<OutT>(out + at[e], v[e].x);
        store<OutT>(out + at[e] + 1, v[e].y);
        store<OutT>(out + at[e] + 2, v[e].z);
        store<OutT>(out + at[e] + 3, v[e].w);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      const size_t at = static_cast<size_t>(m0 + r) * a.N + n0 + c;
      float v = 0.f;
      for (int sp = 0; sp < a.splits; ++sp) v += __ldcg(a.ws + sp * mn + at);
      store<OutT>(out + at, v);
    }
  }
  if (threadIdx.x == 0) a.counters[tile] = 0;
}

// ------------------------------------------------------------- rows kernel
// The product is taken transposed, y^T = W^T x^T: a 16-column slice of the
// weight is the 16-row A operand of mma.m16n8k16 and 8 rows of x the 8-column
// B operand, so decode's 8 rows fill the product with no padded rows.
constexpr int R_THREADS = 128;
constexpr int R_NT = BN / 4 / 16;      // 16-column weight slices per warp
constexpr int R_KS = 128;              // packed rows per stage
constexpr int R_NSTAGE = 3;            // the ring: two stages in flight while one computes
constexpr int R_W_STRIDE = R_KS + 16;  // bytes per column (conflict-free 32-bit loads)
constexpr int R_X_STRIDE = R_KS + 16;  // bf16 per x row (conflict-free 64-bit loads)

template <int MT8>  // 8-row tiles of x: 1, 2 or 4
struct RowsLayout {
  static constexpr int BM = 8 * MT8;
  static constexpr int W_BYTES = BN * R_W_STRIDE;
  static constexpr int X_BYTES = 2 * BM * R_X_STRIDE * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int SMEM = R_NSTAGE * STAGE;
};

// packed rows [r0, r0 + kb) of the block's columns and both halves' x.
// Every copy is 16 bytes; a thread's chunks follow from its index by shifts
// alone (the chunk counts are constants), and the chunks past kb of a short
// last stage are skipped (no k-step reads them).
template <int MT8>
__device__ __forceinline__ void rows_load(const Args& a, char* stage, int r0, int kb, int m0,
                                          int n0) {
  using L = RowsLayout<MT8>;
  uint8_t* sw = reinterpret_cast<uint8_t*>(stage);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(stage + L::W_BYTES);
  constexpr int WC = R_KS / 16;  // 16-byte chunks of a column
  const int c = threadIdx.x % WC;
  if (c * 16 < kb) {
#pragma unroll
    for (int j = 0; j < BN * WC / R_THREADS; ++j) {
      const int n = threadIdx.x / WC + j * (R_THREADS / WC);
      const int gn = n0 + n;
      cp_async16(sw + n * R_W_STRIDE + c * 16,
                 a.q4 + static_cast<size_t>(min(gn, a.N - 1)) * a.K2 + r0 + c * 16,
                 gn < a.N ? 16 : 0);
    }
  }
  constexpr int XC = R_KS / 8;  // 16-byte chunks of an x row's stage columns
  static_assert(2 * L::BM * XC % R_THREADS == 0, "x chunks per thread");
#pragma unroll
  for (int j = 0; j < 2 * L::BM * XC / R_THREADS; ++j) {
    const int i = threadIdx.x + j * R_THREADS;
    const int cx = i % XC, hr = i / XC;
    const int h = hr / L::BM, r = hr % L::BM;
    const int gm = m0 + r;
    if (cx * 8 < kb)
      cp_async16(sx + (h * L::BM + r) * R_X_STRIDE + cx * 8,
                 a.x + static_cast<size_t>(min(gm, a.M - 1)) * (2 * a.K2) + h * a.K2 + r0 + cx * 8,
                 gm < a.M ? 16 : 0);
  }
}

// one output element (row m, column n) to the output or the workspace
template <typename OutT>
__device__ __forceinline__ void put1(const Args& a, int split, int m, int n, float v) {
  if (m >= a.M || n >= a.N) return;
  const size_t at = static_cast<size_t>(m) * a.N + n;
  if (a.splits > 1)
    a.ws[static_cast<size_t>(split) * a.M * a.N + at] = v;
  else
    store<OutT>(reinterpret_cast<OutT*>(a.out) + at, v);
}

template <int MT8, typename OutT>
__global__ void __launch_bounds__(R_THREADS) int4_matmul_rows_kernel(Args a) {
  using L = RowsLayout<MT8>;
  extern __shared__ __align__(16) char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * L::BM, split = blockIdx.z;
  const int gh = a.K2 / a.G;
  const int r_begin = split * a.per * a.G, r_end = min(gh, (split + 1) * a.per) * a.G;
  const int n_stages = (r_end - r_begin + R_KS - 1) / R_KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = warp * (R_NT * 16);  // the warp's first column in the tile

  // C fragments: (column wn + 16t + gid (+8), rows 8mt + 2tig (+1))
  float acc[R_NT][MT8][4], plo[R_NT][MT8][4], phi[R_NT][MT8][4];
#pragma unroll
  for (int t = 0; t < R_NT; ++t)
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][mt][e] = plo[t][mt][e] = phi[t][mt][e] = 0.f;
  float slo[R_NT][2], shi[R_NT][2];  // scales of columns gid and gid + 8 of each slice
  int gpos = 0;  // rows of the current group done (the split starts at a group)

#pragma unroll
  for (int st = 0; st < R_NSTAGE - 1; ++st) {
    if (st < n_stages) {
      const int r0 = r_begin + st * R_KS;
      rows_load<MT8>(a, smem + st * L::STAGE, r0, min(R_KS, r_end - r0), m0, n0);
    }
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<R_NSTAGE - 2>();
    __syncthreads();
    {
      const int nx = st + R_NSTAGE - 1;
      if (nx < n_stages) {
        const int r0 = r_begin + nx * R_KS;
        rows_load<MT8>(a, smem + (nx % R_NSTAGE) * L::STAGE, r0, min(R_KS, r_end - r0), m0, n0);
      }
      cp_async_commit();
    }
    const char* stage = smem + (st % R_NSTAGE) * L::STAGE;
    const uint8_t* sw = reinterpret_cast<const uint8_t*>(stage);
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(stage + L::W_BYTES);
    const int r0 = r_begin + st * R_KS, kb = min(R_KS, r_end - r0);
    for (int k = 0; k < kb; k += 16) {
      if (gpos == 0) {  // a group starts: fetch its scale rows for this thread's columns
        const int j = (r0 + k) / a.G;
#pragma unroll
        for (int t = 0; t < R_NT; ++t) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn + t * 16 + gid + 8 * e;
            const bool ok = n < a.N;
            slo[t][e] = ok ? __ldg(a.s + static_cast<size_t>(j) * a.N + n) : 0.f;
            shi[t][e] = ok ? __ldg(a.s + static_cast<size_t>(gh + j) * a.N + n) : 0.f;
          }
        }
      }
      // x as the B operand, k permuted as the packed bytes are: b[0] holds
      // physical rows (p, p+2), b[1] (p+1, p+3), p = k + 4 tig
      uint32_t blo[MT8][2], bhi[MT8][2];
#pragma unroll
      for (int mt = 0; mt < MT8; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 u = *reinterpret_cast<const uint2*>(
              sx + (h * L::BM + mt * 8 + gid) * R_X_STRIDE + k + 4 * tig);
          uint32_t* bf = h ? bhi[mt] : blo[mt];
          bf[0] = __byte_perm(u.x, u.y, 0x5410);
          bf[1] = __byte_perm(u.x, u.y, 0x7632);
        }
      }
#pragma unroll
      for (int t = 0; t < R_NT; ++t) {
        // columns gid and gid + 8 of the slice: 4 packed rows each, both halves
        const uint8_t* col = sw + (wn + t * 16 + gid) * R_W_STRIDE + k + 4 * tig;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(col);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(col + 8 * R_W_STRIDE);
        const uint32_t alo[4] = {nib02_bf16x2(w0), nib02_bf16x2(w1), nib02_bf16x2(w0 >> 8),
                                 nib02_bf16x2(w1 >> 8)};
        const uint32_t ahi[4] = {nib02_bf16x2(w0 >> 4), nib02_bf16x2(w1 >> 4),
                                 nib02_bf16x2(w0 >> 12), nib02_bf16x2(w1 >> 12)};
#pragma unroll
        for (int mt = 0; mt < MT8; ++mt) {
          mma_bf16(plo[t][mt], alo, blo[mt]);
          mma_bf16(phi[t][mt], ahi, bhi[mt]);
        }
      }
      gpos += 16;
      if (gpos == a.G) {  // the group ends: acc + lo * s_lo + hi * s_hi
        gpos = 0;
#pragma unroll
        for (int t = 0; t < R_NT; ++t)
#pragma unroll
          for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[t][mt][e] += plo[t][mt][e] * slo[t][e >> 1];
              acc[t][mt][e] += phi[t][mt][e] * shi[t][e >> 1];
              plo[t][mt][e] = phi[t][mt][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int t = 0; t < R_NT; ++t)
#pragma unroll
    for (int mt = 0; mt < MT8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        put1<OutT>(a, split, m0 + mt * 8 + 2 * tig + (e & 1), n0 + wn + t * 16 + gid + 8 * (e >> 1),
                   acc[t][mt][e]);
  if (a.splits > 1) fold_splits<OutT>(a, m0, L::BM, n0);
}

// ------------------------------------------------------------- wgmma kernel
constexpr int T_THREADS = 256;  // 8 warps: two warpgroups
constexpr int T_NSTAGE = 4;     // the ring: packed bytes, x and scales

// KS: packed rows a stage holds, the largest of 64, 32, 16 dividing G (a
// stage never spans groups).
// Hopper's warpgroup product for the 128-row tiles: each of two warpgroups
// multiplies its 64 rows of x (A, from registers: the mma.m16n8k16 A fragment
// of each warp, loaded with ldmatrix) by the converted weight tile (B, read by
// the tensor cores from shared memory through a descriptor, K-major, no
// swizzle: 8 x 16-byte core matrices, those adjacent along k 128 bytes apart,
// those adjacent along n KS*16 bytes apart), m64n128k16 per instruction.  The
// products of a stage run asynchronously while the block converts the next
// stage's nibbles into the other tile.
// acc[64] (+)= A (16 rows of this warp, mma.m16n8k16 A fragment) x B (smem
// descriptor, 16 x 128, K-major); scale_d 0 overwrites acc
__device__ __forceinline__ void wgmma_m64n128k16(float* acc, const uint32_t* a, uint64_t desc,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
        "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
        "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
        "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
        "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
        "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
        "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;  // no swizzle, base offset 0
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving register reads or writes across the
// asynchronous products
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int KS_>
struct WgLayout {
  static constexpr int BM = 128;
  static constexpr int XSTRIDE = KS_ + 8;    // bf16 per x row (ldmatrix, conflict-free)
  static constexpr int PSTRIDE = KS_ + 16;   // bytes per column of packed bytes
  static constexpr int W_BYTES = BN * PSTRIDE;
  static constexpr int X_BYTES = BM * XSTRIDE * 2;
  static constexpr int S_BYTES = BN * 4;
  static constexpr int STAGE = W_BYTES + X_BYTES + S_BYTES;
  static constexpr int SBO = KS_ / 8 * 128;  // core matrices adjacent along n
  static constexpr int B_BYTES = BN * KS_ * 2;
  static constexpr int SMEM = T_NSTAGE * STAGE + 2 * B_BYTES;
};

template <int KS_>
__device__ __forceinline__ void wg_load(const Args& a, char* stage, int st, int spu, int g_begin,
                                        int m0, int n0) {
  using L = WgLayout<KS_>;
  const int u = st / spu, j = g_begin + u / 2, h = u & 1;
  const int r0 = j * a.G + (st - u * spu) * KS_;  // packed row
  uint8_t* sw = reinterpret_cast<uint8_t*>(stage);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(stage + L::W_BYTES);
  float* ss = reinterpret_cast<float*>(stage + L::W_BYTES + L::X_BYTES);
  constexpr int WC = KS_ / 16;
#pragma unroll
  for (int i = threadIdx.x; i < BN * WC; i += T_THREADS) {
    const int n = i / WC, c = i % WC;
    const int gn = n0 + n;
    cp_async16(sw + n * L::PSTRIDE + c * 16,
               a.q4 + static_cast<size_t>(min(gn, a.N - 1)) * a.K2 + r0 + c * 16,
               gn < a.N ? 16 : 0);
  }
  constexpr int XC = KS_ / 8;
#pragma unroll
  for (int i = threadIdx.x; i < L::BM * XC; i += T_THREADS) {
    const int r = i / XC, c = i % XC;
    const int gm = m0 + r;
    cp_async16(sx + r * L::XSTRIDE + c * 8,
               a.x + static_cast<size_t>(min(gm, a.M - 1)) * (2 * a.K2) + h * a.K2 + r0 + c * 8,
               gm < a.M ? 16 : 0);
  }
  if (threadIdx.x < BN) {
    const int gn = n0 + threadIdx.x;
    const int gh = a.K2 / a.G;
    cp_async4(ss + threadIdx.x, a.s + static_cast<size_t>(h * gh + j) * a.N + min(gn, a.N - 1),
              gn < a.N ? 4 : 0);
  }
}

template <int KS_, typename OutT>
__global__ void __launch_bounds__(T_THREADS, 1) int4_matmul_wg_kernel(Args a) {
  using L = WgLayout<KS_>;
  extern __shared__ __align__(128) char smem[];
  char* sb0 = smem + T_NSTAGE * L::STAGE;  // two converted tiles (core-matrix layout)
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * L::BM, split = blockIdx.z;
  const int gh = a.K2 / a.G;
  const int g_begin = split * a.per, g_end = min(gh, g_begin + a.per);
  const int spu = a.G / KS_;  // stages per unit
  const int n_stages = 2 * (g_end - g_begin) * spu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16;  // this warp's 16 rows

  float acc[64], part[64];  // (row gid / gid + 8, columns 8j + 2 tig, +1) for j < 16
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // this stage's nibbles (one half) -> bf16 core matrices at `dst`
  auto convert = [&](int st, char* dst) {
    const uint8_t* sw = reinterpret_cast<const uint8_t*>(smem + (st % T_NSTAGE) * L::STAGE);
    const bool hi = (st / spu) & 1;
#pragma unroll
    for (int i = threadIdx.x; i < BN * (KS_ / 8); i += T_THREADS) {
      const int n = i % BN, c = i / BN;
      uint2 w = *reinterpret_cast<const uint2*>(sw + n * L::PSTRIDE + c * 8);
      if (hi) {
        w.x >>= 4;
        w.y >>= 4;
      }
      uint4 o;
      o.x = nib02_bf16x2(__byte_perm(w.x, 0u, 0x4140));
      o.y = nib02_bf16x2(__byte_perm(w.x, 0u, 0x4342));
      o.z = nib02_bf16x2(__byte_perm(w.y, 0u, 0x4140));
      o.w = nib02_bf16x2(__byte_perm(w.y, 0u, 0x4342));
      *reinterpret_cast<uint4*>(dst + (n / 8) * L::SBO + c * 128 + (n % 8) * 16) = o;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

#pragma unroll
  for (int st = 0; st < T_NSTAGE - 1; ++st) {
    if (st < n_stages) wg_load<KS_>(a, smem + st * L::STAGE, st, spu, g_begin, m0, n0);
    cp_async_commit();
  }
  cp_async_wait<T_NSTAGE - 2>();
  __syncthreads();
  convert(0, sb0);
  int upos = 0;  // stages of the current unit done
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<T_NSTAGE - 3>();
    // stage st+1 landed; stage st is converted; stage st-1's products are done
    __syncthreads();
    const char* stage = smem + (st % T_NSTAGE) * L::STAGE;
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(stage + L::W_BYTES);
    uint32_t af[KS_ / 16][4];
#pragma unroll
    for (int ks = 0; ks < KS_ / 16; ++ks)
      mmu::ldmatrix_x4(af[ks], sx + (row0 + (lane & 15)) * L::XSTRIDE + ks * 16 + (lane >> 4) * 8);
    const char* sb = sb0 + (st & 1) * L::B_BYTES;
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS_ / 16; ++ks)  // a unit's first product overwrites the partial
      wgmma_m64n128k16(part, af[ks], smem_desc(sb + ks * 256, 128, L::SBO),
                       upos > 0 || ks > 0);
    wgmma_commit();
    if (st + 1 < n_stages) convert(st + 1, sb0 + ((st + 1) & 1) * L::B_BYTES);
    {
      const int nx = st + T_NSTAGE - 1;
      if (nx < n_stages)
        wg_load<KS_>(a, smem + (nx % T_NSTAGE) * L::STAGE, nx, spu, g_begin, m0, n0);
      cp_async_commit();
    }
    wgmma_wait_all();
    pin(part);
    if (++upos == spu) {  // the unit ends: its scale row multiplies its partial
      upos = 0;
      const float* ss = reinterpret_cast<const float*>(stage + L::W_BYTES + L::X_BYTES);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i] * ss[(i >> 2) * 8 + 2 * tig + (i & 1)];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + row0 + gid, n = n0 + 8 * j + 2 * tig;
    put<OutT>(a, split, m, n, acc[4 * j], acc[4 * j + 1]);
    put<OutT>(a, split, m + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (a.splits > 1) fold_splits<OutT>(a, m0, L::BM, n0);
}

// ------------------------------------------------------------- launchers
// block rows by M: 33-64 rows run as two 32-row tiles of the rows kernel
int tile_rows(int M) { return M <= 8 ? 8 : M <= 16 ? 16 : M <= 64 ? 32 : 128; }

template <typename K>
cudaError_t run(K kernel, dim3 grid, int threads, int smem, cudaStream_t st, const Args& a) {
  cudaError_t err = mmu::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t wg(dim3 grid, cudaStream_t st, const Args& a) {
  if (a.G % 64 == 0)
    return run(int4_matmul_wg_kernel<64, OutT>, grid, T_THREADS, WgLayout<64>::SMEM, st, a);
  if (a.G % 32 == 0)
    return run(int4_matmul_wg_kernel<32, OutT>, grid, T_THREADS, WgLayout<32>::SMEM, st, a);
  return run(int4_matmul_wg_kernel<16, OutT>, grid, T_THREADS, WgLayout<16>::SMEM, st, a);
}

template <typename OutT>
cudaError_t dispatch(const Args& a, cudaStream_t st) {
  const int bm = tile_rows(a.M);
  const dim3 grid((a.N + BN - 1) / BN, (a.M + bm - 1) / bm, a.splits);
  if (bm == 8)
    return run(int4_matmul_rows_kernel<1, OutT>, grid, R_THREADS, RowsLayout<1>::SMEM, st, a);
  if (bm == 16)
    return run(int4_matmul_rows_kernel<2, OutT>, grid, R_THREADS, RowsLayout<2>::SMEM, st, a);
  if (bm == 32)
    return run(int4_matmul_rows_kernel<4, OutT>, grid, R_THREADS, RowsLayout<4>::SMEM, st, a);
  return wg<OutT>(grid, st, a);
}

}  // namespace

// x [M,2*K2] bf16 contiguous, 16-byte aligned; q4 [K2,N] int8 stored
// K2-contiguous (column n at q4 + n*K2), 16-byte aligned; s [2*K2/G,N] f32
// contiguous; out [M,N] bf16 (out_f32 = 0) or f32 contiguous.  G % 16 == 0,
// G <= 128, K2 % G == 0; the groups are divided into `splits` runs of `per`
// (the last may be shorter, none empty).  With splits > 1: ws [splits,M,N]
// f32 and counters (one int per (N, M) tile, all 0; the kernel leaves them
// 0), on the launch's stream alone.
extern "C" int mmu_int4_matmul(const void* x, const void* q4, const float* s, void* out,
                               float* ws, int* counters, int M, int K2, int N, int G, int per,
                               int splits, int out_f32, void* stream) {
  if (M <= 0 || N <= 0 || G <= 0 || G % 16 || G > 128 || K2 % G) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int gh = K2 / G;
  if (splits < 1 || per < 1 || static_cast<long long>(per) * splits < gh ||
      static_cast<long long>(per) * (splits - 1) >= gh ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4), s, out, ws,
               counters, M, K2, N, G, per, splits};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? dispatch<float>(a, st) : dispatch<__nv_bfloat16>(a, st));
}
