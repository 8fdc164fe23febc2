// flash on the tensor cores, for hd in {64, 128, 256}: the two kernels that
// flash.cu's entry point takes for those head sizes.
//
// Both compute what flash_fwd_kernel (flash.cu) computes: the same masking
// (scores masked by causality or the window set to -2^30, keys past S to
// -inf), the tanh softcap, the grouped-query row map, fp32 online-softmax
// statistics, the output in the input type, ragged S masked in the kernel and
// tiles masked whole by causality or the window skipped (exact, for the
// reason flash.cu gives).  The next K/V tile is loaded while the current one
// is used.  Scores are checked against the masks only in tiles that hold a
// masked pair, and elsewhere the scale folds into the exponent; exp is 2^x
// on the special-function unit.  Blocks are ordered so the query tiles with
// the most keys start first.
//
// What bounds them on an H100: at the LM shapes the work is 4 * S^2 * hd
// operations per row of heads (half under causality) against 4 * S * hd
// values moved: operations in bf16 (989 TFLOP/s), bytes or operations in
// split TF32 (495 / 3 = 165 TFLOP/s), depending on S.
//
// fp32, flash_tf32x3_kernel: mma.sync.m16n8k8 in TF32 with the split-TF32
// scheme.  Plain TF32 keeps 10 mantissa bits, about three decimal digits, and
// would miss the fp32 tolerance (rtol 1e-4 / atol 2e-5) at hd 128.  So each
// operand x is split as hi = tf32(x), lo = tf32(x - hi), both rounded with
// cvt.rna, and each product is taken as lo.hi + hi.lo + hi.hi (small terms
// first) into fp32 accumulators; the dropped lo.lo term is below 2^-22 of the
// product.  Why mma.sync and not wgmma: TF32 wgmma takes K-major operands
// only, so V would have to be transposed in shared memory, and both split
// halves of K and V would have to live there: at hd 128 with 64-key tiles
// that is 64 KB per tensor per stage, 256 KB for a two-stage ring, more than
// the 227 KB a block may hold.  mma.sync takes its operands from registers,
// so the tiles stay in shared memory once, in fp32, and each thread splits
// its fragments as it loads them.  Each warp owns 16 query rows (8 warps a
// block at hd 64, 4 at hd 128 and 256); S = Q.K^T and O += P.V are 16 x 8 x 8
// products with no branch among them, and a warp skips a tile that none of
// its rows keeps.  K and V tiles stream through a two-stage ring.  The k
// index of a product is permuted so that a thread's two k values are
// neighbours in memory: for Q.K^T, fragment column t is head dim 2t and
// t + 4 is 2t + 1 (one float2 load); for P.V, the S accumulator's key
// columns 2t, 2t + 1 become the A fragment's columns t, t + 4 as they stand,
// and V is read at the same keys.  Rows of Q and K are padded to hd + 8
// floats and rows of V to hd + 4, which makes every fragment load free of
// bank conflicts; tiles come in by cp.async, since a TMA box cannot pad
// rows.
//
// bf16, flash_wgmma_kernel: wgmma with bf16 operands.  One block holds two
// warpgroups, each owning 64 query rows; K and V stream through two-stage
// rings.  The Tensor Memory Accelerator (TMA) fills them: one thread issues a
// tile as boxes of 64 head dims, which land with the 128-byte swizzle wgmma
// reads, and completion is counted on one mbarrier a stage, so no thread spends
// instructions on the copies.  S = Q.K^T is wgmma m64n{BK}k16 with both
// operands K-major from shared memory; the online softmax runs on the
// accumulator fragments in registers (row max and sum over the four threads of
// a quad); P is rounded to bf16 in registers and O += P.V is wgmma m64n{hd}k16
// with A from registers and V read MN-major through the descriptor's transpose
// bit.  Within a warpgroup S of tile i and P.V of tile i - 1 are issued
// together and the softmax of tile i overlaps P.V.  Rounding P to bf16 is a
// numerical difference from the TPU kernel, which keeps P in fp32: it adds a
// relative error of at most 2^-9 to each weight, inside the bf16 tolerance
// (rtol 3e-2 / atol 3e-2); l sums the fp32 P.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace tc {

constexpr float kNeg = -1073741824.0f;  // -2^30, the TPU kernel's masked score

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = full ? 16 : 0;           // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22); exp(x) is
// taken as 2^((x - m) * log2 e), with the subtraction first so a masked
// score minus a masked max is exactly 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The scaled, capped score.
__device__ __forceinline__ float capped(float acc, float scale,
                                       float softcap) {
  const float x = acc * scale;
  return softcap > 0.f ? tanhf(x / softcap) * softcap : x;
}

// The masked, capped, scaled score of (query qi, key kj).
__device__ __forceinline__ float score(float acc, int qi, int kj, int S,
                                       float scale, int causal, int window,
                                       float softcap) {
  if (kj >= S) return -INFINITY;                 // past the sequence
  if ((causal && kj > qi) || (window > 0 && qi - kj >= window)) return kNeg;
  return capped(acc, scale, softcap);
}

// Keys [k0, k0 + n) against query rows [r0, r1]: no pair is kept, so the
// keys may be skipped, which adds exactly what masked scores add, nothing,
// once each row's own key is seen.
__device__ __forceinline__ bool keys_dead(int k0, int n, int r0, int r1,
                                          int S, int causal, int window) {
  return k0 >= S || (causal && k0 > r1) ||
         (window > 0 && r0 - (k0 + n - 1) >= window);
}
// ... or some pair is masked or past S, so each score must be checked.
__device__ __forceinline__ bool keys_masked(int k0, int n, int r0, int r1,
                                            int S, int causal, int window) {
  return k0 + n > S || (causal && k0 + n - 1 > r0) ||
         (window > 0 && r1 - k0 >= window);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The key range a block of query rows [q0, q0 + bq) visits, in whole tiles.
__device__ __forceinline__ void key_range(int q0, int bq, int bk, int S,
                                          int causal, int window, int& begin,
                                          int& end) {
  end = causal ? min(S, q0 + bq) : S;
  begin = window > 0 ? max(0, q0 - window + 1) / bk * bk : 0;
}

// ------------------------------------------------------------ fp32, TF32 x3
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b with a and b split: lo.hi + hi.lo + hi.hi.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[2]) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b[0], bh0, bl0);
  split_tf32(b[1], bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Rows [r0, r0 + R) of a row-major (S, HD) fp32 slice into shared memory
// with row stride LD floats; rows at or past S are zeros.
template <int HD, int LD, int R, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int r0, int S) {
  constexpr int C = HD / 4;                      // 16-byte chunks per row
#pragma unroll 4
  for (int i = threadIdx.x; i < R * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool in = r0 + r < S;
    cp_async16(dst + r * LD + 4 * c,
               src + (long long)(in ? r0 + r : 0) * HD + 4 * c, in);
  }
}

template <int HD, int NW, int BK>
struct Tf32Cfg {
  static constexpr int BQ = 16 * NW;
  static constexpr int LDQ = HD + 8, LDK = HD + 8, LDV = HD + 4;
  static constexpr size_t smem =
      sizeof(float) * (size_t)(BQ * LDQ + 2 * BK * LDK + 2 * BK * LDV);
};

// NW warps own 16 query rows each; K and V tiles of BK keys stream through a
// two-stage ring.
template <int HD, int NW, int BK>
__global__ void __launch_bounds__(NW * 32)
    flash_tf32x3_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        int BH, int H, int KV, int S, int n_q, float scale,
                        int causal, int window, float softcap) {
  using Cfg = Tf32Cfg<HD, NW, BK>;
  constexpr int BQ = Cfg::BQ, LDQ = Cfg::LDQ, LDK = Cfg::LDK,
                LDV = Cfg::LDV, NT = NW * 32;
  constexpr int NS = BK / 8, NO = HD / 8;  // 8-wide column blocks of S and O
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                           // (BQ, LDQ)
  float* sk = sq + BQ * LDQ;                  // 2 stages of (BK, LDK)
  float* sv = sk + 2 * BK * LDK;              // 2 stages of (BK, LDV)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - (int)(blockIdx.x / BH)) * BQ;
  const long long kv_row = (bh / H) * KV + (bh % H) / (H / KV);
  const float* qb = q + bh * S * HD;
  const float* kb = k + kv_row * S * HD;
  const float* vb = v + kv_row * S * HD;

  int k_begin, k_end;
  key_range(q0, BQ, BK, S, causal, window, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  load_rows_f32<HD, LDQ, BQ, NT>(sq, qb, q0, S);
  load_rows_f32<HD, LDK, BK, NT>(sk, kb, k_begin, S);
  load_rows_f32<HD, LDV, BK, NT>(sv, vb, k_begin, S);
  cp_async_commit();

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int row0 = warp * 16 + g;             // this thread's rows: +0, +8
  const int r0 = q0 + warp * 16, r1 = r0 + 15;  // this warp's rows

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      load_rows_f32<HD, LDK, BK, NT>(sk + nb * BK * LDK, kb, k0 + BK, S);
      load_rows_f32<HD, LDV, BK, NT>(sv + nb * BK * LDV, vb, k0 + BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* K = sk + (it & 1) * BK * LDK;
    const float* V = sv + (it & 1) * BK * LDV;
    // a tile that no row of this warp keeps is skipped by the warp
    if (!keys_dead(k0, BK, r0, r1, S, causal, window)) {
      // S = Q . K^T, 16 x BK for this warp
      float sacc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float* qr = sq + row0 * LDQ + kk * 8 + 2 * t;
        const float2 a0 = *reinterpret_cast<const float2*>(qr);
        const float2 a1 = *reinterpret_cast<const float2*>(qr + 8 * LDQ);
        // columns t, t + 4 of the fragment are head dims 2t, 2t + 1
        const float a[4] = {a0.x, a1.x, a0.y, a1.y};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 bb = *reinterpret_cast<const float2*>(
              K + (n * 8 + g) * LDK + kk * 8 + 2 * t);
          const float b[2] = {bb.x, bb.y};
          mma_tf32x3(sacc[n], ah, al, b);
        }
      }

      // online softmax on the fragments: element (n, e) is row
      // row0 + 8 (e / 2), key k0 + 8 n + 2 t + e % 2
      // plain: no masked pair and no cap, so the scale folds into the exp
      const bool plain = !keys_masked(k0, BK, r0, r1, S, causal, window) &&
                         !(softcap > 0.f);
      if (!plain) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[n][e] = score(sacc[n][e], q0 + row0 + 8 * (e / 2),
                               k0 + 8 * n + 2 * t + e % 2, S, scale, causal,
                               window, softcap);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sacc[n][e]);
      float alpha[2], rs[2] = {0.f, 0.f}, ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // max(acc) * scale is max(acc * scale): scale > 0, rounding monotone
        const float tile_max = quad_max(mx[r]) * (plain ? scale : 1.f);
        const float m_new = fmaxf(m[r], tile_max);
        alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        ml[r] = m_new * kLog2e;
      }
      const float c = scale * kLog2e;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(
              plain ? fmaf(sacc[n][e], c, -ml[e / 2])
                    : (sacc[n][e] - m[e / 2]) * kLog2e);
          sacc[n][e] = p;
          rs[e / 2] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] *= alpha[e / 2];

      // O += P . V: the S fragment's keys 2t, 2t + 1 are columns t, t + 4
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float a[4] = {sacc[j][0], sacc[j][2], sacc[j][1], sacc[j][3]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
        const float* vr = V + (j * 8 + 2 * t) * LDV + g;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float b[2] = {vr[n * 8], vr[LDV + n * 8]};
          mma_tf32x3(oacc[n], ah, al, b);
        }
      }
    }
    __syncthreads();                 // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = o + (bh * S + qi) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------ bf16, wgmma
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading byte offset (LBO) and stride byte offset (SBO), in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
// One arrival that also expects `bytes` from the tensor copies to follow.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Rows [row, row + R) of a (rows, HD) bf16 tensor by the Tensor Memory
// Accelerator, as HD / 64 boxes of (R, 64) laid one after another in dst,
// each row of a box 128 bytes with the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8)); rows past the tensor are zeros.  Completion
// is counted on bar.
template <int HD, int R>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst,
                                         const CUtensorMap* map, int row,
                                         uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < HD / 64; ++b)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_u32(dst + b * R * 64)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(b * 64), "r"(row),
        "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD, int BK>
struct WgmmaCfg {
  static constexpr int BQ = 128, NT = 256;
  // the tiles, and 1 KB to align them to the swizzle's 1024-byte pattern
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(BQ * HD + 4 * BK * HD) + 1024;
};

// Two warpgroups own 64 query rows each; K and V tiles of BK keys stream
// through two-stage rings filled by the Tensor Memory Accelerator, one
// mbarrier a stage.  Within a warpgroup, S of tile i and P.V of tile i - 1
// are issued together, the softmax of tile i runs while P.V does, and only
// then is O rescaled and P of tile i packed.  Rows of K, V and Q past a
// head's S belong to the next head (or are zeros past the tensor): their
// scores are masked, their P is 0, and their outputs are not written.
template <int HD, int BK>
__global__ void __launch_bounds__(256)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int BH, int H, int KV,
                       int S, int n_q, float scale, int causal, int window,
                       float softcap) {
  using Cfg = WgmmaCfg<HD, BK>;
  constexpr int BQ = Cfg::BQ;
  constexpr int NS = BK / 2;                    // S accumulators a thread
  constexpr int KS = BK / 16;                   // k16 steps of P.V
  constexpr uint32_t kAtom = 1024;              // 8 swizzled 128-byte rows
  constexpr uint32_t kTileBytes = BK * HD * 2, kQBytes = BQ * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[4];     // K stages 0, 1; V 0, 1
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((kAtom - (smem_u32(smem_raw) & (kAtom - 1))) & (kAtom - 1)));
  __nv_bfloat16* sk = sq + BQ * HD;             // 2 stages of (BK, HD)
  __nv_bfloat16* sv = sk + 2 * BK * HD;         // 2 stages of (BK, HD)

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool leader = threadIdx.x == 0;
  const long long bh = blockIdx.x % BH;
  const int q0 = (n_q - 1 - (int)(blockIdx.x / BH)) * BQ;
  const int kv_row = (int)((bh / H) * KV + (bh % H) / (H / KV));

  int k_begin, k_end;
  key_range(q0, BQ, BK, S, causal, window, k_begin, k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int kv0 = kv_row * S + k_begin;         // tensor row of key k_begin

  float oacc[HD / 2], sacc[NS], alpha[2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sacc[i] = 0.f;
  uint32_t pa[KS][4];                           // P in bf16, A fragments
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int row0 = wg * 64 + warp * 16 + g;     // rows +0, +8 of the block
  const int r0 = q0 + wg * 64, r1 = r0 + 63;    // this warpgroup's rows

  // S = Q . K^T of tile it: K-major A and B, a k16 step is 32 bytes along
  // a swizzled 128-byte row, four to a 64-column box (SBO: the next eight
  // rows; LBO unused)
  auto issue_s = [&](int it) {
    const __nv_bfloat16* K = sk + (it & 1) * BK * HD;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BK>(
          sacc,
          sw128_desc(sq + (kk / 4) * BQ * 64 + wg * 64 * 64 + (kk % 4) * 16,
                     16, kAtom),
          sw128_desc(K + (kk / 4) * BK * 64 + (kk % 4) * 16, 16, kAtom),
          kk > 0);
    wgmma_commit();
  };
  // O += P . V of tile it: P from registers, V MN-major, a k16 step is 16
  // keys, two swizzled atoms down (SBO: the next eight keys; LBO: the next
  // 64 head dims)
  auto issue_pv = [&](int it) {
    const __nv_bfloat16* V = sv + (it & 1) * BK * HD;
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(oacc, pa[kk],
                   sw128_desc(V + kk * 16 * 64, BK * 128, kAtom));
    wgmma_commit();
  };
  // The online softmax of tile it on sacc (sacc[4 j + e] is row
  // row0 + 8 (e / 2), key k0 + 8 j + 2 t + e % 2): new m and l, the factor
  // alpha for O, and P in sacc.  O itself is not touched.
  auto softmax = [&](int it) {
    const int k0 = k_begin + it * BK;
    // plain: no masked pair and no cap, so the scale folds into the exp
    const bool plain =
        !keys_masked(k0, BK, r0, r1, S, causal, window) && !(softcap > 0.f);
    if (!plain) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        sacc[i] = score(sacc[i], q0 + row0 + 8 * ((i % 4) / 2),
                        k0 + 8 * (i / 4) + 2 * t + i % 2, S, scale, causal,
                        window, softcap);
    }
    float mx[2] = {-INFINITY, -INFINITY}, ml[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sacc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // max(acc) * scale is max(acc * scale): scale > 0, rounding monotone
      const float m_new =
          fmaxf(m[r], quad_max(mx[r]) * (plain ? scale : 1.f));
      alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
    }
    const float c = scale * kLog2e;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i % 4) / 2;
      const float p = exp2_approx(plain ? fmaf(sacc[i], c, -ml[r])
                                        : (sacc[i] - m[r]) * kLog2e);
      sacc[i] = p;
      rs[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
  };
  // O scaled by alpha and P packed, once P.V of the last tile is done
  auto rescale_pack = [&]() {
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] *= alpha[(i % 4) / 2];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] =
            pack_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
  };
  // the n-th fill of a stage completes its barrier's phase n
  auto wait_k = [&](int it) { mbar_wait(&bars[it & 1], (it >> 1) & 1); };
  auto wait_v = [&](int it) { mbar_wait(&bars[2 + (it & 1)], (it >> 1) & 1); };

  if (leader) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Q with K of tile 0, K of tile 1, V of tile 0
  if (leader) {
    mbar_expect(&bars[0], kQBytes + kTileBytes);
    tma_tile<HD, BQ>(sq, &tq, (int)bh * S + q0, &bars[0]);
    tma_tile<HD, BK>(sk, &tk, kv0, &bars[0]);
    if (n_tiles > 1) {
      mbar_expect(&bars[1], kTileBytes);
      tma_tile<HD, BK>(sk + BK * HD, &tk, kv0 + BK, &bars[1]);
    }
    mbar_expect(&bars[2], kTileBytes);
    tma_tile<HD, BK>(sv, &tv, kv0, &bars[2]);
  }
  wait_k(0);
  issue_s(0);
  wgmma_wait<0>();
  fence_regs(sacc);
  softmax(0);
  rescale_pack();

  for (int it = 1; it < n_tiles; ++it) {
    // every warpgroup is done with S of tile it - 1 and P.V of tile it - 2:
    // K stage (it + 1) % 2 takes tile it + 1, V stage it % 2 takes tile it
    __syncthreads();
    if (leader) {
      if (it + 1 < n_tiles) {
        mbar_expect(&bars[(it + 1) & 1], kTileBytes);
        tma_tile<HD, BK>(sk + ((it + 1) & 1) * BK * HD, &tk,
                         kv0 + (it + 1) * BK, &bars[(it + 1) & 1]);
      }
      mbar_expect(&bars[2 + (it & 1)], kTileBytes);
      tma_tile<HD, BK>(sv + (it & 1) * BK * HD, &tv, kv0 + it * BK,
                       &bars[2 + (it & 1)]);
    }
    wait_k(it);
    issue_s(it);
    wait_v(it - 1);
    issue_pv(it - 1);
    wgmma_wait<1>();                   // S of tile it (P.V runs on)
    fence_regs(sacc);
    softmax(it);
    wgmma_wait<0>();
    fence_regs(oacc);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) fence_regs(pa[kk]);
    rescale_pack();
  }
  wait_v(n_tiles - 1);
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(oacc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + (bh * S + qi) * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------ launches
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, hd) bf16 tensor in boxes of (box_rows, 64), 128-byte swizzle.
inline bool tile_map(CUtensorMap* map, const void* base, long long rows,
                     int hd, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || (uintptr_t)base % 16) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)hd, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)hd * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NW, int BK>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v,
                          void* o, int BH, int H, int KV, int S, float scale,
                          int causal, int window, float softcap,
                          cudaStream_t st) {
  using Cfg = Tf32Cfg<HD, NW, BK>;
  cudaError_t err = set_smem(flash_tf32x3_kernel<HD, NW, BK>, Cfg::smem);
  if (err != cudaSuccess) return err;
  const int n_q = (S + Cfg::BQ - 1) / Cfg::BQ;
  flash_tf32x3_kernel<HD, NW, BK>
      <<<(unsigned)((long long)BH * n_q), NW * 32, Cfg::smem, st>>>(
          (const float*)q, (const float*)k, (const float*)v, (float*)o, BH, H,
          KV, S, n_q, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <int HD, int BK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, int BH, int H, int KV, int S, float scale,
                         int causal, int window, float softcap,
                         cudaStream_t st) {
  using Cfg = WgmmaCfg<HD, BK>;
  const long long q_rows = (long long)BH * S;
  const long long kv_rows = (long long)BH / H * KV * S;
  if (q_rows >= (1ll << 31)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, q_rows, HD, Cfg::BQ) ||
      !tile_map(&tk, k, kv_rows, HD, BK) || !tile_map(&tv, v, kv_rows, HD, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_wgmma_kernel<HD, BK>, Cfg::smem);
  if (err != cudaSuccess) return err;
  const int n_q = (S + Cfg::BQ - 1) / Cfg::BQ;
  flash_wgmma_kernel<HD, BK>
      <<<(unsigned)((long long)BH * n_q), Cfg::NT, Cfg::smem, st>>>(
          tq, tk, tv, (__nv_bfloat16*)o, BH, H, KV, S, n_q, scale, causal,
          window, softcap);
  return cudaGetLastError();
}

// The shapes each head size takes.  fp32: warps x 16 query rows, keys per
// tile; at hd 128, 4 warps and 32-key tiles take 101 KB of shared memory, so
// two blocks share an SM.  bf16: 64-key tiles, 32 at hd 256, where a thread
// holds 128 O accumulators.
inline cudaError_t dispatch_tf32x3(int hd, const void* q, const void* k,
                                   const void* v, void* o, int BH, int H,
                                   int KV, int S, float scale, int causal,
                                   int window, float softcap,
                                   cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch_tf32x3<64, 8, 64>(q, k, v, o, BH, H, KV, S, scale,
                                      causal, window, softcap, st);
    case 128:
      return launch_tf32x3<128, 4, 32>(q, k, v, o, BH, H, KV, S, scale,
                                        causal, window, softcap, st);
    case 256:
      return launch_tf32x3<256, 4, 32>(q, k, v, o, BH, H, KV, S, scale,
                                        causal, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

inline cudaError_t dispatch_wgmma(int hd, const void* q, const void* k,
                                  const void* v, void* o, int BH, int H,
                                  int KV, int S, float scale, int causal,
                                  int window, float softcap,
                                  cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch_wgmma<64, 64>(q, k, v, o, BH, H, KV, S, scale,
                                          causal, window, softcap, st);
    case 128:
      return launch_wgmma<128, 64>(q, k, v, o, BH, H, KV, S, scale,
                                           causal, window, softcap, st);
    case 256:
      return launch_wgmma<256, 32>(q, k, v, o, BH, H, KV, S, scale,
                                           causal, window, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc
