// flash: blocked online-softmax attention, forward.
//
// One entry point, three kernels: the wrapper (ops.py::_variant) picks one
// by head size and type, and this file never falls back from one to another.
//   variant 0, flash_fwd_kernel below: fp32 FMAs on the CUDA cores, for
//     hd in {8, 16, 32} (test-scale shapes, where it is launch-bound);
//   variant 1, tc::flash_tf32x3_kernel (flash_tc.cuh): fp32 inputs at hd in
//     {64, 128, 256} on the tensor cores, split TF32 with mma.sync;
//   variant 2, tc::flash_wgmma_kernel (flash_tc.cuh): bf16 inputs at hd in
//     {64, 128, 256}, wgmma.
// The note below describes variant 0; flash_tc.cuh describes 1 and 2.
//
// Replaces the TPU kernel src/repro/kernels/flash/kernel.py::flash_attention_bh
// (body _flash_kernel at :24, pl.pallas_call at :103; wrapper ops.py, whose
// custom_vjp at :55-82 recomputes the backward through a jnp reference).
//
//   o[b, i] = sum_j softmax_j(mask(cap(q[b, i] . k[r(b), j] * scale))) v[r(b), j]
//
// with cap(s) = tanh(s / c) * c when c > 0, masked scores (key j > query i
// when causal, i - j >= window when window > 0) set to -2^30 as in the TPU
// kernel, fp32 math for fp32 or bf16 inputs, the output in the input type, and
// the grouped-query row map r(b) = (b / H) * KV + (b % H) / (H / KV), so K/V
// are never repeated.
//
// What bounds it on an H100: the work is 4 * S^2 * hd operations per row of
// heads (half under causality) against 4 * S * hd values moved.  At the LM
// shapes (S 256-8192, hd 64-256) that is the tensor-core kernels' work
// (flash_tc.cuh).  Variant 0 serves hd 8-32 at test-scale S, where launches
// bound it; it is the simple, exact design: fp32 FMAs on the CUDA cores.  One
// block of 256 threads owns a 64-row query tile of one head row.  It keeps the
// query tile in shared memory and walks the 64-key tiles: the key tile is
// staged, each thread scores a 4 x 4 patch of the 64 x 64 tile from shared
// memory, the running max m, sum l and output rows acc are updated online
// (rows reduced over 16 lanes with shuffles), the probabilities go to shared
// memory, the value tile replaces the key tile in the same buffer, and each
// thread adds P.V into its 4 rows x hd/16 columns held in registers.  Rows
// are padded by one float, so the column reads hit distinct banks.  Tiles that
// causality or the window mask wholly are skipped: exact, since each row's own
// key is always visited, and a masked score then contributes exp(-2^30 - m),
// which is 0.  A ragged last tile is masked here (keys past S contribute
// nothing, queries past S are not written), so S need not divide by 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty owns rows ty + 16 i, tx cols tx + 16 j
constexpr float kNeg = -1073741824.0f;   // -2^30, the TPU kernel's masked score

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)((kBQ + kBK) * (HD + 1) + kBQ * (kBK + 1));
}

// Rows [r0, r0 + 64) of a row-major (S, HD) slice into shared memory with row
// stride HD + 1, as fp32; rows at or past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int S) {
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] =
        (r0 + r < S) ? to_float(src[(long long)(r0 + r) * HD + c]) : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int KV, int S, int n_q, float scale, int causal,
                     int window, float softcap) {
  constexpr int LD = HD + 1;
  constexpr int LP = kBK + 1;
  constexpr int NJ = (HD + 15) / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                      // (kBQ, LD) query tile
  float* skv = sq + kBQ * LD;            // (kBK, LD) key, then value tile
  float* sp = skv + kBK * LD;            // (kBQ, LP) probabilities

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x / n_q;
  const int q0 = (int)(blockIdx.x % n_q) * kBQ;
  const long long kv_row = (bh / H) * KV + (bh % H) / (H / KV);
  const T* qb = q + bh * S * HD;
  const T* kb = k + kv_row * S * HD;
  const T* vb = v + kv_row * S * HD;

  load_tile<T, HD>(sq, qb, q0, S);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                 // the previous P.V is done with skv, sp
    load_tile<T, HD>(skv, kb, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = skv[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (kj >= S)
          x = -INFINITY;             // past the sequence: no key at all
        else if ((causal && kj > qi) || (window > 0 && qi - kj >= window))
          x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }

    __syncthreads();                 // sp written; every thread done with K
    load_tile<T, HD>(skv, vb, k0, S);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int d = tx + 16 * jj;
        if (d < HD) {
          const float vv = skv[c * LD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * S + qi) * HD;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < HD) store(orow + d, acc[i][jj] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int H, int KV, int S, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_q = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<T, HD>
      <<<(unsigned)((long long)BH * n_q), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, n_q, scale,
          causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int BH, int H, int KV, int S, float scale,
                        int causal, int window, float softcap,
                        cudaStream_t st) {
  switch (hd) {
    case 8:
      return launch<T, 8>(q, k, v, o, BH, H, KV, S, scale, causal, window,
                          softcap, st);
    case 16:
      return launch<T, 16>(q, k, v, o, BH, H, KV, S, scale, causal, window,
                           softcap, st);
    case 32:
      return launch<T, 32>(q, k, v, o, BH, H, KV, S, scale, causal, window,
                           softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, S, hd), k and v (BH / H * KV, S, hd), o (BH, S, hd), all contiguous,
// of one type: dtype 0 = fp32, 1 = bf16.  variant 0 takes hd in {8, 16, 32}
// and either type; variant 1 fp32 and variant 2 bf16, both at hd in {64, 128,
// 256}.  H = KV = 1 is the identity row map.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a variant that does not
// take these inputs.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, int BH, int H, int KV, int S, int hd,
                                float scale, int causal, int window,
                                float softcap, int dtype, int variant,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  const bool tc_hd = hd == 64 || hd == 128 || hd == 256;
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == 0 && !tc_hd && dtype == 0)
    err = dispatch_hd<float>(hd, q, k, v, o, BH, H, KV, S, scale, causal,
                             window, softcap, st);
  else if (variant == 0 && !tc_hd && dtype == 1)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, BH, H, KV, S, scale,
                                     causal, window, softcap, st);
  else if (variant == 1 && tc_hd && dtype == 0)
    err = tc::dispatch_tf32x3(hd, q, k, v, o, BH, H, KV, S, scale, causal,
                              window, softcap, st);
  else if (variant == 2 && tc_hd && dtype == 1)
    err = tc::dispatch_wgmma(hd, q, k, v, o, BH, H, KV, S, scale, causal,
                             window, softcap, st);
  return (int)err;
}
