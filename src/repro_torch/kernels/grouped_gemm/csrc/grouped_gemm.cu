// grouped_gemm: one matrix product per group of rows, the groups' row
// counts read on the device, for the dropless MoE dispatch.
//
// Replaces no TPU kernel: the JAX package runs its MoE through the dense or
// the capacity dispatch and has no grouped product.  It was added for
// models/moe.py's "dropless" dispatch, where the routing choices, sorted by
// expert, form one group of rows per (member, expert), and every row meets
// its own expert's matrix.
//
//   rows:  Y[r, :] = X[r, :] . B_g        for r in [off[g], off[g+1])
//          B_g = W[g % Gw] (K, N), or its transpose when W[g % Gw] is (N, K)
//   wgrad: dW[g] = X[off[g]:off[g+1], :]^T . D[off[g]:off[g+1], :]   (K, N)
//
// X (M, K), D (M, N), Y (M, N) fp32 row-major; W (Gw, K, N) or (Gw, N, K);
// off (G + 1,) int64 with off[0] = 0 and off[G] = M, on the device: the
// host never reads it, so the launch needs no synchronisation.  The rows
// grid is the static bound ceil(M / BM) + G row tiles; a block finds its
// group by walking the offsets and exits if it has none.  The wgrad grid is
// (N tiles, K tiles, G); a group with no rows writes zeros.
//
// What bounds it on an H100: operations.  At the dropless MoE's shapes
// (M = 65,536 routed rows of d = 1,024 into experts of 512) a product is
// 2 M K N = 68.7 GFLOP over about 0.4 GB of operands, some 170 operations a
// byte.  Arithmetic: fp32 FMAs on the CUDA cores (67 TFLOP/s dense), summed
// in k order per output, as the configurations ask for fp32 and the
// benchmark turns TF32 off.  Design: 64 x 128 output tiles over 256
// threads, each thread a 4 x 8 block of outputs in registers; BK = 16 deep
// tiles of both operands staged in shared memory, padded by 4 floats a row
// so that the transposing stores spread over the banks and every thread
// reads its operands as 16-byte words.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 128, BK = 16, kThreads = 256;
constexpr int AP = BM + 4, BP = BN + 4;      // padded shared rows

struct Tiles {
  float a[BK][AP];
  float b[BK][BP];
};

// acc += the BK-deep product of the staged tiles: thread (ty, tx) owns
// rows 4 ty .. 4 ty + 3 and columns 4 tx .. 4 tx + 3, 64 + 4 tx .. + 3.
__device__ __forceinline__ void mma_tile(const Tiles& s, float acc[4][8],
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[kk][ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kk][tx * 4]);
    const float4 b1 =
        *reinterpret_cast<const float4*>(&s.b[kk][64 + tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[(r0 + i) * ld + c0 + j] for the rows below r1 and columns below n.
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float acc[4][8],
                                           long long r0, long long r1,
                                           long long ld, int c0, int n,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    if (r >= r1) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < n) out[r * ld + c] = acc[i][j];
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_rows_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const long long* __restrict__ off,
                         float* __restrict__ y, int K, int N, int G,
                         int Gw) {
  __shared__ __align__(16) Tiles s;
  // this block's group and first row: the blockIdx.x-th row tile of the
  // groups in order
  long long t = blockIdx.x, r0 = 0, r1 = 0;
  int g = -1;
  for (int j = 0; j < G; ++j) {
    const long long a = off[j], b = off[j + 1];
    const long long n_tiles = (b - a + BM - 1) / BM;
    if (t < n_tiles) {
      g = j;
      r0 = a + t * BM;
      r1 = b;
      break;
    }
    t -= n_tiles;
  }
  if (g < 0) return;
  const int c0 = blockIdx.y * BN;
  const float* wg = w + (long long)(g % Gw) * K * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][8] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    // X rows: 16 consecutive k of a row per 16 threads, stored transposed
#pragma unroll
    for (int l = 0; l < BM * BK / kThreads; ++l) {
      const int idx = tid + l * kThreads, r = idx / BK, kk = idx % BK;
      const long long row = r0 + r;
      const int k = k0 + kk;
      s.a[kk][r] = (row < r1 && k < K) ? x[row * K + k] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < BK * BN / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      int kk, c;
      if (TRANS) {            // B (k, c) = W_g[c, k]: read along k
        c = idx / BK;
        kk = idx % BK;
      } else {                // B (k, c) = W_g[k, c]: read along c
        kk = idx / BN;
        c = idx % BN;
      }
      const int k = k0 + kk, col = c0 + c;
      float v = 0.f;
      if (k < K && col < N)
        v = TRANS ? wg[(long long)col * K + k] : wg[(long long)k * N + col];
      s.b[kk][c] = v;
    }
    __syncthreads();
    mma_tile(s, acc, ty, tx);
    __syncthreads();
  }
  store_tile(y, acc, r0, r1, N, c0, N, ty, tx);
}

__global__ void __launch_bounds__(kThreads)
grouped_gemm_wgrad_kernel(const float* __restrict__ x,
                          const float* __restrict__ d,
                          const long long* __restrict__ off,
                          float* __restrict__ dw, int K, int N) {
  __shared__ __align__(16) Tiles s;
  const int g = blockIdx.z;
  const long long a = off[g], b = off[g + 1];
  const int i0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][8] = {};
  for (long long r0 = a; r0 < b; r0 += BK) {
    // X^T (i, r): 64 consecutive i of a row per 64 threads
#pragma unroll
    for (int l = 0; l < BM * BK / kThreads; ++l) {
      const int idx = tid + l * kThreads, kk = idx / BM, i = idx % BM;
      const long long r = r0 + kk;
      s.a[kk][i] = (r < b && i0 + i < K) ? x[r * K + i0 + i] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < BK * BN / kThreads; ++l) {
      const int idx = tid + l * kThreads, kk = idx / BN, c = idx % BN;
      const long long r = r0 + kk;
      s.b[kk][c] = (r < b && c0 + c < N) ? d[r * N + c0 + c] : 0.f;
    }
    __syncthreads();
    mma_tile(s, acc, ty, tx);
    __syncthreads();
  }
  store_tile(dw + (long long)g * K * N, acc, i0, K, N, c0, N, ty, tx);
}

}  // namespace

// x (M, K), w (Gw, K, N) or, with trans, (Gw, N, K); off (G + 1,) int64;
// y (M, N).  All fp32 but off, contiguous, on the stream's device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int grouped_gemm_rows_launch(const void* x, const void* w,
                                        const void* off, void* y,
                                        long long M, int K, int N, int G,
                                        int Gw, int trans, void* stream) {
  if (M < 0 || K < 1 || N < 1 || G < 1 || Gw < 1 || G % Gw != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (M + BM - 1) / BM + G;
  const long long n_tiles = (N + BN - 1) / BN;
  if (tiles >= (1LL << 31) || n_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)n_tiles);
  cudaStream_t st = (cudaStream_t)stream;
  if (trans)
    grouped_gemm_rows_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w, (const long long*)off, (float*)y,
        K, N, G, Gw);
  else
    grouped_gemm_rows_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w, (const long long*)off, (float*)y,
        K, N, G, Gw);
  return (int)cudaGetLastError();
}

// x (M, K), d (M, N), off (G + 1,) int64; dw (G, K, N).
extern "C" int grouped_gemm_wgrad_launch(const void* x, const void* d,
                                         const void* off, void* dw,
                                         long long M, int K, int N, int G,
                                         void* stream) {
  if (M < 0 || K < 1 || N < 1 || G < 1 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (N + BN - 1) / BN, k_tiles = (K + BM - 1) / BM;
  if (n_tiles >= (1LL << 31) || k_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n_tiles, (unsigned)k_tiles, (unsigned)G);
  grouped_gemm_wgrad_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)d, (const long long*)off, (float*)dw, K,
      N);
  return (int)cudaGetLastError();
}
