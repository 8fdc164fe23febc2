// fedagg: the FedAvg contraction on a flat parameter plane.
//
// Replaces the TPU kernel src/repro/kernels/fedagg/kernel.py::weighted_aggregate
// (body _agg_kernel, pl.pallas_call at :29), reached from
// core/aggregation.py::aggregate_plane once per dispatched round per cluster.
//
//   out[d] = sum_c w[c] * plane[c, d]      plane (C, D) fp32 row-major, w (C,)
//
// What bounds it on an H100: bytes.  It reads the (C, D) plane once and writes
// (D,), (C + 1) * D * 4 bytes, and does 2 * C * D flops, so it is about half a
// flop per byte, far below the card's ratio.  At C = 16 and the full-width CNN's
// level-0 plane (D = 1,629,440) that is about 111 MB, 33 us at 3.35 TB/s.
//
// Design: no cross-block reduction is needed, because each output column
// depends only on its own column of the plane.  Each thread owns 4 consecutive
// columns and loads them as one float4 per member row (D is a multiple of 128,
// so every row start is 16-byte aligned); neighbouring threads read
// neighbouring 16-byte words, which coalesces each row read.  The weights sit in
// shared memory.  The sum over C runs in fp32, in row order, and each column is
// written once.  The TPU kernel's block_d <= 2048 grid and its MXU dot are not
// carried over: the grid is ceil(D / 4 / 256) blocks of 256 threads.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fedagg_kernel(const float4* __restrict__ plane, const float* __restrict__ w,
              float4* __restrict__ out, int C, long long D4) {
  extern __shared__ float sw[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) sw[c] = w[c];
  __syncthreads();
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= D4) return;
  const float4* col = plane + j;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float4 v = __ldg(col + (long long)c * D4);
    const float wc = sw[c];
    acc.x = fmaf(wc, v.x, acc.x);
    acc.y = fmaf(wc, v.y, acc.y);
    acc.z = fmaf(wc, v.z, acc.z);
    acc.w = fmaf(wc, v.w, acc.w);
  }
  out[j] = acc;
}

}  // namespace

// plane: (C, D) fp32, 16-byte aligned, D % 4 == 0; w: (C,) fp32; out: (D,) fp32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fedagg_launch(const void* plane, const void* w, void* out,
                             int C, long long D, void* stream) {
  if (C < 1 || D < 4 || D % 4 != 0 || C * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const long long D4 = D / 4;
  const long long blocks = (D4 + kThreads - 1) / kThreads;
  fedagg_kernel<<<(unsigned)blocks, kThreads, C * sizeof(float),
                  (cudaStream_t)stream>>>(
      (const float4*)plane, (const float*)w, (float4*)out, C, D4);
  return (int)cudaGetLastError();
}
