// distill: the fused Hinton knowledge-distillation loss, one value per row.
//
// Replaces the TPU kernel src/repro/kernels/distill/kernel.py::kd_loss_rows
// (body _kd_kernel at :28, pl.pallas_call at :93; wrapper ops.py::kd_loss).
//
//   loss[n] = alpha * CE(s[n], y[n])
//           + (1 - alpha) * T^2 * KL(softmax(t[n] / T) || softmax(s[n] / T))
//
// in one streaming pass over the V logits of a row, never materialising a
// softmax.  Each thread keeps the nine fp32 running statistics of _kd_kernel
// over its strided slice of the row:
//   teacher at T:  max m_t, sum l_t, A = sum p*t/T, B = sum p*s/T
//   student at T:  max m_sT, sum l_sT          (log-sum-exp)
//   student at 1:  max m_s1, sum l_s1, and the logit at the label
// so that KL = (A - B) / l_t - (m_t + log l_t) + (m_sT + log l_sT) and
// CE = m_s1 + log l_s1 - picked.  Partial statistics merge by rescaling to the
// larger max, first across a warp with shuffles, then across the warps of a
// row through shared memory.
//
// What bounds it on an H100: at LM vocabularies, bytes (each logit is read
// once, 2 * N * V * 4 bytes in fp32) against the special-function units (six
// expf per logit pair).  At the CNN's 10 classes it is launch-bound.  The
// design reads each row once, coalesced (neighbouring threads read
// neighbouring logits), and writes one float per row; the wrapper takes the
// mean.  A row is handled by one warp when V <= 1024 (eight rows per block)
// and by a whole 256-thread block otherwise.  Ragged N and V are masked in
// the kernel: skipped columns contribute exactly what the JAX wrapper's -3e4
// padding contributes, zero.  Inputs are fp32 or bf16 (template), labels int32
// or int64; labels must lie in [0, V).  There is no valid_mask on this route,
// as in the JAX kernel, and no backward: it is forward only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;     // finite, so exp(kNeg - m) is exactly 0

struct Stats {
  float mt, lt, a, b;     // teacher at T, with p-weighted sums of t/T and s/T
  float msT, lsT;         // student at T
  float ms1, ls1;         // student at 1
  float picked;           // student logit at the label
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void merge_lse(float& m, float& l, float m2,
                                          float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void merge(Stats& s, const Stats& o) {
  const float mn = fmaxf(s.mt, o.mt);
  const float sa = expf(s.mt - mn), sb = expf(o.mt - mn);
  s.lt = s.lt * sa + o.lt * sb;
  s.a = s.a * sa + o.a * sb;
  s.b = s.b * sa + o.b * sb;
  s.mt = mn;
  merge_lse(s.msT, s.lsT, o.msT, o.lsT);
  merge_lse(s.ms1, s.ls1, o.ms1, o.ls1);
  s.picked += o.picked;
}

__device__ __forceinline__ Stats shfl_down(const Stats& s, int off) {
  Stats o;
  o.mt = __shfl_down_sync(0xffffffffu, s.mt, off);
  o.lt = __shfl_down_sync(0xffffffffu, s.lt, off);
  o.a = __shfl_down_sync(0xffffffffu, s.a, off);
  o.b = __shfl_down_sync(0xffffffffu, s.b, off);
  o.msT = __shfl_down_sync(0xffffffffu, s.msT, off);
  o.lsT = __shfl_down_sync(0xffffffffu, s.lsT, off);
  o.ms1 = __shfl_down_sync(0xffffffffu, s.ms1, off);
  o.ls1 = __shfl_down_sync(0xffffffffu, s.ls1, off);
  o.picked = __shfl_down_sync(0xffffffffu, s.picked, off);
  return o;
}

// GROUP threads per row (32: a warp; 256: the whole block).
template <typename T, typename L, int GROUP>
__global__ void __launch_bounds__(kThreads)
kd_rows_kernel(const T* __restrict__ s, const T* __restrict__ t,
               const L* __restrict__ labels, float* __restrict__ out,
               int N, int V, float temp, float alpha, float kl_coef) {
  constexpr int kRows = kThreads / GROUP;
  const int lane = threadIdx.x % GROUP;
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / GROUP;
  Stats st = {kNeg, 0.f, 0.f, 0.f, kNeg, 0.f, kNeg, 0.f, 0.f};
  if (row < N) {
    const T* sr = s + row * V;
    const T* tr = t + row * V;
    const long long label = (long long)labels[row];
    for (int v = lane; v < V; v += GROUP) {
      const float sv = to_float(sr[v]);
      const float tv = to_float(tr[v]);
      const float sT = sv / temp, tT = tv / temp;
      float mn = fmaxf(st.mt, tT);
      const float sc = expf(st.mt - mn), p = expf(tT - mn);
      st.lt = st.lt * sc + p;
      st.a = st.a * sc + p * tT;
      st.b = st.b * sc + p * sT;
      st.mt = mn;
      mn = fmaxf(st.msT, sT);
      st.lsT = st.lsT * expf(st.msT - mn) + expf(sT - mn);
      st.msT = mn;
      mn = fmaxf(st.ms1, sv);
      st.ls1 = st.ls1 * expf(st.ms1 - mn) + expf(sv - mn);
      st.ms1 = mn;
      if (v == label) st.picked += sv;
    }
  }
  // Every thread of a warp serves the same row, so the whole warp shuffles.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(st, shfl_down(st, off));
  if (GROUP > 32) {
    __shared__ Stats partial[kThreads / 32];
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) partial[warp] = st;
    __syncthreads();
    if (lane == 0)
      for (int w = 1; w < GROUP / 32; ++w) merge(st, partial[warp + w]);
  }
  if (row < N && lane == 0) {
    const float zt = st.mt + logf(st.lt);
    const float zsT = st.msT + logf(st.lsT);
    const float zs1 = st.ms1 + logf(st.ls1);
    const float kl = st.a / st.lt - zt + zsT - st.b / st.lt;
    const float ce = zs1 - st.picked;
    out[row] = alpha * ce + kl_coef * kl;
  }
}

template <typename T, typename L>
int launch(const void* s, const void* t, const void* labels, void* out, int N,
           int V, float temp, float alpha, float kl_coef,
           cudaStream_t stream) {
  if (V <= 1024) {
    const unsigned blocks = (unsigned)((N + kThreads / 32 - 1) / (kThreads / 32));
    kd_rows_kernel<T, L, 32><<<blocks, kThreads, 0, stream>>>(
        (const T*)s, (const T*)t, (const L*)labels, (float*)out, N, V, temp,
        alpha, kl_coef);
  } else {
    kd_rows_kernel<T, L, kThreads><<<(unsigned)N, kThreads, 0, stream>>>(
        (const T*)s, (const T*)t, (const L*)labels, (float*)out, N, V, temp,
        alpha, kl_coef);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// s, t: (N, V) row-major, fp32 (dtype 0) or bf16 (dtype 1); labels: (N,)
// int32 (label_bytes 4) or int64 (label_bytes 8); out: (N,) fp32.
// kl_coef = (1 - alpha) * T^2.  Returns cudaGetLastError() after the launch.
extern "C" int kd_rows_launch(const void* s, const void* t, const void* labels,
                              void* out, int N, int V, float temp, float alpha,
                              float kl_coef, int dtype, int label_bytes,
                              void* stream) {
  if (N < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && label_bytes == 4)
    return launch<float, int32_t>(s, t, labels, out, N, V, temp, alpha, kl_coef, st);
  if (dtype == 0 && label_bytes == 8)
    return launch<float, int64_t>(s, t, labels, out, N, V, temp, alpha, kl_coef, st);
  if (dtype == 1 && label_bytes == 4)
    return launch<__nv_bfloat16, int32_t>(s, t, labels, out, N, V, temp, alpha,
                                          kl_coef, st);
  if (dtype == 1 && label_bytes == 8)
    return launch<__nv_bfloat16, int64_t>(s, t, labels, out, N, V, temp, alpha,
                                          kl_coef, st);
  return (int)cudaErrorInvalidValue;
}
