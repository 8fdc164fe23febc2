// distill: the fused Hinton knowledge-distillation loss, one value per row.
//
// Replaces the TPU kernel src/repro/kernels/distill/kernel.py::kd_loss_rows
// (body _kd_kernel at :28, pl.pallas_call at :93; wrapper ops.py::kd_loss).
//
//   loss[n] = alpha * CE(s[n], y[n])
//           + (1 - alpha) * T^2 * KL(softmax(t[n] / T) || softmax(s[n] / T))
//
// without materialising a softmax.  Every partial result is the nine fp32
// statistics of _kd_kernel:
//   teacher at T:  max m_t, sum l_t, A = sum p*t/T, B = sum p*s/T
//   student at T:  max m_sT, sum l_sT          (log-sum-exp)
//   student at 1:  max m_s1, sum l_s1, and the logit at the label
// so that KL = (A - B) / l_t - (m_t + log l_t) + (m_sT + log l_sT) and
// CE = m_s1 + log l_s1 - picked.  Two partials merge by rescaling to the
// larger max.
//
// What bounds it on an H100: bytes (each logit is read once, 2 * N * V * 4
// bytes in fp32) at LM vocabularies; launches at the CNN's 10 classes.
//
// V > 1024, the split-vocabulary design: one wrapper call runs two kernels.
//   1. kd_split_kernel: each row's vocabulary is cut into `splits` chunks of
//      `chunk` logits (chunk a multiple of 8; the wrapper picks the split
//      count from (N, V) so that about 4 x 132 blocks fill the card).  One
//      256-thread block owns one (row, chunk).  A thread takes 8 consecutive
//      logits of each tensor per step, with 16-byte loads where the row is
//      aligned (neighbouring threads on neighbouring 16 bytes), and reduces
//      them in two steps: first the group's three maxima (teacher at T,
//      student at T, student at 1; the maxima at T are the maxima at 1 times
//      1/T), rescaling its running sums once per group when a max grows,
//      then the sums with one expf per statistic and logit: three expf per
//      (student, teacher) pair instead of the six of a per-element online
//      rescale.  Warps merge with shuffles, the block's warps through shared
//      memory, and the block writes its nine statistics to the scratch
//      (N, splits, 9) buffer the wrapper allocates.
//   2. kd_merge_kernel: one warp per row merges the row's chunks in a fixed
//      order (lane i takes chunks i, i + 32, ... in turn, then a fixed
//      shuffle tree), so repeated calls give the same bits, and writes the
//      loss.
// V <= 1024 (the CNN's 10 classes): kd_rows_kernel, one warp per row, eight
// rows per block, one kernel; it is launch-bound there.
//
// Ragged N and V are masked in the kernels: skipped logits contribute what
// the JAX wrapper's -3e4 padding contributes, zero.  Inputs are fp32 or bf16
// (template), labels int32 or int64; labels must lie in [0, V).  There is no
// valid_mask on this route, as in the JAX kernel, and no backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;          // consecutive logits per thread and step
constexpr float kNeg = -1e30f;     // finite, so exp(kNeg - m) is exactly 0

struct Stats {
  float mt, lt, a, b;     // teacher at T, with p-weighted sums of t/T and s/T
  float msT, lsT;         // student at T
  float ms1, ls1;         // student at 1
  float picked;           // student logit at the label
};

__device__ __forceinline__ Stats empty_stats() {
  return {kNeg, 0.f, 0.f, 0.f, kNeg, 0.f, kNeg, 0.f, 0.f};
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Eight consecutive logits from a 16-byte-aligned address.
__device__ __forceinline__ void load8(const float* p, float (&x)[kGroup]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[kGroup]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

__device__ __forceinline__ void warp_merge(Stats& st) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge(st, shfl_down(st, off));
}

__device__ __forceinline__ float finish(const Stats& st, float alpha,
                                        float kl_coef) {
  const float zt = st.mt + logf(st.lt);
  const float zsT = st.msT + logf(st.lsT);
  const float zs1 = st.ms1 + logf(st.ls1);
  const float kl = st.a / st.lt - zt + zsT - st.b / st.lt;
  const float ce = zs1 - st.picked;
  return alpha * ce + kl_coef * kl;
}

// V <= 1024: one warp per row, one element per lane and step.
template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
kd_rows_kernel(const T* __restrict__ s, const T* __restrict__ t,
               const L* __restrict__ labels, float* __restrict__ out,
               int N, int V, float temp, float alpha, float kl_coef) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  Stats st = empty_stats();
  if (row < N) {
    const T* sr = s + row * V;
    const T* tr = t + row * V;
    const long long label = (long long)labels[row];
    for (int v = lane; v < V; v += 32) {
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
  warp_merge(st);      // every lane of a warp serves the same row
  if (row < N && lane == 0) out[row] = finish(st, alpha, kl_coef);
}

// V > 1024, step 1: the statistics of one (row, chunk), to part[row, split].
template <typename T, typename L, bool VEC>
__global__ void __launch_bounds__(kThreads)
kd_split_kernel(const T* __restrict__ s, const T* __restrict__ t,
                const L* __restrict__ labels, float* __restrict__ part,
                int V, int splits, int chunk, float temp) {
  const long long row = blockIdx.x / splits;
  const int split = blockIdx.x % splits;
  const int c0 = split * chunk;
  const int c1 = min(V, c0 + chunk);
  const T* sr = s + row * V;
  const T* tr = t + row * V;
  const long long label = (long long)labels[row];
  const float inv_t = 1.f / temp;
  Stats st = empty_stats();
  for (int base = c0 + threadIdx.x * kGroup; base < c1;
       base += kThreads * kGroup) {
    const int n = min(kGroup, c1 - base);
    float sv[kGroup], tv[kGroup];
    if (VEC && n == kGroup) {
      load8(sr + base, sv);
      load8(tr + base, tv);
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        sv[j] = j < n ? to_float(sr[base + j]) : -INFINITY;
        tv[j] = j < n ? to_float(tr[base + j]) : -INFINITY;
      }
    }
    // the group's maxima; x * (1/T) is monotone, so max(x)/T = max(x/T)
    float gs = sv[0], gt = tv[0];
#pragma unroll
    for (int j = 1; j < kGroup; ++j) {
      gs = fmaxf(gs, sv[j]);
      gt = fmaxf(gt, tv[j]);
    }
    const float gtT = gt * inv_t, gsT = gs * inv_t;
    if (gtT > st.mt) {
      const float sc = expf(st.mt - gtT);
      st.lt *= sc;
      st.a *= sc;
      st.b *= sc;
      st.mt = gtT;
    }
    if (gsT > st.msT) {
      st.lsT *= expf(st.msT - gsT);
      st.msT = gsT;
    }
    if (gs > st.ms1) {
      st.ls1 *= expf(st.ms1 - gs);
      st.ms1 = gs;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < n) {
        const float tT = tv[j] * inv_t, sT = sv[j] * inv_t;
        const float p = expf(tT - st.mt);
        st.lt += p;
        st.a += p * tT;
        st.b += p * sT;
        st.lsT += expf(sT - st.msT);
        st.ls1 += expf(sv[j] - st.ms1);
        if (base + j == label) st.picked += sv[j];
      }
    }
  }
  warp_merge(st);
  __shared__ Stats partial[kThreads / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) partial[warp] = st;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) merge(st, partial[w]);
    float* o = part + (long long)blockIdx.x * 9;
    o[0] = st.mt; o[1] = st.lt; o[2] = st.a; o[3] = st.b;
    o[4] = st.msT; o[5] = st.lsT; o[6] = st.ms1; o[7] = st.ls1;
    o[8] = st.picked;
  }
}

// V > 1024, step 2: one warp per row merges its chunks in a fixed order.
__global__ void __launch_bounds__(kThreads)
kd_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                int N, int splits, float alpha, float kl_coef) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  Stats st = empty_stats();
  if (row < N) {
    for (int c = lane; c < splits; c += 32) {
      const float* p = part + (row * splits + c) * 9;
      const Stats o = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
      merge(st, o);
    }
  }
  warp_merge(st);
  if (row < N && lane == 0) out[row] = finish(st, alpha, kl_coef);
}

template <typename T, typename L>
int launch(const void* s, const void* t, const void* labels, void* out,
           void* part, int N, int V, int splits, int chunk, float temp,
           float alpha, float kl_coef, cudaStream_t stream) {
  const unsigned row_blocks = (unsigned)((N + kThreads / 32 - 1) /
                                         (kThreads / 32));
  if (V <= 1024) {
    kd_rows_kernel<T, L><<<row_blocks, kThreads, 0, stream>>>(
        (const T*)s, (const T*)t, (const L*)labels, (float*)out, N, V, temp,
        alpha, kl_coef);
    return (int)cudaGetLastError();
  }
  if (splits < 1 || chunk < 1 || chunk % kGroup ||
      (long long)(splits - 1) * chunk >= V || (long long)splits * chunk < V ||
      (long long)N * splits >= (1ll << 31) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads need every row start aligned: V * sizeof(T) % 16 == 0
  const bool vec = (V * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)s | (uintptr_t)t) % 16 == 0;
  const unsigned blocks = (unsigned)((long long)N * splits);
  if (vec)
    kd_split_kernel<T, L, true><<<blocks, kThreads, 0, stream>>>(
        (const T*)s, (const T*)t, (const L*)labels, (float*)part, V, splits,
        chunk, temp);
  else
    kd_split_kernel<T, L, false><<<blocks, kThreads, 0, stream>>>(
        (const T*)s, (const T*)t, (const L*)labels, (float*)part, V, splits,
        chunk, temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kd_merge_kernel<<<row_blocks, kThreads, 0, stream>>>(
      (const float*)part, (float*)out, N, splits, alpha, kl_coef);
  return (int)cudaGetLastError();
}

}  // namespace

// s, t: (N, V) row-major, fp32 (dtype 0) or bf16 (dtype 1); labels: (N,)
// int32 (label_bytes 4) or int64 (label_bytes 8); out: (N,) fp32.
// kl_coef = (1 - alpha) * T^2.  For V > 1024, part is fp32 scratch of
// N * splits * 9 values, with splits chunks of chunk logits covering V
// (chunk a multiple of 8, no chunk empty); V <= 1024 ignores part, splits and
// chunk.  Returns cudaGetLastError() after the launches.
extern "C" int kd_rows_launch(const void* s, const void* t, const void* labels,
                              void* out, void* part, int N, int V, int splits,
                              int chunk, float temp, float alpha,
                              float kl_coef, int dtype, int label_bytes,
                              void* stream) {
  if (N < 1 || V < 1 || !(temp > 0.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && label_bytes == 4)
    return launch<float, int32_t>(s, t, labels, out, part, N, V, splits,
                                  chunk, temp, alpha, kl_coef, st);
  if (dtype == 0 && label_bytes == 8)
    return launch<float, int64_t>(s, t, labels, out, part, N, V, splits,
                                  chunk, temp, alpha, kl_coef, st);
  if (dtype == 1 && label_bytes == 4)
    return launch<__nv_bfloat16, int32_t>(s, t, labels, out, part, N, V,
                                          splits, chunk, temp, alpha,
                                          kl_coef, st);
  if (dtype == 1 && label_bytes == 8)
    return launch<__nv_bfloat16, int64_t>(s, t, labels, out, part, N, V,
                                          splits, chunk, temp, alpha,
                                          kl_coef, st);
  return (int)cudaErrorInvalidValue;
}
