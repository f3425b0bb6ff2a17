// GroupNorm over NHWC activations, on Hopper: the statistics, and the
// normalisation fused with its epilogue (LeakyReLU, or a residual add).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses it with the ops around it. The serving forward of the port
// (models/fused_forward.py::_res_tail, the ResBlock after the chain kernel's
// conv0) ran it as plain PyTorch: a copy of the chain's NHWC output to NCHW,
// casts to float32 and back, F.group_norm's statistics and apply passes,
// LeakyReLU, and a residual add over tensors of two layouts, each a pass over
// device memory. This pair exists to move fewer bytes.
//
//   gn_stats  x [N, H, W, C]  ->  mean, rstd  float32 [N, G]
//             per sample and group, over H*W*(C/G) values: the mean and
//             1/sqrt(var + eps), var biased (as F.group_norm).
//   gn_apply  y = (x - mean) * rstd * gamma + beta in float32, as
//             y = x * a + b with a = rstd * gamma, b = beta - a * mean
//             (F.group_norm's CUDA kernel), then
//             act:      out = y > 0 ? y : 0.2 * y, with y first rounded to
//                       the element type and 0.2 * y rounded again;
//             residual: out = residual + y, with y first rounded to the
//                       element type,
//             so a bfloat16 result rounds exactly where the plain
//             composition rounds (F.group_norm in float32, .to(bfloat16),
//             then LeakyReLU or the add on bfloat16 tensors), and float32 is
//             float32 throughout. out is NHWC, like x.
//
// What bounds it: bytes. Each is a few flops a byte, far below the 295
// flops a byte at which the card's bf16 tensor cores, let alone its float32
// lanes, would be the limit. A ResBlock tail (stats, apply + act, conv1,
// stats, apply + residual) moves 14 * C bytes a pixel in bf16 here (28 * C
// in float32), against ~66 * C through the plain ops.
//
// Design. Element type (float32, bfloat16) and vector width are template
// parameters: a thread moves 16 bytes of one pixel's channels (8 bf16, 4
// float32 values), or 1 value where C is not a multiple of that or a pointer
// is not 16-byte aligned. A block of 256 threads is R rows of L = C / VEC
// lanes; each block owns a contiguous run of pixels of one sample, row r
// taking pixels r, r + R, ..., so each warp's loads are one contiguous run.
// The wrapper (ops/group_norm.py::gn_plan) sizes the runs from N * H * W:
// 16 pixels a row, but one wave of at most 4 blocks for each of the 132 SMs
// (the stats kernel is held to 64 registers a thread for it) and at least
// one block a SM, where there are that many pixels. Fewer, longer runs cut
// the partials the statistics' last block merges, which at the narrow
// levels cost more than the loads.
//
// gn_stats keeps per-channel count, mean and M2 in float32 registers
// (Welford), 4 pixels' loads in flight a thread, then merges the block's rows
// in shared memory (Chan's formula) and writes the block's per-channel
// partials to a scratch buffer. The last block of each sample to finish
// (__threadfence, then an atomic ticket per sample) merges that sample's
// partials, 8 loads in flight a thread, in an order fixed by the block
// index, so the result does not depend on which block came last, then the
// channels of each group (equal counts: the mean of
// means, M2 = sum of M2 + count * sum of squared deviations of the means),
// writes mean and rstd, and resets the ticket to 0 for the next launch on
// the stream. gn_apply computes each thread's a and b once, in registers
// (its lane's channels are fixed), and streams its pixels, 4 in flight.
// One launch each per call, on the caller's stream, no sync, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // pixels whose loads a thread keeps in flight
constexpr int kMerge = 8;       // partials whose loads the last block keeps in flight
constexpr int kStatsBlocks = 4; // stats blocks resident on an SM (64 registers a thread)
constexpr int kMaxC = 2048;     // channels the shared-memory partials hold
constexpr float kSlope = 0.2f;  // LeakyReLU's negative slope

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Chan's merge of (nb, mb, qb) into (n, m, q): counts, means, sums of
// squared deviations. An empty part changes nothing.
__device__ __forceinline__ void chan(float& n, float& m, float& q, float nb, float mb,
                                     float qb) {
  if (nb == 0.f) return;
  const float nn = n + nb, d = mb - m, w = nb / nn;
  m = fmaf(d, w, m);
  q = q + qb + d * d * n * w;
  n = nn;
}

template <typename T, int VEC>
__device__ __forceinline__ void welford(float& n, float (&m)[VEC], float (&q)[VEC],
                                        const Pack<T, VEC>& v) {
  n += 1.f;
  const float inv = 1.f / n;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float x = to_f(v.v[j]), d = x - m[j];
    m[j] = fmaf(d, inv, m[j]);
    q[j] = fmaf(d, x - m[j], q[j]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kStatsBlocks)
gn_stats_kernel(const T* __restrict__ x, int P, int C, int G, float eps, int S, int ppb,
                float* __restrict__ ws, int* __restrict__ tickets,
                float* __restrict__ mean_out, float* __restrict__ rstd_out) {
  __shared__ float s_mean[kMaxC];
  __shared__ float s_m2[kMaxC];
  __shared__ float s_cnt[kThreads];
  __shared__ bool s_last;
  const int L = C / VEC, R = kThreads / L;
  const int t = threadIdx.x, lane = t % L, row = t / L;
  const int n = blockIdx.x / S, s = blockIdx.x % S;
  const int p0 = s * ppb, p1 = min(P, p0 + ppb);

  float cnt = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) mean[j] = m2[j] = 0.f;
  if (row < R) {
    const T* base = x + static_cast<size_t>(n) * P * C + lane * VEC;
    int p = p0 + row;
    for (; p + (kUnroll - 1) * R < p1; p += kUnroll * R) {
      Pack<T, VEC> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = *reinterpret_cast<const Pack<T, VEC>*>(base + static_cast<size_t>(p + u * R) * C);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) welford<T, VEC>(cnt, mean, m2, v[u]);
    }
    for (; p < p1; p += R)
      welford<T, VEC>(cnt, mean, m2,
                      *reinterpret_cast<const Pack<T, VEC>*>(base + static_cast<size_t>(p) * C));
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s_mean[row * C + lane * VEC + j] = mean[j];
      s_m2[row * C + lane * VEC + j] = m2[j];
    }
    if (lane == 0) s_cnt[row] = cnt;
  }
  __syncthreads();

  // the block's rows, merged per channel: its partial (count p1 - p0)
  float* part = ws + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int c = t; c < C; c += kThreads) {
    float nA = s_cnt[0], mA = s_mean[c], qA = s_m2[c];
    for (int r = 1; r < R; ++r) chan(nA, mA, qA, s_cnt[r], s_mean[r * C + c], s_m2[r * C + c]);
    part[c] = mA;
    part[C + c] = qA;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&tickets[n], 1) == S - 1;
  __syncthreads();
  if (!s_last) return;

  // the sample's last block: its S partials, Q interleaved sets per channel
  // in parallel, then the Q sets in order
  const int Q = max(1, kThreads / C);
  const float* parts = ws + static_cast<size_t>(n) * S * 2 * C;
  auto count = [&](int b) { return static_cast<float>(min(P, (b + 1) * ppb) - b * ppb); };
  for (int i = t; i < Q * C; i += kThreads) {
    const int q = i / C, c = i % C;
    float nA = 0.f, mA = 0.f, qA = 0.f;
    int b = q;
    for (; b + (kMerge - 1) * Q < S; b += kMerge * Q) {
      float mb[kMerge], qb[kMerge];
#pragma unroll
      for (int u = 0; u < kMerge; ++u) {
        const float* pb = parts + static_cast<size_t>(b + u * Q) * 2 * C;
        mb[u] = __ldcg(pb + c);
        qb[u] = __ldcg(pb + C + c);
      }
#pragma unroll
      for (int u = 0; u < kMerge; ++u) chan(nA, mA, qA, count(b + u * Q), mb[u], qb[u]);
    }
    for (; b < S; b += Q) {
      const float* pb = parts + static_cast<size_t>(b) * 2 * C;
      chan(nA, mA, qA, count(b), __ldcg(pb + c), __ldcg(pb + C + c));
    }
    s_mean[i] = mA;
    s_m2[i] = qA;
    if (c == 0) s_cnt[q] = nA;
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    float nA = s_cnt[0], mA = s_mean[c], qA = s_m2[c];
    for (int q = 1; q < Q; ++q) chan(nA, mA, qA, s_cnt[q], s_mean[q * C + c], s_m2[q * C + c]);
    s_mean[c] = mA;
    s_m2[c] = qA;
  }
  __syncthreads();

  // the channels of each group: P values each
  const int Cg = C / G;
  for (int g = t; g < G; g += kThreads) {
    float m = 0.f;
    for (int k = 0; k < Cg; ++k) m += s_mean[g * Cg + k];
    m /= static_cast<float>(Cg);
    float q = 0.f;
    for (int k = 0; k < Cg; ++k) {
      const float d = s_mean[g * Cg + k] - m;
      q += s_m2[g * Cg + k] + static_cast<float>(P) * d * d;
    }
    const float var = q / (static_cast<float>(P) * static_cast<float>(Cg));
    mean_out[n * G + g] = m;
    rstd_out[n * G + g] = 1.f / sqrtf(var + eps);
  }
  if (t == 0) tickets[n] = 0;
}

template <typename T, int VEC, bool ACT>
__device__ __forceinline__ Pack<T, VEC> epilogue(const Pack<T, VEC>& xv, const Pack<T, VEC>& rv,
                                                 const float (&a)[VEC], const float (&b)[VEC]) {
  Pack<T, VEC> o;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const T y = from_f<T>(fmaf(to_f(xv.v[j]), a[j], b[j]));
    const float f = to_f(y);
    if (ACT)
      o.v[j] = f > 0.f ? y : from_f<T>(f * kSlope);
    else
      o.v[j] = from_f<T>(to_f(rv.v[j]) + f);
  }
  return o;
}

// ACT: LeakyReLU; else the residual add (res is read only then)
template <typename T, int VEC, bool ACT>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ res, T* __restrict__ out,
                int P, int C, int G, int S, int ppb) {
  const int L = C / VEC, R = kThreads / L;
  const int t = threadIdx.x, lane = t % L, row = t / L;
  if (row >= R) return;
  const int n = blockIdx.x / S, s = blockIdx.x % S;
  const int p0 = s * ppb, p1 = min(P, p0 + ppb);
  const int Cg = C / G;
  float a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = lane * VEC + j, g = n * G + c / Cg;
    a[j] = rstd[g] * gamma[c];
    b[j] = fmaf(-a[j], mean[g], beta[c]);
  }
  const size_t base = static_cast<size_t>(n) * P * C + lane * VEC;
  using V = Pack<T, VEC>;
  int p = p0 + row;
  for (; p + (kUnroll - 1) * R < p1; p += kUnroll * R) {
    V xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t at = base + static_cast<size_t>(p + u * R) * C;
      xv[u] = *reinterpret_cast<const V*>(x + at);
      if (!ACT) rv[u] = *reinterpret_cast<const V*>(res + at);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      *reinterpret_cast<V*>(out + base + static_cast<size_t>(p + u * R) * C) =
          epilogue<T, VEC, ACT>(xv[u], rv[u], a, b);
  }
  for (; p < p1; p += R) {
    const size_t at = base + static_cast<size_t>(p) * C;
    V rv;
    if (!ACT) rv = *reinterpret_cast<const V*>(res + at);
    *reinterpret_cast<V*>(out + at) = epilogue<T, VEC, ACT>(*reinterpret_cast<const V*>(x + at), rv, a, b);
  }
}

template <typename T, int VEC>
cudaError_t launch_stats(const void* x, int n, int p, int c, int g, float eps, int s, int ppb,
                         float* ws, int* tickets, float* mean, float* rstd, cudaStream_t st) {
  gn_stats_kernel<T, VEC><<<n * s, kThreads, 0, st>>>(static_cast<const T*>(x), p, c, g, eps,
                                                      s, ppb, ws, tickets, mean, rstd);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_apply(const void* x, const float* mean, const float* rstd,
                         const float* gamma, const float* beta, const void* res, void* out,
                         int n, int p, int c, int g, int s, int ppb, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (res == nullptr)
    gn_apply_kernel<T, VEC, true><<<n * s, kThreads, 0, st>>>(xt, mean, rstd, gamma, beta,
                                                              nullptr, ot, p, c, g, s, ppb);
  else
    gn_apply_kernel<T, VEC, false><<<n * s, kThreads, 0, st>>>(
        xt, mean, rstd, gamma, beta, static_cast<const T*>(res), ot, p, c, g, s, ppb);
  return cudaGetLastError();
}

bool bad_shape(int n, int p, int c, int g, int vec, int s, int ppb) {
  return n <= 0 || p <= 0 || c <= 0 || g <= 0 || c % g != 0 || c > kMaxC || c % vec != 0 ||
         c / vec > kThreads || s <= 0 || ppb <= 0 || static_cast<long long>(s) * ppb < p;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vec: 16 / element size, or 1. x: [n, p, c]
// contiguous; s blocks of ppb pixels per sample; ws: n * s * 2 * c floats;
// tickets: n ints, 0 on entry and left 0; mean, rstd: [n, g] float32.
// Returns cudaGetLastError() after the launch.
extern "C" int idt_gn_stats(int dtype, int vec, const void* x, int n, int p, int c, int g,
                            float eps, int s, int ppb, float* ws, int* tickets, float* mean,
                            float* rstd, void* stream) {
  if (bad_shape(n, p, c, g, vec, s, ppb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return static_cast<int>(launch_stats<float, 4>(x, n, p, c, g, eps, s, ppb, ws, tickets, mean, rstd, st));
  if (dtype == 0 && vec == 1)
    return static_cast<int>(launch_stats<float, 1>(x, n, p, c, g, eps, s, ppb, ws, tickets, mean, rstd, st));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(launch_stats<__nv_bfloat16, 8>(x, n, p, c, g, eps, s, ppb, ws, tickets, mean, rstd, st));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(launch_stats<__nv_bfloat16, 1>(x, n, p, c, g, eps, s, ppb, ws, tickets, mean, rstd, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// As idt_gn_stats; gamma, beta: [c] float32; res: [n, p, c] like x for the
// residual add, or null for LeakyReLU; out: [n, p, c] like x.
extern "C" int idt_gn_apply(int dtype, int vec, const void* x, const float* mean,
                            const float* rstd, const float* gamma, const float* beta,
                            const void* res, void* out, int n, int p, int c, int g, int s,
                            int ppb, void* stream) {
  if (bad_shape(n, p, c, g, vec, s, ppb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return static_cast<int>(launch_apply<float, 4>(x, mean, rstd, gamma, beta, res, out, n, p, c, g, s, ppb, st));
  if (dtype == 0 && vec == 1)
    return static_cast<int>(launch_apply<float, 1>(x, mean, rstd, gamma, beta, res, out, n, p, c, g, s, ppb, st));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(launch_apply<__nv_bfloat16, 8>(x, mean, rstd, gamma, beta, res, out, n, p, c, g, s, ppb, st));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(launch_apply<__nv_bfloat16, 1>(x, mean, rstd, gamma, beta, res, out, n, p, c, g, s, ppb, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
