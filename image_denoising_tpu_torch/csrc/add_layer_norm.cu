// Restormer's residual add and BiasFree LayerNorm over NHWC activations, in
// one pass, on Hopper.
//
// Replaces no TPU kernel: the JAX package has no Restormer. It was added for
// the bytes. The served Restormer forward (models/restormer.py, bf16,
// channels_last) ran each block's residual add as one plain op and each
// BiasFree LayerNorm as six (a cast to float32, the variance, + eps and sqrt,
// the divide, the scale, the cast back) on PyTorch's generic broadcasting
// elementwise path: about 38 bytes a channel-pixel for an add and its norm in
// bf16. This kernel moves 8 (reads x and r, writes s and y), or 4 without a
// residual (reads x, writes y).
//
//   s = x + r   rounded to the element type, as PyTorch's add on that type
//               rounds (the float32 sum, rounded once); s = x without r
//   y = s / sqrt(Var_c(s) + eps) * w
//               in float32 from the rounded s, then rounded once to the
//               element type; Var_c biased and centred, the numerator not
//               centred (Restormer's BiasFree LayerNorm); the divide, then
//               the scale, as the plain ops order them.
//
// What bounds it: bytes. It does about 2 flops a byte, against the ~295 a
// byte at which the card's bf16 tensor cores would be the limit. An E2 burst
// of Restormer (9 chunks of 8 tiles of 352^2, 44 blocks, 2 calls a block,
// each stage's first without a residual) makes 792 calls over 12.85 G
// channel-pixels: 194 GB in bf16, 58 ms at 3.35 TB/s.
//
// Design. A pixel is a group of G lanes, G a power of two of at most 32, so
// that the group lies in one warp. Each lane holds K 16-byte vectors of the
// pixel's channels (8 bf16 or 4 float32 values each): lane j the vectors j,
// j + G, ..., so each load of a group is G contiguous vectors. C = K * G *
// VEC: Restormer's 48, 96, 192 and 384 channels are K = 3 and G = 2, 4, 8, 16
// in bf16 (4, 8, 16, 32 in float32); the wrapper (ops/layer_norm.py::
// add_ln_plan) picks the smallest K of 1 to 4 that gives such a G, and
// passes both. The
// pixel's sums stay in registers, in the element type: their float32 sum,
// then their centred sum of squares, each over the group by xor shuffles, so
// there is no shared memory and no second read of device memory. A lane's
// weights are loaded once, into registers (80 registers a thread at most,
// three blocks of 256 threads an SM). The grid is one wave, as many blocks
// as the card holds at once (the occupancy API, asked once a kernel); each
// warp strides over the pixels, 32 / G at a time, in a loop that is uniform
// over the warp, so every shuffle has all of its lanes.
//
// Where C is no such multiple, or a pointer is not 16-byte aligned, a warp
// takes one pixel at a time, one value a lane, in three passes over the pixel
// (the sum, the centred squares, the result) that read it again from the
// cache: right for any C, and not tuned.
//
// One launch per call, on the caller's stream; no sync, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 3;  // holds the vector kernel to 80 registers a thread
constexpr unsigned kFull = 0xffffffffu;

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

// the sum over the aligned group of g lanes (g a power of two); every lane
// of the group gets the same value
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T, int VEC, int K, bool RES>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
add_ln_vec_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ w, T* __restrict__ s_out, T* __restrict__ y_out,
                  int P, int C, int G, float eps) {
  using V = Pack<T, VEC>;
  const int lane = threadIdx.x & 31, j = lane & (G - 1), per_warp = 32 / G;
  const int warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int warps = gridDim.x * (kThreads / 32);
  const float c = static_cast<float>(C);
  float wk[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) wk[k][i] = w[(k * G + j) * VEC + i];

  for (int p0 = warp * per_warp; p0 < P; p0 += warps * per_warp) {
    const int p = p0 + lane / G;
    const bool live = p < P;
    const size_t at = static_cast<size_t>(live ? p : 0) * C + j * VEC;
    V sv[K];
    float sum = 0.f;
    if (live) {
      V xv[K], rv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xv[k] = *reinterpret_cast<const V*>(x + at + k * G * VEC);
        if (RES) rv[k] = *reinterpret_cast<const V*>(r + at + k * G * VEC);
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          sv[k].v[i] = RES ? from_f<T>(to_f(xv[k].v[i]) + to_f(rv[k].v[i])) : xv[k].v[i];
          sum += to_f(sv[k].v[i]);
        }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) sv[k].v[i] = from_f<T>(0.f);
    }
    const float mean = group_sum(sum, G) / c;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = to_f(sv[k].v[i]) - mean;
        sq = fmaf(d, d, sq);
      }
    const float den = sqrtf(group_sum(sq, G) / c + eps);
    if (!live) continue;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      V yv;
#pragma unroll
      for (int i = 0; i < VEC; ++i) yv.v[i] = from_f<T>(to_f(sv[k].v[i]) / den * wk[k][i]);
      if (RES) *reinterpret_cast<V*>(s_out + at + k * G * VEC) = sv[k];
      *reinterpret_cast<V*>(y_out + at + k * G * VEC) = yv;
    }
  }
}

template <typename T, bool RES>
__device__ __forceinline__ T sum_at(const T* __restrict__ x, const T* __restrict__ r, size_t i) {
  return RES ? from_f<T>(to_f(x[i]) + to_f(r[i])) : x[i];
}

// one pixel a warp, one value a lane: any C, any element alignment
template <typename T, bool RES>
__global__ void __launch_bounds__(kThreads)
add_ln_scalar_kernel(const T* __restrict__ x, const T* __restrict__ r,
                     const float* __restrict__ w, T* __restrict__ s_out,
                     T* __restrict__ y_out, int P, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const float c = static_cast<float>(C);
  for (int p = (blockIdx.x * kThreads + threadIdx.x) >> 5; p < P; p += warps) {
    const size_t base = static_cast<size_t>(p) * C;
    float sum = 0.f;
    for (int k = lane; k < C; k += 32) sum += to_f(sum_at<T, RES>(x, r, base + k));
    const float mean = group_sum(sum, 32) / c;
    float sq = 0.f;
    for (int k = lane; k < C; k += 32) {
      const float d = to_f(sum_at<T, RES>(x, r, base + k)) - mean;
      sq = fmaf(d, d, sq);
    }
    const float den = sqrtf(group_sum(sq, 32) / c + eps);
    for (int k = lane; k < C; k += 32) {
      const T s = sum_at<T, RES>(x, r, base + k);
      if (RES) s_out[base + k] = s;
      y_out[base + k] = from_f<T>(to_f(s) / den * w[k]);
    }
  }
}

// the blocks of one wave of Kernel on the current device: as many as are
// resident at once on all of its SMs; kept per kernel
template <auto Kernel>
int wave() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads, 0);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  return blocks;
}

template <auto Kernel, typename... Args>
cudaError_t launch_wave(int blocks, cudaStream_t st, Args... args) {
  const int most = wave<Kernel>();
  Kernel<<<blocks < most ? blocks : most, kThreads, 0, st>>>(args...);
  return cudaGetLastError();
}

template <typename T, int VEC, int K>
cudaError_t launch_vec(int g, const void* x, const void* r, const float* w, void* s, void* y,
                       int p, int c, float eps, int blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (r != nullptr)
    return launch_wave<add_ln_vec_kernel<T, VEC, K, true>>(
        blocks, st, xt, static_cast<const T*>(r), w, static_cast<T*>(s), static_cast<T*>(y), p,
        c, g, eps);
  return launch_wave<add_ln_vec_kernel<T, VEC, K, false>>(
      blocks, st, xt, static_cast<const T*>(nullptr), w, static_cast<T*>(nullptr),
      static_cast<T*>(y), p, c, g, eps);
}

template <typename T>
cudaError_t launch(int k, int g, const void* x, const void* r, const float* w, void* s,
                   void* y, int p, int c, float eps, int blocks, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  switch (k) {
    case 1: return launch_vec<T, VEC, 1>(g, x, r, w, s, y, p, c, eps, blocks, st);
    case 2: return launch_vec<T, VEC, 2>(g, x, r, w, s, y, p, c, eps, blocks, st);
    case 3: return launch_vec<T, VEC, 3>(g, x, r, w, s, y, p, c, eps, blocks, st);
    case 4: return launch_vec<T, VEC, 4>(g, x, r, w, s, y, p, c, eps, blocks, st);
    default: break;
  }
  const T* xt = static_cast<const T*>(x);
  if (r != nullptr)
    return launch_wave<add_ln_scalar_kernel<T, true>>(
        blocks, st, xt, static_cast<const T*>(r), w, static_cast<T*>(s), static_cast<T*>(y), p,
        c, eps);
  return launch_wave<add_ln_scalar_kernel<T, false>>(
      blocks, st, xt, static_cast<const T*>(nullptr), w, static_cast<T*>(nullptr),
      static_cast<T*>(y), p, c, eps);
}

// the plan out of range: k > 0 needs g a power of two of at most 32 and
// c = k * g * vec
bool bad_shape(int k, int g, int vec, int p, int c, int blocks) {
  if (p <= 0 || c <= 0 || blocks <= 0 || k < 0 || k > 4) return true;
  if (k == 0) return false;
  return g < 1 || g > 32 || (g & (g - 1)) != 0 || c != k * g * vec;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. k: the 16-byte vectors a lane holds (1 to
// 4), or 0 for one value a lane; g: the lanes a pixel where k > 0 (unused
// where k = 0). The wrapper's plan (ops/layer_norm.py::add_ln_plan) picks
// both. x, r, s, y: [p, c] contiguous, 16-byte aligned where k > 0; r null
// for no residual, and s then unused (s = x); w: [c] float32. blocks:
// enough to give every pixel its lanes; the grid is at most one wave of
// them. Returns cudaGetLastError() after the launch.
extern "C" int idt_add_ln(int dtype, int k, int g, const void* x, const void* r,
                          const float* w, void* s, void* y, int p, int c, float eps, int blocks,
                          void* stream) {
  const int vec = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || bad_shape(k, g, vec, p, c, blocks) ||
      (r != nullptr && s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(k, g, x, r, w, s, y, p, c, eps, blocks, st));
  return static_cast<int>(launch<__nv_bfloat16>(k, g, x, r, w, s, y, p, c, eps, blocks, st));
}
