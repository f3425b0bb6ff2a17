// Direct-convolution kernel for the ImprovedUNet level-block chain on Hopper.
//
// Replaces: image_denoising_tpu/ops/fused_block_pallas.py::fused_rdb_chain
// (the Pallas TPU kernel, body _chain_kernel). One level block is
//   [lead 3x3 conv + bias + LeakyReLU(0.2)]
//   -> 4 dense 3x3 growth-32 convs + bias + LeakyReLU over a growing buffer
//   -> 1x1 local-feature-fusion conv + bias + residual add
//   -> [ResBlock conv0, 3x3, no bias]
// with SAME zero padding. The Python wrapper (ops/fused_block.py) launches
// this kernel once per conv of the chain (6 or 7 launches per chain).
//
// Design, and why it differs from the TPU kernel: the Pallas kernel keeps a
// whole-image slab of every activation resident in ~116 MB of VMEM. An H100
// block has at most 227 KB of shared memory, and at the deep levels one pixel
// of the f32 feature buffer alone is 2 KB. So this first kernel keeps the
// TPU kernel's central idea and drops the residency:
//   * every conv reads a channel prefix of ONE NHWC feature buffer of width
//     nf + n_growth*growth and writes its output at its own channel offset,
//     so the dense concat never materialises;
//   * SAME padding is a predicated zero load at the image edge (no halo
//     padding on the host, no mask pass);
//   * accumulation is f32 on the CUDA cores; bias + LeakyReLU, or bias +
//     residual, run in the epilogue; each stored value is rounded once to the
//     working type (f32 or bf16), as _chain_kernel does.
// A block computes an 8x16 pixel tile for 32 output channels; per 16-channel
// stage it stages the (8+2)x(16+2) input halo and the 3x3x16x32 weights in
// shared memory (29.3 KB, static). Each thread keeps 4 pixels x 8 channels of
// f32 accumulators in registers.
//
// What bounds it: the chain is ~133 GFLOP per 352^2 tile in the main path's
// shapes, at 450-1200 FLOP per byte of unique traffic in f32 (twice that in
// bf16), far above the H100's ridge points (20 FLOP/B for f32 on the CUDA
// cores, 295 for bf16 on the tensor cores), so it is bound by operations.
// This kernel runs them as f32 FMAs on the CUDA cores (67 TFLOP/s peak), not
// on the tensor cores (989 TFLOP/s bf16), and it re-reads the feature buffer
// from L2/HBM once per conv. Work left for later:
// a spatial tile with recomputed halos kept in shared memory across the whole
// chain, wgmma implicit GEMM in bf16 (and 3xTF32 for f32), TMA loads with an
// mbarrier pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output columns per block
constexpr int BN = 32;       // output channels per block
constexpr int BK = 16;       // input channels per shared-memory stage
constexpr int NTHREADS = 128;
constexpr int PX = 4;        // consecutive output columns per thread
constexpr int CH = 8;        // consecutive output channels per thread

enum Epilogue : int {
  kBiasLeaky = 0,     // out = T(leaky(acc + bias))
  kBiasResidual = 1,  // out = T(res + T(acc + bias))
  kPlain = 2,         // out = T(acc)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// in:  [B, H, W, in_stride] NHWC, channels [0, cin) are read.
// w:   [KS, KS, cin, cout] (HWIO).
// out: [B, H, W, out_stride], channels [out_off, out_off + cout) written.
// res: [B, H, W, res_stride], channels [0, cout) read (kBiasResidual only).
// in and out may be the same buffer: the channel ranges are disjoint.
template <typename T, int KS, int EPI>
__global__ void __launch_bounds__(NTHREADS)
conv_kernel(const T* in, int in_stride, int cin, const T* w, const T* bias,
            const T* res, int res_stride, T* out, int out_stride, int out_off,
            int cout, int H, int W, int tiles_w) {
  constexpr int HALO = KS / 2;
  constexpr int IW = TW + KS - 1;
  constexpr int IPX = (TH + KS - 1) * IW;
  __shared__ float s_in[BK][IPX];
  __shared__ __align__(16) float s_w[KS * KS][BK][BN];

  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * TH;
  const int tx0 = (blockIdx.x % tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int cg = tid & 3;          // channels n0 + cg*8 .. +8
  const int pg = tid >> 2;         // 32 pixel groups of 4 columns
  const int prow = pg >> 2;        // 0..7
  const int pcol = (pg & 3) * PX;  // 0, 4, 8, 12

  float acc[PX][CH];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[i][j] = 0.f;

  const T* in_b = in + (size_t)b * H * W * in_stride;

  for (int k0 = 0; k0 < cin; k0 += BK) {
    for (int i = tid; i < IPX * BK; i += NTHREADS) {
      const int k = i % BK, p = i / BK;
      const int yy = ty0 - HALO + p / IW, xx = tx0 - HALO + p % IW;
      float v = 0.f;
      if (k0 + k < cin && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = to_f32(in_b[((size_t)yy * W + xx) * in_stride + k0 + k]);
      s_in[k][p] = v;
    }
    for (int i = tid; i < KS * KS * BK * BN; i += NTHREADS) {
      const int n = i % BN, k = (i / BN) % BK, t = i / (BN * BK);
      float v = 0.f;
      if (k0 + k < cin && n0 + n < cout)
        v = to_f32(w[((size_t)t * cin + k0 + k) * cout + n0 + n]);
      s_w[t][k][n] = v;
    }
    __syncthreads();

#pragma unroll
    for (int dy = 0; dy < KS; ++dy) {
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[PX + KS - 1];
        const float* row = &s_in[k][(prow + dy) * IW + pcol];
#pragma unroll
        for (int i = 0; i < PX + KS - 1; ++i) a[i] = row[i];
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const float4* wp =
              reinterpret_cast<const float4*>(&s_w[dy * KS + dx][k][cg * CH]);
          const float4 w0 = wp[0], w1 = wp[1];
          const float bw[CH] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < PX; ++i)
#pragma unroll
            for (int j = 0; j < CH; ++j)
              acc[i][j] = fmaf(a[i + dx], bw[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int y = ty0 + prow;
  if (y >= H) return;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    const int x = tx0 + pcol + i;
    if (x >= W) continue;
    const size_t pix = ((size_t)b * H + y) * W + x;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int n = n0 + cg * CH + j;
      if (n >= cout) continue;
      float v = acc[i][j];
      if (EPI == kBiasLeaky) {
        v += to_f32(bias[n]);
        v = fmaxf(v, 0.2f * v);
      } else if (EPI == kBiasResidual) {
        const float lff = to_f32(from_f32<T>(v + to_f32(bias[n])));
        v = to_f32(res[pix * res_stride + n]) + lff;
      }
      out[pix * out_stride + out_off + n] = from_f32<T>(v);
    }
  }
}

template <typename T, int KS, int EPI>
cudaError_t launch(const void* in, int in_stride, int cin, const void* w,
                   const void* bias, const void* res, int res_stride, void* out,
                   int out_stride, int out_off, int cout, int batch, int h,
                   int wd, cudaStream_t stream) {
  const int tiles_h = (h + TH - 1) / TH, tiles_w = (wd + TW - 1) / TW;
  const dim3 grid(tiles_h * tiles_w, (cout + BN - 1) / BN, batch);
  conv_kernel<T, KS, EPI><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const T*>(in), in_stride, cin, static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(res), res_stride,
      static_cast<T*>(out), out_stride, out_off, cout, h, wd, tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int ks, int epi, const void* in, int in_stride, int cin,
                     const void* w, const void* bias, const void* res,
                     int res_stride, void* out, int out_stride, int out_off,
                     int cout, int batch, int h, int wd, cudaStream_t s) {
  if (ks == 3 && epi == kBiasLeaky)
    return launch<T, 3, kBiasLeaky>(in, in_stride, cin, w, bias, res,
                                    res_stride, out, out_stride, out_off, cout,
                                    batch, h, wd, s);
  if (ks == 3 && epi == kPlain)
    return launch<T, 3, kPlain>(in, in_stride, cin, w, bias, res, res_stride,
                                out, out_stride, out_off, cout, batch, h, wd, s);
  if (ks == 1 && epi == kBiasResidual)
    return launch<T, 1, kBiasResidual>(in, in_stride, cin, w, bias, res,
                                       res_stride, out, out_stride, out_off,
                                       cout, batch, h, wd, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// One conv of the chain. dtype: 0 = float32, 1 = bfloat16. ks: 3 or 1.
// epi: 0 bias+LeakyReLU (ks 3), 1 bias+residual (ks 1), 2 plain (ks 3).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int idt_chain_conv(int dtype, int ks, int epi, const void* in,
                              int in_stride, int cin, const void* w,
                              const void* bias, const void* res,
                              int res_stride, void* out, int out_stride,
                              int out_off, int cout, int batch, int h, int wd,
                              void* stream) {
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(ks, epi, in, in_stride, cin, w, bias, res,
                          res_stride, out, out_stride, out_off, cout, batch, h,
                          wd, s);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(ks, epi, in, in_stride, cin, w, bias, res,
                                  res_stride, out, out_stride, out_off, cout,
                                  batch, h, wd, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
