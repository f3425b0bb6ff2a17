// Implicit-GEMM convolution for the ImprovedUNet level-block chain, on
// Hopper's tensor cores.
//
// Replaces: image_denoising_tpu/ops/fused_block_pallas.py::fused_rdb_chain
// (the Pallas TPU kernel, body _chain_kernel). One level block is
//   [lead 3x3 conv + bias + LeakyReLU(0.2)]
//   -> 4 dense 3x3 growth-32 convs + bias + LeakyReLU over a growing buffer
//   -> 1x1 local-feature-fusion conv + bias + residual add
//   -> [ResBlock conv0, 3x3, no bias]
// with SAME zero padding. The Python wrapper (ops/fused_block.py) launches
// this kernel once per conv of the chain, every conv reading a channel
// prefix of ONE NHWC feature buffer and writing at its own channel offset,
// so the dense concat never materialises. Every conv accumulates in f32;
// each stored value is rounded once to the working type, as _chain_kernel
// does. The tensor cores truncate the f32 accumulator toward zero at every
// wgmma instruction: half an ulp of it on average, all one way. Carried
// over a whole conv (up to 1,944 instructions: 576 channels, 9 taps, 3
// TF32 products) that is about half the f32 limit on inputs of one sign.
// So f32 starts each K-stage's 27 instructions (9 taps x 3) from zero and
// adds their sum to a second accumulator in f32 registers, rounded to
// nearest. bf16 keeps one accumulator: at most 324 instructions, about
// 2e-5 of a value against a limit of 4 bf16 ulps.
//
// Design. One conv is a GEMM: M = the 64 pixels of an 8x8 output tile, N =
// an output-channel tile of NP (16 to 192, a multiple of 8), K = taps x
// input channels. A block has one consumer warpgroup and one producer warp.
//   * Input by TMA: a 4-D tensor map over the NHWC buffer (channel size =
//     the prefix read, row stride = the buffer's width) loads the (8+2)^2
//     halo of one 16-byte channel chunk (8 bf16 / 4 f32 channels) per copy.
//     Its zero fill at negative and past-the-edge coordinates IS the SAME
//     padding, and channels past the prefix (being written by this conv's
//     other blocks) are never read. The chunk lands as a plane of 16-byte
//     pixel rows: exactly the no-swizzle "core matrix" layout of wgmma, so
//     the A operand of tap (dy, dx) is a descriptor that starts at pixel
//     (dy, dx) of the halo, with one image row per 8-row group: im2col costs
//     no instruction, and each core matrix is 128 contiguous bytes (no bank
//     conflicts).
//   * Weights are repacked once per FusedChainWeights (the wrapper) into the
//     K-major layout [n_tile][chunk][tap][NP][16 bytes]; a K-stage (two
//     chunks, all taps) is one contiguous bulk copy.
//   * A ring of 2-4 stages on full/empty mbarriers; per stage and tap one
//     wgmma m64nNPk16 (bf16) or three m64nNPk8 tf32 (f32: 3xTF32, the
//     weights split into hi + lo by the wrapper, the activations in shared
//     memory by the consumers), so f32 keeps its tolerance. bf16 leaves one
//     stage's wgmma group running while the next is issued. f32 must wait
//     for a stage's group before adding it to its second accumulator, so it
//     splits the next stage's activations while the group runs instead.
//   * Epilogues, fused: bias + LeakyReLU; bias + residual with the LFF
//     rounded once before the add; plain. One rounding per stored value.
//   * Filling the card: where a launch has fewer than 132 blocks (the E6
//     16^2 and 8^2 levels) the wrapper splits K across blocks; they write
//     f32 partial sums and a second kernel adds them in a fixed order and
//     runs the epilogue, so the result is deterministic (no float atomics).
//
// What bounds it: the chain is ~133 GFLOP per 352^2 tile at the main path's
// shapes, far above the ridge point, so operations: 989 TFLOP/s in bf16 and
// 495/3 TFLOP/s for three TF32 products. Left for later: a chain-resident
// tile that keeps the growth outputs in shared memory across convs,
// persistent blocks, deeper K-stages, and a backward for training.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

using namespace idt;

constexpr int kTile = 8;          // tile rows; a warpgroup's M of 64 is 8 x 8 pixels
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxStages = 4;

// A probe build (scripts/probe_chain.py) takes parts out to time the rest;
// its results are wrong. The library the wrapper loads defines none.
#ifndef IDT_PROBE_SKIP
#define IDT_PROBE_SKIP 0
#endif
constexpr int kSkipMma = 1;     // issue no wgmma
constexpr int kSkipAct = 2;     // load no activation halo
constexpr int kSkipWeight = 4;  // copy no weights
__host__ __device__ constexpr bool probe_keeps(int part) { return (IDT_PROBE_SKIP & part) == 0; }

// M-tiles of 64 pixels per block, side by side: 8 x (8 MT) pixels share each
// weight stage. As many as keep the accumulators at 96 floats a thread.
__host__ __device__ constexpr int m_tiles(int np) { return np <= 48 ? 4 : (np <= 96 ? 2 : 1); }

// One chunk's halo plane: (8 + 2) x (8 MT + 2) pixel rows of 16 bytes,
// 128-byte aligned; a 1x1 conv uses the first 8 x 8 MT rows of it.
__host__ __device__ constexpr int plane_bytes(int mt) { return ((kTile + 2) * (kTile * mt + 2) * 16 + 127) / 128 * 128; }

enum Epilogue : int {
  kBiasLeaky = 0,     // out = T(leaky(acc + bias))
  kBiasResidual = 1,  // out = T(res + T(acc + bias))
  kPlain = 2,         // out = T(acc)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct ConvArgs {
  const void* in;     // [batch, h, w, in_stride], channels [0, cin) read
  const void* w_hi;   // packed weights [n_tiles][chunks][taps][NP][16 B]
  const void* w_lo;   // f32: the TF32 remainder, same layout; else null
  const void* bias;   // [cout] or null
  const void* res;    // [P, res_stride], channels [0, cout) (kBiasResidual)
  void* out;          // [P, out_stride], channels [out_off, out_off + cout)
  float* ws;          // split K: [splits][P][cout] f32 partial sums
  size_t pixels;      // P = batch * h * w
  int in_stride, res_stride, out_stride, out_off, cout, cin, batch;
  int taps, halo, k_stages, per_split, stages, epi;
  int h, w, tiles_x, tiles_y;
};

template <typename T>
__device__ __forceinline__ void store_out(const ConvArgs& a, size_t pix, int n,
                                          float v) {
  const T* bias = static_cast<const T*>(a.bias);
  if (a.epi == kBiasLeaky) {
    v += to_f32(bias[n]);
    v = fmaxf(v, 0.2f * v);
  } else if (a.epi == kBiasResidual) {
    const float lff = to_f32(from_f32<T>(v + to_f32(bias[n])));
    v = to_f32(static_cast<const T*>(a.res)[pix * a.res_stride + n]) + lff;
  }
  static_cast<T*>(a.out)[pix * a.out_stride + a.out_off + n] = from_f32<T>(v);
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
chain_conv_kernel(const __grid_constant__ CUtensorMap in_map, const ConvArgs a) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kChunk = 16 / sizeof(T);  // channels per 16-byte chunk
  constexpr int MT = m_tiles(NP);
  constexpr int kPlane = plane_bytes(MT);
  constexpr int kABytes = 2 * kPlane;      // two chunks: one K-step
  const uint32_t b_bytes = 2u * a.taps * NP * 16;
  const uint32_t stage_bytes = kABytes + b_bytes * (kF32 ? 2 : 1);

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t lo_off = a.stages * stage_bytes;  // f32: the activations' lo, x2
  const uint32_t bar_off = lo_off + (kF32 ? 2 * kABytes : 0);
  const uint32_t full0 = base + bar_off, empty0 = full0 + 8 * a.stages;

  int t = blockIdx.x;
  const int tx = t % a.tiles_x;
  t /= a.tiles_x;
  const int ty = t % a.tiles_y;
  const int img = t / a.tiles_y;
  const int x0 = tx * kTile * MT, y0 = ty * kTile;
  const int n_tile = blockIdx.y, split = blockIdx.z;
  const int s0 = split * a.per_split;
  const int s1 = min(a.k_stages, s0 + a.per_split);
  const int box_w = kTile * MT + 2 * a.halo;  // halo row length in pixels

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const size_t tile_bytes = static_cast<size_t>(2 * a.k_stages) * a.taps * NP * 16;
      const char* w_hi = static_cast<const char*>(a.w_hi) + n_tile * tile_bytes;
      const char* w_lo =
          kF32 ? static_cast<const char*>(a.w_lo) + n_tile * tile_bytes : nullptr;
      const uint32_t a_bytes = 2u * (kTile + 2 * a.halo) * box_w * 16;
      for (int s = s0; s < s1; ++s) {
        const int j = s - s0, slot = j % a.stages;
        mbar_wait(empty0 + 8 * slot, ((j / a.stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * slot, dst = base + slot * stage_bytes;
        mbar_arrive_expect_tx(full, (probe_keeps(kSkipAct) ? a_bytes : 0) +
                                        (probe_keeps(kSkipWeight) ? b_bytes * (kF32 ? 2 : 1) : 0));
        if constexpr (probe_keeps(kSkipAct)) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // past the last chunk (an odd count) load chunk 2s again: its
            // weights are zero, and finite data times zero adds nothing
            const int cc = (2 * s + c) * kChunk < a.cin ? 2 * s + c : 2 * s;
            tma_load_4d(dst + c * kPlane, &in_map, full, cc * kChunk, x0 - a.halo,
                        y0 - a.halo, img);
          }
        }
        if constexpr (probe_keeps(kSkipWeight)) {
          const size_t off = static_cast<size_t>(2 * s) * a.taps * NP * 16;
          bulk_load(dst + kABytes, w_hi + off, b_bytes, full);
          if (kF32) bulk_load(dst + kABytes + b_bytes, w_lo + off, b_bytes, full);
        }
      }
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float acc[MT][NP / 2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NP / 2; ++i) acc[m][i] = 0.f;

    // issue the products of this block's K-stage j (ring slot j % stages;
    // f32: the activations' lo in buffer j & 1) on acc, as one group
    auto mma_stage = [&](int j) {
      const uint32_t a_hi = base + (j % a.stages) * stage_bytes, b_hi = a_hi + kABytes;
      const uint32_t a_lo = base + lo_off + (j & 1) * kABytes, b_lo = b_hi + b_bytes;
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
      wgmma_fence();
      const uint32_t lbo_b = a.taps * NP * 16;
      for (int tap = 0; tap < a.taps; ++tap) {
        const int dy = a.halo ? tap / 3 : 0, dx = a.halo ? tap % 3 : 0;
        const uint32_t b_off = tap * NP * 16;
        const uint64_t db = make_desc(b_hi + b_off, lbo_b, 128, 0);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // tap (dy, dx) of M-tile m: the window that starts at halo pixel
          // (dy, dx + 8m), one halo row per 8 rows of M
          const uint32_t a_off = (dy * box_w + dx + kTile * m) * 16;
          const uint64_t da = make_desc(a_hi + a_off, kPlane, box_w * 16, 0);
          if constexpr (!probe_keeps(kSkipMma)) {
            continue;
          } else if constexpr (kF32) {
            wgmma_ss<NP, kTF32>(acc[m], da, db);
            wgmma_ss<NP, kTF32>(acc[m], da, make_desc(b_lo + b_off, lbo_b, 128, 0));
            wgmma_ss<NP, kTF32>(acc[m], make_desc(a_lo + a_off, kPlane, box_w * 16, 0),
                                db);
          } else {
            wgmma_ss<NP, kBF16>(acc[m], da, db);
          }
        }
      }
      wgmma_commit();
    };

    const int n_stages = s1 - s0;
    if constexpr (kF32) {
      // wait for stage j, then split its activations into TF32 hi (in
      // place) and lo (buffer j & 1); the weights come split
      auto split_stage = [&](int j) {
        const int slot = j % a.stages;
        mbar_wait(full0 + 8 * slot, (j / a.stages) & 1);
        float4* p = reinterpret_cast<float4*>(smem + slot * stage_bytes);
        float4* l = reinterpret_cast<float4*>(smem + lo_off + (j & 1) * kABytes);
        for (int i = threadIdx.x; i < kABytes / 16; i += kConsumers) {
          float4 v = p[i], hv, lv;
          split_tf32(v.x, hv.x, lv.x);
          split_tf32(v.y, hv.y, lv.y);
          split_tf32(v.z, hv.z, lv.z);
          split_tf32(v.w, hv.w, lv.w);
          p[i] = hv;
          l[i] = lv;
        }
        fence_proxy_async();
        named_barrier(1, kConsumers);
      };
      // each stage's 27 (1x1: 3) instructions per M-tile start from zero,
      // and their sum is added to total, rounded to nearest (header)
      float total[MT][NP / 2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) total[m][i] = 0.f;
      if (n_stages > 0) split_stage(0);
      for (int j = 0; j < n_stages; ++j) {
        mma_stage(j);
        // split the next stage while this one's products run: its lo
        // buffer's last reader, stage j - 1, finished at the wait below
        if (j + 1 < n_stages) split_stage(j + 1);
        wgmma_wait_all();
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
        mbar_arrive(empty0 + 8 * (j % a.stages));
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < NP / 2; ++i) {
            total[m][i] += acc[m][i];
            acc[m][i] = 0.f;
          }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < NP / 2; ++i) acc[m][i] = total[m][i];
    } else {
      for (int s = s0; s < s1; ++s) {
        const int j = s - s0, slot = j % a.stages;
        mbar_wait(full0 + 8 * slot, (j / a.stages) & 1);
        mma_stage(j);
        // keep this stage's products running; the previous stage's are done
        // and its slot goes back to the producer
        wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
        if (j > 0) mbar_arrive(empty0 + 8 * ((j - 1) % a.stages));
      }
      wgmma_wait_all();
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    }

    // acc[m][4i + 2j + c]: pixel (y0 + 2*warp + j, x0 + 8m + lane/4),
    // channel n_tile*NP + 8i + 2*(lane%4) + c
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int x = x0 + kTile * m + lane / 4;
#pragma unroll
      for (int jr = 0; jr < 2; ++jr) {
        const int y = y0 + 2 * warp + jr;
        if (y >= a.h || x >= a.w) continue;
        const size_t pix = (static_cast<size_t>(img) * a.h + y) * a.w + x;
#pragma unroll
        for (int i = 0; i < NP / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = n_tile * NP + 8 * i + 2 * (lane % 4) + c;
            if (n >= a.cout) continue;
            const float v = acc[m][4 * i + 2 * jr + c];
            if (a.ws != nullptr) {
              a.ws[(static_cast<size_t>(split) * a.pixels + pix) * a.cout + n] = v;
            } else {
              store_out<T>(a, pix, n, v);
            }
          }
        }
      }
    }
  }
}

// Split K: add the partial sums in split order, then the epilogue.
template <typename T>
__global__ void chain_finish_kernel(const ConvArgs a, int splits) {
  const size_t pixels = a.pixels;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pixels * a.cout) return;
  const size_t pix = i / a.cout;
  const int n = static_cast<int>(i % a.cout);
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += a.ws[z * pixels * a.cout + i];
  store_out<T>(a, pix, n, v);
}

template <typename T, int NP>
cudaError_t launch(ConvArgs a, int splits, cudaStream_t s) {
  constexpr int MT = m_tiles(NP);
  constexpr int kABytes = 2 * plane_bytes(MT);
  constexpr int esize = sizeof(T);
  a.tiles_x = (a.w + kTile * MT - 1) / (kTile * MT);
  a.tiles_y = (a.h + kTile - 1) / kTile;
  if (static_cast<long long>(a.tiles_x) * a.tiles_y * a.batch > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.cin), static_cast<cuuint64_t>(a.w),
                              static_cast<cuuint64_t>(a.h), static_cast<cuuint64_t>(a.batch)};
  const cuuint64_t px = static_cast<cuuint64_t>(a.in_stride) * esize;
  const cuuint64_t strides[3] = {px, px * a.w, px * a.w * a.h};
  const cuuint32_t box[4] = {16 / esize, static_cast<cuuint32_t>(kTile * MT + 2 * a.halo),
                             static_cast<cuuint32_t>(kTile + 2 * a.halo), 1};
  CUtensorMap map;
  if (!encode_tiled(&map,
                    esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    4, a.in, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;

  const int n_tiles = (a.cout + NP - 1) / NP;
  const int b_bytes = 2 * a.taps * NP * 16 * (esize == 4 ? 2 : 1);
  const int stage_bytes = kABytes + b_bytes;
  const int lo = esize == 4 ? 2 * kABytes : 0;
  int stages = (kMaxDynamicSmem - lo - 16 * kMaxStages) / stage_bytes;
  stages = stages > kMaxStages ? kMaxStages : stages;
  if (stages < 2) return cudaErrorInvalidConfiguration;
  a.stages = stages;
  const int smem = stages * stage_bytes + lo + 16 * stages;
  auto kernel = chain_conv_kernel<T, NP>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.tiles_x * a.tiles_y * a.batch, n_tiles, splits);
  kernel<<<grid, kThreads, smem, s>>>(map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = a.pixels * a.cout;
  chain_finish_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(a, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int np, const ConvArgs& a, int splits, cudaStream_t s) {
  switch (np) {
    case 16: return launch<T, 16>(a, splits, s);
    case 32: return launch<T, 32>(a, splits, s);
    case 48: return launch<T, 48>(a, splits, s);
    case 64: return launch<T, 64>(a, splits, s);
    case 96: return launch<T, 96>(a, splits, s);
  }
  if constexpr (sizeof(T) == 2) {
    switch (np) {
      case 128: return launch<T, 128>(a, splits, s);
      case 192: return launch<T, 192>(a, splits, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// One conv of the chain. dtype: 0 = float32, 1 = bfloat16. ks: 3 or 1.
// epi: 0 bias+LeakyReLU, 1 bias+residual, 2 plain.
// in: NHWC [batch, h, wd, in_stride], channels [0, cin) read; cin a
// multiple of the 16-byte chunk, in_stride * element size a multiple of 16,
// `in` 16-byte aligned. w_hi / w_lo: weights packed by the wrapper for
// output-channel tiles of np (w_lo: float32 only). splits > 1: K split
// across blocks into ws (splits * batch*h*wd * cout floats), then summed in
// order. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int idt_chain_conv(int dtype, int ks, int epi, const void* in,
                              int in_stride, int cin, const void* w_hi,
                              const void* w_lo, const void* bias, const void* res,
                              int res_stride, void* out, int out_stride, int out_off,
                              int cout, int np, int splits, void* ws, int batch,
                              int h, int wd, void* stream) {
  const int esize = dtype == 0 ? 4 : 2, chunk = 16 / esize;
  if (batch <= 0 || h <= 0 || wd <= 0 || cin <= 0 || cout <= 0 || splits <= 0 ||
      cin % chunk != 0 || (in_stride * esize) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(in) % 16 != 0 || (ks != 3 && ks != 1) ||
      (splits > 1 && ws == nullptr) || (dtype == 0 && w_lo == nullptr) ||
      (epi != kPlain && bias == nullptr) || (epi == kBiasResidual && res == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvArgs a{};
  a.in = in;
  a.w_hi = w_hi;
  a.w_lo = w_lo;
  a.bias = bias;
  a.res = res;
  a.out = out;
  a.ws = splits > 1 ? static_cast<float*>(ws) : nullptr;
  a.pixels = static_cast<size_t>(batch) * h * wd;
  a.in_stride = in_stride;
  a.res_stride = res_stride;
  a.out_stride = out_stride;
  a.out_off = out_off;
  a.cout = cout;
  a.cin = cin;
  a.batch = batch;
  a.taps = ks * ks;
  a.halo = ks / 2;
  a.k_stages = (cin / chunk + 1) / 2;
  a.per_split = (a.k_stages + splits - 1) / splits;
  a.epi = epi;
  a.h = h;
  a.w = wd;
  if ((splits - 1) * a.per_split >= a.k_stages)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(np, a, splits, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(np, a, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
