// Neighbor2Neighbor random sub-sampler, on Hopper.
//
// Replaces: image_denoising_tpu/ops/neighbor_pallas.py::subsample_pair_pallas
// (the Pallas TPU kernel, body _make_kernel with _lut and _select_pos). For
// an NCHW image [N, C, H, W] (H, W even) and a 64-bit seed it draws, for every
// image and every 2x2 cell, r uniform in [0, 8), maps r through the TPU
// kernel's _POS1 / _POS2 tables to two distinct cell positions (0 = TL,
// 1 = TR, 2 = BL, 3 = BR) and writes
//   sel1, sel2  int32 [N, H/2, W/2]       the two positions, once per cell;
//   sub1, sub2  [N, C, H/2, W/2]          the cell's values at those
//                                         positions, for every channel.
// One draw per cell is shared by all channels, as in the TPU kernel.
//
// The draw. The TPU's on-core PRNG has no counterpart here; this kernel runs
// Philox4x32-10 (Random123's constants and round order) as a device function:
// key = (seed low word, seed high word), counter = (cell index h2 * (W/2) + w2,
// image index n, 0, 0), r = word 0 mod 8 -- exactly uniform, since 2^32 is a
// multiple of 8. The plain version (ops/neighbor.py::generate_mask_pair) uses
// the same layout, so the two agree bit for bit.
//
// Design. The kernel moves bits and computes nothing on them, so it is
// templated on the element size only (4 bytes: float32; 2 bytes: bfloat16).
// One thread owns one cell: it draws once, writes sel1 and sel2 once, and for
// each channel loads the cell's two rows as one 8- or 4-byte pair each and
// writes one element of sub1 and of sub2. Consecutive threads own
// consecutive cells of a row, so every load and store of a warp is one
// contiguous run. One launch per call, on the caller's stream, no sync.
//
// What bounds it: bytes. At the training shape (N = 4, C = 1, 352^2, f32) it
// reads 1.98 MB and writes 0.99 MB of sub-images and 0.99 MB of selectors:
// about 1.2 us at 3.35 TB/s. Its 10 Philox rounds are about 100 integer
// operations per cell, which moves 32 bytes: far below the card's integer
// rate. At this size the launch itself takes longer than the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // round multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // key increments

// The 8 entries of a position table, 2 bits each, entry r at bits 2r..2r+1.
constexpr uint32_t pack_positions(uint32_t p0, uint32_t p1, uint32_t p2,
                                  uint32_t p3, uint32_t p4, uint32_t p5,
                                  uint32_t p6, uint32_t p7) {
  return p0 | p1 << 2 | p2 << 4 | p3 << 6 | p4 << 8 | p5 << 10 | p6 << 12 |
         p7 << 14;
}
constexpr uint32_t kPos1 = pack_positions(0, 0, 1, 2, 1, 2, 3, 3);  // _POS1
constexpr uint32_t kPos2 = pack_positions(1, 2, 3, 3, 0, 0, 1, 2);  // _POS2

// Word 0 of Philox4x32-10 of counter (c0, c1, 0, 0) under key (k0, k1).
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t k0, uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

// A cell row's two horizontally adjacent elements, loaded at once.
template <int kBytes>
struct CellRow;

template <>
struct CellRow<4> {
  using Elem = uint32_t;
  using Pair = uint2;
  static __device__ __forceinline__ Elem left(Pair p) { return p.x; }
  static __device__ __forceinline__ Elem right(Pair p) { return p.y; }
};

template <>
struct CellRow<2> {
  using Elem = uint16_t;
  using Pair = uint32_t;  // little endian: the left element is the low half
  static __device__ __forceinline__ Elem left(Pair p) {
    return static_cast<Elem>(p & 0xffffu);
  }
  static __device__ __forceinline__ Elem right(Pair p) {
    return static_cast<Elem>(p >> 16);
  }
};

template <typename Elem>
__device__ __forceinline__ Elem pick(uint32_t pos, Elem tl, Elem tr, Elem bl,
                                     Elem br) {
  return pos == 0 ? tl : (pos == 1 ? tr : (pos == 2 ? bl : br));
}

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
subsample_pair_kernel(const typename CellRow<kBytes>::Pair* __restrict__ img,
                      int n, int c, int h2, int w2, uint32_t k0, uint32_t k1,
                      typename CellRow<kBytes>::Elem* __restrict__ sub1,
                      typename CellRow<kBytes>::Elem* __restrict__ sub2,
                      int* __restrict__ sel1, int* __restrict__ sel2) {
  using Row = CellRow<kBytes>;
  const long long cells = static_cast<long long>(h2) * w2;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= cells * n) return;
  const int image = static_cast<int>(idx / cells);
  const long long cell = idx - image * cells;  // h2 * (W/2) + w2
  const long long hh = cell / w2, ww = cell - hh * w2;

  const uint32_t r = philox_word0(static_cast<uint32_t>(cell),
                                  static_cast<uint32_t>(image), k0, k1) & 7u;
  const uint32_t p1 = (kPos1 >> (2 * r)) & 3u;
  const uint32_t p2 = (kPos2 >> (2 * r)) & 3u;
  sel1[idx] = static_cast<int>(p1);
  sel2[idx] = static_cast<int>(p2);

  // a row of W elements is w2 pairs; the cell's rows are 2hh and 2hh + 1
  for (int ch = 0; ch < c; ++ch) {
    const long long plane = static_cast<long long>(image) * c + ch;
    const long long top = (plane * 2 * h2 + 2 * hh) * w2 + ww;
    const typename Row::Pair t = img[top];
    const typename Row::Pair b = img[top + w2];
    const typename Row::Elem tl = Row::left(t), tr = Row::right(t);
    const typename Row::Elem bl = Row::left(b), br = Row::right(b);
    const long long out = plane * cells + cell;
    sub1[out] = pick(p1, tl, tr, bl, br);
    sub2[out] = pick(p2, tl, tr, bl, br);
  }
}

template <int kBytes>
cudaError_t launch(const void* img, int n, int c, int h, int w,
                   unsigned long long seed, void* sub1, void* sub2, void* sel1,
                   void* sel2, cudaStream_t s) {
  using Row = CellRow<kBytes>;
  const long long cells = static_cast<long long>(n) * (h / 2) * (w / 2);
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  subsample_pair_kernel<kBytes><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const typename Row::Pair*>(img), n, c, h / 2, w / 2,
      static_cast<uint32_t>(seed & 0xffffffffull), static_cast<uint32_t>(seed >> 32),
      static_cast<typename Row::Elem*>(sub1), static_cast<typename Row::Elem*>(sub2),
      static_cast<int*>(sel1), static_cast<int*>(sel2));
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 (float32) or 2 (bfloat16). img [n, c, h, w]
// contiguous, aligned to two elements; h, w even. sub1, sub2 [n, c, h/2, w/2]
// of the same element size; sel1, sel2 int32 [n, h/2, w/2]. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int idt_subsample_pair(int elem_bytes, const void* img, int n, int c,
                                  int h, int w, unsigned long long seed,
                                  void* sub1, void* sub2, void* sel1, void* sel2,
                                  void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || h % 2 != 0 || w % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 4: return static_cast<int>(launch<4>(img, n, c, h, w, seed, sub1, sub2, sel1, sel2, s));
    case 2: return static_cast<int>(launch<2>(img, n, c, h, w, seed, sub1, sub2, sel1, sel2, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

// The least a launch costs: a kernel with no work. chip_smoke.py times it to
// put the sub-sampler's few microseconds beside the card's launch floor.
__global__ void empty_kernel() {}

}  // namespace

// Launches the empty kernel `count` times back to back on `stream` (one
// block of 32 threads each), does not synchronise, returns
// cudaGetLastError().
extern "C" int idt_empty_launches(int count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < count; ++i) empty_kernel<<<1, 32, 0, s>>>();
  return static_cast<int>(cudaGetLastError());
}
