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
// What bounds it: bytes. At the training shape (N = 4, C = 1, 352^2, f32) it
// reads 1.98 MB and writes 0.99 MB of sub-images and 0.99 MB of selectors:
// about 1.2 us at 3.35 TB/s. Its 10 Philox rounds are about 100 integer
// operations per cell, which moves 32 bytes: far below the card's integer
// rate. In the N2N step the image was written by the noise op just before,
// so it is read from L2, and what is left above the bound is the fixed cost
// of starting the grid and waiting for the first loads.
//
// Design. The kernel moves bits and computes nothing on them, so it is
// templated on the element size (4 bytes: float32; 2 bytes: bfloat16) and on
// how many channels' loads it keeps in flight at once (min(C, 4)). Each
// thread owns 4 consecutive cells of one cell row (a quad); consecutive
// threads own consecutive quads, so every load and store of a warp is one
// contiguous run. On the vector path (W/2 a multiple of 4 and every pointer
// 16-byte aligned) a thread first issues the loads of both image rows of its
// quad for the first channels, 16 bytes each (two uint4 a row in float32,
// one in bfloat16), then runs the 4 independent Philox evaluations while the
// loads are in flight, then writes each selector map as one 16-byte int4 and
// each sub-image row as one 16-byte (float32) or 8-byte (bfloat16) vector.
// So a thread holds up to 4 channels x 64 bytes in flight, and the grid has
// a quarter of the old one-cell-per-thread grid's threads. The scalar path,
// a uniform branch of the same kernel, takes the shapes the vectors cannot:
// W/2 not a multiple of 4 (a row's last quad is partial, and rows start off
// 16 bytes) or an image that is not 16-byte aligned; it moves a cell row as
// one 8- or 4-byte pair and writes elements one by one. The grid is sized
// exactly, one thread a quad (a grid of one wave of blocks striding over the
// quads measured slower). One launch per call, on the caller's stream, no
// sync.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kQuad = 4;       // consecutive cells of one cell row per thread
constexpr int kMaxGroup = 4;   // channels whose loads are in flight together
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

__device__ __forceinline__ uint32_t pick(uint32_t pos, uint32_t tl, uint32_t tr,
                                         uint32_t bl, uint32_t br) {
  return pos == 0 ? tl : (pos == 1 ? tr : (pos == 2 ? bl : br));
}

// The element-size-dependent layout of a quad. An image row of a quad is
// 8 elements, kRowWords 32-bit words; a sub-image row of a quad is 4
// elements, kOutWords words. Elements are handled as their bits.
template <int kBytes>
struct Layout;

template <>
struct Layout<4> {
  static constexpr int kRowWords = 8;  // two uint4
  static constexpr int kOutWords = 4;  // one uint4
  using Pair = uint2;                  // a cell row's two elements
  using Elem = uint32_t;
  static __device__ __forceinline__ uint32_t left(const uint32_t* w, int k) { return w[2 * k]; }
  static __device__ __forceinline__ uint32_t right(const uint32_t* w, int k) { return w[2 * k + 1]; }
  static __device__ __forceinline__ void put(uint32_t* o, int k, uint32_t v) { o[k] = v; }
  static __device__ __forceinline__ uint32_t pair_left(Pair p) { return p.x; }
  static __device__ __forceinline__ uint32_t pair_right(Pair p) { return p.y; }
  static __device__ __forceinline__ void store(void* dst, const uint32_t* o) {
    *static_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  }
};

template <>
struct Layout<2> {
  static constexpr int kRowWords = 4;  // one uint4: word k holds cell k's pair
  static constexpr int kOutWords = 2;  // one uint2
  using Pair = uint32_t;               // little endian: the left element is the low half
  using Elem = uint16_t;
  static __device__ __forceinline__ uint32_t left(const uint32_t* w, int k) { return w[k] & 0xffffu; }
  static __device__ __forceinline__ uint32_t right(const uint32_t* w, int k) { return w[k] >> 16; }
  static __device__ __forceinline__ void put(uint32_t* o, int k, uint32_t v) {
    o[k >> 1] |= v << (16 * (k & 1));
  }
  static __device__ __forceinline__ uint32_t pair_left(Pair p) { return p & 0xffffu; }
  static __device__ __forceinline__ uint32_t pair_right(Pair p) { return p >> 16; }
  static __device__ __forceinline__ void store(void* dst, const uint32_t* o) {
    *static_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
  }
};

struct Geometry {
  const unsigned char* img;
  unsigned char* sub1;
  unsigned char* sub2;
  int* sel1;
  int* sel2;
  int n, c, h2, w2;
  int quads_per_row;  // ceil(w2 / 4)
  long long quads;    // n * h2 * quads_per_row
  uint32_t k0, k1;
};

// One row of a quad, `kRowWords` words from byte address `src`, 16 bytes a load.
template <int kBytes>
__device__ __forceinline__ void load_row(uint32_t* w, const unsigned char* src) {
#pragma unroll
  for (int v = 0; v < Layout<kBytes>::kRowWords / 4; ++v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src) + v);
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
}

// The vector path: a whole quad, every pointer 16-byte aligned.
template <int kBytes, int kGroup>
__device__ __forceinline__ void vector_quad(const Geometry& g, int image, int hh, int ww0) {
  using L = Layout<kBytes>;
  const long long cells = static_cast<long long>(g.h2) * g.w2;
  const long long cell0 = static_cast<long long>(hh) * g.w2 + ww0;
  const long long row_bytes = 2LL * g.w2 * kBytes;  // one image row, W elements
  // byte offset of the quad's top row in channel 0 of `image`
  const long long top0 =
      (static_cast<long long>(image) * g.c * 2 * g.h2 + 2LL * hh) * row_bytes +
      2LL * ww0 * kBytes;
  const long long plane_bytes = 2LL * g.h2 * row_bytes;

  uint32_t top[kGroup][L::kRowWords], bot[kGroup][L::kRowWords];
  auto load_group = [&](int ch0) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (ch0 + j < g.c) {
        const unsigned char* src = g.img + top0 + (ch0 + j) * plane_bytes;
        load_row<kBytes>(top[j], src);
        load_row<kBytes>(bot[j], src + row_bytes);
      }
    }
  };
  load_group(0);  // in flight while the draws run

  uint32_t p1[kQuad], p2[kQuad];
#pragma unroll
  for (int k = 0; k < kQuad; ++k) {
    const uint32_t r = philox_word0(static_cast<uint32_t>(cell0 + k),
                                    static_cast<uint32_t>(image), g.k0, g.k1) & 7u;
    p1[k] = (kPos1 >> (2 * r)) & 3u;
    p2[k] = (kPos2 >> (2 * r)) & 3u;
  }
  const long long sel_at = image * cells + cell0;
  *reinterpret_cast<int4*>(g.sel1 + sel_at) = make_int4(p1[0], p1[1], p1[2], p1[3]);
  *reinterpret_cast<int4*>(g.sel2 + sel_at) = make_int4(p2[0], p2[1], p2[2], p2[3]);

  for (int ch0 = 0; ch0 < g.c; ch0 += kGroup) {
    if (ch0) load_group(ch0);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (ch0 + j >= g.c) break;
      uint32_t o1[L::kOutWords] = {}, o2[L::kOutWords] = {};
#pragma unroll
      for (int k = 0; k < kQuad; ++k) {
        const uint32_t tl = L::left(top[j], k), tr = L::right(top[j], k);
        const uint32_t bl = L::left(bot[j], k), br = L::right(bot[j], k);
        L::put(o1, k, pick(p1[k], tl, tr, bl, br));
        L::put(o2, k, pick(p2[k], tl, tr, bl, br));
      }
      const long long out =
          ((static_cast<long long>(image) * g.c + ch0 + j) * cells + cell0) * kBytes;
      L::store(g.sub1 + out, o1);
      L::store(g.sub2 + out, o2);
    }
  }
}

// The scalar path: up to 4 cells, each cell row moved as one element pair.
template <int kBytes>
__device__ __forceinline__ void scalar_quad(const Geometry& g, int image, int hh, int ww0) {
  using L = Layout<kBytes>;
  using Pair = typename L::Pair;
  using Elem = typename L::Elem;
  const long long cells = static_cast<long long>(g.h2) * g.w2;
  const int count = min(kQuad, g.w2 - ww0);
  const Pair* img = reinterpret_cast<const Pair*>(g.img);  // a row is w2 pairs
  Elem* sub1 = reinterpret_cast<Elem*>(g.sub1);
  Elem* sub2 = reinterpret_cast<Elem*>(g.sub2);
  for (int k = 0; k < count; ++k) {
    const long long cell = static_cast<long long>(hh) * g.w2 + ww0 + k;
    const uint32_t r = philox_word0(static_cast<uint32_t>(cell),
                                    static_cast<uint32_t>(image), g.k0, g.k1) & 7u;
    const uint32_t p1 = (kPos1 >> (2 * r)) & 3u;
    const uint32_t p2 = (kPos2 >> (2 * r)) & 3u;
    g.sel1[image * cells + cell] = static_cast<int>(p1);
    g.sel2[image * cells + cell] = static_cast<int>(p2);
    for (int ch = 0; ch < g.c; ++ch) {
      const long long plane = static_cast<long long>(image) * g.c + ch;
      const long long top = (plane * 2 * g.h2 + 2LL * hh) * g.w2 + ww0 + k;
      const Pair t = img[top];
      const Pair b = img[top + g.w2];
      const uint32_t tl = L::pair_left(t), tr = L::pair_right(t);
      const uint32_t bl = L::pair_left(b), br = L::pair_right(b);
      const long long out = plane * cells + cell;
      sub1[out] = static_cast<Elem>(pick(p1, tl, tr, bl, br));
      sub2[out] = static_cast<Elem>(pick(p2, tl, tr, bl, br));
    }
  }
}

template <int kBytes, int kGroup>
__global__ void __launch_bounds__(kThreads)
subsample_pair_kernel(Geometry g, bool vec) {
  const long long qi = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (qi >= g.quads) return;
  const long long row = qi / g.quads_per_row;  // image * h2 + hh
  const int q = static_cast<int>(qi - row * g.quads_per_row);
  const int image = static_cast<int>(row / g.h2);
  const int hh = static_cast<int>(row - static_cast<long long>(image) * g.h2);
  if (vec) {
    vector_quad<kBytes, kGroup>(g, image, hh, q * kQuad);
  } else {
    scalar_quad<kBytes>(g, image, hh, q * kQuad);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int kBytes, int kGroup>
cudaError_t launch_group(const Geometry& g, bool vec, int blocks, cudaStream_t s) {
  subsample_pair_kernel<kBytes, kGroup><<<blocks, kThreads, 0, s>>>(g, vec);
  return cudaGetLastError();
}

template <int kBytes>
cudaError_t launch(const void* img, int n, int c, int h, int w,
                   unsigned long long seed, void* sub1, void* sub2, void* sel1,
                   void* sel2, cudaStream_t s) {
  Geometry g;
  g.img = static_cast<const unsigned char*>(img);
  g.sub1 = static_cast<unsigned char*>(sub1);
  g.sub2 = static_cast<unsigned char*>(sub2);
  g.sel1 = static_cast<int*>(sel1);
  g.sel2 = static_cast<int*>(sel2);
  g.n = n;
  g.c = c;
  g.h2 = h / 2;
  g.w2 = w / 2;
  g.quads_per_row = (g.w2 + kQuad - 1) / kQuad;
  g.quads = static_cast<long long>(n) * g.h2 * g.quads_per_row;
  g.k0 = static_cast<uint32_t>(seed & 0xffffffffull);
  g.k1 = static_cast<uint32_t>(seed >> 32);
  const bool vec = g.w2 % kQuad == 0 && aligned16(img) && aligned16(sub1) &&
                      aligned16(sub2) && aligned16(sel1) && aligned16(sel2);
  const long long blocks = (g.quads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int b = static_cast<int>(blocks);
  switch (c < kMaxGroup ? c : kMaxGroup) {
    case 1: return launch_group<kBytes, 1>(g, vec, b, s);
    case 2: return launch_group<kBytes, 2>(g, vec, b, s);
    case 3: return launch_group<kBytes, 3>(g, vec, b, s);
    default: return launch_group<kBytes, 4>(g, vec, b, s);
  }
}

}  // namespace

// elem_bytes: 4 (float32) or 2 (bfloat16). img [n, c, h, w] contiguous,
// aligned to two elements; h, w even. sub1, sub2 [n, c, h/2, w/2] of the same
// element size; sel1, sel2 int32 [n, h/2, w/2]. Launches on `stream`, does
// not synchronise, returns cudaGetLastError().
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
