// Streaming top-1 L2 retrieval over a memory bank, on Hopper.
//
// Replaces: image_denoising_tpu/memory/retrieval_pallas.py::top1_l2_retrieval
// (the Pallas TPU kernel, body _kernel). For queries q [B, D] and a bank
// [N, D] with precomputed squared norms sqn [N] it returns, per query,
//   argmin_n (sqn[n] - 2 q.b_n)        (the query's own norm is a constant)
// as int32 [B]. Ties go to the FIRST minimum, as torch/jnp argmin do. The
// [B, N] distance matrix is never stored.
//
// Three regimes, picked by the bank's type:
//   * float32 bank: float32 queries, f32 FMAs on the CUDA cores (no TF32:
//     it would rank differently from the float32 reference), f32 norms;
//   * bfloat16 bank: bfloat16 queries (the wrapper casts them, as the TPU
//     kernel does), each value widened exactly to f32 in shared memory,
//     then the f32 path;
//   * int8 bank (centered bytes k - 128): int8 queries, __dp4a with int32
//     accumulation and int32 norms. |2 q.b| <= 2 * D * 128 * 128 < 2^31 for
//     D = 16384, so every distance is exact and the indices are bit-equal to
//     any exact reference.
//
// Design. A block owns BM = 64 queries x BN = 128 bank rows. It walks D in
// stages of BK = 32 words (a word is one float, or four int8 values packed in
// an int), staging both tiles row-major in shared memory (27.6 KB, static)
// and prefetching the next stage's global loads into registers while it
// computes the current one. Each of its 256 threads keeps 4 queries x 8 bank
// rows of accumulators. The epilogue forms sqn - 2 q.b (the expression of
// _kernel:77), turns each (distance, index) pair into a 64-bit key whose
// unsigned order is the lexicographic order of (distance, index), reduces
// the keys over the block's rows with warp shuffles, and folds them into a
// per-query key with one 64-bit atomicMin per query and block. The minimum
// key is the first minimum whatever order the blocks run in, so the result
// is deterministic. Blocks that share a bank tile are adjacent in the grid,
// so the bank streams from device memory about once; the queries stay in L2.
// Bank rows past N are masked; padded rows (pad_bank_for_retrieval) carry a
// +inf / INT32_MAX norm and never win.
//
// What bounds it at the E6 shape (B = 400, N = 105,125, D = 16,384): 1.38
// TFLOP (2 per multiply-add) against 6.9 GB (f32), 3.4 GB (bf16) or 1.7 GB
// (int8) of bank. The peaks that bound the work are the tensor cores' (989
// TFLOP/s bf16, 1979 TOP/s int8) and the CUDA cores' 67 TFLOP/s for f32, so
// every regime is bound by operations. This first kernel runs on the CUDA
// cores in all three. Work left for later: wgmma for bf16, s8 mma for int8,
// TMA loads and a pipelined bank stream (warp-specialised producer).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64;        // queries per block
constexpr int BN = 128;       // bank rows per block
constexpr int BK = 32;        // words per shared-memory stage
constexpr int LD = BK + 4;    // row stride of the staged tiles, in words
constexpr int NTHREADS = 256;
constexpr int TM = BM / 16;   // queries per thread (rows ty + 16 i)
constexpr int TN = BN / 16;   // bank rows per thread (rows tx + 16 j)

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <int DT>
struct Traits {
  using Word = std::conditional_t<DT == kI8, int, float>;
  using Vec = std::conditional_t<DT == kI8, int4, float4>;
  static constexpr int kElemBytes = DT == kF32 ? 4 : (DT == kBF16 ? 2 : 1);
  static constexpr int kElemsPerWord = DT == kI8 ? 4 : 1;
  // words that one 16-byte global load yields
  static constexpr int kWordsPerLoad = DT == kBF16 ? 8 : 4;
};

__device__ __forceinline__ uint4 load16(const char* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Write one 16-byte load into shared memory as words (bf16 widens to f32).
template <int DT>
__device__ __forceinline__ void store_words(typename Traits<DT>::Word* dst,
                                            uint4 raw) {
  if constexpr (DT == kBF16) {
    // element 2i is the low half of 32-bit word i (little endian)
    float4* d = reinterpret_cast<float4*>(dst);
    d[0] = make_float4(__uint_as_float(raw.x << 16),
                       __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16),
                       __uint_as_float(raw.y & 0xffff0000u));
    d[1] = make_float4(__uint_as_float(raw.z << 16),
                       __uint_as_float(raw.z & 0xffff0000u),
                       __uint_as_float(raw.w << 16),
                       __uint_as_float(raw.w & 0xffff0000u));
  } else {
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ int dot4(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// (distance, index) -> key whose unsigned order is the lexicographic order.
__device__ __forceinline__ unsigned long long make_key(float sqn, float ab,
                                                       int n) {
  float d = sqn - 2.0f * ab;
  if (d == 0.0f) d = 0.0f;  // -0 and +0 compare equal: one key for both
  unsigned u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(n);
}

__device__ __forceinline__ unsigned long long make_key(int sqn, int ab, int n) {
  long long d = static_cast<long long>(sqn) - 2LL * ab;  // exact
  d = d < INT_MIN ? INT_MIN : (d > INT_MAX ? INT_MAX : d);
  const unsigned u = static_cast<unsigned>(static_cast<int>(d)) ^ 0x80000000u;
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(n);
}

template <int DT>
__global__ void __launch_bounds__(NTHREADS, 2)
top1_kernel(const char* __restrict__ q, const char* __restrict__ bank,
            const void* __restrict__ sqn_ptr, int B, int N, int DW,
            int q_tiles, unsigned long long* __restrict__ keys) {
  using T = Traits<DT>;
  using Word = typename T::Word;
  using Vec = typename T::Vec;
  constexpr int VW = T::kWordsPerLoad;
  constexpr int VPR = BK / VW;                          // loads per row
  constexpr int WB = T::kElemsPerWord * T::kElemBytes;  // bytes per word
  constexpr int QL = BM * VPR / NTHREADS;               // loads per thread
  constexpr int BL = BN * VPR / NTHREADS;
  static_assert(QL * NTHREADS == BM * VPR && BL * NTHREADS == BN * VPR, "");

  __shared__ __align__(16) Word s_q[BM * LD];
  __shared__ __align__(16) Word s_b[BN * LD];

  const int m0 = (blockIdx.x % q_tiles) * BM;
  const int n0 = (blockIdx.x / q_tiles) * BN;
  const size_t row_bytes = static_cast<size_t>(DW) * WB;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  uint4 rq[QL], rb[BL];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < QL; ++u) {
      const int i = tid + u * NTHREADS, r = i / VPR, kw = k0 + (i % VPR) * VW;
      rq[u] = (m0 + r < B && kw < DW)
                  ? load16(q + (m0 + r) * row_bytes + static_cast<size_t>(kw) * WB)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < BL; ++u) {
      const int i = tid + u * NTHREADS, r = i / VPR, kw = k0 + (i % VPR) * VW;
      rb[u] = (n0 + r < N && kw < DW)
                  ? load16(bank + (n0 + r) * row_bytes + static_cast<size_t>(kw) * WB)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < QL; ++u) {
      const int i = tid + u * NTHREADS;
      store_words<DT>(&s_q[(i / VPR) * LD + (i % VPR) * VW], rq[u]);
    }
#pragma unroll
    for (int u = 0; u < BL; ++u) {
      const int i = tid + u * NTHREADS;
      store_words<DT>(&s_b[(i / VPR) * LD + (i % VPR) * VW], rb[u]);
    }
  };

  Word acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Word(0);

  const int stages = (DW + BK - 1) / BK;
  load(0);
  store();
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load((s + 1) * BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      Vec a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const Vec*>(&s_q[(ty + 16 * i) * LD + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const Vec b = *reinterpret_cast<const Vec*>(&s_b[(tx + 16 * j) * LD + kk]);
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][j] = dot4(a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
    if (s + 1 < stages) {
      store();
      __syncthreads();
    }
  }

  const Word* sqn = static_cast<const Word*>(sqn_ptr);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    unsigned long long best = ~0ull;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) {
        const unsigned long long key = make_key(sqn[n], acc[i][j], n);
        best = key < best ? key : best;
      }
    }
    // the 16 lanes tx = 0..15 that share this query row are one half-warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o < best ? o : best;
    }
    const int m = m0 + ty + 16 * i;
    if (tx == 0 && m < B && best != ~0ull) atomicMin(&keys[m], best);
  }
}

__global__ void keys_to_index(const unsigned long long* __restrict__ keys,
                              int* __restrict__ out, int B) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < B) out[m] = static_cast<int>(keys[m] & 0xffffffffull);
}

template <int DT>
cudaError_t launch(const void* q, const void* bank, const void* sqn, int b,
                   int n, int d, unsigned long long* keys, int* out,
                   cudaStream_t s) {
  const int dw = d / Traits<DT>::kElemsPerWord;
  const long long q_tiles = (b + BM - 1) / BM, n_tiles = (n + BN - 1) / BN;
  if (q_tiles * n_tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * b, s);
  if (err != cudaSuccess) return err;
  top1_kernel<DT><<<static_cast<unsigned>(q_tiles * n_tiles), NTHREADS, 0, s>>>(
      static_cast<const char*>(q), static_cast<const char*>(bank), sqn, b, n,
      dw, static_cast<int>(q_tiles), keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys_to_index<<<(b + 255) / 256, 256, 0, s>>>(keys, out, b);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 bank + float32 queries + float32 norms; 1 = bfloat16 bank
// + bfloat16 queries + float32 norms; 2 = int8 bank + int8 queries + int32
// norms. q [b, d], bank [n, d] row-major, 16-byte aligned; d % 16 == 0.
// keys: scratch of b uint64. out: int32 [b]. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int idt_top1_l2(int dtype, const void* q, const void* bank,
                           const void* sqn, int b, int n, int d, void* keys,
                           void* out, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || d % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<unsigned long long*>(keys);
  auto* o = static_cast<int*>(out);
  switch (dtype) {
    case kF32: return static_cast<int>(launch<kF32>(q, bank, sqn, b, n, d, k, o, s));
    case kBF16: return static_cast<int>(launch<kBF16>(q, bank, sqn, b, n, d, k, o, s));
    case kI8: return static_cast<int>(launch<kI8>(q, bank, sqn, b, n, d, k, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
