// Streaming top-1 L2 retrieval over a memory bank, on Hopper's tensor cores.
//
// Replaces: image_denoising_tpu/memory/retrieval_pallas.py::top1_l2_retrieval
// (the Pallas TPU kernel, body _kernel). For queries q [B, D] and a bank
// [N, D] with precomputed squared norms sqn [N] it returns, per query,
//   argmin_n (sqn[n] - 2 q.b_n)        (the query's own norm is a constant)
// as int32 [B]. Ties go to the FIRST minimum, as torch/jnp argmin do. The
// [B, N] distance matrix is never stored.
//
// Three regimes, picked by the bank's type:
//   * bfloat16 bank, bfloat16 queries: wgmma m64nNk16 bf16 -> f32;
//   * int8 bank (centered bytes k - 128), int8 queries: wgmma m64nNk32
//     s8 -> s32, exact: |2 q.b| <= 2 * D * 128 * 128 < 2^31 for D = 16384,
//     so the indices are bit-equal to any exact reference;
//   * float32 bank, float32 queries: 3xTF32. Each operand is split in
//     shared memory into hi (rounded to TF32) + lo (the exact rest), and
//     hi.hi + hi.lo + lo.hi run on wgmma m64nNk8 tf32. The tensor cores
//     truncate the f32 accumulator at every instruction, so one accumulator
//     over D = 16,384 (6,144 instructions) loses some 2^-12 of q.b, all in
//     one direction. So each K-stage's 12 instructions start from zero and
//     their sum is added to a second accumulator in f32 registers, rounded
//     to nearest: about 2^-21 of sum |q b| from the dropped lo.lo, lo's
//     truncation and a stage's truncations, far inside the f32 reference's
//     rounding budget. The second accumulator caps a query tile at 128
//     columns. The split costs one extra stage-sized buffer pair in shared
//     memory (2 x 32 KB at N = 128) and no extra device-memory bytes.
//
// Design. The bank is wgmma's M and the queries its N: a block owns 128
// bank rows (two consumer warpgroups of 64) and one query tile of BN = 8 to
// 256 columns (bf16 and int8 run B = 400 as two tiles of 208, float32 as
// four of 128; B = 8 as one of 8, with nothing empty). A producer warp
// streams D in K-stages of 128 bytes per row (32 f32, 64 bf16, 128 int8)
// with TMA: a 2-D tensor map over the bank and one over the queries,
// 128-byte swizzle as the wgmma descriptors expect, into a ring of 2-8
// stages on full/empty mbarriers; it gives up registers (setmaxnreg) to
// the consumers. TMA's zero fill covers a ragged
// N, B and D; the epilogue masks rows past N and queries past B. Blocks
// that share a bank tile are adjacent in the grid, so the bank streams from
// device memory about once and the other query tiles read it from L2.
// Epilogue: sqn - 2 q.b (the expression of _kernel:77), each (distance,
// index) pair as a 64-bit key whose unsigned order is the lexicographic
// order of (distance, index); a min over the accumulator fragment's rows,
// over the warp with shuffles, over the block's 8 warps in shared memory,
// then one 64-bit atomicMin per query and block. The minimum key is the
// first minimum whatever order the blocks run in, so the result is
// deterministic. Padded rows (pad_bank_for_retrieval) carry a +inf /
// INT32_MAX norm and never win.
//
// What bounds it at the E6 shape (B = 400, N = 105,125, D = 16,384): 1.38
// TFLOP (2 per multiply-add) against 6.9 GB (f32), 3.4 GB (bf16) or 1.7 GB
// (int8) of bank: operations at the tensor cores' 989 TFLOP/s (bf16), 1979
// TOP/s (int8) and 495/3 TFLOP/s (three TF32 products); at B = 8 the bank's
// bytes over 3.35 TB/s.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

using namespace idt;

constexpr int kBankRows = 128;    // bank rows per block: two warpgroups of 64
constexpr int kRowBytes = 128;    // bytes of one row in one K-stage
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // + a producer warpgroup (one thread issues)
constexpr int kMaxStages = 8;

enum DType : int { kF32 = 0, kBf16 = 1, kI8 = 2 };

template <int DT>
struct Regime {
  static constexpr int kKind = DT == kF32 ? kTF32 : (DT == kBf16 ? kBF16 : kS8);
  static constexpr int kElemBytes = DT == kF32 ? 4 : (DT == kBf16 ? 2 : 1);
  static constexpr int kStageElems = kRowBytes / kElemBytes;
  using Acc = typename WgmmaAcc<kKind>::type;
};

// (distance, index) -> key whose unsigned order is the lexicographic order.
__device__ __forceinline__ unsigned long long make_key(float sqn, float ab, int n) {
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

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

// Split `rows` rows of 32 floats at `p` into TF32 hi (in place) and lo.
__device__ __forceinline__ void split_rows(float* p, float* lo, int rows, int t) {
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int i = t; i < rows * (kRowBytes / 16); i += 128) {
    float4 v = p4[i], h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    p4[i] = h;
    l4[i] = l;
  }
}

template <int DT, int BN>
__global__ void __launch_bounds__(kThreads, 1)
top1_kernel(const __grid_constant__ CUtensorMap bank_map,
            const __grid_constant__ CUtensorMap q_map, const void* __restrict__ sqn_ptr,
            int B, int N, int k_stages, int q_tiles, int stages,
            unsigned long long* __restrict__ keys) {
  using R = Regime<DT>;
  using Acc = typename R::Acc;
  constexpr uint32_t kStageBytes = (kBankRows + BN) * kRowBytes;
  constexpr uint32_t kQueryOff = kBankRows * kRowBytes;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;  // 128B swizzle: 1 KB aligned
  unsigned char* smem = smem_raw + pad;
  const uint32_t ring = raw + pad;
  const uint32_t lo_off = stages * kStageBytes;  // f32 only: two lo buffers
  const uint32_t bar_off = lo_off + (DT == kF32 ? 2 * kStageBytes : 0);
  const uint32_t full0 = ring + bar_off, empty0 = full0 + 8 * stages;

  const int q0 = (blockIdx.x % q_tiles) * BN;
  const int n0 = (blockIdx.x / q_tiles) * kBankRows;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer warpgroup: one thread keeps the ring full
    reg_dealloc<40>();
    if (threadIdx.x == kConsumers) {
      for (int s = 0; s < k_stages; ++s) {
        const int slot = s % stages;
        mbar_wait(empty0 + 8 * slot, ((s / stages) & 1) ^ 1);
        const uint32_t full = full0 + 8 * slot, dst = ring + slot * kStageBytes;
        mbar_arrive_expect_tx(full, kStageBytes);
        tma_load_2d(dst, &bank_map, full, s * R::kStageElems, n0);
        tma_load_2d(dst + kQueryOff, &q_map, full, s * R::kStageElems, q0);
      }
    }
  } else {
    reg_alloc<232>();
    const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    Acc acc[BN / 2];
    Acc total[DT == kF32 ? BN / 2 : 1];  // f32: the sum of the K-stages' acc
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
    if constexpr (DT == kF32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) total[i] = 0.0f;
    }

    for (int s = 0; s < k_stages; ++s) {
      const int slot = s % stages;
      mbar_wait(full0 + 8 * slot, (s / stages) & 1);
      const uint32_t stage = slot * kStageBytes;
      const uint32_t a = ring + stage + wg * 64 * kRowBytes, b = ring + stage + kQueryOff;
      uint32_t a_lo = 0, b_lo = 0;
      if constexpr (DT == kF32) {
        // lo buffers alternate by stage: a warpgroup writes buffer s & 1 only
        // after both passed the barrier of stage s - 1, so after both
        // finished stage s - 2's products, the last readers of that buffer
        const uint32_t lo = lo_off + (s & 1) * kStageBytes;
        a_lo = ring + lo + wg * 64 * kRowBytes;
        b_lo = ring + lo + kQueryOff;
        const uint32_t my_a = stage + wg * 64 * kRowBytes;
        split_rows(reinterpret_cast<float*>(smem + my_a),
                   reinterpret_cast<float*>(smem + lo + wg * 64 * kRowBytes), 64, t);
        const uint32_t my_q = kQueryOff + wg * (BN / 2) * kRowBytes;
        split_rows(reinterpret_cast<float*>(smem + stage + my_q),
                   reinterpret_cast<float*>(smem + lo + my_q), BN / 2, t);
        fence_proxy_async();
        named_barrier(1, kConsumers);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRowBytes / 32; ++kk) {
        const uint64_t da = make_desc(a + 32 * kk, 16, 1024, 1);
        const uint64_t db = make_desc(b + 32 * kk, 16, 1024, 1);
        wgmma_ss<BN, R::kKind>(acc, da, db);
        if constexpr (DT == kF32) {
          wgmma_ss<BN, R::kKind>(acc, da, make_desc(b_lo + 32 * kk, 16, 1024, 1));
          wgmma_ss<BN, R::kKind>(acc, make_desc(a_lo + 32 * kk, 16, 1024, 1), db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * slot);
      if constexpr (DT == kF32) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          total[i] += acc[i];
          acc[i] = 0.0f;
        }
      }
    }
    if constexpr (DT == kF32) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = total[i];
    }

    // epilogue: acc[4i + 2j + c] is bank row 16*(warp%4) + lane/4 + 8j of
    // this warpgroup's 64, query column 8i + 2*(lane%4) + c
    using Norm = typename R::Acc;
    const Norm* sqn = static_cast<const Norm*>(sqn_ptr);
    const int r0 = n0 + wg * 64 + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
    const Norm s0 = r0 < N ? sqn[r0] : Norm(0), s1 = r1 < N ? sqn[r1] : Norm(0);
    named_barrier(1, kConsumers);  // every product is done: the ring is free
    auto* red = reinterpret_cast<unsigned long long*>(smem);  // [8 warps][BN]
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        unsigned long long k = ~0ull;
        if (r0 < N) k = make_key(s0, acc[4 * i + c], r0);
        if (r1 < N) k = kmin(k, make_key(s1, acc[4 * i + 2 + c], r1));
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) k = kmin(k, __shfl_xor_sync(0xffffffffu, k, off));
        if (lane < 4) red[warp * BN + 8 * i + 2 * lane + c] = k;
      }
    }
    named_barrier(1, kConsumers);
    for (int col = threadIdx.x; col < BN; col += kConsumers) {
      unsigned long long k = red[col];
#pragma unroll
      for (int w = 1; w < kConsumers / 32; ++w) k = kmin(k, red[w * BN + col]);
      if (q0 + col < B && k != ~0ull) atomicMin(&keys[q0 + col], k);
    }
  }
}

__global__ void keys_to_index(const unsigned long long* __restrict__ keys,
                              int* __restrict__ out, int B) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < B) out[m] = static_cast<int>(keys[m] & 0xffffffffull);
}

template <int DT, int BN>
cudaError_t launch(const void* q, const void* bank, const void* sqn, int b, int n,
                   int d, unsigned long long* keys, int* out, cudaStream_t s) {
  using R = Regime<DT>;
  const CUtensorMapDataType type =
      DT == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : (DT == kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8);
  const cuuint64_t row_stride[1] = {static_cast<cuuint64_t>(d) * R::kElemBytes};
  const cuuint64_t bank_dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(n)};
  const cuuint64_t q_dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(b)};
  const cuuint32_t bank_box[2] = {R::kStageElems, kBankRows};
  const cuuint32_t q_box[2] = {R::kStageElems, BN};
  CUtensorMap bank_map, q_map;
  if (!encode_tiled(&bank_map, type, 2, bank, bank_dims, row_stride, bank_box,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_tiled(&q_map, type, 2, q, q_dims, row_stride, q_box,
                    CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;

  const int stage_bytes = (kBankRows + BN) * kRowBytes;
  const int lo_bytes = DT == kF32 ? 2 * stage_bytes : 0;
  int stages = (kMaxDynamicSmem - 1024 - lo_bytes - 16 * kMaxStages) / stage_bytes;
  stages = stages > kMaxStages ? kMaxStages : stages;
  if (stages < 2) return cudaErrorInvalidConfiguration;
  const int smem = 1024 + stages * stage_bytes + lo_bytes + 16 * stages;
  auto kernel = top1_kernel<DT, BN>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;

  const long long q_tiles = (b + BN - 1) / BN, n_tiles = (n + kBankRows - 1) / kBankRows;
  if (q_tiles * n_tiles > INT_MAX) return cudaErrorInvalidValue;
  const int k_stages = (d + R::kStageElems - 1) / R::kStageElems;
  err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * b, s);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(q_tiles * n_tiles), kThreads, smem, s>>>(
      bank_map, q_map, sqn, b, n, k_stages, static_cast<int>(q_tiles), stages, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys_to_index<<<(b + 255) / 256, 256, 0, s>>>(keys, out, b);
  return cudaGetLastError();
}

// The query tile: as few tiles of at most `widest` columns as cover B, each
// the smallest compiled width that holds its share.
int query_tile(int b, int widest) {
  constexpr int kWidths[] = {8, 64, 128, 208, 256};
  const int tiles = (b + widest - 1) / widest, need = (b + tiles - 1) / tiles;
  for (int w : kWidths) {
    if (need <= w) return w;
  }
  return widest;
}

template <int DT>
cudaError_t dispatch(const void* q, const void* bank, const void* sqn, int b, int n,
                     int d, unsigned long long* keys, int* out, cudaStream_t s) {
  if constexpr (DT == kF32) {  // two accumulators: at most 128 columns
    switch (query_tile(b, 128)) {
      case 8: return launch<DT, 8>(q, bank, sqn, b, n, d, keys, out, s);
      case 64: return launch<DT, 64>(q, bank, sqn, b, n, d, keys, out, s);
      default: return launch<DT, 128>(q, bank, sqn, b, n, d, keys, out, s);
    }
  } else {
    switch (query_tile(b, 256)) {
      case 8: return launch<DT, 8>(q, bank, sqn, b, n, d, keys, out, s);
      case 64: return launch<DT, 64>(q, bank, sqn, b, n, d, keys, out, s);
      case 128: return launch<DT, 128>(q, bank, sqn, b, n, d, keys, out, s);
      case 208: return launch<DT, 208>(q, bank, sqn, b, n, d, keys, out, s);
      default: return launch<DT, 256>(q, bank, sqn, b, n, d, keys, out, s);
    }
  }
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
    case kF32: return static_cast<int>(dispatch<kF32>(q, bank, sqn, b, n, d, k, o, s));
    case kBf16: return static_cast<int>(dispatch<kBf16>(q, bank, sqn, b, n, d, k, o, s));
    case kI8: return static_cast<int>(dispatch<kI8>(q, bank, sqn, b, n, d, k, o, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
