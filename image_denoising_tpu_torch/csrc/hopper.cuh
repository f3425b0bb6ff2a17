// Hopper building blocks shared by the port's kernels, as inline PTX:
// mbarriers, TMA and bulk copies, wgmma descriptors and fences, register
// rebalancing, the 3xTF32 split, and the host-side tensor-map encoder.
//
// The encoder is fetched from the driver at run time
// (cudaGetDriverEntryPoint), so a library that includes this header links
// against the CUDA runtime only, not against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace idt {

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA tile loads: coordinates innermost first, in elements; the box lands
// in shared memory at `dst` and completes `bytes` on `bar`. Elements
// outside the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the accumulators in place across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Matrix descriptor: start address, leading (K-direction) and stride
// (M/N-direction) byte offsets, layout 0 = no swizzle, 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// 3xTF32: x = hi + lo exactly, hi rounded to TF32 (10 mantissa bits); the
// tensor cores read lo's top 19 bits. hi*hi + hi*lo + lo*hi leaves out
// lo*lo (about 2^-22 of |x y|) and lo's truncation (about 2^-21).
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  hi = __uint_as_float(h);
  lo = x - hi;
}

// ---------------------------------------------------------------- host

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// Dynamic shared memory one block may take on an H100 (227 KB).
constexpr int kMaxDynamicSmem = 232448;

// Let `kernel` take `bytes` of dynamic shared memory on the current device;
// the attribute is set once per kernel and device (at the largest size), not
// at every launch.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  struct Entry { const void* kernel; int device; };
  static Entry done[256];
  static int n_done = 0;
  static std::mutex mu;
  if (bytes > kMaxDynamicSmem) return cudaErrorInvalidConfiguration;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_done; ++i)
    if (done[i].kernel == kernel && done[i].device == device) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxDynamicSmem);
  if (err == cudaSuccess && n_done < 256) done[n_done++] = Entry{kernel, device};
  return err;
}

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess)
      p = nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// A tiled tensor map of `rank` dimensions (sizes and box innermost first;
// strides in bytes of dimensions 1..rank-1). Returns false on failure.
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type, int rank,
                         const void* base, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box,
                         CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  return fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims,
            strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace idt
