// Hopper helpers shared by the port's kernels: mbarrier PTX, TMA copies
// between device and shared memory, and the driver's tensor-map encoder.
// Included by flash_attention.cu and rglru_scan.cu; the build hashes every
// *.cuh of this directory beside the source, so an edit here rebuilds both.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

// Error codes past the CUDA runtime's: no encoder, or a refused tensor map.
constexpr int ERR_NO_ENCODER = 10000;
constexpr int ERR_TENSOR_MAP = 10001;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  No wait
// of these kernels lasts longer than a tile's copy or compute; one that
// spins 2^26 times is a fault, and traps rather than hangs the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

// Make the barriers' initialisation visible to the TMA unit.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A box of a 3-D tensor map into shared memory; completion adds its bytes
// to the barrier's transaction count.  Elements outside the tensor are
// zero-filled and still count.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device into shared memory, completing on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A box of shared memory into a 3-D tensor map, as one bulk group of the
// issuing thread; the part of the box outside the tensor is not written.
// The threads that wrote the box call async_proxy_fence() first.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void async_proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until every bulk group of this thread has read its shared memory
// (the buffers may be written again), or has completed (before exit).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime: its entry
// point is fetched at run time, so the library needs no -lcuda.  It also
// needs a current context, which a thread that has made no runtime call yet
// lacks (autograd runs a backward on a thread of its own, and refuses a map
// there with CUDA_ERROR_INVALID_CONTEXT): cudaSetDevice makes the device's
// primary context current first.
inline EncodeTiled encode_tiled() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// What libcuda was last asked for when it refused a tensor map.
inline char* refused_map() {
  static char text[320] = "";
  return text;
}

// encode(...), noting the request in refused_map() when it is refused.
inline CUresult encode_map(EncodeTiled encode, CUtensorMap* map,
                           CUtensorMapDataType type, cuuint32_t rank,
                           void* ptr, const cuuint64_t* dims,
                           const cuuint64_t* strides, const cuuint32_t* box,
                           const cuuint32_t* estride,
                           CUtensorMapSwizzle swizzle) {
  const CUresult r = encode(map, type, rank, ptr, dims, strides, box, estride,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS)
    snprintf(refused_map(), 320,
             "CUresult %d; rank %u, base %p, map at %p, dims %llu %llu %llu, "
             "byte strides %llu %llu, box %u %u %u",
             static_cast<int>(r), rank, ptr, static_cast<void*>(map),
             static_cast<unsigned long long>(dims[0]),
             static_cast<unsigned long long>(dims[1]),
             static_cast<unsigned long long>(dims[2]),
             static_cast<unsigned long long>(strides[0]),
             static_cast<unsigned long long>(strides[1]), box[0], box[1],
             box[2]);
  return r;
}

// The error string of a code the runtime does not know.
inline const char* error_string(int code) {
  if (code == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found in libcuda";
  if (code == ERR_TENSOR_MAP) {
    static char text[400];
    snprintf(text, sizeof(text),
             "cuTensorMapEncodeTiled refused a tensor map (alignment or "
             "strides): %s", refused_map());
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace hopper
