// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, h_0 = 0, over axis 1
// of [B, S, R], for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py
// (rglru_scan_kernel, body _kernel), which scans [BS, BL] tiles with a
// Hillis-Steele pass and carries h across sequence tiles in VMEM.
//
// Layout.  One thread per (b, r) channel, neighbouring threads on
// neighbouring r, so every load and store of a warp is one contiguous run.
// Each thread walks the sequence in order, carrying h in a register.  The
// loads of a and b do not depend on h, so each group of UNROLL steps issues
// all its loads before the first multiply: the dependent chain is the
// multiply-add alone.
//
// Rounding.  h = __fadd_rn(__fmul_rn(a, h), b): two correctly rounded f32
// operations, never contracted into one FMA, which is what the plain version
// (kernels/rglru/ref.py, one torch multiply and one add per step) computes.
// So the kernel is bit-equal to it.  a and b are read as f32 or bf16 and h is
// stored in the input dtype, the carry staying f32.
//
// Bound.  Bytes: a and b read once, h written once, 3 x 268 MB at the
// RecurrentGemma-9B prefill shape (B 4, S 4096, R 4096, f32), 0.24 ms at the
// H100's 3.35 TB/s.  The recurrence is 2 flops per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan(const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ h, int s, int r) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= r) return;
  const long long base = static_cast<long long>(blockIdx.y) * s * r + ch;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float hh = 0.f;
  int t = 0;
  for (; t + UNROLL <= s; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = static_cast<long long>(t + u) * r;
      av[u] = to_f32(ap[off]);
      bv[u] = to_f32(bp[off]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      hh = __fadd_rn(__fmul_rn(av[u], hh), bv[u]);
      hp[static_cast<long long>(t + u) * r] = from_f32<T>(hh);
    }
  }
  for (; t < s; ++t) {
    const long long off = static_cast<long long>(t) * r;
    hh = __fadd_rn(__fmul_rn(to_f32(ap[off]), hh), to_f32(bp[off]));
    hp[off] = from_f32<T>(hh);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* h, int batch, int s,
                   int r, cudaStream_t stream) {
  const dim3 grid((r + THREADS - 1) / THREADS, batch);
  rglru_scan<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      s, r);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, h: contiguous [batch, s, r] of one dtype, 0 = float32, 1 = bfloat16.
// Returns the CUDA error of the launch (0 on success).
int rglru_scan_fwd(const void* a, const void* b, void* h, int dtype,
                   int batch, int s, int r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h, batch, s, r, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h, batch, s, r, st);
  return cudaErrorInvalidValue;
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
