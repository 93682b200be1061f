// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, h_0 = 0, over axis 1
// of [B, S, R], for Hopper, in two routes chosen by the data.
//
// Replaces the TPU kernel src/repro/kernels/rglru/kernel.py
// (rglru_scan_kernel, body _kernel), which scans [BS, BL] tiles with a
// Hillis-Steele pass and carries h across sequence tiles in VMEM.
//
// Rounding, both routes.  One thread steps one (b, r) channel in sequence
// order, carrying h in an f32 register: h = __fadd_rn(__fmul_rn(a, h), b),
// two correctly rounded f32 operations, never contracted into one FMA,
// which is what the plain version (kernels/rglru/ref.py, one torch multiply
// and one add per step) computes.  So each route is bit-equal to it.  a and
// b are read as f32 or bf16 and h is stored in the input dtype.
//
// Bound.  Bytes: a and b read once, h written once, 3 x 268 MB = 805 MB at
// the RecurrentGemma-9B prefill shape (B 4, S 4096, R 4096, f32), 0.240 ms
// at the H100's 3.35 TB/s.  The recurrence is 2 flops per element.
//
// Simple route (rglru_scan; the first port of this kernel): 64 threads a block
// on neighbouring channels, each group of UNROLL = 16 steps issuing its 32
// loads before its first multiply.  It takes any contiguous input, and the
// wrapper sends it those TMA cannot read (a base not 16-byte aligned, or a
// row pitch R * itemsize not a multiple of 16 bytes).  On an H100 it runs
// at 40-44 % of the bound: the prefill gives it 256 blocks of 2 warps,
// about 4 warps an SM, and each warp loads, waits out one device-memory
// round trip, then computes and stores, with nothing in flight while it
// computes.  256 groups a channel at about 2 us each is the 0.54-0.61 ms
// it takes; 3.35 TB/s needs some 15-20 KB in flight on every SM all the
// time.
//
// Ring route (rglru_scan_ring).  A block owns C consecutive channels of one
// batch row (C = 128, 64 or 32, the largest whose grid B * ceil(R / C)
// reaches about one block an SM: 128 at the prefill, 32 at score's B = 1)
// and runs C consumer threads, one a channel, beside one producer warp.
//   - Loads: one producer thread streams boxes of Tc steps x C channels of a
//     and of b (3-D tensor maps over [B, S, R], box [1, Tc, C], so a box
//     never crosses a batch row) into a ring of STAGES = 4 stages of 32 KB,
//     each with a full and an empty mbarrier.  128 KB per SM is in flight
//     or waiting at all times, and the copies cost the consumers no
//     instruction.  Boxes the tensor's edge cuts are zero-filled and count
//     their full bytes.
//   - Steps: thread c reads row t of its column of the stage (neighbouring
//     threads on neighbouring words: no bank conflict) and steps h; the loop
//     is bounded by S, so zero-filled rows are never stepped on.  A warp
//     releases the stage once all its lanes have read it.
//   - Stores: each stage's h goes into one of two h tiles in shared memory
//     and is sent with one TMA store while the next tile is written (the
//     part of a box past S or R is not written).  Storing h straight from
//     the consumers' registers, a warp writing 128 contiguous bytes a step
//     in f32, was tried and measured slower at both the prefill and the
//     score shape (PERF.md), so it is not kept.
//   - The wrapper passes its plan (C, Tc, STAGES, shared memory, grid);
//     rglru_scan_ring_fwd launches only an instantiation that matches it
//     exactly and refuses any other.
//
// Reverse mode (the gradient; no TPU kernel: XLA differentiates the Pallas
// scan's plain version).  g_t = a_{t+1} g_{t+1} + dh_t from t = S - 1 down,
// with a_S = 0, then db_t = g_t and da_t = g_t h_{t-1} with h_{-1} = 0: each
// route steps it in reverse (rglru_scan_bwd, rglru_scan_ring_bwd) with the
// same two rounded operations as the plain backward
// (kernels/rglru/ref.py: rglru_scan_backward_ref), so it is bit-equal to it.
// Bound: a, h and dh read once, da and db written once, 5 x 67 MB = 335 MB
// at RecurrentGemma-9B's training shape ([1, 4096, 4096] f32), 0.100 ms.
// The ring's stage carries three boxes (a one step ahead, dh, h one step
// behind), so its Tc is STAGE_BYTES / 3 boxes, rounded down.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

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

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// ---------------------------------------------------------------------------
// simple route
// ---------------------------------------------------------------------------

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

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
      hh = step(av[u], hh, bv[u]);
      hp[static_cast<long long>(t + u) * r] = from_f32<T>(hh);
    }
  }
  for (; t < s; ++t) {
    const long long off = static_cast<long long>(t) * r;
    hh = step(to_f32(ap[off]), hh, to_f32(bp[off]));
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

// Reverse mode (rglru_scan_bwd): thread ch steps g_t = a_{t+1} g_{t+1} +
// dh_t from t = S - 1 down, with a_S = 0 and h_{-1} = 0, writing db = g and
// da_t = g_t h_{t-1} (g rounded to the dtype first, as the plain backward).
template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd(const T* __restrict__ a, const T* __restrict__ h,
               const T* __restrict__ dh, T* __restrict__ da,
               T* __restrict__ db, int s, int r) {
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  if (ch >= r) return;
  const long long base = static_cast<long long>(blockIdx.y) * s * r + ch;
  const T* ap = a + base;
  const T* hp = h + base;
  const T* gp = dh + base;
  T* dap = da + base;
  T* dbp = db + base;
  float g = 0.f;
  int t = s - 1;
  for (; t + 1 >= UNROLL; t -= UNROLL) {
    float an[UNROLL], dv[UNROLL], hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = static_cast<long long>(t - u) * r;
      an[u] = t - u + 1 < s ? to_f32(ap[off + r]) : 0.f;
      dv[u] = to_f32(gp[off]);
      hv[u] = t - u > 0 ? to_f32(hp[off - r]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long off = static_cast<long long>(t - u) * r;
      g = step(an[u], g, dv[u]);
      const T gt = from_f32<T>(g);
      dbp[off] = gt;
      dap[off] = from_f32<T>(__fmul_rn(to_f32(gt), hv[u]));
    }
  }
  for (; t >= 0; --t) {
    const long long off = static_cast<long long>(t) * r;
    g = step(t + 1 < s ? to_f32(ap[off + r]) : 0.f, g, to_f32(gp[off]));
    const T gt = from_f32<T>(g);
    dbp[off] = gt;
    dap[off] = from_f32<T>(
        __fmul_rn(to_f32(gt), t > 0 ? to_f32(hp[off - r]) : 0.f));
  }
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* h, const void* dh,
                       void* da, void* db, int batch, int s, int r,
                       cudaStream_t stream) {
  const dim3 grid((r + THREADS - 1) / THREADS, batch);
  rglru_scan_bwd<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(db), s,
      r);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ring route
// ---------------------------------------------------------------------------

using namespace hopper;

// The plan disagrees with every instantiation, or with the shared memory
// or grid of the one it names.
constexpr int ERR_PLAN = 10002;
constexpr int SMEM_ALIGN = 128;   // TMA boxes start on 128-byte boundaries
constexpr int H_TILES = 2;        // one written while the other is sent

template <typename T, int C, int TC, int STAGES>
struct Ring {
  static constexpr int NTHREADS = C + 32;     // consumers and the producer
  static constexpr int BOX = TC * C;          // elements of one box
  static constexpr int BOX_BYTES = BOX * static_cast<int>(sizeof(T));
  static constexpr int STAGE_BYTES = 2 * BOX_BYTES;   // a and b
  static constexpr int SMEM =
      SMEM_ALIGN + STAGES * STAGE_BYTES + H_TILES * BOX_BYTES;
  static_assert(C % 32 == 0 && C * sizeof(T) % 16 == 0 && C <= 256
                    && TC <= 256, "TMA box limits");
  static_assert(SMEM <= 232448, "shared memory a block may take");
};

template <typename T, int C, int TC, int STAGES>
__global__ void __launch_bounds__(C + 32, 1)
rglru_scan_ring(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap th, int s) {
  using G = Ring<T, C, TC, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1)
      & ~uintptr_t(SMEM_ALIGN - 1));
  T* s_h = reinterpret_cast<T*>(base + STAGES * G::STAGE_BYTES);

  const int c0 = blockIdx.x * C;
  const int row = blockIdx.y;
  const int n_tiles = (s + TC - 1) / TC;

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], C / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= C) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == C) {
      for (int k = 0; k < n_tiles; ++k) {
        const int st = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty[st], (k / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], G::STAGE_BYTES);
        uint8_t* dst = base + st * G::STAGE_BYTES;
        tma_load_3d(dst, &ta, &full[st], c0, k * TC, row);
        tma_load_3d(dst + G::BOX_BYTES, &tb, &full[st], c0, k * TC, row);
      }
    }
    return;
  }

  // ---- consumers: thread c steps channel c0 + c ----
  const int c = threadIdx.x;
  float hh = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % STAGES;
    mbar_wait(&full[st], (k / STAGES) & 1);
    const T* sa = reinterpret_cast<const T*>(base + st * G::STAGE_BYTES) + c;
    const T* sb = sa + G::BOX;
    const int t0 = k * TC;
    const int n = min(TC, s - t0);
    T* sh = s_h + (k % H_TILES) * G::BOX + c;
    if (n == TC) {
#pragma unroll 8
      for (int t = 0; t < TC; ++t) {
        hh = step(to_f32(sa[t * C]), hh, to_f32(sb[t * C]));
        sh[t * C] = from_f32<T>(hh);
      }
    } else {
      for (int t = 0; t < n; ++t) {
        hh = step(to_f32(sa[t * C]), hh, to_f32(sb[t * C]));
        sh[t * C] = from_f32<T>(hh);
      }
    }
    __syncwarp();
    if (c % 32 == 0) mbar_arrive(&empty[st]);
    // the tile is sent after every consumer wrote it; the tile the next
    // stage writes (sent one stage ago) must have been read by then
    async_proxy_fence();
    if (c == 0) bulk_wait_read();
    asm volatile("bar.sync 1, %0;\n" :: "n"(C) : "memory");
    if (c == 0)
      tma_store_3d(&th, s_h + (k % H_TILES) * G::BOX, c0, t0, row);
  }
  if (c == 0) bulk_wait_all();
}

// Reverse mode of the ring (rglru_scan_ring_bwd): a stage carries three
// boxes of TC steps, a at rows k TC + 1 .., dh at k TC .. and h at
// k TC - 1 .., and the producer issues them from the last sequence tile down
// to the first; rows past S or below 0 are zero-filled by the TMA unit, which
// gives a_S = 0 and h_{-1} = 0.  Thread c steps g down through its column of
// the stage and writes db = g and da = g h_{t-1} into two tiles, sent by TMA
// stores, double-buffered as the forward's h tile.
template <typename T, int C, int TC, int STAGES>
struct RingBwd {
  static constexpr int NTHREADS = C + 32;
  static constexpr int BOX = TC * C;
  static constexpr int BOX_BYTES = BOX * static_cast<int>(sizeof(T));
  static constexpr int STAGE_BYTES = 3 * BOX_BYTES;   // a, dh, h
  static constexpr int SMEM =
      SMEM_ALIGN + STAGES * STAGE_BYTES + H_TILES * 2 * BOX_BYTES;
  static_assert(C % 32 == 0 && C * sizeof(T) % 16 == 0 && C <= 256
                    && TC <= 256 && BOX_BYTES % SMEM_ALIGN == 0,
                "TMA box limits");
  static_assert(SMEM <= 232448, "shared memory a block may take");
};

template <typename T, int C, int TC, int STAGES>
__global__ void __launch_bounds__(C + 32, 1)
rglru_scan_ring_bwd(const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap th,
                    const __grid_constant__ CUtensorMap tg,
                    const __grid_constant__ CUtensorMap tda,
                    const __grid_constant__ CUtensorMap tdb, int s) {
  using G = RingBwd<T, C, TC, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1)
      & ~uintptr_t(SMEM_ALIGN - 1));
  // output tiles: (da, db) of buffer 0, then of buffer 1
  T* s_out = reinterpret_cast<T*>(base + STAGES * G::STAGE_BYTES);

  const int c0 = blockIdx.x * C;
  const int row = blockIdx.y;
  const int n_tiles = (s + TC - 1) / TC;

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], C / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= C) {
    // ---- producer: tiles from the last to the first ----
    if (threadIdx.x == C) {
      for (int j = 0; j < n_tiles; ++j) {
        const int k = n_tiles - 1 - j;
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[st], (j / STAGES - 1) & 1);
        mbar_expect_tx(&full[st], G::STAGE_BYTES);
        uint8_t* dst = base + st * G::STAGE_BYTES;
        tma_load_3d(dst, &ta, &full[st], c0, k * TC + 1, row);
        tma_load_3d(dst + G::BOX_BYTES, &tg, &full[st], c0, k * TC, row);
        tma_load_3d(dst + 2 * G::BOX_BYTES, &th, &full[st], c0, k * TC - 1,
                    row);
      }
    }
    return;
  }

  // ---- consumers: thread c steps channel c0 + c backwards ----
  const int c = threadIdx.x;
  float g = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int k = n_tiles - 1 - j;
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const T* sa = reinterpret_cast<const T*>(base + st * G::STAGE_BYTES) + c;
    const T* sg = sa + G::BOX;
    const T* sh = sa + 2 * G::BOX;
    const int t0 = k * TC;
    const int n = min(TC, s - t0);
    T* oa = s_out + (j % H_TILES) * 2 * G::BOX + c;
    T* ob = oa + G::BOX;
    // UNROLL steps at a time: their loads first, into registers (the
    // compiler cannot move a load of the stage above a store to the
    // output tiles on its own), then the chain
    int t = n - 1;
    for (; t + 1 >= UNROLL; t -= UNROLL) {
      float av[UNROLL], gv[UNROLL], hv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        av[u] = to_f32(sa[(t - u) * C]);
        gv[u] = to_f32(sg[(t - u) * C]);
        hv[u] = to_f32(sh[(t - u) * C]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        g = step(av[u], g, gv[u]);
        const T gt = from_f32<T>(g);
        ob[(t - u) * C] = gt;
        oa[(t - u) * C] = from_f32<T>(__fmul_rn(to_f32(gt), hv[u]));
      }
    }
    for (; t >= 0; --t) {
      g = step(to_f32(sa[t * C]), g, to_f32(sg[t * C]));
      const T gt = from_f32<T>(g);
      ob[t * C] = gt;
      oa[t * C] = from_f32<T>(__fmul_rn(to_f32(gt), to_f32(sh[t * C])));
    }
    __syncwarp();
    if (c % 32 == 0) mbar_arrive(&empty[st]);
    // the tiles are sent after every consumer wrote them; the pair the next
    // stage writes (sent one stage ago) must have been read by then
    async_proxy_fence();
    if (c == 0) bulk_wait_read();
    asm volatile("bar.sync 1, %0;\n" :: "n"(C) : "memory");
    if (c == 0) {
      tma_store_3d(&tda, s_out + (j % H_TILES) * 2 * G::BOX, c0, t0, row);
      tma_store_3d(&tdb, s_out + (j % H_TILES) * 2 * G::BOX + G::BOX, c0, t0,
                   row);
    }
  }
  if (c == 0) bulk_wait_all();
}

// A 3-D map over (R, S, B) of a contiguous [B, S, R] tensor, box
// [1, TC, C] (no swizzle: a consumer reads its own column).
template <typename T>
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                  int batch, int s, int r, int c, int tc) {
  const cuuint64_t dims[3] = {cuuint64_t(r), cuuint64_t(s),
                              cuuint64_t(batch)};
  const cuuint64_t strides[2] = {cuuint64_t(r) * sizeof(T),
                                 cuuint64_t(s) * cuuint64_t(r) * sizeof(T)};
  const cuuint32_t box[3] = {cuuint32_t(c), cuuint32_t(tc), 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  return encode_map(encode, map,
                    sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    3, const_cast<void*>(ptr), dims, strides, box, estride,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename T, int C, int TC, int STAGES>
int launch_ring(const void* a, const void* b, void* h, int batch, int s,
                int r, int smem, int grid_x, int grid_y,
                cudaStream_t stream) {
  using G = Ring<T, C, TC, STAGES>;
  if (smem != G::SMEM || grid_x != (r + C - 1) / C || grid_y != batch)
    return ERR_PLAN;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap ta, tb, th;
  if (make_map<T>(&ta, encode, a, batch, s, r, C, TC) != CUDA_SUCCESS
      || make_map<T>(&tb, encode, b, batch, s, r, C, TC) != CUDA_SUCCESS
      || make_map<T>(&th, encode, h, batch, s, r, C, TC) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_ring<T, C, TC, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  rglru_scan_ring<T, C, TC, STAGES>
      <<<dim3(grid_x, grid_y), G::NTHREADS, G::SMEM, stream>>>(
          ta, tb, th, s);
  return cudaGetLastError();
}

template <typename T, int C, int TC, int STAGES>
int launch_ring_bwd(const void* a, const void* h, const void* dh, void* da,
                    void* db, int batch, int s, int r, int smem, int grid_x,
                    int grid_y, cudaStream_t stream) {
  using G = RingBwd<T, C, TC, STAGES>;
  if (smem != G::SMEM || grid_x != (r + C - 1) / C || grid_y != batch)
    return ERR_PLAN;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap ta, th, tg, tda, tdb;
  if (make_map<T>(&ta, encode, a, batch, s, r, C, TC) != CUDA_SUCCESS
      || make_map<T>(&th, encode, h, batch, s, r, C, TC) != CUDA_SUCCESS
      || make_map<T>(&tg, encode, dh, batch, s, r, C, TC) != CUDA_SUCCESS
      || make_map<T>(&tda, encode, da, batch, s, r, C, TC) != CUDA_SUCCESS
      || make_map<T>(&tdb, encode, db, batch, s, r, C, TC) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_ring_bwd<T, C, TC, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  rglru_scan_ring_bwd<T, C, TC, STAGES>
      <<<dim3(grid_x, grid_y), G::NTHREADS, G::SMEM, stream>>>(
          ta, th, tg, tda, tdb, s);
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

// The ring route on the plan (channels, steps, stages, smem, grid_x,
// grid_y) of kernels/rglru/plan.py; ERR_PLAN where no instantiation
// matches it.  a, b and h need 16-byte aligned bases and r * itemsize a
// multiple of 16 (else the tensor map is refused).
int rglru_scan_ring_fwd(const void* a, const void* b, void* h, int dtype,
                        int batch, int s, int r, int channels, int steps,
                        int stages, int smem, int grid_x, int grid_y,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages != 4) return ERR_PLAN;
#define RGLRU_RING(T, DT, C, TC)                                            \
  if (dtype == DT && channels == C && steps == TC)                          \
    return launch_ring<T, C, TC, 4>(a, b, h, batch, s, r, smem, grid_x,     \
                                    grid_y, st);
  RGLRU_RING(float, 0, 128, 32)
  RGLRU_RING(float, 0, 64, 64)
  RGLRU_RING(float, 0, 32, 128)
  RGLRU_RING(__nv_bfloat16, 1, 128, 64)
  RGLRU_RING(__nv_bfloat16, 1, 64, 128)
  RGLRU_RING(__nv_bfloat16, 1, 32, 256)
#undef RGLRU_RING
  return ERR_PLAN;
}

// Reverse mode: (da, db) of h = scan(a, b) for the output gradient dh; a,
// h, dh, da, db contiguous [batch, s, r] of one dtype.  The simple route.
int rglru_scan_bwd(const void* a, const void* h, const void* dh, void* da,
                   void* db, int dtype, int batch, int s, int r,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(a, h, dh, da, db, batch, s, r, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(a, h, dh, da, db, batch, s, r, st);
  return cudaErrorInvalidValue;
}

// The reverse ring on the plan of kernels/rglru/plan.py's ring_bwd_plan;
// ERR_PLAN where no instantiation matches it.  Every pointer 16-byte
// aligned and r * itemsize a multiple of 16.
int rglru_scan_ring_bwd_launch(const void* a, const void* h, const void* dh,
                               void* da, void* db, int dtype, int batch,
                               int s, int r, int channels, int steps,
                               int stages, int smem, int grid_x, int grid_y,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages != 4) return ERR_PLAN;
#define RGLRU_RING_BWD(T, DT, C, TC)                                        \
  if (dtype == DT && channels == C && steps == TC)                          \
    return launch_ring_bwd<T, C, TC, 4>(a, h, dh, da, db, batch, s, r,      \
                                        smem, grid_x, grid_y, st);
  RGLRU_RING_BWD(float, 0, 128, 21)
  RGLRU_RING_BWD(float, 0, 64, 42)
  RGLRU_RING_BWD(float, 0, 32, 85)
  RGLRU_RING_BWD(__nv_bfloat16, 1, 128, 42)
  RGLRU_RING_BWD(__nv_bfloat16, 1, 64, 85)
  RGLRU_RING_BWD(__nv_bfloat16, 1, 32, 170)
#undef RGLRU_RING_BWD
  return ERR_PLAN;
}

const char* rglru_scan_error_string(int code) {
  if (code == ERR_PLAN)
    return "the plan matches no instantiation of the ring kernel";
  return hopper::error_string(code);
}

}  // extern "C"
