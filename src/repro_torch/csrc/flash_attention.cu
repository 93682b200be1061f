// Causal / sliding-window GQA flash attention (forward) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd, body _kernel): o = softmax(q k^T / sqrt(D) + mask) v
// with q [B, H, Sq, D], k and v [B, KVH, Sk, D], query head h reading kv
// head h / (H / KVH), positions q_offset + i for queries and j for keys, the
// mask q_pos >= k_pos (causal) and q_pos - k_pos < window (window > 0).
//
// Layout.  One block per (query tile of BQ rows, head, batch).  The TPU's
// sequential kv grid axis becomes a loop inside the block over kv tiles of
// BK keys; the online-softmax state (running max m, denominator l and the
// [BQ, D] accumulator) stays on chip for the whole loop and the output tile
// is written once.  K and V are read from their own kv head, never
// replicated.  Every operand is addressed through (batch, head, sequence)
// strides with a unit stride over D, so the model's grouped [B, S, kvH, G, D]
// layout is read in place.  Ragged edges (Sq, Sk not multiples of the tiles)
// are masked here: rows past Sq are computed on zeros and not stored, keys
// past Sk get probability 0.
//
// Arithmetic.  bf16 or f32 in, f32 everywhere inside (the TPU kernel upcasts
// its tiles too), q.dtype out.  Warp w owns rows w, w + 8, ... of the query
// tile and lane j owns key j of the kv tile, so a row's max and sum are warp
// shuffles; in the P.V product lane j owns columns j, j + 32, ... of the
// accumulator and takes row i's probabilities from the other lanes by
// shuffle.  Masked scores are NEG_INF = -1e30 (finite, as on the TPU): a row
// whose first visited tiles are wholly masked builds up garbage in l and acc
// (exp(NEG_INF - NEG_INF) = 1), and its first valid key resets both, since
// alpha = exp(NEG_INF - m) = 0.  A -INFINITY sentinel would give NaN there.
//
// Tile skipping.  Tiles wholly above the causal diagonal are skipped, as on
// the TPU.  By the same argument, so are tiles wholly left of the window when
// every row of the query tile has at least one valid key: such a tile only
// adds garbage that the first valid key resets, or exact zeros after it.
// When some row has no valid key at all (q_pos - window + 1 > Sk - 1) the
// reference averages v uniformly over all Sk keys, so the block then visits
// every tile.  At S = 4096 and window 2048, with 64 x 32 tiles, the two
// skips leave 3168 of the 8192 kv tiles of a (batch, head); the diagonal
// alone would leave 4160.
//
// Bound.  At the RecurrentGemma-9B prefill shape (B 4, H 16, KVH 1, S 4096,
// D 256, window 2048) the valid (q, k) pairs need 4.1e11 flops against 0.29
// GB of traffic, so the card's bf16 tensor-core rate bounds it (0.42 ms).
// This first kernel uses f32 CUDA cores (67 TFLOP/s peak, about 6 ms for the
// same flops); wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per kv tile (one per lane)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;   // query rows per warp
constexpr unsigned FULL = 0xffffffffu;

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

// Q and K tiles are stored with a row stride of D + PAD floats: float4
// aligned, and the eight lanes of a quarter-warp reading eight K rows at the
// same column hit disjoint banks.
constexpr int PAD = 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + PAD) + size_t(BK) * (D + PAD)
                          + size_t(BK) * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int sq,
          int sk, int causal, int window, int q_offset, float scale,
          long long qsb, long long qsh, long long qss, long long ksb,
          long long ksh, long long kss, long long vsb, long long vsh,
          long long vss, long long osb, long long osh, long long oss) {
  constexpr int DP = D + PAD;
  constexpr int NC = (D + 31) / 32;  // accumulator columns per lane
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_k = s_q + BQ * DP;
  float* s_v = s_k + BK * DP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / group) * ksh;
  const T* vb = v + b * vsb + (h / group) * vsh;
  T* ob = o + b * osb + h * osh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < sq) x = to_f32(qb[(q0 + r) * qss + d]) * scale;
    s_q[r * DP + d] = x;
  }

  float m_run[RPW], l_run[RPW], acc[RPW][NC];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // kv tiles this query tile needs
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(sk, q_hi + 1) : sk;
  int k_begin = 0;
  if (window > 0 && q_hi - window + 1 <= sk - 1)
    k_begin = max(0, q_lo - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V (and, first, Q) are settled
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int j = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < sk) {
        kx = to_f32(kb[(k0 + j) * kss + d]);
        vx = to_f32(vb[(k0 + j) * vss + d]);
      }
      s_k[j * DP + d] = kx;
      s_v[j * D + d] = vx;
    }
    __syncthreads();

    // scores of rows warp + NWARPS * i against key `lane`
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(s_k + lane * DP);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(
            s_q + (warp + NWARPS * i) * DP)[d4];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // mask, online softmax update; p[i] is row i's probability of key lane
    const int k_pos = k0 + lane;
    const bool in_range = k_pos < sk;
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int q_pos = q_lo + warp + NWARPS * i;
      bool ok = in_range;
      if (causal) ok = ok && q_pos >= k_pos;
      if (window > 0) ok = ok && q_pos - k_pos < window;
      const float x = ok ? s[i] : NEG_INF;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      p[i] = in_range ? expf(x - m_new) : 0.f;
      float ps = p[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(FULL, ps, off);
      l_run[i] = l_run[i] * alpha + ps;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        vj[c] = (D % 32 == 0 || col < D) ? s_v[j * D + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pij = __shfl_sync(FULL, p[i], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pij, vj[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = q0 + warp + NWARPS * i;
    if (r >= sq) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D) ob[r * oss + col] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int h, int group, int sq, int sk, int causal,
                   int window, int q_offset, float scale, const long long* st,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_fwd<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, sk, causal,
      window, q_offset, scale, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       void* o, int b, int h, int group, int sq, int sk,
                       int causal, int window, int q_offset, float scale,
                       const long long* st, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, h, group, sq, sk, causal, window, q_offset, scale, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, h, group, sq, sk, causal, window, q_offset, scale, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, h, group, sq, sk, causal, window, q_offset, scale, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, h, group, sq, sk, causal, window, q_offset, scale, st, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, h, group, sq, sk, causal, window, q_offset, scale, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  strides: 12
// element strides, (batch, head, sequence) of q, k, v and o in turn; the
// head-dim stride is 1.  window <= 0 means none.  Returns the CUDA error of
// the launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int b, int h, int kvh, int sq, int sk,
                        int d, int causal, int window, int q_offset,
                        float scale, const long long* strides,
                        void* stream) {
  if (kvh <= 0 || h % kvh != 0) return cudaErrorInvalidValue;
  const int group = h / kvh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, b, h, group, sq, sk, causal,
                             window, q_offset, scale, strides, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, h, group, sq, sk,
                                     causal, window, q_offset, scale, strides,
                                     s);
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
