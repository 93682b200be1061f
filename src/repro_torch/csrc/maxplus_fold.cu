// (max,+) matrix folds for NVIDIA Hopper (sm_90a): one kernel per design
// point (K1/K2) and one per trace of a fleet (K3), sharing one step.
//
// maxplus_fold_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/maxplus/kernel.py::maxplus_fold_kernel
// in both of its branches: the trace-indexed bodies (_kernel_indexed,
// _kernel_indexed_energy via _arrival_step) and the periodic bodies
// (_kernel_periodic, _kernel_periodic_energy).  For every design point b
// it folds T ops, with i = idx[t] (trace-indexed) or i = t mod M
// (periodic):
//
//   s[r]   <- max_c (A[b, i, r, c] + s[c])          the (max,+) matvec
//   s[r]   <- max(s[r], g[b, i, r] + arr[t])        arrival max-in   (optional)
//   s[r]   <- s[r] + w[b, i, r] * ext[t]            fault surcharge  (optional)
//   acc[p] <- acc[p] + E[b, i, p]                   phase energies   (optional)
//
// maxplus_fold_many_kernel replaces the Pallas TPU megakernel
//   src/repro/kernels/maxplus/kernel.py::maxplus_fold_many_kernel
// (body _kernel_fused).  Each lane is a whole trace: lane l folds its own
// lengths[l] ops i = idx[l, t] against ONE shared union dictionary
// [M1, N, N] (no per-lane stride), with its own arrivals/extras at
// l * T + t and the optional g/w rows of the shared [M1, N] tables.  The
// TPU kernel pads short lanes with the identity op M1 - 1 and selects
// rows with a one-hot dot_general because vector gathers do not lower
// there; here each lane simply stops at its own length (exact: the
// identity op is a bitwise no-op) and reads its matrix by index.
//
// What bounds them on this card.  The work is 2*N^2 float32 max/add
// operations a step: for K1 2*T*B*N^2 (at the real-size sweep, T = 65536,
// B = 64, N = 146: 1.8e11, 2.7 ms at the 67 TFLOP/s float32 peak, against
// 2.8 GB of dictionary, 0.8 ms at 3.35 TB/s), for K3 2*N^2*sum(lengths)
// against one shared dictionary (the 8x16 fleet: 513 matrices, 43.7 MB,
// about the H100's 50 MB L2).  Operations bound both.  Both kernels are
// far from that bound, because each step depends on the previous state:
// per step a block reads one N x N matrix (85 KB at N = 146) and waits for
// it before the next step can start, so a lane's time is its length times
// one memory round trip plus a block barrier.  K3's fleet runs in waves
// of one block per SM; its critical path is the longest lane.
//
// Design (simple and right first).  One block per design point (K1) or
// per lane (K3) loops over t; the state is double-buffered in shared
// memory (2*N floats), so one __syncthreads per step suffices.  Each warp
// takes rows r = warp + 32*j; its lanes read A[i, r, c] contiguously over
// c (coalesced), add s[c] and reduce by shuffle max.  All of a thread's
// matrix loads for a step are issued together into registers (N <= kMaxN
// fixes their count), so a step costs about one memory latency.  Not done
// yet: prefetching step t+1's matrix during step t.
//
// Exactness.  Each A + s is one correctly rounded float32 add and max does
// not depend on order, so any reduction order reproduces the JAX kernels
// bit for bit.  The shift is __fadd_rn(s, __fmul_rn(w, ext)): no FMA
// contraction can enter, and with w in {0, 1} the product is exact
// either way.  Energies add in t order, as the TPU kernel's fori_loop
// does.  The NEG sentinel of the dictionaries is -1e30f, never -inf;
// -FLT_MAX only seeds the reduction and is below every real candidate.

#include <cfloat>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 32;                                  // 1024 threads
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 160;                  // 8 channels x 16 ways: N = 146
constexpr int kRowsPerWarp = (kMaxN + kWarps - 1) / kWarps;  // 5
constexpr int kColsPerLane = (kMaxN + 31) / 32;              // 5

// The per-row side operations of a step, in the TPU kernels' order:
// the arrival max-in, then the fault shift on the written rows.
__device__ __forceinline__ float arrival_max_in(float v, float g, float arr) {
  return fmaxf(v, __fadd_rn(g, arr));
}

__device__ __forceinline__ float fault_shift(float v, float w, float ext) {
  return __fadd_rn(v, __fmul_rn(w, ext));
}

// One fold step for the whole block: nxt[r] = side(r, max_c(a[r, c] +
// cur[c])).  Shared by K1/K2 and K3, so the two cannot drift apart.
// `side` applies a kernel's optional arrival max-in / fault shift; it
// runs in lane 0 after the reduction, so its operands are loaded only
// then and hold no registers while the matrix loads are in flight (the
// block runs at the 64-register cap of 1024 threads).  `overlap` runs
// once the matrix loads are issued, so work such as K1's energy sum
// waits on memory together with them.  The caller synchronises and
// swaps the buffers.
template <typename Overlap, typename Side>
__device__ __forceinline__ void fold_step(const float* __restrict__ a,
                                          const float* cur, float* nxt,
                                          int n, Overlap overlap, Side side) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // issue every matrix load of this thread before using any of them
  float x[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + j * kWarps;
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int c = lane + 32 * q;
      x[j][q] = (r < n && c < n) ? __ldg(a + static_cast<size_t>(r) * n + c)
                                 : 0.0f;
    }
  }
  float sc[kColsPerLane];
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int c = lane + 32 * q;
    sc[q] = c < n ? cur[c] : 0.0f;
  }
  overlap();
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp + j * kWarps;
    if (r < n) {                                        // warp-uniform
      float v = -FLT_MAX;
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        if (lane + 32 * q < n) v = fmaxf(v, __fadd_rn(x[j][q], sc[q]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      }
      if (lane == 0) nxt[r] = side(r, v);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
maxplus_fold_kernel(const float* __restrict__ mats,    // [B, M, N, N]
                    const float* __restrict__ s0,      // [B, N]
                    const int* __restrict__ idx,       // [T] or null
                    const float* __restrict__ gvec,    // [B, M, N] or null
                    const float* __restrict__ arrivals,  // [T] with gvec
                    const float* __restrict__ wvec,    // [B, M, N] with gvec
                    const float* __restrict__ extras,  // [T] with gvec
                    const float* __restrict__ energy,  // [B, M, P] or null
                    float* __restrict__ out,           // [B, N]
                    float* __restrict__ acc_out,       // [B, P] with energy
                    int m, int n, int p, long long t_steps) {
  extern __shared__ float sbuf[];                      // 2 * n floats
  const int b = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* mats_b = mats + static_cast<size_t>(b) * m * nn;
  float* cur = sbuf;
  float* nxt = sbuf + n;
  for (int r = threadIdx.x; r < n; r += kThreads) {
    cur[r] = s0[static_cast<size_t>(b) * n + r];
  }
  float acc = 0.0f;
  __syncthreads();

  for (long long t = 0; t < t_steps; ++t) {
    const int i = idx ? __ldg(idx + t) : static_cast<int>(t % m);
    const size_t vec = (static_cast<size_t>(b) * m + i) * n;   // g/w rows
    fold_step(mats_b + static_cast<size_t>(i) * nn, cur, nxt, n,
              [&] {
                if (energy != nullptr && threadIdx.x < p) {
                  acc = __fadd_rn(acc, __ldg(energy + (static_cast<size_t>(b)
                                                       * m + i) * p
                                             + threadIdx.x));
                }
              },
              [&](int r, float v) {
                if (gvec != nullptr) {
                  v = arrival_max_in(v, __ldg(gvec + vec + r),
                                     __ldg(arrivals + t));
                  v = fault_shift(v, __ldg(wvec + vec + r), __ldg(extras + t));
                }
                return v;
              });
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int r = threadIdx.x; r < n; r += kThreads) {
    out[static_cast<size_t>(b) * n + r] = cur[r];
  }
  if (energy != nullptr && threadIdx.x < p) {
    acc_out[static_cast<size_t>(b) * p + threadIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
maxplus_fold_many_kernel(const float* __restrict__ mats,   // [M1, N, N]
                         const float* __restrict__ gvec,   // [M1, N] or null
                         const float* __restrict__ wvec,   // [M1, N] or null
                         const int* __restrict__ idx,      // [B, T]
                         const float* __restrict__ arrivals,  // [B, T] with gvec
                         const float* __restrict__ extras,    // [B, T] with wvec
                         const float* __restrict__ s0,     // [N]
                         const int* __restrict__ lengths,  // [B]
                         float* __restrict__ out,          // [B, N]
                         int n, long long t_stride) {
  extern __shared__ float sbuf[];                      // 2 * n floats
  const int b = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t row = static_cast<size_t>(b) * t_stride;
  const long long len = __ldg(lengths + b);
  float* cur = sbuf;
  float* nxt = sbuf + n;
  for (int r = threadIdx.x; r < n; r += kThreads) cur[r] = s0[r];
  __syncthreads();

  for (long long t = 0; t < len; ++t) {
    const int i = __ldg(idx + row + t);
    const size_t vec = static_cast<size_t>(i) * n;             // g/w rows
    fold_step(mats + static_cast<size_t>(i) * nn, cur, nxt, n, [] {},
              [&](int r, float v) {
                if (gvec != nullptr) {
                  v = arrival_max_in(v, __ldg(gvec + vec + r),
                                     __ldg(arrivals + row + t));
                }
                if (wvec != nullptr) {
                  v = fault_shift(v, __ldg(wvec + vec + r),
                                  __ldg(extras + row + t));
                }
                return v;
              });
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int r = threadIdx.x; r < n; r += kThreads) {
    out[static_cast<size_t>(b) * n + r] = cur[r];
  }
}

}  // namespace

extern "C" {

int maxplus_fold_max_n() { return kMaxN; }

// Launch on `stream` and return cudaGetLastError() (0 = launched).  Pointers
// that a variant does not use are null: idx (periodic), gvec/arrivals/wvec/
// extras (all four or none), energy/acc (both or none).
int maxplus_fold(const float* mats, const float* s0, const int* idx,
                 const float* gvec, const float* arrivals, const float* wvec,
                 const float* extras, const float* energy, float* out,
                 float* acc, int b, int m, int n, int p, long long t_steps,
                 void* stream) {
  if (b <= 0 || m <= 0 || n <= 0 || n > kMaxN || t_steps < 0 ||
      (energy != nullptr && (p <= 0 || p > kThreads))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  maxplus_fold_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mats, s0, idx, gvec, arrivals, wvec, extras, energy, out, acc, m, n, p,
      t_steps);
  return static_cast<int>(cudaGetLastError());
}

// Launch the many-trace fold (one block per lane) on `stream` and return
// cudaGetLastError().  gvec/arrivals (the arrival max-in) and wvec/extras
// (the fault shift) are each both given or both null; lengths[b] <= t_stride.
int maxplus_fold_many(const float* mats, const float* gvec, const float* wvec,
                      const int* idx, const float* arrivals,
                      const float* extras, const float* s0,
                      const int* lengths, float* out, int b, int n,
                      long long t_stride, void* stream) {
  if (b <= 0 || n <= 0 || n > kMaxN || t_stride < 0 ||
      (gvec == nullptr) != (arrivals == nullptr) ||
      (wvec == nullptr) != (extras == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * static_cast<size_t>(n) * sizeof(float);
  maxplus_fold_many_kernel<<<b, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      mats, gvec, wvec, idx, arrivals, extras, s0, lengths, out, n, t_stride);
  return static_cast<int>(cudaGetLastError());
}

const char* maxplus_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
