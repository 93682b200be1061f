// (max,+) trace-indexed matrix fold for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
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
// What bounds it on this card.  The work is 2*T*B*N^2 float32 max/add
// operations; the dictionary [B, M, N, N] is B*M*N^2*4 bytes, read once
// at the least.  At the real-size sweep (T = 65536, B = 64, N = 146,
// M = 512) that is 1.8e11 operations (2.7 ms at the 67 TFLOP/s float32
// peak) against 2.8 GB (0.8 ms at 3.35 TB/s): operations bound it.  The
// kernel is far from that bound, because each step depends on the
// previous state: per step a block reads one N x N matrix (85 KB at
// N = 146) and waits for it before the next step can start, so the time
// is T times one memory round trip plus a block barrier.
//
// Design (simple and right first).  One block per design point loops over
// t; the state is double-buffered in shared memory (2*N floats), so one
// __syncthreads per step suffices.  Each warp takes rows r = warp + 32*j;
// its lanes read A[b, i, r, c] contiguously over c (coalesced), add s[c]
// and reduce by shuffle max.  All of a thread's matrix loads for a step
// are issued together into registers (N <= kMaxN fixes their count), so
// a step costs about one memory latency.  A single-table Simulator.run
// uses one block, i.e. one SM: a batch of design points is what fills
// the card.  Not done yet: prefetching step t+1's matrix during step t.
//
// Exactness.  Each A + s is one correctly rounded float32 add and max does
// not depend on order, so any reduction order reproduces the JAX kernel
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
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
    const float* a = mats_b + static_cast<size_t>(i) * nn;
    const size_t vec = (static_cast<size_t>(b) * m + i) * n;   // g/w rows

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
    if (energy != nullptr && threadIdx.x < p) {
      acc = __fadd_rn(acc, __ldg(energy + (static_cast<size_t>(b) * m + i) * p
                                 + threadIdx.x));
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp + j * kWarps;
      if (r < n) {                                      // warp-uniform
        float v = -FLT_MAX;
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
          if (lane + 32 * q < n) v = fmaxf(v, __fadd_rn(x[j][q], sc[q]));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
        }
        if (lane == 0) {
          if (gvec != nullptr) {
            v = fmaxf(v, __fadd_rn(__ldg(gvec + vec + r), __ldg(arrivals + t)));
            v = __fadd_rn(v, __fmul_rn(__ldg(wvec + vec + r), __ldg(extras + t)));
          }
          nxt[r] = v;
        }
      }
    }
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

const char* maxplus_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
