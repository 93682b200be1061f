// (max,+) matrix folds for NVIDIA Hopper (sm_90a): one kernel per design
// point (K1/K2) and one per trace of a fleet (K3), each in two routes.
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
// Two routes, chosen by the data.  A step matrix of the SSD recurrence
// (repro_torch/core/maxplus_form.py::op_matrix) is the (max,+) identity
// except for the at most four rows an op rewrites (bus, ctrl, chip, and
// round_start under the batched policy at way 0), and each of those rows
// holds at most four finite entries (the sources bus, chip or
// round_start, ctrl, origin).  The compact route keeps only those: a
// pre-pass (maxplus_compact_kernel) reads the dense operands once and
// writes, per combo, a 128-byte record of its rewritten rows, their
// finite entries as (column, value) and their g/w side values, plus one
// flag that says whether the inputs meet the route's precondition.  The
// wrapper reads the flag where it synchronises for its range checks and
// launches the compact fold when it is clear, the dense fold otherwise.
// Both are kernels of this file; neither falls back to the other on an
// error.
//
// The precondition (checked by the pre-pass, bit patterns as unsigned):
//   - every value below is in [+0, L], L = 2^60, sign bit clear (so
//     neither -0.0, NaN nor inf): the kept matrix entries, s0, every
//     gvec value that is not <= NEG, the arrivals and extras of every
//     step a lane folds;
//   - every other matrix entry and gvec value is <= NEG (NEG = -1e30f;
//     -inf is allowed), every wvec value is +0 or in (0, 1];
//   - a row is rewritten (kept) when its matrix row is not bitwise the
//     identity basis row (+0 on the diagonal, NEG elsewhere), or its g is
//     kept, or its w is not +0; a combo rewrites at most kRows rows, each
//     with between 1 and kEntries kept entries;
//   - T < 2^24 steps (checked by the wrapper).
// Why it makes the compact route exact.  Every operation is the dense
// route's, on the kept rows, so only the skipped terms need an argument.
// Each op of the fold is monotone in its operands.  A step's result
// rounds at most twice on its way from the old state (the matvec add and
// the fault add); its other terms, g + arr <= 2L and w * ext <= L (w <=
// 1), are below powers of two that rounding cannot pass.  So by induction
// the state after t steps is at most (2t + 1) L (1 + 2^-24)^(2t) <
// 2^25 * 2^60 * e^2 < 2^88 for t < 2^24, and it is never negative.  Then:
//   - every dropped candidate NEG + s[c] (or below) is < -1e30 + 2^88 < 0,
//     below every kept candidate val + s[c] >= +0, so the row's max is the
//     max over its kept entries;
//   - a skipped identity row gives max(+0 + s[r], NEG + s[c]) = s[r] bit
//     for bit (+0 + x = x for x >= +0);
//   - a skipped side gives max(s[r], NEG + arr) = s[r] and
//     s[r] + (+0) * ext = s[r];
//   - padding a short row by repeating one of its own entries changes no
//     max (max is idempotent).
//
// What bounds them on this card.  Counted for what the inputs need, the
// compact route does at most 16 add/max pairs a step, so bytes bound
// every launch: the dense dictionary read once by the pre-pass (the
// real-size sweep: 64 x 512 matrices of 146 x 146, 2.79 GB, 0.83 ms at
// 3.35 TB/s; the 8 x 16 fleet: 513 matrices, 43.7 MB) plus the index,
// arrival and surcharge of each step.  Each lane is a serial chain,
// though: step t + 1 reads the state step t wrote, so a launch takes at
// least its longest lane times the latency of one dependent step.  The
// dense route reads the whole N x N matrix of every step (85 KB at N =
// 146) and ends each step on a block barrier, about 2.9 us a step at N =
// 146; the compact route keeps the step inside one warp and shared
// memory.
//
// Design of the compact route.  One warp folds one lane (a design point
// for K1, a trace for K3); the state s [N] stays in shared memory and is
// updated in place.  Lanes 4j + k of the warp (and their mirror 16 higher)
// take entry k of the step's row j: val + s[col], two xor shuffles take
// the row's max, and lane 4j applies the sides in the dense order
// (arrival_max_in, then fault_shift) and writes s[row].  Every read of a
// step comes before its writes, with a __syncwarp between them and
// another before the next step's reads; no block barrier.  The combo
// records live in shared memory (K1: a block per design point, its own
// dictionary; K3: several lanes a block sharing one copy of the union
// dictionary, as many warps a block as put every lane in one wave across
// the SMs).  The warp loads 32 steps' indices, arrivals and extras with
// one coalesced load each, a chunk ahead, and hands each on by
// __shfl_sync; the next step's record is read from shared memory while
// the current step runs, since its index is known.  What stays on the
// chain: read s, add, two shuffles, the sides, write.  K1's energies add
// in t order into a register of lane p (P <= 32), from a shared copy.
//
// Design of the dense route (simple and right first, kept as it was).
// One block per design point (K1) or per lane (K3) loops over t; the state
// is double-buffered in shared memory (2*N floats), so one __syncthreads
// per step suffices.  Each warp takes rows r = warp + 32*j; its lanes read
// A[i, r, c] contiguously over c (coalesced), add s[c] and reduce by
// shuffle max.  All of a thread's matrix loads for a step are issued
// together into registers (N <= kMaxN fixes their count), so a step costs
// about one memory latency.
//
// Exactness.  Each A + s is one correctly rounded float32 add and max does
// not depend on order, so any reduction order reproduces the JAX kernels
// bit for bit.  The shift is __fadd_rn(s, __fmul_rn(w, ext)): no FMA
// contraction can enter, and with w in {0, 1} the product is exact
// either way.  Energies add in t order, as the TPU kernel's fori_loop
// does.  The NEG sentinel of the dictionaries is -1e30f, never -inf;
// -FLT_MAX only seeds the dense reduction and is below every real
// candidate.

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

// ---------------------------------------------------------------------------
// The compact route.
// ---------------------------------------------------------------------------

constexpr int kRows = 4;             // rows an op rewrites
constexpr int kEntries = 4;          // kept entries a rewritten row holds
constexpr int kSlots = kRows * kEntries;                      // 16
// One combo's record, 32 words (128 bytes):
//   [0, 16)   val of slot 4j + k: entry k of row j (f32)
//   [16, 20)  g of row j (f32; NEG where there is no gvec)
//   [20, 24)  w of row j (f32; +0 where there is no wvec)
//   [24, 28)  col of slot l in byte l % 4 of word 24 + l / 4
//   [28]      row j in byte j
//   [29]      the number of rows
//   [30, 32)  zero
// Rows past the count hold row 0, col 0, val NEG, g NEG, w +0.
constexpr int kWords = 32;
constexpr int kValWord = 0, kGWord = 16, kWWord = 20, kColWord = 24,
              kRowWord = 28, kCountWord = 29;
constexpr float kNeg = -1e30f;                 // maxplus_form.NEG
constexpr unsigned kNegBits = 0xF149F2CAu;     // its bits
constexpr unsigned kLimitBits = 0x5D800000u;   // 2^60
constexpr unsigned kOneBits = 0x3F800000u;     // 1.0f
constexpr int kPrepassWarps = 8;
constexpr int kFoldThreads = 256;    // K1: all copy the dictionary, warp 0 folds
constexpr int kMaxLaneWarps = 32;    // K3: lanes a block at most

__device__ __forceinline__ bool in_range(float x) {      // [+0, L]
  return __float_as_uint(x) <= kLimitBits;
}

// A flat view of up to `rows` x `cols` values checked against [+0, L];
// with `lengths`, row r only up to min(lengths[r], cols).
struct Span {
  const float* p;
  long long rows, cols;
  const int* lengths;
};

__device__ __forceinline__ bool span_ok(const Span& sp, long long e) {
  const long long r = e / sp.cols, t = e - r * sp.cols;
  if (sp.lengths != nullptr && t >= static_cast<long long>(__ldg(sp.lengths + r))) {
    return true;
  }
  return in_range(__ldg(sp.p + e));
}

// Blocks [0, combos) compact one combo's [N, N] matrix each; the blocks
// past them check the value spans.  A violation sets *refused (any
// writer stores 1, so the race is benign); the records are then not used.
__global__ void __launch_bounds__(kPrepassWarps * 32)
maxplus_compact_kernel(const float* __restrict__ mats,   // [combos, N, N]
                       const float* __restrict__ gvec,   // [combos, N] or null
                       const float* __restrict__ wvec,   // [combos, N] or null
                       Span s0, Span arr, Span ext,
                       unsigned* __restrict__ rec,       // [combos, kWords]
                       int* __restrict__ refused, long long combos, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x >= combos) {
    const long long nth = (gridDim.x - combos) * blockDim.x;
    const long long first = (blockIdx.x - combos) * blockDim.x + threadIdx.x;
    const Span spans[3] = {s0, arr, ext};
    bool bad = false;
    for (int k = 0; k < 3; ++k) {
      if (spans[k].p == nullptr) continue;
      const long long total = spans[k].rows * spans[k].cols;
      for (long long e = first; e < total; e += nth) {
        bad |= !span_ok(spans[k], e);
      }
    }
    if (bad) *refused = 1;
    return;
  }
  __shared__ unsigned char kept_row[kMaxN];
  __shared__ unsigned char n_kept[kMaxN];
  __shared__ unsigned char kcol[kMaxN][kEntries];
  __shared__ float kval[kMaxN][kEntries];
  __shared__ float row_g[kMaxN], row_w[kMaxN];
  __shared__ int rows[kRows];
  const long long c = blockIdx.x;
  const float* a = mats + static_cast<size_t>(c) * n * n;
  bool bad = false;
  for (int r = warp; r < n; r += kPrepassWarps) {
    float x[kColsPerLane];
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int col = lane + 32 * q;
      x[q] = col < n ? __ldg(a + static_cast<size_t>(r) * n + col) : 0.0f;
    }
    bool differs = false;
    int count = 0;
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) {
      const int col = lane + 32 * q;
      const bool real = col < n;
      const bool keep = real && in_range(x[q]);
      bad |= real && !keep && !(x[q] <= kNeg);
      differs |= real && __float_as_uint(x[q]) != (col == r ? 0u : kNegBits);
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int pos = count + __popc(m & ((1u << lane) - 1u));
        if (pos < kEntries) {
          kcol[r][pos] = static_cast<unsigned char>(col);
          kval[r][pos] = x[q];
        }
      }
      count += __popc(m);
    }
    differs = __any_sync(0xffffffffu, differs);
    if (lane == 0) {
      const float g = gvec != nullptr ? __ldg(gvec + c * n + r) : kNeg;
      const float w = wvec != nullptr ? __ldg(wvec + c * n + r) : 0.0f;
      const unsigned wb = __float_as_uint(w);
      const bool g_kept = in_range(g);
      const bool w_kept = wb != 0u && wb <= kOneBits;
      bad |= !g_kept && !(g <= kNeg);
      bad |= !w_kept && wb != 0u;
      const bool keep_row = differs || g_kept || w_kept;
      bad |= keep_row && (count == 0 || count > kEntries);
      kept_row[r] = keep_row;
      n_kept[r] = static_cast<unsigned char>(count < kEntries ? count
                                                              : kEntries);
      row_g[r] = g;
      row_w[r] = w;
    }
  }
  __syncthreads();
  if (warp != 0) {
    if (bad) *refused = 1;
    return;
  }
  // the kept rows in ascending order
  int count = 0;
#pragma unroll
  for (int q = 0; q < kColsPerLane; ++q) {
    const int r = lane + 32 * q;
    const bool keep = r < n && kept_row[r];
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int pos = count + __popc(m & ((1u << lane) - 1u));
      if (pos < kRows) rows[pos] = r;
    }
    count += __popc(m);
  }
  bad |= count > kRows;
  const int nr = count < kRows ? count : kRows;
  __syncwarp();
  // lane l writes word l of the record
  unsigned word = 0u;
  auto slot_entry = [&](int slot, bool want_col) -> unsigned {
    const int j = slot >> 2, k = slot & 3;
    if (j >= nr) return want_col ? 0u : kNegBits;
    const int r = rows[j];
    const int kk = k < n_kept[r] ? k : 0;         // pad with the first entry
    return want_col ? kcol[r][kk] : __float_as_uint(kval[r][kk]);
  };
  if (lane < kGWord) {
    word = slot_entry(lane - kValWord, false);
  } else if (lane < kWWord) {
    const int j = lane - kGWord;
    word = j < nr ? __float_as_uint(row_g[rows[j]]) : kNegBits;
  } else if (lane < kColWord) {
    const int j = lane - kWWord;
    word = j < nr ? __float_as_uint(row_w[rows[j]]) : 0u;
  } else if (lane < kRowWord) {
    for (int b = 0; b < 4; ++b) {
      word |= slot_entry(4 * (lane - kColWord) + b, true) << (8 * b);
    }
  } else if (lane == kRowWord) {
    for (int j = 0; j < nr; ++j) word |= static_cast<unsigned>(rows[j]) << (8 * j);
  } else if (lane == kCountWord) {
    word = static_cast<unsigned>(nr);
  }
  rec[c * kWords + lane] = word;
  if (bad) *refused = 1;
}

// One step's record as the registers of one lane of the folding warp.
struct Entry {
  float val, g, w;
  int col, row, rows;
};

__device__ __forceinline__ Entry fetch(const unsigned* rec, int lane) {
  const int slot = lane & (kSlots - 1);
  const int j = slot >> 2;
  Entry e;
  e.val = __uint_as_float(rec[kValWord + slot]);
  e.g = __uint_as_float(rec[kGWord + j]);
  e.w = __uint_as_float(rec[kWWord + j]);
  e.col = (rec[kColWord + (slot >> 2)] >> (8 * (slot & 3))) & 0xff;
  e.row = (rec[kRowWord] >> (8 * j)) & 0xff;
  e.rows = static_cast<int>(rec[kCountWord]);
  return e;
}

// One lane's fold inside one warp: `len` steps against the records in
// shared memory `dict`, the state `s` [n] in shared memory updated in
// place.  kIndexed reads i = idx[t] (else i = t mod m); kG / kW apply the
// arrival max-in / fault shift with arr[t] / ext[t]; kEnergy adds
// e[i * p + lane] into `acc` on lanes < p.
template <bool kIndexed, bool kG, bool kW, bool kEnergy>
__device__ __forceinline__ void fold_lane(const unsigned* dict, float* s,
                                          const float* e, int p, int m,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ arr,
                                          const float* __restrict__ ext,
                                          long long len, float& acc) {
  const int lane = threadIdx.x & 31;
  const int slot = lane & (kSlots - 1);
  const bool writer = lane < kSlots && (slot & 3) == 0;
  const int j = slot >> 2;
  // chunk of 32 steps: lane q holds step base + q; `nxt` the chunk after
  auto load_i = [&](long long t) {
    return kIndexed && t < len ? __ldg(idx + t) : 0;
  };
  auto load_f = [&](const float* x, long long t) {
    return t < len ? __ldg(x + t) : 0.0f;
  };
  long long base = 0;
  int cur_i = load_i(lane), nxt_i = load_i(32 + lane);
  float cur_a = 0.0f, nxt_a = 0.0f, cur_x = 0.0f, nxt_x = 0.0f;
  if (kG) { cur_a = load_f(arr, lane); nxt_a = load_f(arr, 32 + lane); }
  if (kW) { cur_x = load_f(ext, lane); nxt_x = load_f(ext, 32 + lane); }
  int i = kIndexed ? __shfl_sync(0xffffffffu, cur_i, 0) : 0;
  Entry cur = fetch(dict + static_cast<size_t>(i) * kWords, lane);
  for (long long t = 0; t < len; ++t) {
    const int q = static_cast<int>(t - base);
    const int qn = q + 1;
    int i_next;
    if (kIndexed) {
      i_next = __shfl_sync(0xffffffffu, qn < 32 ? cur_i : nxt_i, qn & 31);
    } else {
      i_next = i + 1 == m ? 0 : i + 1;
    }
    float v = __fadd_rn(cur.val, s[cur.col]);
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if (kG) v = arrival_max_in(v, cur.g, __shfl_sync(0xffffffffu, cur_a, q));
    if (kW) v = fault_shift(v, cur.w, __shfl_sync(0xffffffffu, cur_x, q));
    const Entry next = fetch(dict + static_cast<size_t>(i_next) * kWords,
                             lane);
    if (kEnergy && lane < p) acc = __fadd_rn(acc, e[i * p + lane]);
    __syncwarp();
    if (writer && j < cur.rows) s[cur.row] = v;
    __syncwarp();
    cur = next;
    i = i_next;
    if (qn == 32) {
      base += 32;
      cur_i = nxt_i;
      nxt_i = load_i(base + 32 + lane);
      if (kG) { cur_a = nxt_a; nxt_a = load_f(arr, base + 32 + lane); }
      if (kW) { cur_x = nxt_x; nxt_x = load_f(ext, base + 32 + lane); }
    }
  }
}

// Copy `words` 32-bit words from global to shared memory with the block.
__device__ __forceinline__ void copy_words(unsigned* dst,
                                           const unsigned* __restrict__ src,
                                           size_t words) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (size_t k = threadIdx.x; k < words / 4; k += blockDim.x) d4[k] = s4[k];
}

__host__ __device__ constexpr size_t round4(size_t x) { return (x + 3) & ~size_t{3}; }

template <bool kIndexed, bool kSides, bool kEnergy>
__global__ void __launch_bounds__(kFoldThreads)
maxplus_fold_compact_kernel(const unsigned* __restrict__ rec,  // [B, M, kWords]
                            const float* __restrict__ s0,      // [B, N]
                            const int* __restrict__ idx,       // [T] or null
                            const float* __restrict__ arrivals,  // [T] with kSides
                            const float* __restrict__ extras,    // [T] with kSides
                            const float* __restrict__ energy,  // [B, M, P] with kEnergy
                            float* __restrict__ out,           // [B, N]
                            float* __restrict__ acc_out,       // [B, P] with kEnergy
                            int m, int n, int p, long long t_steps) {
  extern __shared__ uint4 smem[];
  unsigned* dict = reinterpret_cast<unsigned*>(smem);          // m * kWords
  float* s = reinterpret_cast<float*>(dict + static_cast<size_t>(m) * kWords);
  float* e = s + round4(n);                                    // m * p
  const int b = blockIdx.x;
  copy_words(dict, rec + static_cast<size_t>(b) * m * kWords,
             static_cast<size_t>(m) * kWords);
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    s[r] = s0[static_cast<size_t>(b) * n + r];
  }
  if (kEnergy) {
    for (int k = threadIdx.x; k < m * p; k += blockDim.x) {
      e[k] = energy[static_cast<size_t>(b) * m * p + k];
    }
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  float acc = 0.0f;
  fold_lane<kIndexed, kSides, kSides, kEnergy>(dict, s, e, p, m, idx,
                                               arrivals, extras, t_steps,
                                               acc);
  __syncwarp();
  for (int r = threadIdx.x; r < n; r += 32) {
    out[static_cast<size_t>(b) * n + r] = s[r];
  }
  if (kEnergy && static_cast<int>(threadIdx.x) < p) {
    acc_out[static_cast<size_t>(b) * p + threadIdx.x] = acc;
  }
}

template <bool kG, bool kW>
__global__ void __launch_bounds__(kMaxLaneWarps * 32)
maxplus_fold_many_compact_kernel(const unsigned* __restrict__ rec,  // [M1, kWords]
                                 const int* __restrict__ idx,       // [B, T]
                                 const float* __restrict__ arrivals,  // [B, T] with kG
                                 const float* __restrict__ extras,    // [B, T] with kW
                                 const float* __restrict__ s0,      // [N]
                                 const int* __restrict__ lengths,   // [B]
                                 float* __restrict__ out,           // [B, N]
                                 int b, int m1, int n,
                                 long long t_stride) {
  extern __shared__ uint4 smem[];
  unsigned* dict = reinterpret_cast<unsigned*>(smem);          // m1 * kWords
  const int warp = threadIdx.x >> 5;
  float* s = reinterpret_cast<float*>(dict + static_cast<size_t>(m1) * kWords)
             + warp * round4(n);
  copy_words(dict, rec, static_cast<size_t>(m1) * kWords);
  const int lane_id = blockIdx.x * (blockDim.x >> 5) + warp;
  for (int r = threadIdx.x & 31; r < n; r += 32) s[r] = s0[r];
  __syncthreads();
  if (lane_id >= b) return;
  const size_t row = static_cast<size_t>(lane_id) * t_stride;
  float acc = 0.0f;
  fold_lane<true, kG, kW, false>(dict, s, nullptr, 0, m1, idx + row,
                                 kG ? arrivals + row : nullptr,
                                 kW ? extras + row : nullptr,
                                 __ldg(lengths + lane_id), acc);
  __syncwarp();
  for (int r = threadIdx.x & 31; r < n; r += 32) {
    out[static_cast<size_t>(lane_id) * n + r] = s[r];
  }
}

size_t fold_compact_smem(int m, int n, int p) {
  return (static_cast<size_t>(m) * kWords + round4(n)
          + static_cast<size_t>(m) * p) * sizeof(float);
}

// Lanes a block of the compact many-trace fold: enough that every lane
// starts in one wave, one block an SM.
int many_lane_warps(int b) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int w = (b + sms - 1) / sms;
  return w < 1 ? 1 : (w > kMaxLaneWarps ? kMaxLaneWarps : w);
}

size_t many_compact_smem(int m1, int n, int warps) {
  return (static_cast<size_t>(m1) * kWords
          + static_cast<size_t>(warps) * round4(n)) * sizeof(float);
}

template <bool kIndexed, bool kSides, bool kEnergy>
int launch_fold_compact(const unsigned* rec, const float* s0, const int* idx,
                        const float* arrivals, const float* extras,
                        const float* energy, float* out, float* acc, int b,
                        int m, int n, int p, long long t_steps,
                        cudaStream_t stream) {
  auto kernel = maxplus_fold_compact_kernel<kIndexed, kSides, kEnergy>;
  const size_t smem = fold_compact_smem(m, n, kEnergy ? p : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kFoldThreads, smem, stream>>>(rec, s0, idx, arrivals, extras,
                                            energy, out, acc, m, n, p,
                                            t_steps);
  return static_cast<int>(cudaGetLastError());
}

template <bool kG, bool kW>
int launch_many_compact(const unsigned* rec, const int* idx,
                        const float* arrivals, const float* extras,
                        const float* s0, const int* lengths, float* out,
                        int b, int m1, int n, long long t_stride,
                        cudaStream_t stream) {
  auto kernel = maxplus_fold_many_compact_kernel<kG, kW>;
  const int warps = many_lane_warps(b);
  const size_t smem = many_compact_smem(m1, n, warps);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(b + warps - 1) / warps, warps * 32, smem, stream>>>(
      rec, idx, arrivals, extras, s0, lengths, out, b, m1, n, t_stride);
  return static_cast<int>(cudaGetLastError());
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

// --- the compact route ---------------------------------------------------

int maxplus_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// Dynamic shared memory of a compact fold launch (p = 0 without energy).
long long maxplus_fold_compact_smem(int m, int n, int p) {
  return static_cast<long long>(fold_compact_smem(m, n, p));
}

long long maxplus_fold_many_compact_smem(int m1, int n, int b) {
  return static_cast<long long>(many_compact_smem(m1, n, many_lane_warps(b)));
}

int maxplus_fold_many_lane_warps(int b) { return many_lane_warps(b); }

// The pre-pass: records [combos, 32] of the combos' [N, N] matrices (with
// their gvec / wvec rows where given) and *refused = 1 where the inputs
// break the compact route's precondition.  s0 is checked as s0_count
// values, arrivals / extras (each optional) as rows x cols values, row r
// up to lengths[r] where lengths is given.  *refused is cleared first.
int maxplus_compact(const float* mats, const float* gvec, const float* wvec,
                    const float* s0, long long s0_count, const float* arr,
                    const float* ext, const int* lengths, long long rows,
                    long long cols, unsigned* rec, int* refused,
                    long long combos, int n, void* stream) {
  if (combos <= 0 || n <= 0 || n > kMaxN || s0_count < 0 || rows < 0 ||
      cols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(refused, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Span s{s0, 1, s0_count, nullptr};
  const Span a{arr, rows, cols, lengths};
  const Span x{ext, rows, cols, lengths};
  const long long checked = s0_count + (arr != nullptr ? rows * cols : 0)
                            + (ext != nullptr ? rows * cols : 0);
  long long check_blocks = (checked + kPrepassWarps * 32 - 1)
                           / (kPrepassWarps * 32);
  check_blocks = check_blocks < 1 ? 1 : (check_blocks > 4096 ? 4096
                                                            : check_blocks);
  maxplus_compact_kernel<<<static_cast<unsigned>(combos + check_blocks),
                           kPrepassWarps * 32, 0, st>>>(
      mats, gvec, wvec, s, a, x, rec, refused, combos, n);
  return static_cast<int>(cudaGetLastError());
}

// The compact fold of K1/K2 on the pre-pass's records [B, M, 32]; the
// pointers as for maxplus_fold, gvec / wvec folded into the records
// (arrivals and extras both or none, and only with idx; energy with
// 0 < p <= 32).
int maxplus_fold_compact(const unsigned* rec, const float* s0, const int* idx,
                         const float* arrivals, const float* extras,
                         const float* energy, float* out, float* acc, int b,
                         int m, int n, int p, long long t_steps,
                         void* stream) {
  const bool sides = arrivals != nullptr;
  if (b <= 0 || m <= 0 || n <= 0 || n > kMaxN || t_steps < 0 ||
      sides != (extras != nullptr) || (sides && idx == nullptr) ||
      (energy != nullptr && (p <= 0 || p > 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FOLD(I, S, E)                                                  \
  return launch_fold_compact<I, S, E>(rec, s0, idx, arrivals, extras, energy, \
                                      out, acc, b, m, n, p, t_steps, st)
  if (idx == nullptr) {
    if (energy != nullptr) REPRO_FOLD(false, false, true);
    REPRO_FOLD(false, false, false);
  }
  if (sides) {
    if (energy != nullptr) REPRO_FOLD(true, true, true);
    REPRO_FOLD(true, true, false);
  }
  if (energy != nullptr) REPRO_FOLD(true, false, true);
  REPRO_FOLD(true, false, false);
#undef REPRO_FOLD
}

// The compact fold of K3 on the pre-pass's records [M1, 32] of the union
// dictionary, one warp a lane; arrivals (the arrival max-in) and extras
// (the fault shift) are each optional, their g / w in the records.
int maxplus_fold_many_compact(const unsigned* rec, const int* idx,
                              const float* arrivals, const float* extras,
                              const float* s0, const int* lengths,
                              float* out, int b, int m1, int n,
                              long long t_stride, void* stream) {
  if (b <= 0 || m1 <= 0 || n <= 0 || n > kMaxN || t_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_MANY(G, W)                                                     \
  return launch_many_compact<G, W>(rec, idx, arrivals, extras, s0, lengths,  \
                                   out, b, m1, n, t_stride, st)
  if (arrivals != nullptr) {
    if (extras != nullptr) REPRO_MANY(true, true);
    REPRO_MANY(true, false);
  }
  if (extras != nullptr) REPRO_MANY(false, true);
  REPRO_MANY(false, false);
#undef REPRO_MANY
}

const char* maxplus_fold_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
