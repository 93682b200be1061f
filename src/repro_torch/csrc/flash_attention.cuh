// Causal / sliding-window GQA flash attention for Hopper, shared by the two
// sources that build it: the forward in two routes picked by dtype (a
// tensor-core kernel for bf16 and a CUDA-core kernel for f32), each writing
// the rows' log-sum-exp when asked, and the backward (see "backward" below).
// Every kernel is a template on EXT: flash_attention.cu instantiates the
// index kernels (EXT false), flash_attention_ext.cu the instantiations that
// read caller positions and may soft-cap the scores (see "caller positions"
// below), so that the two compile side by side.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd, body _kernel): o = softmax(q k^T / sqrt(D) + mask) v
// with q [B, H, Sq, D], k and v [B, KVH, Sk, D], query head h reading kv
// head h / (H / KVH), positions q_offset + i for queries and j for keys, the
// mask q_pos >= k_pos (causal) and q_pos - k_pos < window (window > 0).
//
// Common to both routes.  One block per (query tile, head, batch).  The TPU's
// sequential kv grid axis becomes a loop inside the block over kv tiles; the
// online-softmax state (running max m, denominator l and the accumulator)
// stays on chip for the whole loop and the output tile is written once.  K and
// V are read from their own kv head, never replicated.  Every operand is
// addressed through (batch, head, sequence) strides with a unit stride over D,
// so the model's grouped [B, S, kvH, G, D] layout is read and written in place.
// Ragged edges are masked here: rows past Sq are computed on zeros and not
// stored, keys past Sk get probability 0.
//
// Masked scores are NEG_INF = -1e30 (finite, as on the TPU): a row whose first
// visited tiles are wholly masked builds up garbage in l and acc
// (exp(NEG_INF - NEG_INF) = 1), and its first valid key resets both, since
// alpha = exp(NEG_INF - m) = 0.  A -INFINITY sentinel would give NaN there.
//
// Tile schedule (kv_range below; its Python twin is
// kernels/flash_attention/tiles.py, which the wrapper and the tests use).
// Tiles wholly above the causal diagonal are skipped, as on the TPU.  By the
// same argument, so are tiles wholly left of the window when every row of the
// query tile has at least one valid key: such a tile only adds garbage that
// the first valid key resets, or exact zeros after it.  When some row has no
// valid key at all (q_pos - window + 1 > Sk - 1) the reference averages v
// uniformly over all Sk keys, so the block then visits every tile.
//
// Tensor-core route (bf16; flash_fwd_tc).  Warp-specialised: a producer
// warpgroup and NC consumer warpgroups of 64 query rows each, so a block owns
// BQ = 64 NC query rows and walks kv tiles of BK = 64 keys.  NC = 2 for
// D <= 128 (384 threads); at D = 256 a consumer holds a 128-float O
// accumulator, which does not fit beside the scores under the 168 registers
// a thread of 384 may have (ptxas then spills and serialises every wgmma),
// so NC = 1 there (256 threads, up to 255 registers: 212 used, no spills).
//   - Loads: one producer thread issues TMA copies (4-D tensor maps over
//     (D, S, heads, batch), so the strided grouped layout needs no copy) into
//     shared memory swizzled for wgmma: Q once per block; K and V tiles into
//     two rings of STAGES = 2 stages with their own full / empty mbarriers,
//     so the next tiles load while the current ones compute.  K of a tile is
//     released once its scores are done, V once its products are.
//     Out-of-range rows are zero-filled by the TMA unit.
//   - Q.K^T: wgmma m64n64k16, both operands from shared memory (K-major),
//     bf16 in, f32 accumulators; the scale 1/sqrt(D) (times log2 e, for exp2)
//     is applied to the f32 scores.
//   - Softmax: online, in registers.  A thread holds 2 rows x 16 keys of the
//     tile; a row's max and sum are two quad shuffles.  Only the tiles on the
//     causal diagonal, on the window's left edge or past Sk take mask
//     arithmetic (tile_masked); interior tiles take none.
//   - P.V: P rounded to bf16 and fed from registers to wgmma m64nDk16 against
//     V read MN-major from shared memory, into the f32 O accumulator.
//   - Overlap: tile t's Q.K^T and tile t - 1's P.V are issued together, and
//     the softmax of tile t runs on the CUDA cores while that P.V runs on the
//     tensor cores.  P is packed into its bf16 fragments only after that
//     P.V has finished: packing it while the P.V was pending made ptxas
//     serialise every wgmma of the kernel (its warning C7513).
//   - Budget at D = 256: Q 32 KB + 2 stages x (K 32 KB + V 32 KB) = 161 KB
//     of shared memory, one block per SM.  At D <= 128 the consumers are
//     raised to 240 registers and the producer lowered to 24 (setmaxnreg).
//   - Bound: at the RecurrentGemma-9B prefill shape (B 4, H 16, KVH 1, S 4096,
//     D 256, window 2048) the valid (q, k) pairs need 4.12e11 flops against
//     0.29 GB of traffic, so the bf16 tensor-core rate (989 TFLOP/s) bounds it
//     at 0.42 ms.  The 64 x 64 tiles compute 4.25e11 flops.
//
// CUDA-core route (f32; flash_fwd_f32).  f32 everywhere (a bf16 or TF32
// tensor-core product cannot meet the f32 bar of 5e-5).  64 x 32 tiles, 256
// threads: warp w owns rows w, w + 8, ... of the query tile and lane j owns
// key j of the kv tile, so a row's max and sum are warp shuffles; in the P.V
// product lane j owns columns j, j + 32, ... of the accumulator and takes row
// i's probabilities from the other lanes by shuffle.  Q, K and V tiles are
// converted to f32 in shared memory and loaded synchronously; every visited
// tile is masked.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "tma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// the tile schedule, shared by both routes
// ---------------------------------------------------------------------------

struct KvRange {
  int begin;  // first key of the first kv tile (a multiple of bk)
  int end;    // keys [begin, end) are visited, in tiles of bk
  int q_lo, q_hi;  // positions of the block's first and last real query rows
};

__device__ __forceinline__ KvRange kv_range(int q0, int bq, int bk,
                                                     int sq, int sk,
                                                     int causal, int window,
                                                     int q_offset) {
  KvRange r;
  r.q_lo = q_offset + q0;
  r.q_hi = q_offset + min(q0 + bq, sq) - 1;
  r.end = causal ? min(sk, r.q_hi + 1) : sk;
  r.begin = 0;
  // some row without a valid key: visit every tile (see the header)
  if (window > 0 && r.q_hi - window + 1 <= sk - 1)
    r.begin = max(0, r.q_lo - window + 1) / bk * bk;
  return r;
}

// Does the kv tile at k0 hold a (real row, key) pair that the mask drops?
__device__ __forceinline__ bool tile_masked(const KvRange& r, int k0,
                                                     int bk, int sk,
                                                     int causal, int window) {
  return !(k0 + bk <= sk && (!causal || k0 + bk - 1 <= r.q_lo)
           && (window <= 0 || r.q_hi - k0 < window));
}

// ---------------------------------------------------------------------------
// caller positions and the logit soft cap (the EXT instantiations)
// ---------------------------------------------------------------------------
//
// The EXT instantiation of every kernel (built from flash_attention_ext.cu)
// takes per-row positions q_pos [B, Sq] and k_pos [B, Sk] (one row a batch
// entry, shared by every head) in place of q_offset + i and j, and may
// soft-cap the scores: s = cap tanh(q.k scale / cap) before the mask, as the
// JAX package's _softcap; the backward multiplies dS by 1 - tanh^2 before
// its products for dq and dk.  A pair is kept iff q_pos >= k_pos (causal)
// and q_pos - k_pos < window (a window).  With packed documents the
// positions restart, so in index order every tile holds a few kept pairs.
//
// The mask reads positions alone, and softmax over a set of keys does not
// depend on their order.  So the EXT kernels work in position order: the
// caller's PosPlan holds, per batch entry, the stable sort permutation of
// q_pos and of k_pos (sorted row r is query q_perm[r], sorted key j is key
// k_perm[j]), made once a model forward.  In that order sorted row r keeps
// exactly the keys [lo_r, hi_r): hi_r counts the keys with k_pos <= q_pos_r
// (Sk without the causal mask), lo_r those with k_pos <= q_pos_r - window
// (0 without a window).  Both are monotone in r, so the tiles a block visits
// are a band again, as on the index path: a query block [r0, r1] walks keys
// from lo_r0 to hi_r1, and only the tiles the band's edges cross take the
// mask, an integer compare of the key's sorted index against [lo_r, hi_r).
// Seen from key j, the rows keeping it are [qlo_j, qhi_j): qlo_j counts the
// rows with q_pos < k_pos_j, qhi_j those with q_pos < k_pos_j + window, so a
// dk/dv block of keys walks a band of query tiles the same way.
//
// flash_pos_band, a pre-pass over the sorted positions (a binary search a
// row and a key), writes lo, hi, qlo, qhi and the first and last row that
// keeps no key (hull), once for each (plan, causal, window).  A query
// block that may hold such a row (it meets the hull) visits every tile with
// the mask (the row averages v over every key, as the reference); a dk/dv
// block walks the hull's tiles beside its band (those rows give P = 1 / S
// and dS = 0), all masked.  For positions q_offset + arange / arange the
// band is the index path's: same tiles visited, same tiles masked.
//
// Operands reach the kernels in sorted order.  The tensor-core kernels read
// Q, K, V through TMA from sorted copies that flash_pos_gather writes before
// them (K and V are small under GQA); the backward's row pass reads O and dO
// at q_perm and writes delta, lse and a sorted copy of dO.  The CUDA-core
// kernels gather rows in their own loads.  Every kernel stores its outputs (O, lse,
// dq, dk, dv) back to index order from registers.  A plan without
// permutations (positions known sorted: a cap alone) runs on the operands in
// place.
//
// The bf16 route computes tanh as 1 - 2 / (2^(2 x log2 e) + 1) with
// ex2.approx and rcp.approx (absolute error a few 1e-7, so a score capped
// at 50 is off by about 1e-5; tanh.approx.f32 would be off by up to 2.5e-2
// there); the f32 route calls tanhf.

// the band's row and key arrays are padded to a multiple of this (the
// largest query tile), so that every tile's rows are in bounds
constexpr int POS_PAD = 128;

__host__ __device__ __forceinline__ int pos_padded(int n) {
  return (n + POS_PAD - 1) / POS_PAD * POS_PAD;
}

// int32 elements of one batch entry's band: lo, hi [pos_padded(sq)], qlo,
// qhi [pos_padded(sk)], then the hull (the first and last row keeping no
// key, as Sq - first and last + 1: 0, 0 for none) and two ints of padding
__host__ __device__ __forceinline__ long long band_ints(int sq, int sk) {
  return 2LL * pos_padded(sq) + 2LL * pos_padded(sk) + 4;
}

// What the EXT kernels read of the caller's plan.
struct PosPlan {
  const int* q_perm;   // [B, Sq] contiguous, or null: positions sorted
  const int* k_perm;   // [B, Sk] contiguous, or null
  const int* band;     // [B, band_ints(Sq, Sk)]
  int sq, sk;

  __device__ const int* lo(int b) const {
    return band + static_cast<long long>(b) * band_ints(sq, sk);
  }
  __device__ const int* hi(int b) const { return lo(b) + pos_padded(sq); }
  __device__ const int* qlo(int b) const { return hi(b) + pos_padded(sq); }
  __device__ const int* qhi(int b) const { return qlo(b) + pos_padded(sk); }
  __device__ const int* hull(int b) const { return qhi(b) + pos_padded(sk); }
  // the first and last sorted row keeping no key (sq and -1: none)
  __device__ int hull_first(int b) const { return sq - __ldg(hull(b)); }
  __device__ int hull_last(int b) const { return __ldg(hull(b) + 1) - 1; }
  // the index of sorted row r (key j) in the caller's order
  __device__ int q_row(int b, int r) const {
    return q_perm ? __ldg(q_perm + static_cast<long long>(b) * sq + r) : r;
  }
  __device__ int k_row(int b, int j) const {
    return k_perm ? __ldg(k_perm + static_cast<long long>(b) * sk + j) : j;
  }
};

// The keys a block of sorted query rows [q0, q0 + bq) visits (the forward
// and the backward's dq blocks): [begin, end) in tiles of bk from begin.
struct BandRange {
  int begin, end;
  bool keyless;            // the block meets the hull: every tile, masked
  int lo_last, hi_first;   // the band of its last and first real rows
};

__device__ __forceinline__ BandRange band_range(const PosPlan& p, int b,
                                                int q0, int bq, int bk) {
  const int r1 = min(q0 + bq, p.sq) - 1;
  const int* lo = p.lo(b);
  const int* hi = p.hi(b);
  BandRange r;
  r.keyless = p.hull_first(b) <= r1 && p.hull_last(b) >= q0;
  r.lo_last = __ldg(lo + r1);
  r.hi_first = __ldg(hi + q0);
  r.begin = r.keyless ? 0 : __ldg(lo + q0) / bk * bk;
  r.end = r.keyless ? p.sk : __ldg(hi + r1);
  return r;
}

// Does the key tile at k0 hold a (real row, key) pair the mask drops?
__device__ __forceinline__ bool band_masked(const BandRange& r, int k0,
                                            int bk, int sk) {
  return r.keyless
         || !(k0 + bk <= sk && r.lo_last <= k0 && k0 + bk <= r.hi_first);
}

// The query tiles a dk/dv block of sorted keys [k0, k0 + bk) walks: the
// band of rows keeping one of its keys and the hull's tiles, as one or two
// runs of tiles of bq rows.
struct QRuns {
  int a0, na, c0, nc;
  __device__ int count() const { return na + nc; }
  __device__ int at(int t, int bq) const {
    return t < na ? a0 + t * bq : c0 + (t - na) * bq;
  }
};

__device__ __forceinline__ QRuns band_runs(const PosPlan& p, int b, int k0,
                                           int bk, int bq) {
  const int kl = min(k0 + bk, p.sk) - 1;
  int a0 = __ldg(p.qlo(b) + k0) / bq * bq;
  int a1 = __ldg(p.qhi(b) + kl);
  int c0 = p.hull_first(b) / bq * bq;
  int c1 = p.hull_last(b) + 1;
  // tile ends (a multiple of bq past each start), empty runs dropped
  a1 = a1 > a0 ? a0 + (a1 - a0 + bq - 1) / bq * bq : a0;
  c1 = c1 > c0 ? c0 + (c1 - c0 + bq - 1) / bq * bq : c0;
  if (c1 == c0) return QRuns{a0, (a1 - a0) / bq, 0, 0};
  if (a1 == a0) return QRuns{c0, (c1 - c0) / bq, 0, 0};
  if (c0 < a0) {
    int t = a0; a0 = c0; c0 = t;
    t = a1; a1 = c1; c1 = t;
  }
  if (c0 <= a1) return QRuns{a0, (max(a1, c1) - a0) / bq, 0, 0};
  return QRuns{a0, (a1 - a0) / bq, c0, (c1 - c0) / bq};
}

// Does the (query tile q0, key tile k0) pair hold a pair the mask drops, or
// a row or key past the end?
__device__ __forceinline__ bool band_tile_masked(const PosPlan& p, int b,
                                                 int q0, int bq, int k0,
                                                 int bk) {
  return !(q0 + bq <= p.sq && k0 + bk <= p.sk
           && __ldg(p.lo(b) + q0 + bq - 1) <= k0
           && k0 + bk <= __ldg(p.hi(b) + q0));
}

// ---------------------------------------------------------------------------
// tensor-core route (bf16)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BK = 64;        // keys a kv tile
constexpr int STAGES = 2;     // K and V rings

// Shared-memory layout of a [rows, D] bf16 tile: D is cut into boxes of CH
// columns (SW bytes a row, the swizzle span); each box holds rows x SW bytes,
// swizzled by the TMA unit as wgmma's layout LAYOUT expects.
template <int D>
struct Cfg {
  // consumer warpgroups: at D = 256 the 128-float O accumulator leaves no
  // room for two under the 168 registers a thread of 384 may have
  static constexpr int NC = D == 256 ? 1 : 2;
  static constexpr int BQ = 64 * NC;                   // query rows a block
  static constexpr int NTHREADS = 128 * (NC + 1);      // and the producer
  static constexpr int CONSUMER_WARPS = 4 * NC;
  static constexpr int SW = D * 2 >= 128 ? 128 : D * 2;
  static constexpr int CH = SW / 2;
  static constexpr int NB = D / CH;
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int Q_BOX = BQ * SW;
  static constexpr int KV_BOX = BK * SW;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous region of a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh x = 1 - 2 / (2^(2 x log2 e) + 1) (see "caller positions" above);
// 1 at x = +inf (rcp.approx of inf is 0), -1 at x = -inf
__device__ __forceinline__ float tanh_fast(float x) {
  const float e = ex2(x * 2.8853900817779268f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(e + 1.f));
  return 1.f - 2.f * r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Generated operand lists (one asm per shape): S = Q.K^T with both operands
// in shared memory, K-major (first: D = A.B, the accumulator written, not
// read), and O += P.V with P in registers and V MN-major in shared memory.
template <int N> struct WgmmaSS;

template <> struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
  static __device__ __forceinline__ void first(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(0));
  }
};

template <> struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
  static __device__ __forceinline__ void first(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(0));
  }
};

template <int N> struct WgmmaRS;

template <> struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t* a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t* a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t* a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t* a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <> struct WgmmaRS<256> {
  static __device__ __forceinline__ void run(float (&d)[128],
                                             const uint32_t* a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};


// A B^T for a 64-row A tile and an N-row B tile, both [rows, D] K-major in
// shared memory, A_BOX and B_BOX bytes apart box to box (issued, not waited
// for).  da and db describe the first 16 columns; a k-step moves the start
// address (the low bits of the descriptor) to the next 16 columns: 32 bytes
// into the swizzled row, or the next box.
template <int D, int A_BOX, int B_BOX, int N = BK>
__device__ __forceinline__ void issue_ss(float (&sc)[N / 2],
                                         uint64_t da, uint64_t db) {
  constexpr int CH = Cfg<D>::CH;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int bx = kk * 16 / CH;
    const int off = (kk * 16 % CH) * 2;
    const uint64_t a = da + ((bx * A_BOX + off) >> 4);
    const uint64_t b = db + ((bx * B_BOX + off) >> 4);
    if (kk == 0)
      WgmmaSS<N>::first(sc, a, b);
    else
      WgmmaSS<N>::run(sc, a, b);
  }
}

// S = Q K^T for one kv tile
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         uint64_t dq, uint64_t dk) {
  issue_ss<D, Cfg<D>::Q_BOX, Cfg<D>::KV_BOX>(sc, dq, dk);
}

// O += P V for one kv tile (issued, not waited for); a k-step moves dv
// 16 keys (rows of the swizzled V tile) on.  The backward uses it for every
// register-A product against a 64-row tile read MN-major.
template <int D, int KSTEPS = BK / 16>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[4 * KSTEPS],
                                         uint64_t dv) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    WgmmaRS<D>::run(acc, pa + 4 * kk, dv + ((kk * 16 * C::SW) >> 4));
}

struct RowState {
  float m0, m1, l0, l1;   // running max and sum of rows r and r + 8
};

// The EXT instantiations' part of a softmax step: the soft cap (cap_out =
// cap log2 e, cap_in = scale / cap; none when cap_out is 0), and the band
// [lo, hi) of sorted keys each of the thread's rows keeps (a: row r, b:
// row r + 8).
struct Ext {
  float cap_in, cap_out;
  int loa, hia, lob, hib;
};

// Online-softmax step on the f32 scores of one tile, in place: scale (with
// log2 e, for exp2; the EXT instantiation soft-caps first), mask (edge
// tiles only), new running max, p = 2^(s - m) left in sc, and the factors
// alpha by which the old sums are rescaled.  A thread holds rows r and
// r + 8 of the tile at keys 8 j + col, + 1.
template <bool EXT = false, int NS>
__device__ __forceinline__ void softmax(float (&sc)[NS], RowState& st,
                                        float& alpha0, float& alpha1,
                                        bool masked, int k0, int col,
                                        int qp0, int sk, int causal,
                                        int window, float scale_log2,
                                        const Ext& ext = Ext()) {
  if (EXT && ext.cap_out != 0.f) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      sc[i] = ext.cap_out * tanh_fast(sc[i] * ext.cap_in);
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
  }
  if (masked) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kj = 8 * (i / 4) + col + (i & 1);
      const int kp = k0 + kj;
      bool ok = true;
      if constexpr (EXT) {
        ok = kp >= ((i & 2) ? ext.lob : ext.loa)
             && kp < ((i & 2) ? ext.hib : ext.hia);
      } else {
        const int qp = qp0 + ((i & 2) ? 8 : 0);
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
      }
      // keys past Sk: -inf, so p = 0 even for a row without a valid key
      sc[i] = kp >= sk ? -CUDART_INF_F : ok ? sc[i] : NEG_INF;
    }
  }
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
  alpha0 = ex2(st.m0 - mx0);
  alpha1 = ex2(st.m1 - mx1);
  st.m0 = mx0;
  st.m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    sc[4 * j] = ex2(sc[4 * j] - mx0);
    sc[4 * j + 1] = ex2(sc[4 * j + 1] - mx0);
    sc[4 * j + 2] = ex2(sc[4 * j + 2] - mx1);
    sc[4 * j + 3] = ex2(sc[4 * j + 3] - mx1);
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = st.l0 * alpha0 + sum0;
  st.l1 = st.l1 * alpha1 + sum1;
}

// P (f32, in the accumulator layout of S) rounded to bf16 A fragments:
// k-step j / 2 takes rows (r, r + 8) x keys 8 (j % 2) + col, + 1
template <int NS>
__device__ __forceinline__ void pack_p(const float (&p)[NS],
                                       uint32_t (&pa)[NS / 2]) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    pa[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(p[4 * j], p[4 * j + 1]);
    pa[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(p[4 * j + 2], p[4 * j + 3]);
  }
}

template <int NA>
__device__ __forceinline__ void rescale(float (&acc)[NA], float a0,
                                        float a1) {
  if (__any_sync(FULL, a0 != 1.f || a1 != 1.f)) {
#pragma unroll
    for (int j = 0; j < NA / 4; ++j) {
      acc[4 * j] *= a0;
      acc[4 * j + 1] *= a0;
      acc[4 * j + 2] *= a1;
      acc[4 * j + 3] *= a1;
    }
  }
}

template <int D, bool EXT>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, int group, int sq, int sk,
             int causal, int window, int q_offset, float scale_log2,
             long long osb, long long osh, long long oss,
             float* __restrict__ lse, PosPlan plan, float cap_in,
             float cap_out) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  // K and V rings with their own barriers: K of a tile is released once
  // its scores are computed, V once its products are
  __shared__ __align__(8) uint64_t full_k[STAGES], empty_k[STAGES];
  __shared__ __align__(8) uint64_t full_v[STAGES], empty_v[STAGES];
  __shared__ __align__(8) uint64_t q_bar;
  // swizzle atoms need 1024-byte alignment
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = base;
  uint8_t* s_k = s_q + C::Q_BYTES;
  uint8_t* s_v = s_k + STAGES * C::KV_BYTES;

  // the longest query tiles (most kv tiles) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const KvRange r = kv_range(q0, BQ, BK, sq, sk, causal, window, q_offset);
  // EXT: the band of the block's sorted rows
  BandRange br{};
  if constexpr (EXT) br = band_range(plan, b, q0, BQ, BK);
  const int k_begin = EXT ? br.begin : r.begin;
  const int n_tiles = EXT ? (br.end - br.begin + BK - 1) / BK
                          : (r.end - r.begin + BK - 1) / BK;
  // warpgroup index, uniform across the warp by construction (a shuffle),
  // so the compiler gives each role's branch its own register count
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], C::CONSUMER_WARPS);
      mbar_init(&empty_v[s], C::CONSUMER_WARPS);
    }
    mbar_init(&q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy ----
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int kvh = h / group;
      mbar_expect_tx(&q_bar, C::Q_BYTES);
#pragma unroll
      for (int bx = 0; bx < C::NB; ++bx)
        tma_load_4d(s_q + bx * C::Q_BOX, &tq, &q_bar, bx * C::CH, q0, h, b);
      int k0 = k_begin;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t > 0) k0 += BK;
        if (t >= STAGES) mbar_wait(&empty_k[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
        for (int bx = 0; bx < C::NB; ++bx)
          tma_load_4d(s_k + s * C::KV_BYTES + bx * C::KV_BOX, &tk,
                      &full_k[s], bx * C::CH, k0, kvh, b);
        if (t >= STAGES) mbar_wait(&empty_v[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
        for (int bx = 0; bx < C::NB; ++bx)
          tma_load_4d(s_v + s * C::KV_BYTES + bx * C::KV_BOX, &tv,
                      &full_v[s], bx * C::CH, k0, kvh, b);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns query rows q0 + 64 w .. + 63 ----
    if constexpr (C::NC == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row = 64 * w + 16 * (tid / 32) + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);                        // and col + 1
    const int qp0 = q_offset + q0 + row;
    // K-major descriptors for Q (this warpgroup's 64 rows) and K, MN-major
    // for V; a stage is KV_BYTES further on
    const uint64_t dq = make_desc(smem_u32(s_q) + 64 * w * C::SW, 16,
                                  8 * C::SW, C::LAYOUT);
    const uint64_t dk = make_desc(smem_u32(s_k), 16, 8 * C::SW, C::LAYOUT);
    const uint64_t dv = make_desc(smem_u32(s_v), C::KV_BOX, 8 * C::SW,
                                  C::LAYOUT);
    constexpr uint64_t STAGE = C::KV_BYTES >> 4;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    RowState st = {NEG_INF, NEG_INF, 0.f, 0.f};
    float sc[BK / 2];
    uint32_t pa[BK / 4];
    float alpha0, alpha1;
    Ext ext{cap_in, cap_out, 0, 0, 0, 0};
    if constexpr (EXT) {
      const int* lo = plan.lo(b) + q0 + row;
      const int* hi = plan.hi(b) + q0 + row;
      ext.loa = lo[0];
      ext.hia = hi[0];
      ext.lob = lo[8];
      ext.hib = hi[8];
    }
    auto masked = [&](int k0) {
      return EXT ? band_masked(br, k0, BK, sk)
                 : tile_masked(r, k0, BK, sk, causal, window);
    };

    mbar_wait(&q_bar, 0);
    // tile 0: scores only
    int k0 = k_begin;
    mbar_wait(&full_k[0], 0);
    wg_fence();
    issue_qk<D>(sc, dq, dk);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    // K's stage is released once the scores are in
    if (lane == 0) mbar_arrive(&empty_k[0]);
    softmax<EXT>(sc, st, alpha0, alpha1, masked(k0), k0, col, qp0, sk,
                 causal, window, scale_log2, ext);
    pack_p(sc, pa);
    // tile t: its scores, then the products of tile t - 1 (after O is
    // rescaled to tile t - 1's running max); the softmax of t runs while
    // those products do, and its P is packed once they are done
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % STAGES, sp = (t - 1) % STAGES;
      k0 += BK;
      mbar_wait(&full_k[s], (t / STAGES) & 1);
      mbar_wait(&full_v[sp], ((t - 1) / STAGES) & 1);
      fence_regs(sc);
      wg_fence();
      issue_qk<D>(sc, dq, dk + s * STAGE);
      wg_commit();
      rescale(acc, alpha0, alpha1);
      fence_regs(acc);
      fence_regs(pa);
      wg_fence();
      issue_pv<D>(acc, pa, dv + sp * STAGE);
      wg_commit();
      wg_wait<1>();               // the scores
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&empty_k[s]);
      softmax<EXT>(sc, st, alpha0, alpha1, masked(k0), k0, col, qp0, sk,
                   causal, window, scale_log2, ext);
      wg_wait<0>();               // the products of tile t - 1
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty_v[sp]);
      pack_p(sc, pa);
    }
    // the products of the last tile
    const int sl = (n_tiles - 1) % STAGES;
    mbar_wait(&full_v[sl], ((n_tiles - 1) / STAGES) & 1);
    rescale(acc, alpha0, alpha1);
    fence_regs(acc);
    fence_regs(pa);
    wg_fence();
    issue_pv<D>(acc, pa, dv + sl * STAGE);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);

    // normalise and store the rows this thread holds
    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + b * osb + h * osh;
    const int r0 = q0 + row;
    // EXT: sorted rows r0, r0 + 8 go back to the caller's order
    const int oa = EXT && r0 < sq ? plan.q_row(b, r0) : r0;
    const int ob_row = EXT && r0 + 8 < sq ? plan.q_row(b, r0 + 8) : r0 + 8;
    if (lse != nullptr && col == 0) {
      // m + log l per row, in natural units (m and l are base 2 here)
      float* lb = lse + (static_cast<long long>(b) * gridDim.y + h) * sq;
      if (r0 < sq) lb[oa] = (st.m0 + log2f(fmaxf(l0, 1e-30f))) * LN2;
      if (r0 + 8 < sq) lb[ob_row] = (st.m1 + log2f(fmaxf(l1, 1e-30f))) * LN2;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + oa * oss + 8 * j + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r0 + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + ob_row * oss + 8 * j
                                           + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                  acc[4 * j + 3] * inv1);
    }
  }
}

// A 4-D map over (D, S, heads, batch) of a bf16 tensor with element strides
// (batch, head, seq); boxes of CH columns x rows.
template <int D>
CUresult make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                  int batch, int heads, int seq, const long long* st,
                  int rows) {
  using C = Cfg<D>;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(seq),
                              cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {cuuint32_t(C::CH), cuuint32_t(rows), 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_map(encode, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                    const_cast<void*>(ptr), dims, strides, box, estride, swz);
}

// EXT with permutations: q, k and v are the caller's sorted copies
// (flash_pos_gather's), o the caller's tensor in index order.
template <int D, bool EXT>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kvh, int sq, int sk, int causal, int window,
           int q_offset, float scale, const long long* st, int n_q_tiles,
           float* lse, const PosPlan& plan, void*, float softcap,
           cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  if (make_map<D>(&tq, encode, q, b, h, sq, st, C::BQ) != CUDA_SUCCESS
      || make_map<D>(&tk, encode, k, b, kvh, sk, st + 3, BK) != CUDA_SUCCESS
      || make_map<D>(&tv, encode, v, b, kvh, sk, st + 6, BK) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D, EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_q_tiles, h, b);
  const float log2e = 1.4426950408889634f;
  flash_fwd_tc<D, EXT><<<grid, C::NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), h / kvh, sq, sk, causal,
      window, q_offset, scale * log2e, st[9], st[10], st[11], lse, plan,
      softcap > 0.f ? scale / softcap : 0.f, softcap * log2e);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// CUDA-core route (f32)
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per kv tile (one per lane)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

// Q and K tiles are stored with a row stride of D + PAD floats: float4
// aligned, and the eight lanes of a quarter-warp reading eight K rows at the
// same column hit disjoint banks.
constexpr int PAD = 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + PAD) + size_t(BK) * (D + PAD)
                          + size_t(BK) * D);
}

template <int D, bool EXT>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int group,
              int sq, int sk, int causal, int window, int q_offset,
              float scale, long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss, long long vsb,
              long long vsh, long long vss, long long osb, long long osh,
              long long oss, float* __restrict__ lse, PosPlan plan,
              float softcap) {
  constexpr int DP = D + PAD;
  constexpr int NC = (D + 31) / 32;  // accumulator columns per lane
  // EXT: the band [lo, hi) of sorted keys each of the block's rows keeps
  __shared__ int s_lo[EXT ? BQ : 1], s_hi[EXT ? BQ : 1];
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;
  float* ob = o + b * osb + h * osh;

  // EXT: rows and keys in sorted order, gathered here
  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < sq)
      x = qb[(EXT ? plan.q_row(b, q0 + r) : q0 + r) * qss + d] * scale;
    s_q[r * DP + d] = x;
  }
  if constexpr (EXT) {
    for (int i = tid; i < BQ; i += NTHREADS) {
      s_lo[i] = plan.lo(b)[q0 + i];
      s_hi[i] = plan.hi(b)[q0 + i];
    }
  }

  float m_run[RPW], l_run[RPW], acc[RPW][NC];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const KvRange rng = kv_range(q0, BQ, BK, sq, sk, causal, window, q_offset);
  const int q_lo = rng.q_lo;
  // EXT: the band of the block's sorted rows
  BandRange br{};
  if constexpr (EXT) br = band_range(plan, b, q0, BQ, BK);
  const int k_end = EXT ? br.end : rng.end;
  for (int k0 = EXT ? br.begin : rng.begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V (and, first, Q) are settled
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int j = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < sk) {
        const int kr = EXT ? plan.k_row(b, k0 + j) : k0 + j;
        kx = kb[kr * kss + d];
        vx = vb[kr * vss + d];
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

    // (EXT) soft cap, mask, online softmax update; p[i] is row i's
    // probability of key lane
    const int k_pos = k0 + lane;
    const bool in_range = k_pos < sk;
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      bool ok = in_range;
      if constexpr (EXT) {
        if (softcap > 0.f) s[i] = softcap * tanhf(s[i] / softcap);
        const int r = warp + NWARPS * i;
        ok = ok && k_pos >= s_lo[r] && k_pos < s_hi[r];
      } else {
        const int q_pos = q_lo + warp + NWARPS * i;
        if (causal) ok = ok && q_pos >= k_pos;
        if (window > 0) ok = ok && q_pos - k_pos < window;
      }
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
    const int rs = q0 + warp + NWARPS * i;
    if (rs >= sq) continue;
    const int r = EXT ? plan.q_row(b, rs) : rs;   // the caller's row
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * sq + r] =
          m_run[i] + logf(fmaxf(l_run[i], 1e-30f));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D) ob[r * oss + col] = acc[i][c] * inv;
    }
  }
}

template <int D, bool EXT>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kvh, int sq, int sk, int causal, int window,
           int q_offset, float scale, const long long* st, int n_q_tiles,
           float* lse, const PosPlan& plan, void*, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D, EXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_q_tiles, h, b);
  flash_fwd_f32<D, EXT><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), h / kvh, sq, sk,
      causal, window, q_offset, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], lse, plan, softcap);
  return cudaGetLastError();
}

}  // namespace f32


// ---------------------------------------------------------------------------
// backward: a tensor-core route (bf16) and a CUDA-core route (f32)
// ---------------------------------------------------------------------------
//
// No TPU kernel is replaced: the TPU package has no backward kernel (XLA
// differentiates its plain attention).  These give K4 its gradient,
// FA2-style, from q, k, v, o, the output's gradient do and the forward's lse:
//   P = exp(q k^T scale - lse)   (0 where the mask drops the pair)
//   delta_i = sum_d do_id o_id,  dS = P (do v^T - delta)
//   dv = P^T do,  dk = scale dS^T q,  dq = scale dS k.
// Each route runs three kernels: a row pass (delta), a dk/dv kernel, one
// block a (key tile, kv head, batch), which walks the query tiles of every
// head of its group that can see its keys and keeps dk and dv in f32
// registers, and a dq kernel, one block a (query tile, head, batch), which
// walks the kv tiles of the forward's schedule (kv_range).  Each tile
// recomputes P from lse.  Every output element is summed in one fixed order
// (the GQA sum over the group inside one block, heads then query tiles in
// order): no atomics, so two calls give the same bits.  Causal masks and
// windows as the forward's: queries at positions q_offset + i (i < Sq)
// against keys j < Sk, with q_offset + Sq <= Sk (the wrapper refuses the
// rest), so every row has a valid key.  Sq < Sk is the query chunk of the
// sequence-sharded attention of tensor parallelism (one rank's rows
// q_offset .. q_offset + Sq - 1 against every key).  A dk/dv block whose
// keys no query of the chunk sees (past its last row, or left of its
// window) walks no query tile and writes dk = dv = 0.
//
// Bound: five products over the kept pairs (q.k and do.v recomputed, P^T do,
// dS^T q, dS k: 10 D flops a pair); at qwen2-0.5b's shape (H 14, KVH 2,
// S 4096, D 64, causal) 7.5e10 flops, 0.076 ms at the bf16 tensor-core rate
// of 989 TFLOP/s, against 0.010 ms for the bytes.  So the products must run
// on the tensor cores, fed without stalls.
//
// Tensor-core route (bf16; namespace tcb).  The forward's machinery: 4-D TMA
// maps over (D, S, heads, batch), so the grouped strided layout is read in
// place, tiles swizzled for wgmma, kv_range / tile_masked, and WgmmaSS /
// WgmmaRS.  One producer warp (its first lane issues every copy) beside
// the consumer warpgroups, so that a consumer may hold 224 registers (a
// producer warpgroup would cap every thread at 168).
//   - flash_bwd_prep, one warp a row: delta, and lse times log2 e, into a
//     scratch padded to a multiple of 128 rows (zeros past S), so a tile's
//     rows are one 16-byte aligned bulk copy.
//   - flash_bwd_dkdv_tc: 64 keys a block; K and V loaded once; the query
//     tiles (64 rows of Q and dO, their lse and delta) stream through a
//     ring of STAGES = 2.  Two consumer warpgroups split the work so that
//     each holds one D-wide f32 accumulator (at D = 256, dk and dv together
//     would be 256 registers a thread): the first computes S^T = K Q^T
//     (wgmma, both operands in shared memory, K-major; keys as M), P^T,
//     hands P^T (f32, in its accumulator layout) to the second through one
//     of two exchange buffers guarded by mbarriers, and adds P^T dO to dv
//     (P^T rounded to bf16 A fragments in registers, dO read MN-major); the
//     second computes dP^T = V dO^T, dS^T = P^T (dP^T - delta) and adds
//     dS^T Q to dk.  Only tiles on the diagonal, on the window's edge or
//     past S take mask arithmetic (dkdv_masked).  At D = 256: K + V 64 KB,
//     the ring 129 KB, the exchange 32 KB, 226 KB of shared memory; nine
//     warps leave a thread 168 registers, of which dk or dv take 128, so a
//     warpgroup holds half of S^T (32 query columns) at a time there.  At
//     D <= 64 two blocks share an SM (96 registers a thread, 84 KB each),
//     so one block's waits on its products hide behind the other's work.
//   - The grid: one block a key tile and kv head has the most causal work
//     at the first key tiles, and at D = 256 with one kv head only 64
//     blocks.  So a group's heads are cut into runs (dkdv_splits in
//     tiles.py: about 264 blocks), one block each, which write f32 sums;
//     flash_bwd_sum adds them in run order, so the bits stay fixed.
//   - flash_bwd_dq_tc: the forward's block (64 query rows a consumer
//     warpgroup, two at D <= 128, one at D = 256); Q and dO loaded once, K
//     and V through a ring of STAGES = 2; S = Q K^T and dP = dO V^T issued
//     together, P then dS on the CUDA cores while dP runs, dS rounded to
//     bf16 fragments and dq += dS K with K read MN-major.
//
// CUDA-core route (f32; namespace bwd).  f32 everywhere (a bf16 or TF32
// tensor-core product cannot meet the f32 bar of 1e-4).  256 threads; warp w
// holds query rows w, w + 8, ... of a tile and lane j key j of a kv tile for
// the scores (Q, K, V and dO tiles are f32 in shared memory, padded as the
// f32 forward's, loaded synchronously).  BQ = 64 rows (32 at D = 256, for
// shared memory).  Every product is a scalar FMA with a shared-memory load.

namespace bwd {

constexpr int BK = 32;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 4;
constexpr int PS = BK + 1;   // row stride of the P and dS tiles (no conflicts)

// query rows of a tile (fewer at D = 256, for shared memory)
constexpr int bq_rows(int d) { return d == 256 ? 32 : 64; }

template <int D>
struct Shape {
  static constexpr int BQ = bq_rows(D);
  static constexpr int RPW = BQ / NWARPS;     // rows a warp in the scores
  static constexpr int DP = D + PAD;
  // dkdv: K, V, Q, dO, P, dS, lse, delta; dq: the same without P
  static constexpr size_t SMEM_KV =
      sizeof(float) * (2 * size_t(BK) * DP + 2 * size_t(BQ) * DP
                       + 2 * size_t(BQ) * PS + 2 * size_t(BQ));
  static constexpr size_t SMEM_Q =
      sizeof(float) * (2 * size_t(BK) * DP + 2 * size_t(BQ) * DP
                       + size_t(BQ) * PS + 2 * size_t(BQ));
};

// (batch, head, sequence) element strides of each tensor
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};


// Is (query row i at position q_offset + i, key kp) a kept pair of real
// rows and keys?
__device__ __forceinline__ bool pair_ok(int i, int kp, int sq, int sk,
                                        int q_offset, int causal,
                                        int window) {
  const int qp = q_offset + i;
  return i < sq && kp < sk && (!causal || qp >= kp)
         && (window <= 0 || qp - kp < window);
}

// delta = rowsum(do * o), one warp a row of [B, H, S]
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_delta(const float* __restrict__ o, const float* __restrict__ g,
                float* __restrict__ delta, int h, int s, int d,
                long long rows, Strides st) {
  const long long row =
      static_cast<long long>(blockIdx.x) * NWARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = static_cast<int>(row % s);
  const long long bh = row / s;
  const int hh = static_cast<int>(bh % h);
  const int bb = static_cast<int>(bh / h);
  const float* orow = o + bb * st.o[0] + hh * st.o[1] + i * st.o[2];
  const float* grow = g + bb * st.g[0] + hh * st.g[1] + i * st.g[2];
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(orow[c], grow[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Loads rows [r0, r0 + n) of a [S, D] slice (element stride ss) into a
// padded tile; rows past s are zero.  EXT: rows of the sorted order, row r
// of the slice being perm[r] (perm null: r).
template <int D, bool EXT = false>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int n, int s,
                                          const int* perm = nullptr) {
  for (int i = threadIdx.x; i < n * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    int row = r0 + r;
    if (EXT && perm != nullptr && row < s) row = __ldg(perm + row);
    dst[r * (D + PAD) + c] = r0 + r < s ? src[row * ss + c] : 0.f;
  }
}

// Scores and dP of the rows warp + NWARPS i of the query tile against key
// `lane` of the kv tile: s_ij = q_i . k_j, dp_ij = do_i . v_j.
template <int D, int RPW>
__device__ __forceinline__ void scores(const float* s_q, const float* s_g,
                                       const float* s_k, const float* s_v,
                                       float (&sc)[RPW], float (&dp)[RPW]) {
  constexpr int DP = D + PAD;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < RPW; ++i) sc[i] = dp[i] = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(s_k + lane * DP);
  const float4* v4 = reinterpret_cast<const float4*>(s_v + lane * DP);
#pragma unroll 2
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 kk = k4[d4], vv = v4[d4];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float4 qq =
          reinterpret_cast<const float4*>(s_q + (warp + NWARPS * i) * DP)[d4];
      const float4 gg =
          reinterpret_cast<const float4*>(s_g + (warp + NWARPS * i) * DP)[d4];
      sc[i] = fmaf(qq.x, kk.x, sc[i]);
      sc[i] = fmaf(qq.y, kk.y, sc[i]);
      sc[i] = fmaf(qq.z, kk.z, sc[i]);
      sc[i] = fmaf(qq.w, kk.w, sc[i]);
      dp[i] = fmaf(gg.x, vv.x, dp[i]);
      dp[i] = fmaf(gg.y, vv.y, dp[i]);
      dp[i] = fmaf(gg.z, vv.z, dp[i]);
      dp[i] = fmaf(gg.w, vv.w, dp[i]);
    }
  }
}

template <int D, bool EXT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int h,
               int group, int sq, int sk, int q_offset, int causal,
               int window, float scale, Strides st, PosPlan plan,
               float softcap) {
  using Sh = Shape<D>;
  constexpr int BQ = Sh::BQ, RPW = Sh::RPW, DP = Sh::DP;
  constexpr int NCOL = D / 8;     // columns of dk and dv a thread holds
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);
  float* s_v = s_k + BK * DP;
  float* s_q = s_v + BK * DP;
  float* s_g = s_q + BQ * DP;
  float* s_p = s_g + BQ * DP;
  float* s_ds = s_p + BQ * PS;
  float* s_lse = s_ds + BQ * PS;
  float* s_dl = s_lse + BQ;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // EXT: keys and rows in sorted order, gathered in the loads
  const int* kperm =
      EXT && plan.k_perm ? plan.k_perm + static_cast<long long>(b) * sk
                         : nullptr;
  const int* qperm =
      EXT && plan.q_perm ? plan.q_perm + static_cast<long long>(b) * sq
                         : nullptr;
  load_tile<D, EXT>(s_k, k + b * st.k[0] + kvh * st.k[1], st.k[2], k0, BK,
                    sk, kperm);
  load_tile<D, EXT>(s_v, v + b * st.v[0] + kvh * st.v[1], st.v[2], k0, BK,
                    sk, kperm);

  // this thread's share of dk and dv: key kj, columns c0 + 8 m
  const int kj = tid / 8, c0 = tid % 8;
  float acc_k[NCOL], acc_v[NCOL];
#pragma unroll
  for (int m = 0; m < NCOL; ++m) acc_k[m] = acc_v[m] = 0.f;

  // the query rows that can see a key of this tile (EXT: the band's and
  // the hull's query tiles, and the rows [qlo, qhi) keeping key `lane`);
  // none for keys past the chunk's last row or left of its window
  const int q_first = causal ? max(0, k0 - q_offset) : 0;
  const int q_begin = q_first / BQ * BQ;
  const int q_end =
      window > 0 ? min(sq, k0 + BK - 1 + window - q_offset) : sq;
  const int kp = k0 + lane;
  QRuns runs{};
  int qlo = 0, qhi = 0;
  if constexpr (EXT) {
    runs = band_runs(plan, b, k0, BK, BQ);
    qlo = plan.qlo(b)[kp];
    qhi = plan.qhi(b)[kp];
  }
  const int nq = EXT ? runs.count()
                     : q_first < q_end ? (q_end - q_begin + BQ - 1) / BQ
                                       : 0;
  for (int hg = 0; hg < group; ++hg) {
    const int hh = kvh * group + hg;
    const float* qb = q + b * st.q[0] + hh * st.q[1];
    const float* gb = g + b * st.g[0] + hh * st.g[1];
    const long long rb = (static_cast<long long>(b) * h + hh) * sq;
    for (int n = 0; n < nq; ++n) {
      const int q0 = EXT ? runs.at(n, BQ) : q_begin + n * BQ;
      __syncthreads();   // the previous tile is read (first: K, V loaded)
      load_tile<D, EXT>(s_q, qb, st.q[2], q0, BQ, sq, qperm);
      load_tile<D, EXT>(s_g, gb, st.g[2], q0, BQ, sq, qperm);
      for (int r = tid; r < BQ; r += NTHREADS) {
        const int row = EXT && qperm && q0 + r < sq ? __ldg(qperm + q0 + r)
                                                    : q0 + r;
        s_lse[r] = q0 + r < sq ? lse[rb + row] : 0.f;
        s_dl[r] = q0 + r < sq ? delta[rb + row] : 0.f;
      }
      __syncthreads();
      float sc[RPW], dp[RPW];
      scores<D, RPW>(s_q, s_g, s_k, s_v, sc, dp);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + NWARPS * i;
        if constexpr (EXT) {
          // a row without a kept key (lse at NEG_INF) averages v over
          // every key: P = 1 / S there, and dS = 0
          const bool ok = q0 + r < sq && kp < sk && q0 + r >= qlo
                          && q0 + r < qhi;
          float u = sc[i] * scale, f = 1.f;
          if (softcap > 0.f) {
            const float t = tanhf(u / softcap);
            u = softcap * t;
            f = 1.f - t * t;
          }
          float p = ok ? expf(u - s_lse[r]) : 0.f;
          s_ds[r * PS + lane] = ok ? p * (dp[i] - s_dl[r]) * f : 0.f;
          if (s_lse[r] < 0.5f * NEG_INF && kp < sk) p = 1.f / sk;
          s_p[r * PS + lane] = p;
        } else {
          const bool ok =
              pair_ok(q0 + r, kp, sq, sk, q_offset, causal, window);
          const float p = ok ? expf(sc[i] * scale - s_lse[r]) : 0.f;
          s_p[r * PS + lane] = p;
          s_ds[r * PS + lane] = ok ? p * (dp[i] - s_dl[r]) : 0.f;
        }
      }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q over the tile's rows, in row order
      for (int r = 0; r < BQ; ++r) {
        const float pr = s_p[r * PS + kj], dsr = s_ds[r * PS + kj];
        const float* qr = s_q + r * DP;
        const float* gr = s_g + r * DP;
#pragma unroll
        for (int m = 0; m < NCOL; ++m) {
          acc_v[m] = fmaf(pr, gr[c0 + 8 * m], acc_v[m]);
          acc_k[m] = fmaf(dsr, qr[c0 + 8 * m], acc_k[m]);
        }
      }
    }
  }
  if (k0 + kj < sk) {
    const int kr = EXT ? plan.k_row(b, k0 + kj) : k0 + kj;   // caller's key
    float* dkr = dk + b * st.dk[0] + kvh * st.dk[1] + kr * st.dk[2];
    float* dvr = dv + b * st.dv[0] + kvh * st.dv[1] + kr * st.dv[2];
#pragma unroll
    for (int m = 0; m < NCOL; ++m) {
      dkr[c0 + 8 * m] = acc_k[m] * scale;
      dvr[c0 + 8 * m] = acc_v[m];
    }
  }
}

template <int D, bool EXT>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, int h, int group, int sq, int sk,
             int q_offset, int causal, int window, float scale, Strides st,
             PosPlan plan, float softcap) {
  using Sh = Shape<D>;
  constexpr int BQ = Sh::BQ, RPW = Sh::RPW, DP = Sh::DP;
  constexpr int TPR = NTHREADS / BQ;   // threads a row of dq
  constexpr int NCOL = D / TPR;        // columns of dq a thread holds
  // EXT: the band [lo, hi) of sorted keys each of the block's rows keeps
  __shared__ int s_lo[EXT ? BQ : 1], s_hi[EXT ? BQ : 1];
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);
  float* s_v = s_k + BK * DP;
  float* s_q = s_v + BK * DP;
  float* s_g = s_q + BQ * DP;
  float* s_ds = s_g + BQ * DP;
  float* s_lse = s_ds + BQ * PS;
  float* s_dl = s_lse + BQ;

  // the longest query tiles (most kv tiles) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = hh / group;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // EXT: rows and keys in sorted order, gathered in the loads
  const int* kperm =
      EXT && plan.k_perm ? plan.k_perm + static_cast<long long>(b) * sk
                         : nullptr;
  const int* qperm =
      EXT && plan.q_perm ? plan.q_perm + static_cast<long long>(b) * sq
                         : nullptr;
  load_tile<D, EXT>(s_q, q + b * st.q[0] + hh * st.q[1], st.q[2], q0, BQ, sq,
                    qperm);
  load_tile<D, EXT>(s_g, g + b * st.g[0] + hh * st.g[1], st.g[2], q0, BQ, sq,
                    qperm);
  const long long rb = (static_cast<long long>(b) * h + hh) * sq;
  for (int r = tid; r < BQ; r += NTHREADS) {
    const int row = EXT && qperm && q0 + r < sq ? __ldg(qperm + q0 + r)
                                                : q0 + r;
    s_lse[r] = q0 + r < sq ? lse[rb + row] : 0.f;
    s_dl[r] = q0 + r < sq ? delta[rb + row] : 0.f;
    if constexpr (EXT) {
      s_lo[r] = plan.lo(b)[q0 + r];
      s_hi[r] = plan.hi(b)[q0 + r];
    }
  }
  const float* kb = k + b * st.k[0] + kvh * st.k[1];
  const float* vb = v + b * st.v[0] + kvh * st.v[1];

  // this thread's share of dq: row qr, columns c0 + TPR m
  const int qr = tid / TPR, c0 = tid % TPR;
  float acc[NCOL];
#pragma unroll
  for (int m = 0; m < NCOL; ++m) acc[m] = 0.f;

  const KvRange rng =
      kv_range(q0, BQ, BK, sq, sk, causal, window, q_offset);
  BandRange br{};
  if constexpr (EXT) br = band_range(plan, b, q0, BQ, BK);
  for (int k0 = EXT ? br.begin : rng.begin; k0 < (EXT ? br.end : rng.end);
       k0 += BK) {
    __syncthreads();   // the previous tile is read (first: Q, dO loaded)
    load_tile<D, EXT>(s_k, kb, st.k[2], k0, BK, sk, kperm);
    load_tile<D, EXT>(s_v, vb, st.v[2], k0, BK, sk, kperm);
    __syncthreads();
    float sc[RPW], dp[RPW];
    scores<D, RPW>(s_q, s_g, s_k, s_v, sc, dp);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NWARPS * i;
      if constexpr (EXT) {
        const bool ok = q0 + r < sq && k0 + lane < sk
                        && k0 + lane >= s_lo[r] && k0 + lane < s_hi[r];
        float u = sc[i] * scale, f = 1.f;
        if (softcap > 0.f) {
          const float t = tanhf(u / softcap);
          u = softcap * t;
          f = 1.f - t * t;
        }
        s_ds[r * PS + lane] =
            ok ? expf(u - s_lse[r]) * (dp[i] - s_dl[r]) * f : 0.f;
      } else {
        const bool ok =
            pair_ok(q0 + r, k0 + lane, sq, sk, q_offset, causal, window);
        const float p = ok ? expf(sc[i] * scale - s_lse[r]) : 0.f;
        s_ds[r * PS + lane] = ok ? p * (dp[i] - s_dl[r]) : 0.f;
      }
    }
    __syncthreads();
    // dq += dS K over the tile's keys, in key order
    for (int j = 0; j < BK; ++j) {
      const float dsv = s_ds[qr * PS + j];
      const float* kr = s_k + j * DP;
#pragma unroll
      for (int m = 0; m < NCOL; ++m)
        acc[m] = fmaf(dsv, kr[c0 + TPR * m], acc[m]);
    }
  }
  if (q0 + qr < sq) {
    const int row = EXT ? plan.q_row(b, q0 + qr) : q0 + qr;   // caller's row
    float* dqr = dq + b * st.dq[0] + hh * st.dq[1] + row * st.dq[2];
#pragma unroll
    for (int m = 0; m < NCOL; ++m) dqr[c0 + TPR * m] = acc[m] * scale;
  }
}

template <int D, bool EXT>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int b, int h, int kvh, int sq, int sk, int q_offset,
           int causal, int window, float scale, const Strides& st,
           const PosPlan& plan, void*, float softcap, cudaStream_t stream) {
  using Sh = Shape<D>;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tg = static_cast<const float*>(g);
  const long long rows = static_cast<long long>(b) * h * sq;
  flash_bwd_delta<<<static_cast<unsigned>((rows + NWARPS - 1) / NWARPS),
                       NTHREADS, 0, stream>>>(
      static_cast<const float*>(o), tg, delta, h, sq, D, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<D, EXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::SMEM_KV));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<D, EXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::SMEM_Q));
  if (err != cudaSuccess) return err;
  const int group = h / kvh;
  flash_bwd_dkdv<D, EXT><<<dim3((sk + BK - 1) / BK, kvh, b), NTHREADS,
                              Sh::SMEM_KV, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), h, group, sq, sk, q_offset, causal, window,
      scale, st, plan, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<D, EXT><<<dim3((sq + Sh::BQ - 1) / Sh::BQ, h, b), NTHREADS,
                            Sh::SMEM_Q, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<float*>(dq), h, group, sq, sk,
      q_offset, causal, window, scale, st, plan, softcap);
  return cudaGetLastError();
}

typedef int (*Launch)(const void*, const void*, const void*, const void*,
                      const void*, const float*, float*, void*, void*, void*,
                      int, int, int, int, int, int, int, int, float,
                      const Strides&, const PosPlan&, void*, float,
                      cudaStream_t);

template <bool EXT>
Launch pick(int d) {
  switch (d) {
    case 16: return launch<16, EXT>;
    case 32: return launch<32, EXT>;
    case 64: return launch<64, EXT>;
    case 128: return launch<128, EXT>;
    case 256: return launch<256, EXT>;
  }
  return nullptr;
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// backward, tensor-core route (bf16)
// ---------------------------------------------------------------------------

namespace tcb {

using namespace hopper;
using tc::BK;
using tc::Cfg;
using tc::STAGES;
using tc::ex2;
using tc::fence_regs;
using tc::issue_pv;
using tc::issue_ss;
using tc::make_desc;
using tc::pack_p;
using tc::tanh_fast;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ_KV = 64;       // query rows of a tile the dk/dv kernel walks
constexpr int PAD_ROWS = 128;   // rows of the lse / delta scratch, padded
constexpr int PRODUCER = 32;    // one producer warp, after the consumers

template <int D>
struct Bwd {
  using C = Cfg<D>;
  static constexpr int TILE = C::KV_BYTES;    // a [64, D] tile
  static constexpr int BOX = C::KV_BOX;       // its boxes' stride
  static constexpr int VEC = BQ_KV * 4;       // lse or delta of a query tile
  static constexpr int EX = 32 * 128 * 4;     // one P^T exchange buffer
  // query columns of S^T a dk/dv warpgroup holds at once: half the tile at
  // D = 256, where the D-wide accumulator takes 128 of its 168 registers
  static constexpr int QN = D == 256 ? 32 : 64;
  // dk/dv blocks an SM holds: two at D <= 64, where 96 registers a thread
  // do without spilling and two blocks' shared memory fits (the dq kernel
  // spills at 96, so it keeps one)
  static constexpr int KV_MIN_BLOCKS = D <= 64 ? 2 : 1;
  // dk/dv: K, V; a ring of (Q, dO, lse, delta); two exchange buffers
  static constexpr int KV_THREADS = 256 + PRODUCER;
  static constexpr size_t KV_SMEM =
      1024 + 2 * TILE + STAGES * (2 * TILE + 2 * VEC) + 2 * EX;
  // dq: Q and dO of the block's rows; a ring of (K, V)
  static constexpr int Q_THREADS = 128 * C::NC + PRODUCER;
  static constexpr size_t Q_SMEM = 1024 + 2 * C::Q_BYTES + STAGES * 2 * TILE;
  static_assert(KV_SMEM <= 232448 - 128 && Q_SMEM <= 232448 - 128,
                "shared memory a block may take");
};

// The query rows [begin, end) that can see a key of the tile at k0 (tiles
// of BQ_KV rows from begin on; row i at position q_offset + i).  Empty
// (end <= begin) for keys past the chunk's last row or left of its window.
struct QRange {
  int begin, end;
};

__device__ __forceinline__ QRange dkdv_range(int k0, int sq, int q_offset,
                                             int causal, int window) {
  QRange r;
  const int first = causal ? max(0, k0 - q_offset) : 0;
  r.begin = first / BQ_KV * BQ_KV;
  r.end = window > 0 ? min(sq, k0 + BK - 1 + window - q_offset) : sq;
  if (first >= r.end) r.end = r.begin;   // no row sees these keys
  return r;
}

// Does the (key tile k0, query tile q0) pair hold a pair the mask drops, or
// a key or query past the end?
__device__ __forceinline__ bool dkdv_masked(int k0, int q0, int sq, int sk,
                                            int q_offset, int causal,
                                            int window) {
  return !(q0 + BQ_KV <= sq && k0 + BK <= sk
           && (!causal || q_offset + q0 >= k0 + BK - 1)
           && (window <= 0 || q_offset + q0 + BQ_KV - 1 - k0 < window));
}

// Is (query row i at position q_offset + i, key kp) a kept pair of real
// rows and keys?
__device__ __forceinline__ bool kept(int i, int kp, int sq, int sk,
                                     int q_offset, int causal, int window) {
  const int qp = q_offset + i;
  return i < sq && kp < sk && (!causal || qp >= kp)
         && (window <= 0 || qp - kp < window);
}

// delta = rowsum(do * o) and lse log2 e, one warp a row of [B, H, sp]
// (zeros in the rows past s, the Sq query rows).  EXT: row i of the sorted
// order, read at the caller's row plan.q_row(i); with a permutation dO's
// row is also copied to row i of gs ([B, H, S, d], contiguous).
template <bool EXT>
__global__ void __launch_bounds__(256)
flash_bwd_prep(const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ g,
               const float* __restrict__ lse, float* __restrict__ lse2,
               float* __restrict__ delta, int h, int s, int sp, int d,
               long long rows, bwd::Strides st, PosPlan plan,
               __nv_bfloat16* __restrict__ gs) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = static_cast<int>(row % sp);
  const long long bh = row / sp;
  const int bb = static_cast<int>(bh / h);
  const int src = EXT && i < s ? plan.q_row(bb, i) : i;
  float acc = 0.f;
  if (i < s) {
    const int hh = static_cast<int>(bh % h);
    const __nv_bfloat16* orow =
        o + bb * st.o[0] + hh * st.o[1] + src * st.o[2];
    const __nv_bfloat16* grow =
        g + bb * st.g[0] + hh * st.g[1] + src * st.g[2];
    __nv_bfloat16* srow = EXT && plan.q_perm != nullptr
                              ? gs + (bh * s + i) * d : nullptr;
    for (int c = lane; c < d; c += 32) {
      acc = fmaf(__bfloat162float(orow[c]), __bfloat162float(grow[c]), acc);
      if (EXT && srow != nullptr) srow[c] = grow[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
  }
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = i < s ? lse[bh * s + src] * LOG2E : 0.f;
  }
}

// One block a (key tile of BK keys, kv head, batch, part of the group):
// warpgroup 0 computes S^T, P^T and dv, warpgroup 1 dP^T, dS^T and dk, a
// query tile QN columns at a time; warp 8 loads.  With splits > 1 the
// group's heads are cut into `splits` runs of consecutive heads, one a
// block, and each block writes its f32 sums into `part`
// ([splits, 2 (dk, dv), B, KVH, Sk, D]) for flash_bwd_sum; else it writes
// dk and dv.  A block whose keys no query row sees walks no tile and
// writes zeros.
template <int D, bool EXT>
__global__ void __launch_bounds__(Bwd<D>::KV_THREADS, Bwd<D>::KV_MIN_BLOCKS)
flash_bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tg,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                  int h, int group, int splits, int sq, int sk,
                  int q_offset, int sp, int causal, int window,
                  float scale_log2, float scale, bwd::Strides st,
                  PosPlan plan, float cap_in, float cap_out) {
  using C = Cfg<D>;
  using G = Bwd<D>;
  constexpr int QN = G::QN;
  constexpr int PARTS = BQ_KV / QN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_bar, full[STAGES], empty[STAGES];
  // P^T from warpgroup 0 to warpgroup 1, double-buffered
  __shared__ __align__(8) uint64_t ex_full[2], ex_empty[2];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_k = base;
  uint8_t* s_v = s_k + G::TILE;
  uint8_t* s_ring = s_v + G::TILE;             // a stage: Q, then dO
  float* s_vec = reinterpret_cast<float*>(s_ring + STAGES * 2 * G::TILE);
  float* s_ex = s_vec + STAGES * 2 * BQ_KV;    // a stage: lse, then delta

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int per = (group + splits - 1) / splits;
  const int hg0 = split * per;
  const int n_heads = min(group, hg0 + per) - hg0;
  const QRange qr = dkdv_range(k0, sq, q_offset, causal, window);
  // EXT: the query tiles of the band and the hull (qr unused)
  QRuns runs{};
  if constexpr (EXT) runs = band_runs(plan, b, k0, BK, BQ_KV);
  const int nq = EXT ? runs.count() : (qr.end - qr.begin + BQ_KV - 1) / BQ_KV;
  const int n_tiles = nq * n_heads;   // heads in order, then query tiles
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(&kv_bar, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    for (int e = 0; e < 2; ++e) {
      mbar_init(&ex_full[e], 128);
      mbar_init(&ex_empty[e], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == 256) {
      mbar_expect_tx(&kv_bar, 2 * G::TILE);
#pragma unroll
      for (int bx = 0; bx < C::NB; ++bx) {
        tma_load_4d(s_k + bx * G::BOX, &tk, &kv_bar, bx * C::CH, k0, kvh, b);
        tma_load_4d(s_v + bx * G::BOX, &tv, &kv_bar, bx * C::CH, k0, kvh, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int hh = kvh * group + hg0 + n / nq;
        const int q0 = EXT ? runs.at(n % nq, BQ_KV)
                           : qr.begin + (n % nq) * BQ_KV;
        const int i = n % STAGES;
        if (n >= STAGES) mbar_wait(&empty[i], (n / STAGES - 1) & 1);
        mbar_expect_tx(&full[i], 2 * G::TILE + 2 * G::VEC);
        uint8_t* sq = s_ring + i * 2 * G::TILE;
#pragma unroll
        for (int bx = 0; bx < C::NB; ++bx) {
          tma_load_4d(sq + bx * G::BOX, &tq, &full[i], bx * C::CH, q0, hh, b);
          tma_load_4d(sq + G::TILE + bx * G::BOX, &tg, &full[i], bx * C::CH,
                      q0, hh, b);
        }
        const long long row = (static_cast<long long>(b) * h + hh) * sp + q0;
        bulk_load(s_vec + i * 2 * BQ_KV, lse2 + row, G::VEC, &full[i]);
        bulk_load(s_vec + i * 2 * BQ_KV + BQ_KV, delta + row, G::VEC,
                  &full[i]);
      }
    }
    return;
  }

  // ---- consumers: a thread holds key rows kr, kr + 8 of the tile and
  // query columns 8 j + col, + 1 of a QN-column part of S^T / dP^T ----
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int kr = 16 * (tid / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  constexpr uint64_t STAGE = (2 * G::TILE) >> 4;
  constexpr uint64_t PART = (QN * C::SW) >> 4;   // QN rows of a tile on
  const uint32_t ring = smem_u32(s_ring);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[QN / 2];
  uint32_t pa[QN / 4];
  mbar_wait(&kv_bar, 0);

  if (wg == 0) {
    // S^T = K Q^T (both K-major), P^T, dv += P^T dO (dO MN-major)
    const uint64_t dka = make_desc(smem_u32(s_k), 16, 8 * C::SW, C::LAYOUT);
    const uint64_t dqb = make_desc(ring, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t dgmn =
        make_desc(ring + G::TILE, G::BOX, 8 * C::SW, C::LAYOUT);
    // EXT: the sorted query rows [qlo, qhi) keeping this thread's keys
    // kr (a) and kr + 8 (b)
    int qloa = 0, qhia = 0, qlob = 0, qhib = 0;
    if constexpr (EXT) {
      const int* lo = plan.qlo(b) + k0 + kr;
      const int* hi = plan.qhi(b) + k0 + kr;
      qloa = lo[0];
      qhia = hi[0];
      qlob = lo[8];
      qhib = hi[8];
    }
    for (int n = 0; n < n_tiles; ++n) {
      const int i = n % STAGES;
      const int q0 = EXT ? runs.at(n % nq, BQ_KV)
                         : qr.begin + (n % nq) * BQ_KV;
      const bool masked =
          EXT ? band_tile_masked(plan, b, q0, BQ_KV, k0, BK)
              : dkdv_masked(k0, q0, sq, sk, q_offset, causal, window);
      mbar_wait(&full[i], (n / STAGES) & 1);
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt) {
        fence_regs(sc);
        wg_fence();
        issue_ss<D, G::BOX, G::BOX, QN>(sc, dka, dqb + i * STAGE + pt * PART);
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        const int c0 = pt * QN;           // first column of the part
        const float* ls = s_vec + i * 2 * BQ_KV + c0;
        const int xi = n * PARTS + pt;
        const int xb = xi & 1;
        if constexpr (EXT) {
          // P^T for dv stays in sc; P^T (1 - t^2), 0 where the pair is
          // dropped, goes straight to warpgroup 1 for dS^T.  A query
          // without a kept key (lse at NEG_INF) takes P = 1 / S from
          // every key and gives dS = 0.
          if (xi >= 2) mbar_wait(&ex_empty[xb], ((xi >> 1) - 1) & 1);
          float* ex = s_ex + xb * 32 * 128 + tid;
#pragma unroll
          for (int j = 0; j < QN / 8; ++j) {
            const float2 l =
                *reinterpret_cast<const float2*>(ls + 8 * j + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = sc[4 * j + e];
              const float lj = (e & 1) ? l.y : l.x;
              float f = 1.f;
              if (cap_out != 0.f) {
                const float t = tanh_fast(x * cap_in);
                x = ex2(cap_out * t - lj);
                f = 1.f - t * t;
              } else {
                x = ex2(x * scale_log2 - lj);
              }
              if (masked) {
                const int qq = q0 + c0 + 8 * j + col + (e & 1);
                const int kk = k0 + kr + ((e & 2) ? 8 : 0);
                if (!(qq < sq && kk < sk && qq >= ((e & 2) ? qlob : qloa)
                      && qq < ((e & 2) ? qhib : qhia)))
                  x = 0.f;
                ex[(4 * j + e) * 128] = x * f;
                if (lj < 0.5f * NEG_INF && kk < sk) x = 1.f / sk;
              } else {
                ex[(4 * j + e) * 128] = x * f;
              }
            }
          }
          mbar_arrive(&ex_full[xb]);
        } else {
#pragma unroll
          for (int j = 0; j < QN / 8; ++j) {
            const float2 l =
                *reinterpret_cast<const float2*>(ls + 8 * j + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = sc[4 * j + e];
              x = ex2(x * scale_log2 - ((e & 1) ? l.y : l.x));
              if (masked && !kept(q0 + c0 + 8 * j + col + (e & 1),
                                  k0 + kr + ((e & 2) ? 8 : 0), sq, sk,
                                  q_offset, causal, window))
                x = 0.f;
            }
          }
          // hand P^T to warpgroup 1: thread t's values go to thread t
          if (xi >= 2) mbar_wait(&ex_empty[xb], ((xi >> 1) - 1) & 1);
          float* ex = s_ex + xb * 32 * 128 + tid;
#pragma unroll
          for (int x = 0; x < QN / 2; ++x) ex[x * 128] = sc[x];
          mbar_arrive(&ex_full[xb]);
        }
        pack_p(sc, pa);
        fence_regs(acc);
        fence_regs(pa);
        wg_fence();
        issue_pv<D, QN / 16>(acc, pa, dgmn + i * STAGE + pt * PART);
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
      }
      if (lane == 0) mbar_arrive(&empty[i]);
    }
  } else {
    // dP^T = V dO^T (both K-major), dS^T, dk += dS^T Q (Q MN-major)
    const uint64_t dva = make_desc(smem_u32(s_v), 16, 8 * C::SW, C::LAYOUT);
    const uint64_t dgb = make_desc(ring + G::TILE, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t dqmn = make_desc(ring, G::BOX, 8 * C::SW, C::LAYOUT);
    for (int n = 0; n < n_tiles; ++n) {
      const int i = n % STAGES;
      mbar_wait(&full[i], (n / STAGES) & 1);
#pragma unroll
      for (int pt = 0; pt < PARTS; ++pt) {
        fence_regs(sc);
        wg_fence();
        issue_ss<D, G::BOX, G::BOX, QN>(sc, dva, dgb + i * STAGE + pt * PART);
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);
        const float* dl = s_vec + i * 2 * BQ_KV + BQ_KV + pt * QN;
        const int xi = n * PARTS + pt;
        const int xb = xi & 1;
        mbar_wait(&ex_full[xb], (xi >> 1) & 1);
        const float* ex = s_ex + xb * 32 * 128 + tid;
#pragma unroll
        for (int j = 0; j < QN / 8; ++j) {
          const float2 dd =
              *reinterpret_cast<const float2*>(dl + 8 * j + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = ex[(4 * j + e) * 128]
                            * (sc[4 * j + e] - ((e & 1) ? dd.y : dd.x));
        }
        mbar_arrive(&ex_empty[xb]);
        pack_p(sc, pa);
        fence_regs(acc);
        fence_regs(pa);
        wg_fence();
        issue_pv<D, QN / 16>(acc, pa, dqmn + i * STAGE + pt * PART);
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
      }
      if (lane == 0) mbar_arrive(&empty[i]);
    }
  }

  // dv (warpgroup 0) or scale dk (warpgroup 1), the keys below Sk: in the
  // dtype, or f32 sums of this block's heads into `part`; EXT: sorted keys
  // r0, r0 + 8 go back to the caller's rows oa, ob_row
  const float mul = wg == 0 ? 1.f : scale;
  const int r0 = k0 + kr;
  const int oa = EXT && r0 < sk ? plan.k_row(b, r0) : r0;
  const int ob_row = EXT && r0 + 8 < sk ? plan.k_row(b, r0 + 8) : r0 + 8;
  if (splits > 1) {
    const int nb = gridDim.z / splits;
    const int which = 1 - wg;        // 0 dk, 1 dv
    float* out = part + (((static_cast<long long>(split) * 2 + which) * nb + b)
                         * gridDim.y + kvh) * sk * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < sk)
        *reinterpret_cast<float2*>(out + oa * D + 8 * j + col) =
            make_float2(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (r0 + 8 < sk)
        *reinterpret_cast<float2*>(out + ob_row * D + 8 * j + col) =
            make_float2(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
    return;
  }
  const long long os = wg == 0 ? st.dv[2] : st.dk[2];
  __nv_bfloat16* out = wg == 0 ? dv + b * st.dv[0] + kvh * st.dv[1]
                               : dk + b * st.dk[0] + kvh * st.dk[1];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < sk)
      *reinterpret_cast<__nv_bfloat162*>(out + oa * os + 8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r0 + 8 < sk)
      *reinterpret_cast<__nv_bfloat162*>(out + ob_row * os + 8 * j
                                         + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// dk and dv from the dk/dv blocks' partial sums: part[0] + part[1] + ...
// in that order, rounded to bf16; one thread a column pair of a row.
__global__ void __launch_bounds__(256)
flash_bwd_sum(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int splits, int kvh, int s,
              int d, long long pairs, bwd::Strides st) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= pairs) return;        // pairs = 2 (dk, dv) x B x KVH x S x D / 2
  const long long per = pairs / 2;   // column pairs of dk (or dv)
  const int which = static_cast<int>(i / per);   // 0 dk, 1 dv
  const long long e = 2 * (i % per);             // element of [B, KVH, S, D]
  const int c = static_cast<int>(e % d);
  const long long r = e / d;
  const int row = static_cast<int>(r % s);
  const int hh = static_cast<int>((r / s) % kvh);
  const int bb = static_cast<int>(r / s / kvh);
  float2 sum = make_float2(0.f, 0.f);
  for (int k = 0; k < splits; ++k) {
    const float2 x = *reinterpret_cast<const float2*>(
        part + (static_cast<long long>(k) * 2 + which) * 2 * per + e);
    sum.x += x.x;
    sum.y += x.y;
  }
  __nv_bfloat16* out =
      which == 0 ? dk + bb * st.dk[0] + hh * st.dk[1] + row * st.dk[2]
                 : dv + bb * st.dv[0] + hh * st.dv[1] + row * st.dv[2];
  *reinterpret_cast<__nv_bfloat162*>(out + c) =
      __floats2bfloat162_rn(sum.x, sum.y);
}

// One block a (query tile, head, batch): consumer warpgroup w owns query
// rows q0 + 64 w .. + 63; the last warp loads.
template <int D, bool EXT>
__global__ void __launch_bounds__(Bwd<D>::Q_THREADS, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tg,
                const float* __restrict__ lse2,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int group, int sq, int sk,
                int q_offset, int sp, int causal, int window,
                float scale_log2, float scale, long long dsb, long long dsh,
                long long dss, PosPlan plan, float cap_in, float cap_out) {
  using C = Cfg<D>;
  using G = Bwd<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_bar, full[STAGES], empty[STAGES];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = base;
  uint8_t* s_g = s_q + C::Q_BYTES;
  uint8_t* s_k = s_g + C::Q_BYTES;
  uint8_t* s_v = s_k + STAGES * G::TILE;

  // the longest query tiles (most kv tiles) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const KvRange r = kv_range(q0, BQ, BK, sq, sk, causal, window, q_offset);
  // EXT: the band of the block's sorted rows
  BandRange br{};
  if constexpr (EXT) br = band_range(plan, b, q0, BQ, BK);
  const int k_begin = EXT ? br.begin : r.begin;
  const int n_tiles = EXT ? (br.end - br.begin + BK - 1) / BK
                          : (r.end - r.begin + BK - 1) / BK;
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(&q_bar, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], C::CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == C::NC) {
    // ---- producer ----
    if (threadIdx.x == 128 * C::NC) {
      const int kvh = h / group;
      mbar_expect_tx(&q_bar, 2 * C::Q_BYTES);
#pragma unroll
      for (int bx = 0; bx < C::NB; ++bx) {
        tma_load_4d(s_q + bx * C::Q_BOX, &tq, &q_bar, bx * C::CH, q0, h, b);
        tma_load_4d(s_g + bx * C::Q_BOX, &tg, &q_bar, bx * C::CH, q0, h, b);
      }
      int k0 = k_begin;
      for (int t = 0; t < n_tiles; ++t) {
        const int i = t % STAGES;
        if (t > 0) k0 += BK;
        if (t >= STAGES) mbar_wait(&empty[i], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[i], 2 * G::TILE);
#pragma unroll
        for (int bx = 0; bx < C::NB; ++bx) {
          tma_load_4d(s_k + i * G::TILE + bx * G::BOX, &tk, &full[i],
                      bx * C::CH, k0, kvh, b);
          tma_load_4d(s_v + i * G::TILE + bx * G::BOX, &tv, &full[i],
                      bx * C::CH, k0, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: a thread holds query rows row, row + 8 and key columns
  // 8 j + col, + 1 of S / dP ----
  const int w = wg;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = 64 * w + 16 * (tid / 32) + lane / 4;
  const int col = 2 * (lane % 4);
  const int qp0 = q0 + row;
  const long long rb = (static_cast<long long>(b) * gridDim.y + h) * sp + qp0;
  const float l0 = lse2[rb], l1 = lse2[rb + 8];
  const float d0 = delta[rb], d1 = delta[rb + 8];
  const uint64_t dqa =
      make_desc(smem_u32(s_q) + 64 * w * C::SW, 16, 8 * C::SW, C::LAYOUT);
  const uint64_t dga =
      make_desc(smem_u32(s_g) + 64 * w * C::SW, 16, 8 * C::SW, C::LAYOUT);
  const uint64_t dkb = make_desc(smem_u32(s_k), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t dvb = make_desc(smem_u32(s_v), 16, 8 * C::SW, C::LAYOUT);
  const uint64_t dkmn =
      make_desc(smem_u32(s_k), G::BOX, 8 * C::SW, C::LAYOUT);
  constexpr uint64_t STAGE = G::TILE >> 4;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2], dp[BK / 2];
  uint32_t pa[BK / 4];
  // EXT: the band [lo, hi) of sorted keys this thread's rows keep (a: row,
  // b: row + 8)
  int loa = 0, hia = 0, lob = 0, hib = 0;
  if constexpr (EXT) {
    const int* lo = plan.lo(b) + qp0;
    const int* hi = plan.hi(b) + qp0;
    loa = lo[0];
    hia = hi[0];
    lob = lo[8];
    hib = hi[8];
  }
  mbar_wait(&q_bar, 0);
  int k0 = k_begin;
  for (int t = 0; t < n_tiles; ++t) {
    const int i = t % STAGES;
    if (t > 0) k0 += BK;
    mbar_wait(&full[i], (t / STAGES) & 1);
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
    issue_ss<D, C::Q_BOX, G::BOX>(sc, dqa, dkb + i * STAGE);
    wg_commit();
    issue_ss<D, C::Q_BOX, G::BOX>(dp, dga, dvb + i * STAGE);
    wg_commit();
    wg_wait<1>();                 // S; P on the CUDA cores while dP runs
    fence_regs(sc);
    if constexpr (EXT) {
      // P (1 - t^2) of the soft cap: dq needs P only within dS
      const bool masked = band_masked(br, k0, BK, sk);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[4 * j + e];
          const float l = (e & 2) ? l1 : l0;
          if (cap_out != 0.f) {
            const float th = tanh_fast(x * cap_in);
            x = ex2(cap_out * th - l) * (1.f - th * th);
          } else {
            x = ex2(x * scale_log2 - l);
          }
          const int kk = k0 + 8 * j + col + (e & 1);
          if (masked && !(qp0 + ((e & 2) ? 8 : 0) < sq && kk < sk
                          && kk >= ((e & 2) ? lob : loa)
                          && kk < ((e & 2) ? hib : hia)))
            x = 0.f;
        }
      }
    } else {
      const bool masked = tile_masked(r, k0, BK, sk, causal, window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[4 * j + e];
          x = ex2(x * scale_log2 - ((e & 2) ? l1 : l0));
          if (masked && !kept(qp0 + ((e & 2) ? 8 : 0),
                              k0 + 8 * j + col + (e & 1), sq, sk, q_offset,
                              causal, window))
            x = 0.f;
        }
      }
    }
    wg_wait<0>();                 // dP
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] *= dp[4 * j] - d0;
      sc[4 * j + 1] *= dp[4 * j + 1] - d0;
      sc[4 * j + 2] *= dp[4 * j + 2] - d1;
      sc[4 * j + 3] *= dp[4 * j + 3] - d1;
    }
    pack_p(sc, pa);
    fence_regs(acc);
    fence_regs(pa);
    wg_fence();
    issue_pv<D>(acc, pa, dkmn + i * STAGE);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[i]);
  }

  __nv_bfloat16* ob = dq + b * dsb + h * dsh;
  // EXT: sorted rows qp0, qp0 + 8 go back to the caller's rows
  const int oa = EXT && qp0 < sq ? plan.q_row(b, qp0) : qp0;
  const int ob_row = EXT && qp0 + 8 < sq ? plan.q_row(b, qp0 + 8) : qp0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (qp0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + oa * dss + 8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (qp0 + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + ob_row * dss + 8 * j
                                         + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                acc[4 * j + 3] * scale);
  }
}

// EXT with permutations: q, k and v are the caller's sorted copies
// (flash_pos_gather's); o, g and lse are in index order, and
// flash_bwd_prep writes a sorted copy of g into `sorted` ([B, H, S, D]
// bf16), which the maps then read.
template <int D, bool EXT>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, int b, int h, int kvh, int sq, int sk,
           int q_offset, int sp, int splits, int causal, int window,
           float scale,
           const bwd::Strides& st, const PosPlan& plan, void* sorted,
           float softcap, cudaStream_t stream) {
  using C = Cfg<D>;
  using G = Bwd<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const long long rows = static_cast<long long>(b) * h * sp;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  float* part = splits > 1 ? scratch + 2 * rows : nullptr;
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  // the dO the maps read, and its strides
  const void* mg = g;
  long long sg_[3];
  memcpy(sg_, st.g, sizeof(sg_));
  __nv_bfloat16* gs = nullptr;
  if (EXT && plan.q_perm != nullptr) {
    gs = static_cast<__nv_bfloat16*>(sorted);
    mg = gs;
    sg_[0] = static_cast<long long>(h) * sq * D;
    sg_[1] = static_cast<long long>(sq) * D;
    sg_[2] = D;
  }
  // Q and dO in 64-row boxes (dk/dv) and in the dq block's rows
  CUtensorMap tq, tg, tqb, tgb, tk, tv;
  if (tc::make_map<D>(&tq, encode, q, b, h, sq, st.q, BQ_KV) != CUDA_SUCCESS
      || tc::make_map<D>(&tg, encode, mg, b, h, sq, sg_, BQ_KV)
             != CUDA_SUCCESS
      || tc::make_map<D>(&tqb, encode, q, b, h, sq, st.q, C::BQ)
             != CUDA_SUCCESS
      || tc::make_map<D>(&tgb, encode, mg, b, h, sq, sg_, C::BQ)
             != CUDA_SUCCESS
      || tc::make_map<D>(&tk, encode, k, b, kvh, sk, st.k, BK)
             != CUDA_SUCCESS
      || tc::make_map<D>(&tv, encode, v, b, kvh, sk, st.v, BK)
             != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  flash_bwd_prep<EXT><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                        stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(g), lse, lse2, delta, h, sq, sp, D,
      rows, st, plan, gs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_tc<D, EXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::KV_SMEM));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tc<D, EXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(G::Q_SMEM));
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * LOG2E;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap * LOG2E;
  flash_bwd_dkdv_tc<D, EXT><<<dim3((sk + BK - 1) / BK, kvh, b * splits),
                              G::KV_THREADS, G::KV_SMEM, stream>>>(
      tq, tk, tv, tg, lse2, delta, dk_, dv_, part, h, h / kvh, splits, sq,
      sk, q_offset, sp, causal, window, scale_log2, scale, st, plan, cap_in,
      cap_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long pairs = static_cast<long long>(b) * kvh * sk * D;
    flash_bwd_sum<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0,
                    stream>>>(part, dk_, dv_, splits, kvh, sk, D, pairs, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_tc<D, EXT><<<dim3((sq + C::BQ - 1) / C::BQ, h, b),
                            G::Q_THREADS, G::Q_SMEM, stream>>>(
      tqb, tk, tv, tgb, lse2, delta, static_cast<__nv_bfloat16*>(dq),
      h / kvh, sq, sk, q_offset, sp, causal, window, scale_log2, scale,
      st.dq[0], st.dq[1], st.dq[2], plan, cap_in, cap_out);
  return cudaGetLastError();
}

typedef int (*Launch)(const void*, const void*, const void*, const void*,
                      const void*, const float*, float*, void*, void*, void*,
                      int, int, int, int, int, int, int, int, int, int,
                      float, const bwd::Strides&, const PosPlan&, void*,
                      float, cudaStream_t);

template <bool EXT>
Launch pick(int d) {
  switch (d) {
    case 16: return launch<16, EXT>;
    case 32: return launch<32, EXT>;
    case 64: return launch<64, EXT>;
    case 128: return launch<128, EXT>;
    case 256: return launch<256, EXT>;
  }
  return nullptr;
}

// Dynamic shared memory of the dk/dv (which 0) or dq (1) kernel at head dim
// d; 0 for a head dim the route does not serve.
int smem_bytes(int which, int d) {
  switch (d) {
#define BWD_SMEM(D) \
  case D: return static_cast<int>(which ? Bwd<D>::Q_SMEM : Bwd<D>::KV_SMEM);
    BWD_SMEM(16) BWD_SMEM(32) BWD_SMEM(64) BWD_SMEM(128) BWD_SMEM(256)
#undef BWD_SMEM
  }
  return 0;
}

}  // namespace tcb

typedef int (*Launch)(const void*, const void*, const void*, void*, int, int,
                      int, int, int, int, int, int, float, const long long*,
                      int, float*, const PosPlan&, void*, float,
                      cudaStream_t);

template <bool EXT>
Launch pick(int route, int d) {
  if (route == 0) {
    switch (d) {
      case 16: return f32::launch<16, EXT>;
      case 32: return f32::launch<32, EXT>;
      case 64: return f32::launch<64, EXT>;
      case 128: return f32::launch<128, EXT>;
      case 256: return f32::launch<256, EXT>;
    }
  } else if (route == 1) {
    switch (d) {
      case 16: return tc::launch<16, EXT>;
      case 32: return tc::launch<32, EXT>;
      case 64: return tc::launch<64, EXT>;
      case 128: return tc::launch<128, EXT>;
      case 256: return tc::launch<256, EXT>;
    }
  }
  return nullptr;
}

// The C interfaces' checks: the tiles the caller planned with against the
// route's own (forward: route 0 f32, 1 tensor cores; backward: the dq
// block's (rows, keys) and the dk/dv block's (keys, rows), the scratch's
// padded rows and the group's splits).
inline bool fwd_tiles_ok(int route, int d, int sq, int bq, int bk,
                         int n_q_tiles) {
  const bool ok = route == 0 ? bq == f32::BQ && bk == f32::BK
                             : bq == (d == 256 ? 64 : 128) && bk == tc::BK;
  return ok && n_q_tiles == (sq + bq - 1) / bq;
}

inline bool bwd_tiles_ok(int route, int d, int h, int kvh, int sq,
                         const int* tiles, int s_pad, int splits) {
  if (route == 0) {
    const int bq = bwd::bq_rows(d);
    return tiles[0] == bq && tiles[1] == bwd::BK && tiles[2] == bwd::BK
           && tiles[3] == bq && s_pad == sq && splits == 1;
  }
  if (route == 1) {
    const int group = h / kvh;
    const int per = splits > 0 ? (group + splits - 1) / splits : 0;
    return tiles[0] == (d == 256 ? 64 : 128) && tiles[1] == tc::BK
           && tiles[2] == tc::BK && tiles[3] == tcb::BQ_KV && s_pad >= sq
           && s_pad % tcb::PAD_ROWS == 0 && splits >= 1 && splits <= group
           && (splits - 1) * per < group;
  }
  return false;
}

}  // namespace
