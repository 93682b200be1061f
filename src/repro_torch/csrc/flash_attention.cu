// Causal / sliding-window GQA flash attention for Hopper: the forward in two
// routes picked by dtype (a tensor-core kernel for bf16 and a CUDA-core kernel
// for f32), each writing the rows' log-sum-exp when asked, and the backward
// (see "backward" below).
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


// S = Q K^T for one kv tile (issued, not waited for).  dq and dk describe
// the first 16 columns of Q and K; a k-step moves the start address (the
// low bits of the descriptor) to the next 16 columns: 32 bytes into the
// swizzled row, or the next box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         uint64_t dq, uint64_t dk) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int bx = kk * 16 / C::CH;
    const int off = (kk * 16 % C::CH) * 2;
    const uint64_t da = dq + ((bx * C::Q_BOX + off) >> 4);
    const uint64_t db = dk + ((bx * C::KV_BOX + off) >> 4);
    if (kk == 0)
      WgmmaSS<BK>::first(sc, da, db);
    else
      WgmmaSS<BK>::run(sc, da, db);
  }
}

// O += P V for one kv tile (issued, not waited for); a k-step moves dv
// 16 keys (rows of the swizzled V tile) on.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 4],
                                         uint64_t dv) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    WgmmaRS<D>::run(acc, pa + 4 * kk, dv + ((kk * 16 * C::SW) >> 4));
}

struct RowState {
  float m0, m1, l0, l1;   // running max and sum of rows r and r + 8
};

// Online-softmax step on the f32 scores of one tile, in place: scale (with
// log2 e, for exp2), mask (edge tiles only), new running max, p = 2^(s - m)
// left in sc, and the factors alpha by which the old sums are rescaled.  A
// thread holds rows r and r + 8 of the tile at keys 8 j + col, + 1.
template <int NS>
__device__ __forceinline__ void softmax(float (&sc)[NS], RowState& st,
                                        float& alpha0, float& alpha1,
                                        bool masked, int k0, int col,
                                        int qp0, int sk, int causal,
                                        int window, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] *= scale_log2;
  if (masked) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kp = k0 + 8 * (i / 4) + col + (i & 1);
      const int qp = qp0 + ((i & 2) ? 8 : 0);
      bool ok = true;
      if (causal) ok = ok && qp >= kp;
      if (window > 0) ok = ok && qp - kp < window;
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

template <int D>
__global__ void __launch_bounds__(Cfg<D>::NTHREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, int group, int sq, int sk,
             int causal, int window, int q_offset, float scale_log2,
             long long osb, long long osh, long long oss,
             float* __restrict__ lse) {
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
  const int n_tiles = (r.end - r.begin + BK - 1) / BK;
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
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int k0 = r.begin + t * BK;
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

    mbar_wait(&q_bar, 0);
    // tile 0: scores only
    mbar_wait(&full_k[0], 0);
    wg_fence();
    issue_qk<D>(sc, dq, dk);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&empty_k[0]);
    softmax(sc, st, alpha0, alpha1,
            tile_masked(r, r.begin, BK, sk, causal, window), r.begin, col,
            qp0, sk, causal, window, scale_log2);
    pack_p(sc, pa);
    // tile t: its scores, then the products of tile t - 1 (after O is
    // rescaled to tile t - 1's running max); the softmax of t runs while
    // those products do, and its P is packed once they are done
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % STAGES, sp = (t - 1) % STAGES;
      const int k0 = r.begin + t * BK;
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
      softmax(sc, st, alpha0, alpha1,
              tile_masked(r, k0, BK, sk, causal, window), k0, col, qp0, sk,
              causal, window, scale_log2);
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
    if (lse != nullptr && col == 0) {
      // m + log l per row, in natural units (m and l are base 2 here)
      float* lb = lse + (static_cast<long long>(b) * gridDim.y + h) * sq;
      if (r0 < sq) lb[r0] = (st.m0 + log2f(fmaxf(l0, 1e-30f))) * LN2;
      if (r0 + 8 < sq) lb[r0 + 8] = (st.m1 + log2f(fmaxf(l1, 1e-30f))) * LN2;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * oss + 8 * j + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r0 + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * oss + 8 * j
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
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kvh, int sq, int sk, int causal, int window,
           int q_offset, float scale, const long long* st, int n_q_tiles,
           float* lse, cudaStream_t stream) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  CUtensorMap tq, tk, tv;
  if (make_map<D>(&tq, encode, q, b, h, sq, st, C::BQ) != CUDA_SUCCESS
      || make_map<D>(&tk, encode, k, b, kvh, sk, st + 3, BK) != CUDA_SUCCESS
      || make_map<D>(&tv, encode, v, b, kvh, sk, st + 6, BK) != CUDA_SUCCESS)
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_q_tiles, h, b);
  flash_fwd_tc<D><<<grid, C::NTHREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), h / kvh, sq, sk, causal,
      window, q_offset, scale * 1.4426950408889634f, st[9], st[10], st[11],
      lse);
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

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int group,
              int sq, int sk, int causal, int window, int q_offset,
              float scale, long long qsb, long long qsh, long long qss,
              long long ksb, long long ksh, long long kss, long long vsb,
              long long vsh, long long vss, long long osb, long long osh,
              long long oss, float* __restrict__ lse) {
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
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;
  float* ob = o + b * osb + h * osh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (q0 + r < sq) x = qb[(q0 + r) * qss + d] * scale;
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

  const KvRange rng = kv_range(q0, BQ, BK, sq, sk, causal, window, q_offset);
  const int q_lo = rng.q_lo;
  for (int k0 = rng.begin; k0 < rng.end; k0 += BK) {
    __syncthreads();  // the previous tile's K/V (and, first, Q) are settled
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int j = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + j < sk) {
        kx = kb[(k0 + j) * kss + d];
        vx = vb[(k0 + j) * vss + d];
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kvh, int sq, int sk, int causal, int window,
           int q_offset, float scale, const long long* st, int n_q_tiles,
           float* lse, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_q_tiles, h, b);
  flash_fwd_f32<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), h / kvh, sq, sk,
      causal, window, q_offset, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], lse);
  return cudaGetLastError();
}

}  // namespace f32


// ---------------------------------------------------------------------------
// backward (both dtypes, CUDA cores)
// ---------------------------------------------------------------------------
//
// The TPU package has no backward kernel (XLA differentiates its plain
// attention); this one gives K4 its gradient, FA2-style, from q, k, v, o, the
// output's gradient do and the forward's lse:
//   P = exp(q k^T scale - lse)   (0 where the mask drops the pair)
//   delta_i = sum_d do_id o_id,  dS = P (do v^T - delta)
//   dv = P^T do,  dk = scale dS^T q,  dq = scale dS k.
// Three kernels: flash_bwd_delta (one warp a row); flash_bwd_dkdv, one block
// a (key tile of BK keys, kv head, batch), which walks the query tiles of
// every head of its group that can see its keys and keeps dk and dv in f32
// registers; flash_bwd_dq, one block a (query tile, head, batch), which walks
// the kv tiles of the forward's schedule (kv_range).  Each tile recomputes P
// from lse.  Every output element is summed by one thread in a fixed order
// (the GQA sum over the group inside one block): no atomics, so two calls
// give the same bits.  bf16 or f32 in and out, f32 inside.  Causal masks and
// windows as the forward's, with q_offset 0 and Sq = Sk (the wrapper refuses
// the rest), so every row has a valid key.
//
// Layout: 256 threads; warp w holds query rows w, w + 8, ... of a tile and
// lane j key j of a kv tile for the scores (Q, K, V and dO tiles are f32 in
// shared memory, padded as the f32 forward's).  BQ = 64 rows (32 at D = 256,
// for shared memory).  Bound: five products over the valid pairs (q.k, do.v,
// P^T do, dS^T q, dS k: 10 D flops a pair), which CUDA cores at 67 TFLOP/s
// (f32) take far longer than the bytes.  Redesigning it for the tensor cores
// (wgmma) is later work.

namespace bwd {

constexpr int BK = 32;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 4;
constexpr int PS = BK + 1;   // row stride of the P and dS tiles (no conflicts)

template <int D>
struct Shape {
  static constexpr int BQ = D == 256 ? 32 : 64;
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool pair_ok(int qp, int kp, int s, int causal,
                                        int window) {
  return qp < s && kp < s && (!causal || qp >= kp)
         && (window <= 0 || qp - kp < window);
}

// delta = rowsum(do * o), one warp a row of [B, H, S]
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ g,
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
  const T* orow = o + bb * st.o[0] + hh * st.o[1] + i * st.o[2];
  const T* grow = g + bb * st.g[0] + hh * st.g[1] + i * st.g[2];
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc = fmaf(to_f(orow[c]), to_f(grow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Loads rows [r0, r0 + n) of a [S, D] slice (element stride ss) into a
// padded f32 tile; rows past s are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int n,
                                          int s) {
  for (int i = threadIdx.x; i < n * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + PAD) + c] = r0 + r < s ? to_f(src[(r0 + r) * ss + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int h, int group,
               int s, int causal, int window, float scale, Strides st) {
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
  load_tile<T, D>(s_k, k + b * st.k[0] + kvh * st.k[1], st.k[2], k0, BK, s);
  load_tile<T, D>(s_v, v + b * st.v[0] + kvh * st.v[1], st.v[2], k0, BK, s);

  // this thread's share of dk and dv: key kj, columns c0 + 8 m
  const int kj = tid / 8, c0 = tid % 8;
  float acc_k[NCOL], acc_v[NCOL];
#pragma unroll
  for (int m = 0; m < NCOL; ++m) acc_k[m] = acc_v[m] = 0.f;

  // the query rows that can see a key of this tile
  const int q_begin = causal ? k0 / BQ * BQ : 0;
  const int q_end = window > 0 ? min(s, k0 + BK - 1 + window) : s;
  const int kp = k0 + lane;
  for (int hg = 0; hg < group; ++hg) {
    const int hh = kvh * group + hg;
    const T* qb = q + b * st.q[0] + hh * st.q[1];
    const T* gb = g + b * st.g[0] + hh * st.g[1];
    const long long rb = (static_cast<long long>(b) * h + hh) * s;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the previous tile is read (first: K, V loaded)
      load_tile<T, D>(s_q, qb, st.q[2], q0, BQ, s);
      load_tile<T, D>(s_g, gb, st.g[2], q0, BQ, s);
      for (int r = tid; r < BQ; r += NTHREADS) {
        s_lse[r] = q0 + r < s ? lse[rb + q0 + r] : 0.f;
        s_dl[r] = q0 + r < s ? delta[rb + q0 + r] : 0.f;
      }
      __syncthreads();
      float sc[RPW], dp[RPW];
      scores<D, RPW>(s_q, s_g, s_k, s_v, sc, dp);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + NWARPS * i;
        const bool ok = pair_ok(q0 + r, kp, s, causal, window);
        const float p = ok ? expf(sc[i] * scale - s_lse[r]) : 0.f;
        s_p[r * PS + lane] = p;
        s_ds[r * PS + lane] = ok ? p * (dp[i] - s_dl[r]) : 0.f;
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
  if (k0 + kj < s) {
    T* dkr = dk + b * st.dk[0] + kvh * st.dk[1] + (k0 + kj) * st.dk[2];
    T* dvr = dv + b * st.dv[0] + kvh * st.dv[1] + (k0 + kj) * st.dv[2];
#pragma unroll
    for (int m = 0; m < NCOL; ++m) {
      dkr[c0 + 8 * m] = from_f<T>(acc_k[m] * scale);
      dvr[c0 + 8 * m] = from_f<T>(acc_v[m]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int h, int group, int s, int causal,
             int window, float scale, Strides st) {
  using Sh = Shape<D>;
  constexpr int BQ = Sh::BQ, RPW = Sh::RPW, DP = Sh::DP;
  constexpr int TPR = NTHREADS / BQ;   // threads a row of dq
  constexpr int NCOL = D / TPR;        // columns of dq a thread holds
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
  load_tile<T, D>(s_q, q + b * st.q[0] + hh * st.q[1], st.q[2], q0, BQ, s);
  load_tile<T, D>(s_g, g + b * st.g[0] + hh * st.g[1], st.g[2], q0, BQ, s);
  const long long rb = (static_cast<long long>(b) * h + hh) * s;
  for (int r = tid; r < BQ; r += NTHREADS) {
    s_lse[r] = q0 + r < s ? lse[rb + q0 + r] : 0.f;
    s_dl[r] = q0 + r < s ? delta[rb + q0 + r] : 0.f;
  }
  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];

  // this thread's share of dq: row qr, columns c0 + TPR m
  const int qr = tid / TPR, c0 = tid % TPR;
  float acc[NCOL];
#pragma unroll
  for (int m = 0; m < NCOL; ++m) acc[m] = 0.f;

  const KvRange rng = kv_range(q0, BQ, BK, s, s, causal, window, 0);
  for (int k0 = rng.begin; k0 < rng.end; k0 += BK) {
    __syncthreads();   // the previous tile is read (first: Q, dO loaded)
    load_tile<T, D>(s_k, kb, st.k[2], k0, BK, s);
    load_tile<T, D>(s_v, vb, st.v[2], k0, BK, s);
    __syncthreads();
    float sc[RPW], dp[RPW];
    scores<D, RPW>(s_q, s_g, s_k, s_v, sc, dp);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + NWARPS * i;
      const bool ok = pair_ok(q0 + r, k0 + lane, s, causal, window);
      const float p = ok ? expf(sc[i] * scale - s_lse[r]) : 0.f;
      s_ds[r * PS + lane] = ok ? p * (dp[i] - s_dl[r]) : 0.f;
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
  if (q0 + qr < s) {
    T* dqr = dq + b * st.dq[0] + hh * st.dq[1] + (q0 + qr) * st.dq[2];
#pragma unroll
    for (int m = 0; m < NCOL; ++m) dqr[c0 + TPR * m] = from_f<T>(acc[m] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* g, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int b, int h, int kvh, int s, int causal, int window,
           float scale, const Strides& st, cudaStream_t stream) {
  using Sh = Shape<D>;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  const long long rows = static_cast<long long>(b) * h * s;
  flash_bwd_delta<T><<<static_cast<unsigned>((rows + NWARPS - 1) / NWARPS),
                       NTHREADS, 0, stream>>>(
      static_cast<const T*>(o), tg, delta, h, s, D, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::SMEM_KV));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::SMEM_Q));
  if (err != cudaSuccess) return err;
  const int group = h / kvh;
  flash_bwd_dkdv<T, D><<<dim3((s + BK - 1) / BK, kvh, b), NTHREADS,
                         Sh::SMEM_KV, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      h, group, s, causal, window, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, D><<<dim3((s + Sh::BQ - 1) / Sh::BQ, h, b), NTHREADS,
                       Sh::SMEM_Q, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), h, group, s, causal,
      window, scale, st);
  return cudaGetLastError();
}

typedef int (*Launch)(const void*, const void*, const void*, const void*,
                      const void*, const float*, float*, void*, void*, void*,
                      int, int, int, int, int, int, float, const Strides&,
                      cudaStream_t);

template <typename T>
Launch pick(int d) {
  switch (d) {
    case 16: return launch<T, 16>;
    case 32: return launch<T, 32>;
    case 64: return launch<T, 64>;
    case 128: return launch<T, 128>;
    case 256: return launch<T, 256>;
  }
  return nullptr;
}

}  // namespace bwd

typedef int (*Launch)(const void*, const void*, const void*, void*, int, int,
                      int, int, int, int, int, int, float, const long long*,
                      int, float*, cudaStream_t);

Launch pick(int route, int d) {
  if (route == 0) {
    switch (d) {
      case 16: return f32::launch<16>;
      case 32: return f32::launch<32>;
      case 64: return f32::launch<64>;
      case 128: return f32::launch<128>;
      case 256: return f32::launch<256>;
    }
  } else if (route == 1) {
    switch (d) {
      case 16: return tc::launch<16>;
      case 32: return tc::launch<32>;
      case 64: return tc::launch<64>;
      case 128: return tc::launch<128>;
      case 256: return tc::launch<256>;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// route: 0 = the f32 CUDA-core kernel (q, k, v, o float32), 1 = the bf16
// tensor-core kernel (all bfloat16).  bq, bk: the tile the caller planned
// with, checked against the route's own.  n_q_tiles: blocks along the query
// axis.  strides: 12 element strides, (batch, head, sequence) of q, k, v and o
// in turn; the head-dim stride is 1.  window <= 0 means none.  lse: null, or
// a contiguous float32 [B, H, Sq] that receives m + log l of each query row
// (natural units; the backward's input).  Returns 0 on success, else a CUDA
// error code (or one past them: see flash_attention_error_string).
int flash_attention_fwd(int route, const void* q, const void* k,
                        const void* v, void* o, int b, int h, int kvh, int sq,
                        int sk, int d, int causal, int window, int q_offset,
                        float scale, const long long* strides, int bq, int bk,
                        int n_q_tiles, void* lse, void* stream) {
  if (kvh <= 0 || h % kvh != 0) return cudaErrorInvalidValue;
  const bool tiles_ok =
      route == 0 ? bq == f32::BQ && bk == f32::BK
                 : bq == (d == 256 ? 64 : 128) && bk == tc::BK;
  if (!tiles_ok || n_q_tiles != (sq + bq - 1) / bq) return cudaErrorInvalidValue;
  Launch fn = pick(route, d);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, o, b, h, kvh, sq, sk, causal, window, q_offset, scale,
            strides, n_q_tiles, static_cast<float*>(lse),
            static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block of the route takes at head dim d (bytes;
// 0 for a head dim the route does not serve).
int flash_attention_smem_bytes(int route, int d) {
  switch (route * 1000 + d) {
    case 16: return static_cast<int>(f32::smem_bytes<16>());
    case 32: return static_cast<int>(f32::smem_bytes<32>());
    case 64: return static_cast<int>(f32::smem_bytes<64>());
    case 128: return static_cast<int>(f32::smem_bytes<128>());
    case 256: return static_cast<int>(f32::smem_bytes<256>());
    case 1016: return static_cast<int>(tc::Cfg<16>::SMEM);
    case 1032: return static_cast<int>(tc::Cfg<32>::SMEM);
    case 1064: return static_cast<int>(tc::Cfg<64>::SMEM);
    case 1128: return static_cast<int>(tc::Cfg<128>::SMEM);
    case 1256: return static_cast<int>(tc::Cfg<256>::SMEM);
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do and dq, dk, dv alike).
// lse: the forward's [B, H, S] float32; delta: float32 [B, H, S] scratch.
// strides: 24 element strides, (batch, head, sequence) of q, k, v, o, do, dq,
// dk and dv in turn; the head-dim stride is 1.  Sq = Sk = s, q_offset 0.
// Launches the three kernels on `stream`; returns 0 or an error code.
int flash_attention_bwd(int dtype, const void* q, const void* k,
                        const void* v, const void* o, const void* g,
                        const void* lse, void* delta, void* dq, void* dk,
                        void* dv, int b, int h, int kvh, int s, int d,
                        int causal, int window, float scale,
                        const long long* strides, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || s <= 0) return cudaErrorInvalidValue;
  bwd::Launch fn = dtype == 0 ? bwd::pick<float>(d)
                   : dtype == 1 ? bwd::pick<__nv_bfloat16>(d) : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  bwd::Strides st;
  static_assert(sizeof(st) == 24 * sizeof(long long), "24 strides");
  memcpy(&st, strides, sizeof(st));
  return fn(q, k, v, o, g, static_cast<const float*>(lse),
            static_cast<float*>(delta), dq, dk, dv, b, h, kvh, s, causal,
            window, scale, st, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
