// K4's index kernels: causal / sliding-window GQA flash attention on
// positions q_offset + i for queries and j for keys, forward and backward,
// both routes.  The kernels are flash_attention.cuh's templates with EXT
// false; flash_attention_ext.cu builds their EXT instantiations (caller
// positions, the soft cap) beside this file.

#include "flash_attention.cuh"

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
  if (!fwd_tiles_ok(route, d, sq, bq, bk, n_q_tiles))
    return cudaErrorInvalidValue;
  Launch fn = pick<false>(route, d);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, o, b, h, kvh, sq, sk, causal, window, q_offset, scale,
            strides, n_q_tiles, static_cast<float*>(lse), PosPlan{}, nullptr,
            0.f, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block of the route takes at head dim d (bytes;
// 0 for a head dim the route does not serve).  route: 0 and 1 the forward's
// (as flash_attention_fwd), 2 the tensor-core backward's dk/dv kernel, 3 its
// dq kernel.  The EXT instantiations take the same.
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
  if (route == 2 || route == 3) return tcb::smem_bytes(route - 2, d);
  return 0;
}

// route: 0 = the f32 CUDA-core kernels (q, k, v, o, do and dq, dk, dv all
// float32), 1 = the bf16 tensor-core kernels (all bfloat16).  lse: the
// forward's [B, H, S] float32.  scratch: float32, [B, H, s_pad] for route 0
// (delta; s_pad = s, splits = 1), 2 x [B, H, s_pad] for route 1 (lse log2 e,
// then delta; s_pad a multiple of 128, at least s), then, when splits > 1,
// the dk/dv blocks' partial sums [splits, 2, B, KVH, S, D].  splits: the
// runs of consecutive heads a group is cut into (one dk/dv block each; none
// empty).  strides: 24 element strides,
// (batch, head, sequence) of q, k, v, o, do, dq, dk and dv in turn; the
// head-dim stride is 1.  tiles: the (query rows, keys) of a dq block and the
// (keys, query rows) of a dk/dv block's tiles the caller planned with,
// checked against the route's own.  q, o, do and dq are [B, H, sq, D], k, v,
// dk and dv [B, KVH, sk, D], query row i at position q_offset + i, with
// q_offset + sq <= sk (self-attention: q_offset 0, sq = sk; a query chunk
// otherwise), so that every row has a valid key; lse and the scratch's rows
// are sq a head, the partial sums' sk.  Launches the kernels on `stream`;
// returns 0 or an error code.
int flash_attention_bwd(int route, const void* q, const void* k,
                        const void* v, const void* o, const void* g,
                        const void* lse, void* scratch, void* dq, void* dk,
                        void* dv, int b, int h, int kvh, int sq, int sk,
                        int q_offset, int d, int causal, int window,
                        float scale, const long long* strides,
                        const int* tiles, int s_pad, int splits,
                        void* stream) {
  if (kvh <= 0 || h % kvh != 0 || sq <= 0 || sk <= 0 || q_offset < 0
      || q_offset > sk - sq)
    return cudaErrorInvalidValue;
  bwd::Strides st;
  static_assert(sizeof(st) == 24 * sizeof(long long), "24 strides");
  memcpy(&st, strides, sizeof(st));
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  bwd::Launch f32_fn = bwd::pick<false>(d);
  tcb::Launch tc_fn = tcb::pick<false>(d);
  if (!bwd_tiles_ok(route, d, h, kvh, sq, tiles, s_pad, splits)
      || f32_fn == nullptr || tc_fn == nullptr)
    return cudaErrorInvalidValue;
  if (route == 0)
    return f32_fn(q, k, v, o, g, l, sc, dq, dk, dv, b, h, kvh, sq, sk,
                  q_offset, causal, window, scale, st, PosPlan{}, nullptr,
                  0.f, stream_);
  return tc_fn(q, k, v, o, g, l, sc, dq, dk, dv, b, h, kvh, sq, sk, q_offset,
               s_pad, splits, causal, window, scale, st, PosPlan{}, nullptr,
               0.f, stream_);
}

const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
