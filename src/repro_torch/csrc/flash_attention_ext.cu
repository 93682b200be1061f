// K4's EXT instantiations: flash attention on caller positions q_pos [B, Sq]
// and k_pos [B, Sk], with an optional logit soft cap, forward and backward,
// both routes, in the position-sorted order flash_attention.cuh describes
// ("caller positions").  This file adds the plan's pre-pass flash_pos_band
// and the C entry points; the kernels are the header's templates with EXT
// true.  flash_attention.cu builds the index instantiations beside it.

#include "flash_attention.cuh"

namespace {

// keys of a sorted row <= x (upper bound) and < x (lower bound)
__device__ __forceinline__ int count_le(const int* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(a + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_lt(const int* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(a + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One thread a sorted row r and a sorted key j of one batch entry
// (blockIdx.y): from the sorted positions qs [Sq] and ks [Sk] (batch
// strides qsb, ksb), row r's band [lo, hi) of sorted keys and key j's rows
// [qlo, qhi), each by binary search, in band_ints(Sq, Sk) ints a batch
// entry; pads hold 0.  The hull (the first and last row keeping no key)
// is kept as Sq - first and last + 1 by atomicMax over a band that starts
// zeroed, so that every block can add to it: 0, 0 when every row keeps a
// key (PosPlan::hull_first / hull_last decode it).
__global__ void __launch_bounds__(256)
flash_pos_band(const int* __restrict__ qs, long long qsb,
               const int* __restrict__ ks, long long ksb, int sq, int sk,
               int causal, int window, int* __restrict__ band) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int* q = qs + b * qsb;
  const int* k = ks + b * ksb;
  const int sqp = pos_padded(sq), skp = pos_padded(sk);
  int* lo = band + static_cast<long long>(b) * band_ints(sq, sk);
  int* hi = lo + sqp;
  int* qlo = hi + sqp;
  int* qhi = qlo + skp;
  int* hull = qhi + skp;
  if (i < sqp) {
    int l = 0, h = 0;
    if (i < sq) {
      const long long p = __ldg(q + i);
      h = causal ? count_le(k, sk, p) : sk;
      l = window > 0 ? count_le(k, sk, p - window) : 0;
      if (h <= l) {
        atomicMax(hull, sq - i);
        atomicMax(hull + 1, i + 1);
      }
    }
    lo[i] = l;
    hi[i] = h;
  }
  if (i < skp) {
    int a = 0, z = 0;
    if (i < sk) {
      const long long kp = __ldg(k + i);
      a = causal ? count_lt(q, sq, kp) : 0;
      z = window > 0 ? count_lt(q, sq, kp + window) : sq;
    }
    qlo[i] = a;
    qhi[i] = z;
  }
}

// Rows of one [B, heads, S, row] tensor (strides in 16-byte units) copied
// in sorted order into a contiguous destination: row r of (batch, head)
// from row perm[batch, r] of the source.
struct GatherJob {
  const uint4* src;
  uint4* dst;
  const int* perm;    // [B, S] contiguous
  long long sb, sh, ss;
  int heads, s;
};

struct GatherJobs {
  GatherJob job[3];
};

// One thread a 16-byte vector of row blockIdx.x * rows_per_block + ... of
// (batch, head) blockIdx.y (heads past the tensor's leave at once) of
// tensor blockIdx.z; vecs (16-byte vectors a row) is a power of two.
__global__ void __launch_bounds__(256)
flash_pos_gather(GatherJobs jobs, int vecs_log2, int heads_max) {
  const GatherJob& g = jobs.job[blockIdx.z];
  const int bb = blockIdx.y / heads_max, hh = blockIdx.y % heads_max;
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int row = i >> vecs_log2, c = i & ((1 << vecs_log2) - 1);
  if (hh >= g.heads || row >= g.s) return;
  const int src_row = __ldg(g.perm + static_cast<long long>(bb) * g.s + row);
  g.dst[((static_cast<long long>(bb) * g.heads + hh) * g.s + row)
        << vecs_log2 | c] = g.src[bb * g.sb + hh * g.sh + src_row * g.ss + c];
}

// Sorted copies of n (1 to 3) tensors [B, heads[i], seq[i], row] (element
// strides (batch, head, sequence) strides[3 i ..], 16-byte multiples like
// every base) into dst[i] (contiguous): row r of dst[i] is row
// perm[i][batch, r] of src[i].  row_bytes: 16 times a power of two.
int gather_rows(int n, const void* const* src, void* const* dst,
                const void* const* perm, const long long* strides,
                const int* heads, const int* seq, int b, int row_bytes,
                int elem_bytes, cudaStream_t stream) {
  if (n < 1 || n > 3 || b <= 0 || row_bytes % 16 != 0 || elem_bytes <= 0)
    return cudaErrorInvalidValue;
  const int vecs = row_bytes / 16;
  int vecs_log2 = 0;
  while ((1 << vecs_log2) < vecs) ++vecs_log2;
  if ((1 << vecs_log2) != vecs) return cudaErrorInvalidValue;
  GatherJobs jobs{};
  int most_rows = 0, heads_max = 0;
  for (int i = 0; i < n; ++i) {
    GatherJob& g = jobs.job[i];
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] * elem_bytes % 16 != 0)
        return cudaErrorInvalidValue;
    g.src = static_cast<const uint4*>(src[i]);
    g.dst = static_cast<uint4*>(dst[i]);
    g.perm = static_cast<const int*>(perm[i]);
    g.sb = strides[3 * i] * elem_bytes / 16;
    g.sh = strides[3 * i + 1] * elem_bytes / 16;
    g.ss = strides[3 * i + 2] * elem_bytes / 16;
    g.heads = heads[i];
    g.s = seq[i];
    most_rows = max(most_rows, seq[i]);
    heads_max = max(heads_max, heads[i]);
  }
  if (most_rows == 0 || heads_max == 0) return cudaSuccess;
  const long long vec_total = static_cast<long long>(most_rows) * vecs;
  if (vec_total > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_pos_gather<<<dim3(static_cast<unsigned>((vec_total + 255) / 256),
                          b * heads_max, n),
                     256, 0, stream>>>(
      jobs, vecs_log2, heads_max);
  return cudaGetLastError();
}

// Q, K and V of a tensor-core EXT call with permutations gathered into
// `sorted` ([B, H, Sq, D], then [B, KVH, Sk, D] twice, bf16); *q, *k, *v
// and their strides (st[0..8]) then name the copies.
int gather_qkv(const void** q, const void** k, const void** v,
               long long* st, const PosPlan& plan, void* sorted, int b,
               int h, int kvh, int sq, int sk, int d, cudaStream_t stream) {
  __nv_bfloat16* qs = static_cast<__nv_bfloat16*>(sorted);
  __nv_bfloat16* ks = qs + static_cast<long long>(b) * h * sq * d;
  __nv_bfloat16* vs = ks + static_cast<long long>(b) * kvh * sk * d;
  const void* src[3] = {*q, *k, *v};
  void* dst[3] = {qs, ks, vs};
  const void* perm[3] = {plan.q_perm, plan.k_perm, plan.k_perm};
  const int heads[3] = {h, kvh, kvh}, seq[3] = {sq, sk, sk};
  const int err = gather_rows(3, src, dst, perm, st, heads, seq, b, d * 2, 2,
                              stream);
  if (err != cudaSuccess) return err;
  *q = qs;
  *k = ks;
  *v = vs;
  for (int i = 0; i < 3; ++i) {
    st[3 * i] = static_cast<long long>(heads[i]) * seq[i] * d;
    st[3 * i + 1] = static_cast<long long>(seq[i]) * d;
    st[3 * i + 2] = d;
  }
  return cudaSuccess;
}

// The plan's pointers, checked: both permutations or neither.
bool make_plan(PosPlan* plan, const void* q_perm, const void* k_perm,
               const void* band, int sq, int sk) {
  if (band == nullptr || (q_perm == nullptr) != (k_perm == nullptr))
    return false;
  plan->q_perm = static_cast<const int*>(q_perm);
  plan->k_perm = static_cast<const int*>(k_perm);
  plan->band = static_cast<const int*>(band);
  plan->sq = sq;
  plan->sk = sk;
  return true;
}

}  // namespace

extern "C" {

// int32 elements of the band flash_attention_pos_band fills for B batch
// entries of Sq queries and Sk keys.
long long flash_attention_pos_scratch_ints(int b, int sq, int sk) {
  return static_cast<long long>(b) * band_ints(sq, sk);
}

// The plan's pre-pass: q_sorted [B, Sq] and k_sorted [B, Sk] int32 with a
// contiguous sequence (batch strides q_sb, k_sb; 0 repeats one row), each
// row sorted ascending; band: flash_attention_pos_scratch_ints(b, sq, sk)
// int32, zeroed.  window <= 0 means none.
int flash_attention_pos_band(const void* q_sorted, long long q_sb,
                             const void* k_sorted, long long k_sb, int b,
                             int sq, int sk, int causal, int window,
                             void* band, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  const int n = max(pos_padded(sq), pos_padded(sk));
  flash_pos_band<<<dim3((n + 255) / 256, b), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_sorted), q_sb,
      static_cast<const int*>(k_sorted), k_sb, sq, sk, causal, window,
      static_cast<int*>(band));
  return cudaGetLastError();
}

// The sorted copies of the tensor-core EXT calls, alone (gather_rows).
int flash_attention_pos_gather(int n, const void* const* src,
                               void* const* dst, const void* const* perm,
                               const long long* strides, const int* heads,
                               const int* seq, int b, int row_bytes,
                               int elem_bytes, void* stream) {
  return gather_rows(n, src, dst, perm, strides, heads, seq, b, row_bytes,
                     elem_bytes, static_cast<cudaStream_t>(stream));
}

// flash_attention_fwd's arguments (q_offset 0: the positions carry it)
// and the plan: q_perm [B, Sq] and k_perm [B, Sk] int32 contiguous (both
// null for positions known sorted) and its band for (causal, window).  The
// f32 route gathers rows in its loads; the tensor-core route with
// permutations first writes sorted copies of q, k and v into `sorted`
// (B H Sq D + 2 B KVH Sk D bf16; flash_pos_gather), which its kernel
// reads.  o and lse are written in the caller's order.  softcap: the logit
// soft cap, 0 for none.
int flash_attention_ext_fwd(int route, const void* q, const void* k,
                            const void* v, void* o, int b, int h, int kvh,
                            int sq, int sk, int d, int causal, int window,
                            float scale, const long long* strides, int bq,
                            int bk, int n_q_tiles, void* lse,
                            const void* q_perm, const void* k_perm,
                            const void* band, void* sorted, float softcap,
                            void* stream) {
  if (kvh <= 0 || h % kvh != 0 || softcap < 0.f) return cudaErrorInvalidValue;
  if (!fwd_tiles_ok(route, d, sq, bq, bk, n_q_tiles))
    return cudaErrorInvalidValue;
  PosPlan plan;
  const bool gather = route == 1 && q_perm != nullptr;
  if (!make_plan(&plan, q_perm, k_perm, band, sq, sk)
      || (gather && sorted == nullptr))
    return cudaErrorInvalidValue;
  Launch fn = pick<true>(route, d);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  long long st[12];
  memcpy(st, strides, sizeof(st));
  if (gather) {
    const int err = gather_qkv(&q, &k, &v, st, plan, sorted, b, h, kvh, sq,
                               sk, d, stream_);
    if (err != cudaSuccess) return err;
  }
  return fn(q, k, v, o, b, h, kvh, sq, sk, causal, window, 0, scale, st,
            n_q_tiles, static_cast<float*>(lse), plan, nullptr, softcap,
            stream_);
}

// flash_attention_bwd's arguments without q_offset (the positions carry
// it; any sq and sk) and the plan, as flash_attention_ext_fwd: on the
// tensor-core route with permutations `sorted` is room for sorted copies of
// q, k, v (flash_pos_gather) and g (written by the row pass flash_bwd_prep,
// which reads o and g at q_perm), B H Sq D + 2 B KVH Sk D + B H Sq D bf16.
int flash_attention_ext_bwd(int route, const void* q, const void* k,
                            const void* v, const void* o, const void* g,
                            const void* lse, void* scratch, void* dq,
                            void* dk, void* dv, int b, int h, int kvh,
                            int sq, int sk, int d, int causal, int window,
                            float scale, const long long* strides,
                            const int* tiles, int s_pad, int splits,
                            const void* q_perm, const void* k_perm,
                            const void* band, void* sorted, float softcap,
                            void* stream) {
  if (kvh <= 0 || h % kvh != 0 || sq <= 0 || sk <= 0 || softcap < 0.f)
    return cudaErrorInvalidValue;
  PosPlan plan;
  const bool gather = route == 1 && q_perm != nullptr;
  if (!make_plan(&plan, q_perm, k_perm, band, sq, sk)
      || (gather && sorted == nullptr))
    return cudaErrorInvalidValue;
  bwd::Strides st;
  static_assert(sizeof(st) == 24 * sizeof(long long), "24 strides");
  memcpy(&st, strides, sizeof(st));
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  bwd::Launch f32_fn = bwd::pick<true>(d);
  tcb::Launch tc_fn = tcb::pick<true>(d);
  if (!bwd_tiles_ok(route, d, h, kvh, sq, tiles, s_pad, splits)
      || f32_fn == nullptr || tc_fn == nullptr)
    return cudaErrorInvalidValue;
  if (route == 0)
    return f32_fn(q, k, v, o, g, l, sc, dq, dk, dv, b, h, kvh, sq, sk, 0,
                  causal, window, scale, st, plan, nullptr, softcap,
                  stream_);
  void* gs = nullptr;   // room for g's sorted copy, after q, k, v's
  if (gather) {
    // q, k and v are contiguous copies from here on: their strides too
    long long qkv[9];
    memcpy(qkv, st.q, sizeof(st.q));
    memcpy(qkv + 3, st.k, sizeof(st.k));
    memcpy(qkv + 6, st.v, sizeof(st.v));
    const int err = gather_qkv(&q, &k, &v, qkv, plan, sorted, b, h, kvh, sq,
                               sk, d, stream_);
    if (err != cudaSuccess) return err;
    memcpy(st.q, qkv, sizeof(st.q));
    memcpy(st.k, qkv + 3, sizeof(st.k));
    memcpy(st.v, qkv + 6, sizeof(st.v));
    gs = static_cast<__nv_bfloat16*>(sorted)
         + (static_cast<long long>(b) * h * sq * d
            + 2LL * b * kvh * sk * d);
  }
  return tc_fn(q, k, v, o, g, l, sc, dq, dk, dv, b, h, kvh, sq, sk, 0, s_pad,
               splits, causal, window, scale, st, plan, gs, softcap,
               stream_);
}

const char* flash_attention_error_string(int code) {
  return hopper::error_string(code);
}

}  // extern "C"
