// Flash-decode attention over a contiguous or a paged KV cache, for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention/kernel.py
// decode_attention_pallas (body _kernel) and decode_attention_paged_pallas
// (body _paged_kernel).  One source: page indirection is the PAGED
// template flag, and it changes only the address of a cache row.
//
// Computes, for one new query token per sequence b:
//   out[b, h] = softmax_j(scale * q[b, h] . k[b, j, h / group]) v[b, j, ...]
// over positions j in [lo, cache_len[b]), lo = max(0, cache_len - window)
// when window > 0, else 0.  q (B, H, hd); contiguous k/v (B, S, KVH, hd);
// paged k/v pools (n_pages, ps, KVH, hd) with page_table (B, P_max): page
// of position j is page_table[b, j / ps], clipped to [0, n_pages - 1] as
// decode_attention/ops.py does, so garbage and trash entries past the
// valid prefix are legal reads that cache_len masks.  cache_len = 0 gives
// exact zeros.  fp32 softmax and accumulation.  hd a multiple of 8, at
// most 128.
//
// What bounds it on the H100: every cached K/V byte of the valid prefix is
// read once for 4 FLOPs per (head, position, dim), so at the serving
// decode tick (B = 8 slots, H = KVH = 12, hd = 64, fp32, cache_len
// ~ 128..160 of max_len 256) it is ~0.5 FLOP per byte: memory bound,
// ~7.7 MB of K/V per call, ~2 us at 3.35 TB/s.
//
// Design (flash-decoding), one launch per call:
//  * one CTA per (chunk of CH = 64 positions, kv head, sequence): at the
//    tick 3 live chunks x 12 x 8 = 288 CTAs.  A chunk starts at a multiple
//    of CH, whatever B, the card or the order CTAs run in, so a row's bits
//    do not depend on the other rows of the launch.  CTAs of chunks
//    wholly outside [lo, cache_len) exit before loading anything;
//  * the CTA stages the chunk's valid K and V rows in shared memory with
//    16-byte cp.async (a row's lanes on neighbouring addresses) and serves
//    the whole GQA group, one query head after another over the staged
//    rows, so each K/V byte is read once per group;
//  * inside the chunk each of the 8 warps owns 8 positions; a row is read
//    by hd / (16 bytes) lanes (a power of two of them, the rest idle), the
//    dot products reduce by xor shuffles, 4 positions' chains interleaved,
//    and each row group keeps an online softmax (m, l, acc) in registers
//    over its positions, in base 2 (log2(e) folded into q's scale, as the
//    flash kernels do).  The row groups merge by shuffles and the warps
//    through shared memory, in a fixed order, into the chunk's (m, l, acc);
//  * the chunk's state goes to a workspace; the last CTA of each
//    (sequence, kv head) to count, at a counter that it resets for the
//    next call, merges the chunks in chunk order (an online merge, the
//    states of 8 chunks loaded at once) and writes out.  Chunks hold at
//    least one valid position, so m is finite; a merge weight of m = -inf
//    is 0, never exp(-inf - -inf);
//  * paged and contiguous share every arithmetic step: only the source
//    address of a staged row differs, so their outputs are bit-equal.
//
// The partial form (decode_attention_partial) attends over one block of
// a cache whose sequence is split over ranks: k/v hold positions
// [seq_lo, seq_lo + S) of it, the masks act on those global positions,
// and the merge writes this block's normalised output in fp32 beside its
// log-sum-exp, lse = m ln 2 + ln l (m, the base-2 max), so that the
// blocks' outputs merge by their lse (decode_attention/ref.py
// merge_partials).  A block with no valid position writes zeros and
// lse = -inf.  With seq_lo = 0 and no lse the kernel is the whole-cache
// one: the same steps on the same positions, the same bits.
#include <climits>

#include "mma_sync.cuh"

namespace {

constexpr int CH = 64;         // cache positions per chunk (one CTA)
constexpr int NW = 8;          // warps per CTA
constexpr int DT = NW * 32;    // threads per CTA
constexpr int PW = CH / NW;    // positions per warp
constexpr int MAX_HD = 128;
constexpr int U = 4;           // positions a row group takes per step
constexpr int NB = 8;          // chunk states the merge loads at once
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte load
};

// 16 bytes of T from shared memory as N floats
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {  // bf16 is the high half of an fp32
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
  }
}

// a merge weight: 2^(m - M) (scores are in base 2), 0 for a state that
// saw no position
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : exp2f(m - mx);
}

// bytes of dynamic shared memory: K and V of the chunk (T), the group's
// scaled queries, the warps' states of one query head
template <typename T>
size_t smem_bytes(int group, int hd) {
  return 2 * static_cast<size_t>(CH) * hd * sizeof(T) +
         sizeof(float) * (static_cast<size_t>(group) * hd + NW * (hd + 2));
}

// the query heads of the group take one pass each over the staged chunk
template <typename T, bool PAGED>
__global__ void __launch_bounds__(DT, 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ page_table,
              const int* __restrict__ cache_len, float* __restrict__ work,
              int* __restrict__ counters, void* __restrict__ out,
              float* __restrict__ lse, int S, int seq_lo, int cap,
              int n_pages, int ps, int p_max, int H, int KVH, int hd,
              int window, float scale) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int group = H / KVH;
  T* k_s = reinterpret_cast<T*>(smem_raw);            // CH x hd
  T* v_s = k_s + CH * hd;                              // CH x hd
  float* q_s = reinterpret_cast<float*>(v_s + CH * hd);  // group x hd
  float* wm = q_s + group * hd;                        // NW
  float* wl = wm + NW;                                 // NW
  float* wacc = wl + NW;                               // NW x hd

  const int c = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int nchunk = gridDim.x;
  const int tid = threadIdx.x;
  const int capacity = PAGED ? p_max * ps : S;
  // global cache length and window start; the block's valid positions
  // [lo, clen) in its own coordinates (the whole cache: seq_lo = 0 and
  // cap = capacity, so these are the global ones)
  const int glen = min(max(cache_len[b], 0), cap);
  const int glo = window > 0 ? max(0, glen - window) : 0;
  const int clen = min(glen - seq_lo, capacity);
  const int lo = max(glo - seq_lo, 0);
  const int bh = b * KVH + kvh;
  const size_t o_off = (static_cast<size_t>(b) * H + kvh * group) * hd;
  T* o_b = static_cast<T*>(out) + o_off;
  float* of_b = static_cast<float*>(out) + o_off;
  if (clen <= lo) {  // no position: exact zeros (and lse = -inf)
    if (c == 0) {
      for (int i = tid; i < group * hd; i += DT) {
        if (lse)
          of_b[i] = 0.f;
        else
          o_b[i] = repro::from_f<T>(0.f);
      }
      if (lse)
        for (int g = tid; g < group; g += DT)
          lse[b * H + kvh * group + g] = -INFINITY;
    }
    return;
  }
  const int c_lo = lo / CH;
  const int c_hi = (clen - 1) / CH;
  if (c < c_lo || c > c_hi) return;
  const int p0 = c * CH;

  // stage the chunk's valid rows; rows outside [lo, clen) stay unloaded
  const int cpr = hd / VEC;  // 16-byte pieces per row
  for (int i = tid; i < CH * cpr; i += DT) {
    const int j = i / cpr;
    const int pos = p0 + j;
    if (pos < lo || pos >= clen) continue;
    size_t row;
    if (PAGED) {
      int page = page_table[static_cast<size_t>(b) * p_max + pos / ps];
      page = min(max(page, 0), n_pages - 1);
      row = (static_cast<size_t>(page) * ps + pos % ps) * KVH + kvh;
    } else {
      row = (static_cast<size_t>(b) * S + pos) * KVH + kvh;
    }
    const size_t off = row * hd + (i % cpr) * VEC;
    repro::mma::cp_async16(k_s + j * hd + (i % cpr) * VEC, k + off, 16);
    repro::mma::cp_async16(v_s + j * hd + (i % cpr) * VEC, v + off, 16);
  }
  repro::mma::cp_async_commit();
  for (int i = tid; i < group * hd; i += DT)
    q_s[i] = repro::to_f(
                 q[(static_cast<size_t>(b) * H + kvh * group) * hd + i]) *
             scale * LOG2E;
  repro::mma::cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  int lpr = 1;  // lanes per row: hd / VEC rounded up to a power of two
  while (lpr * VEC < hd) lpr <<= 1;
  const int slot = lane / lpr;
  const int sub = lane % lpr;
  const int rpw = 32 / lpr;  // rows a warp reads at once
  const bool dvalid = sub * VEC < hd;
  const int d0 = dvalid ? sub * VEC : 0;
  const int wend = (warp + 1) * PW;  // past the warp's positions
  float* st = work + (static_cast<size_t>(bh) * nchunk + c) * group * (hd + 2);

  for (int g = 0; g < group; ++g) {
    float qv[VEC], acc[VEC], m = -INFINITY, l = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qv[e] = dvalid ? q_s[g * hd + d0 + e] : 0.f;
      acc[e] = 0.f;
    }
    // this row group's positions, U at a time (their dot products and
    // shuffles interleaved), in order: online softmax in base 2
    // (every lane takes the same steps: the shuffles need the whole warp)
    for (int j0 = warp * PW + slot; j0 - slot < wend; j0 += U * rpw) {
      float s[U], vv[U][VEC];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * rpw;
        const bool in = j < wend;
        ok[u] = in && p0 + j >= lo && p0 + j < clen;
        float kv[VEC];
        load16(k_s + (in ? j : warp * PW) * hd + d0, kv);
        load16(v_s + (in ? j : warp * PW) * hd + d0, vv[u]);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qv[e], kv[e], d);
        s[u] = dvalid ? d : 0.f;
      }
      for (int off = 1; off < lpr; off <<= 1)
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(~0u, s[u], off);
      float mn = m;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mn = fmaxf(mn, s[u]);
      if (mn == -INFINITY) continue;  // no valid position yet
      const float corr = weight(m, mn);
      l *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        const float p = exp2f(s[u] - mn);
        l += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vv[u][e], acc[e]);
      }
      m = mn;
    }
    // merge the warp's row groups: the lower slot first, in every lane
    for (int off = lpr; off < 32; off <<= 1) {
      const bool lower = (lane & off) == 0;
      const float m2 = __shfl_xor_sync(~0u, m, off);
      const float l2 = __shfl_xor_sync(~0u, l, off);
      const float mlo = lower ? m : m2, mhi = lower ? m2 : m;
      const float llo = lower ? l : l2, lhi = lower ? l2 : l;
      const float mx = fmaxf(mlo, mhi);
      const float wlo = weight(mlo, mx), whi = weight(mhi, mx);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a2 = __shfl_xor_sync(~0u, acc[e], off);
        const float alo = lower ? acc[e] : a2;
        const float ahi = lower ? a2 : acc[e];
        acc[e] = fmaf(alo, wlo, ahi * whi);
      }
      l = fmaf(llo, wlo, lhi * whi);
      m = mx;
    }
    if (slot == 0) {
      if (dvalid)
#pragma unroll
        for (int e = 0; e < VEC; ++e) wacc[warp * hd + d0 + e] = acc[e];
      if (lane == 0) {
        wm[warp] = m;
        wl[warp] = l;
      }
    }
    __syncthreads();
    // the warps in warp order: the chunk's (m, l, acc) of head g
    float* sg = st + g * (hd + 2);
    for (int d = tid; d < hd; d += DT) {
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w]);
      float a = 0.f, ll = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float wt = weight(wm[w], mx);
        a = fmaf(wacc[w * hd + d], wt, a);
        ll = fmaf(wl[w], wt, ll);
      }
      sg[2 + d] = a;
      if (d == 0) {
        sg[0] = mx;
        sg[1] = ll;
      }
    }
    __syncthreads();
  }

  // the last live chunk of (b, kv head) merges the chunks
  if (tid == 0) last = repro::count_acq_rel(counters + bh) == c_hi - c_lo;
  __syncthreads();
  if (!last) return;
  const float* sb = work + static_cast<size_t>(bh) * nchunk * group * (hd + 2);
  const size_t cstride = static_cast<size_t>(group) * (hd + 2);
  for (int i = tid; i < group * hd; i += DT) {
    const int g = i / hd;
    const int d = i % hd;
    const float* sg = sb + g * (hd + 2);
    // online merge in chunk order; NB chunks' states loaded at once
    float mx = -INFINITY, a = 0.f, ll = 0.f;
    for (int c0 = c_lo; c0 <= c_hi; c0 += NB) {
      float mv[NB], lv[NB], av[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const bool in = c0 + u <= c_hi;
        const float* sc = sg + (in ? c0 + u : c0) * cstride;
        mv[u] = in ? __ldcg(sc) : -INFINITY;
        lv[u] = in ? __ldcg(sc + 1) : 0.f;
        av[u] = in ? __ldcg(sc + 2 + d) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        if (mv[u] == -INFINITY) continue;  // past the last live chunk
        const float mn = fmaxf(mx, mv[u]);
        const float wo = weight(mx, mn), wn = exp2f(mv[u] - mn);
        a = fmaf(a, wo, av[u] * wn);
        ll = fmaf(ll, wo, lv[u] * wn);
        mx = mn;
      }
    }
    if (lse) {
      of_b[i] = ll > 0.f ? a / ll : 0.f;
      if (d == 0)
        lse[b * H + kvh * group + g] =
            ll > 0.f ? fmaf(mx, LN2, logf(ll)) : -INFINITY;
    } else {
      o_b[i] = repro::from_f<T>(ll > 0.f ? a / ll : 0.f);
    }
  }
  if (tid == 0) counters[bh] = 0;
}

template <typename T, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* page_table, const int* cache_len, float* work,
                   int* counters, void* out, float* lse, int B, int S,
                   int seq_lo, int cap, int n_pages, int ps, int p_max,
                   int H, int KVH, int hd, int window, float scale,
                   cudaStream_t stream) {
  const int smem = static_cast<int>(smem_bytes<T>(H / KVH, hd));
  const cudaError_t e = repro::mma::allow_smem(decode_kernel<T, PAGED>, smem);
  if (e != cudaSuccess) return e;
  const int capacity = PAGED ? p_max * ps : S;
  const dim3 grid((capacity + CH - 1) / CH, KVH, B);
  decode_kernel<T, PAGED><<<grid, DT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), page_table, cache_len, work, counters, out,
      lse, S, seq_lo, cap, n_pages, ps, p_max, H, KVH, hd, window, scale);
  return cudaGetLastError();
}

// lse null: the whole cache (seq_lo 0, cap the capacity), out in T;
// else one block of a split cache, out and lse in fp32
template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v,
             const void* page_table, const void* cache_len, void* work,
             void* counters, void* out, void* lse, int B, int S, int seq_lo,
             int cap, int n_pages, int ps, int p_max, int H, int KVH, int hd,
             int window, float scale, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || hd <= 0 || hd % 8 != 0 || hd > MAX_HD ||
      seq_lo < 0)
    return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const int* pt = static_cast<const int*>(page_table);
  const int* cl = static_cast<const int*>(cache_len);
  float* wk = static_cast<float*>(work);
  int* ctr = static_cast<int*>(counters);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float, PAGED>(q, k, v, pt, cl, wk, ctr, out, ls, B, S,
                                seq_lo, cap, n_pages, ps, p_max, H, KVH, hd,
                                window, scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16, PAGED>(q, k, v, pt, cl, wk, ctr, out, ls, B,
                                        S, seq_lo, cap, n_pages, ps, p_max,
                                        H, KVH, hd, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// floats of fp32 workspace a call needs for B sequences of `capacity`
// cache positions (the caller allocates it; its contents need not be
// initialised); the caller also keeps B * KVH int32 counters, zeroed once:
// each call leaves them zero
extern "C" long long decode_attention_work(int B, int capacity, int H,
                                           int hd) {
  return static_cast<long long>(B) * ((capacity + CH - 1) / CH) * H *
         (hd + 2);
}

// cache positions per chunk: one CTA per (chunk, kv head, sequence)
extern "C" int decode_attention_chunk() { return CH; }

// dynamic shared memory of a CTA (bytes) for a GQA group and head dim
extern "C" int decode_attention_smem(int group, int hd, int dtype) {
  return static_cast<int>(dtype == REPRO_DTYPE_F32
                              ? smem_bytes<float>(group, hd)
                              : smem_bytes<__nv_bfloat16>(group, hd));
}

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_len, void* work,
                                void* counters, void* out, int B, int S,
                                int H, int KVH, int hd, int window,
                                float scale, int dtype, void* stream) {
  if (S <= 0) return cudaErrorInvalidValue;
  return dispatch<false>(q, k, v, nullptr, cache_len, work, counters, out,
                         nullptr, B, S, 0, S, 1, 1, 1, H, KVH, hd, window,
                         scale, dtype, stream);
}

// one block of a cache split over its sequence: k/v (B, S, KVH, hd) hold
// global positions [seq_lo, seq_lo + S); cache_len is global.  Writes out
// (B, H, hd) and lse (B, H), both fp32; a row with no valid position in
// the block gets zeros and lse = -inf.  Workspace and counters as for
// decode_attention over S positions.
extern "C" int decode_attention_partial(const void* q, const void* k,
                                        const void* v, const void* cache_len,
                                        void* work, void* counters, void* out,
                                        void* lse, int B, int S, int seq_lo,
                                        int H, int KVH, int hd, int window,
                                        float scale, int dtype,
                                        void* stream) {
  if (S <= 0 || lse == nullptr) return cudaErrorInvalidValue;
  return dispatch<false>(q, k, v, nullptr, cache_len, work, counters, out,
                         lse, B, S, seq_lo, INT_MAX, 1, 1, 1, H, KVH, hd,
                         window, scale, dtype, stream);
}

extern "C" int decode_attention_paged(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table,
                                      const void* cache_len, void* work,
                                      void* counters, void* out, int B,
                                      int n_pages, int ps, int p_max, int H,
                                      int KVH, int hd, int window, float scale,
                                      int dtype, void* stream) {
  if (n_pages <= 0 || ps <= 0 || p_max <= 0) return cudaErrorInvalidValue;
  return dispatch<true>(q, k_pool, v_pool, page_table, cache_len, work,
                        counters, out, nullptr, B, 0, 0, p_max * ps, n_pages,
                        ps, p_max, H, KVH, hd, window, scale, dtype, stream);
}
