// Flash-decode attention over a contiguous or a paged KV cache, for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/decode_attention/kernel.py
// decode_attention_pallas (body _kernel) and decode_attention_paged_pallas
// (body _paged_kernel).  One source: page indirection is the PAGED
// template flag.
//
// Computes, for one new query token per sequence b:
//   out[b, h] = softmax_j(scale * q[b, h] . k[b, j, h / group]) v[b, j, ...]
// over positions j in [lo, cache_len[b]), lo = max(0, cache_len - window)
// when window > 0, else 0.  q (B, H, hd); contiguous k/v (B, S, KVH, hd);
// paged k/v pools (n_pages, ps, KVH, hd) with page_table (B, P_max): page
// of position j is page_table[b, j / ps], clipped to [0, n_pages - 1] as
// decode_attention/ops.py does, so garbage and trash entries past the
// valid prefix are legal reads that cache_len masks.  cache_len = 0 gives
// exact zeros.  fp32 online softmax and accumulation.
//
// What bounds it on the H100: every cached K/V byte of the valid prefix is
// read once for 4 FLOPs per (head, position, dim) of work on 2 values, so
// at the serving decode tick (B = 8 slots, H = KVH = 12, hd = 64, fp32,
// cache_len ~ 128..160 of max_len 256) it is about 0.5 FLOP per byte:
// memory bound, ~7 MB of K/V per call, about 2 us at 3.35 TB/s.
//
// Design (simple and right first; a split-K "flash-decoding" design that
// spreads one long cache over several CTAs is later work):
//  * one CTA per (b, kv head); it holds the whole GQA group's queries, so
//    each K/V byte is read once per group, not once per query head;
//  * the CTA walks the cache in tiles of BS positions up to cache_len
//    (page by page through its own page-table row when PAGED), staging
//    K/V in shared memory; tiles past cache_len or before the window are
//    never loaded;
//  * scores go to shared memory, one thread per query head does the
//    online-softmax bookkeeping for the tile, and the output accumulators
//    (group x hd) are updated by all threads.
#include "common.cuh"

namespace {

constexpr int DT = 128;  // threads per CTA
constexpr int BS = 64;   // cache positions per tile

template <typename T, bool PAGED>
__global__ void __launch_bounds__(DT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ page_table,
              const int* __restrict__ cache_len, T* __restrict__ out, int S,
              int n_pages, int ps, int p_max, int H, int KVH, int hd,
              int window, float scale) {
  extern __shared__ float smem[];
  const int group = H / KVH;
  const int kstride = hd + 1;  // padded: the score loop reads K by position
  float* q_s = smem;                       // group * hd
  float* k_s = q_s + group * hd;           // BS * (hd + 1)
  float* v_s = k_s + BS * kstride;         // BS * hd
  float* s_s = v_s + BS * hd;              // group * BS
  float* acc_s = s_s + group * BS;         // group * hd
  float* m_s = acc_s + group * hd;         // group
  float* l_s = m_s + group;                // group
  float* alpha_s = l_s + group;            // group

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int capacity = PAGED ? p_max * ps : S;
  const int clen = min(max(cache_len[b], 0), capacity);
  const int lo = window > 0 ? max(0, clen - window) : 0;

  for (int i = tid; i < group * hd; i += DT) {
    const int h = kvh * group + i / hd;
    q_s[i] = repro::to_f(q[(static_cast<size_t>(b) * H + h) * hd + i % hd]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += DT) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  for (int t0 = (lo / BS) * BS; t0 < clen; t0 += BS) {
    __syncthreads();
    for (int i = tid; i < BS * hd; i += DT) {
      const int j = i / hd;
      const int d = i % hd;
      const int pos = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (pos >= lo && pos < clen) {
        size_t off;
        if (PAGED) {
          int page = page_table[static_cast<size_t>(b) * p_max + pos / ps];
          page = min(max(page, 0), n_pages - 1);
          off = ((static_cast<size_t>(page) * ps + pos % ps) * KVH + kvh) * hd + d;
        } else {
          off = ((static_cast<size_t>(b) * S + pos) * KVH + kvh) * hd + d;
        }
        kv = repro::to_f(k[off]);
        vv = repro::to_f(v[off]);
      }
      k_s[j * kstride + d] = kv;
      v_s[j * hd + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < group * BS; i += DT) {
      const int g = i / BS;
      const int j = i % BS;
      const int pos = t0 + j;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(q_s[g * hd + d], k_s[j * kstride + d], dot);
      s_s[i] = (pos >= lo && pos < clen) ? dot : -INFINITY;
    }
    __syncthreads();

    for (int g = tid; g < group; g += DT) {
      float* s = s_s + g * BS;
      float mx = -INFINITY;
      for (int j = 0; j < BS; ++j) mx = fmaxf(mx, s[j]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m_old - m_new);  // m_old = -inf -> 0
        for (int j = 0; j < BS; ++j) {
          const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
          s[j] = p;
          sum += p;
        }
      } else {
        for (int j = 0; j < BS; ++j) s[j] = 0.f;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      alpha_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < group * hd; i += DT) {
      const int g = i / hd;
      const int d = i % hd;
      float a = acc_s[i] * alpha_s[g];
      const float* p = s_s + g * BS;
      for (int j = 0; j < BS; ++j) a = fmaf(p[j], v_s[j * hd + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < group * hd; i += DT) {
    const int g = i / hd;
    const int h = kvh * group + g;
    const float l = l_s[g];
    out[(static_cast<size_t>(b) * H + h) * hd + i % hd] =
        repro::from_f<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

size_t smem_bytes(int group, int hd) {
  return sizeof(float) * (static_cast<size_t>(group) * hd + BS * (hd + 1) +
                          BS * hd + group * BS + group * hd + 3 * group);
}

template <typename T, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* page_table, const int* cache_len, void* out,
                   int B, int S, int n_pages, int ps, int p_max, int H,
                   int KVH, int hd, int window, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KVH, hd);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(KVH, B);
  decode_kernel<T, PAGED><<<grid, DT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), page_table, cache_len, static_cast<T*>(out), S,
      n_pages, ps, p_max, H, KVH, hd, window, scale);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v,
             const void* page_table, const void* cache_len, void* out, int B,
             int S, int n_pages, int ps, int p_max, int H, int KVH, int hd,
             int window, float scale, int dtype, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || hd <= 0) return cudaErrorInvalidValue;
  if (B <= 0) return cudaSuccess;
  const int* pt = static_cast<const int*>(page_table);
  const int* cl = static_cast<const int*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float, PAGED>(q, k, v, pt, cl, out, B, S, n_pages, ps,
                                p_max, H, KVH, hd, window, scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16, PAGED>(q, k, v, pt, cl, out, B, S, n_pages,
                                        ps, p_max, H, KVH, hd, window, scale,
                                        s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* cache_len, void* out, int B, int S,
                                int H, int KVH, int hd, int window,
                                float scale, int dtype, void* stream) {
  return dispatch<false>(q, k, v, nullptr, cache_len, out, B, S, 1, 1, 1, H,
                         KVH, hd, window, scale, dtype, stream);
}

extern "C" int decode_attention_paged(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table,
                                      const void* cache_len, void* out, int B,
                                      int n_pages, int ps, int p_max, int H,
                                      int KVH, int hd, int window, float scale,
                                      int dtype, void* stream) {
  if (n_pages <= 0 || ps <= 0 || p_max <= 0) return cudaErrorInvalidValue;
  return dispatch<true>(q, k_pool, v_pool, page_table, cache_len, out, B, 0,
                        n_pages, ps, p_max, H, KVH, hd, window, scale, dtype,
                        stream);
}
