// Flash attention forward (causal / sliding window / GQA) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (body _fwd_kernel, tile predicate _tile_live,
// element mask _pair_mask).
//
// Computes out = softmax(scale * q k^T + mask) v and lse = m + log(l) per
// query row, for q (B, Sq, H, hd), k/v (B, Sk, KVH, hd), out like q, lse
// (B*H, Sq) fp32.  KV head of query head h is h / (H / KVH).  Key kj is
// visible to query position p = qi + q_offset iff kj < Sk, (not causal or
// p >= kj) and (window == 0 or p - kj < window).  Rows that see no key
// get zeros and lse = 0, as in the TPU kernel's finalize.
//
// What bounds it on the H100: at the serving path's prefill (B=1, S=128..
// 1024, H=12, hd=64, fp32) the work is 4*hd FLOPs per visible (q, k) pair
// against 4*S*H*hd*4 bytes of q/k/v/out, i.e. about S/8 FLOPs per byte
// after the causal half: operations bound (fp32, outside the tensor cores,
// 67 TFLOP/s) from S of a few hundred up.
//
// Design (simple and right first; wgmma/TMA come later):
//  * one CTA per (b*h, tile of BQ query rows), one thread per query row,
//    so the TPU grid's sequential KV axis with persistent scratch becomes
//    a loop inside the CTA; the row's q (pre-scaled), running max, sum and
//    output accumulator stay in registers, fp32;
//  * K/V tiles of BK keys are staged in shared memory as fp32 and read by
//    every thread of the CTA at the same address (broadcast);
//  * whole tiles outside the causal/window band of the CTA's rows are
//    never loaded: the key loop runs over [k_lo, k_hi) only, the same
//    predicate as _tile_live;
//  * ragged tails of Sq and Sk are masked, so no shape has to divide BQ
//    or BK (the TPU kernel requires it);
//  * masked keys contribute exactly 0 (never exp of a sentinel), so a
//    row's result does not depend on keys it cannot see: a prompt padded
//    to a bucket gives the same rows as the prompt alone.
#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per CTA (one thread each)
constexpr int BK = 64;  // keys per shared-memory tile
constexpr int CH = 16;  // keys per online-softmax step

template <typename T, int HD>
__global__ void __launch_bounds__(BQ)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                 int q_offset, int causal, int window, float scale) {
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int qi = q0 + tid;
  const bool row_ok = qi < Sq;
  const int qpos = qi + q_offset;

  float qr[HD];
  float acc[HD];
  const T* qp = q + ((static_cast<size_t>(b) * Sq + (row_ok ? qi : 0)) * H + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = row_ok ? repro::to_f(qp[d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // keys visible to any row of this CTA (the _tile_live band)
  const int first = q0 + q_offset;
  const int last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, last + 1) : Sk;
  int k_lo = window > 0 ? max(0, first - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * HD; i += BQ) {
      const int j = i / HD;
      const int d = i % HD;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + kj) * KVH + kvh) * HD + d;
        kv = repro::to_f(k[off]);
        vv = repro::to_f(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (!row_ok) continue;  // the loop bounds are CTA-uniform

    for (int c = 0; c < BK; c += CH) {
      float s[CH];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int kj = k0 + c + jj;
        const bool ok = kj < Sk && (!causal || qpos >= kj) &&
                        (window <= 0 || qpos - kj < window);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[c + jj][d], dot);
        s[jj] = ok ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      if (cmax == -INFINITY) continue;
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);  // m = -inf -> 0
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const float p = s[jj] == -INFINITY ? 0.f : expf(s[jj] - m_new);
        l += p;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[c + jj][d], acc[d]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float ll = l == 0.f ? 1.f : l;
    T* op = out + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d] = repro::from_f<T>(acc[d] / ll);
    lse[static_cast<size_t>(bh) * Sq + qi] = (m == -INFINITY ? 0.f : m) + logf(ll);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int KVH, int hd,
                   int q_offset, int causal, int window, float scale,
                   cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  switch (hd) {
    case 16:
      flash_fwd_kernel<T, 16><<<grid, BQ, 0, stream>>>(
          qq, kk, vv, oo, lse, Sq, Sk, H, KVH, q_offset, causal, window, scale);
      break;
    case 32:
      flash_fwd_kernel<T, 32><<<grid, BQ, 0, stream>>>(
          qq, kk, vv, oo, lse, Sq, Sk, H, KVH, q_offset, causal, window, scale);
      break;
    case 64:
      flash_fwd_kernel<T, 64><<<grid, BQ, 0, stream>>>(
          qq, kk, vv, oo, lse, Sq, Sk, H, KVH, q_offset, causal, window, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Sq, int Sk, int H,
                         int KVH, int hd, int q_offset, int causal, int window,
                         float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(q, k, v, out, l, B, Sq, Sk, H, KVH, hd, q_offset,
                         causal, window, scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, out, l, B, Sq, Sk, H, KVH, hd,
                                 q_offset, causal, window, scale, s);
  return cudaErrorInvalidValue;
}
