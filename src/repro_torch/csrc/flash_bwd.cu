// Flash attention backward (causal / sliding window / GQA) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_bwd_pallas (bodies _bwd_dq_kernel and _bwd_dkv_kernel,
// shared tile math _bwd_p_ds).
//
// From the forward's residuals, q (B, Sq, H, hd), k/v (B, Sk, KVH, hd),
// lse (B*H, Sq) fp32, the output gradient dO (B, Sq, H, hd) and
// delta = rowsum(dO * O) (B*H, Sq) fp32 (computed by the wrapper):
//
//   s  = scale * q k^T  (masked)      p  = exp(s - lse)   (0 where masked)
//   dp = dO v^T                       ds = p * (dp - delta) * scale
//   dq = ds k        dk = ds^T q      dv = p^T dO
//
// The mask is the forward's: key kj is visible to query position
// p = qi + q_offset iff (not causal or p >= kj) and (window == 0 or
// p - kj < window).  A masked pair contributes an exact 0: p is never
// exp(sentinel - lse), so a row that sees no key (lse 0, out 0 in the
// forward) gets zero gradients.
//
// What bounds it on the H100: at the training path (B*H = 240, S = 512,
// hd 64, causal, fp32) the two kernels do 5 products of 2 * hd FLOPs
// (s, dp, dq, dk, dv) for each of the 31.5 M visible pairs, ~20 GFLOP,
// against ~250 MB of q/k/v/out/dO/dq/dk/dv: operations bound (fp32
// outside the tensor cores, 67 TFLOP/s, 0.30 ms).
//
// Design (simple and right first; wgmma/TMA come later):
//  * two kernels, because the TPU kernels' accumulators live in scratch
//    that persists across a sequential grid, which Hopper does not have;
//    each accumulator here stays in registers of one CTA instead:
//      - dq: one CTA per (b*h, tile of BQ query rows) loops over the KV
//        tiles of the causal/window band, like the forward;
//      - dk/dv: one CTA per (b, kv head, tile of BK key rows) loops over
//        the GQA group's query heads and the live query tiles, so the
//        group sum is a loop in one CTA: deterministic, no atomics;
//  * two threads per row, each owning every other element of the head
//    dim (interleaved, so the pair reads adjacent shared-memory words);
//    the dot products s and dp are completed with one shuffle;
//  * the operand tiles of the other side (K/V for dq, q/dO for dk/dv)
//    are staged in shared memory as fp32 and read by all threads of a
//    warp at the same row (broadcast);
//  * ragged tails of Sq and Sk are masked, so no shape has to divide a
//    tile; accumulation is fp32 for fp32 and bf16 inputs.
#include "common.cuh"

namespace {

constexpr int BQ = 64;           // query rows per dq CTA / per dk-dv q tile
constexpr int BK = 64;           // key rows per dk-dv CTA / per dq k tile
constexpr int NT = 2 * BQ;       // threads per CTA: two per row
static_assert(BQ == BK, "one thread layout for both kernels");

__device__ __forceinline__ bool visible(int qpos, int kj, int causal,
                                        int window) {
  return (!causal || qpos >= kj) && (window <= 0 || qpos - kj < window);
}

// dq for BQ query rows of one (b, h).
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KVH, int q_offset, int causal,
                    int window, float scale) {
  constexpr int HH = HD / 2;
  __shared__ float ks[BK][HD];
  __shared__ float vs[BK][HD];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int qi = q0 + tid / 2;
  const bool row_ok = qi < Sq;
  const int qpos = qi + q_offset;

  float qr[HH], dor[HH], acc[HH];
  const size_t qoff = ((static_cast<size_t>(b) * Sq + (row_ok ? qi : 0)) * H + h) * HD;
#pragma unroll
  for (int t = 0; t < HH; ++t) {
    const int d = 2 * t + half;
    qr[t] = row_ok ? repro::to_f(q[qoff + d]) * scale : 0.f;
    dor[t] = row_ok ? repro::to_f(dout[qoff + d]) : 0.f;
    acc[t] = 0.f;
  }
  const size_t ridx = static_cast<size_t>(bh) * Sq + (row_ok ? qi : 0);
  const float l_i = row_ok ? lse[ridx] : 0.f;
  const float d_i = row_ok ? delta[ridx] : 0.f;

  // keys visible to any row of this CTA (the _tile_live band)
  const int first = q0 + q_offset;
  const int last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, last + 1) : Sk;
  int k_lo = window > 0 ? max(0, first - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * HD; i += NT) {
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
    const int jmax = min(BK, Sk - k0);
    for (int j = 0; j < jmax; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int t = 0; t < HH; ++t) {
        s = fmaf(qr[t], ks[j][2 * t + half], s);
        dp = fmaf(dor[t], vs[j][2 * t + half], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const bool ok = row_ok && visible(qpos, k0 + j, causal, window);
      const float p = ok ? expf(s - l_i) : 0.f;
      const float ds = p * (dp - d_i) * scale;
#pragma unroll
      for (int t = 0; t < HH; ++t) acc[t] = fmaf(ds, ks[j][2 * t + half], acc[t]);
    }
  }

  if (row_ok) {
    T* o = dq + qoff;
#pragma unroll
    for (int t = 0; t < HH; ++t) o[2 * t + half] = repro::from_f<T>(acc[t]);
  }
}

// dk and dv for BK key rows of one (b, kv head): the GQA group's heads
// and the live query tiles are a loop inside the CTA.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                     int q_offset, int causal, int window, float scale) {
  constexpr int HH = HD / 2;
  __shared__ float qs[BQ][HD];
  __shared__ float dos[BQ][HD];
  __shared__ float ls[BQ];
  __shared__ float dls[BQ];

  const int bkv = blockIdx.y;
  const int b = bkv / KVH;
  const int kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int kj = k0 + tid / 2;
  const bool row_ok = kj < Sk;

  float kr[HH], vr[HH], dkr[HH], dvr[HH];
  const size_t koff = ((static_cast<size_t>(b) * Sk + (row_ok ? kj : 0)) * KVH + kvh) * HD;
#pragma unroll
  for (int t = 0; t < HH; ++t) {
    const int d = 2 * t + half;
    kr[t] = row_ok ? repro::to_f(k[koff + d]) : 0.f;
    vr[t] = row_ok ? repro::to_f(v[koff + d]) : 0.f;
    dkr[t] = 0.f;
    dvr[t] = 0.f;
  }

  // query rows that see any key of this CTA: q_pos >= k0 (causal) and
  // q_pos - (last key) < window
  const int k_last = min(k0 + BK, Sk) - 1;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int qt0 = q_lo; qt0 < q_hi; qt0 += BQ) {
      __syncthreads();
      for (int i = tid; i < BQ * HD; i += NT) {
        const int r = i / HD;
        const int d = i % HD;
        const int qi = qt0 + r;
        float qv = 0.f, dov = 0.f;
        if (qi < q_hi) {
          const size_t off = ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD + d;
          qv = repro::to_f(q[off]);
          dov = repro::to_f(dout[off]);
        }
        qs[r][d] = qv;
        dos[r][d] = dov;
      }
      for (int r = tid; r < BQ; r += NT) {
        const int qi = qt0 + r;
        ls[r] = qi < q_hi ? lse[bh * Sq + qi] : 0.f;
        dls[r] = qi < q_hi ? delta[bh * Sq + qi] : 0.f;
      }
      __syncthreads();
      const int rmax = min(BQ, q_hi - qt0);
      for (int r = 0; r < rmax; ++r) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int t = 0; t < HH; ++t) {
          s = fmaf(qs[r][2 * t + half] * scale, kr[t], s);
          dp = fmaf(dos[r][2 * t + half], vr[t], dp);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const bool ok = row_ok && visible(qt0 + r + q_offset, kj, causal, window);
        const float p = ok ? expf(s - ls[r]) : 0.f;
        const float ds = p * (dp - dls[r]) * scale;
#pragma unroll
        for (int t = 0; t < HH; ++t) {
          dvr[t] = fmaf(p, dos[r][2 * t + half], dvr[t]);
          dkr[t] = fmaf(ds, qs[r][2 * t + half], dkr[t]);
        }
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int t = 0; t < HH; ++t) {
      dk[koff + 2 * t + half] = repro::from_f<T>(dkr[t]);
      dv[koff + 2 * t + half] = repro::from_f<T>(dvr[t]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                      int H, int KVH, int q_offset, int causal, int window,
                      float scale, cudaStream_t stream) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* dd = static_cast<const T*>(dout);
  const dim3 grid_q((Sq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, HD><<<grid_q, NT, 0, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KVH,
      q_offset, causal, window, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_k((Sk + BK - 1) / BK, B * KVH);
  flash_bwd_dkv_kernel<T, HD><<<grid_k, NT, 0, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KVH, q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                   int KVH, int hd, int q_offset, int causal, int window,
                   float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq,
                              Sk, H, KVH, q_offset, causal, window, scale, s);
    case 32:
      return launch_hd<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq,
                              Sk, H, KVH, q_offset, causal, window, scale, s);
    case 64:
      return launch_hd<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq,
                              Sk, H, KVH, q_offset, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// lse and delta: (B*H, Sq) fp32.  dq like q; dk, dv like k.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                         int H, int KVH, int hd, int q_offset, int causal,
                         int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, H, KVH,
                         hd, q_offset, causal, window, scale, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk,
                                 H, KVH, hd, q_offset, causal, window, scale,
                                 s);
  return cudaErrorInvalidValue;
}
