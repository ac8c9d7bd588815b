// Flash attention forward (causal / sliding window / GQA) for Hopper's
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (body _fwd_kernel, tile predicate _tile_live,
// element mask _pair_mask).
//
// Computes out = softmax(scale * q k^T + mask) v and lse = m + log(l) per
// query row, for q (B, Sq, H, hd), k/v (B, Sk, KVH, hd), out like q, lse
// (B*H, Sq) fp32 in natural log.  KV head of query head h is h / (H / KVH).
// Key kj is visible to query position p = qi + q_offset iff kj < Sk, (not
// causal or p >= kj) and (window == 0 or p - kj < window).  Rows that see
// no key get zeros and lse = 0, as in the TPU kernel's finalize.
//
// What bounds it on the H100: 4 * hd FLOPs per visible (q, k) pair (two
// products) against 16 * S * H * hd bytes of q/k/v/out in fp32, about S/8
// FLOPs per byte after the causal half: operations bound from S of a few
// hundred up.  In fp32 the fastest fp32-accurate route is 3xTF32 on the
// tensor cores (3 TF32 MMAs per product at 495 TFLOP/s, an effective
// 165 TFLOP/s), the same route PyTorch's fp32 SDPA takes.
//
// Design (FlashAttention-2 on mma.sync; flash_mma.cuh has the fragments):
//  * one CTA per (b*h, tile of 64 query rows), 4 warps of 16 rows each.
//    (CTAs of one warp, which spread the serving prefill's small grid,
//    B*H = 12 x 2 tiles, over more SMs, ran slower there: the four warps
//    share each K/V tile's load.)  The key tiles and the order of a row's
//    sums never depend on Sq or the grid;
//  * K/V tiles of 64 keys are double-buffered in shared memory with
//    16-byte cp.async: tile j+1 loads while tile j computes.  The Q tile
//    is staged through the second buffer before the loop and held in
//    registers as MMA fragments.  Rows are padded (flash_mma.cuh Pad) so
//    that every fragment load is free of bank conflicts;
//  * S = Q K^T and O += P V run on mma.sync: 3xTF32 m16n8k8 for fp32 (no
//    one-pass TF32: fp32 keeps fp32-class error), m16n8k16 for bf16 with P
//    rounded to bf16.  The online softmax steps over 32-key blocks of the
//    tile, on the accumulator fragments: row max by quad shuffles, exp2
//    with log2(e) folded into the scale; the row sum stays per thread until
//    the end.  32-key blocks keep the registers under 3 CTAs per SM
//    (__launch_bounds__) without spills up to hd 64.  At hd 128 the Q
//    fragments and the output accumulator double: in bf16 (70 KB of
//    tiles) the registers are held to two CTAs per SM (fwd_min_ctas); in
//    fp32 the Q fragments alone would be 64 registers beside the
//    accumulator's 64, which spilled at 255, so the Q tile stays in a
//    fifth shared-memory tile (169 KB: one CTA per SM) and a warp reads
//    its fragments from there per k step, as the backward does
//    (fwd_q_in_smem);
//  * a warp skips the tiles and 32-key blocks outside the causal/window
//    band of its 16 rows, the _tile_live predicate; whole tiles outside
//    the CTA's band are never loaded;
//  * ragged tails of Sq and Sk are zero-filled and masked, so no shape has
//    to divide a tile (the TPU kernel requires it);
//  * masked keys contribute exactly 0 (never exp of a sentinel), and a
//    tile a row cannot see leaves its state bit for bit as it was, so a
//    row's result does not depend on keys it cannot see: a prompt padded
//    to a bucket gives the same rows as the prompt alone.
#include "flash_mma.cuh"

namespace {

using repro::fa::BK;
using repro::fa::Mma;

constexpr int NW = 4;   // warps per CTA, 16 query rows each
constexpr int NS = 32;  // keys per online-softmax step

// the Q tile read from shared memory per k step instead of registers
template <typename T, int HD>
__host__ __device__ constexpr bool fwd_q_in_smem() {
  return HD > 64 && sizeof(T) == 4;
}

// two stages of K and V tiles, and the Q tile where it stays there
template <typename T, int HD>
constexpr int fwd_smem_bytes() {
  return (fwd_q_in_smem<T, HD>() ? 5 : 4) * BK *
         (HD + repro::fa::Pad<T>::value) * sizeof(T);
}

// CTAs per SM the registers are held to (__launch_bounds__)
template <typename T, int HD>
constexpr int fwd_min_ctas() {
  return HD <= 64 ? 3 : sizeof(T) == 4 ? 1 : 2;
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * NW, (fwd_min_ctas<T, HD>()))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                 int q_offset, int causal, int window, float scale,
                 float scale_log2) {
  using M = Mma<T>;
  constexpr int BQ = 16 * NW;
  constexpr int LD = HD + repro::fa::Pad<T>::value;
  constexpr int TILE = BK * LD;
  constexpr int NKC = HD / M::K;  // k steps over the head dim
  constexpr int NN = NS / 8;      // 8-key accumulator tiles per key block
  constexpr int ND = HD / 8;      // 8-wide accumulator tiles of the output
  constexpr int KPT = M::K / 8;   // accumulator tiles per P.V k step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // stage s: K at 2s, V at 2s+1

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KVH);
  const int q0 = blockIdx.x * BQ;
  const size_t q_rs = static_cast<size_t>(H) * HD;
  const size_t kv_rs = static_cast<size_t>(KVH) * HD;
  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * HD;

  // keys visible to any row of this CTA (the _tile_live band)
  const int first = q0 + q_offset;
  const int last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int k_hi = causal ? min(Sk, last + 1) : Sk;
  int k_lo = window > 0 ? max(0, first - window + 1) : 0;
  k_lo = (k_lo / BK) * BK;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = k_lo + tile * BK;
    T* ks = sm + 2 * stage * TILE;
    repro::fa::load_tile<T, HD, LD>(ks, kb + k0 * kv_rs, kv_rs, BK, Sk - k0,
                                    tid, 32 * NW);
    repro::fa::load_tile<T, HD, LD>(ks + TILE, vb + k0 * kv_rs, kv_rs, BK,
                                    Sk - k0, tid, 32 * NW);
  };

  // the Q tile through stage 1's K buffer (or into its own tile after
  // the stages), the first K/V tile into stage 0
  constexpr bool QS = fwd_q_in_smem<T, HD>();
  T* qtile = sm + (QS ? 4 : 2) * TILE;
  repro::fa::load_tile<T, HD, LD>(qtile, qb + q0 * q_rs, q_rs, BQ, Sq - q0,
                                  tid, 32 * NW);
  if (ntiles > 0) load_kv(0, 0);
  repro::fa::cp_async_commit();
  repro::fa::cp_async_wait<0>();
  __syncthreads();
  const T* qsm = qtile + 16 * warp * LD;  // this warp's rows
  typename M::A qf[QS ? 1 : NKC];
  if constexpr (!QS) {
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc)
      qf[kc] = M::load_a(qsm + kc * M::K, LD, g, t);
    __syncthreads();
  }

  // this warp's rows and their band of keys (none past Sq)
  const int w0 = q0 + 16 * warp;
  const int wfirst = w0 + q_offset;
  const int wlast = min(w0 + 16, Sq) - 1 + q_offset;
  const int wk_hi = w0 >= Sq ? -1 : causal ? min(Sk, wlast + 1) : Sk;
  const int wk_lo = window > 0 ? max(0, wfirst - window + 1) : 0;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) repro::fa::zero(acc[j]);
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sum

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = k_lo + it * BK;
    if (it + 1 < ntiles) load_kv(it + 1, (it + 1) & 1);
    repro::fa::cp_async_commit();
    repro::fa::cp_async_wait<1>();
    __syncthreads();
    const T* ks = sm + 2 * (it & 1) * TILE;
    const T* vs = ks + TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += NS) {
      const int kb0 = k0 + c0;
      if (kb0 >= wk_hi || kb0 + NS <= wk_lo) continue;
      float s[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n) repro::fa::zero(s[n]);
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
        typename M::AP a;
        if constexpr (QS)
          a = M::prep_a(M::load_a(qsm + kc * M::K, LD, g, t));
        else
          a = M::prep_a(qf[kc]);
#pragma unroll
        for (int n = 0; n < NN; ++n)
          M::mma(s[n], a, M::prep_b(M::load_b_nk(
                              ks + (c0 + 8 * n) * LD + kc * M::K, LD, g, t)));
      }
      // every pair of the block visible to every row of the warp?
      const bool full = kb0 + NS <= Sk &&
                        (!causal || wfirst >= kb0 + NS - 1) &&
                        (window <= 0 || wlast - kb0 < window);
      if (!full) {
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = kb0 + 8 * n + 2 * t + (e & 1);
            if (!(kj < Sk &&
                  repro::fa::visible(wfirst + g + 8 * (e >> 1), kj, causal,
                                     window)))
              s[n][e] = -INFINITY;
          }
      }
      // online softmax, rows g (i = 0) and g + 8 (i = 1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NN; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // m = -inf -> alpha 0; an unchanged max rescales by exactly 1
        const float alpha =
            m_new == m[i] ? 1.f : exp2f((m[i] - m_new) * scale_log2);
        const float ms = m_new == -INFINITY ? 0.f : m_new * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float p = s[n][e] == -INFINITY
                                ? 0.f
                                : exp2f(fmaf(s[n][e], scale_log2, -ms));
            s[n][e] = p;
            sum += p;
          }
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[j][2 * i] *= alpha;
          acc[j][2 * i + 1] *= alpha;
        }
      }
      // O += P V
#pragma unroll
      for (int kc = 0; kc < NN / KPT; ++kc) {
        const typename M::AP a = M::prep_a(M::a_from_c(&s[kc * KPT]));
#pragma unroll
        for (int j = 0; j < ND; ++j)
          M::mma(acc[j], a, M::prep_b(M::load_b_kn(
                                vs + (c0 + kc * M::K) * LD + 8 * j, LD, g, t)));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float ls = l[i];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const int qi = w0 + g + 8 * i;
    if (qi >= Sq) continue;
    const float ll = ls == 0.f ? 1.f : ls;
    T* op = out + (static_cast<size_t>(b) * Sq + qi) * q_rs + h * HD;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      op[8 * j + 2 * t] = repro::from_f<T>(acc[j][2 * i] / ll);
      op[8 * j + 2 * t + 1] = repro::from_f<T>(acc[j][2 * i + 1] / ll);
    }
    if (t == 0)
      lse[static_cast<size_t>(bh) * Sq + qi] =
          (m[i] == -INFINITY ? 0.f : m[i] * scale) + logf(ll);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Sq, int Sk, int H, int KVH,
                      int q_offset, int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<T, HD>();
  static const cudaError_t opt_in =
      repro::fa::allow_smem(flash_fwd_kernel<T, HD>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((Sq + 16 * NW - 1) / (16 * NW), B * H);
  flash_fwd_kernel<T, HD><<<grid, 32 * NW, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, KVH,
      q_offset, causal, window, scale, scale * repro::fa::LOG2E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int H, int KVH, int hd,
                   int q_offset, int causal, int window, float scale,
                   cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, lse, B, Sq, Sk, H, KVH, q_offset,
                              causal, window, scale, s);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, KVH, q_offset,
                              causal, window, scale, s);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, KVH, q_offset,
                              causal, window, scale, s);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, KVH,
                               q_offset, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dynamic shared memory of one forward CTA, in bytes (-1: not a config)
extern "C" int flash_fwd_smem(int hd, int dtype) {
  using BF = __nv_bfloat16;
  const bool f32 = dtype == REPRO_DTYPE_F32;
  switch (hd) {
    case 16: return f32 ? fwd_smem_bytes<float, 16>() : fwd_smem_bytes<BF, 16>();
    case 32: return f32 ? fwd_smem_bytes<float, 32>() : fwd_smem_bytes<BF, 32>();
    case 64: return f32 ? fwd_smem_bytes<float, 64>() : fwd_smem_bytes<BF, 64>();
    case 128: return f32 ? fwd_smem_bytes<float, 128>() : fwd_smem_bytes<BF, 128>();
    default: return -1;
  }
}

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int Sq, int Sk, int H,
                         int KVH, int hd, int q_offset, int causal, int window,
                         float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return cudaSuccess;
  if (KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
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
