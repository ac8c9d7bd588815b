// Flash attention backward (causal / sliding window / GQA) for Hopper's
// tensor cores.
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
// hd 64, causal, fp32) the backward needs 5 products of 2 * hd FLOPs (s,
// dp, dq, dk, dv) for each of the 31.5 M visible pairs, ~20 GFLOP,
// against ~250 MB of q/k/v/out/dO/dq/dk/dv: operations bound.  In fp32
// the fastest fp32-accurate route is 3xTF32 on the tensor cores (an
// effective 165 TFLOP/s, 0.12 ms).
//
// Design (FlashAttention-2 on mma.sync; flash_mma.cuh has the fragments,
// the 3xTF32 split for fp32 and m16n8k16 for bf16):
//  * two kernels and no atomics, so the result is deterministic: a run
//    twice on the same inputs gives the same bits.  The price is that s
//    and dp are computed in both, 7 products per visible pair instead of
//    5 (about 1.4x the bound's operations);
//      - dq: one CTA per (b*h, tile of 64 query rows), 4 warps of 16
//        rows, looping over the K/V tiles of the causal/window band like
//        the forward; dq += ds k stays in registers;
//      - dk/dv: one CTA per (b, kv head, tile of 64 keys), each warp
//        owning 16 keys, looping over the GQA group's query heads and the
//        live query tiles: the group sum is a loop inside one CTA.  The
//        warp computes s^T = k q^T and dp^T = v dO^T with keys as the MMA's
//        rows, so p^T and ds^T come out of the accumulators already in
//        the A-operand layout of dv += p^T dO and dk += ds^T q: no trip
//        through shared memory, no transpose;
//  * the tiles of the other side (K/V for dq; q, dO, lse and delta for
//    dk/dv) are double-buffered in shared memory with 16-byte cp.async
//    (lse and delta with plain loads), padded so that fragment loads are
//    free of bank conflicts; the CTA's own rows (q and dO, or k and v)
//    stay in shared memory after the stages, and a warp reads its A
//    fragments from there per k step, which keeps them out of registers;
//  * s and dp are recomputed 32 columns at a time; with the own rows in
//    shared memory a thread fits 2 CTAs per SM (__launch_bounds__) without
//    spills up to hd 64; a warp skips the blocks outside its band.  At hd
//    128 the fp32 dq CTA takes 203 KB of shared memory, so one CTA fits
//    an SM and the registers are held to that (the dk/dv accumulators
//    alone are 128 registers); bf16's 104 KB fit two (bwd_min_ctas);
//  * ragged tails of Sq and Sk are zero-filled and masked, so no shape has
//    to divide a tile; accumulation is fp32 for fp32 and bf16 inputs.
#include "flash_mma.cuh"

namespace {

using repro::fa::BK;
using repro::fa::Mma;

constexpr int NW = 4;   // warps per CTA, 16 rows (dq) or keys (dk/dv) each
constexpr int NS = 32;  // columns of s / dp recomputed at a time

// two stages of two 64-row tiles, then the CTA's own 16 * NW rows of two
// operands (q and dO, or k and v)
template <typename T, int HD>
constexpr int dq_smem_bytes() {
  return (4 * BK + 32 * NW) * (HD + repro::fa::Pad<T>::value) * sizeof(T);
}

// the dk/dv kernel adds lse and delta of two stages' query tiles
constexpr int LSE_BYTES = 4 * BK * static_cast<int>(sizeof(float));

template <typename T, int HD>
constexpr int dkv_smem_bytes() {
  return dq_smem_bytes<T, HD>() + LSE_BYTES;
}

// CTAs per SM the registers are held to (__launch_bounds__)
template <typename T, int HD>
constexpr int bwd_min_ctas() {
  return HD <= 64 || sizeof(T) == 2 ? 2 : 1;
}

// dq for 64 query rows of one (b, h).
template <typename T, int HD>
__global__ void __launch_bounds__(32 * NW, (bwd_min_ctas<T, HD>()))
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KVH, int q_offset, int causal,
                    int window, float scale, float scale_log2) {
  using M = Mma<T>;
  constexpr int BQ = 16 * NW;
  constexpr int LD = HD + repro::fa::Pad<T>::value;
  constexpr int TILE = BK * LD;
  constexpr int NKC = HD / M::K;
  constexpr int NN = NS / 8;      // accumulator tiles per recomputed block
  constexpr int ND = HD / 8;
  constexpr int KPT = M::K / 8;
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
  const size_t qoff = (static_cast<size_t>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Sk * KVH + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Sk * KVH + kvh) * HD;

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

  // the CTA's q and dO rows after the stages, the first K/V tile into
  // stage 0; a warp reads its rows' fragments from there as it needs them
  T* qsm = sm + 4 * TILE;
  T* dsm = qsm + BQ * LD;
  repro::fa::load_tile<T, HD, LD>(qsm, q + qoff + q0 * q_rs, q_rs, BQ,
                                  Sq - q0, tid, 32 * NW);
  repro::fa::load_tile<T, HD, LD>(dsm, dout + qoff + q0 * q_rs, q_rs, BQ,
                                  Sq - q0, tid, 32 * NW);
  if (ntiles > 0) load_kv(0, 0);
  repro::fa::cp_async_commit();
  qsm += 16 * warp * LD;
  dsm += 16 * warp * LD;

  const int w0 = q0 + 16 * warp;
  const bool warp_live = w0 < Sq;
  const int wfirst = w0 + q_offset;
  const int wlast = min(w0 + 16, Sq) - 1 + q_offset;
  const int wk_hi = causal ? min(Sk, wlast + 1) : Sk;
  const int wk_lo = window > 0 ? max(0, wfirst - window + 1) : 0;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w0 + g + 8 * i;
    const size_t r = static_cast<size_t>(bh) * Sq + (qi < Sq ? qi : 0);
    lse2[i] = qi < Sq ? lse[r] * repro::fa::LOG2E : 0.f;
    dl[i] = qi < Sq ? delta[r] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) repro::fa::zero(acc[j]);

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
      if (!warp_live || kb0 >= wk_hi || kb0 + NS <= wk_lo) continue;
      float s[NN][4], dp[NN][4];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        repro::fa::zero(s[n]);
        repro::fa::zero(dp[n]);
      }
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
        const typename M::AP aq =
            M::prep_a(M::load_a(qsm + kc * M::K, LD, g, t));
        const typename M::AP ad =
            M::prep_a(M::load_a(dsm + kc * M::K, LD, g, t));
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int row = (c0 + 8 * n) * LD + kc * M::K;
          M::mma(s[n], aq, M::prep_b(M::load_b_nk(ks + row, LD, g, t)));
          M::mma(dp[n], ad, M::prep_b(M::load_b_nk(vs + row, LD, g, t)));
        }
      }
      const bool full = kb0 + NS <= Sk &&
                        (!causal || wfirst >= kb0 + NS - 1) &&
                        (window <= 0 || wlast - kb0 < window);
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int kj = kb0 + 8 * n + 2 * t + (e & 1);
          const bool ok = full || (kj < Sk && repro::fa::visible(
                                                  wfirst + g + 8 * i, kj,
                                                  causal, window));
          const float p =
              ok ? exp2f(fmaf(s[n][e], scale_log2, -lse2[i])) : 0.f;
          s[n][e] = p * (dp[n][e] - dl[i]) * scale;  // ds
        }
      // dq += ds k
#pragma unroll
      for (int kc = 0; kc < NN / KPT; ++kc) {
        const typename M::AP a = M::prep_a(M::a_from_c(&s[kc * KPT]));
#pragma unroll
        for (int j = 0; j < ND; ++j)
          M::mma(acc[j], a,
                 M::prep_b(M::load_b_kn(ks + (c0 + kc * M::K) * LD + 8 * j,
                                        LD, g, t)));
      }
    }
    __syncthreads();
  }
  repro::fa::cp_async_wait<0>();  // no tile: the own rows' copies

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = w0 + g + 8 * i;
    if (qi >= Sq) continue;
    T* o = dq + qoff + qi * q_rs;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      o[8 * j + 2 * t] = repro::from_f<T>(acc[j][2 * i]);
      o[8 * j + 2 * t + 1] = repro::from_f<T>(acc[j][2 * i + 1]);
    }
  }
}

// dk and dv for 64 keys of one (b, kv head): the GQA group's heads and
// the live query tiles are a loop inside the CTA.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * NW, (bwd_min_ctas<T, HD>()))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                     int q_offset, int causal, int window, float scale,
                     float scale_log2) {
  using M = Mma<T>;
  constexpr int BKV = 16 * NW;
  constexpr int LD = HD + repro::fa::Pad<T>::value;
  constexpr int TILE = BK * LD;
  constexpr int NKC = HD / M::K;
  constexpr int NN = NS / 8;
  constexpr int ND = HD / 8;
  constexpr int KPT = M::K / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // stage s: q at 2s, dO at 2s+1
  T* ksm = sm + 4 * TILE;  // the CTA's k rows, then its v rows
  T* vsm = ksm + BKV * LD;
  // [stage][lse, delta][BK]
  float* rows = reinterpret_cast<float*>(vsm + BKV * LD);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int bkv = blockIdx.y;
  const int b = bkv / KVH;
  const int kvh = bkv % KVH;
  const int group = H / KVH;
  const int k0 = blockIdx.x * BKV;
  const size_t q_rs = static_cast<size_t>(H) * HD;
  const size_t kv_rs = static_cast<size_t>(KVH) * HD;
  const size_t koff = (static_cast<size_t>(b) * Sk * KVH + kvh) * HD;

  // query rows that see any key of this CTA
  const int k_last = min(k0 + BKV, Sk) - 1;
  const int q_lo = causal ? max(0, k0 - q_offset) : 0;
  const int q_hi = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;
  const int nqt = q_hi > q_lo ? (q_hi - q_lo + BK - 1) / BK : 0;
  const int ntiles = group * nqt;

  auto load_q = [&](int tile, int stage) {
    const int h = kvh * group + tile / nqt;
    const int qt = q_lo + (tile % nqt) * BK;
    const size_t off = (static_cast<size_t>(b) * Sq * H + h) * HD + qt * q_rs;
    T* qs = sm + 2 * stage * TILE;
    repro::fa::load_tile<T, HD, LD>(qs, q + off, q_rs, BK, Sq - qt, tid,
                                    32 * NW);
    repro::fa::load_tile<T, HD, LD>(qs + TILE, dout + off, q_rs, BK, Sq - qt,
                                    tid, 32 * NW);
    float* ls = rows + 2 * stage * BK;
    const size_t r0 = (static_cast<size_t>(b) * H + h) * Sq;
    for (int r = tid; r < BK; r += 32 * NW) {
      const int qi = qt + r;
      ls[r] = qi < Sq ? lse[r0 + qi] * repro::fa::LOG2E : 0.f;
      ls[BK + r] = qi < Sq ? delta[r0 + qi] : 0.f;
    }
  };

  // the CTA's k and v rows after the stages, the first q / dO tile into
  // stage 0; a warp reads its keys' fragments from there as it needs them
  repro::fa::load_tile<T, HD, LD>(ksm, k + koff + k0 * kv_rs, kv_rs, BKV,
                                  Sk - k0, tid, 32 * NW);
  repro::fa::load_tile<T, HD, LD>(vsm, v + koff + k0 * kv_rs, kv_rs, BKV,
                                  Sk - k0, tid, 32 * NW);
  if (ntiles > 0) load_q(0, 0);
  repro::fa::cp_async_commit();
  ksm += 16 * warp * LD;
  vsm += 16 * warp * LD;

  // this warp's keys and their band of query rows
  const int kw0 = k0 + 16 * warp;
  const bool warp_live = kw0 < Sk;
  const int kw_last = min(kw0 + 16, Sk) - 1;
  const int wq_lo = causal ? max(0, kw0 - q_offset) : 0;
  const int wq_hi = window > 0 ? min(Sq, kw_last + window - q_offset) : Sq;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    repro::fa::zero(dka[j]);
    repro::fa::zero(dva[j]);
  }

  for (int it = 0; it < ntiles; ++it) {
    const int qt = q_lo + (it % nqt) * BK;
    if (it + 1 < ntiles) load_q(it + 1, (it + 1) & 1);
    repro::fa::cp_async_commit();
    repro::fa::cp_async_wait<1>();
    __syncthreads();
    const T* qs = sm + 2 * (it & 1) * TILE;
    const T* dos = qs + TILE;
    const float* ls = rows + 2 * (it & 1) * BK;
#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += NS) {
      const int qb0 = qt + c0;
      if (!warp_live || qb0 >= wq_hi || qb0 + NS <= wq_lo) continue;
      float s[NN][4], dp[NN][4];  // s^T, dp^T: keys x queries
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        repro::fa::zero(s[n]);
        repro::fa::zero(dp[n]);
      }
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
        const typename M::AP ak =
            M::prep_a(M::load_a(ksm + kc * M::K, LD, g, t));
        const typename M::AP av =
            M::prep_a(M::load_a(vsm + kc * M::K, LD, g, t));
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const int row = (c0 + 8 * n) * LD + kc * M::K;
          M::mma(s[n], ak, M::prep_b(M::load_b_nk(qs + row, LD, g, t)));
          M::mma(dp[n], av, M::prep_b(M::load_b_nk(dos + row, LD, g, t)));
        }
      }
      // every (key, query) pair of the block visible?
      const bool full = qb0 + NS <= Sq && kw0 + 16 <= Sk &&
                        (!causal || qb0 + q_offset >= kw0 + 15) &&
                        (window <= 0 ||
                         qb0 + NS - 1 + q_offset - kw0 < window);
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * n + 2 * t + (e & 1);
          const int qi = qt + c;
          const int key = kw0 + g + 8 * (e >> 1);
          const bool ok =
              full || (qi < Sq && key < Sk &&
                       repro::fa::visible(qi + q_offset, key, causal, window));
          const float p = ok ? exp2f(fmaf(s[n][e], scale_log2, -ls[c])) : 0.f;
          dp[n][e] = p * (dp[n][e] - ls[BK + c]) * scale;  // ds^T
          s[n][e] = p;                                     // p^T
        }
      // dv += p^T dO, dk += ds^T q
#pragma unroll
      for (int kc = 0; kc < NN / KPT; ++kc) {
        const typename M::AP ap = M::prep_a(M::a_from_c(&s[kc * KPT]));
        const typename M::AP as = M::prep_a(M::a_from_c(&dp[kc * KPT]));
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          const int row = (c0 + kc * M::K) * LD + 8 * j;
          M::mma(dva[j], ap, M::prep_b(M::load_b_kn(dos + row, LD, g, t)));
          M::mma(dka[j], as, M::prep_b(M::load_b_kn(qs + row, LD, g, t)));
        }
      }
    }
    __syncthreads();
  }
  repro::fa::cp_async_wait<0>();  // no tile: the own rows' copies

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw0 + g + 8 * i;
    if (key >= Sk) continue;
    const size_t off = koff + key * kv_rs;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dk[off + 8 * j + 2 * t] = repro::from_f<T>(dka[j][2 * i]);
      dk[off + 8 * j + 2 * t + 1] = repro::from_f<T>(dka[j][2 * i + 1]);
      dv[off + 8 * j + 2 * t] = repro::from_f<T>(dva[j][2 * i]);
      dv[off + 8 * j + 2 * t + 1] = repro::from_f<T>(dva[j][2 * i + 1]);
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
  const float scale_log2 = scale * repro::fa::LOG2E;
  constexpr int smem_dq = dq_smem_bytes<T, HD>();
  constexpr int smem_dkv = dkv_smem_bytes<T, HD>();
  static const cudaError_t opt_in = [] {
    const cudaError_t e =
        repro::fa::allow_smem(flash_bwd_dq_kernel<T, HD>, smem_dq);
    return e != cudaSuccess
               ? e
               : repro::fa::allow_smem(flash_bwd_dkv_kernel<T, HD>, smem_dkv);
  }();
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid_q((Sq + 16 * NW - 1) / (16 * NW), B * H);
  flash_bwd_dq_kernel<T, HD><<<grid_q, 32 * NW, smem_dq, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KVH,
      q_offset, causal, window, scale, scale_log2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_k((Sk + 16 * NW - 1) / (16 * NW), B * KVH);
  flash_bwd_dkv_kernel<T, HD><<<grid_k, 32 * NW, smem_dkv, stream>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KVH, q_offset, causal, window, scale, scale_log2);
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
    case 128:
      return launch_hd<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq,
                               Sk, H, KVH, q_offset, causal, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dynamic shared memory of one dq (dkv = 0) or dk/dv (dkv = 1) CTA, in
// bytes (-1: not a config)
extern "C" int flash_bwd_smem(int dkv, int hd, int dtype) {
  using BF = __nv_bfloat16;
  const bool f32 = dtype == REPRO_DTYPE_F32;
  int dq = -1;
  switch (hd) {
    case 16: dq = f32 ? dq_smem_bytes<float, 16>() : dq_smem_bytes<BF, 16>(); break;
    case 32: dq = f32 ? dq_smem_bytes<float, 32>() : dq_smem_bytes<BF, 32>(); break;
    case 64: dq = f32 ? dq_smem_bytes<float, 64>() : dq_smem_bytes<BF, 64>(); break;
    case 128: dq = f32 ? dq_smem_bytes<float, 128>() : dq_smem_bytes<BF, 128>(); break;
    default: return -1;
  }
  return dkv ? dq + LSE_BYTES : dq;
}

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
