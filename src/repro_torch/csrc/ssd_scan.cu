// Mamba2 SSD (state-space duality) chunked scan, forward, for Hopper's
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// ssd_scan_pallas (body _kernel).
//
// For x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, Bm and C (B, S, G, N)
// with G | H (head h reads group h / (H / G)), and chunks of Q steps, per
// (b, h, chunk c) with cum the chunk's inclusive prefix sum of dt * A:
//   y_t = exp(cum_t) C_t . s_c  +  sum_{i <= t} (C_t . B_i) exp(cum_t - cum_i) dt_i x_i
//   s_{c+1} = exp(cum_{Q-1}) s_c + sum_i exp(cum_{Q-1} - cum_i) dt_i x_i (x) B_i
// with s_0 = 0 and the (P, N) state s in fp32.  Accumulation is fp32 for
// fp32 and bf16 x / Bm / C; y is written in x's dtype.
//
// What bounds it on the H100: at the training path (B = 5, S = 512,
// H = 48, P = 64, N = 128, G = 1, Q = 256) the work is ~6.1 GFLOP of
// products (the inter-chunk term, the state update and the causal half
// of M @ x per head, C . B^T per group) against ~66 MB of compulsory
// traffic: operations bound.  fp32 runs as 3xTF32 on the tensor cores,
// 3 x FLOPs / 495 TFLOP/s = 0.037 ms there.
//
// Design (mma_sync.cuh: 3xTF32 m16n8k8 for fp32, m16n8k16 for bf16; every
// CTA is 4 warps of 16 rows).  The TPU kernel walks the chunks of one
// (b, h) in order and carries the state in VMEM scratch; Hopper CTAs run
// in parallel, so the carry is split out into four passes:
//  (a) ssd_chunk_state, one CTA per (b*h, chunk): the chunk's prefix sum
//      of dt * A (a block scan) into a workspace, and the chunk's own
//      state contribution upd[p, n] = sum_i (w_i x_i[p]) B_i[n] as a
//      (P x Q) . (Q x N) product whose A operand is (w o x)^T, read from
//      the staged x tile and weighted in registers; x and B tiles of 64
//      rows are double-buffered with cp.async;
//  (b) ssd_state_pass, one thread per (b*h, 4 state elements): walks the
//      chunks in order and turns each chunk's contribution into the state
//      that enters it, s_{c+1} = exp(cum_{Q-1}) s_c + upd_c, in place;
//  (c) ssd_cb, one CTA per (b*g, chunk, 64-row tile t, 64-column tile
//      i <= t): C_t . B_i^T once per group, not once per head (H / G times
//      less work than per head: 48x at mamba2), into an fp32 workspace
//      (B, G, S/Q, Q, Q) of which only the causal tiles are written;
//  (d) ssd_chunk_scan, one CTA per (b*h, chunk, 64 rows t), flash's
//      forward without the softmax: acc = C_t . s^T with the entering
//      state as the B operand, each row scaled by exp(cum_t); then for
//      each column tile i <= t the C.B^T tile is read from the workspace
//      straight into accumulator-layout registers, multiplied by
//      exp(cum_t - cum_i) dt_i, turned into an A operand (a_from_c) and
//      multiplied by the x tile (load_b_kn), as P.V is in flash_fwd.cu.
//      Shared memory holds the C tile and the state for the inter term,
//      then in their place a cp.async double buffer of x tiles: 70 KB at
//      N = 128 fp32, 3 CTAs per SM.
// A warp computes only the 8-column blocks of a diagonal tile that its
// 16 rows can see.  Overflow: above the diagonal cum_t - cum_i is
// positive and exp of it overflows once a chunk's decay passes ~88; the
// exponent is formed only where i <= t, else M is 0.  Every other
// exponent is of a sum of non-positive steps (A < 0, dt >= 0).  Sums run
// in a fixed order without atomics: two calls give the same bits.
#include "mma_sync.cuh"

namespace {

using repro::mma::Mma;

constexpr int NT = 128;     // threads of the MMA passes: 4 warps
constexpr int TQ = 64;      // rows t / columns i per tile
constexpr int NA = 128;     // state columns per pass in (a)
constexpr int SP_NT = 256;  // threads of the state pass (b)
constexpr int SP_E = 4;     // state elements per thread in (b)
constexpr int MAX_P = 64;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr int pad() { return repro::mma::Pad<T>::value; }
// state width rounded up to a whole k16 step, and a staged C/B/state row
__host__ __device__ __forceinline__ int n_k(int N) {
  return (N + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ __forceinline__ int ld_c(int N) {
  return n_k(N) + repro::mma::PadPk<T>::value;
}
// rows of a per-row array padded to whole tiles
__host__ __device__ __forceinline__ int rows_pad(int Q) {
  return (Q + TQ - 1) / TQ * TQ;
}

// (w o x)^T as the A operand of one k step: A[p][k] = x_k[p] * w_k for
// p = rows pw + (g, g+8), k the step's rows of the staged x tile xs
// (row stride ld), in load_b_kn's k order.
template <typename T> struct XtW;
template <> struct XtW<float> {
  __device__ static __forceinline__ Mma<float>::A load(const float* xs,
                                                       int ld,
                                                       const float* w, int g,
                                                       int t) {
    const float* lo = xs + 2 * t * ld;
    const float* hi = lo + ld;
    const float wl = w[2 * t], wh = w[2 * t + 1];
    return {{lo[g] * wl, lo[g + 8] * wl, hi[g] * wh, hi[g + 8] * wh}};
  }
};
template <> struct XtW<__nv_bfloat16> {
  using T = __nv_bfloat16;
  __device__ static __forceinline__ uint32_t two(const T* xs, int ld,
                                                 const float* w, int k,
                                                 int p) {
    return Mma<T>::pack(repro::to_f(xs[k * ld + p]) * w[k],
                        repro::to_f(xs[(k + 1) * ld + p]) * w[k + 1]);
  }
  __device__ static __forceinline__ Mma<T>::A load(const T* xs, int ld,
                                                   const float* w, int g,
                                                   int t) {
    return {{two(xs, ld, w, 2 * t, g), two(xs, ld, w, 2 * t, g + 8),
             two(xs, ld, w, 2 * t + 8, g), two(xs, ld, w, 2 * t + 8, g + 8)}};
  }
};

// the entering state (P x N fp32) as a T tile (PT x ld, zeros past P, N)
__device__ __forceinline__ void stage_state(float* dst, int ld,
                                            const float* src, int PT, int P,
                                            int N, bool vec, int tid) {
  repro::mma::load_tile_2d<float>(dst, ld, src, N, PT, n_k(N), P, N, vec,
                                  tid, NT);
}
__device__ __forceinline__ void stage_state(__nv_bfloat16* dst, int ld,
                                            const float* src, int PT, int P,
                                            int N, bool, int tid) {
  const int nk = n_k(N);
  for (int i = tid; i < PT * nk; i += NT) {
    const int r = i / nk, c = i % nk;
    dst[r * ld + c] = __float2bfloat16(
        r < P && c < N ? src[static_cast<size_t>(r) * N + c] : 0.f);
  }
}

// vec bits of the launches: rows 16-byte aligned, tiles move as cp.async
constexpr int VEC_X = 1, VEC_B = 2, VEC_C = 4, VEC_S = 8;

// (a) grid (B*H, chunks): cum of the chunk into cum_ws (B*H, S), the
// chunk's state contribution into states (B*H, chunks, P, N).
template <typename T, int PT>
__global__ void __launch_bounds__(NT, 2)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                float* __restrict__ cum_ws, float* __restrict__ states,
                int S, int H, int G, int P, int N, int Q, int vec) {
  using M_ = Mma<T>;
  constexpr int KS = M_::K;
  constexpr int LDX = PT + pad<T>();
  constexpr int LDB = NA + pad<T>();
  constexpr int WP = PT / 16;        // warps along p
  constexpr int NJ = NA / (4 / WP) / 8;  // 8-column tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int QP = rows_pad(Q);
  float* cum = reinterpret_cast<float*>(smem_raw);  // QP
  float* tmp = cum + QP;            // QP: scan buffer, then the weights w
  float* dts = tmp + QP;            // QP
  T* xs = reinterpret_cast<T*>(dts + QP);  // 2 x (TQ x LDX)
  T* bs = xs + 2 * TQ * LDX;               // 2 x (TQ x LDB)
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const int nc = S / Q;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int pw = (warp % WP) * 16;
  const int nw = (warp / WP) * NJ * 8;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const float ah = a[h];

  for (int e = tid; e < QP; e += NT) {
    const float d = e < Q ? dt[(row0 + e) * H + h] : 0.f;
    dts[e] = d;
    cum[e] = d * ah;
  }
  __syncthreads();
  // inclusive prefix sum (Hillis-Steele, double-buffered through tmp)
  for (int off = 1; off < Q; off <<= 1) {
    for (int e = tid; e < Q; e += NT)
      tmp[e] = e >= off ? cum[e] + cum[e - off] : cum[e];
    __syncthreads();
    for (int e = tid; e < Q; e += NT) cum[e] = tmp[e];
    __syncthreads();
  }
  const float total = cum[Q - 1];
  for (int e = tid; e < QP; e += NT) {
    if (e < Q)
      cum_ws[static_cast<size_t>(bh) * S + static_cast<size_t>(c) * Q + e] =
          cum[e];
    tmp[e] = e < Q ? expf(total - cum[e]) * dts[e] : 0.f;
  }
  __syncthreads();

  const int ntiles = (Q + TQ - 1) / TQ;
  for (int n0 = 0; n0 < N; n0 += NA) {
    auto load = [&](int it, int st) {
      const int i0 = it * TQ;
      repro::mma::load_tile_2d<T>(xs + st * TQ * LDX, LDX,
                                  x + ((row0 + i0) * H + h) * P,
                                  static_cast<size_t>(H) * P, TQ, PT, Q - i0,
                                  P, vec & VEC_X, tid, NT);
      repro::mma::load_tile_2d<T>(bs + st * TQ * LDB, LDB,
                                  bm + ((row0 + i0) * G + grp) * N + n0,
                                  static_cast<size_t>(G) * N, TQ, NA, Q - i0,
                                  N - n0, vec & VEC_B, tid, NT);
    };
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) repro::mma::zero(acc[j]);
    load(0, 0);
    repro::mma::cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      if (it + 1 < ntiles) load(it + 1, (it + 1) & 1);
      repro::mma::cp_async_commit();
      repro::mma::cp_async_wait<1>();
      __syncthreads();
      const T* xt = xs + (it & 1) * TQ * LDX;
      const T* bt = bs + (it & 1) * TQ * LDB;
      const int ksteps = (min(TQ, Q - it * TQ) + KS - 1) / KS;
#pragma unroll 1
      for (int kc = 0; kc < ksteps; ++kc) {
        const typename M_::AP af = M_::prep_a(XtW<T>::load(
            xt + kc * KS * LDX + pw, LDX, tmp + it * TQ + kc * KS, g, t));
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          M_::mma(acc[j], af, M_::prep_b(M_::load_b_kn(
                                  bt + kc * KS * LDB + nw + 8 * j, LDB, g,
                                  t)));
      }
      __syncthreads();
    }
    float* out = states + (static_cast<size_t>(bh) * nc + c) * P * N;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pw + g + 8 * (e >> 1);
        const int n = n0 + nw + 8 * j + 2 * t + (e & 1);
        if (p < P && n < N) out[static_cast<size_t>(p) * N + n] = acc[j][e];
      }
  }
}

// (b) grid (B*H, ceil(P*N / (SP_NT * SP_E))): chunk contributions ->
// entering states.  Each thread walks SP_E state elements and loads the
// next chunk's contributions before it stores this chunk's states.
__global__ void __launch_bounds__(SP_NT)
ssd_state_pass(const float* __restrict__ cum_ws, float* __restrict__ states,
               int S, int P, int N, int Q) {
  const int bh = blockIdx.x;
  const int e0 = (blockIdx.y * SP_NT + threadIdx.x) * SP_E;
  const int nc = S / Q;
  const size_t pn = static_cast<size_t>(P) * N;
  if (e0 >= P * N) return;
  const int ne = min(SP_E, P * N - e0);
  float* st = states + static_cast<size_t>(bh) * nc * pn + e0;
  float s[SP_E], upd[SP_E];
#pragma unroll
  for (int j = 0; j < SP_E; ++j) {
    s[j] = 0.f;
    upd[j] = j < ne ? st[j] : 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    float nxt[SP_E];
#pragma unroll
    for (int j = 0; j < SP_E; ++j)
      nxt[j] = c + 1 < nc && j < ne ? st[(c + 1) * pn + j] : 0.f;
    const float decay =
        expf(cum_ws[static_cast<size_t>(bh) * S + static_cast<size_t>(c) * Q +
                    Q - 1]);
#pragma unroll
    for (int j = 0; j < SP_E; ++j) {
      if (j < ne) st[c * pn + j] = s[j];
      s[j] = decay * s[j] + upd[j];
      upd[j] = nxt[j];
    }
  }
}

// 8-column blocks of a (t tile z, column tile it) pair that warp `warp`
// computes: all 8 below the diagonal, on it the 2 warp + 2 its rows can
// see; none past Q; even for bf16 (two blocks per k16 step).
template <typename T>
__device__ __forceinline__ int blocks_seen(int z, int it, int warp, int Q) {
  int nj = it < z ? 8 : 2 * warp + 2;
  nj = min(nj, (Q - it * TQ + 7) / 8);
  return Mma<T>::K == 16 ? (nj + 1) & ~1 : nj;
}

// (c) grid (B*G, chunks, tile pairs (z, it <= z)): cbw[bg, c, t, i] =
// C_t . B_i for t in tile z, i in tile it.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_cb(const T* __restrict__ bm, const T* __restrict__ cm,
       float* __restrict__ cbw, int S, int G, int N, int Q, int vec) {
  using M_ = Mma<T>;
  constexpr int KS = M_::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDC = ld_c<T>(N);
  const int nk = n_k(N);
  T* cs = reinterpret_cast<T*>(smem_raw);  // TQ x LDC: C of the rows t
  T* bs = cs + TQ * LDC;                   // TQ x LDC: B of the columns i
  const int bg = blockIdx.x, c = blockIdx.y;
  const int b = bg / G, grp = bg % G;
  const int nc = S / Q;
  int z = 0;
  while ((z + 1) * (z + 2) / 2 <= static_cast<int>(blockIdx.z)) ++z;
  const int it = blockIdx.z - z * (z + 1) / 2;
  const int t0 = z * TQ, i0 = it * TQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t gs = static_cast<size_t>(G) * N;

  repro::mma::load_tile_2d<T>(cs, LDC, cm + ((row0 + t0) * G + grp) * N, gs,
                              TQ, nk, Q - t0, N, vec & VEC_C, tid, NT);
  repro::mma::load_tile_2d<T>(bs, LDC, bm + ((row0 + i0) * G + grp) * N, gs,
                              TQ, nk, Q - i0, N, vec & VEC_B, tid, NT);
  repro::mma::cp_async_commit();
  repro::mma::cp_async_wait<0>();
  __syncthreads();

  const int nj = blocks_seen<T>(z, it, warp, Q);
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) repro::mma::zero(s[j]);
#pragma unroll 1
  for (int kc = 0; kc < nk / KS; ++kc) {
    const typename M_::AP af = M_::prep_a(
        M_::load_a_pk(cs + 16 * warp * LDC + kc * KS, LDC, g, t));
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < nj)
        M_::mma(s[j], af, M_::prep_b(M_::load_b_nk_pk(
                              bs + 8 * j * LDC + kc * KS, LDC, g, t)));
  }
  float* out = cbw + (static_cast<size_t>(bg) * nc + c) * Q * Q;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = t0 + 16 * warp + g + 8 * (e >> 1);
      const int ii = i0 + 8 * j + 2 * t + (e & 1);
      if (j < nj && tt < Q && ii < Q)
        out[static_cast<size_t>(tt) * Q + ii] = s[j][e];
    }
}

// (d) grid (B*H, chunks, ceil(Q / TQ)): y for 64 rows of one chunk.
// 3 CTAs per SM for fp32 (70 KB of shared memory at N = 128); bf16 at 2
// keeps its P-tile-64 instantiation's registers (~200) unspilled
template <typename T, int PT>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 3 : 2)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ cm, const float* __restrict__ cum_ws,
               const float* __restrict__ states,
               const float* __restrict__ cbw, T* __restrict__ y, int S,
               int H, int G, int P, int N, int Q, int vec) {
  using M_ = Mma<T>;
  constexpr int KS = M_::K;
  constexpr int KPT = KS / 8;        // accumulator tiles per k step
  constexpr int LDX = PT + pad<T>();
  constexpr int NP = PT / 8;         // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDC = ld_c<T>(N);
  const int nk = n_k(N);
  float* ct = reinterpret_cast<float*>(smem_raw);  // TQ: cum of the rows t
  float* ci = ct + TQ;                // 2 x TQ: cum of the columns i
  float* di = ci + 2 * TQ;            // 2 x TQ: dt of the columns i
  T* cs = reinterpret_cast<T*>(di + 2 * TQ);  // TQ x LDC: C of the rows t
  T* st = cs + TQ * LDC;              // PT x LDC: the entering state
  // 2 x (TQ x LDX): x of the columns i, over C and the state once the
  // inter-chunk term has read them
  T* xs = cs;
  const int bh = blockIdx.x, c = blockIdx.y, z = blockIdx.z;
  const int t0 = z * TQ;
  const int b = bh / H, h = bh % H, grp = h / (H / G);
  const int nc = S / Q;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const float* cum = cum_ws + static_cast<size_t>(bh) * S +
                     static_cast<size_t>(c) * Q;
  const float* cb = cbw + (static_cast<size_t>(b * G + grp) * nc + c) * Q * Q;

  auto load_x = [&](int it, int buf) {
    const int i0 = it * TQ;
    repro::mma::load_tile_2d<T>(xs + buf * TQ * LDX, LDX,
                                x + ((row0 + i0) * H + h) * P,
                                static_cast<size_t>(H) * P, TQ, PT, Q - i0, P,
                                vec & VEC_X, tid, NT);
    for (int e = tid; e < TQ; e += NT) {
      const bool ok = i0 + e < Q;
      ci[buf * TQ + e] = ok ? cum[i0 + e] : 0.f;
      di[buf * TQ + e] = ok ? dt[(row0 + i0 + e) * H + h] : 0.f;
    }
  };

  for (int e = tid; e < TQ; e += NT) ct[e] = t0 + e < Q ? cum[t0 + e] : 0.f;
  repro::mma::load_tile_2d<T>(cs, LDC, cm + ((row0 + t0) * G + grp) * N,
                              static_cast<size_t>(G) * N, TQ, nk, Q - t0, N,
                              vec & VEC_C, tid, NT);
  stage_state(st, LDC, states + (static_cast<size_t>(bh) * nc + c) * P * N,
              PT, P, N, vec & VEC_S, tid);
  repro::mma::cp_async_commit();
  repro::mma::cp_async_wait<0>();
  __syncthreads();

  // inter-chunk: acc = exp(cum_t) C_t . s^T
  float acc[NP][4];
#pragma unroll
  for (int j = 0; j < NP; ++j) repro::mma::zero(acc[j]);
#pragma unroll 1
  for (int kc = 0; kc < nk / KS; ++kc) {
    const typename M_::AP af = M_::prep_a(
        M_::load_a_pk(cs + 16 * warp * LDC + kc * KS, LDC, g, t));
#pragma unroll
    for (int j = 0; j < NP; ++j)
      M_::mma(acc[j], af, M_::prep_b(M_::load_b_nk_pk(
                              st + 8 * j * LDC + kc * KS, LDC, g, t)));
  }
  const int r_lo = 16 * warp + g;  // this lane's rows r_lo, r_lo + 8
  const float ct_lo = ct[r_lo], ct_hi = ct[r_lo + 8];
  {
    const float d_lo = expf(ct_lo), d_hi = expf(ct_hi);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      acc[j][0] *= d_lo;
      acc[j][1] *= d_lo;
      acc[j][2] *= d_hi;
      acc[j][3] *= d_hi;
    }
  }

  __syncthreads();  // C and the state are read: the x tiles take their place
  load_x(0, 0);
  repro::mma::cp_async_commit();

  // intra-chunk, column tiles it <= z (the causal half)
  for (int it = 0; it <= z; ++it) {
    if (it + 1 <= z) load_x(it + 1, (it + 1) & 1);
    repro::mma::cp_async_commit();
    repro::mma::cp_async_wait<1>();
    __syncthreads();
    const int buf = it & 1;
    const int i0 = it * TQ;
    const int nj = blocks_seen<T>(z, it, warp, Q);
    // M[t, i] = (C_t . B_i) exp(cum_t - cum_i) dt_i where i <= t, else 0
    float m[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + 8 * (e >> 1);
        const int tt = t0 + r;
        const int il = 8 * j + 2 * t + (e & 1);
        const int ii = i0 + il;
        float v = 0.f;
        // the exponent only where i <= t: never exp of a positive sum
        if (j < nj && ii <= tt && tt < Q)
          v = cb[static_cast<size_t>(tt) * Q + ii] *
              exp2f(((e >> 1 ? ct_hi : ct_lo) - ci[buf * TQ + il]) * LOG2E) *
              di[buf * TQ + il];
        m[j][e] = v;
      }
    // y[t, p] += sum_i M[t, i] x_i[p]
    const T* xt = xs + buf * TQ * LDX;
#pragma unroll
    for (int kc = 0; kc < 8 / KPT; ++kc) {
      if (kc * KPT >= nj) break;
      const typename M_::AP af = M_::prep_a(M_::a_from_c(&m[kc * KPT]));
#pragma unroll
      for (int j = 0; j < NP; ++j)
        M_::mma(acc[j], af, M_::prep_b(M_::load_b_kn(
                                xt + kc * KS * LDX + 8 * j, LDX, g, t)));
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = t0 + r_lo + 8 * (e >> 1);
      const int p = 8 * j + 2 * t + (e & 1);
      if (tt < Q && p < P)
        y[((row0 + tt) * H + h) * P + p] = repro::from_f<T>(acc[j][e]);
    }
}

template <typename T, int PT>
size_t state_smem(int Q) {
  return sizeof(float) * 3 * rows_pad(Q) +
         sizeof(T) * 2 * TQ * (PT + pad<T>() + NA + pad<T>());
}
template <typename T>
size_t cb_smem(int N) {
  return sizeof(T) * 2 * TQ * ld_c<T>(N);
}
template <typename T, int PT>
size_t scan_smem(int N) {
  const int cst = (TQ + PT) * ld_c<T>(N);  // C and the state
  const int xs = 2 * TQ * (PT + pad<T>());  // the x double buffer over them
  return sizeof(float) * 5 * TQ + sizeof(T) * (cst > xs ? cst : xs);
}

template <typename T, int PT>
cudaError_t launch(const T* x, const float* dt, const float* a, const T* bm,
                   const T* cm, T* y, float* cum, float* st, int B, int S,
                   int H, int G, int P, int N, int Q, cudaStream_t s) {
  const int nc = S / Q;
  const int nt = (Q + TQ - 1) / TQ;
  float* cbw = st + static_cast<size_t>(B) * H * nc * P * N;
  const size_t es = sizeof(T);
  int vec = 0;
  if (repro::mma::aligned16(x, P * es)) vec |= VEC_X;
  if (repro::mma::aligned16(bm, N * es)) vec |= VEC_B;
  if (repro::mma::aligned16(cm, N * es)) vec |= VEC_C;
  if (repro::mma::aligned16(st, N * sizeof(float))) vec |= VEC_S;
  const size_t sa = state_smem<T, PT>(Q), sb = cb_smem<T>(N),
               sc = scan_smem<T, PT>(N);
  using repro::mma::allow_smem;
  cudaError_t err = allow_smem(ssd_chunk_state<T, PT>, static_cast<int>(sa));
  if (err == cudaSuccess) err = allow_smem(ssd_cb<T>, static_cast<int>(sb));
  if (err == cudaSuccess)
    err = allow_smem(ssd_chunk_scan<T, PT>, static_cast<int>(sc));
  if (err != cudaSuccess) return err;
  ssd_chunk_state<T, PT><<<dim3(B * H, nc), NT, sa, s>>>(
      x, dt, a, bm, cum, st, S, H, G, P, N, Q, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_pass<<<dim3(B * H, (P * N + SP_NT * SP_E - 1) / (SP_NT * SP_E)),
                   SP_NT, 0, s>>>(cum, st, S, P, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_cb<T><<<dim3(B * G, nc, nt * (nt + 1) / 2), NT, sb, s>>>(
      bm, cm, cbw, S, G, N, Q, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<T, PT><<<dim3(B * H, nc, nt), NT, sc, s>>>(
      x, dt, cm, cum, st, cbw, y, S, H, G, P, N, Q, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_p(const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, void* y, void* cum_ws,
                     void* states, int B, int S, int H, int G, int P, int N,
                     int Q, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  T* yt = static_cast<T*>(y);
  float* cum = static_cast<float*>(cum_ws);
  float* st = static_cast<float*>(states);
  if (P <= 16)
    return launch<T, 16>(xt, dtf, af, bt, ct, yt, cum, st, B, S, H, G, P, N,
                         Q, s);
  if (P <= 32)
    return launch<T, 32>(xt, dtf, af, bt, ct, yt, cum, st, B, S, H, G, P, N,
                         Q, s);
  return launch<T, 64>(xt, dtf, af, bt, ct, yt, cum, st, B, S, H, G, P, N, Q,
                       s);
}

template <typename T>
int smem_of(int kernel, int PT, int N, int Q) {
  switch (kernel * 100 + PT) {
    case 16: return static_cast<int>(state_smem<T, 16>(Q));
    case 32: return static_cast<int>(state_smem<T, 32>(Q));
    case 64: return static_cast<int>(state_smem<T, 64>(Q));
    case 116: case 132: case 164: return static_cast<int>(cb_smem<T>(N));
    case 216: return static_cast<int>(scan_smem<T, 16>(N));
    case 232: return static_cast<int>(scan_smem<T, 32>(N));
    case 264: return static_cast<int>(scan_smem<T, 64>(N));
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory in bytes of one CTA of pass kernel (0: chunk
// state, 1: C.B^T, 2: chunk scan) at head-dim tile PT (16, 32, 64), state
// width N and chunk Q (-1: not a config).
extern "C" int ssd_scan_smem(int kernel, int PT, int N, int Q, int dtype) {
  if (dtype == REPRO_DTYPE_F32) return smem_of<float>(kernel, PT, N, Q);
  if (dtype == REPRO_DTYPE_BF16)
    return smem_of<__nv_bfloat16>(kernel, PT, N, Q);
  return -1;
}

// x, y: (B, S, H, P) and bm, cm: (B, S, G, N) in the dtype's element type;
// dt: (B, S, H) fp32; a: (H,) fp32; workspaces cum_ws: (B*H, S) fp32 and
// states: B*H*(S/Q)*P*N + B*G*(S/Q)*Q*Q fp32, the chunk states (B*H, S/Q,
// P, N) followed by the per-group C.B^T tiles (B, G, S/Q, Q, Q).  All contiguous; S % Q == 0,
// G | H, P <= 64, N <= 256 (the wrapper checks).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* a,
                            const void* bm, const void* cm, void* y,
                            void* cum_ws, void* states, int B, int S, int H,
                            int G, int P, int N, int Q, int dtype,
                            void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaSuccess;
  if (Q <= 0 || S % Q || G <= 0 || H % G || P <= 0 || P > MAX_P || N <= 0 ||
      N > 256)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch_p<float>(x, dt, a, bm, cm, y, cum_ws, states, B, S, H, G,
                           P, N, Q, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch_p<__nv_bfloat16>(x, dt, a, bm, cm, y, cum_ws, states, B, S,
                                   H, G, P, N, Q, s);
  return cudaErrorInvalidValue;
}
