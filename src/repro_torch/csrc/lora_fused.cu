// Fused LoRA projection, forward and backward, for Hopper's tensor cores.
//
// Replaces the TPU kernels src/repro/kernels/lora_matmul/kernel.py
// lora_matmul_pallas (body _fwd_kernel) and lora_matmul_bwd_pallas
// (bodies _bwd_dx_kernel and _bwd_dab_kernel).
//
// Forward, for x (M, K), W (K, N), A (K, r), B (r, N), scale a device
// fp32 scalar:
//   xa = x @ A                 (M, r) fp32, also the backward's residual
//   y  = x @ W + scale * xa @ B
// Backward, for the cotangent g (M, N) (W is frozen: no dW):
//   gb = g @ B^T               (M, r) fp32
//   dx = g @ W^T + scale * gb @ A^T
//   dA = scale * x^T @ gb      (K, r)      dB = scale * xa^T @ g   (r, N)
// (dscale = sum(xa * gb) is one elementwise op in the wrapper.)
// Accumulation is fp32 for fp32 and bf16 operands; r is any rank in
// 1..64 (rank columns that the rank mask zeroed are summed as zeros);
// M, K and N are any sizes.
//
// What bounds it on the H100: the x @ W product.  At the gpt2 eval path
// (M = 10240 tokens, K = N = 768, r = 16, fp32) it is 12.1 GFLOP against
// 63 MB of x and y, ~190 FLOPs per byte: operations bound.  fp32 runs as
// 3xTF32 on the tensor cores (3 TF32 MMAs per fp32-accurate product:
// 3 x FLOPs / 495 TFLOP/s, 0.076 ms there); the rank-r terms add 4 %.
//
// Design.  The TPU kernels keep xa (and gb) in scratch across a
// sequential grid axis and accumulate dA/dB in output windows that every
// grid step revisits; Hopper CTAs run in parallel, so:
//  * a thin pass (lora_xa_mma_kernel) computes xa = x @ A (or gb =
//    g @ B^T) on the tensor cores into a tensor the wrapper allocates,
//    before the wide pass reads it: one CTA per 16 rows, whose 4 warps
//    split each staged slice of K and add their partial sums in warp
//    order;
//  * the wide pass (lora_gemm_kernel) is a GEMM on mma.sync (mma_sync.cuh:
//    3xTF32 m16n8k8 for fp32, m16n8k16 for bf16).  A CTA computes 128 x
//    128 outputs with 8 warps of 64 x 32 (64 x 128 with 4 warps when the
//    128-row grid would not fill one wave of the 132 SMs); K steps of 32
//    fp32 / 64 bf16 go through a 3-stage cp.async ring of x and W tiles
//    whose padded rows keep every fragment load free of bank conflicts.
//    Per k step a warp splits its 4 B fragments once and reuses them
//    across its 4 m tiles, and each A fragment across its 4 n tiles, with
//    the two-operation split (Mma<float>::split_tr: the MMA truncates a
//    TF32 operand itself).
//    Each k tile sums into fresh accumulators that are then added to the
//    output's: an MMA truncates its fp32 sum, and over K of 768-3072 one
//    accumulator of y's size drifted past the 1e-4 tolerance (up to
//    1.4e-3 at mamba2's shapes);
//  * the rank-r term goes into the same accumulators:
//    y = [x | s xa] @ [W ; B], as ceil(r / 8) more k steps (fp32) on a
//    zero-padded s * xa tile and the B tile; in bf16 s * xa is split into
//    a bf16 high and low part against two copies of B's rows (ceil(r / 32)
//    more k tiles), so its rounding stays below 2^-16 instead of 2^-9;
//  * ragged M, K, N: out-of-range rows and columns are zero-filled by
//    cp.async's src-size form and masked on the store; an operand whose
//    rows are not 16-byte aligned (K or N not a multiple of 4 fp32 / 8
//    bf16) is staged element by element instead;
//  * the backward's dx is the same kernel reading W^T and A^T through
//    load_b_nk (KN = false);
//  * dA and dB reduce over all M rows: each CTA of lora_partial_kernel
//    sums one slice of MS rows into a workspace, and lora_reduce_kernel
//    adds the slices in slice order: deterministic, no atomics.
#include "mma_sync.cuh"

namespace {

constexpr int MAX_R = 64;

constexpr int TT = 256;  // threads of the dA/dB passes

// ---- wide pass: C[m, n] = sum_k X[m, k] W(k, n) + sum_c (s L[m, c]) V(c, n)
// X (M, Kr) row-major in T, row stride ldx; L (M, R) fp32 row-major;
// C (M, N) row-major.  KN: W(k, n) = w[k * ldw + n], V(c, n) = v[c * ldv + n]
// (the forward's W and B); otherwise W(k, n) = w[n * ldw + k] and
// V(c, n) = v[n * ldv + c] (the backward's W^T and A^T).
// A tensor-core GEMM over the k tiles of X, then ceil(R / BK) more k tiles
// whose A operand is s * L (zero past R) and whose B operand is V: the
// rank-r term lands in the same accumulators.
constexpr int GBN = 128;     // output columns per CTA
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int MIN_WAVE = 132;  // SMs of an H100 SXM: below this many 128-row
                               // CTAs, 64-row CTAs fill the card better
// vec bits: operand rows are 16-byte aligned, so tiles move as cp.async
constexpr int VEC_X = 1, VEC_W = 2, VEC_V = 4;

template <typename T>
struct GemmTile {
  static constexpr int KS = repro::mma::Mma<T>::K;
  static constexpr int BK = 128 / sizeof(T);  // 32 fp32, 64 bf16: 128 B
  static constexpr int LDA = BK + repro::mma::PadPk<T>::value;
  static constexpr int LDB_KN = GBN + repro::mma::Pad<T>::value;
  static constexpr int LDB_NK = BK + repro::mma::PadPk<T>::value;
  template <bool KN>
  __host__ __device__ static constexpr int b_elems() {
    return KN ? BK * LDB_KN : GBN * LDB_NK;
  }
  template <int BM, bool KN>
  __host__ __device__ static constexpr int stage_elems() {
    return BM * LDA + b_elems<KN>();
  }
  template <int BM, bool KN>
  __host__ __device__ static constexpr int smem_bytes() {
    return STAGES * stage_elems<BM, KN>() * sizeof(T);
  }
};

// BM x 128 outputs per CTA, 8 (BM 128) or 4 (BM 64) warps of 64 x 32.
// A 128-row CTA runs alone on its SM: capped at 128 registers for two
// CTAs per SM, its 64 accumulators and split fragments spilled.
template <typename T, int BM, bool KN>
__global__ void __launch_bounds__(BM * 2, BM == 128 ? 1 : 2)
lora_gemm_kernel(const T* __restrict__ x, int ldx, const T* __restrict__ w,
                 int ldw, const float* __restrict__ l, int R,
                 const T* __restrict__ v, int ldv,
                 const float* __restrict__ scale, T* __restrict__ c, int M,
                 int Kr, int N, int vec) {
  using M_ = repro::mma::Mma<T>;
  using G = GemmTile<T>;
  constexpr int NT = BM * 2;
  constexpr int BK = G::BK;
  constexpr int KS = G::KS;
  constexpr int LDA = G::LDA;
  constexpr int LDB = KN ? G::LDB_KN : G::LDB_NK;
  constexpr int STAGE = G::template stage_elems<BM, KN>();
  // rank columns per rank tile: bf16 holds s * xa as hi + lo, two bf16
  // halves of the tile's k steps against two copies of the V rows
  constexpr bool HILO = sizeof(T) == 2;
  constexpr int RC = HILO ? BK / 2 : BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int wm = warp / 4;          // 64-row block of the warp
  const int wn = warp % 4;          // 32-column block of the warp
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * GBN;
  const float s = *scale;
  const int nkx = (Kr + BK - 1) / BK;
  const int nt = nkx + (R + RC - 1) / RC;

  auto load_stage = [&](int kt, int st) {
    T* as = sm + st * STAGE;
    T* bs = as + BM * LDA;
    if (kt < nkx) {
      const int k0 = kt * BK;
      repro::mma::load_tile_2d<T>(as, LDA, x + size_t(m0) * ldx + k0, ldx, BM,
                                  BK, M - m0, Kr - k0, vec & VEC_X, tid, NT);
      if (KN)
        repro::mma::load_tile_2d<T>(bs, LDB, w + size_t(k0) * ldw + n0, ldw,
                                    BK, GBN, Kr - k0, N - n0, vec & VEC_W,
                                    tid, NT);
      else
        repro::mma::load_tile_2d<T>(bs, LDB, w + size_t(n0) * ldw + k0, ldw,
                                    GBN, BK, N - n0, Kr - k0, vec & VEC_W,
                                    tid, NT);
    } else {
      const int c0 = (kt - nkx) * RC;
      // s * L, rounded to T for the MMA (exact for fp32; for bf16 the
      // columns past RC hold what the rounding left)
      for (int i = tid; i < BM * BK; i += NT) {
        const int r = i / BK, cc = i % BK, rc = cc % RC;
        const float val =
            (m0 + r < M && c0 + rc < R) ? s * l[size_t(m0 + r) * R + c0 + rc]
                                        : 0.f;
        const T hi = repro::from_f<T>(val);
        as[r * LDA + cc] =
            cc < RC ? hi : repro::from_f<T>(val - repro::to_f(hi));
      }
#pragma unroll
      for (int h = 0; h < (HILO ? 2 : 1); ++h) {
        if (KN)
          repro::mma::load_tile_2d<T>(bs + h * RC * LDB, LDB,
                                      v + size_t(c0) * ldv + n0, ldv, RC, GBN,
                                      R - c0, N - n0, vec & VEC_V, tid, NT);
        else
          repro::mma::load_tile_2d<T>(bs + h * RC, LDB,
                                      v + size_t(n0) * ldv + c0, ldv, GBN, RC,
                                      N - n0, R - c0, vec & VEC_V, tid, NT);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) repro::mma::zero(acc[i][j]);

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt) load_stage(st, st);
    repro::mma::cp_async_commit();
  }
  for (int kt = 0; kt < nt; ++kt) {
    repro::mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the stage computed in the previous step is free for tile kt + 2
    if (kt + STAGES - 1 < nt)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    repro::mma::cp_async_commit();
    const T* as = sm + (kt % STAGES) * STAGE + wm * 64 * LDA;
    const T* bs = sm + (kt % STAGES) * STAGE + BM * LDA;
    // fp32 rank tiles stop after ceil((R - c0) / KS) k steps
    const int ksteps = kt < nkx || HILO
                           ? BK / KS
                           : min(BK / KS, (R - (kt - nkx) * RC + KS - 1) / KS);
    // the tile's sum, added to acc once: each MMA truncates its sum to
    // fp32, so summing a long K in one accumulator of the size of y loses
    // bits that a short partial sum keeps
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) repro::mma::zero(part[i][j]);
#pragma unroll
    for (int kk = 0; kk < BK / KS; ++kk) {
      if (kk >= ksteps) break;
      typename M_::BP b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + 8 * j;
        b[j] = M_::prep_b_tr(
            KN ? M_::load_b_kn(bs + kk * KS * LDB + col, LDB, g, t)
               : M_::load_b_nk_pk(bs + col * LDB + kk * KS, LDB, g, t));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const typename M_::AP a = M_::prep_a_tr(
            M_::load_a_pk(as + 16 * i * LDA + kk * KS, LDA, g, t));
#pragma unroll
        for (int j = 0; j < 4; ++j) M_::mma(part[i][j], a, b[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + 16 * i + g + 8 * (e >> 1);
        const int col = n0 + wn * 32 + 8 * j + 2 * t + (e & 1);
        if (row < M && col < N)
          c[static_cast<size_t>(row) * N + col] =
              repro::from_f<T>(acc[i][j][e]);
      }
}

// 128-row CTAs when they fill at least one wave of the card's SMs, else
// 64-row CTAs (twice the CTAs for small M).  REPRO_LORA_TILE_BM fixes the
// choice at build time.
int pick_bm(int M, int N) {
#ifdef REPRO_LORA_TILE_BM
  return REPRO_LORA_TILE_BM;
#else
  const long tiles = static_cast<long>((M + 127) / 128) * ((N + GBN - 1) / GBN);
  return tiles >= MIN_WAVE ? 128 : 64;
#endif
}

template <typename T, int BM, bool KN>
cudaError_t launch_gemm(const T* x, int ldx, const T* w, int ldw,
                        const float* l, int R, const T* v, int ldv,
                        const float* scale, T* c, int M, int Kr, int N,
                        cudaStream_t stream) {
  constexpr int smem = GemmTile<T>::template smem_bytes<BM, KN>();
  static const cudaError_t opt_in =
      repro::mma::allow_smem(lora_gemm_kernel<T, BM, KN>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const size_t es = sizeof(T);
  int vec = 0;
  if (repro::mma::aligned16(x, ldx * es)) vec |= VEC_X;
  if (repro::mma::aligned16(w, ldw * es)) vec |= VEC_W;
  if (repro::mma::aligned16(v, ldv * es)) vec |= VEC_V;
  const dim3 grid((N + GBN - 1) / GBN, (M + BM - 1) / BM);
  lora_gemm_kernel<T, BM, KN><<<grid, BM * 2, smem, stream>>>(
      x, ldx, w, ldw, l, R, v, ldv, scale, c, M, Kr, N, vec);
  return cudaGetLastError();
}

template <typename T, bool KN>
cudaError_t gemm(const T* x, int ldx, const T* w, int ldw, const float* l,
                 int R, const T* v, int ldv, const float* scale, T* c, int M,
                 int Kr, int N, cudaStream_t stream) {
  if (pick_bm(M, N) == 128)
    return launch_gemm<T, 128, KN>(x, ldx, w, ldw, l, R, v, ldv, scale, c, M,
                                   Kr, N, stream);
  return launch_gemm<T, 64, KN>(x, ldx, w, ldw, l, R, v, ldv, scale, c, M,
                                Kr, N, stream);
}

// ---- thin pass on the tensor cores: out = X @ Y (M, R) fp32, R <= RN
// X (M, K) row-major (ldx = K); KN: Y(k, c) = y[k * R + c] (the
// forward's A), otherwise Y(k, c) = y[c * K + k] (the backward's B^T).
// One CTA per 16 rows (M / 16 CTAs keep a small M spread over the card);
// each staged slice of K holds XW k tiles of BK, one per warp, and the
// warps' partial sums are added in warp order at the end: deterministic.
constexpr int XW = 4;  // warps per CTA

template <typename T, int RN, bool KN>
struct XaTile {
  static constexpr int BK = GemmTile<T>::BK;
  static constexpr int SK = XW * BK;  // K columns per stage
  static constexpr int LDX = SK + repro::mma::PadPk<T>::value;
  // Y's tile: SK x RN k-major, or RN x SK
  static constexpr int LDY = KN ? RN + repro::mma::Pad<T>::value : LDX;
  static constexpr int STAGE = 16 * LDX + (KN ? SK : RN) * LDY;
  __host__ __device__ static constexpr int smem_bytes() {
    return STAGES * STAGE * static_cast<int>(sizeof(T));
  }
};

template <typename T, int RN, bool KN>
__global__ void __launch_bounds__(32 * XW)
lora_xa_mma_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   float* __restrict__ out, int M, int K, int R, int vec) {
  using M_ = repro::mma::Mma<T>;
  using X = XaTile<T, RN, KN>;
  constexpr int NT = 32 * XW;
  constexpr int BK = X::BK;
  constexpr int KS = M_::K;
  constexpr int NJ = RN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int m0 = blockIdx.x * 16;
  const int ns = (K + X::SK - 1) / X::SK;

  auto load_stage = [&](int ks, int st) {
    T* xs = sm + st * X::STAGE;
    const int k0 = ks * X::SK;
    repro::mma::load_tile_2d<T>(xs, X::LDX, x + size_t(m0) * K + k0, K, 16,
                                X::SK, M - m0, K - k0, vec & VEC_X, tid, NT);
    if (KN)
      repro::mma::load_tile_2d<T>(xs + 16 * X::LDX, X::LDY,
                                  y + size_t(k0) * R, R, X::SK, RN, K - k0, R,
                                  vec & VEC_W, tid, NT);
    else
      repro::mma::load_tile_2d<T>(xs + 16 * X::LDX, X::LDY, y + k0, K, RN,
                                  X::SK, R, K - k0, vec & VEC_W, tid, NT);
  };

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) repro::mma::zero(acc[j]);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ns) load_stage(st, st);
    repro::mma::cp_async_commit();
  }
  for (int ks = 0; ks < ns; ++ks) {
    repro::mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ks + STAGES - 1 < ns)
      load_stage(ks + STAGES - 1, (ks + STAGES - 1) % STAGES);
    repro::mma::cp_async_commit();
    const T* xs = sm + (ks % STAGES) * X::STAGE + warp * BK;
    const T* ys = sm + (ks % STAGES) * X::STAGE + 16 * X::LDX +
                  (KN ? warp * BK * X::LDY : warp * BK);
    // this warp's k tile: its k steps that reach into K
    const int kvalid = K - ks * X::SK - warp * BK;
    const int ksteps = min(BK / KS, max(0, (kvalid + KS - 1) / KS));
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) repro::mma::zero(part[j]);
#pragma unroll
    for (int kk = 0; kk < BK / KS; ++kk) {
      if (kk >= ksteps) break;
      const typename M_::AP af =
          M_::prep_a_tr(M_::load_a_pk(xs + kk * KS, X::LDX, g, t));
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        M_::mma(part[j], af, M_::prep_b_tr(
            KN ? M_::load_b_kn(ys + kk * KS * X::LDY + 8 * j, X::LDY, g, t)
               : M_::load_b_nk_pk(ys + 8 * j * X::LDY + kk * KS, X::LDY, g,
                                  t)));
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  // the warps' partial sums through shared memory, added in warp order
  repro::mma::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);  // XW x 16 x RN
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * 16 + g + 8 * (e >> 1)) * RN + 8 * j + 2 * t + (e & 1)] =
          acc[j][e];
  __syncthreads();
  for (int i = tid; i < 16 * R; i += NT) {
    const int r = i / R, c = i % R;
    if (m0 + r >= M) continue;
    float sum = red[r * RN + c];
#pragma unroll
    for (int w = 1; w < XW; ++w) sum += red[(w * 16 + r) * RN + c];
    out[size_t(m0 + r) * R + c] = sum;
  }
}

template <typename T, int RN, bool KN>
cudaError_t launch_thin(const T* x, const T* y, float* out, int M, int K,
                        int R, cudaStream_t stream) {
  constexpr int smem = XaTile<T, RN, KN>::smem_bytes();
  static const cudaError_t opt_in =
      repro::mma::allow_smem(lora_xa_mma_kernel<T, RN, KN>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const size_t es = sizeof(T);
  int vec = 0;
  if (repro::mma::aligned16(x, K * es)) vec |= VEC_X;
  if (repro::mma::aligned16(y, (KN ? R : K) * es)) vec |= VEC_W;
  lora_xa_mma_kernel<T, RN, KN><<<(M + 15) / 16, 32 * XW, smem, stream>>>(
      x, y, out, M, K, R, vec);
  return cudaGetLastError();
}

template <typename T, bool KN>
cudaError_t thin(const T* x, const T* y, float* out, int M, int K, int R,
                 cudaStream_t stream) {
  if (R <= 16) return launch_thin<T, 16, KN>(x, y, out, M, K, R, stream);
  if (R <= 32) return launch_thin<T, 32, KN>(x, y, out, M, K, R, stream);
  return launch_thin<T, 64, KN>(x, y, out, M, K, R, stream);
}

// ---- adapter gradients: part[sl, p, c] = sum_{m in slice sl} X[m, p] * Y[m, c]
// X (M, P) row-major in T; Y (M, R) fp32 row-major; one CTA per (P tile
// of PT columns, slice of MS rows).
constexpr int PT = 64;
constexpr int MS = 256;
constexpr int MC = 32;           // rows staged per step

template <typename T>
__global__ void __launch_bounds__(TT)
lora_partial_kernel(const T* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ part, int M, int P, int R) {
  __shared__ float xs[MC][PT];
  __shared__ float ysh[MC][MAX_R];
  const int p0 = blockIdx.x * PT;
  const int sl = blockIdx.y;
  const int tid = threadIdx.x;
  constexpr int NO = (PT * MAX_R + TT - 1) / TT;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  const int m_end = min(M, (sl + 1) * MS);
  for (int mb = sl * MS; mb < m_end; mb += MC) {
    __syncthreads();
    for (int i = tid; i < MC * PT; i += TT) {
      const int mm = i / PT, pp = i % PT;
      const int row = mb + mm, col = p0 + pp;
      xs[mm][pp] = (row < m_end && col < P)
                       ? repro::to_f(x[static_cast<size_t>(row) * P + col])
                       : 0.f;
    }
    for (int i = tid; i < MC * R; i += TT) {
      const int mm = i / R, cc = i % R;
      const int row = mb + mm;
      ysh[mm][cc] = row < m_end ? y[static_cast<size_t>(row) * R + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int o = tid + i * TT;
      if (o < PT * R) {
        const int pp = o / R, cc = o % R;
        float s = acc[i];
        for (int mm = 0; mm < MC; ++mm) s = fmaf(xs[mm][pp], ysh[mm][cc], s);
        acc[i] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int o = tid + i * TT;
    if (o < PT * R) {
      const int col = p0 + o / R;
      if (col < P)
        part[(static_cast<size_t>(sl) * P + col) * R + o % R] = acc[i];
    }
  }
}

// out(p, c) = scale * sum_sl part[sl, p, c], summed in slice order;
// out(p, c) = out[p * osp + c * osc].
template <typename T>
__global__ void __launch_bounds__(TT)
lora_reduce_kernel(const float* __restrict__ part,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int S, int P, int R, int osp, int osc) {
  const int i = blockIdx.x * TT + threadIdx.x;
  if (i >= P * R) return;
  float s = 0.f;
  for (int sl = 0; sl < S; ++sl) s += part[static_cast<size_t>(sl) * P * R + i];
  const int p = i / R, c = i % R;
  out[static_cast<size_t>(p) * osp + static_cast<size_t>(c) * osc] =
      repro::from_f<T>(*scale * s);
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const void* a, const void* b,
                const float* scale, float* xa, void* y, int M, int K, int N,
                int R, cudaStream_t stream) {
  const T* xx = static_cast<const T*>(x);
  const cudaError_t e =
      thin<T, true>(xx, static_cast<const T*>(a), xa, M, K, R, stream);
  if (e != cudaSuccess) return e;
  return gemm<T, true>(xx, K, static_cast<const T*>(w), N, xa,
                       R, static_cast<const T*>(b), N, scale,
                       static_cast<T*>(y), M, K, N, stream);
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const void* a, const void* b,
                const float* scale, const void* g, const float* xa, float* gb,
                float* work, void* dx, void* da, void* db, int M, int K,
                int N, int R, cudaStream_t stream) {
  const T* gg = static_cast<const T*>(g);
  const T* bb = static_cast<const T*>(b);
  // gb = g @ B^T: B^T(n, c) = B[c * N + n]
  cudaError_t e = thin<T, false>(gg, bb, gb, M, N, R, stream);
  if (e != cudaSuccess) return e;
  // dx = g @ W^T + scale * gb @ A^T: W^T(n, k) = W[k * N + n],
  // A^T(c, k) = A[k * R + c]
  e = gemm<T, false>(gg, N, static_cast<const T*>(w), N, gb, R,
                     static_cast<const T*>(a), R, scale, static_cast<T*>(dx),
                     M, N, K, stream);
  if (e != cudaSuccess) return e;
  const int S = (M + MS - 1) / MS;
  // dA (K, r) = scale * x^T @ gb
  lora_partial_kernel<T><<<dim3((K + PT - 1) / PT, S), TT, 0, stream>>>(
      static_cast<const T*>(x), gb, work, M, K, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lora_reduce_kernel<T><<<(K * R + TT - 1) / TT, TT, 0, stream>>>(
      work, scale, static_cast<T*>(da), S, K, R, R, 1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // dB (r, N) = scale * xa^T @ g, summed as (N, r) and written transposed
  lora_partial_kernel<T><<<dim3((N + PT - 1) / PT, S), TT, 0, stream>>>(
      gg, xa, work, M, N, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lora_reduce_kernel<T><<<(N * R + TT - 1) / TT, TT, 0, stream>>>(
      work, scale, static_cast<T*>(db), S, N, R, 1, N);
  return cudaGetLastError();
}

}  // namespace

// Rows of each wide-pass CTA for an (M, N) output (64 or 128), and a
// CTA's dynamic shared memory in bytes (-1: not a config).
extern "C" int lora_fused_tile(int M, int N) { return pick_bm(M, N); }
extern "C" int lora_fused_smem(int bm, int kn, int dtype) {
  using BF = __nv_bfloat16;
  const bool f = dtype == REPRO_DTYPE_F32;
  if (bm == 128)
    return kn ? (f ? GemmTile<float>::smem_bytes<128, true>()
                   : GemmTile<BF>::smem_bytes<128, true>())
              : (f ? GemmTile<float>::smem_bytes<128, false>()
                   : GemmTile<BF>::smem_bytes<128, false>());
  if (bm == 64)
    return kn ? (f ? GemmTile<float>::smem_bytes<64, true>()
                   : GemmTile<BF>::smem_bytes<64, true>())
              : (f ? GemmTile<float>::smem_bytes<64, false>()
                   : GemmTile<BF>::smem_bytes<64, false>());
  return -1;
}

// Dynamic shared memory in bytes of a thin-pass CTA for ranks up to rn
// (16, 32 or 64), Y read k-major (1: the forward's xa) or not (0: the
// backward's gb) (-1: not a config).
template <typename T, bool KN>
int thin_smem(int rn) {
  switch (rn) {
    case 16: return XaTile<T, 16, KN>::smem_bytes();
    case 32: return XaTile<T, 32, KN>::smem_bytes();
    case 64: return XaTile<T, 64, KN>::smem_bytes();
    default: return -1;
  }
}
extern "C" int lora_fused_xa_smem(int rn, int kn, int dtype) {
  using BF = __nv_bfloat16;
  if (dtype == REPRO_DTYPE_F32)
    return kn ? thin_smem<float, true>(rn) : thin_smem<float, false>(rn);
  return kn ? thin_smem<BF, true>(rn) : thin_smem<BF, false>(rn);
}

// Rows of the split-M workspace the backward needs: (M / 256 rounded up)
// * max(K, N) * R floats.
extern "C" int lora_fused_work_slices(int M) { return (M + MS - 1) / MS; }

// xa: (M, R) fp32, written.  scale: device fp32 scalar.
extern "C" int lora_fused_fwd(const void* x, const void* w, const void* a,
                              const void* b, const void* scale, void* xa,
                              void* y, int M, int K, int N, int R, int dtype,
                              void* stream) {
  if (R < 1 || R > MAX_R || K < 1) return cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* xf = static_cast<float*>(xa);
  if (dtype == REPRO_DTYPE_F32)
    return fwd<float>(x, w, a, b, sc, xf, y, M, K, N, R, s);
  if (dtype == REPRO_DTYPE_BF16)
    return fwd<__nv_bfloat16>(x, w, a, b, sc, xf, y, M, K, N, R, s);
  return cudaErrorInvalidValue;
}

// xa: the forward's (M, R) fp32 residual.  gb: (M, R) fp32, written.
// work: lora_fused_work_slices(M) * max(K, N) * R floats of scratch.
// dx like x; da like A; db like B.
extern "C" int lora_fused_bwd(const void* x, const void* w, const void* a,
                              const void* b, const void* scale, const void* g,
                              const void* xa, void* gb, void* work, void* dx,
                              void* da, void* db, int M, int K, int N, int R,
                              int dtype, void* stream) {
  if (R < 1 || R > MAX_R || K < 1 || N < 1 || M < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* xf = static_cast<const float*>(xa);
  float* gf = static_cast<float*>(gb);
  float* wk = static_cast<float*>(work);
  if (dtype == REPRO_DTYPE_F32)
    return bwd<float>(x, w, a, b, sc, g, xf, gf, wk, dx, da, db, M, K, N, R,
                      s);
  if (dtype == REPRO_DTYPE_BF16)
    return bwd<__nv_bfloat16>(x, w, a, b, sc, g, xf, gf, wk, dx, da, db, M, K,
                              N, R, s);
  return cudaErrorInvalidValue;
}
