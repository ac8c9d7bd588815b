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
//  * dA = s x^T @ gb and dB = s xa^T @ g reduce over all M rows, in one
//    launch (lora_dab_kernel): a CTA owns one 64-column tile of x (for
//    dA) or of g (for dB^T) and one slice of M, stages 32-row tiles of
//    x or g and of gb or xa through the cp.async ring, reads x and g
//    transposed out of shared memory as the MMA's A operand and sums each
//    32-row tile into fresh accumulators (3xTF32 for fp32; for bf16, x
//    and g are exact in TF32 and only gb and xa are split: two MMAs).
//    The slices' partials go to a workspace; the last CTA of each column
//    tile to count adds them in slice order (deterministic, no float
//    atomics), scales, writes dA or dB^T in the adapter's dtype and
//    resets its counter.  The slices are whole 32-row tiles, as many as
//    give about 4 CTAs per SM (528 CTAs at M = 10240, K = N = 768).  The
//    pass reads x and g once (63 MB at the gpt2 eval shape): its bound is
//    bytes, 0.019 ms at 3.35 TB/s, against 0.003 ms of 3xTF32 work.
#include "mma_sync.cuh"

namespace {

constexpr int MAX_R = 64;

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

// ---- adapter gradients on the tensor cores, dA and dB in one launch:
// out[p, c] = s sum_m X[m, p] Y[m, c] with X (M, P) in T and Y (M, R) fp32:
// dA = s x^T @ gb (X = x, P = K, Y = gb) and dB^T = s g^T @ xa (X = g,
// P = N, Y = xa).  The thin pass's shape with the roles changed: M is the
// reduction, and the P x R output is tiled over CTAs.  A CTA owns one
// column tile (DPT columns of x or of g) and one slice of M; the last CTA
// of a column tile to count adds the slices' partials in slice order.
constexpr int DW = 4;              // warps per CTA, 16 output rows (p) each
constexpr int DPT = 16 * DW;       // output rows (columns of X) per tile
constexpr int DBK = 32;            // rows of M per stage: one fresh partial
constexpr int DAB_CTAS = 4 * MIN_WAVE;  // grid target: 4 CTAs per SM
// vec bits of the dA/dB pass: rows of x, g, gb, xa are 16-byte aligned
constexpr int VEC_DX = 1, VEC_DG = 2, VEC_DGB = 4, VEC_DXA = 8;

template <typename T, int RN>
struct DabTile {
  // X's stage rows read transposed (load_xt): conflict-free with a row of
  // 4 mod 16 (fp32) or 8 mod 16 (bf16) elements
  static constexpr int LDX = DPT + repro::mma::Pad<T>::value;
  static constexpr int LDY = RN + repro::mma::Pad<float>::value;
  static constexpr int X_BYTES = DBK * LDX * static_cast<int>(sizeof(T));
  static constexpr int STAGE_BYTES = X_BYTES + DBK * LDY * 4;
  __host__ __device__ static constexpr int smem_bytes() {
    return STAGES * STAGE_BYTES;
  }
};

// column tiles (those of dA first) and the M slices of a call: enough
// slices of whole 32-row stages to give about DAB_CTAS CTAs
struct DabGrid {
  int tiles, rows, slices;
};
inline DabGrid dab_grid(int M, int K, int N) {
  const int tiles = (K + DPT - 1) / DPT + (N + DPT - 1) / DPT;
  const int steps = (M + DBK - 1) / DBK;
  const int fill = DAB_CTAS / tiles;
  const int want = steps < fill ? steps : fill > 1 ? fill : 1;
  const int per = (steps + want - 1) / want;
  return {tiles, per * DBK, (steps + per - 1) / per};
}

inline int rank_tile(int R) { return R <= 16 ? 16 : R <= 32 ? 32 : 64; }

// A fragment of X^T (16 p rows x 8 rows of M, in load_b_kn's permuted k
// order) from a staged (m, p) tile: A[p][k] = xs[k * ld + p], as fp32
// (bf16 is exact in TF32)
template <typename T>
__device__ __forceinline__ repro::mma::Mma<float>::A load_xt(const T* p,
                                                             int ld, int g,
                                                             int t) {
  return {{repro::to_f(p[2 * t * ld + g]), repro::to_f(p[2 * t * ld + g + 8]),
           repro::to_f(p[(2 * t + 1) * ld + g]),
           repro::to_f(p[(2 * t + 1) * ld + g + 8])}};
}

template <typename T, int RN>
__global__ void __launch_bounds__(32 * DW)
lora_dab_kernel(const T* __restrict__ x, const float* __restrict__ gb,
                const T* __restrict__ g, const float* __restrict__ xa,
                const float* __restrict__ scale, float* __restrict__ work,
                int* __restrict__ counters, T* __restrict__ da,
                T* __restrict__ db, int M, int K, int N, int R, int rows,
                int vec) {
  using M_ = repro::mma::Mma<float>;
  using D = DabTile<T, RN>;
  constexpr int NT = 32 * DW;
  constexpr int NJ = RN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int gq = (tid & 31) >> 2;
  const int t = tid & 3;
  const int tile = blockIdx.x;
  const int ns = gridDim.y;
  const int ta = (K + DPT - 1) / DPT;
  const bool is_a = tile < ta;
  const T* X = is_a ? x : g;
  const float* Y = is_a ? gb : xa;
  const int P = is_a ? K : N;
  const int p0 = (is_a ? tile : tile - ta) * DPT;
  const bool xv = vec & (is_a ? VEC_DX : VEC_DG);
  const bool yv = vec & (is_a ? VEC_DGB : VEC_DXA);
  const int m_lo = blockIdx.y * rows;
  const int m_hi = min(M, m_lo + rows);
  const int nst = (m_hi - m_lo + DBK - 1) / DBK;

  auto load_stage = [&](int st, int buf) {
    unsigned char* base = smem_raw + buf * D::STAGE_BYTES;
    const int m0 = m_lo + st * DBK;
    repro::mma::load_tile_2d<T>(reinterpret_cast<T*>(base), D::LDX,
                                X + static_cast<size_t>(m0) * P + p0, P, DBK,
                                DPT, m_hi - m0, P - p0, xv, tid, NT);
    repro::mma::load_tile_2d<float>(
        reinterpret_cast<float*>(base + D::X_BYTES), D::LDY,
        Y + static_cast<size_t>(m0) * R, R, DBK, RN, m_hi - m0, R, yv, tid,
        NT);
  };

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) repro::mma::zero(acc[j]);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nst) load_stage(st, st);
    repro::mma::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    repro::mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nst)
      load_stage(st + STAGES - 1, (st + STAGES - 1) % STAGES);
    repro::mma::cp_async_commit();
    const unsigned char* base = smem_raw + (st % STAGES) * D::STAGE_BYTES;
    const T* xs = reinterpret_cast<const T*>(base) + 16 * warp;
    const float* ys = reinterpret_cast<const float*>(base + D::X_BYTES);
    const int kv = m_hi - m_lo - st * DBK;  // rows of the stage in M
    // the stage's sum in fresh accumulators, added to acc once: an MMA
    // truncates its fp32 sum, and M runs to 10240 rows
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) repro::mma::zero(part[j]);
#pragma unroll
    for (int kk = 0; kk < DBK / M_::K; ++kk) {
      if (kk * M_::K >= kv) break;
      const M_::A a = load_xt(xs + kk * M_::K * D::LDX, D::LDX, gq, t);
      // fp32: 3xTF32; bf16 x and g are exact in TF32, so only Y is split
      // and its two halves make two MMAs
      const M_::AP ap = M_::prep_a_tr(a);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const M_::BP bp = M_::prep_b_tr(
            M_::load_b_kn(ys + kk * M_::K * D::LDY + 8 * j, D::LDY, gq, t));
        if (sizeof(T) == 4) {
          M_::mma(part[j], ap, bp);
        } else {
          M_::mma1(part[j], ap.big, bp.small);
          M_::mma1(part[j], ap.big, bp.big);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }

  // this slice's partial: (DPT, RN) floats at work[tile][slice]
  float* wp = work + (static_cast<size_t>(tile) * ns + blockIdx.y) * DPT * RN;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v;
      v.x = acc[j][2 * h];
      v.y = acc[j][2 * h + 1];
      *reinterpret_cast<float2*>(wp + (16 * warp + gq + 8 * h) * RN + 8 * j +
                                 2 * t) = v;
    }

  // the last of the tile's CTAs adds the partials in slice order
  __syncthreads();
  if (tid == 0) last = repro::count_acq_rel(counters + tile) == ns - 1;
  __syncthreads();
  if (!last) return;
  // a thread sums P4 float4 positions of the tile, NB slices of each
  // loaded at once (16 loads in flight)
  constexpr int P4 = DPT * RN / 4 / NT;
  constexpr int NB = 16 / P4;
  const float* wt = work + static_cast<size_t>(tile) * ns * DPT * RN;
  float sum[P4][4];
#pragma unroll
  for (int j = 0; j < P4; ++j) repro::mma::zero(sum[j]);
  for (int s0 = 0; s0 < ns; s0 += NB) {
    float4 buf[NB][P4];
#pragma unroll
    for (int u = 0; u < NB; ++u)
#pragma unroll
      for (int j = 0; j < P4; ++j)
        buf[u][j] = s0 + u < ns
                        ? __ldcg(reinterpret_cast<const float4*>(
                              wt + static_cast<size_t>(s0 + u) * DPT * RN +
                              4 * (tid + j * NT)))
                        : float4{0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (s0 + u < ns)
#pragma unroll
        for (int j = 0; j < P4; ++j) {
          sum[j][0] += buf[u][j].x;
          sum[j][1] += buf[u][j].y;
          sum[j][2] += buf[u][j].z;
          sum[j][3] += buf[u][j].w;
        }
  }
  const float s = *scale;
#pragma unroll
  for (int j = 0; j < P4; ++j) {
    const int i = 4 * (tid + j * NT);
    const int p = p0 + i / RN;
    const int c = i % RN;
    if (p >= P) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= R) break;
      const T v = repro::from_f<T>(s * sum[j][e]);
      if (is_a)
        da[static_cast<size_t>(p) * R + c + e] = v;   // dA (K, R)
      else
        db[static_cast<size_t>(c + e) * N + p] = v;   // dB (R, N)
    }
  }
  if (tid == 0) counters[tile] = 0;
}

template <typename T, int RN>
cudaError_t launch_dab(const T* x, const float* gb, const T* g,
                       const float* xa, const float* scale, float* work,
                       int* counters, T* da, T* db, int M, int K, int N,
                       int R, cudaStream_t stream) {
  constexpr int smem = DabTile<T, RN>::smem_bytes();
  static const cudaError_t opt_in =
      repro::mma::allow_smem(lora_dab_kernel<T, RN>, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const size_t es = sizeof(T);
  int vec = 0;
  if (repro::mma::aligned16(x, K * es)) vec |= VEC_DX;
  if (repro::mma::aligned16(g, N * es)) vec |= VEC_DG;
  if (repro::mma::aligned16(gb, R * 4)) vec |= VEC_DGB;
  if (repro::mma::aligned16(xa, R * 4)) vec |= VEC_DXA;
  const DabGrid gr = dab_grid(M, K, N);
  lora_dab_kernel<T, RN><<<dim3(gr.tiles, gr.slices), 32 * DW, smem,
                           stream>>>(x, gb, g, xa, scale, work, counters, da,
                                     db, M, K, N, R, gr.rows, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dab(const T* x, const float* gb, const T* g, const float* xa,
                const float* scale, float* work, int* counters, T* da, T* db,
                int M, int K, int N, int R, cudaStream_t stream) {
  switch (rank_tile(R)) {
    case 16:
      return launch_dab<T, 16>(x, gb, g, xa, scale, work, counters, da, db,
                               M, K, N, R, stream);
    case 32:
      return launch_dab<T, 32>(x, gb, g, xa, scale, work, counters, da, db,
                               M, K, N, R, stream);
    default:
      return launch_dab<T, 64>(x, gb, g, xa, scale, work, counters, da, db,
                               M, K, N, R, stream);
  }
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
                float* work, int* counters, void* dx, void* da, void* db,
                int M, int K, int N, int R, cudaStream_t stream) {
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
  // dA (K, r) = scale * x^T @ gb and dB (r, N) = scale * xa^T @ g
  return dab<T>(static_cast<const T*>(x), gb, gg, xa, scale, work, counters,
                static_cast<T*>(da), static_cast<T*>(db), M, K, N, R, stream);
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

// The dA/dB pass: floats of its fp32 workspace (the slices' partials; the
// caller allocates it per call, its contents need not be initialised),
// its int32 counters (one per column tile; the caller zeroes them once
// and keeps them, each call leaves them zero), the CTAs of its grid, and
// a CTA's dynamic shared memory in bytes for ranks up to rn (16, 32, 64;
// -1: not a config).
extern "C" long long lora_fused_dab_work(int M, int K, int N, int R) {
  const DabGrid gr = dab_grid(M, K, N);
  return static_cast<long long>(gr.tiles) * gr.slices * DPT * rank_tile(R);
}
extern "C" int lora_fused_dab_counters(int K, int N) {
  return dab_grid(1, K, N).tiles;
}
extern "C" int lora_fused_dab_ctas(int M, int K, int N) {
  const DabGrid gr = dab_grid(M, K, N);
  return gr.tiles * gr.slices;
}
template <typename T>
int dab_smem(int rn) {
  switch (rn) {
    case 16: return DabTile<T, 16>::smem_bytes();
    case 32: return DabTile<T, 32>::smem_bytes();
    case 64: return DabTile<T, 64>::smem_bytes();
    default: return -1;
  }
}
extern "C" int lora_fused_dab_smem(int rn, int dtype) {
  return dtype == REPRO_DTYPE_F32 ? dab_smem<float>(rn)
                                  : dab_smem<__nv_bfloat16>(rn);
}

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
// work, counters: as lora_fused_dab_work and lora_fused_dab_counters say.
// dx like x; da like A; db like B.
extern "C" int lora_fused_bwd(const void* x, const void* w, const void* a,
                              const void* b, const void* scale, const void* g,
                              const void* xa, void* gb, void* work,
                              void* counters, void* dx, void* da, void* db,
                              int M, int K, int N, int R, int dtype,
                              void* stream) {
  if (R < 1 || R > MAX_R || K < 1 || N < 1 || M < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* xf = static_cast<const float*>(xa);
  float* gf = static_cast<float*>(gb);
  float* wk = static_cast<float*>(work);
  int* ctr = static_cast<int*>(counters);
  if (dtype == REPRO_DTYPE_F32)
    return bwd<float>(x, w, a, b, sc, g, xf, gf, wk, ctr, dx, da, db, M, K, N,
                      R, s);
  if (dtype == REPRO_DTYPE_BF16)
    return bwd<__nv_bfloat16>(x, w, a, b, sc, g, xf, gf, wk, ctr, dx, da, db,
                              M, K, N, R, s);
  return cudaErrorInvalidValue;
}
