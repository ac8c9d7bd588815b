// Fused LoRA projection, forward and backward, for Hopper.
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
// 1..64 (rank columns that the rank mask zeroed are summed as zeros).
//
// What bounds it on the H100: at the eval path (M = 10240 tokens,
// K = N = 768, r = 16, fp32) the x @ W product is 12 GFLOP against 63 MB
// of x and y, ~190 FLOPs per byte: operations bound (fp32 outside the
// tensor cores, 67 TFLOP/s); the rank-r terms add 2 % of the work.
//
// Design (simple and right first; wgmma/TMA come later).  The TPU kernels
// keep xa (and gb) in scratch across a sequential grid axis and
// accumulate dA/dB in output windows that every grid step revisits;
// Hopper CTAs run in parallel, so:
//  * a thin pass (lora_thin_kernel) computes xa = x @ A (or gb = g @ B^T)
//    into a tensor the wrapper allocates, before the wide pass reads it;
//  * the wide pass (lora_wide_kernel) is one register-blocked fp32 GEMM
//    over tiles of 64 x 64 outputs (4 x 4 per thread, K staged in
//    shared-memory slices of 16), computing x @ W inside this kernel, with
//    the scale * xa @ B epilogue; the backward's dx is the same kernel
//    reading W and A transposed through strides;
//  * dA and dB reduce over all M rows: each CTA of lora_partial_kernel
//    sums one slice of MS rows into a workspace, and lora_reduce_kernel
//    adds the slices in slice order: deterministic, no atomics.
#include "common.cuh"

namespace {

constexpr int MAX_R = 64;

// ---- thin pass: out[m, c] = sum_k X[m, k] * Y(k, c), c < R --------------
// Y(k, c) = y[k * ysk + c * ysc]; one CTA per TM rows, K staged in slices.
constexpr int TT = 256;
constexpr int TM = 16;
constexpr int TKC = 64;

template <typename T, typename TY>
__global__ void __launch_bounds__(TT)
lora_thin_kernel(const T* __restrict__ x, const TY* __restrict__ y,
                 float* __restrict__ out, int M, int K, int R, int ysk,
                 int ysc) {
  __shared__ float xs[TM][TKC];
  __shared__ float ys[TKC][MAX_R];
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  // each thread owns outputs o = tid, tid + TT, ... of the TM x R tile
  float acc[(TM * MAX_R + TT - 1) / TT];
#pragma unroll
  for (int i = 0; i < (TM * MAX_R + TT - 1) / TT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TKC) {
    __syncthreads();
    for (int i = tid; i < TM * TKC; i += TT) {
      const int m = i / TKC, kk = i % TKC;
      const int row = m0 + m, kg = k0 + kk;
      xs[m][kk] = (row < M && kg < K)
                      ? repro::to_f(x[static_cast<size_t>(row) * K + kg])
                      : 0.f;
    }
    for (int i = tid; i < TKC * R; i += TT) {
      const int kk = i / R, c = i % R;
      const int kg = k0 + kk;
      ys[kk][c] = kg < K ? repro::to_f(y[static_cast<size_t>(kg) * ysk +
                                         static_cast<size_t>(c) * ysc])
                         : 0.f;
    }
    __syncthreads();
    const int kmax = min(TKC, K - k0);
#pragma unroll
    for (int i = 0; i < (TM * MAX_R + TT - 1) / TT; ++i) {
      const int o = tid + i * TT;
      if (o < TM * R) {
        const int m = o / R, c = o % R;
        float s = acc[i];
        for (int kk = 0; kk < kmax; ++kk) s = fmaf(xs[m][kk], ys[kk][c], s);
        acc[i] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < (TM * MAX_R + TT - 1) / TT; ++i) {
    const int o = tid + i * TT;
    if (o < TM * R) {
      const int row = m0 + o / R;
      if (row < M) out[static_cast<size_t>(row) * R + o % R] = acc[i];
    }
  }
}

// ---- wide pass: C[m, n] = sum_k X[m, k] * W(k, n) + s * sum_c L[m, c] * V(c, n)
// W(k, n) = w[k * wsk + n * wsn]; V(c, n) = v[c * vsc + n * vsn];
// X (M, K) and C (M, N) row-major; L (M, R) fp32 row-major.
constexpr int WT = 256;          // threads: 16 x 16, 4 x 4 outputs each
constexpr int WBM = 64;
constexpr int WBN = 64;
constexpr int WBK = 16;

template <typename T>
__global__ void __launch_bounds__(WT)
lora_wide_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ l, const T* __restrict__ v,
                 const float* __restrict__ scale, T* __restrict__ c, int M,
                 int K, int N, int R, int wsk, int wsn, int vsc, int vsn) {
  // +1 pads keep the transposing tile stores free of bank conflicts
  __shared__ float xs[WBK][WBM + 1];  // x tile, k-major
  __shared__ float wsh[WBK][WBN + 1];
  __shared__ float lsh[WBM][MAX_R + 1];
  __shared__ float vsh[MAX_R][WBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // column group
  const int ty = tid / 16;            // row group
  const int m0 = blockIdx.y * WBM;
  const int n0 = blockIdx.x * WBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += WBK) {
    __syncthreads();
    for (int i = tid; i < WBM * WBK; i += WT) {
      const int m = i / WBK, kk = i % WBK;
      const int row = m0 + m, kg = k0 + kk;
      xs[kk][m] = (row < M && kg < K)
                      ? repro::to_f(x[static_cast<size_t>(row) * K + kg])
                      : 0.f;
    }
    for (int i = tid; i < WBK * WBN; i += WT) {
      // consecutive threads along n when W is n-contiguous, along k when
      // it is read transposed
      int kk, n;
      if (wsn == 1) { kk = i / WBN; n = i % WBN; }
      else          { kk = i % WBK; n = i / WBK; }
      const int kg = k0 + kk, col = n0 + n;
      wsh[kk][n] = (kg < K && col < N)
                       ? repro::to_f(w[static_cast<size_t>(kg) * wsk +
                                       static_cast<size_t>(col) * wsn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wsh[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: + scale * L @ V over the tile's rows and columns
  __syncthreads();
  for (int i = tid; i < WBM * R; i += WT) {
    const int m = i / R, cc = i % R;
    const int row = m0 + m;
    lsh[m][cc] = row < M ? l[static_cast<size_t>(row) * R + cc] : 0.f;
  }
  for (int i = tid; i < R * WBN; i += WT) {
    int cc, n;
    if (vsn == 1) { cc = i / WBN; n = i % WBN; }
    else          { cc = i % R; n = i / R; }
    const int col = n0 + n;
    vsh[cc][n] = col < N ? repro::to_f(v[static_cast<size_t>(cc) * vsc +
                                         static_cast<size_t>(col) * vsn])
                         : 0.f;
  }
  __syncthreads();
  const float s = *scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    const int row = m0 + m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      const int col = n0 + n;
      float delta = 0.f;
      for (int cc = 0; cc < R; ++cc) delta = fmaf(lsh[m][cc], vsh[cc][n], delta);
      if (row < M && col < N)
        c[static_cast<size_t>(row) * N + col] = repro::from_f<T>(acc[i][j] + s * delta);
    }
  }
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
  lora_thin_kernel<T, T><<<(M + TM - 1) / TM, TT, 0, stream>>>(
      xx, static_cast<const T*>(a), xa, M, K, R, R, 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((N + WBN - 1) / WBN, (M + WBM - 1) / WBM);
  lora_wide_kernel<T><<<grid, WT, 0, stream>>>(
      xx, static_cast<const T*>(w), xa, static_cast<const T*>(b), scale,
      static_cast<T*>(y), M, K, N, R, N, 1, N, 1);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const void* a, const void* b,
                const float* scale, const void* g, const float* xa, float* gb,
                float* work, void* dx, void* da, void* db, int M, int K,
                int N, int R, cudaStream_t stream) {
  const T* gg = static_cast<const T*>(g);
  const T* bb = static_cast<const T*>(b);
  // gb = g @ B^T: B^T(n, c) = B[c * N + n]
  lora_thin_kernel<T, T><<<(M + TM - 1) / TM, TT, 0, stream>>>(
      gg, bb, gb, M, N, R, 1, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // dx = g @ W^T + scale * gb @ A^T: W^T(n, k) = W[k * N + n],
  // A^T(c, k) = A[k * R + c]
  const dim3 grid((K + WBN - 1) / WBN, (M + WBM - 1) / WBM);
  lora_wide_kernel<T><<<grid, WT, 0, stream>>>(
      gg, static_cast<const T*>(w), gb, static_cast<const T*>(a), scale,
      static_cast<T*>(dx), M, N, K, R, 1, N, 1, R);
  e = cudaGetLastError();
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
