// Indexed multi-adapter LoRA projection for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul/kernel.py
// lora_matmul_indexed_pallas (body _indexed_kernel).
//
// Computes, for every row i of x (M, K):
//   y[i] = x[i] @ W + scale[id] * (x[i] @ A[id]) @ B[id],   id = ids[i]
// with W (K, N), A pool (P, K, R), B pool (P, R, N), scale (P,) fp32,
// ids (M,) int32, y (M, N) in x's dtype; fp32 accumulation throughout and
// xa = x @ A[id] kept in fp32, as the TPU kernel does.
//
// What bounds it on the H100: at the serving decode tick (M = num_slots
// = 8, K = N = 768, R = 16, fp32) each call does 2*M*K*N ~ 9.4 MFLOP on
// the 2.4 MB of W, about 4 FLOPs per byte: memory bound on W (0.7 us at
// 3.35 TB/s).  At prefill (M = bucket, 128) it is 60 FLOPs per byte, at
// the fp32 FMA rate (67 TFLOP/s) about 0.14 us of arithmetic, so launch
// and latency dominate either way at these widths.
//
// Design (simple and right first), two kernels behind one entry point:
//  * the TPU kernel computes xa once at j == 0 and reuses it across its
//    sequential j axis.  CTAs here run in parallel, so a first pass
//    (lora_xa_kernel, one CTA per row, the K axis split over the threads)
//    writes xa (M, R) fp32 to scratch that the wrapper allocates;
//  * the main pass (lora_indexed_kernel) runs one CTA per (tile of LBM
//    rows, tile of LBN = 32 output columns); each lane owns one column,
//    each of the 8 warps one slice of every K chunk, so a warp's W loads
//    are 32 consecutive values.  x @ W is computed here, not by a library
//    GEMM; the epilogue adds scale[id] * xa @ B[id];
//  * each CTA loads its rows' ids itself (no scalar prefetch) and clamps
//    them into the pool;
//  * every output's sums run in an order fixed by K, R and the tile
//    constants alone (per-thread partials over fixed K slices, combined
//    in slice order), so a row's result does not depend on which other
//    rows share the launch: the batched engine reproduces the one-request
//    serial reference bit for bit.
#include "common.cuh"

namespace {

constexpr int LT = 256;       // threads per CTA (both kernels)
constexpr int NW = LT / 32;   // warps
constexpr int LBM = 8;        // rows per CTA
constexpr int LBN = 32;       // columns per CTA (one per lane)
constexpr int LKC = 256;      // K chunk staged in shared memory
constexpr int KW = LKC / NW;  // K values per warp per chunk
constexpr int MAX_R = 64;

static_assert(LBM * LBN == LT, "epilogue maps one thread per output");

// xa[row, rr] = sum_k x[row, k] * A[id, k, rr]: thread (slice, rr) sums a
// contiguous K slice; the slices are then added in order.
template <typename T>
__global__ void __launch_bounds__(LT)
lora_xa_kernel(const T* __restrict__ x, const T* __restrict__ a_pool,
               const int* __restrict__ ids, float* __restrict__ xa, int K,
               int R, int P) {
  __shared__ float part[LT];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int nslice = LT / R;
  const int rr = tid % R;
  const int slice = tid / R;
  const int id = min(max(ids[row], 0), P - 1);
  if (slice < nslice) {
    const int len = (K + nslice - 1) / nslice;
    const int k_lo = slice * len;
    const int k_hi = min(K, k_lo + len);
    const T* xr = x + static_cast<size_t>(row) * K;
    const T* a = a_pool + static_cast<size_t>(id) * K * R + rr;
    float s = 0.f;
#pragma unroll 8
    for (int k = k_lo; k < k_hi; ++k)
      s = fmaf(repro::to_f(xr[k]), repro::to_f(a[static_cast<size_t>(k) * R]), s);
    part[slice * R + rr] = s;
  }
  __syncthreads();
  if (tid < R) {
    float s = 0.f;
    for (int j = 0; j < nslice; ++j) s += part[j * R + tid];
    xa[static_cast<size_t>(row) * R + tid] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(LT)
lora_indexed_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ b_pool,
                    const float* __restrict__ scale, const int* __restrict__ ids,
                    const float* __restrict__ xa, T* __restrict__ y, int M,
                    int K, int N, int R, int P) {
  __shared__ float xs[LBM][LKC];
  __shared__ float red[NW][LBM][LBN];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * LBM;
  const int n0 = blockIdx.x * LBN;
  const int col = n0 + lane;

  float acc[LBM];
#pragma unroll
  for (int m = 0; m < LBM; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += LKC) {
    __syncthreads();
    for (int i = tid; i < LBM * LKC; i += LT) {
      const int m = i / LKC;
      const int kk = i % LKC;
      const int row = m0 + m;
      const int kg = k0 + kk;
      xs[m][kk] = (row < M && kg < K)
                      ? repro::to_f(x[static_cast<size_t>(row) * K + kg])
                      : 0.f;
    }
    __syncthreads();
    // x @ W: warp `warp` takes K slice [warp*KW, (warp+1)*KW) of the chunk
    if (col < N) {
      const int kmax = min(KW, K - k0 - warp * KW);
#pragma unroll 8
      for (int j = 0; j < kmax; ++j) {
        const int kk = warp * KW + j;
        const float wv = repro::to_f(w[static_cast<size_t>(k0 + kk) * N + col]);
#pragma unroll
        for (int m = 0; m < LBM; ++m) acc[m] = fmaf(xs[m][kk], wv, acc[m]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < LBM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();

  const int m = tid / LBN;
  const int c = tid % LBN;
  const int row = m0 + m;
  const int n = n0 + c;
  if (row < M && n < N) {
    float base = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) base += red[j][m][c];
    const int id = min(max(ids[row], 0), P - 1);
    const T* bb = b_pool + static_cast<size_t>(id) * R * N + n;
    const float* xr = xa + static_cast<size_t>(row) * R;
    float delta = 0.f;
    for (int rr = 0; rr < R; ++rr)
      delta = fmaf(xr[rr], repro::to_f(bb[static_cast<size_t>(rr) * N]), delta);
    y[static_cast<size_t>(row) * N + n] = repro::from_f<T>(base + scale[id] * delta);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   const float* scale, const int* ids, float* xa, void* y,
                   int M, int K, int N, int R, int P, cudaStream_t stream) {
  lora_xa_kernel<T><<<M, LT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), ids, xa, K, R, P);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((N + LBN - 1) / LBN, (M + LBM - 1) / LBM);
  lora_indexed_kernel<T><<<grid, LT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), scale, ids, xa, static_cast<T*>(y), M, K, N,
      R, P);
  return cudaGetLastError();
}

}  // namespace

// xa: (M, R) fp32 scratch owned by the caller.
extern "C" int lora_indexed(const void* x, const void* w, const void* a_pool,
                            const void* b_pool, const void* scale,
                            const void* ids, void* xa, void* y, int M, int K,
                            int N, int R, int P, int dtype, void* stream) {
  if (R < 1 || R > MAX_R || P < 1 || K < 1) return cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int* id = static_cast<const int*>(ids);
  float* xf = static_cast<float*>(xa);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(x, w, a_pool, b_pool, sc, id, xf, y, M, K, N, R, P, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, a_pool, b_pool, sc, id, xf, y, M, K, N,
                                 R, P, s);
  return cudaErrorInvalidValue;
}
