// Per-message, per-channel int8 quantization of smashed activations
// (quantize, dequantize and the fused round trip) for Hopper.
//
// Replaces the TPU kernels src/repro/kernels/smashed_quant/kernel.py
// quantize_pallas, roundtrip_pallas (both through _two_phase_call and
// _quant_body) and dequantize_pallas.
//
// For x (G, M, d), G messages (clients) of M tokens by d channels:
//   scale[g, c] = max(max_m |x[g, m, c]|, 1e-12) * (1 / 127)
//   q           = clip(round_half_even(x / scale), -127, 127)
//   quantize  -> (q int8, scale fp32 (G, d));  dequantize -> q * scale;
//   round trip -> q * scale in x's dtype, the int8 q never stored.
// The arithmetic is the reference's as XLA compiles it: the constant
// division "/ 127" becomes a multiply by fp32(1/127) (XLA's algebraic
// simplifier does that under jit; PyTorch does the same for a scalar
// divisor on the card), x / scale stays a true division (not a multiply
// by 1/scale), and rintf rounds half to even like jnp.round.  So the
// kernel, the plain version and the reference agree bit for bit, ties
// included.
//
// What bounds it on the H100: memory.  The round trip at the training
// path (G = 5, M = 2048, d = 768, fp32) reads x twice and writes y once,
// 31.5 MB of compulsory traffic (x once, y once) for ~4 operations per
// element.
//
// Design (simple and right first).  The TPU kernel carries the column
// amax in scratch across a sequential (g, phase, row block) grid; Hopper
// has no such grid, so one CTA owns (message g, slice of 32 channels) and
// streams that message's M rows twice: first the column amax (8 row
// groups, reduced in shared memory), then the emit.  A warp reads 32
// adjacent channels of one row (128 bytes in fp32).  At the path's shape
// that is 5 x 24 = 120 CTAs on 132 SMs.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CW = 32;            // channels per CTA (one warp's width)
constexpr int RG = 8;             // row groups (warps) per CTA
constexpr int NT = CW * RG;
constexpr float EPS = 1e-12f;

// Column scale of this CTA's (g, channel) from an amax pass over M rows.
template <typename T>
__device__ float column_scale(const T* __restrict__ xg, int M, int d, int c,
                              bool ok) {
  __shared__ float part[RG][CW];
  const int lane = threadIdx.x % CW;
  const int rg = threadIdx.x / CW;
  float amax = 0.f;
  if (ok)
    for (int m = rg; m < M; m += RG)
      amax = fmaxf(amax, fabsf(repro::to_f(xg[static_cast<size_t>(m) * d + c])));
  part[rg][lane] = amax;
  __syncthreads();
  float a = part[0][lane];
#pragma unroll
  for (int i = 1; i < RG; ++i) a = fmaxf(a, part[i][lane]);
  return fmaxf(a, EPS) * (1.f / 127.f);
}

__device__ __forceinline__ float quant(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

// mode 0: round trip (y in T); mode 1: quantize (q int8 + scale)
template <typename T, int MODE>
__global__ void __launch_bounds__(NT)
smashed_quant_kernel(const T* __restrict__ x, T* __restrict__ y,
                     int8_t* __restrict__ q, float* __restrict__ scale_out,
                     int M, int d) {
  const int g = blockIdx.y;
  const int c = blockIdx.x * CW + threadIdx.x % CW;
  const bool ok = c < d;
  const size_t base = static_cast<size_t>(g) * M * d;
  const float scale = column_scale(x + base, M, d, c, ok);
  if (!ok) return;
  const int rg = threadIdx.x / CW;
  if (MODE == 1 && rg == 0) scale_out[static_cast<size_t>(g) * d + c] = scale;
  for (int m = rg; m < M; m += RG) {
    const size_t i = base + static_cast<size_t>(m) * d + c;
    const float qv = quant(repro::to_f(x[i]), scale);
    if (MODE == 0)
      y[i] = repro::from_f<T>(qv * scale);
    else
      q[i] = static_cast<int8_t>(qv);
  }
}

template <typename T>
__global__ void dequant_kernel(const int8_t* __restrict__ q,
                               const float* __restrict__ scale,
                               T* __restrict__ x, int M, int d) {
  const int g = blockIdx.y;
  const size_t per = static_cast<size_t>(M) * d;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < per; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % d);
    const size_t j = static_cast<size_t>(g) * per + i;
    x[j] = repro::from_f<T>(static_cast<float>(q[j]) *
                            scale[static_cast<size_t>(g) * d + c]);
  }
}

template <typename T, int MODE>
cudaError_t launch_quant(const void* x, void* y, void* q, void* scale, int G,
                         int M, int d, cudaStream_t s) {
  const dim3 grid((d + CW - 1) / CW, G);
  smashed_quant_kernel<T, MODE><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<int8_t*>(q), static_cast<float*>(scale), M, d);
  return cudaGetLastError();
}

}  // namespace

// x, y: (G, M, d) contiguous in the dtype's element type.
extern "C" int smashed_roundtrip(const void* x, void* y, int G, int M, int d,
                                 int dtype, void* stream) {
  if (G <= 0 || M <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch_quant<float, 0>(x, y, nullptr, nullptr, G, M, d, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch_quant<__nv_bfloat16, 0>(x, y, nullptr, nullptr, G, M, d, s);
  return cudaErrorInvalidValue;
}

// q: (G, M, d) int8; scale: (G, d) fp32.
extern "C" int smashed_quantize(const void* x, void* q, void* scale, int G,
                                int M, int d, int dtype, void* stream) {
  if (G <= 0 || M <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == REPRO_DTYPE_F32)
    return launch_quant<float, 1>(x, nullptr, q, scale, G, M, d, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch_quant<__nv_bfloat16, 1>(x, nullptr, q, scale, G, M, d, s);
  return cudaErrorInvalidValue;
}

// x: (G, M, d) in the output dtype.
extern "C" int smashed_dequantize(const void* q, const void* scale, void* x,
                                  int G, int M, int d, int dtype,
                                  void* stream) {
  if (G <= 0 || M <= 0 || d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const size_t blocks = (static_cast<size_t>(M) * d + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(blocks < 1024 ? blocks : 1024), G);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == REPRO_DTYPE_F32)
    dequant_kernel<float><<<grid, threads, 0, s>>>(
        qq, sc, static_cast<float*>(x), M, d);
  else if (dtype == REPRO_DTYPE_BF16)
    dequant_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        qq, sc, static_cast<__nv_bfloat16*>(x), M, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
