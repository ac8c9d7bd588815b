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
// path (G = 5, M = 2048, d = 768, fp32) must read x once and write y
// once, 63 MB (0.019 ms at 3.35 TB/s), for ~6 operations per element;
// quantize and dequantize move 5 bytes per element (0.012 ms).
//
// Design.  The TPU kernel carries the column amax in scratch across a
// sequential (g, phase, row block) grid.  Here quantize and the round trip
// are one launch of thread block clusters: one cluster of CS CTAs per
// (message, 64-channel tile), each CTA a slice of the message's M rows.
//  * A lane owns 16 bytes of a row (4 fp32 or 8 bf16 channels) and loads
//    its rows with 16-byte loads, 8 or 16 of them in flight: enough bytes
//    in flight to cover DRAM's latency.
//  * Each CTA reduces its column amax in shared memory; after a cluster
//    barrier every CTA takes the max of the CS CTAs' amax through
//    distributed shared memory (mapa).  Max is exact, so the split of M
//    cannot change a scale.  A second cluster barrier, waited for at the
//    end, keeps every CTA's shared memory alive until the others have
//    read it.
//  * Each CTA then emits its own rows.  Quantize reads them again: at 64
//    registers its 480 CTAs at the path's shape (5 messages x 12 tiles x
//    8) are resident at once, 4 a SM.  The round trip keeps each thread's
//    first rows, 256 of the CTA's, in registers from the first pass (64
//    registers fp32), so x is read once, at 2 CTAs a SM (two waves);
//    rows past those (M above 2048) are streamed and read again.  On the
//    card, keeping the rows made the round trip faster and quantize
//    slower (its second wave cost more than its second read).
//  * What holds both back: within a wave every CTA reads, waits at the
//    cluster barrier and then writes, so the reads and the writes of a
//    wave do not overlap.
//  * d not a multiple of the lane's channels (or an unaligned x) takes
//    the same loops with element loads.
// Dequantize is elementwise: a thread owns 4 channels of a message, loads
// their scales once, and walks the message's rows with one 4-byte load of
// q and one 16-byte (fp32) or 8-byte (bf16) store of x per row, DU rows
// in flight (element by element when d is not a multiple of 4); 4 CTAs a
// SM, all resident.  Neighbouring lanes own neighbouring channels, so a
// warp's store is 512 contiguous bytes: with 16 contiguous channels a
// thread, each 16-byte store instruction would write half of each of 32
// sectors, which measured slower on the card.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CS = 8;          // CTAs per cluster: the split of M
constexpr int NT = 256;        // threads per CTA
constexpr int CT = 64;         // channels per cluster
constexpr int KEEP_ROWS = 256; // round trip: rows a CTA keeps in registers
constexpr int DQ = 4;          // dequantize: channels per thread
constexpr int DU = 4;          // dequantize: rows a thread has in flight
constexpr int DQ_CTAS = 4 * 132;  // dequantize: 4 CTAs per H100 SM
constexpr float EPS = 1e-12f;

// N elements that move as one load or store
template <typename T, int N>
struct alignas(N * sizeof(T)) Vec {
  static constexpr int size = N;
  T v[N];
};
// 16 bytes of a row: the channels one lane of quantize owns
template <typename T>
using Pack = Vec<T, 16 / sizeof(T)>;

// the first n channels at p (the rest zero): one 16-byte load when vec
template <typename T>
__device__ __forceinline__ Pack<T> load_pack(const T* p, bool vec, int n) {
  Pack<T> r;
  if (vec && n == Pack<T>::size) return *reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
  for (int e = 0; e < Pack<T>::size; ++e)
    r.v[e] = e < n ? p[e] : repro::from_f<T>(0.f);
  return r;
}

__device__ __forceinline__ float quant(float x, float scale) {
  return fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
}

// thread block clusters: the barrier (arrive releases this thread's
// writes, wait acquires those of every thread that arrived), and the
// generic address of *p in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
template <typename P>
__device__ __forceinline__ P* cluster_map(P* p, int rank) {
  uint64_t a;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(a) : "l"(p), "r"(rank));
  return reinterpret_cast<P*>(a);
}

// CTAs a SM that the registers must allow: 4 for fp32 quantize (64
// registers: the path's 480 CTAs resident at once), else 2
template <typename T, int MODE>
constexpr int min_ctas() {
  return MODE == 1 && sizeof(T) == 4 ? 4 : 2;
}

// mode 0: round trip (y in T); mode 1: quantize (q int8 + scale).
// Grid (CS, channel tiles, G) in clusters of (CS, 1, 1): blockIdx.x is the
// CTA's rank in its cluster.  vec: d is a multiple of the lane's channels
// and x is 16-byte aligned.
template <typename T, int MODE>
__global__ void __launch_bounds__(NT, (min_ctas<T, MODE>()))
smashed_quant_kernel(const T* __restrict__ x, T* __restrict__ y,
                     int8_t* __restrict__ q, float* __restrict__ scale_out,
                     int M, int d, int vec) {
  constexpr int VEC = Pack<T>::size;    // channels per lane
  constexpr int LPR = CT / VEC;      // lanes per row
  constexpr int RPI = NT / LPR;      // rows the CTA covers per step
  // rows a thread keeps in registers (round trip: 16 fp32, 8 bf16) and
  // rows it streams at a time past them
  constexpr int KEEP = MODE == 0 ? KEEP_ROWS / RPI : 0;
  constexpr int U = MODE == 0 ? 4 : 8;
  __shared__ float part[RPI][CT];
  __shared__ float amax_s[CT];       // this CTA's column amax
  __shared__ float scale_s[CT];      // the cluster's column scales
  const int tid = threadIdx.x;
  const int cc = (tid % LPR) * VEC;  // the lane's first channel in the tile
  const int rg = tid / LPR;
  const int c0 = blockIdx.y * CT;
  const int nc = max(0, min(VEC, d - c0 - cc));
  const int per = (M + CS - 1) / CS;
  const int m_lo = blockIdx.x * per;
  const int m_hi = min(M, m_lo + per);
  const size_t base = static_cast<size_t>(blockIdx.z) * M * d + c0 + cc;
  const T* xg = x + base;

  // pass 1: this CTA's column amax.  The thread's first KEEP rows are
  // loaded at once and kept in registers for pass 2; rows past them are
  // streamed U at a time and read again.
  Pack<T> keep[KEEP > 0 ? KEEP : 1];
#pragma unroll
  for (int k = 0; k < KEEP; ++k) {
    const int m = m_lo + rg + k * RPI;
    keep[k] = load_pack(xg + static_cast<size_t>(m < m_hi ? m : m_lo) * d,
                        vec, m < m_hi ? nc : 0);
  }
  float amax[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) amax[e] = 0.f;
#pragma unroll
  for (int k = 0; k < KEEP; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      amax[e] = fmaxf(amax[e], fabsf(repro::to_f(keep[k].v[e])));
  const int m_rest = m_lo + rg + KEEP * RPI;
  for (int m0 = m_rest; m0 < m_hi; m0 += U * RPI) {
    Pack<T> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * RPI;
      v[u] = load_pack(xg + static_cast<size_t>(m < m_hi ? m : m_lo) * d, vec,
                       m < m_hi ? nc : 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        amax[e] = fmaxf(amax[e], fabsf(repro::to_f(v[u].v[e])));
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) part[rg][cc + e] = amax[e];
  __syncthreads();
  if (tid < CT) {
    float a = part[0][tid];
    for (int i = 1; i < RPI; ++i) a = fmaxf(a, part[i][tid]);
    amax_s[tid] = a;
  }
  // the cluster's amax, through every CTA's shared memory
  cluster_arrive();
  cluster_wait();
  if (tid < CT) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < CS; ++r) a = fmaxf(a, *cluster_map(amax_s + tid, r));
    scale_s[tid] = fmaxf(a, EPS) * (1.f / 127.f);
  }
  cluster_arrive();  // done reading the others' amax_s
  __syncthreads();
  if (MODE == 1 && blockIdx.x == 0 && tid < CT && c0 + tid < d)
    scale_out[static_cast<size_t>(blockIdx.z) * d + c0 + tid] = scale_s[tid];

  // pass 2: emit this CTA's rows
  float sc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) sc[e] = scale_s[cc + e];
  auto emit = [&](const Pack<T>& v, int m) {
    if (m >= m_hi || nc == 0) return;
    const size_t i = base + static_cast<size_t>(m) * d;
    if (MODE == 0) {
      // the code as the wire carries it, an integer: -0 becomes +0, as in
      // the plain version's int8
      Pack<T> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = repro::from_f<T>(
            static_cast<float>(
                static_cast<int>(quant(repro::to_f(v.v[e]), sc[e]))) *
            sc[e]);
      if (vec) {
        *reinterpret_cast<Pack<T>*>(y + i) = o;
      } else {
        for (int e = 0; e < nc; ++e) y[i + e] = o.v[e];
      }
    } else {
      Vec<int8_t, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = static_cast<int8_t>(quant(repro::to_f(v.v[e]), sc[e]));
      if (vec) {
        *reinterpret_cast<Vec<int8_t, VEC>*>(q + i) = o;
      } else {
        for (int e = 0; e < nc; ++e) q[i + e] = o.v[e];
      }
    }
  };
#pragma unroll
  for (int k = 0; k < KEEP; ++k) emit(keep[k], m_lo + rg + k * RPI);
  for (int m0 = m_rest; m0 < m_hi; m0 += U * RPI) {
    Pack<T> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * RPI;
      v[u] = load_pack(xg + static_cast<size_t>(m < m_hi ? m : m_lo) * d, vec,
                       m < m_hi ? nc : 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) emit(v[u], m0 + u * RPI);
  }
  cluster_wait();  // every CTA has read this one's amax_s
}

// x = q * scale.  Grid (CTAs per message, G); a thread owns DQ channels
// from c of message blockIdx.y and the rows rl, rl + nrl, ..., DU of them
// in flight.  Neighbouring lanes own neighbouring channels, so each load
// and each store of a warp is one contiguous run of whole sectors.  vec:
// d is a multiple of DQ and q, scale and x are aligned to their DQ
// elements.
template <typename T>
__global__ void __launch_bounds__(NT, 4)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               T* __restrict__ x, int M, int d, int vec) {
  const int cgs = (d + DQ - 1) / DQ;
  const int nrl = gridDim.x * NT / cgs;
  const int t = blockIdx.x * NT + threadIdx.x;
  const int rl = t / cgs;
  if (rl >= nrl || rl >= M) return;
  const int c = (t % cgs) * DQ;
  const int nc = min(DQ, d - c);
  const float* sg = scale + static_cast<size_t>(blockIdx.y) * d + c;
  float sc[DQ];
  if (vec) {
    const float4 s4 = *reinterpret_cast<const float4*>(sg);
    sc[0] = s4.x;
    sc[1] = s4.y;
    sc[2] = s4.z;
    sc[3] = s4.w;
  } else {
#pragma unroll
    for (int e = 0; e < DQ; ++e) sc[e] = e < nc ? sg[e] : 0.f;
  }
  const size_t base = static_cast<size_t>(blockIdx.y) * M * d + c;
  for (int m0 = rl; m0 < M; m0 += DU * nrl) {
    if (vec) {
      Vec<int8_t, DQ> b[DU];
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        const int m = m0 + u * nrl;
        if (m < M)
          b[u] = *reinterpret_cast<const Vec<int8_t, DQ>*>(
              q + base + static_cast<size_t>(m) * d);
      }
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        const int m = m0 + u * nrl;
        if (m >= M) break;
        Vec<T, DQ> o;
#pragma unroll
        for (int e = 0; e < DQ; ++e)
          o.v[e] = repro::from_f<T>(static_cast<float>(b[u].v[e]) * sc[e]);
        *reinterpret_cast<Vec<T, DQ>*>(x + base + static_cast<size_t>(m) * d) =
            o;
      }
    } else {
      for (int u = 0; u < DU; ++u) {
        const int m = m0 + u * nrl;
        if (m >= M) break;
        const size_t i = base + static_cast<size_t>(m) * d;
        for (int e = 0; e < nc; ++e)
          x[i + e] = repro::from_f<T>(static_cast<float>(q[i + e]) * sc[e]);
      }
    }
  }
}

inline dim3 quant_grid(int G, int d) { return dim3(CS, (d + CT - 1) / CT, G); }

inline int dequant_ctas_per_message(int G, int M, int d) {
  const long cgs = (d + DQ - 1) / DQ;
  const long need = (static_cast<long>(M) * cgs + NT - 1) / NT;  // a row each
  const long fill = (DQ_CTAS + G - 1) / G;
  const long least = (cgs + NT - 1) / NT;  // every channel group a thread
  long n = need < fill ? need : fill;
  if (n < least) n = least;
  return static_cast<int>(n);
}

template <typename T, int MODE>
cudaError_t launch_quant(const void* x, void* y, void* q, void* scale, int G,
                         int M, int d, cudaStream_t s) {
  const int vec = d % Pack<T>::size == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  (MODE == 1 || reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                  (MODE == 0 || reinterpret_cast<uintptr_t>(q) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = quant_grid(G, d);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a refused cluster launch returns its error here
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, smashed_quant_kernel<T, MODE>, static_cast<const T*>(x),
      static_cast<T*>(y), static_cast<int8_t*>(q), static_cast<float*>(scale),
      M, d, vec);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// CTAs per cluster of the quantize and round-trip kernel, and the CTAs of
// its grid (the dtype does not change them); CTAs of the dequantize grid.
extern "C" int smashed_quant_cluster() { return CS; }
extern "C" int smashed_quant_ctas(int G, int d) {
  const dim3 g = quant_grid(G, d);
  return static_cast<int>(g.x * g.y * g.z);
}
extern "C" int smashed_dequant_ctas(int G, int M, int d) {
  return G * dequant_ctas_per_message(G, M, d);
}

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
  const int vec = d % DQ == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;  // DQ elements each
  const dim3 grid(dequant_ctas_per_message(G, M, d), G);
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == REPRO_DTYPE_F32)
    dequant_kernel<float><<<grid, NT, 0, s>>>(
        qq, sc, static_cast<float*>(x), M, d, vec);
  else if (dtype == REPRO_DTYPE_BF16)
    dequant_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        qq, sc, static_cast<__nv_bfloat16*>(x), M, d, vec);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
