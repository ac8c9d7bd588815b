// Mamba2 SSD (state-space duality) chunked scan, forward, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// ssd_scan_pallas (body _kernel).
//
// For x (B, S, H, P), dt (B, S, H) fp32, A (H,) fp32, Bm and C (B, S, G, N)
// with G | H (head h reads group h / (H / G)), and chunks of Q steps, per
// (b, h, chunk c) with cum the chunk's inclusive prefix sum of dt * A:
//   y_t = exp(cum_t) C_t . s_c  +  sum_{i <= t} (C_t . B_i) exp(cum_t - cum_i) dt_i x_i
//   s_{c+1} = exp(cum_{Q-1}) s_c + sum_i exp(cum_{Q-1} - cum_i) dt_i x_i (x) B_i
// with s_0 = 0 and the (P, N) state s in fp32.  Arithmetic is fp32 for
// fp32 and bf16 x / Bm / C; y is written in x's dtype.
//
// What bounds it on the H100: at the training path (B = 5, S = 512,
// H = 48, P = 64, N = 128, G = 1, Q = 256) the work is ~6.1 GFLOP (the
// inter-chunk term, the state update and the causal half of M @ x per
// head, C . B per group) against ~66 MB of compulsory traffic:
// operations bound (fp32 outside the tensor cores).
//
// Design (simple and right first; wgmma/TMA come later).  The TPU kernel
// walks the chunks of one (b, h) in order and carries the state in VMEM
// scratch; Hopper CTAs run in parallel, so the carry is split out:
//  (a) ssd_chunk_state: one CTA per (b*h, chunk) takes the chunk's prefix
//      sum of dt * A (a block scan), stores it in a workspace, and sums
//      the chunk's own contribution to the state, a (P, N) outer-product
//      reduction over the chunk's rows, into a second workspace;
//  (b) ssd_state_pass: one thread per (b*h, state element) walks the
//      chunks in order and turns each chunk's contribution into the state
//      that enters it, s_{c+1} = exp(cum_{Q-1}) s_c + upd_c, in place;
//  (c) ssd_chunk_scan: one CTA per (b*h, chunk, 64 rows t) adds the
//      inter-chunk term from the entering state and, tile by tile over
//      the columns i <= t only, the intra-chunk term: the (64, 64) tile of
//      M = (C . B) * decay * dt built in shared memory, then M @ x.
// Shared memory: a chunk of B or C at Q = 256, N = 128 is 128 KB in fp32,
// so (c) stages 64 rows at a time (C tile, B tile or state, x tile and
// the M tile: ~100 KB at N = 128), and (a) 32 rows.  Rows indexed by the
// thread's row group are padded to N + 1 floats, so a warp reading one
// column of them hits 16 banks, not one.
// Overflow: above the diagonal cum_t - cum_i is positive and exp of it
// overflows once a chunk's decay passes ~88; the kernel never forms it:
// the exponent is taken only where i <= t, else M is 0.  Every other
// exponent is of a sum of non-positive steps (A < 0, dt >= 0).
// C . B is computed per head, not once per group: H / G times the work
// of that term (the price of this simple tiling, in PERF.md).
#include "common.cuh"

namespace {

constexpr int NT = 256;     // threads per CTA, a 16 x 16 grid
constexpr int TQ = 64;      // rows t and columns i per tile in (c)
constexpr int TA = 32;      // rows per staged slice in (a)
constexpr int MAX_P = 64;   // head dim: 4 columns per thread
constexpr int NA = 128;     // state columns per pass in (a): 8 per thread

// (a) grid (B*H, chunks): cum of the chunk into cum_ws (B*H, S), the
// chunk's state contribution into states (B*H, chunks, P, N).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                float* __restrict__ cum_ws, float* __restrict__ states,
                int S, int H, int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;                  // Q
  float* tmp = cum + Q;               // Q: scan buffer, then the weights w
  float* dts = tmp + Q;               // Q
  float* xs = dts + Q;                // TA x MAX_P, x_i * w_i
  float* bs = xs + TA * MAX_P;        // TA x NA
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int nc = S / Q;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const float ah = a[h];

  for (int e = tid; e < Q; e += NT) {
    const float d = dt[(row0 + e) * H + h];
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
  for (int e = tid; e < Q; e += NT) {
    cum_ws[static_cast<size_t>(bh) * S + static_cast<size_t>(c) * Q + e] =
        cum[e];
    tmp[e] = expf(total - cum[e]) * dts[e];
  }
  __syncthreads();

  // upd[p, n] = sum_i (w_i x_i[p]) B_i[n]; thread owns p = ty + 16 r,
  // n = n0 + tx + 16 j
  for (int n0 = 0; n0 < N; n0 += NA) {
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    for (int i0 = 0; i0 < Q; i0 += TA) {
      for (int e = tid; e < TA * MAX_P; e += NT) {
        const int ii = e / MAX_P, pp = e % MAX_P;
        const int i = i0 + ii;
        xs[e] = (i < Q && pp < P)
                    ? repro::to_f(x[((row0 + i) * H + h) * P + pp]) * tmp[i]
                    : 0.f;
      }
      for (int e = tid; e < TA * NA; e += NT) {
        const int ii = e / NA, nn = e % NA;
        const int i = i0 + ii, n = n0 + nn;
        bs[e] = (i < Q && n < N)
                    ? repro::to_f(bm[((row0 + i) * G + g) * N + n])
                    : 0.f;
      }
      __syncthreads();
      for (int ii = 0; ii < TA; ++ii) {
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = xs[ii * MAX_P + ty + 16 * r];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[ii * NA + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv[r], bv[j], acc[r][j]);
      }
      __syncthreads();
    }
    float* out = states + (static_cast<size_t>(bh) * nc + c) * P * N;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (p < P && n < N) out[static_cast<size_t>(p) * N + n] = acc[r][j];
      }
    }
  }
}

// (b) grid (B*H, ceil(P*N / NT)): chunk contributions -> entering states.
__global__ void __launch_bounds__(NT)
ssd_state_pass(const float* __restrict__ cum_ws, float* __restrict__ states,
               int S, int P, int N, int Q) {
  const int bh = blockIdx.x;
  const int e = blockIdx.y * NT + threadIdx.x;
  const int nc = S / Q;
  const size_t pn = static_cast<size_t>(P) * N;
  if (e < P * N) {
    float s = 0.f;
    for (int c = 0; c < nc; ++c) {
      const size_t i = (static_cast<size_t>(bh) * nc + c) * pn + e;
      const float upd = states[i];
      states[i] = s;
      const float decay =
          expf(cum_ws[static_cast<size_t>(bh) * S +
                      static_cast<size_t>(c) * Q + Q - 1]);
      s = decay * s + upd;
    }
  }
}

// (c) grid (B*H, chunks, ceil(Q / TQ)): y for 64 rows of one chunk.
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ cum_ws,
               const float* __restrict__ states, T* __restrict__ y, int S,
               int H, int G, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int NP = N + 1;               // padded row of N floats
  float* ct = smem;                   // TQ: cum of the rows t
  float* ci = ct + TQ;                // TQ: cum of the columns i
  float* di = ci + TQ;                // TQ: dt of the columns i
  float* cs = di + TQ;                // TQ x NP: C of the rows t
  float* buf = cs + TQ * NP;          // max(P, TQ) x NP: state, then B tiles
  float* xs = buf + TQ * NP;          // TQ x MAX_P: x of the columns i
  float* ms = xs + TQ * MAX_P;        // TQ x (TQ + 1): the M tile
  const int bh = blockIdx.x, c = blockIdx.y, t0 = blockIdx.z * TQ;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int nc = S / Q;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const float* cum = cum_ws + static_cast<size_t>(bh) * S +
                     static_cast<size_t>(c) * Q;

  for (int e = tid; e < TQ; e += NT) ct[e] = t0 + e < Q ? cum[t0 + e] : 0.f;
  for (int e = tid; e < TQ * N; e += NT) {
    const int r = e / N, n = e % N;
    cs[r * NP + n] = t0 + r < Q
        ? repro::to_f(cm[((row0 + t0 + r) * G + g) * N + n]) : 0.f;
  }
  const float* st = states + (static_cast<size_t>(bh) * nc + c) * P * N;
  for (int e = tid; e < P * N; e += NT) buf[(e / N) * NP + e % N] = st[e];
  __syncthreads();

  // inter-chunk: acc[r][j] = exp(cum_t) C_t . s[p], t = ty + 16 r,
  // p = tx + 16 j
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  {
    int prow[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) prow[j] = min(tx + 16 * j, P - 1) * NP;
    for (int n = 0; n < N; ++n) {
      float cv[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * NP + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) sv[j] = buf[prow[j] + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(cv[r], sv[j], acc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float dec = expf(ct[ty + 16 * r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] *= dec;
    }
  }
  __syncthreads();

  // intra-chunk, column tiles i0 <= t0 (the causal half)
  for (int i0 = 0; i0 <= t0; i0 += TQ) {
    for (int e = tid; e < TQ; e += NT) {
      const bool ok = i0 + e < Q;
      ci[e] = ok ? cum[i0 + e] : 0.f;
      di[e] = ok ? dt[(row0 + i0 + e) * H + h] : 0.f;
    }
    for (int e = tid; e < TQ * N; e += NT) {
      const int r = e / N, n = e % N;
      buf[r * NP + n] = i0 + r < Q
          ? repro::to_f(bm[((row0 + i0 + r) * G + g) * N + n]) : 0.f;
    }
    for (int e = tid; e < TQ * MAX_P; e += NT) {
      const int r = e / MAX_P, pp = e % MAX_P;
      xs[e] = (i0 + r < Q && pp < P)
                  ? repro::to_f(x[((row0 + i0 + r) * H + h) * P + pp])
                  : 0.f;
    }
    __syncthreads();
    // M[t, i] = (C_t . B_i) exp(cum_t - cum_i) dt_i for i <= t, else 0;
    // t = ty + 16 r, i = tx + 16 j
    float m[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[r][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * NP + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = buf[(tx + 16 * j) * NP + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[r][j] = fmaf(cv[r], bv[j], m[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tx + 16 * j;
        // the exponent only where i <= t: never exp of a positive sum
        ms[t * (TQ + 1) + i] =
            i0 + i <= t0 + t ? m[r][j] * expf(ct[t] - ci[i]) * di[i] : 0.f;
      }
    }
    __syncthreads();
    // y[t, p] += sum_i M[t, i] x_i[p]
    for (int i = 0; i < TQ; ++i) {
      float mv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) mv[r] = ms[(ty + 16 * r) * (TQ + 1) + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[i * MAX_P + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(mv[r], xv[j], acc[r][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + ty + 16 * r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (t < Q && p < P)
        y[((row0 + t) * H + h) * P + p] = repro::from_f<T>(acc[r][j]);
    }
  }
}

size_t state_smem(int Q) {
  return sizeof(float) * (3 * static_cast<size_t>(Q) + TA * MAX_P + TA * NA);
}

size_t scan_smem(int N) {
  return sizeof(float) * (3 * TQ + 2 * static_cast<size_t>(TQ) * (N + 1) +
                          TQ * MAX_P + TQ * (TQ + 1));
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, void* y, void* cum_ws,
                   void* states, int B, int S, int H, int G, int P, int N,
                   int Q, cudaStream_t s) {
  const int nc = S / Q;
  const size_t sa = state_smem(Q), sc = scan_smem(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sa));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_chunk_scan<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sc));
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  float* cum = static_cast<float*>(cum_ws);
  float* st = static_cast<float*>(states);
  ssd_chunk_state<T><<<dim3(B * H, nc), NT, sa, s>>>(
      xt, dtf, static_cast<const float*>(a), static_cast<const T*>(bm), cum,
      st, S, H, G, P, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_state_pass<<<dim3(B * H, (P * N + NT - 1) / NT), NT, 0, s>>>(
      cum, st, S, P, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<T><<<dim3(B * H, nc, (Q + TQ - 1) / TQ), NT, sc, s>>>(
      xt, dtf, static_cast<const T*>(bm), static_cast<const T*>(cm), cum, st,
      static_cast<T*>(y), S, H, G, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// x, y: (B, S, H, P) and bm, cm: (B, S, G, N) in the dtype's element type;
// dt: (B, S, H) fp32; a: (H,) fp32; workspaces cum_ws: (B*H, S) fp32 and
// states: (B*H, S/Q, P, N) fp32.  All contiguous; S % Q == 0, G | H,
// P <= 64, N <= 256 (the wrapper checks).
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
    return launch<float>(x, dt, a, bm, cm, y, cum_ws, states, B, S, H, G, P,
                         N, Q, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, cum_ws, states, B, S,
                                 H, G, P, N, Q, s);
  return cudaErrorInvalidValue;
}
