// Indexed multi-adapter LoRA projection for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul/kernel.py
// lora_matmul_indexed_pallas (body _indexed_kernel).
//
// Computes, for every row i of x (M, K):
//   y[i] = x[i] @ W + scale[id] * (x[i] @ A[id]) @ B[id],   id = ids[i]
// with W (K, N), A pool (P, K, R), B pool (P, R, N), scale (P,) fp32,
// ids (M,) int32 clamped into the pool, y (M, N) in x's dtype; fp32
// accumulation throughout and xa = x @ A[id] kept in fp32, as the TPU
// kernel does.
//
// What bounds it on the H100: at the serving decode tick (M = num_slots
// = 8, K = N = 768, R = 16, fp32) it reads W's 2.36 MB for ~9.4 MFLOP:
// memory bound (0.7 us at 3.35 TB/s).  At prefill (M = bucket, 128) it is
// 151 MFLOP on the same bytes, product-shaped: 3xTF32 on the tensor cores.
//
// Design: one launch per call, one route for every M.
//  * The grid is (N / 64 column tiles, K / 64 slices, M / 16 row tiles):
//    the K split spreads W over the card at M = 8 (12 x 12 = 144 CTAs at
//    K = N = 768).  Each CTA stages its 16 rows of x (rows past M zero)
//    and its 64 x 64 slice of W in shared memory with 16-byte cp.async,
//    neighbouring lanes on neighbouring columns, and multiplies them on
//    the tensor cores (mma.sync: fp32 as 3xTF32 on m16n8k8, bf16 on
//    m16n8k16), each 32-deep (fp32) or 64-deep (bf16) k tile into fresh
//    accumulators: an MMA truncates its fp32 sum.
//  * The same CTA forms its slice's x @ A[id] on the CUDA cores: each row
//    has its own adapter, so a thread takes 4 rank columns of one row
//    over a quarter of the slice (16-byte loads of A's rows, issued
//    beside the copies), and the quarters are added in order.  (Staging
//    the whole pool slice for the tensor cores instead, [A_0 | ... |
//    A_(P-1)] as one more 64-column tile, measured slower on the card:
//    16 KB more per CTA.)
//  * Both partials go to a workspace.  The last CTA of each (row tile,
//    column tile) to count, at a counter that it resets for the next
//    call, adds the slices' partials in slice order, then
//    scale[id] * xa @ B[id], and writes y.
//  * Every choice depends on K, N, R, P and constants alone, never on M:
//    a row's bits do not depend on M or on the other rows of the launch,
//    so the batched engine reproduces the one-request serial reference.
//  * The counters assume one call at a time per counter buffer (one
//    stream); the wrapper keeps them zeroed between calls.
#include "mma_sync.cuh"

namespace {

constexpr int NT = 128;     // threads: 4 warps of 16 output columns
constexpr int BM = 16;      // rows per CTA: one MMA row tile
constexpr int BN = 64;      // output (and pool) columns per tile
constexpr int KSL = 64;     // K per CTA: the K split
constexpr int KQ = 4;       // quarters of the slice in x @ A[id]
constexpr int MAX_R = 64;
constexpr int NB = 12;      // slices whose partials one load batch takes
constexpr int VEC_X = 1, VEC_W = 2, VEC_A = 4, VEC_B = 8;

template <typename T>
struct Tile {
  // fresh accumulators per BK-deep k tile: 128 bytes of a row
  static constexpr int BK = 128 / sizeof(T);
  static constexpr int LDX = KSL + repro::mma::PadPk<T>::value;
  static constexpr int LDW = BN + repro::mma::Pad<T>::value;
};

// floats of the workspace: the y partials (BM x BN) and then the xa
// partials (BM x R) of every (row tile, column tile, K slice)
inline size_t work_floats(int M, int K, int N, int R) {
  const size_t tiles = static_cast<size_t>((M + BM - 1) / BM) *
                       ((N + BN - 1) / BN) * ((K + KSL - 1) / KSL);
  return tiles * BM * (BN + R);
}

// 4 consecutive elements as floats, those from n on zero: one 16-byte
// (fp32) or 8-byte (bf16) load when vec and all 4 are in range
__device__ __forceinline__ void load4(const float* p, bool vec, int n,
                                      float (&v)[4]) {
  if (vec && n >= 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? p[e] : 0.f;
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec,
                                      int n, float (&v)[4]) {
  if (vec && n >= 4) {  // bf16 is the high half of an fp32
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xFFFF0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xFFFF0000u);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? repro::to_f(p[e]) : 0.f;
  }
}

// 4 floats that other CTAs of this launch wrote: through L2, never a
// stale L1 line; zeros when !ok
__device__ __forceinline__ void ldcg4(const float* p, bool ok,
                                      float (&v)[4]) {
  const float4 u = ok ? __ldcg(reinterpret_cast<const float4*>(p))
                      : float4{0.f, 0.f, 0.f, 0.f};
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

template <typename T>
__global__ void __launch_bounds__(NT)
lora_indexed_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ a_pool,
                    const T* __restrict__ b_pool,
                    const float* __restrict__ scale,
                    const int* __restrict__ ids, float* __restrict__ work,
                    int* __restrict__ counters, T* __restrict__ y, int M,
                    int K, int N, int R, int P, int vec) {
  using M_ = repro::mma::Mma<T>;
  using Tl = Tile<T>;
  constexpr int KS = M_::K;
  constexpr int BK = Tl::BK;
  constexpr int LDX = Tl::LDX;
  constexpr int LDW = Tl::LDW;
  constexpr int KLEN = KSL / KQ;
  __shared__ __align__(16) T xs[BM * LDX];
  __shared__ __align__(16) T ws[KSL * LDW];
  __shared__ float xq[KQ * BM * MAX_R];  // x @ A[id] by slice quarter
  __shared__ float xa_s[BM * MAX_R];     // the combine's xa
  __shared__ int id_s[BM];               // the rows' ids, in the pool
  __shared__ int last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int nn = gridDim.x;
  const int nks = gridDim.y;
  const int m0 = blockIdx.z * BM;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * KSL;
  const int rows = min(BM, M - m0);
  const int kv = min(KSL, K - k0);
  const int tile = blockIdx.z * nn + blockIdx.x;
  const int r4n = (R + 3) / 4;

  repro::mma::load_tile_2d<T>(xs, LDX, x + static_cast<size_t>(m0) * K + k0,
                              K, BM, KSL, rows, kv, vec & VEC_X, tid, NT);
  repro::mma::load_tile_2d<T>(ws, LDW, w + static_cast<size_t>(k0) * N + n0,
                              N, KSL, BN, kv, N - n0, vec & VEC_W, tid, NT);
  repro::mma::cp_async_commit();
  if (tid < rows) id_s[tid] = min(max(ids[m0 + tid], 0), P - 1);
  __syncthreads();

  // x @ A[id] over the slice: task (slice quarter, row, 4 rank columns);
  // the first task's A rows are in flight beside the tiles
  const int ntask = KQ * rows * r4n;
  float av[KLEN][4];
  auto load_a = [&](int o) {
    const int r4 = o % r4n;
    const int row = (o / r4n) % rows;
    const int kq = o / (r4n * rows);
    const T* a = a_pool + (static_cast<size_t>(id_s[row]) * K + k0 +
                           kq * KLEN) * R + 4 * r4;
#pragma unroll
    for (int k = 0; k < KLEN; ++k)
      load4(a + static_cast<size_t>(k) * R, vec & VEC_A,
            kq * KLEN + k < kv ? R - 4 * r4 : 0, av[k]);
  };
  if (tid < ntask) load_a(tid);

  repro::mma::cp_async_wait<0>();
  __syncthreads();

  // x @ W over the slice: warp `warp` owns columns [16 warp, 16 warp + 16)
  const size_t slot = static_cast<size_t>(tile) * nks + blockIdx.y;
  float* ypart = work + slot * BM * BN;
  const size_t xa_base =
      static_cast<size_t>(gridDim.z) * nn * nks * BM * BN;
  float* xpart = work + xa_base + slot * BM * R;
  {
    float acc[2][4];
    repro::mma::zero(acc[0]);
    repro::mma::zero(acc[1]);
#pragma unroll
    for (int kt = 0; kt < KSL / BK; ++kt) {
      if (kt * BK >= kv) break;
      float part[2][4];
      repro::mma::zero(part[0]);
      repro::mma::zero(part[1]);
#pragma unroll
      for (int kk = 0; kk < BK / KS; ++kk) {
        const int kb = kt * BK + kk * KS;
        if (kb >= kv) break;
        const typename M_::AP a =
            M_::prep_a_tr(M_::load_a_pk(xs + kb, LDX, g, t));
#pragma unroll
        for (int j = 0; j < 2; ++j)
          M_::mma(part[j], a,
                  M_::prep_b_tr(M_::load_b_kn(
                      ws + kb * LDW + 16 * warp + 8 * j, LDW, g, t)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r < rows) {
          float2 v;
          v.x = acc[j][2 * h];
          v.y = acc[j][2 * h + 1];
          *reinterpret_cast<float2*>(ypart + r * BN + 16 * warp + 8 * j +
                                     2 * t) = v;
        }
      }
  }
  for (int o = tid; o < ntask; o += NT) {
    if (o != tid) load_a(o);
    const int r4 = o % r4n;
    const int row = (o / r4n) % rows;
    const int kq = o / (r4n * rows);
    const T* xr = xs + row * LDX + kq * KLEN;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < KLEN; ++k) {
      const float xv = repro::to_f(xr[k]);
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] = fmaf(xv, av[k][e], sum[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      xq[(kq * BM + row) * MAX_R + 4 * r4 + e] = sum[e];
  }
  __syncthreads();
  // the slice's x @ A[id]: its quarters in order
  for (int o = tid; o < rows * R; o += NT) {
    const int row = o / R;
    const int c = o % R;
    float sx = 0.f;
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) sx += xq[(kq * BM + row) * MAX_R + c];
    xpart[o] = sx;
  }

  // the last of the tile's nks CTAs combines
  __syncthreads();
  if (tid == 0) last = repro::count_acq_rel(counters + tile) == nks - 1;
  __syncthreads();
  if (!last) return;

  // thread: 4 columns of row tid / 16, then of row tid / 16 + 8 (when
  // rows > 8); each row's slice partials in slice order, NB slices (and
  // in the first half xa's) loaded at once
  const float* ybase = work + static_cast<size_t>(tile) * nks * BM * BN;
  const float* xbase =
      work + xa_base + static_cast<size_t>(tile) * nks * BM * R;
  const int c4 = 4 * (tid % 16);
  const int n = n0 + c4;
  const int nh = rows > 8 ? 2 : 1;
  const bool bvec = (vec & VEC_B) != 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h >= nh) break;  // the same in every thread
    const int row = tid / 16 + 8 * h;
    float base[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nks; s0 += NB) {
      float buf[NB][4];
#pragma unroll
      for (int u = 0; u < NB; ++u)
        ldcg4(ybase + (static_cast<size_t>(s0 + u) * BM + min(row, rows - 1)) *
                          BN + c4,
              s0 + u < nks, buf[u]);
      for (int o = tid; h == 0 && o < rows * R; o += NT) {
        float xb[NB];
#pragma unroll
        for (int u = 0; u < NB; ++u)
          xb[u] = s0 + u < nks
                      ? __ldcg(xbase + static_cast<size_t>(s0 + u) * BM * R + o)
                      : 0.f;
        float sx = s0 == 0 ? 0.f : xa_s[(o / R) * MAX_R + o % R];
#pragma unroll
        for (int u = 0; u < NB; ++u)
          if (s0 + u < nks) sx += xb[u];
        xa_s[(o / R) * MAX_R + o % R] = sx;
      }
#pragma unroll
      for (int u = 0; u < NB; ++u)
        if (s0 + u < nks)
#pragma unroll
          for (int e = 0; e < 4; ++e) base[e] += buf[u][e];
    }
    if (h == 0) __syncthreads();  // xa complete
    if (row >= rows) continue;
    // + scale[id] * xa @ B[id], rank rows in order
    const int id = id_s[row];
    const T* bb = b_pool + static_cast<size_t>(id) * R * N + min(n, N - 1);
    const float* xr = xa_s + row * MAX_R;
    float delta[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r0 = 0; r0 < R; r0 += 16) {
      float bv[16][4];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        load4(bb + static_cast<size_t>(min(r0 + u, R - 1)) * N, bvec,
              r0 + u < R ? N - n : 0, bv[u]);
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (r0 + u < R)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            delta[e] = fmaf(xr[r0 + u], bv[u][e], delta[e]);
    }
    const float sc = scale[id];
    T* yr = y + static_cast<size_t>(m0 + row) * N + n;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) yr[e] = repro::from_f<T>(base[e] + sc * delta[e]);
  }
  if (tid == 0) counters[tile] = 0;
}

// the grid: (column tiles, K slices, row tiles)
inline dim3 grid_of(int M, int K, int N) {
  return dim3((N + BN - 1) / BN, (K + KSL - 1) / KSL, (M + BM - 1) / BM);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   const float* scale, const int* ids, float* work,
                   int* counters, void* y, int M, int K, int N, int R, int P,
                   cudaStream_t stream) {
  const size_t es = sizeof(T);
  int vec = 0;
  if (repro::mma::aligned16(x, K * es)) vec |= VEC_X;
  if (repro::mma::aligned16(w, N * es)) vec |= VEC_W;
  // A's and B's rows as 4-element loads: 16 (fp32) or 8 (bf16) bytes
  if (reinterpret_cast<uintptr_t>(a) % (4 * es) == 0 && R % 4 == 0)
    vec |= VEC_A;
  if (reinterpret_cast<uintptr_t>(b) % (4 * es) == 0 && N % 4 == 0)
    vec |= VEC_B;
  lora_indexed_kernel<T><<<grid_of(M, K, N), NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(a), static_cast<const T*>(b), scale, ids, work,
      counters, static_cast<T*>(y), M, K, N, R, P, vec);
  return cudaGetLastError();
}

}  // namespace

// floats of fp32 workspace a call needs (the caller allocates it; its
// contents need not be initialised)
extern "C" long long lora_indexed_work(int M, int K, int N, int R) {
  return static_cast<long long>(work_floats(M, K, N, R));
}

// int32 counters a call needs: one per (row tile, column tile); the caller
// zeroes them once and keeps them, each call leaves them zero
extern "C" int lora_indexed_counters(int M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// CTAs of a call's grid
extern "C" int lora_indexed_ctas(int M, int K, int N) {
  const dim3 g = grid_of(M, K, N);
  return static_cast<int>(g.x * g.y * g.z);
}

extern "C" int lora_indexed(const void* x, const void* w, const void* a_pool,
                            const void* b_pool, const void* scale,
                            const void* ids, void* work, void* counters,
                            void* y, int M, int K, int N, int R, int P,
                            int dtype, void* stream) {
  if (R < 1 || R > MAX_R || P < 1 || K < 1) return cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const int* id = static_cast<const int*>(ids);
  float* wk = static_cast<float*>(work);
  int* ctr = static_cast<int*>(counters);
  if (dtype == REPRO_DTYPE_F32)
    return launch<float>(x, w, a_pool, b_pool, sc, id, wk, ctr, y, M, K, N, R,
                         P, s);
  if (dtype == REPRO_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, a_pool, b_pool, sc, id, wk, ctr, y, M,
                                 K, N, R, P, s);
  return cudaErrorInvalidValue;
}
