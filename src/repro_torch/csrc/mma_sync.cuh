// Tensor-core building blocks shared by the flash attention kernels
// (flash_fwd.cu, flash_bwd.cu), the fused LoRA GEMM (lora_fused.cu) and
// the SSD chunked scan (ssd_scan.cu): warp-level mma.sync fragments, the
// 3xTF32 split for fp32, and cp.async tile staging.
//
// Fragment layouts are PTX's for mma.sync ... .row.col (lane = 4 g + t,
// g = lane / 4, t = lane % 4); an accumulator tile is 16 x 8 fp32 and
// lane (g, t) holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
//
//  * fp32 runs m16n8k8 on TF32 operands, three times per product:
//    x = big + small with big = x truncated to TF32 and small = x - big
//    rounded to TF32 (nearest, ties away); acc += small*big, += big*small,
//    += big*big, in that order (CUTLASS's OpMultiplyAddFastF32 scheme).
//    |x - big| < 2^-10 |x|, so the dropped small*small term and the
//    rounding of small stay below ~2^-19 of |x*y|: fp32-class accuracy at
//    tensor-core rate.  Truncating big (instead of rounding it, which
//    would give ~2^-20) saves an integer operation per operand element.
//  * bf16 runs m16n8k16 on the bf16 inputs as they are, with fp32
//    accumulation.
//
// An A operand built from accumulators (P, dS, the SSD's decayed C.B^T)
// avoids any shuffle: for bf16 two 8-column accumulator tiles are exactly
// one k16 A fragment.  For TF32 one accumulator tile is one k8 step if
// the step's k index is permuted: A column t stands for k = 2t and column
// t + 4 for k = 2t + 1.  load_b_kn applies the same permutation to B's
// rows, so the sum over k is unchanged.  A GEMM whose A comes from shared
// memory uses the same order through load_a_pk / load_b_nk_pk: for TF32
// the k pair (2t, 2t+1) of a row is one 8-byte load (half the load
// instructions of load_a); for bf16 they are load_a / load_b_nk.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace mma {

// Row pad (elements) of a staged tile whose fragments are read with
// 4-byte loads (load_a, load_b_nk, load_b_kn): rows of n + PAD elements
// make every fragment load free of bank conflicts and keep rows 16-byte
// aligned.  PadPk: rows read with load_a_pk / load_b_nk_pk (for TF32,
// 8-byte loads, conflict-free per half-warp with a row of 8 mod 32 words).
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };
template <typename T> struct PadPk;
template <> struct PadPk<float> { static constexpr int value = 8; };
template <> struct PadPk<__nv_bfloat16> { static constexpr int value = 8; };

__device__ __forceinline__ void zero(float (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes from global src into shared dst, of which the first `bytes`
// are copied and the rest zero-filled (bytes 0: all zeros; src must still
// be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// rows x HD elements from global (row r at src + r * gstride) into shared
// memory (row stride LD) with 16-byte cp.async; rows >= nvalid are filled
// with zeros (row 0 must exist: it is the source address of those copies).
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t gstride, int rows,
                                          int nvalid, int tid, int nthreads) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = HD / EPC;        // chunks per row
  for (int i = tid; i < rows * CPR; i += nthreads) {
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = r < nvalid;
    cp_async16(dst + r * LD + c * EPC, src + (ok ? r : 0) * gstride + c * EPC,
               ok ? 16 : 0);
  }
}

// rows x cols elements of a ragged matrix (row r at src + r * gstride,
// rows >= nr and columns >= nc read as zeros) into shared memory (row
// stride ld; cols a multiple of 16 bytes).  vec: src and every row start
// are 16-byte aligned, so the tile moves as 16-byte cp.async with the
// src-size form zero-filling the ragged edge; otherwise element by
// element with plain loads and stores (synchronous: visible after the
// next __syncthreads, like a completed cp.async).  src must be a valid
// address even when nr or nc is <= 0.
template <typename T>
__device__ __forceinline__ void load_tile_2d(T* dst, int ld, const T* src,
                                             size_t gstride, int rows,
                                             int cols, int nr, int nc,
                                             bool vec, int tid,
                                             int nthreads) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);
    const int cpr = cols / EPC;
    for (int i = tid; i < rows * cpr; i += nthreads) {
      const int r = i / cpr;
      const int c = (i % cpr) * EPC;
      const int n = (r < nr) ? min(EPC, max(0, nc - c)) : 0;
      cp_async16(dst + r * ld + c,
                 n > 0 ? src + static_cast<size_t>(r) * gstride + c : src,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthreads) {
      const int r = i / cols;
      const int c = i % cols;
      dst[r * ld + c] = (r < nr && c < nc)
                            ? src[static_cast<size_t>(r) * gstride + c]
                            : from_f<T>(0.f);
    }
  }
}

// (host) may tiles of this operand move as 16-byte cp.async?
inline bool aligned16(const void* p, size_t row_bytes) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && row_bytes % 16 == 0;
}

template <typename T> struct Mma;

// fp32: 3xTF32 on mma.sync.m16n8k8
template <> struct Mma<float> {
  static constexpr int K = 8;
  struct A { float x[4]; };
  struct B { float x[2]; };
  struct AP { uint32_t big[4], small[4]; };
  struct BP { uint32_t big[2], small[2]; };

  // 16 x 8 block at p (row stride ld): rows g, g+8; columns t, t+4
  __device__ static __forceinline__ A load_a(const float* p, int ld, int g,
                                             int t) {
    return {{p[g * ld + t], p[(g + 8) * ld + t], p[g * ld + t + 4],
             p[(g + 8) * ld + t + 4]}};
  }
  // B[k][n] = p[n * ld + k] (an (n, k) row-major block, e.g. K for Q K^T)
  __device__ static __forceinline__ B load_b_nk(const float* p, int ld,
                                                int g, int t) {
    return {{p[g * ld + t], p[g * ld + t + 4]}};
  }
  // B[k][n] = p[k * ld + n] (a (k, n) row-major block, e.g. V for P V),
  // rows in a_from_c's permuted k order
  __device__ static __forceinline__ B load_b_kn(const float* p, int ld,
                                                int g, int t) {
    return {{p[2 * t * ld + g], p[(2 * t + 1) * ld + g]}};
  }
  // load_a and load_b_nk in load_b_kn's permuted k order: columns
  // (2t, 2t+1) of a row, one 8-byte load (p 8-byte aligned, ld even)
  __device__ static __forceinline__ A load_a_pk(const float* p, int ld,
                                                int g, int t) {
    const float2 lo = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
    const float2 hi =
        *reinterpret_cast<const float2*>(p + (g + 8) * ld + 2 * t);
    return {{lo.x, hi.x, lo.y, hi.y}};
  }
  __device__ static __forceinline__ B load_b_nk_pk(const float* p, int ld,
                                                   int g, int t) {
    const float2 v = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
    return {{v.x, v.y}};
  }
  // the k step's A from one accumulator tile (k permuted, see above)
  __device__ static __forceinline__ A a_from_c(const float (*c)[4]) {
    return {{c[0][0], c[0][2], c[0][1], c[0][3]}};
  }

  // big: x truncated to tf32 (one integer AND); small: the exact rest
  // x - big rounded to nearest, ties away (cvt.rna.tf32's rounding, as an
  // integer ADD and AND).  Integer operations on the bit pattern issue
  // faster than cvt.rna.tf32.f32; the split is the kernels' busiest work.
  __device__ static __forceinline__ void split(float x, uint32_t& big,
                                               uint32_t& small) {
    big = __float_as_uint(x) & 0xFFFFE000u;
    small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) &
            0xFFFFE000u;
  }
  __device__ static __forceinline__ AP prep_a(const A& a) {
    AP r;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a.x[i], r.big[i], r.small[i]);
    return r;
  }
  __device__ static __forceinline__ BP prep_b(const B& b) {
    BP r;
#pragma unroll
    for (int i = 0; i < 2; ++i) split(b.x[i], r.big[i], r.small[i]);
    return r;
  }
  // The MMA reads a TF32 operand's top 19 bits (it truncates), so a split
  // can hand it x's own bits as big and the unrounded rest x - trunc(x)
  // as small: two operations per element instead of four, with small's
  // truncation below 2^-20 |x|.  (The fused LoRA kernels use it.)
  __device__ static __forceinline__ void split_tr(float x, uint32_t& big,
                                                  uint32_t& small) {
    big = __float_as_uint(x);
    small = __float_as_uint(x - __uint_as_float(big & 0xFFFFE000u));
  }
  __device__ static __forceinline__ AP prep_a_tr(const A& a) {
    AP r;
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tr(a.x[i], r.big[i], r.small[i]);
    return r;
  }
  __device__ static __forceinline__ BP prep_b_tr(const B& b) {
    BP r;
#pragma unroll
    for (int i = 0; i < 2; ++i) split_tr(b.x[i], r.big[i], r.small[i]);
    return r;
  }
  __device__ static __forceinline__ void mma1(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
  }
  __device__ static __forceinline__ void mma(float (&d)[4], const AP& a,
                                             const BP& b) {
    mma1(d, a.small, b.big);
    mma1(d, a.big, b.small);
    mma1(d, a.big, b.big);
  }
};

// bf16: mma.sync.m16n8k16, fp32 accumulation
template <> struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  using T = __nv_bfloat16;
  struct A { uint32_t x[4]; };
  struct B { uint32_t x[2]; };
  using AP = A;
  using BP = B;

  __device__ static __forceinline__ uint32_t pair(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  // 16 x 16 block: rows g, g+8; column pairs (2t, 2t+1), (2t+8, 2t+9)
  __device__ static __forceinline__ A load_a(const T* p, int ld, int g,
                                             int t) {
    return {{pair(p + g * ld + 2 * t), pair(p + (g + 8) * ld + 2 * t),
             pair(p + g * ld + 2 * t + 8), pair(p + (g + 8) * ld + 2 * t + 8)}};
  }
  __device__ static __forceinline__ B load_b_nk(const T* p, int ld, int g,
                                                int t) {
    return {{pair(p + g * ld + 2 * t), pair(p + g * ld + 2 * t + 8)}};
  }
  __device__ static __forceinline__ B load_b_kn(const T* p, int ld, int g,
                                                int t) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    auto two = [&](int k) {
      return static_cast<uint32_t>(u[k * ld + g]) |
             (static_cast<uint32_t>(u[(k + 1) * ld + g]) << 16);
    };
    return {{two(2 * t), two(2 * t + 8)}};
  }
  // bf16 needs no permutation: the k order of load_b_kn is natural
  __device__ static __forceinline__ A load_a_pk(const T* p, int ld, int g,
                                                int t) {
    return load_a(p, ld, g, t);
  }
  __device__ static __forceinline__ B load_b_nk_pk(const T* p, int ld, int g,
                                                   int t) {
    return load_b_nk(p, ld, g, t);
  }
  // two accumulator tiles (16 columns) are one k16 A fragment
  __device__ static __forceinline__ A a_from_c(const float (*c)[4]) {
    return {{pack(c[0][0], c[0][1]), pack(c[0][2], c[0][3]),
             pack(c[1][0], c[1][1]), pack(c[1][2], c[1][3])}};
  }
  __device__ static __forceinline__ AP prep_a(const A& a) { return a; }
  __device__ static __forceinline__ BP prep_b(const B& b) { return b; }
  __device__ static __forceinline__ AP prep_a_tr(const A& a) { return a; }
  __device__ static __forceinline__ BP prep_b_tr(const B& b) { return b; }
  __device__ static __forceinline__ void mma(float (&d)[4], const AP& a,
                                             const BP& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
          "r"(b.x[1]));
  }
};

// dynamic shared memory above 48 KB needs the kernel's opt-in, once
template <typename Kern>
cudaError_t allow_smem(Kern kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace mma
}  // namespace repro
