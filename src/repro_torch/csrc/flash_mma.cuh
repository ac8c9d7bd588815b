// Tensor-core building blocks of the flash attention kernels
// (flash_fwd.cu, flash_bwd.cu): warp-level mma.sync fragments, the 3xTF32
// split for fp32, and cp.async tile staging.
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
//    accumulation; P and dS are rounded to bf16 before their products,
//    as FlashAttention-2 does.
//
// An A operand built from accumulators (P, dS) avoids any shuffle: for
// bf16 two 8-column accumulator tiles are exactly one k16 A fragment.  For
// TF32 one accumulator tile is one k8 step if the step's k index is
// permuted: A column t stands for k = 2t and column t + 4 for k = 2t + 1.
// load_b_kn applies the same permutation to B's rows, so the sum over k
// is unchanged.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace fa {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;  // keys (fwd, dq) or queries (dkv) per staged tile

// Row pad (elements) of a staged tile: rows of HD + PAD elements make every
// fragment load below free of bank conflicts and keep rows 16-byte aligned.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };

__device__ __forceinline__ void zero(float (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = 0.f;
}

__device__ __forceinline__ bool visible(int qpos, int kj, int causal,
                                        int window) {
  return (!causal || qpos >= kj) && (window <= 0 || qpos - kj < window);
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
    const T* s = src + (ok ? r : 0) * gstride + c * EPC;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * LD + c * EPC)),
                 "l"(s), "r"(ok ? 16 : 0)
                 : "memory");
  }
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
  // two accumulator tiles (16 columns) are one k16 A fragment
  __device__ static __forceinline__ A a_from_c(const float (*c)[4]) {
    return {{pack(c[0][0], c[0][1]), pack(c[0][2], c[0][3]),
             pack(c[1][0], c[1][1]), pack(c[1][2], c[1][3])}};
  }
  __device__ static __forceinline__ AP prep_a(const A& a) { return a; }
  __device__ static __forceinline__ BP prep_b(const B& b) { return b; }
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

}  // namespace fa
}  // namespace repro
