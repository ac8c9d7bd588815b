// Shared helpers for the repro_torch kernels: element conversion and the
// dtype codes the Python wrappers pass (kernels/_build.py DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define REPRO_DTYPE_F32 0
#define REPRO_DTYPE_BF16 1

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A CTA's count at a device-wide counter, by one thread after a
// __syncthreads: releases the CTA's earlier writes (the barrier orders
// the other threads' before it) and acquires the writes that earlier
// counts released; returns the old value.  The last CTA to count reads
// the others' results after a second __syncthreads.
__device__ __forceinline__ int count_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace repro
