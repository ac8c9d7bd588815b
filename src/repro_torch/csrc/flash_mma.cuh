// What the flash attention kernels (flash_fwd.cu, flash_bwd.cu) share
// beyond the tensor-core building blocks of mma_sync.cuh: the key tile,
// the visibility predicate, and the shared blocks under their names in
// namespace repro::fa.
#pragma once

#include "mma_sync.cuh"

namespace repro {
namespace fa {

using mma::allow_smem;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::load_tile;
using mma::Mma;
using mma::Pad;
using mma::smem_u32;
using mma::zero;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BK = 64;  // keys (fwd, dq) or queries (dkv) per staged tile

__device__ __forceinline__ bool visible(int qpos, int kj, int causal,
                                        int window) {
  return (!causal || qpos >= kj) && (window <= 0 || qpos - kj < window);
}

}  // namespace fa
}  // namespace repro
