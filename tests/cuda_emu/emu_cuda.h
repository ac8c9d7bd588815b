// CPU emulation of the CUDA features the port's hand-written kernels use,
// for tests/test_torch_*_emulated.py (built by build.py).  Each CUDA
// thread of a block is a fiber (ucontext) on the calling OS thread; a
// fiber runs until it waits at a barrier (__syncthreads, a warp's
// exchange inside a shuffle or mma.sync, or the cluster barrier), and the
// scheduler then resumes the next runnable fiber, so an emulated kernel
// keeps one core busy however many threads its blocks have.  Warp-level
// collectives go through per-warp exchange buffers with PTX's fragment
// layouts.  The test rewrites each inline-asm statement of the kernel
// sources into the emu_* call of the same instruction, each launch into
// emu_launch, and every shared array into the block's own copy
// (emu_dyn_smem, EMU_SHARED).  Blocks run one after another, except the
// blocks of one thread block cluster (cudaLaunchKernelEx with a cluster
// dimension), which run at once as fibers of one scheduler: the cluster
// barrier is a barrier between them, and mapa maps a shared address into
// another block's copy.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <ucontext.h>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(x)
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, gridDim;
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline cudaError_t cudaGetLastError() { return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline const char* cudaGetErrorString(int) { return "emu"; }

inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }

// ---- fibers, barriers, block and warp state ----
struct EmuFiber {
  ucontext_t ctx;
  int state;   // 0 runnable, 1 waiting at a barrier, 2 done
  int block;   // its block in the cluster
  int cphase;  // the cluster barrier's phase at its last arrival
};
struct EmuSched {
  ucontext_t main;
  std::vector<EmuFiber> fibers;
  int cur = 0;
  const std::function<void()>* body = nullptr;
};
inline thread_local EmuSched* emu_sched = nullptr;

// back to the scheduler; returns when this fiber is resumed
inline void emu_yield() {
  EmuSched& s = *emu_sched;
  swapcontext(&s.fibers[s.cur].ctx, &s.main);
}

struct EmuBarrier {
  int expected;
  int count = 0;
  std::vector<int> waiters;
  explicit EmuBarrier(int n) : expected(n) {}
  void arrive_and_wait() {
    EmuSched& s = *emu_sched;
    if (++count == expected) {  // the last to arrive releases the others
      count = 0;
      for (int w : waiters) s.fibers[w].state = 0;
      waiters.clear();
      return;
    }
    waiters.push_back(s.cur);
    s.fibers[s.cur].state = 1;
    emu_yield();
  }
};
struct EmuWarp {
  EmuBarrier bar{32};
  float f[32][8];
  uint32_t u[32][8];
};
// A block's shared memory: the dynamic buffer and one copy of each static
// __shared__ array (keyed by its declaration), both garbage at first, as
// on the card.
struct EmuShared {
  const void* key;
  std::vector<float4> mem;
};
struct EmuBlock {
  std::unique_ptr<EmuBarrier> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  dim3 idx;
  std::vector<float4> dyn;
  std::vector<EmuShared> statics;
};
inline thread_local EmuBlock* emu_block = nullptr;
// the blocks of the running cluster by rank (one block outside a cluster)
inline thread_local std::vector<EmuBlock>* emu_cluster = nullptr;

inline unsigned char* emu_dyn_smem() {
  return reinterpret_cast<unsigned char*>(emu_block->dyn.data());
}
inline EmuShared& emu_static(EmuBlock& b, const void* key, size_t bytes) {
  for (EmuShared& sh : b.statics)
    if (sh.key == key) return sh;
  b.statics.push_back({key, std::vector<float4>((bytes + 15) / 16)});
  EmuShared& sh = b.statics.back();
  std::memset(static_cast<void*>(sh.mem.data()), 0xCD, sh.mem.size() * 16);
  return sh;
}
template <class U>
U& emu_shared(const void* key) {
  return *reinterpret_cast<U*>(
      emu_static(*emu_block, key, sizeof(U)).mem.data());
}
// a static __shared__ declaration, rewritten: the block's own copy
#define EMU_SHARED(name, ...)           \
  static const char name##_emu_key = 0; \
  auto& name = emu_shared<__VA_ARGS__>(&name##_emu_key)

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
// one OS thread runs every block: a global atomic needs no more than the
// plain operation (atom.add.acq_rel is rewritten into it), and an L2-only
// load is a load
inline int atomicAdd(int* p, int v) { const int old = *p; *p = old + v; return old; }
inline float atomicAdd(float* p, float v) { const float old = *p; *p = old + v; return old; }
inline float __ldcg(const float* p) { return *p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline EmuWarp& emu_warp() { return *emu_block->warps[threadIdx.x / 32]; }
inline int emu_lane() { return threadIdx.x % 32; }

inline float __shfl_xor_sync(unsigned, float x, int m) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  w.f[l][0] = x;
  w.bar.arrive_and_wait();
  const float r = w.f[l ^ m][0];
  w.bar.arrive_and_wait();
  return r;
}

inline void emu_fiber_main() {
  EmuSched& s = *emu_sched;
  (*s.body)();
  s.fibers[s.cur].state = 2;  // uc_link returns to the scheduler
}

// the fibers' stacks, shared by every launch (pages are touched only as
// deep as the kernels go)
inline char* emu_stacks(size_t bytes) {
  static thread_local std::unique_ptr<char[]> area;
  static thread_local size_t size = 0;
  if (size < bytes) {
    area.reset(new char[bytes]);
    size = bytes;
  }
  return area.get();
}

// The cluster barrier (barrier.cluster.arrive / wait): an arrival counts
// towards the current phase, and a wait returns once the phase of the
// fiber's last arrival has completed.
struct EmuClusterBarrier {
  int expected = 0;
  int count = 0;
  int phase = 0;
  std::vector<int> waiters;
};
inline thread_local EmuClusterBarrier* emu_cbar = nullptr;

inline void emu_cluster_arrive() {
  EmuSched& s = *emu_sched;
  EmuClusterBarrier& c = *emu_cbar;
  s.fibers[s.cur].cphase = c.phase;
  if (++c.count == c.expected) {
    c.count = 0;
    ++c.phase;
    for (int w : c.waiters) s.fibers[w].state = 0;
    c.waiters.clear();
  }
}
inline void emu_cluster_wait() {
  EmuSched& s = *emu_sched;
  EmuClusterBarrier& c = *emu_cbar;
  if (s.fibers[s.cur].cphase < 0) std::abort();  // a wait before an arrive
  if (c.phase > s.fibers[s.cur].cphase) return;
  c.waiters.push_back(s.cur);
  s.fibers[s.cur].state = 1;
  emu_yield();
}

// mapa (generic addresses): the same shared byte in block `rank` of the
// cluster
inline void* emu_mapa(const void* p, unsigned rank) {
  EmuBlock& me = *emu_block;
  if (rank >= emu_cluster->size()) std::abort();
  EmuBlock& to = (*emu_cluster)[rank];
  const unsigned char* q = static_cast<const unsigned char*>(p);
  const unsigned char* d =
      reinterpret_cast<const unsigned char*>(me.dyn.data());
  if (q >= d && q < d + me.dyn.size() * 16)
    return reinterpret_cast<unsigned char*>(to.dyn.data()) + (q - d);
  for (EmuShared& sh : me.statics) {
    const unsigned char* b =
        reinterpret_cast<const unsigned char*>(sh.mem.data());
    if (q >= b && q < b + sh.mem.size() * 16)
      return reinterpret_cast<unsigned char*>(
                 emu_static(to, sh.key, sh.mem.size() * 16).mem.data()) +
             (q - b);
  }
  std::abort();  // not a shared address
}

// Runs the grid's clusters of `cluster` blocks along x (1: no cluster) one
// after another; the blocks of a cluster run at once.
template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F body,
                unsigned cluster = 1) {
  constexpr size_t STACK = 256 * 1024;
  if (smem > 232448 || cluster < 1 || grid.x % cluster) std::abort();
  const int nt = block.x;
  const int nf = nt * static_cast<int>(cluster);
  char* stacks = emu_stacks(nf * STACK);
  const std::function<void()> fn = body;
  EmuSched sched;
  sched.body = &fn;
  sched.fibers.resize(nf);
  EmuSched* outer = emu_sched;
  emu_sched = &sched;
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; bx += cluster) {
      std::vector<EmuBlock> blocks(cluster);
      for (unsigned c = 0; c < cluster; ++c) {
        EmuBlock& blk = blocks[c];
        blk.bar = std::make_unique<EmuBarrier>(nt);
        for (int w = 0; w < (nt + 31) / 32; ++w)
          blk.warps.push_back(std::make_unique<EmuWarp>());
        blk.idx = dim3(bx + c, by, bz);
        blk.dyn.resize((smem + 15) / 16);
        std::memset(static_cast<void*>(blk.dyn.data()), 0xCD,
                    blk.dyn.size() * 16);
      }
      EmuClusterBarrier cbar;
      cbar.expected = nf;
      emu_cbar = &cbar;
      emu_cluster = &blocks;
      for (int t = 0; t < nf; ++t) {
        EmuFiber& f = sched.fibers[t];
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = stacks + t * STACK;
        f.ctx.uc_stack.ss_size = STACK;
        f.ctx.uc_link = &sched.main;
        makecontext(&f.ctx, emu_fiber_main, 0);
        f.state = 0;
        f.block = t / nt;
        f.cphase = -1;
      }
      for (int done = 0; done < nf;) {
        bool ran = false;
        done = 0;
        for (int t = 0; t < nf; ++t) {
          EmuFiber& f = sched.fibers[t];
          if (f.state == 2) { ++done; continue; }
          if (f.state != 0) continue;
          ran = true;
          sched.cur = t;
          emu_block = &blocks[f.block];
          blockIdx = blocks[f.block].idx;
          threadIdx = dim3(t % nt);
          swapcontext(&sched.main, &f.ctx);
        }
        if (!ran && done < nf) std::abort();  // every live fiber waits
      }
      emu_cluster = nullptr;
      emu_cbar = nullptr;
    }
  emu_sched = outer;
}

// cudaLaunchKernelEx and its configuration; a cluster dimension (along x
// only) runs the cluster's blocks at once
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(P...), A&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      const auto& c = cfg->attrs[i].val.clusterDim;
      if (c.y != 1 || c.z != 1) std::abort();
      cluster = c.x;
    }
  emu_launch(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cfg->stream,
             [&] { kernel(args...); }, cluster);
  return cudaSuccess;
}

// ---- PTX instructions ----
// cp.async.cg.shared.global [dst], [src], 16, n: n bytes, zeros after
inline void emu_cp_async16(void* dst, const void* src, int n) {
  std::memset(dst, 0, 16);
  std::memcpy(dst, src, n);
}
inline float emu_tf32(uint32_t u) { return __uint_as_float(u & 0xFFFFE000u); }
inline float emu_bf(uint32_t h) { return __uint_as_float(h << 16); }

// D = A B + C on one warp; A 16 x K, B K x 8, with PTX's fragment layouts
// (lane = 4 g + t).  Products exact, sum in double, rounded once.
template <int K, class AF, class BF>
void emu_mma(float (&d)[4], const uint32_t* a, const uint32_t* b, AF aval,
             BF bval) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) { w.u[l][i] = a[i]; w.f[l][i] = d[i]; }
  for (int i = 0; i < 2; ++i) w.u[l][4 + i] = b[i];
  w.bar.arrive_and_wait();
  float A[16][K], B[K][8];
  for (int ln = 0; ln < 32; ++ln) {
    const int g = ln / 4, t = ln % 4;
    aval(A, w.u[ln], g, t);
    bval(B, w.u[ln] + 4, g, t);
  }
  const int g = l / 4, t = l % 4;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    double s = w.f[4 * (r % 8) + c / 2][(r / 8) * 2 + c % 2];
    for (int kk = 0; kk < K; ++kk) s += double(A[r][kk]) * double(B[kk][c]);
    out[e] = float(s);
  }
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = out[e];
}

inline void emu_mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                         const uint32_t (&b)[2]) {
  emu_mma<8>(
      d, a, b,
      [](float (&A)[16][8], const uint32_t* r, int g, int t) {
        A[g][t] = emu_tf32(r[0]);
        A[g + 8][t] = emu_tf32(r[1]);
        A[g][t + 4] = emu_tf32(r[2]);
        A[g + 8][t + 4] = emu_tf32(r[3]);
      },
      [](float (&B)[8][8], const uint32_t* r, int g, int t) {
        B[t][g] = emu_tf32(r[0]);
        B[t + 4][g] = emu_tf32(r[1]);
      });
}

inline void emu_mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                         const uint32_t (&b)[2]) {
  emu_mma<16>(
      d, a, b,
      [](float (&A)[16][16], const uint32_t* r, int g, int t) {
        for (int h = 0; h < 2; ++h) {
          A[g][2 * t + h] = emu_bf((r[0] >> (16 * h)) & 0xFFFF);
          A[g + 8][2 * t + h] = emu_bf((r[1] >> (16 * h)) & 0xFFFF);
          A[g][2 * t + 8 + h] = emu_bf((r[2] >> (16 * h)) & 0xFFFF);
          A[g + 8][2 * t + 8 + h] = emu_bf((r[3] >> (16 * h)) & 0xFFFF);
        }
      },
      [](float (&B)[16][8], const uint32_t* r, int g, int t) {
        for (int h = 0; h < 2; ++h) {
          B[2 * t + h][g] = emu_bf((r[0] >> (16 * h)) & 0xFFFF);
          B[2 * t + 8 + h][g] = emu_bf((r[1] >> (16 * h)) & 0xFFFF);
        }
      });
}
