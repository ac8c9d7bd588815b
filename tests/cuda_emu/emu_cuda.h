// CPU emulation of the CUDA features the port's hand-written kernels use,
// for tests/test_torch_*_emulated.py (built by build.py).  Each CUDA
// thread of a block is a fiber (ucontext) on the calling OS thread; a
// fiber runs until it waits at a barrier (__syncthreads, or a warp's
// exchange inside a shuffle or mma.sync), and the block's scheduler then
// resumes the next runnable fiber, so an emulated kernel keeps one core
// busy however many threads its blocks have.  Warp-level collectives go
// through per-warp exchange buffers with PTX's fragment layouts.  The
// test rewrites each inline-asm statement of the kernel sources into the
// emu_* call of the same instruction, each launch into emu_launch, and
// the dynamic shared memory into emu_smem; blocks run one after another.
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
  int state;  // 0 runnable, 1 waiting at a barrier, 2 done
};
struct EmuSched {
  ucontext_t main;
  std::vector<EmuFiber> fibers;
  int cur = 0;
  const std::function<void()>* body = nullptr;
};
inline thread_local EmuSched* emu_sched = nullptr;

// back to the block's scheduler; returns when this fiber is resumed
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
struct EmuBlock {
  std::unique_ptr<EmuBarrier> bar;
  std::vector<std::unique_ptr<EmuWarp>> warps;
};
inline thread_local EmuBlock* emu_block = nullptr;
alignas(16) inline unsigned char emu_smem[256 * 1024];

inline void __syncthreads() { emu_block->bar->arrive_and_wait(); }
// blocks run one after another on one OS thread: a global atomic needs
// no more than the plain operation (atom.add.acq_rel is rewritten into
// it), and an L2-only load is a load
inline int atomicAdd(int* p, int v) { const int old = *p; *p = old + v; return old; }
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

template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F body) {
  constexpr size_t STACK = 256 * 1024;
  if (smem > sizeof(emu_smem)) std::abort();
  const int nt = block.x;
  char* stacks = emu_stacks(nt * STACK);
  const std::function<void()> fn = body;
  EmuSched sched;
  sched.body = &fn;
  sched.fibers.resize(nt);
  EmuSched* outer = emu_sched;
  emu_sched = &sched;
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::memset(emu_smem, 0xCD, smem);  // garbage, as on the card
      EmuBlock blk;
      blk.bar = std::make_unique<EmuBarrier>(nt);
      for (int w = 0; w < (nt + 31) / 32; ++w)
        blk.warps.push_back(std::make_unique<EmuWarp>());
      emu_block = &blk;
      blockIdx = dim3(bx, by, bz);
      for (int t = 0; t < nt; ++t) {
        EmuFiber& f = sched.fibers[t];
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = stacks + t * STACK;
        f.ctx.uc_stack.ss_size = STACK;
        f.ctx.uc_link = &sched.main;
        makecontext(&f.ctx, emu_fiber_main, 0);
        f.state = 0;
      }
      for (int done = 0; done < nt;) {
        bool ran = false;
        done = 0;
        for (int t = 0; t < nt; ++t) {
          EmuFiber& f = sched.fibers[t];
          if (f.state == 2) { ++done; continue; }
          if (f.state != 0) continue;
          ran = true;
          sched.cur = t;
          threadIdx = dim3(t);
          swapcontext(&sched.main, &f.ctx);
        }
        if (!ran && done < nt) std::abort();  // every live fiber waits
      }
    }
  emu_sched = outer;
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
