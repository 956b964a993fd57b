// A CPU emulation of the CUDA features the port's kernels use, so that
// tests/test_torch_kernels_emulated.py can compile csrc/*.cu with g++ and
// run them: one fiber (ucontext) per CUDA thread, scheduled round-robin;
// __syncthreads, __syncwarp and the warp shuffles are cooperative
// barriers; blocks run one after the other; shared memory is one static
// buffer; cp.async copies at once. It models what the kernels compute,
// not how fast: no timing, no memory model beyond program order.
#pragma once
#include <ucontext.h>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <functional>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __constant__
#define __align__(n) alignas(n)
#define __shared__ static

struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };

inline dim3 threadIdx, blockIdx, blockDim, gridDim;
alignas(16) inline uint8_t emu_smem[256 * 1024];

struct EmuFiber { ucontext_t ctx; std::vector<char> stack; bool done = false; };
inline ucontext_t emu_main;
inline std::vector<EmuFiber>* emu_fibers = nullptr;
inline int emu_cur = 0;
inline std::function<void()> emu_body;

inline void emu_yield() { swapcontext(&(*emu_fibers)[emu_cur].ctx, &emu_main); }

struct EmuBar { int count = 0; unsigned gen = 0; };
inline EmuBar emu_block_bar;
inline EmuBar emu_warp_bar[64];
inline void emu_bar_wait(EmuBar& b, int n) {
  const unsigned g = b.gen;
  if (++b.count == n) { b.count = 0; ++b.gen; return; }
  while (b.gen == g) emu_yield();
}
inline int emu_active_threads = 0;  // threads of the block not yet returned
inline void __syncthreads() { emu_bar_wait(emu_block_bar, emu_active_threads); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  const int w = threadIdx.x / 32;
  int n = blockDim.x - 32 * w; if (n > 32) n = 32;
  emu_bar_wait(emu_warp_bar[w], n);
}

// Named barriers (bar.sync / bar.arrive id, n).
inline EmuBar emu_named[16];
inline void emu_named_sync(int id, int n) { emu_bar_wait(emu_named[id], n); }
inline void emu_named_arrive(int id, int n) {
  EmuBar& b = emu_named[id];
  if (++b.count == n) { b.count = 0; ++b.gen; }
}

inline uint64_t emu_slot[1024];
template <typename T>
inline T emu_shfl_idx(T v, int idx) {
  static_assert(sizeof(T) <= 8, "");
  uint64_t raw = 0; std::memcpy(&raw, &v, sizeof(T));
  emu_slot[threadIdx.x] = raw;
  __syncwarp();
  const uint64_t got = emu_slot[idx];
  __syncwarp();
  T r; std::memcpy(&r, &got, sizeof(T));
  return r;
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int base = threadIdx.x & ~(width - 1);
  return emu_shfl_idx(v, base + (src & (width - 1)));
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  const int base = threadIdx.x & ~(width - 1);
  return emu_shfl_idx(v, base + (((threadIdx.x & (width - 1)) ^ mask) & (width - 1)));
}

inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  uint8_t b[8];
  for (int i = 0; i < 4; ++i) { b[i] = (x >> (8 * i)) & 0xff; b[4 + i] = (y >> (8 * i)) & 0xff; }
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= uint32_t(b[(s >> (4 * i)) & 7]) << (8 * i);
  return r;
}
template <typename T> inline T __ldg(const T* p) { return *p; }

// cuda_pipeline_primitives
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t = 0) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename K> inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }

static void emu_trampoline() {
  emu_body();
  (*emu_fibers)[emu_cur].done = true;
  --emu_active_threads;
  // A returned thread no longer counts at __syncthreads: release a barrier
  // that now has all its remaining threads.
  if (emu_block_bar.count > 0 && emu_block_bar.count == emu_active_threads) {
    emu_block_bar.count = 0; ++emu_block_bar.gen;
  }
  swapcontext(&(*emu_fibers)[emu_cur].ctx, &emu_main);
}

// Run fn() as grid x block threads, one block after the other.
inline void emu_launch(int grid, int block, std::function<void()> fn) {
  gridDim.x = grid; blockDim.x = block;
  std::vector<EmuFiber> fibers(block);
  emu_fibers = &fibers;
  emu_body = fn;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    emu_block_bar = EmuBar{};
    for (auto& w : emu_warp_bar) w = EmuBar{};
    for (auto& w : emu_named) w = EmuBar{};
    emu_active_threads = block;
    for (int t = 0; t < block; ++t) {
      auto& f = fibers[t];
      f.done = false;
      f.stack.assign(256 * 1024, 0);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, emu_trampoline, 0);
    }
    bool left = true;
    while (left) {
      left = false;
      for (int t = 0; t < block; ++t) {
        if (fibers[t].done) continue;
        left = true;
        emu_cur = t;
        threadIdx.x = t;
        swapcontext(&emu_main, &fibers[t].ctx);
      }
    }
  }
}
