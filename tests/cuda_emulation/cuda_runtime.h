// CPU stand-in for the CUDA runtime, enough to run the solve kernel's
// source (ilqr_tpu_torch/csrc/cilqr_kernel.cu) and the repro kernels'
// (ilqr_tpu_torch/csrc/debug_repros.cu) on the host in tests: one
// std::thread per CUDA thread, a std::barrier per warp for __syncwarp, the
// shuffles, the votes and the reductions (every lane of a warp must reach
// each of them, as on the card with a full mask), one block at a time, a
// block's dynamic shared memory filled with NaN bytes. Rounding: each
// product and sum rounds on its own (build with -ffp-contract=off), as the
// kernel's -fmad=false build does on the card. Clocks: clock64() counts
// the calling thread's reads (so lanes that read at the same marks read
// the same values, and a span between two marks counts the marks in it),
// and globaltimer() stands for %globaltimer with the host's monotonic
// nanoseconds.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) alignas(n)
#define __shared__

using std::max;
using std::min;

struct EmuDim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local EmuDim3 threadIdx, blockIdx, blockDim;
inline thread_local unsigned char* emu_smem;  // the block's dynamic shared memory

struct EmuWarp {
  std::barrier<> bar{32};
  unsigned char slot[32][8];

  void arrive_and_wait() { bar.arrive_and_wait(); }
};
inline thread_local EmuWarp* emu_warp;

inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp->arrive_and_wait(); }

template <class T>
T emu_exchange(T v, int src, bool in_range) {
  const int lane = threadIdx.x % 32;
  std::memcpy(emu_warp->slot[lane], &v, sizeof(T));
  emu_warp->arrive_and_wait();
  T r = v;
  if (in_range) std::memcpy(&r, emu_warp->slot[src], sizeof(T));
  emu_warp->arrive_and_wait();
  return r;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return emu_exchange(v, src, true);
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned d) {
  const int src = threadIdx.x % 32 + d;
  return emu_exchange(v, src, src < 32);
}

// every lane's v folded by f in lane order, from init, in every lane (the
// votes and reductions)
template <class T, class F>
T emu_fold(T v, T init, F f) {
  const int lane = threadIdx.x % 32;
  std::memcpy(emu_warp->slot[lane], &v, sizeof(T));
  emu_warp->arrive_and_wait();
  T r = init;
  for (int i = 0; i < 32; ++i) {
    T x;
    std::memcpy(&x, emu_warp->slot[i], sizeof(T));
    r = f(r, x);
  }
  emu_warp->arrive_and_wait();
  return r;
}
inline int __all_sync(unsigned, int p) {
  return emu_fold(p != 0, true, [](bool a, bool b) { return a && b; });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return emu_fold(v, 0u, [](unsigned a, unsigned b) { return a > b ? a : b; });
}

struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) double2 {
  double x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline int __float2int_rn(float a) { return static_cast<int>(std::nearbyint(a)); }
inline int __double2int_rn(double a) { return static_cast<int>(std::nearbyint(a)); }

inline thread_local long long emu_clock = 0;
inline long long clock64() { return ++emu_clock; }
#define CUDA_EMULATION 1
inline unsigned long long globaltimer() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*a).fetch_add(v);
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

// kernel<<<grid, block, bytes, stream>>>(args...), rewritten by the test
// into this call: one block at a time.
template <class F, class... A>
void emu_launch(F kernel, unsigned grid, unsigned block, size_t bytes, cudaStream_t, A... args) {
  for (unsigned bi = 0; bi < grid; ++bi) {
    std::vector<unsigned char> smem(bytes + 16, 0xff);
    std::vector<EmuWarp> warps((block + 31) / 32);
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block; ++t)
      threads.emplace_back([&, t]() {
        threadIdx.x = t;
        blockIdx.x = bi;
        blockDim.x = block;
        emu_smem = smem.data();
        emu_warp = &warps[t / 32];
        kernel(args...);
      });
    for (auto& t : threads) t.join();
  }
}
