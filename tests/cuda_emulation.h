// A CPU emulation of the CUDA features that csrc/critic_grad.cu uses, so
// that g++ can build the kernel's source and the CPU tests can run it
// (tests/test_torch_critic_kernel_emulated.py): every thread of a block is
// an OS thread, blocks run one after another, __syncthreads and __syncwarp
// are barriers, a shuffle goes through a per-warp buffer between two
// barriers, __shared__ arrays are static (one block at a time) and the
// dynamic shared memory is one static buffer. bfloat16 rounds to nearest
// even. It checks the kernel's arithmetic and lane logic, not its speed.
#pragma once
#include <cmath>
#include <cstddef>
#include <cstring>
#include <cstdint>
#include <pthread.h>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct dim3s { int x, y, z; };
static thread_local dim3s threadIdx, blockIdx, gridDim, blockDim;
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct __nv_bfloat16 { unsigned short v; };
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.v << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {(unsigned short)((u >> 16) | 0x40)};
  uint32_t r = u + 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(r >> 16)};
}
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
inline cudaError_t cudaGetLastError() { return 0; }

static float emu_dyn_smem[1 << 16] __attribute__((aligned(16)));
static pthread_barrier_t emu_block_bar, emu_warp_bar[64];
static float emu_xchg[64][32];
inline void __syncthreads() { pthread_barrier_wait(&emu_block_bar); }
inline void __syncwarp() { pthread_barrier_wait(&emu_warp_bar[threadIdx.x >> 5]); }
inline float emu_exchange(float v, int src) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  emu_xchg[w][l] = v;
  __syncwarp();
  float r = emu_xchg[w][src];
  __syncwarp();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) { return emu_exchange(v, (threadIdx.x & 31) ^ o); }
inline float __shfl_sync(unsigned, float v, int src) { return emu_exchange(v, src); }

template <class K, class A>
void emu_launch(K kernel, int grid, int block, int smem, A args) {
  (void)smem;
  pthread_barrier_init(&emu_block_bar, nullptr, block);
  for (int w = 0; w < block / 32; ++w) pthread_barrier_init(&emu_warp_bar[w], nullptr, 32);
  // one OS thread a CUDA thread, walking the blocks in order; a barrier
  // ends each block (threads that returned early wait there too)
  std::vector<std::thread> ts;
  for (int t = 0; t < block; ++t)
    ts.emplace_back([=] {
      threadIdx = {t, 0, 0}; gridDim = {grid, 1, 1}; blockDim = {block, 1, 1};
      for (int b = 0; b < grid; ++b) {
        blockIdx = {b, 0, 0};
        kernel(args);
        pthread_barrier_wait(&emu_block_bar);
      }
    });
  for (auto& th : ts) th.join();
  pthread_barrier_destroy(&emu_block_bar);
  for (int w = 0; w < block / 32; ++w) pthread_barrier_destroy(&emu_warp_bar[w]);
}
template <class T> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) { *n = 0; return 0; }
