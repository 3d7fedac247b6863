// The reduction skeleton that csrc/bn_swish.cu (bn_moments,
// bn_bwd_partials) and csrc/bce_rowsum.cu (bce_rowsum_fwd) share: raw
// 16-byte chunks in registers, a sum over the block, and a sum over a
// thread block cluster in rank order through distributed shared memory.
//
// A reduction whose rows are split over several blocks makes those blocks
// one cluster. Each block sums its part in registers, then over its warps;
// the cluster's first block adds the blocks' sums in rank order. So the
// sums are bit-identical from launch to launch, with no float atomics, no
// scratch in device memory and no second launch.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCluster = 8;   // blocks that share a sum: one cluster

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive elements of type T as loaded: kept raw in registers (a
// half or a quarter of the floats' room in bf16) until used. V * sizeof(T)
// is a whole number of 16-byte words (read through the read-only path,
// ld.global.nc), or V = 1 (one element).
template <typename T, int V>
struct Chunk {
  static constexpr int kWords = V * (int)sizeof(T) / 16;
  static_assert(kWords * 16 == V * (int)sizeof(T), "whole 16-byte words");
  uint4 raw[kWords];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      raw[w] = __ldg(reinterpret_cast<const uint4*>(p) + w);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int w = 0; w < kWords; ++w) raw[w] = make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ float at(int k) const {
    return to_f32(reinterpret_cast<const T*>(raw)[k]);
  }
};
template <typename T>
struct Chunk<T, 1> {
  float v;
  __device__ __forceinline__ void load(const T* p) { v = to_f32(__ldg(p)); }
  __device__ __forceinline__ void zero() { v = 0.0f; }
  __device__ __forceinline__ float at(int) const { return v; }
};

// Sums each of v over the block; the block's first thread holds the
// totals. blockDim.x is a multiple of 32, at most 1024.
template <int kN>
__device__ __forceinline__ void block_sum(float (&v)[kN]) {
  __shared__ float part[kN][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < kN; ++k) part[k][warp] = v[k];
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = lane < n_warps ? part[k][lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < kN; ++k)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
}

// The cluster's barrier in its two halves. A block may write into another
// block's shared memory only once that block has started: every thread
// arrives as its kernel begins and waits just before its first such
// write (in cluster_sum), so the wait is over, as a rule, long before it
// is reached.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The end of a reduction over the blocks of one cluster (grid.y). Thread
// i < width of each block holds its block's kN sums of output i; it writes
// them into the shared memory of the cluster's first block, which adds the
// blocks' sums in rank order. Returns true in the first block's threads
// i < width, whose v then holds output i's totals; every other thread gets
// false. Every thread of the block calls it, once, after cluster_arrive().
template <int kWidth, int kN>
__device__ __forceinline__ bool cluster_sum(float (&v)[kN], int width) {
  namespace cg = cooperative_groups;
  __shared__ float red[kN][kMaxCluster][kWidth];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), ranks = cluster.num_blocks();
  const int i = threadIdx.x;
  cluster_wait();   // the first block is on the card: its memory exists
  if (i < width) {
    float* first = cluster.map_shared_rank(&red[0][0][0], 0);
#pragma unroll
    for (int k = 0; k < kN; ++k)
      first[(k * kMaxCluster + rank) * kWidth + i] = v[k];
  }
  cluster.sync();
  if (rank != 0 || i >= width) return false;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    v[k] = red[k][0][i];
    for (unsigned r = 1; r < ranks; ++r) v[k] += red[k][r][i];
  }
  return true;
}

// Launches kernel on grid; the grid.y blocks that share a sum are one
// cluster. A grid.y of 1 launches without the cluster attribute: every
// block is then a cluster of one, and the launch is a plain one.
// Returns the cudaError_t of the launch.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                   cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = grid.y;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, Params(args)...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// log2 of v where v is a power of 2, else -1.
inline int log2_exact(int v) {
  int l = 0;
  while (l < 30 && (1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

}  // namespace
