// Row-summed, numerically stable BCE with logits (forward).
//
// Replaces the TPU kernel mvae_tpu/ops/elbo_pallas.py:_kernel:
//
//   out[r] = sum_k max(x[r,k], 0) - x[r,k] * t[r',k] + log1p(exp(-|x[r,k]|))
//
// with r' = r mod n_target_rows, so the T terms' decoded rows (T*B of them)
// share one copy of the B target rows instead of a repeated one.
//
// What bounds it: bytes. It reads every logit and every target row once
// and writes one f32 per row; the (300, 12288) image rows of the CelebA eval
// step are 15-30 MB against the card's memory rate, and the 18-wide
// attribute rows are a launch. Design: one block per row, threads striding
// over the row with 16-byte loads (a chunk of V elements per load group),
// f32 accumulation in registers, then a warp-shuffle and shared-memory
// reduction. Logits and targets are each f32 or bf16 (template
// instantiations), upcast in registers, so the caller never makes a cast
// copy. expf/log1pf are the precise forms (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float bce(float x, float t) {
  return fmaxf(x, 0.0f) - x * t + log1pf(expf(-fabsf(x)));
}

// V consecutive elements from a 16-byte-aligned address, as f32.
template <typename T, int V>
__device__ __forceinline__ void load_chunk(const T* p, float (&out)[V]) {
  constexpr int kPerLoad = 16 / sizeof(T);
  static_assert(V % kPerLoad == 0, "a chunk is whole 16-byte loads");
#pragma unroll
  for (int i = 0; i < V / kPerLoad; ++i) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPerLoad; ++j) out[i * kPerLoad + j] = to_f32(e[j]);
  }
}

template <typename TX, typename TT, int V>
__global__ void __launch_bounds__(kMaxThreads)
bce_rowsum_kernel(const TX* __restrict__ x, const TT* __restrict__ t,
                  float* __restrict__ out, int n_cols, int n_target_rows,
                  bool vectorized) {
  const int row = blockIdx.x;
  const TX* xr = x + (size_t)row * n_cols;
  const TT* tr = t + (size_t)(row % n_target_rows) * n_cols;

  float acc = 0.0f;
  if (vectorized) {
    const int n_chunks = n_cols / V;
    for (int ch = threadIdx.x; ch < n_chunks; ch += blockDim.x) {
      float xv[V];
      float tv[V];
      load_chunk<TX, V>(xr + (size_t)ch * V, xv);
      load_chunk<TT, V>(tr + (size_t)ch * V, tv);
#pragma unroll
      for (int j = 0; j < V; ++j) acc += bce(xv[j], tv[j]);
    }
  } else {
    for (int k = threadIdx.x; k < n_cols; k += blockDim.x) {
      acc += bce(to_f32(xr[k]), to_f32(tr[k]));
    }
  }

  __shared__ float warp_sums[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) out[row] = acc;
  }
}

template <typename TX, typename TT>
int launch(const void* x, const void* t, float* out, int n_rows, int n_cols,
           int n_target_rows, cudaStream_t stream) {
  // a chunk spans one 16-byte load of the narrower type
  constexpr int V = 16 / (sizeof(TX) < sizeof(TT) ? sizeof(TX) : sizeof(TT));
  const bool vectorized = n_cols % V == 0 &&
                          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(t) % 16 == 0;
  const int work = vectorized ? n_cols / V : n_cols;
  int threads = 32;
  while (threads < kMaxThreads && threads < work) threads *= 2;
  bce_rowsum_kernel<TX, TT, V><<<n_rows, threads, 0, stream>>>(
      (const TX*)x, (const TT*)t, out, n_cols, n_target_rows, vectorized);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n_rows, n_cols) f32 or bf16 (x_bf16 = 1), contiguous; t: (n_target_rows,
// n_cols) f32 or bf16 (t_bf16 = 1), contiguous, n_rows % n_target_rows == 0;
// out: (n_rows,) f32. Returns the cudaError_t of the launch.
extern "C" int mvae_bce_rowsum_fwd(const void* x, int x_bf16, const void* t,
                                   int t_bf16, void* out, int n_rows,
                                   int n_cols, int n_target_rows,
                                   void* stream) {
  if (n_rows < 1 || n_cols < 1 || n_target_rows < 1 ||
      n_rows % n_target_rows != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  if (!x_bf16 && !t_bf16) {
    return launch<float, float>(x, t, o, n_rows, n_cols, n_target_rows, s);
  }
  if (!x_bf16 && t_bf16) {
    return launch<float, __nv_bfloat16>(x, t, o, n_rows, n_cols,
                                        n_target_rows, s);
  }
  if (x_bf16 && !t_bf16) {
    return launch<__nv_bfloat16, float>(x, t, o, n_rows, n_cols,
                                        n_target_rows, s);
  }
  return launch<__nv_bfloat16, __nv_bfloat16>(x, t, o, n_rows, n_cols,
                                              n_target_rows, s);
}
