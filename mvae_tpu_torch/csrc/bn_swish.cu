// Train-mode BatchNorm + swish in four passes, forward and backward.
//
// Replaces the four TPU kernels of mvae_tpu/ops/bn_pallas.py:
//
//   bn_moments       _k_moments      (:92)   per (g, c): sum x, sum x^2
//   bn_normalize     _k_normalize    (:102)  y = swish(x*a + b), rounded once
//   bn_bwd_partials  _k_bwd_partials (:107)  per (g, c): sum dz, sum dz*x
//   bn_dx            _k_dx           (:120)  dx = P*dz + Q + R*x, rounded once
//
// with z = x*a + b, s = 1 / (1 + exp(-z)) and dz = g * s * (1 + z*(1 - s))
// recomputed in registers, never stored. The per-(g, c) algebra between the
// passes (mean, var, a, b, P, Q, R) is a few (G, C) tensors in PyTorch
// (ops/bn.py), as the TPU version keeps it in jnp.
//
// Layout: x is a contiguous (G, N, C, S) view: G groups (the ELBO terms in
// the decoders, 1 elsewhere), N rows per group, C channels, S = H*W (1 for
// BatchNorm1d). An NCHW conv map and an (N, C) MLP activation are both this
// view without a copy. Statistics are per (g, c) over (N, S): the plane of
// one (g, c) is N runs of S contiguous elements, C*S elements apart.
//
// What bounds it: bytes. Each pass streams its inputs once: moments read x;
// normalize reads x and writes y; bwd_partials read x and g; dx reads x and
// g and writes dx. One exp and a dozen flops per element are far below the
// card's ratio of operations to bytes. Design: the TPU kernels walk row
// blocks in order and sum per-block partials outside. Here blocks run in no
// order, so each reduction pass gives a whole (g, c) plane to one block,
// which sums it in registers and then through warp shuffles and shared
// memory: no second pass, no atomics, and a summation order that does not
// change from run to run. The price is G*C blocks (96 at the CelebA
// decoder's last BN, for 132 SMs). The two elementwise passes also split
// each plane's rows over grid.y, so they fill the card. A thread loads 16
// bytes at a time where a run of S holds whole chunks (S % V == 0), else one
// element, and keeps kUnroll loads in flight. x and g are f32 or bf16
// (template), upcast in registers; y and dx round once, to nearest even, to
// x's type. z is formed as a rounded product plus a rounded sum, as the
// plain version and the TPU kernel form it; expf and the division are the
// precise forms (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kReduceThreads = 512;
constexpr int kElementwiseThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTargetBlocks = 4 * 132;  // elementwise passes: 4 blocks an SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// V consecutive elements as f32: one 16-byte load (V = 16 / sizeof(T)) or
// one scalar load (V = 1).
template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_f32(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(e[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    from_f32(v[0], p);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) from_f32(v[j], e + j);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Rows [n0, n1) of the (g, c) plane, in chunks of V elements.
struct Plane {
  long long base;  // element offset of (g, n0, c, 0)
  long long row;   // C * S: from one row n to the next
  int per_row;     // S / V chunks a row
  int items;       // (n1 - n0) * per_row chunks in all
  int width;       // V

  __device__ __forceinline__ Plane(int g, int c, int n0, int n1, int N, int C,
                                   int S, int V)
      : base(((long long)g * N + n0) * C * S + (long long)c * S),
        row((long long)C * S),
        per_row(S / V),
        items((n1 - n0) * (S / V)),
        width(V) {}

  __device__ __forceinline__ long long offset(int j) const {
    const int n = j / per_row;
    return base + n * row + (long long)(j - n * per_row) * width;
  }
};

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// d swish(z) / dz times the upstream gradient g.
__device__ __forceinline__ float dswish(float z, float g) {
  const float s = sigmoid(z);
  return g * (s * (1.0f + z * (1.0f - s)));
}

// Sums a and b over the block; the block's first thread holds the totals.
// blockDim.x is a multiple of 32, at most 1024.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[32];
  __shared__ float sb[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    a = lane < n_warps ? sa[lane] : 0.0f;
    b = lane < n_warps ? sb[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

// One block per (g, c) = blockIdx.x; sum[gc] = sum x, sumsq[gc] = sum x^2.
template <typename T, int V>
__global__ void __launch_bounds__(kReduceThreads)
bn_moments_kernel(const T* __restrict__ x, float* __restrict__ sum,
                  float* __restrict__ sumsq, int N, int C, int S) {
  const int gc = blockIdx.x;
  const Plane p(gc / C, gc % C, 0, N, N, C, S, V);
  float s = 0.0f;
  float q = 0.0f;
  for (int j0 = threadIdx.x; j0 < p.items; j0 += blockDim.x * kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < p.items) {
        load<T, V>(x + p.offset(j), v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[u][k] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s += v[u][k];
        q = fmaf(v[u][k], v[u][k], q);
      }
    }
  }
  block_sum2(s, q);
  if (threadIdx.x == 0) {
    sum[gc] = s;
    sumsq[gc] = q;
  }
}

// Block (gc, blockIdx.y) takes rows [y * rows, (y + 1) * rows) of plane gc.
template <typename T, int V>
__global__ void __launch_bounds__(kElementwiseThreads)
bn_normalize_kernel(const T* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ b, T* __restrict__ y, int N,
                    int C, int S, int rows) {
  const int gc = blockIdx.x;
  const int n0 = blockIdx.y * rows;
  const int n1 = min(N, n0 + rows);
  if (n0 >= n1) return;
  const Plane p(gc / C, gc % C, n0, n1, N, C, S, V);
  const float av = a[gc];
  const float bv = b[gc];
  for (int j0 = threadIdx.x; j0 < p.items; j0 += blockDim.x * kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < p.items) load<T, V>(x + p.offset(j), v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < p.items) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float z = affine(v[u][k], av, bv);
          v[u][k] = z * sigmoid(z);
        }
        store<T, V>(y + p.offset(j), v[u]);
      }
    }
  }
}

// One block per (g, c): sdz[gc] = sum dz, sdzx[gc] = sum dz * x.
template <typename T, int V>
__global__ void __launch_bounds__(kReduceThreads)
bn_bwd_partials_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ sdz,
                       float* __restrict__ sdzx, int N, int C, int S) {
  const int gc = blockIdx.x;
  const Plane p(gc / C, gc % C, 0, N, N, C, S, V);
  const float av = a[gc];
  const float bv = b[gc];
  float s = 0.0f;
  float q = 0.0f;
  for (int j0 = threadIdx.x; j0 < p.items; j0 += blockDim.x * kUnroll) {
    float xv[kUnroll][V];
    float gv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < p.items) {
        const long long o = p.offset(j);
        load<T, V>(x + o, xv[u]);
        load<T, V>(g + o, gv[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          xv[u][k] = 0.0f;
          gv[u][k] = 0.0f;  // dz = 0 for the padding
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float dz = dswish(affine(xv[u][k], av, bv), gv[u][k]);
        s += dz;
        q = fmaf(dz, xv[u][k], q);
      }
    }
  }
  block_sum2(s, q);
  if (threadIdx.x == 0) {
    sdz[gc] = s;
    sdzx[gc] = q;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kElementwiseThreads)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
             const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ pc, const float* __restrict__ qc,
             const float* __restrict__ rc, T* __restrict__ dx, int N, int C,
             int S, int rows) {
  const int gc = blockIdx.x;
  const int n0 = blockIdx.y * rows;
  const int n1 = min(N, n0 + rows);
  if (n0 >= n1) return;
  const Plane p(gc / C, gc % C, n0, n1, N, C, S, V);
  const float av = a[gc];
  const float bv = b[gc];
  const float pv = pc[gc];
  const float qv = qc[gc];
  const float rv = rc[gc];
  for (int j0 = threadIdx.x; j0 < p.items; j0 += blockDim.x * kUnroll) {
    float xv[kUnroll][V];
    float gv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < p.items) {
        const long long o = p.offset(j);
        load<T, V>(x + o, xv[u]);
        load<T, V>(g + o, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < p.items) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float dz = dswish(affine(xv[u][k], av, bv), gv[u][k]);
          xv[u][k] = pv * dz + qv + rv * xv[u][k];
        }
        store<T, V>(dx + p.offset(j), xv[u]);
      }
    }
  }
}

int threads_for(long long work, int cap) {
  int t = 32;
  while (t < cap && t < work) t *= 2;
  return t;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// (grid, rows per block) of an elementwise pass.
dim3 split_rows(int G, int N, int C, int* rows) {
  const int planes = G * C;
  int splits = (kTargetBlocks + planes - 1) / planes;
  if (splits > N) splits = N;
  if (splits < 1) splits = 1;
  *rows = (N + splits - 1) / splits;
  return dim3((unsigned)planes, (unsigned)((N + *rows - 1) / *rows));
}

// A plane's chunks and the planes are counted in int.
bool bad_shape(int G, int N, int C, int S) {
  return G < 1 || N < 1 || C < 1 || S < 1 ||
         (long long)G * C > 0x7fffffffLL || (long long)N * S > 0x7fffffffLL;
}

template <typename T>
int moments(const void* x, float* sum, float* sumsq, int G, int N, int C,
            int S, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((unsigned)(G * C));
  if (S % V == 0 && aligned16(x)) {
    const int t = threads_for((long long)N * (S / V), kReduceThreads);
    bn_moments_kernel<T, V><<<grid, t, 0, st>>>((const T*)x, sum, sumsq, N,
                                                 C, S);
  } else {
    const int t = threads_for((long long)N * S, kReduceThreads);
    bn_moments_kernel<T, 1><<<grid, t, 0, st>>>((const T*)x, sum, sumsq, N,
                                                 C, S);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int normalize(const void* x, const float* a, const float* b, void* y, int G,
              int N, int C, int S, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  int rows = 0;
  const dim3 grid = split_rows(G, N, C, &rows);
  if (S % V == 0 && aligned16(x) && aligned16(y)) {
    const int t = threads_for((long long)rows * (S / V), kElementwiseThreads);
    bn_normalize_kernel<T, V><<<grid, t, 0, st>>>((const T*)x, a, b, (T*)y, N,
                                                   C, S, rows);
  } else {
    const int t = threads_for((long long)rows * S, kElementwiseThreads);
    bn_normalize_kernel<T, 1><<<grid, t, 0, st>>>((const T*)x, a, b, (T*)y, N,
                                                   C, S, rows);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_partials(const void* x, const void* g, const float* a, const float* b,
                 float* sdz, float* sdzx, int G, int N, int C, int S,
                 cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((unsigned)(G * C));
  if (S % V == 0 && aligned16(x) && aligned16(g)) {
    const int t = threads_for((long long)N * (S / V), kReduceThreads);
    bn_bwd_partials_kernel<T, V><<<grid, t, 0, st>>>(
        (const T*)x, (const T*)g, a, b, sdz, sdzx, N, C, S);
  } else {
    const int t = threads_for((long long)N * S, kReduceThreads);
    bn_bwd_partials_kernel<T, 1><<<grid, t, 0, st>>>(
        (const T*)x, (const T*)g, a, b, sdz, sdzx, N, C, S);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dx(const void* x, const void* g, const float* a, const float* b,
       const float* p, const float* q, const float* r, void* out, int G,
       int N, int C, int S, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  int rows = 0;
  const dim3 grid = split_rows(G, N, C, &rows);
  if (S % V == 0 && aligned16(x) && aligned16(g) && aligned16(out)) {
    const int t = threads_for((long long)rows * (S / V), kElementwiseThreads);
    bn_dx_kernel<T, V><<<grid, t, 0, st>>>((const T*)x, (const T*)g, a, b, p,
                                            q, r, (T*)out, N, C, S, rows);
  } else {
    const int t = threads_for((long long)rows * S, kElementwiseThreads);
    bn_dx_kernel<T, 1><<<grid, t, 0, st>>>((const T*)x, (const T*)g, a, b, p,
                                            q, r, (T*)out, N, C, S, rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes x (and g, y, dx) as contiguous (G, N, C, S)
// tensors of one type, f32 (bf16 = 0) or bf16 (bf16 = 1), and the per-(g, c)
// vectors as contiguous (G, C) f32. It returns the cudaError_t of the launch.

extern "C" int mvae_bn_moments(const void* x, int bf16, void* sum,
                               void* sumsq, int G, int N, int C, int S,
                               void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? moments<__nv_bfloat16>(x, (float*)sum, (float*)sumsq, G, N,
                                       C, S, st)
              : moments<float>(x, (float*)sum, (float*)sumsq, G, N, C, S, st);
}

extern "C" int mvae_bn_normalize(const void* x, int bf16, const void* a,
                                 const void* b, void* y, int G, int N, int C,
                                 int S, void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? normalize<__nv_bfloat16>(x, (const float*)a, (const float*)b,
                                         y, G, N, C, S, st)
              : normalize<float>(x, (const float*)a, (const float*)b, y, G, N,
                                 C, S, st);
}

extern "C" int mvae_bn_bwd_partials(const void* x, const void* g, int bf16,
                                    const void* a, const void* b, void* sdz,
                                    void* sdzx, int G, int N, int C, int S,
                                    void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? bwd_partials<__nv_bfloat16>(x, g, (const float*)a,
                                            (const float*)b, (float*)sdz,
                                            (float*)sdzx, G, N, C, S, st)
              : bwd_partials<float>(x, g, (const float*)a, (const float*)b,
                                    (float*)sdz, (float*)sdzx, G, N, C, S,
                                    st);
}

extern "C" int mvae_bn_dx(const void* x, const void* g, int bf16,
                          const void* a, const void* b, const void* p,
                          const void* q, const void* r, void* out, int G,
                          int N, int C, int S, void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dx<__nv_bfloat16>(x, g, (const float*)a, (const float*)b,
                                  (const float*)p, (const float*)q,
                                  (const float*)r, out, G, N, C, S, st)
              : dx<float>(x, g, (const float*)a, (const float*)b,
                          (const float*)p, (const float*)q, (const float*)r,
                          out, G, N, C, S, st);
}
