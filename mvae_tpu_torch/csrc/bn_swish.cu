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
// card's ratio of operations to bytes, but at a few dozen instructions an
// element their instructions take about as long as their bytes: a pass
// needs every SM, and loads in flight while it computes. Design: the TPU
// kernels walk row blocks in order and sum per-block partials outside.
// Here blocks run in no order. bn_moments gives a whole (g, c) plane to
// one block, which sums it in registers and then through warp shuffles and
// shared memory: no second pass, no atomics, and a summation order that
// does not change from run to run, at the price of G*C blocks (96 at the
// CelebA decoder's last BN, for 132 SMs). The two elementwise passes split
// each plane's rows over grid.y, so they fill the card. bn_bwd_partials
// splits the rows too: each block sums its rows of a plane the same way,
// the blocks of a plane are one thread block cluster, and the cluster's
// first block adds their sums in rank order out of its shared memory, so
// the sums are bit-identical from run to run, without float atomics and
// without a scratch in device memory. It walks its rows
// with running pointers (no division in the loop), reads through the
// read-only path, and where a run of S is shorter than 16 bytes
// (BatchNorm1d: S = 1) it puts threads on consecutive channels and loops
// over rows, so that a warp reads one contiguous line. A thread loads 16
// bytes at a time where a run of S holds whole chunks (S % V == 0), else one
// element, and keeps kUnroll loads in flight (bn_bwd_partials fewer, on more
// threads: its arithmetic is the heaviest). x and g are f32 or bf16
// (template), upcast in registers; y and dx round once, to nearest even, to
// x's type. z is formed as a rounded product plus a rounded sum, as the
// plain version and the TPU kernel form it; expf and the division are the
// precise forms (no --use_fast_math), but for bn_bwd_partials, whose sums
// take the approximate ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace {

constexpr int kReduceThreads = 512;
constexpr int kElementwiseThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTargetBlocks = 4 * 132;  // elementwise passes: 4 blocks an SM
constexpr int kPartialsThreads = 256;   // bn_bwd_partials, at most
constexpr int kPartialsUnroll = 2;      // ... rows a thread has in flight
constexpr int kMaxCluster = 8;          // ... blocks that share a plane
constexpr int kColumnsWide = 32;        // its columns mapping: channels
constexpr int kColumnsDeep = 8;         // ... by row lanes a block

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

// The same with the fast exponential and division (ex2.approx and
// rcp.approx, about 2 ulp each): bn_bwd_partials only sums dz, and its sums
// are held as means to 1e-5; the two elementwise passes keep the precise
// forms.
__device__ __forceinline__ float dswish_fast(float z, float g) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-z));
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

// A 16-byte chunk of V elements, or one element, as loaded: kept raw in
// registers (a quarter of the floats' room) until it is used.
template <typename T, int V>
struct Chunk {
  uint4 raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));   // ld.global.nc
  }
  __device__ __forceinline__ void zero() { raw = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ float at(int k) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[k]);
  }
};
template <typename T>
struct Chunk<T, 1> {
  float v;
  __device__ __forceinline__ void load(const T* p) { v = to_f32(__ldg(p)); }
  __device__ __forceinline__ void zero() { v = 0.0f; }
  __device__ __forceinline__ float at(int) const { return v; }
};

// The cluster's barrier in its two halves. A block may write into another
// block's shared memory only once that block has started: every block
// arrives as its kernel begins and waits just before its first such write,
// so the wait is over, as a rule, long before it is reached.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The end of both bn_bwd_partials kernels. The blocks that share a plane
// (the rows mapping) or a stretch of channels (the columns mapping) are
// one thread block cluster along grid.y. Each block's thread i < width
// holds one pair of sums (s, q); it writes them into the shared memory of
// the cluster's first block, which adds the blocks' pairs in rank order
// and stores pair i at out[i]: no scratch in device memory, no atomics,
// and the same sums from run to run. Every thread of the kernel has called
// cluster_arrive() once, at the kernel's start.
template <int kWidth>
__device__ __forceinline__ void cluster_sum2(float s, float q, int width,
                                             float* sdz, float* sdzx,
                                             const int* out) {
  namespace cg = cooperative_groups;
  __shared__ float red[2][kMaxCluster][kWidth];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), ranks = cluster.num_blocks();
  const int i = threadIdx.x;
  cluster_wait();   // the first block is on the card: its memory exists
  if (i < width) {
    float* first = cluster.map_shared_rank(&red[0][0][0], 0);
    first[rank * kWidth + i] = s;
    first[(kMaxCluster + rank) * kWidth + i] = q;
  }
  cluster.sync();
  if (rank != 0 || i >= width || out[i] < 0) return;
  s = red[0][0][i];
  q = red[1][0][i];
  for (unsigned r = 1; r < ranks; ++r) {
    s += red[0][r][i];
    q += red[1][r][i];
  }
  sdz[out[i]] = s;
  sdzx[out[i]] = q;
}

// The rows mapping. Block (gc, y) sums dz and dz * x over rows [y * rows,
// (y + 1) * rows) of plane gc. Its threads lie tpr = 2^tpr_log2 along a
// row's chunks and blockDim.x / tpr down the rows; each walks its rows with
// a running pointer, kPartialsUnroll rows (twice as many loads) in flight.
// Few loads a thread and many threads: the loads of one warp overlap the
// arithmetic of the others on its SM.
template <typename T, int V>
__global__ void __launch_bounds__(kPartialsThreads)
bn_bwd_partials_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ sdz,
                       float* __restrict__ sdzx, int N, int C, int S,
                       int rows, int tpr_log2) {
  cluster_arrive();
  const int gc = blockIdx.x;
  const int n0 = blockIdx.y * rows;
  const int count = min(N, n0 + rows) - n0;
  const int per_row = S / V;
  const int tpr = 1 << tpr_log2;
  const int chunk0 = threadIdx.x & (tpr - 1);
  const int row0 = threadIdx.x >> tpr_log2;
  const int down = blockDim.x >> tpr_log2;
  const size_t row = (size_t)C * S;
  const size_t step = (size_t)down * row;   // to the thread's next row
  const size_t first =
      ((size_t)(gc / C) * N + n0 + row0) * row + (size_t)(gc % C) * S;
  const T* px = x + first;
  const T* pg = g + first;
  const float av = a[gc];
  const float bv = b[gc];
  float s = 0.0f;
  float q = 0.0f;
  for (int n = row0; n < count; n += down * kPartialsUnroll) {
    for (int c = chunk0; c < per_row; c += tpr) {
      Chunk<T, V> xc[kPartialsUnroll], gk[kPartialsUnroll];
#pragma unroll
      for (int u = 0; u < kPartialsUnroll; ++u) {
        if (n + u * down < count) {
          xc[u].load(px + u * step + c * V);
          gk[u].load(pg + u * step + c * V);
        } else {
          xc[u].zero();
          gk[u].zero();   // dz = 0 past the block's rows
        }
      }
#pragma unroll
      for (int u = 0; u < kPartialsUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xv = xc[u].at(k);
          const float dz = dswish_fast(affine(xv, av, bv), gk[u].at(k));
          s += dz;
          q = fmaf(dz, xv, q);
        }
      }
    }
    px += kPartialsUnroll * step;
    pg += kPartialsUnroll * step;
  }
  block_sum2(s, q);
  __shared__ int out;
  if (threadIdx.x == 0) out = gc;
  cluster_sum2<1>(s, q, 1, sdz, sdzx, &out);
}

// The columns mapping, for runs of S shorter than 16 bytes (S = 1 for
// BatchNorm1d): a plane's elements lie C * S apart, so threads on one plane
// would each touch their own sector. Block (group g's channels 32 * i ..
// 32 * i + 31, y): kColumnsWide threads on consecutive channels, whose S
// runs are one contiguous stretch of a row, by kColumnsDeep row lanes that
// walk rows [y * rows, (y + 1) * rows); the row lanes' sums meet in shared
// memory, in lane order.
template <typename T>
__global__ void __launch_bounds__(kColumnsWide * kColumnsDeep)
bn_bwd_partials_columns_kernel(const T* __restrict__ x,
                               const T* __restrict__ g,
                               const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ sdz,
                               float* __restrict__ sdzx, int N, int C, int S,
                               int rows) {
  cluster_arrive();
  __shared__ float ss[kColumnsDeep][kColumnsWide + 1];
  __shared__ float sq[kColumnsDeep][kColumnsWide + 1];
  __shared__ int out[kColumnsWide];
  const int cx = threadIdx.x % kColumnsWide;
  const int ry = threadIdx.x / kColumnsWide;
  const int across = (C + kColumnsWide - 1) / kColumnsWide;
  const int grp = blockIdx.x / across;
  const int c = (blockIdx.x % across) * kColumnsWide + cx;
  const int n0 = blockIdx.y * rows;
  const int count = min(N, n0 + rows) - n0;
  float s = 0.0f;
  float q = 0.0f;
  if (c < C) {
    const size_t row = (size_t)C * S;
    const size_t step = (size_t)kColumnsDeep * row;
    const size_t first = ((size_t)grp * N + n0 + ry) * row + (size_t)c * S;
    const T* px = x + first;
    const T* pg = g + first;
    const float av = a[grp * C + c];
    const float bv = b[grp * C + c];
    for (int n = ry; n < count; n += kColumnsDeep * kPartialsUnroll) {
      for (int k = 0; k < S; ++k) {
        Chunk<T, 1> xc[kPartialsUnroll], gk[kPartialsUnroll];
#pragma unroll
        for (int u = 0; u < kPartialsUnroll; ++u) {
          if (n + u * kColumnsDeep < count) {
            xc[u].load(px + u * step + k);
            gk[u].load(pg + u * step + k);
          } else {
            xc[u].zero();
            gk[u].zero();
          }
        }
#pragma unroll
        for (int u = 0; u < kPartialsUnroll; ++u) {
          const float dz = dswish_fast(affine(xc[u].v, av, bv), gk[u].v);
          s += dz;
          q = fmaf(dz, xc[u].v, q);
        }
      }
      px += kPartialsUnroll * step;
      pg += kPartialsUnroll * step;
    }
  }
  ss[ry][cx] = s;
  sq[ry][cx] = q;
  if (ry == 0) out[cx] = c < C ? grp * C + c : -1;
  __syncthreads();
  if (ry == 0) {
#pragma unroll
    for (int r = 1; r < kColumnsDeep; ++r) {
      s += ss[r][cx];
      q += sq[r][cx];
    }
  }
  cluster_sum2<kColumnsWide>(s, q, kColumnsWide, sdz, sdzx, out);
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

// The launch the wrapper computed (ops/bn.py:bwd_partials_launch): the
// columns or the rows mapping, the vector width, the rows a block, the
// blocks that share a plane (one cluster), the threads a block and (rows
// mapping) along a row.
struct PartialsLaunch {
  int columns, vec, splits, rows, threads, tpr;
};

int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// grid.y = splits blocks are one cluster.
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
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, Params(args)...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int bwd_partials(const void* x, const void* g, const float* a, const float* b,
                 float* sdz, float* sdzx, int G, int N, int C, int S,
                 const PartialsLaunch& l, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  // every row in exactly one block, no block without rows, one cluster
  if (l.rows < 1 || l.splits < 1 || l.splits > kMaxCluster ||
      (long long)l.splits * l.rows < N ||
      (long long)(l.splits - 1) * l.rows >= N)
    return (int)cudaErrorInvalidValue;
  const T* xt = (const T*)x;
  const T* gt = (const T*)g;
  if (l.columns) {
    if (l.threads != kColumnsWide * kColumnsDeep)
      return (int)cudaErrorInvalidValue;
    const int across = (C + kColumnsWide - 1) / kColumnsWide;
    const dim3 grid((unsigned)(G * across), (unsigned)l.splits);
    return launch_cluster(bn_bwd_partials_columns_kernel<T>, grid, l.threads,
                          st, xt, gt, a, b, sdz, sdzx, N, C, S, l.rows);
  }
  const int tpr_log2 = log2_exact(l.tpr);
  const bool vec_ok = l.vec == 1 || (l.vec == V && S % V == 0 &&
                                     aligned16(x) && aligned16(g));
  if (tpr_log2 < 0 || l.threads % 32 || l.threads < 32 ||
      l.threads > kPartialsThreads || l.tpr > l.threads ||
      l.threads % l.tpr || !vec_ok)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(G * C), (unsigned)l.splits);
  if (l.vec == V)
    return launch_cluster(bn_bwd_partials_kernel<T, V>, grid, l.threads, st,
                          xt, gt, a, b, sdz, sdzx, N, C, S, l.rows, tpr_log2);
  return launch_cluster(bn_bwd_partials_kernel<T, 1>, grid, l.threads, st, xt,
                        gt, a, b, sdz, sdzx, N, C, S, l.rows, tpr_log2);
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

// The six ints after S are ops/bn.py:bwd_partials_launch's result.
extern "C" int mvae_bn_bwd_partials(const void* x, const void* g, int bf16,
                                    const void* a, const void* b, void* sdz,
                                    void* sdzx, int G, int N, int C, int S,
                                    int columns, int vec, int splits,
                                    int rows, int threads, int tpr,
                                    void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const PartialsLaunch l{columns, vec, splits, rows, threads, tpr};
  return bf16 ? bwd_partials<__nv_bfloat16>(x, g, (const float*)a,
                                            (const float*)b, (float*)sdz,
                                            (float*)sdzx, G, N, C, S, l, st)
              : bwd_partials<float>(x, g, (const float*)a, (const float*)b,
                                    (float*)sdz, (float*)sdzx, G, N, C, S, l,
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
