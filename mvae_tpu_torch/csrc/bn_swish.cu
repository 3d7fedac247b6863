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
// passes, which the TPU version keeps in jnp for XLA to fuse
// (bn_pallas.py:227-231, 257-268), is done by the two elementwise kernels
// themselves: bn_normalize takes the moments' sums and forms mean, var,
// invstd, a and b; bn_dx takes the backward sums and forms Q, R (P = a) and
// the gradients of scale and bias. A layer is then four launches and no
// eager per-channel op between them.
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
// needs every SM, and loads in flight while it computes.
//
// The reductions. The TPU kernels walk row blocks in order and sum
// per-block partials outside; here blocks run in no order. bn_moments gives
// a whole (g, c) plane to one block, which sums it in registers and then
// through warp shuffles and shared memory: no second pass, no atomics, and
// a summation order that does not change from run to run, at the price of
// G*C blocks (96 at the CelebA decoder's last BN, for 132 SMs).
// bn_bwd_partials splits a plane's rows over blocks: each block sums its
// rows the same way, the blocks of a plane are one thread block cluster,
// and the cluster's first block adds their sums in rank order out of its
// shared memory, so the sums are bit-identical from run to run, without
// float atomics and without a scratch in device memory. It walks its rows
// with running pointers (no division in the loop), reads through the
// read-only path, and where a run of S is shorter than 16 bytes
// (BatchNorm1d: S = 1) it puts threads on consecutive channels and loops
// over rows, so that a warp reads one contiguous line.
//
// The two elementwise passes (bn_normalize, bn_dx) hold nothing across
// elements, so each is one flat stream over the whole tensor, whatever S:
// 16-byte chunks (one element where the tensors' offsets from a 16-byte
// boundary differ), chunk j of a grid-stride loop at thread j mod (blocks *
// threads), so that neighbouring threads read neighbouring chunks at S = 1
// as at S = 1024; a grid of one wave of resident blocks (ops/bn.py:
// normalize_launch, dx_launch); the head before x's first 16-byte boundary
// and the tail after the last whole chunk done by the first threads of the
// grid in the same launch. A chunk's channel comes from its element index
// by three divisions, each a multiply-high and a shift (FastDiv), once a
// chunk where S is a multiple of the chunk, else once an element (S = 1,
// S = 25). Chunks stay raw (uint4) in registers until used and are read
// through the read-only path. A chunk forms its coefficients from the
// (G, C) sums itself, in the shadow of its loads (a shared-memory table of
// every (g, c)'s coefficients a block paid only at S = 25 on an H100, by
// too little to keep). Block 0 also writes the per-(g, c) vectors the
// other passes and the EMA commit take (normalize: mean, var, a, b,
// invstd; dx: the gradients of scale and bias, summed over g in index
// order): no atomics, no state between launches.
//
// x and g are f32 or bf16 (template), upcast in registers; y and dx round
// once, to nearest even, to x's type. z is formed as a rounded product plus
// a rounded sum, as the plain version and the TPU kernel form it; expf and
// the division are the precise forms (no --use_fast_math), but for
// bn_bwd_partials, whose sums take the approximate ones. The per-(g, c)
// algebra rounds every operation as the plain version's PyTorch ops do
// on the card (ops/bn.py: bn_affine, bn_dx_coeffs): a division by n is a
// product with 1 / n, torch.rsqrt is rsqrtf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace {

constexpr int kReduceThreads = 512;
constexpr int kUnroll = 4;              // bn_moments: loads a thread in flight
constexpr int kPartialsThreads = 256;   // bn_bwd_partials, at most
constexpr int kPartialsUnroll = 2;      // ... rows a thread has in flight
constexpr int kMaxCluster = 8;          // ... blocks that share a plane
constexpr int kColumnsWide = 32;        // its columns mapping: channels
constexpr int kColumnsDeep = 8;         // ... by row lanes a block
constexpr int kStreamThreads = 256;     // bn_normalize, bn_dx: a block
constexpr int kStreamBlocksPerSm = 4;   // ... resident an SM (one wave)
constexpr int kStreamUnroll = 2;        // ... chunks of x (and g) in flight
constexpr float kEps = 1e-5f;           // ops/bn.py:EPS

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

// d swish(z) / dz times the upstream gradient g, each operation rounded
// as ops/bn.py:_dz's PyTorch ops round it (no FMA).
__device__ __forceinline__ float dswish(float z, float g) {
  const float s = sigmoid(z);
  return __fmul_rn(
      g, __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(z, __fsub_rn(1.0f, s)))));
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

// ---------------------------------------------------------------------------
// The two elementwise passes as flat streams.

// n / d for 0 <= n < 2^31: __umulhi(n, m) >> s, with m = ceil(2^(31 + l) /
// d), s = l - 1, l = ceil(log2 d) (m = 0 for d = 1). ops/bn.py:fast_div
// computes m and s; stream_ok checks them.
struct FastDiv {
  unsigned m;
  unsigned s;
  __device__ __forceinline__ unsigned operator()(unsigned n) const {
    return m ? __umulhi(n, m) >> s : n;
  }
};

// What ops/bn.py:_stream_launch computed for a (G, N, C, S) view.
struct Stream {
  int vec;      // elements a chunk: 16 / sizeof(T), or 1
  int head;     // elements before the first chunk (x's 16-byte boundary)
  int chunks;   // whole chunks after the head
  int tail;     // elements after the last chunk
  int whole;    // each chunk lies in one channel: S % vec == 0, head == 0
  int blocks;   // of kStreamThreads threads
  FastDiv by_s, by_c, by_group;   // S, C, N * C * S
};

struct Chan {
  int gc;   // g * C + c
  int c;
};

// The (g, c) of element e of the (G, N, C, S) view.
__device__ __forceinline__ Chan channel_of(const Stream& st, unsigned e,
                                           int C) {
  const unsigned run = st.by_s(e);        // (g * N + n) * C + c
  const int c = (int)(run - st.by_c(run) * (unsigned)C);
  return {(int)st.by_group(e) * C + c, c};
}

// V elements of x's type, packed as they are stored.
template <typename T, int V>
struct Packed {
  uint4 raw;
  __device__ __forceinline__ void set(int k, float v) {
    from_f32(v, reinterpret_cast<T*>(&raw) + k);
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <typename T>
struct Packed<T, 1> {
  T v;
  __device__ __forceinline__ void set(int, float f) { from_f32(f, &v); }
  __device__ __forceinline__ void store(T* p) const { *p = v; }
};

// bn_affine (ops/bn.py) of one (g, c) from the moments' sums over n
// elements, each operation rounded as PyTorch rounds it on the card: a
// division by the number n is a product with inv_n = 1 / n (rounded once),
// torch.rsqrt is rsqrtf.
struct Affine {
  float mean, var, invstd, a, b;
};
__device__ __forceinline__ Affine affine_of(float s, float q, float inv_n,
                                            float scale, float bias) {
  Affine f;
  f.mean = __fmul_rn(s, inv_n);
  const float v = __fsub_rn(__fmul_rn(q, inv_n), __fmul_rn(f.mean, f.mean));
  f.var = v < 0.0f ? 0.0f : v;   // torch.clamp(min=0): NaN stays NaN
  f.invstd = rsqrtf(__fadd_rn(f.var, kEps));
  f.a = __fmul_rn(scale, f.invstd);
  f.b = __fsub_rn(bias, __fmul_rn(f.mean, f.a));
  return f;
}

// bn_normalize: y = swish(x * a + b), coefficients (a, b). Block 0 writes
// out = (mean, var, a, b, invstd), each (G, C).
struct NormalizeOp {
  using Coef = float2;
  static constexpr bool kReadsG = false;
  const float* s;
  const float* q;
  const float* scale;
  const float* bias;
  float inv_n;
  float* out;

  __device__ __forceinline__ Coef coef(Chan ch) const {
    const Affine f = affine_of(__ldg(s + ch.gc), __ldg(q + ch.gc), inv_n,
                               __ldg(scale + ch.c), __ldg(bias + ch.c));
    return make_float2(f.a, f.b);
  }
  // The (G, C) vectors of every (g, c), by block 0's threads.
  __device__ __forceinline__ void write_vectors(int G, int C) const {
    const int gcs = G * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const float sc = scale[c];
      const float bi = bias[c];
      for (int g = 0, gc = c; g < G; ++g, gc += C) {
        const Affine f = affine_of(s[gc], q[gc], inv_n, sc, bi);
        out[gc] = f.mean;
        out[gcs + gc] = f.var;
        out[2 * gcs + gc] = f.a;
        out[3 * gcs + gc] = f.b;
        out[4 * gcs + gc] = f.invstd;
      }
    }
  }
  __device__ __forceinline__ float apply(float x, float, Coef k) const {
    const float z = affine(x, k.x, k.y);
    return z * sigmoid(z);
  }
};

// bn_dx: dx = P * dz + Q + R * x, P = a; coefficients (a, b, Q, R), formed
// as bn_dx_coeffs (ops/bn.py) forms them from the backward's sums:
// sdzxh = (sdzx - mean * sdz) * invstd, R = (-(a * sdzxh) / n) * invstd,
// Q = -(a * sdz) / n - R * mean, rounded as affine_of rounds. dx rounds as
// bn_dx_plain's PyTorch ops: (P * dz + Q) + R * x, no FMA. Block 0 writes
// dscale = sum over g of sdzxh and dbias = sum over g of sdz, each (C,):
// the gradients of scale and bias.
struct DxOp {
  using Coef = float4;
  static constexpr bool kReadsG = true;
  const float* sdz;
  const float* sdzx;
  const float* a;
  const float* b;
  const float* mean;
  const float* invstd;
  float inv_n;
  float* dscale;
  float* dbias;

  __device__ __forceinline__ float4 coef_of(int gc, float& sdzxh,
                                            float& dz_sum) const {
    const float av = __ldg(a + gc);
    const float mv = __ldg(mean + gc);
    const float iv = __ldg(invstd + gc);
    dz_sum = __ldg(sdz + gc);
    sdzxh = __fmul_rn(__fsub_rn(__ldg(sdzx + gc), __fmul_rn(mv, dz_sum)), iv);
    const float r = __fmul_rn(__fmul_rn(-__fmul_rn(av, sdzxh), inv_n), iv);
    const float q = __fsub_rn(__fmul_rn(-__fmul_rn(av, dz_sum), inv_n),
                              __fmul_rn(r, mv));
    return make_float4(av, __ldg(b + gc), q, r);
  }
  __device__ __forceinline__ Coef coef(Chan ch) const {
    float sdzxh, dz_sum;
    return coef_of(ch.gc, sdzxh, dz_sum);
  }
  // dscale and dbias, by block 0's threads.
  __device__ __forceinline__ void write_vectors(int G, int C) const {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float ds = 0.0f;
      float db = 0.0f;
      for (int g = 0, gc = c; g < G; ++g, gc += C) {
        float sdzxh, dz_sum;
        coef_of(gc, sdzxh, dz_sum);
        ds += sdzxh;   // in g order, as (G, C).sum(0)
        db += dz_sum;
      }
      dscale[c] = ds;
      dbias[c] = db;
    }
  }
  __device__ __forceinline__ float apply(float x, float g, Coef k) const {
    const float dz = dswish(affine(x, k.x, k.y), g);
    return __fadd_rn(__fadd_rn(__fmul_rn(k.x, dz), k.z), __fmul_rn(k.w, x));
  }
};

// One pass over the stream. Thread t of the grid takes chunks t, t +
// stride, t + 2 * stride, ... (stride = blocks * threads), kStreamUnroll of
// them loaded at once into registers; its first loads go out before block
// 0 writes the (G, C) vectors. kWhole: a chunk's V elements share one
// channel.
template <typename Op, typename T, int V, bool kWhole>
__device__ __forceinline__ void stream(const Op& op, const T* __restrict__ x,
                                       const T* __restrict__ g,
                                       T* __restrict__ out, int G, int C,
                                       const Stream& st) {
  using Coef = typename Op::Coef;
  const int stride = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const T* xs = x + st.head;
  const T* gs = Op::kReadsG ? g + st.head : nullptr;
  T* os = out + st.head;
  // chunk j, its V elements of x (and g) at hand
  auto process = [&](int j, const Chunk<T, V>& xc, const Chunk<T, V>& gk) {
    const unsigned e = (unsigned)(st.head + j * V);
    const Coef first = op.coef(channel_of(st, e, C));
    Packed<T, V> o;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const Coef kc =
          (kWhole || i == 0) ? first : op.coef(channel_of(st, e + i, C));
      const float gv = Op::kReadsG ? gk.at(i) : 0.0f;
      o.set(i, op.apply(xc.at(i), gv, kc));
    }
    o.store(os + (size_t)j * V);
  };
  Chunk<T, V> xc[kStreamUnroll], gk[kStreamUnroll];
  auto load = [&](int k) {
#pragma unroll
    for (int u = 0; u < kStreamUnroll; ++u) {
      const int j = k + u * stride;
      if (j < st.chunks) {
        xc[u].load(xs + (size_t)j * V);
        if constexpr (Op::kReadsG) gk[u].load(gs + (size_t)j * V);
      }
    }
  };
  load(t);
  if (blockIdx.x == 0) op.write_vectors(G, C);
  // the head and the tail, one element a thread
  if (t < st.head + st.tail) {
    const int e = t < st.head ? t : st.head + st.chunks * V + (t - st.head);
    Chunk<T, 1> xe, ge;
    xe.load(x + e);
    if constexpr (Op::kReadsG) ge.load(g + e);
    const float gv = Op::kReadsG ? ge.v : 0.0f;
    Packed<T, 1> o;
    o.set(0, op.apply(xe.v, gv, op.coef(channel_of(st, (unsigned)e, C))));
    o.store(out + e);
  }
  for (int k = t; k < st.chunks;) {
#pragma unroll
    for (int u = 0; u < kStreamUnroll; ++u) {
      const int j = k + u * stride;
      if (j < st.chunks) process(j, xc[u], gk[u]);
    }
    k += kStreamUnroll * stride;
    load(k);
  }
}

template <typename T, int V, bool kWhole>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksPerSm)
bn_normalize_kernel(const T* __restrict__ x, T* __restrict__ y,
                    NormalizeOp op, int G, int C, Stream st) {
  stream<NormalizeOp, T, V, kWhole>(op, x, nullptr, y, G, C, st);
}

template <typename T, int V, bool kWhole>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksPerSm)
bn_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
             T* __restrict__ dx, DxOp op, int G, int C, Stream st) {
  stream<DxOp, T, V, kWhole>(op, x, g, dx, G, C, st);
}

int threads_for(long long work, int cap) {
  int t = 32;
  while (t < cap && t < work) t *= 2;
  return t;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// d's FastDiv is exact for every dividend below 2^31: m * d - 2^(32 + s)
// lies in [0, 2^(s + 1)], so the error of n * m / 2^(32 + s) against n / d
// stays below 1 / d.
bool exact(FastDiv f, long long d) {
  if (f.m == 0) return d == 1 && f.s == 0;
  if (d < 2 || f.s > 30) return false;
  const unsigned long long p = 1ull << (32 + f.s);
  const unsigned long long md = (unsigned long long)f.m * (unsigned long long)d;
  return md >= p && md - p <= (1ull << (f.s + 1));
}

// What the wrapper computed covers the tensor once, chunk by chunk, with
// every chunk 16-byte aligned in every tensor, and fits the kernel. The
// stream counts elements in int (FastDiv takes dividends below 2^31).
bool stream_ok(const Stream& st, int V, int G, int N, int C, int S,
               size_t itemsize, const void* const* ptrs, int n_ptrs) {
  const long long numel = (long long)G * N * C * S;
  if (numel > 0x7fffffffLL) return false;
  if (st.vec != 1 && st.vec != V) return false;
  const int edge = st.vec == 1 ? 1 : st.vec;   // head, tail below this
  if (st.head < 0 || st.head >= edge || st.tail < 0 || st.tail >= edge ||
      st.chunks < 0 ||
      (long long)st.head + (long long)st.chunks * st.vec + st.tail != numel)
    return false;
  if (st.vec > 1)
    for (int i = 0; i < n_ptrs; ++i)
      if (!aligned16((const char*)ptrs[i] + st.head * itemsize)) return false;
  if (st.whole && (S % st.vec || st.head)) return false;
  if (st.blocks < 1 || st.head + st.tail > kStreamThreads) return false;
  return exact(st.by_s, S) && exact(st.by_c, C) &&
         exact(st.by_group, (long long)N * C * S);
}

// The kernel of this layout: V-element chunks (or one element), in one
// channel or not.
template <template <typename, int, bool> class K, typename T,
          typename... Args>
int launch_stream(const Stream& st, cudaStream_t s, Args... args) {
  constexpr int V = 16 / sizeof(T);
  const dim3 grid((unsigned)st.blocks), block((unsigned)kStreamThreads);
  if (st.vec == 1)
    K<T, 1, true>::launch(grid, block, s, args...);
  else if (st.whole)
    K<T, V, true>::launch(grid, block, s, args...);
  else
    K<T, V, false>::launch(grid, block, s, args...);
  return (int)cudaGetLastError();
}

template <typename T, int V, bool kWhole>
struct NormalizeLaunch {
  static void launch(dim3 grid, dim3 block, cudaStream_t s, const void* x,
                     void* y, NormalizeOp op, int G, int C, Stream st) {
    bn_normalize_kernel<T, V, kWhole><<<grid, block, 0, s>>>(
        (const T*)x, (T*)y, op, G, C, st);
  }
};

template <typename T, int V, bool kWhole>
struct DxLaunch {
  static void launch(dim3 grid, dim3 block, cudaStream_t s, const void* x,
                     const void* g, void* dx, DxOp op, int G, int C,
                     Stream st) {
    bn_dx_kernel<T, V, kWhole><<<grid, block, 0, s>>>(
        (const T*)x, (const T*)g, (T*)dx, op, G, C, st);
  }
};

template <typename T>
int normalize_pass(const void* x, void* y, const NormalizeOp& op, int G,
                   int N, int C, int S, const Stream& st, cudaStream_t s) {
  const void* ptrs[] = {x, y};
  if (!stream_ok(st, 16 / sizeof(T), G, N, C, S, sizeof(T), ptrs, 2))
    return (int)cudaErrorInvalidValue;
  return launch_stream<NormalizeLaunch, T>(st, s, x, y, op, G, C, st);
}

template <typename T>
int dx_pass(const void* x, const void* g, void* out, const DxOp& op, int G,
            int N, int C, int S, const Stream& st, cudaStream_t s) {
  const void* ptrs[] = {x, g, out};
  if (!stream_ok(st, 16 / sizeof(T), G, N, C, S, sizeof(T), ptrs, 3))
    return (int)cudaErrorInvalidValue;
  return launch_stream<DxLaunch, T>(st, s, x, g, out, op, G, C, st);
}

Stream stream_of(const int* geo, const unsigned* div) {
  Stream st;
  st.vec = geo[0];
  st.head = geo[1];
  st.chunks = geo[2];
  st.tail = geo[3];
  st.whole = geo[4];
  st.blocks = geo[5];
  st.by_s = {div[0], div[1]};
  st.by_c = {div[2], div[3]};
  st.by_group = {div[4], div[5]};
  return st;
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

// geo (6 ints) and div (6) are ops/bn.py:normalize_launch's (dx_launch's)
// result: vec, head, chunks, tail, whole, blocks; the multiplier and shift
// of S, C and N * C * S. n: the elements
// each sum was over.
extern "C" int mvae_bn_normalize(const void* x, int bf16, const void* s,
                                 const void* q, const void* scale,
                                 const void* bias, float n, void* y,
                                 void* out, int G, int N, int C, int S,
                                 const int* geo, const unsigned* div,
                                 void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  const Stream st = stream_of(geo, div);
  const NormalizeOp op{(const float*)s, (const float*)q, (const float*)scale,
                       (const float*)bias, 1.0f / n, (float*)out};
  cudaStream_t cs = (cudaStream_t)stream;
  return bf16 ? normalize_pass<__nv_bfloat16>(x, y, op, G, N, C, S, st, cs)
              : normalize_pass<float>(x, y, op, G, N, C, S, st, cs);
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

// dscale, dbias: (C,), the gradients of scale and bias.
extern "C" int mvae_bn_dx(const void* x, const void* g, int bf16,
                          const void* sdz, const void* sdzx, const void* a,
                          const void* b, const void* mean,
                          const void* invstd, float n, void* dx,
                          void* dscale, void* dbias, int G, int N, int C,
                          int S, const int* geo, const unsigned* div,
                          void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  const Stream st = stream_of(geo, div);
  const DxOp op{(const float*)sdz,  (const float*)sdzx, (const float*)a,
                (const float*)b,    (const float*)mean, (const float*)invstd,
                1.0f / n,           (float*)dscale,     (float*)dbias};
  cudaStream_t cs = (cudaStream_t)stream;
  return bf16 ? dx_pass<__nv_bfloat16>(x, g, dx, op, G, N, C, S, st, cs)
              : dx_pass<float>(x, g, dx, op, G, N, C, S, st, cs);
}
