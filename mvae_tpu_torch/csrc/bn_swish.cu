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
// per-block partials outside; here blocks run in no order. bn_moments and
// bn_bwd_partials are one skeleton (bn_reduce_kernel) that differs only in
// what an element adds to its pair of sums (MomentsOp: x and x^2 of one
// tensor; PartialsOp: dz and dz * x of two). A block sums its rows in
// registers and then through warp shuffles and shared memory. A plane
// whose threads load few chunks each from one block of 512 takes that
// block, in a plain launch; a larger plane's rows are split over up to 8
// blocks of 256 that are one thread block cluster, and the cluster's first
// block adds their sums in rank order out of its shared memory
// (csrc/reduce.cuh). Either way the sums are bit-identical from run to
// run, without float atomics, without a scratch in device memory and
// without a second launch. (On an H100 a cluster launch costs about 1 us
// more than a plain one, which is most of a small layer's time: the
// geometry, ops/bn.py:reduce_launch, splits only where the plane is too
// large for one block.) A thread walks its rows with a running pointer
// (no division in the loop), 2 rows in flight, and reads raw 16-byte
// chunks through the read-only path. Where a run of S is shorter than 16
// bytes (BatchNorm1d: S = 1) a block takes a few consecutive channels of
// a group by many row lanes (the columns mapping), so that a warp reads a
// few whole sectors of each of its rows; the same rule splits its rows.
//
// Channels innermost (the lanes mapping and the lanes streams). A
// channels-last conv map, NHWC in memory, is the view (G, N*H*W, C, 1)
// without a copy (ops/bn.py:bn_swish_train), as an (N, C) activation is:
// S = 1, each row C contiguous elements. Where C holds whole 16-byte
// chunks (cpr = C / V of them a row) and the tensors are aligned, a thread
// keeps one chunk position k of every row it reads, so the same V channels
// throughout: the JAX kernel's "lane j is channel j" (bn_pallas.py:20-24).
// What bounds it is still bytes. At the cells' planes (CelebA's last
// decoder map at B = 4096 is 537 MB) the columns mapping's grid of G *
// ceil(C / 8) blocks by at most one cluster of 8 leaves most SMs idle and
// loads one element at a time; so the lanes reductions load 16-byte chunks
// and spread the groups' rows over clusters of 8 blocks of 512 threads, 2
// rows in flight a thread, as many clusters as an H100 holds at once at 2
// blocks an SM (30: grid (splits, G), ops/bn.py:LANES_CLUSTERS; 33 or 34
// left some a second wave, 25-30% slower). A block's row lanes meet in a fixed tree in shared memory;
// clusters of up to 8 consecutive blocks meet in their first block, out of
// the others' shared memory, in rank order; that block writes the
// cluster's 2C sums into a row of a scratch that the wrapper allocates;
// the group's last cluster to finish, found by an integer counter a group
// (__threadfence, then atomicAdd), adds the group's rows in order (each
// output by a few threads over runs of consecutive rows, whose sums then
// meet in order) and sets the counter back to 0 for the next launch. (A
// row a block, with no cluster, left one block a read of up to 540 kB of
// partial sums at the encoder's last plane.) The sums are bit-identical
// from run to run, with no float atomics and in one launch. Below ops/bn.py:LANES_MIN_ROWS rows the
// columns mapping stays (BatchNorm1d at the paper's B = 100, where its
// exactness note below holds). The streams: the grid's stride in chunks is
// a multiple of cpr, so a thread's chunks all sit at one position k; it
// forms its V channels' coefficients where its chunks enter a group (one
// division a group) and keeps them in registers, with no division per chunk
// or element (the flat stream's S = 1 path forms them per element).
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
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kReduceThreads = 512;     // bn_moments, bn_bwd_partials: a
                                        // block, at most
constexpr int kReduceUnroll = 2;        // ... rows a thread has in flight
constexpr int kColumnsMaxWide = 32;     // ... columns mapping: channels a
                                        // block, at most
constexpr int kStreamThreads = 256;     // bn_normalize, bn_dx: a block
constexpr int kStreamBlocksPerSm = 4;   // ... resident an SM (one wave)
constexpr int kStreamUnroll = 2;        // ... chunks of x (and g) in flight
constexpr int kLanesThreads = 512;      // lanes mapping (reductions): a block
constexpr int kLanesBlocksPerSm = 2;    // ... resident an SM
constexpr int kLanesUnroll = 2;         // ... rows a thread has in flight
constexpr int kLanesDxBlocksPerSm = 2;  // bn_dx's lanes stream: resident an
                                        // SM (4V coefficients in registers)
constexpr float kEps = 1e-5f;           // ops/bn.py:EPS

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

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

// ---------------------------------------------------------------------------
// The two reductions: one skeleton (reduce_rows, reduce_columns) and what an
// element contributes to its pair of sums (the Op). Each Op writes its pair
// per (g, c) into s and q, (G, C) f32.

// bn_moments: (x, x^2), exact f32 adds and FMAs.
struct MomentsOp {
  static constexpr bool kReadsG = false;
  float* s;
  float* q;
  struct Coef {};
  __device__ __forceinline__ Coef coef(int) const { return {}; }
  __device__ __forceinline__ void add(Coef, float x, float, float& s_,
                                      float& q_) const {
    s_ += x;
    q_ = fmaf(x, x, q_);
  }
};

// bn_bwd_partials: (dz, dz * x) with z = x * a + b, dz from the fast forms.
struct PartialsOp {
  static constexpr bool kReadsG = true;
  const float* a;
  const float* b;
  float* s;
  float* q;
  using Coef = float2;
  __device__ __forceinline__ Coef coef(int gc) const {
    return make_float2(a[gc], b[gc]);
  }
  __device__ __forceinline__ void add(Coef k, float x, float g, float& s_,
                                      float& q_) const {
    const float dz = dswish_fast(affine(x, k.x, k.y), g);
    s_ += dz;
    q_ = fmaf(dz, x, q_);
  }
};

// The rows mapping. Block (gc, y) sums rows [y * rows, (y + 1) * rows) of
// plane gc. Its threads lie tpr = 2^tpr_log2 along a row's chunks and
// blockDim.x / tpr down the rows; each walks its rows with a running
// pointer, kReduceUnroll rows (as many loads of each input) in flight. Few loads a thread
// and many threads: the loads of one warp overlap the arithmetic of the
// others on its SM. Past the block's rows x (and g) read as 0, which adds
// 0 to either Op's sums.
template <typename Op, typename T, int V>
__device__ __forceinline__ void reduce_rows(const Op& op,
                                            const T* __restrict__ x,
                                            const T* __restrict__ g, int N,
                                            int C, int S, int rows,
                                            int tpr_log2) {
  constexpr int U = kReduceUnroll;
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
  const T* pg = Op::kReadsG ? g + first : nullptr;
  const typename Op::Coef k = op.coef(gc);
  float v[2] = {0.0f, 0.0f};
  for (int n = row0; n < count; n += down * U) {
    for (int c = chunk0; c < per_row; c += tpr) {
      Chunk<T, V> xc[U], gk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (n + u * down < count) {
          xc[u].load(px + u * step + c * V);
          if constexpr (Op::kReadsG) gk[u].load(pg + u * step + c * V);
        } else {
          xc[u].zero();
          if constexpr (Op::kReadsG) gk[u].zero();   // dz = 0
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e)
          op.add(k, xc[u].at(e), Op::kReadsG ? gk[u].at(e) : 0.0f, v[0],
                 v[1]);
    }
    px += U * step;
    if constexpr (Op::kReadsG) pg += U * step;
  }
  block_sum<2>(v);
  if (cluster_sum<1, 2>(v, 1)) {
    op.s[gc] = v[0];
    op.q[gc] = v[1];
  }
}

// The columns mapping, for runs of S shorter than 16 bytes (S = 1 for
// BatchNorm1d): a plane's elements lie C * S apart, so threads on one plane
// would each touch their own sector. Block (group g's channels wide * i ..
// wide * i + wide - 1, y), wide = 2^wide_log2 <= 32: `wide` threads on
// consecutive channels, whose S runs are one contiguous stretch of a row,
// by blockDim.x / wide row lanes that walk rows [y * rows, (y + 1) * rows),
// kReduceUnroll rows each in flight. The row lanes' sums meet in lane
// order, one after another: where the rows are no more than the lanes, a
// channel's sum is then ((x_0 + x_1) + x_2) + ..., row by row. (With a
// tree of shuffles in its place, the gradient of a Linear bias ahead of
// the BN, exactly 0, read 1.2e-4 of rounding noise against the plain
// version's at 4 rows on an H100, over the card test's bound of 1e-4.)
template <typename Op, typename T>
__device__ __forceinline__ void reduce_columns(const Op& op,
                                               const T* __restrict__ x,
                                               const T* __restrict__ g,
                                               int N, int C, int S, int rows,
                                               int wide_log2) {
  constexpr int U = kReduceUnroll;
  __shared__ float part[2][kReduceThreads];
  const int wide = 1 << wide_log2;
  const int deep = blockDim.x >> wide_log2;
  const int cx = threadIdx.x & (wide - 1);
  const int ry = threadIdx.x >> wide_log2;
  const int across = (C + wide - 1) >> wide_log2;
  const int grp = blockIdx.x / across;
  const int c = (blockIdx.x % across) * wide + cx;
  const int n0 = blockIdx.y * rows;
  const int count = min(N, n0 + rows) - n0;
  float v[2] = {0.0f, 0.0f};
  if (c < C) {
    const size_t row = (size_t)C * S;
    const size_t step = (size_t)deep * row;
    const size_t first = ((size_t)grp * N + n0 + ry) * row + (size_t)c * S;
    const T* px = x + first;
    const T* pg = Op::kReadsG ? g + first : nullptr;
    const typename Op::Coef k = op.coef(grp * C + c);
    for (int n = ry; n < count; n += deep * U) {
      for (int e = 0; e < S; ++e) {
        Chunk<T, 1> xc[U], gk[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (n + u * deep < count) {
            xc[u].load(px + u * step + e);
            if constexpr (Op::kReadsG) gk[u].load(pg + u * step + e);
          } else {
            xc[u].zero();
            if constexpr (Op::kReadsG) gk[u].zero();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          op.add(k, xc[u].v, Op::kReadsG ? gk[u].v : 0.0f, v[0], v[1]);
      }
      px += U * step;
      if constexpr (Op::kReadsG) pg += U * step;
    }
  }
  part[0][threadIdx.x] = v[0];
  part[1][threadIdx.x] = v[1];
  __syncthreads();
  // thread i < wide: row lane 0 of channel i, which adds the other lanes'
  if ((int)threadIdx.x < wide)
    for (int r = 1; r < deep; ++r) {
      v[0] += part[0][r * wide + cx];
      v[1] += part[1][r * wide + cx];
    }
  if (cluster_sum<kColumnsMaxWide, 2>(v, wide) && c < C) {
    op.s[grp * C + c] = v[0];
    op.q[grp * C + c] = v[1];
  }
}

// Both reductions, both mappings: the blocks that share a plane (rows) or a
// stretch of channels (columns) are one thread block cluster along grid.y.
// tpr_log2: log2 of the threads along a row's chunks (rows) or of the
// channels a block (columns).
template <typename Op, typename T, int V, bool kColumns>
__global__ void __launch_bounds__(kReduceThreads)
bn_reduce_kernel(Op op, const T* __restrict__ x, const T* __restrict__ g,
                 int N, int C, int S, int rows, int tpr_log2) {
  cluster_arrive();
  if constexpr (kColumns)
    reduce_columns<Op, T>(op, x, g, N, C, S, rows, tpr_log2);
  else
    reduce_rows<Op, T, V>(op, x, g, N, C, S, rows, tpr_log2);
}

// The lanes mapping's cluster: all of a group's blocks up to kMaxCluster,
// else kMaxCluster (ops/bn.py:reduce_launch makes splits a multiple).
__host__ __device__ __forceinline__ int lanes_cluster(int splits) {
  return splits < kMaxCluster ? splits : kMaxCluster;
}

// The lanes mapping (the note at the head of the file): block (b, grp) of a
// grid (splits, G), thread t on chunk k = t % cpr of rows n0 = b * lanes +
// t / cpr, n0 + splits * lanes, ... of group grp, lanes = blockDim.x / cpr
// (threads past lanes * cpr idle). Past N, x (and g) read as 0. The blocks
// of a cluster (lanes_cluster of them along grid.x) meet in its first
// block; a group of one cluster writes its sums there, else `scratch`
// holds a row of 2C sums a cluster (G * splits / cluster * 2C floats) and
// `counters` one integer a group, 0 at the launch and left 0.
template <typename Op, typename T, int V>
__global__ void __launch_bounds__(kLanesThreads, kLanesBlocksPerSm)
bn_reduce_kernel_lanes(Op op, const T* __restrict__ x,
                       const T* __restrict__ g, int N, int C,
                       float* __restrict__ scratch,
                       unsigned* __restrict__ counters) {
  constexpr int U = kLanesUnroll;
  __shared__ float part[2 * V][kLanesThreads];
  __shared__ bool last;
  const int cpr = C / V;
  const int lanes = blockDim.x / cpr;
  const int t = threadIdx.x;
  const int lane = t / cpr;
  const int k = t - lane * cpr;
  const int grp = blockIdx.y;
  const int splits = gridDim.x;
  float sv[V], qv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sv[e] = qv[e] = 0.0f;
  if (lane < lanes) {
    const int down = splits * lanes;         // rows to the thread's next row
    const size_t step = (size_t)down * C;
    const int n0 = blockIdx.x * lanes + lane;
    const size_t first = ((size_t)grp * N + n0) * C + (size_t)k * V;
    const T* px = x + first;
    const T* pg = Op::kReadsG ? g + first : nullptr;
    typename Op::Coef kc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) kc[e] = op.coef(grp * C + k * V + e);
    for (int n = n0; n < N; n += down * U) {
      Chunk<T, V> xc[U], gk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (n + u * down < N) {
          xc[u].load(px + u * step);
          if constexpr (Op::kReadsG) gk[u].load(pg + u * step);
        } else {
          xc[u].zero();
          if constexpr (Op::kReadsG) gk[u].zero();   // dz = 0
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e)
          op.add(kc[e], xc[u].at(e), Op::kReadsG ? gk[u].at(e) : 0.0f, sv[e],
                 qv[e]);
      px += U * step;
      if constexpr (Op::kReadsG) pg += U * step;
    }
  }
  // the block's row lanes in a fixed tree: lane l adds lane l + half
#pragma unroll
  for (int e = 0; e < V; ++e) {
    part[e][t] = sv[e];
    part[V + e][t] = qv[e];
  }
  __syncthreads();
  for (int live = lanes; live > 1;) {
    const int half = (live + 1) >> 1;
    if (lane < live - half)
#pragma unroll
      for (int w = 0; w < 2 * V; ++w) part[w][t] += part[w][t + half * cpr];
    live = half;
    __syncthreads();
  }
  // The cluster's blocks (consecutive blocks of the group, grid.x) in rank
  // order, by its first block out of the others' shared memory; output
  // o < 2C is the first sum (o < C) or the second of channel o % C.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank(), ranks = cluster.num_blocks();
  const int outs = 2 * C;
  const int clusters = splits / (int)ranks;     // a group's
  cluster.sync();                               // every block's tree is done
  float* rows = scratch + (size_t)grp * clusters * outs;
  if (rank == 0)
    for (int o = t; o < outs; o += blockDim.x) {
      const int c = o % C;
      float* own = &part[(o / C) * V + c % V][c / V];
      float v = *own;
      for (unsigned r = 1; r < ranks; ++r) v += *cluster.map_shared_rank(own, r);
      if (clusters == 1)
        (o < C ? op.s : op.q)[grp * C + c] = v;
      else
        rows[(size_t)(blockIdx.x / ranks) * outs + o] = v;
    }
  cluster.sync();                   // the others' memory is read: they may end
  if (rank != 0 || clusters == 1) return;
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(counters + grp, 1u) == (unsigned)clusters - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the group's last cluster: the clusters' rows in order, `per` threads an
  // output, each a run of `span` consecutive rows; the runs then in order
  auto put = [&](int o, float v) {
    (o < C ? op.s : op.q)[grp * C + o % C] = v;
  };
  const int per = outs >= (int)blockDim.x ? 1 : (int)blockDim.x / outs;
  if (per == 1) {
    for (int o = t; o < outs; o += blockDim.x) {
      float v = 0.0f;
#pragma unroll 8
      for (int r = 0; r < clusters; ++r)
        v += __ldcg(rows + (size_t)r * outs + o);
      put(o, v);
    }
  } else {
    const int span = (clusters + per - 1) / per;
    const int o = t % outs;
    const int p = t / outs;
    float v = 0.0f;
    if (p < per) {
      const int end = min(clusters, (p + 1) * span);
#pragma unroll 8
      for (int r = p * span; r < end; ++r)
        v += __ldcg(rows + (size_t)r * outs + o);
    }
    float* runs = &part[0][0];
    runs[t] = v;
    __syncthreads();
    if (t < outs) {
      float total = runs[t];
      for (int q = 1; q < per; ++q) total += runs[q * outs + t];
      put(t, total);
    }
  }
  if (t == 0) counters[grp] = 0;
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
  int lanes;    // the lanes streams: chunks a row (C / vec, S = 1), else 0
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

// The lanes streams (the note at the head of the file): S = 1, C a multiple
// of V, no head and no tail, a stride a multiple of cpr = st.lanes. Thread
// t's chunks all hold channels (t % cpr) * V onward; it forms their
// coefficients where its chunks enter a group.
template <typename Op, typename T, int V>
__device__ __forceinline__ void stream_lanes(const Op& op,
                                             const T* __restrict__ x,
                                             const T* __restrict__ g,
                                             T* __restrict__ out, int G,
                                             int N, int C, const Stream& st) {
  using Coef = typename Op::Coef;
  const int stride = gridDim.x * blockDim.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int c0 = (t % st.lanes) * V;
  const int per_group = N * st.lanes;       // chunks a group
  int next = 0;                             // the next group's first chunk
  Coef kc[V];
  auto enter = [&](int j) {                 // chunk j: its group's coefficients
    if (j < next) return;
    const int grp = j / per_group;
    next = (grp + 1) * per_group;
#pragma unroll
    for (int e = 0; e < V; ++e)
      kc[e] = op.coef(Chan{grp * C + c0 + e, c0 + e});
  };
  Chunk<T, V> xc[kStreamUnroll], gk[kStreamUnroll];
  auto load = [&](int k) {
#pragma unroll
    for (int u = 0; u < kStreamUnroll; ++u) {
      const int j = k + u * stride;
      if (j < st.chunks) {
        xc[u].load(x + (size_t)j * V);
        if constexpr (Op::kReadsG) gk[u].load(g + (size_t)j * V);
      }
    }
  };
  load(t);
  if (blockIdx.x == 0) op.write_vectors(G, C);
  for (int k = t; k < st.chunks;) {
#pragma unroll
    for (int u = 0; u < kStreamUnroll; ++u) {
      const int j = k + u * stride;
      if (j < st.chunks) {
        enter(j);
        Packed<T, V> o;
#pragma unroll
        for (int i = 0; i < V; ++i)
          o.set(i, op.apply(xc[u].at(i), Op::kReadsG ? gk[u].at(i) : 0.0f,
                            kc[i]));
        o.store(out + (size_t)j * V);
      }
    }
    k += kStreamUnroll * stride;
    load(k);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksPerSm)
bn_normalize_kernel_lanes(const T* __restrict__ x, T* __restrict__ y,
                          NormalizeOp op, int G, int N, int C, Stream st) {
  stream_lanes<NormalizeOp, T, V>(op, x, nullptr, y, G, N, C, st);
}

template <typename T, int V>
__global__ void __launch_bounds__(kStreamThreads, kLanesDxBlocksPerSm)
bn_dx_kernel_lanes(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, DxOp op, int G, int N, int C,
                   Stream st) {
  stream_lanes<DxOp, T, V>(op, x, g, dx, G, N, C, st);
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

// A plane's chunks and the planes are counted in int.
bool bad_shape(int G, int N, int C, int S) {
  return G < 1 || N < 1 || C < 1 || S < 1 ||
         (long long)G * C > 0x7fffffffLL || (long long)N * S > 0x7fffffffLL;
}

// The launch the wrapper computed (ops/bn.py:reduce_launch): the mapping
// (0 rows, 1 columns, 2 lanes), the vector width, the blocks that share a
// plane (one cluster; the lanes mapping: a group's blocks), the rows a block
// (the lanes mapping: its row lanes), the threads a block and, of them, the
// threads along a row (rows mapping), the channels a block (columns
// mapping) or the chunks a row (lanes mapping).
struct ReduceLaunch {
  int columns, vec, splits, rows, threads, tpr;
};

ReduceLaunch reduce_of(const int* geo) {
  return {geo[0], geo[1], geo[2], geo[3], geo[4], geo[5]};
}

// Either reduction: its geometry checked against the shape and the
// tensors, then the kernel of its mapping and vector width.
template <typename Op, typename T>
int reduce(const Op& op, const void* x, const void* g, int G, int N, int C,
           int S, const ReduceLaunch& l, void* scratch, void* counters,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = (const T*)x;
  const T* gt = (const T*)g;
  if (l.columns == 2) {
    // whole chunks a row, every row lane's chunks in one block, aligned
    // tensors, a scratch row a block and a counter a group where split
    if (S != 1 || l.vec != V || C % V || l.tpr != C / V ||
        l.threads != kLanesThreads || l.tpr > l.threads ||
        l.rows != l.threads / l.tpr || l.splits < 1 || G > 65535 ||
        l.splits % lanes_cluster(l.splits) || !aligned16(x) ||
        (Op::kReadsG && !aligned16(g)) ||
        (l.splits > kMaxCluster &&
         (scratch == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    const int cl = lanes_cluster(l.splits);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)cl;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)l.splits, (unsigned)G);
    cfg.blockDim = dim3((unsigned)kLanesThreads);
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = cl > 1 ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, bn_reduce_kernel_lanes<Op, T, V>, op, xt, gt, N, C,
        (float*)scratch, (unsigned*)counters);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  const int tpr_log2 = log2_exact(l.tpr);
  // every row in exactly one block, no block without rows, one cluster
  if (l.rows < 1 || l.splits < 1 || l.splits > kMaxCluster ||
      (long long)l.splits * l.rows < N ||
      (long long)(l.splits - 1) * l.rows >= N || tpr_log2 < 0 ||
      l.threads % 32 || l.threads < 32 || l.threads > kReduceThreads ||
      l.threads % l.tpr)
    return (int)cudaErrorInvalidValue;
  if (l.columns) {
    if (l.vec != 1 || l.tpr > kColumnsMaxWide)
      return (int)cudaErrorInvalidValue;
    const int across = (C + l.tpr - 1) / l.tpr;
    const dim3 grid((unsigned)(G * across), (unsigned)l.splits);
    return launch_cluster(bn_reduce_kernel<Op, T, 1, true>, grid, l.threads,
                          st, op, xt, gt, N, C, S, l.rows, tpr_log2);
  }
  const bool vec_ok =
      l.vec == 1 || (l.vec == V && S % V == 0 && aligned16(x) &&
                     (!Op::kReadsG || aligned16(g)));
  if (!vec_ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(G * C), (unsigned)l.splits);
  auto go = [&](auto kernel) {
    return launch_cluster(kernel, grid, l.threads, st, op, xt, gt, N, C, S,
                          l.rows, tpr_log2);
  };
  return l.vec == V ? go(bn_reduce_kernel<Op, T, V, false>)
                    : go(bn_reduce_kernel<Op, T, 1, false>);
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
  if (st.lanes &&
      (S != 1 || st.vec != V || C % V || st.lanes != C / V || st.head ||
       st.tail || st.whole ||
       (long long)st.blocks * kStreamThreads % st.lanes))
    return false;
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
  if (st.lanes)
    K<T, V, true>::lanes(grid, block, s, args...);
  else if (st.vec == 1)
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
                     void* y, NormalizeOp op, int G, int, int C, Stream st) {
    bn_normalize_kernel<T, V, kWhole><<<grid, block, 0, s>>>(
        (const T*)x, (T*)y, op, G, C, st);
  }
  static void lanes(dim3 grid, dim3 block, cudaStream_t s, const void* x,
                    void* y, NormalizeOp op, int G, int N, int C, Stream st) {
    bn_normalize_kernel_lanes<T, V><<<grid, block, 0, s>>>(
        (const T*)x, (T*)y, op, G, N, C, st);
  }
};

template <typename T, int V, bool kWhole>
struct DxLaunch {
  static void launch(dim3 grid, dim3 block, cudaStream_t s, const void* x,
                     const void* g, void* dx, DxOp op, int G, int, int C,
                     Stream st) {
    bn_dx_kernel<T, V, kWhole><<<grid, block, 0, s>>>(
        (const T*)x, (const T*)g, (T*)dx, op, G, C, st);
  }
  static void lanes(dim3 grid, dim3 block, cudaStream_t s, const void* x,
                    const void* g, void* dx, DxOp op, int G, int N, int C,
                    Stream st) {
    bn_dx_kernel_lanes<T, V><<<grid, block, 0, s>>>(
        (const T*)x, (const T*)g, (T*)dx, op, G, N, C, st);
  }
};

template <typename T>
int normalize_pass(const void* x, void* y, const NormalizeOp& op, int G,
                   int N, int C, int S, const Stream& st, cudaStream_t s) {
  const void* ptrs[] = {x, y};
  if (!stream_ok(st, 16 / sizeof(T), G, N, C, S, sizeof(T), ptrs, 2))
    return (int)cudaErrorInvalidValue;
  return launch_stream<NormalizeLaunch, T>(st, s, x, y, op, G, N, C, st);
}

template <typename T>
int dx_pass(const void* x, const void* g, void* out, const DxOp& op, int G,
            int N, int C, int S, const Stream& st, cudaStream_t s) {
  const void* ptrs[] = {x, g, out};
  if (!stream_ok(st, 16 / sizeof(T), G, N, C, S, sizeof(T), ptrs, 3))
    return (int)cudaErrorInvalidValue;
  return launch_stream<DxLaunch, T>(st, s, x, g, out, op, G, N, C, st);
}

Stream stream_of(const int* geo, const unsigned* div) {
  Stream st;
  st.vec = geo[0];
  st.head = geo[1];
  st.chunks = geo[2];
  st.tail = geo[3];
  st.whole = geo[4];
  st.blocks = geo[5];
  st.lanes = geo[6];
  st.by_s = {div[0], div[1]};
  st.by_c = {div[2], div[3]};
  st.by_group = {div[4], div[5]};
  return st;
}

}  // namespace

// Every entry point takes x (and g, y, dx) as contiguous (G, N, C, S)
// tensors of one type, f32 (bf16 = 0) or bf16 (bf16 = 1), and the per-(g, c)
// vectors as contiguous (G, C) f32. It returns the cudaError_t of the launch.

// geo (6 ints) is ops/bn.py:reduce_launch's result: columns, vec, splits,
// rows, threads, tpr. scratch and counters: the lanes mapping's, where it
// splits a group's rows (G * splits * 2C floats; G unsigned, all 0), else
// null.
extern "C" int mvae_bn_moments(const void* x, int bf16, void* sum,
                               void* sumsq, int G, int N, int C, int S,
                               const int* geo, void* scratch, void* counters,
                               void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  const MomentsOp op{(float*)sum, (float*)sumsq};
  cudaStream_t st = (cudaStream_t)stream;
  const ReduceLaunch l = reduce_of(geo);
  return bf16 ? reduce<MomentsOp, __nv_bfloat16>(op, x, nullptr, G, N, C, S,
                                                 l, scratch, counters, st)
              : reduce<MomentsOp, float>(op, x, nullptr, G, N, C, S, l,
                                         scratch, counters, st);
}

// geo (7 ints) and div (6) are ops/bn.py:normalize_launch's (dx_launch's)
// result: vec, head, chunks, tail, whole, blocks, lanes; the multiplier and
// shift of S, C and N * C * S. n: the elements
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

// geo, scratch, counters: as mvae_bn_moments'.
extern "C" int mvae_bn_bwd_partials(const void* x, const void* g, int bf16,
                                    const void* a, const void* b, void* sdz,
                                    void* sdzx, int G, int N, int C, int S,
                                    const int* geo, void* scratch,
                                    void* counters, void* stream) {
  if (bad_shape(G, N, C, S)) return (int)cudaErrorInvalidValue;
  const PartialsOp op{(const float*)a, (const float*)b, (float*)sdz,
                      (float*)sdzx};
  cudaStream_t st = (cudaStream_t)stream;
  const ReduceLaunch l = reduce_of(geo);
  return bf16 ? reduce<PartialsOp, __nv_bfloat16>(op, x, g, G, N, C, S, l,
                                                  scratch, counters, st)
              : reduce<PartialsOp, float>(op, x, g, G, N, C, S, l, scratch,
                                          counters, st);
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
