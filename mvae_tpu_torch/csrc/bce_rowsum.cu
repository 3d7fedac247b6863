// Row-summed, numerically stable BCE with logits (forward).
//
// Replaces the TPU kernel mvae_tpu/ops/elbo_pallas.py:_kernel:
//
//   out[r] = sum_k max(x[r,k], 0) - x[r,k] * t[r',k] + log1p(exp(-|x[r,k]|))
//
// with r' = r mod n_target_rows, so the T terms' decoded rows (T*B of them)
// share one copy of the B target rows instead of a repeated one.
//
// What bounds it: bytes, once an element costs few instructions. It reads
// every logit and every target row once and writes one f32 per row; the
// (300, 12288) image rows of the CelebA steps are 10-17 MB against the
// card's memory rate, and the 18-wide attribute rows are a launch. With the
// precise expf and log1pf an element was about 45 instructions, which took
// as long as its bytes; the softplus now takes the hardware's
// approximations (bce below), about 10 instructions an element.
//
// Design (ops/elbo.py:bce_launch gives the geometry, checked here). A row
// is chunks of V elements, V * 4 bytes of f32 or V * 2 of bf16 (V = 16
// bytes of the narrower type; one element where K is not a whole number
// of chunks or a tensor is off a 16-byte boundary). Wide rows: a block of
// 256 threads a row, each thread 2 chunks of x and of t in flight, raw in
// registers, summed in f32; a row too long for its threads to take it in
// a few chunks each is split into spans, one block each, and the blocks
// of a row are one thread block cluster whose sums meet in the first
// block in rank order (csrc/reduce.cuh). The CelebA image rows fit one
// block: a cluster launch costs the card about 1 us more than a plain one.
// Narrow rows (a warp's lanes or fewer to a row, several rows a block):
// the lanes of a row sum by warp shuffles. Every sum is bit-identical
// from launch to launch, with no atomics, in one launch. Logits and
// targets are each f32 or bf16 (template instantiations), upcast in
// registers, so the caller never makes a cast copy.
//
// bf16 math (bf16 logits, kBf16Math): the elementwise terms round to bf16
// at the points ops/elbo.py fixes (bce_bf16 below) and the row still sums
// in f32 -- the JAX package's MVAE_BF16_LOSS branch, whose own rounding
// points XLA may skip. It takes the precise expf and log1pf, whose f32
// results PyTorch's bf16 exp and log1p round too, so an element equals the
// plain version's bit for bit and only the order of the row sum differs.

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;     // a block, at most
constexpr int kUnroll = 2;        // chunks of x and of t a thread has in
                                  // flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One element's BCE. The softplus term log(1 + exp(-|x|)) is formed as
// __expf and __logf form it, from ex2.approx and lg2.approx, without their
// handling of denormal values (e is one only where it is below 2^-126,
// 1 + e never). Its error against the exact value, by the CUDA Math API's
// bounds: e = __expf(-|x|) within (2 + 1.173 |x|) ulp, at most 2^-22
// absolute over |x| >= 0; 1 + e rounded, 2^-24; __logf on [1, 2] within
// 2^-21.41 absolute: in all below 6.7e-7 an element, so a row of K
// elements sums within K * 6.7e-7 of the precise forms' sum (8.2e-3 at
// K = 12288, where BCE_TOL allows 1e-4 + 1e-5 |row|). The other terms round
// as the plain version's do, but for the fused multiply-add.
__device__ __forceinline__ float bce(float x, float t) {
  float e, l;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fabsf(x) * -kLog2e));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(l) : "f"(1.0f + e));
  return fmaf(-x, t, fmaxf(x, 0.0f)) + l * kLn2;
}

// Block (bx, y): rows bx * (blockDim.x / lanes) + threadIdx.x / lanes, each
// row's chunks [y * span, (y + 1) * span) over its `lanes` threads,
// kUnroll chunks a thread in flight. Wide rows: lanes = blockDim.x (one row a
// block, the grid.y blocks of a row one cluster); narrow: lanes <= 32,
// grid.y = 1.
// x rounded to bf16 and back: one of the bf16 math's rounding points.
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One element's BCE in bf16 steps (ops/elbo.py): with t rounded to bf16,
//   a = bf16(x t), b = bf16(max(x, 0) - a), e = bf16(exp(-|x|)),
//   l = bf16(log1p(e)), element = bf16(b + l),
// each operation in f32 from bf16 operands (x t is exact there), rounded
// once; the _rn intrinsics keep the compiler from contracting them.
__device__ __forceinline__ float bce_bf16(float x, float t) {
  const float a = rbf(__fmul_rn(x, rbf(t)));
  const float b = rbf(__fsub_rn(fmaxf(x, 0.0f), a));
  const float l = rbf(log1pf(rbf(expf(-fabsf(x)))));
  return rbf(__fadd_rn(b, l));
}

template <bool kBf16Math>
__device__ __forceinline__ float bce_elem(float x, float t) {
  return kBf16Math ? bce_bf16(x, t) : bce(x, t);
}

template <typename TX, typename TT, int V, bool kBf16Math>
__global__ void __launch_bounds__(kThreads)
bce_rowsum_kernel(const TX* __restrict__ x, const TT* __restrict__ t,
                  float* __restrict__ out, int n_rows, int n_cols,
                  int n_target_rows, int span, int lanes_log2) {
  constexpr int U = kUnroll;
  const int lanes = 1 << lanes_log2;
  const bool wide = lanes == (int)blockDim.x;
  if (wide) cluster_arrive();
  const int row = blockIdx.x * (blockDim.x >> lanes_log2) +
                  (threadIdx.x >> lanes_log2);
  const int lane = threadIdx.x & (lanes - 1);
  const int c0 = blockIdx.y * span;
  const int c1 = min(n_cols / V, c0 + span);
  float acc[1] = {0.0f};
  if (row < n_rows) {
    const TX* xr = x + (size_t)row * n_cols;
    const TT* tr = t + (size_t)(row % n_target_rows) * n_cols;
    for (int c = c0 + lane; c < c1; c += lanes * U) {
      Chunk<TX, V> xc[U];
      Chunk<TT, V> tc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = c + u * lanes;
        if (j < c1) {
          xc[u].load(xr + (size_t)j * V);
          tc[u].load(tr + (size_t)j * V);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (c + u * lanes < c1)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[0] += bce_elem<kBf16Math>(xc[u].at(e), tc[u].at(e));
    }
  }
  if (wide) {
    block_sum<1>(acc);
    if (cluster_sum<1, 1>(acc, 1)) out[row] = acc[0];
    return;
  }
  for (int o = lanes >> 1; o > 0; o >>= 1)
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  if (lane == 0 && row < n_rows) out[row] = acc[0];
}

// What ops/elbo.py:bce_launch computed.
struct BceLaunch {
  int vec, lanes, threads, splits, span;
};

template <typename TX, typename TT, bool kBf16Math = false>
int launch(const void* x, const void* t, float* out, int n_rows, int n_cols,
           int n_target_rows, const BceLaunch& l, cudaStream_t stream) {
  // a chunk spans one 16-byte load of the narrower type
  constexpr int V = 16 / (sizeof(TX) < sizeof(TT) ? sizeof(TX) : sizeof(TT));
  const int lanes_log2 = log2_exact(l.lanes);
  const bool vec_ok = l.vec == 1 || (l.vec == V && n_cols % V == 0 &&
                                     aligned16(x) && aligned16(t));
  const long long chunks = n_cols / l.vec;
  const bool wide = l.lanes == l.threads;
  // every chunk of every row in exactly one block, one cluster a row
  if (!vec_ok || lanes_log2 < 0 || l.threads % 32 || l.threads < 32 ||
      l.threads > kThreads || l.threads % l.lanes ||
      (!wide && (l.lanes > 32 || l.splits != 1)) || l.splits < 1 ||
      l.splits > kMaxCluster || l.span < 1 ||
      (long long)l.splits * l.span < chunks ||
      (long long)(l.splits - 1) * l.span >= chunks)
    return (int)cudaErrorInvalidValue;
  const int per_block = l.threads / l.lanes;
  const dim3 grid((unsigned)((n_rows + per_block - 1) / per_block),
                  (unsigned)l.splits);
  auto go = [&](auto kernel) {
    return launch_cluster(kernel, grid, l.threads, stream, (const TX*)x,
                          (const TT*)t, out, n_rows, n_cols, n_target_rows,
                          l.span, lanes_log2);
  };
  return l.vec == V ? go(bce_rowsum_kernel<TX, TT, V, kBf16Math>)
                    : go(bce_rowsum_kernel<TX, TT, 1, kBf16Math>);
}

}  // namespace

// x: (n_rows, n_cols) f32 or bf16 (x_bf16 = 1), contiguous; t: (n_target_rows,
// n_cols) f32 or bf16 (t_bf16 = 1), contiguous, n_rows % n_target_rows == 0;
// bf16_math = 1 (bf16 x only): the bf16 steps; out: (n_rows,) f32; geo (5
// ints): ops/elbo.py:bce_launch's vec, lanes, threads, splits, span.
// Returns the cudaError_t of the launch.
extern "C" int mvae_bce_rowsum_fwd(const void* x, int x_bf16, const void* t,
                                   int t_bf16, int bf16_math, void* out,
                                   int n_rows, int n_cols, int n_target_rows,
                                   const int* geo, void* stream) {
  if (n_rows < 1 || n_cols < 1 || n_target_rows < 1 ||
      n_rows % n_target_rows != 0 || (bf16_math && !x_bf16)) {
    return (int)cudaErrorInvalidValue;
  }
  const BceLaunch l{geo[0], geo[1], geo[2], geo[3], geo[4]};
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  if (!x_bf16 && !t_bf16) {
    return launch<float, float>(x, t, o, n_rows, n_cols, n_target_rows, l, s);
  }
  if (!x_bf16 && t_bf16) {
    return launch<float, __nv_bfloat16>(x, t, o, n_rows, n_cols,
                                        n_target_rows, l, s);
  }
  if (bf16_math) {
    return t_bf16 ? launch<__nv_bfloat16, __nv_bfloat16, true>(
                        x, t, o, n_rows, n_cols, n_target_rows, l, s)
                  : launch<__nv_bfloat16, float, true>(
                        x, t, o, n_rows, n_cols, n_target_rows, l, s);
  }
  if (x_bf16 && !t_bf16) {
    return launch<__nv_bfloat16, float>(x, t, o, n_rows, n_cols,
                                        n_target_rows, l, s);
  }
  return launch<__nv_bfloat16, __nv_bfloat16>(x, t, o, n_rows, n_cols,
                                              n_target_rows, l, s);
}
