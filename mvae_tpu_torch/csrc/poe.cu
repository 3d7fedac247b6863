// Masked product of experts for every ELBO term: the forward (poe_fwd) and
// its closed-form backward (poe_bwd).
//
// poe_fwd replaces the TPU kernel mvae_tpu/ops/poe_pallas.py:_kernel,
// poe_bwd the closed form poe_pallas.py:_bwd (jnp there, which XLA fuses;
// eager PyTorch it was 25 launches). For each column c of the flattened
// (B*D) posterior axis and each term t, with w = masks (T, M):
//
//   e_m    = exp(logvar_m),   prec_m = 1 / (e_m + 1e-8)
//   den_t  = sum_m w[t, m] * prec_m + 1 / (1 + 1e-8)     (prior folded in)
//   num_t  = sum_m w[t, m] * (mu_m * prec_m)
//   pd_mu[t, c] = num_t / den_t,   pd_logvar[t, c] = -log(den_t)
//
// and from the upstream gradients g_mu, g_lv (T, B*D), recomputing the
// above in registers as JAX recomputes them (the forward saves nothing):
//
//   d_num_t = g_mu_t / den_t
//   d_den_t = -(g_mu_t * num_t) / (den_t * den_t) - g_lv_t / den_t
//   back_m  = sum_t w[t, m] * d_num_t,   dd_m = sum_t w[t, m] * d_den_t
//   d_mu_m  = back_m * prec_m
//   d_lv_m  = (back_m * mu_m + dd_m) * (-(prec_m * prec_m) * e_m)
//
// What bounds them: latency. At the CelebA paths' shapes (M = 2, T <= 3,
// B*D <= 10^4) each moves a few hundred KB, 0.1-0.2 us at the card's
// memory rate, against about 3 us that a launch costs on its own. So the
// design takes dependent trips out, not bytes:
//  - One memory round trip. A thread issues every load of its column
//    first (mu and logvar; in the backward also the upstream gradients of
//    the first kTermBatch terms), and the masks' first row beside them,
//    read through the read-only path at an address the whole warp shares
//    (one broadcast). No shared-memory stage, no barrier; the next mask
//    row is loaded while a term is summed, from L1.
//  - One wave of threads: one column a thread in blocks of kThreads, as
//    many blocks as cover the columns (the ragged tail in the same
//    launch). On the H100 4 columns a thread (one 16-byte load a row)
//    read 0.5-1.5 us slower at the steps' 10^4 columns, as a thread's
//    arithmetic, 4 columns long, is what so few warps wait on; the block
//    size moved the time by under 0.05 us.
//  - Registers sized to the experts: the kernels are templated on an
//    expert cap (2, 8 or 32) that the wrapper picks (ops/poe.py:
//    expert_cap), so the main path's M = 2 holds 2 experts and M = 32
//    does not spill.
// The mask contraction is a plain f32 FMA loop in ascending m (the TPU
// kernel insists on true f32, Precision.HIGHEST: no tensor cores, no TF32)
// and the backward's term sums FMAs in ascending t; expf, logf and the
// divisions are the precise forms. Each output is written by one thread,
// so both kernels are bit-identical from launch to launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // a block, one column a thread
constexpr int kTermBatch = 4;     // terms whose upstream gradients a thread
                                  // of poe_bwd has in flight
constexpr float kEps = 1e-8f;

// Mask row t, the same address in every lane; 0 past the experts.
template <int kCap>
__device__ __forceinline__ void load_row(float (&w)[kCap],
                                         const float* __restrict__ masks,
                                         int t, int n_experts) {
#pragma unroll
  for (int m = 0; m < kCap; ++m)
    w[m] = m < n_experts ? __ldg(masks + t * n_experts + m) : 0.0f;
}

// Each thread: column c of every row.
template <int kCap>
__global__ void __launch_bounds__(kThreads)
poe_fwd_kernel(const float* __restrict__ mu, const float* __restrict__ logvar,
               const float* __restrict__ masks, float* __restrict__ pd_mu,
               float* __restrict__ pd_logvar, int n_experts, int n_terms,
               long long n_cols) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cols) return;
  float x_mu[kCap], x_lv[kCap];
#pragma unroll
  for (int m = 0; m < kCap; ++m) {
    if (m < n_experts) {
      x_mu[m] = __ldg(mu + m * n_cols + c);
      x_lv[m] = __ldg(logvar + m * n_cols + c);
    }
  }
  float w[kCap];
  load_row(w, masks, 0, n_experts);
  // x_lv becomes prec, x_mu becomes mu * prec
#pragma unroll
  for (int m = 0; m < kCap; ++m) {
    if (m < n_experts) {
      const float p = 1.0f / (expf(x_lv[m]) + kEps);
      x_lv[m] = p;
      x_mu[m] *= p;
    }
  }
  const float prior = 1.0f / (1.0f + kEps);
  for (int t = 0; t < n_terms; ++t) {
    float den = 0.0f;
    float num = 0.0f;
#pragma unroll
    for (int m = 0; m < kCap; ++m) {
      if (m < n_experts) {
        den = fmaf(w[m], x_lv[m], den);
        num = fmaf(w[m], x_mu[m], num);
      }
    }
    den += prior;
    if (t + 1 < n_terms) load_row(w, masks, t + 1, n_experts);
    pd_mu[t * n_cols + c] = num / den;
    pd_logvar[t * n_cols + c] = -logf(den);
  }
}

// The upstream gradients of terms [t0, t0 + kTermBatch) at column c.
__device__ __forceinline__ void load_terms(
    float (&gm)[kTermBatch], float (&gl)[kTermBatch],
    const float* __restrict__ g_mu, const float* __restrict__ g_lv, int t0,
    int n_terms, long long n_cols, long long c) {
#pragma unroll
  for (int j = 0; j < kTermBatch; ++j) {
    if (t0 + j < n_terms) {
      gm[j] = __ldg(g_mu + (t0 + j) * n_cols + c);
      gl[j] = __ldg(g_lv + (t0 + j) * n_cols + c);
    }
  }
}

// The same columns as poe_fwd_kernel: prec and the d_lv factor
// -(prec^2) e of each expert in registers, then the terms in ascending
// order, kTermBatch gradients at a time, accumulating back and dd.
template <int kCap>
__global__ void __launch_bounds__(kThreads)
poe_bwd_kernel(const float* __restrict__ mu, const float* __restrict__ logvar,
               const float* __restrict__ masks,
               const float* __restrict__ g_mu, const float* __restrict__ g_lv,
               float* __restrict__ d_mu, float* __restrict__ d_lv,
               int n_experts, int n_terms, long long n_cols) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_cols) return;
  float x_mu[kCap], prec[kCap];
#pragma unroll
  for (int m = 0; m < kCap; ++m) {
    if (m < n_experts) {
      x_mu[m] = __ldg(mu + m * n_cols + c);
      prec[m] = __ldg(logvar + m * n_cols + c);
    }
  }
  float gm[kTermBatch], gl[kTermBatch];
  load_terms(gm, gl, g_mu, g_lv, 0, n_terms, n_cols, c);
  float w[kCap];
  load_row(w, masks, 0, n_experts);
  float fac[kCap], back[kCap], dd[kCap];
#pragma unroll
  for (int m = 0; m < kCap; ++m) {
    if (m < n_experts) {
      const float ex = expf(prec[m]);
      const float p = 1.0f / (ex + kEps);
      prec[m] = p;
      fac[m] = -(p * p) * ex;
      back[m] = 0.0f;
      dd[m] = 0.0f;
    }
  }
  const float prior = 1.0f / (1.0f + kEps);
  for (int t0 = 0; t0 < n_terms; t0 += kTermBatch) {
#pragma unroll
    for (int j = 0; j < kTermBatch; ++j) {
      const int t = t0 + j;
      if (t < n_terms) {
        float den = 0.0f;
        float num = 0.0f;
#pragma unroll
        for (int m = 0; m < kCap; ++m) {
          if (m < n_experts) {
            den = fmaf(w[m], prec[m], den);
            num = fmaf(w[m], x_mu[m] * prec[m], num);
          }
        }
        den += prior;
        const float d_num = gm[j] / den;
        const float d_den = -(gm[j] * num) / (den * den) - gl[j] / den;
#pragma unroll
        for (int m = 0; m < kCap; ++m) {
          if (m < n_experts) {
            back[m] = fmaf(w[m], d_num, back[m]);
            dd[m] = fmaf(w[m], d_den, dd[m]);
          }
        }
        if (t + 1 < n_terms) load_row(w, masks, t + 1, n_experts);
      }
    }
    if (t0 + kTermBatch < n_terms)
      load_terms(gm, gl, g_mu, g_lv, t0 + kTermBatch, n_terms, n_cols, c);
  }
#pragma unroll
  for (int m = 0; m < kCap; ++m) {
    if (m < n_experts) {
      d_mu[m * n_cols + c] = back[m] * prec[m];
      d_lv[m * n_cols + c] = fmaf(back[m], x_mu[m], dd[m]) * fac[m];
    }
  }
}

// The blocks that cover n_cols columns, or 0 where the launch is not one
// the kernels take: the cap is an instantiation and holds the experts.
unsigned blocks_of(int cap, int n_experts, int n_terms, long long n_cols) {
  if (!(cap == 2 || cap == 8 || cap == 32) || n_experts < 1 ||
      n_experts > cap || n_terms < 1 || n_cols < 1 ||
      (long long)n_terms * n_experts >= (1LL << 31))
    return 0;
  const long long blocks = (n_cols + kThreads - 1) / kThreads;
  return blocks < (1LL << 31) ? (unsigned)blocks : 0;
}

using FwdKernel = void (*)(const float*, const float*, const float*, float*,
                           float*, int, int, long long);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*, int,
                           int, long long);

FwdKernel fwd_kernel(int cap) {
  if (cap == 2) return &poe_fwd_kernel<2>;
  if (cap == 8) return &poe_fwd_kernel<8>;
  return &poe_fwd_kernel<32>;
}

BwdKernel bwd_kernel(int cap) {
  if (cap == 2) return &poe_bwd_kernel<2>;
  if (cap == 8) return &poe_bwd_kernel<8>;
  return &poe_bwd_kernel<32>;
}

}  // namespace

// mu, logvar: (n_experts, n_cols) f32, contiguous; masks: (n_terms,
// n_experts) f32; pd_mu, pd_logvar: (n_terms, n_cols) f32; cap: the
// expert cap, ops/poe.py:expert_cap(n_experts). Returns the cudaError_t of
// the launch.
extern "C" int mvae_poe_fwd(const void* mu, const void* logvar,
                            const void* masks, void* pd_mu, void* pd_logvar,
                            int n_experts, int n_terms, long long n_cols,
                            int cap, void* stream) {
  const unsigned blocks = blocks_of(cap, n_experts, n_terms, n_cols);
  if (!blocks) return (int)cudaErrorInvalidValue;
  fwd_kernel(cap)<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mu, (const float*)logvar, (const float*)masks,
      (float*)pd_mu, (float*)pd_logvar, n_experts, n_terms, n_cols);
  return (int)cudaGetLastError();
}

// As mvae_poe_fwd, with g_mu, g_lv: (n_terms, n_cols) f32, contiguous, the
// upstream gradients of pd_mu and pd_logvar; d_mu, d_lv: (n_experts,
// n_cols) f32, the gradients of mu and logvar.
extern "C" int mvae_poe_bwd(const void* mu, const void* logvar,
                            const void* masks, const void* g_mu,
                            const void* g_lv, void* d_mu, void* d_lv,
                            int n_experts, int n_terms, long long n_cols,
                            int cap, void* stream) {
  const unsigned blocks = blocks_of(cap, n_experts, n_terms, n_cols);
  if (!blocks) return (int)cudaErrorInvalidValue;
  bwd_kernel(cap)<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mu, (const float*)logvar, (const float*)masks,
      (const float*)g_mu, (const float*)g_lv, (float*)d_mu, (float*)d_lv,
      n_experts, n_terms, n_cols);
  return (int)cudaGetLastError();
}
