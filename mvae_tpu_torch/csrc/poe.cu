// Masked product of experts for every ELBO term in one pass (forward).
//
// Replaces the TPU kernel mvae_tpu/ops/poe_pallas.py:_kernel. For each
// column c of the flattened (B*D) posterior axis and each term t:
//
//   prec_m = 1 / (exp(logvar_m) + 1e-8)
//   den_t  = sum_m masks[t, m] * prec_m + 1 / (1 + 1e-8)     (prior folded in)
//   num_t  = sum_m masks[t, m] * mu_m * prec_m
//   pd_mu[t, c] = num_t / den_t,   pd_logvar[t, c] = -log(den_t)
//
// What bounds it: at the shapes of the CelebA paths (M=2, B*D <= 10^4,
// T <= 3) the kernel moves a few hundred KB, so one launch costs more than
// its bytes; at large B*D it is bound by reading mu/logvar once and writing
// the 2*T outputs once. The design keeps it at one read: one thread owns a
// column, loads its M experts once and forms prec and mu*prec in registers,
// then runs every term's mask contraction from those registers. The mask
// contraction is a plain f32 FMA loop (M <= 32): the TPU kernel insists on
// true f32 (Precision.HIGHEST), so no tensor cores and no TF32 here.
// expf/logf/division are the precise forms (no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxExperts = 32;
constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;

__global__ void __launch_bounds__(kThreads)
poe_fwd_kernel(const float* __restrict__ mu, const float* __restrict__ logvar,
               const float* __restrict__ masks, float* __restrict__ pd_mu,
               float* __restrict__ pd_logvar, int n_experts, int n_terms,
               long long n_cols) {
  extern __shared__ float s_masks[];  // (n_terms, n_experts)
  for (int i = threadIdx.x; i < n_terms * n_experts; i += blockDim.x) {
    s_masks[i] = masks[i];
  }
  __syncthreads();

  const float prior = 1.0f / (1.0f + kEps);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < n_cols; c += stride) {
    float prec[kMaxExperts];
    float mu_prec[kMaxExperts];
#pragma unroll
    for (int m = 0; m < kMaxExperts; ++m) {
      if (m < n_experts) {
        const float p = 1.0f / (expf(logvar[m * n_cols + c]) + kEps);
        prec[m] = p;
        mu_prec[m] = mu[m * n_cols + c] * p;
      }
    }
    for (int t = 0; t < n_terms; ++t) {
      const float* w = s_masks + t * n_experts;
      float den = 0.0f;
      float num = 0.0f;
#pragma unroll
      for (int m = 0; m < kMaxExperts; ++m) {
        if (m < n_experts) {
          den = fmaf(w[m], prec[m], den);
          num = fmaf(w[m], mu_prec[m], num);
        }
      }
      den += prior;
      pd_mu[t * n_cols + c] = num / den;
      pd_logvar[t * n_cols + c] = -logf(den);
    }
  }
}

}  // namespace

// mu, logvar: (n_experts, n_cols) f32, contiguous; masks: (n_terms,
// n_experts) f32; pd_mu, pd_logvar: (n_terms, n_cols) f32. Returns the
// cudaError_t of the launch.
extern "C" int mvae_poe_fwd(const void* mu, const void* logvar,
                            const void* masks, void* pd_mu, void* pd_logvar,
                            int n_experts, int n_terms, long long n_cols,
                            void* stream) {
  if (n_experts < 1 || n_experts > kMaxExperts || n_terms < 1 || n_cols < 1) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = (n_cols + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // grid-strided beyond this
  const size_t smem = sizeof(float) * (size_t)n_terms * n_experts;
  poe_fwd_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)mu, (const float*)logvar, (const float*)masks,
      (float*)pd_mu, (float*)pd_logvar, n_experts, n_terms, n_cols);
  return (int)cudaGetLastError();
}
