// Bias-free conv2d with the per-channel moments of its output, in one pass.
//
// Replaces the TPU kernel of mvae_tpu/ops/convbn_pallas.py:_fwd_impl (the
// pallas_call at :156, kernel body _make_kernel._k at :116-136; the JAX
// package's public function is conv2d_moments, :188):
//
//   y[b, co, oh, ow] = sum over (ci, kh, kw) of
//                      x[b, ci, oh*s - p + kh, ow*s - p + kw] * w[co, ci, kh, kw]
//   part[0, t, co]   = sum over the pixels of tile t of y, rounded to y's type
//   part[1, t, co]   = the same sum of y * y
//
// x NCHW, w OIHW, y NCHW, all contiguous and of one type (f32 or bf16); part
// is (2, tiles, C_out) f32 and the wrapper (ops/convbn.py) sums it over the
// tiles, as the TPU version sums its per-block partials outside the kernel
// (:182-183). The kernel takes the 4x4 convolutions of the DCGAN stacks
// (`supported`, :61-71): stride 2 with padding 1, stride 1 with padding 0.
//
// Design. An implicit GEMM: M = B*OH*OW output pixels, N = C_out, K =
// C_in*16 (the OIHW weight is already the (N, K) matrix, K contiguous). A
// block owns a tile of 64 pixels x 64 channels and walks K in slices of 32:
// it stages the input patch (im2col on the fly, zero padding by bounds
// checks) and the weight slice in shared memory and accumulates in f32.
//   bf16: 4 warps, each a 32 x 32 sub-tile of 2 x 2 wmma 16x16x16 bf16
//         products (mma.sync on the tensor cores), f32 accumulators;
//   f32:  256 threads, each a 4 x 4 sub-tile of FMAs. No TF32: the f32 path
//         is held to the CPU at 1e-4.
// The TPU kernel's stride-2 phase decomposition (:78-96) is a VMEM layout
// device and is not carried over: the bounds checks do its work here.
// Epilogue: the accumulators pass through shared memory, channel-major; each
// is rounded once (to nearest even) to y's type and stored as NCHW y,
// threads on consecutive pixels of one channel; the sum and the sum of
// squares of the ROUNDED values, the materialized y as the TPU kernel takes
// them (:125-130), are summed over the tile's pixels in a fixed order and
// written as one partial row per pixel tile. No atomics: the sums are the
// same from run to run.
//
// What bounds it. At the CelebA encoder's shapes (B = 100: conv2 32->64 at
// 32x32, conv3 64->128 at 16x16, conv4 128->256 at 8x8, stride 1) the work is
// 1.68, 1.68 and 2.62 GFLOP on 9.9, 5.2 and 4.0 MB in bf16. Against 989
// TFLOP/s (bf16 tensor cores) and 3.35 TB/s that is about 3.0, 1.7 and
// 2.7 us, conv2 bound by bytes and the other two by operations; in f32
// against 67 TFLOP/s (FMA) all three are bound by operations (25-39 us).
// This first kernel has no pipelining (no cp.async, TMA or wgmma): each K
// slice is loaded, then multiplied, with the block waiting on both, so it
// sits well above either bound; its tiles are laid out for a later
// multi-stage pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kTileM = 64;           // output pixels a block (ops/convbn.py)
constexpr int kTileN = 64;           // output channels a block
constexpr int kTileK = 32;           // K slice staged in shared memory
constexpr int kLdAB = kTileK + 8;    // bf16 A and B rows: 80 bytes apart
constexpr int kLdC = kTileM + 4;     // Cs[channel][pixel], f32
constexpr int kBf16Threads = 128;    // 4 warps of 32 x 32
constexpr int kF32Threads = 256;     // 16 x 16 threads of 4 x 4

struct Geometry {
  int B, Cin, H, W, Cout, stride, pad, OH, OW, tiles;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The pixel a thread loads the input patch of, fixed for the whole K loop.
template <typename T>
struct Pixel {
  const T* xb;  // x of the pixel's image
  int ih0, iw0; // top-left input position of its 4x4 window
  bool ok;      // inside M
};

template <typename T>
__device__ __forceinline__ Pixel<T> pixel(const T* x, const Geometry& g,
                                          int m) {
  Pixel<T> p{x, 0, 0, false};
  const int ohw = g.OH * g.OW;
  if (m < g.B * ohw) {
    const int b = m / ohw, r = m - b * ohw, oh = r / g.OW, ow = r - oh * g.OW;
    p.xb = x + (long long)b * g.Cin * g.H * g.W;
    p.ih0 = oh * g.stride - g.pad;
    p.iw0 = ow * g.stride - g.pad;
    p.ok = true;
  }
  return p;
}

// Element kg of the pixel's im2col row: kg = ci*16 + kh*4 + kw; 0 in the
// padding and past K.
template <typename T>
__device__ __forceinline__ T patch(const Pixel<T>& p, const Geometry& g,
                                   int kg, int K) {
  if (p.ok && kg < K) {
    const int ih = p.ih0 + ((kg >> 2) & 3), iw = p.iw0 + (kg & 3);
    if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
      return p.xb[((long long)(kg >> 4) * g.H + ih) * g.W + iw];
  }
  return from_f32<T>(0.0f);
}

template <typename T>
__device__ __forceinline__ T weight(const T* w, int n, int kg, int Cout,
                                    int K) {
  return (n < Cout && kg < K) ? w[(long long)n * K + kg] : from_f32<T>(0.0f);
}

// Cs holds the tile's f32 accumulators, Cs[channel][pixel]. Round, store y,
// then the per-channel sums of the rounded values over the tile's pixels.
template <typename T, int NT>
__device__ __forceinline__ void epilogue(float (*Cs)[kLdC], T* y, float* part,
                                         const Geometry& g) {
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int ohw = g.OH * g.OW, M = g.B * ohw;
  for (int e = threadIdx.x; e < kTileM * kTileN; e += NT) {
    const int nn = e / kTileM, mi = e - nn * kTileM;
    const int m = m0 + mi, n = n0 + nn;
    float v = 0.0f;
    if (m < M && n < g.Cout) {
      const T r = from_f32<T>(Cs[nn][mi]);
      const int b = m / ohw;
      y[((long long)b * g.Cout + n) * ohw + (m - b * ohw)] = r;
      v = to_f32(r);
    }
    Cs[nn][mi] = v;
  }
  __syncthreads();
  constexpr int kPer = NT / kTileN;        // threads a channel, neighbours
  constexpr int kRows = kTileM / kPer;     // pixels each sums, in order
  static_assert(kPer >= 1 && kPer <= 32 && NT % kTileN == 0, "threads");
  const int nn = threadIdx.x / kPer, j = threadIdx.x % kPer;
  float s = 0.0f, q = 0.0f;
#pragma unroll 8
  for (int i = 0; i < kRows; ++i) {
    const float v = Cs[nn][j * kRows + i];
    s += v;
    q += v * v;
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off, kPer);
    q += __shfl_down_sync(0xffffffffu, q, off, kPer);
  }
  const int n = n0 + nn;
  if (j == 0 && n < g.Cout) {
    part[(long long)blockIdx.x * g.Cout + n] = s;
    part[((long long)g.tiles + blockIdx.x) * g.Cout + n] = q;
  }
}

__global__ void __launch_bounds__(kBf16Threads)
conv_moments_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ part, Geometry g) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[kTileM][kLdAB];  // [pixel][k]
  __shared__ __align__(32) __nv_bfloat16 Bs[kTileN][kLdAB];  // [channel][k]
  __shared__ __align__(32) float Cs[kTileN][kLdC];
  const int t = threadIdx.x, warp = t >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int K = g.Cin * 16, n0 = blockIdx.y * kTileN;
  const int mi = t & (kTileM - 1);
  const Pixel<__nv_bfloat16> px = pixel(x, g, blockIdx.x * kTileM + mi);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int j = 0; j < kTileK / 2; ++j) {
      const int kk = (t >> 6) + 2 * j;
      As[mi][kk] = patch(px, g, k0 + kk, K);
    }
#pragma unroll
    for (int j = 0; j < kTileN / 4; ++j) {
      const int nn = (t >> 5) + 4 * j, kk = t & 31;
      Bs[nn][kk] = weight(w, n0 + nn, k0 + kk, g.Cout, K);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTileK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm * 32 + i * 16][ks], kLdAB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[wn * 32 + j * 16][ks], kLdAB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wn * 32 + j * 16][wm * 32 + i * 16],
                              acc[i][j], kLdC, wmma::mem_col_major);
  __syncthreads();
  epilogue<__nv_bfloat16, kBf16Threads>(Cs, y, part, g);
}

__global__ void __launch_bounds__(kF32Threads)
conv_moments_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ y,
                        float* __restrict__ part, Geometry g) {
  __shared__ __align__(16) float As[kTileK][kTileM];   // [k][pixel]
  __shared__ __align__(16) float Bs[kTileK][kTileN];   // [k][channel]
  __shared__ __align__(16) float Cs[kTileN][kLdC];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int K = g.Cin * 16, n0 = blockIdx.y * kTileN;
  const int mi = t & (kTileM - 1);
  const Pixel<float> px = pixel(x, g, blockIdx.x * kTileM + mi);

  float acc[4][4];   // [pixel ty*4 + i][channel tx*4 + j]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int j = 0; j < kTileK / 4; ++j) {
      const int kk = (t >> 6) + 4 * j;
      As[kk][mi] = patch(px, g, k0 + kk, K);
      Bs[kk][mi] = weight(w, n0 + mi, k0 + kk, g.Cout, K);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(&Cs[tx * 4 + j][ty * 4]) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  __syncthreads();
  epilogue<float, kF32Threads>(Cs, y, part, g);
}

int out_size(int in, int stride, int pad) {
  return (in + 2 * pad - 4) / stride + 1;
}

// Only the shapes the wrapper accepts (ops/convbn.py:supported), with every
// index inside int.
bool bad_geometry(const Geometry& g) {
  const long long M = (long long)g.B * g.OH * g.OW;
  const bool conv_ok = (g.stride == 2 && g.pad == 1) ||
                       (g.stride == 1 && g.pad == 0);
  return g.B < 1 || g.Cin < 1 || g.H < 4 || g.W < 4 || g.Cout < 1 ||
         !conv_ok || g.OH != out_size(g.H, g.stride, g.pad) ||
         g.OW != out_size(g.W, g.stride, g.pad) ||
         g.tiles != (M + kTileM - 1) / kTileM ||
         (long long)g.B * g.Cin * g.H * g.W > 0x7fffffffLL ||
         M * g.Cout > 0x7fffffffLL ||
         (long long)g.Cin * 16 * g.Cout > 0x7fffffffLL ||
         (g.Cout + kTileN - 1) / kTileN > 65535;
}

}  // namespace

// x (B, Cin, H, W), w (Cout, Cin, 4, 4), y (B, Cout, OH, OW): contiguous, f32
// (bf16 = 0) or bf16 (bf16 = 1); part: (2, tiles, Cout) f32 with tiles =
// ceil(B*OH*OW / 64). Returns the cudaError_t of the launch.
extern "C" int mvae_conv_moments(const void* x, const void* w, int bf16,
                                 void* y, void* part, int B, int Cin, int H,
                                 int W, int Cout, int stride, int pad, int OH,
                                 int OW, int tiles, void* stream) {
  const Geometry g{B, Cin, H, W, Cout, stride, pad, OH, OW, tiles};
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((Cout + kTileN - 1) / kTileN));
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    conv_moments_bf16_kernel<<<grid, kBf16Threads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)y,
        (float*)part, g);
  } else {
    conv_moments_f32_kernel<<<grid, kF32Threads, 0, st>>>(
        (const float*)x, (const float*)w, (float*)y, (float*)part, g);
  }
  return (int)cudaGetLastError();
}
