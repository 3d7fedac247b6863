// Bias-free conv2d with the per-channel moments of its output, in one pass.
//
// Replaces the TPU kernel of mvae_tpu/ops/convbn_pallas.py:_fwd_impl (the
// pallas_call at :156, kernel body _make_kernel._k at :116-136; the JAX
// package's public function is conv2d_moments, :188):
//
//   y[b, co, oh, ow] = sum over (ci, kh, kw) of
//                      x[b, ci, oh*s - p + kh, ow*s - p + kw] * w[co, ci, kh, kw]
//   part[0, t, co]   = sum over tile t's pixels (b, oh, ow) of y, rounded to
//                      y's type; summed over t, the channel's sum of y
//   part[1, t, co]   = the same sums of y * y
//
// x NCHW, w OIHW, y NCHW, all contiguous and of one type (f32 or bf16). The
// kernel takes the 4x4 convolutions of the DCGAN stacks (`supported`,
// :61-71): stride 2 with padding 1, stride 1 with padding 0.
//
// What bounds it. An implicit GEMM: M = B*OH*OW output pixels, N = C_out,
// K = C_in*16 (the OIHW weight is already the (N, K) matrix, K contiguous).
// At the CelebA encoder's shapes the work is 1.7-2.6 GFLOP on 4-10 MB: in
// bf16 the tensor cores and the memory both allow a few microseconds, in
// f32 the FMA units a few tens. What a kernel loses here it loses to
// latency: K is long (8 to 32 slices of 128 bytes a weight row), M*N is
// small (160-400 tiles of 64 x 64 for 132 SMs), and the A operand does not
// exist in memory.
//
// Design.
//   Tiles. A block owns 64 consecutive pixels (in b, oh, ow order) by BN
//     output channels; the wrapper (ops/convbn.py:launch_geometry) picks BN
//     and the slices a stage so that every SM has work and all blocks are
//     on the card at once, and passes the whole launch geometry in.
//   A, staged raw. The 4x4 windows of 64 consecutive pixels cover, for one
//     input channel, a short run of whole input rows (counted over the
//     batch as padded rows v = b*(H + 2p) + ih + p, they are consecutive).
//     A stage holds that run for the 4 or 8 (bf16) or 2 (f32) input
//     channels of its share of K, copied row by row with 16-byte cp.async;
//     the padding rows and columns are zeroed once and never written. No
//     im2col matrix is ever formed: element (pixel, k = ci*16 + kh*4 + kw)
//     is read from tile[ci][row(pixel) + kh][col(pixel) + kw]. A row's data
//     starts on a 16-byte boundary (cp.async needs it), so the pair (kw,
//     kw + 1) of a stride-2 window starts on an odd element: a fragment
//     register is two aligned 4-byte loads and a funnel shift.
//   B. A K slice of the weight is BN rows of 128 bytes, 16-byte cp.async
//     into the 128-byte-swizzled K-major layout wgmma reads (chunk c of row
//     n at n*128 + ((c ^ (n & 7)) << 4)); rows past C_out and chunks past K
//     are zero-filled by the copy.
//   A ring of kStages stages: the copies of the next slices are in flight
//     while slice k is multiplied; one barrier a slice. In bf16 the wgmma
//     of slice k stay in flight over that barrier and the fragment reads
//     of slice k+1 (two sets of fragment registers).
//   bf16: wgmma.mma_async m64nBNk16 (bf16 -> f32), A from registers (a
//     k16 step is one input channel), B from shared memory through a
//     descriptor, accumulators in registers; one warpgroup a block. A
//     stage is one or two such B tiles (4 or 8 channels, 64 or 128 k): with
//     a long K, two halve the barriers and waits, which cost more than the
//     products; with a short K, one leaves room for more blocks on an SM.
//   f32: 256 threads, 4 pixels x 4 channels each, FMAs in (ci, kh, kw)
//     order out of the same stages. No TF32: the f32 path is held to the
//     CPU at 1e-4.
//   Epilogue. The accumulators pass through shared memory, channel-major;
//     each is rounded once (to nearest even) to y's type and stored as NCHW
//     y, threads on consecutive pixels of one channel; the sum and the sum
//     of squares of the ROUNDED values, the materialized y as the TPU kernel
//     takes them (:125-130), are summed over the tile's pixels in a fixed
//     order and written as one row of per-tile partials, which the wrapper
//     sums over the tiles (one small reduction, in a fixed order). The
//     kernel keeps no state between launches. No float atomics, no split K:
//     the sums are the same from run to run.
//   Shapes off the fast path (rows of x that are not whole 16-byte chunks)
//     stage the same tile with plain loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;           // output pixels a block: wgmma's M
constexpr int kStages = 4;           // depth of the ring
static_assert(kStages >= 3, "the K loops wait on kStages - 3 groups");
constexpr int kRowBytes = 128;       // a B row of one K slice
constexpr int kLdC = kTileM + 4;     // Cs[channel][pixel], f32
constexpr int kBf16Threads = 128;    // one warpgroup
constexpr int kF32Threads = 256;     // 16 x 16 threads of 4 x 4
constexpr int kF32TileN = 64;

// The convolution and the launch geometry the wrapper chose.
struct Geometry {
  int B, Cin, H, W, Cout, stride, pad, OH, OW, tiles;
  int rs;       // elements from one staged row to the next
  int ch;       // elements from one staged channel to the next
  int lp;       // zero elements left of a staged row's data
  int vec;      // rows of x are whole, aligned 16-byte chunks
  int a_stage;  // bytes of a stage's A tile
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `bytes` (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Shared-memory writes of this thread become visible to wgmma's reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The staged input rows of a block: padded rows v0 .. v0 + rows - 1.
struct Tile {
  int m0, v0, rows;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g) {
  const int M = g.B * g.OH * g.OW, vh = g.H + 2 * g.pad;
  Tile t;
  t.m0 = blockIdx.x * kTileM;
  const int r0 = t.m0 / g.OW, r1 = min(t.m0 + kTileM - 1, M - 1) / g.OW;
  t.v0 = (r0 / g.OH) * vh + (r0 % g.OH) * g.stride;
  t.rows = (r1 / g.OH) * vh + (r1 % g.OH) * g.stride + 3 - t.v0 + 1;
  return t;
}

// Element offset, inside a staged channel, of the top-left of pixel mi's
// window (pixels past M read the last pixel's; their results are dropped).
__device__ __forceinline__ int window_offset(const Geometry& g, const Tile& t,
                                             int mi) {
  const int ohw = g.OH * g.OW;
  const int m = min(t.m0 + mi, g.B * ohw - 1);
  const int b = m / ohw, r = m - b * ohw, oh = r / g.OW, ow = r - oh * g.OW;
  const int v = b * (g.H + 2 * g.pad) + oh * g.stride - t.v0;
  return v * g.rs + ow * g.stride + g.lp - g.pad;
}

// Where each piece of a staged channel comes from: on the fast path one
// entry per 16-byte chunk (x = element offset in x's channel 0, or -1 for a
// padding row; y = element offset in the staged channel), else one per row.
template <typename T, int NT>
__device__ __forceinline__ int build_table(int2* table, const Geometry& g,
                                           const Tile& t) {
  constexpr int kEpc = 16 / sizeof(T);
  const int vh = g.H + 2 * g.pad, cpr = g.vec ? g.W / kEpc : 1;
  const int items = t.rows * cpr;
  for (int i = threadIdx.x; i < items; i += NT) {
    const int r = i / cpr, c = i - r * cpr, v = t.v0 + r;
    const int b = v / vh, ih = v - b * vh - g.pad;
    const bool real = ih >= 0 && ih < g.H;
    table[i] = make_int2(
        real ? (b * g.Cin * g.H + ih) * g.W + c * kEpc : -1,
        r * g.rs + (g.vec ? g.lp + c * kEpc : 0));
  }
  return items;
}

// The weight rows n0 .. n0 + BN - 1, K from k0 on: AT tiles of BN rows by
// 128 bytes, one after the other.
template <typename T, int BN, int NT, int AT>
__device__ __forceinline__ void stage_b(unsigned char* bs, const T* w, int n0,
                                        int k0, const Geometry& g) {
  constexpr int kEpc = 16 / sizeof(T);
  const int K = g.Cin * 16;
  for (int i = threadIdx.x; i < AT * BN * 8; i += NT) {
    const int at = i / (BN * 8), r = (i / 8) % BN, c = i % 8;
    const int n = n0 + r, k = k0 + (at * 8 + c) * kEpc;
    const bool ok = n < g.Cout && k < K;
    cp_async16(bs + (at * BN + r) * kRowBytes + ((c ^ (r & 7)) << 4),
               ok ? w + (long long)n * K + k : w, ok ? 16 : 0);
  }
}

// The input rows of the stage's channels c0 .. c0 + kc - 1.
template <typename T, int NT, int AT>
__device__ __forceinline__ void stage_a(T* as, const T* x, int c0,
                                        const int2* table, int items,
                                        const Geometry& g, const Tile& t) {
  constexpr int kc = AT * kRowBytes / (16 * sizeof(T));   // channels
  constexpr int lanes = NT / kc;                          // threads each
  const int c = threadIdx.x / lanes, l = threadIdx.x % lanes;
  if (c0 + c >= g.Cin) return;   // past K: the weights there are zero
  const T* xc = x + (long long)(c0 + c) * g.H * g.W;
  T* dst = as + c * g.ch;
  if (g.vec) {
    for (int i = l; i < items; i += lanes) {
      const int2 e = table[i];
      if (e.x >= 0) cp_async16(dst + e.y, xc + e.x, 16);
    }
  } else {
    const int n = t.rows * g.rs;
    for (int i = l; i < n; i += lanes) {
      const int r = i / g.rs, iw = i - r * g.rs - g.lp;
      const int src = table[r].x;
      dst[i] = (src >= 0 && iw >= 0 && iw < g.W) ? xc[src + iw]
                                                 : from_f32<T>(0.0f);
    }
  }
}

// Cs holds the tile's f32 accumulators, Cs[channel][pixel]. Round them to
// y's type, sum the rounded values per channel over the tile's pixels,
// write the tile's row of partials (part is (2, tiles, Cout)) and store y.
template <typename T, int BN, int NT>
__device__ __forceinline__ void epilogue(float* Cs, T* y, float* part,
                                         const Geometry& g) {
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * BN;
  const int ohw = g.OH * g.OW, M = g.B * ohw;
  const int mi = threadIdx.x % kTileM, m = m0 + mi;
  for (int nn = threadIdx.x / kTileM; nn < BN; nn += NT / kTileM) {
    const bool in = m < M && n0 + nn < g.Cout;
    Cs[nn * kLdC + mi] =
        in ? to_f32(from_f32<T>(Cs[nn * kLdC + mi])) : 0.0f;
  }
  __syncthreads();
  constexpr int kPer = NT / BN;            // threads a channel, neighbours
  constexpr int kRows = kTileM / kPer;     // pixels each sums, in order
  static_assert(kPer >= 1 && kPer <= 32 && NT % BN == 0, "threads");
  {
    const int nn = threadIdx.x / kPer, j = threadIdx.x % kPer;
    float s = 0.0f, q = 0.0f;
#pragma unroll 8
    for (int i = 0; i < kRows; ++i) {
      const float v = Cs[nn * kLdC + j * kRows + i];
      s += v;
      q += v * v;
    }
#pragma unroll
    for (int off = kPer / 2; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off, kPer);
      q += __shfl_down_sync(0xffffffffu, q, off, kPer);
    }
    if (j == 0 && n0 + nn < g.Cout) {
      part[(long long)blockIdx.x * g.Cout + n0 + nn] = s;
      part[((long long)g.tiles + blockIdx.x) * g.Cout + n0 + nn] = q;
    }
  }
  if (m < M) {
    const int b = m / ohw;
    T* yp = y + (long long)b * g.Cout * ohw + (m - b * ohw);
    for (int nn = threadIdx.x / kTileM; nn < BN && n0 + nn < g.Cout;
         nn += NT / kTileM)
      yp[(long long)(n0 + nn) * ohw] = from_f32<T>(Cs[nn * kLdC + mi]);
  }
}

// Dynamic shared memory from its first 1024-byte boundary: the B stages
// (each a multiple of 1024 bytes, as the swizzle wants), the A stages, then
// the staging table; the epilogue's Cs lies over the stages.
struct Smem {
  unsigned char* b;
  unsigned char* a;
  int2* table;
};

template <int BN, int AT>
__device__ __forceinline__ Smem carve(unsigned char* raw, const Geometry& g) {
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int ring = kStages * (AT * BN * kRowBytes + g.a_stage);
  const int cs = BN * kLdC * (int)sizeof(float);
  Smem s;
  s.b = base;
  s.a = base + kStages * AT * BN * kRowBytes;
  s.table = reinterpret_cast<int2*>(base + (ring > cs ? ring : cs));
  return s;
}

// Slice nx (if there is one) goes into its stage of the ring; a group is
// committed either way, so that the count of groups tells the slices.
template <typename T, int BN, int NT, int AT>
__device__ __forceinline__ void refill(const Smem& sm, const T* x, const T* w,
                                       const Geometry& g, const Tile& t,
                                       int items, int nx, int slices) {
  constexpr int kc = AT * kRowBytes / (16 * sizeof(T));
  constexpr int kk = AT * kRowBytes / sizeof(T);     // K elements a stage
  const int st = nx % kStages;
  if (nx < slices) {
    stage_b<T, BN, NT, AT>(sm.b + st * AT * BN * kRowBytes, w,
                           blockIdx.y * BN, nx * kk, g);
    stage_a<T, NT, AT>(reinterpret_cast<T*>(sm.a + st * g.a_stage), x,
                       nx * kc, sm.table, items, g, t);
  }
  cp_async_commit();
}

// Zeroes the A stages (their padding stays zero for the whole run; the B
// stages are written whole by every copy), builds the table and puts the
// first kStages - 1 slices in flight.
template <typename T, int BN, int NT, int AT>
__device__ __forceinline__ int prologue(const Smem& sm, const T* x, const T* w,
                                        const Geometry& g, const Tile& t,
                                        int slices) {
  uint4* z = reinterpret_cast<uint4*>(sm.a);
  for (int i = threadIdx.x; i < kStages * g.a_stage / 16; i += NT)
    z[i] = make_uint4(0, 0, 0, 0);
  const int items = build_table<T, NT>(sm.table, g, t);
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s)
    refill<T, BN, NT, AT>(sm, x, w, g, t, items, s, slices);
  return items;
}

// wgmma.mma_async m64nBNk16, bf16 x bf16 -> f32: A from registers (the
// m16k16 fragment of each warp, as mma.sync lays it out), B from shared
// memory (K-major, 128-byte swizzle), D += A * B.
template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Descriptor of a K-major B tile in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart; a k16 step further along K is 32
// bytes further in the start address.
__device__ __forceinline__ uint64_t b_descriptor(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int BN, int AT>
__global__ void __launch_bounds__(kBf16Threads)
conv_moments_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         __nv_bfloat16* __restrict__ y,
                         float* __restrict__ part, Geometry g) {
  using T = __nv_bfloat16;
  // a stage holds AT B tiles of 64 k: kc = 4 * AT channels
  constexpr int NT = kBf16Threads, kc = 4 * AT;
  extern __shared__ unsigned char raw[];
  const Smem sm = carve<BN, AT>(raw, g);
  const Tile t = tile_of(g);
  const int slices = (g.Cin + kc - 1) / kc;
  const int items = prologue<T, BN, NT, AT>(sm, x, w, g, t, slices);

  // The fragment of a k16 step (one channel) holds, for the thread's two
  // pixels p0 = 16*warp + lane/4 and p0 + 8, the pairs (kw0, kw0 + 1) of
  // window rows kh0 and kh0 + 2, kh0 = (lane % 4) / 2, kw0 = 2 * (lane % 2).
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int in_window = ((lane & 3) >> 1) * g.rs + 2 * (lane & 1);
  const int e0 = window_offset(g, t, p0) + in_window;
  const int e1 = window_offset(g, t, p0 + 8) + in_window;
  const int w0 = e0 >> 1, w1 = e1 >> 1, sh0 = (e0 & 1) * 16,
            sh1 = (e1 & 1) * 16;
  const int two_rows = g.rs, chw = g.ch >> 1;    // in 4-byte words: 2 rows

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  // the fragments of slice ks out of its stage
  auto fragments = [&](uint32_t (&a)[kc][4], int ks) {
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(
        sm.a + (ks % kStages) * g.a_stage);
#pragma unroll
    for (int c = 0; c < kc; ++c) {
      const uint32_t* p = aw + c * chw;
      a[c][0] = __funnelshift_r(p[w0], p[w0 + 1], sh0);
      a[c][1] = __funnelshift_r(p[w1], p[w1 + 1], sh1);
      a[c][2] = __funnelshift_r(p[w0 + two_rows], p[w0 + two_rows + 1], sh0);
      a[c][3] = __funnelshift_r(p[w1 + two_rows], p[w1 + two_rows + 1], sh1);
    }
  };
  // Slice ks: its products go off; while they run, slice ks + 1 is waited
  // for and its fragments are read; then the products are waited for, and
  // the stage of slice ks - 1 (every warp waited for its products before
  // this slice's barrier) takes slice ks + kStages - 1.
  auto step = [&](uint32_t (&a)[kc][4], uint32_t (&next)[kc][4], int ks) {
    const unsigned char* bs = sm.b + (ks % kStages) * AT * BN * kRowBytes;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kc; ++c)
      wgmma_rs<BN>(acc, a[c][0], a[c][1], a[c][2], a[c][3],
                   b_descriptor(bs + (c / 4) * BN * kRowBytes) + 2 * (c % 4));
    wgmma_commit();
    if (ks + 1 < slices) {
      cp_async_wait<kStages - 3>();
      fence_async_proxy();
      __syncthreads();
      fragments(next, ks + 1);
    }
    wgmma_wait();
    refill<T, BN, NT, AT>(sm, x, w, g, t, items, ks + kStages - 1, slices);
  };

  cp_async_wait<kStages - 2>();
  fence_async_proxy();
  __syncthreads();
  uint32_t a0[kc][4], a1[kc][4];
  fragments(a0, 0);
  for (int ks = 0; ks < slices; ks += 2) {
    step(a0, a1, ks);
    if (ks + 1 < slices) step(a1, a0, ks + 1);
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc[4j .. 4j+3]: channels 8j + 2*(lane % 4) + {0, 1} of pixels p0 (the
  // first two) and p0 + 8
  float* Cs = reinterpret_cast<float*>(sm.b);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = 8 * j + 2 * (lane & 3);
    Cs[n * kLdC + p0] = acc[4 * j];
    Cs[(n + 1) * kLdC + p0] = acc[4 * j + 1];
    Cs[n * kLdC + p0 + 8] = acc[4 * j + 2];
    Cs[(n + 1) * kLdC + p0 + 8] = acc[4 * j + 3];
  }
  __syncthreads();
  epilogue<T, BN, NT>(Cs, y, part, g);
}

__global__ void __launch_bounds__(kF32Threads)
conv_moments_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ y,
                        float* __restrict__ part, Geometry g) {
  constexpr int NT = kF32Threads, BN = kF32TileN, kc = 2;  // 32 k a slice
  extern __shared__ unsigned char raw[];
  const Smem sm = carve<BN, 1>(raw, g);
  const Tile t = tile_of(g);
  const int slices = (g.Cin + kc - 1) / kc;
  const int items = prologue<float, BN, NT, 1>(sm, x, w, g, t, slices);

  // pixels ty*4 + i, channels tx + 16*j: a quarter warp's 16-byte reads of
  // B then fall on 8 different rows, which the swizzle spreads over the banks
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) off[i] = window_offset(g, t, ty * 4 + i);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int ks = 0; ks < slices; ++ks) {
    // slice ks has landed for every thread, and the stage that slice
    // ks - 1 was read from is free: slice ks + kStages - 1 goes into it
    cp_async_wait<kStages - 2>();
    __syncthreads();
    refill<float, BN, NT, 1>(sm, x, w, g, t, items, ks + kStages - 1, slices);
    const int st = ks % kStages;
    const float* as = reinterpret_cast<const float*>(sm.a + st * g.a_stage);
    const unsigned char* bs = sm.b + st * BN * kRowBytes;
#pragma unroll
    for (int c = 0; c < kc; ++c) {
#pragma unroll
      for (int kh = 0; kh < 4; ++kh) {
        float bv[4][4], av[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = tx + 16 * j;
          const float4 b4 = *reinterpret_cast<const float4*>(
              bs + n * kRowBytes + (((c * 4 + kh) ^ (n & 7)) << 4));
          bv[j][0] = b4.x, bv[j][1] = b4.y, bv[j][2] = b4.z, bv[j][3] = b4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* p = as + c * g.ch + kh * g.rs + off[i];
#pragma unroll
          for (int kw = 0; kw < 4; ++kw) av[i][kw] = p[kw];
        }
#pragma unroll
        for (int kw = 0; kw < 4; ++kw)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(av[i][kw], bv[j][kw], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* Cs = reinterpret_cast<float*>(sm.b);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(&Cs[(tx + 16 * j) * kLdC + ty * 4]) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  __syncthreads();
  epilogue<float, BN, NT>(Cs, y, part, g);
}

int out_size(int in, int stride, int pad) {
  return (in + 2 * pad - 4) / stride + 1;
}

// Only the shapes the wrapper accepts (ops/convbn.py:supported) with the
// geometry it computes (launch_geometry), and every index inside int.
bool bad_geometry(const Geometry& g, int bf16, int tile_m, int bn, int atoms,
                  int stages) {
  const long long M = (long long)g.B * g.OH * g.OW;
  const int epc = bf16 ? 8 : 4;
  const bool conv_ok = (g.stride == 2 && g.pad == 1) ||
                       (g.stride == 1 && g.pad == 0);
  const bool bn_ok = bf16 ? ((bn == 32 || bn == 64) &&
                             (atoms == 1 || atoms == 2))
                          : (bn == kF32TileN && atoms == 1);
  return g.B < 1 || g.Cin < 1 || g.H < 4 || g.W < 4 || g.Cout < 1 ||
         !conv_ok || g.OH != out_size(g.H, g.stride, g.pad) ||
         g.OW != out_size(g.W, g.stride, g.pad) || tile_m != kTileM ||
         stages != kStages || !bn_ok ||
         g.tiles != (M + kTileM - 1) / kTileM ||
         g.lp != (g.pad ? epc : 0) || g.rs < g.W + g.lp || g.rs % 2 ||
         (g.vec && (g.W % epc || g.rs % epc)) || g.ch < g.rs ||
         g.ch % epc || g.a_stage % 16 ||
         (long long)g.B * g.Cin * g.H * g.W > 0x7fffffffLL ||
         M * g.Cout > 0x7fffffffLL ||
         (long long)g.Cin * 16 * g.Cout > 0x7fffffffLL ||
         (g.Cout + bn - 1) / bn > 65535;
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t st,
           const void* x, const void* w, void* y, void* part,
           const Geometry& g) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {(void*)&x, (void*)&w, (void*)&y, (void*)&part, (void*)&g};
  e = cudaLaunchKernel((const void*)kernel, grid, dim3((unsigned)threads),
                       args, (size_t)smem, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// x (B, Cin, H, W), w (Cout, Cin, 4, 4), y (B, Cout, OH, OW): contiguous, f32
// (bf16 = 0) or bf16 (bf16 = 1), x and w on 16-byte boundaries; part: (2,
// tiles, Cout) f32, the per-tile sums of y and of y * y. The rest is the
// result of ops/convbn.py:launch_geometry; more dynamic shared memory than
// the card has fails the launch. Returns the cudaError_t of the launch.
extern "C" int mvae_conv_moments(const void* x, const void* w, int bf16,
                                 void* y, void* part, int B, int Cin, int H,
                                 int W, int Cout, int stride, int pad, int OH,
                                 int OW, int tiles, int tile_m, int bn,
                                 int atoms, int stages, int rs, int ch,
                                 int lp, int vec, int a_stage, int smem,
                                 void* stream) {
  const Geometry g{B,  Cin,   H,  W,  Cout, stride, pad, OH,
                   OW, tiles, rs, ch, lp,   vec,    a_stage};
  if (bad_geometry(g, bf16, tile_m, bn, atoms, stages) || smem < 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)((Cout + bn - 1) / bn));
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16)
    return launch(conv_moments_f32_kernel, grid, kF32Threads, smem, st, x, w,
                  y, part, g);
  auto kernel = bn == 32 ? (atoms == 1 ? conv_moments_bf16_kernel<32, 1>
                                       : conv_moments_bf16_kernel<32, 2>)
                         : (atoms == 1 ? conv_moments_bf16_kernel<64, 1>
                                       : conv_moments_bf16_kernel<64, 2>);
  return launch(kernel, grid, kBf16Threads, smem, st, x, w, y, part, g);
}
