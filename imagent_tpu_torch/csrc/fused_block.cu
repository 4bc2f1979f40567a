// Fused stride-1 identity ResNet bottleneck for Hopper (sm_90a), eval mode
// with BatchNorm folded into the convolutions.
//
// Replaces the Pallas TPU kernel of imagent_tpu/ops/fused_block.py:
//   fused_block -> _kernel (:45), launched from fused_bottleneck (:82, the
//                  pallas_call at :95)
// It computes, for x (B, H, W, C) NHWC, W1 (C, F), W3 (3, 3, F, F) HWIO,
// Wc (F, C) and fp32 biases b1 (F), b3 (F), bc (C):
//   y1  = round(relu(x W1 + b1))                      (1x1 reduce)
//   y2  = round(relu(sum over 9 taps of y1 window W3[dy, dx] + b3))
//   out = round(relu(y2 Wc + bc + x))                 (1x1 expand, residual)
// with every product accumulated in fp32, round() the rounding to x's
// dtype (float or __nv_bfloat16) exactly where the TPU kernel rounds (:59,
// :68, :73), and y1 zero outside the image: the TPU kernel pads y1, not x
// (:63), and with folded BN b1 is far from zero.
//
// Blocks. The TPU kernel keeps a whole batch tile's H x W extent in VMEM,
// so it needs no halos. A CUDA block has at most 227 KB of shared memory,
// and at ResNet-50's layer 4 (F = 512) one image's y1 alone would not fit
// beside y2. So each block owns one TH x TW output tile of one image, with
// every channel, and writes only that tile (no atomics; deterministic):
// * step 1: y1 over the tile's (TH + 2) x (TW + 2) halo, recomputed at the
//   halo pixels (a neighbour tile computes them too): x is staged kKC
//   channels at a time, W1 in kKC x kCols chunks; y1 goes to shared memory,
//   channel-major, 0 at pixels outside the image;
// * step 2: y2 over the tile, the 3x3 as 9 shifted products reading y1's
//   windows in shared memory, W3 streamed in chunks; y2 to shared memory;
// * step 3: out = relu(y2 Wc + bc + x), Wc streamed over C in chunks, x read
//   from device memory in the epilogue, the tile written once.
// Each of the three is a block GEMM of at most kRows = 64 pixel rows by
// kCols = 64 channel columns per pass (256 threads, 4 x 4 fp32 accumulators
// each: rows ty + 16 i, columns tx + 16 j), with K staged kKC = 32 at a
// time; so (TH + 2) (TW + 2) <= 64 and the tile is 6 x 6 or smaller. The
// tile is a runtime choice (ops/fused_block.py plan(): the fewest tiles
// whose shared memory, smem_floats() below, fits the opt-in limit). Ragged
// H and W are masked in place; B is the grid.
//
// What bounds it on an H100. The function moves x in and out once plus the
// weights: at B = 64, 0.06 ms of HBM traffic at 56 x 56 and 0.01 ms at
// 7 x 7, against 28 GFLOP at every ResNet-50 geometry, 0.028 ms at the bf16
// tensor-core peak; so layers 1-2 are bound by bytes and layers 3-4 by
// operations. This first version does its products as fp32 FMA loops over
// shared memory (no tensor cores), so its ceiling is the fp32 CUDA-core rate
// (67 TFLOP/s), held lower by the shared-memory loads (8 per 16 FMA), the
// synchronous weight staging, and the halo: step 1 runs a full 64-row pass
// for (TH + 2) (TW + 2) useful rows. mma.sync / wgmma, TMA and
// double-buffered weight chunks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kRows = 64;       // GEMM rows (pixels) per pass
constexpr int kCols = 64;       // GEMM columns (channels) per pass
constexpr int kKC = 32;         // K staged per chunk
constexpr int kAPitch = kRows + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Shared memory of one block, in floats: y1 (F x (P1 + 1)), y2
// (F x (Q + 1)), the staged x chunk (kKC x kAPitch) and weight chunk
// (kKC x kCols). What ops/fused_block.py's smem_bytes must agree with.
__host__ __device__ inline int smem_floats(int TH, int TW, int F) {
  const int p1 = (TH + 2) * (TW + 2), q = TH * TW;
  return F * (p1 + 1) + F * (q + 1) + kKC * kAPitch + kKC * kCols;
}

// Rows k0 .. k0 + kKC of a row-major K x N weight (leading dimension ld),
// columns n0 .. n0 + kCols, into sB as fp32; zero past K or N.
template <typename T>
__device__ __forceinline__ void stage_weights(float* __restrict__ sB,
                                              const T* __restrict__ w, int K,
                                              int N, int ld, int k0, int n0) {
  for (int e = threadIdx.x; e < kKC * kCols; e += kThreads) {
    const int k = e / kCols, n = e % kCols;
    float v = 0.f;
    if (k0 + k < K && n0 + n < N)
      v = to_f(w[(long long)(k0 + k) * ld + n0 + n]);
    sB[e] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w3,
                      const float* __restrict__ b3, const T* __restrict__ wc,
                      const float* __restrict__ bc, T* __restrict__ out,
                      int H, int W, int C, int F, int TH, int TW, int ntw,
                      int tiles) {
  extern __shared__ float smem[];
  const int PW = TW + 2;
  const int P1 = (TH + 2) * PW;   // halo pixels
  const int Q = TH * TW;          // output pixels
  const int LY1 = P1 + 1, LY2 = Q + 1;
  float* sY1 = smem;              // F x LY1: y1 by channel over the halo
  float* sY2 = sY1 + F * LY1;     // F x LY2: y2 by channel over the tile
  float* sA = sY2 + F * LY2;      // kKC x kAPitch: x chunk, by channel
  float* sB = sA + kKC * kAPitch; // kKC x kCols: weight chunk

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int h0 = (t / ntw) * TH, w0 = (t % ntw) * TW;
  const long long img = (long long)b * H * W * C;
  const T* __restrict__ xb = x + img;
  T* __restrict__ ob = out + img;

  // ---- step 1: y1 = round(relu(x W1 + b1)) over the halo
  for (int n0 = 0; n0 < F; n0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKC) {
      __syncthreads();  // the last chunk's products are done with sA, sB
      for (int e = tid; e < kRows * kKC; e += kThreads) {
        const int k = e % kKC, p = e / kKC;
        float v = 0.f;
        if (p < P1 && k0 + k < C) {
          const int ih = h0 - 1 + p / PW, iw = w0 - 1 + p % PW;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W)
            v = to_f(xb[((long long)ih * W + iw) * C + k0 + k]);
        }
        sA[k * kAPitch + p] = v;
      }
      stage_weights(sB, w1, C, F, F, k0, n0);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kKC; ++k) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[k * kAPitch + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = sB[k * kCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
      if (p >= P1) continue;
      const int ih = h0 - 1 + p / PW, iw = w0 - 1 + p % PW;
      const bool inside = ih >= 0 && ih < H && iw >= 0 && iw < W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = n0 + tx + 16 * j;
        if (f < F)
          sY1[f * LY1 + p] =
              inside ? round_to<T>(fmaxf(acc[i][j] + b1[f], 0.f)) : 0.f;
      }
    }
  }

  // ---- step 2: y2 = round(relu(3x3(y1) + b3)) over the tile
  for (int n0 = 0; n0 < F; n0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      int off[4];  // the halo pixel each of this thread's rows reads
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = ty + 16 * i < Q ? ty + 16 * i : 0;
        off[i] = (q / TW + dy) * PW + q % TW + dx;
      }
      for (int k0 = 0; k0 < F; k0 += kKC) {
        __syncthreads();  // sY1 written; the last chunk is done with sB
        stage_weights(sB, w3 + (long long)tap * F * F, F, F, F, k0, n0);
        __syncthreads();
        const int kn = min(kKC, F - k0);
        const float* y1 = sY1 + k0 * LY1;
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          float a[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = y1[k * LY1 + off[i]];
#pragma unroll
          for (int j = 0; j < 4; ++j) w[j] = sB[k * kCols + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
      if (q >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = n0 + tx + 16 * j;
        if (f < F)
          sY2[f * LY2 + q] = round_to<T>(fmaxf(acc[i][j] + b3[f], 0.f));
      }
    }
  }

  // ---- step 3: out = round(relu(y2 Wc + bc + x)) over the tile
  int row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) row[i] = ty + 16 * i < Q ? ty + 16 * i : 0;
  for (int n0 = 0; n0 < C; n0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < F; k0 += kKC) {
      __syncthreads();  // sY2 written; the last chunk is done with sB
      stage_weights(sB, wc, F, C, C, k0, n0);
      __syncthreads();
      const int kn = min(kKC, F - k0);
      const float* y2 = sY2 + k0 * LY2;
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = y2[k * LY2 + row[i]];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = sB[k * kCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = ty + 16 * i;
      if (q >= Q) continue;
      const int oh = h0 + q / TW, ow = w0 + q % TW;
      if (oh >= H || ow >= W) continue;
      const long long base = ((long long)oh * W + ow) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c < C) {
          const float v = acc[i][j] + bc[c] + to_f(xb[base + c]);
          ob[base + c] = from_f<T>(fmaxf(v, 0.f));
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1,
                   const void* w3, const void* b3, const void* wc,
                   const void* bc, void* out, int B, int H, int W, int C,
                   int F, int TH, int TW, cudaStream_t s) {
  const int bytes = smem_floats(TH, TW, F) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const int nth = (H + TH - 1) / TH, ntw = (W + TW - 1) / TW;
  const int tiles = nth * ntw;
  const long long grid = (long long)B * tiles;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  bottleneck_kernel<T><<<(unsigned)grid, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<const T*>(wc),
      static_cast<const float*>(bc), static_cast<T*>(out), H, W, C, F, TH, TW,
      ntw, tiles);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). fused_block returns the
// cudaError_t of its launch as an int: 0 on success. bf16 != 0 selects
// __nv_bfloat16 for x, the weights and out, else float; the biases are
// float. Every tensor is contiguous.
extern "C" {

int fused_block(const void* x, const void* w1, const void* b1, const void* w3,
                const void* b3, const void* wc, const void* bc, void* out,
                int B, int H, int W, int C, int F, int TH, int TW, int bf16,
                void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || TH < 1 || TW < 1 ||
      (TH + 2) * (TW + 2) > kRows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)launch<__nv_bfloat16>(x, w1, b1, w3, b3, wc, bc, out, B,
                                           H, W, C, F, TH, TW, s)
              : (int)launch<float>(x, w1, b1, w3, b3, wc, bc, out, B, H, W, C,
                                   F, TH, TW, s);
}

// Dynamic shared memory per block, in bytes, for a TH x TW tile at width F.
int fused_block_smem_bytes(int TH, int TW, int F) {
  return smem_floats(TH, TW, F) * (int)sizeof(float);
}

}  // extern "C"
