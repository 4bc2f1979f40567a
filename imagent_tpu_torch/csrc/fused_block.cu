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
// beside y2 in fp32. So each block owns one TH x TW output tile of one
// image, with every channel, and writes only that tile (no atomics; two
// runs are bitwise identical):
// * step 1: y1 over the tile's (TH + 2) x (TW + 2) halo, recomputed at the
//   halo pixels (a neighbour tile computes them too), 0 at pixels outside
//   the image; y1 stays in shared memory;
// * step 2: y2 over the tile, the 3x3 as 9 shifted products reading y1's
//   windows in shared memory, W3 streamed in chunks; y2 to shared memory;
// * step 3: out = relu(y2 Wc + bc + x), Wc streamed over C in chunks, x read
//   from device memory in the epilogue, the tile written once.
// The tile is a runtime choice of ops/fused_block.py (plan() for fp32,
// plan_tc() for bf16) against the kernel's own shared-memory formula.
// Ragged B, H, W, C and F are masked or zero-padded in place.
//
// What bounds it on an H100. The function moves x in and out once plus the
// weights: at B = 64, 0.06 ms of HBM traffic at 56 x 56 and 0.01 ms at
// 7 x 7, against 28 GFLOP at every ResNet-50 geometry, 0.028 ms at the bf16
// tensor-core peak; so layers 1-2 are bound by bytes and layers 3-4 by
// operations.
//
// bf16: block_tc_kernel, on the tensor cores. Every operand is bf16 already
// (x, the weights, and y1 and y2 after their rounding), so each product is
// mma.sync.m16n8k16 bf16 x bf16 with fp32 accumulation; only the order of
// summation differs from the plain version. y1 and y2 live in shared memory
// as bf16, pixel-major: each pixel's F channels contiguous, F zero-padded
// to FP (whole chunks of K), pitch FP + 8 so that the 8 rows an ldmatrix
// reads fall in 8 distinct bank groups. Each step is a block GEMM in
// passes of BM rows x BN columns: 8 warps in a WM x WN grid, each warp 64
// rows x 32 columns (4 x 4 mma tiles, 64 fp32 accumulators a lane), WN =
// 2, 4 or 8 per step as the plan chooses. K is staged kTcKC = 64 at a
// time as bf16 by cp.async through a ring of two stages, the next chunk
// in flight during one chunk's products; the ring runs on across pass and
// step boundaries (only x and the weights are staged, never y1 or y2):
// * step 1: M = halo pixels, N = F, K = C; the A chunk is x's halo rows
//   (zero outside the image and past C), the B chunk W1's;
// * step 2: M = tile pixels, N = F, K = 9 FP, the 3x3 as an implicit GEMM:
//   for tap (dy, dx) the A row of output pixel q is y1's halo pixel
//   (q / TW + dy) PW + q % TW + dx, which ldmatrix takes as one lane's row
//   address, so the shifted window costs an address and no copy;
// * step 3: M = tile pixels, N = C, K = FP; the epilogue adds bc and x
//   (loaded all at once after the products) in fp32.
// A warp runs only its 16-row tiles with rows (no branch inside a chunk:
// the chunk loop is instantiated per tile count); rows past M inside a
// tile read a clamped valid row and are not stored.
//
// Where the time goes. Every block streams all three weight matrices from
// L2 once per pass over its rows, and a block's rows are one tile: 28 to
// 392 output pixels. So the weights, not x, are most of the traffic (at
// 7 x 7, 9 MB a block), and each pass costs a turn of the ring and an
// epilogue. ops/fused_block.py plan_tc() chooses the tile, WN per step and
// a split of each tile over a cluster of two blocks by a model of both
// (warp steps, KB staged, passes; chip_smoke.py --block-plans fits it).
// With split = 2 (ResNet-50's 7 x 7 geometry: one whole image a cluster,
// 128 blocks) the two blocks share a tile and each computes half of every
// step's columns: half the weights each; after step 1 and step 2 each
// pulls the other half of y1's (y2's) channels from its peer's shared
// memory (distributed shared memory, between cluster barriers).
// C and F that are not multiples of 8 (or pointers not 16-byte aligned)
// stage through plain loads (block_tc_kernel<false>): the same kernel
// otherwise.
//
// fp32: bottleneck_kernel, the first version, unchanged: fp32 FMA loops
// over fp32 shared memory (no tensor cores). Each of the three is a block
// GEMM of at most kRows = 64 pixel rows by kCols = 64 channel columns per
// pass (256 threads, 4 x 4 fp32 accumulators each: rows ty + 16 i, columns
// tx + 16 j), with K staged kKC = 32 at a time; so (TH + 2) (TW + 2) <= 64
// and the tile is 6 x 6 or smaller (plan(): the fewest tiles whose shared
// memory, smem_floats() below, fits the opt-in limit). Its ceiling is the
// fp32 CUDA-core rate (67 TFLOP/s), held lower by the shared-memory loads,
// the synchronous weight staging and the halo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

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


// ---------------------------------------------------------------- bf16
// block_tc_kernel: the three block GEMMs on the tensor cores (see the
// header). Shared memory, bf16: y1 (P1 x LDF), y2 (Q x LDF), then a ring
// of kTcStages stages of kTcStage elements, each an x chunk (BM x kTcLDK,
// step 1 only) followed by a weight chunk (kTcKC x (BN + 8)).

constexpr int kTcThreads = 256;      // 8 warps
constexpr int kTcKC = 64;            // K per staged chunk
constexpr int kKSteps = kTcKC / 16;  // k16 steps per chunk
constexpr int kTcLDK = kTcKC + 8;
constexpr int kTcStages = 2;
// Step 1's x chunk: kXPieces 16-byte pieces a row, so one sweep of the
// block's threads stages kXRows rows, and a pass of at most 256 rows
// kXGroups sweeps.
constexpr int kXPieces = kTcKC / 8;
constexpr int kXRows = kTcThreads / kXPieces;
constexpr int kXGroups = 256 / kXRows;
// The largest stage of the three warp grids (WM x WN = 4 x 2, 2 x 4,
// 1 x 8): BM kTcLDK + kTcKC (BN + 8) with BM = 64 WM, BN = 32 WN.
constexpr int kTcStage = 256 * kTcLDK + kTcKC * (64 + 8);
static_assert(kTcStage >= 128 * kTcLDK + kTcKC * (128 + 8) &&
                  kTcStage >= 64 * kTcLDK + kTcKC * (256 + 8),
              "stage");

// F zero-padded to whole chunks, so that every chunk of steps 2 and 3 is
// kKSteps k16 steps (step 1's last chunk is zero-filled past C).
__host__ __device__ inline int tc_fp(int F) {
  return (F + kTcKC - 1) / kTcKC * kTcKC;
}

// Dynamic shared memory of one block_tc_kernel, in bytes: what
// ops/fused_block.py's smem_bytes(..., bfloat16) must agree with.
// The three steps' StepGeom, at the start of shared memory.
constexpr int kTcGeoBytes = 128;

__host__ __device__ inline int tc_smem_bytes(int TH, int TW, int F) {
  const int p1 = (TH + 2) * (TW + 2), q = TH * TW;
  return kTcGeoBytes +
         2 * ((p1 + q) * (tc_fp(F) + 8) + kTcStages * kTcStage);
}

// b[n], 0 past the n valid entries (the padded channels).
__device__ __forceinline__ float bias_at(const float* b, int n, int valid) {
  return n < valid ? b[n] : 0.f;
}

// x[c] and x[c + 1] (0 when !second) as a bf16 pair, c in the low half;
// one 4-byte load where C is even (the pair is then 4-byte aligned).
__device__ __forceinline__ uint32_t load_pair(const bf16* p, bool second,
                                              int C) {
  if (second && (C & 1) == 0)
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  const uint32_t lo = __ldg(reinterpret_cast<const unsigned short*>(p));
  const uint32_t hi =
      second ? __ldg(reinterpret_cast<const unsigned short*>(p + 1)) : 0u;
  return lo | hi << 16;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// Waits until at most N committed cp.async groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread block clusters (split = 2): the block's rank in its cluster, a
// barrier of the whole cluster (release / acquire of shared memory), and
// a copy of columns c0 .. c0 + w of a pitch-LDF array of `rows` rows from
// the same array in the peer block's shared memory (distributed shared
// memory; both blocks lay out their shared memory alike).
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void pull_columns(bf16* y, int rows, int LDF,
                                             int c0, int w, int peer) {
  const int per_row = w / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kTcThreads) {
    const int r = i / per_row, p = i - r * per_row;
    bf16* dst = y + r * LDF + c0 + 8 * p;
    uint32_t src;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(src)
                 : "r"(smem_u32(dst)), "r"(peer));
    uint4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(src)
                 : "memory");
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

struct TcArgs {
  const bf16 *x, *w1, *w3, *wc;
  const float *b1, *b3, *bc;
  bf16* out;
  int H, W, C, F, TH, TW, ntw, tiles;
  int split;  // 2: a cluster of two blocks shares each tile (see below)
  int wn[3];  // warps across the columns in steps 1, 2, 3: 2, 4 or 8
};

// One step's GEMM: M rows (step 1 the halo, else the tile), this block's
// columns N0 .. N of the step's (all of them, or one half when split), K
// per tap; WN warps across the columns and 8 / WN down the rows (the
// plan's choice per step: fewer passes over the rows stage the weights
// fewer times), nch chunks per pass. The three are computed once into
// shared memory (geo below).
struct StepGeom {
  int M, N0, N, K, WN, BM, BN, nkc, nch;
};
static_assert(3 * sizeof(StepGeom) <= kTcGeoBytes, "geo");

// Where one block's tile lies, and its shared-memory arrays. rank: the
// block's half of the columns (0 unless split); geo[s - 1]: step s.
struct TcTile {
  const bf16* xb;  // this image of x
  bf16* ob;        // this image of out
  bf16 *y1, *y2, *stage;
  const StepGeom* geo;
  int h0, w0, PW, P1, Q, FP, LDF, rank;
};

__device__ __forceinline__ StepGeom step_geom(int step, const TcArgs& a,
                                              const TcTile& t) {
  StepGeom g;
  g.M = step == 1 ? t.P1 : t.Q;
  const int cols = (step == 3 ? a.C : t.FP) / a.split;
  g.N0 = t.rank * cols;
  g.N = g.N0 + cols;
  g.K = step == 1 ? a.C : t.FP;
  g.WN = a.wn[step - 1];
  g.BM = 512 / g.WN;
  g.BN = 32 * g.WN;
  g.nkc = (g.K + kTcKC - 1) / kTcKC;
  g.nch = (step == 2 ? 9 : 1) * g.nkc;
  return g;
}

// One 16-byte piece of shared memory from 8 bf16 at src (n of them valid,
// the rest zero). VEC: a cp.async (n is 0 or 8); else plain loads.
template <bool VEC>
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int n) {
  if constexpr (VEC) {
    cp_async16(smem_u32(dst), src, n > 0);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned short lo =
          2 * e < n ? __bfloat16_as_ushort(src[2 * e]) : 0;
      const unsigned short hi =
          2 * e + 1 < n ? __bfloat16_as_ushort(src[2 * e + 1]) : 0;
      u[e] = lo | (uint32_t)hi << 16;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// Rows k0 .. k0 + kTcKC of a row-major K x N weight (leading dimension N),
// columns n0 .. n0 + BN, into dst (pitch BN + 8); zero past K or N.
template <bool VEC>
__device__ __forceinline__ void stage_w(bf16* dst, const bf16* w, int K,
                                        int N, int k0, int n0, int BN) {
  const int per_row = BN / 8;
  const int sh = 31 - __clz(per_row);
  for (int i = threadIdx.x; i < kTcKC * per_row; i += kTcThreads) {
    const int k = i >> sh, p = i & (per_row - 1);
    const int n = n0 + 8 * p;
    const int valid = k0 + k < K ? max(0, min(8, N - n)) : 0;
    stage8<VEC>(dst + k * (BN + 8) + 8 * p,
                valid ? w + (long long)(k0 + k) * N + n : w, valid);
  }
}

// The staging side of the ring: the next chunk to stage, in the order
// the passes consume them (steps 1, 2, 3; passes by rows, then columns;
// chunks by tap, then K), running kTcStages - 1 chunks ahead across pass
// and step boundaries. Only x and the weights are staged, never y1 or
// y2, so no chunk waits on an epilogue.
struct Producer {
  int step, m0, n0, s;
  int g;  // the chunk's index in the block's sequence: stage g % kTcStages
  // Step 1: the image pixel of each x row this thread stages (rows
  // tid / kXPieces + kXRows j of the pass), -1 outside the image.
  int xpix[kXGroups];

  __device__ __forceinline__ void rows(const TcArgs& a, const TcTile& t) {
#pragma unroll
    for (int j = 0; j < kXGroups; ++j) {
      xpix[j] = -1;
      const int p = m0 + threadIdx.x / kXPieces + kXRows * j;
      if (p < t.P1) {
        const int ih = t.h0 - 1 + p / t.PW, iw = t.w0 - 1 + p % t.PW;
        if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
          xpix[j] = ih * a.W + iw;
      }
    }
  }

  // Stages the next chunk (none past the last) as one cp.async group.
  template <bool VEC>
  __device__ __forceinline__ void next(const TcArgs& a, const TcTile& t) {
    if (step <= 3) {
      const StepGeom& G = t.geo[step - 1];
      bf16* buf = t.stage + (g % kTcStages) * kTcStage;
      if (step == 1) {
        const int p = threadIdx.x % kXPieces, r0 = threadIdx.x / kXPieces;
        const int k = s * kTcKC + 8 * p;
        const int kv = max(0, min(8, a.C - k));
#pragma unroll
        for (int j = 0; j < kXGroups; ++j) {
          if (kXRows * j < G.BM) {
            const int valid = xpix[j] >= 0 ? kv : 0;
            stage8<VEC>(buf + (r0 + kXRows * j) * kTcLDK + 8 * p,
                        valid ? t.xb + (long long)xpix[j] * a.C + k : t.xb,
                        valid);
          }
        }
        stage_w<VEC>(buf + G.BM * kTcLDK, a.w1, a.C, a.F, s * kTcKC, n0,
                     G.BN);
      } else if (step == 2) {
        const int tap = s / G.nkc, k0 = (s - tap * G.nkc) * kTcKC;
        stage_w<VEC>(buf, a.w3 + (long long)tap * a.F * a.F, a.F, a.F, k0,
                     n0, G.BN);
      } else {
        stage_w<VEC>(buf, a.wc, a.F, a.C, s * kTcKC, n0, G.BN);
      }
      if (++s == G.nch) {
        s = 0;
        n0 += G.BN;
        if (n0 >= G.N) {
          m0 += G.BM;
          if (m0 >= G.M) {
            m0 = 0;
            ++step;
          }
          n0 = step <= 3 ? t.geo[step - 1].N0 : 0;
          if (step == 1) rows(a, t);
        }
      }
    }
    cp_async_commit();  // empty past the last chunk: the count stays even
    ++g;
  }
};

// One chunk's products on a warp's MT 16-row tiles x 32 columns: A rows
// at arow + aoff (byte addresses, one per lane), the B chunk at bptr
// (pitch LDB).
template <int MT>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][4][4],
                                          const uint32_t (&arow)[4],
                                          uint32_t aoff, uint32_t bptr,
                                          int LDB) {
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    uint32_t b[2][4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      ldsm_x4_t(b[jj], bptr + (kk * 16 * LDB + 16 * jj) * 2);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t af[4];
      ldsm_x4(af, arow[i] + aoff + kk * 32);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        mma_bf16(acc[i][2 * jj], af, b[jj][0], b[jj][1]);
        mma_bf16(acc[i][2 * jj + 1], af, b[jj][2], b[jj][3]);
      }
    }
  }
}

// Step STEP over the whole tile: its passes of BM rows x BN columns, each
// over all of K from the ring (chunk g of the block's sequence in stage
// g % kTcStages), then the step's epilogue.
template <int STEP, bool VEC>
__device__ __forceinline__ void tc_step(const TcArgs& a, const TcTile& t,
                                        Producer& P, int& g) {
  const StepGeom G = t.geo[STEP - 1];
  const int LDB = G.BN + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G.WN, wn = warp - wm * G.WN;
  const int gid = lane >> 2, tig = lane & 3;
  const Lanes ln(lane);
  const uint32_t brow =
      smem_u32(t.stage + (STEP == 1 ? G.BM * kTcLDK : 0) + ln.t_row * LDB +
               32 * wn + ln.t_col);

  for (int m0 = 0; m0 < G.M; m0 += G.BM) {
    const int rw = m0 + 64 * wm;  // this warp's first row
    const int mt = max(0, min(4, (G.M - rw + 15) / 16));
    // This lane's ldmatrix row address in each of its 16-row tiles (step
    // 1: in a stage; step 2: at tap (0, 0)); rows past M read the last.
    uint32_t arow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(rw + 16 * i + ln.a_row, G.M - 1);
      if constexpr (STEP == 1) {
        arow[i] = smem_u32(t.stage + (r - m0) * kTcLDK + ln.a_col);
      } else if constexpr (STEP == 2) {
        const int p = (r / a.TW) * t.PW + r % a.TW;
        arow[i] = smem_u32(t.y1 + p * t.LDF + ln.a_col);
      } else {
        arow[i] = smem_u32(t.y2 + r * t.LDF + ln.a_col);
      }
    }
    for (int n0 = G.N0; n0 < G.N; n0 += G.BN) {
      float acc[4][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      // The bias of this lane's 8 columns, loaded before the products so
      // that its latency hides behind them.
      float2 bias[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 32 * wn + 8 * j + 2 * tig;
        const float* bv = STEP == 1 ? a.b1 : (STEP == 2 ? a.b3 : a.bc);
        const int nv = STEP == 3 ? a.C : a.F;
        bias[j] = make_float2(bias_at(bv, n, nv), bias_at(bv, n + 1, nv));
      }

      for (int s = 0; s < G.nch; ++s, ++g) {
        cp_async_wait<kTcStages - 2>();
        // Chunk g landed; every warp is done with chunk g - 1 (whose
        // stage the producer refills now) and with the last epilogue.
        __syncthreads();
        P.next<VEC>(a, t);
        const int tap = STEP == 2 ? s / G.nkc : 0;
        const int k0 = (s - tap * G.nkc) * kTcKC;
        const uint32_t sbuf = (g % kTcStages) * kTcStage * 2;
        // The A chunk's byte offset from arow: step 1 the stage, step 2
        // the tap's shift and the channel offset, step 3 the channel
        // offset.
        uint32_t aoff;
        if constexpr (STEP == 1)
          aoff = sbuf;
        else if constexpr (STEP == 2)
          aoff = (((tap / 3) * t.PW + tap % 3) * t.LDF + k0) * 2;
        else
          aoff = k0 * 2;
        const uint32_t bptr = brow + sbuf;
        switch (mt) {  // this warp's 16-row tiles: no branch inside
          case 4: mma_chunk<4>(acc, arow, aoff, bptr, LDB); break;
          case 3: mma_chunk<3>(acc, arow, aoff, bptr, LDB); break;
          case 2: mma_chunk<2>(acc, arow, aoff, bptr, LDB); break;
          case 1: mma_chunk<1>(acc, arow, aoff, bptr, LDB); break;
          default: break;
        }
      }

      // Epilogue: fragment (i, j) holds rows rw + 16 i + gid (+ 8) and
      // columns n0 + 32 wn + 8 j + 2 tig (+ 1). Step 3 first loads the
      // residual x at all of this lane's outputs (bf16 pairs, 0 where
      // nothing is stored), every load in flight before the first use.
      uint32_t res[STEP == 3 ? 4 : 1][2][4];
      if constexpr (STEP == 3) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = rw + 16 * i + gid + 8 * hr;
            const int oh = t.h0 + r / a.TW, ow = t.w0 + r % a.TW;
            const bool ok = i < mt && r < G.M && oh < a.H && ow < a.W;
            const long long base = ((long long)oh * a.W + ow) * a.C;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = n0 + 32 * wn + 8 * j + 2 * tig;
              res[i][hr][j] =
                  ok && c < a.C ? load_pair(t.xb + base + c, c + 1 < a.C, a.C)
                                : 0u;
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= mt) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = rw + 16 * i + gid + 8 * hr;
          if (r >= G.M) continue;
          if constexpr (STEP == 1 || STEP == 2) {
            bool inside = true;  // step 1: y1 is 0 outside the image
            if constexpr (STEP == 1) {
              const int ih = t.h0 - 1 + r / t.PW, iw = t.w0 - 1 + r % t.PW;
              inside = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
            }
            bf16* y = (STEP == 1 ? t.y1 : t.y2) + r * t.LDF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = n0 + 32 * wn + 8 * j + 2 * tig;
              if (n >= G.N) continue;
              const float v0 = fmaxf(acc[i][j][2 * hr] + bias[j].x, 0.f);
              const float v1 = fmaxf(acc[i][j][2 * hr + 1] + bias[j].y, 0.f);
              *reinterpret_cast<uint32_t*>(y + n) =
                  inside ? pack_bf16(v0, v1) : 0u;
            }
          } else {
            const int oh = t.h0 + r / a.TW, ow = t.w0 + r % a.TW;
            if (oh >= a.H || ow >= a.W) continue;
            bf16* o = t.ob + ((long long)oh * a.W + ow) * a.C;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = n0 + 32 * wn + 8 * j + 2 * tig;
              if (c >= G.N) continue;
              const float2 xr = unpack_bf16(res[i][hr][j]);
              const uint32_t v =
                  pack_bf16(fmaxf(acc[i][j][2 * hr] + bias[j].x + xr.x, 0.f),
                            fmaxf(acc[i][j][2 * hr + 1] + bias[j].y + xr.y,
                                  0.f));
              if (c + 1 < a.C && (a.C & 1) == 0) {
                *reinterpret_cast<uint32_t*>(o + c) = v;
              } else {
                o[c] = __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
                if (c + 1 < a.C)
                  o[c + 1] = __ushort_as_bfloat16((unsigned short)(v >> 16));
              }
            }
          }
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kTcThreads, 1)
    block_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  TcTile t;
  t.FP = tc_fp(a.F);
  t.LDF = t.FP + 8;
  t.PW = a.TW + 2;
  t.P1 = (a.TH + 2) * t.PW;
  t.Q = a.TH * a.TW;
  StepGeom* geo = reinterpret_cast<StepGeom*>(smem_tc);
  t.geo = geo;
  t.y1 = reinterpret_cast<bf16*>(smem_tc + kTcGeoBytes);
  t.y2 = t.y1 + t.P1 * t.LDF;
  t.stage = t.y2 + t.Q * t.LDF;
  t.rank = a.split == 2 ? cluster_rank() : 0;
  const int blk = blockIdx.x / a.split;
  const int b = blk / a.tiles, tile = blk % a.tiles;
  t.h0 = (tile / a.ntw) * a.TH;
  t.w0 = (tile % a.ntw) * a.TW;
  const long long img = (long long)b * a.H * a.W * a.C;
  t.xb = a.x + img;
  t.ob = a.out + img;
  if (threadIdx.x < 3) geo[threadIdx.x] = step_geom(threadIdx.x + 1, a, t);
  __syncthreads();

  Producer P;
  P.step = 1;
  P.m0 = P.s = P.g = 0;
  P.n0 = t.geo[0].N0;
  P.rows(a, t);
  for (int i = 0; i < kTcStages - 1; ++i) P.next<VEC>(a, t);
  int g = 0;
  const int half = t.FP / 2, peer = t.rank ^ 1;
  // step 1: y1 = round(relu(x W1 + b1)) over the halo, 0 outside the image
  tc_step<1, VEC>(a, t, P, g);
  if (a.split == 2) {  // the other half of y1's channels from the peer
    cluster_sync();
    pull_columns(t.y1, t.P1, t.LDF, peer * half, half, peer);
  }
  // step 2: y2 = round(relu(3x3(y1) + b3)) over the tile
  tc_step<2, VEC>(a, t, P, g);
  if (a.split == 2) {  // the other half of y2's; the peer is done with y1
    cluster_sync();
    pull_columns(t.y2, t.Q, t.LDF, peer * half, half, peer);
  }
  // step 3: out = round(relu(y2 Wc + bc + x)) over the tile
  tc_step<3, VEC>(a, t, P, g);
  if (a.split == 2) cluster_sync();  // the peer is done reading y2 here
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t launch_tc(const void* x, const void* w1, const void* b1,
                      const void* w3, const void* b3, const void* wc,
                      const void* bc, void* out, int B, int H, int W, int C,
                      int F, int TH, int TW, int split, const int (&wn)[3],
                      cudaStream_t s) {
  if (split != 1 && (split != 2 || C % 64 != 0))
    return cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (wn[i] != 2 && wn[i] != 4 && wn[i] != 8) return cudaErrorInvalidValue;
  const int bytes = tc_smem_bytes(TH, TW, F);
  const bool vec = C % 8 == 0 && F % 8 == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(w3) && aligned16(wc);
  const auto kernel = vec ? block_tc_kernel<true> : block_tc_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int nth = (H + TH - 1) / TH, ntw = (W + TW - 1) / TW;
  const int tiles = nth * ntw;
  const long long grid = (long long)B * tiles * split;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  TcArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w1 = static_cast<const bf16*>(w1);
  a.w3 = static_cast<const bf16*>(w3);
  a.wc = static_cast<const bf16*>(wc);
  a.b1 = static_cast<const float*>(b1);
  a.b3 = static_cast<const float*>(b3);
  a.bc = static_cast<const float*>(bc);
  a.out = static_cast<bf16*>(out);
  a.H = H;
  a.W = W;
  a.C = C;
  a.F = F;
  a.TH = TH;
  a.TW = TW;
  a.ntw = ntw;
  a.tiles = tiles;
  a.split = split;
  for (int i = 0; i < 3; ++i) a.wn[i] = wn[i];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split == 2 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). fused_block returns the
// cudaError_t of its launch as an int: 0 on success. bf16 != 0 launches
// block_tc_kernel on __nv_bfloat16 x, weights and out; else the fp32
// bottleneck_kernel on float. The biases are float. Every tensor is
// contiguous; TH x TW is the output tile (plan_tc() for bf16, plan() for
// fp32); split (bf16 only; 1 for fp32) is the blocks per tile, 1 or 2,
// and wn1 .. wn3 (bf16 only) the warps across the columns of each step.
extern "C" {

int fused_block(const void* x, const void* w1, const void* b1, const void* w3,
                const void* b3, const void* wc, const void* bc, void* out,
                int B, int H, int W, int C, int F, int TH, int TW, int split,
                int wn1, int wn2, int wn3, int bf16, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || F < 1 || TH < 1 || TW < 1 ||
      (!bf16 && ((TH + 2) * (TW + 2) > kRows || split != 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wn[3] = {wn1, wn2, wn3};
  return bf16 ? (int)launch_tc(x, w1, b1, w3, b3, wc, bc, out, B, H, W, C, F,
                               TH, TW, split, wn, s)
              : (int)launch<float>(x, w1, b1, w3, b3, wc, bc, out, B, H, W, C,
                                   F, TH, TW, s);
}

// Dynamic shared memory per block, in bytes, for a TH x TW tile at width F,
// of the bf16 kernel (bf16 != 0) or the fp32 one.
int fused_block_smem_bytes(int TH, int TW, int F, int bf16) {
  return bf16 ? tc_smem_bytes(TH, TW, F)
              : smem_floats(TH, TW, F) * (int)sizeof(float);
}

}  // extern "C"
