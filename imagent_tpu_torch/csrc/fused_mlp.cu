// Fused ConvNeXt MLP for Hopper (sm_90a): forward, backward, reduce.
//
// Replaces the two Pallas TPU kernels of imagent_tpu/ops/fused_mlp.py:
//   fused_mlp_fwd    -> _fwd_kernel (:113, via _mlp_chain :94), launched
//                       from _fused_fwd_impl (:183)
//   fused_mlp_bwd    -> _bwd_kernel (:122), launched from _fused_core_bwd
//   fused_mlp_reduce    (:220); the second launch sums the backward's
//                       per-block partial gradients
// One block of ConvNeXt: out = resid + gamma * (GELU(LN(h) W1 + b1) W2 + b2)
// over rows of the flattened (R, C) activations, W1 C x 4C, W2 4C x C.
//
// Numerics follow the TPU kernel: LayerNorm statistics in fp32 with a
// two-pass variance (mean of (h - mu)^2), GEMMs accumulate in fp32, GELU is
// exact (erf), and every GEMM operand that the TPU rounds to the compute
// dtype is rounded here at the same point (y1, GELU(a), dout * gamma, da).
// bf16 products are exact in fp32, so fp32 FMA reproduces the MXU's
// preferred_element_type=float32 products up to summation order.
//
// Blocks. The TPU runs a 1-D grid over row tiles in order and keeps W1, W2
// and the weight-gradient accumulators resident in VMEM across it. Here:
// * forward: each CUDA block owns kBMF = 32 rows. It takes the LN of its
//   rows into shared memory, then walks the 4C axis in chunks of kBNF = 32:
//   the W1 chunk is staged in shared memory, a = y1 W1[:, chunk] + b1 and
//   GELU(a) are formed for the chunk, then the W2 chunk replaces the W1
//   chunk and o += GELU(a) W2[chunk, :] accumulates in registers (each
//   thread 4 rows x C/32 columns). The 4C activation exists only one chunk
//   at a time, in shared memory; it never reaches device memory.
// * backward: S CUDA blocks, S a function of the shape alone, never of
//   the device (ops/fused_mlp.py splits(): as many 8 C^2 + 7 C fp32 slots as
//   fit 256 MiB, at least 128 and at most kMaxSplit, never more than the row
//   tiles). Block s owns row tiles s, s + S, s + 2S, ... of kBMB = 16 rows
//   and recomputes the chain chunk by chunk (kBNB = 16), keeping o and dy1
//   in registers; it writes dh for its rows and adds its rows' share of dW1,
//   dW2, db1, dgamma, dls and dlb into its own fp32 slot of a workspace (one
//   owner per slot element, so the adds need no atomics; the slot's old
//   values are loaded kBatch at a time so their latency overlaps).
//   fused_mlp_reduce sums the S slots in slot order (16-byte loads, 16
//   slots in flight per thread; see its section). A rerun is bitwise
//   identical.
// * ragged R is masked in place: rows past R load as zero (so they add
//   nothing to any gradient) and are never written.
// * C is a runtime value; the register tiles are instantiated for
//   C <= 32 * NJ, NJ in {1, 2, 3, 4, 6, 8, 12, 16, 24}, with the columns past
//   C zero-padded in shared memory. Shared memory is fp32 in both dtypes:
//   at C = 768 the forward and the backward take 200,832 bytes each, under
//   the 227 KB opt-in limit, so every ConvNeXt-T width fuses (the TPU's VMEM
//   rule leaves C = 768 unfused).
//
// What bounds it on an H100. Per row the MLP pair costs 16 C^2 flops forward
// and ~48 C^2 backward (with the recompute) against ~6 C bytes of bf16
// activations: 2.7 C flops per byte, 260 at C = 96, so the fused chain is
// at the tensor cores' balance point at stage 0 and compute-bound beyond
// it. This first version does the GEMMs as fp32 FMA loops over shared
// memory (no tensor cores), so its ceiling is the fp32 CUDA-core rate,
// and shared-memory bandwidth holds it below that. mma.sync / wgmma, TMA
// and double-buffered weight chunks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBMF = 32;       // forward rows per block
constexpr int kBNF = 32;       // forward 4C chunk
constexpr int kBMB = 16;       // backward rows per tile
constexpr int kBNB = 16;       // backward 4C chunk
constexpr int kMaxSplit = 1024;  // backward blocks = partial slots (at most)
constexpr int kBatch = 4;      // slot updates with their loads in flight
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr float kInvSqrt2Pi = 0.398942280401432703f;

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

// x rounded to T and widened back: the compute-dtype rounding of a GEMM
// operand.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float gelu(float a) {
  return 0.5f * a * (1.f + erff(a / kSqrt2));
}

__device__ __forceinline__ float gelu_grad(float a) {
  const float phi = expf(-0.5f * a * a) * kInvSqrt2Pi;
  return 0.5f * (1.f + erff(a / kSqrt2)) + a * phi;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One row's LayerNorm by one warp: h[row] -> dst[0, C) as
// round_to<T>(xn * ls + lb), dst[C, CP) = 0; returns (mu, rsig) in the
// out-parameters. Two-pass variance, as _ln_fwd.
template <typename T, int CP>
__device__ __forceinline__ void ln_row(const T* __restrict__ hr,
                                       const T* __restrict__ ls,
                                       const T* __restrict__ lb, float* dst,
                                       int C, float eps, float& mu,
                                       float& rsig) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(hr[c]);
    dst[c] = v;
    s += v;
  }
  mu = warp_sum(s) / C;
  float q = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = dst[c] - mu;
    q += d * d;
  }
  rsig = 1.f / sqrtf(warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32) {
    const float xn = (dst[c] - mu) * rsig;
    dst[c] = round_to<T>(xn * to_f(ls[c]) + to_f(lb[c]));
  }
  for (int c = C + lane; c < CP; c += 32) dst[c] = 0.f;
}

template <int NJ>
constexpr int fwd_smem_floats() {
  return kBMF * (32 * NJ + 1) + kBNF * 32 * NJ + kBMF * kBNF;
}

// Row pitch of the backward's C-wide tiles: a multiple of 4 floats, so
// the K = C products read them as float4, and 4 banks apart row to row.
template <int NJ>
__host__ __device__ constexpr int bwd_pitch() {
  return 32 * NJ + 4;
}

template <int NJ>
constexpr int bwd_smem_floats() {
  return (2 * kBMB + 2 * kBNB) * bwd_pitch<NJ>() + 3 * kBMB * kBNB + 2 * kBMB;
}

// ---------------------------------------------------------------- forward

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(const T* __restrict__ resid, const T* __restrict__ h,
                   const T* __restrict__ ls, const T* __restrict__ lb,
                   const T* __restrict__ w1, const T* __restrict__ b1,
                   const T* __restrict__ w2, const T* __restrict__ b2,
                   const T* __restrict__ gamma, T* __restrict__ out, int R,
                   int C, float eps) {
  constexpr int CP = 32 * NJ;
  constexpr int LDY = CP + 1;
  extern __shared__ float smem[];
  float* sY = smem;               // kBMF x LDY: y1 rounded to T
  float* sW = sY + kBMF * LDY;    // W1 chunk C x kBNF, then W2 chunk kBNF x CP
  float* sG = sW + kBNF * CP;     // kBMF x kBNF: GELU(a) rounded to T

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int tx = tid & 31;        // column lane
  const int ty = warp;            // rows ty * 4 .. ty * 4 + 3
  const int H = 4 * C;
  const long long row0 = (long long)blockIdx.x * kBMF;

  for (int r = warp; r < kBMF; r += kWarps) {
    const long long row = row0 + r;
    float* dst = sY + r * LDY;
    if (row < R) {
      float mu, rsig;
      ln_row<T, CP>(h + row * C, ls, lb, dst, C, eps, mu, rsig);
    } else {
      for (int c = tx; c < CP; c += 32) dst[c] = 0.f;
    }
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < H; n0 += kBNF) {
    __syncthreads();  // sY written / the last chunk's GEMM done with sW
    for (int i = tid; i < C * kBNF; i += kThreads) {
      const int k = i / kBNF;
      const int n = i - k * kBNF;
      sW[i] = to_f(w1[(long long)k * H + n0 + n]);
    }
    __syncthreads();
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < C; ++k) {
      const float w = sW[k * kBNF + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] += sY[(ty * 4 + i) * LDY + k] * w;
    }
    const float bias = to_f(b1[n0 + tx]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sG[(ty * 4 + i) * kBNF + tx] = round_to<T>(gelu(a[i] + bias));
    __syncthreads();  // sG complete; every thread done with the W1 chunk
    for (int i = tid; i < kBNF * CP; i += kThreads) {
      const int n = i / CP;
      const int c = i - n * CP;
      sW[i] = c < C ? to_f(w2[(long long)(n0 + n) * C + c]) : 0.f;
    }
    __syncthreads();
    for (int n = 0; n < kBNF; ++n) {
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = sG[(ty * 4 + i) * kBNF + n];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w = sW[n * CP + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += g[i] * w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = row0 + ty * 4 + i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 32 * j;
      if (c < C) {
        const float o = acc[i][j] + to_f(b2[c]);
        out[row * C + c] =
            from_f<T>(to_f(resid[row * C + c]) + to_f(gamma[c]) * o);
      }
    }
  }
}

// --------------------------------------------------------------- backward

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_kernel(const T* __restrict__ h, const T* __restrict__ ls,
                   const T* __restrict__ lb, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ w2,
                   const T* __restrict__ b2, const T* __restrict__ gamma,
                   const T* __restrict__ dout, T* __restrict__ dh,
                   float* __restrict__ ws, int R, int C, float eps) {
  constexpr int CP = 32 * NJ;
  constexpr int LD = bwd_pitch<NJ>();
  extern __shared__ __align__(16) float smem[];
  float* sY = smem;               // kBMB x LD: y1 rounded (xn at the end)
  float* sD = sY + kBMB * LD;     // kBMB x LD: dout * gamma rounded
  float* sW1 = sD + kBMB * LD;    // kBNB x LD: W1[:, chunk] transposed
  float* sW2 = sW1 + kBNB * LD;   // kBNB x LD: W2[chunk, :]
  float* sG = sW2 + kBNB * LD;    // kBMB x kBNB: GELU(a) rounded
  float* sA = sG + kBMB * kBNB;   // kBMB x kBNB: da rounded
  float* sAf = sA + kBMB * kBNB;  // kBMB x kBNB: da in fp32 (for db1)
  float* sMu = sAf + kBMB * kBNB; // kBMB
  float* sRs = sMu + kBMB;        // kBMB
  float* sRed = sW1;              // tile epilogue: 3 x kWarps x CP partials
  static_assert(3 * kWarps * CP <= 2 * kBNB * LD + 3 * kBMB * kBNB,
                "epilogue partials overflow the chunk buffers");

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int tx = tid & 31;
  const int ty = warp;            // rows ty * 2, ty * 2 + 1
  const int H = 4 * C;
  const int n_tiles = (R + kBMB - 1) / kBMB;

  float* slot = ws + (long long)blockIdx.x * (8LL * C * C + 7LL * C);
  float* gW1 = slot;                     // C x H
  float* gW2 = gW1 + (long long)C * H;   // H x C
  float* gB1 = gW2 + (long long)H * C;   // H
  float* gGam = gB1 + H;                 // C
  float* gLs = gGam + C;                 // C
  float* gLb = gLs + C;                  // C

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const bool first = t == (int)blockIdx.x;
    const long long row0 = (long long)t * kBMB;
    __syncthreads();  // the last tile's epilogue is done with sRed and sY
    for (int r = warp; r < kBMB; r += kWarps) {
      const long long row = row0 + r;
      float* y = sY + r * LD;
      float* d = sD + r * LD;
      if (row < R) {
        float mu, rsig;
        ln_row<T, CP>(h + row * C, ls, lb, y, C, eps, mu, rsig);
        for (int c = tx; c < C; c += 32)
          d[c] = round_to<T>(to_f(dout[row * C + c]) * to_f(gamma[c]));
        for (int c = C + tx; c < CP; c += 32) d[c] = 0.f;
        if (tx == 0) {
          sMu[r] = mu;
          sRs[r] = rsig;
        }
      } else {
        for (int c = tx; c < CP; c += 32) {
          y[c] = 0.f;
          d[c] = 0.f;
        }
        if (tx == 0) {
          sMu[r] = 0.f;
          sRs[r] = 0.f;
        }
      }
    }

    float o[2][NJ], dy[2][NJ];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        o[i][j] = 0.f;
        dy[i][j] = 0.f;
      }

    for (int n0 = 0; n0 < H; n0 += kBNB) {
      __syncthreads();  // sY/sD written / the last chunk's readers done
#pragma unroll
      for (int it = 0; it < CP * kBNB / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int c = i / kBNB;
        const int n = i - c * kBNB;
        sW1[n * LD + c] = c < C ? to_f(w1[(long long)c * H + n0 + n]) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < kBNB * CP / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int n = i / CP;
        const int c = i - n * CP;
        sW2[n * LD + c] = c < C ? to_f(w2[(long long)(n0 + n) * C + c]) : 0.f;
      }
      __syncthreads();
      {  // a = y1 W1[:, chunk] + b1 and dga = do W2[chunk, :]^T, one
         // (row, column) of the 16 x 16 chunk per thread, 4 k at a time
         // (the columns past C are zero in every operand)
        const int r = tid >> 4;
        const int n = tid & 15;
        const float4* y = reinterpret_cast<const float4*>(sY + r * LD);
        const float4* d = reinterpret_cast<const float4*>(sD + r * LD);
        const float4* w1r = reinterpret_cast<const float4*>(sW1 + n * LD);
        const float4* w2r = reinterpret_cast<const float4*>(sW2 + n * LD);
        float a = 0.f, dga = 0.f;
#pragma unroll 4
        for (int k4 = 0; k4 < CP / 4; ++k4) {
          const float4 yv = y[k4], wv = w1r[k4];
          const float4 dv = d[k4], vv = w2r[k4];
          a += yv.x * wv.x;
          a += yv.y * wv.y;
          a += yv.z * wv.z;
          a += yv.w * wv.w;
          dga += dv.x * vv.x;
          dga += dv.y * vv.y;
          dga += dv.z * vv.z;
          dga += dv.w * vv.w;
        }
        a += to_f(b1[n0 + n]);
        const float da = dga * gelu_grad(a);
        sG[r * kBNB + n] = round_to<T>(gelu(a));
        sA[r * kBNB + n] = round_to<T>(da);
        sAf[r * kBNB + n] = da;
      }
      __syncthreads();
      if (tid < kBNB) {  // db1: column sums of da, rows in order
        float s = 0.f;
        for (int r = 0; r < kBMB; ++r) s += sAf[r * kBNB + tid];
        float* p = gB1 + n0 + tid;
        *p = first ? s : *p + s;
      }
      // o += GELU(a) W2[chunk, :] and dy1 += da W1[:, chunk]^T
      for (int n = 0; n < kBNB; ++n) {
        const float g0 = sG[(ty * 2) * kBNB + n];
        const float g1 = sG[(ty * 2 + 1) * kBNB + n];
        const float a0 = sA[(ty * 2) * kBNB + n];
        const float a1 = sA[(ty * 2 + 1) * kBNB + n];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 32 * j;
          const float w2v = sW2[n * LD + c];
          const float w1v = sW1[n * LD + c];
          o[0][j] += g0 * w2v;
          o[1][j] += g1 * w2v;
          dy[0][j] += a0 * w1v;
          dy[1][j] += a1 * w1v;
        }
      }
      {  // dW1[:, chunk] += y1^T da: column n, rows c = tid/16 + 16k;
         // the slot's old values are loaded kBatch at a time
        constexpr int kStep = kThreads / kBNB;
        const int n = tid & 15;
        float av[kBMB];
#pragma unroll
        for (int r = 0; r < kBMB; ++r) av[r] = sA[r * kBNB + n];
        for (int c0 = tid >> 4; c0 < C; c0 += kStep * kBatch) {
          float old[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int c = c0 + kStep * u;
            old[u] = !first && c < C ? gW1[(long long)c * H + n0 + n] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int c = c0 + kStep * u;
            if (c < C) {
              float s = 0.f;
#pragma unroll
              for (int r = 0; r < kBMB; ++r) s += sY[r * LD + c] * av[r];
              gW1[(long long)c * H + n0 + n] = old[u] + s;
            }
          }
        }
      }
      {  // dW2[chunk, :] += GELU(a)^T do: rows n = 2 ty, 2 ty + 1
        const int n = 2 * ty;
        float g0[kBMB], g1[kBMB];
#pragma unroll
        for (int r = 0; r < kBMB; ++r) {
          g0[r] = sG[r * kBNB + n];
          g1[r] = sG[r * kBNB + n + 1];
        }
        float* p0 = gW2 + (long long)(n0 + n) * C;
        float* p1 = p0 + C;
        for (int c0 = tx; c0 < C; c0 += 32 * kBatch) {
          float old0[kBatch], old1[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int c = c0 + 32 * u;
            const bool load = !first && c < C;
            old0[u] = load ? p0[c] : 0.f;
            old1[u] = load ? p1[c] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int c = c0 + 32 * u;
            if (c < C) {
              float s0 = 0.f, s1 = 0.f;
#pragma unroll
              for (int r = 0; r < kBMB; ++r) {
                const float d = sD[r * LD + c];
                s0 += g0[r] * d;
                s1 += g1[r] * d;
              }
              p0[c] = old0[u] + s0;
              p1[c] = old1[u] + s1;
            }
          }
        }
      }
    }

    // Tile epilogue: dgamma, dls, dlb partials and dh (rows ty * 2 + i,
    // columns tx + 32 j).
    __syncthreads();  // every chunk's readers done: sW1/sW2 become sRed
    float* rGam = sRed;
    float* rLs = sRed + kWarps * CP;
    float* rLb = sRed + 2 * kWarps * CP;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 32 * j;
      rGam[ty * CP + c] = 0.f;
      rLs[ty * CP + c] = 0.f;
      rLb[ty * CP + c] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i;
      const long long row = row0 + r;
      const bool live = row < R;  // uniform across the warp
      const float mu = sMu[r];
      const float rsig = sRs[r];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 32 * j;
        if (live && c < C) {
          const float g = to_f(dout[row * C + c]);
          const float xn = (to_f(h[row * C + c]) - mu) * rsig;
          rGam[ty * CP + c] += g * (o[i][j] + to_f(b2[c]));
          rLs[ty * CP + c] += dy[i][j] * xn;
          rLb[ty * CP + c] += dy[i][j];
          const float dxn = dy[i][j] * to_f(ls[c]);
          s1 += dxn;
          s2 += dxn * xn;
          sY[r * LD + c] = xn;
        }
      }
      const float m1 = warp_sum(s1) / C;
      const float m2 = warp_sum(s2) / C;
      if (live) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 32 * j;
          if (c < C) {
            const float xn = sY[r * LD + c];
            const float dxn = dy[i][j] * to_f(ls[c]);
            dh[row * C + c] = from_f<T>(rsig * (dxn - m1 - xn * m2));
          }
        }
      }
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float sg = 0.f, sl = 0.f, sb = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sg += rGam[w * CP + c];
        sl += rLs[w * CP + c];
        sb += rLb[w * CP + c];
      }
      gGam[c] = first ? sg : gGam[c] + sg;
      gLs[c] = first ? sl : gLs[c] + sl;
      gLb[c] = first ? sb : gLb[c] + sb;
    }
  }
}

// ----------------------------------------------------------------- reduce

// out[i] = ws[0][i] + ws[1][i] + ... + ws[S-1][i], added in slot order (the
// order of reduce_plain, so the sum is bitwise equal to it and a rerun is
// bitwise identical). The kernel reads the (S, n) workspace once, so its
// bound is that read at HBM rate. Each thread owns one V-wide column group
// (float4 where n % 4 == 0 and both pointers are 16-byte aligned, as every
// ConvNeXt width gives; else float) and keeps the next 2 * kReduceDepth
// slots in flight in a ring of registers: each register is reloaded with
// the slot 2 * kReduceDepth ahead as soon as it has been added, so the
// loads stay outstanding while the adds go on in slot order, with no split
// of the slot axis (splitting it would reorder the adds). Loads bypass L1 and ask L2 for 256-byte
// fetches: every byte is read once. The grid is as many blocks as are
// resident on all SMs at once (the occupancy query), fewer when the columns
// run out; each block then strides over column chunks. Block size (64,
// against 128 and 256), depth (8, against 4 and 16) and load kind (against
// ld.global.cs and ld.global.nc) were chosen by timing the variants on an
// H100 at the four ConvNeXt-T widths.
constexpr int kReduceThreads = 64;
constexpr int kReduceDepth = 8;

__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];"
      : "=f"(v)
      : "l"(p));
  return v;
}
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Adds slots [k0, k0 + kReduceDepth) of the column group to acc in order,
// those below S, from buf, and refills each register as soon as it has
// been added with the slot kAhead further on (none where the group lies
// past the columns: !ok).
template <int kAhead, typename V>
__device__ __forceinline__ void add_and_refill(V& acc, V (&buf)[kReduceDepth],
                                               const V* p, long long pitch,
                                               int k0, int S, bool ok) {
#pragma unroll
  for (int j = 0; j < kReduceDepth; ++j) {
    if (k0 + j < S) add_to(acc, buf[j]);
    const int k = k0 + kAhead + j;
    if (ok && k < S) buf[j] = ld_stream(p + (long long)k * pitch);
  }
}

template <typename V>
__global__ void __launch_bounds__(kReduceThreads)
    mlp_reduce_kernel(const V* __restrict__ ws, V* __restrict__ out, int S,
                      long long units) {
  constexpr int kRing = 2 * kReduceDepth;  // slots in flight per thread
  const long long chunks = (units + kReduceThreads - 1) / kReduceThreads;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long i = c * kReduceThreads + threadIdx.x;
    const bool ok = i < units;  // the last chunk may run past the columns
    const V* p = ws + i;
    V acc, a[kReduceDepth], b[kReduceDepth];
    if (ok) acc = ld_stream(p);
#pragma unroll
    for (int j = 0; j < kReduceDepth; ++j) {
      if (ok && 1 + j < S) a[j] = ld_stream(p + (long long)(1 + j) * units);
      const int k = 1 + kReduceDepth + j;
      if (ok && k < S) b[j] = ld_stream(p + (long long)k * units);
    }
    for (int k0 = 1; k0 < S; k0 += kRing) {
      add_and_refill<kRing>(acc, a, p, units, k0, S, ok);
      add_and_refill<kRing>(acc, b, p, units, k0 + kReduceDepth, S, ok);
    }
    if (ok) out[i] = acc;
  }
}

template <typename V>
cudaError_t launch_reduce(const void* ws, void* out, int S, long long units,
                          cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mlp_reduce_kernel<V>, kReduceThreads, 0);
  if (e != cudaSuccess) return e;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long chunks = (units + kReduceThreads - 1) / kReduceThreads;
  const int grid = (int)(chunks < resident ? chunks : resident);
  mlp_reduce_kernel<V><<<grid, kReduceThreads, 0, s>>>(
      static_cast<const V*>(ws), static_cast<V*>(out), S, units);
  return cudaGetLastError();
}

// --------------------------------------------------------------- launchers

template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int NJ>
cudaError_t launch_fwd(const void* resid, const void* h, const void* ls,
                       const void* lb, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* gamma,
                       void* out, int R, int C, float eps, cudaStream_t s) {
  const int bytes = fwd_smem_floats<NJ>() * (int)sizeof(float);
  cudaError_t e = allow_smem(mlp_fwd_kernel<T, NJ>, bytes);
  if (e != cudaSuccess) return e;
  const int grid = (R + kBMF - 1) / kBMF;
  mlp_fwd_kernel<T, NJ><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(resid), static_cast<const T*>(h),
      static_cast<const T*>(ls), static_cast<const T*>(lb),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(gamma), static_cast<T*>(out), R, C, eps);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_bwd(const void* h, const void* ls, const void* lb,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* gamma, const void* dout,
                       void* dh, void* ws, int R, int C, float eps,
                       int splits, cudaStream_t s) {
  const int bytes = bwd_smem_floats<NJ>() * (int)sizeof(float);
  cudaError_t e = allow_smem(mlp_bwd_kernel<T, NJ>, bytes);
  if (e != cudaSuccess) return e;
  mlp_bwd_kernel<T, NJ><<<splits, kThreads, bytes, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(ls),
      static_cast<const T*>(lb), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<const T*>(gamma),
      static_cast<const T*>(dout), static_cast<T*>(dh),
      static_cast<float*>(ws), R, C, eps);
  return cudaGetLastError();
}

// The smallest instantiated NJ with 32 * NJ >= C; 0 when C is too wide.
int pick_nj(int C) {
  const int need = (C + 31) / 32;
  const int nj[] = {1, 2, 3, 4, 6, 8, 12, 16, 24};
  for (int v : nj)
    if (v >= need) return v;
  return 0;
}

#define NJ_DISPATCH(NJ_, CALL)                          \
  switch (NJ_) {                                        \
    case 1: { constexpr int kNJ = 1; return CALL; }     \
    case 2: { constexpr int kNJ = 2; return CALL; }     \
    case 3: { constexpr int kNJ = 3; return CALL; }     \
    case 4: { constexpr int kNJ = 4; return CALL; }     \
    case 6: { constexpr int kNJ = 6; return CALL; }     \
    case 8: { constexpr int kNJ = 8; return CALL; }     \
    case 12: { constexpr int kNJ = 12; return CALL; }   \
    case 16: { constexpr int kNJ = 16; return CALL; }   \
    case 24: { constexpr int kNJ = 24; return CALL; }   \
    default: return cudaErrorInvalidValue;              \
  }

template <typename T>
cudaError_t fwd_nj(const void* resid, const void* h, const void* ls,
                   const void* lb, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* gamma,
                   void* out, int R, int C, float eps, cudaStream_t s) {
  NJ_DISPATCH(pick_nj(C), (launch_fwd<T, kNJ>(resid, h, ls, lb, w1, b1, w2,
                                               b2, gamma, out, R, C, eps, s)))
}

template <typename T>
cudaError_t bwd_nj(const void* h, const void* ls, const void* lb,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* gamma, const void* dout,
                   void* dh, void* ws, int R, int C, float eps, int splits,
                   cudaStream_t s) {
  NJ_DISPATCH(pick_nj(C),
              (launch_bwd<T, kNJ>(h, ls, lb, w1, b1, w2, b2, gamma, dout, dh,
                                  ws, R, C, eps, splits, s)))
}

bool bad_geometry(int R, int C) { return R < 1 || C < 8 || C % 8 != 0; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the cudaError_t of
// its launch as an int: 0 on success. bf16 != 0 selects __nv_bfloat16
// operands, else float. Every tensor is contiguous; ws is fp32
// (splits, 8 C^2 + 7 C) and out of the reduce fp32 (n).
extern "C" {

int fused_mlp_fwd(const void* resid, const void* h, const void* ls,
                  const void* lb, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* gamma,
                  void* out, int R, int C, float eps, int bf16,
                  void* stream) {
  if (bad_geometry(R, C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)fwd_nj<__nv_bfloat16>(resid, h, ls, lb, w1, b1, w2, b2,
                                           gamma, out, R, C, eps, s)
              : (int)fwd_nj<float>(resid, h, ls, lb, w1, b1, w2, b2, gamma,
                                   out, R, C, eps, s);
}

int fused_mlp_bwd(const void* h, const void* ls, const void* lb,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* gamma, const void* dout,
                  void* dh, void* ws, int R, int C, float eps, int splits,
                  int bf16, void* stream) {
  const int n_tiles = (R + kBMB - 1) / kBMB;
  if (bad_geometry(R, C) || splits < 1 || splits > kMaxSplit ||
      splits > n_tiles)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)bwd_nj<__nv_bfloat16>(h, ls, lb, w1, b1, w2, b2, gamma,
                                           dout, dh, ws, R, C, eps, splits, s)
              : (int)bwd_nj<float>(h, ls, lb, w1, b1, w2, b2, gamma, dout,
                                   dh, ws, R, C, eps, splits, s);
}

int fused_mlp_reduce(const void* ws, void* out, int splits, long long n,
                     void* stream) {
  if (splits < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? (int)launch_reduce<float4>(ws, out, splits, n / 4, s)
             : (int)launch_reduce<float>(ws, out, splits, n, s);
}

// Dynamic shared memory per block, in bytes, of the larger of the forward
// and backward kernels at width C (0 when C is too wide for the register
// tiles): what ops/fused_mlp.py's smem_bytes must agree with.
int fused_mlp_smem_bytes(int C) {
  int f = 0, b = 0;
  switch (pick_nj(C)) {
#define SMEM_CASE(V)                                     \
  case V:                                                \
    f = fwd_smem_floats<V>();                            \
    b = bwd_smem_floats<V>();                            \
    break;
    SMEM_CASE(1) SMEM_CASE(2) SMEM_CASE(3) SMEM_CASE(4) SMEM_CASE(6)
    SMEM_CASE(8) SMEM_CASE(12) SMEM_CASE(16) SMEM_CASE(24)
#undef SMEM_CASE
    default: return 0;
  }
  return (int)sizeof(float) * (f > b ? f : b);
}

}  // extern "C"
