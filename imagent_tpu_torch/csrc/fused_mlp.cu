// Fused ConvNeXt MLP for Hopper (sm_90a): forward, backward, reduce.
//
// Replaces the two Pallas TPU kernels of imagent_tpu/ops/fused_mlp.py:
//   fused_mlp_fwd    -> _fwd_kernel (:113, via _mlp_chain :94), launched
//                       from _fused_fwd_impl (:183)
//   fused_mlp_bwd    -> _bwd_kernel (:122), launched from _fused_core_bwd
//   fused_mlp_bwd_tc    (:220): fp32 in one kernel, bf16 in two
//   fused_mlp_wgrad     (row pass, then the weight-gradient pass); the
//   fused_mlp_reduce    reduce sums the per-slot partial gradients
// One block of ConvNeXt: out = resid + gamma * (GELU(LN(h) W1 + b1) W2 + b2)
// over rows of the flattened (R, C) activations, W1 C x 4C, W2 4C x C.
//
// Numerics follow the TPU kernel: LayerNorm statistics in fp32 with a
// two-pass variance (mean of (h - mu)^2), GEMMs accumulate in fp32, GELU is
// exact (erf), and every GEMM operand that the TPU rounds to the compute
// dtype is rounded here at the same point (y1, GELU(a), dout * gamma, da).
// bf16 products are exact in fp32, so the tensor cores' bf16 x bf16 -> fp32
// mma reproduces the MXU's preferred_element_type=float32 products up to
// summation order; db1, dgamma, dls and dlb are fp32 sums of unrounded
// values in both designs.
//
// What bounds it on an H100. Per row the MLP pair costs 16 C^2 flops forward
// and ~48 C^2 backward (with the recompute) against ~6 C bytes of bf16
// activations: 2.7 C flops per byte, 260 at C = 96, so the fused chain is
// at the tensor cores' balance point at stage 0 and compute-bound beyond
// it. Two designs share this file.
//
// bf16 (mlp_fwd_tc_kernel, mlp_bwd_tc_kernel, mlp_wgrad_kernel): tensor
// cores. Every product is mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 fed
// by ldmatrix (.trans for an operand stored with the summed axis as rows).
// * The row kernels (forward, and pass 1 of the backward): 8 warps own a
//   tile of BM rows (TcGeom: 128 rows at C <= 96, down to 32 forward and
//   16 backward at C = 768, so the C-wide fp32 accumulators stay within 96
//   registers a lane). The LayerNorm of the tile goes into shared memory as
//   bf16, then the 4C axis is walked in chunks of 32 columns: W1[:, chunk]
//   and W2[chunk, :] are staged as bf16 by cp.async (16-byte copies,
//   zero-filled past C), double-buffered where two stages fit in 227 KB
//   (all widths but C = 768), so the next chunk's copy overlaps this
//   chunk's math. Per chunk, each warp takes a 16-row strip of
//   a = y1 W1[:, chunk] (+ b1) on the tensor cores, forms GELU(a) on the
//   accumulator fragments and rounds it into a bf16 tile in shared memory,
//   from which o += GELU(a) W2[chunk, :] is accumulated in registers, each
//   warp owning 16 rows x CP / WN columns of o. The 4C activation never
//   reaches device memory. The forward adds b2, scales by gamma and adds
//   the residual in its epilogue.
// * Pass 1 of the backward does the same walk with dga = do W2[chunk, :]^T
//   beside a, then da = dga GELU'(a) (rounded into a second bf16 tile) and
//   dy1 += da W1[:, chunk]^T beside o. It writes dh, and per row tile the
//   fp32 partial sums of db1, dgamma, dls and dlb (each written once). It
//   also writes y1, dout * gamma (R x C) and GELU(a), da (R x 4C) as bf16:
//   the operands the TPU kernel feeds its dW products.
// * Pass 2 (mlp_wgrad_kernel): dW1 = y1^T da and dW2 = GELU(a)^T do, long-K
//   products over the rows on the tensor cores (4 warps, 64 x 64 fp32
//   output tiles, 64-row slabs double-buffered by cp.async). The rows are
//   split into S fixed ranges, S a function of the shape alone, never of
//   the device (ops/fused_mlp.py row_ranges: just enough tile x range
//   blocks to fill 132 SMs four deep). Each block writes its tile once into
//   the workspace slot of its range, and sums the row tiles' vector
//   partials of its range in order into the same slot. fused_mlp_reduce
//   then sums the S slots in slot order. Device memory sees the
//   intermediates once each way (40 R C bytes) and a workspace of tens of
//   MB; nothing is read-modified-written, and no float atomics are used:
//   a rerun is bitwise identical.
//
// fp32 (mlp_fwd_kernel, mlp_bwd_kernel): the first version, kept as it
// was: fp32 FMA loops over fp32 shared memory, the forward on kBMF = 32
// rows and kBNF = 32 hidden columns a chunk (each thread 4 rows x C/32
// columns of o in registers); the backward on S blocks (splits(): as many
// 8 C^2 + 7 C fp32 slots as fit 256 MiB, at least 128 and at most
// kMaxSplit, never more than the row tiles), block s owning row tiles
// s, s + S, ... of kBMB = 16 rows, recomputing the chain in kBNB = 16
// chunks and adding its rows' share of every gradient into its own slot.
//
// Both: ragged R is masked in place (rows past R load as zero, so they add
// nothing to any gradient, and are never written); C is a runtime multiple
// of 8, the tiles are instantiated for CP = 32 NJ >= C, NJ in {1, 2, 3, 4,
// 6, 8, 12, 16, 24}, with the columns past C zero in shared memory (the
// k16 mma needs its depth zero-padded). Every ConvNeXt-T width fuses (the
// TPU's VMEM rule leaves C = 768 unfused).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

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

// ------------------------------------------- tensor-core kernels (bf16)

constexpr int kTcThreads = 256;       // 8 warps
constexpr int kTcChunk = 32;          // hidden (4C) columns per chunk
constexpr int kTcSmemLimit = 232448;  // an H100's opt-in shared memory
constexpr int kRangeRows = 128;       // row ranges are multiples of this
constexpr int kWgTile = 64;           // weight-gradient output tile
constexpr int kWgRows = 64;           // weight-gradient rows per stage
constexpr int kWgThreads = 128;       // 4 warps of 32 x 32
constexpr int kWgLd = kWgTile + 8;
constexpr int kWgSmem = 2 * 2 * kWgRows * kWgLd * (int)sizeof(bf16);

__host__ __device__ constexpr int tc_smem(int p, int row_tile, int stage,
                                          int act, int f32, int stages) {
  return 2 * (p * row_tile + stages * stage + p * act) + 4 * f32;
}

// Geometry of the row kernels at padded width CP = 32 NJ. Warps form a
// WM x WN grid: warp (wm, wn) owns rows 16 wm .. + 16 and columns
// wn WC .. + WC of the C-wide accumulators (o, and dy1 in the backward),
// WC = CP / WN at most 192 columns forward and 96 backward (96 registers
// a lane). The GEMM1 strips (16 rows x SW chunk columns, a and dga
// together) are spread one per warp where there are 8. Rows are pitched
// 16 bytes past their width, so the 8 rows an ldmatrix reads fall in 8
// distinct bank groups.
template <int NJ, bool BWD>
struct TcGeom {
  static constexpr int CP = 32 * NJ;
  static constexpr int LDC = CP + 8;  // bf16 pitch of C-wide rows
  static constexpr int BN = kTcChunk;
  static constexpr int LDN = BN + 8;  // bf16 pitch of chunk-wide rows
  static constexpr int MAXW = BWD ? 96 : 192;
  static constexpr int WN = CP <= MAXW       ? 1
                            : CP <= 2 * MAXW ? 2
                            : CP <= 4 * MAXW ? 4
                                             : 8;
  static constexpr int WM = 8 / WN;
  static constexpr int BM = 16 * WM;
  static constexpr int WC = CP / WN;
  static constexpr int P = BWD ? 2 : 1;  // row tiles: y1 (and do)
  static constexpr int SW0 = WM * BN / 8;
  static constexpr int SW = SW0 < 8 ? 8 : (SW0 > BN ? BN : SW0);
  static constexpr int UNITS = WM * (BN / SW);
  static constexpr int ROW_TILE = BM * LDC;          // bf16
  static constexpr int STAGE = CP * LDN + BN * LDC;  // W1 chunk, W2 chunk
  static constexpr int ACT = BM * LDN;               // GELU(a) (and da)
  // fp32: db1 strips (WM x BN), mu and rsig (BM each), row sums (WN x BM
  // x 2), column sums (WM x 3 x CP)
  static constexpr int F32 =
      BWD ? WM * BN + 2 * BM + 2 * WN * BM + 3 * WM * CP : 0;
  static constexpr int STAGES =
      tc_smem(P, ROW_TILE, STAGE, ACT, F32, 2) <= kTcSmemLimit ? 2 : 1;
  static constexpr int SMEM = tc_smem(P, ROW_TILE, STAGE, ACT, F32, STAGES);
  static_assert(WC % 16 == 0, "accumulator columns in ldmatrix.x4 pairs");
  static_assert(SMEM <= kTcSmemLimit, "shared memory");
};

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a.b through a fresh accumulator: the tensor core rounds its sum
// toward zero, so a long K chain accumulated in it drifts; here each k16
// step's sum is added to c with one round-to-nearest fp32 add, as an FMA
// loop would. Used where the result is rounded to bf16 next (a and dga in
// the backward): the fewer fp32 differences from the plain version, the
// fewer values land on the other side of a bf16 rounding boundary.
__device__ __forceinline__ void mma_bf16_rn(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(t, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

template <bool RN>
__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  if constexpr (RN)
    mma_bf16_rn(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

// Two adjacent bf16 values (4-byte aligned) widened to fp32.
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Sum over the 8 lanes that hold one accumulator column's rows.
__device__ __forceinline__ float column_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

struct TcArgs {
  const bf16 *resid, *h, *ls, *lb, *w1, *b1, *w2, *b2, *gamma, *dout;
  bf16* out;                    // forward: the block output; backward: dh
  bf16 *y1c, *doc, *gac, *dac;  // backward: the weight-gradient operands
  float* vec;  // backward: (row tiles, 7 C) partials of db1, dgamma, dls, dlb
  int R, C;
  float eps;
};

// W1[:, n0 .. n0 + BN) (CP rows, those past C zero) and W2[n0 .. n0 + BN, :)
// (BN rows, columns past C zero) into one stage, as one cp.async group.
template <class G>
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* w1,
                                            const bf16* w2, int n0, int C) {
  constexpr int P1 = G::BN / 8;  // 16-byte pieces of a W1 chunk row
  const long long H = 4LL * C;
  for (int i = threadIdx.x; i < G::CP * P1; i += kTcThreads) {
    const int k = i / P1;
    const int p = i - k * P1;
    const bool ok = k < C;
    cp_async16(smem_u32(dst + k * G::LDN + p * 8),
               w1 + (ok ? k * H + n0 + p * 8 : 0), ok);
  }
  bf16* d2 = dst + G::CP * G::LDN;
  constexpr int P2 = G::CP / 8;
  for (int i = threadIdx.x; i < G::BN * P2; i += kTcThreads) {
    const int n = i / P2;
    const int p = i - n * P2;
    const bool ok = p * 8 < C;
    cp_async16(smem_u32(d2 + n * G::LDC + p * 8),
               w2 + (ok ? (long long)(n0 + n) * C + p * 8 : 0), ok);
  }
  cp_async_commit();
}

// The row kernels' body: the forward (BWD = false) or pass 1 of the
// backward, on the BM-row tile blockIdx.x.
template <int NJ, bool BWD>
__device__ __forceinline__ void mlp_tc_body(const TcArgs& a) {
  using G = TcGeom<NJ, BWD>;
  constexpr int CP = G::CP, LDC = G::LDC, BN = G::BN, LDN = G::LDN;
  constexpr int BM = G::BM, WM = G::WM, WN = G::WN, WC = G::WC;
  constexpr int NT = WC / 8;      // n8 tiles of a warp's accumulators
  constexpr int NT1 = G::SW / 8;  // n8 tiles of a GEMM1 strip
  constexpr int QS = BN / G::SW;  // strips across a chunk
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sY = reinterpret_cast<bf16*>(smem_tc);  // BM x LDC: y1 rounded
  bf16* sD = sY + G::ROW_TILE;       // BM x LDC: do rounded (backward)
  bf16* sW = sY + G::P * G::ROW_TILE;  // STAGES x (W1 chunk, W2 chunk)
  bf16* sG = sW + G::STAGES * G::STAGE;  // BM x LDN: GELU(a) rounded
  bf16* sDa = sG + G::ACT;               // BM x LDN: da rounded (backward)
  float* sDb = reinterpret_cast<float*>(sG + G::P * G::ACT);  // WM x BN
  float* sMu = sDb + WM * BN;        // BM
  float* sRs = sMu + BM;             // BM
  float* sRow = sRs + BM;            // WN x BM x 2
  float* sCol = sRow + 2 * WN * BM;  // WM x 3 x CP

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // accumulator rows gid and gid + 8
  const int tig = lane & 3;   // accumulator columns 2 tig, 2 tig + 1
  const Lanes ln(lane);
  const int R = a.R, C = a.C, H = 4 * C;
  const long long row0 = (long long)blockIdx.x * BM;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;

  stage_chunk<G>(sW, a.w1, a.w2, 0, C);

  // LayerNorm of the tile, one warp per row, two-pass variance (as
  // _ln_fwd); the backward also forms do = dout * gamma. Rows past R and
  // columns past C are zero.
  for (int r = warp; r < BM; r += kTcThreads / 32) {
    const long long row = row0 + r;
    bf16* y = sY + r * LDC;
    bf16* d = sD + r * LDC;
    if (row < R) {
      const bf16* hr = a.h + row * C;
      float v[NJ];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < C ? __bfloat162float(hr[c]) : 0.f;
        s += v[j];
      }
      const float mu = warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float dv = v[j] - mu;
        q += lane + 32 * j < C ? dv * dv : 0.f;
      }
      const float rsig = 1.f / sqrtf(warp_sum(q) / C + a.eps);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        bf16 yv = __float2bfloat16(0.f);
        if (c < C) {
          const float xn = (v[j] - mu) * rsig;
          yv = __float2bfloat16(xn * __bfloat162float(a.ls[c]) +
                                __bfloat162float(a.lb[c]));
          if constexpr (BWD) a.y1c[row * C + c] = yv;
        }
        y[c] = yv;
        if constexpr (BWD) {
          bf16 dv = __float2bfloat16(0.f);
          if (c < C) {
            dv = __float2bfloat16(__bfloat162float(a.dout[row * C + c]) *
                                  __bfloat162float(a.gamma[c]));
            a.doc[row * C + c] = dv;
          }
          d[c] = dv;
        }
      }
      if (BWD && lane == 0) {
        sMu[r] = mu;
        sRs[r] = rsig;
      }
    } else {
      for (int c = lane; c < CP; c += 32) {
        y[c] = __float2bfloat16(0.f);
        if constexpr (BWD) d[c] = __float2bfloat16(0.f);
      }
      if (BWD && lane == 0) {
        sMu[r] = 0.f;
        sRs[r] = 0.f;
      }
    }
  }

  float o[NT][4];
  float dy[BWD ? NT : 1][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[j][e] = 0.f;
      if constexpr (BWD) dy[j][e] = 0.f;
    }

  const int n_chunks = H / BN;
  for (int i = 0; i < n_chunks; ++i) {
    const int n0 = i * BN;
    const bf16* cW1 = sW + (G::STAGES == 2 ? (i & 1) : 0) * G::STAGE;
    const bf16* cW2 = cW1 + CP * LDN;
    cp_async_wait_all();
    __syncthreads();  // chunk i landed; every warp is done with chunk i - 1
    if (G::STAGES == 2 && i + 1 < n_chunks)
      stage_chunk<G>(sW + ((i + 1) & 1) * G::STAGE, a.w1, a.w2, n0 + BN, C);

    // GEMM1: a = y1 W1[:, chunk] (and dga = do W2[chunk, :]^T) on strips
    // of 16 rows x SW columns, then GELU(a) (and da) on the fragments.
    // The backward sums each k16 step in round to nearest (mma_bf16_rn).
    for (int u = warp; u < G::UNITS; u += kTcThreads / 32) {
      const int m = u / QS;
      const int q0 = (u - m * QS) * G::SW;
      float acc[NT1][4], accg[BWD ? NT1 : 1][4];
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] = 0.f;
          if constexpr (BWD) accg[j][e] = 0.f;
        }
#pragma unroll 2
      for (int kk = 0; kk < CP / 16; ++kk) {
        uint32_t ay[4], ad[4];
        ldsm_x4(ay, smem_u32(sY + (m * 16 + ln.a_row) * LDC + kk * 16 +
                             ln.a_col));
        if constexpr (BWD)
          ldsm_x4(ad, smem_u32(sD + (m * 16 + ln.a_row) * LDC + kk * 16 +
                               ln.a_col));
        if constexpr (NT1 >= 2) {
#pragma unroll
          for (int jj = 0; jj < NT1 / 2; ++jj) {
            uint32_t b[4];
            ldsm_x4_t(b, smem_u32(cW1 + (kk * 16 + ln.t_row) * LDN + q0 +
                                  jj * 16 + ln.t_col));
            mma_acc<BWD>(acc[2 * jj], ay, b[0], b[1]);
            mma_acc<BWD>(acc[2 * jj + 1], ay, b[2], b[3]);
            if constexpr (BWD) {
              ldsm_x4(b, smem_u32(cW2 + (q0 + jj * 16 + ln.b_row) * LDC +
                                  kk * 16 + ln.b_col));
              mma_acc<BWD>(accg[2 * jj], ad, b[0], b[1]);
              mma_acc<BWD>(accg[2 * jj + 1], ad, b[2], b[3]);
            }
          }
        } else {
          uint32_t b[2];
          ldsm_x2_t(b, smem_u32(cW1 + (kk * 16 + ln.t_row) * LDN + q0 +
                                ln.t_col));
          mma_acc<BWD>(acc[0], ay, b[0], b[1]);
          if constexpr (BWD) {
            ldsm_x2(b, smem_u32(cW2 + (q0 + ln.b_row) * LDC + kk * 16 +
                                ln.b_col));
            mma_acc<BWD>(accg[0], ad, b[0], b[1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT1; ++j) {
        const int n = q0 + 8 * j + 2 * tig;  // chunk column
        const float2 bias = ld2(a.b1 + n0 + n);
        float db0 = 0.f, db1 = 0.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = m * 16 + gid + 8 * hr;
          const float a0 = acc[j][2 * hr] + bias.x;
          const float a1 = acc[j][2 * hr + 1] + bias.y;
          const uint32_t gp = pack_bf16(gelu(a0), gelu(a1));
          *reinterpret_cast<uint32_t*>(sG + r * LDN + n) = gp;
          if constexpr (BWD) {
            const float d0 = accg[j][2 * hr] * gelu_grad(a0);
            const float d1 = accg[j][2 * hr + 1] * gelu_grad(a1);
            const uint32_t dp = pack_bf16(d0, d1);
            *reinterpret_cast<uint32_t*>(sDa + r * LDN + n) = dp;
            const long long row = row0 + r;
            if (row < R) {
              *reinterpret_cast<uint32_t*>(a.gac + row * H + n0 + n) = gp;
              *reinterpret_cast<uint32_t*>(a.dac + row * H + n0 + n) = dp;
            }
            db0 += d0;  // rows past R add 0: there y1 = do = 0, so da = 0
            db1 += d1;
          }
        }
        if constexpr (BWD) {
          db0 = column_sum(db0);
          db1 = column_sum(db1);
          if (gid == 0) {
            sDb[m * BN + n] = db0;
            sDb[m * BN + n + 1] = db1;
          }
        }
      }
    }
    __syncthreads();  // the GELU(a) / da tiles and db1 strips are complete
    if constexpr (BWD) {  // db1 of the chunk: the strips' sums in row order
      for (int n = tid; n < BN; n += kTcThreads) {
        float s = 0.f;
#pragma unroll
        for (int m = 0; m < WM; ++m) s += sDb[m * BN + n];
        a.vec[(long long)blockIdx.x * 7 * C + n0 + n] = s;
      }
    }

    // GEMM2: o += GELU(a) W2[chunk, :] (and dy1 += da W1[:, chunk]^T) on
    // this warp's 16 rows x WC columns.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t ag[4], aa[4];
      ldsm_x4(ag, smem_u32(sG + (wm * 16 + ln.a_row) * LDN + kk * 16 +
                           ln.a_col));
      if constexpr (BWD)
        ldsm_x4(aa, smem_u32(sDa + (wm * 16 + ln.a_row) * LDN + kk * 16 +
                             ln.a_col));
#pragma unroll
      for (int jj = 0; jj < WC / 16; ++jj) {
        const int c0 = wn * WC + jj * 16;
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cW2 + (kk * 16 + ln.t_row) * LDC + c0 +
                              ln.t_col));
        mma_bf16(o[2 * jj], ag, b[0], b[1]);
        mma_bf16(o[2 * jj + 1], ag, b[2], b[3]);
        if constexpr (BWD) {
          ldsm_x4(b, smem_u32(cW1 + (c0 + ln.b_row) * LDN + kk * 16 +
                              ln.b_col));
          mma_bf16(dy[2 * jj], aa, b[0], b[1]);
          mma_bf16(dy[2 * jj + 1], aa, b[2], b[3]);
        }
      }
    }
    if (G::STAGES == 1 && i + 1 < n_chunks) {
      __syncthreads();  // every warp is done with the only stage
      stage_chunk<G>(sW, a.w1, a.w2, n0 + BN, C);
    }
  }

  // Epilogues. This lane holds rows wm 16 + gid + 8 hr and columns
  // wn WC + 8 j + 2 tig + e (e = 0, 1) of o and dy1.
  if constexpr (!BWD) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long row = row0 + wm * 16 + gid + 8 * hr;
      if (row >= R) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * WC + 8 * j + 2 * tig;
        if (c < C) {  // C % 8 == 0: c + 1 < C too
          const float2 bb = ld2(a.b2 + c);
          const float2 g = ld2(a.gamma + c);
          const float2 res = ld2(a.resid + row * C + c);
          *reinterpret_cast<uint32_t*>(a.out + row * C + c) =
              pack_bf16(res.x + g.x * (o[j][2 * hr] + bb.x),
                        res.y + g.y * (o[j][2 * hr + 1] + bb.y));
        }
      }
    }
  } else {
    // dh = rsig (dxn - mean(dxn) - xn mean(dxn xn)), dxn = dy1 ls: each
    // row's sums over this warp's columns, then over the WN warps.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * 16 + gid + 8 * hr;
      const long long row = row0 + r;
      const float mu = sMu[r], rsig = sRs[r];
      float s1 = 0.f, s2 = 0.f;
      if (row < R) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = wn * WC + 8 * j + 2 * tig;
          if (c < C) {
            const float2 hv = ld2(a.h + row * C + c);
            const float2 lv = ld2(a.ls + c);
            const float dx0 = dy[j][2 * hr] * lv.x;
            const float dx1 = dy[j][2 * hr + 1] * lv.y;
            s1 += dx0 + dx1;
            s2 += dx0 * ((hv.x - mu) * rsig) + dx1 * ((hv.y - mu) * rsig);
          }
        }
      }
      s1 = quad_sum(s1);
      s2 = quad_sum(s2);
      if (tig == 0) {
        sRow[(wn * BM + r) * 2] = s1;
        sRow[(wn * BM + r) * 2 + 1] = s2;
      }
    }
    // dgamma = sum dout (o + b2), dls = sum dy1 xn and dlb = sum dy1 over
    // this warp's 16 rows, per column.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = wn * WC + 8 * j + 2 * tig;
      float cg[2] = {0.f, 0.f}, cl[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
      if (c < C) {
        const float2 bb = ld2(a.b2 + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm * 16 + gid + 8 * hr;
          const long long row = row0 + r;
          if (row < R) {
            const float mu = sMu[r], rsig = sRs[r];
            const float2 hv = ld2(a.h + row * C + c);
            const float2 gv = ld2(a.dout + row * C + c);
            const float y0 = dy[j][2 * hr], y1 = dy[j][2 * hr + 1];
            cg[0] += gv.x * (o[j][2 * hr] + bb.x);
            cg[1] += gv.y * (o[j][2 * hr + 1] + bb.y);
            cl[0] += y0 * ((hv.x - mu) * rsig);
            cl[1] += y1 * ((hv.y - mu) * rsig);
            cb[0] += y0;
            cb[1] += y1;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cg[e] = column_sum(cg[e]);
        cl[e] = column_sum(cl[e]);
        cb[e] = column_sum(cb[e]);
      }
      if (gid == 0) {
        float* col = sCol + wm * 3 * CP + c;
        col[0] = cg[0];
        col[1] = cg[1];
        col[CP] = cl[0];
        col[CP + 1] = cl[1];
        col[2 * CP] = cb[0];
        col[2 * CP + 1] = cb[1];
      }
    }
    __syncthreads();  // row sums and column sums of every warp are in
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm * 16 + gid + 8 * hr;
      const long long row = row0 + r;
      if (row >= R) continue;
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        m1 += sRow[(w * BM + r) * 2];
        m2 += sRow[(w * BM + r) * 2 + 1];
      }
      m1 /= C;
      m2 /= C;
      const float mu = sMu[r], rsig = sRs[r];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = wn * WC + 8 * j + 2 * tig;
        if (c < C) {
          const float2 hv = ld2(a.h + row * C + c);
          const float2 lv = ld2(a.ls + c);
          const float x0 = (hv.x - mu) * rsig, x1 = (hv.y - mu) * rsig;
          const float dx0 = dy[j][2 * hr] * lv.x;
          const float dx1 = dy[j][2 * hr + 1] * lv.y;
          *reinterpret_cast<uint32_t*>(a.out + row * C + c) =
              pack_bf16(rsig * (dx0 - m1 - x0 * m2),
                        rsig * (dx1 - m1 - x1 * m2));
        }
      }
    }
    float* v = a.vec + (long long)blockIdx.x * 7 * C + 4 * C;
    for (int c = tid; c < C; c += kTcThreads) {
      float sg = 0.f, sl = 0.f, sb = 0.f;
#pragma unroll
      for (int m = 0; m < WM; ++m) {
        sg += sCol[m * 3 * CP + c];
        sl += sCol[m * 3 * CP + CP + c];
        sb += sCol[m * 3 * CP + 2 * CP + c];
      }
      v[c] = sg;
      v[C + c] = sl;
      v[2 * C + c] = sb;
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(kTcThreads, 1)
    mlp_fwd_tc_kernel(const TcArgs a) {
  mlp_tc_body<NJ, false>(a);
}

template <int NJ>
__global__ void __launch_bounds__(kTcThreads, 1)
    mlp_bwd_tc_kernel(const TcArgs a) {
  mlp_tc_body<NJ, true>(a);
}

// Rows [k0, k0 + kWgRows) of X's columns [m0, m0 + 64) and Y's columns
// [c0, c0 + 64) into one stage, as one cp.async group; zero past row r1
// and past M / N.
__device__ __forceinline__ void stage_slab(bf16* sx, bf16* sy, const bf16* X,
                                           const bf16* Y, int M, int N,
                                           int m0, int c0, long long k0,
                                           long long r1) {
  constexpr int PIECES = kWgRows * kWgTile / 8;  // per operand
  for (int i = threadIdx.x; i < 2 * PIECES; i += kWgThreads) {
    const bool is_y = i >= PIECES;
    const int j = is_y ? i - PIECES : i;
    const int r = j / (kWgTile / 8);
    const int p = j - r * (kWgTile / 8);
    const long long row = k0 + r;
    const int col = (is_y ? c0 : m0) + p * 8;
    const int width = is_y ? N : M;
    const bool ok = row < r1 && col < width;
    const bf16* src = (is_y ? Y : X) + (ok ? row * width + col : 0);
    cp_async16(smem_u32((is_y ? sy : sx) + r * kWgLd + p * 8), src, ok);
  }
  cp_async_commit();
}

// Pass 2 of the bf16 backward. Block (t, s) computes the 64 x 64 output
// tile t of dW1 = y1^T da (C x 4C) or dW2 = GELU(a)^T do (4C x C) over the
// rows of range s, [s L, min(R, (s + 1) L)), and writes it into workspace
// slot s; the blocks of range s also sum the row kernel's vector partials
// of the range's row tiles, in tile order, into the slot's db1, dgamma,
// dls and dlb. out[m][n] = sum_r X[r][m] Y[r][n]: X's slab is the A
// operand stored depth-major, Y's the B operand (both ldmatrix.trans).
__global__ void __launch_bounds__(kWgThreads)
    mlp_wgrad_kernel(const bf16* __restrict__ y1c,
                     const bf16* __restrict__ doc,
                     const bf16* __restrict__ gac,
                     const bf16* __restrict__ dac,
                     const float* __restrict__ vec, float* __restrict__ ws,
                     int R, int C, int range_rows, int vec_rows) {
  __shared__ __align__(16) bf16 sX[2][kWgRows * kWgLd];
  __shared__ __align__(16) bf16 sY[2][kWgRows * kWgLd];
  const int H = 4 * C;
  const int tn_c = (C + kWgTile - 1) / kWgTile;
  const int tn_h = (H + kWgTile - 1) / kWgTile;
  const int tiles1 = tn_c * tn_h;
  int t = blockIdx.x;
  const int s = blockIdx.y;
  const long long slot = 8LL * C * C + 7LL * C;
  float* out = ws + s * slot;
  const bf16 *X, *Y;
  int M, N, tm, tn;
  if (t < tiles1) {  // dW1 = y1^T da, C x 4C
    X = y1c, Y = dac, M = C, N = H;
    tm = t / tn_h, tn = t - tm * tn_h;
  } else {  // dW2 = GELU(a)^T do, 4C x C
    t -= tiles1;
    X = gac, Y = doc, M = H, N = C;
    out += (long long)C * H;
    tm = t / tn_c, tn = t - tm * tn_c;
  }
  const int m0 = tm * kWgTile, c0 = tn * kWgTile;
  const long long r0 = (long long)s * range_rows;
  const long long r1 = r0 + range_rows < R ? r0 + range_rows : R;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const Lanes ln(lane);
  const int wy = warp >> 1, wx = warp & 1;  // 32 x 32 of the tile each

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nk = (int)((r1 - r0 + kWgRows - 1) / kWgRows);
  if (nk > 0) stage_slab(sX[0], sY[0], X, Y, M, N, m0, c0, r0, r1);
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {
      stage_slab(sX[buf ^ 1], sY[buf ^ 1], X, Y, M, N, m0, c0,
                 r0 + (long long)(kt + 1) * kWgRows, r1);
      cp_async_wait_1();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const bf16* cX = sX[buf];
    const bf16* cY = sY[buf];
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4_t(af[mi], smem_u32(cX + (kk * 16 + ln.b_row) * kWgLd +
                                   wy * 32 + mi * 16 + ln.b_col));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(cY + (kk * 16 + ln.t_row) * kWgLd + wx * 32 +
                              nj * 16 + ln.t_col));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before its refill
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wy * 32 + mi * 16 + gid + 8 * hr;
        const int n = c0 + wx * 32 + 8 * j + 2 * tig;
        if (m < M && n < N)  // N % 8 == 0: n + 1 < N too
          *reinterpret_cast<float2*>(out + (long long)m * N + n) =
              make_float2(acc[mi][j][2 * hr], acc[mi][j][2 * hr + 1]);
      }

  // The range's row tiles' vector partials, added in tile order.
  const long long t_lo = r0 / vec_rows;
  const long long t_hi = (r1 + vec_rows - 1) / vec_rows;
  float* vout = ws + s * slot + 8LL * C * C;
  for (int j = blockIdx.x * kWgThreads + tid; j < 7 * C;
       j += gridDim.x * kWgThreads) {
    float v = 0.f;
    for (long long tt = t_lo; tt < t_hi; ++tt) v += vec[tt * 7 * C + j];
    vout[j] = v;
  }
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

cudaError_t fwd_nj(const void* resid, const void* h, const void* ls,
                   const void* lb, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* gamma,
                   void* out, int R, int C, float eps, cudaStream_t s) {
  NJ_DISPATCH(pick_nj(C), (launch_fwd<float, kNJ>(resid, h, ls, lb, w1, b1,
                                                   w2, b2, gamma, out, R, C,
                                                   eps, s)))
}

cudaError_t bwd_nj(const void* h, const void* ls, const void* lb,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* gamma, const void* dout,
                   void* dh, void* ws, int R, int C, float eps, int splits,
                   cudaStream_t s) {
  NJ_DISPATCH(pick_nj(C),
              (launch_bwd<float, kNJ>(h, ls, lb, w1, b1, w2, b2, gamma, dout,
                                      dh, ws, R, C, eps, splits, s)))
}

template <int NJ, bool BWD>
cudaError_t launch_tc(const TcArgs& a, cudaStream_t s) {
  using G = TcGeom<NJ, BWD>;
  const int grid = (a.R + G::BM - 1) / G::BM;
  cudaError_t e;
  if constexpr (BWD) {
    e = allow_smem(mlp_bwd_tc_kernel<NJ>, G::SMEM);
    if (e != cudaSuccess) return e;
    mlp_bwd_tc_kernel<NJ><<<grid, kTcThreads, G::SMEM, s>>>(a);
  } else {
    e = allow_smem(mlp_fwd_tc_kernel<NJ>, G::SMEM);
    if (e != cudaSuccess) return e;
    mlp_fwd_tc_kernel<NJ><<<grid, kTcThreads, G::SMEM, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool BWD>
cudaError_t tc_nj(const TcArgs& a, cudaStream_t s) {
  NJ_DISPATCH(pick_nj(a.C), (launch_tc<kNJ, BWD>(a, s)))
}

// The row kernels' tile rows at width C (forward or backward); 0 when C is
// too wide.
int tc_rows(int C, bool bwd) {
  switch (pick_nj(C)) {
#define ROWS_CASE(V) \
  case V:            \
    return bwd ? TcGeom<V, true>::BM : TcGeom<V, false>::BM;
    ROWS_CASE(1) ROWS_CASE(2) ROWS_CASE(3) ROWS_CASE(4) ROWS_CASE(6)
    ROWS_CASE(8) ROWS_CASE(12) ROWS_CASE(16) ROWS_CASE(24)
#undef ROWS_CASE
    default: return 0;
  }
}

bool bad_geometry(int R, int C) { return R < 1 || C < 8 || C % 8 != 0; }

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the cudaError_t of
// its launch as an int: 0 on success. Every tensor is contiguous. fp32: ws is
// (splits, 8 C^2 + 7 C). bf16: every pointer is 16-byte aligned (cp.async);
// y1c and doc are (R, C), gac and dac (R, 4 C), vec fp32 (ceil(R / rows),
// 7 C) with rows = fused_mlp_tc_rows(C, 1), and ws fp32 (splits, 8 C^2 + 7 C)
// with splits = ceil(R / range_rows). The reduce's out is fp32 (n).
extern "C" {

// use_bf16 != 0 selects the tensor-core kernel on __nv_bfloat16 operands, else
// the fp32 kernel.
int fused_mlp_fwd(const void* resid, const void* h, const void* ls,
                  const void* lb, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* gamma,
                  void* out, int R, int C, float eps, int use_bf16,
                  void* stream) {
  if (bad_geometry(R, C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!use_bf16)
    return (int)fwd_nj(resid, h, ls, lb, w1, b1, w2, b2, gamma, out, R, C,
                       eps, s);
  const void* ptrs[] = {resid, h, ls, lb, w1, b1, w2, b2, gamma, out};
  for (const void* p : ptrs)
    if (misaligned(p)) return (int)cudaErrorMisalignedAddress;
  TcArgs a{};
  a.resid = static_cast<const bf16*>(resid);
  a.h = static_cast<const bf16*>(h);
  a.ls = static_cast<const bf16*>(ls);
  a.lb = static_cast<const bf16*>(lb);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const bf16*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const bf16*>(b2);
  a.gamma = static_cast<const bf16*>(gamma);
  a.out = static_cast<bf16*>(out);
  a.R = R;
  a.C = C;
  a.eps = eps;
  return (int)tc_nj<false>(a, s);
}

// The fp32 backward: dh and the S = splits partial slots in one kernel.
int fused_mlp_bwd(const void* h, const void* ls, const void* lb,
                  const void* w1, const void* b1, const void* w2,
                  const void* b2, const void* gamma, const void* dout,
                  void* dh, void* ws, int R, int C, float eps, int splits,
                  void* stream) {
  const int n_tiles = (R + kBMB - 1) / kBMB;
  if (bad_geometry(R, C) || splits < 1 || splits > kMaxSplit ||
      splits > n_tiles)
    return (int)cudaErrorInvalidValue;
  return (int)bwd_nj(h, ls, lb, w1, b1, w2, b2, gamma, dout, dh, ws, R, C,
                     eps, splits, static_cast<cudaStream_t>(stream));
}

// Pass 1 of the bf16 backward: dh, the weight-gradient operands and the
// row tiles' vector partials.
int fused_mlp_bwd_tc(const void* h, const void* ls, const void* lb,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, const void* gamma, const void* dout,
                     void* dh, void* y1c, void* doc, void* gac, void* dac,
                     void* vec, int R, int C, float eps, void* stream) {
  if (bad_geometry(R, C)) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {h, ls, lb, w1, b1, w2, b2, gamma, dout, dh,
                        y1c, doc, gac, dac, vec};
  for (const void* p : ptrs)
    if (misaligned(p)) return (int)cudaErrorMisalignedAddress;
  TcArgs a{};
  a.h = static_cast<const bf16*>(h);
  a.ls = static_cast<const bf16*>(ls);
  a.lb = static_cast<const bf16*>(lb);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const bf16*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const bf16*>(b2);
  a.gamma = static_cast<const bf16*>(gamma);
  a.dout = static_cast<const bf16*>(dout);
  a.out = static_cast<bf16*>(dh);
  a.y1c = static_cast<bf16*>(y1c);
  a.doc = static_cast<bf16*>(doc);
  a.gac = static_cast<bf16*>(gac);
  a.dac = static_cast<bf16*>(dac);
  a.vec = static_cast<float*>(vec);
  a.R = R;
  a.C = C;
  a.eps = eps;
  return (int)tc_nj<true>(a, static_cast<cudaStream_t>(stream));
}

// Pass 2 of the bf16 backward: dW1, dW2 and the vector partials of each of
// the `splits` row ranges of range_rows rows into its workspace slot.
int fused_mlp_wgrad(const void* y1c, const void* doc, const void* gac,
                    const void* dac, const void* vec, void* ws, int R, int C,
                    int range_rows, int splits, void* stream) {
  const int rows = tc_rows(C, true);
  if (bad_geometry(R, C) || rows == 0 || range_rows < 1 ||
      range_rows % kRangeRows != 0 || kRangeRows % rows != 0 ||
      splits != (R + range_rows - 1) / range_rows)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {y1c, doc, gac, dac, vec, ws};
  for (const void* p : ptrs)
    if (misaligned(p)) return (int)cudaErrorMisalignedAddress;
  const int tiles = ((C + kWgTile - 1) / kWgTile) *
                    ((4 * C + kWgTile - 1) / kWgTile);
  const dim3 grid(2 * tiles, splits);
  mlp_wgrad_kernel<<<grid, kWgThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y1c), static_cast<const bf16*>(doc),
      static_cast<const bf16*>(gac), static_cast<const bf16*>(dac),
      static_cast<const float*>(vec), static_cast<float*>(ws), R, C,
      range_rows, rows);
  return (int)cudaGetLastError();
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

// The bf16 row kernels' tile rows at width C: the forward's (bwd == 0) or
// the backward's, whose row tiles the vector partials follow (0 when C is
// too wide): what ops/fused_mlp.py's tc_rows must agree with.
int fused_mlp_tc_rows(int C, int bwd) { return tc_rows(C, bwd != 0); }

// Dynamic shared memory per block, in bytes, of the largest kernel at width
// C for the dtype (use_bf16 != 0: the tensor-core forward, pass 1 and pass 2,
// whose tiles are static; else the fp32 forward and backward), 0 when C is
// too wide: what ops/fused_mlp.py's smem_bytes must agree with.
int fused_mlp_smem_bytes(int C, int use_bf16) {
  int f = 0, b = 0;
  switch (pick_nj(C)) {
#define SMEM_CASE(V)                                               \
  case V:                                                          \
    f = use_bf16 ? TcGeom<V, false>::SMEM                          \
                 : (int)sizeof(float) * fwd_smem_floats<V>();      \
    b = use_bf16 ? TcGeom<V, true>::SMEM                           \
                 : (int)sizeof(float) * bwd_smem_floats<V>();      \
    break;
    SMEM_CASE(1) SMEM_CASE(2) SMEM_CASE(3) SMEM_CASE(4) SMEM_CASE(6)
    SMEM_CASE(8) SMEM_CASE(12) SMEM_CASE(16) SMEM_CASE(24)
#undef SMEM_CASE
    default: return 0;
  }
  int m = f > b ? f : b;
  if (use_bf16 && kWgSmem > m) m = kWgSmem;
  return m;
}

}  // extern "C"
