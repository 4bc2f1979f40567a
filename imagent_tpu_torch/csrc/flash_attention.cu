// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of imagent_tpu/ops/flash_attention.py:
//   flash_fwd -> _fwd_kernel (:58), launched from _flash_fwd_impl (:167)
//   flash_dq  -> _dq_kernel  (:98), launched from _flash_bhd_bwd (:217)
//   flash_dkv -> _dkv_kernel (:126), launched from _flash_bhd_bwd (:217)
// Non-causal softmax attention with scale D^-0.5 and fp32 softmax statistics.
//
// Layout. q, k and v keep the JAX layout (B, N, H, D) and are read through
// their strides (sB, sN, sH; the last dim must be contiguous), so a slice of a
// fused QKV projection needs no copy. o, dO, dq, dk and dv are contiguous
// (B, N, H, D). The per-row statistics LSE = m + log(l) and Di = rowsum(dO*O)
// are compact fp32 (B*H, N): the TPU's 128-lane broadcast is not needed here.
//
// Blocks. The TPU runs its grid (B*H, N/bq, N/bk) in order on one core and
// carries (acc, m, l) across the innermost grid axis in VMEM scratch. Here
// every CUDA block owns one output tile and loops over the other sequence
// axis itself: fwd and dq own a 64-row Q tile and loop over 64-row K/V
// tiles; dkv owns a 64-row K/V tile and loops over Q tiles. Each output tile
// has exactly one owner, so there are no atomics and the result is
// deterministic. The ragged edge (N = 197 for ViT-B/16 at 224 px) is masked
// in the kernel, for Q rows and K columns alike; nothing is padded in memory.
//
// Numerics follow the TPU kernel: S = Q.K^T from input-type operands with
// fp32 accumulation (bf16 products are exact in fp32), then * scale; masked
// keys get -0.7 * FLT_MAX, not -inf; P.V is done in fp32 (the TPU kernel
// upcasts V); l is clamped at 1e-30.
//
// What bounds it on an H100. At ViT-B/16 shapes (N = 197, D = 64) attention
// is memory-bound: 4*N*D flops per row pair against 4 reads/writes of D
// values per row gives ~N/2 = 100 flops per byte in bf16, below the ~295
// the tensor cores need per byte of HBM. The design keeps every N x N
// intermediate (S, P, dP, dS) in shared memory, so device memory sees one
// read of each input tile and one write of each output, as in the bound.
// This first version computes in fp32 with plain FMA loops on 64x64 tiles
// staged through shared memory (256 threads, each owning a 4x4 patch of S
// and a 4 x ceil(D/16) patch of the output); it is far from that bound.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // Q rows per tile
constexpr int kBK = 64;       // K/V rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 patch of S
constexpr int kLDS = kBK + 1;  // padded row of an S/P/dS tile
constexpr float kNegBig = -0.7f * FLT_MAX;  // _NEG_BIG of the TPU kernel

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

struct Geom {
  int B, H, N;
  long long sB, sN, sH;  // strides of q, k and v, in elements
};

// Rows [row0, row0 + rows) of one (b, h) slice into a float tile with row
// pitch LD. Rows at or beyond N read as zero.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long base, long long pitch,
                                          int row0, int rows, int n_real) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int n = row0 + r;
    dst[r * LD + d] =
        n < n_real ? to_f(src[base + (long long)n * pitch + d]) : 0.f;
  }
}

__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           long long base, int row0,
                                           int n_real) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const int n = row0 + r;
    dst[r] = n < n_real ? src[base + n] : 0.f;
  }
}

template <int D>
constexpr int fwd_smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kLDS + 3 * kBQ;
}
template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * kLDS + 2 * kBQ;
}
template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ * kLDS + 2 * kBQ;
}

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, Geom g, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ x LD
  float* sK = sQ + kBQ * LD;    // kBK x LD
  float* sV = sK + kBK * LD;    // kBK x D
  float* sS = sV + kBK * D;     // kBQ x kLDS: S, then P
  float* sM = sS + kBQ * kLDS;  // running max
  float* sL = sM + kBQ;         // running sum
  float* sA = sL + kBQ;         // this tile's rescale factor

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const long long in_base = (long long)b * g.sB + (long long)h * g.sH;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  load_rows<T, D, LD>(sQ, q, in_base, g.sN, q0, kBQ, g.N);
  if (tid < kBQ) {
    sM[tid] = kNegBig;
    sL[tid] = 0.f;
  }
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;

  const int nk = (g.N + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D, LD>(sK, k, in_base, g.sN, k0, kBK, g.N);
    load_rows<T, D, D>(sV, v, in_base, g.sN, k0, kBK, g.N);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        sS[(tr * 4 + i) * kLDS + c] =
            k0 + c < g.N ? s[i][j] * scale : kNegBig;
      }
    __syncthreads();

    // Online softmax: warp w owns rows 8w .. 8w+7, a lane two columns.
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x0 = sS[r * kLDS + lane];
      const float x1 = sS[r * kLDS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new);
      const float p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sS[r * kLDS + lane] = p0;
      sS[r * kLDS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, all fp32.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sA[tr * 4 + i];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sS[(tr * 4 + i) * kLDS + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int d = tc + 16 * jj;
        if (d < D) {
          const float vv = sV[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
        }
      }
    }
  }

  const long long row_pitch = (long long)g.H * D;
  const long long out_base = (long long)b * g.N * row_pitch + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int n = q0 + r;
    if (n < g.N) {
      const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int d = tc + 16 * jj;
        if (d < D) o[out_base + n * row_pitch + d] = from_f<T>(acc[i][jj] / l);
      }
      if (tc == 0) lse[(long long)bh * g.N + n] = sM[r] + logf(l);
    }
  }
}

// --------------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dq, Geom g, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // kBQ x LD
  float* sdO = sQ + kBQ * LD;   // kBQ x LD
  float* sK = sdO + kBQ * LD;   // kBK x LD
  float* sV = sK + kBK * LD;    // kBK x LD
  float* sS = sV + kBK * LD;    // kBQ x kLDS: dS
  float* sLSE = sS + kBQ * kLDS;
  float* sDi = sLSE + kBQ;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const long long in_base = (long long)b * g.sB + (long long)h * g.sH;
  const long long row_pitch = (long long)g.H * D;
  const long long out_base = (long long)b * g.N * row_pitch + (long long)h * D;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;

  load_rows<T, D, LD>(sQ, q, in_base, g.sN, q0, kBQ, g.N);
  load_rows<T, D, LD>(sdO, dout, out_base, row_pitch, q0, kBQ, g.N);
  load_stats(sLSE, lse, (long long)bh * g.N, q0, g.N);
  load_stats(sDi, di, (long long)bh * g.N, q0, g.N);
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;

  const int nk = (g.N + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_rows<T, D, LD>(sK, k, in_base, g.sN, k0, kBK, g.N);
    load_rows<T, D, LD>(sV, v, in_base, g.sN, k0, kBK, g.N);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(tr * 4 + i) * LD + d];
        ov[i] = sdO[(tr * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tc + 16 * j) * LD + d];
        vv[j] = sV[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = k0 + c < g.N ? expf(s[i][j] * scale - sLSE[r]) : 0.f;
        sS[r * kLDS + c] = p * (dp[i][j] - sDi[r]);
      }
    }
    __syncthreads();

    // dQ += dS.K (scale applied once, at the end).
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sS[(tr * 4 + i) * kLDS + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int d = tc + 16 * jj;
        if (d < D) {
          const float kk = sK[c * LD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(dsv[i], kk, acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + tr * 4 + i;
    if (n < g.N) {
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int d = tc + 16 * jj;
        if (d < D) dq[out_base + n * row_pitch + d] = from_f<T>(acc[i][jj] * scale);
      }
    }
  }
}

// ------------------------------------------------------------------ dK/dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               T* __restrict__ dk, T* __restrict__ dv, Geom g, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = (D + 15) / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // kBK x LD
  float* sV = sK + kBK * LD;    // kBK x LD
  float* sQ = sV + kBK * LD;    // kBQ x LD
  float* sdO = sQ + kBQ * LD;   // kBQ x LD
  float* sP = sdO + kBQ * LD;   // kBQ x kLDS
  float* sdS = sP + kBQ * kLDS;  // kBQ x kLDS
  float* sLSE = sdS + kBQ * kLDS;
  float* sDi = sLSE + kBQ;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const long long in_base = (long long)b * g.sB + (long long)h * g.sH;
  const long long row_pitch = (long long)g.H * D;
  const long long out_base = (long long)b * g.N * row_pitch + (long long)h * D;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;

  load_rows<T, D, LD>(sK, k, in_base, g.sN, k0, kBK, g.N);
  load_rows<T, D, LD>(sV, v, in_base, g.sN, k0, kBK, g.N);
  // This thread owns K/V rows 4*tr .. 4*tr+3 and columns tc + 16*jj.
  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc_k[i][jj] = acc_v[i][jj] = 0.f;

  const int nq = (g.N + kBQ - 1) / kBQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_rows<T, D, LD>(sQ, q, in_base, g.sN, q0, kBQ, g.N);
    load_rows<T, D, LD>(sdO, dout, out_base, row_pitch, q0, kBQ, g.N);
    load_stats(sLSE, lse, (long long)bh * g.N, q0, g.N);
    load_stats(sDi, di, (long long)bh * g.N, q0, g.N);
    __syncthreads();

    // (r, c) = (Q row 4*tr+i, K row tc+16*j) of this Q tile.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(tr * 4 + i) * LD + d];
        ov[i] = sdO[(tr * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tc + 16 * j) * LD + d];
        vv[j] = sV[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const bool row_ok = q0 + r < g.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j;
        const float p = (row_ok && k0 + c < g.N)
                            ? expf(s[i][j] * scale - sLSE[r])
                            : 0.f;
        sP[r * kLDS + c] = p;
        sdS[r * kLDS + c] = p * (dp[i][j] - sDi[r]);
      }
    }
    __syncthreads();

    // dV += P^T.dO and dK += dS^T.Q over this tile's Q rows.
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[r * kLDS + tr * 4 + i];
        dsv[i] = sdS[r * kLDS + tr * 4 + i];
      }
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int d = tc + 16 * jj;
        if (d < D) {
          const float ov = sdO[r * LD + d];
          const float qv = sQ[r * LD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][jj] = fmaf(pv[i], ov, acc_v[i][jj]);
            acc_k[i][jj] = fmaf(dsv[i], qv, acc_k[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = k0 + tr * 4 + i;
    if (n < g.N) {
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const int d = tc + 16 * jj;
        if (d < D) {
          dk[out_base + n * row_pitch + d] = from_f<T>(acc_k[i][jj] * scale);
          dv[out_base + n * row_pitch + d] = from_f<T>(acc_v[i][jj]);
        }
      }
    }
  }
}

// --------------------------------------------------------------- launches

// D^-0.5 rounded once to fp32, as the JAX side's Python-float scale is.
float head_scale(int D) { return (float)(1.0 / sqrt((double)D)); }

template <typename KernelT>
cudaError_t set_smem(KernelT kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, Geom g, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  cudaError_t err = set_smem(fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.B * g.H, (g.N + kBQ - 1) / kBQ);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      g, head_scale(D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, Geom g, cudaStream_t stream) {
  const size_t smem = sizeof(float) * dq_smem_floats<D>();
  cudaError_t err = set_smem(dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.B * g.H, (g.N + kBQ - 1) / kBQ);
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), g, head_scale(D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, Geom g, cudaStream_t stream) {
  const size_t smem = sizeof(float) * dkv_smem_floats<D>();
  cudaError_t err = set_smem(dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.B * g.H, (g.N + kBK - 1) / kBK);
  dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), g, head_scale(D));
  return cudaGetLastError();
}

// One switch over the supported head dims: D is a template parameter so
// the tile loops unroll and the accumulators stay in registers.
#define FLASH_DISPATCH(D_, CALL)                       \
  switch (D_) {                                        \
    case 8: { constexpr int kD = 8; return CALL; }     \
    case 16: { constexpr int kD = 16; return CALL; }   \
    case 32: { constexpr int kD = 32; return CALL; }   \
    case 64: { constexpr int kD = 64; return CALL; }   \
    case 80: { constexpr int kD = 80; return CALL; }   \
    case 128: { constexpr int kD = 128; return CALL; } \
    default: return cudaErrorInvalidValue;             \
  }

template <typename T>
cudaError_t fwd_d(int D, const void* q, const void* k, const void* v, void* o,
                  void* lse, Geom g, cudaStream_t s) {
  FLASH_DISPATCH(D, (launch_fwd<T, kD>(q, k, v, o, lse, g, s)))
}

template <typename T>
cudaError_t dq_d(int D, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* di, void* dq,
                 Geom g, cudaStream_t s) {
  FLASH_DISPATCH(D, (launch_dq<T, kD>(q, k, v, dout, lse, di, dq, g, s)))
}

template <typename T>
cudaError_t dkv_d(int D, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* di, void* dk,
                  void* dv, Geom g, cudaStream_t s) {
  FLASH_DISPATCH(D,
                 (launch_dkv<T, kD>(q, k, v, dout, lse, di, dk, dv, g, s)))
}

Geom make_geom(int B, int H, int N, long long sB, long long sN,
               long long sH) {
  Geom g;
  g.B = B;
  g.H = H;
  g.N = N;
  g.sB = sB;
  g.sN = sN;
  g.sH = sH;
  return g;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the cudaError_t of
// its launch as an int: 0 on success. bf16 != 0 selects __nv_bfloat16
// operands, else float.
extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int H, int N, int D, long long sB,
              long long sN, long long sH, int bf16, void* stream) {
  const Geom g = make_geom(B, H, N, sB, sN, sH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)fwd_d<__nv_bfloat16>(D, q, k, v, o, lse, g, s)
              : (int)fwd_d<float>(D, q, k, v, o, lse, g, s);
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* di, void* dq, int B, int H, int N,
             int D, long long sB, long long sN, long long sH, int bf16,
             void* stream) {
  const Geom g = make_geom(B, H, N, sB, sN, sH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)dq_d<__nv_bfloat16>(D, q, k, v, dout, lse, di, dq, g, s)
              : (int)dq_d<float>(D, q, k, v, dout, lse, di, dq, g, s);
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* di, void* dk, void* dv, int B,
              int H, int N, int D, long long sB, long long sN, long long sH,
              int bf16, void* stream) {
  const Geom g = make_geom(B, H, N, sB, sN, sH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? (int)dkv_d<__nv_bfloat16>(D, q, k, v, dout, lse, di, dk, dv,
                                          g, s)
              : (int)dkv_d<float>(D, q, k, v, dout, lse, di, dk, dv, g, s);
}

}  // extern "C"
