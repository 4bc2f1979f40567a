// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the three Pallas TPU kernels of imagent_tpu/ops/flash_attention.py:
//   flash_fwd -> _fwd_kernel (:58), launched from _flash_fwd_impl (:167)
//   flash_dq  -> _dq_kernel  (:98), launched from _flash_bhd_bwd (:217)
//   flash_dkv -> _dkv_kernel (:126), launched from _flash_bhd_bwd (:217)
// Non-causal softmax attention with scale D^-0.5 and fp32 softmax statistics.
//
// Layout. q, k and v keep the JAX layout (B, N, H, D) and are read through
// their strides (sB, sN, sH; the last dim must be contiguous; the wrapper
// makes every pointer and stride 16-byte aligned for cp.async), so a slice of
// a fused QKV projection needs no copy. o, dO, dq, dk and dv are contiguous
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
// keys get -0.7 * FLT_MAX, not -inf; l is clamped at 1e-30. The FMA kernels
// do P.V, P^T.dO and dS^T.Q in fp32 (the TPU kernel upcasts the second
// operand); the tensor-core kernels split P and dS into bf16 hi + lo
// (below).
//
// What bounds it on an H100. At ViT-B/16 shapes (N = 197, D = 64) attention
// is memory-bound: 4*N*D flops per row pair against 4 reads/writes of D
// values per row gives ~N/2 = 100 flops per byte in bf16, below the ~295
// the tensor cores need per byte of HBM. Every design here keeps each
// N x N intermediate (S, P, dP, dS) on chip, so device memory sees one read
// of each input tile per owner block and one write of each output.
//
// Two designs share this file.
//
// bf16 (fwd_tc_kernel, dq_tc_kernel, dkv_tc_kernel): tensor cores.
// Four warps per block, 16 rows of the block's 64-row tile each (a 128-row
// forward tile measured 2.5% faster on an H100 at the ViT-B/16 shape,
// within noise, and fits one block per SM at D = 128). The other
// sequence axis streams through shared memory in tiles that cp.async
// double-buffers (16-byte copies, zero-filled past N; the next tile loads
// while this one computes). Every product is
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with operands fed by
// ldmatrix (.trans for the operand whose rows are the summed axis):
//   forward: S = Q.K^T per 64-key tile; the online softmax (max, exp, row
//     sum, the alpha rescale) works on the accumulator fragments in
//     registers with quad shuffles; the C fragment of P is the A fragment
//     of P.V, so S and P never touch shared memory; O is divided by l in
//     registers and stored once, LSE once per row.
//   dQ: the forward's blocking with Q and dO resident as A fragments; per
//     16-key group S = Q.K^T and dP = dO.V^T, then P = exp(S - LSE) and
//     dS = P (dP - Di) on the fragments, and dQ += dS.K at once with dS as
//     the register A fragment and K read transposed (no running statistics,
//     so one group's S and dP are live at a time). At D > 64 the K/V tile
//     is 32 keys.
//   dK/dV: each warp owns 16 key rows and loops over Q tiles (Q, dO, LSE
//     and Di double-buffered), forming S^T = K.Q^T and dP^T = V.dO^T, then
//     P^T and dS^T in registers, and accumulating dV += P^T.dO and
//     dK += dS^T.Q with P^T and dS^T as register A fragments.
// The TPU kernel multiplies P and dS as fp32 operands. Here each is split
// into bf16 hi = bf16(x) and lo = bf16(x - hi), and every product with it is
// two mma (hi, then lo): about 16 mantissa bits. Rounding them to bf16 once,
// as FlashAttention-2 does, breaks the bf16 card bound (1e-3 + |ref|/64)
// where one large P or dS term meets a cancelling sum: at the ViT-B/16
// shape dK went past it on an H100 in 39 elements (max |err| 7.8e-3);
// dQ's dS.K is the same kind of sum, so dS is split there too
// (tests/test_torch_port_flash_tc.py emulates the roundings on the CPU
// against the interpret-mode Pallas kernel). exp is ex2.approx on
// log2e-scaled scores. Head dims below 16 are zero-padded to the mma depth
// in shared memory; rows are pitched 16 bytes past their width, so the 8
// rows an ldmatrix reads fall in 8 distinct bank groups.
//
// fp32 (fwd_kernel, dq_kernel, dkv_kernel): the first version, FMA loops
// on 64x64 tiles staged through shared memory (256 threads, each owning a
// 4x4 patch of S and a 4 x ceil(D/16) patch of the output). TF32 would not
// hold the fp32 bound.
//
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;       // Q rows per tile
constexpr int kBK = 64;       // K/V rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads, each a 4x4 patch of S
constexpr int kLDS = kBK + 1;  // padded row of an S/P/dS tile
constexpr float kNegBig = -0.7f * FLT_MAX;  // _NEG_BIG of the TPU kernel

struct Geom {
  int B, H, N;
  long long sB, sN, sH;  // strides of q, k and v, in elements
};

// Rows [row0, row0 + rows) of one (b, h) slice into a float tile with row
// pitch LD. Rows at or beyond N read as zero.
template <int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long base, long long pitch,
                                          int row0, int rows, int n_real) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int n = row0 + r;
    dst[r * LD + d] =
        n < n_real ? src[base + (long long)n * pitch + d] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
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

  load_rows<D, LD>(sQ, q, in_base, g.sN, q0, kBQ, g.N);
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
    load_rows<D, LD>(sK, k, in_base, g.sN, k0, kBK, g.N);
    load_rows<D, D>(sV, v, in_base, g.sN, k0, kBK, g.N);
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
        if (d < D) o[out_base + n * row_pitch + d] = acc[i][jj] / l;
      }
      if (tc == 0) lse[(long long)bh * g.N + n] = sM[r] + logf(l);
    }
  }
}

// --------------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              float* __restrict__ dq, Geom g, float scale) {
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

  load_rows<D, LD>(sQ, q, in_base, g.sN, q0, kBQ, g.N);
  load_rows<D, LD>(sdO, dout, out_base, row_pitch, q0, kBQ, g.N);
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
    load_rows<D, LD>(sK, k, in_base, g.sN, k0, kBK, g.N);
    load_rows<D, LD>(sV, v, in_base, g.sN, k0, kBK, g.N);
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
        if (d < D) dq[out_base + n * row_pitch + d] = acc[i][jj] * scale;
      }
    }
  }
}

// ------------------------------------------------------------------ dK/dV

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ di,
               float* __restrict__ dk, float* __restrict__ dv, Geom g,
               float scale) {
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

  load_rows<D, LD>(sK, k, in_base, g.sN, k0, kBK, g.N);
  load_rows<D, LD>(sV, v, in_base, g.sN, k0, kBK, g.N);
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
    load_rows<D, LD>(sQ, q, in_base, g.sN, q0, kBQ, g.N);
    load_rows<D, LD>(sdO, dout, out_base, row_pitch, q0, kBQ, g.N);
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
          dk[out_base + n * row_pitch + d] = acc_k[i][jj] * scale;
          dv[out_base + n * row_pitch + d] = acc_v[i][jj];
        }
      }
    }
  }
}

// ------------------------------------------- tensor-core kernels (bf16)

typedef __nv_bfloat16 bf16;

constexpr int kTcRows = 64;      // K/V tile rows; dK/dV's own tile: 4 warps
constexpr int kTcThreads = 128;  // the dK/dV block: 4 warps of 16 key rows
constexpr int kFwdWarps = 4;     // the forward block: 4 warps of 16 Q rows
constexpr int kFwdRows = 16 * kFwdWarps;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry of head dim D: D zero-padded to the mma depth (16), a
// shared-memory row pitch 16 bytes past it, the k16 chunks and n8 tiles of
// the padded width, and the 16-byte chunks of a real row.
template <int D>
struct Tc {
  static constexpr int DP = D < 16 ? 16 : D;
  static constexpr int LDS = DP + 8;
  static constexpr int KC = DP / 16;
  static constexpr int NT = DP / 8;
  static constexpr int CH = D / 8;
};

// The dK/dV kernel's Q tile: 64 rows, or 32 where D > 64 keeps the two
// D-wide accumulators and the S^T and dP^T tiles within the register file.
template <int D>
struct DkvTile {
  static constexpr int BQ = D > 64 ? 32 : 64;
};

// The dQ kernel's K/V tile: 64 keys, or 32 where D > 64 (half the shared
// memory of the two double-buffered D-wide tiles).
template <int D>
struct DqTile {
  static constexpr int BK = D > 64 ? 32 : 64;
};

template <int D>
__host__ __device__ constexpr size_t fwd_tc_smem_bytes() {
  // Q, then two stages each of K and V.
  return sizeof(bf16) * (kFwdRows + 4 * kTcRows) * Tc<D>::LDS;
}

template <int D>
__host__ __device__ constexpr size_t dkv_tc_smem_bytes() {
  // K and V, two stages each of Q and dO, two stages each of LSE and Di.
  return sizeof(bf16) * (2 * kTcRows + 4 * DkvTile<D>::BQ) * Tc<D>::LDS +
         sizeof(float) * 4 * DkvTile<D>::BQ;
}

template <int D>
__host__ __device__ constexpr size_t dq_tc_smem_bytes() {
  // Q and dO, two stages each of K and V, LSE and Di of the Q tile.
  return sizeof(bf16) * (2 * kTcRows + 4 * DqTile<D>::BK) * Tc<D>::LDS +
         sizeof(float) * 2 * kTcRows;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; a source size of 0 reads nothing and
// writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a.b on one 16x8 tile: a is 16x16 (row-major), b is 16x8 (col-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x0 and x1 (the lower and the upper column) split into bf16 pairs with
// x = hi + lo to about 16 mantissa bits: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The hi and lo A fragments of a 16x16 chunk from the C fragments of its
// two 16x8 halves (columns 0-7 and 8-15): a C fragment's layout is an A
// fragment's.
__device__ __forceinline__ void c_to_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float (&c0)[4],
                                       const float (&c1)[4]) {
  split_bf16(hi[0], lo[0], c0[0], c0[1]);
  split_bf16(hi[1], lo[1], c0[2], c0[3]);
  split_bf16(hi[2], lo[2], c1[0], c1[1]);
  split_bf16(hi[3], lo[3], c1[2], c1[3]);
}

// Two fp32 values rounded to bf16, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Quad reductions: the 4 lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + ROWS) of one (b, h) slice into a shared tile of pitch
// Tc<D>::LDS by 16-byte cp.async; rows at or beyond N are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long base, long long pitch,
                                           int row0, int n_real) {
  constexpr int CH = Tc<D>::CH;
  for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
    const int r = i / CH;
    const int c = i - r * CH;
    const int n = row0 + r;
    const bool ok = n < n_real;
    const bf16* p = src + base + (ok ? (long long)n * pitch : 0) + c * 8;
    cp_async16(smem_u32(dst + r * Tc<D>::LDS + c * 8), p, ok);
  }
}

// ROWS fp32 row statistics from row0 on; rows at or beyond N read as zero.
template <int ROWS>
__device__ __forceinline__ void stage_stats(float* dst, const float* src,
                                            long long base, int row0,
                                            int n_real) {
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int n = row0 + r;
    const bool ok = n < n_real;
    cp_async4(smem_u32(dst + r), src + base + (ok ? n : 0), ok);
  }
}

// Zeroes columns [D, DP) of `rows` consecutive tile rows: the padding to
// the mma depth, which no cp.async writes.
template <int D>
__device__ __forceinline__ void zero_pad(bf16* rows_base, int rows) {
  if constexpr (D < Tc<D>::DP) {
    static_assert(Tc<D>::DP - D == 8, "one 16-byte chunk of padding");
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      *reinterpret_cast<uint4*>(rows_base + r * Tc<D>::LDS + D) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// Lane offsets of the three ldmatrix.x4 patterns. A operand: a 16 x 16
// chunk (rows, depth). B by rows: two n8 tiles of 8 rows x 16 depth, the
// rows being the product's columns (K for S = Q.K^T). B transposed: 16
// depth rows x two n8 tiles of columns (V for P.V).
struct Lanes {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane & 15),
        a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8),
        b_col(((lane >> 3) & 1) * 8),
        t_row((lane & 7) + ((lane >> 3) & 1) * 8),
        t_col((lane >> 4) * 8) {}
};

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, Geom g, float scale) {
  using G = Tc<D>;
  constexpr int LDS = G::LDS;
  constexpr int TILE = kTcRows * LDS;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sK = sQ + kFwdRows * LDS;  // stages 0, 1
  bf16* sV = sK + 2 * TILE;  // stages 0, 1

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kFwdRows;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const long long in_base = (long long)b * g.sB + (long long)h * g.sH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // accumulator rows gid and gid + 8
  const int tig = lane & 3;   // accumulator columns 2*tig, 2*tig + 1
  const Lanes ln(lane);
  // A warp whose 16 rows all lie at or beyond N only helps stage tiles.
  const bool active = q0 + warp * 16 < g.N;
  const float c = scale * kLog2e;

  zero_pad<D>(sQ, kFwdRows + 4 * kTcRows);
  stage_rows<D, kFwdRows>(sQ, q, in_base, g.sN, q0, g.N);
  stage_rows<D, kTcRows>(sK, k, in_base, g.sN, 0, g.N);
  stage_rows<D, kTcRows>(sV, v, in_base, g.sN, 0, g.N);
  cp_async_commit();

  uint32_t qf[G::KC][4];
  float acc[G::NT][4];
#pragma unroll
  for (int j = 0; j < G::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_r[2] = {kNegBig, kNegBig};  // running max of the raw scores
  float l_r[2] = {0.f, 0.f};          // this lane's part of the row sums

  const int nk = (g.N + kTcRows - 1) / kTcRows;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      stage_rows<D, kTcRows>(sK + (st ^ 1) * TILE, k, in_base, g.sN,
                             (kt + 1) * kTcRows, g.N);
      stage_rows<D, kTcRows>(sV + (st ^ 1) * TILE, v, in_base, g.sN,
                             (kt + 1) * kTcRows, g.N);
    }
    cp_async_commit();
    cp_async_wait_1();  // Q and tile kt have landed
    __syncthreads();

    if (active) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < G::KC; ++kk)
          ldsm_x4(qf[kk], smem_u32(sQ + (warp * 16 + ln.a_row) * LDS +
                                   kk * 16 + ln.a_col));
      }
      const bf16* cK = sK + st * TILE;
      const bf16* cV = sV + st * TILE;
      const int kvalid = g.N - kt * kTcRows;  // < 64 on the last tile only

      // S = Q.K^T: 16 rows x 64 keys per warp; 16-key groups past N skipped.
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj * 16 < kvalid) {
#pragma unroll
          for (int kk = 0; kk < G::KC; ++kk) {
            uint32_t bk[4];
            ldsm_x4(bk, smem_u32(cK + (jj * 16 + ln.b_row) * LDS + kk * 16 +
                                 ln.b_col));
            mma_bf16(s[2 * jj], qf[kk], bk[0], bk[1]);
            mma_bf16(s[2 * jj + 1], qf[kk], bk[2], bk[3]);
          }
        }
      }

      // Online softmax on the fragments: this lane holds rows gid (e = 0, 1)
      // and gid + 8 (e = 2, 3) at columns 8*j + 2*tig + (e & 1).
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j * 8 + 2 * tig + (e & 1) >= kvalid) s[j][e] = kNegBig;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        const float alpha = ex2((m_r[r] - mx[r]) * c);
        m_r[r] = mx[r];
        mc[r] = mx[r] * c;
        l_r[r] *= alpha;
#pragma unroll
        for (int j = 0; j < G::NT; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(fmaf(s[j][e], c, -mc[e >> 1]));
          l_r[e >> 1] += s[j][e];
        }

      // acc += P.V: P's C fragments are the A fragments; V read transposed.
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        if (kc * 16 < kvalid) {
          uint32_t ph[4], pl[4];
          c_to_a(ph, pl, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
          for (int dn = 0; dn < G::NT / 2; ++dn) {
            uint32_t bv[4];
            ldsm_x4_t(bv, smem_u32(cV + (kc * 16 + ln.t_row) * LDS +
                                   dn * 16 + ln.t_col));
            mma_bf16(acc[2 * dn], ph, bv[0], bv[1]);
            mma_bf16(acc[2 * dn + 1], ph, bv[2], bv[3]);
            mma_bf16(acc[2 * dn], pl, bv[0], bv[1]);
            mma_bf16(acc[2 * dn + 1], pl, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  if (!active) return;
  const long long row_pitch = (long long)g.H * D;
  const long long out_base = (long long)b * g.N * row_pitch + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + gid + 8 * r;
    const float l = fmaxf(quad_sum(l_r[r]), 1e-30f);
    if (n < g.N) {
      bf16* orow = o + out_base + (long long)n * row_pitch;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int d = j * 8 + 2 * tig;
        if (d < D)
          *reinterpret_cast<uint32_t*>(orow + d) =
              pack_bf16(acc[j][2 * r] / l, acc[j][2 * r + 1] / l);
      }
      if (tig == 0) lse[(long long)bh * g.N + n] = m_r[r] * scale + logf(l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ di,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, Geom g,
                  float scale) {
  using G = Tc<D>;
  constexpr int LDS = G::LDS;
  constexpr int BQ = DkvTile<D>::BQ;
  constexpr int NQ = BQ / 8;  // n8 tiles of S^T across a Q tile
  constexpr int QT = BQ * LDS;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);
  bf16* sV = sK + kTcRows * LDS;
  bf16* sQ = sV + kTcRows * LDS;  // stages 0, 1
  bf16* sdO = sQ + 2 * QT;        // stages 0, 1
  float* sL = reinterpret_cast<float*>(sdO + 2 * QT);  // LSE, stages 0, 1
  float* sD = sL + 2 * BQ;                             // Di, stages 0, 1

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTcRows;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const long long in_base = (long long)b * g.sB + (long long)h * g.sH;
  const long long row_pitch = (long long)g.H * D;
  const long long out_base = (long long)b * g.N * row_pitch + (long long)h * D;
  const long long stat_base = (long long)bh * g.N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // key rows gid and gid + 8 of the warp's 16
  const int tig = lane & 3;
  const Lanes ln(lane);
  const bool active = k0 + warp * 16 < g.N;
  const float c = scale * kLog2e;
  const bool key_ok[2] = {k0 + warp * 16 + gid < g.N,
                          k0 + warp * 16 + gid + 8 < g.N};

  zero_pad<D>(sK, 2 * kTcRows + 4 * BQ);
  stage_rows<D, kTcRows>(sK, k, in_base, g.sN, k0, g.N);
  stage_rows<D, kTcRows>(sV, v, in_base, g.sN, k0, g.N);
  stage_rows<D, BQ>(sQ, q, in_base, g.sN, 0, g.N);
  stage_rows<D, BQ>(sdO, dout, out_base, row_pitch, 0, g.N);
  stage_stats<BQ>(sL, lse, stat_base, 0, g.N);
  stage_stats<BQ>(sD, di, stat_base, 0, g.N);
  cp_async_commit();

  float dka[G::NT][4], dva[G::NT][4];
#pragma unroll
  for (int j = 0; j < G::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int nq = (g.N + BQ - 1) / BQ;
  for (int qt = 0; qt < nq; ++qt) {
    const int st = qt & 1;
    if (qt + 1 < nq) {
      const int nst = st ^ 1;
      const int r0 = (qt + 1) * BQ;
      stage_rows<D, BQ>(sQ + nst * QT, q, in_base, g.sN, r0, g.N);
      stage_rows<D, BQ>(sdO + nst * QT, dout, out_base, row_pitch, r0, g.N);
      stage_stats<BQ>(sL + nst * BQ, lse, stat_base, r0, g.N);
      stage_stats<BQ>(sD + nst * BQ, di, stat_base, r0, g.N);
    }
    cp_async_commit();
    cp_async_wait_1();  // K, V and Q tile qt have landed
    __syncthreads();

    if (active) {
      const bf16* cQ = sQ + st * QT;
      const bf16* cdO = sdO + st * QT;
      const float* cL = sL + st * BQ;
      const float* cD = sD + st * BQ;
      const int qvalid = g.N - qt * BQ;  // < BQ on the last tile only

      // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x BQ queries per warp.
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < G::KC; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, smem_u32(sK + (warp * 16 + ln.a_row) * LDS + kk * 16 +
                             ln.a_col));
        ldsm_x4(va, smem_u32(sV + (warp * 16 + ln.a_row) * LDS + kk * 16 +
                             ln.a_col));
#pragma unroll
        for (int jj = 0; jj < NQ / 2; ++jj) {
          if (jj * 16 < qvalid) {
            uint32_t bq[4], bo[4];
            ldsm_x4(bq, smem_u32(cQ + (jj * 16 + ln.b_row) * LDS + kk * 16 +
                                 ln.b_col));
            ldsm_x4(bo, smem_u32(cdO + (jj * 16 + ln.b_row) * LDS + kk * 16 +
                                 ln.b_col));
            mma_bf16(s[2 * jj], ka, bq[0], bq[1]);
            mma_bf16(s[2 * jj + 1], ka, bq[2], bq[3]);
            mma_bf16(dp[2 * jj], va, bo[0], bo[1]);
            mma_bf16(dp[2 * jj + 1], va, bo[2], bo[3]);
          }
        }
      }

      // P^T = exp(S^T * scale - LSE) and dS^T = P^T (dP^T - Di), LSE and Di
      // broadcast down each query column; P^T is 0 past N either way.
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * tig + (e & 1);
          const bool ok = key_ok[e >> 1] && col < qvalid;
          const float p =
              ok ? ex2(fmaf(s[j][e], c, -cL[col] * kLog2e)) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - cD[col]);
        }

      // dV += P^T.dO and dK += dS^T.Q, with dO and Q read transposed.
#pragma unroll
      for (int kc = 0; kc < NQ / 2; ++kc) {
        if (kc * 16 < qvalid) {
          uint32_t ph[4], pl[4], dh[4], dl[4];
          c_to_a(ph, pl, s[2 * kc], s[2 * kc + 1]);
          c_to_a(dh, dl, dp[2 * kc], dp[2 * kc + 1]);
#pragma unroll
          for (int dn = 0; dn < G::NT / 2; ++dn) {
            uint32_t bo[4], bq[4];
            ldsm_x4_t(bo, smem_u32(cdO + (kc * 16 + ln.t_row) * LDS +
                                   dn * 16 + ln.t_col));
            ldsm_x4_t(bq, smem_u32(cQ + (kc * 16 + ln.t_row) * LDS +
                                   dn * 16 + ln.t_col));
            mma_bf16(dva[2 * dn], ph, bo[0], bo[1]);
            mma_bf16(dva[2 * dn + 1], ph, bo[2], bo[3]);
            mma_bf16(dka[2 * dn], dh, bq[0], bq[1]);
            mma_bf16(dka[2 * dn + 1], dh, bq[2], bq[3]);
            mma_bf16(dva[2 * dn], pl, bo[0], bo[1]);
            mma_bf16(dva[2 * dn + 1], pl, bo[2], bo[3]);
            mma_bf16(dka[2 * dn], dl, bq[0], bq[1]);
            mma_bf16(dka[2 * dn + 1], dl, bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = k0 + warp * 16 + gid + 8 * r;
    if (n < g.N) {
      const long long row = out_base + (long long)n * row_pitch;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int d = j * 8 + 2 * tig;
        if (d < D) {
          *reinterpret_cast<uint32_t*>(dk + row + d) =
              pack_bf16(dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + row + d) =
              pack_bf16(dva[j][2 * r], dva[j][2 * r + 1]);
        }
      }
    }
  }
}

// dQ on tensor cores. Each warp owns 16 of the block's 64 Q rows, as in the
// forward: Q, dO, LSE and Di of the tile are staged once, K and V stream
// through shared memory in tiles of DqTile<D>::BK keys that cp.async
// double-buffers. Per 16-key group: S = Q.K^T and dP = dO.V^T (Q and dO
// as register A fragments, K and V read by rows as B operands), then P and
// dS = P (dP - Di) on the accumulator fragments, and dQ += dS.K with dS's C
// fragments as hi + lo A fragments and K read transposed. P needs no
// running statistics (LSE is known), so a group's dS goes into dQ at once
// and only one group's S and dP are live.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 bf16* __restrict__ dq, Geom g, float scale) {
  using G = Tc<D>;
  constexpr int LDS = G::LDS;
  constexpr int BK = DqTile<D>::BK;
  constexpr int KT = BK * LDS;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sdO = sQ + kTcRows * LDS;
  bf16* sK = sdO + kTcRows * LDS;  // stages 0, 1
  bf16* sV = sK + 2 * KT;          // stages 0, 1
  float* sL = reinterpret_cast<float*>(sV + 2 * KT);  // LSE of the Q tile
  float* sD = sL + kTcRows;                           // Di of the Q tile

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTcRows;
  const int b = bh / g.H;
  const int h = bh - b * g.H;
  const long long in_base = (long long)b * g.sB + (long long)h * g.sH;
  const long long row_pitch = (long long)g.H * D;
  const long long out_base = (long long)b * g.N * row_pitch + (long long)h * D;
  const long long stat_base = (long long)bh * g.N;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // accumulator rows gid and gid + 8
  const int tig = lane & 3;   // accumulator columns 2*tig, 2*tig + 1
  const Lanes ln(lane);
  const bool active = q0 + warp * 16 < g.N;
  const float c = scale * kLog2e;

  zero_pad<D>(sQ, 2 * kTcRows + 4 * BK);
  stage_rows<D, kTcRows>(sQ, q, in_base, g.sN, q0, g.N);
  stage_rows<D, kTcRows>(sdO, dout, out_base, row_pitch, q0, g.N);
  stage_stats<kTcRows>(sL, lse, stat_base, q0, g.N);
  stage_stats<kTcRows>(sD, di, stat_base, q0, g.N);
  stage_rows<D, BK>(sK, k, in_base, g.sN, 0, g.N);
  stage_rows<D, BK>(sV, v, in_base, g.sN, 0, g.N);
  cp_async_commit();

  uint32_t qf[G::KC][4], of[G::KC][4];
  float lse_r[2], di_r[2];  // rows gid and gid + 8; LSE scaled by log2e
  float acc[G::NT][4];
#pragma unroll
  for (int j = 0; j < G::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int nk = (g.N + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      stage_rows<D, BK>(sK + (st ^ 1) * KT, k, in_base, g.sN, (kt + 1) * BK,
                        g.N);
      stage_rows<D, BK>(sV + (st ^ 1) * KT, v, in_base, g.sN, (kt + 1) * BK,
                        g.N);
    }
    cp_async_commit();
    cp_async_wait_1();  // the Q tile and K/V tile kt have landed
    __syncthreads();

    if (active) {
      if (kt == 0) {
#pragma unroll
        for (int kk = 0; kk < G::KC; ++kk) {
          const int off = (warp * 16 + ln.a_row) * LDS + kk * 16 + ln.a_col;
          ldsm_x4(qf[kk], smem_u32(sQ + off));
          ldsm_x4(of[kk], smem_u32(sdO + off));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lse_r[r] = sL[warp * 16 + gid + 8 * r] * kLog2e;
          di_r[r] = sD[warp * 16 + gid + 8 * r];
        }
      }
      const bf16* cK = sK + st * KT;
      const bf16* cV = sV + st * KT;
      const int kvalid = g.N - kt * BK;  // < BK on the last tile only

#pragma unroll
      for (int jj = 0; jj < BK / 16; ++jj) {
        if (jj * 16 < kvalid) {
          // S = Q.K^T and dP = dO.V^T for keys jj*16 .. jj*16 + 15.
          float s[2][4], dp[2][4];
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < G::KC; ++kk) {
            uint32_t bk[4], bv[4];
            const int off = (jj * 16 + ln.b_row) * LDS + kk * 16 + ln.b_col;
            ldsm_x4(bk, smem_u32(cK + off));
            ldsm_x4(bv, smem_u32(cV + off));
            mma_bf16(s[0], qf[kk], bk[0], bk[1]);
            mma_bf16(s[1], qf[kk], bk[2], bk[3]);
            mma_bf16(dp[0], of[kk], bv[0], bv[1]);
            mma_bf16(dp[1], of[kk], bv[2], bv[3]);
          }
          // P = exp(S * scale - LSE), 0 past N; dS = P (dP - Di).
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = jj * 16 + t * 8 + 2 * tig + (e & 1);
              const float p =
                  col < kvalid ? ex2(fmaf(s[t][e], c, -lse_r[e >> 1])) : 0.f;
              dp[t][e] = p * (dp[t][e] - di_r[e >> 1]);
            }
          // dQ += dS.K: dS's C fragments as hi + lo A fragments, K read
          // transposed (its rows are the summed axis).
          uint32_t dh[4], dl[4];
          c_to_a(dh, dl, dp[0], dp[1]);
#pragma unroll
          for (int dn = 0; dn < G::NT / 2; ++dn) {
            uint32_t bk[4];
            ldsm_x4_t(bk, smem_u32(cK + (jj * 16 + ln.t_row) * LDS + dn * 16 +
                                   ln.t_col));
            mma_bf16(acc[2 * dn], dh, bk[0], bk[1]);
            mma_bf16(acc[2 * dn + 1], dh, bk[2], bk[3]);
            mma_bf16(acc[2 * dn], dl, bk[0], bk[1]);
            mma_bf16(acc[2 * dn + 1], dl, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before its refill
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = q0 + warp * 16 + gid + 8 * r;
    if (n < g.N) {
      bf16* row = dq + out_base + (long long)n * row_pitch;
#pragma unroll
      for (int j = 0; j < G::NT; ++j) {
        const int d = j * 8 + 2 * tig;
        if (d < D)
          *reinterpret_cast<uint32_t*>(row + d) =
              pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid(g.B * g.H, (g.N + kFwdRows - 1) / kFwdRows);
    const size_t smem = fwd_tc_smem_bytes<D>();
    cudaError_t err = set_smem(fwd_tc_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    fwd_tc_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), g, head_scale(D));
  } else {
    const dim3 grid(g.B * g.H, (g.N + kBQ - 1) / kBQ);
    const size_t smem = sizeof(float) * fwd_smem_floats<D>();
    cudaError_t err = set_smem(fwd_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), g, head_scale(D));
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, Geom g, cudaStream_t stream) {
  const dim3 grid(g.B * g.H, (g.N + kBQ - 1) / kBQ);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(kTcRows == kBQ, "one grid for both designs");
    const size_t smem = dq_tc_smem_bytes<D>();
    cudaError_t err = set_smem(dq_tc_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dq_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<bf16*>(dq), g, head_scale(D));
  } else {
    const size_t smem = sizeof(float) * dq_smem_floats<D>();
    cudaError_t err = set_smem(dq_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dq_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dq), g, head_scale(D));
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, Geom g, cudaStream_t stream) {
  const dim3 grid(g.B * g.H, (g.N + kBK - 1) / kBK);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_assert(kTcRows == kBK, "one grid for both designs");
    const size_t smem = dkv_tc_smem_bytes<D>();
    cudaError_t err = set_smem(dkv_tc_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dkv_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), g, head_scale(D));
  } else {
    const size_t smem = sizeof(float) * dkv_smem_floats<D>();
    cudaError_t err = set_smem(dkv_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(di),
        static_cast<float*>(dk), static_cast<float*>(dv), g, head_scale(D));
  }
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
