// Flash attention, forward and backward, for Hopper (sm_90a), written by hand.
//
// Replaces three Pallas TPU kernels of paddle_tpu/ops/attention.py:
//   flash_fwd_kernel       <- _fwd_kernel       (via _fwd_pallas)
//   flash_bwd_dkdv_kernel  <- _bwd_kernel_dkdv  (via _bwd_pallas)
//   flash_bwd_dq_kernel    <- _bwd_kernel_dq    (via _bwd_pallas)
//
// What they compute, for each row n of q [N, Tq, D], k/v [N, Tk, D]:
//   s = mask(q . k^T * scale), mask = kpos < Tk && (!causal || qpos >= kpos)
//   forward:  o = softmax(s) . v (online softmax over K tiles) and
//             lse = m + log(l) per query row, float32;
//   backward: p = exp(s - lse), ds = p * (g . v^T - delta) * scale with
//             delta = rowsum(o * g) (computed by the caller), then
//             dv = p^T . g, dk = ds^T . q, dq = ds . k.
// Causal alignment is top-left (qpos and kpos both count from 0, also when
// Tq != Tk).  Masked scores take the finite fill -1e30, masked
// probabilities are exactly 0, and a row with l == 0 gives o = 0 and
// lse = m + log(1), as in the TPU kernel.  Scores, softmax statistics and
// every sum run in float32.  With bfloat16 inputs, p is rounded to
// bfloat16 before p . v, and p and ds are rounded before the backward
// products (the JAX package's dtype rules); with float32 inputs nothing is
// rounded.  Outputs: o in q's type, lse float32, dq/dk/dv in the inputs'
// type.
//
// What bounds them on the H100, at the training shape (N=64, T=1024, D=64,
// causal, float32): operations.  One masked product is about N*T^2*D =
// 4.3 GFLOP; the forward does two (0.128 ms at 67 TFLOP/s of float32 FMA),
// dK/dV four (0.256 ms) and dQ three (0.192 ms), against 0.02 ms for their
// bytes.  float32 inputs run on the CUDA cores in full float32 (the JAX
// package's Precision.HIGHEST), so the design keeps every operand of the
// inner loops in shared memory and registers:
//   * the TPU kernels carry (m, l, acc) or (dk, dv) or dq in VMEM across a
//     sequential grid axis; Hopper blocks run in no order, so one block per
//     (row of N, Q tile) loops over its K tiles itself (forward, dQ) and one
//     block per (row of N, K tile) loops over its Q tiles (dK/dV).  No
//     atomics: every output element has one writer, so results repeat
//     exactly from run to run;
//   * 64 x 64 tiles; 256 threads as 16 x 16, each owning a 4 x 4 patch of
//     the score tile and 4 rows x D/16 columns of its accumulators; row
//     statistics are reduced with shuffles over the 16 lanes of a row;
//   * K (and V in the backward) sit transposed in shared memory for the
//     score products, rows are padded by one float against bank conflicts;
//     the forward and dQ walk Q tiles from the last, so the longest causal
//     rows start first; tiles above the causal diagonal are skipped;
//   * dynamic shared memory (66-183 KB by D) is taken above 48 KB by opt-in.
// The kernel picks its own tiles (64 x 64): the block_k of the plain
// backward does not reach it.  D must be 16, 32, 64 or 128.
//
// Later work, not done here: wgmma / mma.sync tiles (bf16 at tensor-core
// rate), TMA or cp.async double-buffered tile loads, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded through the input type: the identity for float32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// max / sum over the 16 lanes that share a score row (xor offsets < 16 stay
// inside one half-warp)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [row0, row0 + kB) of a [rows, D] matrix into dst[r][d] (leading
// dimension D + 1), zero past `rows`
template <typename T, int D>
__device__ void load_tile(float* dst, const T* src, int row0, int rows) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int gr = row0 + r;
    dst[r * (D + 1) + d] = gr < rows ? to_f32(src[(int64_t)gr * D + d]) : 0.f;
  }
}

// the same rows transposed: dst[d][r] (leading dimension kB + 1)
template <typename T, int D>
__device__ void load_tile_t(float* dst, const T* src, int row0, int rows) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const int gr = row0 + r;
    dst[d * (kB + 1) + r] = gr < rows ? to_f32(src[(int64_t)gr * D + d]) : 0.f;
  }
}

// lse and delta of rows [row0, row0 + kB), zero past `rows`
__device__ void load_stats(float* lse_s, float* dl_s, const float* lse,
                           const float* delta, int row0, int rows) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const int gr = row0 + r;
    lse_s[r] = gr < rows ? lse[gr] : 0.f;
    dl_s[r] = gr < rows ? delta[gr] : 0.f;
  }
}

template <int D>
constexpr int fwd_smem_floats() {
  return 2 * kB * (D + 1) + D * (kB + 1) + kB * (kB + 1);
}
template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * D * (kB + 1) + 2 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB;
}
template <int D>
constexpr int dq_smem_floats() {
  return 3 * kB * (D + 1) + 2 * D * (kB + 1) + kB * (kB + 1) + 2 * kB;
}

// ------------------------------------------------------------------ forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, float scale,
                     int causal, int n_qt) {
  constexpr int CW = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kB][D + 1]
  float* kt_s = q_s + kB * (D + 1);    // [D][kB + 1]
  float* v_s = kt_s + D * (kB + 1);    // [kB][D + 1]
  float* p_s = v_s + kB * (D + 1);     // [kB][kB + 1]

  const int n = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int q0 = qt * kB;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qn = q + (int64_t)n * Tq * D;
  const T* kn = k + (int64_t)n * Tk * D;
  const T* vn = v + (int64_t)n * Tk * D;

  load_tile<T, D>(q_s, qn, q0, Tq);

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (Tk + kB - 1) / kB;
  if (causal) n_kt = min(n_kt, qt + 1);  // skip tiles above the diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's readers are done
    load_tile_t<T, D>(kt_s, kn, k0, Tk);
    load_tile<T, D>(v_s, vn, k0, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kt_s[d * (kB + 1) + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        ok[j] = kp < Tk && (!causal || qp >= kp);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        p_s[(ty * 4 + i) * (kB + 1) + tx * 4 + j] = round_to<T>(p);
      }
      rs = row_sum16(rs);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * (kB + 1) + kk];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vv = v_s[kk * (D + 1) + tx * CW + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp < Tq) {
      const float safe = l[i] == 0.f ? 1.f : l[i];
      T* orow = o + ((int64_t)n * Tq + qp) * D;
#pragma unroll
      for (int c = 0; c < CW; ++c)
        orow[tx * CW + c] = from_f32<T>(acc[i][c] / safe);
      if (tx == 0) lse[(int64_t)n * Tq + qp] = m[i] + logf(safe);
    }
  }
}

// ------------------------------------------------------------- backward math

// One (Q tile, K tile) pair: the score and g . v^T products, then p and ds
// rounded through T into p_s / ds_s ([q][k], leading dimension kB + 1).
// p_s may be null (the dQ pass needs ds only).
template <typename T, int D>
__device__ __forceinline__ void recompute_p_ds(
    const float* q_s, const float* g_s, const float* kt_s, const float* vt_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s, int q0,
    int k0, int Tq, int Tk, float scale, int causal) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], ga[4], b[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = q_s[(ty * 4 + i) * (D + 1) + d];
      ga[i] = g_s[(ty * 4 + i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = kt_s[d * (kB + 1) + tx * 4 + j];
      bv[j] = vt_s[d * (kB + 1) + tx * 4 + j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], bv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qp = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tx * 4 + j;
      // padded Q rows and K columns past Tk are masked explicitly
      const bool ok = qp < Tq && kp < Tk && (!causal || qp >= kp);
      const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      const float ds = p * (dp[i][j] - dl_s[r]) * scale;
      if (p_s != nullptr) p_s[r * (kB + 1) + tx * 4 + j] = round_to<T>(p);
      ds_s[r * (kB + 1) + tx * 4 + j] = round_to<T>(ds);
    }
  }
}

// --------------------------------------------------------------- dK / dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Tq, int Tk, float scale, int causal, int n_kt) {
  constexpr int CW = D / 16;
  extern __shared__ float smem[];
  float* kt_s = smem;                   // [D][kB + 1]
  float* vt_s = kt_s + D * (kB + 1);    // [D][kB + 1]
  float* q_s = vt_s + D * (kB + 1);     // [kB][D + 1]
  float* g_s = q_s + kB * (D + 1);      // [kB][D + 1]
  float* p_s = g_s + kB * (D + 1);      // [kB][kB + 1]
  float* ds_s = p_s + kB * (kB + 1);    // [kB][kB + 1]
  float* lse_s = ds_s + kB * (kB + 1);  // [kB]
  float* dl_s = lse_s + kB;             // [kB]

  const int n = blockIdx.x / n_kt;
  const int kt = blockIdx.x % n_kt;
  const int k0 = kt * kB;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qn = q + (int64_t)n * Tq * D;
  const T* gn = g + (int64_t)n * Tq * D;
  const T* kn = k + (int64_t)n * Tk * D;
  const T* vn = v + (int64_t)n * Tk * D;
  const float* lsen = lse + (int64_t)n * Tq;
  const float* dln = delta + (int64_t)n * Tq;

  load_tile_t<T, D>(kt_s, kn, k0, Tk);
  load_tile_t<T, D>(vt_s, vn, k0, Tk);

  float dka[4][CW], dva[4][CW];  // rows k0 + ty*4 + i, columns tx*CW + c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_qt = (Tq + kB - 1) / kB;
  // causal: Q tiles wholly above this K tile see p == 0 (q_start + kB - 1
  // < k_start), so start at the diagonal tile
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kB;
    __syncthreads();
    load_tile<T, D>(q_s, qn, q0, Tq);
    load_tile<T, D>(g_s, gn, q0, Tq);
    load_stats(lse_s, dl_s, lsen, dln, q0, Tq);
    __syncthreads();
    recompute_p_ds<T, D>(q_s, g_s, kt_s, vt_s, lse_s, dl_s, p_s, ds_s, q0, k0,
                         Tq, Tk, scale, causal);
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kB; ++qq) {
      float pk[4], dsk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = p_s[qq * (kB + 1) + ty * 4 + i];
        dsk[i] = ds_s[qq * (kB + 1) + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float gv = g_s[qq * (D + 1) + tx * CW + c];
        const float qv = q_s[qq * (D + 1) + tx * CW + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][c] = fmaf(pk[i], gv, dva[i][c]);
          dka[i][c] = fmaf(dsk[i], qv, dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp < Tk) {
      const int64_t row = ((int64_t)n * Tk + kp) * D;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        dk[row + tx * CW + c] = from_f32<T>(dka[i][c]);
        dv[row + tx * CW + c] = from_f32<T>(dva[i][c]);
      }
    }
  }
}

// -------------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ g, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Tq, int Tk,
    float scale, int causal, int n_qt) {
  constexpr int CW = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kB][D + 1]
  float* g_s = q_s + kB * (D + 1);      // [kB][D + 1]
  float* k_s = g_s + kB * (D + 1);      // [kB][D + 1]
  float* kt_s = k_s + kB * (D + 1);     // [D][kB + 1]
  float* vt_s = kt_s + D * (kB + 1);    // [D][kB + 1]
  float* ds_s = vt_s + D * (kB + 1);    // [kB][kB + 1]
  float* lse_s = ds_s + kB * (kB + 1);  // [kB]
  float* dl_s = lse_s + kB;             // [kB]

  const int n = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int q0 = qt * kB;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kn = k + (int64_t)n * Tk * D;
  const T* vn = v + (int64_t)n * Tk * D;

  load_tile<T, D>(q_s, q + (int64_t)n * Tq * D, q0, Tq);
  load_tile<T, D>(g_s, g + (int64_t)n * Tq * D, q0, Tq);
  load_stats(lse_s, dl_s, lse + (int64_t)n * Tq, delta + (int64_t)n * Tq, q0,
             Tq);

  float dqa[4][CW];  // rows q0 + ty*4 + i, columns tx*CW + c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dqa[i][c] = 0.f;

  int n_kt = (Tk + kB - 1) / kB;
  if (causal) n_kt = min(n_kt, qt + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    load_tile<T, D>(k_s, kn, k0, Tk);
    load_tile_t<T, D>(kt_s, kn, k0, Tk);
    load_tile_t<T, D>(vt_s, vn, k0, Tk);
    __syncthreads();
    recompute_p_ds<T, D>(q_s, g_s, kt_s, vt_s, lse_s, dl_s, nullptr, ds_s, q0,
                         k0, Tq, Tk, scale, causal);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float dsq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsq[i] = ds_s[(ty * 4 + i) * (kB + 1) + kk];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float kv = k_s[kk * (D + 1) + tx * CW + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][c] = fmaf(dsq[i], kv, dqa[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp < Tq) {
      const int64_t row = ((int64_t)n * Tq + qp) * D;
#pragma unroll
      for (int c = 0; c < CW; ++c) dq[row + tx * CW + c] = from_f32<T>(dqa[i][c]);
    }
  }
}

// ---------------------------------------------------------------- launchers

template <typename K>
int prepare(K kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int N, int Tq, int Tk, float scale, int causal, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  int rc = prepare(kern, smem);
  if (rc != 0) return rc;
  const int n_qt = (Tq + kB - 1) / kB;
  kern<<<(unsigned)(N * n_qt), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Tq, Tk, scale,
      causal, n_qt);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* g,
         const float* lse, const float* delta, void* dk, void* dv, int N,
         int Tq, int Tk, float scale, int causal, cudaStream_t st) {
  auto kern = flash_bwd_dkdv_kernel<T, D>;
  const size_t smem = sizeof(float) * dkdv_smem_floats<D>();
  int rc = prepare(kern, smem);
  if (rc != 0) return rc;
  const int n_kt = (Tk + kB - 1) / kB;
  kern<<<(unsigned)(N * n_kt), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, scale, causal, n_kt);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* g,
       const float* lse, const float* delta, void* dqp, int N, int Tq, int Tk,
       float scale, int causal, cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  const size_t smem = sizeof(float) * dq_smem_floats<D>();
  int rc = prepare(kern, smem);
  if (rc != 0) return rc;
  const int n_qt = (Tq + kB - 1) / kB;
  kern<<<(unsigned)(N * n_qt), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dqp), Tq, Tk, scale, causal, n_qt);
  return (int)cudaGetLastError();
}

// return FN<T, D>(...) for the (dtype, D) of the enclosing entry point
#define FLASH_DISPATCH(FN, ...)                                         \
  {                                                                     \
    if (dtype == kF32) {                                                \
      switch (D) {                                                      \
        case 16: return FN<float, 16>(__VA_ARGS__);                     \
        case 32: return FN<float, 32>(__VA_ARGS__);                     \
        case 64: return FN<float, 64>(__VA_ARGS__);                     \
        case 128: return FN<float, 128>(__VA_ARGS__);                   \
      }                                                                 \
    } else if (dtype == kBF16) {                                        \
      switch (D) {                                                      \
        case 16: return FN<__nv_bfloat16, 16>(__VA_ARGS__);             \
        case 32: return FN<__nv_bfloat16, 32>(__VA_ARGS__);             \
        case 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__);             \
        case 128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);           \
      }                                                                 \
    }                                                                   \
    return (int)cudaErrorInvalidValue;                                  \
  }

}  // namespace

// Plain C entry points (loaded with ctypes).  dtype: 0 float32, 1 bfloat16,
// the same for q, k, v, g and the outputs; lse and delta are float32
// [N, Tq].  All tensors are contiguous.  Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (0 = launched).

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, int N, int Tq, int Tk,
                                int D, float scale, int causal, int dtype,
                                void* stream) {
  if (N < 1 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, o, lse, N, Tq, Tk, scale, causal, st);
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* g,
                                     const float* lse, const float* delta,
                                     void* dk, void* dv, int N, int Tq, int Tk,
                                     int D, float scale, int causal, int dtype,
                                     void* stream) {
  if (N < 1 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkdv, q, k, v, g, lse, delta, dk, dv, N, Tq, Tk, scale,
                 causal, st);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const float* lse, const float* delta,
                                   void* dqp, int N, int Tq, int Tk, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (N < 1 || Tq < 1 || Tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq, q, k, v, g, lse, delta, dqp, N, Tq, Tk, scale, causal,
                 st);
}
