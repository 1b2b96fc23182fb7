// Paged decode attention for Hopper (sm_90a), written by hand.
//
// Replaces: paddle_tpu/ops/paged_attention.py::_decode_kernel (the Pallas
// TPU kernel that paged_attention reaches through pl.pallas_call).
//
// What it computes, for slot s, window row w, head h:
//   o[s,w,h,:] = softmax_t(mask(q[s,w,h] . K[s,h,t] * scale,
//                               t < lengths[s,w], fill -1e9)) @ V[s,h,t,:]
// where K/V of slot s are the arena tiles arena[tables[s,j], layer, h]
// ([Bs, Dh] each, contiguous).  An int8 arena is dequantized on load as
// int8 * scale[blk, layer, h, pos].  Scores and softmax run in float32;
// probabilities are rounded to the output type before the value product,
// which accumulates in float32 (the JAX package's dtype rules).
//
// What bounds it on the H100: bytes.  Each live K/V tile is streamed once
// from device memory (3.35 TB/s); the work per byte is about one
// multiply-add per element, far below the ~20 flops/byte at which float32
// CUDA-core arithmetic would bind.  The design therefore streams each tile
// once and keeps everything else on chip:
//   * one thread block per (head, slot) reads its own row of the block table
//     (the TPU kernel used scalar prefetch for this);
//   * pass 1: each warp takes one position at a time, lanes split Dh, and
//     the score for every window row is reduced with warp shuffles into a
//     [W, T_live] float32 score buffer in shared memory;
//   * a full-row block reduction gives each row's max and sum (the TPU
//     kernel carried scores across its sequential grid; on Hopper a loop
//     inside the block takes the grid's place);
//   * pass 2: threads own one Dh element each and stride over positions,
//     partial sums per thread group are combined in shared memory.
// Table columns that lie wholly at or past max_w lengths[s,w] are skipped:
// after the -1e9 fill their weights are exactly 0, so the skip changes no
// result (when some row has length <= 0 every column is kept, because such a
// row averages over all of T in the plain version).
//
// Later work, not done here: wgmma tiles for long windows, TMA/cp.async
// double-buffered tile loads, and a split over T (flash-decoding) so that
// few slots still fill the 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// MAX_WINDOW and _RED_SLOTS in ../paged_attention.py size the launch's
// dynamic shared memory from these two; change them together.
constexpr int kMaxW = 8;      // largest decode window the kernel takes
constexpr int kRedSlots = 32;  // shared floats for block reductions

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result.  The leading
// __syncthreads protects `red` from the previous reduction's readers.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r += red[i];
  return r;
}

template <typename QT, typename KT, typename OT>
__global__ void paged_decode_kernel(
    const QT* __restrict__ q,            // [S, W, H, Dh]
    const KT* __restrict__ k_arena,      // [NB, L, H, Bs, Dh]
    const KT* __restrict__ v_arena,      // [NB, L, H, Bs, Dh]
    const float* __restrict__ k_scale,   // [NB, L, H, Bs] (int8 only)
    const float* __restrict__ v_scale,   // [NB, L, H, Bs] (int8 only)
    const int* __restrict__ tables,      // [S, n_tbl]
    const int* __restrict__ lengths,     // [S, W]
    OT* __restrict__ out,                // [S, W, H, Dh]
    int W, int H, int Dh, int Bs, int n_tbl, int n_arena_blocks, int L,
    int layer, float scale) {
  constexpr bool kQuant = sizeof(KT) == 1;
  constexpr bool kRoundProbs = sizeof(OT) == 2;
  extern __shared__ float smem[];
  const int h = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const int T = n_tbl * Bs;
  const int G = nthr / Dh;  // thread groups of the value pass

  float* q_s = smem;                  // [W, Dh]
  float* sc = q_s + W * Dh;           // [W, T_live] (room for [W, T])
  float* part = sc + W * T;           // [G, W, Dh]
  float* red = part + G * W * Dh;     // [kRedSlots]

  int len[kMaxW];
  int max_len = 0, min_len = 0x7fffffff;
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    len[w] = w < W ? lengths[s * W + w] : 0;
    if (w < W) {
      max_len = max(max_len, len[w]);
      min_len = min(min_len, len[w]);
    }
  }
  const int n_live =
      min_len <= 0 ? n_tbl : min(n_tbl, (max_len + Bs - 1) / Bs);
  const int T_live = n_live * Bs;

  for (int i = tid; i < W * Dh; i += nthr) {
    const int w = i / Dh, d = i - w * Dh;
    q_s[i] = to_f32(q[((int64_t)(s * W + w) * H + h) * Dh + d]);
  }
  __syncthreads();

  // pass 1: scores, one position per warp at a time
  for (int t = warp; t < T_live; t += nwarps) {
    const int j = t / Bs, r = t - j * Bs;
    int blk = tables[(int64_t)s * n_tbl + j];
    blk = min(max(blk, 0), n_arena_blocks - 1);  // JAX clamps gathers
    const int64_t row = (((int64_t)blk * L + layer) * H + h) * Bs + r;
    const KT* krow = k_arena + row * Dh;
    float acc[kMaxW];
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) acc[w] = 0.f;
    for (int d = lane; d < Dh; d += 32) {
      float kv = to_f32(krow[d]);
      if constexpr (kQuant) kv *= k_scale[row];
#pragma unroll
      for (int w = 0; w < kMaxW; ++w)
        if (w < W) acc[w] += q_s[w * Dh + d] * kv;
    }
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w < W) {
        const float v = warp_sum(acc[w]);
        if (lane == 0) sc[w * T_live + t] = t < len[w] ? v * scale : -1e9f;
      }
    }
  }
  __syncthreads();

  // full-row softmax per window row: max, exp, sum, normalise
  for (int w = 0; w < W; ++w) {
    float* rowp = sc + w * T_live;
    float m = -INFINITY;
    for (int t = tid; t < T_live; t += nthr) m = fmaxf(m, rowp[t]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int t = tid; t < T_live; t += nthr) {
      const float e = expf(rowp[t] - m);
      rowp[t] = e;
      sum += e;
    }
    sum = block_sum(sum, red);
    for (int t = tid; t < T_live; t += nthr) {
      float p = rowp[t] / sum;
      if constexpr (kRoundProbs) p = __bfloat162float(__float2bfloat16(p));
      rowp[t] = p;
    }
  }
  __syncthreads();

  // pass 2: value product; thread (g, d) strides over positions t = g mod G
  const int d = tid % Dh, g = tid / Dh;
  float acc[kMaxW];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) acc[w] = 0.f;
  if (g < G) {
    for (int t = g; t < T_live; t += G) {
      const int j = t / Bs, r = t - j * Bs;
      int blk = tables[(int64_t)s * n_tbl + j];
      blk = min(max(blk, 0), n_arena_blocks - 1);
      const int64_t row = (((int64_t)blk * L + layer) * H + h) * Bs + r;
      float vv = to_f32(v_arena[row * Dh + d]);
      if constexpr (kQuant) vv *= v_scale[row];
#pragma unroll
      for (int w = 0; w < kMaxW; ++w)
        if (w < W) acc[w] += sc[w * T_live + t] * vv;
    }
#pragma unroll
    for (int w = 0; w < kMaxW; ++w)
      if (w < W) part[(g * W + w) * Dh + d] = acc[w];
  }
  __syncthreads();
  for (int i = tid; i < W * Dh; i += nthr) {
    const int w = i / Dh, dd = i - w * Dh;
    float o = 0.f;
    for (int gg = 0; gg < G; ++gg) o += part[(gg * W + w) * Dh + dd];
    out[((int64_t)(s * W + w) * H + h) * Dh + dd] = from_f32<OT>(o);
  }
}

template <typename QT, typename KT, typename OT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* tables, const int* lengths, void* out,
           int S, int W, int H, int Dh, int Bs, int n_tbl, int n_arena_blocks,
           int L, int layer, float scale, int nthreads, size_t smem,
           cudaStream_t stream) {
  auto kern = paged_decode_kernel<QT, KT, OT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(H, S);
  kern<<<grid, nthreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, tables, lengths,
      static_cast<OT*>(out), W, H, Dh, Bs, n_tbl, n_arena_blocks, L, layer,
      scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int dispatch_out(int out_dtype, const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* tables,
                 const int* lengths, void* out, int S, int W, int H, int Dh,
                 int Bs, int n_tbl, int nb, int L, int layer, float scale,
                 int nthreads, size_t smem, cudaStream_t st) {
  if (out_dtype == kF32)
    return launch<QT, KT, float>(q, k, v, ks, vs, tables, lengths, out, S, W,
                                 H, Dh, Bs, n_tbl, nb, L, layer, scale,
                                 nthreads, smem, st);
  if (out_dtype == kBF16)
    return launch<QT, KT, __nv_bfloat16>(q, k, v, ks, vs, tables, lengths,
                                         out, S, W, H, Dh, Bs, n_tbl, nb, L,
                                         layer, scale, nthreads, smem, st);
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int dispatch_kv(int kv_dtype, int out_dtype, const void* q, const void* k,
                const void* v, const float* ks, const float* vs,
                const int* tables, const int* lengths, void* out, int S, int W,
                int H, int Dh, int Bs, int n_tbl, int nb, int L, int layer,
                float scale, int nthreads, size_t smem, cudaStream_t st) {
  if (kv_dtype == kF32)
    return dispatch_out<QT, float>(out_dtype, q, k, v, ks, vs, tables,
                                   lengths, out, S, W, H, Dh, Bs, n_tbl, nb,
                                   L, layer, scale, nthreads, smem, st);
  if (kv_dtype == kBF16)
    return dispatch_out<QT, __nv_bfloat16>(out_dtype, q, k, v, ks, vs, tables,
                                           lengths, out, S, W, H, Dh, Bs,
                                           n_tbl, nb, L, layer, scale,
                                           nthreads, smem, st);
  if (kv_dtype == kI8)
    return dispatch_out<QT, int8_t>(out_dtype, q, k, v, ks, vs, tables,
                                    lengths, out, S, W, H, Dh, Bs, n_tbl, nb,
                                    L, layer, scale, nthreads, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Dtype codes: 0 float32,
// 1 bfloat16, 2 int8 (arena only; ks/vs then point at the float32 scale
// planes).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() of the launch (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_arena, const void* v_arena,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* lengths, void* out, int S, int W, int H, int Dh, int Bs,
    int n_tbl, int n_arena_blocks, int L, int layer, float scale,
    int q_dtype, int kv_dtype, int out_dtype, int nthreads,
    long long smem_bytes, void* stream) {
  if (W < 1 || W > kMaxW || nthreads % Dh != 0 || nthreads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32)
    return dispatch_kv<float>(kv_dtype, out_dtype, q, k_arena, v_arena,
                              k_scale, v_scale, tables, lengths, out, S, W, H,
                              Dh, Bs, n_tbl, n_arena_blocks, L, layer, scale,
                              nthreads, smem, st);
  if (q_dtype == kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, out_dtype, q, k_arena,
                                      v_arena, k_scale, v_scale, tables,
                                      lengths, out, S, W, H, Dh, Bs, n_tbl,
                                      n_arena_blocks, L, layer, scale,
                                      nthreads, smem, st);
  return (int)cudaErrorInvalidValue;
}
