// Batch-norm backward for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of benchmark/bn_probe.py:
//   * _red_kernel (via pallas_reduce_flat) with bn_bwd_reduce_kernel (and
//     bn_bwd_combine_kernel): per channel c, over the batch and the spatial
//     positions (N x HW, M = N * HW values a channel),
//       dbeta[c]  = sum dy
//       dgamma[c] = sum dy * xhat,   xhat = (x - mean[c]) * rstd[c]
//     accumulated in float32;
//   * _dx_kernel (via pallas_dx_flat) with bn_bwd_dx_kernel:
//       dx = gamma[c] * rstd[c] * (dy - dbeta[c] / M - xhat * dgamma[c] / M)
//     computed in float32 and written in dy's type.  M is an argument, the
//     values a channel of the whole batch: N * HW on one device; under
//     data parallelism dbeta and dgamma are the sums over every rank and M
//     the global count, while the rank's dy and x are its own rows.
// The probe's kernels read a saved xhat; these recompute it from x, mean
// and rstd, which the batch-norm forward (paddle_tpu/layers/nn.py:339-377)
// has anyway, so the forward saves x and no activation-sized xhat.
//
// Operands: dy, x and dx are NCHW contiguous (viewed as [N, C, HW]) in
// float32 or bfloat16 (dy and x of one type); mean, rstd, gamma, dbeta and
// dgamma are float32 [C].  Any N, C and HW.
//
// What bounds them on the H100: bytes.  Per element the reduction does 3
// float32 operations and dx 4 on 4-8 bytes read (float32) or 2-4 (bf16),
// far below the ~20 operations a byte where the CUDA cores would bind.  At
// the probe's shape (N=256, C=256, 56x56, M = 802,816) the reduction reads
// dy and x once, 2 x 411 MB in bf16 (0.245 ms at 3.35 TB/s); dx reads both
// and writes dx, 3 x 411 MB (0.368 ms).  So the design keeps every SM
// streaming:
//   * one grid for both kernels, (channel, split): block (c, s) walks the
//     s-th run of channel c's M values, flattened over (n, hw), so a block
//     never idles on a short row (HW = 49 at the last stage).  The wrapper
//     picks the number of splits so that C x splits fills the 132 SMs about
//     twice at full occupancy (8 blocks of 256 threads an SM): at C = 64,
//     one block a channel would have used 64 SMs;
//   * wide loads: a thread loads V values of a row at once, 16 bytes where
//     HW and the pointers allow (4 float32, 8 bf16), and keeps its
//     position as (n, hw) updated by addition, with no division a step;
//   * the reduction keeps two float32 sums a thread, reduces them over the
//     block by shuffles and shared memory in a fixed order, and writes one
//     (sum dy, sum dy * (x - mean)) partial a block into float32 scratch;
//     bn_bwd_combine_kernel adds a channel's partials in split order and
//     multiplies by rstd once.  One writer per output, no atomics: results
//     repeat exactly.  With one split the block writes dbeta and dgamma
//     itself and there is no combine launch;
//   * dx forms its per-channel coefficients gamma * rstd, dbeta / M and
//     dgamma * rstd / M once a block (the block's channel is fixed), not
//     once an element, and rounds each result once, to dy's type.
// What is left for later work: the reduction could also emit the dx
// coefficients, and dx could be fused into the producer of dy (the ReLU
// backward) so that dy is read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// V values of type T at p (aligned to V * sizeof(T)) as float32, and back.
template <typename T, int V>
struct VecIO;

template <int V>
struct VecIO<float, V> {
  static_assert(V == 1 || V == 2 || V == 4, "float32 vectors of 1, 2 or 4");
  static __device__ __forceinline__ void load(const float* p, float (&o)[V]) {
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    } else if constexpr (V == 2) {
      const float2 a = *reinterpret_cast<const float2*>(p);
      o[0] = a.x; o[1] = a.y;
    } else {
      o[0] = *p;
    }
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[V]) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
    } else {
      *p = o[0];
    }
  }
};

template <int V>
struct VecIO<__nv_bfloat16, V> {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8,
                "bfloat16 vectors of 1, 2, 4 or 8");
  // a bfloat16 is the high half of a float32: widening is a shift
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[V]) {
    if constexpr (V == 1) {
      o[0] = __uint_as_float(
          (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
    } else {
      unsigned w[V / 2];
      if constexpr (V == 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(p);
        w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      } else if constexpr (V == 4) {
        const uint2 a = *reinterpret_cast<const uint2*>(p);
        w[0] = a.x; w[1] = a.y;
      } else {
        w[0] = *reinterpret_cast<const unsigned*>(p);
      }
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {   // little-endian: element 2k low
        o[2 * k] = __uint_as_float(w[k] << 16);
        o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
  // round to nearest even, as torch's .to(torch.bfloat16)
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&o)[V]) {
    unsigned short b[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      b[i] = __bfloat16_as_ushort(__float2bfloat16_rn(o[i]));
    if constexpr (V == 1) {
      *reinterpret_cast<unsigned short*>(p) = b[0];
    } else {
      unsigned w[V / 2];
#pragma unroll
      for (int k = 0; k < V / 2; ++k)
        w[k] = (unsigned)b[2 * k] | ((unsigned)b[2 * k + 1] << 16);
      if constexpr (V == 8) {
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      } else if constexpr (V == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      } else {
        *reinterpret_cast<unsigned*>(p) = w[0];
      }
    }
  }
};

// The walk of block (c, s) over channel c's values: vectors j in
// [begin, end) of the channel's n_rows * hw_v, flattened as j = n * hw_v + r,
// a thread starting at begin + threadIdx.x and stepping by kThreads.  The
// offset (in elements) of vector (n, r) is ((n * C + c) * hw_v + r) * V.
struct Walk {
  int64_t j, end, off;
  int r;
  int dn, dr, hw_v;
  int64_t row_step;   // elements from (n, c) to (n + 1, c)

  __device__ __forceinline__ Walk(int c, int C, int n_rows, int hw_v_,
                                  int64_t chunk, int V) {
    hw_v = hw_v_;
    const int64_t total = (int64_t)n_rows * hw_v;
    const int64_t begin = (int64_t)blockIdx.y * chunk;
    end = begin + chunk < total ? begin + chunk : total;
    j = begin + threadIdx.x;
    const int64_t n = j / hw_v;                 // the walk's only division
    r = (int)(j - n * hw_v);
    dn = kThreads / hw_v;
    dr = kThreads % hw_v;
    row_step = (int64_t)C * hw_v * V;
    off = ((n * C + c) * hw_v + r) * V;
  }
  __device__ __forceinline__ bool more() const { return j < end; }
  __device__ __forceinline__ void next(int V) {
    j += kThreads;
    r += dr;
    int64_t rows = dn;
    if (r >= hw_v) {
      r -= hw_v;
      ++rows;
    }
    off += rows * row_step + (int64_t)(dr - (rows - dn) * hw_v) * V;
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         float* __restrict__ part_sum,
                         float* __restrict__ part_dot,
                         float* __restrict__ dbeta,
                         float* __restrict__ dgamma, int C, int n_rows,
                         int hw_v, int64_t chunk) {
  const int c = blockIdx.x;
  const float mu = mean[c];
  float sum = 0.f, dot = 0.f;
  for (Walk w(c, C, n_rows, hw_v, chunk, V); w.more(); w.next(V)) {
    float g[V], v[V];
    VecIO<T, V>::load(dy + w.off, g);
    VecIO<T, V>::load(x + w.off, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sum += g[i];
      dot = fmaf(g[i], v[i] - mu, dot);
    }
  }
  // block sum in a fixed order: shuffles within each warp, then warp 0
  // over the warps' results
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  }
  __shared__ float s_sum[kWarps], s_dot[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_sum[warp] = sum;
    s_dot[warp] = dot;
  }
  __syncthreads();
  if (warp != 0) return;
  sum = lane < kWarps ? s_sum[lane] : 0.f;
  dot = lane < kWarps ? s_dot[lane] : 0.f;
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
  }
  if (lane != 0) return;
  if (gridDim.y == 1) {
    dbeta[c] = sum;
    dgamma[c] = dot * rstd[c];
  } else {
    part_sum[(int64_t)blockIdx.y * C + c] = sum;
    part_dot[(int64_t)blockIdx.y * C + c] = dot;
  }
}

// one thread a channel: the splits' partials in split order
__global__ void bn_bwd_combine_kernel(const float* __restrict__ part_sum,
                                      const float* __restrict__ part_dot,
                                      const float* __restrict__ rstd,
                                      float* __restrict__ dbeta,
                                      float* __restrict__ dgamma, int C,
                                      int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sum = 0.f, dot = 0.f;
  for (int s = 0; s < splits; ++s) {
    sum += part_sum[(int64_t)s * C + c];
    dot += part_dot[(int64_t)s * C + c];
  }
  dbeta[c] = sum;
  dgamma[c] = dot * rstd[c];
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const float* __restrict__ gamma,
                     const float* __restrict__ dbeta,
                     const float* __restrict__ dgamma, T* __restrict__ dx,
                     int C, int n_rows, int hw_v, int64_t chunk,
                     float inv_m) {
  const int c = blockIdx.x;
  const float mu = mean[c], rs = rstd[c];
  const float a = gamma[c] * rs;          // gamma * rstd
  const float kb = dbeta[c] * inv_m;      // dbeta / M
  const float kg = dgamma[c] * rs * inv_m;  // rstd * dgamma / M
  for (Walk w(c, C, n_rows, hw_v, chunk, V); w.more(); w.next(V)) {
    float g[V], v[V];
    VecIO<T, V>::load(dy + w.off, g);
    VecIO<T, V>::load(x + w.off, v);
#pragma unroll
    for (int i = 0; i < V; ++i) g[i] = a * (g[i] - kb - (v[i] - mu) * kg);
    VecIO<T, V>::store(dx + w.off, g);
  }
}

template <typename T, int V>
int reduce_launch(const void* dy, const void* x, const float* mean,
                  const float* rstd, float* part_sum, float* part_dot,
                  float* dbeta, float* dgamma, int N, int C, int HW,
                  int splits, cudaStream_t st) {
  const int hw_v = HW / V;
  const int64_t total = (int64_t)N * hw_v;
  const int64_t chunk = (total + splits - 1) / splits;
  bn_bwd_reduce_kernel<T, V><<<dim3(C, splits), kThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), mean, rstd,
      part_sum, part_dot, dbeta, dgamma, C, N, hw_v, chunk);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dx_launch(const void* dy, const void* x, const float* mean,
              const float* rstd, const float* gamma, const float* dbeta,
              const float* dgamma, void* dx, int N, int C, int HW,
              int splits, int64_t count, cudaStream_t st) {
  const int hw_v = HW / V;
  const int64_t total = (int64_t)N * hw_v;
  const int64_t chunk = (total + splits - 1) / splits;
  const float inv_m = 1.0f / (float)count;
  bn_bwd_dx_kernel<T, V><<<dim3(C, splits), kThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), mean, rstd, gamma,
      dbeta, dgamma, static_cast<T*>(dx), C, N, hw_v, chunk, inv_m);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int C, int HW, int splits, int vec, int dtype) {
  const int max_vec = dtype == kBF16 ? 8 : 4;
  return N < 1 || C < 1 || HW < 1 || splits < 1 || splits > 65535 ||
         vec < 1 || vec > max_vec || (vec & (vec - 1)) != 0 ||
         HW % vec != 0 || (dtype != kF32 && dtype != kBF16);
}

}  // namespace

extern "C" {

// dbeta and dgamma [C] from dy and x [N, C, HW] (dtype 0 float32, 1
// bfloat16), mean and rstd [C].  With splits > 1 the partials go through
// part_sum and part_dot [splits, C] and a combine launch; with one split
// the reduction writes dbeta and dgamma itself.  vec values a load (HW and
// every pointer a multiple of it).  Returns 0 or the first CUDA error.
int bn_bwd_reduce_launch(const void* dy, const void* x, const float* mean,
                         const float* rstd, float* part_sum, float* part_dot,
                         float* dbeta, float* dgamma, int N, int C, int HW,
                         int splits, int vec, int dtype, void* stream) {
  if (bad_shape(N, C, HW, splits, vec, dtype) ||
      (splits > 1 && (part_sum == nullptr || part_dot == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kF32) {
    if (vec == 4)
      rc = reduce_launch<float, 4>(dy, x, mean, rstd, part_sum, part_dot,
                                   dbeta, dgamma, N, C, HW, splits, st);
    else if (vec == 2)
      rc = reduce_launch<float, 2>(dy, x, mean, rstd, part_sum, part_dot,
                                   dbeta, dgamma, N, C, HW, splits, st);
    else
      rc = reduce_launch<float, 1>(dy, x, mean, rstd, part_sum, part_dot,
                                   dbeta, dgamma, N, C, HW, splits, st);
  } else {
    if (vec == 8)
      rc = reduce_launch<__nv_bfloat16, 8>(dy, x, mean, rstd, part_sum,
                                           part_dot, dbeta, dgamma, N, C, HW,
                                           splits, st);
    else if (vec == 4)
      rc = reduce_launch<__nv_bfloat16, 4>(dy, x, mean, rstd, part_sum,
                                           part_dot, dbeta, dgamma, N, C, HW,
                                           splits, st);
    else if (vec == 2)
      rc = reduce_launch<__nv_bfloat16, 2>(dy, x, mean, rstd, part_sum,
                                           part_dot, dbeta, dgamma, N, C, HW,
                                           splits, st);
    else
      rc = reduce_launch<__nv_bfloat16, 1>(dy, x, mean, rstd, part_sum,
                                           part_dot, dbeta, dgamma, N, C, HW,
                                           splits, st);
  }
  if (rc != 0 || splits == 1) return rc;
  bn_bwd_combine_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part_sum, part_dot, rstd, dbeta, dgamma, C, splits);
  return (int)cudaGetLastError();
}

// dx [N, C, HW] in dy's type from dy, x, and mean, rstd, gamma, dbeta,
// dgamma [C], with count = M, the values a channel that dbeta and dgamma
// sum over (N * HW, or the global batch's under data parallelism); grid and
// vec as for the reduction.
int bn_bwd_dx_launch(const void* dy, const void* x, const float* mean,
                     const float* rstd, const float* gamma,
                     const float* dbeta, const float* dgamma, void* dx,
                     int N, int C, int HW, int splits, int vec, int dtype,
                     long long count, void* stream) {
  if (bad_shape(N, C, HW, splits, vec, dtype) || count < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    if (vec == 4)
      return dx_launch<float, 4>(dy, x, mean, rstd, gamma, dbeta, dgamma, dx,
                                 N, C, HW, splits, count, st);
    if (vec == 2)
      return dx_launch<float, 2>(dy, x, mean, rstd, gamma, dbeta, dgamma, dx,
                                 N, C, HW, splits, count, st);
    return dx_launch<float, 1>(dy, x, mean, rstd, gamma, dbeta, dgamma, dx,
                               N, C, HW, splits, count, st);
  }
  if (vec == 8)
    return dx_launch<__nv_bfloat16, 8>(dy, x, mean, rstd, gamma, dbeta,
                                       dgamma, dx, N, C, HW, splits, count,
                                       st);
  if (vec == 4)
    return dx_launch<__nv_bfloat16, 4>(dy, x, mean, rstd, gamma, dbeta,
                                       dgamma, dx, N, C, HW, splits, count,
                                       st);
  if (vec == 2)
    return dx_launch<__nv_bfloat16, 2>(dy, x, mean, rstd, gamma, dbeta,
                                       dgamma, dx, N, C, HW, splits, count,
                                       st);
  return dx_launch<__nv_bfloat16, 1>(dy, x, mean, rstd, gamma, dbeta, dgamma,
                                     dx, N, C, HW, splits, count, st);
}

}  // extern "C"
