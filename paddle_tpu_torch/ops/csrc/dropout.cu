// Dropout's mask for Hopper (sm_90a), written by hand: the forward
// y = x * keep and the backward dx = dy * keep, with the keep mask drawn
// inside the kernel from JAX's threefry2x32, bit for bit.
//
// Replaces no Pallas kernel.  On the TPU the JAX package's dropout
// (paddle_tpu/layers/nn.py:449-458: jax.random.bernoulli, then a * mask)
// is fused by XLA into one pass; here one launch draws the mask and
// applies it, and the backward launch draws the same mask again instead
// of reading a stored one.
//
// The mask, as jax.random does it with jax_threefry_partitionable on:
//   key(seed)         = (0, seed & 0xFFFFFFFF)  (JAX's 32-bit mode)
//   fold_in(k, d)     = threefry2x32(k, (0, d))
//   op key            = fold_in(fold_in(key(seed), step), tag)
//   bits[i]           = x0 ^ x1 of threefry2x32(op key, (i >> 32, i & ~0u)),
//                       i the row-major index of the element
//   u[i]              = float32 from the bits ((bits >> 9) | 0x3F800000) - 1
//   keep[i]           = u[i] < keep_prob, keep_prob = float32(1 - p)
// (jax/_src/prng.py threefry_2x32, threefry_fold_in and
// _threefry_random_bits_partitionable; jax/_src/random.py _uniform and
// _bernoulli).  The step word is read from device memory when step_ptr is
// given: a warmed step's CUDA graph reads the step counter that the
// Executor stages before each replay, so each replay draws its own masks.
// Otherwise (an eager step) step_imm is the step.
//
// What bounds it on the H100: bytes in float32, instruction issue in
// bfloat16.  Per element one threefry2x32 (20 rounds of add, rotate, xor
// and 5 key injections, about 72 32-bit operations) and a few more to make
// the float and apply the mask, against 8 bytes moved in float32 (x in,
// y out; 4 in bfloat16).  Integer adds issue as IMAD on the FMA pipe
// beside the INT32 pipe's shifts and logic ops, so the ceiling is the
// issue rate, one warp instruction a clock per scheduler (about 33 T a
// second): at [8, 1024, 512] the operations take about 9.4 us and the
// bytes 10 us (float32) or 5 us (bfloat16).  The design keeps the issue
// slots on the hash:
// the op key is derived once a block (thread 0, into shared memory), the
// rotations are single funnel shifts, and each thread walks the elements
// with a grid stride so that the card holds 2048 threads an SM.  Every
// output has one writer; the result does not depend on the launch shape.
// The multiply by 0 or 1 is exact, in float32 for both types, so y and dx
// are bitwise the plain version's (ops/dropout.py), signed zeros and NaNs
// included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ void tf_round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

// threefry2x32 of the counter (c0, c1) under the key (k0, k1): 20 rounds
// with JAX's rotation schedule and key injections.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t c0, uint32_t c1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i,
                                        float v) {
  p[i] = __float2bfloat16_rn(v);  // exact: v is an input value or +-0
}

// Where a rank's slice lies in the global tensor (ops/dropout.py
// CounterMap): local index i draws the bits of global index
//   base + i                                        when row == 0,
//   base + (i / row) * stride + f(i % row)          otherwise, where
//   f(c) = (c < seg ? off0 : off1) + c              when row2 == 0,
//   f(c) = ((q < seg ? off0 : off1) + q) * stride2 + off2 + c % row2,
//          q = c / row2                             when row2 > 0,
// so a slice under a mesh draws the global tensor's mask at its elements:
// one level for dp rows and an sp slice (contiguous or striped), or a
// tensor-parallel slice of the last dim (row the local width, stride the
// global one); two for a tp slice of the last dim inside an sp slice
// (row2 the local width, stride2 the global one, off2 the rank's column).
struct CounterMap {
  int64_t base, row, stride, seg, off0, off1, row2, stride2, off2;
};

// out[i] = in[i] * keep[global index of i] for i < n.  kMapped 1 (row >
// 0, row2 == 0) or 2 (row2 > 0): a thread divides its first index by row
// (and the remainder by row2) once and then advances the quotients and
// remainders by the grid stride's, so no element pays for a 64-bit
// division; kMapped 0: the index is base + i, as for a whole tensor.
template <typename T, int kMapped>
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(const T* __restrict__ in, T* __restrict__ out, int64_t n,
                    uint32_t seed_hi, uint32_t seed_lo,
                    const int32_t* __restrict__ step_ptr, uint32_t step_imm,
                    uint32_t tag, float keep_prob, CounterMap cmap) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    const uint32_t step =
        step_ptr != nullptr ? static_cast<uint32_t>(*step_ptr) : step_imm;
    const uint2 sk = threefry2x32(seed_hi, seed_lo, 0u, step);
    const uint2 ok = threefry2x32(sk.x, sk.y, 0u, tag);
    key[0] = ok.x;
    key[1] = ok.y;
  }
  __syncthreads();
  const uint32_t k0 = key[0], k1 = key[1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // kMapped 1: i = r * row + c, the stride = dr * row + dc;
  // kMapped 2: c = q * row2 + c2 too, and dc = dq * row2 + dc2
  int64_t r = 0, c = 0, dr = 0, dc = 0, q = 0, dq = 0, qrow = 0;
  if (kMapped > 0) {
    r = i / cmap.row;
    c = i - r * cmap.row;
    dr = stride / cmap.row;
    dc = stride - dr * cmap.row;
  }
  if (kMapped == 2) {
    qrow = cmap.row / cmap.row2;
    q = c / cmap.row2;
    c -= q * cmap.row2;
    dq = dc / cmap.row2;
    dc -= dq * cmap.row2;
  }
  for (; i < n; i += stride) {
    int64_t g;
    if (kMapped == 1) {
      g = cmap.base + r * cmap.stride + (c < cmap.seg ? cmap.off0 : cmap.off1)
          + c;
      r += dr;
      c += dc;
      if (c >= cmap.row) {  // c, dc < row: one carry at most
        c -= cmap.row;
        ++r;
      }
    } else if (kMapped == 2) {
      g = cmap.base + r * cmap.stride
          + ((q < cmap.seg ? cmap.off0 : cmap.off1) + q) * cmap.stride2
          + cmap.off2 + c;
      r += dr;
      c += dc;
      if (c >= cmap.row2) {  // c, dc < row2: one carry at most
        c -= cmap.row2;
        ++q;
      }
      q += dq;
      if (q >= qrow) {  // q <= qrow and dq < qrow: one carry at most
        q -= qrow;
        ++r;
      }
    } else {
      g = cmap.base + i;
    }
    const uint2 h = threefry2x32(k0, k1, static_cast<uint32_t>(g >> 32),
                                 static_cast<uint32_t>(g));
    const uint32_t bits = h.x ^ h.y;
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float m = u < keep_prob ? 1.0f : 0.0f;
    store_f(out, i, load_f(in, i) * m);
  }
}

template <typename T>
void launch_mask(const void* in, void* out, long long n, unsigned blocks,
                 cudaStream_t st, unsigned seed_hi, unsigned seed_lo,
                 const int* step_ptr, unsigned step_imm, unsigned tag,
                 float keep_prob, const CounterMap& cmap) {
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  if (cmap.row == 0)
    dropout_mask_kernel<T, 0><<<blocks, kThreads, 0, st>>>(
        x, y, n, seed_hi, seed_lo, step_ptr, step_imm, tag, keep_prob, cmap);
  else if (cmap.row2 == 0)
    dropout_mask_kernel<T, 1><<<blocks, kThreads, 0, st>>>(
        x, y, n, seed_hi, seed_lo, step_ptr, step_imm, tag, keep_prob, cmap);
  else
    dropout_mask_kernel<T, 2><<<blocks, kThreads, 0, st>>>(
        x, y, n, seed_hi, seed_lo, step_ptr, step_imm, tag, keep_prob, cmap);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || count <= 0)
      count = 132;
  }
  return count;
}

}  // namespace

extern "C" {

// out = in * keep over n elements (dtype 0 float32, 1 bfloat16): the
// forward with in = x, the backward with in = dy (the same mask for the
// same arguments).  The mask is drawn from (seed_hi, seed_lo), the step
// (*step_ptr when step_ptr is not null, else step_imm) and tag, keeping
// where the uniform is below keep_prob, at the global indices the counter
// map (base, row, stride, seg, off0, off1, row2, stride2, off2) gives;
// all zero is the whole tensor.  Returns 0 or the first CUDA error.
int dropout_launch(const void* in, void* out, long long n, unsigned seed_hi,
                   unsigned seed_lo, const int* step_ptr, unsigned step_imm,
                   unsigned tag, float keep_prob, int dtype, long long base,
                   long long row, long long stride, long long seg,
                   long long off0, long long off1, long long row2,
                   long long stride2, long long off2, void* stream) {
  if (n < 0 || row < 0 || row2 < 0 || (dtype != kF32 && dtype != kBF16) ||
      (row2 > 0 && (row == 0 || row % row2 != 0)))
    return (int)cudaErrorInvalidValue;
  const CounterMap cmap{base, row, stride, seg, off0, off1, row2, stride2,
                        off2};
  if (n == 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    launch_mask<float>(in, out, n, blocks, st, seed_hi, seed_lo, step_ptr,
                       step_imm, tag, keep_prob, cmap);
  else
    launch_mask<__nv_bfloat16>(in, out, n, blocks, st, seed_hi, seed_lo,
                               step_ptr, step_imm, tag, keep_prob, cmap);
  return (int)cudaGetLastError();
}

}  // extern "C"
