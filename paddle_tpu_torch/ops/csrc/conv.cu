// 3x3 SAME convolution over NHWC as an implicit GEMM, for Hopper (sm_90a),
// written by hand; optionally with a folded batch norm and a ReLU in its
// epilogue.
//
// Replaces the two Pallas TPU kernels of benchmark/conv_probe.py:
//   igemm_kernel<T, false, V>  <- _igemm_kernel        (via igemm_conv)
//   igemm_kernel<T, true, V>   <- _igemm_fused_kernel  (via igemm_conv_fused)
//
// What they compute, for x [N, H, W, C] (NHWC, un-padded) and w [3, 3, C, O]
// (HWIO), with x read as zero outside the image (SAME padding of 1):
//   acc[n, h, w, o] = sum_{dy, dx, c} x[n, h + dy - 1, w + dx - 1, c]
//                                     * w[dy, dx, c, o]
// accumulated in float32 from operands in the input type (the probe's nine
// shifted [H*W, C] @ [C, O] products, _igemm_accumulate); the plain form
// writes acc, the fused form max(acc * a[o] + b[o], 0) with a and b float32
// [O] (the folded batch norm a = scale * rsqrt(var + eps), b = bias - mean *
// a), the epilogue in float32 (multiply, then add, each rounded: no fused
// multiply-add, as the plain version computes it), and the output rounded
// once to the input type.
//
// As a GEMM: M = N*H*W output pixels, N_gemm = O, K = 9*C taken tap by tap
// (k = (dy*3 + dx)*C + c, so w is the row-major [9C, O] matrix as it
// stands).  The TPU kernel gives one image per grid step and lets the MXU
// take whole [H*W, C] @ [C, O] products out of VMEM; on the H100 a block
// owns a BM x BN tile of (pixels, output channels) and walks K in BK-deep
// slices, each slice one tap and a run of channels:
//   * the A slice (BM pixels x BK channels of one tap) is gathered straight
//     from x: a pixel's channels are contiguous in NHWC, so each row is
//     16-byte cp.async copies, and a pixel whose tap falls outside the
//     image (or past M, or a channel past C) is a zero-filled copy that
//     reads nothing: the zero padding costs no padded copy of x (the probe
//     pads with jnp.pad, one more pass over x).  Each pixel's (h, w) is
//     decoded once a block into shared memory;
//   * the B slice (BK x BN of w) comes the same way; w is small (at most
//     9 x 512 x 512) and stays in L2;
//   * two stages: slice it + 1 loads while slice it is multiplied;
//   * bfloat16 runs on the tensor cores, mma.sync.m16n8k16 (bf16 in, f32
//     accumulate): 128 x 64 tiles, four warps of 64 x 32, operands from
//     shared memory by ldmatrix (.trans for w), the layout of the bf16
//     flash forward (flash_attention.cu);
//   * float32 runs on the CUDA cores (FFMA): 128 x 64 tiles, 256 threads
//     as 16 x 16, each an 8 x 4 patch fed by 128-bit shared loads (8 rows
//     of A and 4 of B per 4 k: 128 FMAs per 12 loads);
//   * a 1-D grid with the output-channel tiles of one pixel tile adjacent,
//     so the x rows a pixel tile gathers are read from L2 by its siblings.
// Any N, H, W, C and O: the 16-byte path needs C and O multiples of 16
// bytes' worth of elements and aligned pointers (V = true); any other shape
// (the CIFAR stem's C = 3, ragged channels) takes element-by-element loads
// and stores (V = false).  One writer per output element and no atomics:
// results repeat exactly from run to run.
//
// What bounds them on the H100 at ResNet-50's shapes (bs = 256): bfloat16
// is on the line between bytes and operations (56x56x64: 59.2 GFLOP, 0.060
// ms at 989 TFLOP/s, against 205.5 MB of x and output, 0.061 ms at 3.35
// TB/s); float32 is bound by operations (0.883 ms at 67 TFLOP/s).  This is
// the simple first kernel: mma.sync reaches a part of the tensor cores'
// rate, and the two-stage ring, 16-byte bf16x2 epilogue stores and 128 x 64
// tiles are not tuned.  Later work: wgmma fed by TMA, a deeper ring, a
// shared-memory staged epilogue, tiles chosen by shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 64, BK = 32, kThreads = 128;
};
template <>
struct Tile<float> {
  static constexpr int BM = 128, BN = 64, BK = 16, kThreads = 256;
};

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes from global to shared memory without a register round trip;
// zero-filled (and the source not read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a . b for one 16 x 8 tile, k = 16
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The epilogue of one accumulator: the folded batch norm and the ReLU
// (fused form), in float32, multiply and add each rounded
template <bool kFused>
__device__ __forceinline__ float epilogue(float acc, float a, float b) {
  if constexpr (kFused) {
    return fmaxf(__fadd_rn(__fmul_rn(acc, a), b), 0.f);
  } else {
    return acc;
  }
}

// Slice `it` of K (tap it / n_c, channels (it % n_c) * BK on) into one
// stage: A [BM][LDA] gathered from x, B [BK][LDB] from w.  With V, by
// 16-byte cp.async copies (committed by the caller); without, element by
// element, stored directly.  A zero stands wherever the tap leaves the
// image, the pixel is past M, or the channel past C; B is zero past C and O.
template <typename T, bool V>
__device__ __forceinline__ void load_slice(
    T* a_s, T* b_s, const T* __restrict__ x, const T* __restrict__ w,
    const int* s_p, const int* s_h, const int* s_w, int it, int n_c, int o0,
    int H, int W, int C, int O) {
  using G = Tile<T>;
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK, NT = G::kThreads;
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int LDA = BK + kPer, LDB = BN + kPer;
  const int tap = it / n_c, c0 = (it % n_c) * BK;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int shift = dy * W + dx;  // pixel offset of the tap
  if constexpr (V) {
    constexpr int kChA = BK / kPer;
    for (int i = threadIdx.x; i < BM * kChA; i += NT) {
      const int r = i / kChA, cc = (i % kChA) * kPer;
      const int ih = s_h[r] + dy, iw = s_w[r] + dx, c = c0 + cc;
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W && c < C;
      const T* src = ok ? x + ((int64_t)s_p[r] + shift) * C + c : x;
      cp_async16(a_s + r * LDA + cc, src, ok);
    }
    constexpr int kChB = BN / kPer;
    for (int i = threadIdx.x; i < BK * kChB; i += NT) {
      const int r = i / kChB, oc = (i % kChB) * kPer;
      const int c = c0 + r, o = o0 + oc;
      const bool ok = c < C && o < O;
      const T* src = ok ? w + ((int64_t)tap * C + c) * O + o : w;
      cp_async16(b_s + r * LDB + oc, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, cc = i % BK;
      const int ih = s_h[r] + dy, iw = s_w[r] + dx, c = c0 + cc;
      const bool ok = ih >= 0 && ih < H && iw >= 0 && iw < W && c < C;
      a_s[r * LDA + cc] =
          ok ? x[((int64_t)s_p[r] + shift) * C + c] : zero_of<T>();
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int r = i / BN, oc = i % BN;
      const int c = c0 + r, o = o0 + oc;
      b_s[r * LDB + oc] = (c < C && o < O)
                              ? w[((int64_t)tap * C + c) * O + o]
                              : zero_of<T>();
    }
  }
}

// One block: the BM x BN output tile (pixels m0.., channels o0..).
template <typename T, bool kFused, bool V>
__global__ void __launch_bounds__(Tile<T>::kThreads)
    igemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ fa, const float* __restrict__ fb,
                 T* __restrict__ out, int M, int H, int W, int C, int O,
                 int n_ot) {
  using G = Tile<T>;
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK, NT = G::kThreads;
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int LDA = BK + kPer, LDB = BN + kPer;
  __shared__ __align__(16) T a_s[2 * BM * LDA];
  __shared__ __align__(16) T b_s[2 * BK * LDB];
  __shared__ int s_p[BM], s_h[BM], s_w[BM];

  const int m0 = (int)(blockIdx.x / n_ot) * BM;
  const int o0 = (int)(blockIdx.x % n_ot) * BN;
  const int HW = H * W;
  for (int r = threadIdx.x; r < BM; r += NT) {
    const int p = m0 + r;
    if (p < M) {
      const int hw = p % HW;
      s_p[r] = p;
      s_h[r] = hw / W;
      s_w[r] = hw % W;
    } else {  // every tap of a pixel past M falls outside the image
      s_p[r] = 0;
      s_h[r] = -4;
      s_w[r] = 0;
    }
  }
  __syncthreads();

  const int n_c = (C + BK - 1) / BK;
  const int n_it = 9 * n_c;
  load_slice<T, V>(a_s, b_s, x, w, s_p, s_h, s_w, 0, n_c, o0, H, W, C, O);
  cp_async_commit();

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // four warps as 2 x 2, each 64 pixels x 32 channels: 4 x 4 mma tiles
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp >> 1, wn = warp & 1;
    const int g = lane >> 2, t4 = lane & 3;
    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int it = 0; it < n_it; ++it) {
      if (it + 1 < n_it) {  // the other stage was freed at the end of it - 1
        const int st = (it + 1) & 1;
        load_slice<T, V>(a_s + st * BM * LDA, b_s + st * BK * LDB, x, w, s_p,
                         s_h, s_w, it + 1, n_c, o0, H, W, C, O);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* as = a_s + (it & 1) * BM * LDA;
      const T* bs = b_s + (it & 1) * BK * LDB;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[4][4], bf[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * LDA +
                                  ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4_trans(bf[np], bs + (ks * 16 + (lane & 15)) * LDB +
                                        wn * 32 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            mma_bf16(acc[mi][2 * np], af[mi], bf[np][0], bf[np][1]);
            mma_bf16(acc[mi][2 * np + 1], af[mi], bf[np][2], bf[np][3]);
          }
      }
      __syncthreads();  // stage it & 1 is free for slice it + 2
    }

    // lane (g, t4) holds rows g and g + 8, channels 2 t4 and 2 t4 + 1 of
    // each 16 x 8 tile
    float ea[4][2], eb[4][2];
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = o0 + wn * 32 + nj * 8 + 2 * t4 + e;
        ea[nj][e] = (kFused && o < O) ? fa[o] : 1.f;
        eb[nj][e] = (kFused && o < O) ? fb[o] : 0.f;
      }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 64 + mi * 16 + g + 8 * h;
        if (m >= M) continue;
        T* orow = out + (int64_t)m * O;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int o = o0 + wn * 32 + nj * 8 + 2 * t4;
          const float v0 =
              epilogue<kFused>(acc[mi][nj][2 * h], ea[nj][0], eb[nj][0]);
          const float v1 =
              epilogue<kFused>(acc[mi][nj][2 * h + 1], ea[nj][1], eb[nj][1]);
          if constexpr (V) {  // O % 8 == 0: o < O means o + 1 < O
            if (o < O)
              *reinterpret_cast<__nv_bfloat162*>(orow + o) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (o < O) orow[o] = __float2bfloat16(v0);
            if (o + 1 < O) orow[o + 1] = __float2bfloat16(v1);
          }
        }
      }
  } else {
    // 256 threads as 16 x 16, each rows ty * 8 + i and channels tx * 4 + j
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int it = 0; it < n_it; ++it) {
      if (it + 1 < n_it) {
        const int st = (it + 1) & 1;
        load_slice<T, V>(a_s + st * BM * LDA, b_s + st * BK * LDB, x, w, s_p,
                         s_h, s_w, it + 1, n_c, o0, H, W, C, O);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* as = reinterpret_cast<const float*>(a_s) + (it & 1) * BM * LDA;
      const float* bs = reinterpret_cast<const float*>(b_s) + (it & 1) * BK * LDB;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4) {
        float4 av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(as + (ty * 8 + i) * LDA + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + (kk + j) * LDB + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ak[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(ak[j], bv[j].x, acc[i][0]);
            acc[i][1] = fmaf(ak[j], bv[j].y, acc[i][1]);
            acc[i][2] = fmaf(ak[j], bv[j].z, acc[i][2]);
            acc[i][3] = fmaf(ak[j], bv[j].w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }

    const int oc = o0 + tx * 4;
    float ea[4], eb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ea[j] = (kFused && oc + j < O) ? fa[oc + j] : 1.f;
      eb[j] = (kFused && oc + j < O) ? fb[oc + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i;
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = epilogue<kFused>(acc[i][j], ea[j], eb[j]);
      float* orow = reinterpret_cast<float*>(out) + (int64_t)m * O;
      if constexpr (V) {  // O % 4 == 0: oc < O means oc + 3 < O
        if (oc < O)
          *reinterpret_cast<float4*>(orow + oc) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (oc + j < O) orow[oc + j] = v[j];
      }
    }
  }
}

template <typename T, bool kFused, bool V>
int launch(const void* x, const void* w, const float* fa, const float* fb,
           void* out, int M, int H, int W, int C, int O, cudaStream_t st) {
  using G = Tile<T>;
  const int64_t n_mt = ((int64_t)M + G::BM - 1) / G::BM;
  const int n_ot = (O + G::BN - 1) / G::BN;
  const int64_t blocks = n_mt * n_ot;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  igemm_kernel<T, kFused, V><<<(unsigned)blocks, G::kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), fa, fb,
      static_cast<T*>(out), M, H, W, C, O, n_ot);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, const float* fa, const float* fb,
             void* out, int M, int H, int W, int C, int O, int fused, int vec,
             cudaStream_t st) {
  if (fused) {
    return vec ? launch<T, true, true>(x, w, fa, fb, out, M, H, W, C, O, st)
               : launch<T, true, false>(x, w, fa, fb, out, M, H, W, C, O, st);
  }
  return vec ? launch<T, false, true>(x, w, fa, fb, out, M, H, W, C, O, st)
             : launch<T, false, false>(x, w, fa, fb, out, M, H, W, C, O, st);
}

}  // namespace

// One launch of the convolution on `stream`: x [N, H, W, C] and w [3, 3, C,
// O] of `dtype` (0 float32, 1 bfloat16), out [N, H, W, O] of the same type;
// with `fused`, a and b are float32 [O] and out = max(acc * a + b, 0).
// `vec` selects the 16-byte path, which the caller may set only when C and
// O are multiples of 16 bytes of elements and x, w and out are 16-byte
// aligned.  Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int igemm_conv_launch(const void* x, const void* w, const float* a,
                                 const float* b, void* out, int N, int H,
                                 int W, int C, int O, int dtype, int fused,
                                 int vec, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * H * W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (fused && (a == nullptr || b == nullptr))
    return (int)cudaErrorInvalidValue;
  const int M = N * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(x, w, a, b, out, M, H, W, C, O, fused, vec, st);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(x, w, a, b, out, M, H, W, C, O, fused, vec,
                                   st);
  return (int)cudaErrorInvalidValue;
}
