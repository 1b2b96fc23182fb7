// 3x3 SAME convolution over NHWC as an implicit GEMM, for Hopper (sm_90a),
// written by hand; optionally with a folded batch norm and a ReLU in its
// epilogue.
//
// Replaces the two Pallas TPU kernels of benchmark/conv_probe.py, each by
// three routes (below):
//   halo_kernel<false>, halo_f32_kernel<false>,  <- _igemm_kernel
//   igemm_kernel<T, false, V>                       (via igemm_conv)
//   halo_kernel<true>, halo_f32_kernel<true>,    <- _igemm_fused_kernel
//   igemm_kernel<T, true, V>                        (via igemm_conv_fused)
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
// Three routes, chosen by shape in ops/conv.py::conv_route, each a hand
// kernel (no fallback: the route is fixed before the launch):
//   * the halo route, halo_kernel<kFused>: bfloat16 with C and O multiples
//     of 64, aligned pointers and W + 2 <= 256, which is every ResNet 3x3
//     stride-1 conv (C = O in {64, 128, 256, 512});
//   * the halo_f32 route, halo_f32_kernel<kFused>: float32 with the same
//     channels and pointers and W + 2 <= 184, every ResNet 3x3 stride-1
//     conv in float32;
//   * the gather route, igemm_kernel<T, kFused, V> above: everything else
//     (the CIFAR stem's C = 3, ragged channels, misaligned pointers).
//
// What bounds them on the H100 at ResNet-50's shapes (bs = 256): bfloat16
// is on the line between bytes and operations (56x56x64: 59.2 GFLOP, 0.060
// ms at 989 TFLOP/s, against 205.5 MB of x and output, 0.061 ms at 3.35
// TB/s: bytes by a hair; 28x28x128: operations, 0.060 ms); float32 is bound
// by operations: 0.883 ms at the CUDA cores' 67 TFLOP/s (the gather
// route's FFMA), 0.359 ms as three TF32 passes at 495 TFLOP/s (the
// halo_f32 route), against 411 MB of x and output, 0.123 ms.
//
// The gather route is the first kernel: each tap re-gathers its A slice,
// so x crosses L2 nine times (925 MB at 56x56x64) and every 128-pixel block
// reads all of w (462 MB more); mma.sync caps the rate; the short two-stage
// ring waits on every 32-channel slice.  The halo route answers each:
//   * x about once: a tile is 256 consecutive points of one grid of pitch
//     W + 2 over all images (a zero column each side of a row, one zero row
//     between images), so tap (dy, dx) is one constant shift of a halo
//     buffer of 256 + 2 (W + 2) + 2 points, loaded once per 16 channels,
//     zero where a point holds no pixel (a zero-filling cp.async, no padded
//     copy of x): x crosses L2 1.46x at 56x56, 1.24x at 28x28.  The pitch
//     columns and zero rows are computed and dropped: 5% of the rows at
//     56x56, 10% at 28x28, 18% at 14x14, 32% at 7x7;
//   * w once per 256-pixel tile, not once per 128-pixel block, and by the
//     bulk-copy engine: a small kernel packs w into the stages' layout, so
//     a stage's w (9 taps x 16 channels x 64 outputs, 18 KB) is one
//     cp.async.bulk counted on an mbarrier, where 1,152 16-byte cp.async
//     cost the kernel about a third of its time (PERF.md);
//   * wgmma.m64n64k16 from shared memory: two warpgroups of 128 rows, the
//     halo in the no-swizzle K-major core-matrix layout ([8-channel group]
//     [point][8 channels]), so each tap's A is the same buffer at a start
//     16 (dy (W + 2) + dx) bytes on; w MN-major with the transpose bit;
//   * a three-stage ring (16 channels x 9 taps a stage), one barrier a
//     stage, the next stage's copies issued while the products run; about
//     91 KB at 56x56, so two blocks share an SM;
//   * the epilogue staged through shared memory and stored as 128-byte
//     rows, 16 bytes a thread.
// Tried and dropped (PERF.md): multicasting w across a cluster of 2
// or 4 (the cross-block release each stage cost more than the L2 reads it
// saved), a warp of its own for the copies, a persistent grid, 512-row
// and 64 x 128 tiles, a four-stage ring (one block an SM).  Later work:
// the halo by TMA (a tile of whole image rows, so that a tensor map
// zero-fills and lays out the halo), which needs a new tiling.
//
// The halo_f32 route replaces the gather route's float32 FFMA: the CUDA
// cores' 67 TFLOP/s bound it at 0.883 ms (56x56x64), and cuDNN's float32
// (TF32 off) is already past that at 28x28.  It keeps float32's accuracy
// on the tensor cores by splitting each operand v into two TF32 values,
// hi = rna_tf32(v) and lo = rna_tf32(v - hi) (cvt.rna.tf32.f32: 10 stored
// mantissa bits, unit roundoff u = 2^-11), and summing three products,
// a_lo b_hi + a_hi b_lo + a_hi b_hi, in that order.  The error: |v - hi|
// <= u |v|, and v - hi is exact in float32, so v = hi + lo + e with |e| <=
// u |v - hi| <= u^2 |v|; then a b - (a_lo b_hi + a_hi b_lo + a_hi b_hi) =
// a_lo b_lo + (terms in e_a, e_b), at most 3 u^2 (1 + O(u)) |a b| = 7.2e-7
// |a b| a product, so at most 7.2e-7 sum |a b| over a sum of products.
// With random data at ResNet's shapes sum |a b| is about (2 / pi) sqrt(K)
// / 5 max |out|, 3 (K = 576) to 9 (K = 4608), so the split costs at most
// 2.2e-6 to 6.5e-6 of max |out|, inside chip_smoke's 2e-5.  Each TF32 product is exact in
// float32 (11 x 11 significant bits).  Three passes at 495 TFLOP/s bound the route
// by operations at 0.359 ms at each ResNet shape (59.2 GFLOP); the bytes
// (x and the output, 411 MB at 56x56x64) take 0.123 ms.  The design:
//   * the halo route's grid of pitch W + 2 and 256-point tiles, the halo
//     raw float32 by cp.async ([4-channel group][point][4]), each tap one
//     shift; A from registers: each thread loads its fragment of the
//     shifted halo and splits it there, so the halo is stored once;
//   * w split and packed per call (halo_f32_pack_w) into the stages'
//     layout, K-major (TF32 wgmma takes no transpose), hi and lo a stage's
//     one bulk copy;
//   * wgmma.m64n64k8 TF32, two warpgroups of 128 rows; 16 channels a step
//     in a two-stage ring (about 193 KB at 56x56, one block an SM);
//   * the tensor cores' float32 accumulation is not rounded to nearest:
//     summed in one accumulator over K = 9 C products, the error grew with
//     K and passed 2e-5 of max |out| at 7x7x512 (PERF.md).  So each step's
//     products (9 taps x 16 channels, three passes) go into a fresh
//     accumulator that is then added into the float32 sum by a rounded
//     add, which keeps the worst error near 0.06 of the limit.
// What holds it at 0.40-0.50 of its bound (PERF.md): the product stream
// itself, one batch of m64n64k8 products a tap: with no fragment loads,
// barriers or drains the same products reach only 0.54-0.68 of it; the
// per-step barriers and drains add about 0.1 ms, the fragment loads and
// splits 0.08-0.15 ms.  No better: a three-stage ring of 8 channels,
// batches of three taps, two batches in flight, products issued pass by
// pass, m64n128 products, A from shared memory (the same stream).

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

// ------------------------------------------------------------ halo route
//
// bfloat16 with C and O multiples of 64, 16-byte aligned pointers and
// W + 2 <= kMaxPitch.  The images lie on one grid of pitch G = W + 2: row
// 0 is zeros, then image 0's H rows, a zero row, image 1's rows, ..., a
// last zero row; each grid row is a zero pixel, the image row's W pixels
// and a zero pixel.  Grid point g = R G + c' holds x[n, h, w] for R = n (H
// + 1) + 1 + h, c' = 1 + w.  An output pixel at grid point q reads tap
// (dy, dx) at q + (dy - 1) G + (dx - 1), so on this grid a tap is one
// constant shift.  A tile is BM consecutive grid points from q0 = G + t BM
// (the pitch columns, zero rows and points past the last image among them
// are computed and dropped); its halo is the NP = BM + 2 G + 2 points from
// q0 - G - 1, and output row r reads tap (dy, dx) at halo point r + dy G +
// dx.  The block walks K in steps of KC channels: each step brings the
// halo's KC channels and w's [9 taps][KC][BN] into one stage of the ring,
// and runs the nine taps as products of the same halo buffer at nine start
// points.
struct Halo {
  static constexpr int BM = 256, BN = 64, KC = 16, kStages = 3,
                       kThreads = 256, kMinBlocks = 2, kMaxPitch = 256;
};
// bytes of one tap's [KC][BN] w slice and of a stage's nine
constexpr int kHaloWTap = Halo::KC * Halo::BN * 2;
constexpr int kHaloWBytes = 9 * kHaloWTap;
// the output tile staged for the stores: [BM][kHaloLDO] bf16 (8 pad
// columns keep the accumulator writes off one bank)
constexpr int kHaloLDO = Halo::BN + 8;

// Halo points of a tile, and the stride between the halo's two 8-channel
// groups in points: NP rounded to 4 mod 8, so that the two groups a warp
// writes fall on different banks.
__host__ __device__ __forceinline__ int halo_points(int G) {
  return Halo::BM + 2 * G + 2;
}
__host__ __device__ __forceinline__ int halo_group_stride(int G) {
  return (halo_points(G) + 3) / 8 * 8 + 4;
}
// one stage: w [9][BN/8][KC][8] then the halo [KC/8][group stride][8]
__host__ __device__ __forceinline__ int halo_stage_bytes(int G) {
  const int b = kHaloWBytes + halo_group_stride(G) * Halo::KC * 2;
  return (b + 127) / 128 * 128;
}
// the ring, then the w stages' barriers, then the halo's pixel table
__host__ __device__ __forceinline__ int halo_smem_bytes(int G) {
  return Halo::kStages * halo_stage_bytes(G) + 8 * Halo::kStages +
         halo_points(G) * 4;
}

// A wgmma shared-memory descriptor, no swizzle (the INTERLEAVE core-matrix
// layout: 8 rows of 16 bytes, 128 contiguous bytes a core matrix): start
// address, LBO = the stride between core matrices along K, SBO = along M
// (or N), each in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void gmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void gmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void gmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators as written by an asm after the wait: nothing reads them
// before the products are done
__device__ __forceinline__ void gmma_hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// cp.async's copies are generic-proxy writes; wgmma reads through the
// async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers (shared::cta addresses)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// wait for the phase of the given parity to complete; a wait that never
// ends traps (a launch error) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 22)) __trap();
  }
}
// `bytes` from global memory into shared memory by the bulk-copy engine,
// counted on the barrier at `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// d += A . B for a 64 x 64 tile, k = 16: A K-major (a 64 x 16 slice of the
// halo), B MN-major (w's [16][64], output channels contiguous: the
// transpose bit)
__device__ __forceinline__ void gmma_m64n64k16(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The output pixel (n H + h) W + w of grid point q, or -1 for a pitch
// column, a zero row or a point past the last image.
__device__ __forceinline__ int grid_pixel(int q, int N, int H, int W,
                                          int G) {
  if (q < 0) return -1;
  const int R = q / G, c = q - R * G;
  const int n = R / (H + 1), r = R - n * (H + 1);
  if (n >= N || r < 1 || c < 1 || c > W) return -1;
  return (n * H + r - 1) * W + c - 1;
}

// w [9C, O] (row-major) into the stages' layout: wp [O / BN][C / KC][tap]
// [BN / 8][KC][8], so that the w of one (output-channel tile, step) is
// kHaloWBytes contiguous bytes, one bulk copy.  One thread a 16-byte row.
__global__ void halo_pack_w(const uint4* __restrict__ w,
                            uint4* __restrict__ wp, int C, int O) {
  constexpr int BN = Halo::BN, KC = Halo::KC;
  const int64_t rows = (int64_t)9 * C * (O / 8);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < rows;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t kr = i / (O / 8);
    const int oc = (int)(i - kr * (O / 8));
    const int tap = (int)(kr / C), c = (int)(kr - (int64_t)tap * C);
    const int64_t dst =
        ((((int64_t)(oc / (BN / 8)) * (C / KC) + c / KC) * 9 + tap) *
             (BN / 8) + oc % (BN / 8)) * KC + c % KC;
    wp[dst] = w[i];
  }
}

// One block: the BM grid points from q0 x BN output channels from o0.
// Two warpgroups, each 128 rows as two m64 products.
template <bool kFused>
__global__ void __launch_bounds__(Halo::kThreads, Halo::kMinBlocks)
    halo_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wp,
                const float* __restrict__ fa, const float* __restrict__ fb,
                __nv_bfloat16* __restrict__ out, int N, int H, int W, int C,
                int O, int n_ot) {
  constexpr int BM = Halo::BM, BN = Halo::BN, KC = Halo::KC,
                S = Halo::kStages, NT = Halo::kThreads;
  static_assert(BN == 64 && KC == 16 && BM % 128 == 0 && NT == BM,
                "the copy maps and the m64n64k16 products are written for "
                "these tiles, a warpgroup of 128 threads for 128 rows");
  static_assert(BM * kHaloLDO * 2 <= S * kHaloWBytes,
                "the staged output tile fits the ring");
  extern __shared__ __align__(128) uint8_t smem[];
  const int G = W + 2;
  const int NP = halo_points(G), GS = halo_group_stride(G);
  const int stage_bytes = halo_stage_bytes(G);
  const uint32_t base = smem_u32(smem);
  // full[st]: the stage's w has landed
  const uint32_t full = base + S * stage_bytes;
  int* s_src = reinterpret_cast<int*>(smem + S * stage_bytes + 8 * S);

  const int q0 = G + (int)(blockIdx.x / n_ot) * BM;
  const int o0 = (int)(blockIdx.x % n_ot) * BN;
  const int n_steps = C / KC;
  const __nv_bfloat16* w_tile = wp + (int64_t)(o0 / BN) * n_steps *
                                         (kHaloWBytes / 2);
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) mbar_init(full + 8 * st, 1);
    // the barriers are set before the bulk-copy engine reaches them
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // each halo point's pixel in x, decoded once a tile
  for (int p = threadIdx.x; p < NP; p += NT)
    s_src[p] = grid_pixel(q0 - G - 1 + p, N, H, W, G);
  __syncthreads();

  // step s (channels s KC on) into stage st.  w, by thread 0: one bulk copy
  // of kHaloWBytes, counted on the stage's full barrier.  The halo:
  // [group][point][8], zero where a point holds no pixel, by 16-byte
  // cp.async (lanes on consecutive points, so each quarter-warp writes 128
  // contiguous bytes).
  auto load_step = [&](int s, int st) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + 8 * st, kHaloWBytes);
      bulk_copy(base + st * stage_bytes,
                w_tile + (int64_t)s * (kHaloWBytes / 2), kHaloWBytes,
                full + 8 * st);
    }
    uint8_t* hb = smem + st * stage_bytes + kHaloWBytes;
    const int c0 = s * KC;
    for (int i = threadIdx.x; i < NP * (KC / 8); i += NT) {
      const int grp = i % (KC / 8), p = i / (KC / 8);
      const int pix = s_src[p];
      const __nv_bfloat16* src =
          pix >= 0 ? x + (int64_t)pix * C + c0 + grp * 8 : x;
      cp_async16(hb + (grp * GS + p) * 16, src, pix >= 0);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_steps) load_step(s, s);
    cp_async_commit();
  }

  const int wg = threadIdx.x >> 7;
  float acc[2][32];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mi][i] = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<S - 2>();   // this thread's copies of step s are in
    fence_proxy_async();
    __syncthreads();          // everyone's; and step s - 1's products done
    mbar_wait(full + 8 * (s % S), (s / S) & 1);   // step s's w is in
    const uint32_t wb = base + (s % S) * stage_bytes;
    const uint32_t hb = wb + kHaloWBytes;
    gmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * G + tap % 3;
      const uint64_t db = gmma_desc(wb + tap * kHaloWTap, 128, KC * 16);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        gmma_m64n64k16(acc[mi],
                       gmma_desc(hb + (wg * 128 + mi * 64 + shift) * 16,
                                 GS * 16, 128),
                       db);
    }
    gmma_commit();
    // the stage step s - 1 used is free: refill it while the products run
    if (s + S - 1 < n_steps) load_step(s + S - 1, (s + S - 1) % S);
    cp_async_commit();
    gmma_wait<0>();
    gmma_hold(acc[0]);
    gmma_hold(acc[1]);
  }
  cp_async_wait<0>();
  __syncthreads();   // every product has read its stage: reuse the ring

  // the epilogue into a [BM][kHaloLDO] tile: warp wq of the warpgroup holds
  // rows 16 wq + lane / 4 (+ 8) of each m64 product, channels 8 j + 2
  // (lane % 4) (+ 1) in d[4 j + 2 h + e]
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float a0 = kFused ? fa[o0 + c] : 1.f, a1 = kFused ? fa[o0 + c + 1] : 1.f;
    const float b0 = kFused ? fb[o0 + c] : 0.f, b1 = kFused ? fb[o0 + c + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 128 + mi * 64 + wq * 16 + (lane >> 2) + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(os + r * kHaloLDO + c) =
            __floats2bfloat162_rn(
                epilogue<kFused>(acc[mi][4 * j + 2 * h], a0, b0),
                epilogue<kFused>(acc[mi][4 * j + 2 * h + 1], a1, b1));
      }
  }
  __syncthreads();
  // the pixels' rows, 16 bytes a thread, eight threads a 128-byte row;
  // pitch columns, zero rows and points past the images are dropped
  for (int i = threadIdx.x; i < BM * (BN / 8); i += NT) {
    const int r = i >> 3, ch = i & 7;
    const int pix = grid_pixel(q0 + r, N, H, W, G);
    if (pix < 0) continue;
    *reinterpret_cast<uint4*>(out + (int64_t)pix * O + o0 + ch * 8) =
        *reinterpret_cast<const uint4*>(os + r * kHaloLDO + ch * 8);
  }
}

template <bool kFused>
int launch_halo(const void* x, const void* w, const float* fa,
                const float* fb, void* out, void* wp, int N, int H, int W,
                int C, int O, cudaStream_t st) {
  constexpr int BM = Halo::BM;
  const int G = W + 2;
  // grid points up to the last tile's halo must fit an int
  const int64_t L = ((int64_t)N * (H + 1) - 1) * G;
  if (L + 2 * (int64_t)G + 2 * BM >= 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;   // the attribute, once per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        halo_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        halo_smem_bytes(Halo::kMaxPitch));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int64_t n_mt = (L + BM - 1) / BM;
  const int n_ot = O / Halo::BN;
  const int64_t blocks = n_mt * n_ot;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int64_t w_rows = (int64_t)9 * C * (O / 8);
  halo_pack_w<<<(unsigned)((w_rows + 255) / 256), 256, 0, st>>>(
      static_cast<const uint4*>(w), static_cast<uint4*>(wp), C, O);
  halo_kernel<kFused><<<(unsigned)blocks, Halo::kThreads, halo_smem_bytes(G),
                        st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wp), fa, fb,
      static_cast<__nv_bfloat16*>(out), N, H, W, C, O, n_ot);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------- halo_f32 route
//
// float32 with C and O multiples of 64, 16-byte aligned pointers and W + 2
// <= kMaxPitch: the halo route's grid and tiles (above), a ring of
// kStages, with the products as three TF32 passes.  Each operand v is
// split into hi = rna_tf32(v) and lo = rna_tf32(v - hi) (see the note at
// the head), and part += a_lo b_hi + a_hi b_lo + a_hi b_hi, each a
// wgmma.m64n64k8 TF32 product; acc += part at each step's end.  wgmma
// takes TF32 operands K-major only, so:
//   * w is packed with its input channels contiguous for each output
//     channel, hi and lo: a stage is [hi, lo][9 taps][KC / 4][BN][4], one
//     bulk copy; B's core matrices are 8 output channels x 4 channels;
//   * A comes from registers: the halo is [KC / 4 group][point][4 floats]
//     (raw float32, by cp.async), and each thread reads its m64 x k8
//     fragment of the shifted halo (rows 16 wq + lane / 4 (+ 8), channels
//     lane % 4 (+ 4)), four conflict-free 32-bit loads (a warp reads 8
//     consecutive points x 16 bytes), splits them in registers and issues
//     the A-from-registers form.  The halo is stored once, not split.
struct HaloF32 {
  static constexpr int BM = 256, BN = 64, KC = 16, kStages = 2,
                       kThreads = 256, kMaxPitch = 184;
};
// bytes of one tap's [KC / 4][BN][4] w slice (hi or lo), of a stage's nine
// (hi or lo), and of a stage's w
constexpr int kF32WTap = HaloF32::KC * HaloF32::BN * 4;
constexpr int kF32WHalf = 9 * kF32WTap;
constexpr int kF32WBytes = 2 * kF32WHalf;
// the output tile staged for the stores: [BM][kF32LDO] float32 (8 pad
// columns: a half-warp's float2 writes fall on 32 different banks)
constexpr int kF32LDO = HaloF32::BN + 8;

// halo_f32 points and group stride are halo_points / halo_group_stride;
// one stage: w then the halo [KC / 4][group stride][4]
static_assert(HaloF32::BM == Halo::BM, "halo_points counts Halo::BM rows");
__host__ __device__ __forceinline__ int halo_f32_stage_bytes(int G) {
  const int b = kF32WBytes + halo_group_stride(G) * HaloF32::KC * 4;
  return (b + 127) / 128 * 128;
}
// the ring, then the w stages' barriers, then the halo's pixel table
__host__ __device__ __forceinline__ int halo_f32_smem_bytes(int G) {
  return HaloF32::kStages * halo_f32_stage_bytes(G) + 8 * HaloF32::kStages +
         halo_points(G) * 4;
}

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the low 13 bits of the result are zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// v = hi + lo + e, |e| <= 2^-22 |v|: hi and lo each exact in TF32
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// d = A . B + (scale_d ? d : 0) for a 64 x 64 tile, k = 8: A from
// registers (this thread's fragment of the warpgroup's m64 x k8 slice), B
// K-major from shared memory
__device__ __forceinline__ void gmma_m64n64k8_tf32(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// w [9C, O] (row-major float32) split into hi and lo and packed into the
// stages' layout: wp [O / BN][C / KC][hi, lo][tap][KC / 4][BN][4] (each 4
// consecutive input channels of one output channel in 16 bytes), so that
// the w of one (output-channel tile, step) is kF32WBytes contiguous bytes,
// one bulk copy.  One thread a (4 channels, output channel) unit: neighbours
// read neighbouring output channels.
__global__ void halo_f32_pack_w(const float* __restrict__ w,
                                float4* __restrict__ wp, int C, int O) {
  constexpr int BN = HaloF32::BN, KC = HaloF32::KC;
  const int64_t units = (int64_t)9 * (C / 4) * O;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < units;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int o = (int)(i % O);
    const int64_t kq = i / O;                  // tap * C / 4 + c / 4
    const int tap = (int)(kq / (C / 4));
    const int c = 4 * (int)(kq - (int64_t)tap * (C / 4));
    const float* src = w + ((int64_t)tap * C + c) * O + o;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) tf32_split(src[(int64_t)j * O], hi[j], lo[j]);
    const int64_t dst =
        ((((int64_t)(o / BN) * (C / KC) + c / KC) * 2 * 9 + tap) *
             (KC / 4) + (c % KC) / 4) * BN + o % BN;
    wp[dst] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                          __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    wp[dst + 9 * (KC / 4) * BN] =
        make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                    __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
}

// One block: the BM grid points from q0 x BN output channels from o0.
// Two warpgroups, each 128 rows as two m64 products.
template <bool kFused>
__global__ void __launch_bounds__(HaloF32::kThreads, 1)
    halo_f32_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                    const float* __restrict__ fa, const float* __restrict__ fb,
                    float* __restrict__ out, int N, int H, int W, int C, int O,
                    int n_ot) {
  constexpr int BM = HaloF32::BM, BN = HaloF32::BN, KC = HaloF32::KC,
                S = HaloF32::kStages, NT = HaloF32::kThreads;
  static_assert(BN == 64 && KC % 8 == 0 && BM % 128 == 0 && NT == BM,
                "the copy maps and the m64n64k8 products are written for "
                "these tiles, a warpgroup of 128 threads for 128 rows");
  static_assert(BM * kF32LDO * 4 <= S * kF32WBytes,
                "the staged output tile fits the ring");
  extern __shared__ __align__(128) uint8_t smem[];
  const int G = W + 2;
  const int NP = halo_points(G), GS = halo_group_stride(G);
  const int stage_bytes = halo_f32_stage_bytes(G);
  const uint32_t base = smem_u32(smem);
  // full[st]: the stage's w has landed
  const uint32_t full = base + S * stage_bytes;
  int* s_src = reinterpret_cast<int*>(smem + S * stage_bytes + 8 * S);

  const int q0 = G + (int)(blockIdx.x / n_ot) * BM;
  const int o0 = (int)(blockIdx.x % n_ot) * BN;
  const int n_steps = C / KC;
  const float* w_tile = wp + (int64_t)(o0 / BN) * n_steps * (kF32WBytes / 4);
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) mbar_init(full + 8 * st, 1);
    // the barriers are set before the bulk-copy engine reaches them
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // each halo point's pixel in x, decoded once a tile
  for (int p = threadIdx.x; p < NP; p += NT)
    s_src[p] = grid_pixel(q0 - G - 1 + p, N, H, W, G);
  __syncthreads();

  // step s (channels s KC on) into stage st.  w, by thread 0: one bulk copy
  // of kF32WBytes, counted on the stage's full barrier.  The halo:
  // [group][point][4], zero where a point holds no pixel, by 16-byte
  // cp.async.
  auto load_step = [&](int s, int st) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + 8 * st, kF32WBytes);
      bulk_copy(base + st * stage_bytes,
                w_tile + (int64_t)s * (kF32WBytes / 4), kF32WBytes,
                full + 8 * st);
    }
    uint8_t* hb = smem + st * stage_bytes + kF32WBytes;
    const int c0 = s * KC;
    for (int i = threadIdx.x; i < NP * (KC / 4); i += NT) {
      const int grp = i % (KC / 4), p = i / (KC / 4);
      const int pix = s_src[p];
      const float* src = pix >= 0 ? x + (int64_t)pix * C + c0 + grp * 4 : x;
      cp_async16(hb + (grp * GS + p) * 16, src, pix >= 0);
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_steps) load_step(s, s);
    cp_async_commit();
  }

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  // this thread's fragment: rows r0 + mi 64 (+ 8) of the tile, channels
  // lane % 4 (+ 4) of the step
  const int r0 = wg * 128 + wq * 16 + (lane >> 2);
  const int t4 = lane & 3;
  constexpr int KS = KC / 8;   // k8 slices a tap
  // part: the wgmma accumulator of one step, added into acc by a rounded
  // float32 add at the step's end (see the note at the head)
  float acc[2][32], part[2][32];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mi][i] = part[mi][i] = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<S - 2>();   // this thread's copies of step s are in
    __syncthreads();          // everyone's; and step s - 1's products done
    mbar_wait(full + 8 * (s % S), (s / S) & 1);   // step s's w is in
    const uint32_t wb = base + (s % S) * stage_bytes;
    const float* hs =
        reinterpret_cast<const float*>(smem + (s % S) * stage_bytes +
                                       kF32WBytes);
    // one tap a batch: its fragments are loaded and split while the tap
    // before runs, then wgmma.fence, 2 x KS x 3 products, commit
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      // [mi][k8 slice][register]; slice ks is the halo's 4-channel groups
      // 2 ks and 2 ks + 1
      uint32_t ah[2][KS][4], al[2][KS][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int p = r0 + mi * 64 + (tap / 3) * G + tap % 3;
          const float* g0 = hs + (2 * ks * GS + p) * 4 + t4;
          const float* g1 = g0 + GS * 4;
          const float v[4] = {g0[0], g0[32], g1[0], g1[32]};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tf32_split(v[e], ah[mi][ks][e], al[mi][ks][e]);
        }
      gmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t wt = wb + tap * kF32WTap + ks * 2 * BN * 16;
        const uint64_t bh = gmma_desc(wt, BN * 16, 128);
        const uint64_t bl = gmma_desc(wt + kF32WHalf, BN * 16, 128);
        // the step's first products start part afresh
        const int keep = tap > 0 || ks > 0;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          gmma_m64n64k8_tf32(part[mi], al[mi][ks], bh, keep);
          gmma_m64n64k8_tf32(part[mi], ah[mi][ks], bl, 1);
          gmma_m64n64k8_tf32(part[mi], ah[mi][ks], bh, 1);
        }
      }
      gmma_commit();
      if (tap == 0) {
        // the stage step s - 1 used is free: refill it while the products
        // run
        if (s + S - 1 < n_steps) load_step(s + S - 1, (s + S - 1) % S);
        cp_async_commit();
      } else {
        gmma_wait<1>();   // the tap before is done: its registers free
      }
    }
    gmma_wait<0>();
    gmma_hold(part[0]);
    gmma_hold(part[1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[mi][i] = __fadd_rn(acc[mi][i], part[mi][i]);
  }
  cp_async_wait<0>();
  __syncthreads();   // every product has read its stage: reuse the ring

  // the epilogue into a [BM][kF32LDO] tile: warp wq of the warpgroup holds
  // rows 16 wq + lane / 4 (+ 8) of each m64 product, channels 8 j + 2
  // (lane % 4) (+ 1) in d[4 j + 2 h + e]
  float* os = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float a0 = kFused ? fa[o0 + c] : 1.f, a1 = kFused ? fa[o0 + c + 1] : 1.f;
    const float b0 = kFused ? fb[o0 + c] : 0.f, b1 = kFused ? fb[o0 + c + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + mi * 64 + 8 * h;
        *reinterpret_cast<float2*>(os + r * kF32LDO + c) =
            make_float2(epilogue<kFused>(acc[mi][4 * j + 2 * h], a0, b0),
                        epilogue<kFused>(acc[mi][4 * j + 2 * h + 1], a1, b1));
      }
  }
  __syncthreads();
  // the pixels' rows, 16 bytes a thread, sixteen threads a 256-byte row;
  // pitch columns, zero rows and points past the images are dropped
  for (int i = threadIdx.x; i < BM * (BN / 4); i += NT) {
    const int r = i >> 4, ch = i & 15;
    const int pix = grid_pixel(q0 + r, N, H, W, G);
    if (pix < 0) continue;
    *reinterpret_cast<float4*>(out + (int64_t)pix * O + o0 + ch * 4) =
        *reinterpret_cast<const float4*>(os + r * kF32LDO + ch * 4);
  }
}

template <bool kFused>
int launch_halo_f32(const void* x, const void* w, const float* fa,
                    const float* fb, void* out, void* wp, int N, int H, int W,
                    int C, int O, cudaStream_t st) {
  constexpr int BM = HaloF32::BM;
  const int G = W + 2;
  // grid points up to the last tile's halo must fit an int
  const int64_t L = ((int64_t)N * (H + 1) - 1) * G;
  if (L + 2 * (int64_t)G + 2 * BM >= 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;   // the attribute, once per instantiation
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        halo_f32_kernel<kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        halo_f32_smem_bytes(HaloF32::kMaxPitch));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int64_t n_mt = (L + BM - 1) / BM;
  const int n_ot = O / HaloF32::BN;
  const int64_t blocks = n_mt * n_ot;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int64_t units = (int64_t)9 * (C / 4) * O;
  halo_f32_pack_w<<<(unsigned)((units + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(w), static_cast<float4*>(wp), C, O);
  halo_f32_kernel<kFused><<<(unsigned)blocks, HaloF32::kThreads,
                            halo_f32_smem_bytes(G), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wp), fa, fb,
      static_cast<float*>(out), N, H, W, C, O, n_ot);
  return (int)cudaGetLastError();
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

// One launch of a halo route on `stream`: x [N, H, W, C] and w [3, 3, C,
// O] of `dtype` (1 bfloat16: the halo route; 0 float32: the halo_f32
// route), out [N, H, W, O] of the same type; with `fused`, a and b are
// float32 [O].  wp is scratch that takes w in the stages' layout (a small
// packing kernel runs first, on the same stream): w's size in bfloat16,
// twice w's size in float32 (its TF32 hi and lo parts).  The caller routes
// here only when C and O are multiples of 64, W + 2 <= 256 (bfloat16) or
// 184 (float32) and x, w and out are 16-byte aligned
// (ops/conv.py::conv_route); anything else returns cudaErrorInvalidValue.
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int conv_halo_launch(const void* x, const void* w, const float* a,
                                const float* b, void* out, void* wp, int N,
                                int H, int W, int C, int O, int dtype,
                                int fused, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  const int max_pitch = dtype == kBF16  ? Halo::kMaxPitch
                        : dtype == kF32 ? HaloF32::kMaxPitch
                                        : 0;
  if (C % 64 != 0 || O % 64 != 0 || W + 2 > max_pitch)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out | (uintptr_t)wp) % 16 !=
      0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * H * W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (fused && (a == nullptr || b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return fused
               ? launch_halo_f32<true>(x, w, a, b, out, wp, N, H, W, C, O, st)
               : launch_halo_f32<false>(x, w, a, b, out, wp, N, H, W, C, O,
                                        st);
  return fused ? launch_halo<true>(x, w, a, b, out, wp, N, H, W, C, O, st)
               : launch_halo<false>(x, w, a, b, out, wp, N, H, W, C, O, st);
}
