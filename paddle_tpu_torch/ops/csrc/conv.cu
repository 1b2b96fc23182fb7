// 3x3 SAME convolution over NHWC as an implicit GEMM, for Hopper (sm_90a),
// written by hand; optionally with a folded batch norm and a ReLU in its
// epilogue.
//
// Replaces the two Pallas TPU kernels of benchmark/conv_probe.py, each by
// three routes (below):
//   halo_kernel<false>, halo_f32_kernel<false>,  <- _igemm_kernel
//   igemm_kernel<T, false, BN>                      (via igemm_conv)
//   halo_kernel<true>, halo_f32_kernel<true>,    <- _igemm_fused_kernel
//   igemm_kernel<T, true, BN>                       (via igemm_conv_fused)
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
// once to the input type.  One writer per output element and no atomics:
// results repeat exactly from run to run.
//
// As a GEMM: M = N*H*W output pixels, N_gemm = O, K = 9*C (w is the
// row-major [9C, O] matrix as it stands).  The TPU kernel gives one image
// per grid step and lets the MXU take whole [H*W, C] @ [C, O] products out
// of VMEM; on the H100 a block owns a tile of pixels and output channels,
// stages x's part of it once in shared memory and takes each tap as a
// shift inside that copy.
//
// Three routes, chosen by shape in ops/conv.py::conv_route, each a hand
// kernel (no fallback: the route is fixed before the launch):
//   * the halo route, halo_kernel<kFused>: bfloat16 with C and O multiples
//     of 64, aligned pointers and W + 2 <= 256, which is every ResNet 3x3
//     stride-1 conv (C = O in {64, 128, 256, 512});
//   * the halo_f32 route, halo_f32_kernel<kFused>: float32 with the same
//     channels and pointers and W + 2 <= 184, every ResNet 3x3 stride-1
//     conv in float32;
//   * the gather route, igemm_kernel<T, kFused, BN>: everything else, any
//     N, H, W, C, O and pointers: the stems' C = 3, ocr_ctc's C = 1, the
//     ragged channels of FCN, SSD's heads (O = 8, 42) and GoogLeNet, and
//     rows too wide for the halo routes (VGG-19's 224-wide float32 conv).
//
// What bounds them on the H100 at ResNet-50's shapes (bs = 256): bfloat16
// is on the line between bytes and operations (56x56x64: 59.2 GFLOP, 0.060
// ms at 989 TFLOP/s, against 205.5 MB of x and output, 0.061 ms at 3.35
// TB/s: bytes by a hair; 28x28x128: operations, 0.060 ms); float32 is bound
// by operations: 0.883 ms at the CUDA cores' 67 TFLOP/s, 0.359 ms as three
// TF32 passes at 495 TFLOP/s (the halo_f32 route), against 411 MB of x and
// output, 0.123 ms.
//
// A kernel that gathers each tap's A slice from x afresh crosses L2 nine
// times for x (925 MB at 56x56x64) and, with 128-pixel blocks, reads all of
// w once a block (462 MB more).  The halo route answers that at ResNet's
// shapes:
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
// The halo_f32 route keeps float32 on the tensor cores, where the CUDA
// cores' 67 TFLOP/s bound FFMA products at 0.883 ms (56x56x64) and cuDNN's
// float32 (TF32 off) is already past that at 28x28.  It keeps float32's
// accuracy by splitting each operand v into two TF32 values,
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
//
// The gather route (igemm_kernel<T, kFused, BN>, at the end of this file)
// takes the shapes the models other than ResNet route: the C = 3 stems of
// FCN ([32, 256, 256, 3] x 16) and VGG-19 ([64, 224, 224, 3] x 64),
// ocr_ctc's C = 1, SSD's heads (O = 8 and 42), FCN's C = 16 and 32, and
// GoogLeNet's C = 96-160, O = 128-320.  What bounds them: bytes for the
// stems, ocr_ctc and SSD's heads (the stems' output alone is 67 MB and 411
// MB in bfloat16, 0.020 and 0.123 ms at 3.35 TB/s, against 1.8 and 11
// GFLOP of products, 0.002 and 0.011 ms at 989 TFLOP/s); products for
// GoogLeNet (bfloat16 0.006-0.022 ms, float32 as three TF32 passes
// 0.035-0.135 ms) and for VGG-19's 224-wide float32 conv (1.43 ms).  What
// a gather that walks K a tap at a time in 32-channel slices, with 64-wide
// N tiles and scalar stores, loses there, and what this design does about
// each:
//   1. K padded per tap (at C = 3, 91% of the loads and products zeros):
//      K is walked in 16-byte granules of channels (8 bfloat16 or 4
//      float32, zero past C), and an mma's k is two granules that may come
//      from two taps: ldmatrix takes one row address a lane, so the two
//      halves of A (and of B) can point at two taps.  C = 3 costs 9 + 1
//      granules, 5 k16 steps in bfloat16 where 32-channel slices a tap
//      took 18;
//   2. N padded to 64: BN, the block's output channels, is instantiated at
//      8, 16, 24, 32, 48 and 64 and picked on the host as the least that
//      covers O when O <= 64 (ops/conv.py::gather_bn): SSD's 8 and 42 (48),
//      FCN's 16 and 32 waste at most 7 columns; O > 64 takes 64-wide tiles,
//      each block keeping one;
//   3. scalar stores where C or O is not a multiple of 16 bytes: the output
//      is staged in shared memory (a padded row a pixel, written as pairs)
//      and goes out as 16-byte streaming stores: where O is a multiple of
//      16 bytes and out is aligned, a patch row's (or a pixel's) outputs
//      are whole aligned pieces; else each segment's pieces start at the
//      shift that aligns them in memory, so every piece inside it is one
//      16-byte store for any O (42 included) and any pointer, and only the
//      pieces at a segment's two ends store element by element;
//   4. x read nine times: a tile is a TH x TW patch of the images' grid
//      (the images one under another, a zero row between two; picked on
//      the host from N, H and W, ops/conv.py::gather_patch: 8 x 16 at the
//      wide images, 18 x 7 at 7x7 so a tile spans images), and its
//      (TH + 2) x (TW + 2) halo is staged once per chunk of channels, zero
//      off the grid (a zero-filling cp.async; element loads where C is not
//      a multiple of a granule, the stems, held in registers across the
//      step before).  A tap is then a shift of each lane's row address
//      inside the halo: x crosses L2 (TH + 2)(TW + 2) / (TH TW) times,
//      1.41x at 8 x 16.  Blocks are persistent, each on one tile of outputs
//      over many patches: where all of w for it fits 80 KB (every model
//      shape but GoogLeNet's, and in float32 VGG-19's c224, FCN's c64 and
//      SSD's conf heads) it is loaded once and stays; else it streams with
//      the halo, packed first (gather_bf16_pack_w, gather_f32_pack_w) into
//      the stages' image, so that each chunk of it is one contiguous run of
//      16-byte copies (gathering w's rows per tap and channel instead was
//      the larger part of GoogLeNet's bfloat16 time).  A
//      bfloat16 granule's 8 rows of w are swizzled by their n-block, so
//      its copies and its ldmatrix reads stay off each other's banks.  A
//      three-stage ring over (patch, chunk) steps keeps two
//      steps of copies in flight while the products, epilogue and stores
//      run; a chunk is the most granules (up to 4) whose stage fits 40 KB
//      (ops/conv.py::gather_step_granules);
//   5. float32 on FFMA (whose bound is above cuDNN's time at GoogLeNet's
//      shapes): float32 runs on the tensor cores as three TF32 passes of
//      mma.sync.m16n8k8 (the halo_f32 route's split, above, with its error
//      bound, 7.2e-7 sum |a b|), each chunk's products in a fresh
//      accumulator added into the float32 sum by a rounded add; w is split
//      into its hi and lo parts once a launch (gather_f32_pack_w, laid out
//      as the stages hold it), A in registers; both come by ldmatrix, whose
//      16-byte rows are a granule's 4 channels, as the TF32 fragments stand.
//      bfloat16 runs mma.sync.m16n8k16 from ldmatrix.
// Eight warps, each one m16 tile of the patch's rows by BN; a warp whose
// rows lie past the patch skips its products.  The TF32 passes are issued
// pass by pass over a warp's n8 tiles, so consecutive products go to
// different accumulators.  Tried and dropped (on an NVIDIA H100 80GB
// HBM3; PERF.md): two m16 tiles a warp (BM 256) for GoogLeNet's bfloat16
// shapes (no faster), narrower BN there to keep w resident (slower), a
// per-block order of the streamed chunks (no change), and smaller patches
// for the small grids of SSD's 38x38 heads and GoogLeNet's 7x7 (slower).  wgmma and TMA
// are left to later work: these shapes are mostly bound by bytes, a patch
// of 128 pixels is one wgmma M of 64 twice at most, and a TMA tensor map
// cannot lay out two taps in one k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
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
// 4 bytes from global to shared memory; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
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

// ------------------------------------------------------------ gather route
//
// Any N, H, W, C, O and pointers (see the note at the head).  The images
// lie on one grid of NG = N (H + 1) - 1 rows of W pixels: image n's row h
// is grid row n (H + 1) + h, and a zero row lies between two images.  A
// tile is a TH x TW patch of the grid (TH TW <= BM pixels) and BN output
// channels; halo point p = hr (TW + 2) + hc holds grid pixel (h0 - 1 + hr,
// w0 - 1 + hc), zero off the grid or on a zero row, so patch pixel r = ph
// TW + pw reads tap (dy, dx) at point (ph + dy)(TW + 2) + pw + dx.  K is
// walked in chunks of CGs granules (16 bytes of channels each; CGs picked
// on the host, at most kGranules); unit u = g * 9 + tap of a chunk is
// granule g of tap `tap`, and an mma's k takes units 2 ks and 2 ks + 1 (a
// zero unit past the chunk's 9 CG).  A chunk's halo is [CG][point][16
// bytes], its w 16-byte rows (gather_load_w, gather_f32_pack_w).
//
// The grid is persistent: as many blocks as fit the card, a multiple of
// the output-channel tiles, so each block keeps one tile of outputs and
// walks its patches.  When all of w's chunks for those outputs fit
// kGatherWRes bytes (every model shape but GoogLeNet's, VGG-19's float32
// c224, and FCN's c64 and SSD's conf heads in float32) they are loaded once
// and stay, and the ring holds halos only; else w streams through the ring
// with the halo, in chunks small enough for three stages, each chunk copied
// whole from the image that a small kernel packed first.  The ring runs
// over (patch, chunk) steps, kStages - 1 ahead, so copies are in flight
// while the products, epilogue and stores run; where x is read element by
// element (C below a granule: the stems) the step's loads go to registers
// before the products of the step before and to shared memory after them.
// The output is staged in the stage just used when it fits there, else
// past the ring.
struct Gather {
  static constexpr int BM = 128, kGranules = 4, kStages = 3, kThreads = 256;
};
// the patch rows a warp multiplies: one m16 tile
constexpr int kGatherWarpRows = Gather::BM / (Gather::kThreads / 32);
// bytes below w and the ring: 16 zero bytes (the zero unit's operands);
// from byte kGatherSegs the tile's segment table (an int a segment); from
// byte kGatherUnits the chunk's unit tables (a unit's A and B offsets,
// kGatherUnitsN ints each)
constexpr int kGatherSegs = 128;
constexpr int kGatherUnits = kGatherSegs + 4 * Gather::BM;
constexpr int kGatherUnitsN = 9 * Gather::kGranules + 4;
constexpr int kGatherRing = 1024;
static_assert(kGatherUnits + 8 * kGatherUnitsN <= kGatherRing,
              "the tables fit below the ring");
// the most bytes of w that stay in shared memory for a whole launch
constexpr int kGatherWRes = 80 * 1024;
// the most bytes of a stage that streams w
constexpr int kGatherStage = 40 * 1024;
// elements past BN in a staged pixel's row (rows then start 16 bytes apart
// across the banks)
constexpr int kGatherPad = 8;
// the block's shared memory at most (an H100 block's opt-in limit)
constexpr int kGatherSmemMax = 232448;
// halo points a thread takes (at most (BM + 2) 3 in a patch)
constexpr int kGatherPend = ((Gather::BM + 2) * 3 + Gather::kThreads - 1) /
                            Gather::kThreads;
static_assert(kGatherWarpRows == 16,
              "the fragments are written for one m16 tile a warp");
// blocks an SM should hold, by BN and the element's bytes: narrow tiles
// are bound by bytes and want warps in flight; registers are capped to fit
// them (float32 holds twice the fragments)
__host__ __device__ constexpr int gather_min_blocks(int BN, int elt) {
  return BN * elt <= 64 ? 3 : 2;
}

// granules of C channels, at most `cap`
__host__ __device__ __forceinline__ int gather_granules(int C, int per,
                                                        int cap) {
  const int g = (C + per - 1) / per;
  return g < cap ? g : cap;
}
__host__ __device__ __forceinline__ int gather_chunks(int C, int per,
                                                      int CGs) {
  return (C + CGs * per - 1) / (CGs * per);
}
// bytes of one chunk's halo ((TH + 2)(TW + 2) points) and of its w (9 BN
// rows of 8 outputs; float32 twice, its TF32 hi and lo parts), CG granules
__host__ __device__ __forceinline__ int gather_halo_bytes(int TH, int TW,
                                                          int CG) {
  return 16 * CG * (TH + 2) * (TW + 2);
}
__host__ __device__ __forceinline__ int gather_w_bytes(int BN, int CG,
                                                       int elt) {
  return 16 * CG * 9 * BN * (elt == 4 ? 2 : 1);
}
// whether all of w's chunks of CGs granules for one output tile stay
__host__ __device__ __forceinline__ bool gather_resident(int C, int BN,
                                                         int elt, int CGs) {
  return gather_chunks(C, 16 / elt, CGs) * gather_w_bytes(BN, CGs, elt) <=
         kGatherWRes;
}
// one stage of the ring: a halo, and w unless resident
__host__ __device__ __forceinline__ int gather_stage_bytes(int TH, int TW,
                                                           int BN, int C,
                                                           int elt, int CGs) {
  return gather_halo_bytes(TH, TW, CGs) +
         (gather_resident(C, BN, elt, CGs) ? 0
                                           : gather_w_bytes(BN, CGs, elt));
}
// bytes of the staged output: a row of BN + kGatherPad elements a pixel
__host__ __device__ __forceinline__ int gather_staged_bytes(int TH, int TW,
                                                            int BN, int elt) {
  return TH * TW * (BN + kGatherPad) * elt;
}
// the block's shared memory: the zero bytes, resident w, the ring's stages
// and, unless it fits a stage, the staged output
__host__ __device__ __forceinline__ int gather_smem_bytes(int TH, int TW,
                                                          int BN, int C,
                                                          int elt, int CGs) {
  const int stage = gather_stage_bytes(TH, TW, BN, C, elt, CGs);
  const int staged = gather_staged_bytes(TH, TW, BN, elt);
  return kGatherRing +
         (gather_resident(C, BN, elt, CGs)
              ? gather_chunks(C, 16 / elt, CGs) *
                    gather_w_bytes(BN, CGs, elt)
              : 0) +
         Gather::kStages * stage + (staged <= stage ? 0 : staged);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
// c += a . b for one 16 x 8 tile, k = 16 (bfloat16) or k = 8 (TF32),
// float32 sums; register-only, so the compiler may interleave them
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of a granule's values, in order
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const __nv_bfloat16 (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (uint32_t)__bfloat16_as_ushort(v[2 * i]) |
           ((uint32_t)__bfloat16_as_ushort(v[2 * i + 1]) << 16);
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// The grid pixel (row R, column col) as an index of x's pixels, or -1 off
// the grid and on the zero rows between images
__device__ __forceinline__ int gather_pixel(int R, int col, int H, int W,
                                            int NG) {
  if (R < 0 || R >= NG || col < 0 || col >= W) return -1;
  const int n = R / (H + 1), h = R - n * (H + 1);
  return h < H ? (n * H + h) * W + col : -1;
}

// The element-loaded halo points of gather_load_halo (one granule each)
// into `hs`
template <typename T, int K>
__device__ __forceinline__ void gather_store_halo(
    uint8_t* hs, int NP, const T (&pv)[K][16 / sizeof(T)]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = (int)threadIdx.x + k * Gather::kThreads;
    if (p < NP) *reinterpret_cast<uint4*>(hs + 16 * p) = pack16(pv[k]);
  }
}

// One chunk's halo (channels c0 on, CG granules) into `hs`: granule g of
// point p at byte 16 (g NP + p), zero off the grid and past C.  A thread
// takes the points p = threadIdx.x + k NT, whose halo rows and columns
// (hr[k], hc[k]; hr -1 past NP) are fixed for the launch; grid row h0 - 1
// is split into image and row once, and each point's row follows from it
// by carries.  Where C is a multiple of a granule and x is aligned (vec_x),
// 16-byte cp.async copies (committed by the caller).  Else element loads:
// with one granule a point (C below a granule: the stems) into `pv`, stored
// by gather_store_halo at once or, with `defer`, after the products of the
// step before; with more (no model shape), stored here.
template <typename T, int K>
__device__ __forceinline__ void gather_load_halo(
    uint8_t* hs, const T* __restrict__ x, int h0, int w0, int c0, int CG,
    int H, int W, int C, int NG, int NP, const int (&hr)[K],
    const int (&hc)[K], bool vec_x, T (&pv)[K][16 / sizeof(T)], bool defer) {
  constexpr int per = 16 / (int)sizeof(T);
  const int n0 = h0 >= 1 ? (h0 - 1) / (H + 1) : -1;
  const int row0 = h0 - 1 - n0 * (H + 1);   // H: a zero row
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (hr[k] < 0) continue;
    int n = n0, row = row0 + hr[k];
    while (row > H) row -= H + 1, ++n;
    const int col = w0 - 1 + hc[k];
    const bool in = h0 - 1 + hr[k] >= 0 && h0 - 1 + hr[k] < NG && row < H &&
                    col >= 0 && col < W;
    const int64_t off = ((int64_t)(n * H + row) * W + col) * C + c0;
    const int p = (int)threadIdx.x + k * Gather::kThreads;
    if (vec_x) {
      for (int g = 0; g < CG; ++g)
        cp_async16(hs + 16 * (g * NP + p), in ? x + off + g * per : x, in);
    } else if (CG == 1) {
#pragma unroll
      for (int j = 0; j < per; ++j)
        pv[k][j] = (in && c0 + j < C) ? x[off + j] : zero_of<T>();
    } else {
      for (int g = 0; g < CG; ++g) {
        T v[per];
#pragma unroll
        for (int j = 0; j < per; ++j)
          v[j] = (in && c0 + g * per + j < C) ? x[off + g * per + j]
                                              : zero_of<T>();
        *reinterpret_cast<uint4*>(hs + 16 * (g * NP + p)) = pack16(v);
      }
    }
  }
  if (!vec_x && CG == 1 && !defer) gather_store_halo<T, K>(hs, NP, pv);
}

// The row of bfloat16 w that holds channel cl (of a chunk) for the outputs
// of n-block nb of tap `tap`: rows of 8 outputs of one channel, a granule's
// 8 channels in 8 rows whose order is swizzled by nb (row cl % 8 at
// (cl % 8) xor (nb % 8)), so that the copies of one channel into 8 n-blocks
// fall on 8 different banks and a granule's 8 rows, read by ldmatrix, still
// do
__device__ __forceinline__ int gather_w_row(int tap, int nb, int cl, int NB,
                                            int CGs) {
  return (tap * NB + nb) * CGs * 8 + (cl & ~7) + ((cl & 7) ^ (nb & 7));
}

// One bfloat16 chunk's w (channels c0 on, CG granules, outputs o0 .. o0 +
// BN) into `ws`, zero past C and O: output o0 + ol of channel c0 + cl of
// tap `tap` at element 8 gather_w_row(tap, ol / 8, cl) + ol % 8 (read
// transposed); by 16-byte cp.async copies where O is a multiple of a
// granule and w is aligned (vec_w 2), by 4-byte ones of two outputs where O
// is even (vec_w 1, SSD's 42), element loads otherwise.
template <int BN>
__device__ __forceinline__ void gather_load_w(
    uint8_t* wsb, const __nv_bfloat16* __restrict__ w, int o0, int c0, int CG,
    int C, int O, int CGs, int vec_w) {
  constexpr int NB = BN / 8, NT = Gather::kThreads;
  const int CKc = CG * 8;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(wsb);
  for (int tap = 0; tap < 9; ++tap) {
    const __nv_bfloat16* wt = w + (int64_t)tap * C * O;
    if (vec_w == 2) {
      for (int i = threadIdx.x; i < CKc * NB; i += NT) {
        const int cl = i / NB, q = i - cl * NB;
        const int c = c0 + cl, o = o0 + q * 8;
        const bool ok = c < C && o < O;
        cp_async16(ws + gather_w_row(tap, q, cl, NB, CGs) * 8,
                   ok ? wt + ((int64_t)c * O + o) : w, ok);
      }
    } else if (vec_w == 1) {
      for (int i = threadIdx.x; i < CKc * (BN / 2); i += NT) {
        const int cl = i / (BN / 2), ol = 2 * (i - cl * (BN / 2));
        const int c = c0 + cl, o = o0 + ol;
        const bool ok = c < C && o < O;
        cp_async4(ws + gather_w_row(tap, ol / 8, cl, NB, CGs) * 8 + ol % 8,
                  ok ? wt + ((int64_t)c * O + o) : w, ok);
      }
    } else {
      for (int i = threadIdx.x; i < CKc * BN; i += NT) {
        const int cl = i / BN, ol = i - cl * BN;
        const int c = c0 + cl, o = o0 + ol;
        ws[gather_w_row(tap, ol / 8, cl, NB, CGs) * 8 + ol % 8] =
            (c < C && o < O) ? wt[(int64_t)c * O + o]
                             : zero_of<__nv_bfloat16>();
      }
    }
  }
}

// `bytes` contiguous bytes (a multiple of 16) by 16-byte cp.async copies
__device__ __forceinline__ void gather_copy(uint8_t* dst, const uint8_t* src,
                                            int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += Gather::kThreads * 16)
    cp_async16(dst + i, src + i, true);
}

// w [3, 3, C, O] float32 split into TF32 hi and lo parts and packed for
// the gather route: each (output tile ot, chunk ch) is the image of its
// stage's w, 2 gather_w_bytes(BN, CGs, 2) contiguous bytes, hi rows then lo
// rows, a row the 4 channels of granule gs of one output: float4 unit
// ((((ot n_ch + ch) 2 + half) 9 + tap) BN / 8 + nb) CGs 8 + gs 8 + n8 holds
// channels (ch CGs + gs) 4 .. + 4 of output ot BN + nb 8 + n8, zero past C
// and O.  One thread a unit (the hi and lo halves).
__global__ void gather_f32_pack_w(const float* __restrict__ w,
                                  float4* __restrict__ wp, int C, int O,
                                  int BN, int CGs, int n_ch, int n_ot) {
  const int NB = BN / 8;
  const int64_t half = (int64_t)9 * NB * CGs * 8;
  const int64_t units = (int64_t)n_ot * n_ch * half;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < units;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = i;
    const int n8 = (int)(r % 8);
    r /= 8;
    const int gs = (int)(r % CGs);
    r /= CGs;
    const int nb = (int)(r % NB);
    r /= NB;
    const int tap = (int)(r % 9);
    r /= 9;
    const int ch = (int)(r % n_ch);
    const int ot = (int)(r / n_ch);
    const int o = ot * BN + nb * 8 + n8, c0 = (ch * CGs + gs) * 4;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = (o < O && c0 + k < C)
                          ? w[((int64_t)tap * C + c0 + k) * O + o]
                          : 0.f;
      tf32_split(v, hi[k], lo[k]);
    }
    const int64_t dst = ((int64_t)(ot * n_ch + ch) * 2 * 9 + tap) *
                            (NB * CGs * 8) +
                        (nb * CGs + gs) * 8 + n8;
    wp[dst] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                          __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    wp[dst + half] =
        make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                    __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  }
}

// bfloat16 w [3, 3, C, O] packed for the gather route where it streams:
// each (output tile ot, chunk ch) is the image of its stage's w,
// gather_w_bytes(BN, CGs, 2) contiguous bytes, row gather_w_row(tap, nb,
// cl) of 8 outputs at row (ot n_ch + ch) 9 BN / 8 CGs 8 + that, zero past
// C and O.  One thread a row.
__global__ void gather_bf16_pack_w(const __nv_bfloat16* __restrict__ w,
                                   uint4* __restrict__ wp, int C, int O,
                                   int BN, int CGs, int n_ch, int n_ot) {
  const int NB = BN / 8;
  const int64_t chunk = (int64_t)9 * NB * CGs * 8;   // rows of a chunk
  const int64_t units = (int64_t)n_ot * n_ch * chunk;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < units;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = i;
    const int cl = (int)(r % (CGs * 8));
    r /= CGs * 8;
    const int nb = (int)(r % NB);
    r /= NB;
    const int tap = (int)(r % 9);
    r /= 9;
    const int ch = (int)(r % n_ch);
    const int ot = (int)(r / n_ch);
    const int c = ch * CGs * 8 + cl, o = ot * BN + nb * 8;
    __nv_bfloat16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (c < C && o + k < O) ? w[((int64_t)tap * C + c) * O + o + k]
                                  : zero_of<__nv_bfloat16>();
    wp[(int64_t)(ot * n_ch + ch) * chunk + gather_w_row(tap, nb, cl, NB,
                                                        CGs)] = pack16(v);
  }
}

// The products of one chunk, acc += A . B over its nu units.  Both
// operands come by ldmatrix from 16-byte rows: lane l gives A's row l % 16
// of the warp's m16 tile (its halo point pa) in unit 2 ks + l / 16, and B's
// row l % 8 of unit 2 ks + (l / 8) % 2 in n-block j + l / 16; unit u's rows
// start atab[u] bytes into the halo and btab[u] into w, and the zero unit
// reads the 16 zero bytes at `zero`.  bfloat16: B's rows are 8 outputs of
// a channel, read transposed; one m16n8k16 a tile.  float32: A's and B's
// rows are a granule's 4 channels, so a lane gets the m16n8k8 TF32
// fragments as they stand (a0-a3; b0-b1 of the hi rows at `ws`, of the lo
// rows wlo bytes on); A is split into hi and lo in registers, and the
// three passes go a_lo b_hi, then a_hi b_lo, then a_hi b_hi into each
// accumulator, pass by pass over the n8 tiles.  Steps go U at a time so
// that narrow tiles have loads in flight across steps.
template <typename T, int BN>
__device__ __forceinline__ void gather_mma(float (&acc)[BN / 8][4],
                                           uint32_t hs, uint32_t ws,
                                           uint32_t wlo, uint32_t zero,
                                           const int* atab, const int* btab,
                                           int pa, int nu, int CGs,
                                           int lane) {
  constexpr int NB = BN / 8, U = NB <= 2 ? 4 : 2;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  const int n_ks = (nu + 1) / 2;
  const uint32_t wsl = ws + (lane & 7) * 16;
  const int nbl = (lane >> 4) * CGs * 128;
  for (int ks0 = 0; ks0 < n_ks; ks0 += U) {
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const int ks = ks0 + uu;
      if (ks >= n_ks) break;
      const int ua = 2 * ks + (lane >> 4), ub = 2 * ks + ((lane >> 3) & 1);
      uint32_t af[4];
      ldsm_x4(af, ua < nu ? hs + pa * 16 + atab[ua] : zero);
      const uint32_t brow = wsl + btab[ub];
      const bool bok = ub < nu;
      if constexpr (kBF16) {
        // rows swizzled by n-block (gather_w_row): this lane's row of
        // n-block nb at ((lane % 8) xor (nb % 8))
        const uint32_t bsw = ws + btab[ub];
        uint32_t bf[NB][2];
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          if (j + 1 < NB) {
            uint32_t b4[4];
            const int nb = j + (lane >> 4);
            ldsm_x4_t(b4, bok ? bsw + (nb * CGs * 8 + ((lane & 7) ^ (nb & 7)))
                                          * 16
                              : zero);
            bf[j][0] = b4[0];
            bf[j][1] = b4[1];
            bf[j + 1][0] = b4[2];
            bf[j + 1][1] = b4[3];
          } else {
            ldsm_x2_t(bf[j], bok ? bsw + (j * CGs * 8 + ((lane & 7) ^ (j & 7)))
                                         * 16
                                 : zero);
          }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma16816(acc[j], af, bf[j][0], bf[j][1]);
      } else {
        uint32_t ah[4], al[4], bh[NB][2], bl[NB][2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(__uint_as_float(af[e]), ah[e], al[e]);
#pragma unroll
        for (int j = 0; j < NB; j += 2) {
          if (j + 1 < NB) {
            uint32_t h4[4], l4[4];
            const uint32_t at = brow + j * CGs * 128 + nbl;
            ldsm_x4(h4, bok ? at : zero);
            ldsm_x4(l4, bok ? at + wlo : zero);
            bh[j][0] = h4[0];
            bh[j][1] = h4[1];
            bh[j + 1][0] = h4[2];
            bh[j + 1][1] = h4[3];
            bl[j][0] = l4[0];
            bl[j][1] = l4[1];
            bl[j + 1][0] = l4[2];
            bl[j + 1][1] = l4[3];
          } else {
            const uint32_t at = brow + j * CGs * 128;
            ldsm_x2(bh[j], bok ? at : zero);
            ldsm_x2(bl[j], bok ? at + wlo : zero);
          }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
      }
    }
  }
}

// The image pixel that starts output segment `sg` of the patch at grid
// (h0, w0) (a patch row of TW pixels x O when the block holds all of O,
// `covers`; else pixel sg's BN outputs), or -1 where it holds no pixel of
// an image (off the grid, a zero row)
__device__ __forceinline__ int gather_segment(bool covers, int sg, int h0,
                                              int w0, int H, int W, int TW,
                                              int NG) {
  const int ph = covers ? sg : sg / TW, pw = covers ? 0 : sg - ph * TW;
  return gather_pixel(h0 + ph, w0 + pw, H, W, NG);
}

// One block: output channels o0 .. o0 + BN of the patches t = blockIdx.x,
// blockIdx.x + gridDim.x, ... of the n_tiles (patch t / n_ot, o0 = (t %
// n_ot) BN: gridDim.x is a multiple of n_ot, so o0 is the block's own).
// w is float32's as gather_f32_pack_w packs it; bfloat16's as
// gather_bf16_pack_w packs it where it streams, w itself where it stays.
template <typename T, bool kFused, int BN>
__global__ void __launch_bounds__(Gather::kThreads,
                                  gather_min_blocks(BN, sizeof(T)))
    igemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ fa, const float* __restrict__ fb,
                 T* __restrict__ out, int N, int H, int W, int C, int O,
                 int TH, int TW, int nW, int n_ot, int n_tiles, int CGs,
                 int vec_x, int vec_w, int vec_o) {
  constexpr int per = 16 / (int)sizeof(T);          // channels a granule
  constexpr int NB = BN / 8, NT = Gather::kThreads, S = Gather::kStages;
  constexpr int SX = BN + kGatherPad, elt = (int)sizeof(T);
  constexpr int K = kGatherPend;
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(128) uint8_t smem[];
  const int NG = N * (H + 1) - 1;
  const int PW = TW + 2, NP = (TH + 2) * PW, rows = TH * TW;
  const int CK = CGs * per;                          // channels a chunk
  const int n_ch = gather_chunks(C, per, CGs);
  const bool res = gather_resident(C, BN, elt, CGs), covers = n_ot == 1;
  const int hb = gather_halo_bytes(TH, TW, CGs);
  const int wb = gather_w_bytes(BN, CGs, elt);
  const int stage = gather_stage_bytes(TH, TW, BN, C, elt, CGs);
  const bool in_ring = gather_staged_bytes(TH, TW, BN, elt) <= stage;
  uint8_t* wres = smem + kGatherRing;
  uint8_t* ring = wres + (res ? n_ch * wb : 0);
  int* segs = reinterpret_cast<int*>(smem + kGatherSegs);
  int* atab = reinterpret_cast<int*>(smem + kGatherUnits);
  int* btab = atab + kGatherUnitsN;
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem)[threadIdx.x] = 0u;
  // unit u = g * 9 + tap: its A rows at point tap's shift of granule g's
  // halo, its B rows at tap's and g's rows of w (past the chunk: 0)
  if (threadIdx.x < kGatherUnitsN) {
    const int u = threadIdx.x, gu = u / 9, tu = u - 9 * gu;
    const bool ok = gu < CGs;
    atab[u] = ok ? (gu * NP + (tu / 3) * PW + tu % 3) * 16 : 0;
    btab[u] = ok ? ((tu * NB) * CGs + gu) * 128 : 0;
  }
  // this thread's halo points threadIdx.x + k NT as (row, column)
  int hr[K], hc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = (int)threadIdx.x + k * NT;
    hr[k] = p < NP ? p / PW : -1;
    hc[k] = p - max(hr[k], 0) * PW;
  }

  const int ot = (int)blockIdx.x % n_ot, o0 = ot * BN;
  const int my = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int steps = my * n_ch;
  // a chunk's w: copied from its packed image, or (resident bfloat16)
  // loaded from w itself
  auto load_w = [&](uint8_t* dst, int ch) {
    if constexpr (kBF16) {
      if (res) {
        gather_load_w<BN>(dst, w, o0, ch * CK,
                          gather_granules(C - ch * CK, per, CGs), C, O, CGs,
                          vec_w);
        return;
      }
    }
    gather_copy(dst,
                reinterpret_cast<const uint8_t*>(w) +
                    (int64_t)(ot * n_ch + ch) * wb,
                wb);
  };
  T pv[K][per];   // element-loaded halo points in flight
  // step s: chunk s % n_ch of the block's patch s / n_ch, into stage s % S
  auto issue = [&](int s, bool defer) {
    if (s >= steps) return;
    const int t = (int)blockIdx.x + (s / n_ch) * (int)gridDim.x;
    const int patch = t / n_ot, ch = s % n_ch;
    const int h0 = (patch / nW) * TH, w0 = (patch % nW) * TW;
    uint8_t* st = ring + (s % S) * stage;
    gather_load_halo<T, K>(st, x, h0, w0, ch * CK,
                        gather_granules(C - ch * CK, per, CGs), H, W, C, NG,
                        NP, hr, hc, vec_x, pv, defer);
    if (!res) load_w(st + hb, ch);
  };
  // the ring's first S - 1 steps, one commit group each, resident w's chunk
  // s in step s's (the rest in the last), so the first patch starts on its
  // first chunk; every later step commits one group too, empty past the
  // last
  for (int s = 0; s < S - 1; ++s) {
    if (res)
      for (int ch = s; ch < (s < S - 2 ? s + 1 : n_ch); ++ch)
        load_w(wres + ch * wb, ch);
    issue(s, false);
    cp_async_commit();
  }
  // the halo of a step S - 1 on waits in registers (pv) while the step
  // before it runs
  const bool held = !vec_x && gather_granules(C, per, CGs) == 1;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = warp * kGatherWarpRows;
  const bool live = r0 < rows;   // the warp's m16 tile holds patch pixels
  // this lane's ldmatrix row of the patch as a halo point (tap (0, 0));
  // rows past the patch read point 0 and are dropped
  const int ra = r0 + (lane & 15);
  const int pa = ra < rows ? (ra / TW) * PW + ra % TW : 0;
  const uint64_t base = (uint64_t)(uintptr_t)out / sizeof(T);
  float acc[NB][4];

  for (int s = 0; s < steps; ++s) {
    const int ch = s % n_ch;
    // step s + S - 1 into the stage step s - 1 freed; step s's copies done
    issue(s + S - 1, true);
    cp_async_commit();
    cp_async_wait<S - 1>();
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    uint8_t* st = ring + (s % S) * stage;
    const uint32_t wsa = smem_u32(res ? wres + ch * wb : st + hb);
    const int nu = 9 * gather_granules(C - ch * CK, per, CGs);
    if (live) {
      if constexpr (kBF16) {
        gather_mma<T, BN>(acc, smem_u32(st), wsa, 0, smem_u32(smem), atab,
                          btab, pa, nu, CGs, lane);
      } else {
        float part[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
        gather_mma<T, BN>(part, smem_u32(st), wsa, wb / 2, smem_u32(smem),
                          atab, btab, pa, nu, CGs, lane);
        // the chunk's products promoted into the float32 sum
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
      }
    }
    if (held && s + S - 1 < steps)
      gather_store_halo<T, K>(ring + ((s + S - 1) % S) * stage, NP, pv);
    if (ch == n_ch - 1) {
      const int patch = ((int)blockIdx.x + (s / n_ch) * (int)gridDim.x) /
                        n_ot;
      const int h0 = (patch / nW) * TH, w0 = (patch % nW) * TW;
      // the staged tile: pixel r's outputs in a row of SX elements, in the
      // stage just used (after every warp's products) or past the ring;
      // the segments' first pixels in segs
      T* so = reinterpret_cast<T*>(in_ring ? st : ring + S * stage);
      const int n_seg = covers ? TH : rows;
      for (int sg = threadIdx.x; sg < n_seg; sg += NT)
        segs[sg] = gather_segment(covers, sg, h0, w0, H, W, TW, NG);
      if (in_ring) __syncthreads();
      // lane (g, t4) holds rows g and g + 8 of the m16 tile, outputs 2 t4
      // and 2 t4 + 1 of each n8 tile: one 4- or 8-byte store each pair
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        if (!live || r >= rows) continue;
        T* d = so + r * SX + 2 * t4;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = min(o0 + j * 8 + 2 * t4 + e, O - 1);
            v[e] = epilogue<kFused>(acc[j][2 * hh + e], kFused ? fa[o] : 1.f,
                                    kFused ? fb[o] : 0.f);
          }
          if constexpr (kBF16) {
            *reinterpret_cast<__nv_bfloat162*>(d + j * 8) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
            *reinterpret_cast<float2*>(d + j * 8) = make_float2(v[0], v[1]);
          }
        }
      }
      __syncthreads();
      // the segments out in 16-byte pieces, streamed past the caches
      const int TWv = min(TW, W - w0), BNv = min(BN, O - o0);
      if (vec_o && covers) {
        // every row starts on a 16-byte boundary: warp w takes patch rows
        // w, w + 8, ..., its lanes the row's pieces in order
        const int OP = O / per;   // pieces a pixel
        for (int ph = warp; ph < TH; ph += NT / 32) {
          const int pix = segs[ph];
          if (pix < 0) continue;
          uint4* dst = reinterpret_cast<uint4*>(out + (int64_t)pix * O);
          for (int q = lane; q < TWv * OP; q += 32) {
            const int pw = q / OP;
            __stcs(dst + q, *reinterpret_cast<const uint4*>(
                                so + (ph * TW + pw) * SX + (q - pw * OP) * per));
          }
        }
      } else if (vec_o) {
        // every pixel's BN outputs start on a 16-byte boundary
        constexpr int PS = BN / per;   // pieces a pixel
        for (int i = threadIdx.x; i < rows * PS; i += NT) {
          const int r = i / PS, q = i - r * PS;
          const int pix = segs[r];
          if (pix < 0 || q * per >= BNv) continue;
          __stcs(reinterpret_cast<uint4*>(out + (int64_t)pix * O + o0 +
                                          q * per),
                 *reinterpret_cast<const uint4*>(so + r * SX + q * per));
        }
      } else {
        // pieces of per elements on per-element boundaries of memory (a
        // segment's first piece starts sh = its first element's address /
        // sizeof(T) mod per before it): a whole piece is one 16-byte
        // store; a piece that the segment cuts stores its elements one by
        // one
        const int QS = ((covers ? TW * O : BN) + 2 * per - 2) / per;
        const int Ov = covers ? O : BN;
        for (int i = threadIdx.x; i < n_seg * QS; i += NT) {
          const int sg = i / QS, q = i - sg * QS;
          const int pix = segs[sg];
          if (pix < 0) continue;
          const int64_t first = (int64_t)pix * O + (covers ? 0 : o0);
          const int len = covers ? TWv * O : BNv;
          const int px = covers ? sg * TW : sg;
          const int sh = (int)((base + first) & (per - 1));
          const int lo = q * per - sh;   // the piece's first element
          const int vs = max(lo, 0), ve = min(lo + per, len);
          if (vs >= ve) continue;
          // element vs: staged pixel pk, output c; then on by carries
          int pk = px + vs / Ov, c = vs - (vs / Ov) * Ov;
          if (vs == lo && ve == lo + per) {
            T e[per];
#pragma unroll
            for (int k = 0; k < per; ++k) {
              e[k] = so[pk * SX + c];
              if (++c == Ov) c = 0, ++pk;
            }
            __stcs(reinterpret_cast<uint4*>(out + (first + lo)), pack16(e));
          } else {
            for (int k = vs; k < ve; ++k) {
              out[first + k] = so[pk * SX + c];
              if (++c == Ov) c = 0, ++pk;
            }
          }
        }
      }
    }
    __syncthreads();  // stage s % S is free for step s + S, the staging too
  }
  cp_async_wait<0>();   // no copy outlives the block (the empty groups)
}

template <typename T, bool kFused, int BN>
int launch_gather(const void* x, const void* w, const float* fa,
                  const float* fb, void* out, void* wp, int N, int H, int W,
                  int C, int O, int TH, int TW, int CGs, cudaStream_t st) {
  constexpr int per = 16 / (int)sizeof(T), elt = (int)sizeof(T);
  const int64_t NG = (int64_t)N * (H + 1) - 1;
  const int64_t nH = (NG + TH - 1) / TH, nW = (W + TW - 1) / TW;
  const int n_ot = (O + BN - 1) / BN;
  const int64_t n_tiles = nH * nW * n_ot;
  if (NG + TH + 2 > 0x7fffffff || n_tiles > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const int smem = gather_smem_bytes(TH, TW, BN, C, elt, CGs);
  if (smem > kGatherSmemMax) return (int)cudaErrorInvalidValue;
  // the attribute and the card's SMs once per instantiation; the blocks an
  // SM holds at this launch's shared memory, kept for the last size asked
  static bool sized = false;
  static int occ_smem = -1, occ = 0, sms = 0;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        igemm_kernel<T, kFused, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kGatherSmemMax);
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  if (smem != occ_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, igemm_kernel<T, kFused, BN>, Gather::kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    occ_smem = smem;
  }
  // a multiple of n_ot blocks, at most the tiles and what the card holds
  int64_t grid = (int64_t)(occ > 0 ? occ : 1) * sms;
  if (grid > n_tiles) grid = n_tiles;
  grid = grid / n_ot * n_ot;
  if (grid < n_ot) grid = n_ot;
  // w packed first, on the same stream: float32 always (split into hi
  // and lo), bfloat16 where it streams
  const void* wk = w;
  const int n_ch = gather_chunks(C, per, CGs);
  const int64_t units = (int64_t)n_ot * n_ch * 9 * (BN / 8) * CGs * 8;
  if (elt == 4 || !gather_resident(C, BN, elt, CGs)) {
    if (wp == nullptr || (uintptr_t)wp % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (elt == 4)
      gather_f32_pack_w<<<(unsigned)((units + 255) / 256), 256, 0, st>>>(
          static_cast<const float*>(w), static_cast<float4*>(wp), C, O, BN,
          CGs, n_ch, n_ot);
    else
      gather_bf16_pack_w<<<(unsigned)((units + 255) / 256), 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(w), static_cast<uint4*>(wp), C,
          O, BN, CGs, n_ch, n_ot);
    wk = wp;
  }
  const int vec_x = C % per == 0 && (uintptr_t)x % 16 == 0;
  // bfloat16 w: 16-byte copies (2), 4-byte copies of two outputs (1) or
  // element loads (0)
  const int vec_w = O % per == 0 && (uintptr_t)w % 16 == 0 ? 2
                    : O % 2 == 0 && (uintptr_t)w % 4 == 0  ? 1
                                                            : 0;
  const int vec_o = O % per == 0 && (uintptr_t)out % 16 == 0;
  igemm_kernel<T, kFused, BN>
      <<<(unsigned)grid, Gather::kThreads, smem, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(wk), fa, fb,
          static_cast<T*>(out), N, H, W, C, O, TH, TW, (int)nW, n_ot,
          (int)n_tiles, CGs, vec_x, vec_w, vec_o);
  return (int)cudaGetLastError();
}

template <typename T, bool kFused>
int dispatch_gather(const void* x, const void* w, const float* fa,
                    const float* fb, void* out, void* wp, int N, int H, int W,
                    int C, int O, int TH, int TW, int BN, int CGs,
                    cudaStream_t st) {
  switch (BN) {
#define GATHER_CASE(B)                                                     \
  case B:                                                                  \
    return launch_gather<T, kFused, B>(x, w, fa, fb, out, wp, N, H, W, C, \
                                       O, TH, TW, CGs, st);
    GATHER_CASE(8)
    GATHER_CASE(16)
    GATHER_CASE(24)
    GATHER_CASE(32)
    GATHER_CASE(48)
    GATHER_CASE(64)
#undef GATHER_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
}  // namespace

// One launch of the gather route on `stream`: x [N, H, W, C] and w [3, 3,
// C, O] of `dtype` (0 float32, 1 bfloat16), out [N, H, W, O] of the same
// type; with `fused`, a and b are float32 [O] and out = max(acc * a + b,
// 0).  A tile is a TH x TW patch of the images' grid (TH TW <= Gather::BM)
// and BN outputs, BN one of 8, 16, 24, 32, 48, 64, K walked in chunks of
// CGs granules, 1 to Gather::kGranules (ops/conv.py::gather_patch,
// gather_bn and gather_step_granules pick them); any shape, and pointers
// aligned to their element.  Scratch wp takes ops/conv.py::
// gather_scratch_numel values of x's type (float32 always, bfloat16 where w
// streams; else wp may be null), into which a small kernel packs w first,
// on the same stream.  Returns the CUDA error of the launch (0 when it was
// accepted).
extern "C" int igemm_conv_launch(const void* x, const void* w, const float* a,
                                 const float* b, void* out, void* wp, int N,
                                 int H, int W, int C, int O, int TH, int TW,
                                 int BN, int CGs, int dtype, int fused,
                                 void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || O < 1)
    return (int)cudaErrorInvalidValue;
  if (TH < 1 || TW < 1 || TH > Gather::BM || TW > Gather::BM ||
      TH * TW > Gather::BM || CGs < 1 || CGs > Gather::kGranules)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * H * W > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (fused && (a == nullptr || b == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  const uintptr_t elt = dtype == kF32 ? 4 : 2;
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % elt != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return fused ? dispatch_gather<float, true>(x, w, a, b, out, wp, N, H, W,
                                                C, O, TH, TW, BN, CGs,
                                                st)
                 : dispatch_gather<float, false>(x, w, a, b, out, wp, N, H,
                                                 W, C, O, TH, TW, BN, CGs,
                                                 st);
  return fused ? dispatch_gather<__nv_bfloat16, true>(x, w, a, b, out, wp, N,
                                                      H, W, C, O, TH, TW, BN,
                                                      CGs, st)
               : dispatch_gather<__nv_bfloat16, false>(x, w, a, b, out, wp,
                                                       N, H, W, C, O, TH, TW,
                                                       BN, CGs, st);
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
