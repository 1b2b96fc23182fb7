// Flash attention, forward and backward, for Hopper (sm_90a), written by hand.
//
// Replaces three Pallas TPU kernels of paddle_tpu/ops/attention.py:
//   flash_fwd_f32_kernel,       <- _fwd_kernel       (via _fwd_pallas)
//   flash_fwd_bf16_kernel
//   flash_bwd_dkdv_f32_kernel,  <- _bwd_kernel_dkdv  (via _bwd_pallas)
//   flash_bwd_dkdv_bf16_kernel
//   flash_bwd_dq_f32_kernel,    <- _bwd_kernel_dq    (via _bwd_pallas)
//   flash_bwd_dq_bf16_kernel
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
// package's Precision.HIGHEST: neither TF32 nor 3xTF32).  In all three
// kernels the TPU kernels' carry of (m, l, acc) or (dk, dv) or dq in VMEM
// across a sequential grid axis becomes a loop inside one block: one block
// per (row of N, Q tile) loops over its K tiles (forward, dQ), one block
// per (row of N, K tile) over its Q tiles (dK/dV).  No atomics: every
// output element has one writer, so results repeat exactly from run to
// run.  Tiles above the causal diagonal are skipped, and the forward and
// dQ start the longest causal rows first (the float32 dK/dV the longest
// columns).
//
// The float32 forward (flash_fwd_f32_kernel) is bound by how fast shared
// memory feeds the FMAs: 128 B a clock against 128 FMAs a clock per SM, so
// an inner loop needs 4 FMAs per shared word to keep both busy.
//   * 128 x 64 tiles (64 x 64 at D = 128), 128 threads as 16 x 8; each
//     thread owns an 8 x 8 patch of scores (rows ty + 16 i, keys tx + 8 j)
//     and 8 rows x D/8 columns of o, filled by 128-bit shared loads along D
//     (scores) and along the keys (p . v): 4 FMAs per shared word in both
//     products.  Row statistics reduce over the 8 lanes of a row;
//   * K, V and Q stay row-major in shared memory, padded by 4 floats a row
//     so the 8 rows of one load hit 8 bank groups, and cp.async fills them
//     16 bytes at a time with no transpose and no register round trip.  K
//     and V have one buffer each and alternate: K(t+1) loads during the
//     softmax and p . v of tile t, V(t+1) during the scores of tile t + 1;
//   * p goes through shared memory (rows 8 banks apart) from the score
//     patch to the p . v patch; 104 KB a block at D = 64, two blocks an SM.
// The bfloat16 forward (flash_fwd_bf16_kernel) runs both products on the
// tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate), the
// FlashAttention-2 layout: four warps each own 16 query rows of a 64-row
// tile, q stays in registers as A fragments, K and V tiles of 64 keys
// come through a two-stage cp.async ring and reach the mma by ldmatrix
// (.trans for V), the row statistics live in the accumulator fragments
// (4 lanes a row), and p, rounded to bf16, is the A operand of p . v
// straight from the score fragments.
// The float32 backward kernels reuse the float32 forward's machinery: 128
// threads as 16 x 8, register patches fed by 128-bit shared loads
// (patch_dot for the score products, patch_acc for the products that
// reduce over keys or queries), row-major tiles padded by 4 floats and
// filled by cp.async, and one buffer for each streamed operand, the two
// alternating so that one loads while the other is read.  Their tiles are
// 64 x 64, so a thread's patches are 4 x 8 (2.7 FMAs a shared word, not
// the forward's 4): with 128-row tiles and 8 x 8 patches a block took
// more than half of an SM's shared memory, and dK/dV spilled, and both
// ran slower than two 64-row blocks an SM.
//   * dQ (flash_bwd_dq_f32_kernel): one block per (row of N, Q tile),
//     longest causal rows first, holding Q, G, lse and delta; per K/V
//     tile, dP = g . v^T waits in shared memory while s = q . k^T is
//     computed, dS = p (dP - delta) scale replaces it, and dq += dS . k
//     accumulates in registers.  V(t+1) loads during the scores, dS and
//     dS . k of tile t, K(t+1) during dP of tile t+1.  89 KB of shared
//     memory at D = 64;
//   * dK/dV (flash_bwd_dkdv_f32_kernel), in FlashAttention-2's transposed
//     frame: one block per (row of N, K tile), keys as the patches' rows,
//     holding K and V, with dk and dv in registers; per Q tile,
//     s^T = k . q^T gives p^T (kept in shared memory), dP^T = v . g^T gives
//     dS^T, then dk += dS^T . q and dv += p^T . g; lse and delta are per
//     column and load with the Q tile.  Q(t+1) loads during dv of tile t,
//     G(t+1) during s^T of tile t+1.  107 KB at D = 64.
// Both skip the tiles above the causal diagonal.
//
// The bfloat16 backward kernels (flash_bwd_dkdv_bf16_kernel,
// flash_bwd_dq_bf16_kernel) are bound by tensor-core operations: at the
// training shape in bfloat16, dK/dV's four masked products take 0.0174 ms
// and dQ's three 0.0130 ms at 989 TFLOP/s, against 0.0152 and 0.0127 ms
// for their bytes.  Their design is FlashAttention-2's backward on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), the bfloat16 forward's
// machinery: 128 threads as four warps of 16 rows, row-major bf16 tiles
// padded by 8 elements (the 8 rows of an ldmatrix phase on 8 bank groups)
// and filled by cp.async through a two-stage ring, operands by ldmatrix,
// and the scores, p and dS kept in the accumulator fragments, p as
// 2^(s scale log2(e) - lse log2(e)) (one FMA and one ex2.approx.ftz an
// entry; __expf of s scale - lse took 17-20% longer):
//   * dK/dV, in the transposed frame: a block owns 64 keys; per Q tile,
//     s^T = k . q^T and dP^T = v . g^T (A: K and V; B: Q and G, both
//     ldmatrix), p^T and dS^T in the fragments with lse and delta per
//     column, then dv += p^T . g and dk += dS^T . q with p^T and dS^T
//     rounded to bf16 as A fragments straight from registers (the C
//     fragment of two m16n8 tiles is the A fragment of one m16n8k16 step)
//     and G and Q by ldmatrix .trans.  Q tiles of 64 queries (32 at
//     D = 128, where dk and dv take 64 floats each a thread);
//   * dQ: a block owns 64 queries with q and g as A fragments in
//     registers; per K/V tile, s = q . k^T, dP = g . v^T, dS in the
//     fragments, dq += dS . k with K by ldmatrix .trans.  K/V tiles of 64
//     keys (32 at D = 128).
// The same schedule as the float32 pair: dK/dV starts the first K tiles
// (the longest causal columns) first, dQ the last Q tiles; one writer per
// output element, no atomics.  55 KB of shared memory a block at D = 64
// (69-70 KB at D = 128), taken above 48 KB by opt-in.  D must be 16, 32,
// 64 or 128.
//
// Later work, not done here: wgmma and TMA for the bf16 kernels (Hopper's
// full tensor-core rate; mma.sync reaches a part of it) and warp
// specialisation; in the bf16 backward, the ldmatrix traffic (one 512-byte
// load for every two mma), dK/dV's occupancy (two blocks an SM at 228
// registers) and the exp and mask work in the fragments (dQ without it
// took two thirds of the time, PERF.md section 6).  Tried and not kept,
// each within 3% either way: masking only the tiles at the ragged edge
// and the diagonal, K and V held in registers as A fragments, a cap of
// 168 registers for three dK/dV blocks an SM.  The float32 kernels'
// remaining distance to their FMA bound (shared loads still take
// instruction slots from the FMAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

// ------------------------------------------------------------------ forward

constexpr int kFwdThreads = 128;  // four warps; also the f32 backward's

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
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a [rows, D] matrix into dst (leading
// dimension LD elements) by cp.async, zero past `rows`; not committed
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void async_tile(T* dst, const T* src, int row0,
                                           int rows) {
  constexpr int kPer = 16 / (int)sizeof(T);  // elements per 16-byte copy
  constexpr int kChunks = D / kPer;  // copies per row (a power of two)
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kFwdThreads) {
    const int r = c / kChunks, x = (c % kChunks) * kPer;
    const int gr = row0 + r;
    const bool ok = gr < rows;
    cp_async16(dst + r * LD + x, src + (int64_t)(ok ? gr : 0) * D + x, ok);
  }
}

// max / sum over the 8 lanes that share a score row in the float32
// forward (xor offsets < 8 stay inside them)
__device__ __forceinline__ float row_max8(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum8(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// float32 forward tiles: 128 threads as 16 (rows) x 8 (keys / columns);
// thread (ty, tx) owns score rows ty + 16 i and keys tx + 8 j, and o
// columns col(tx, c) (float4 groups 32 apart, or one float2 at D = 16)
template <int D>
struct FwdF32 {
  static constexpr int BQ = D == 128 ? 64 : 128;  // query rows of a block
  static constexpr int BK = 64;                   // keys of a K/V tile
  static constexpr int TM = BQ / 16;              // score rows per thread
  static constexpr int TN = BK / 8;               // keys per thread
  static constexpr int CW = D / 8;                // o columns per thread
  // leading dimensions: rows 16-byte aligned for cp.async and float4
  // loads, 4 banks apart so the 8 key rows of a load hit 8 bank groups;
  // p rows 8 banks apart so the scalar p stores of a warp do not collide
  static constexpr int LQ = D + 4, LK = D + 4, LP = BK + 8;
  static constexpr int kSmemFloats = BQ * LQ + 2 * BK * LK + BQ * LP;
};

template <int CW>
__device__ __forceinline__ void load_cols(const float* row, int tx,
                                          float (&x)[CW]) {
  if constexpr (CW >= 4) {
#pragma unroll
    for (int c = 0; c < CW / 4; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(row + tx * 4 + 32 * c);
      x[4 * c] = t.x;
      x[4 * c + 1] = t.y;
      x[4 * c + 2] = t.z;
      x[4 * c + 3] = t.w;
    }
  } else {
    const float2 t = *reinterpret_cast<const float2*>(row + tx * 2);
    x[0] = t.x;
    x[1] = t.y;
  }
}

template <int CW>
__device__ __forceinline__ void store_cols(float* row, int tx,
                                           const float (&x)[CW]) {
  if constexpr (CW >= 4) {
#pragma unroll
    for (int c = 0; c < CW / 4; ++c)
      *reinterpret_cast<float4*>(row + tx * 4 + 32 * c) =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
  } else {
    *reinterpret_cast<float2*>(row + tx * 2) = make_float2(x[0], x[1]);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 8 j][d] for patch rows
// I0 <= i < I1: a [.][LA] and b [.][LB] row-major in shared memory, read
// 128 bits at a time along d, so 4 (I1 - I0) + 4 TN shared words feed
// 4 (I1 - I0) TN multiply-adds.  The float32 forward's q . k^T and the
// float32 backward's four score products.
template <int D, int TM, int TN, int LA, int LB, int I0, int I1>
__device__ __forceinline__ void patch_dot(const float* a_s, const float* b_s,
                                          int tx, int ty,
                                          float (&s)[TM][TN]) {
#pragma unroll
  for (int i = I0; i < I1; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[TM];
#pragma unroll
    for (int i = I0; i < I1; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * i) * LA + d);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(b_s + (tx + 8 * j) * LB + d);
#pragma unroll
      for (int i = I0; i < I1; ++i) {
        s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
      }
    }
  }
}

// acc[i][c] += sum_kk p[ty + 16 i][kk] * v[kk][col(tx, c)] over KN values
// of kk, for patch rows I0 <= i < I1: p [.][LP] read 128 bits at a time
// along kk, v [KN][LV] along its columns, so 4 (I1 - I0) + 4 CW shared
// words feed 4 (I1 - I0) CW multiply-adds.  The float32 forward's p . v
// and the float32 backward's dS . K, P^T . G and dS^T . Q.
template <int KN, int TM, int CW, int LP, int LV, int I0, int I1>
__device__ __forceinline__ void patch_acc(const float* p_s, const float* v_s,
                                          float (&acc)[TM][CW], int tx,
                                          int ty) {
#pragma unroll 2
  for (int kk = 0; kk < KN; kk += 4) {
    float4 pv[TM];
#pragma unroll
    for (int i = I0; i < I1; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * LP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vv[CW];
      load_cols<CW>(v_s + (kk + u) * LV, tx, vv);
#pragma unroll
      for (int i = I0; i < I1; ++i) {
        const float p = lane_of(pv[i], u);
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
}

// The three products of one K/V tile in the float32 forward, for score
// rows ty + 16 i with i >= I0: at I0 = TM / 2 the first half of the Q tile
// lies wholly above the causal diagonal of the tile (every p is 0) and is
// skipped.  s = q . k^T
template <int D, int I0>
__device__ __forceinline__ void f32_scores(
    const float* q_s, const float* k_s, int tx, int ty,
    float (&s)[FwdF32<D>::TM][FwdF32<D>::TN]) {
  using G = FwdF32<D>;
  patch_dot<D, G::TM, G::TN, G::LQ, G::LK, I0, G::TM>(q_s, k_s, tx, ty, s);
}

// mask and online softmax of the tile's scores; p into shared memory
template <int D, int I0>
__device__ __forceinline__ void f32_softmax(
    float (&s)[FwdF32<D>::TM][FwdF32<D>::TN], float* p_s,
    float (&m)[FwdF32<D>::TM], float (&l)[FwdF32<D>::TM],
    float (&acc)[FwdF32<D>::TM][FwdF32<D>::CW], int q0, int k0, int Tk,
    int causal, float scale, int tx, int ty) {
  using G = FwdF32<D>;
  constexpr int TM = G::TM, TN = G::TN;
#pragma unroll
  for (int i = I0; i < TM; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    bool ok[TN];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kp = k0 + tx + 8 * j;
      ok[j] = kp < Tk && (!causal || qp >= kp);
      s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = row_max8(mx);
    const float m_new = fmaxf(m[i], mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float p = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
      rs += p;
      p_s[r * G::LP + tx + 8 * j] = p;
    }
    rs = row_sum8(rs);
    const float alpha = __expf(m[i] - m_new);
    l[i] = l[i] * alpha + rs;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < G::CW; ++c) acc[i][c] *= alpha;
  }
}

// o += p . v
template <int D, int I0>
__device__ __forceinline__ void f32_pv(
    const float* p_s, const float* v_s,
    float (&acc)[FwdF32<D>::TM][FwdF32<D>::CW], int tx, int ty) {
  using G = FwdF32<D>;
  patch_acc<G::BK, G::TM, G::CW, G::LP, G::LK, I0, G::TM>(p_s, v_s, acc, tx,
                                                          ty);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int N, int Tq, int Tk, float scale, int causal,
    int n_qt) {
  using G = FwdF32<D>;
  constexpr int BQ = G::BQ, BK = G::BK, TM = G::TM, TN = G::TN, CW = G::CW;
  constexpr int LQ = G::LQ, LK = G::LK;
  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][LQ]
  float* k_s = q_s + BQ * LQ;      // [BK][LK], one K tile
  float* v_s = k_s + BK * LK;      // [BK][LK], one V tile
  float* p_s = v_s + BK * LK;      // [BQ][LP]

  // longest causal rows first: every row of N's last Q tile, then the
  // tiles before it
  const int qt = n_qt - 1 - (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const float* qn = q + (int64_t)n * Tq * D;
  const float* kn = k + (int64_t)n * Tk * D;
  const float* vn = v + (int64_t)n * Tk * D;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, Tq) - 1) / BK + 1);

  // K and V alternate in one buffer each: K(kt+1) loads during the
  // softmax and p.v of tile kt, V(kt+1) during the scores of tile kt+1
  async_tile<float, D, BQ, LQ>(q_s, qn, q0, Tq);
  async_tile<float, D, BK, LK>(k_s, kn, 0, Tk);
  cp_async_commit();
  async_tile<float, D, BK, LK>(v_s, vn, 0, Tk);
  cp_async_commit();

  float m[TM], l[TM], acc[TM][CW], s[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    // the first half of the Q tile precedes every key of this tile
    const bool half = causal && q0 + BQ / 2 <= k0;
    cp_async_wait<1>();  // Q and K(kt) are in; V(kt) may be in flight
    __syncthreads();
    if (half)
      f32_scores<D, TM / 2>(q_s, k_s, tx, ty, s);
    else
      f32_scores<D, 0>(q_s, k_s, tx, ty, s);
    __syncthreads();  // every thread is done with K(kt)
    if (kt + 1 < n_kt) {
      async_tile<float, D, BK, LK>(k_s, kn, k0 + BK, Tk);
      cp_async_commit();
    }
    if (half)
      f32_softmax<D, TM / 2>(s, p_s, m, l, acc, q0, k0, Tk, causal, scale,
                             tx, ty);
    else
      f32_softmax<D, 0>(s, p_s, m, l, acc, q0, k0, Tk, causal, scale, tx,
                        ty);
    if (kt + 1 < n_kt)
      cp_async_wait<1>();  // V(kt) is in; K(kt+1) may be in flight
    else
      cp_async_wait<0>();
    __syncthreads();  // p and V(kt) visible to all
    if (half)
      f32_pv<D, TM / 2>(p_s, v_s, acc, tx, ty);
    else
      f32_pv<D, 0>(p_s, v_s, acc, tx, ty);
    __syncthreads();  // every thread is done with V(kt) and p
    if (kt + 1 < n_kt) {
      async_tile<float, D, BK, LK>(v_s, vn, k0 + BK, Tk);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < Tq) {
      const float safe = l[i] == 0.f ? 1.f : l[i];
      float out[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) out[c] = acc[i][c] / safe;
      store_cols<CW>(o + ((int64_t)n * Tq + qp) * D, tx, out);
      if (tx == 0) lse[(int64_t)n * Tq + qp] = m[i] + logf(safe);
    }
  }
}

// bfloat16 forward on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate): four warps, each owning 16 query rows of a 64-row Q tile;
// K/V tiles of 64 keys in a two-stage cp.async ring; operands come from
// shared memory by ldmatrix.  Scores and o accumulate in the mma
// fragments: lane (g = lane / 4, t = lane % 4) holds rows g and g + 8,
// columns 8 j + 2 t and 8 j + 2 t + 1 of every 8-column tile j, so a row's
// statistics reduce over the 4 lanes of its quad.
template <int D>
struct FwdBF16 {
  static constexpr int BQ = 64, BK = 64;
  // leading dimension: rows 16-byte aligned, 8 rows on 8 bank groups
  static constexpr int LD = D + 8;
  static constexpr int kSmemElems = BQ * LD + 4 * BK * LD;  // Q, 2 x (K, V)
};

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
// two floats rounded to bfloat16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ldmatrix addresses, for a lane of a warp reading a row-major tile with
// leading dimension LD (elements):
//   a_frag: the A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16);
//           with ldmatrix .trans, the same addresses give the B fragments
//           of two 8-column tiles [c0, c0 + 16) of a [k][n] tile, k-rows
//           [r0, r0 + 16) (regs 0-1 the first n-tile's, 2-3 the second's);
//   b_pair: B fragments of two 8-row tiles [r0, r0 + 16) of a [n][k] tile
//           (B = its transpose), k-columns [c0, c0 + 16).
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* a_frag(
    const __nv_bfloat16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const __nv_bfloat16* b_pair(
    const __nv_bfloat16* s, int r0, int c0, int lane) {
  return s + (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
         ((lane >> 3) & 1) * 8;
}

// The A fragment of k-step kk from the C fragments of 8-column tiles 2 kk
// and 2 kk + 1, rounded to bfloat16
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int N, int Tq, int Tk, float scale, int causal,
    int n_qt) {
  using G = FwdBF16<D>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD;
  constexpr int KS = D / 16;  // k-steps of q . k^T
  constexpr int NT = D / 8;   // 8-column tiles of o
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* k_s = q_s + BQ * LD;      // [2][BK][LD]
  __nv_bfloat16* v_s = k_s + 2 * BK * LD;  // [2][BK][LD]

  const int qt = n_qt - 1 - (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* qn = q + (int64_t)n * Tq * D;
  const __nv_bfloat16* kn = k + (int64_t)n * Tk * D;
  const __nv_bfloat16* vn = v + (int64_t)n * Tk * D;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, Tq) - 1) / BK + 1);

  async_tile<__nv_bfloat16, D, BQ, LD>(q_s, qn, q0, Tq);
  async_tile<__nv_bfloat16, D, BK, LD>(k_s, kn, 0, Tk);
  async_tile<__nv_bfloat16, D, BK, LD>(v_s, vn, 0, Tk);
  cp_async_commit();

  uint32_t qf[KS][4];  // this warp's 16 query rows as A fragments
  float oacc[NT][4], m[2], l[2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[t][e] = 0.f;
  m[0] = m[1] = kNegInf;
  l[0] = l[1] = 0.f;
  const int r0 = q0 + warp * 16 + g;  // rows r0 and r0 + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < n_kt) {  // the other stage was freed at the end of kt - 1
      const int st = (kt + 1) & 1;
      async_tile<__nv_bfloat16, D, BK, LD>(k_s + st * BK * LD, kn, k0 + BK,
                                           Tk);
      async_tile<__nv_bfloat16, D, BK, LD>(v_s + st * BK * LD, vn, k0 + BK,
                                           Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], a_frag<LD>(q_s, warp * 16, ks * 16, lane));
    }
    const __nv_bfloat16* kb = k_s + (kt & 1) * BK * LD;
    const __nv_bfloat16* vb = v_s + (kt & 1) * BK * LD;

    // s = q . k^T over 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair<LD>(kb, jp * 16, ks * 16, lane));
        mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
      }
    }

    // mask and online softmax for rows r0 (h = 0) and r0 + 8 (h = 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qp = r0 + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * t4 + e;
          const bool ok = kp < Tk && (!causal || qp >= kp);
          float& x = s[j][2 * h + e];
          x = ok ? x * scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * h + e];
          x = x == kNegInf ? 0.f : __expf(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      alpha[h] = __expf(m[h] - m_new);
      l[h] = l[h] * alpha[h] + rs;
      m[h] = m_new;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      oacc[t][0] *= alpha[0];
      oacc[t][1] *= alpha[0];
      oacc[t][2] *= alpha[1];
      oacc[t][3] *= alpha[1];
    }

    // o += p . v: p, rounded to bfloat16, is the A operand straight from
    // the score fragments (the JAX dtype rule for bf16 inputs)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      c_to_a<8>(a, s, kk);
#pragma unroll
      for (int tp = 0; tp < NT / 2; ++tp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, a_frag<LD>(vb, kk * 16, tp * 16, lane));
        mma_bf16(oacc[2 * tp], a, b[0], b[1]);
        mma_bf16(oacc[2 * tp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // stage kt & 1 is free for tile kt + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = r0 + 8 * h;
    if (qp < Tq) {
      const float safe = l[h] == 0.f ? 1.f : l[h];
      __nv_bfloat16* orow = o + ((int64_t)n * Tq + qp) * D;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * t + 2 * t4) =
            __floats2bfloat162_rn(oacc[t][2 * h] / safe,
                                  oacc[t][2 * h + 1] / safe);
      if (t4 == 0) lse[(int64_t)n * Tq + qp] = m[h] + logf(safe);
    }
  }
}

// ------------------------------------------------------ float32 backward

// 4 bytes from global to shared memory by cp.async (4-byte alignment is
// enough); zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// lse and delta of rows [row0, row0 + ROWS) into lse_s / dl_s by cp.async,
// zero past `rows`; not committed
template <int ROWS>
__device__ __forceinline__ void async_stats(float* lse_s, float* dl_s,
                                            const float* lse,
                                            const float* delta, int row0,
                                            int rows) {
  for (int c = threadIdx.x; c < 2 * ROWS; c += kFwdThreads) {
    const int r = c % ROWS, gr = row0 + r;
    const bool ok = gr < rows;
    const float* src = (c < ROWS ? lse : delta) + (ok ? gr : 0);
    cp_async4((c < ROWS ? lse_s : dl_s) + r, src, ok);
  }
}

// float32 dQ tiles: the forward's 128 threads as 16 x 8; thread (ty, tx)
// owns rows ty + 16 i of the Q tile, keys tx + 8 j of a K/V tile and dq
// columns col(tx, c)
template <int D>
struct BwdDqF32 {
  static constexpr int BQ = 64;  // query rows of a block
  static constexpr int BK = 64;  // keys of a K/V tile
  static constexpr int TM = BQ / 16, TN = BK / 8, CW = D / 8;
  // rows as in FwdF32: 16-byte aligned, 4 banks apart; dS rows 8 apart
  static constexpr int LQ = D + 4, LK = D + 4, LS = BK + 8;
  // Q, G [BQ][LQ]; one K and one V tile [BK][LK]; dS [BQ][LS]; lse and
  // delta [BQ]
  static constexpr int kSmemFloats =
      2 * BQ * LQ + 2 * BK * LK + BQ * LS + 2 * BQ;
};

// dS of one (Q tile, K tile) pair from the scores s = q . k^T and dP,
// which waits in ds_s: p = exp(s scale - lse), 0 where masked (padded
// rows and keys too), dS = p (dP - delta) scale into ds_s, in place (each
// thread rewrites its own entries)
template <int D>
__device__ __forceinline__ void dq_f32_ds(
    const float (&s)[BwdDqF32<D>::TM][BwdDqF32<D>::TN], float* ds_s,
    const float* lse_s, const float* dl_s, int q0, int k0, int Tq, int Tk,
    int causal, float scale, int tx, int ty) {
  using G = BwdDqF32<D>;
#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    const float ls = lse_s[r], dl = dl_s[r];
#pragma unroll
    for (int j = 0; j < G::TN; ++j) {
      const int kp = k0 + tx + 8 * j;
      const bool ok = qp < Tq && kp < Tk && (!causal || qp >= kp);
      const float p = ok ? __expf(s[i][j] * scale - ls) : 0.f;
      float& e = ds_s[r * G::LS + tx + 8 * j];
      e = p * (e - dl) * scale;
    }
  }
}

// dP = g . v^T, parked in ds_s for dq_f32_ds
template <int D>
__device__ __forceinline__ void dq_f32_dp(
    const float* g_s, const float* v_s, float* ds_s, int tx, int ty,
    float (&s)[BwdDqF32<D>::TM][BwdDqF32<D>::TN]) {
  using G = BwdDqF32<D>;
  patch_dot<D, G::TM, G::TN, G::LQ, G::LK, 0, G::TM>(g_s, v_s, tx, ty, s);
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < G::TN; ++j)
      ds_s[(ty + 16 * i) * G::LS + tx + 8 * j] = s[i][j];
}

// One K/V tile of the float32 dQ pass: dP (parked), the scores, dS, then
// dq += dS . K, with V(kt + 1) loading from the end of dP on; K(kt + 1)
// starts loading after the return, when K(kt) is free.
template <int D>
__device__ __forceinline__ void dq_f32_tile(
    const float* q_s, const float* g_s, const float* k_s, float* v_s,
    float* ds_s, const float* lse_s, const float* dl_s, const float* vn,
    float (&acc)[BwdDqF32<D>::TM][BwdDqF32<D>::CW], int q0, int k0,
    bool more, int Tq, int Tk, int causal, float scale, int tx, int ty) {
  using G = BwdDqF32<D>;
  float s[G::TM][G::TN];
  dq_f32_dp<D>(g_s, v_s, ds_s, tx, ty, s);
  __syncthreads();  // every thread is done with V(kt)
  if (more) {
    async_tile<float, D, G::BK, G::LK>(v_s, vn, k0 + G::BK, Tk);
    cp_async_commit();
    cp_async_wait<1>();  // K(kt) is in; V(kt + 1) may be in flight
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // K(kt) visible to all
  patch_dot<D, G::TM, G::TN, G::LQ, G::LK, 0, G::TM>(q_s, k_s, tx, ty, s);
  dq_f32_ds<D>(s, ds_s, lse_s, dl_s, q0, k0, Tq, Tk, causal, scale, tx, ty);
  __syncthreads();  // dS visible to all
  patch_acc<G::BK, G::TM, G::CW, G::LS, G::LK, 0, G::TM>(ds_s, k_s, acc, tx,
                                                         ty);
}

// float32 dQ: one block per (row of N, Q tile), longest causal rows first,
// looping over its K/V tiles.  Q, G, lse and delta stay; K and V have one
// buffer each and alternate: V(kt + 1) loads during the scores, dS and
// dS . K of tile kt, K(kt + 1) during dP of tile kt + 1.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int N, int Tq, int Tk, float scale, int causal,
    int n_qt) {
  using G = BwdDqF32<D>;
  constexpr int BQ = G::BQ, BK = G::BK, TM = G::TM, CW = G::CW;
  extern __shared__ float smem[];
  float* q_s = smem;                // [BQ][LQ]
  float* g_s = q_s + BQ * G::LQ;    // [BQ][LQ]
  float* k_s = g_s + BQ * G::LQ;    // [BK][LK]
  float* v_s = k_s + BK * G::LK;    // [BK][LK]
  float* ds_s = v_s + BK * G::LK;   // [BQ][LS]
  float* lse_s = ds_s + BQ * G::LS; // [BQ]
  float* dl_s = lse_s + BQ;         // [BQ]

  const int qt = n_qt - 1 - (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const float* kn = k + (int64_t)n * Tk * D;
  const float* vn = v + (int64_t)n * Tk * D;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, Tq) - 1) / BK + 1);

  async_tile<float, D, BQ, G::LQ>(q_s, q + (int64_t)n * Tq * D, q0, Tq);
  async_tile<float, D, BQ, G::LQ>(g_s, g + (int64_t)n * Tq * D, q0, Tq);
  async_stats<BQ>(lse_s, dl_s, lse + (int64_t)n * Tq,
                  delta + (int64_t)n * Tq, q0, Tq);
  async_tile<float, D, BK, G::LK>(v_s, vn, 0, Tk);
  cp_async_commit();
  async_tile<float, D, BK, G::LK>(k_s, kn, 0, Tk);
  cp_async_commit();

  float acc[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const bool more = kt + 1 < n_kt;
    cp_async_wait<1>();  // Q, G, the stats and V(kt) are in
    __syncthreads();
    dq_f32_tile<D>(q_s, g_s, k_s, v_s, ds_s, lse_s, dl_s, vn, acc, q0, k0,
                   more, Tq, Tk, causal, scale, tx, ty);
    __syncthreads();  // every thread is done with K(kt) and dS
    if (more) {
      async_tile<float, D, BK, G::LK>(k_s, kn, k0 + BK, Tk);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < Tq) store_cols<CW>(dq + ((int64_t)n * Tq + qp) * D, tx, acc[i]);
  }
}

// float32 dK/dV tiles, in the transposed frame (FlashAttention-2): a
// block owns BK keys, which are the rows of its patches; thread (ty, tx)
// owns keys ty + 16 i, queries tx + 8 j of a Q tile, and dk / dv columns
// col(tx, c)
template <int D>
struct BwdDkdvF32 {
  static constexpr int BK = 64;  // keys of a block
  static constexpr int BQ = 64;  // queries of a Q tile
  static constexpr int TM = BK / 16, TN = BQ / 8, CW = D / 8;
  static constexpr int LK = D + 4, LQ = D + 4, LP = BQ + 8;
  // K, V [BK][LK]; one Q and one G tile [BQ][LQ]; P^T, dS^T [BK][LP];
  // lse and delta of the Q tile [BQ]
  static constexpr int kSmemFloats =
      2 * BK * LK + 2 * BQ * LQ + 2 * BK * LP + 2 * BQ;
};

// One Q tile of the float32 dK/dV pass: S^T = K . Q^T and P^T, parked in
// p_s; dP^T = V . G^T and dS^T = P^T (dP^T - delta) scale into ds_s;
// dk += dS^T . Q; then, with Q(qt + 1) loading, dv += P^T . G.  G(qt + 1)
// starts loading after the return, when G is free.
template <int D>
__device__ __forceinline__ void dkdv_f32_tile(
    const float* k_s, const float* v_s, float* q_s, const float* g_s,
    float* p_s, float* ds_s, float* lse_s, float* dl_s, const float* qn,
    const float* lsen, const float* dln,
    float (&dka)[BwdDkdvF32<D>::TM][BwdDkdvF32<D>::CW],
    float (&dva)[BwdDkdvF32<D>::TM][BwdDkdvF32<D>::CW], int q0, int k0,
    bool more, int Tq, int Tk, int causal, float scale, int tx, int ty) {
  using G = BwdDkdvF32<D>;
  constexpr int TM = G::TM, TN = G::TN, BQ = G::BQ;
  float s[TM][TN];
  patch_dot<D, TM, TN, G::LK, G::LQ, 0, TM>(k_s, q_s, tx, ty, s);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx + 8 * j, qp = q0 + c;
    const float ls = lse_s[c];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int kp = k0 + ty + 16 * i;
      const bool ok = qp < Tq && kp < Tk && (!causal || qp >= kp);
      p_s[(ty + 16 * i) * G::LP + c] =
          ok ? __expf(s[i][j] * scale - ls) : 0.f;
    }
  }
  cp_async_wait<0>();  // G(qt) is in
  __syncthreads();
  patch_dot<D, TM, TN, G::LK, G::LQ, 0, TM>(v_s, g_s, tx, ty, s);
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int c = tx + 8 * j;
    const float dl = dl_s[c];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int e = (ty + 16 * i) * G::LP + c;
      ds_s[e] = p_s[e] * (s[i][j] - dl) * scale;
    }
  }
  __syncthreads();  // P^T and dS^T visible to all
  patch_acc<BQ, TM, G::CW, G::LP, G::LQ, 0, TM>(ds_s, q_s, dka, tx, ty);
  __syncthreads();  // every thread is done with Q(qt) and the stats
  if (more) {
    async_tile<float, D, BQ, G::LQ>(q_s, qn, q0 + BQ, Tq);
    async_stats<BQ>(lse_s, dl_s, lsen, dln, q0 + BQ, Tq);
    cp_async_commit();
  }
  patch_acc<BQ, TM, G::CW, G::LP, G::LQ, 0, TM>(p_s, g_s, dva, tx, ty);
}

// float32 dK/dV: one block per (row of N, K tile), the first K tiles (the
// longest causal columns) first, looping over the Q tiles from the causal
// diagonal on.  K and V stay; Q (with its lse and delta) and G have one
// buffer each and alternate: Q(qt + 1) loads during dv += P^T . G of
// tile qt, G(qt + 1) during S^T of tile qt + 1.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int N, int Tq, int Tk,
    float scale, int causal, int n_kt) {
  using G = BwdDkdvF32<D>;
  constexpr int BK = G::BK, BQ = G::BQ, TM = G::TM, CW = G::CW;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [BK][LK]
  float* v_s = k_s + BK * G::LK;     // [BK][LK]
  float* q_s = v_s + BK * G::LK;     // [BQ][LQ]
  float* g_s = q_s + BQ * G::LQ;     // [BQ][LQ]
  float* p_s = g_s + BQ * G::LQ;     // [BK][LP]
  float* ds_s = p_s + BK * G::LP;    // [BK][LP]
  float* lse_s = ds_s + BK * G::LP;  // [BQ]
  float* dl_s = lse_s + BQ;          // [BQ]

  const int kt = (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int k0 = kt * BK;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const float* qn = q + (int64_t)n * Tq * D;
  const float* gn = g + (int64_t)n * Tq * D;
  const float* lsen = lse + (int64_t)n * Tq;
  const float* dln = delta + (int64_t)n * Tq;

  const int n_qt = (Tq + BQ - 1) / BQ;
  // causal: Q tiles wholly above this K tile (q0 + BQ - 1 < k0) see
  // p == 0, so start at the tile holding query k0
  const int qt0 = causal ? k0 / BQ : 0;

  async_tile<float, D, BK, G::LK>(k_s, k + (int64_t)n * Tk * D, k0, Tk);
  async_tile<float, D, BK, G::LK>(v_s, v + (int64_t)n * Tk * D, k0, Tk);
  async_tile<float, D, BQ, G::LQ>(q_s, qn, qt0 * BQ, Tq);
  async_stats<BQ>(lse_s, dl_s, lsen, dln, qt0 * BQ, Tq);
  cp_async_commit();
  async_tile<float, D, BQ, G::LQ>(g_s, gn, qt0 * BQ, Tq);
  cp_async_commit();

  float dka[TM][CW], dva[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    const bool more = qt + 1 < n_qt;
    cp_async_wait<1>();  // K, V, Q(qt) and its stats are in
    __syncthreads();
    dkdv_f32_tile<D>(k_s, v_s, q_s, g_s, p_s, ds_s, lse_s, dl_s, qn, lsen,
                     dln, dka, dva, q0, k0, more, Tq, Tk, causal, scale, tx,
                     ty);
    __syncthreads();  // every thread is done with G(qt), P^T and dS^T
    if (more) {
      async_tile<float, D, BQ, G::LQ>(g_s, gn, q0 + BQ, Tq);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (no Q tile at all
                       // when a causal K tile starts past Tq)

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp < Tk) {
      const int64_t row = ((int64_t)n * Tk + kp) * D;
      store_cols<CW>(dk + row, tx, dka[i]);
      store_cols<CW>(dv + row, tx, dva[i]);
    }
  }
}

// ----------------------------------------------------- bfloat16 backward
//
// Both kernels run their four (dK/dV) or three (dQ) products on the tensor
// cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate), as the bfloat16
// forward does: four warps of 16 rows each, operands from row-major tiles
// in shared memory by ldmatrix, and p and dS, rounded to bfloat16 in the
// accumulator fragments, reused straight from registers as the A operand
// of the next product (the C fragment of an m16n8 tile pair is the A
// fragment of one m16n8k16 step).  In a C fragment lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, columns 8 j + 2 t and 8 j + 2 t + 1
// of every 8-column tile j.

// 2^x by the special-function unit, denormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// dK/dV tiles, in the transposed frame: a block owns BK keys (warp w the
// 16 keys 16 w ...), streams Q tiles of BQ queries through a two-stage
// cp.async ring; at D = 128 a narrower Q tile keeps dk, dv (64 floats each
// a thread) and the two score tiles in registers
template <int D>
struct BwdDkdvBF16 {
  static constexpr int BK = 64;                  // keys of a block
  static constexpr int BQ = D == 128 ? 32 : 64;  // queries of a Q tile
  // leading dimension: rows 16-byte aligned, the 8 rows of an ldmatrix
  // phase on 8 bank groups
  static constexpr int LD = D + 8;
  // K, V [BK][LD]; two stages of Q, G [BQ][LD] (bf16), then two stages of
  // lse and delta [BQ] (float32)
  static constexpr int kSmemBytes =
      2 * (2 * BK * LD + 4 * BQ * LD) + 4 * (4 * BQ);
};

// dQ tiles: a block owns BQ queries (warp w the 16 rows 16 w ...), with
// its q and g fragments in registers, and streams K/V tiles of BK keys
// through a two-stage ring; narrower K/V tiles at D = 128, as above
template <int D>
struct BwdDqBF16 {
  static constexpr int BQ = 64;                  // queries of a block
  static constexpr int BK = D == 128 ? 32 : 64;  // keys of a K/V tile
  static constexpr int LD = D + 8;
  // Q, G [BQ][LD]; two stages of K, V [BK][LD] (bf16)
  static constexpr int kSmemBytes = 2 * (2 * BQ * LD + 4 * BK * LD);
};

// bfloat16 dK/dV: one block per (row of N, K tile), the first K tiles
// (the longest causal columns) first, looping over the Q tiles from the
// causal diagonal on.  Per Q tile, warp w computes, for its 16 keys,
// s^T = k . q^T and dP^T = v . g^T (A: K and V by ldmatrix; B: Q and G by
// ldmatrix), then p^T = exp(s^T scale - lse) and dS^T = p^T (dP^T - delta)
// scale in the fragments (lse and delta per column, i.e. per query), and
// dv += p^T . g, dk += dS^T . q with p^T and dS^T as bf16 A fragments from
// registers and G and Q by ldmatrix .trans.  The Q tile after the current
// one (Q, G, lse, delta) loads during its products.
template <int D>
__global__ void __launch_bounds__(kFwdThreads) flash_bwd_dkdv_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N,
    int Tq, int Tk, float scale, int causal, int n_kt) {
  using G = BwdDkdvBF16<D>;
  constexpr int BK = G::BK, BQ = G::BQ, LD = G::LD;
  constexpr int KS = D / 16;   // k-steps of the score products (over d)
  constexpr int NQ = BQ / 8;   // 8-query tiles of s^T and dP^T
  constexpr int QS = BQ / 16;  // k-steps of dv and dk (over queries)
  constexpr int ND = D / 8;    // 8-column tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + BK * LD;      // [BK][LD]
  __nv_bfloat16* q_s = v_s + BK * LD;      // [2][BQ][LD]
  __nv_bfloat16* g_s = q_s + 2 * BQ * LD;  // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(g_s + 2 * BQ * LD);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int kt = (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int k0 = kt * BK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int kr = warp * 16 + (lane >> 2);  // key rows kr and kr + 8
  const __nv_bfloat16* qn = q + (int64_t)n * Tq * D;
  const __nv_bfloat16* gn = g + (int64_t)n * Tq * D;
  const float* lsen = lse + (int64_t)n * Tq;
  const float* dln = delta + (int64_t)n * Tq;

  const int n_qt = (Tq + BQ - 1) / BQ;
  // causal: Q tiles wholly above this K tile (q0 + BQ - 1 < k0) see
  // p == 0, so start at the tile holding query k0
  const int qt0 = causal ? k0 / BQ : 0;

  async_tile<__nv_bfloat16, D, BK, LD>(k_s, k + (int64_t)n * Tk * D, k0, Tk);
  async_tile<__nv_bfloat16, D, BK, LD>(v_s, v + (int64_t)n * Tk * D, k0, Tk);
  async_tile<__nv_bfloat16, D, BQ, LD>(q_s, qn, qt0 * BQ, Tq);
  async_tile<__nv_bfloat16, D, BQ, LD>(g_s, gn, qt0 * BQ, Tq);
  async_stats<BQ>(lse_s, dl_s, lsen, dln, qt0 * BQ, Tq);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;
  const float sl2 = scale * kLog2e;  // p = 2^(s sl2 - lse log2(e))

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {  // the other stage was freed at the end of qt - 1
      const int nx = st ^ 1, q1 = (qt + 1) * BQ;
      async_tile<__nv_bfloat16, D, BQ, LD>(q_s + nx * BQ * LD, qn, q1, Tq);
      async_tile<__nv_bfloat16, D, BQ, LD>(g_s + nx * BQ * LD, gn, q1, Tq);
      async_stats<BQ>(lse_s + nx * BQ, dl_s + nx * BQ, lsen, dln, q1, Tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qb = q_s + st * BQ * LD;
    const __nv_bfloat16* gb = g_s + st * BQ * LD;
    const float* lb = lse_s + st * BQ;
    const float* db = dl_s + st * BQ;
    const int q0 = qt * BQ;

    // s^T = k . q^T and dP^T = v . g^T, 16 keys x BQ queries a warp
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, a_frag<LD>(k_s, warp * 16, ks * 16, lane));
      ldmatrix_x4(va, a_frag<LD>(v_s, warp * 16, ks * 16, lane));
#pragma unroll
      for (int jp = 0; jp < NQ / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair<LD>(qb, jp * 16, ks * 16, lane));
        mma_bf16(sT[2 * jp], ka, b[0], b[1]);
        mma_bf16(sT[2 * jp + 1], ka, b[2], b[3]);
        ldmatrix_x4(b, b_pair<LD>(gb, jp * 16, ks * 16, lane));
        mma_bf16(dpT[2 * jp], va, b[0], b[1]);
        mma_bf16(dpT[2 * jp + 1], va, b[2], b[3]);
      }
    }

    // p^T and dS^T in place; padded queries and keys are masked too
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t4 + e, qp = q0 + c;
        const float ls2 = lb[c] * kLog2e, dl = db[c];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kp = k0 + kr + 8 * h;
          const bool ok = qp < Tq && kp < Tk && (!causal || qp >= kp);
          const float p = ok ? ex2(fmaf(sT[j][2 * h + e], sl2, -ls2)) : 0.f;
          sT[j][2 * h + e] = p;
          dpT[j][2 * h + e] = p * (dpT[j][2 * h + e] - dl) * scale;
        }
      }

    // dv += p^T . g and dk += dS^T . q, p^T and dS^T rounded to bfloat16
#pragma unroll
    for (int kk = 0; kk < QS; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a<NQ>(pa, sT, kk);
      c_to_a<NQ>(da, dpT, kk);
#pragma unroll
      for (int tp = 0; tp < ND / 2; ++tp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, a_frag<LD>(gb, kk * 16, tp * 16, lane));
        mma_bf16(dva[2 * tp], pa, b[0], b[1]);
        mma_bf16(dva[2 * tp + 1], pa, b[2], b[3]);
        ldmatrix_x4_trans(b, a_frag<LD>(qb, kk * 16, tp * 16, lane));
        mma_bf16(dka[2 * tp], da, b[0], b[1]);
        mma_bf16(dka[2 * tp + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // stage st is free for Q tile qt + 2
  }
  cp_async_wait<0>();  // no copy outlives the block (no Q tile at all
                       // when a causal K tile starts past Tq)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + kr + 8 * h;
    if (kp < Tk) {
      const int64_t row = ((int64_t)n * Tk + kp) * D + 2 * t4;
#pragma unroll
      for (int t = 0; t < ND; ++t) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * t) =
            __floats2bfloat162_rn(dka[t][2 * h], dka[t][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * t) =
            __floats2bfloat162_rn(dva[t][2 * h], dva[t][2 * h + 1]);
      }
    }
  }
}

// bfloat16 dQ: one block per (row of N, Q tile), longest causal rows
// first, looping over its K/V tiles up to the causal limit.  Warp w holds
// its 16 rows of q and g as A fragments; per K/V tile, s = q . k^T and
// dP = g . v^T (B: K and V by ldmatrix), dS = p (dP - delta) scale in the
// fragments (lse and delta per row), and dq += dS . k with dS as a bf16 A
// fragment from registers and K by ldmatrix .trans.  The next K/V tile
// loads during the current one's products.
template <int D>
__global__ void __launch_bounds__(kFwdThreads) flash_bwd_dq_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int N, int Tq, int Tk, float scale,
    int causal, int n_qt) {
  using G = BwdDqBF16<D>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD;
  constexpr int KS = D / 16;   // k-steps of the score products (over d)
  constexpr int NK = BK / 8;   // 8-key tiles of s and dP
  constexpr int KK = BK / 16;  // k-steps of dq (over keys)
  constexpr int ND = D / 8;    // 8-column tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* g_s = q_s + BQ * LD;      // [BQ][LD]
  __nv_bfloat16* k_s = g_s + BQ * LD;      // [2][BK][LD]
  __nv_bfloat16* v_s = k_s + 2 * BK * LD;  // [2][BK][LD]

  const int qt = n_qt - 1 - (int)(blockIdx.x / N);
  const int n = (int)(blockIdx.x % N);
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int r0 = q0 + warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const __nv_bfloat16* kn = k + (int64_t)n * Tk * D;
  const __nv_bfloat16* vn = v + (int64_t)n * Tk * D;

  int n_kt = (Tk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (min(q0 + BQ, Tq) - 1) / BK + 1);

  async_tile<__nv_bfloat16, D, BQ, LD>(q_s, q + (int64_t)n * Tq * D, q0, Tq);
  async_tile<__nv_bfloat16, D, BQ, LD>(g_s, g + (int64_t)n * Tq * D, q0, Tq);
  async_tile<__nv_bfloat16, D, BK, LD>(k_s, kn, 0, Tk);
  async_tile<__nv_bfloat16, D, BK, LD>(v_s, vn, 0, Tk);
  cp_async_commit();

  // p = 2^(s sl2 - ls2), ls2 = lse log2(e)
  const float sl2 = scale * kLog2e;
  float ls2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    ls2[h] = r < Tq ? lse[(int64_t)n * Tq + r] * kLog2e : 0.f;
    dl[h] = r < Tq ? delta[(int64_t)n * Tq + r] : 0.f;
  }
  uint32_t qf[KS][4], gf[KS][4];
  float dqa[ND][4];
#pragma unroll
  for (int t = 0; t < ND; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[t][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < n_kt) {  // the other stage was freed at the end of kt - 1
      const int nx = (kt + 1) & 1;
      async_tile<__nv_bfloat16, D, BK, LD>(k_s + nx * BK * LD, kn, k0 + BK,
                                           Tk);
      async_tile<__nv_bfloat16, D, BK, LD>(v_s + nx * BK * LD, vn, k0 + BK,
                                           Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldmatrix_x4(qf[ks], a_frag<LD>(q_s, warp * 16, ks * 16, lane));
        ldmatrix_x4(gf[ks], a_frag<LD>(g_s, warp * 16, ks * 16, lane));
      }
    }
    const __nv_bfloat16* kb = k_s + (kt & 1) * BK * LD;
    const __nv_bfloat16* vb = v_s + (kt & 1) * BK * LD;

    // s = q . k^T and dP = g . v^T, 16 rows x BK keys a warp
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, b_pair<LD>(kb, jp * 16, ks * 16, lane));
        mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
        ldmatrix_x4(b, b_pair<LD>(vb, jp * 16, ks * 16, lane));
        mma_bf16(dp[2 * jp], gf[ks], b[0], b[1]);
        mma_bf16(dp[2 * jp + 1], gf[ks], b[2], b[3]);
      }

    // dS in place of dP; padded rows and keys are masked too
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = r0 + 8 * h, kp = k0 + 8 * j + 2 * t4 + e;
          const bool ok = qp < Tq && kp < Tk && (!causal || qp >= kp);
          const float p = ok ? ex2(fmaf(s[j][2 * h + e], sl2, -ls2[h])) : 0.f;
          dp[j][2 * h + e] = p * (dp[j][2 * h + e] - dl[h]) * scale;
        }

    // dq += dS . k, dS rounded to bfloat16
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t da[4];
      c_to_a<NK>(da, dp, kk);
#pragma unroll
      for (int tp = 0; tp < ND / 2; ++tp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, a_frag<LD>(kb, kk * 16, tp * 16, lane));
        mma_bf16(dqa[2 * tp], da, b[0], b[1]);
        mma_bf16(dqa[2 * tp + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // stage kt & 1 is free for K/V tile kt + 2
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = r0 + 8 * h;
    if (qp < Tq) {
      __nv_bfloat16* row = dq + ((int64_t)n * Tq + qp) * D + 2 * t4;
#pragma unroll
      for (int t = 0; t < ND; ++t)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * t) =
            __floats2bfloat162_rn(dqa[t][2 * h], dqa[t][2 * h + 1]);
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

// prepare() and the largest shared-memory carveout, so that two float32
// forward blocks (104 KB each at D = 64), or two float32 dQ (89 KB) or
// dK/dV (107 KB) blocks, or three bfloat16 backward blocks (55 KB), share
// an SM
template <typename K>
int prepare_carveout(K kern, size_t smem) {
  int rc = prepare(kern, smem);
  if (rc != 0) return rc;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, typename K>
int launch_fwd(K kern, size_t smem, int bq, const void* q, const void* k,
               const void* v, void* o, float* lse, int N, int Tq, int Tk,
               float scale, int causal, cudaStream_t st) {
  int rc = prepare_carveout(kern, smem);
  if (rc != 0) return rc;
  const int n_qt = (Tq + bq - 1) / bq;
  kern<<<(unsigned)(N * n_qt), kFwdThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, N, Tq, Tk, scale,
      causal, n_qt);
  return (int)cudaGetLastError();
}

// float32 inputs run flash_fwd_f32_kernel, bfloat16 ones the tensor-core
// flash_fwd_bf16_kernel
template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int N, int Tq, int Tk, float scale, int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return launch_fwd<T>(flash_fwd_f32_kernel<D>,
                         sizeof(float) * FwdF32<D>::kSmemFloats,
                         FwdF32<D>::BQ, q, k, v, o, lse, N, Tq, Tk, scale,
                         causal, st);
  else
    return launch_fwd<T>(flash_fwd_bf16_kernel<D>,
                         sizeof(T) * FwdBF16<D>::kSmemElems, FwdBF16<D>::BQ,
                         q, k, v, o, lse, N, Tq, Tk, scale, causal, st);
}

// float32 inputs run flash_bwd_dkdv_f32_kernel, bfloat16 ones
// flash_bwd_dkdv_bf16_kernel
template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* g,
         const float* lse, const float* delta, void* dk, void* dv, int N,
         int Tq, int Tk, float scale, int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    using G = BwdDkdvF32<D>;
    auto kern = flash_bwd_dkdv_f32_kernel<D>;
    const size_t smem = sizeof(float) * G::kSmemFloats;
    int rc = prepare_carveout(kern, smem);
    if (rc != 0) return rc;
    const int n_kt = (Tk + G::BK - 1) / G::BK;
    kern<<<(unsigned)(N * n_kt), kFwdThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), N, Tq, Tk,
        scale, causal, n_kt);
    return (int)cudaGetLastError();
  } else {
    using G = BwdDkdvBF16<D>;
    auto kern = flash_bwd_dkdv_bf16_kernel<D>;
    int rc = prepare_carveout(kern, G::kSmemBytes);
    if (rc != 0) return rc;
    const int n_kt = (Tk + G::BK - 1) / G::BK;
    kern<<<(unsigned)(N * n_kt), kFwdThreads, G::kSmemBytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv), N, Tq, Tk, scale, causal,
        n_kt);
    return (int)cudaGetLastError();
  }
}

// float32 inputs run flash_bwd_dq_f32_kernel, bfloat16 ones
// flash_bwd_dq_bf16_kernel
template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* g,
       const float* lse, const float* delta, void* dqp, int N, int Tq, int Tk,
       float scale, int causal, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    using G = BwdDqF32<D>;
    auto kern = flash_bwd_dq_f32_kernel<D>;
    const size_t smem = sizeof(float) * G::kSmemFloats;
    int rc = prepare_carveout(kern, smem);
    if (rc != 0) return rc;
    const int n_qt = (Tq + G::BQ - 1) / G::BQ;
    kern<<<(unsigned)(N * n_qt), kFwdThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g), lse,
        delta, static_cast<float*>(dqp), N, Tq, Tk, scale, causal, n_qt);
    return (int)cudaGetLastError();
  } else {
    using G = BwdDqBF16<D>;
    auto kern = flash_bwd_dq_bf16_kernel<D>;
    int rc = prepare_carveout(kern, G::kSmemBytes);
    if (rc != 0) return rc;
    const int n_qt = (Tq + G::BQ - 1) / G::BQ;
    kern<<<(unsigned)(N * n_qt), kFwdThreads, G::kSmemBytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
        static_cast<T*>(dqp), N, Tq, Tk, scale, causal, n_qt);
    return (int)cudaGetLastError();
  }
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
