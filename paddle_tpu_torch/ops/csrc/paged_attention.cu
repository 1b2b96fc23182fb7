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
// which accumulates in float32 (the JAX package's dtype rules).  A table
// entry is clamped into the arena, as JAX clamps gathers.  A row with
// length <= 0 has every score at the fill and averages V over all of T.
//
// What bounds it on the H100: bytes.  Each live K/V tile is streamed once
// from device memory (3.35 TB/s); the work is one multiply-add per element
// and window row, below the ~20 flops/byte at which float32 CUDA-core
// arithmetic would bind for W <= 4.  At the serving shape (8 slots, 8
// heads, Dh 64, T up to 1024) the live tiles are about 14 MB a call in
// float32, some 4 us at the memory rate, so the design has to keep
// megabytes in flight across all 132 SMs:
//   * split over T (flash-decoding): the grid is (split, head, slot); each
//     block takes a run of `cols` table columns.  The wrapper picks `cols`
//     so that splits x heads x slots fills the SMs several times over.  A
//     split wholly past max_w lengths[s,w] exits at once (unless some row's
//     length is <= 0: such a row needs every column);
//   * wide loads, many in flight: a lane loads 16 bytes of an arena row
//     (4 float32, 8 bfloat16 or 16 int8; 8 int8 at windows over 4, to keep
//     the registers in bounds), Dh / that many lanes share a position, and
//     a lane has the K and V rows of 1-4 positions in each pass, with the
//     next pass's loads issued before this pass computes.  The block stages
//     its columns' arena rows (clamped table entries) in shared memory
//     first, so no load waits on a table read.  A dot product is reduced
//     over the lanes of one position only (log2 of 1..32 shuffle steps),
//     never over the whole warp;
//   * one pass over the split: each lane group keeps its own online
//     softmax (m, l, acc) per window row; groups merge by shuffles, warps
//     through shared memory, so no [W, T] score row lives in shared memory
//     and T is not capped;
//   * each split writes its partial (m, l, acc[Dh]) per window row into
//     float32 scratch, and paged_combine_kernel merges the live splits of a
//     slot in a fixed order, o = sum_j e^(m_j - M) acc_j / sum_j e^(m_j - M)
//     l_j: no atomics, so results repeat exactly.  A split that only holds
//     masked positions of a row has m_j = -1e9 and weighs exactly 0 once
//     the row has a live position.  A slot with one live split, or a call
//     with one split, writes o directly from the split kernel;
//   * bfloat16 outputs round each probability relative to its stream's
//     running max (before the later rescaling), not the normalised one:
//     within bfloat16's tolerance of the full-row version.
//
// What is left: at the serving shape the two kernels take 12-25 us of
// device time against a 2-6 us byte bound.  The split kernel's blocks are
// short chains of dependent memory round trips (lengths, then the table
// and q, then the passes), and the combine kernel is a launch of its own
// (3-5 us).  Later work: a deeper cp.async/TMA ring of tiles, a
// transposed reduction of the W dot products for wide windows, and
// CUDA-graph capture of the decode step, whose host cost per call is
// larger than both kernels together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ../paged_attention.py mirrors these (MAX_WINDOW, HEAD_DIMS, SPLIT_WARPS,
// _PART_EXTRA, MAX_SPLITS, COL_CHUNK); tests/test_torch_ops.py pins them.
// Change them together.
constexpr int kMaxW = 8;        // largest decode window the kernel takes
constexpr int kMaxDh = 128;     // largest head dim
constexpr int kWarps = 4;       // warps of a split block
constexpr int kPartExtra = 2;   // m and l after each row's Dh partial sums
constexpr int kMaxSplits = 64;  // splits of a call (one combine weight each)
constexpr int kColChunk = 32;   // table columns a split block stages at once
constexpr float kFill = -1e9f;  // masked scores, as in the plain version

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// elements of an arena row one lane loads at a time (16 bytes; 8 bytes of
// int8 at windows over 4), and positions per lane group per pass (fewer
// where the window or the load is wide, to keep the registers in bounds)
template <typename KT, int WB>
__host__ __device__ constexpr int elems_per_lane() {
  return sizeof(KT) == 4 ? 4 : sizeof(KT) == 2 ? 8 : (WB <= 4 ? 16 : 8);
}
template <typename KT, int WB>
__host__ __device__ constexpr int unroll() {
  return elems_per_lane<KT, WB>() == 16                      ? 1
         : (WB == 8 || (elems_per_lane<KT, WB>() == 8 && WB == 4)) ? 2
                                                                   : 4;
}

template <int NBYTES>
__device__ __forceinline__ uint4 load_raw(const void* p) {
  if constexpr (NBYTES == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint4(r.x, r.y, 0u, 0u);
  }
}

// the E values of one raw load as float32
template <typename KT, int E>
__device__ __forceinline__ void unpack(const uint4& r, float (&x)[E]) {
  const uint32_t wd[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(KT) == 4) {
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = __uint_as_float(wd[e]);
  } else if constexpr (sizeof(KT) == 2) {
#pragma unroll
    for (int e = 0; e < E / 2; ++e) {
      x[2 * e] = __uint_as_float(wd[e] << 16);
      x[2 * e + 1] = __uint_as_float(wd[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E / 4; ++e)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        x[4 * e + b] = static_cast<float>(
            static_cast<int8_t>((wd[e] >> (8 * b)) & 0xffu));
  }
}

// the raw K and V loads (and int8 scales) of one pass
template <int U>
struct Pass {
  uint4 k[U], v[U];
  float ks[U], vs[U];
};

// issue the loads of the positions t = base + u NG + g in [tb, te) of the
// staged columns (row_s: arena row of each column's first position)
template <typename KT, int E, int U>
__device__ __forceinline__ void fetch(Pass<U>& f, int base, int NG, int g,
                                      int i, int tb, int te, int Bs,
                                      const int64_t* row_s, const KT* k_arena,
                                      const KT* v_arena, const float* k_scale,
                                      const float* v_scale, int Dh) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = base + u * NG + g;
    f.k[u] = f.v[u] = make_uint4(0u, 0u, 0u, 0u);
    f.ks[u] = f.vs[u] = 1.f;
    if (t < te) {
      const int c = (t - tb) / Bs;
      const int64_t row = row_s[c] + (t - tb - c * Bs);
      f.k[u] = load_raw<E * (int)sizeof(KT)>(k_arena + row * Dh + i * E);
      f.v[u] = load_raw<E * (int)sizeof(KT)>(v_arena + row * Dh + i * E);
      if constexpr (sizeof(KT) == 1) {
        f.ks[u] = __ldg(k_scale + row);
        f.vs[u] = __ldg(v_scale + row);
      }
    }
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_out(void* out, int64_t idx, float v,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[idx] = v;
}

// table columns the call must read for slot s: those below max_w
// lengths[s,w], or all of them when some row's length is <= 0
__device__ __forceinline__ int live_columns(const int* len_s, int W, int Bs,
                                            int n_tbl) {
  int max_len = 0, min_len = 0x7fffffff;
  for (int w = 0; w < W; ++w) {
    max_len = max(max_len, len_s[w]);
    min_len = min(min_len, len_s[w]);
  }
  return min_len <= 0 ? n_tbl : min(n_tbl, (max_len + Bs - 1) / Bs);
}

// e^(m - M) for a stream's max m under the merged max M; an empty stream
// (m = -inf) weighs 0
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

template <typename KT, int WB>
__global__ void __launch_bounds__(kWarps * 32) paged_split_kernel(
    const void* __restrict__ q, int q_bf16,    // [S, W, H, Dh]
    const KT* __restrict__ k_arena,            // [NB, L, H, Bs, Dh]
    const KT* __restrict__ v_arena,            // [NB, L, H, Bs, Dh]
    const float* __restrict__ k_scale,         // [NB, L, H, Bs] (int8 only)
    const float* __restrict__ v_scale,         // [NB, L, H, Bs] (int8 only)
    const int* __restrict__ tables,            // [S, n_tbl]
    const int* __restrict__ lengths,           // [S, W]
    void* __restrict__ out, int out_bf16,      // [S, W, H, Dh]
    float* __restrict__ part,  // [S, H, n_splits, W, Dh + kPartExtra]
    int W, int H, int Dh, int Bs, int n_tbl, int n_arena_blocks, int L,
    int layer, float scale, int cols, int n_splits) {
  constexpr int E = elems_per_lane<KT, WB>();
  constexpr int U = unroll<KT, WB>();
  __shared__ float red[kWarps][WB][kMaxDh + kPartExtra];

  const int sp = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int LP = Dh / E;  // lanes per position (a power of two, <= 32)
  const int NG = 32 / LP;  // positions per load instruction
  const int g = lane / LP, i = lane - g * LP;

  const int n_live = live_columns(lengths + (int64_t)s * W, W, Bs, n_tbl);
  const int c0 = sp * cols;
  if (c0 >= n_live) return;  // wholly past every row: the combine skips it
  const int live_splits = (n_live + cols - 1) / cols;
  const int c_end = min(c0 + cols, n_live);

  int len[WB];
  float qv[WB][E], m[WB], l[WB], acc[WB][E];
#pragma unroll
  for (int w = 0; w < WB; ++w) {
    len[w] = w < W ? lengths[(int64_t)s * W + w] : 0;
    const int64_t qrow = ((int64_t)(s * W + w) * H + h) * Dh + i * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float x = 0.f;
      if (w < W)
        x = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q)[qrow + e])
                   : static_cast<const float*>(q)[qrow + e];
      qv[w][e] = x;
      acc[w][e] = 0.f;
    }
    m[w] = -INFINITY;
    l[w] = 0.f;
  }

  const int* tbl = tables + (int64_t)s * n_tbl;
  __shared__ int64_t row_s[kColChunk];
  const int stride = kWarps * NG * U;
  for (int cc = c0; cc < c_end; cc += kColChunk) {
    // stage the arena rows of up to kColChunk columns (clamped entries)
    const int nc = min(kColChunk, c_end - cc);
    __syncthreads();  // the previous chunk's readers are done
    if (threadIdx.x < nc) {
      const int blk = min(max(tbl[cc + threadIdx.x], 0), n_arena_blocks - 1);
      row_s[threadIdx.x] = (((int64_t)blk * L + layer) * H + h) * Bs;
    }
    __syncthreads();
    const int tb = cc * Bs, te = (cc + nc) * Bs;

    // passes of NG x U positions a warp; the loads of the next pass are in
    // flight while this one computes
    Pass<U> cur, nxt;
    int base = tb + warp * NG * U;
    if (base < te)
      fetch<KT, E, U>(cur, base, NG, g, i, tb, te, Bs, row_s, k_arena,
                      v_arena, k_scale, v_scale, Dh);
    for (; base < te; base += stride) {
      if (base + stride < te)
        fetch<KT, E, U>(nxt, base + stride, NG, g, i, tb, te, Bs, row_s,
                        k_arena, v_arena, k_scale, v_scale, Dh);

      // scores: lane partial dots, then a reduction over the position's
      // lanes
      float sc[U][WB];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kx[E];
        unpack<KT, E>(cur.k[u], kx);
#pragma unroll
        for (int w = 0; w < WB; ++w) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qv[w][e], kx[e], d);
          sc[u][w] = d;
        }
      }
      for (int off = LP >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int w = 0; w < WB; ++w)
            sc[u][w] += __shfl_xor_sync(0xffffffffu, sc[u][w], off);

      // online softmax of the pass, per window row
      float pr[U][WB];
#pragma unroll
      for (int w = 0; w < WB; ++w) {
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = base + u * NG + g;
          const float v = t >= te ? -INFINITY
                          : t < len[w] ? sc[u][w] * scale * cur.ks[u]
                                       : kFill;
          sc[u][w] = v;
          mx = fmaxf(mx, v);
        }
        const float m_new = fmaxf(m[w], mx);
        const bool any = m_new != -INFINITY;
        const float alpha = any ? expf(m[w] - m_new) : 1.f;
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = any ? expf(sc[u][w] - m_new) : 0.f;
          ps += p;
          pr[u][w] = (out_bf16 ? round_bf16(p) : p) * cur.vs[u];
        }
        l[w] = l[w] * alpha + ps;
        m[w] = m_new;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[w][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vx[E];
        unpack<KT, E>(cur.v[u], vx);
#pragma unroll
        for (int w = 0; w < WB; ++w)
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[w][e] = fmaf(pr[u][w], vx[e], acc[w][e]);
      }
      cur = nxt;
    }
  }

  // merge the lane groups of the warp (butterfly over the group bits)
  for (int off = LP; off < 32; off <<= 1) {
#pragma unroll
    for (int w = 0; w < WB; ++w) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[w], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[w], off);
      const float mn = fmaxf(m[w], mo);
      const float a = weight(m[w], mn), b = weight(mo, mn);
      l[w] = l[w] * a + lo * b;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[w][e] = acc[w][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[w][e], off) * b;
      m[w] = mn;
    }
  }
  if (g == 0) {
#pragma unroll
    for (int w = 0; w < WB; ++w) {
#pragma unroll
      for (int e = 0; e < E; ++e) red[warp][w][i * E + e] = acc[w][e];
      if (i == 0) {
        red[warp][w][kMaxDh] = m[w];
        red[warp][w][kMaxDh + 1] = l[w];
      }
    }
  }
  __syncthreads();

  // merge the warps; warp 0 holds the split's first position, so M is
  // finite
  for (int x = threadIdx.x; x < W * Dh; x += kWarps * 32) {
    const int w = x / Dh, d = x - w * Dh;
    float M = -INFINITY;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) M = fmaxf(M, red[k][w][kMaxDh]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float wk = weight(red[k][w][kMaxDh], M);
      num += wk * red[k][w][d];
      den += wk * red[k][w][kMaxDh + 1];
    }
    if (live_splits == 1) {
      store_out(out, ((int64_t)(s * W + w) * H + h) * Dh + d, num / den,
                out_bf16);
    } else {
      float* p = part + (((int64_t)(s * H + h) * n_splits + sp) * W + w) *
                            (Dh + kPartExtra);
      p[d] = num;
      if (d == 0) {
        p[Dh] = M;
        p[Dh + 1] = den;
      }
    }
  }
}

// o of every slot with more than one live split, from the splits' partials
// merged in split order: one warp a window row reads the splits' (m, l) at
// once and leaves each split's weight e^(m_j - M) / sum_j e^(m_j - M) l_j
// in shared memory; then every (row, d) sums weight x acc_j over the splits
__global__ void __launch_bounds__(128) paged_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ lengths,
    void* __restrict__ out, int out_bf16, int W, int H, int Dh, int Bs,
    int n_tbl, int cols, int n_splits) {
  __shared__ float wt[kMaxW][kMaxSplits];
  const int h = blockIdx.x, s = blockIdx.y;
  const int n_live = live_columns(lengths + (int64_t)s * W, W, Bs, n_tbl);
  const int live_splits = (n_live + cols - 1) / cols;
  if (live_splits <= 1) return;  // the split kernel wrote o
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rs = W * (Dh + kPartExtra);  // floats between two splits' rows
  const float* ps = part + (int64_t)(s * H + h) * n_splits * rs;
  for (int w = warp; w < W; w += 4) {
    float mj[kMaxSplits / 32], lj[kMaxSplits / 32];
    float M = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxSplits / 32; ++c) {
      const int j = lane + 32 * c;
      const float* pj = ps + j * rs + w * (Dh + kPartExtra) + Dh;
      mj[c] = j < live_splits ? pj[0] : -INFINITY;
      lj[c] = j < live_splits ? pj[1] : 0.f;
      M = fmaxf(M, mj[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float den = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxSplits / 32; ++c) {
      mj[c] = weight(mj[c], M);
      den += mj[c] * lj[c];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, o);
#pragma unroll
    for (int c = 0; c < kMaxSplits / 32; ++c)
      if (lane + 32 * c < live_splits) wt[w][lane + 32 * c] = mj[c] / den;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W * Dh; x += blockDim.x) {
    const int w = x / Dh, d = x - w * Dh;
    const float* pw = ps + w * (Dh + kPartExtra) + d;
    float o = 0.f;
#pragma unroll 8
    for (int j = 0; j < live_splits; ++j) o = fmaf(wt[w][j], pw[j * rs], o);
    store_out(out, ((int64_t)(s * W + w) * H + h) * Dh + d, o, out_bf16);
  }
}

template <typename KT, int WB>
int launch_split(const void* q, int q_bf16, const void* k, const void* v,
                 const float* ks, const float* vs, const int* tables,
                 const int* lengths, void* out, int out_bf16, float* part,
                 int S, int W, int H, int Dh, int Bs, int n_tbl, int nb,
                 int L, int layer, float scale, int cols, int n_splits,
                 cudaStream_t st) {
  dim3 grid(n_splits, H, S);
  paged_split_kernel<KT, WB><<<grid, kWarps * 32, 0, st>>>(
      q, q_bf16, static_cast<const KT*>(k), static_cast<const KT*>(v), ks,
      vs, tables, lengths, out, out_bf16, part, W, H, Dh, Bs, n_tbl, nb, L,
      layer, scale, cols, n_splits);
  return (int)cudaGetLastError();
}

template <typename KT>
int dispatch_window(int W, const void* q, int q_bf16, const void* k,
                    const void* v, const float* ks, const float* vs,
                    const int* tables, const int* lengths, void* out,
                    int out_bf16, float* part, int S, int H, int Dh, int Bs,
                    int n_tbl, int nb, int L, int layer, float scale,
                    int cols, int n_splits, cudaStream_t st) {
#define PAGED_SPLIT(WB)                                                     \
  launch_split<KT, WB>(q, q_bf16, k, v, ks, vs, tables, lengths, out,      \
                       out_bf16, part, S, W, H, Dh, Bs, n_tbl, nb, L, layer, \
                       scale, cols, n_splits, st)
  if (W <= 1) return PAGED_SPLIT(1);
  if (W <= 2) return PAGED_SPLIT(2);
  if (W <= 4) return PAGED_SPLIT(4);
  return PAGED_SPLIT(8);
#undef PAGED_SPLIT
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Dtype codes: 0 float32,
// 1 bfloat16, 2 int8 (arena only; ks/vs then point at the float32 scale
// planes).  `part` is float32 scratch of S * H * n_splits * W * (Dh + 2)
// values, unused (may be null) when n_splits == 1; n_splits must be
// ceil(n_tbl / cols) and at most kMaxSplits.  Enqueues the split kernel and, when n_splits > 1,
// the combine kernel on `stream`; does not synchronise; returns
// cudaGetLastError() of the launches (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_arena, const void* v_arena,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* lengths, void* out, float* part, int S, int W, int H, int Dh,
    int Bs, int n_tbl, int n_arena_blocks, int L, int layer, float scale,
    int q_dtype, int kv_dtype, int out_dtype, int cols, int n_splits,
    void* stream) {
  if (S < 1 || W < 1 || W > kMaxW || H < 1 || Bs < 1 || n_tbl < 1 ||
      cols < 1 || n_splits != (n_tbl + cols - 1) / cols ||
      n_splits > kMaxSplits ||
      (n_splits > 1 && part == nullptr) ||
      (Dh != 16 && Dh != 32 && Dh != 64 && Dh != kMaxDh) ||
      (q_dtype != kF32 && q_dtype != kBF16) ||
      (out_dtype != kF32 && out_dtype != kBF16) ||
      (kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q_bf16 = q_dtype == kBF16, out_bf16 = out_dtype == kBF16;
  int rc;
  if (kv_dtype == kF32)
    rc = dispatch_window<float>(W, q, q_bf16, k_arena, v_arena, k_scale,
                                v_scale, tables, lengths, out, out_bf16,
                                part, S, H, Dh, Bs, n_tbl, n_arena_blocks, L,
                                layer, scale, cols, n_splits, st);
  else if (kv_dtype == kBF16)
    rc = dispatch_window<__nv_bfloat16>(
        W, q, q_bf16, k_arena, v_arena, k_scale, v_scale, tables, lengths,
        out, out_bf16, part, S, H, Dh, Bs, n_tbl, n_arena_blocks, L, layer,
        scale, cols, n_splits, st);
  else if (kv_dtype == kI8)
    rc = dispatch_window<int8_t>(W, q, q_bf16, k_arena, v_arena, k_scale,
                                 v_scale, tables, lengths, out, out_bf16,
                                 part, S, H, Dh, Bs, n_tbl, n_arena_blocks,
                                 L, layer, scale, cols, n_splits, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0 || n_splits == 1) return rc;
  paged_combine_kernel<<<dim3(H, S), 128, 0, st>>>(
      part, lengths, out, out_bf16, W, H, Dh, Bs, n_tbl, cols, n_splits);
  return (int)cudaGetLastError();
}
