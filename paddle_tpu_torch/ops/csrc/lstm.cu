// LSTM recurrence, forward and reverse, for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel paddle_tpu/ops/lstm.py::_lstm_kernel (via
// _lstm_pallas) with the forward, and the JAX package's backward
// (_fused_bwd: jax.vjp over _lstm_scan, not a Pallas kernel there) with the
// reverse recurrence.
//
// What they compute, with xw [T, B, 4H] (x @ Wx + b, gates i, f, c, o in
// blocks of H), U [H, 4H], peep [3, H], mask [T, B] float, and the carried
// state h, c starting at zero:
//   forward, step t:  g = xw_t + h @ U
//     i = ga(g_i [+ c * p0]),  f = ga(g_f [+ c * p1]),  cd = cda(g_c)
//     c_new = f * c + i * cd,  o = ga(g_o [+ c_new * p2]),  h_new = o * ca(c_new)
//     h <- h_new * m + h * (1 - m),  c <- c_new * m + c * (1 - m)
//     hs_t = h_new * m                    (padded steps emit zeros)
//   backward, step t = T-1 .. 0, carrying dh (d carried h_t) and dc (d carried
//   c_t, starting at d c_final):
//     dh = dgates_{t+1} . U^T + dh_{t+1} * (1 - m_{t+1})   (0 at t = T-1)
//     dh_new = (dhs_t + dh) * m,  dc_new = dc * m + dh_new * o * ca'
//     dz_o = dh_new * ca(c_new) * ga'(o)  [dc_new += dz_o * p2]
//     dz_i = dc_new * cd * ga'(i),  dz_f = dc_new * c_prev * ga'(f),
//     dz_c = dc_new * i * cda'(cd)
//     dc <- dc_new * f + dc * (1 - m)  [+ dz_i * p0 + dz_f * p1]
//     dxw_t = (dz_i, dz_f, dz_c, dz_o)
// Activations are picked by code (0 sigmoid, 1 tanh, 2 relu, 3 identity)
// for the gates, the cell and the candidate separately; derivatives are
// taken from the activated value (relu' is 0 at 0, as jax.grad gives).
// The caller computes dU = sum_t h_{t-1}^T dxw_t and the peephole sums
// from the residuals, outside any kernel, as the JAX package does.
//
// Layout of the state: hc and cc are [T + 1, B, H]; slot 0 holds the zero
// initial state (the caller clears it), step t reads slot t and writes slot
// t + 1, so the carried state is double-buffered in device memory and the
// whole history is the backward's residual (h_{t-1} for dU, c_{t-1} for the
// f and peephole terms).  When the caller asks for residuals the forward
// also writes the activated gates [T, B, 4H] and c_new [T, B, H].
//
// What bounds them on the H100 at the training shape (T=100, B=128, H=512,
// float32): operations.  The recurrent product is 2*T*B*H*4H = 26.8 GFLOP a
// pass (0.40 ms at 67 TFLOP/s of float32 FMA on the CUDA cores), against
// about 0.1 ms for the bytes.  float32 runs on the CUDA cores in full
// float32 (the JAX package's HIGHEST precision), so the design keeps the
// product's operands in shared memory and registers:
//   * the TPU kernel walks T as a sequential grid axis with U, h and c in
//     VMEM.  U is 4 MB at H=512, more than one SM's shared memory, and
//     Hopper blocks run in no order, so each C entry point enqueues one
//     launch per step on the caller's stream (Python makes one call per
//     sequence).  U stays in the 50 MB L2 between steps;
//   * forward: a block owns 16 hidden units of 32 batch rows and computes
//     all four gate columns (j, H+j, 2H+j, 3H+j) of h_{t-1} . U for them, so
//     the cell update happens in the registers that hold the sums.  256
//     threads in two halves; h and U go through shared memory in chunks of
//     64 of the depth, each half multiplies 32 of them (4 rows x 4 gates of
//     one unit a thread, read as float4), and the halves' sums meet in
//     shared memory at the end;
//   * backward: the same tile of (rows, units).  Two warps per gate each
//     take half of a 32-deep chunk of that gate's quarter of the depth of
//     dgates_{t+1} . U^T (4 rows x 4 units a thread), the eight partial
//     tiles are summed in shared memory, and each thread then finishes 2
//     (row, unit) pairs elementwise.  dh and dc live in [B, H] buffers that
//     only the owning thread reads and writes from one launch to the next;
//   * both load each chunk into registers while the previous chunk is
//     multiplied, so the global loads overlap the FMAs;
//   * no atomics: every output has one writer, so results repeat exactly.
// What holds them back: every step each block re-reads its U columns and
// its h (or dgates) rows from L2, about 24 MB a step at this shape, and
// each step is a launch.  Later work, not done here: one persistent launch
// for the whole sequence, with each block's U slice (128 KB) resident in
// shared memory and a grid barrier per step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTB = 32;        // batch rows of a block's tile
constexpr int kTJ = 16;        // hidden units of a block's tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kGates = 4;
// forward: a chunk of 64 of the depth, each half of the block takes 32
constexpr int kFwdKC = 64;
constexpr int kFwdLH = kTB * kFwdKC / kThreads;           // h loads a thread
constexpr int kFwdLU = kFwdKC * kGates * kTJ / kThreads;  // U loads a thread
// backward: a chunk of 32 of each gate's quarter of the depth, two warps
// per gate taking 16 each
constexpr int kBwdKC = 32;
constexpr int kBwdLD = kGates * kTB * kBwdKC / kThreads;  // dgates loads
constexpr int kBwdLU = kGates * kTJ * kBwdKC / kThreads;  // U loads
static_assert(kThreads == 2 * kTJ * kTB / 4, "forward: 4 rows x 4 gates a "
              "thread in each half of the block");
static_assert(kThreads == 2 * kGates * 32, "backward: two warps per gate");
static_assert(kFwdLH * kThreads == kTB * kFwdKC &&
              kFwdLU * kThreads == kFwdKC * kGates * kTJ &&
              kBwdLD * kThreads == kGates * kTB * kBwdKC &&
              kBwdLU * kThreads == kGates * kTJ * kBwdKC,
              "chunk loads split evenly over the threads");

enum Act { kSigmoid = 0, kTanh = 1, kRelu = 2, kIdentity = 3 };

__device__ __forceinline__ float act(int code, float x) {
  switch (code) {
    case kSigmoid:
      return 1.f / (1.f + expf(-x));
    case kTanh:
      return tanhf(x);
    case kRelu:
      return x < 0.f ? 0.f : x;  // NaN passes through, as max(x, 0) does
    default:
      return x;
  }
}

// the derivative, from the activated value y = act(code, x)
__device__ __forceinline__ float act_grad(int code, float y) {
  switch (code) {
    case kSigmoid:
      return y * (1.f - y);
    case kTanh:
      return 1.f - y * y;
    case kRelu:
      return y > 0.f ? 1.f : 0.f;
    default:
      return 1.f;
  }
}

struct Acts {
  int use_peep, gate, cell, cand;
};

struct FwdStep {
  const float* xw;      // [B, 4H] of step t
  const float* u;       // [H, 4H]
  const float* peep;    // [3, H]
  const float* mask;    // [B] of step t
  const float* h_prev;  // [B, H] carried state in
  const float* c_prev;
  float* h_next;        // [B, H] carried state out
  float* c_next;
  float* hs;            // [B, H] output of step t
  float* gates;         // [B, 4H] activated i, f, cd, o, or null
  float* cnew;          // [B, H] c_new, or null
  int B, H;
  Acts acts;
};

__global__ void __launch_bounds__(kThreads) lstm_fwd_step(FwdStep a) {
  // h chunk transposed, [depth][row]; rows padded to 36 (a multiple of 4
  // for float4 reads, 4-way store conflicts instead of 32-way)
  __shared__ __align__(16) float hs_t[kFwdKC][kTB + 4];
  // U chunk as [depth][unit][gate]: one float4 holds a unit's four gates
  __shared__ __align__(16) float us[kFwdKC][kTJ][kGates];
  // the second half's sums, [thread][row][gate]
  __shared__ __align__(16) float red[kThreads / 2][4][kGates];

  const int tid = threadIdx.x;
  const int half = tid / (kThreads / 2);       // which 32 of each chunk
  const int tx = tid % kTJ;                    // unit within the tile
  const int ty = (tid % (kThreads / 2)) / kTJ; // rows 4ty .. 4ty+3
  const int j0 = blockIdx.x * kTJ, b0 = blockIdx.y * kTB;
  const int B = a.B, H = a.H;
  const int64_t G = (int64_t)kGates * H;

  // chunk loads go through registers: the next chunk's global loads are in
  // flight while the current one is multiplied
  float rh[kFwdLH], ru[kFwdLU];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kFwdLH; ++q) {
      const int i = tid + q * kThreads;
      const int b = b0 + i / kFwdKC, k = k0 + i % kFwdKC;
      rh[q] = (b < B && k < H) ? a.h_prev[(int64_t)b * H + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kFwdLU; ++q) {
      const int i = tid + q * kThreads;
      const int j = j0 + i % kTJ, g = (i / kTJ) % kGates;
      const int k = k0 + i / (kGates * kTJ);
      ru[q] = (j < H && k < H) ? a.u[(int64_t)k * G + (int64_t)g * H + j] : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int q = 0; q < kFwdLH; ++q) {
      const int i = tid + q * kThreads;
      hs_t[i % kFwdKC][i / kFwdKC] = rh[q];
    }
#pragma unroll
    for (int q = 0; q < kFwdLU; ++q) {
      const int i = tid + q * kThreads;
      us[i / (kGates * kTJ)][i % kTJ][(i / kTJ) % kGates] = ru[q];
    }
  };

  float acc[4][kGates];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < kGates; ++g) acc[r][g] = 0.f;

  load(0);
  for (int k0 = 0; k0 < H; k0 += kFwdKC) {
    store();
    __syncthreads();
    if (k0 + kFwdKC < H) load(k0 + kFwdKC);
#pragma unroll 8
    for (int kq = 0; kq < kFwdKC / 2; ++kq) {
      const int kk = half * (kFwdKC / 2) + kq;
      const float4 hv = *reinterpret_cast<const float4*>(&hs_t[kk][4 * ty]);
      const float4 wv = *reinterpret_cast<const float4*>(&us[kk][tx][0]);
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
      const float wg[kGates] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int g = 0; g < kGates; ++g) acc[r][g] = fmaf(hr[r], wg[g], acc[r][g]);
    }
    __syncthreads();
  }
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(&red[tid - kThreads / 2][r][0]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  const int j = j0 + tx;
  if (half == 1 || j >= H) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 v = *reinterpret_cast<const float4*>(&red[tid][r][0]);
    acc[r][0] += v.x;
    acc[r][1] += v.y;
    acc[r][2] += v.z;
    acc[r][3] += v.w;
  }

  const Acts ac = a.acts;
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  if (ac.use_peep) {
    p0 = a.peep[j];
    p1 = a.peep[H + j];
    p2 = a.peep[2 * H + j];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + 4 * ty + r;
    if (b >= B) break;
    const float* x = a.xw + (int64_t)b * G;
    const int64_t s = (int64_t)b * H + j;
    const float gi = x[j] + acc[r][0], gf = x[H + j] + acc[r][1];
    const float gc = x[2 * H + j] + acc[r][2], go = x[3 * H + j] + acc[r][3];
    const float cp = a.c_prev[s], hp = a.h_prev[s];
    float i, f;
    if (ac.use_peep) {
      i = act(ac.gate, gi + cp * p0);
      f = act(ac.gate, gf + cp * p1);
    } else {
      i = act(ac.gate, gi);
      f = act(ac.gate, gf);
    }
    const float cd = act(ac.cand, gc);
    const float cn = f * cp + i * cd;
    const float o = ac.use_peep ? act(ac.gate, go + cn * p2) : act(ac.gate, go);
    const float hn = o * act(ac.cell, cn);
    const float m = a.mask[b];
    a.h_next[s] = hn * m + hp * (1.f - m);
    a.c_next[s] = cn * m + cp * (1.f - m);
    a.hs[s] = hn * m;
    if (a.gates != nullptr) {
      float* gr = a.gates + (int64_t)b * G;
      gr[j] = i;
      gr[H + j] = f;
      gr[2 * H + j] = cd;
      gr[3 * H + j] = o;
      a.cnew[s] = cn;
    }
  }
}

struct BwdStep {
  const float* dg_next;    // [B, 4H] dgates of step t+1, or null at t = T-1
  const float* mask_next;  // [B] mask of step t+1 (unused at t = T-1)
  const float* u;          // [H, 4H]
  const float* peep;       // [3, H]
  const float* mask;       // [B] of step t
  const float* dhs;        // [B, H] gradient of hs_t
  const float* gates;      // [B, 4H] activated i, f, cd, o of step t
  const float* cnew;       // [B, H] c_new of step t
  const float* c_prev;     // [B, H] carried c_{t-1}
  float* dh;               // [B, H] in: d h_{t+1}; out: d h_t
  float* dc;               // [B, H] in: d c_t;     out: d c_{t-1}
  float* dxw;              // [B, 4H] dgates of step t
  int B, H;
  Acts acts;
};

__global__ void __launch_bounds__(kThreads) lstm_bwd_step(BwdStep a) {
  // one chunk of each gate's quarter of the depth: dgates transposed
  // [gate][depth][row] and U rows as [gate][depth][unit], padded as above
  __shared__ __align__(16) float dg_t[kGates][kBwdKC][kTB + 4];
  __shared__ __align__(16) float ur[kGates][kBwdKC][kTJ + 4];
  // each warp's partial tile, summed over the 8 warps at the end
  __shared__ float part[2 * kGates][kTB][kTJ + 1];

  const int tid = threadIdx.x;
  const int w = tid / 32;                    // warp: gate w % 4, half w / 4
  const int gz = w % kGates, kh = w / kGates;
  const int lane = tid % 32;
  const int rg = lane / 4, ug = lane % 4;    // rows 4rg.., units 4ug..
  const int j0 = blockIdx.x * kTJ, b0 = blockIdx.y * kTB;
  const int B = a.B, H = a.H;
  const int64_t G = (int64_t)kGates * H;

  float rd[kBwdLD], ru[kBwdLU];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kBwdLD; ++q) {
      const int i = tid + q * kThreads;
      const int k = k0 + i % kBwdKC, b = b0 + (i / kBwdKC) % kTB;
      const int g = i / (kBwdKC * kTB);
      rd[q] = (b < B && k < H)
                  ? a.dg_next[(int64_t)b * G + (int64_t)g * H + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBwdLU; ++q) {
      const int i = tid + q * kThreads;
      const int k = k0 + i % kBwdKC, j = j0 + (i / kBwdKC) % kTJ;
      const int g = i / (kBwdKC * kTJ);
      ru[q] = (j < H && k < H) ? a.u[(int64_t)j * G + (int64_t)g * H + k] : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int q = 0; q < kBwdLD; ++q) {
      const int i = tid + q * kThreads;
      dg_t[i / (kBwdKC * kTB)][i % kBwdKC][(i / kBwdKC) % kTB] = rd[q];
    }
#pragma unroll
    for (int q = 0; q < kBwdLU; ++q) {
      const int i = tid + q * kThreads;
      ur[i / (kBwdKC * kTJ)][i % kBwdKC][(i / kBwdKC) % kTJ] = ru[q];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (a.dg_next != nullptr) {
    load(0);
    for (int k0 = 0; k0 < H; k0 += kBwdKC) {
      store();
      __syncthreads();
      if (k0 + kBwdKC < H) load(k0 + kBwdKC);
#pragma unroll 8
      for (int kq = 0; kq < kBwdKC / 2; ++kq) {
        const int kk = kh * (kBwdKC / 2) + kq;
        const float4 dv = *reinterpret_cast<const float4*>(&dg_t[gz][kk][4 * rg]);
        const float4 wv = *reinterpret_cast<const float4*>(&ur[gz][kk][4 * ug]);
        const float dr[4] = {dv.x, dv.y, dv.z, dv.w};
        const float wu[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(dr[r], wu[c], acc[r][c]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[w][4 * rg + r][4 * ug + c] = acc[r][c];
  __syncthreads();

  const Acts ac = a.acts;
  for (int q = tid; q < kTB * kTJ; q += kThreads) {
    const int r = q / kTJ, jj = q % kTJ;
    const int b = b0 + r, j = j0 + jj;
    if (b >= B || j >= H) continue;
    const int64_t s = (int64_t)b * H + j;
    float dh = 0.f;
    if (a.dg_next != nullptr) {
#pragma unroll
      for (int p = 0; p < 2 * kGates; ++p) dh += part[p][r][jj];
      dh += a.dh[s] * (1.f - a.mask_next[b]);
    }
    const float* gr = a.gates + (int64_t)b * G;
    const float i = gr[j], f = gr[H + j], cd = gr[2 * H + j], o = gr[3 * H + j];
    const float cn = a.cnew[s], cp = a.c_prev[s];
    const float m = a.mask[b];
    const float dc_in = a.dc[s];
    const float dhn = (a.dhs[s] + dh) * m;
    const float ch = act(ac.cell, cn);
    float dcn = dc_in * m + dhn * o * act_grad(ac.cell, ch);
    const float dzo = dhn * ch * act_grad(ac.gate, o);
    if (ac.use_peep) dcn += dzo * a.peep[2 * H + j];
    const float dzi = dcn * cd * act_grad(ac.gate, i);
    const float dzf = dcn * cp * act_grad(ac.gate, f);
    const float dzc = dcn * i * act_grad(ac.cand, cd);
    float dcp = dcn * f + dc_in * (1.f - m);
    if (ac.use_peep) dcp += dzi * a.peep[j] + dzf * a.peep[H + j];
    float* dr = a.dxw + (int64_t)b * G;
    dr[j] = dzi;
    dr[H + j] = dzf;
    dr[2 * H + j] = dzc;
    dr[3 * H + j] = dzo;
    a.dh[s] = dh;
    a.dc[s] = dcp;
  }
}

}  // namespace

extern "C" {

// One launch per step t = 0 .. T-1 on `stream`.  hc and cc are [T+1, B, H]
// with slot 0 cleared by the caller; gates [T, B, 4H] and cnew [T, B, H]
// are both written or both null.  Returns 0 or the first CUDA error.
int lstm_fwd_launch(const float* xw, const float* u, const float* peep,
                    const float* mask, float* hs, float* hc, float* cc,
                    float* gates, float* cnew, int T, int B, int H,
                    int use_peep, int gate_act, int cell_act, int cand_act,
                    void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const dim3 grid((H + kTJ - 1) / kTJ, (B + kTB - 1) / kTB);
  const int64_t bh = (int64_t)B * H, bg = kGates * bh;
  for (int t = 0; t < T; ++t) {
    FwdStep a;
    a.xw = xw + t * bg;
    a.u = u;
    a.peep = peep;
    a.mask = mask + (int64_t)t * B;
    a.h_prev = hc + t * bh;
    a.c_prev = cc + t * bh;
    a.h_next = hc + (t + 1) * bh;
    a.c_next = cc + (t + 1) * bh;
    a.hs = hs + t * bh;
    a.gates = gates != nullptr ? gates + t * bg : nullptr;
    a.cnew = cnew != nullptr ? cnew + t * bh : nullptr;
    a.B = B;
    a.H = H;
    a.acts = Acts{use_peep, gate_act, cell_act, cand_act};
    lstm_fwd_step<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One launch per step t = T-1 .. 0 on `stream`.  dc holds d c_final on
// entry (and d c_{-1} on exit); dh needs no initial value.  dxw [T, B, 4H]
// receives the gate gradients.  Returns 0 or the first CUDA error.
int lstm_bwd_launch(const float* dhs, const float* u, const float* peep,
                    const float* mask, const float* gates, const float* cnew,
                    const float* cc, float* dh, float* dc, float* dxw, int T,
                    int B, int H, int use_peep, int gate_act, int cell_act,
                    int cand_act, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  const dim3 grid((H + kTJ - 1) / kTJ, (B + kTB - 1) / kTB);
  const int64_t bh = (int64_t)B * H, bg = kGates * bh;
  for (int t = T - 1; t >= 0; --t) {
    BwdStep a;
    const bool last = t == T - 1;
    a.dg_next = last ? nullptr : dxw + (t + 1) * bg;
    a.mask_next = last ? nullptr : mask + (int64_t)(t + 1) * B;
    a.u = u;
    a.peep = peep;
    a.mask = mask + (int64_t)t * B;
    a.dhs = dhs + t * bh;
    a.gates = gates + t * bg;
    a.cnew = cnew + t * bh;
    a.c_prev = cc + t * bh;
    a.dh = dh;
    a.dc = dc;
    a.dxw = dxw + t * bg;
    a.B = B;
    a.H = H;
    a.acts = Acts{use_peep, gate_act, cell_act, cand_act};
    lstm_bwd_step<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
