// LSTM recurrence, forward and reverse, for Hopper (sm_90a), written by hand.
//
// The forward kernels (lstm_fwd_persistent, lstm_fwd_step) replace the
// Pallas TPU kernel paddle_tpu/ops/lstm.py::_lstm_kernel (via _lstm_pallas);
// the reverse-recurrence kernels (lstm_bwd_persistent, lstm_bwd_step)
// replace the JAX package's backward (_fused_bwd: jax.vjp over _lstm_scan,
// not a Pallas kernel there).
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
// float32, lengths 50-100): operations.  The recurrent product is
// 2 * n_valid * H * 4H over the (step, row) pairs the mask keeps, 19.8 GFLOP
// a pass: 0.2959 ms for the forward at 67 TFLOP/s of float32 FMA on the CUDA
// cores, 0.5919 ms for the whole backward (the reverse product plus du),
// against about 0.1 ms for the bytes.  float32 runs in full float32 on the
// CUDA cores (FFMA; the JAX package's HIGHEST precision, no TF32).
//
// Two routes, chosen by shape before the launch (ops/lstm.py::lstm_route):
//
// "persistent" (lstm_fwd_persistent, lstm_bwd_persistent): one cooperative
// launch a call.  The TPU kernel walks T as a sequential grid axis with U, h
// and c in VMEM; here the time loop runs inside each block.  A block owns
// 32 batch rows x 16 hidden units for the whole sequence:
//   * its U slice stays resident in dynamic shared memory, loaded once: the
//     forward's 16 units x 4 gates x H (128 KB at H=512), the reverse's 16
//     rows of U over all 4H columns (128 KB), so no step re-reads U;
//   * each thread keeps the carried state of its two (row, unit) pairs in
//     registers: h and c forward, dh and dc in reverse;
//   * only h (forward) or dgates (reverse) crosses blocks, through L2: step t
//     of a block needs the previous step's values of its 32 rows from all
//     unit tiles of its row group and nothing from the other row groups, so
//     the blocks of a row group meet at a counter (a per-row-group barrier,
//     not a grid barrier): a block arrives after writing its slice (a
//     __syncthreads, then one thread's red.release.gpu add), and waits with
//     one thread's acquire loads for gridDim.x * (steps done), then a
//     __syncthreads.  Cross-block data is
//     read with cp.async.cg, which goes to L2 and not L1.  A wait that spins
//     for about two seconds traps (a launch failure the wrapper reports), so
//     a fault cannot hang the card.  The launch is cooperative: a grid that
//     cannot be resident all at once is refused with an error, never left
//     spinning, and the entry point also refuses one larger than the
//     occupancy API's resident blocks;
//   * forward step: each warp copies its eighth of the depth of h_{t-1}'s 32
//     rows into shared memory (two cp.async groups, the second in flight
//     while the first is multiplied) and multiplies it by the resident U: a
//     lane holds 8 rows x 2 units x 4 gates (64 sums; h read as float4 along
//     the depth, U as float4 of a unit's four gates).  The eight warps'
//     partial sums meet in shared memory, added in warp order, and each
//     thread finishes its two pairs;
//   * reverse step: each warp streams its eighth of the depth of the 32 rows
//     of dgates_{t+1} (256 KB a block a step at H=512, the reverse's main
//     cost) through a two-stage cp.async ring of its own, a lane holding 8
//     rows x 8 units over a quarter of each chunk; U is stored with an XOR
//     swizzle so that the lanes' float4 reads meet no bank twice.  The 32
//     partial sums meet in shared memory, added in order;
//   * no atomics on data: every output has one writer and every sum a fixed
//     order, so results repeat bit for bit.
// The persistent route takes H % 4 == 0, a tile whose shared memory fits
// the card's opt-in limit (H <= 576 on an H100) and a grid of
// ceil(H/16) x ceil(B/32) blocks no larger than the SM count (one block an
// SM): text_lstm's B=128, H=512 is 32 x 4 = 128 blocks on 132 SMs.
//
// "step" (lstm_fwd_step, lstm_bwd_step; the first port's kernels): one
// launch per step, the same (rows, units) tile, U and h (or dgates) re-read
// from L2 every step, dh and dc carried in [B, H] buffers.  It takes every
// other shape (B = 256 at H = 512, H > 576, H % 4 != 0):
//   * forward: 256 threads in two halves; h and U go through shared memory
//     in chunks of 64 of the depth, each half multiplies 32 of them (4 rows
//     x 4 gates of one unit a thread, read as float4), and the halves' sums
//     meet in shared memory at the end;
//   * backward: two warps per gate each take half of a 32-deep chunk of that
//     gate's quarter of the depth of dgates_{t+1} . U^T (4 rows x 4 units a
//     thread), the eight partial tiles are summed in shared memory, and each
//     thread then finishes 2 (row, unit) pairs elementwise;
//   * both load each chunk into registers while the previous chunk is
//     multiplied.
// What is left: a B larger than 32 x the SM count / ceil(H/16) (B=256 at
// H=512) could stay persistent with blocks that walk several row tiles a
// step; the reverse's dgates stream could be split over a cluster and
// exchanged through distributed shared memory; 3xTF32 on the tensor cores
// is a separate, measured question (PERF.md).

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


// ----------------------------------------------------------- persistent route

constexpr int kPRows = 32;       // batch rows of a block's tile: a row group
constexpr int kPUnits = 16;      // hidden units of a block's tile
constexpr int kPThreads = 256;   // 8 warps
constexpr int kPWarps = kPThreads / 32;
constexpr int kPRowsThread = 8;  // rows a lane holds: rg + 4 r, r < 8
// forward: the depth is cut into kPWarps ranges of fwd_warp_depth(H), a
// multiple of 8 (h and U zero past H); partial sums [warp][row][unit][gate]
constexpr int kFwdDepthAlign = 64;
constexpr int kFwdRedFloats = kPWarps * kPRows * kPUnits * kGates;
// reverse: the depth 4H is cut into kPWarps ranges of bwd_warp_depth(H), a
// multiple of kBwdChunk, each streamed through kBwdStages ring stages of its
// warp, rows kBwdPitch floats apart; partial sums [part][row][unit]
constexpr int kBwdChunk = 32;
constexpr int kBwdStages = 2;
constexpr int kBwdPitch = 40;
constexpr int kBwdLaneParts = 4;
constexpr int kBwdParts = kPWarps * kBwdLaneParts;
constexpr int kBwdRingFloats = kPWarps * kBwdStages * kPRows * kBwdPitch;
constexpr int kBwdRedFloats = kBwdParts * kPRows * kPUnits;
// a barrier wait longer than this many SM clocks (about two seconds) traps
constexpr long long kSpinLimit = 4000000000LL;
static_assert(kPThreads == 32 * kPWarps, "whole warps");
static_assert(kPRows == 4 * kPRowsThread && kPUnits == 2 * 8,
              "a warp is 4 row groups x 8 unit pairs (forward) or 4 row "
              "groups x 2 unit octets x 4 depth parts (reverse)");
static_assert(2 * kPThreads == kPRows * kPUnits,
              "two (row, unit) pairs a thread");
static_assert(kBwdRedFloats <= kBwdRingFloats,
              "the reverse's partial sums reuse the ring");
static_assert(kBwdChunk == 2 * 4 * kBwdLaneParts,
              "a chunk is two halves of four depths a lane part");
static_assert(kBwdStages == 2, "the ring loop issues one chunk ahead");

__host__ __device__ constexpr int fwd_warp_depth(int H) {
  return 8 * ((H + kFwdDepthAlign - 1) / kFwdDepthAlign);
}
__host__ __device__ constexpr int bwd_warp_depth(int H) {
  return kBwdChunk * ((H + 63) / 64);
}
// dynamic shared memory of a block, bytes: U [Hp][16][4], then h_{t-1}
// [32][Hp + 4], whose space the partial sums take after the product
__host__ __device__ constexpr size_t fwd_smem_bytes(int H) {
  return 4 * ((size_t)kPWarps * fwd_warp_depth(H) * kPUnits * kGates +
              (kPRows * (kPWarps * fwd_warp_depth(H) + 4) > kFwdRedFloats
                   ? (size_t)kPRows * (kPWarps * fwd_warp_depth(H) + 4)
                   : (size_t)kFwdRedFloats));
}
// U rows [Dp][16] (swizzled), then the warps' rings
__host__ __device__ constexpr size_t bwd_smem_bytes(int H) {
  return 4 * ((size_t)kPWarps * bwd_warp_depth(H) * kPUnits + kBwdRingFloats);
}

// the reverse's U: depth c, unit u of the tile, two depths to a 32-float
// line, the half and the 8-float quarter XORed by bits 2 and 3 of c, so the
// float4 reads of a warp (4 depth parts 4 apart x 2 unit quads) meet no bank
// twice
__device__ __forceinline__ int bwd_u_index(int c, int unit) {
  return (c >> 1) * 32 +
         ((((c & 1) << 4) | unit) ^ (((c >> 2) & 1) << 4) ^ (((c >> 3) & 1) << 3));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// the block waits until its row group's counter reaches `target`: one
// thread's acquire loads, then the block's barrier, order the block's later
// reads after the writes the arrivals released
__device__ __forceinline__ void group_wait(const unsigned* ctr,
                                           unsigned target) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (ld_acquire(ctr) < target) {
      if (clock64() - t0 > kSpinLimit) __trap();
    }
  }
  __syncthreads();
}

// the block arrives: called after a __syncthreads that follows its writes,
// one thread's release add publishes them (no sequentially consistent
// fence: about 5% of the forward's time, measured)
__device__ __forceinline__ void group_arrive(unsigned* ctr) {
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ctr)
                 : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct FwdSeq {
  const float* xw;    // [T, B, 4H]
  const float* u;     // [H, 4H]
  const float* peep;  // [3, H]
  const float* mask;  // [T, B]
  float* hs;          // [T, B, H]
  float* hc;          // [T + 1, B, H], slot 0 zero
  float* cc;          // [T + 1, B, H], slot 0 zero
  float* gates;       // [T, B, 4H] or null
  float* cnew;        // [T, B, H] or null
  unsigned* sync;     // [ceil(B / 32)] arrival counters, zero at launch
  int T, B, H;
  Acts acts;
};

__global__ void __launch_bounds__(kPThreads, 1)
    lstm_fwd_persistent(FwdSeq a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, H = a.H, kw = fwd_warp_depth(H);
  const int Hp = kPWarps * kw, hp = Hp + 4;
  const int64_t G = (int64_t)kGates * H, BH = (int64_t)B * H;
  float* us = smem;                                  // [Hp][16][4]
  float* hb = smem + (size_t)Hp * kPUnits * kGates;  // [32][hp], partials
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int rg = lane >> 3, cg = lane & 7;  // rows rg + 4r, units cg, cg + 8
  const int j0 = blockIdx.x * kPUnits, b0 = blockIdx.y * kPRows;
  unsigned* ctr = a.sync + blockIdx.y;
  const Acts ac = a.acts;

  for (int i = tid; i < Hp * kPUnits * kGates; i += kPThreads) {
    const int k = i / (kPUnits * kGates), g = (i / kPUnits) % kGates;
    const int unit = i % kPUnits, j = j0 + unit;
    us[(k * kPUnits + unit) * kGates + g] =
        (k < H && j < H) ? a.u[(int64_t)k * G + (int64_t)g * H + j] : 0.f;
  }
  // the thread's (row, unit) pairs tid and tid + 256, and their carried h, c
  int pb[2], pj[2];
  bool pv[2];
  float p0[2], p1[2], p2[2], hcar[2], ccar[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = tid + q * kPThreads;
    pb[q] = b0 + p / kPUnits;
    pj[q] = j0 + p % kPUnits;
    pv[q] = pb[q] < B && pj[q] < H;
    const bool peep = pv[q] && ac.use_peep;
    p0[q] = peep ? a.peep[pj[q]] : 0.f;
    p1[q] = peep ? a.peep[H + pj[q]] : 0.f;
    p2[q] = peep ? a.peep[2 * H + pj[q]] : 0.f;
    hcar[q] = ccar[q] = 0.f;
  }
  __syncthreads();

  const int kbase = w * kw, kh = kw / 2, per_row = kh / 4;
  for (int t = 0; t < a.T; ++t) {
    // this step's inputs of the thread's pairs, in flight during the wait
    float xg[2][kGates], m[2], sum[2][kGates];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int g = 0; g < kGates; ++g) {
        sum[q][g] = 0.f;
        xg[q][g] = pv[q] ? a.xw[((int64_t)t * B + pb[q]) * G +
                                (int64_t)g * H + pj[q]] : 0.f;
      }
      m[q] = pv[q] ? a.mask[(int64_t)t * B + pb[q]] : 0.f;
    }
    if (t > 0) {
      group_wait(ctr, gridDim.x * t);
      // the warp's depth range of h_{t-1} (slot t), 32 rows, in two halves
      const float* src = a.hc + t * BH;
      for (int hh = 0; hh < 2; ++hh) {
        for (int n = lane; n < kPRows * per_row; n += 32) {
          const int row = n / per_row;
          const int k = kbase + hh * kh + (n % per_row) * 4, b = b0 + row;
          const bool ok = b < B && k < H;
          cp_async16(hb + row * hp + k, ok ? src + (int64_t)b * H + k : src,
                     ok);
        }
        cp_async_commit();
      }
      float acc[kPRowsThread][2 * kGates];
#pragma unroll
      for (int r = 0; r < kPRowsThread; ++r)
#pragma unroll
        for (int c = 0; c < 2 * kGates; ++c) acc[r][c] = 0.f;
      for (int hh = 0; hh < 2; ++hh) {
        if (hh == 0)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncwarp();
        const int kend = kbase + (hh + 1) * kh;
#pragma unroll 2
        for (int k = kbase + hh * kh; k < kend; k += 4) {
          float4 hv[kPRowsThread];
#pragma unroll
          for (int r = 0; r < kPRowsThread; ++r)
            hv[r] = *reinterpret_cast<const float4*>(hb + (rg + 4 * r) * hp + k);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 ua = *reinterpret_cast<const float4*>(
                us + ((k + c) * kPUnits + cg) * kGates);
            const float4 ub = *reinterpret_cast<const float4*>(
                us + ((k + c) * kPUnits + cg + 8) * kGates);
#pragma unroll
            for (int r = 0; r < kPRowsThread; ++r) {
              const float x = comp(hv[r], c);
              acc[r][0] = fmaf(x, ua.x, acc[r][0]);
              acc[r][1] = fmaf(x, ua.y, acc[r][1]);
              acc[r][2] = fmaf(x, ua.z, acc[r][2]);
              acc[r][3] = fmaf(x, ua.w, acc[r][3]);
              acc[r][4] = fmaf(x, ub.x, acc[r][4]);
              acc[r][5] = fmaf(x, ub.y, acc[r][5]);
              acc[r][6] = fmaf(x, ub.z, acc[r][6]);
              acc[r][7] = fmaf(x, ub.w, acc[r][7]);
            }
          }
        }
      }
      __syncthreads();  // every warp has read its h: the space takes the sums
#pragma unroll
      for (int r = 0; r < kPRowsThread; ++r) {
        float* dst = hb + ((w * kPRows + rg + 4 * r) * kPUnits + cg) * kGates;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(dst + 8 * kGates) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!pv[q]) continue;
        const int cell = (pb[q] - b0) * kPUnits + (pj[q] - j0);
        for (int ww = 0; ww < kPWarps; ++ww) {
          const float4 v = *reinterpret_cast<const float4*>(
              hb + (ww * kPRows * kPUnits + cell) * kGates);
          sum[q][0] += v.x;
          sum[q][1] += v.y;
          sum[q][2] += v.z;
          sum[q][3] += v.w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!pv[q]) continue;
      const int b = pb[q], j = pj[q];
      const float gi = xg[q][0] + sum[q][0], gf = xg[q][1] + sum[q][1];
      const float gc = xg[q][2] + sum[q][2], go = xg[q][3] + sum[q][3];
      const float cp = ccar[q], hp0 = hcar[q];
      float i, f;
      if (ac.use_peep) {
        i = act(ac.gate, gi + cp * p0[q]);
        f = act(ac.gate, gf + cp * p1[q]);
      } else {
        i = act(ac.gate, gi);
        f = act(ac.gate, gf);
      }
      const float cd = act(ac.cand, gc);
      const float cn = f * cp + i * cd;
      const float o =
          ac.use_peep ? act(ac.gate, go + cn * p2[q]) : act(ac.gate, go);
      const float hn = o * act(ac.cell, cn);
      const float mm = m[q];
      hcar[q] = hn * mm + hp0 * (1.f - mm);
      ccar[q] = cn * mm + cp * (1.f - mm);
      const int64_t s = (int64_t)b * H + j;
      a.hc[(t + 1) * BH + s] = hcar[q];
      a.cc[(t + 1) * BH + s] = ccar[q];
      a.hs[t * BH + s] = hn * mm;
      if (a.gates != nullptr) {
        float* gr = a.gates + ((int64_t)t * B + b) * G;
        gr[j] = i;
        gr[H + j] = f;
        gr[2 * H + j] = cd;
        gr[3 * H + j] = o;
        a.cnew[t * BH + s] = cn;
      }
    }
    if (t + 1 < a.T) {
      __syncthreads();
      group_arrive(ctr);
    }
  }
}

struct BwdSeq {
  const float* dhs;    // [T, B, H]
  const float* u;      // [H, 4H]
  const float* peep;   // [3, H]
  const float* mask;   // [T, B]
  const float* gates;  // [T, B, 4H]
  const float* cnew;   // [T, B, H]
  const float* cc;     // [T + 1, B, H]
  float* dh;           // [B, H] out: d h_0 (the recurrent part)
  float* dc;           // [B, H] in: d c_final; out: d c_{-1}
  float* dxw;          // [T, B, 4H]
  unsigned* sync;      // [ceil(B / 32)] arrival counters, zero at launch
  int T, B, H;
  Acts acts;
};

__global__ void __launch_bounds__(kPThreads, 1)
    lstm_bwd_persistent(BwdSeq a) {
  extern __shared__ __align__(16) float smem[];
  const int B = a.B, H = a.H, cw = bwd_warp_depth(H), Dp = kPWarps * cw;
  const int64_t G = (int64_t)kGates * H, BH = (int64_t)B * H;
  float* us = smem;                            // [Dp][16], swizzled
  float* ring = smem + (size_t)Dp * kPUnits;   // the rings, then partials
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  // depth part kp, rows rg + 4r, units ug*4 .. +3 and 8 + ug*4 .. +3
  const int kp = lane >> 3, rg = (lane >> 1) & 3, ug = lane & 1;
  const int j0 = blockIdx.x * kPUnits, b0 = blockIdx.y * kPRows;
  unsigned* ctr = a.sync + blockIdx.y;
  const Acts ac = a.acts;

  for (int i = tid; i < Dp * kPUnits; i += kPThreads) {
    const int unit = i / Dp, c = i % Dp, j = j0 + unit;
    us[bwd_u_index(c, unit)] =
        (c < G && j < H) ? a.u[(int64_t)j * G + c] : 0.f;
  }
  int pb[2], pj[2];
  bool pv[2];
  float p0[2], p1[2], p2[2], dhcar[2], dccar[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = tid + q * kPThreads;
    pb[q] = b0 + p / kPUnits;
    pj[q] = j0 + p % kPUnits;
    pv[q] = pb[q] < B && pj[q] < H;
    const bool peep = pv[q] && ac.use_peep;
    p0[q] = peep ? a.peep[pj[q]] : 0.f;
    p1[q] = peep ? a.peep[H + pj[q]] : 0.f;
    p2[q] = peep ? a.peep[2 * H + pj[q]] : 0.f;
    dhcar[q] = 0.f;
    dccar[q] = pv[q] ? a.dc[(int64_t)pb[q] * H + pj[q]] : 0.f;
  }
  __syncthreads();

  float* wring = ring + w * kBwdStages * kPRows * kBwdPitch;
  const int cbase = w * cw, nchunks = cw / kBwdChunk;
  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    // this step's residuals of the thread's pairs, in flight during the wait
    float dhs[2], ga[2][kGates], cn[2], cp[2], m[2], mn[2], dsum[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int64_t i = t * BH + (int64_t)pb[q] * H + pj[q];
      const float* gr = a.gates + ((int64_t)t * B + pb[q]) * G + pj[q];
      dhs[q] = pv[q] ? a.dhs[i] : 0.f;
#pragma unroll
      for (int g = 0; g < kGates; ++g)
        ga[q][g] = pv[q] ? gr[(int64_t)g * H] : 0.f;
      cn[q] = pv[q] ? a.cnew[i] : 0.f;
      cp[q] = pv[q] ? a.cc[i] : 0.f;  // slot t: c_{t-1}
      m[q] = pv[q] ? a.mask[(int64_t)t * B + pb[q]] : 0.f;
      mn[q] = (pv[q] && s > 0) ? a.mask[(int64_t)(t + 1) * B + pb[q]] : 0.f;
      dsum[q] = 0.f;
    }
    if (s > 0) {
      group_wait(ctr, gridDim.x * s);
      // dgates_{t+1} of the 32 rows, the warp's depth range, chunk by chunk
      const float* src = a.dxw + (int64_t)(t + 1) * B * G;
      auto issue = [&](int n) {
        float* st = wring + (n % kBwdStages) * kPRows * kBwdPitch;
        for (int e = lane; e < kPRows * (kBwdChunk / 4); e += 32) {
          const int row = e / (kBwdChunk / 4), gi = e % (kBwdChunk / 4);
          const int c = cbase + n * kBwdChunk + gi * 4, b = b0 + row;
          const bool ok = b < B && c < G;
          cp_async16(st + row * kBwdPitch + gi * 4,
                     ok ? src + (int64_t)b * G + c : src, ok);
        }
        cp_async_commit();
      };
      float acc[kPRowsThread][8];
#pragma unroll
      for (int r = 0; r < kPRowsThread; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      issue(0);
      for (int n = 0; n < nchunks; ++n) {
        if (n + 1 < nchunks) {
          issue(n + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const float* st = wring + (n % kBwdStages) * kPRows * kBwdPitch;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int cl = hh * 16 + kp * 4;
          float4 dv[kPRowsThread];
#pragma unroll
          for (int r = 0; r < kPRowsThread; ++r)
            dv[r] = *reinterpret_cast<const float4*>(
                st + (rg + 4 * r) * kBwdPitch + cl);
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const int c = cbase + n * kBwdChunk + cl + c4;
            const float4 ua =
                *reinterpret_cast<const float4*>(us + bwd_u_index(c, ug * 4));
            const float4 ub = *reinterpret_cast<const float4*>(
                us + bwd_u_index(c, 8 + ug * 4));
#pragma unroll
            for (int r = 0; r < kPRowsThread; ++r) {
              const float d = comp(dv[r], c4);
              acc[r][0] = fmaf(d, ua.x, acc[r][0]);
              acc[r][1] = fmaf(d, ua.y, acc[r][1]);
              acc[r][2] = fmaf(d, ua.z, acc[r][2]);
              acc[r][3] = fmaf(d, ua.w, acc[r][3]);
              acc[r][4] = fmaf(d, ub.x, acc[r][4]);
              acc[r][5] = fmaf(d, ub.y, acc[r][5]);
              acc[r][6] = fmaf(d, ub.z, acc[r][6]);
              acc[r][7] = fmaf(d, ub.w, acc[r][7]);
            }
          }
        }
        __syncwarp();  // the stage is free for chunk n + 2
      }
      __syncthreads();  // every ring is drained: the space takes the sums
      const int part = w * kBwdLaneParts + kp;
#pragma unroll
      for (int r = 0; r < kPRowsThread; ++r) {
        float* dst = ring + (part * kPRows + rg + 4 * r) * kPUnits + ug * 4;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        *reinterpret_cast<float4*>(dst + 8) =
            make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!pv[q]) continue;
        const int cell = (pb[q] - b0) * kPUnits + (pj[q] - j0);
        for (int pt = 0; pt < kBwdParts; ++pt)
          dsum[q] += ring[pt * kPRows * kPUnits + cell];
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!pv[q]) continue;
      const float dh = s > 0 ? dsum[q] + dhcar[q] * (1.f - mn[q]) : 0.f;
      const float i = ga[q][0], f = ga[q][1], cd = ga[q][2], o = ga[q][3];
      const float mm = m[q], dc_in = dccar[q];
      const float dhn = (dhs[q] + dh) * mm;
      const float ch = act(ac.cell, cn[q]);
      float dcn = dc_in * mm + dhn * o * act_grad(ac.cell, ch);
      const float dzo = dhn * ch * act_grad(ac.gate, o);
      if (ac.use_peep) dcn += dzo * p2[q];
      const float dzi = dcn * cd * act_grad(ac.gate, i);
      const float dzf = dcn * cp[q] * act_grad(ac.gate, f);
      const float dzc = dcn * i * act_grad(ac.cand, cd);
      float dcp = dcn * f + dc_in * (1.f - mm);
      if (ac.use_peep) dcp += dzi * p0[q] + dzf * p1[q];
      float* dr = a.dxw + ((int64_t)t * B + pb[q]) * G + pj[q];
      dr[0] = dzi;
      dr[H] = dzf;
      dr[2 * H] = dzc;
      dr[3 * H] = dzo;
      dhcar[q] = dh;
      dccar[q] = dcp;
    }
    if (s + 1 < a.T) {
      __syncthreads();
      group_arrive(ctr);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (!pv[q]) continue;
    const int64_t i = (int64_t)pb[q] * H + pj[q];
    a.dh[i] = dhcar[q];
    a.dc[i] = dccar[q];
  }
}

// One cooperative launch of a persistent kernel: sets its shared memory,
// refuses a grid larger than the resident blocks the occupancy API gives,
// launches.  Returns 0 or the CUDA error.
int cooperative_launch(const void* fn, dim3 grid, size_t smem, void* arg,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kPThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * n_sm < (long long)grid.x * grid.y)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {arg};
  err = cudaLaunchCooperativeKernel(fn, grid, dim3(kPThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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

// One cooperative launch for the whole sequence (the persistent route), with
// the same operands as lstm_fwd_launch and `sync`, ceil(B / 32) counters the
// caller zeroes.  H must be a multiple of 4.  Returns 0 or the CUDA error
// (cudaErrorCooperativeLaunchTooLarge for a grid that cannot be resident).
int lstm_fwd_persistent_launch(const float* xw, const float* u,
                               const float* peep, const float* mask,
                               float* hs, float* hc, float* cc, float* gates,
                               float* cnew, unsigned* sync, int T, int B,
                               int H, int use_peep, int gate_act,
                               int cell_act, int cand_act, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (H % 4 != 0) return (int)cudaErrorInvalidValue;
  FwdSeq a{xw, u, peep, mask, hs, hc, cc, gates, cnew, sync, T, B, H,
           Acts{use_peep, gate_act, cell_act, cand_act}};
  const dim3 grid((H + kPUnits - 1) / kPUnits, (B + kPRows - 1) / kPRows);
  return cooperative_launch((const void*)lstm_fwd_persistent, grid,
                            fwd_smem_bytes(H), &a, stream);
}

// The same for the reverse recurrence, with lstm_bwd_launch's operands and
// `sync`: dc holds d c_final on entry and d c_{-1} on exit, dh receives the
// recurrent d h_0.
int lstm_bwd_persistent_launch(const float* dhs, const float* u,
                               const float* peep, const float* mask,
                               const float* gates, const float* cnew,
                               const float* cc, float* dh, float* dc,
                               float* dxw, unsigned* sync, int T, int B,
                               int H, int use_peep, int gate_act,
                               int cell_act, int cand_act, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  if (H % 4 != 0) return (int)cudaErrorInvalidValue;
  BwdSeq a{dhs, u, peep, mask, gates, cnew, cc, dh, dc, dxw, sync, T, B, H,
           Acts{use_peep, gate_act, cell_act, cand_act}};
  const dim3 grid((H + kPUnits - 1) / kPUnits, (B + kPRows - 1) / kPRows);
  return cooperative_launch((const void*)lstm_bwd_persistent, grid,
                            bwd_smem_bytes(H), &a, stream);
}

// The current device's SM count and opt-in shared memory a block, for the
// route (ops/lstm.py::lstm_route).  Returns 0 or the CUDA error.
int lstm_device_limits(int* n_sm, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // extern "C"
