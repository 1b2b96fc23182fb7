#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving and training paths on one CUDA card and
check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero, before the final line):
  1. device  - require CUDA; print the card's name and power limit and the
               torch / CUDA versions;
  2. build   - build the hand-written kernels from ops/csrc with nvcc, one
               nvcc per source, all started together, and print ptxas's
               registers and spills for each kernel;
  3. kernels - hold each kernel against its plain PyTorch version on the
               card (paged attention at the serving shapes; the three flash
               kernels at the training shape in float32 and bfloat16, a
               rectangular non-causal and a ragged causal case; the LSTM
               forward and reverse kernels at text_lstm's full width, with
               peepholes, and through dynamic_lstm(is_reverse=True) on
               lengths {1, T, 0}), and time kernel, plain version and the
               library yardstick (scaled_dot_product_attention, cuDNN's
               LSTM; the port never calls either), each as the event-timed
               call (host cost included) and as device time (the kernels
               the calls enqueue, read by torch.profiler; the phase fails
               if the profiler shows none);
  4. serve   - the Transformer-base LM (V=32000, d=512, 8 heads, 6 layers,
               d_ff=2048, tied embeddings, float32, random weights from
               seed 0) served by ContinuousScheduler over a paged pool
               (max_len 1024, block 16, 8 slots): 16 mixed greedy/sampled
               requests, then a speculative (W=4) pass on repetitive
               prompts.  Checks completion, zero leaked blocks, kernel
               launches == n_layers x step dispatches, teacher-forced
               agreement >= 0.98 against the dense lm_forward oracle, and
               sampled-stream determinism;
  5. train   - the same LM built by build_lm through Program / Executor with
               Adam(1e-3) and global-norm clipping (1.0), weights from
               init_lm_params(0): one step on 2 x 1024 tokens on the card
               and on the CPU (plain versions) from the same weights, loss
               and every gradient compared; then 5 steps on a fixed 8 x 1024
               batch with the flash launch counts set to 0 before and read
               after (each must be n_layers x steps), losses finite and
               falling, ms per step and tokens/s;
  6. lstm train - the text classifier (vocab 10000, emb 128, 2 x LSTM-512,
               2 classes, seq_len 100, float32, weights from seed 0) through
               Program / Executor with Adam(1e-3): one step on 16 sequences
               on the card and on the CPU from the same weights, loss and
               every gradient compared; then 5 steps on a fixed batch of 128
               with the LSTM launch counts set to 0 before and read after
               (2 layers x 5 steps each), losses finite and falling, ms per
               step and sequences/s;
  7. bn kernels - the batch-norm backward kernels (reduction, dx) against
               their plain versions in float32 and bfloat16 at ResNet-50's
               shapes ([256,64,56,56], [256,128,28,28], [256,256,56,56]
               (benchmark/bn_probe.py's), [256,2048,7,7]) and a ragged one,
               each with a constant channel; timed at [256,256,56,56] beside
               the plain versions and native_batch_norm_backward;
  8. resnet train - ResNet-50 (1000 classes, 224x224, weights from seed 0)
               as bench.py trains it, Program / Executor with Momentum(0.1,
               0.9): one float32 step (TF32 off) on 4 images on the card and
               on the CPU from the same weights, loss and every running
               statistic compared, and every gradient against the CPU's own
               spread under a 1e-7 change of the images (two more CPU
               steps; the gradients are chaotic at float32's resolution at
               this initialisation); then 5 steps in each arm,
               amp at bs=256 and float32 at bs=256, on a batch that stays on
               the card, with the batch-norm launch counts set to 0 before
               and read after (53 layers x 5 steps each), losses finite and
               printed, images/s from the median of steps 2-5, peak memory;
  9. conv kernels - the 3x3 implicit-GEMM kernels (plain and fused with the
               folded batch norm and ReLU) against their plain versions in
               float32 and bfloat16 at ResNet-50's stride-1 shapes
               ([256,56,56,64]x64 and [256,28,28,128]x128, which are
               benchmark/conv_probe.py's, [256,14,14,256]x256,
               [256,7,7,512]x512) and two ragged ones ([3,13,9,3]x40 on the
               element-wise path, [3,13,9,16]x24 on the 16-byte one); timed at
               the probe's two shapes beside the plain versions and cuDNN
               (F.conv2d, then the batch norm's scale and shift and the ReLU
               as separate passes, on the same NHWC tensor as a channels_last
               view and on an NCHW copy);
 10. resnet infer - the is_test program benchmark/resnet.py's infer configs
               prune to (build, 1000 classes, 224x224, weights and running
               statistics from seed 0), through Program.prune and
               Executor.run with its 3x3 stride-1 convolutions routed onto
               the kernels: ResNet-50 on 4 images on the card and on the CPU
               from the same arrays, in float32 (TF32 off) and under amp,
               logits compared; then 5 steps in each arm, ResNet-50 amp and
               float32 and ResNet-18 amp at bs=256 on images that stay on
               the card, with the conv launch counts set to 0 before and
               read after (fused 13 x 5 on ResNet-50; fused 5 x 5 and plain
               8 x 5 on ResNet-18), images/s from the median of steps 2-5,
               peak memory.
Each phase prints its seconds.  The line before the card line is the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12,     # CUDA-core float32
                  torch.bfloat16: 989e12,   # dense tensor-core bf16
                  torch.int8: 1979e12}      # dense tensor-core int8

LM_CFG = dict(vocab_size=32000, max_len=1024, d_model=512, n_heads=8,
              n_layers=6, d_ff=2048)
ENGINE_CFG = dict(n_slots=8, block_size=16, spec_window=4, dtype="float32")
# kernel-check shapes: the serving step's (S = n_slots, H, Dh, Bs, n_tbl =
# max_len / Bs, L = n_layers)
KS, KH, KDH, KBS, KNTBL, KL, KLAYER = 8, 8, 64, 16, 64, 6, 3
TOLERANCE = {  # (atol, rtol); float32 sums run in another order
    "float32": (2e-5, 1e-5),
    "bfloat16": (2e-2, 2e-2),
    "int8": (2e-5, 1e-5),
}
KERNEL_SOURCES = ("paged_attention.cu", "flash_attention.cu", "lstm.cu",
                  "batch_norm.cu", "conv.cu")
# flash kernels against their plain versions.  float32: the JAX package's
# own tolerances for its Pallas kernels (tests/test_pallas_ops.py:34,215):
# o and lse atol 2e-5, gradients 2e-4 of max |grad|, over the tensor.
# bfloat16 is held element by element, with BF16_U = 2^-8, bfloat16's unit
# roundoff (one ulp of x is at most 2 * BF16_U * |x|):
#   o: |d| <= 2u (A + |o|) + 2e-5, A = sum_k p_k |v_k| (the plain forward
#      on |v|).  Kernel and plain version each round every probability
#      once before p.v (the kernel the running, unnormalised one, the plain
#      version the normalised one), at most u * A apart from the exact sum
#      each, and each rounds o once (u |o|): a bound, not a fit;
#   dq, dk, dv: |d| <= 2u |grad| + 1e-3 max |grad|.  Both sides round p and
#      dS at values that differ only in float32's last bits, so a rounding
#      falls the other way only now and then: the first term lets every
#      output differ by one ulp, the second the sums' share, set at three
#      times the largest reading (dq 3.1e-4 of max |grad| on an NVIDIA H100
#      80GB HBM3, 700 W, with dk and dv equal bit for bit).
FLASH_FWD_ATOL = 2e-5
FLASH_BWD_REL = 2e-4
BF16_U = 2.0 ** -8
FLASH_BWD_BF16_SUM_REL = 1e-3
# (label, N = B*H, Tq, Tk, D, causal); the first is the training shape
FLASH_CASES = [("train", 64, 1024, 1024, 64, True),
               ("rectangular", 8, 50, 70, 16, False),
               ("ragged", 8, 37, 37, 16, True)]
FLASH_KERNELS = ("fwd", "bwd_dkdv", "bwd_dq")
# LSTM kernels against their plain versions: the repo's float32 kernel
# tolerances, hs and c_final atol 2e-5, dxw / du / dpeep within 2e-4 of each
# gradient's max |g|
LSTM_FWD_ATOL = 2e-5
LSTM_BWD_REL = 2e-4
LSTM_KERNELS = ("fwd", "bwd")
LSTM_ACTS = ("sigmoid", "tanh", "tanh")
# batch-norm backward kernels against their plain versions: dbeta and
# dgamma (float32 sums in another order) within BN_SUM_REL of sum |dy| and
# sum |dy x-hat| per channel, in both dtypes (the kernel and the plain
# version read the same values and add in float32); float32 dx within
# BN_DX_REL of max |dx|; bfloat16 dx element by element within 2u |dx| +
# BN_BF16_SUM_REL max |dx| (each side rounds once to bfloat16)
BN_SUM_REL = 1e-5
BN_DX_REL = 2e-5
BN_BF16_SUM_REL = 1e-3
BN_KERNELS = ("reduce", "dx")
# (label, N, C, H, W); "probe" is benchmark/bn_probe.py's shape, timed
BN_CASES = [("stage1", 256, 64, 56, 56), ("stage2", 256, 128, 28, 28),
            ("probe", 256, 256, 56, 56), ("stage4", 256, 2048, 7, 7),
            ("ragged", 3, 5, 7, 9)]
BN_EPS = 1e-5
RESNET_PARITY_BATCH = 4
RESNET_BN_LAYERS = 53
# the ResNet-50 parity step's gradients against the CPU's own float32
# floor (see _resnet_parity)
RESNET_FLOOR_FACTOR = 3
# conv kernels against their plain versions: float32 within CONV_F32_REL
# of max |out| (float32 sums in another order); bfloat16 element by element
# within 2u |out| + CONV_BF16_SUM_REL max |out| (each side rounds once to
# bfloat16 from float32 sums that differ in their last bits)
CONV_F32_REL = 2e-5
CONV_BF16_SUM_REL = 1e-3
CONV_KERNELS = ("igemm", "fused")
# (label, N, H, W, C, O); "c56" and "c28" are benchmark/conv_probe.py's
# shapes, timed; the ragged ones leave a part-filled last pixel tile and
# output-channel tile, "ragged" on the element-wise path (C = 3),
# "ragged16" on the 16-byte one
CONV_CASES = [("c56", 256, 56, 56, 64, 64), ("c28", 256, 28, 28, 128, 128),
              ("c14", 256, 14, 14, 256, 256), ("c7", 256, 7, 7, 512, 512),
              ("ragged", 3, 13, 9, 3, 40), ("ragged16", 3, 13, 9, 16, 24)]
# ResNet inference: card against CPU on INFER_PARITY_BATCH images, float32
# logits within INFER_F32_REL of max |.| (float32 sums in another order
# through 50 layers), bfloat16 logits element by element within 2u |.| +
# CONV_BF16_SUM_REL max |.|; the timed arms' launches a step by depth
INFER_PARITY_BATCH = 4
INFER_F32_REL = 1e-4
INFER_LAUNCHES = {50: {"igemm": 0, "fused": 13}, 18: {"igemm": 8, "fused": 5}}
INFER_ARMS = (("resnet50-infer", 50, True), ("resnet50-infer", 50, False),
              ("resnet18-infer", 18, True))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn(i)`` over ``iters`` calls, timed
    with CUDA events after ``warmup`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn(i)``, as torch.profiler reads
    the device kernels and copies that ``iters`` calls enqueue, after
    ``warmup`` calls.  These are the calls ``cuda_ms`` times, made again
    under the profiler (whose host cost would inflate the event-timed ms).
    In a long process the profiler now and then handed a window's last
    records to the next window (one window read nothing, another 12% too
    much).  So a train of marker kernels (``torch.cuda._sleep``, not
    counted) follows the timed calls to push their records out before the
    window closes, the window is padded by 20 ms on each side, and each
    kernel counts at its mean duration times the whole number of times a
    call runs it (its count over ``iters``, rounded): a record lost or
    carried over moves the sum by at most its own share, and a stray
    record of another window's kernel counts for nothing.  Fails when the
    profiler shows no device time: there is no fallback to the events."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.tools.decode_profile import _kernel_us

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for i in range(iters):
            fn(i)
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.02)
    # microseconds a call: each kernel's mean times its launches a call
    us = sum(_kernel_us(evt) / evt.count * round(evt.count / iters)
             for evt in prof.key_averages()
             if _kernel_us(evt) > 0 and "spin_kernel" not in evt.key)
    check(us > 0, "torch.profiler shows no device time for a timed call")
    return us / 1e3


def both_ms(fn, iters: int = 30, warmup: int = 3) -> tuple:
    """(event-timed ms, device ms) per call of ``fn(i)``."""
    return (cuda_ms(fn, iters, warmup), device_ms(fn, iters, warmup))


# ----------------------------------------------------------------- phases


def phase_device() -> str:
    from paddle_tpu_torch import card_info

    card = card_info(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices "
          f"{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for fut in [pool.submit(_build.build_library, src)
                    for src in KERNEL_SOURCES]:
            fut.result()
    for src in KERNEL_SOURCES:
        _build.load_kernel_library(src)
        secs = _build.build_seconds.get(src)
        print(f"build: {src} "
              + (f"compiled in {secs:.2f} s" if secs is not None
                 else "loaded from an earlier build"))
        for name, regs, spill in _ptxas_report(_build.build_logs.get(src,
                                                                     "")):
            print(f"build:   {name}: {regs} registers, {spill} bytes "
                  f"spilled")
    print(f"build: all sources ready in {time.perf_counter() - t0:.2f} s")


def _ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes) per entry function of an
    ``nvcc -Xptxas -v`` log; the mangled name is cut to the kernel's name
    and the first characters of its template arguments."""
    import re

    rows, name, spill = [], None, 0
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name, spill = hit.group(1), 0
            continue
        hit = re.search(r"(\d+) bytes spill stores", line)
        if hit and name:
            spill = int(hit.group(1))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            short, pos = name[:40], 3          # past "_ZN"
            while (num := re.match(r"\d+", name[pos:])) is not None:
                start = pos + num.end()
                ident = name[start:start + int(num.group())]
                if ident.endswith("kernel"):
                    short = ident + name[start + len(ident):][:12]
                    break
                pos = start + len(ident)
            rows.append((short, int(hit.group(1)), spill))
            name = None
    return rows


def _kernel_inputs(kind: str, W: int, dev, rng):
    """Arenas [n_blocks+1, L, H, Bs, Dh] of the given kind, a poisoned trash
    block, per-slot block tables with trash past each slot's live columns,
    ragged lengths [S, W], and q [S, W, H, Dh]."""
    from paddle_tpu_torch.ops import quantize_kv

    S, H, Dh, Bs, n_tbl, L = KS, KH, KDH, KBS, KNTBL, KL
    T = n_tbl * Bs
    nb = S * n_tbl
    shape = (nb + 1, L, H, Bs, Dh)
    kf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kf[nb] = 30.0   # poisoned trash: a mask slip would show
    vf[nb] = 30.0
    if kind == "int8":
        # absmax over Dh gives the [n_blocks+1, L, H, Bs] scale planes
        k_pool = tuple(t.to(dev) for t in quantize_kv(kf))
        v_pool = tuple(t.to(dev) for t in quantize_kv(vf))
        qdt = torch.float32
    else:
        dt = torch.float32 if kind == "float32" else torch.bfloat16
        k_pool, v_pool = kf.to(dev, dt), vf.to(dev, dt)
        qdt = dt
    base = rng.randint(1, T - W + 2, size=S)      # ragged, >= 1
    base[0] = T - W + 1                           # one slot at full length
    lengths = torch.from_numpy(
        (base[:, None] + np.arange(W)[None, :]).astype(np.int32))
    perm = rng.permutation(nb)
    tables = np.full((S, n_tbl), nb, np.int32)
    for s in range(S):
        live = -(-int(lengths[s].max()) // Bs)
        tables[s, :live] = perm[s * n_tbl: s * n_tbl + live]
    q = torch.from_numpy(rng.standard_normal((S, W, H, Dh)).astype(np.float32))
    return (q.to(dev, qdt), k_pool, v_pool, torch.from_numpy(tables).to(dev),
            lengths.to(dev))


def _bound(kind: str, W: int, q, lengths) -> tuple:
    """(bound_ms, bound_by) for one launch: live K/V tiles read once, q, the
    tables and lengths read once, the output written once; operations are
    the score and value multiply-adds over the live positions."""
    itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[kind]
    live_cols = np.ceil(lengths.max(dim=1).values.cpu().numpy() / KBS)
    live_pos = live_cols * KBS
    per_pos = KH * KDH * itemsize + (KH * 4 if kind == "int8" else 0)
    nbytes = 2 * float(live_pos.sum()) * per_pos
    nbytes += 2 * q.numel() * q.element_size()            # q in, out
    nbytes += KS * KNTBL * 4 + lengths.numel() * 4
    ops = float((2 * 2 * W * KH * KDH * live_pos).sum())
    peak = PEAK_OPS_PER_S[{"float32": torch.float32,
                           "bfloat16": torch.bfloat16,
                           "int8": torch.int8}[kind]]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(card: str) -> dict:
    """Kernel against plain version for float32 / bfloat16 / int8 arenas at
    W=1 and W=4; returns the float32 W=1 record for the JSON line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_gather_kv
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    record = None
    for kind in ("float32", "bfloat16", "int8"):
        for W in (1, 4):
            q, kp, vp, tables, lengths = _kernel_inputs(kind, W, dev, rng)
            qq = q[:, 0] if W == 1 else q
            ll = lengths[:, 0] if W == 1 else lengths
            got = paged_attention(qq, kp, vp, KLAYER, tables, ll)
            torch.cuda.synchronize()
            want = paged_attention_reference(qq, kp, vp, KLAYER, tables, ll,
                                             out_dtype=q.dtype)
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{kind} W={W}: kernel returned {got.shape} {got.dtype}, "
                  f"plain {want.shape} {want.dtype}")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kind} W={W}: non-finite kernel output")
            err = float((got.float() - want.float()).abs().max())
            atol, rtol = TOLERANCE[kind]
            ok = torch.allclose(got.float(), want.float(), atol=atol,
                                rtol=rtol)
            print(f"kernel paged_attention {kind} W={W}: max|d|={err:.3e} "
                  f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'MISMATCH'}")
            check(ok, f"paged_attention {kind} W={W} disagrees with its "
                      f"plain version: max|d|={err}")

            # timing: rotate over layers so the live tiles (~34 MB per layer
            # in float32) do not stay in the 50 MB L2, as in a real step
            def run_kernel(i):
                paged_attention(qq, kp, vp, i % KL, tables, ll)

            def run_plain(i):
                paged_attention_reference(qq, kp, vp, i % KL, tables, ll,
                                          out_dtype=q.dtype)

            kc = [paged_gather_kv(kp, la, tables) for la in range(KL)]
            vc = [paged_gather_kv(vp, la, tables) for la in range(KL)]
            qh = q.transpose(1, 2).to(kc[0].dtype)             # [S, H, W, Dh]
            t_idx = torch.arange(KNTBL * KBS, device=dev)
            mask = (t_idx[None, None, :] < lengths[:, :, None])[:, None]

            def run_library(i):
                F.scaled_dot_product_attention(qh, kc[i % KL], vc[i % KL],
                                               attn_mask=mask)

            ms, dev_ms = both_ms(run_kernel)
            plain_ms, plain_dev = both_ms(run_plain)
            library_ms, library_dev = both_ms(run_library)
            bound_ms, bound_by = _bound(kind, W, q, lengths)
            print(f"kernel paged_attention {kind} W={W}: {ms:.4f} ms (device "
                  f"{dev_ms:.4f}), plain {plain_ms:.4f} ms (device "
                  f"{plain_dev:.4f}), sdpa {library_ms:.4f} ms (device "
                  f"{library_dev:.4f}), bound {bound_ms:.4f} ms ({bound_by}; "
                  f"device time {bound_ms / dev_ms:.3f} of it) on {card}")
            del kc, vc
            if kind == "float32" and W == 1:
                record = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                          "plain_ms": plain_ms, "plain_device_ms": plain_dev,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms,
                          "library_device_ms": library_dev}
    return record


def _flash_bound(kernel: str, N: int, Tq: int, Tk: int, D: int,
                 causal: bool, dtype) -> tuple:
    """(bound_ms, bound_by) for one launch at this run's shape: each input
    read once and each output written once; operations are the
    multiply-adds of the kernel's products over the score entries the mask
    keeps (a causal row q sees min(q + 1, Tk) keys): two products in the
    forward (q.k, p.v), four in dK/dV (q.k, g.v, p.g, ds.q), three in dQ
    (q.k, g.v, ds.k)."""
    it = torch.empty((), dtype=dtype).element_size()
    if causal:
        pairs = N * float(np.minimum(np.arange(1, Tq + 1), Tk).sum())
    else:
        pairs = float(N * Tq * Tk)
    products = {"fwd": 2, "bwd_dkdv": 4, "bwd_dq": 3}[kernel]
    ops = 2.0 * D * pairs * products
    q_b, kv_b, stat_b = N * Tq * D * it, N * Tk * D * it, N * Tq * 4
    nbytes = {"fwd": 2 * q_b + 2 * kv_b + stat_b,       # q k v in, o lse out
              "bwd_dkdv": 2 * q_b + 4 * kv_b + 2 * stat_b,  # + dk dv out
              "bwd_dq": 3 * q_b + 2 * kv_b + 2 * stat_b}[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _worst(got, want, tol) -> float:
    """max |got - want| / tol, element by element (tol a tensor or a
    number); the check holds where this is <= 1."""
    return float(((got.float() - want.float()).abs() / tol).max())


def _flash_case(label, N, Tq, Tk, D, causal, dtype, dev, card) -> dict:
    """One case: forward (o, lse) and backward (dq, dk, dv) of the kernels
    against the plain versions on the same inputs; at the training shape
    also the times.  Returns the per-kernel records."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import attention as TA

    kind = "float32" if dtype == torch.float32 else "bfloat16"
    rng = np.random.RandomState(N + Tq + 7 * Tk + D)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    q, k, v, g = mk(N, Tq, D), mk(N, Tk, D), mk(N, Tk, D), mk(N, Tq, D)
    scale = D ** -0.5
    name = f"flash {label} N={N} Tq={Tq} Tk={Tk} D={D} causal={causal} {kind}"

    o, lse = TA.flash_fwd_kernel(q, k, v, scale, causal)
    torch.cuda.synchronize()
    ro, rlse = TA._fwd_reference(q, k, v, scale, causal)
    check(bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all()),
          f"{name}: non-finite forward output")
    err_o, err_lse = _abs(o, ro), _abs(lse, rlse)
    if kind == "float32":
        tol_o, lim_o = FLASH_FWD_ATOL, f"atol {FLASH_FWD_ATOL}"
    else:
        a_sum = TA._fwd_reference(q.float(), k.float(), v.float().abs(),
                                  scale, causal)[0]
        tol_o = 2 * BF16_U * (a_sum + ro.float().abs()) + FLASH_FWD_ATOL
        lim_o = "2u (sum p|v| + |o|) + 2e-5 per element"
    w_o = _worst(o, ro, tol_o)
    ok = w_o <= 1.0 and err_lse <= FLASH_FWD_ATOL
    print(f"kernel {name}: fwd o max|d|={err_o:.3e}, worst |d|/limit "
          f"{w_o:.3f} (limit {lim_o}), lse max|d|={err_lse:.3e} (atol "
          f"{FLASH_FWD_ATOL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: forward kernel disagrees with _fwd_reference: o "
              f"{err_o} ({w_o} of its limit), lse {err_lse}")

    # the backward kernels and _bwd_blockwise on the same (q, k, v, o, lse, g)
    kq, kk, kv = TA.flash_bwd_kernels(q, k, v, ro, rlse, g, scale, causal)
    torch.cuda.synchronize()
    pq, pk, pv = TA._bwd_blockwise(q, k, v, ro, rlse, g, scale, causal, 128)
    worst = {}
    for n, got, want in (("dq", kq, pq), ("dk", kk, pk), ("dv", kv, pv)):
        top = float(want.float().abs().max())
        if kind == "float32":
            tol = FLASH_BWD_REL * top
        else:
            tol = (2 * BF16_U * want.float().abs()
                   + FLASH_BWD_BF16_SUM_REL * top)
        worst[n] = (_abs(got, want) / max(top, 1e-30),
                    _worst(got, want, tol + 1e-30))
    lim = (f"{FLASH_BWD_REL} max|g|" if kind == "float32" else
           f"2u |g| + {FLASH_BWD_BF16_SUM_REL} max|g| per element")
    ok = all(w <= 1.0 for _, w in worst.values()) and all(
        bool(torch.isfinite(t.float()).all()) for t in (kq, kk, kv))
    print(f"kernel {name}: bwd max|d|/max|g| (worst |d|/limit) " + ", ".join(
        f"{n} {r:.3e} ({w:.3f})" for n, (r, w) in worst.items())
        + f" (limit {lim}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: backward kernels disagree with _bwd_blockwise: "
              f"{worst}")
    errs = {"fwd": err_o, "bwd_dkdv": max(_abs(kk, pk), _abs(kv, pv)),
            "bwd_dq": _abs(kq, pq)}
    if label != "train":
        return {}

    # times at the training shape (q, k, v are 16.8 MB each in float32:
    # they stay in the 50 MB L2 between launches, as they do in the step);
    # each backward kernel against its own plain version
    delta = (ro.float() * g.float()).sum(dim=-1).contiguous()
    bwd_args = (q, k, v, g, rlse, delta, scale, True)
    kern_fn = {"fwd": lambda i: TA.flash_fwd_kernel(q, k, v, scale, True),
               "bwd_dkdv": lambda i: TA.flash_bwd_dkdv_kernel(*bwd_args),
               "bwd_dq": lambda i: TA.flash_bwd_dq_kernel(*bwd_args)}
    plain_fn = {
        "fwd": lambda i: TA._fwd_reference(q, k, v, scale, True),
        "bwd_dkdv": lambda i: TA._bwd_dkdv_blockwise(*bwd_args, 128),
        "bwd_dq": lambda i: TA._bwd_dq_blockwise(*bwd_args, 128)}
    ms, dev_ms, plain, plain_dev = {}, {}, {}, {}
    for kern in FLASH_KERNELS:
        ms[kern], dev_ms[kern] = both_ms(kern_fn[kern])
        plain[kern], plain_dev[kern] = both_ms(plain_fn[kern], iters=10)
    B, H = 8, N // 8
    qh, kh, vh, gh = (t.view(B, H, -1, D) for t in (q, k, v, g))
    qr, kr, vr = (t.detach().clone().requires_grad_(True)
                  for t in (qh, kh, vh))

    def sdpa_fwd(i):
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_train_fwd(i):
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def sdpa_fwd_bwd(i):
        out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
        torch.autograd.grad(out, (qr, kr, vr), gh)

    lib_fwd, lib_fwd_dev = both_ms(sdpa_fwd)
    both, both_dev = both_ms(sdpa_fwd_bwd, iters=10)
    train_fwd, train_fwd_dev = both_ms(sdpa_train_fwd)
    lib_bwd, lib_bwd_dev = both - train_fwd, both_dev - train_fwd_dev
    recs = {}
    for kern in FLASH_KERNELS:
        bound_ms, bound_by = _flash_bound(kern, N, Tq, Tk, D, causal, dtype)
        # no PyTorch call computes dk/dv alone or dq alone: the backward
        # kernels have no library time of their own (the pair's is below)
        recs[kern] = {
            "max_abs_err": errs[kern], "ms": ms[kern],
            "device_ms": dev_ms[kern], "plain_ms": plain[kern],
            "plain_device_ms": plain_dev[kern], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_fwd if kern == "fwd" else None,
            "library_device_ms": lib_fwd_dev if kern == "fwd" else None}
        lib = (f"sdpa {lib_fwd:.4f} ms (device {lib_fwd_dev:.4f})"
               if kern == "fwd" else "no library call of its own")
        print(f"kernel flash {kern} {kind} train shape: {ms[kern]:.4f} ms "
              f"(device {dev_ms[kern]:.4f}), plain {plain[kern]:.4f} ms "
              f"(device {plain_dev[kern]:.4f}), {lib}, bound "
              f"{bound_ms:.4f} ms ({bound_by}; device time "
              f"{bound_ms / dev_ms[kern]:.3f} of it) on {card}")
    print(f"kernel flash {kind} train shape: the two backward kernels "
          f"together {ms['bwd_dkdv'] + ms['bwd_dq']:.4f} ms (device "
          f"{dev_ms['bwd_dkdv'] + dev_ms['bwd_dq']:.4f}), their plain "
          f"versions {plain['bwd_dkdv'] + plain['bwd_dq']:.4f} ms, sdpa "
          f"backward (dq, dk and dv; forward + backward less forward) "
          f"{lib_bwd:.4f} ms (device {lib_bwd_dev:.4f}) on {card}")
    return recs


def phase_flash_kernels(card: str) -> dict:
    """Every flash case in float32 and bfloat16; returns the float32
    training-shape records by kernel for the JSON line."""
    dev = torch.device("cuda")
    records = {}
    for label, N, Tq, Tk, D, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            recs = _flash_case(label, N, Tq, Tk, D, causal, dtype, dev, card)
            if label == "train" and dtype == torch.float32:
                records = recs
    return records


def _lstm_bound(kernel: str, T: int, B: int, H: int, n_valid: int,
                whole: bool = True) -> tuple:
    """(bound_ms, bound_by) for one call at this run's shape.  Operations:
    the recurrent product's multiply-adds over the (step, row) pairs the
    mask keeps (``n_valid``; padded steps need none), 2 * n_valid * H * 4H,
    and for the whole backward as much again for du = sum_t h^T dxw.
    Bytes: each input read once and each output written once, float32 --
    forward xw, U, peep, mask in, hs, the carried state hc and cc
    [T+1, B, H], the gates and c_new out (the training path writes them
    for the backward); backward g_hs, g_c, U, peep, mask, gates, c_new, cc
    (and hc for du) in, dxw (and du, dpeep) out."""
    tbh, bh, u = T * B * H, B * H, H * 4 * H
    mask = T * B
    product = 2.0 * n_valid * H * 4 * H
    if kernel == "fwd":
        ops = product
        elems = (4 * tbh + u + 3 * H + mask
                 + tbh + 2 * (tbh + bh) + 4 * tbh + tbh)
    else:
        ops = product * (2 if whole else 1)
        elems = (tbh + bh + u + 3 * H + mask + 4 * tbh + tbh + (tbh + bh)
                 + 4 * tbh)
        if whole:
            elems += (tbh + bh) + u + 3 * H
    t_bytes = 4.0 * elems / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _lstm_inputs(T, B, H, lengths, dev, seed):
    """xw N(0, 1), U N(0, 1/H) (gate pre-activations spread around O(1)),
    peep N(0, 0.5^2), the mask of ``lengths`` and cotangents N(0, 1)."""
    rng = np.random.RandomState(seed)

    def mk(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dev)

    mask = torch.from_numpy((np.arange(T)[:, None] < np.asarray(lengths)[
        None, :]).astype(np.float32)).to(dev)
    return (mk((T, B, 4 * H)), mk((H, 4 * H), H ** -0.5), mk((3, H), 0.5),
            mask, mk((T, B, H)), mk((B, H)))


def _lstm_case(label, T, B, H, lengths, peep_on, dev, card, timed) -> dict:
    """The forward kernel against ``_lstm_scan`` and the backward
    (reverse-recurrence kernel, then du and the peephole sums) against
    ``_lstm_scan_vjp``, on the same inputs on the card; with ``timed`` the
    times, bounds and cuDNN's LSTM beside them.  Returns the records."""
    from paddle_tpu_torch.ops import lstm as TL

    xw, u, peep, mask, g_hs, g_c = _lstm_inputs(T, B, H, lengths, dev,
                                                 T + B + H)
    args = (H, peep_on, LSTM_ACTS)
    name = f"lstm {label} T={T} B={B} H={H} peepholes={peep_on}"
    hs, hc, cc, gates, cnew = TL.lstm_fwd_kernel(xw, u, peep, mask, *args,
                                                 True)
    torch.cuda.synchronize()
    rhs, rc = TL._lstm_scan(xw, u, peep, mask, *args)
    err_f = max(_abs(hs, rhs), _abs(cc[-1], rc))
    ok = (err_f <= LSTM_FWD_ATOL and bool(torch.isfinite(hs).all())
          and bool(torch.isfinite(cc[-1]).all()))
    print(f"kernel {name}: fwd hs, c_final max|d|={err_f:.3e} (atol "
          f"{LSTM_FWD_ATOL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: forward kernel disagrees with _lstm_scan: {err_f}")

    got = TL.lstm_bwd_cuda(g_hs, g_c, u, peep, mask, hc, cc, gates, cnew,
                           *args)
    torch.cuda.synchronize()
    want = TL._lstm_scan_vjp(xw, u, peep, mask, *args, g_hs, g_c)
    rel, err_b = {}, 0.0
    for n, a, b in zip(("dxw", "du", "dpeep"), got, want):
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite {n}")
        top = float(b.abs().max())
        rel[n] = _abs(a, b) / max(top, 1e-30)
        err_b = max(err_b, _abs(a, b))
    ok = all(r <= LSTM_BWD_REL for r in rel.values())
    print(f"kernel {name}: bwd max|d|/max|g| " + ", ".join(
        f"{n} {r:.3e}" for n, r in rel.items())
        + f" (limit {LSTM_BWD_REL}) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: backward disagrees with _lstm_scan_vjp: {rel}")
    if not timed:
        return {}

    ms, dev_ms = {}, {}
    ms["fwd"], dev_ms["fwd"] = both_ms(lambda i: TL.lstm_fwd_kernel(
        xw, u, peep, mask, *args, True))
    ms["bwd"], dev_ms["bwd"] = both_ms(lambda i: TL.lstm_bwd_cuda(
        g_hs, g_c, u, peep, mask, hc, cc, gates, cnew, *args))
    bwd_kernel_ms, bwd_kernel_dev = both_ms(lambda i: TL.lstm_bwd_kernel(
        g_hs, g_c, u, peep, mask, gates, cnew, cc, *args))
    plain, plain_dev = {}, {}
    plain["fwd"], plain_dev["fwd"] = both_ms(
        lambda i: TL._lstm_scan(xw, u, peep, mask, *args), iters=5, warmup=1)
    plain["bwd"], plain_dev["bwd"] = both_ms(lambda i: TL._lstm_scan_vjp(
        xw, u, peep, mask, *args, g_hs, g_c), iters=3, warmup=1)
    # the yardstick: cuDNN's LSTM at the same T, B, H, full length, no
    # peepholes, input width H (text_lstm's second layer), float32 (TF32
    # off); it includes the input projection, so the kernel is shown with
    # that projection's matmul beside it
    torch.backends.cudnn.allow_tf32 = False
    lib = torch.nn.LSTM(H, H).to(dev)
    x = torch.randn(T, B, H, device=dev)
    xr = x.clone().requires_grad_(True)
    gy = torch.randn(T, B, H, device=dev)
    wx = torch.randn(H, 4 * H, device=dev) * H ** -0.5
    leaves = [xr] + list(lib.parameters())

    def lib_fwd(i):
        with torch.no_grad():
            lib(x)

    def lib_train_fwd(i):
        lib(xr)

    def lib_fwd_bwd(i):
        torch.autograd.grad(lib(xr)[0], leaves, gy)

    lib_ms, lib_dev = both_ms(lib_fwd)
    both, both_dev = both_ms(lib_fwd_bwd, iters=10)
    train_fwd, train_fwd_dev = both_ms(lib_train_fwd)
    lib_bwd_ms, lib_bwd_dev = both - train_fwd, both_dev - train_fwd_dev
    proj_ms = cuda_ms(lambda i: x.reshape(T * B, H) @ wx)
    n_valid = int(mask.sum())
    recs = {}
    for kern in LSTM_KERNELS:
        bound_ms, bound_by = _lstm_bound(kern, T, B, H, n_valid)
        library_ms, library_dev = ((lib_ms, lib_dev) if kern == "fwd"
                                   else (lib_bwd_ms, lib_bwd_dev))
        recs[kern] = {"max_abs_err": err_f if kern == "fwd" else err_b,
                      "ms": ms[kern], "device_ms": dev_ms[kern],
                      "plain_ms": plain[kern],
                      "plain_device_ms": plain_dev[kern],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms,
                      "library_device_ms": library_dev}
        print(f"kernel lstm {kern} {label} shape: {ms[kern]:.4f} ms (device "
              f"{dev_ms[kern]:.4f}), plain {plain[kern]:.4f} ms (device "
              f"{plain_dev[kern]:.4f}), cudnn {library_ms:.4f} ms (device "
              f"{library_dev:.4f}), bound {bound_ms:.4f} ms ({bound_by}; "
              f"{n_valid} of {T * B} steps valid) on {card}")
    kb_ms, kb_by = _lstm_bound("bwd", T, B, H, n_valid, whole=False)
    print(f"kernel lstm {label} shape: the reverse-recurrence kernel alone "
          f"{bwd_kernel_ms:.4f} ms (device {bwd_kernel_dev:.4f}; bound "
          f"{kb_ms:.4f} ms, {kb_by}), du matmul and peephole sums the rest "
          f"of the backward; input projection [{T * B}, {H}] x [{H}, "
          f"{4 * H}] {proj_ms:.4f} ms, projection + forward kernel "
          f"{proj_ms + ms['fwd']:.4f} ms vs cudnn forward {lib_ms:.4f} ms "
          f"(full length, no mask); cudnn backward is forward + backward "
          f"less forward, with grad-enabled weights, on {card}")
    return recs


def _lstm_layer_case(card) -> None:
    """dynamic_lstm(is_reverse=True, use_peepholes=True) after an fc, in a
    program run by the card's Executor (kernels) and the CPU's (plain
    versions) from the same weights, on lengths {1, T, 0}: hidden, last
    cell and the three weight gradients compared; the card run launches
    each LSTM kernel once."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import fused_lstm

    T, D, H = 37, 24, 40
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        x = L.data("x", [T, D])
        lengths = L.data("lengths", [-1], dtype="int32",
                         append_batch_size=False)
        proj = L.fc(x, 4 * H, num_flatten_dims=2, bias_attr=False)
        hs, c = L.dynamic_lstm(proj, lengths, H, use_peepholes=True,
                               is_reverse=True)
        loss = L.sums([L.mean(L.square(hs)), L.mean(c)])
        pg = fluid.backward.append_backward(loss)
    rng = np.random.RandomState(5)
    weights = {"fc_w_0": rng.standard_normal((D, 4 * H)) / np.sqrt(D),
               "dynamic_lstm_w_0": rng.standard_normal((H, 4 * H))
               / np.sqrt(H),
               "dynamic_lstm_b_0": rng.standard_normal(7 * H) * 0.5}
    weights = {k: v.astype(np.float32) for k, v in weights.items()}
    feed = {"x": rng.standard_normal((3, T, D)).astype(np.float32),
            "lengths": np.array([1, T, 0], np.int32)}
    fetch = [hs, c] + [g for _, g in pg]
    outs = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        fluid.load_scope(weights, main, scope, device=dev)
        before = dict(fused_lstm.launches)
        outs[dev] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        ran = {k: fused_lstm.launches[k] - before[k] for k in before}
        want = {"fwd": 1, "bwd": 1} if dev == "cuda" else {"fwd": 0, "bwd": 0}
        check(ran == want, f"lstm layer case on {dev}: launches {ran}, "
                           f"expected {want}")
    name = f"lstm layer dynamic_lstm(is_reverse) T={T} B=3 H={H} lengths 1,T,0"
    errs = []
    for i, (v, a, b) in enumerate(zip(fetch, outs["cuda"], outs["cpu"])):
        check(np.isfinite(a).all(), f"{name}: non-finite {v.name}")
        d = float(np.abs(a - b).max())
        lim = LSTM_FWD_ATOL if i < 2 else LSTM_BWD_REL * float(
            np.abs(b).max())
        errs.append((v.name, d, lim))
    ok = all(d <= lim for _, d, lim in errs)
    print(f"kernel {name}: card vs CPU " + ", ".join(
        f"{n} {d:.3e} (limit {lim:.1e})" for n, d, lim in errs)
        + f" {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: card and CPU disagree: {errs}")
    check(np.all(outs["cuda"][0][2] == 0) and np.all(
        outs["cuda"][0][0][1:] == 0), f"{name}: padded steps not zero")


def phase_lstm_kernels(card: str) -> dict:
    """The LSTM cases; returns the full-width records by kernel for the
    JSON line."""
    from paddle_tpu_torch import resolve_device

    dev = resolve_device()         # float32 matmuls in full float32
    T, B, H = 100, 128, 512
    lengths = np.random.RandomState(0).randint(T // 2, T + 1, B)
    recs = _lstm_case("train", T, B, H, lengths, False, dev, card, True)
    _lstm_case("peepholes", T, B, H, lengths, True, dev, card, False)
    _lstm_layer_case(card)
    return recs


def _ttft(handles) -> tuple:
    t = np.array([h.t_first_token - h.t_submit for h in handles]) * 1e3
    return float(np.percentile(t, 50)), float(np.percentile(t, 99))


def _teacher_forced(eng, handles) -> tuple:
    """(agreeing, total): the dense lm_forward oracle (no kernel) over
    prompt + emitted tokens; its argmax at each generated position against
    the emitted token."""
    agree = total = 0
    for h in handles:
        toks = np.asarray(h.tokens, np.int32)
        hist = torch.from_numpy(np.concatenate([h.prompt, toks]))
        x, _ = eng.model(hist.to(eng.device)[None])
        P = h.prompt.size
        pred = eng.model.logits(x[0, P - 1:P - 1 + toks.size]).argmax(-1)
        agree += int((pred.cpu().numpy() == toks).sum())
        total += int(toks.size)
    return agree, total


def _serve(eng, reqs, spec: bool):
    """One scheduler pass over ``reqs`` [(prompt, max_gen, SamplingParams)];
    returns (handles, scheduler, wall seconds, kernel launches, step
    dispatches by window width).  Both counts are set to 0 just before the
    pass and read just after it, so they are this pass's own."""
    from paddle_tpu_torch import ContinuousScheduler
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    sched = ContinuousScheduler(eng, spec=spec)
    torch.cuda.synchronize()
    paged_attention.launches = 0
    eng.step_dispatches.clear()
    t0 = time.perf_counter()
    handles = [sched.submit(p, g, sampling=sp) for p, g, sp in reqs]
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (handles, sched, wall, paged_attention.launches,
            dict(sorted(eng.step_dispatches.items())))


def _check_pass(name, eng, handles, sched, launches, dispatches):
    for h in handles:
        check(h.done.is_set() and h.error is None,
              f"{name}: request {h.id} ended with {h.error!r}")
        check(len(h.tokens) > 0, f"{name}: request {h.id} emitted nothing")
    acct = sched.check_block_accounting()
    check(acct["leaked"] == 0 and acct["occupied"] == 0
          and eng.pool.blocks_free == eng.pool.n_blocks,
          f"{name}: blocks leaked: {acct}, free {eng.pool.blocks_free}")
    n_layers = eng.model.n_layers
    n_disp = sum(dispatches.values())
    check(launches == n_layers * n_disp and n_disp > 0,
          f"{name}: {launches} kernel launches for {n_disp} step "
          f"dispatches x {n_layers} layers")


def phase_serve(card: str) -> dict:
    from paddle_tpu_torch import (ContinuousDecodeEngine, SamplingParams,
                                  init_lm_params)

    V =LM_CFG["vocab_size"]
    params = init_lm_params(0, **LM_CFG)
    eng = ContinuousDecodeEngine(params, **ENGINE_CFG, **LM_CFG)
    greedy = SamplingParams()
    # warm-up (cuBLAS handles, allocator): one short request, not reported
    _serve(eng, [(np.arange(2, 18, dtype=np.int32), 4, greedy)], spec=False)

    # the W=1 path: its counts are this pass's alone (see _serve)
    rng = np.random.RandomState(1)
    sampled_idx = {1, 5, 9, 13}
    reqs = []
    for i in range(16):
        p = rng.randint(2, V, rng.randint(16, 513)).astype(np.int32)
        g = int(rng.randint(32, 65))
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=1000 + i)
              if i in sampled_idx else greedy)
        reqs.append((p, g, sp))
    handles, sched, wall, launches, dispatches = _serve(eng, reqs, False)
    _check_pass("mixed pass", eng, handles, sched, launches, dispatches)
    check(set(dispatches) == {1},
          f"mixed pass dispatched windows {dispatches}, expected W=1 only")
    paths = {"w1_mixed_pass": {"launches": launches,
                               "dispatches_by_window": dispatches}}
    greedy_h = [h for i, h in enumerate(handles) if i not in sampled_idx]
    agree, total = _teacher_forced(eng, greedy_h)
    rate = agree / total
    tokens = sum(len(h.tokens) for h in handles)
    steps = sched.counters["steps"]
    p50, p99 = _ttft(handles)
    print(f"serve mixed: {len(handles)} requests, {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.1f} tok/s, {steps} steps, mean "
          f"step {wall / steps * 1e3:.2f} ms, TTFT p50 {p50:.1f} ms p99 "
          f"{p99:.1f} ms, preemptions {sched.counters['preemptions']}, "
          f"kernel launches {launches} = {eng.model.n_layers} x "
          f"{sum(dispatches.values())} dispatches {dispatches}, on {card}")
    print(f"serve mixed: teacher-forced agreement {agree}/{total} = "
          f"{rate:.4f} (floor 0.98)")
    check(rate >= 0.98, f"teacher-forced agreement {rate} < 0.98")

    # sampled streams are a pure function of (seed, token index): the same
    # sampled requests served twice give the same streams (these reruns are
    # checks, not a path: their counts are not reported)
    sreqs = [reqs[i] for i in sorted(sampled_idx)]
    runs = [_serve(eng, sreqs, False)[0] for _ in range(2)]
    same = all(a.tokens == b.tokens for a, b in zip(*runs))
    print(f"serve sampled: {len(sreqs)} sampled streams repeat "
          f"{'identically' if same else 'DIFFERENTLY'}")
    check(same, "sampled streams differ between two identical runs")

    # the W=4 path, speculative pass: repetitive prompts make n-gram drafts,
    # verified in W=4 steps (steps with no draft still run at W=1)
    sreqs = []
    for i in range(8):
        motif = rng.randint(2, V, rng.randint(6, 20)).astype(np.int32)
        p = np.tile(motif, -(-int(rng.randint(64, 257)) // motif.size))
        sreqs.append((p.astype(np.int32), int(rng.randint(32, 65)), greedy))
    handles, sched, wall, launches, dispatches = _serve(eng, sreqs, True)
    _check_pass("spec pass", eng, handles, sched, launches, dispatches)
    W = ENGINE_CFG["spec_window"]
    check(sched.counters["spec_proposed"] > 0 and dispatches.get(W, 0) > 0,
          f"speculative pass dispatched {dispatches}: the W={W} path did not "
          f"run")
    paths["w4_spec_pass"] = {"launches": launches,
                             "dispatches_by_window": dispatches}
    agree_s, total_s = _teacher_forced(eng, handles)
    rate_s = agree_s / total_s
    tokens_s = sum(len(h.tokens) for h in handles)
    steps_s = sched.counters["steps"]
    print(f"serve spec W=4: {len(handles)} requests, {tokens_s} tokens in "
          f"{wall:.3f} s = {tokens_s / wall:.1f} tok/s, {steps_s} steps, "
          f"accepted {sched.counters['spec_accepted']}/"
          f"{sched.counters['spec_proposed']} drafts, kernel launches "
          f"{launches} = {eng.model.n_layers} x {sum(dispatches.values())} "
          f"dispatches {dispatches}, teacher-forced {agree_s}/{total_s} = {rate_s:.4f}, on {card}")
    check(rate_s >= 0.98, f"spec teacher-forced agreement {rate_s} < 0.98")
    return paths


def phase_train(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention
    from paddle_tpu_torch.tools.train_profile import (
        TRAIN_BATCH, TRAIN_STEPS, build_train_program, train_batch,
        train_scope)

    # the program, weights and batch of tools/train_profile.py
    loss, main, startup = build_train_program()
    params = fluid.init_lm_params(0, **LM_CFG)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())

    # parity step: the card (kernels) and the CPU (plain versions) from the
    # same weights on the same 2 x 1024 tokens
    feed = train_batch(2, 2)
    t0 = time.perf_counter()
    got = exe.run(main, feed=feed, fetch_list=[loss] + grad_names,
                  scope=train_scope(exe, startup, main, params))
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = exe_cpu.run(main, feed=feed, fetch_list=[loss] + grad_names,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    t_cpu = time.perf_counter() - t0
    l_gpu, l_cpu = float(got[0]), float(want[0])
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"parity step: loss {l_gpu} on the card, {l_cpu} on the CPU")
    worst, worst_name = 0.0, None
    for name, a, b in zip(grad_names, got[1:], want[1:]):
        check(np.isfinite(a).all(), f"parity step: non-finite {name}")
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    print(f"train parity: loss {l_gpu:.6f} card, {l_cpu:.6f} CPU (rtol "
          f"1e-4); {len(grad_names)} gradients, worst max|d|/max|g| "
          f"{worst:.3e} ({worst_name}; limit 1e-3); step {t_gpu:.2f} s card "
          f"(first), {t_cpu:.2f} s CPU")
    check(worst <= 1e-3, f"parity step: {worst_name} differs by {worst} of "
                         f"its max |g|")

    # training pass: the counts are this pass's own
    scope = train_scope(exe, startup, main, params)
    feed = train_batch(3)
    torch.cuda.synchronize()
    for kern in FLASH_KERNELS:
        flash_attention.launches[kern] = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        losses.append(float(out))
        step_ms.append(e0.elapsed_time(e1))
    launches = dict(flash_attention.launches)
    n_layers = LM_CFG["n_layers"]
    check(all(np.isfinite(losses)), f"train: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    check(all(launches[k] == n_layers * TRAIN_STEPS for k in FLASH_KERNELS),
          f"train: flash launches {launches}, expected {n_layers} x "
          f"{TRAIN_STEPS} each")
    med = float(np.median(step_ms[1:]))
    T = LM_CFG["max_len"]
    tokens = TRAIN_BATCH * T
    print(f"train: {TRAIN_STEPS} Adam steps on {TRAIN_BATCH} x {T} "
          f"tokens, losses {', '.join(f'{x:.4f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; median of steps 2-"
          f"{TRAIN_STEPS} {med:.2f} ms = {tokens / med * 1e3:.0f} tokens/s; "
          f"flash launches {launches} = {n_layers} layers x {TRAIN_STEPS} "
          f"steps; on {card}")
    return {"launches": launches, "losses": losses, "median_ms": med}


def phase_lstm_train(card: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import fused_lstm
    from paddle_tpu_torch.tools.train_profile import (
        TEXT_LSTM_BATCH, TEXT_LSTM_CFG, TEXT_LSTM_SEQ, TRAIN_STEPS,
        build_text_lstm_program, text_lstm_batch, text_lstm_params,
        train_scope)

    # the program, weights and batch of tools/train_profile.py --model
    # text_lstm
    loss, main, startup = build_text_lstm_program()
    params = text_lstm_params(0)
    grad_names = [f"{n}@GRAD" for n in params]
    exe = fluid.Executor()
    exe_cpu = fluid.Executor(fluid.CPUPlace())

    # parity step: the card (kernels) and the CPU (plain versions) from the
    # same weights on the same 16 sequences
    feed = text_lstm_batch(1, 16)
    t0 = time.perf_counter()
    got = exe.run(main, feed=feed, fetch_list=[loss] + grad_names,
                  scope=train_scope(exe, startup, main, params))
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = exe_cpu.run(main, feed=feed, fetch_list=[loss] + grad_names,
                       scope=train_scope(exe_cpu, startup, main, params,
                                         "cpu"))
    t_cpu = time.perf_counter() - t0
    l_gpu, l_cpu = float(got[0]), float(want[0])
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"lstm parity step: loss {l_gpu} on the card, {l_cpu} on the CPU")
    worst, worst_name = 0.0, None
    for name, a, b in zip(grad_names, got[1:], want[1:]):
        check(np.isfinite(a).all(), f"lstm parity step: non-finite {name}")
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if rel >= worst:
            worst, worst_name = rel, name
    print(f"lstm train parity: loss {l_gpu:.6f} card, {l_cpu:.6f} CPU (rtol "
          f"1e-4); {len(grad_names)} gradients, worst max|d|/max|g| "
          f"{worst:.3e} ({worst_name}; limit 1e-3); step {t_gpu:.2f} s card "
          f"(first), {t_cpu:.2f} s CPU")
    check(worst <= 1e-3, f"lstm parity step: {worst_name} differs by "
                         f"{worst} of its max |g|")

    # training pass: the counts are this pass's own
    scope = train_scope(exe, startup, main, params)
    feed = text_lstm_batch(0)
    torch.cuda.synchronize()
    for kern in LSTM_KERNELS:
        fused_lstm.launches[kern] = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        losses.append(float(out))
        step_ms.append(e0.elapsed_time(e1))
    launches = dict(fused_lstm.launches)
    n_layers = TEXT_LSTM_CFG["num_layers"]
    check(all(np.isfinite(losses)), f"lstm train: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"lstm train: loss did not fall: {losses}")
    check(all(launches[k] == n_layers * TRAIN_STEPS for k in LSTM_KERNELS),
          f"lstm train: launches {launches}, expected {n_layers} x "
          f"{TRAIN_STEPS} each")
    med = float(np.median(step_ms[1:]))
    print(f"lstm train: {TRAIN_STEPS} Adam steps on {TEXT_LSTM_BATCH} x "
          f"{TEXT_LSTM_SEQ} (lengths 50-100, {int(feed['lengths'].sum())} "
          f"valid tokens), losses {', '.join(f'{x:.5f}' for x in losses)}; "
          f"step ms {', '.join(f'{x:.1f}' for x in step_ms)}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.2f} ms = "
          f"{TEXT_LSTM_BATCH / med * 1e3:.0f} sequences/s; lstm launches "
          f"{launches} = {n_layers} layers x {TRAIN_STEPS} steps (each call "
          f"{TEXT_LSTM_SEQ} device launches); on {card}")
    return {"launches": launches, "losses": losses, "median_ms": med}


def _bn_bound(kernel: str, n: int, c: int, hw: int, dtype) -> tuple:
    """(bound_ms, bound_by) for one call: each input read once and each
    output written once (reduction: dy and x in, mean and rstd in, dbeta
    and dgamma out; dx: dy and x in, five per-channel vectors in, dx out);
    operations, float32 on the CUDA cores: 3 an element in the reduction
    (add, subtract, multiply-add), 4 in dx."""
    it = torch.empty((), dtype=dtype).element_size()
    elems = n * c * hw
    nbytes = ({"reduce": 2, "dx": 3}[kernel] * elems * it
              + {"reduce": 4, "dx": 5}[kernel] * c * 4)
    ops = {"reduce": 3, "dx": 4}[kernel] * elems
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _bn_inputs(n, c, h, w, dtype, dev, seed):
    """dy N(0, 1) and x N(0.5, 2^2) in ``dtype`` on the card (channel c // 2
    constant), their batch mean and rstd in float32, gamma in [0.5, 1.5)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n, c, h, w), generator=gen, device=dev) * 2 + 0.5
    x[:, c // 2] = 1.25
    dy = torch.randn((n, c, h, w), generator=gen, device=dev)
    x, dy = x.to(dtype), dy.to(dtype)
    x32 = x.float()
    mean = x32.mean((0, 2, 3))
    var = torch.clamp_min(x32.square().mean((0, 2, 3)) - mean.square(), 0.0)
    del x32
    rstd = torch.rsqrt(var + BN_EPS)
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    return dy, x, mean, rstd, gamma


def _bn_case(label, n, c, h, w, dtype, dev, card) -> dict:
    """Both kernels against their plain versions on the same inputs; for
    the probe's shape also the times.  Returns the records by kernel."""
    from paddle_tpu_torch.ops import batch_norm as TB

    kind = "float32" if dtype == torch.float32 else "bfloat16"
    name = f"bn {label} [{n},{c},{h},{w}] {kind}"
    dy, x, mean, rstd, gamma = _bn_inputs(n, c, h, w, dtype, dev,
                                          n + c + h * w)
    kb, kg = TB.bn_bwd_reduce_kernel(dy, x, mean, rstd)
    torch.cuda.synchronize()
    pb, pg = TB.bn_bwd_reduce_reference(dy, x, mean, rstd)
    dyf = dy.float()
    abs_dy = dyf.abs().sum((0, 2, 3))
    xhat = (x.float() - mean[None, :, None, None]) * rstd[None, :, None, None]
    abs_dg = (dyf * xhat).abs().sum((0, 2, 3))
    del dyf, xhat
    w_red = max(float(((kb - pb).abs() / (BN_SUM_REL * abs_dy + 1e-30)).max()),
                float(((kg - pg).abs() / (BN_SUM_REL * abs_dg + 1e-30)).max()))
    ok = w_red <= 1.0 and bool(torch.isfinite(kb).all()
                               and torch.isfinite(kg).all())
    err_red = max(_abs(kb, pb), _abs(kg, pg))
    print(f"kernel {name}: reduce max|d|={err_red:.3e}, worst |d|/limit "
          f"{w_red:.3f} (limit {BN_SUM_REL} sum |dy|, sum |dy xhat| per "
          f"channel) {'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: reduction kernel disagrees with its plain version "
              f"({w_red} of its limit)")

    # both dx versions from the plain reduction's dbeta, dgamma
    kdx = TB.bn_bwd_dx_kernel(dy, x, mean, rstd, gamma, pb, pg)
    torch.cuda.synchronize()
    pdx = TB.bn_bwd_dx_reference(dy, x, mean, rstd, gamma, pb, pg)
    check(kdx.dtype == dtype and kdx.shape == dy.shape,
          f"{name}: dx kernel returned {kdx.dtype} {tuple(kdx.shape)}")
    check(bool(torch.isfinite(kdx.float()).all()), f"{name}: non-finite dx")
    top = float(pdx.float().abs().max())
    err_dx = _abs(kdx, pdx)
    if kind == "float32":
        w_dx, lim = err_dx / (BN_DX_REL * top), f"{BN_DX_REL} max|dx|"
    else:
        w_dx = _worst(kdx, pdx, 2 * BF16_U * pdx.float().abs()
                      + BN_BF16_SUM_REL * top)
        lim = f"2u |dx| + {BN_BF16_SUM_REL} max|dx| per element"
    ok = w_dx <= 1.0
    print(f"kernel {name}: dx max|d|={err_dx:.3e} ({err_dx / top:.3e} of "
          f"max|dx|), worst |d|/limit {w_dx:.3f} (limit {lim}) "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, f"{name}: dx kernel disagrees with its plain version "
              f"({w_dx} of its limit)")
    if label != "probe":
        return {}

    # times at the probe's shape (dy and x are 411 MB each in bf16, far
    # past the 50 MB L2: every call streams them from device memory)
    kern_fn = {"reduce": lambda i: TB.bn_bwd_reduce_kernel(dy, x, mean,
                                                           rstd),
               "dx": lambda i: TB.bn_bwd_dx_kernel(dy, x, mean, rstd, gamma,
                                                   pb, pg)}
    plain_fn = {"reduce": lambda i: TB.bn_bwd_reduce_reference(dy, x, mean,
                                                               rstd),
                "dx": lambda i: TB.bn_bwd_dx_reference(dy, x, mean, rstd,
                                                       gamma, pb, pg)}
    ms, dev_ms, plain, plain_dev = {}, {}, {}, {}
    for kern in BN_KERNELS:
        ms[kern], dev_ms[kern] = both_ms(kern_fn[kern])
        plain[kern], plain_dev[kern] = both_ms(plain_fn[kern], iters=10)

    # the library yardstick for the pair: dx, dgamma and dbeta in one call
    def library(i):
        torch.ops.aten.native_batch_norm_backward(
            dy, x, gamma, None, None, mean, rstd, True, BN_EPS,
            [True, True, True])

    lib_ms, lib_dev = both_ms(library)
    lx, lg, lb = torch.ops.aten.native_batch_norm_backward(
        dy, x, gamma, None, None, mean, rstd, True, BN_EPS, [True, True, True])
    print(f"kernel {name}: native_batch_norm_backward against the plain "
          f"versions: dx {_abs(lx, pdx) / top:.3e} of max|dx|, dgamma "
          f"{_abs(lg, pg):.3e}, dbeta {_abs(lb, pb):.3e}")
    del lx, lg, lb
    recs = {}
    for kern in BN_KERNELS:
        bound_ms, bound_by = _bn_bound(kern, n, c, h * w, dtype)
        recs[kern] = {
            "max_abs_err": err_red if kern == "reduce" else err_dx,
            "ms": ms[kern], "device_ms": dev_ms[kern],
            "plain_ms": plain[kern], "plain_device_ms": plain_dev[kern],
            "bound_ms": bound_ms, "bound_by": bound_by,
            # no PyTorch call computes the reduction alone or dx alone: the
            # pair's yardstick stands beside each
            "library_ms": lib_ms, "library_device_ms": lib_dev,
            "library": "native_batch_norm_backward (dx, dgamma and dbeta)"}
        print(f"kernel bn {kern} {kind} probe shape: {ms[kern]:.4f} ms "
              f"(device {dev_ms[kern]:.4f}), plain {plain[kern]:.4f} ms "
              f"(device {plain_dev[kern]:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}; device time {bound_ms / dev_ms[kern]:.3f} of "
              f"it) on {card}")
    print(f"kernel bn {kind} probe shape: the pair {ms['reduce'] + ms['dx']:.4f}"
          f" ms (device {dev_ms['reduce'] + dev_ms['dx']:.4f}), "
          f"native_batch_norm_backward {lib_ms:.4f} ms (device "
          f"{lib_dev:.4f}) on {card}")
    return recs


def phase_bn_kernels(card: str) -> dict:
    """Every batch-norm case in float32 and bfloat16; returns the
    probe-shape records by dtype and kernel for the JSON line."""
    dev = torch.device("cuda")
    records = {}
    for label, n, c, h, w in BN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            recs = _bn_case(label, n, c, h, w, dtype, dev, card)
            if recs:
                records["float32" if dtype == torch.float32
                        else "bfloat16"] = recs
            torch.cuda.empty_cache()
    return records


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _resnet_parity(card: str) -> None:
    """One float32 step (TF32 off) of ResNet-50 on RESNET_PARITY_BATCH
    images on the card and on the CPU from the same weights: the loss
    within rtol 1e-4 and every running statistic after the step within
    1e-3 of its max |.|.

    The gradients of this network at its random initialisation are
    chaotic at float32's resolution: a float32 rounding flips a ReLU here
    and there (about 100 of them in the forward), and each batch norm
    spreads a flipped element's gradient over its whole channel (196
    values a channel at the last stage).  On the CPU alone, multiplying
    the images by (1 + 1e-7 N(0, 1)) moves 159 of the 161 gradients by
    more than 1e-3 of their max |.| (up to 0.19), and by 2.3% in L2 each
    (median).  So each gradient is held, in relative L2, within max(1e-3,
    RESNET_FLOOR_FACTOR x its floor), and all of them together within
    RESNET_FLOOR_FACTOR x the floor of all of them, where a floor is the
    larger spread of two such CPU steps (noise seeds 5 and 6) from the
    unperturbed one, measured in this run.  Six more CPU draws reached at
    most 1.32 x a floor of two."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (build_resnet_program,
                                                      resnet_batch,
                                                      resnet_params,
                                                      train_scope)

    loss, main, startup = build_resnet_program(amp=False)
    params = resnet_params(0)
    grad_names = [f"{n}@GRAD" for n in params]
    stat_names = sorted(v.name for v in main.persistable_vars()
                        if v.name.endswith((".w_mean", ".w_var")))
    check(len(stat_names) == 2 * RESNET_BN_LAYERS,
          f"resnet: {len(stat_names)} running statistics")
    feed = resnet_batch(1, RESNET_PARITY_BATCH, "cpu")

    def step(dev, images):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        check(dev == "cpu" or not torch.backends.cudnn.allow_tf32,
              "cuDNN TF32 is on: the float32 contract needs it off")
        scope = train_scope(exe, startup, main, params,
                            None if dev == "cuda" else "cpu")
        t0 = time.perf_counter()
        out = exe.run(main, feed=dict(feed, img=images),
                      fetch_list=[loss] + grad_names, scope=scope)
        secs = time.perf_counter() - t0
        return (float(out[0]), out[1:],
                [scope.find_var(n).cpu().numpy() for n in stat_names], secs)

    l_gpu, g_gpu, s_gpu, t_gpu = step("cuda", feed["img"])
    l_cpu, g_cpu, s_cpu, t_cpu = step("cpu", feed["img"])
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu),
          f"resnet parity step: loss {l_gpu} on the card, {l_cpu} on the CPU")
    worst_s, worst_s_name = max((_rel(a, b), n) for n, a, b in
                                zip(stat_names, s_gpu, s_cpu))
    check(worst_s <= 1e-3, f"resnet parity step: running statistic "
                           f"{worst_s_name} differs by {worst_s} of its max")
    for name, a in zip(grad_names, g_gpu):
        check(np.isfinite(a).all(), f"resnet parity step: non-finite {name}")
    flat = lambda gs: np.concatenate([g.ravel() for g in gs])  # noqa: E731
    floor, floor_max, floor_all = np.zeros(len(grad_names)), 0.0, 0.0
    for seed in (5, 6):
        noise = torch.from_numpy(np.random.RandomState(seed).standard_normal(
            tuple(feed["img"].shape)).astype(np.float32))
        _, g_p, _, _ = step("cpu", feed["img"] * (1 + 1e-7 * noise))
        floor = np.maximum(floor, [_rel_l2(a, b) for a, b in zip(g_p, g_cpu)])
        floor_max = max(floor_max, max(_rel(a, b) for a, b in zip(g_p, g_cpu)))
        floor_all = max(floor_all, _rel_l2(flat(g_p), flat(g_cpu)))
    ratios = np.array([_rel_l2(a, b) for a, b in zip(g_gpu, g_cpu)]) \
        / np.maximum(1e-3, RESNET_FLOOR_FACTOR * floor)
    worst, worst_name = float(ratios.max()), grad_names[int(ratios.argmax())]
    all_l2 = _rel_l2(flat(g_gpu), flat(g_cpu))
    worst_max = max(_rel(a, b) for a, b in zip(g_gpu, g_cpu))
    print(f"resnet train parity (float32, TF32 off, {RESNET_PARITY_BATCH} "
          f"images): loss {l_gpu:.6f} card, {l_cpu:.6f} CPU (rtol 1e-4); "
          f"{len(stat_names)} running statistics, worst {worst_s:.3e} of "
          f"max ({worst_s_name}; limit 1e-3); {len(grad_names)} gradients, "
          f"relative L2: the CPU's floor under a 1e-7 change of the images "
          f"median {np.median(floor):.3e} (max |d|/max up to "
          f"{floor_max:.3e}), card vs CPU worst {worst:.3f} of its limit "
          f"({worst_name}; max(1e-3, {RESNET_FLOOR_FACTOR} x floor)), "
          f"max |d|/max up to {worst_max:.3e}; all together {all_l2:.3e}, "
          f"floor {floor_all:.3e} (limit {RESNET_FLOOR_FACTOR} x); step "
          f"{t_gpu:.2f} s card (first), {t_cpu:.2f} s CPU")
    check(worst <= 1.0, f"resnet parity step: {worst_name} differs beyond "
                        f"its limit ({worst})")
    check(all_l2 <= RESNET_FLOOR_FACTOR * floor_all,
          f"resnet parity step: the gradients differ by {all_l2} in L2, "
          f"limit {RESNET_FLOOR_FACTOR * floor_all}")


def _resnet_arm(amp: bool, card: str) -> dict:
    """TRAIN_STEPS steps of one arm on a fixed batch that stays on the card;
    the batch-norm counts are this pass's own."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import batch_norm_train
    from paddle_tpu_torch.tools.train_profile import (
        RESNET_BATCH, RESNET_FP32_BATCH, TRAIN_STEPS, build_resnet_program,
        resnet_batch, resnet_params, train_scope)

    arm = "amp" if amp else "float32"
    n = RESNET_BATCH if amp else RESNET_FP32_BATCH
    loss, main, startup = build_resnet_program(amp)
    exe = fluid.Executor()
    scope = train_scope(exe, startup, main, resnet_params(0))
    feed = resnet_batch(0, n, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in BN_KERNELS:
        batch_norm_train.launches[kern] = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        losses.append(float(out))
        step_ms.append(e0.elapsed_time(e1))
    launches = dict(batch_norm_train.launches)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"resnet {arm}: non-finite losses "
                                    f"{losses}")
    want = RESNET_BN_LAYERS * TRAIN_STEPS
    check(all(launches[k] == want for k in BN_KERNELS),
          f"resnet {arm}: batch-norm launches {launches}, expected "
          f"{RESNET_BN_LAYERS} x {TRAIN_STEPS} each")
    if amp:
        dtypes = {str(v.dtype) for _, v in scope.items()}
        check(dtypes <= {"torch.float32", "torch.int32"},
              f"resnet amp: master state not float32: {dtypes}")
    med = float(np.median(step_ms[1:]))
    cut = "" if n == RESNET_BATCH else f" (cut from {RESNET_BATCH} to fit)"
    print(f"resnet train {arm}: {TRAIN_STEPS} Momentum steps on {n} images"
          f"{cut}, losses {', '.join(f'{x:.5f}' for x in losses)}; step ms "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; median of steps 2-"
          f"{TRAIN_STEPS} {med:.2f} ms = {n / med * 1e3:.1f} images/s; peak "
          f"memory {peak / 2 ** 30:.2f} GiB (max_memory_allocated); "
          f"batch-norm launches {launches} = {RESNET_BN_LAYERS} layers x "
          f"{TRAIN_STEPS} steps; on {card}")
    return {"launches": launches, "losses": losses, "median_ms": med,
            "images_per_s": n / med * 1e3, "batch": n,
            "peak_memory_bytes": peak}


def phase_resnet_train(card: str) -> dict:
    # float32 convolutions in full float32: cuDNN's TF32 default is on (the
    # port's Executor turns it off on the card too)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _resnet_parity(card)
    arms = {}
    for amp in (True, False):
        arms["amp" if amp else "float32"] = _resnet_arm(amp, card)
        torch.cuda.empty_cache()
    return arms


def _conv_bound(kernel: str, n, h, w, c, o, dtype) -> tuple:
    """(bound_ms, bound_by) for one call: x, w (and a, b) read once and the
    output written once; operations are the 2 N H W 9 C O of the nine taps
    at the dtype's peak (bfloat16 on the tensor cores, float32 on the CUDA
    cores), plus, fused, 3 float32 operations an output (scale, shift,
    ReLU)."""
    it = torch.empty((), dtype=dtype).element_size()
    fused = kernel == "fused"
    nbytes = (n * h * w * c + 9 * c * o + n * h * w * o) * it \
        + (2 * o * 4 if fused else 0)
    t_ops = 2.0 * n * h * w * 9 * c * o / PEAK_OPS_PER_S[dtype] \
        + (3.0 * n * h * w * o / PEAK_OPS_PER_S[torch.float32] if fused
           else 0.0)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _conv_case(label, n, h, w, c, o, dtype, dev, card) -> dict:
    """Both kernels against their plain versions on the same inputs; at the
    probe's shapes also the times.  Returns the records by kernel."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import conv as TC

    kind = "float32" if dtype == torch.float32 else "bfloat16"
    name = f"conv {label} [{n},{h},{w},{c}]x{o} {kind}"
    gen = torch.Generator(device=dev)
    gen.manual_seed(n + h * w + c + o)
    x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dtype)
    wt = (torch.randn((3, 3, c, o), generator=gen, device=dev)
          / (9 * c) ** 0.5).to(dtype)
    a = torch.rand(o, generator=gen, device=dev) + 0.5
    b = torch.randn(o, generator=gen, device=dev) * 0.3
    kern = {"igemm": lambda i: TC.igemm_conv_kernel(x, wt),
            "fused": lambda i: TC.igemm_conv_fused_kernel(x, wt, a, b)}
    plain = {"igemm": lambda i: TC.igemm_conv_reference(x, wt),
             "fused": lambda i: TC.igemm_conv_fused_reference(x, wt, a, b)}
    errs = {}
    for k in CONV_KERNELS:
        got = kern[k](0)
        torch.cuda.synchronize()
        want = plain[k](0)
        check(got.dtype == dtype and got.shape == (n, h, w, o),
              f"{name} {k}: kernel returned {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{name} {k}: non-finite kernel output")
        top = float(want.float().abs().max())
        errs[k] = _abs(got, want)
        if kind == "float32":
            worst = errs[k] / (CONV_F32_REL * top)
            lim = f"{CONV_F32_REL} max|out|"
        else:
            worst = _worst(got, want, 2 * BF16_U * want.float().abs()
                           + CONV_BF16_SUM_REL * top)
            lim = f"2u |out| + {CONV_BF16_SUM_REL} max|out| per element"
        print(f"kernel {name} {k}: max|d|={errs[k]:.3e} ({errs[k] / top:.3e} "
              f"of max|out|), worst |d|/limit {worst:.3f} (limit {lim}) "
              f"{'ok' if worst <= 1.0 else 'MISMATCH'}")
        check(worst <= 1.0, f"{name}: {k} kernel disagrees with its plain "
                            f"version ({worst} of its limit)")
        del got, want
    if label not in ("c56", "c28"):
        return {}

    # the yardstick: cuDNN on the same NHWC tensor, seen as a channels_last
    # NCHW view, and on an NCHW copy; the fused form's batch-norm scale and
    # shift and ReLU as separate passes, in the dtype, as the probe's XLA
    # yardstick computes them
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    x_cl = x.permute(0, 3, 1, 2)
    x_nchw = x_cl.contiguous()
    a_r, b_r = a.to(dtype).view(1, -1, 1, 1), b.to(dtype).view(1, -1, 1, 1)
    lib = {
        ("igemm", "channels_last"): lambda i: F.conv2d(x_cl, w_oihw,
                                                       padding=1),
        ("igemm", "nchw"): lambda i: F.conv2d(x_nchw, w_oihw, padding=1),
        ("fused", "channels_last"): lambda i: torch.relu(
            F.conv2d(x_cl, w_oihw, padding=1) * a_r + b_r),
        ("fused", "nchw"): lambda i: torch.relu(
            F.conv2d(x_nchw, w_oihw, padding=1) * a_r + b_r)}
    recs = {}
    for k in CONV_KERNELS:
        ms, dev_ms = both_ms(kern[k])
        pl_ms, pl_dev = both_ms(plain[k], iters=5, warmup=1)
        lib_t = {lay: both_ms(lib[(k, lay)]) for lay in ("channels_last",
                                                         "nchw")}
        want = plain[k](0).float()
        lib_err = _abs(lib[(k, "channels_last")](0).permute(0, 2, 3, 1),
                       want) / float(want.abs().max())
        bound_ms, bound_by = _conv_bound(k, n, h, w, c, o, dtype)
        recs[k] = {
            "max_abs_err": errs[k], "ms": ms, "device_ms": dev_ms,
            "plain_ms": pl_ms, "plain_device_ms": pl_dev,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_t["channels_last"][0],
            "library_device_ms": lib_t["channels_last"][1],
            "library_nchw_ms": lib_t["nchw"][0],
            "library_nchw_device_ms": lib_t["nchw"][1],
            "library": ("F.conv2d (cuDNN)" if k == "igemm" else
                        "F.conv2d (cuDNN), then * a + b and relu as "
                        "separate passes") + " on the channels_last view"}
        print(f"kernel {name} {k}: {ms:.4f} ms (device {dev_ms:.4f}), plain "
              f"{pl_ms:.4f} ms (device {pl_dev:.4f}), cuDNN channels_last "
              f"{lib_t['channels_last'][0]:.4f} ms (device "
              f"{lib_t['channels_last'][1]:.4f}), NCHW "
              f"{lib_t['nchw'][0]:.4f} ms (device {lib_t['nchw'][1]:.4f}; "
              f"its error {lib_err:.3e} of max|out|), bound {bound_ms:.4f} "
              f"ms ({bound_by}; device time {bound_ms / dev_ms:.3f} of it) "
              f"on {card}")
    return recs


def phase_conv_kernels(card: str) -> dict:
    """Every conv case in float32 and bfloat16; returns the timed records
    by dtype, shape and kernel for the JSON line."""
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    torch.backends.cudnn.allow_tf32 = False         # the yardstick
    dev = torch.device("cuda")
    records = {}
    for label, n, h, w, c, o in CONV_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            recs = _conv_case(label, n, h, w, c, o, dtype, dev, card)
            if recs:
                records.setdefault("float32" if dtype == torch.float32
                                   else "bfloat16", {})[label] = recs
            torch.cuda.empty_cache()
    return records


def _softmax_input(program, pred_name: str) -> str:
    (sm,) = [op for op in program.list_ops() if op.type == "softmax"
             and op.outputs["Out"] == [pred_name]]
    return sm.inputs["X"][0]


def _infer_parity(card: str) -> None:
    """ResNet-50's pruned, routed program on INFER_PARITY_BATCH images on
    the card and on the CPU (the plain versions) from the same weights and
    running statistics.  float32 (TF32 off): the fc's pre-softmax logits
    within INFER_F32_REL of max |.|, and the same top-1 class wherever the
    top two are further apart than twice the largest difference (the
    margins are printed).  The card's running statistics are left bitwise
    as loaded.

    amp: a one-rounding element-wise bound (2u |.| + CONV_BF16_SUM_REL
    max |.|) does not hold through 50 bfloat16 layers even for the CPU
    against itself: float32 sums in another order, or images times (1 +
    1e-7 N(0, 1)), flip a bfloat16 rounding here and there, and the flips
    compound (on the CPU alone, such a draw moved the logits by 32, one
    bfloat16 ulp at their largest values and 0.7% of their max, as far as
    the card is from the CPU).  So the bfloat16 logits are held,
    like the ResNet-50 training gradients (_resnet_parity), to the CPU's
    own spread under that change of the images, measured in this run: in
    max |.| and in relative L2 within RESNET_FLOOR_FACTOR x the larger
    spread of two draws (noise seeds 5 and 6), unless they are within the
    element-wise bound anyway."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (build_infer_program,
                                                      infer_arrays,
                                                      infer_batch,
                                                      train_scope)

    arrays = infer_arrays(50)
    feed = infer_batch(INFER_PARITY_BATCH, "cpu")
    stats = sorted(n for n in arrays if n.endswith((".w_mean", ".w_var")))
    ref32 = None   # the CPU's float32 logits, from the first arm
    for amp in (False, True):
        arm = "amp" if amp else "float32"
        pred, program, startup = build_infer_program(50, amp)
        logits = _softmax_input(program, pred.name)
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
            scope = train_scope(exe, startup, program, arrays,
                                None if dev == "cuda" else "cpu")
            t0 = time.perf_counter()
            out[dev] = exe.run(program, feed=feed, fetch_list=[logits],
                               scope=scope)[0]
            secs[dev] = time.perf_counter() - t0
            if dev == "cuda":
                for n in stats:
                    check(np.array_equal(scope.find_var(n).cpu().numpy(),
                                         arrays[n]),
                          f"resnet infer {arm}: running statistic {n} "
                          f"changed")
        floor_max = floor_l2 = 0.0
        if amp:   # the CPU's own spread (see above); exe, scope: the CPU's
            for seed in (5, 6):
                noise = torch.from_numpy(np.random.RandomState(
                    seed).standard_normal(tuple(feed["img"].shape)).astype(
                    np.float32))
                moved = exe.run(program, fetch_list=[logits], scope=scope,
                                feed={"img": feed["img"] * (1 + 1e-7 * noise)}
                                )[0]
                floor_max = max(floor_max,
                                float(np.abs(moved - out["cpu"]).max()))
                floor_l2 = max(floor_l2, _rel_l2(moved, out["cpu"]))
        got, want = out["cuda"], out["cpu"]
        check(got.shape == (INFER_PARITY_BATCH, 1000)
              and np.isfinite(got).all(),
              f"resnet infer parity {arm}: logits {got.shape}, finite "
              f"{np.isfinite(got).all()}")
        top = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if amp:
            worst = float((np.abs(got - want) / (2 * BF16_U * np.abs(want)
                                                 + CONV_BF16_SUM_REL * top)
                           ).max())
            l2 = _rel_l2(got, want)
            floor_ok = (err <= RESNET_FLOOR_FACTOR * floor_max
                        and l2 <= RESNET_FLOOR_FACTOR * floor_l2)
            lim = (f"2u |.| + {CONV_BF16_SUM_REL} max|.| per element; or "
                   f"{RESNET_FLOOR_FACTOR} x the CPU's floor under a 1e-7 "
                   f"change of the images: max|d| {floor_max:.3e}, relative "
                   f"L2 {floor_l2:.3e}, card vs CPU relative L2 {l2:.3e}, "
                   f"within it: {floor_ok}; amp against float32 on the CPU "
                   f"{_rel(want, ref32):.3e} of max")
            ok = worst <= 1.0 or floor_ok
        else:
            worst = err / (INFER_F32_REL * top)
            lim = f"{INFER_F32_REL} max|.|"
            ok = worst <= 1.0
            ref32 = want
        srt = np.sort(want, axis=1)
        margins = srt[:, -1] - srt[:, -2]
        clear = margins > 2 * err
        same = got.argmax(1) == want.argmax(1)
        print(f"resnet infer parity ({arm}{', TF32 off' if not amp else ''}, "
              f"{INFER_PARITY_BATCH} images): logits max|d| {err:.3e} "
              f"({err / top:.3e} of max), worst |d|/limit {worst:.3f} (limit "
              f"{lim}); top-1 equal {same.tolist()}, top-two margins "
              f"{', '.join(f'{m:.3e}' for m in margins)}; step "
              f"{secs['cuda']:.2f} s card (first), {secs['cpu']:.2f} s CPU")
        check(ok, f"resnet infer parity {arm}: logits differ beyond their "
                  f"limit ({worst} of the element-wise bound)")
        if not amp:
            check(bool(same[clear].all()),
                  f"resnet infer parity float32: top-1 differs where the "
                  f"margin exceeds twice the difference: {same}, {margins}")


def _infer_arm(model: str, depth: int, amp: bool, card: str) -> dict:
    """TRAIN_STEPS inference steps of one arm on a batch that stays on the
    card, fetch included; the conv counts are this pass's own."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import conv
    from paddle_tpu_torch.tools.train_profile import (
        INFER_BATCH, TRAIN_STEPS, build_infer_program, infer_arrays,
        infer_batch, train_scope)

    arm = f"{model} {'amp' if amp else 'float32'}"
    pred, program, startup = build_infer_program(depth, amp)
    exe = fluid.Executor()
    scope = train_scope(exe, startup, program, infer_arrays(depth))
    feed = infer_batch(INFER_BATCH, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in CONV_KERNELS:
        conv.launches[k] = 0
    outs, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, = exe.run(program, feed=feed, fetch_list=[pred], scope=scope)
        e1.record()
        torch.cuda.synchronize()
        outs.append(out)
        step_ms.append(e0.elapsed_time(e1))
    launches = dict(conv.launches)
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TRAIN_STEPS for k, v in INFER_LAUNCHES[depth].items()}
    check(launches == want, f"resnet infer {arm}: conv launches {launches}, "
                            f"expected {want}")
    last = outs[-1]
    check(last.shape == (INFER_BATCH, 1000) and np.isfinite(last).all()
          and np.allclose(last.sum(1), 1.0, atol=1e-2),
          f"resnet infer {arm}: predictions {last.shape}, finite "
          f"{np.isfinite(last).all()}, row sums {last.sum(1)[:4]}")
    med = float(np.median(step_ms[1:]))
    print(f"resnet infer {arm}: {TRAIN_STEPS} steps on {INFER_BATCH} images, "
          f"step ms {', '.join(f'{x:.2f}' for x in step_ms)}; median of "
          f"steps 2-{TRAIN_STEPS} {med:.3f} ms = {INFER_BATCH / med * 1e3:.1f}"
          f" images/s; peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated); conv launches {launches}; steps agree "
          f"bitwise: {all(np.array_equal(o, last) for o in outs)}; top-1 of "
          f"the first images {last.argmax(1)[:4].tolist()}; on {card}")
    return {"launches": launches, "median_ms": med,
            "images_per_s": INFER_BATCH / med * 1e3, "batch": INFER_BATCH,
            "peak_memory_bytes": peak}


def phase_resnet_infer(card: str) -> dict:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _infer_parity(card)
    arms = {}
    for model, depth, amp in INFER_ARMS:
        arms[f"{model} {'amp' if amp else 'float32'}"] = _infer_arm(
            model, depth, amp, card)
        torch.cuda.empty_cache()
    return arms


def _timed(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    card = _timed("device", phase_device)
    _timed("build", phase_build)
    rec = _timed("kernels", phase_kernels, card)
    flash = _timed("flash kernels", phase_flash_kernels, card)
    lstm = _timed("lstm kernels", phase_lstm_kernels, card)
    paths = _timed("serve", phase_serve, card)
    train = _timed("train", phase_train, card)
    lstm_train = _timed("lstm train", phase_lstm_train, card)
    bn = _timed("bn kernels", phase_bn_kernels, card)
    resnet = _timed("resnet train", phase_resnet_train, card)
    convk = _timed("conv kernels", phase_conv_kernels, card)
    infer = _timed("resnet infer", phase_resnet_infer, card)
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/paged_attention.py:60",
        "case": "float32 arena, W=1, S=8 H=8 Dh=64 Bs=16 n_tbl=64",
        # launches: the W=1 main path's (mixed pass) own count; each path's
        # count, taken over its own pass alone, is in launches_by_path
        "launches": paths["w1_mixed_pass"]["launches"], **rec,
        "launches_by_path": paths,
    }]
    replaces = {"fwd": "paddle_tpu/ops/attention.py:39",
                "bwd_dkdv": "paddle_tpu/ops/attention.py:223",
                "bwd_dq": "paddle_tpu/ops/attention.py:268"}
    for kern in FLASH_KERNELS:
        kernels.append({
            "name": f"flash_{kern}", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces[kern],
            "case": "float32, N=B*H=64, T=1024, D=64, causal",
            # launches: the training pass's own count (5 steps x 6 layers)
            "launches": train["launches"][kern], **flash[kern],
        })
    replaces = {"fwd": "paddle_tpu/ops/lstm.py:35",
                "bwd": "paddle_tpu/ops/lstm.py:153"}
    for kern in LSTM_KERNELS:
        kernels.append({
            "name": f"fused_lstm_{kern}", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/lstm.cu",
            "replaces": replaces[kern],
            "case": ("float32, T=100, B=128, H=512, no peepholes, lengths "
                     "50-100" + ("" if kern == "fwd" else
                                 "; the whole backward: reverse-recurrence "
                                 "kernel, du matmul, peephole sums")),
            # launches: the lstm training pass's own count (5 steps x 2
            # layers), one call per layer per step, each call T launches
            "launches": lstm_train["launches"][kern], **lstm[kern],
        })
    replaces = {"reduce": "benchmark/bn_probe.py:84",
                "dx": "benchmark/bn_probe.py:126"}
    for kern in BN_KERNELS:
        kernels.append({
            "name": f"bn_bwd_{kern}", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/batch_norm.cu",
            "replaces": replaces[kern],
            "case": "bfloat16 (the probe's and amp's), N=256, C=256, 56x56",
            # launches: the amp arm's own count (bench.py's recipe, 53
            # batch norms x 5 steps); each arm's in launches_by_path
            "launches": resnet["amp"]["launches"][kern],
            **bn["bfloat16"][kern],
            "launches_by_path": {a: r["launches"][kern]
                                 for a, r in resnet.items()},
            "float32": bn["float32"][kern],
        })
    replaces = {"igemm": "benchmark/conv_probe.py:62",
                "fused": "benchmark/conv_probe.py:68"}
    main_arm = {"igemm": "resnet18-infer amp", "fused": "resnet50-infer amp"}
    for kern in CONV_KERNELS:
        kernels.append({
            "name": "conv_igemm" if kern == "igemm" else "conv_igemm_fused",
            "route": "cuda", "source": "paddle_tpu_torch/ops/csrc/conv.cu",
            "replaces": replaces[kern],
            "case": "bfloat16 (amp's), N=256, 56x56, C=O=64 (the probe's "
                    "c56)",
            # launches: the main arm's own count (resnet18-infer for the
            # plain kernel, resnet50-infer amp for the fused one); each
            # arm's in launches_by_path
            "launches": infer[main_arm[kern]]["launches"][kern],
            **convk["bfloat16"]["c56"][kern],
            "launches_by_path": {a: r["launches"][kern]
                                 for a, r in infer.items()},
            "c28": convk["bfloat16"]["c28"][kern],
            "float32": convk["float32"]["c56"][kern],
            "float32_c28": convk["float32"]["c28"][kern],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
