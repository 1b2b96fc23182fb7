#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving and training paths on one CUDA card and
check them.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero, before the final line):
  1. device  - require CUDA; print the card's name and power limit and the
               torch / CUDA versions;
  2. build   - build the hand-written kernels from ops/csrc with nvcc, one
               nvcc per source, all started together;
  3. kernels - hold each kernel against its plain PyTorch version on the
               card (paged attention at the serving shapes; the three flash
               kernels at the training shape in float32 and bfloat16, a
               rectangular non-causal and a ragged causal case), and time
               kernel, plain version and the library yardstick
               (scaled_dot_product_attention, which the port never calls);
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
               falling, ms per step and tokens/s.
The line before the card line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
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
KERNEL_SOURCES = ("paged_attention.cu", "flash_attention.cu")
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
    print(f"build: all sources ready in {time.perf_counter() - t0:.2f} s")


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

            ms = cuda_ms(run_kernel)
            plain_ms = cuda_ms(run_plain)
            library_ms = cuda_ms(run_library)
            bound_ms, bound_by = _bound(kind, W, q, lengths)
            print(f"kernel paged_attention {kind} W={W}: {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}) on {card}")
            del kc, vc
            if kind == "float32" and W == 1:
                record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms}
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
    ms = {"fwd": cuda_ms(lambda i: TA.flash_fwd_kernel(q, k, v, scale, True)),
          "bwd_dkdv": cuda_ms(lambda i: TA.flash_bwd_dkdv_kernel(*bwd_args)),
          "bwd_dq": cuda_ms(lambda i: TA.flash_bwd_dq_kernel(*bwd_args))}
    plain = {
        "fwd": cuda_ms(lambda i: TA._fwd_reference(q, k, v, scale, True),
                       iters=10),
        "bwd_dkdv": cuda_ms(lambda i: TA._bwd_dkdv_blockwise(*bwd_args, 128),
                            iters=10),
        "bwd_dq": cuda_ms(lambda i: TA._bwd_dq_blockwise(*bwd_args, 128),
                          iters=10)}
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

    lib_fwd = cuda_ms(sdpa_fwd)
    lib_bwd = cuda_ms(sdpa_fwd_bwd, iters=10) - cuda_ms(sdpa_train_fwd)
    recs = {}
    for kern in FLASH_KERNELS:
        bound_ms, bound_by = _flash_bound(kern, N, Tq, Tk, D, causal, dtype)
        # no PyTorch call computes dk/dv alone or dq alone: the backward
        # kernels have no library time of their own (the pair's is below)
        recs[kern] = {
            "max_abs_err": errs[kern], "ms": ms[kern],
            "plain_ms": plain[kern], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_fwd if kern == "fwd" else None}
        lib = (f"sdpa {lib_fwd:.4f} ms" if kern == "fwd"
               else "no library call of its own")
        print(f"kernel flash {kern} {kind} train shape: {ms[kern]:.4f} ms, "
              f"plain {plain[kern]:.4f} ms, {lib}, bound {bound_ms:.4f} ms "
              f"({bound_by}) on {card}")
    print(f"kernel flash {kind} train shape: the two backward kernels "
          f"together {ms['bwd_dkdv'] + ms['bwd_dq']:.4f} ms, their plain "
          f"versions {plain['bwd_dkdv'] + plain['bwd_dq']:.4f} ms, sdpa "
          f"backward (dq, dk and dv; forward + backward less forward) "
          f"{lib_bwd:.4f} ms on {card}")
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


def main() -> int:
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    card = phase_device()
    phase_build()
    rec = phase_kernels(card)
    flash = phase_flash_kernels(card)
    paths = phase_serve(card)
    train = phase_train(card)
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
