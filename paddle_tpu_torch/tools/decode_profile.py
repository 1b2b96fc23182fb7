"""Where the time of one continuous-decode step goes, on the CUDA card.

    python3 -m paddle_tpu_torch.tools.decode_profile [--steps 20]
        [--repeats 5] [--out F]

Serves the Transformer-base LM (V=32000, d=512, 8 heads, 6 layers,
d_ff=2048, float32, random weights from seed 0; max_len 1024, block 16,
8 slots), warmed first (``ContinuousDecodeEngine.warm``: every step and
prefill is a CUDA graph replay), with all 8 slots busy, then,
``--repeats`` times over, records ``--steps`` scheduler steps (each one
W=1 decode dispatch) on the host clock and ``--steps`` more under
``torch.profiler`` (whose own host cost would inflate the wall time).
Prints the signatures warmed and, per step: host wall ms (unprofiled
windows), split into the engine call (staging the inputs, the replay and
the wait for its read back) and the scheduler's own host work around it,
and device busy ms (the sum of kernel times, profiled windows), each as the
median with the least and the most of the repeats, the device idle share of
the medians, device ms by kernel class (paged attention / matmul / other)
and the top kernels, both from the median-busy window.  Raises when the
profiler sees no kernel under the replays, rather than report an idle
share of 1.  ``--out`` also writes the numbers as JSON.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

LM_CFG = dict(vocab_size=32000, max_len=1024, d_model=512, n_heads=8,
              n_layers=6, d_ff=2048)


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "paged_split_kernel" in low or "paged_combine_kernel" in low:
        return "paged_attention"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "matmul", "gemv")):
        return "matmul"
    return "other"


def _kernel_us(evt) -> float:
    """Device microseconds of a kernel row; 0 for CPU-op rows and for the
    device rows of ``record_function`` ranges, whose device time repeats
    that of the kernels they enclose."""
    if "CUDA" not in str(getattr(evt, "device_type", "")) \
            or getattr(evt, "is_user_annotation", False):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs)), "all": [float(x) for x in xs]}


def profile(steps: int = 20, prompt_len: int = 256, repeats: int = 5) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from paddle_tpu_torch import (ContinuousDecodeEngine, ContinuousScheduler,
                                  card_info, init_lm_params)

    if not torch.cuda.is_available():
        raise RuntimeError("decode_profile needs a CUDA card")
    eng = ContinuousDecodeEngine(init_lm_params(0, **LM_CFG), n_slots=8,
                                 block_size=16, dtype="float32", **LM_CFG)
    t0 = time.perf_counter()
    n_sig = eng.warm()
    warm_s = time.perf_counter() - t0
    sched = ContinuousScheduler(eng)
    # the engine call of each step, timed apart from the scheduler's host
    # work around it
    engine_s = [0.0]
    step_tokens = eng.step_tokens

    def timed_step_tokens(*args, **kwargs):
        t = time.perf_counter()
        out = step_tokens(*args, **kwargs)
        engine_s[0] += time.perf_counter() - t
        return out

    eng.step_tokens = timed_step_tokens
    rng = np.random.RandomState(2)
    budget = 2 * steps * repeats + 16
    for _ in range(eng.n_slots):
        sched.submit(rng.randint(2, LM_CFG["vocab_size"], prompt_len)
                     .astype(np.int32), budget)
    for _ in range(8):           # admit everyone, then settle
        sched.step()
    active = sum(1 for s in sched._slots if s is not None)
    traces = eng.trace_count()
    walls, engine_ms, windows = [], [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        engine_s[0] = 0.0
        t0 = time.perf_counter()
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
        engine_ms.append(engine_s[0] * 1e3 / steps)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                sched.step()
            torch.cuda.synchronize()
        by_class = {"paged_attention": 0.0, "matmul": 0.0, "other": 0.0}
        kernels = []
        for evt in prof.key_averages():
            us = _kernel_us(evt)
            if us <= 0:
                continue
            kernels.append((us, evt.key, evt.count))
            by_class[_kernel_class(evt.key)] += us
        if not kernels:
            raise RuntimeError("torch.profiler saw no kernel in the replayed "
                               "steps: device busy time not measured")
        kernels.sort(reverse=True)
        windows.append((sum(by_class.values()) / 1e3 / steps, by_class,
                        kernels))
    if any(s is None for s in sched._slots):
        raise RuntimeError("a slot retired inside the measured windows")
    if eng.trace_count() != traces or not eng.replays:
        raise RuntimeError("the measured steps were not all graph replays")
    busy = [w[0] for w in windows]
    wall_ms, busy_ms = float(np.median(walls)), float(np.median(busy))
    _, by_class, kernels = sorted(windows, key=lambda w: w[0])[
        (repeats - 1) // 2]
    return {
        "card": card_info(0), "steps": steps, "repeats": repeats,
        "active_slots": active, "prompt_len": prompt_len,
        "signatures_warmed": n_sig, "warm_s": warm_s,
        "wall_ms_per_step": _spread(walls),
        "engine_call_ms_per_step": _spread(engine_ms),
        "scheduler_host_ms_per_step": _spread(
            [w - e for w, e in zip(walls, engine_ms)]),
        "device_busy_ms_per_step": _spread(busy),
        "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        "device_ms_per_step_by_class": {k: v / 1e3 / steps
                                        for k, v in by_class.items()},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                         "calls": c} for us, n, c in kernels[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    res = profile(args.steps, repeats=args.repeats)
    wall, busy = res["wall_ms_per_step"], res["device_busy_ms_per_step"]
    eng, host = (res["engine_call_ms_per_step"],
                 res["scheduler_host_ms_per_step"])
    print(f"decode step on {res['card']}: {res['signatures_warmed']} "
          f"signatures warmed as CUDA graphs in {res['warm_s']:.1f} s; "
          f"{res['active_slots']} active "
          f"slots, {res['repeats']} repeats of {res['steps']} steps; wall "
          f"median {wall['median']:.3f} ms/step (min {wall['min']:.3f}, max "
          f"{wall['max']:.3f}), device busy median {busy['median']:.3f} "
          f"ms/step (min {busy['min']:.3f}, max {busy['max']:.3f}), idle "
          f"share {res['device_idle_share']:.3f}; of the wall, the engine "
          f"call (stage, replay, read back) median {eng['median']:.3f} "
          f"ms/step, the scheduler's host work {host['median']:.3f}")
    for k, v in res["device_ms_per_step_by_class"].items():
        print(f"  {k:16s} {v:.4f} ms/step")
    for k in res["top_kernels"]:
        print(f"  {k['ms_per_step']:.4f} ms/step x{k['calls']:5d} "
              f"{k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
