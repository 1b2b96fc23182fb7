"""Where the time of one training step goes, on the CUDA card.

    python3 -m paddle_tpu_torch.tools.train_profile [--model lm|text_lstm] [--out F]

``--model lm`` (the default) builds the Transformer-base LM (V=32000,
T=1024, d=512, 8 heads, 6 layers, d_ff=2048, tied, float32, weights
``init_lm_params(0)``) with ``build_lm``, Adam(1e-3) and global-norm
clipping (1.0), on a fixed 8 x 1024 batch.  ``--model text_lstm`` builds
the LSTM text classifier at the width of ``benchmark/text_lstm.py`` (vocab
10000, emb 128, 2 x LSTM-512, 2 classes, seq_len 100, float32, weights
``init_text_lstm_params(0)``) with Adam(1e-3), on a fixed batch of 128
sequences with lengths drawn from [50, 100] (that file's
``synthetic_feed``).  Either way: two warm-up steps, then, 3 times over, 5
``Executor.run`` steps on the host clock and 5 more under
``torch.profiler``.  Prints per step: host wall ms (unprofiled windows)
and device busy ms (the sum of kernel times, profiled windows), each as
the median with the least and the most of the repeats, the device idle
share of the medians, device ms by kernel class (flash attention / lstm /
matmul / other) and the top kernels, both from the median-busy window.
``--out`` also writes the numbers as JSON.

The programs, weights and batches are the ones ``chip_smoke.py``'s train
phases run (:func:`build_train_program`, :func:`build_text_lstm_program`,
:func:`train_scope`, :func:`train_batch`, :func:`text_lstm_params`,
:func:`text_lstm_batch`), so the profiled step is the smoke-checked step.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .decode_profile import LM_CFG, _kernel_us, _spread

TRAIN_BATCH = 8     # sequences of LM_CFG["max_len"] tokens per step
TRAIN_STEPS = 5
REPEATS = 3         # profiled windows, for the median and spread
# benchmark/text_lstm.py at bs=128, hidden_size=512, lstm_num=2
TEXT_LSTM_CFG = dict(vocab_size=10000, emb_dim=128, hidden=512, num_layers=2,
                     class_dim=2)
TEXT_LSTM_SEQ = 100
TEXT_LSTM_BATCH = 128


def build_train_program():
    """``build_lm`` at LM_CFG's width with Adam(1e-3) and global-norm
    clipping (1.0), in fresh default programs; returns (loss, main,
    startup)."""
    import paddle_tpu_torch as fluid

    T = LM_CFG["max_len"]
    fluid.reset_default_programs()
    toks = fluid.layers.data("toks", [T], dtype="int32")
    labs = fluid.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fluid.models.build_lm(toks, labs, **LM_CFG)
    fluid.optimizer.Adam(
        1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(
        loss)
    return loss, fluid.default_main_program(), fluid.default_startup_program()


def build_text_lstm_program():
    """``models.text_lstm.build`` at TEXT_LSTM_CFG's width over padded
    sequences of TEXT_LSTM_SEQ ids, with Adam(1e-3), in fresh default
    programs; returns (loss, main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    words = fluid.layers.data("words", [TEXT_LSTM_SEQ], dtype="int32")
    lengths = fluid.layers.data("lengths", [-1], dtype="int32",
                                append_batch_size=False)
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, _ = fluid.models.text_lstm.build(words, lengths, label,
                                              **TEXT_LSTM_CFG)
    fluid.optimizer.Adam(1e-3).minimize(loss)
    return loss, fluid.default_main_program(), fluid.default_startup_program()


def text_lstm_params(seed: int = 0) -> dict:
    """The text classifier's weights as numpy arrays, from ``seed``."""
    from ..models import init_text_lstm_params

    return init_text_lstm_params(seed, **TEXT_LSTM_CFG)


def text_lstm_batch(seed: int, n: int = TEXT_LSTM_BATCH) -> dict:
    """``n`` sequences as ``benchmark/text_lstm.py``'s ``synthetic_feed``
    draws them from ``RandomState(seed)``: ids, lengths in [T/2, T], binary
    labels."""
    rng = np.random.RandomState(seed)
    T, V = TEXT_LSTM_SEQ, TEXT_LSTM_CFG["vocab_size"]
    return {"words": rng.randint(0, V, (n, T)).astype(np.int32),
            "lengths": rng.randint(T // 2, T + 1, (n,)).astype(np.int32),
            "label": rng.randint(0, 2, (n, 1)).astype(np.int32)}


def train_scope(exe, startup, main, params, device=None):
    """A new scope with the startup program run by ``exe`` and ``params``
    (numpy arrays by name) loaded over it on ``device``."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.load_scope(params, main, scope, device=device)
    return scope


def train_batch(seed: int, n: int = TRAIN_BATCH) -> dict:
    """``n`` sequences of random tokens and labels from ``seed``."""
    rng = np.random.RandomState(seed)
    T, V = LM_CFG["max_len"], LM_CFG["vocab_size"]
    return {"toks": rng.randint(0, V, (n, T)).astype(np.int32),
            "labs": rng.randint(0, V, (n, T, 1)).astype(np.int32)}


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_" in low:
        return "flash_attention"
    if "lstm_" in low:
        return "lstm"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "matmul", "gemv")):
        return "matmul"
    return "other"


def _recipe(model: str):
    """(loss, main, startup, weights, feed, items per step, item unit)."""
    import paddle_tpu_torch as fluid

    if model == "lm":
        return (*build_train_program(), fluid.init_lm_params(0, **LM_CFG),
                train_batch(3), TRAIN_BATCH * LM_CFG["max_len"], "tokens")
    if model == "text_lstm":
        return (*build_text_lstm_program(), text_lstm_params(0),
                text_lstm_batch(0), TEXT_LSTM_BATCH, "sequences")
    raise ValueError(f"unknown model {model!r}: lm | text_lstm")


def profile(model: str = "lm") -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import paddle_tpu_torch as fluid

    if not torch.cuda.is_available():
        raise RuntimeError("train_profile needs a CUDA card")
    steps, repeats = TRAIN_STEPS, REPEATS
    loss, main, startup, weights, feed, items, unit = _recipe(model)
    exe = fluid.Executor()
    scope = train_scope(exe, startup, main, weights)

    def run(n):
        for _ in range(n):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    run(2)
    walls, windows = [], []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            run(steps)
            torch.cuda.synchronize()
        by_class = {"flash_attention": 0.0, "lstm": 0.0, "matmul": 0.0,
                    "other": 0.0}
        kernels = []
        for evt in prof.key_averages():
            us = _kernel_us(evt)
            if us <= 0:
                continue
            kernels.append((us, evt.key, evt.count))
            by_class[_kernel_class(evt.key)] += us
        kernels.sort(reverse=True)
        windows.append((sum(by_class.values()) / 1e3 / steps, by_class,
                        kernels))
    busy = [w[0] for w in windows]
    wall_ms, busy_ms = float(np.median(walls)), float(np.median(busy))
    _, by_class, kernels = sorted(windows, key=lambda w: w[0])[
        (repeats - 1) // 2]
    return {
        "card": fluid.card_info(0), "model": model, "steps": steps,
        "repeats": repeats, "unit": unit, f"{unit}_per_step": items,
        "wall_ms_per_step": _spread(walls),
        "device_busy_ms_per_step": _spread(busy),
        "device_idle_share": (1.0 - busy_ms / wall_ms) if wall_ms else None,
        f"{unit}_per_s": items / wall_ms * 1e3,
        "device_ms_per_step_by_class": {k: v / 1e3 / steps
                                        for k, v in by_class.items()},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                         "calls_per_step": c / steps}
                        for us, n, c in kernels[:15]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="lm", choices=("lm", "text_lstm"),
                    help="the training step to profile")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    res = profile(args.model)
    wall, busy = res["wall_ms_per_step"], res["device_busy_ms_per_step"]
    unit = res["unit"]
    print(f"{res['model']} train step on {res['card']}: "
          f"{res[unit + '_per_step']} {unit}, {res['repeats']} repeats of "
          f"{res['steps']} steps; wall median {wall['median']:.3f} ms/step "
          f"(min {wall['min']:.3f}, max {wall['max']:.3f}) = "
          f"{res[unit + '_per_s']:.0f} {unit}/s, device "
          f"busy median {busy['median']:.3f} ms/step (min {busy['min']:.3f}, "
          f"max {busy['max']:.3f}), idle share "
          f"{res['device_idle_share']:.3f}")
    for k, v in res["device_ms_per_step_by_class"].items():
        print(f"  {k:16s} {v:.4f} ms/step")
    for k in res["top_kernels"]:
        print(f"  {k['ms_per_step']:.4f} ms/step x{k['calls_per_step']:7.1f} "
              f"{k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
