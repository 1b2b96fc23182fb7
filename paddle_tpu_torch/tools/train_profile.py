"""Where the time of one training step goes, on the CUDA card.

    python3 -m paddle_tpu_torch.tools.train_profile [--model lm|text_lstm|resnet50|resnet50-infer|resnet18-infer] [--out F]

``--model lm`` (the default) builds the Transformer-base LM (V=32000,
T=1024, d=512, 8 heads, 6 layers, d_ff=2048, tied, float32, weights
``init_lm_params(0)``) with ``build_lm``, Adam(1e-3) and global-norm
clipping (1.0), on a fixed 8 x 1024 batch.  ``--model text_lstm`` builds
the LSTM text classifier at the width of ``benchmark/text_lstm.py`` (vocab
10000, emb 128, 2 x LSTM-512, 2 classes, seq_len 100, float32, weights
``init_text_lstm_params(0)``) with Adam(1e-3), on a fixed batch of 128
sequences with lengths drawn from [50, 100] (that file's
``synthetic_feed``).  ``--model resnet50`` builds ResNet-50 as ``bench.py``
trains it (``models.resnet.build``, 1000 classes, Momentum(0.1, 0.9),
weights ``init_resnet_params(0)``) on a fixed batch of 224x224 images that
stays on the card, in two arms: amp (bf16 compute, bs=256) and float32
(TF32 off, bs=``RESNET_FP32_BATCH``).  ``--model resnet50-infer`` and
``--model resnet18-infer`` profile the inference step instead: the
``is_test`` program that ``benchmark/resnet.py``'s infer configs prune to
(``build`` at depth 50 or 18, 1000 classes, ``Program.prune`` to the
prediction), weights ``init_resnet_params(0)`` and running statistics
``init_resnet_stats(0)``, ``INFER_BATCH`` images from ``rand`` of numpy
seed 0 (``benchmark/_common.py``'s draw) that stay on the card, the
prediction fetched each step; ResNet-50 in the amp and the float32 arm,
ResNet-18 under amp.  Either way: two warm-up steps, then,
3 times over, 5 ``Executor.run`` steps on the host clock and 5 more under
``torch.profiler``.  Prints per step: host wall ms (unprofiled windows)
and device busy ms (the sum of kernel times, profiled windows), each as
the median with the least and the most of the repeats, the device idle
share of the medians, device ms by kernel class and the top kernels, both
from the median-busy window.  The classes are flash attention / lstm /
matmul / other by kernel name; for ResNet they are cuDNN convolution
(forward, data gradient, weight gradient, other backward), the batch-norm
backward kernels, the batch-norm forward's plain ops, the rest of the
batch-norm backward, pooling, the optimizer and other, by the op or
autograd node that launched each kernel (the profiled windows wrap each op
in a ``record_function`` range; the unprofiled ones run the program as
it is); for the inference step they are the fused conv + BN + ReLU kernel,
the plain implicit-GEMM kernel, the routed ops' filter layout and BN
folding, cuDNN convolution, the batch norms that stay plain ops, pooling
and other.  ``--out`` also writes the numbers as JSON.

The programs, weights and batches are the ones ``chip_smoke.py``'s train
and resnet infer phases run (:func:`build_train_program`,
:func:`build_text_lstm_program`, :func:`build_resnet_program`,
:func:`build_infer_program`, :func:`train_scope`, :func:`train_batch`,
:func:`text_lstm_params`, :func:`text_lstm_batch`, :func:`resnet_params`,
:func:`resnet_batch`, :func:`infer_arrays`, :func:`infer_batch`), so the
profiled step is the smoke-checked step.
"""
from __future__ import annotations

import argparse
import json
import re
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
# bench.py's ResNet-50 recipe: bs=256, Momentum(0.1, 0.9), amp by default
RESNET_CFG = dict(depth=50, class_dim=1000)
RESNET_IMAGE = (3, 224, 224)
RESNET_BATCH = 256
RESNET_FP32_BATCH = 256
# benchmark/resnet.py's infer configs at the bs=256 of its docstring's
# command: model name -> depth
INFER_DEPTH = {"resnet50-infer": 50, "resnet18-infer": 18}
INFER_BATCH = 256


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


def build_resnet_program(amp: bool):
    """``models.resnet.build`` at RESNET_CFG (ResNet-50, 1000 classes) over
    NCHW float32 images with Momentum(0.1, 0.9), then ``amp.enable()`` when
    ``amp``, as ``bench.py`` builds it, in fresh default programs; returns
    (loss, main, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    img = fluid.layers.data("img", list(RESNET_IMAGE))
    label = fluid.layers.data("label", [1], dtype="int32")
    loss, _, _ = fluid.models.resnet.build(img, label, **RESNET_CFG)
    fluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    if amp:
        fluid.amp.enable()
    return loss, fluid.default_main_program(), fluid.default_startup_program()


def build_infer_program(depth: int, amp: bool):
    """``models.resnet.build`` at ``depth`` (1000 classes) over NCHW float32
    224x224 images, ``amp.enable()`` when ``amp``, pruned to the prediction
    as ``benchmark/resnet.py``'s infer configs are, in fresh default
    programs; returns (prediction, pruned program, startup)."""
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    img = fluid.layers.data("img", list(RESNET_IMAGE))
    label = fluid.layers.data("label", [1], dtype="int32")
    _, _, pred = fluid.models.resnet.build(
        img, label, class_dim=RESNET_CFG["class_dim"], depth=depth)
    if amp:
        fluid.amp.enable()
    return (pred, fluid.default_main_program().prune([pred]),
            fluid.default_startup_program())


def infer_arrays(depth: int, seed: int = 0) -> dict:
    """ResNet's parameters and running statistics at ``depth`` as numpy
    arrays, from ``seed``."""
    from ..models import init_resnet_params, init_resnet_stats

    out = init_resnet_params(seed, depth, RESNET_CFG["class_dim"])
    out.update(init_resnet_stats(seed, depth, RESNET_CFG["class_dim"]))
    return out


def infer_batch(n: int, device, seed: int = 0) -> dict:
    """``n`` images as ``benchmark/_common.py`` draws them (``rand`` of
    ``RandomState(seed)``), as a tensor on ``device``."""
    rng = np.random.RandomState(seed)
    img = rng.rand(n, *RESNET_IMAGE).astype(np.float32)
    return {"img": torch.from_numpy(img).to(device)}


def resnet_params(seed: int = 0) -> dict:
    """ResNet-50's parameters as numpy arrays, from ``seed``."""
    from ..models import init_resnet_params

    return init_resnet_params(seed, **RESNET_CFG)


def resnet_batch(seed: int, n: int, device) -> dict:
    """``n`` images N(0, 1) and labels in [0, class_dim) from
    ``RandomState(seed)``, as tensors on ``device``: a synthetic batch that
    stays there, as ``bench.py``'s does."""
    rng = np.random.RandomState(seed)
    img = rng.standard_normal((n,) + RESNET_IMAGE).astype(np.float32)
    label = rng.randint(0, RESNET_CFG["class_dim"], (n, 1)).astype(np.int32)
    return {"img": torch.from_numpy(img).to(device),
            "label": torch.from_numpy(label).to(device)}


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


# ResNet kernel classes: by the op (record_function range "op::<type>")
# or autograd node that launched each kernel, then by the kernel's name
RESNET_CLASSES = ("conv_fwd", "conv_dgrad", "conv_wgrad", "conv_bwd_other",
                  "bn_bwd_kernels", "bn_fwd_plain", "bn_bwd_other", "pool",
                  "optimizer", "other")
_OP_CLASS = {"conv2d": "conv_fwd", "batch_norm": "bn_fwd_plain",
             "pool2d": "pool", "momentum": "optimizer",
             "increment": "optimizer"}
_NODE = "autograd::engine::evaluate_function: "


def _resnet_class(kernel: str, ancestors) -> str:
    """The class of a kernel launched under ``ancestors`` (the names of the
    enclosing host ranges, innermost first)."""
    low = kernel.lower()
    if "bn_bwd_" in low:
        return "bn_bwd_kernels"
    for a in ancestors:
        if a.startswith("op::"):
            return _OP_CLASS.get(a[4:], "other")
        if a.startswith(_NODE):
            node = a[len(_NODE):]
            if "Convolution" in node:
                return ("conv_wgrad" if "wgrad" in low else
                        "conv_dgrad" if "dgrad" in low else "conv_bwd_other")
            if "BatchNormTrain" in node:
                return "bn_bwd_other"
            if "Pool" in node:
                return "pool"
            return "other"
    return "other"


# ResNet inference kernel classes: the hand-written conv kernels by name,
# then by the op that launched each kernel; the routed ops' own small
# kernels (filter to HWIO, the folded BN's a and b) are "conv_prep"
INFER_CLASSES = ("fused_kernel", "igemm_kernel", "conv_prep", "conv_cudnn",
                 "bn_plain", "pool", "other")


def _igemm_class(kernel: str):
    """"fused_kernel" or "igemm_kernel" for an ``igemm_kernel<T, kFused,
    V>`` instance of ``ops/csrc/conv.cu`` by its name, else None."""
    m = re.search(r"igemm_kernel<[^,<>]+, (true|false)", kernel)
    if m is None:
        return None
    return "fused_kernel" if m.group(1) == "true" else "igemm_kernel"


def _infer_class(kernel: str, ancestors) -> str:
    low = kernel.lower()
    mine = _igemm_class(kernel)
    if mine is not None:
        return mine
    for a in ancestors:
        if not a.startswith("op::"):
            continue
        op = a[4:]
        if op == "conv2d_bn_relu":
            return "conv_prep"
        if op == "conv2d":
            return ("conv_prep" if "copy" in low or "elementwise" in low
                    else "conv_cudnn")
        return {"batch_norm": "bn_plain", "pool2d": "pool"}.get(op, "other")
    return "other"


def _classes_by_origin(prof, classes, classify) -> dict:
    """Device microseconds by class: each host event's kernels, classified
    by ``classify(kernel name, enclosing host range names)``."""
    out = {k: 0.0 for k in classes}
    for evt in prof.events():
        kernels = getattr(evt, "kernels", None) or []
        if not kernels:
            continue
        names, parent = [evt.name], evt.cpu_parent
        while parent is not None:
            names.append(parent.name)
            parent = parent.cpu_parent
        for k in kernels:
            out[classify(k.name, names)] += float(k.duration)
    return out


class _OpRanges:
    """While entered, every op (the routed ops of an inference step too)
    runs inside a ``record_function("op::<type>")`` range, so a profile can
    tell which op launched a kernel."""

    def __enter__(self):
        from torch.profiler import record_function

        from ..core.program import Op

        self._apply = Op.apply

        def apply(op, env, ctx, _apply=self._apply):
            with record_function(f"op::{op.type}"):
                _apply(op, env, ctx)
        Op.apply = apply
        return self

    def __exit__(self, *exc):
        from ..core.program import Op

        Op.apply = self._apply


def _recipe(model: str, amp: bool = True):
    """(fetch, main, startup, weights, feed, items per step, item unit)."""
    import paddle_tpu_torch as fluid

    if model == "lm":
        return (*build_train_program(), fluid.init_lm_params(0, **LM_CFG),
                train_batch(3), TRAIN_BATCH * LM_CFG["max_len"], "tokens")
    if model == "text_lstm":
        return (*build_text_lstm_program(), text_lstm_params(0),
                text_lstm_batch(0), TEXT_LSTM_BATCH, "sequences")
    if model == "resnet50":
        n = RESNET_BATCH if amp else RESNET_FP32_BATCH
        return (*build_resnet_program(amp), resnet_params(0),
                resnet_batch(0, n, "cuda"), n, "images")
    if model in INFER_DEPTH:
        depth = INFER_DEPTH[model]
        return (*build_infer_program(depth, amp), infer_arrays(depth),
                infer_batch(INFER_BATCH, "cuda"), INFER_BATCH, "images")
    raise ValueError(f"unknown model {model!r}: lm | text_lstm | resnet50 | "
                     f"{' | '.join(INFER_DEPTH)}")


def profile(model: str = "lm", amp: bool = True) -> dict:
    """The profile of ``model``'s step (for the ResNets the amp arm, or with
    ``amp=False`` the float32 arm)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import paddle_tpu_torch as fluid

    if not torch.cuda.is_available():
        raise RuntimeError("train_profile needs a CUDA card")
    steps, repeats = TRAIN_STEPS, REPEATS
    exe = fluid.Executor()            # TF32 off for float32 matmuls and convs
    fetch, main, startup, weights, feed, items, unit = _recipe(model, amp)
    scope = train_scope(exe, startup, main, weights)
    resnet = model == "resnet50" or model in INFER_DEPTH

    def run(n):
        for _ in range(n):
            exe.run(main, feed=feed, fetch_list=[fetch], scope=scope)

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
            if resnet:
                with _OpRanges():
                    run(steps)
            else:
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
        busy_us = sum(by_class.values())
        if resnet:
            infer = model in INFER_DEPTH
            by_class = _classes_by_origin(
                prof, INFER_CLASSES if infer else RESNET_CLASSES,
                _infer_class if infer else _resnet_class)
            if infer:
                # a ctypes launch has no host event above its kernel: the
                # conv kernels are counted by name
                for cls in ("fused_kernel", "igemm_kernel"):
                    by_class[cls] = sum(us for us, name, _ in kernels
                                        if _igemm_class(name) == cls)
            # kernels the event tree did not reach count as other
            by_class["other"] += busy_us - sum(by_class.values())
        windows.append((busy_us / 1e3 / steps, by_class, kernels))
    busy = [w[0] for w in windows]
    wall_ms, busy_ms = float(np.median(walls)), float(np.median(busy))
    _, by_class, kernels = sorted(windows, key=lambda w: w[0])[
        (repeats - 1) // 2]
    return {
        "card": fluid.card_info(0), "model": model, "steps": steps,
        "arm": ("amp" if amp else "float32") if resnet else "float32",
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
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
    ap.add_argument("--model", default="lm",
                    choices=("lm", "text_lstm", "resnet50", *INFER_DEPTH),
                    help="the training step to profile (resnet50: both "
                         "arms, amp then float32), or the ResNet inference "
                         "step (resnet50-infer: both arms; resnet18-infer: "
                         "amp)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    arms = ((True, False) if args.model in ("resnet50", "resnet50-infer")
            else (True,))
    results = []
    for amp in arms:
        torch.cuda.reset_peak_memory_stats()
        res = profile(args.model, amp)
        results.append(res)
        wall, busy = res["wall_ms_per_step"], res["device_busy_ms_per_step"]
        unit = res["unit"]
        arm = f" ({res['arm']})" if args.model.startswith("resnet") else ""
        what = "inference" if args.model in INFER_DEPTH else "train"
        print(f"{res['model']}{arm} {what} step on {res['card']}: "
              f"{res[unit + '_per_step']} {unit}, {res['repeats']} repeats "
              f"of {res['steps']} steps; wall median {wall['median']:.3f} "
              f"ms/step (min {wall['min']:.3f}, max {wall['max']:.3f}) = "
              f"{res[unit + '_per_s']:.1f} {unit}/s, device busy median "
              f"{busy['median']:.3f} ms/step (min {busy['min']:.3f}, max "
              f"{busy['max']:.3f}), idle share "
              f"{res['device_idle_share']:.3f}, peak memory "
              f"{res['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
        for k, v in res["device_ms_per_step_by_class"].items():
            print(f"  {k:16s} {v:.4f} ms/step")
        for k in res["top_kernels"]:
            print(f"  {k['ms_per_step']:.4f} ms/step "
                  f"x{k['calls_per_step']:7.1f} {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results if len(results) > 1 else results[0], f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
