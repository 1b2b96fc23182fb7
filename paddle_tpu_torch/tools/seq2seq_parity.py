"""Where the seq2seq parity step's card-against-CPU gradient limit lies.

``chip_smoke.py``'s seq2seq train phase holds one train step on the card
against the same step on the CPU (the plain versions), gradient by
gradient, as max |d| / max |g|.  This tool measures, on that step (the
program, weights and batch of the phase), the readings that place that
limit:

- the card's float32 step (TF32 off, as the port runs it) against the CPU;
- the CPU's own spread: the CPU step again with every weight moved by a
  relative 1e-7 (N(0, 1) draws from SPREAD_SEEDS numpy seeds), against
  the CPU step;
- a lower-precision control: the card's step with TF32 on for matmuls and
  convolutions, against the CPU.

A limit that passes the float32 step and fails the control sits above the
spread and below the control.  Run on a CUDA card::

    python -m paddle_tpu_torch.tools.seq2seq_parity [--out F]

It prints, and writes to ``--out`` when given, one JSON object: the card
(name and power limit), the losses, and for each gradient its max |g| on
the CPU and the readings above.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# the parity signature of chip_smoke.py's seq2seq train phase: its batch
# and the seed of its sentence pairs
PARITY_BATCH = 8
PARITY_FEED_SEED = 1
# the numpy seeds of the CPU's 1e-7 weight changes
SPREAD_SEEDS = 5


def relative(a, b) -> float:
    """max |a - b| over max |b|."""
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def measure() -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        build_seq2seq_program, seq2seq_batch, startup_params, train_scope)

    if not torch.cuda.is_available():
        raise RuntimeError("seq2seq_parity needs a CUDA card")
    loss, main, startup = build_seq2seq_program()
    params = startup_params(main, startup, 0)
    grads = [f"{n}@GRAD" for n in params]
    fetch = [loss] + grads
    feed = seq2seq_batch(PARITY_FEED_SEED, PARITY_BATCH)

    def step(device, weights, tf32=False):
        exe = fluid.Executor(fluid.CPUPlace() if device == "cpu" else None)
        scope = train_scope(exe, startup, main, weights, device)
        if tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        try:
            out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            if tf32 and not torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError("TF32 was switched off during the step")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        return out

    cpu = step("cpu", params)
    card = step("cuda", params)
    control = step("cuda", params, tf32=True)
    spread = []
    for seed in range(SPREAD_SEEDS):
        rng = np.random.RandomState(seed)
        moved = {n: (a * (1 + 1e-7 * rng.standard_normal(a.shape))).astype(
            np.float32) for n, a in params.items()}
        spread.append(step("cpu", moved))
    rows = {}
    for i, name in enumerate(grads, 1):
        rows[name] = {
            "max_abs_cpu": float(np.abs(cpu[i]).max()),
            "card_f32": relative(card[i], cpu[i]),
            "cpu_spread": [relative(s[i], cpu[i]) for s in spread],
            "card_tf32": relative(control[i], cpu[i])}
    return {"card": fluid.card_info(0), "batch": PARITY_BATCH,
            "feed_seed": PARITY_FEED_SEED, "spread_seeds": SPREAD_SEEDS,
            "loss": {"cpu": float(cpu[0]), "card_f32": float(card[0]),
                     "card_tf32": float(control[0]),
                     "cpu_spread": [float(s[0]) for s in spread]},
            "gradients": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    out = measure()
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
