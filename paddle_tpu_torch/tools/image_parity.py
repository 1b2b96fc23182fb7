"""Where the image models' parity step's card-against-CPU gradients lie.

``chip_smoke.py``'s image phase holds one float32 Momentum step of VGG-19,
AlexNet and GoogLeNet on the card against the same step on the CPU
(``_image_train_parity``).  Their gradients at the startup weights are
chaotic at float32's resolution: a rounding flips a ReLU whose input lies
within it of zero, and one flip moves a layer's weight or bias gradient by
one element's product, up to about 1e-2 of its max where the layer sums
few positions.  This tool measures, on that step (the program, weights,
images and dropout masks of the phase), each gradient's relative L2
distance between:

- the card's float32 step (TF32 off, as the port runs it) and the CPU's
  float32 step, and the card's step run a second time (cuDNN's weight
  gradients may add in another order each run);
- each of those and the CPU's float64 step (the program built over float64
  images, the weights cast), which has no float32 flips;
- the CPU's own spreads: its float32 step with the images, or every
  weight, times (1 + 1e-7 N(0, 1)), and with both times (1 + FLOOR_SCALE
  N(0, 1)), the change ``chip_smoke.py`` draws for its floor (numpy seeds
  SPREAD_SEEDS), against its unmoved step;
- a lower-precision control: the card's step with TF32 on.

Run on a CUDA card::

    python -m paddle_tpu_torch.tools.image_parity [--models vgg19,alexnet,googlenet] [--out F]

It prints one line a model and writes to ``--out`` one JSON object: the
card (name and power limit), and for each model the losses and, for each
gradient, its max |g| on the CPU and the readings above.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# chip_smoke.py's image parity step: its batch and the seed of its images
PARITY_BATCH = 2
PARITY_FEED_SEED = 1
SPREAD_SEEDS = (5, 6)
# chip_smoke.py's IMAGE_FLOOR_SCALE
FLOOR_SCALE = 1e-6


def rel_l2(a, b) -> float:
    """||a - b|| over ||b||."""
    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def measure(model: str) -> dict:
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.train_profile import (
        build_image_program, image_batch, startup_params, train_scope)

    programs = {dt: build_image_program(model, False, dtype=dt)
                for dt in ("float32", "float64")}
    loss, main, startup = programs["float32"]
    params = startup_params(main, startup, 0)
    grads = [f"{n}@GRAD" for n in params]
    feed = image_batch(PARITY_BATCH, "cpu", seed=PARITY_FEED_SEED)

    def step(device, weights=params, images=feed["img"], dtype="float32",
             tf32=False):
        loss_v, prog, start = programs[dtype]
        exe = fluid.Executor(fluid.CPUPlace() if device == "cpu" else None)
        if dtype == "float64":
            weights = {n: a.astype(np.float64) for n, a in weights.items()}
            images = images.double()
        scope = train_scope(exe, start, prog, weights, device)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return exe.run(prog, feed=dict(feed, img=images),
                           fetch_list=[loss_v] + grads, scope=scope)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    cpu, cpu64 = step("cpu"), step("cpu", dtype="float64")
    card, card2 = step("cuda"), step("cuda")
    control = step("cuda", tf32=True)
    spread_img, spread_w, spread_floor = [], [], []
    for seed in SPREAD_SEEDS:
        rng = np.random.RandomState(seed)
        noise = torch.from_numpy(rng.standard_normal(tuple(
            feed["img"].shape)).astype(np.float32))
        moves = {n: rng.standard_normal(a.shape) for n, a in params.items()}
        spread_img.append(step("cpu", images=feed["img"] * (
            1 + 1e-7 * noise)))
        spread_w.append(step("cpu", weights={
            n: (a * (1 + 1e-7 * moves[n])).astype(np.float32)
            for n, a in params.items()}))
        spread_floor.append(step(
            "cpu", images=feed["img"] * (1 + FLOOR_SCALE * noise),
            weights={n: (a * (1 + FLOOR_SCALE * moves[n])).astype(
                np.float32) for n, a in params.items()}))
    rows = {}
    for i, name in enumerate(grads, 1):
        rows[name] = {
            "max_abs_cpu": float(np.abs(cpu[i]).max()),
            "card_cpu": rel_l2(card[i], cpu[i]),
            "card_card": rel_l2(card2[i], card[i]),
            "card_f64": rel_l2(card[i], cpu64[i]),
            "cpu_f64": rel_l2(cpu[i], cpu64[i]),
            "cpu_spread_images": [rel_l2(s[i], cpu[i]) for s in spread_img],
            "cpu_spread_weights": [rel_l2(s[i], cpu[i]) for s in spread_w],
            "cpu_spread_floor": [rel_l2(s[i], cpu[i]) for s in spread_floor],
            "card_tf32_cpu": rel_l2(control[i], cpu[i])}
    flat = lambda out: np.concatenate([g.ravel() for g in out[1:]])  # noqa
    return {"loss": {"cpu": float(cpu[0]), "cpu_f64": float(cpu64[0]),
                     "card": float(card[0]), "card_tf32": float(control[0])},
            "all_gradients": {
                "card_cpu": rel_l2(flat(card), flat(cpu)),
                "card_tf32_cpu": rel_l2(flat(control), flat(cpu)),
                "cpu_spread_floor": [rel_l2(flat(s), flat(cpu))
                                     for s in spread_floor]},
            "gradients": rows}


def main(argv=None) -> int:
    import paddle_tpu_torch as fluid

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default="vgg19,alexnet,googlenet")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("image_parity needs a CUDA card")
    out = {"card": fluid.card_info(0), "batch": PARITY_BATCH,
           "feed_seed": PARITY_FEED_SEED, "spread_seeds": SPREAD_SEEDS,
           "models": {}}
    for model in args.models.split(","):
        res = out["models"][model] = measure(model)
        cols = {k: np.median([r[k] if not isinstance(r[k], list)
                              else max(r[k]) for r in
                              res["gradients"].values()])
                for k in ("card_cpu", "card_card", "card_f64", "cpu_f64",
                          "cpu_spread_images", "cpu_spread_weights",
                          "cpu_spread_floor", "card_tf32_cpu")}
        print(f"{model} on {out['card']}: median over "
              f"{len(res['gradients'])} gradients of the relative L2 "
              + ", ".join(f"{k} {v:.3e}" for k, v in cols.items()),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
