"""The port's multi-rank dry run: ``__graft_entry__.py::dryrun_multichip``'s
legs on a gang of ranks.

Two Adam steps (clip 1.0) of the Transformer LM on tiny shapes, run on one
process unsharded, then on a gang of ``n`` ranks under
``parallel.Strategy`` with dp x sp x tp sharding, each leg held to the
single-process losses at the reference's ``rtol=2e-3, atol=1e-4``:

* the composite mesh ({dp, sp, tp}, tp and sp up to 2, the rest dp) with
  ZeRO-1, ring attention over sp;
* when sp > 1, the striped ring and Ulysses on the same mesh;
* when n >= 4, the tp = 4 leg ({dp, sp, tp = 4});
* the pipeline + expert leg ({dp, pp, ep}, pp and ep up to 2, the rest
  dp): ``pipeline_fc_stack`` into ``switch_moe`` into fc and cross
  entropy with the aux loss, two Adam(1e-2) steps, held to the same
  build run unsharded (the sequential fold, every expert on one device)
  at the same tolerances, its second loss below its first.

Run: ``python -m paddle_tpu_torch.tools.dryrun_multichip 8 cpu`` (CPU
ranks over gloo; about half a minute for 8); without ``cpu`` the ranks
run on the card.
"""
from __future__ import annotations

import math
import sys

import numpy as np

V, D_MODEL, N_HEADS, N_LAYERS, D_FF = 64, 32, 4, 2, 64


def mesh_axes(n: int) -> dict:
    """n factored into dp x tp x sp with every axis > 1 where n allows
    (tp and sp up to 2, the rest dp), as the reference factors it."""
    axes = {"dp": 1, "tp": 1, "sp": 1}
    rest = n
    for axis, cap in (("tp", 2), ("sp", 2), ("dp", rest)):
        take = 1
        while take < cap and rest % 2 == 0 and take * 2 <= cap:
            take *= 2
            rest //= 2
        axes[axis] = take
    axes["dp"] *= rest
    return {"dp": axes["dp"], "sp": axes["sp"], "tp": axes["tp"]}


def legs(n: int) -> list:
    """(label, mesh axes, zero1, use_tp, use_sp, sp_strategy) of each leg."""
    axes = mesh_axes(n)
    out = [("composite", axes, True, axes["tp"] > 1, axes["sp"] > 1,
            "ring")]
    if axes["sp"] > 1:
        out.append(("striped ring", axes, False, axes["tp"] > 1, True,
                    "ring_striped"))
        out.append(("ulysses", axes, False, axes["tp"] > 1, True,
                    "ulysses"))
    if n >= 4:
        sp4 = 2 if n >= 8 else 1
        dp4 = max(n // (4 * sp4), 1)
        out.append(("tp=4", {"dp": dp4, "sp": sp4, "tp": 4}, False, True,
                    sp4 > 1, "ring"))
    return out


def feed_for(n: int) -> dict:
    axes = mesh_axes(n)
    T = 16 * axes["sp"]
    sp4 = 2 if n >= 8 else 1
    dp4 = max((n // (4 * sp4)), 1) if n >= 4 else 1
    B = 2 * math.lcm(max(axes["dp"], 1), dp4)
    rng = np.random.RandomState(0)
    return {"toks": rng.randint(0, V, (B, T)).astype("int32"),
            "labs": rng.randint(0, V, (B, T, 1)).astype("int32")}


def ppep_axes(n: int) -> dict:
    """n factored into dp x pp x ep as the reference factors it: pp and ep
    up to 2, the rest dp."""
    axes = {"dp": 1, "pp": 1, "ep": 1}
    rest = n
    for axis, cap in (("pp", 2), ("ep", 2), ("dp", rest)):
        take = 1
        while take < cap and rest % 2 == 0 and take * 2 <= cap:
            take *= 2
            rest //= 2
        axes[axis] = take
    axes["dp"] *= rest
    return axes


PPEP_D = 16


def ppep_feed(n: int) -> dict:
    axes = ppep_axes(n)
    B = 4 * axes["dp"] * axes["pp"]
    rng = np.random.RandomState(1)
    return {"x": rng.randn(B, PPEP_D).astype("float32"),
            "lab": rng.randint(0, 8, (B, 1)).astype("int32")}


def ppep_two_steps(n: int, feed, strategy=None, device=None, d_ff=32,
                   experts=None, stages=None, micro=None, cf=2.0,
                   classes=8, record=None):
    """The reference's pp + ep program for ``n`` ranks' axes (the width is
    the feed's), two Adam(1e-2) steps: unsharded (``strategy`` None, the
    sequential fold) or sharded.  ``experts``, ``stages`` and ``micro``
    default to the reference's 2 x ep, 2 x pp and 2 x pp.  ``record``: a
    dict that gets each step's ms (host clock, synchronised on a card)."""
    import time

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.core.types import Place

    axes = ppep_axes(n)
    D = feed["x"].shape[1]
    fluid.reset_default_programs()
    fluid.reset_global_scope()
    x = fluid.layers.data("x", [D])
    lab = fluid.layers.data("lab", [1], dtype="int32")
    h = parallel.pipeline_fc_stack(x, D, n_stages=stages or axes["pp"] * 2,
                                   n_microbatches=micro or 2 * axes["pp"])
    y, aux = parallel.switch_moe(h, num_experts=experts or 2 * axes["ep"],
                                 d_ff=d_ff, capacity_factor=cf)
    logits = fluid.layers.fc(y, classes)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, lab)) + aux
    fluid.optimizer.Adam(1e-2).minimize(loss)
    place = Place("cpu") if device == "cpu" else None
    exe = fluid.Executor(place, strategy=strategy)
    exe.run(fluid.default_startup_program())
    cuda = exe.device.type == "cuda"
    losses = []
    for _ in range(2):
        if cuda:
            torch.cuda.synchronize(exe.device)
        t0 = time.perf_counter()
        out, = exe.run(feed=feed, fetch_list=[loss])
        if cuda:
            torch.cuda.synchronize(exe.device)
        if record is not None:
            record.setdefault("ms", []).append(
                (time.perf_counter() - t0) * 1e3)
        losses.append(float(np.ravel(out)[0]))
    return losses[0], losses[1]


def train_two_steps(feed, strategy=None, use_tp=False, use_sp=False,
                    sp_strategy="ring", device=None):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.types import Place

    fluid.reset_default_programs()
    fluid.reset_global_scope()
    T = feed["toks"].shape[1]
    toks = fluid.layers.data("toks", [T], dtype="int32")
    labs = fluid.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = fluid.models.transformer.build_lm(
        toks, labs, V, max_len=T, d_model=D_MODEL, n_heads=N_HEADS,
        n_layers=N_LAYERS, d_ff=D_FF, use_tp=use_tp, use_sp=use_sp,
        sp_strategy=sp_strategy)
    fluid.optimizer.Adam(
        1e-3, grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)).minimize(
        loss)
    place = Place("cpu") if device == "cpu" else None
    exe = fluid.Executor(place, strategy=strategy)
    exe.run(fluid.default_startup_program())
    l1, = exe.run(feed=feed, fetch_list=[loss])
    l2, = exe.run(feed=feed, fetch_list=[loss])
    return float(l1), float(l2)


def rank_legs(n: int, device: str) -> list:
    """Every leg on this rank (run in each rank of the gang)."""
    from paddle_tpu_torch import parallel

    feed = feed_for(n)
    out = []
    for label, axes, zero1, use_tp, use_sp, sp_strategy in legs(n):
        mesh = parallel.make_mesh(axes)
        strategy = parallel.Strategy(mesh, shard_optimizer_state=zero1)
        out.append((label, dict(mesh.shape), train_two_steps(
            feed, strategy, use_tp, use_sp, sp_strategy, device)))
    mesh = parallel.make_mesh(ppep_axes(n))
    out.append(("pp+ep", dict(mesh.shape), ppep_two_steps(
        n, ppep_feed(n), parallel.Strategy(mesh), device)))
    return out


def dryrun_multichip(n_ranks: int, device=None,
                     timeout_s: float = 600.0) -> list:
    """Run every leg on a gang of ``n_ranks`` and hold it to the
    single-process losses; prints one line per leg and returns
    [(label, mesh, (l1, l2))].  Raises on a disagreement.  ``device``:
    the card by default (this raises without one), or "cpu"."""
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch._device import resolve_device

    device = str(resolve_device(device))

    feed = feed_for(n_ranks)
    refs = {"lm": train_two_steps(feed, device=device),
            "pp+ep": ppep_two_steps(n_ranks, ppep_feed(n_ranks),
                                    device=device)}
    ranks = distributed.spawn(rank_legs, n_ranks, n_ranks, device,
                              device=device, timeout_s=timeout_s)
    for r, got in enumerate(ranks[1:], 1):
        if got != ranks[0]:
            raise AssertionError(f"rank {r}'s losses differ from rank 0's: "
                                 f"{got} vs {ranks[0]}")
    for label, mesh, (l1, l2) in ranks[0]:
        ref1, ref2 = refs["pp+ep" if label == "pp+ep" else "lm"]
        assert np.isfinite(l1) and np.isfinite(l2), (label, l1, l2)
        assert l2 < l1, f"{label}: one Adam step must reduce the loss"
        np.testing.assert_allclose([l1, l2], [ref1, ref2], rtol=2e-3,
                                   atol=1e-4, err_msg=label)
        print(f"dryrun_multichip ok: {label} mesh={mesh} loss {l1:.4f} -> "
              f"{l2:.4f} == single-device {ref1:.4f} -> {ref2:.4f}")
    return ranks[0]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
