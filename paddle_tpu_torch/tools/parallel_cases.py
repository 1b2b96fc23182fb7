"""Cases of the parallel layer that a gang of ranks runs: the CPU tests
(``tests/test_torch_parallel.py``, ``test_torch_ring_ulysses.py``,
``test_torch_strategy.py``) spawn one gang per file that runs all of a
file's cases (``run_cases``) and hold rank 0's results against the JAX
package; ``chip_smoke.py``'s parallel phase runs its legs here too.

The program builders take the package as an argument (``fl``, and its
``parallel`` as ``par``): the JAX package and the port share the API, so
one builder makes the same program in both.  Nothing here imports either
package's JAX side.
"""
from __future__ import annotations

import numpy as np
import torch

# ------------------------------------------------------------ builders


def build_mlp(fl, par):
    x = fl.layers.data("x", [8])
    y = fl.layers.data("y", [1], dtype="int32")
    h = fl.layers.fc(x, 16, act="relu", param_attr=fl.ParamAttr(name="w1"),
                     bias_attr=fl.ParamAttr(name="b1"))
    logits = fl.layers.fc(h, 4, param_attr=fl.ParamAttr(name="w2"),
                          bias_attr=fl.ParamAttr(name="b2"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss


def build_megatron(fl, par, clip=None):
    """column-parallel fc -> row-parallel fc -> fc, Adam (the reference's
    tests/test_parallel.py Megatron block)."""
    x = fl.layers.data("x", [12])
    y = fl.layers.data("y", [1], dtype="int32")
    h = par.tp.column_parallel_fc(x, 32, act="relu",
                                  param_attr=fl.ParamAttr(name="col.w"),
                                  bias_attr=fl.ParamAttr(name="col.b"))
    h2 = par.tp.row_parallel_fc(h, 12, param_attr=fl.ParamAttr(name="row.w"),
                                bias_attr=fl.ParamAttr(name="row.b"))
    logits = fl.layers.fc(h2, 4, param_attr=fl.ParamAttr(name="out.w"),
                          bias_attr=fl.ParamAttr(name="out.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    grad_clip = None if clip is None else \
        fl.clip.GradientClipByGlobalNorm(clip)
    fl.optimizer.Adam(1e-2, grad_clip=grad_clip).minimize(loss)
    return loss


def build_megatron_clip(fl, par):
    return build_megatron(fl, par, clip=0.05)


def build_vocab(fl, par):
    ids = fl.layers.data("ids", [1], dtype="int32")
    y = fl.layers.data("y", [1], dtype="int32")
    emb = par.tp.vocab_parallel_embedding(
        ids, [64, 16], param_attr=fl.ParamAttr(name="table"))
    logits = fl.layers.fc(emb, 4, param_attr=fl.ParamAttr(name="head.w"),
                          bias_attr=fl.ParamAttr(name="head.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    fl.optimizer.SGD(0.5).minimize(loss)
    return loss


def build_zero1(fl, par):
    x = fl.layers.data("x", [8])
    lab = fl.layers.data("lab", [1], dtype="int32")
    h = fl.layers.fc(x, 16, act="relu", param_attr=fl.ParamAttr(name="z1.w"),
                     bias_attr=fl.ParamAttr(name="z1.b"))
    logits = fl.layers.fc(h, 4, param_attr=fl.ParamAttr(name="z2.w"),
                          bias_attr=fl.ParamAttr(name="z2.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.Adam(1e-2, name="adam_z").minimize(loss)
    return loss


def build_zero1_packed(fl, par):
    """w [7, 5] and bias [5]: no axis divides by dp = 4 (packed)."""
    x = fl.layers.data("x", [7])
    lab = fl.layers.data("lab", [1], dtype="int32")
    logits = fl.layers.fc(x, 5, param_attr=fl.ParamAttr(name="zp.w"),
                          bias_attr=fl.ParamAttr(name="zp.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.Adam(1e-2, name="adam_p").minimize(loss)
    return loss


def build_accum(fl, par, accumulate=2):
    x = fl.layers.data("x", [8])
    lab = fl.layers.data("lab", [1], dtype="int32")
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        fl.layers.fc(x, 4, param_attr=fl.ParamAttr(name="za.w"),
                     bias_attr=fl.ParamAttr(name="za.b")), lab))
    fl.optimizer.Adam(1e-2, accumulate_steps=accumulate,
                      name="adam_a").minimize(loss)
    return loss


def build_accum_1(fl, par):
    return build_accum(fl, par, 1)


def build_dropout(fl, par):
    """x [N, 16, 32] -> dropout 0.5 -> fc -> mean: the mask of a
    batch-major activation (fetched as ``drop``)."""
    x = fl.layers.data("x", [16, 32])
    d = fl.layers.dropout(x, 0.5, name="drop")
    out = fl.layers.fc(d, 8, num_flatten_dims=2,
                       param_attr=fl.ParamAttr(name="dw"),
                       bias_attr=fl.ParamAttr(name="db"))
    loss = fl.layers.mean(out)
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, d


TINY_LM = dict(vocab_size=64, max_len=16, d_model=32, n_heads=4, n_layers=2,
               d_ff=64)


def build_lm(fl, par, use_tp=False, use_sp=False, sp_strategy="ring",
             dropout=0.0, clip=1.0, cfg=None):
    cfg = dict(cfg or TINY_LM)
    T = cfg["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, logits = fl.models.transformer.build_lm(
        toks, labs, use_tp=use_tp, use_sp=use_sp, sp_strategy=sp_strategy,
        dropout=dropout, **cfg)
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        clip)).minimize(loss)
    return loss, logits


BUILDERS = {"mlp": build_mlp, "megatron": build_megatron,
            "megatron_clip": build_megatron_clip, "vocab": build_vocab,
            "zero1": build_zero1, "zero1_packed": build_zero1_packed,
            "accum": build_accum, "accum_1": build_accum_1,
            "dropout": build_dropout, "lm": build_lm}


def fetch_names(built, fetch) -> list:
    """Fetch names, where ``"$i"`` names the i-th Variable a builder
    returned."""
    return [built[int(f[1:])].name if f.startswith("$") else f
            for f in fetch]


# ------------------------------------------------------------ in a rank


def _fresh():
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    fluid.reset_global_scope()
    return fluid


def program_case(spec: dict) -> dict:
    """Build ``spec["build"]`` (with ``spec.get("kw")``), run its startup,
    load ``spec["init"]`` (full numpy arrays by name), then run
    ``spec["feeds"]`` (one feed dict per step) under a Strategy on
    ``spec["mesh"]`` (None: unsharded), fetching the loss and
    ``spec["fetch"]`` (names, ``"$i"`` the builder's i-th output) each
    step.  Returns the fetches, the gathered final state of
    ``spec.get("state", [])`` names and, under ZeRO-1, the coverage dict
    and the local shapes."""
    fluid = _fresh()
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.core.types import Place

    out = BUILDERS[spec["build"]](fluid, parallel, **spec.get("kw", {}))
    loss = out[0] if isinstance(out, tuple) else out
    strategy = None
    if spec.get("mesh") is not None:
        mesh = parallel.make_mesh(spec["mesh"])
        strategy = parallel.Strategy(
            mesh, data_axis=spec.get("data_axis", "dp"),
            shard_optimizer_state=spec.get("zero1", False))
    device = spec.get("device", "cpu")
    exe = fluid.Executor(Place("cpu") if device == "cpu" else None,
                         strategy=strategy)
    main, scope = fluid.default_main_program(), fluid.global_scope()
    exe.run(fluid.default_startup_program())
    if spec.get("init"):
        # the full arrays; under a Strategy the scope gets this rank's shards
        fluid.load_scope(spec["init"], main, scope, device=exe.device,
                         strategy=strategy)
    scope.step_counter = spec.get("step_counter", 0)
    fetch = [loss.name] + fetch_names(out, spec.get("fetch", []))
    steps = []
    for feed in spec["feeds"]:
        steps.append([np.asarray(v) for v in exe.run(feed=feed,
                                                     fetch_list=fetch)])
    res = {"steps": steps}
    names = spec.get("state", [])
    if names:
        res["state"] = fluid.gather_scope(main, scope, strategy, names)
    if strategy is not None and strategy.shard_optimizer_state:
        res["coverage"] = strategy.last_shard_coverage
        res["local_shapes"] = {n: tuple(scope.find_var(n).shape)
                               for n in scope.var_names()}
    return res


def shard_seq(x: np.ndarray, n: int, idx: int, striped: bool, dim: int = 2):
    """Rank ``idx``'s chunk of the sequence dim ``dim`` of x over n ranks
    (contiguous, or striped)."""
    from paddle_tpu_torch.parallel.strategy import seq_index

    return np.take(x, seq_index(x.shape[dim], n, idx, striped), axis=dim)


def attention_case(spec: dict) -> dict:
    """Ring or Ulysses attention (``spec["attn"]``) over this rank's chunks
    of the global
    q/k/v (``spec["qkv"]``, [B, H, T, D]) on ``spec["mesh"]`` (rows of B
    over dp when the mesh has it, T over sp): the output and the q/k/v
    gradients of sum(out * w), gathered to global arrays in global order.
    A ValueError raised by the call (before any collective) is returned as
    ``{"error": message}``."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.parallel import comm

    mesh = parallel.make_mesh(spec["mesh"])
    n, idx = mesh.shape["sp"], mesh.coord("sp")
    striped = spec.get("striped", False)
    dp = mesh.shape.get("dp", 1)
    r = mesh.coord("dp") if "dp" in mesh.shape else 0

    def local(a):
        a = a[r * (a.shape[0] // dp):(r + 1) * (a.shape[0] // dp)]
        return torch.from_numpy(np.ascontiguousarray(
            shard_seq(a, n, idx, striped)))

    q, k, v = (local(a).requires_grad_(True) for a in spec["qkv"])
    w = local(spec["w"])
    try:
        if spec["attn"] == "ring":
            out = parallel.ring_attention(q, k, v, mesh, causal=spec["causal"],
                                          striped=striped)
        else:
            out = parallel.ulysses_attention(q, k, v, mesh,
                                             causal=spec["causal"])
    except ValueError as exc:
        return {"error": str(exc)}
    gq, gk, gv = torch.autograd.grad((out * w).sum(), (q, k, v))

    def glob(t):
        t = comm.all_gather(t.detach(), mesh.group("sp"), 2)
        if striped:
            perm = np.concatenate([shard_seq(np.arange(t.shape[2])[None, None],
                                             n, d, True)[0, 0]
                                   for d in range(n)])
            t = t[:, :, np.argsort(perm)]
        if dp > 1:
            t = comm.all_gather(t, mesh.group("dp"), 0)
        return t.numpy()

    return {"out": glob(out), "dq": glob(gq), "dk": glob(gk), "dv": glob(gv)}


def collectives_case(spec: dict) -> dict:
    """Each collective of comm.py on a mesh of {"a": 2, "b": n / 2}: every
    rank's result, to hold against what the definitions give."""
    import torch.distributed as dist

    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.parallel import comm

    mesh = parallel.make_mesh(spec["mesh"])
    rank = dist.get_rank()
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * rank
    out = {}
    for axis in mesh.axis_names:
        g = mesh.group(axis)
        out[axis] = {
            "ranks": mesh.axis_ranks(axis),
            "sum": comm.all_reduce(x, g).numpy(),
            "max": comm.all_reduce(x, g, "max").numpy(),
            "gather1": comm.all_gather(x, g, 1).numpy(),
            "scatter0": comm.reduce_scatter(x, g, 0).numpy(),
            "a2a": comm.all_to_all(x, g, 0, 1).numpy(),
            "shift": comm.ring_shift([x], g)[0].numpy(),
        }
    return {"rank": rank, "coords": mesh.coords, "by_axis": out}


def _zero_counters() -> None:
    from ..ops import _counters

    snap = _counters.snapshot()
    _counters.restore(_counters.delta(snap, snap))


def lm_leg_case(spec: dict) -> dict:
    """One leg of the chip phase on this rank: the LM of ``spec["cfg"]``
    (``build_lm`` with ``spec["kw"]``) under a Strategy on
    ``spec["mesh"]`` (ZeRO-1 with ``spec["zero1"]``), on this rank's
    device, from ``init_lm_params(spec["seed"])``; ``spec["steps"]`` steps
    on ``spec["feed"]``, the first fetching every gradient (and the first
    dropout's output, with dropout).  Rank 0 holds them against the
    single-card step saved at ``spec["ref"]`` (``torch.save`` of {"loss":
    [...], "grads": {name: tensor}, "mask": bool tensor or None}).
    Returns, per rank: the losses, the worst gradient error over its max
    abs (and its name), whether the mask is bitwise the reference's, the
    kernel launches of the steps, the collectives called and staged, ms
    per step and the peak memory."""
    import time

    from ..models.transformer import init_lm_params
    from ..ops import attention as _attn, dropout as _drop
    from ..parallel import comm

    fluid = _fresh()
    from paddle_tpu_torch import parallel

    cfg = spec["cfg"]
    loss, _ = build_lm(fluid, parallel, cfg=cfg, **spec.get("kw", {}))
    main = fluid.default_main_program()
    mesh = parallel.make_mesh(spec["mesh"])
    strategy = parallel.Strategy(mesh, shard_optimizer_state=spec.get(
        "zero1", False))
    from paddle_tpu_torch.core.types import Place

    exe = fluid.Executor(Place("cpu") if spec.get("device") == "cpu"
                         else None, strategy=strategy)
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    fluid.load_scope(init_lm_params(spec["seed"], **cfg), main, scope,
                     device=exe.device)
    grads = [p.name + "@GRAD" for p in main.parameters()]
    drops = [op.outputs["Out"][0] for op in main.list_ops()
             if op.type == "dropout"]
    first = [loss.name] + grads + drops[:1]
    dev = exe.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    comm.reset_counts()
    outs, ms = [], []
    for i in range(spec["steps"]):
        comm.barrier()
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs.append(exe.run(feed=spec["feed"],
                            fetch_list=first if i == 0 else [loss]))
        if cuda:
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    res = {"coords": mesh.coords,
           "losses": [float(np.ravel(o[0])[0]) for o in outs],
           "flash": dict(_attn.flash_attention.launches),
           "dropout": dict(_drop.threefry_dropout.launches),
           "calls": dict(comm.calls), "staged": dict(comm.staged),
           "comm_s": dict(comm.seconds),
           "backend": comm.backend(),
           "ms": ms,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    if mesh.rank == 0:
        ref = torch.load(spec["ref"])
        worst, where = 0.0, None
        for n, g in zip(grads, outs[0][1:1 + len(grads)]):
            r = ref["grads"][n].numpy()
            err = float(np.abs(g - r).max()) / max(float(np.abs(r).max()),
                                                   1e-30)
            if err >= worst:
                worst, where = err, n
        res["grad_worst"], res["grad_worst_name"] = worst, where
        res["ref_losses"] = ref["loss"]
        if drops:
            res["mask_equal"] = bool(np.array_equal(
                outs[0][-1] == 0, ref["mask"].numpy()))
    return res


KINDS = {"program": program_case, "attention": attention_case,
         "collectives": collectives_case, "lm_leg": lm_leg_case}


def run_cases(cases: dict, keep_all_ranks: bool = False):
    """Run each case (name -> spec with "kind") on this rank, in order;
    rank 0 returns {name: result}, the other ranks None (unless
    ``keep_all_ranks``)."""
    import torch.distributed as dist

    torch.manual_seed(0)
    res = {name: KINDS[spec["kind"]](spec) for name, spec in cases.items()}
    if keep_all_ranks or dist.get_rank() == 0:
        return res
    return None
