"""Strategy: how an Executor maps a Program onto a mesh of ranks (PyTorch
port of ``paddle_tpu/parallel/strategy.py``).

The JAX package compiles one step with ``jax.jit`` shardings and lets
GSPMD insert the collectives.  Here every rank runs the same program on
its own shard, one rank per device, and the Strategy does explicitly what
GSPMD does implicitly:

* the feed is the global batch, as the JAX API takes it; a rank keeps its
  ``data_axis`` rows, and, for the feeds a model marks sequence-sharded
  (``build_lm(use_sp=True)``: a ``SeqAxis`` on dim 1 of their
  ``Variable.sharding``), its slice of the sequence: contiguous blocks, or
  the striped pair of half-blocks (d, 2n-1-d) of ``ring_striped``
  (``SeqAxis.striped``).  The layers carry that spec to every activation
  they make from such a feed, so an op knows from its input's spec, at
  build time, whether it holds a sequence slice;
* a rank's parameter is its shard of the full parameter (its
  ``ParamAttr.sharding``): the startup program draws the full tensor from
  the same seed on every rank and the rank keeps its slice, so a sharded
  run starts from the single-device weights; a full tensor put into the
  scope (``load_scope``) is sliced the same way at the next run;
* the layers act on shards through ``comm.py`` (``parallel/tp.py``, the
  vocab-parallel cross entropy, ``mean`` over dp and sp, ring and Ulysses
  attention), reading the mesh and this step's :class:`StepLayout` from
  their ``OpContext``;
* after the backward, the gradients of parameters replicated over the
  data axes (dp, and sp when the sequence is sharded) are averaged over
  them, in one all-reduce per dtype and axis;
* ZeRO-1 (``shard_optimizer_state``) follows ``_zero1_plan``: an
  accumulator of a replicated parameter is kept as the rank's dp slice,
  along its first dp-divisible axis ("spec") or flattened and padded to a
  dp multiple ("packed"); each update runs on the rank's slice of the
  parameter and gradient, and the parameter is then all-gathered; the
  optimizer ops that read a planned tensor whole (the accumulation buffer,
  the step counter) see it gathered, and it is sliced again for the scope;
* fetches come back global: gathered over dp, sp and tp as their layout
  says, so a rank returns what the single-device run returns;
* the batch reductions a sharded program needs are carried over the data
  axes (ROADMAP C.13): ``mean``, ``reduce_sum`` / ``mean`` / ``max`` /
  ``min`` over dim 0, ``batch_norm``'s training statistics and
  ``accuracy``'s counts give every rank the global value (``comm.py``'s
  gradient convention); an op that mixes batch rows, the positions of a
  sharded sequence or the entries of a dim a model axis shards in
  another way (``reduce_prod`` over the batch, and any op that runs
  along, indexes or contracts such a dim or moves the batch out of dim
  0, by the axes its layer declared (``Op.axes``) or its dim attributes:
  ``_mixing``) runs through a :class:`Carrier`: its sharded inputs
  gathered whole, the op's own function on them, the rank's part of its
  sharded outputs kept (:meth:`Strategy.plan_batch_ops`, planned once
  per program version).

``Executor.warm`` under a Strategy raises ``WarmError`` (NCCL can be
captured in a CUDA graph, gloo cannot; a capture across ranks waits for a
machine with two or more cards).
"""
from __future__ import annotations

import copy
import json
import math
import weakref
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.dropout import CounterMap
from ..param_attr import PartitionSpec as P
from ..param_attr import SeqAxis, seq_axis_of
from . import comm
from .mesh import Mesh, mesh_axis_size


def seq_index(T: int, n: int, idx: int, striped: bool) -> np.ndarray:
    """The global sequence positions of rank ``idx``'s slice of T over n
    ranks, in the rank's local order."""
    if not striped:
        t = T // n
        return np.arange(idx * t, (idx + 1) * t)
    th = T // (2 * n)
    return np.concatenate([np.arange(b * th, (b + 1) * th)
                           for b in (idx, 2 * n - 1 - idx)])


def shard_order(mesh: Mesh, axis, local: int, device) -> tuple:
    """(order, mine) of a dim of ``local`` entries on this rank that
    ``axis`` shards: the permutation that puts the ranks' blocks,
    all-gathered in rank order, in the global order (None when that is
    their order; a striped ``SeqAxis``'s is not), and this rank's global
    positions along the dim (int64 tensors on ``device``)."""
    n, striped = mesh.shape[axis], getattr(axis, "striped", False)
    order = None
    if striped:
        perm = np.concatenate([seq_index(local * n, n, d, True)
                               for d in range(n)])
        order = torch.as_tensor(np.argsort(perm), device=device)
    mine = torch.as_tensor(seq_index(local * n, n, mesh.coord(axis),
                                     striped), device=device)
    return order, mine


class StepLayout:
    """One step's data layout on this rank: ``data_axis`` (rows sharded, or
    None), ``seq_axis`` (the ``SeqAxis`` the feeds' sequence is sharded
    over, or None) and the global batch ``batch``.  Layers read it from
    ``OpContext.layout``, with their input's own ``SeqAxis`` (or None),
    read from its spec at build time."""

    def __init__(self, mesh: Mesh, data_axis: Optional[str],
                 seq_axis: Optional[str], batch: int):
        self.mesh = mesh
        self.data_axis = data_axis
        self.seq_axis = seq_axis
        self.batch = batch
        # the Strategy's plan of the ops carried over this step's sharded
        # batch (Strategy.plan_batch_ops), and the names of batch-major
        # outputs a carried op left whole on every rank
        self.carry = None
        self.replicated = set()

    def sharded(self, seq) -> bool:
        """Whether a variable whose sequence entry is ``seq`` holds a slice
        of its sequence on this step's mesh."""
        return seq is not None and mesh_axis_size(self.mesh, seq) > 1

    def data_groups(self, seq) -> list:
        """The groups a batch-major mean is averaged over: dp, and the
        sequence axis for a sequence-sharded input."""
        axes = [self.data_axis] + ([seq] if self.sharded(seq) else [])
        return [self.mesh.group(a) for a in axes if a is not None]

    def batch_offset(self, local_rows: int) -> int:
        if self.data_axis is None:
            return 0
        return self.mesh.coord(self.data_axis) * local_rows

    def seq_positions(self, seq, t_local: int, device) -> torch.Tensor:
        """The global positions of this rank's slice of a sequence sharded
        over ``seq`` (int64)."""
        n = self.mesh.shape[seq]
        pos = seq_index(t_local * n, n, self.mesh.coord(seq), seq.striped)
        return torch.as_tensor(pos, dtype=torch.int64, device=device)

    def counter_map(self, shape: Sequence[int], seq, batch: bool = True,
                    col=None) -> CounterMap:
        """Where this rank's slice of a tensor of local ``shape`` lies in
        the global one (the dropout counter): its rows over dp when
        ``batch`` (batch-major), its sequence (dim 1) sharded over ``seq``
        or whole (None), and its last dim sharded over the model axis
        ``col`` or whole (None)."""
        rows = int(shape[0])
        base_rows = self.batch_offset(rows) if batch else 0
        nc = mesh_axis_size(self.mesh, col) if col is not None else 1
        w = int(shape[-1])
        W, c0 = w * nc, (self.mesh.coord(col) * w if nc > 1 else 0)
        # elements of one local row, and of one global row
        per_row = int(np.prod(shape[1:], dtype=np.int64))
        per_grow = per_row // w * W
        if not (batch and self.sharded(seq)):
            if nc == 1:
                return CounterMap(base=base_rows * per_row)
            return CounterMap(base=base_rows * per_grow, row=w, stride=W,
                              seg=w, off0=c0)
        n = self.mesh.shape[seq]
        idx = self.mesh.coord(seq)
        t = int(shape[1])
        # the inner rows of a sequence position, each w (local) wide
        inner = per_row // t // (w if nc > 1 else 1)
        stride = per_grow * n
        two = dict(row2=w, stride2=W, off2=c0) if nc > 1 else {}
        if not seq.striped:
            return CounterMap(base=base_rows * stride, row=per_row,
                              stride=stride, seg=t * inner,
                              off0=idx * t * inner, **two)
        th = t // 2
        seg = th * inner
        return CounterMap(base=base_rows * stride, row=per_row,
                          stride=stride, seg=seg, off0=idx * th * inner,
                          off1=(2 * n - 1 - idx) * th * inner - seg, **two)


# op types that carry their reduction over a sharded batch themselves
# (accuracy and its evaluator sum their two counts over the ranks)
BATCH_CARRIED = frozenset({"mean", "reduce_sum", "reduce_mean", "reduce_max",
                           "reduce_min", "reduce_prod", "batch_norm",
                           "switch_moe", "accuracy", "accuracy_accumulate"})

# op types that take a sequence-sharded input on its own terms (ring and
# Ulysses attention, the dropout counter map, positions from the layout)
SEQ_CARRIED = frozenset({"attention", "dropout", "pos_embed"})

# op types with a tensor-parallel form of their own (parallel/tp.py: the
# sharded matmul, the vocab-parallel lookup and cross entropy; the LM's
# head and attention on their shards; the dropout counter map)
MODEL_CARRIED = frozenset({"mul", "embedding", "softmax_with_cross_entropy",
                           "lm_head", "attention", "dropout"})

# attributes that name dims of an op's input (``elementwise_*``'s ``axis``
# aligns a broadcast instead); ``stack`` and ``unsqueeze`` count the dims
# of their output, one more
_DIM_ATTRS = ("axis", "dim", "axes")
_NEW_DIM = frozenset({"stack", "unsqueeze"})


def _op_axes(op, nd: int) -> tuple:
    """The dims of an ``nd``-dim input that ``op`` runs along: those its
    layer declared (``Op.axes``: ``sum_to_one_norm`` and ``top_k`` the
    last, so a 1-D batch-major input's batch; ``sequence_reverse`` and
    ``dynamic_lstm`` the sequence; ``auc`` and the evaluators' counts the
    batch), else those its dim attributes name."""
    if op.type.startswith("elementwise_") or not nd:
        return ()
    n = nd + (op.type in _NEW_DIM)
    if op.axes is not None:
        return tuple(d % n for d in op.axes if -n <= d < n)
    for k in _DIM_ATTRS:
        v = op.attrs.get(k)
        if v is None:
            continue
        vals = v if isinstance(v, (list, tuple)) else (v,)
        return tuple(d % n for d in vals if isinstance(d, int))
    return ()


def _batch(v) -> bool:
    return v is not None and bool(v.shape) and v.shape[0] is None


def _batch_mixing(op, var) -> Optional[str]:
    """How ``op``, one of whose inputs is batch-major (``var(name)``: the
    variable of a name), mixes the rows of a batch sharded over dp, or
    None when each output row reads only its own input rows."""
    ins = {s: [var(n) for n in ns] for s, ns in op.inputs.items()}
    first = next(v for vs in ins.values() for v in vs if _batch(v))
    if 0 in _op_axes(op, len(first.shape)):
        return f"{op.type!r} runs along the batch (dim 0)"
    if op.type in ("gather", "scatter") and _batch(ins["X"][0]):
        return f"{op.type!r} indexes the rows of a batch-major x"
    if op.type in ("matmul", "mul") and any(
            _batch(v) and (op.type == "mul" or len(v.shape) <= 2)
            for v in ins.get("Y", ())):
        return f"{op.type!r} contracts over the batch of its y"
    if not all(_batch(var(n)) for n in op.output_names()):
        return f"{op.type!r} takes the batch out of dim 0"
    return None


def _seq_mixing(op, var, layout) -> Optional[str]:
    """How ``op`` mixes the positions of a sequence-sharded input (a
    ``SeqAxis`` on dim 1 sharded on this step's mesh), or None."""
    if op.type in SEQ_CARRIED:
        return None
    seq = [v for v in map(var, op.input_names())
           if _batch(v) and layout.sharded(seq_axis_of(v))]
    if not seq:
        return None
    if any(1 in _op_axes(op, len(v.shape)) for v in seq):
        return f"{op.type!r} runs along the sharded sequence (dim 1)"
    for n in op.output_names():
        out = var(n)
        if not _batch(out) or seq_axis_of(out) != seq_axis_of(seq[0]):
            return f"{op.type!r} takes the sequence out of dim 1"
    return None


def _model_dims(v, layout) -> set:
    """The dims of ``v`` its spec shards over a model axis (not the data
    axis, not a sequence) of more than one rank on this step's mesh."""
    return {i for i, a in enumerate(_spec_of(v))
            if a is not None and not isinstance(a, SeqAxis)
            and a != layout.data_axis and mesh_axis_size(layout.mesh, a) > 1}


def _model_mixing(op, var, layout) -> Optional[str]:
    """How ``op`` runs along a dim that a model axis shards (the last dim
    of a column-parallel output), with no tensor-parallel form of its
    own, or None."""
    from ..layers.tensor import _reduced_dims

    if op.type in MODEL_CARRIED or op.type.startswith("elementwise_"):
        return None
    for v in map(var, op.input_names()):
        if v is None or not v.shape:
            continue
        dims = _model_dims(v, layout)
        if not dims:
            continue
        nd = len(v.shape)
        if op.type.startswith("reduce_"):
            axes = _reduced_dims(v, op.attrs.get("axis"))
        elif op.type == "mean":
            axes = tuple(range(nd))
        else:
            axes = _op_axes(op, nd)
        if dims & set(axes):
            return f"{op.type!r} runs along a dim sharded over a model axis"
    return None


def _mixing(op, var, layout, dp: int) -> Optional[str]:
    """Why ``op`` must run on the whole batch (and sequence) of this
    step's layout, or on the whole of a dim a model axis shards, or None
    (see :meth:`Strategy.plan_batch_ops`)."""
    from ..layers.tensor import _reduced_dims

    if op.special is not None:
        return None
    what = _model_mixing(op, var, layout)
    if what is not None:
        return what
    batch = [v for v in map(var, op.input_names()) if _batch(v)]
    if not batch:
        return None
    if op.type.startswith("reduce_"):
        dims = _reduced_dims(batch[0], op.attrs.get("axis"))
        seq = layout.sharded(seq_axis_of(batch[0]))
        if op.type == "reduce_prod" and ((0 in dims and dp > 1)
                                         or (1 in dims and seq)):
            return "reduce_prod over a sharded dim"
        if 0 in dims and 1 not in dims and seq:
            return (f"{op.type} over the batch of a sequence-sharded input, "
                    f"keeping the sequence")
        return None
    if op.type in BATCH_CARRIED:
        return None
    what = _batch_mixing(op, var) if dp > 1 else None
    return what or _seq_mixing(op, var, layout)


class Carrier:
    """Runs one op that mixes batch rows on the whole tensors: each input
    sharded over the data axes (its rows over dp, its positions over sp,
    and any dim its spec shards over a model axis) is all-gathered into
    the global order (``comm.gather_shards``), the op's own function runs
    on them with no step layout (so the op's body does what it does on
    one device), and each output keeps the rank's part of the dims its
    variable is sharded on: the rows of a batch-major output, the
    positions of a sequence-sharded one.  Every other output is the same
    whole value on every rank (a metric, a persistable evaluator state,
    the global ``argmax`` over the batch); so is a batch-major output
    whose rows do not divide over dp, which the step records in
    ``StepLayout.replicated`` so that its fetch is not gathered again.
    Backward, ``comm.py``'s convention holds: the gather of a
    data-sharded input sums the ranks' cotangents (``gather_shards``)."""

    def __init__(self, op, var, strategy, layout, why: str):
        self.op, self.why = op, why
        mesh = strategy.mesh
        data = layout.data_axis
        dp = mesh_axis_size(mesh, data) if data else 1

        def dims(n):
            v = var(n)
            out = []
            if v is None or not v.shape:
                return out
            if _batch(v):
                if dp > 1:
                    out.append((0, data, True))
                seq = seq_axis_of(v)
                if layout.sharded(seq):
                    out.append((1, seq, True))
            out += [(i, _spec_of(v)[i], False)
                    for i in sorted(_model_dims(v, layout))]
            return out

        self.ins = {s: [dims(n) for n in ns] for s, ns in op.inputs.items()}
        self.outs = {s: [(n, dims(n)) for n in ns]
                     for s, ns in op.outputs.items()}
        self.mesh = mesh
        self._pos = {}

    def _positions(self, axis, local: int, device):
        """:func:`shard_order` of the dim, kept for later steps."""
        key = (str(axis), getattr(axis, "striped", False), local, device)
        got = self._pos.get(key)
        if got is None:
            got = self._pos[key] = shard_order(self.mesh, axis, local,
                                               device)
        return got

    def __call__(self, env, ctx) -> None:
        op, mesh = self.op, self.mesh
        ins = op.read(env, ctx)
        whole = {}
        for slot, vals in ins.items():
            whole[slot] = []
            for t, steps in zip(vals, self.ins[slot]):
                if steps and isinstance(t, torch.Tensor):
                    t = comm.gather_shards(t, [
                        (d, mesh.group(a), *self._positions(
                            a, t.shape[d], t.device), summed)
                        for d, a, summed in steps])
                whole[slot].append(t)
        gctx = copy.copy(ctx)
        gctx.layout = gctx.carry = None
        outs = op.fn(whole, op.attrs, gctx)
        mine = {}
        for slot, entries in self.outs.items():
            mine[slot] = []
            for t, (name, steps) in zip(outs.get(slot, []), entries):
                for d, a, _ in steps:
                    n = mesh.shape[a]
                    if t.shape[d] % n:
                        if d == 0 and len(steps) == 1:
                            ctx.layout.replicated.add(name)
                            break
                        raise ValueError(
                            f"{op.type}: output {name!r} has {t.shape[d]} "
                            f"entries on dim {d}, which do not divide over "
                            f"{a}={n}")
                    _, pos = self._positions(a, t.shape[d] // n, t.device)
                    t = t.index_select(d, pos)
                mine[slot].append(t)
        op.write(env, mine)


def _spec_of(var) -> tuple:
    return tuple(getattr(var, "sharding", None) or ())


class LocalFeed(dict):
    """A feed dict that is already this rank's part of a global batch (its
    dp rows, and its sequence slice of the sequence-sharded feeds), as
    ``DeviceFeeder(sharding=strategy)`` stages it: ``batch`` is the global
    batch size and ``seq_axis`` the ``SeqAxis`` its sequence was sliced
    over (or None).  ``Executor.run`` under that Strategy takes it without
    slicing again."""

    def __init__(self, feeds, batch: int, seq_axis=None):
        super().__init__(feeds)
        self.batch = int(batch)
        self.seq_axis = seq_axis


class Strategy:
    def __init__(self, mesh: Mesh, data_axis: Optional[str] = "dp",
                 shard_optimizer_state: bool = False):
        """``shard_optimizer_state``: ZeRO-1 (as the reference's):
        accumulators of replicated parameters live as each rank's slice
        over the data axis, every accumulator byte sharded; parameters
        stay replicated, so forward and backward are untouched.
        ``last_shard_coverage`` reports the byte coverage after each run."""
        self.mesh = mesh
        self.data_axis = data_axis if (data_axis in mesh.axis_names) else None
        self.shard_optimizer_state = shard_optimizer_state
        self.last_shard_coverage = None
        self._plan_cache = {}
        # program -> {(version, dp, seq): plan_batch_ops's plan}
        self._plans = weakref.WeakKeyDictionary()

    # ---------------------------------------------------------- ZeRO-1 plan
    def _zero1_plan(self, program, names):
        """name -> ("spec", PartitionSpec) for axis-divisible accumulators,
        ("packed", (shape, numel, padded)) for flatten-pad ones.  Memoized
        per (program, version, names)."""
        if not (self.shard_optimizer_state and self.data_axis):
            return {}
        key = (program, program.version, tuple(sorted(names)))
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached
        plan = {}
        dp = self.mesh.shape[self.data_axis]
        for n in names:
            var = program.global_block.vars.get(n)
            if (var is None or getattr(var, "sharding", None) is not None
                    or not getattr(var, "is_opt_state", False)):
                continue
            shape = tuple(var.shape or ())
            if not shape:
                continue  # scalars: replicated; _coverage reports them
            for i, d in enumerate(shape):
                if d is not None and d % dp == 0 and d >= dp:
                    plan[n] = ("spec", P(*([None] * i + [self.data_axis])))
                    break
            else:
                if all(d is not None for d in shape):
                    numel = math.prod(shape)
                    plan[n] = ("packed", (shape, numel, -(-numel // dp) * dp))
        self._plan_cache[key] = plan
        return plan

    def _program_plan(self, program):
        names = [v.name for v in program.persistable_vars()]
        return self._zero1_plan(program, names)

    def packed_accumulators(self, program, names):
        """Names the ZeRO-1 plan stores flattened and padded."""
        plan = self._zero1_plan(program, list(names))
        return sorted(n for n, (kind, _) in plan.items() if kind == "packed")

    def pack_state(self, program, state):
        """Flatten and pad the accumulators the ZeRO-1 plan marks packed, in
        a dict of full arrays (a no-op for arrays already packed)."""
        plan = self._zero1_plan(program, list(state))
        packed = [(n, info) for n, (kind, info) in plan.items()
                  if kind == "packed"]
        if not packed:
            return state
        state = dict(state)
        for n, (shape, numel, padded) in packed:
            a = state[n]
            if tuple(a.shape) == (padded,):
                continue
            flat = np.asarray(a).reshape(-1)
            state[n] = np.pad(flat, (0, padded - numel))
        return state

    def _coverage(self, program, names, plan):
        """Fraction of optimizer-state bytes sharded; vars the plan cannot
        handle (scalars, unknown dims) count as replicated."""
        sharded = total = 0
        replicated = []
        for n in names:
            var = program.global_block.vars.get(n)
            if var is None or not getattr(var, "is_opt_state", False):
                continue
            shape = tuple(var.shape or ())
            known = all(d is not None for d in shape)
            nbytes = (math.prod(shape) if known and shape else 1) \
                * torch.empty((), dtype=var.dtype).element_size()
            total += nbytes
            if n in plan or getattr(var, "sharding", None) is not None:
                sharded += nbytes
            else:
                replicated.append(n)
        return {"sharded_bytes": sharded, "total_bytes": total,
                "fraction": (sharded / total) if total else 1.0,
                "replicated": replicated}

    def report_coverage(self, program, names):
        """Compute ``last_shard_coverage`` over ``names`` and print it
        once per distinct layout (the first rank of the mesh)."""
        if not self.shard_optimizer_state:
            return
        names = sorted(names)
        prev = self.last_shard_coverage
        self.last_shard_coverage = c = self._coverage(
            program, names, self._zero1_plan(program, names))
        if c != prev and c["total_bytes"] and self.mesh.rank == \
                int(self.mesh.devices.flat[0]):
            print(f"ZeRO-1 shard coverage: {c['sharded_bytes']}/"
                  f"{c['total_bytes']} opt-state bytes "
                  f"({100 * c['fraction']:.1f}%) sharded over "
                  f"{self.data_axis}={self.mesh.shape.get(self.data_axis)}"
                  + (f"; replicated: {c['replicated']}"
                     if c["replicated"] else ""))

    def describe(self, program, state_names, feed_names) -> str:
        """Canonical layout descriptor: mesh axes and sizes, each state's,
        feed's and new state's spec, the data axis and the ZeRO-1 flag
        (JSON, sorted keys; no rank numbers, so every rank gives the same
        string), as the reference's (``compile.aot.canonical_sharding``)."""
        from ..core.executor import state_out_names

        out_names = state_out_names(program, state_names)
        plan = self._zero1_plan(program, sorted(set(state_names)
                                                | set(out_names)))
        block = program.global_block

        def state_spec(n):
            var = block.vars.get(n)
            if n in plan:
                kind, info = plan[n]
                return info if kind == "spec" else P(self.data_axis)
            return _spec_of(var)

        def feed_spec(n):
            var = block.vars.get(n)
            spec = list(_spec_of(var))
            if self.data_axis and var is not None and var.shape \
                    and var.shape[0] is None:
                spec = [self.data_axis] + spec[1:]
            return spec

        def enc(s):
            return [None if e is None else str(e) for e in s]

        d = {"axes": [[a, int(self.mesh.shape[a])]
                      for a in self.mesh.axis_names],
             "specs": {"state": {n: enc(state_spec(n))
                                 for n in sorted(state_names)},
                       "feed": {n: enc(feed_spec(n))
                                for n in sorted(feed_names)},
                       "out": {n: enc(state_spec(n))
                               for n in sorted(out_names)}},
             "extra": {"data_axis": self.data_axis,
                       "zero1": bool(self.shard_optimizer_state)}}
        return json.dumps(d, sort_keys=True)

    # ---------------------------------------------------------- slicing
    def _dp(self):
        if self.data_axis is None:
            return 1, 0
        return self.mesh.shape[self.data_axis], self.mesh.coord(
            self.data_axis)

    def _local_shape(self, shape, spec):
        out = list(shape)
        for i, a in enumerate(spec):
            if a is not None:
                out[i] = shape[i] // mesh_axis_size(self.mesh, a)
        return tuple(out)

    def _slice_spec(self, t, spec):
        for i, a in enumerate(spec):
            n = mesh_axis_size(self.mesh, a) if a is not None else 1
            if n > 1:
                if t.shape[i] % n:
                    raise ValueError(f"dim {i} of {tuple(t.shape)} does not "
                                     f"divide over {a}={n}")
                k = t.shape[i] // n
                t = t.narrow(i, self.mesh.coord(a) * k, k)
        return t.contiguous()

    def _zslice(self, entry, t):
        kind, info = entry
        dp, r = self._dp()
        if kind == "spec":
            return self._slice_spec(t, info)
        shape, numel, padded = info
        flat = t.reshape(-1)
        if flat.numel() < padded:
            flat = torch.cat([flat, flat.new_zeros(padded - flat.numel())])
        k = padded // dp
        return flat[r * k:(r + 1) * k].contiguous()

    def _zgather(self, entry, t):
        kind, info = entry
        group = self.mesh.group(self.data_axis)
        if kind == "spec":
            dim = list(info).index(self.data_axis)
            return comm.all_gather(t, group, dim)
        shape, numel, _ = info
        return comm.all_gather(t, group, 0)[:numel].reshape(shape)

    def _zlocal_shape(self, entry, shape):
        kind, info = entry
        if kind == "spec":
            return self._local_shape(shape, info)
        dp, _ = self._dp()
        return (info[2] // dp,)

    def local_state(self, program, state: Dict[str, Any]) -> Dict[str, Any]:
        """The rank's shards of ``state``: a tensor that has its variable's
        full shape where the rank's shard is smaller (a startup program's
        output, a full tensor put into the scope) is sliced; one already
        local is kept."""
        block = program.global_block
        plan = self._program_plan(program)
        out = {}
        for n, t in state.items():
            var = block.vars.get(n)
            if var is None or t is None or not var.shape \
                    or any(d is None for d in var.shape):
                out[n] = t
                continue
            full = tuple(var.shape)
            missing = [a for a in _spec_of(var)
                       if a is not None and a not in self.mesh.shape]
            if missing:
                raise ValueError(f"{n!r} is sharded over {missing}, which "
                                 f"the mesh {self.mesh.shape} lacks")
            if n in plan:
                local = self._zlocal_shape(plan[n], full)
                slicer = lambda x, _e=plan[n]: self._zslice(_e, x)
            else:
                spec = _spec_of(var)
                local = self._local_shape(full, spec)
                slicer = lambda x, _s=spec: self._slice_spec(x, _s)
            shape = tuple(t.shape)
            if shape == local:
                out[n] = t
            elif shape == full:
                out[n] = slicer(torch.as_tensor(t))
            else:
                raise ValueError(f"state {n!r} has shape {shape}: neither "
                                 f"its full shape {full} nor this rank's "
                                 f"shard {local}")
        return out

    def shard_feed(self, program, feeds: Dict[str, torch.Tensor]):
        """(this rank's feeds, the step's StepLayout): dp rows of every
        batch-major feed, the sequence slice of those with a ``SeqAxis`` on
        dim 1.  A :class:`LocalFeed` (``DeviceFeeder(sharding=strategy)``)
        is already the rank's and is taken as it is."""
        if not self.mesh.in_mesh:
            raise RuntimeError(f"rank {self.mesh.rank} is not in the mesh "
                               f"{self.mesh.shape} (a sub-mesh leaves it "
                               f"idle): it cannot run a step under it")
        if isinstance(feeds, LocalFeed):
            self._check_local(program, feeds)
            out, seq_axis, batch = dict(feeds), feeds.seq_axis, feeds.batch
        else:
            out, seq_axis, batch = self._slice_feeds(program, feeds)
        return out, StepLayout(self.mesh, self.data_axis, seq_axis, batch)

    def _check_local(self, program, feeds: "LocalFeed") -> None:
        """Refuse a :class:`LocalFeed` that is not this rank's part of a
        global batch of ``program`` under this Strategy: its global batch
        does not divide over dp, or a batch-major feed of ``program`` does
        not hold batch / dp rows, or a feed ``program`` shards on its
        sequence was not sliced over that sequence (a feeder made for
        another program or another Strategy)."""
        block = program.global_block
        dp = self._dp()[0] if self.data_axis else 1
        for n, t in feeds.items():
            var = block.vars.get(n)
            if var is None or not var.shape or var.shape[0] is not None:
                continue
            if feeds.batch <= 0 or feeds.batch % dp \
                    or int(t.shape[0]) != feeds.batch // dp:
                raise ValueError(
                    f"feed {n!r} holds {int(t.shape[0])} rows of a LocalFeed "
                    f"whose global batch is {feeds.batch}: under "
                    f"{self.data_axis}={dp} a rank holds batch / {dp} rows "
                    f"(was the DeviceFeeder made for another program or "
                    f"Strategy?)")
            seq = seq_axis_of(var)
            if seq is not None and mesh_axis_size(self.mesh, seq) > 1 \
                    and (feeds.seq_axis != seq or getattr(
                        feeds.seq_axis, "striped", False) != seq.striped):
                raise ValueError(
                    f"feed {n!r} is sharded on its sequence over {seq!r}, "
                    f"but the LocalFeed's sequence was sliced over "
                    f"{feeds.seq_axis!r}")

    def local_feed(self, program, feeds) -> "LocalFeed":
        """This rank's part of a global feed dict (numpy arrays or
        tensors, where they lie), marked as the rank's: what
        ``DeviceFeeder(sharding=strategy)`` uploads."""
        feeds = {n: v if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
                 for n, v in feeds.items()}
        out, seq_axis, batch = self._slice_feeds(program, feeds)
        return LocalFeed(out, batch, seq_axis)

    def _slice_feeds(self, program, feeds):
        block = program.global_block
        seq_axis, batch = None, None
        out = {}
        for n, t in feeds.items():
            var = block.vars.get(n)
            if var is None or not var.shape:
                out[n] = t
                continue
            if var.shape[0] is None:
                batch = int(t.shape[0]) if batch is None else batch
                if self.data_axis:
                    dp, r = self._dp()
                    if t.shape[0] % dp:
                        raise ValueError(
                            f"feed {n!r}: batch {t.shape[0]} does not "
                            f"divide over {self.data_axis}={dp}")
                    k = t.shape[0] // dp
                    t = t[r * k:(r + 1) * k]
            spec = _spec_of(var)
            if any(mesh_axis_size(self.mesh, a) > 1 for a in spec[2:]) or (
                    len(spec) > 1 and mesh_axis_size(self.mesh, spec[1]) > 1
                    and seq_axis_of(var) is None):
                raise ValueError(
                    f"feed {n!r} is sharded as {spec}: a feed may shard "
                    f"only its sequence (a SeqAxis on dim 1 of a "
                    f"batch-major feed)")
            seq = seq_axis_of(var)
            if seq is not None and mesh_axis_size(self.mesh, seq) > 1:
                sn = self.mesh.shape[seq]
                T = int(t.shape[1])
                if T % (2 * sn if seq.striped else sn):
                    raise ValueError(
                        f"feed {n!r}: sequence {T} does not divide over "
                        f"{seq}={sn}" + (" x 2 (striped)" if seq.striped
                                         else ""))
                if seq_axis not in (None, seq) \
                        or (seq_axis is not None
                            and seq_axis.striped != seq.striped):
                    raise ValueError(f"sequence-sharded feeds disagree: "
                                     f"{seq_axis!r} and {seq!r}")
                seq_axis = seq
                pos = torch.as_tensor(seq_index(T, sn, self.mesh.coord(seq),
                                                seq.striped), device=t.device)
                t = t.index_select(1, pos)
            out[n] = t.contiguous()
        return out, seq_axis, batch or 0

    # ---------------------------------------------------------- the step
    def plan_batch_ops(self, program, layout: StepLayout) -> None:
        """Put on ``layout.carry`` the ops of ``program`` (sub-blocks
        included) that mix the rows of this step's sharded batch, the
        positions of its sharded sequence or the entries of a dim a model
        axis shards, in a way no op carries itself, each with its
        :class:`Carrier` (``Op.apply`` runs it in the op's place); None
        when there are none.  Under dp such an op is ``reduce_prod`` over
        the batch, or any op not in ``BATCH_CARRIED`` that takes a
        batch-major input and runs along dim 0 (by the axes its layer
        declared, ``Op.axes``, or a dim attribute: ``auc``, the
        evaluators' counts, ``cumsum``, ``argmax``, ``concat``,
        ``softmax``, ``sum_to_one_norm`` of a [None] vector, ...), indexes
        its rows (``gather`` / ``scatter`` of a batch-major x), contracts
        it (``matmul`` / ``mul`` of a batch-major y) or gives an output
        whose dim 0 is not the batch (``matmul(transpose_x=True)``, a norm
        to a scalar, ``pad`` or ``crop`` of the rows, ...); under sp, a
        reduction over dim 0 but not dim 1 of a sequence-sharded input,
        and an op not in ``SEQ_CARRIED`` that runs along dim 1 of one
        (``sequence_reverse``, ``row_conv``, ``dynamic_lstm``, ...) or
        gives an output that is not sharded on that sequence; under a
        model axis (tp, and any axis but the data one), an op not in
        ``MODEL_CARRIED`` that runs along a dim the axis shards
        (``softmax`` or ``accuracy`` over a column-parallel output).  The
        plan is kept per (program version, dp, sequence axis): a step adds
        no Python work but the carried ops' own."""
        dp = (mesh_axis_size(self.mesh, layout.data_axis)
              if layout.data_axis else 1)
        if self.mesh.size == 1:
            return
        key = (program.version, dp, layout.seq_axis)
        plans = self._plans.setdefault(program, {})
        if key not in plans:
            plan = {}
            for block, op in program.all_ops():
                def var(n, _block=block):
                    return (_block.vars.get(n)
                            or program.global_block.vars.get(n))

                why = _mixing(op, var, layout, dp)
                if why is not None:
                    plan[id(op)] = (op, Carrier(op, var, self, layout, why))
            plans[key] = plan or None
        layout.carry = plans[key]

    def sync_grads(self, env, params: Sequence[str], layout: StepLayout,
                   program) -> None:
        """Average the gradients of parameters replicated over the data
        axes (dp, and sp when the sequence is sharded) over them: one
        all-reduce per dtype and axis over a flat bucket."""
        block = program.global_block
        for axis in (layout.data_axis, layout.seq_axis):
            if axis is None:
                continue
            group, n = self.mesh.group(axis), self.mesh.shape[axis]
            names = [p for p in params
                     if axis not in _spec_of(block.vars.get(p))]
            by_dtype: Dict[Any, list] = {}
            for p in names:
                by_dtype.setdefault(env[p + "@GRAD"].dtype, []).append(p)
            for members in by_dtype.values():
                grads = [env[p + "@GRAD"] for p in members]
                flat = comm.all_reduce(
                    torch.cat([g.reshape(-1) for g in grads]), group) / n
                off = 0
                for p, g in zip(members, grads):
                    env[p + "@GRAD"] = flat[off:off + g.numel()].view_as(g)
                    off += g.numel()

    def run_tail(self, units, env, ctx, program) -> None:
        """The optimizer ops after the backward under ZeRO-1 (see the module
        docstring); without it, the ops as the Executor runs them."""
        from ..core.program import Op

        plan = self._program_plan(program) if self.shard_optimizer_state \
            else {}
        if not plan:
            for unit in units:
                if isinstance(unit, Op):
                    unit.apply(env, ctx)
                else:
                    unit[0].apply_group(unit[1], env, ctx)
            return
        whole = set()   # planned names whose env value is full

        def gather(n):
            if n in plan and n not in whole:
                env[n] = self._zgather(plan[n], env[n])
                whole.add(n)

        def scatter(n):
            if n in whole:
                env[n] = self._zslice(plan[n], env[n])
                whole.discard(n)

        for unit in units:
            if isinstance(unit, Op):
                for n in unit.input_names():
                    gather(n)
                unit.apply(env, ctx)
                whole.update(n for n in unit.output_names() if n in plan)
                continue
            group, ops = unit
            saved, sliced = {}, []
            for op in ops:
                for n in op.inputs.get("Step", []):
                    gather(n)
                accs = op.inputs.get("Accums", [])
                for n in accs:
                    scatter(n)
                entry = plan.get(accs[0]) if accs else None
                if entry is None:
                    continue
                p, g = op.inputs["Param"][0], op.inputs["Grad"][0]
                saved[g] = env[g]
                env[p] = self._zslice(entry, env[p])
                env[g] = self._zslice(entry, env[g])
                sliced.append((p, entry))
            group.apply_group(ops, env, ctx)
            env.update(saved)
            for p, entry in sliced:
                env[p] = self._zgather(entry, env[p])
        for n in list(whole):
            scatter(n)

    # ---------------------------------------------------------- fetches
    def fetch_spec(self, program, name: str, t: torch.Tensor,
                   layout: StepLayout) -> list:
        """The mesh axis of each dim of a fetched tensor on this rank."""
        block = program.global_block
        var = block.vars.get(name)
        if var is None:
            return [None] * t.dim()
        base = block.vars.get(name[:-len("@GRAD")]) \
            if name.endswith("@GRAD") else None
        if base is not None and not base.persistable and any(
                mesh_axis_size(self.mesh, a) > 1
                for a in (layout.data_axis, layout.seq_axis)):
            # a rank's term of the loss mean is its own slice's mean
            # (comm.mean_from): its activation gradients are not the
            # single device's
            raise NotImplementedError(
                f"fetch {name!r}: an activation's gradient is not fetched "
                f"under a Strategy that shards the batch or the sequence")
        spec = list(_spec_of(base if base is not None else var))
        spec += [None] * (t.dim() - len(spec))
        if not var.persistable and base is None and var.shape \
                and var.shape[0] is None and layout.data_axis \
                and name not in layout.replicated:
            spec[0] = layout.data_axis
        return spec

    def gather_fetch(self, program, name: str, t: torch.Tensor,
                     layout: StepLayout) -> torch.Tensor:
        block = program.global_block
        var = block.vars.get(name)
        plan = self._program_plan(program)
        if name in plan:
            return self._zgather(plan[name], t)
        for dim, axis in enumerate(self.fetch_spec(program, name, t,
                                                   layout)):
            if axis is None or mesh_axis_size(self.mesh, axis) == 1:
                continue
            order, _ = shard_order(self.mesh, axis, t.shape[dim], t.device)
            t = comm.all_gather(t, self.mesh.group(axis), dim)
            if order is not None:
                t = t.index_select(dim, order)
        if var is not None and var.shape:
            want = tuple(layout.batch if d is None else d for d in var.shape)
            if tuple(t.shape) != want and not (
                    var.shape[0] is None and tuple(t.shape[1:]) == want[1:]):
                raise ValueError(
                    f"fetch {name!r}: gathered shape {tuple(t.shape)} is not "
                    f"the variable's {want}; a variable sharded on a dim "
                    f"its layout does not name cannot be fetched whole")
        return t

    # ---------------------------------------------------------- state I/O
    def gather_state(self, program, scope, names=None) -> Dict[str, np.ndarray]:
        """The full values of the scope's persistable state as numpy arrays
        (collective: every rank calls it; each gets the whole), the
        counterpart of reading a global ``jax.Array``."""
        block = program.global_block
        plan = self._program_plan(program)
        out = {}
        names = sorted(names if names is not None
                       else [v.name for v in program.persistable_vars()
                             if v.name in scope])
        for n in names:
            t = torch.as_tensor(scope.find_var(n))
            var = block.vars.get(n)
            if n in plan:
                t = self._zgather(plan[n], t)
            elif var is not None:
                for dim, axis in enumerate(_spec_of(var)):
                    if axis is not None and mesh_axis_size(self.mesh,
                                                           axis) > 1:
                        t = comm.all_gather(t, self.mesh.group(axis), dim)
            t = t.detach().cpu()
            out[n] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return out

    def shard_arrays(self, program, arrays: Dict[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
        """This rank's shards of full numpy arrays, as tensors on
        ``device`` (the counterpart of ``device_put`` with a
        ``NamedSharding``)."""
        full = {n: torch.from_numpy(np.array(a)).to(device)
                for n, a in arrays.items()}
        return self.local_state(program, full)
