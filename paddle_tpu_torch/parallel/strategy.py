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
  ``min`` over dim 0 and ``batch_norm``'s training statistics give every
  rank the global value (``comm.py``'s gradient convention); an op that
  mixes batch rows in another way (``BATCH_MIXING``, ``reduce_prod`` over
  the batch, and any op that runs along, indexes or contracts the batch
  or moves it out of dim 0: ``_batch_mixing``) is refused before the
  step's first op (:meth:`Strategy.check_batch_ops`).

``Executor.warm`` under a Strategy is ROADMAP A.9 part 3 (NCCL can be
captured in a CUDA graph, gloo cannot) and raises ``WarmError``.
"""
from __future__ import annotations

import json
import math
import weakref
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.dropout import CounterMap
from ..param_attr import PartitionSpec as P
from ..param_attr import seq_axis_of
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

    def counter_map(self, shape: Sequence[int], seq) -> CounterMap:
        """Where this rank's slice of a batch-major tensor of local
        ``shape``, its sequence (dim 1) sharded over ``seq`` or whole
        (None), lies in the global one (the dropout counter)."""
        rows = int(shape[0])
        per_row = int(np.prod(shape[1:], dtype=np.int64))
        base_rows = self.batch_offset(rows)
        if not self.sharded(seq):
            return CounterMap(base=base_rows * per_row)
        n = self.mesh.shape[seq]
        idx = self.mesh.coord(seq)
        t = int(shape[1])
        inner = per_row // t
        stride = t * n * inner
        if not seq.striped:
            return CounterMap(base=base_rows * stride, row=per_row,
                              stride=stride, seg=per_row,
                              off0=idx * t * inner)
        th = t // 2
        seg = th * inner
        return CounterMap(base=base_rows * stride, row=per_row,
                          stride=stride, seg=seg, off0=idx * th * inner,
                          off1=(2 * n - 1 - idx) * th * inner - seg)


# op types whose output mixes the rows of a batch-major input and which the
# port does not carry over a sharded batch (ROADMAP C.13): the metrics,
# the evaluators' batch counts, the beam loss's mean over sequences and
# roi_pool (its rois name rows of the global batch)
BATCH_MIXING = frozenset({
    "accuracy", "auc", "chunk_eval", "accuracy_accumulate",
    "chunk_accumulate", "precision_recall_accumulate",
    "ctc_error_accumulate", "detection_map_accumulate",
    "cross_entropy_over_beam", "roi_pool"})

# op types that carry their reduction over a sharded batch themselves
BATCH_CARRIED = frozenset({"mean", "reduce_sum", "reduce_mean", "reduce_max",
                           "reduce_min", "reduce_prod", "batch_norm",
                           "switch_moe"})

# attributes that name dims of an op's input (``elementwise_*``'s ``axis``
# aligns a broadcast instead); ``stack`` and ``unsqueeze`` count the dims
# of their output, one more
_DIM_ATTRS = ("axis", "dim", "axes")
_NEW_DIM = frozenset({"stack", "unsqueeze"})


def _names_dim0(op, nd: int) -> bool:
    """Whether ``op``'s dim attributes name dim 0 of an ``nd``-dim input."""
    if op.type.startswith("elementwise_"):
        return False
    n = nd + (op.type in _NEW_DIM)
    for k in _DIM_ATTRS:
        v = op.attrs.get(k)
        vals = v if isinstance(v, (list, tuple)) else (v,)
        if n and any(isinstance(d, int) and d % n == 0 for d in vals):
            return True
    return False


def _batch_mixing(op, var) -> Optional[str]:
    """How ``op``, one of whose inputs is batch-major (``var(name)``: the
    variable of a name), mixes the rows of a batch sharded over dp, or
    None when each output row reads only its own input rows."""
    def batch(v):
        return v is not None and bool(v.shape) and v.shape[0] is None

    ins = {s: [var(n) for n in ns] for s, ns in op.inputs.items()}
    first = next(v for vs in ins.values() for v in vs if batch(v))
    if op.type in BATCH_MIXING:
        return f"{op.type!r} mixes the rows of its batch"
    if _names_dim0(op, len(first.shape)):
        return f"{op.type!r} runs along the batch (dim 0)"
    if op.type in ("gather", "scatter") and batch(ins["X"][0]):
        return f"{op.type!r} indexes the rows of a batch-major x"
    if op.type in ("matmul", "mul") and any(
            batch(v) and (op.type == "mul" or len(v.shape) <= 2)
            for v in ins.get("Y", ())):
        return f"{op.type!r} contracts over the batch of its y"
    if not all(batch(var(n)) for n in op.output_names()):
        return f"{op.type!r} takes the batch out of dim 0"
    return None


def _spec_of(var) -> tuple:
    return tuple(getattr(var, "sharding", None) or ())


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
        # program -> the (version, dp, seq) that refused none
        self._checked = weakref.WeakKeyDictionary()

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
        dim 1."""
        if not self.mesh.in_mesh:
            raise RuntimeError(f"rank {self.mesh.rank} is not in the mesh "
                               f"{self.mesh.shape} (a sub-mesh leaves it "
                               f"idle): it cannot run a step under it")
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
        layout = StepLayout(self.mesh, self.data_axis, seq_axis, batch or 0)
        return out, layout

    # ---------------------------------------------------------- the step
    def check_batch_ops(self, program, layout: StepLayout) -> None:
        """Refuse, before the step's first op, a program holding a layer
        whose output mixes batch rows in a way not carried over this
        step's sharded batch or sequence: ROADMAP C.13.  Under dp that is
        an op of ``BATCH_MIXING``, ``reduce_prod`` over dim 0 of a
        batch-major input, and any op not in ``BATCH_CARRIED`` that takes
        a batch-major input and runs along dim 0 (a dim attribute naming
        it: ``cumsum``, ``argmax``, ``concat``, ``softmax``, ...), indexes
        its rows (``gather`` / ``scatter`` of a batch-major x), contracts
        it (``matmul`` / ``mul`` of a batch-major y) or gives an output
        whose dim 0 is not the batch (``matmul(transpose_x=True)``, a
        norm to a scalar, ``pad`` or ``crop`` of the rows, ...); under
        sp, a reduction over dim 0 but not dim 1 of a sequence-sharded
        input."""
        dp = (mesh_axis_size(self.mesh, layout.data_axis)
              if layout.data_axis else 1)
        key = (program.version, dp, layout.seq_axis)
        if (dp == 1 and layout.seq_axis is None) \
                or key in self._checked.get(program, ()):
            return
        from ..layers.tensor import _reduced_dims

        for block, op in program.all_ops():
            def var(n, _block=block):
                return _block.vars.get(n) or program.global_block.vars.get(n)

            batch = [v for v in map(var, op.input_names())
                     if v is not None and v.shape and v.shape[0] is None]
            if not batch or op.special is not None:
                continue
            what = None
            if op.type.startswith("reduce_"):
                dims = _reduced_dims(batch[0], op.attrs.get("axis"))
                seq = seq_axis_of(batch[0])
                if 0 in dims and op.type == "reduce_prod":
                    what = "reduce_prod over the batch"
                elif 0 in dims and 1 not in dims and layout.sharded(seq):
                    what = (f"{op.type} over the batch of a sequence-"
                            f"sharded input, keeping the sequence")
            elif op.type in BATCH_MIXING or (
                    dp > 1 and op.type not in BATCH_CARRIED):
                what = _batch_mixing(op, var)
            if what is not None:
                raise NotImplementedError(
                    f"{what}: not carried over a batch or sequence sharded "
                    f"by the Strategy (mesh {self.mesh.shape}; ROADMAP "
                    f"C.13); run it unsharded")
        self._checked.setdefault(program, set()).add(key)

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
                and var.shape[0] is None and layout.data_axis:
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
            t = comm.all_gather(t, self.mesh.group(axis), dim)
            if getattr(axis, "striped", False):
                n = self.mesh.shape[axis]
                perm = np.concatenate([seq_index(t.shape[dim], n, d, True)
                                       for d in range(n)])
                t = t.index_select(dim, torch.as_tensor(
                    np.argsort(perm), device=t.device))
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
