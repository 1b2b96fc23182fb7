"""Scope + Executor (PyTorch port of ``paddle_tpu/core/executor.py``).

``Executor.run`` runs the whole Program once per call, op by op, eagerly on
the Executor's device: the inputs are (persistable state, feed, step
counter), the outputs (fetches, new persistable state).  The Scope maps
names to tensors on that device.

The backward meta-op: JAX re-traces the forward prefix inside ``jax.grad``
and relies on XLA's CSE to run it once.  Here the forward ops run once,
with the trainable parameters as leaf tensors that require grad; the
``backward`` op calls ``torch.autograd.grad`` on the (scaled, summed) loss,
and every op after it runs under ``torch.no_grad()``.  The new state is
detached.  In an eager run, updated parameters and moments are new
tensors: the scope's old tensors are replaced, not written in place.  A
warmed signature's state tensors (below) are its static buffers, which the
scope holds and every replay updates in place: a tensor taken with
``find_var`` before such a run changes with it (clone it to keep it), as
it never does with the JAX scope or an eager run.  A program with an amp
policy (``amp.enable``) has each op's inputs cast by it before the op
runs (``Op.apply``).  A program with no backward op (an inference program, such
as ``Program.prune``'s) runs with its 3x3 stride-1 convolutions routed onto
the implicit-GEMM kernels (``core/fusion.py``).  Each run of consecutive
optimizer update ops of one group runs as one grouped call
(``Optimizer.apply_group``: multi-tensor kernels).  A program that names an
``anomaly_guard`` (its loss) keeps its old state on a step whose loss or
any gradient is not finite, and fetches a NaN loss (the reference's
``core/executor.py:364-398``), with ``torch.where`` on the device.

``Executor.warm`` prepares one signature, ``(program, program.version,
scope, state names, feeds (name, shape, dtype), fetch names)``, as the
reference's ``warm`` (``paddle_tpu/core/executor.py:443``) compiles one
executable: static state buffers (clones of the scope's tensors, which the
scope then holds), static feed buffers (``core.graphs.Staged``) and, on the
card, the whole step (forward, ``torch.autograd.grad``, clip, updates, the
step increment) captured as ONE CUDA graph that ends by copying the new
state into the static buffers; on the CPU the step body re-run on those
buffers.  Every later ``run()`` of that signature stages its feeds and
the step counter's low 32 bits (``STEP_FIELD``, one upload), from which
the step's random ops draw their keys (``OpContext.rng_key``), and
replays the graph.  ``append_op``, ``amp.enable`` and ``amp.disable`` bump
``program.version`` (the graph holds the ops and the amp policy it was
captured with), so after them ``run()`` finds no warmed signature.
Unlike the reference's key, the signature holds the scope: a graph is
bound to one scope's buffers.  And unlike the
reference's ``run()``, which compiles every new signature, ``run()`` of a
signature not warmed runs eagerly and prepares nothing, since a capture
pins a scope's state into static buffers: the port captures only when
asked, as the reference's Trainer asks (``paddle_tpu/trainer.py:179``).
``compiles`` counts the signatures prepared, as do the
``compile.executor_compiles`` counter and the ``compile.compile_ms``
histogram; each prepared signature registers its flops and bytes (counted
at its first run) in the ``obs.prof`` cost ledger under its
``train_step:<hash>`` key, and every replay ticks that key's sampled
dispatch timing (a sampled replay synchronises the stream before
``tock``).  ``warm(store=compile.AOTStore(d))`` first looks the signature
up in the AOT store (``compile/aot.py``): a stored graph of the step is
loaded and captured in place of the program's step (``loads`` counts
those), and a live preparation writes its traced graph there.

``Executor(strategy=parallel.Strategy(mesh))`` runs the step on this
rank's shard (``parallel/strategy.py``): the feeds sliced to the rank's
rows (and sequence positions; a ``DeviceFeeder(sharding=strategy)``
batch is the rank's already), the state sliced to its shards, the ops
given the mesh and the step's layout in their ``OpContext``, the ops that
mix batch rows run on the whole batch through the Strategy's plan
(``Strategy.plan_batch_ops``), the replicated gradients averaged after
the backward op, the optimizer ops under ZeRO-1 on the rank's slices, the
fetches gathered back whole.  ``warm`` under a Strategy raises
``WarmError`` (gloo's collectives cannot be captured).
"""
from __future__ import annotations

import contextlib
import functools
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.attention import check_flash_dtype, check_flash_head_dim
from ..ops.batch_norm import check_bn_dtype
from ..ops.dropout import check_dropout_dtype
from ..ops.lstm import check_lstm_dtype
from ..obs import metrics as _metrics
from ..obs import prof as _prof
from .fusion import channels_last_feed, route_inference
from .graphs import Graphs, Staged, WarmError, sync
from .program import (
    Op,
    OpContext,
    Program,
    Variable,
    default_main_program,
)
from .types import Place, convert_dtype, dtype_name

# --------------------------------------------------------------------------- Scope


class Scope:
    """Persistable state: name -> torch.Tensor."""

    def __init__(self):
        self._vars: Dict[str, torch.Tensor] = {}
        self.step_counter = 0

    def find_var(self, name: str):
        return self._vars.get(name)

    def var_names(self) -> List[str]:
        return list(self._vars)

    def set_var(self, name: str, value) -> None:
        self._vars[name] = value

    def items(self):
        return self._vars.items()

    def __contains__(self, name: str) -> bool:
        return name in self._vars


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope():
    global _global_scope
    _global_scope = Scope()


def state_out_names(program, state_names):
    """Persistable names the step returns as new state: the incoming state
    plus every persistable an op writes."""
    persistable = {v.name for v in program.persistable_vars()}
    produced = {
        n for op in program.list_ops() for n in op.output_names() if n in persistable
    }
    return sorted(set(state_names) | produced)


# --------------------------------------------------------------------------- helpers


def _check_feed_shape(shape, var: Variable):
    """Validate non-batch dims against the declared var shape at the feed
    boundary, with an error naming the variable."""
    name = var.name
    declared = tuple(var.shape)
    if len(shape) != len(declared):
        raise ValueError(
            f"feed '{name}': rank {len(shape)} (shape {tuple(shape)}) does not "
            f"match declared rank {len(declared)} (shape {declared}); the "
            f"first declared dim is the batch axis unless the var was built "
            f"with append_batch_size=False")
    for i, (got, want) in enumerate(zip(shape, declared)):
        if want is not None and want != -1 and got != want:
            raise ValueError(
                f"feed '{name}': dim {i} is {got} but the variable declares "
                f"{want} (declared shape {declared}, fed shape {tuple(shape)})")


def _as_feed_array(value, var: Optional[Variable], check: bool = True):
    """A feed as a tensor where it lies (the host for numpy), shape-checked
    (unless ``check`` is false: a rank's part of a sharded feed) and cast
    to the declared dtype (int32 ids stay int32: ops that gather convert
    them)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    if var is not None:
        if check:
            _check_feed_shape(tuple(t.shape), var)
        if t.dtype != var.dtype:
            t = t.to(var.dtype)
    return t


def _fetch_name(f: Union[str, Variable]) -> str:
    return f if isinstance(f, str) else f.name


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


# --------------------------------------------------------------------------- Executor


class _Warmed:
    """One warmed signature: ``state`` the static state buffers by name,
    ``feeds`` the staged feeds, ``run`` the step on them prepared
    (``core.graphs.Prepared``: on the card its CUDA graph; its fetches
    land in ``outs["fetches"]``).  The step holds no reference to this
    object or the Executor, so that dropping an Executor frees its graphs
    and their pool."""

    __slots__ = ("what", "state", "feeds", "outs", "run", "sig_key",
                 "load_s")

    def __init__(self, what, state, feeds, outs):
        self.what, self.state, self.feeds = what, state, feeds
        self.outs, self.run, self.sig_key = outs, None, None
        self.load_s = 0.0


# the staged field that carries the step counter's uint32 bits into a
# warmed step (a name no variable can have)
STEP_FIELD = "@step_counter"


def _what(program, feed_sig, fetch_names, state_names) -> str:
    return (f"signature of program version {program.version}, feeds "
            f"{list(feed_sig)}, fetches {list(fetch_names)}, "
            f"{len(state_names)} state tensors")


def _graph_step(gm):
    """A stored graph as a step: ``gm(state, feeds, step word)`` ->
    (fetches, new state), as the program's warmed step."""
    def step(state, feed, step_index, layout=None):
        fetches, new_state = gm(state, feed, step_index)
        return tuple(fetches), dict(new_state)

    return step


def _warmed_body(step, state, feeds, outs) -> None:
    """The step on the static buffers, its step counter read from the
    staged STEP_FIELD: it ends by copying each new state tensor into its
    static buffer (one multi-tensor copy)."""
    fetches, new_state = step(
        state, {n: v for n, v in feeds.items() if n != STEP_FIELD},
        feeds[STEP_FIELD])
    dst, src = [], []
    for n, v in new_state.items():
        if v.data_ptr() != state[n].data_ptr():
            dst.append(state[n])
            src.append(v)
    if dst:
        torch._foreach_copy_(dst, src)
    outs["fetches"] = fetches


class Executor:
    """Runs Programs on one device: ``Executor()`` is the CUDA card (and
    raises when there is none), ``Executor(CPUPlace())`` the host.

    ``compiles`` counts the signatures ``warm`` prepared live, ``loads``
    those it prepared from an AOT store's graph, and ``replays``
    the runs of warmed signatures (graph replays on the card, body runs on
    the CPU).  ``run`` of a warmed signature is safe from many threads: one
    lock per Executor covers the state copy-in, the staging, the replay and
    the fetch copies (the signature's buffers are static).  Eager runs,
    and ``warm``, take no lock: call them from one thread."""

    def __init__(self, place: Optional[Place] = None, strategy=None):
        self.strategy = strategy  # paddle_tpu_torch.parallel.Strategy or None
        self.place = place or Place("gpu", 0)
        self.device = self.place.torch_device()
        if strategy is not None and place is None:
            # one rank per device: the device distributed.init chose
            from .. import distributed

            self.device = distributed.device()
        self._cache: Dict[tuple, _Warmed] = {}
        self._graphs = Graphs(self.device)
        self._lock = threading.Lock()
        # held over each preparation (capture) when set: a Trainer shares
        # it with its checkpoint restore (``Trainer.prepare``)
        self.capture_lock: Optional[threading.Lock] = None
        self.compiles = 0
        self.loads = 0
        self.replays = 0
        # seconds of each warm's stages, by signature key: "how", the
        # store's "load_s" or the live path's "lookup_s", "first_run_s",
        # "capture_s" (the card), "persist_s" (of it "trace_s" and
        # "write_s") and "total_s"
        self.timings: Dict[str, Dict[str, Any]] = {}

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        program = program or default_main_program()
        check_kernel_shapes(program, self.device)
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        scope = scope or global_scope()

        block = program.global_block
        # a feed a DeviceFeeder(sharding=strategy) staged is the rank's part
        # already: its batch and sequence dims are not the variable's
        local = False
        if self.strategy is not None:
            from ..parallel.strategy import LocalFeed

            local = isinstance(feed, LocalFeed)
        feed_vals = {name: _as_feed_array(value, block.vars.get(name),
                                          check=not local)
                     for name, value in feed.items()}
        fetch_names = [_fetch_name(f) for f in fetch_list]
        state_in_names = sorted(self._state_in_names(program, scope,
                                                     feed_vals, fetch_names))
        if self._cache:
            feed_sig = tuple(sorted((n, tuple(v.shape), dtype_name(v.dtype))
                                    for n, v in feed_vals.items()))
            sig = self._cache.get(self._cache_key(
                program, scope, state_in_names, feed_sig, fetch_names))
            if sig is not None:
                return self._replay(sig, scope, feed_vals, return_numpy)
        feed_vals = {n: v.to(self.device) for n, v in feed_vals.items()}
        step = self._build_step(program, state_in_names, fetch_names)
        state = {n: scope.find_var(n) for n in state_in_names}
        layout, strategy = None, self.strategy
        if strategy is not None:
            if local:
                feed_vals = type(feed)(feed_vals, feed.batch, feed.seq_axis)
            feed_vals, layout = strategy.shard_feed(program, feed_vals)
            strategy.plan_batch_ops(program, layout)
            state = strategy.local_state(program, state)
        fetches, new_state = step(state, feed_vals, scope.step_counter,
                                  layout)
        scope.step_counter += 1
        if strategy is not None:
            new_state = strategy.local_state(program, new_state)
            strategy.report_coverage(program, set(state) | set(new_state))
            fetches = [strategy.gather_fetch(program, n, v, layout)
                       for n, v in zip(fetch_names, fetches)]
        for n, v in new_state.items():
            scope.set_var(n, v)
        if return_numpy:
            fetches = [_to_numpy(v) for v in fetches]
        return fetches

    @staticmethod
    def _cache_key(program, scope, state_names, feed_sig, fetch_names):
        """The one signature key, shared by ``run()`` and ``warm()``.
        ``feed_sig``: sorted (name, shape, dtype name).  Program and scope
        by reference: a collected object's id cannot alias a new one."""
        return (program, program.version, scope, tuple(sorted(state_names)),
                tuple(feed_sig), tuple(fetch_names))

    def warm(self, program: Program, feed_sig, fetch_names,
             scope: Optional[Scope] = None, store=None) -> str:
        """Prepare the signature of ``program`` run on ``scope`` with feeds
        ``feed_sig`` (an iterable of (name, shape, dtype)) and fetches
        ``fetch_names``, before its first batch (the reference's ``warm``,
        ``paddle_tpu/core/executor.py:443``).  Returns how:

          ``"cached"``      this Executor has it already;
          ``"aot_exec"``    its traced graph unpickled from ``store``,
                            then captured;
          ``"compiled"``    the step built from the program and captured
                            (and, with ``store``, traced and written to it
                            for the next process, best-effort).

        ``store``: a ``compile.AOTStore``.  Every store problem (a miss,
        version skew, a quarantined entry, a graph that fails its first
        run) degrades to the live preparation; a step that cannot be
        traced whole (a kernel launched outside a custom op, a host read)
        is not stored.  The ``obs.prof`` ledger's sidecar lives beside the
        store, so a loaded signature whose costs it knows skips the counted
        first run.

        Allocates static state buffers, clones of the scope's tensors, and
        static feed buffers; on the card runs the step once eagerly on a
        side stream and captures it as one CUDA graph (on the CPU runs it
        once); then copies the scope's values back into the static buffers
        and points the scope's names at them.  So warm changes no state and
        not ``step_counter``; but from then on the scope's state tensors of
        this signature are its static buffers, and every ``run()`` of it
        writes the new state into them in place (clone a ``find_var``
        result to keep it).  ``capture_lock``, when set, is held over
        that preparation, so that another thread's device work (a
        checkpoint restore) cannot break a capture.  Raises
        ``WarmError``, naming the signature, when the live first run or the
        capture fails, and before any of it for a program that reads a
        device value on the host (:func:`check_capturable`), which the
        reference's ``warm`` compiles and a CUDA graph cannot hold."""
        if self.strategy is not None:
            raise WarmError(
                "warm under a Strategy is not ported yet "
                "(ROADMAP A.9 part 3: NCCL collectives can be captured in a "
                "CUDA graph, gloo's cannot); run() runs the sharded step "
                "eagerly")
        check_capturable(program)
        scope = scope or global_scope()
        check_kernel_shapes(program, self.device)
        block = program.global_block
        sig_feeds = []
        for n, shape, dtype in feed_sig:
            shape, dtype = tuple(int(d) for d in shape), convert_dtype(dtype)
            var = block.vars.get(n)
            if var is not None:
                _check_feed_shape(shape, var)
                if dtype != var.dtype:
                    raise ValueError(
                        f"warm: feed {n!r} is {dtype_name(dtype)} but the "
                        f"variable declares {dtype_name(var.dtype)}; run() "
                        f"casts every feed to the declared dtype")
            sig_feeds.append((n, shape, dtype_name(dtype)))
        feed_sig = tuple(sorted(sig_feeds))
        fetch_names = [_fetch_name(f) for f in fetch_names]
        state_names = sorted(self._state_in_names(
            program, scope, {n: None for n, _, _ in feed_sig}, fetch_names))
        key = self._cache_key(program, scope, state_names, feed_sig,
                              fetch_names)
        if key in self._cache:
            return "cached"
        t0 = time.perf_counter()
        sig_key = self._train_sig_key(program, feed_sig, fetch_names)
        what = _what(program, feed_sig, fetch_names, state_names)
        prof_fp = _prof.fingerprint(
            "train_step", sig_key, what,
            sorted(str(torch.as_tensor(scope.find_var(n)).dtype)
                   for n in state_names))
        sig, how, fp = None, "compiled", None
        if store is not None:
            store.activate()
            _prof.attach_ledger_near_store(store.dirname)
            fp = self._fingerprint(program, scope, state_names, feed_sig,
                                   fetch_names)
            sig = self._load(store, fp, prof_fp, program, scope,
                             state_names, feed_sig, fetch_names, what)
            if sig is not None:
                how = "aot_exec"
        t_live = time.perf_counter()
        if sig is None:
            sig = self._prepare(program, scope, state_names, feed_sig,
                                fetch_names, what)
        ms = (time.perf_counter() - t0) * 1e3
        self._cache[key] = sig
        sig.sig_key = sig_key
        if how == "compiled":
            self.compiles += 1
            _metrics.counter("compile.executor_compiles").inc()
            _metrics.histogram("compile.compile_ms").observe(ms)
        else:
            self.loads += 1
            _metrics.histogram("compile.aot_load_ms").observe(ms)
        _prof.register(prof_fp, label="train_step", sig_key=sig_key,
                       source="live" if how == "compiled" else how,
                       compile_ms=ms, cost=sig.run.cost)
        timings = {"how": how, **sig.run.timings}
        if how == "compiled":
            timings["lookup_s"] = t_live - t0
        else:
            timings["load_s"] = sig.load_s
        if how == "compiled" and store is not None:
            t1 = time.perf_counter()
            timings.update(self._persist(store, fp, program, sig,
                                         state_names, fetch_names))
            timings["persist_s"] = time.perf_counter() - t1
        timings["total_s"] = time.perf_counter() - t0
        self.timings[sig_key] = timings
        return how

    def _fingerprint(self, program, scope, state_names, feed_sig,
                     fetch_names) -> str:
        """The AOT store's key of one signature (the reference's recipe):
        the program text, its version, amp policy, anomaly guard and step
        seed, every state tensor's shape and dtype, the feeds, the fetches
        and the device; ``compile.aot.fingerprint`` adds the torch, CUDA
        and kernel versions."""
        from .. import flags as _flags
        from ..compile import aot

        extra = repr((repr(getattr(program, "amp_policy", None)),
                      getattr(program, "anomaly_guard", None),
                      program.version,
                      program.random_seed or _flags.get("seed") or 0))
        state = []
        for n in state_names:
            v = torch.as_tensor(scope.find_var(n))
            state.append((n, tuple(v.shape), dtype_name(v.dtype)))
        return aot.fingerprint(
            "train_step", program.to_string(),
            (tuple(state), tuple(feed_sig), tuple(fetch_names)),
            backend=aot.backend_of(self.device), extra=extra)

    def _load(self, store, fp, prof_fp, program, scope, state_names,
              feed_sig, fetch_names, what):
        """The store's graph for ``fp`` prepared as the signature's step.
        Returns the signature, or None on a miss or when the loaded graph
        fails."""
        t0 = time.perf_counter()
        gm = store.get_executable(fp)
        if gm is None:
            return None
        load_s = time.perf_counter() - t0
        known = _prof.ledger().costs(prof_fp)
        count = known is None or known.get("flops") is None
        try:
            sig = self._prepare(program, scope, state_names, feed_sig,
                                fetch_names, what, step=_graph_step(gm),
                                count=count)
            sig.load_s = load_s
            return sig
        except WarmError as exc:
            import sys

            sys.stderr.write(f"paddle_tpu_torch compile: the stored step "
                             f"{fp[:16]} failed ({exc}); preparing it live\n")
            return None

    def _persist(self, store, fp, program, sig, state_names,
                 fetch_names) -> Dict[str, float]:
        """Trace the signature's step and write it to the store
        (``AOTStore.persist``, best-effort): a step that cannot be traced
        whole, or whose graph's custom-op nodes disagree with the launches
        of its live first run, is not stored and this process keeps its
        live step.  Under ``capture_lock``: pickling may copy a device
        constant to the host, which would break another thread's
        capture."""
        from ..compile import aot

        def graph():
            step = self._build_step(program, state_names, fetch_names,
                                    warmed=True)
            feeds = sig.feeds.t
            gm = aot.trace_step(lambda st, fd, s: step(st, fd, s),
                                dict(sig.state),
                                {n: v for n, v in feeds.items()
                                 if n != STEP_FIELD},
                                feeds[STEP_FIELD])
            aot.check_launches(aot.custom_op_counts(gm), sig.run.launches)
            return gm

        return store.persist(fp, graph, {"label": "train_step",
                                         "what": sig.what},
                             lock=self.capture_lock)

    @staticmethod
    def _train_sig_key(program, feed_sig, fetch_names) -> str:
        """The dispatch-timing key of one warmed step, the reference's
        recipe (``paddle_tpu/core/executor.py::_train_sig_key``): a hash
        of the program text and version, the feeds and the fetches, so
        that two programs never share a timing row."""
        h = hashlib.sha1(
            repr((program.to_string(), program.version, tuple(feed_sig),
                  tuple(fetch_names))).encode()).hexdigest()
        return f"train_step:{h[:8]}"

    def _prepare(self, program, scope, state_names, feed_sig, fetch_names,
                 what, step=None, count=True):
        """Static buffers and the prepared step (``step``: a loaded graph's,
        else the program's), under ``capture_lock`` when set."""
        with self.capture_lock or contextlib.nullcontext():
            return self._prepare_locked(program, scope, state_names,
                                        feed_sig, fetch_names, what, step,
                                        count)

    def _prepare_locked(self, program, scope, state_names, feed_sig,
                        fetch_names, what, step, count):
        missing = sorted(set(state_out_names(program, state_names))
                         - set(state_names))
        if missing:
            raise WarmError(
                f"warming the {what} failed: the step writes persistable "
                f"variables the scope does not hold ({missing[:4]}); run "
                f"the startup program first")
        dev = self.device
        state = {}
        for n in state_names:
            v = torch.as_tensor(scope.find_var(n))
            state[n] = torch.empty_like(v, device=dev).copy_(v)
        feeds = Staged([(n, shape, convert_dtype(dt))
                        for n, shape, dt in feed_sig]
                       + [(STEP_FIELD, (), np.uint32)], dev)
        outs: Dict[str, Any] = {}
        if step is None:
            step = self._build_step(program, state_names, fetch_names,
                                    warmed=True)
        body = functools.partial(_warmed_body, step, state, feeds.t, outs)
        sig = _Warmed(what, state, feeds, outs)
        try:
            sig.run = self._graphs.prepare(body, count=count)
        except Exception as exc:  # noqa: BLE001 — re-raised as WarmError
            raise WarmError(f"warming the {what} failed: {exc}") from exc
        # the first run moved the static buffers: back to the scope's values
        with torch.no_grad():
            for n, buf in state.items():
                buf.copy_(torch.as_tensor(scope.find_var(n)))
        for n, buf in state.items():
            scope.set_var(n, buf)
        return sig

    def _replay(self, sig: _Warmed, scope: Scope, feed_vals,
                return_numpy: bool):
        """Run a warmed signature: copy in any state the scope no longer
        holds in its static buffer (a ``set_var`` since the last run, such
        as a checkpoint load), stage the feeds with the step counter (its
        low 32 bits, the reference's ``np.uint32(step_counter)``; one
        upload), replay (card) or run the body (CPU), and fetch copies,
        which the next replay leaves alone; all under the lock."""
        with self._lock:
            return self._replay_locked(sig, scope, feed_vals, return_numpy)

    def _replay_locked(self, sig: _Warmed, scope: Scope, feed_vals,
                       return_numpy: bool):
        with torch.no_grad():
            for n, buf in sig.state.items():
                cur = scope.find_var(n)
                if cur is not buf:
                    cur = torch.as_tensor(cur)
                    if tuple(cur.shape) != tuple(buf.shape):
                        raise ValueError(
                            f"scope variable {n!r} has shape "
                            f"{tuple(cur.shape)}, its warmed signature "
                            f"{tuple(buf.shape)}")
                    buf.copy_(cur)
                    scope.set_var(n, buf)
        t_prof = _prof.tick(sig.sig_key)
        try:
            sig.feeds.stage({**feed_vals, STEP_FIELD: np.array(
                scope.step_counter & 0xFFFFFFFF, np.uint32).view(np.int32)})
            sig.run.replay()
            if t_prof is not None:
                sync(self.device)
                _prof.tock(sig.sig_key, t_prof)
        except Exception as exc:  # noqa: BLE001 — re-raised as WarmError
            raise WarmError(f"replaying the {sig.what} failed: "
                            f"{exc}") from exc
        self.replays += 1
        scope.step_counter += 1
        fetches = sig.outs["fetches"]
        if return_numpy:
            return [_to_numpy(v) for v in fetches]
        return [v.clone() for v in fetches]

    def _state_in_names(self, program, scope, feed_vals, fetch_names):
        referenced, produced, read_first = set(), set(), set()
        for op in program.global_block.ops:
            for n in op.input_names():
                referenced.add(n)
                if n not in produced:
                    read_first.add(n)
            for n in op.output_names():
                referenced.add(n)
                produced.add(n)
        names = []
        for v in program.persistable_vars():
            n = v.name
            if n in feed_vals or (n not in referenced and n not in fetch_names):
                continue
            if n in scope:
                names.append(n)
            elif n in read_first or n not in produced:
                raise RuntimeError(
                    f"persistable variable {n!r} is read by the program before any op "
                    f"produces it and is not in the scope — did you run the startup "
                    f"program? (ref executor.cc:78-88 var creation)"
                )
        return names

    def build_raw_step(self, program: Program, feed_names, fetch_names,
                       scope: Scope):
        """Return (step_fn, state_dict): the whole-program step
        ``step_fn(state, feed, step) -> (fetches, new_state)`` and the
        current persistable state, for harnesses that drive the step
        themselves (benchmarks, entry points)."""
        check_kernel_shapes(program, self.device)
        feed_stub = {n: None for n in feed_names}
        state_names = sorted(self._state_in_names(program, scope, feed_stub,
                                                  fetch_names))
        fn = self._build_step(program, state_names, fetch_names)
        state = {n: scope.find_var(n) for n in state_names}
        return fn, state

    def _build_step(self, program: Program, state_names, fetch_names,
                    warmed: bool = False):
        amp = getattr(program, "amp_policy", None)
        # the anomaly guard (the reference's, paddle_tpu/core/executor.py:
        # 364-398): when the program names a guard loss, a step whose loss
        # or any gradient is not finite keeps the old state and its fetched
        # loss reads NaN, all on the device (torch.where), so it lives in a
        # warmed step's graph too
        guard = getattr(program, "anomaly_guard", None)
        ops = program.list_ops()
        out_names = state_out_names(program, state_names)
        bops = [i for i, op in enumerate(ops) if op.special == "backward"]
        if len(bops) > 1:
            raise NotImplementedError(
                "more than one backward op in a program is not ported")
        routed = None if bops else route_inference(program, fetch_names, amp)
        if routed is not None:
            ops = routed
        device = self.device
        from .. import flags as _flags

        # the reference's step seed: the program's, else the seed flag
        seed = program.random_seed or _flags.get("seed") or 0
        head = ops[:bops[0] + 1] if bops else ops
        tail = _grouped(ops[bops[0] + 1:]) if bops else []
        strategy = self.strategy
        mesh = strategy.mesh if strategy is not None else None

        def step(state, feed, step_index, layout=None):
            ctx = OpContext(seed, step_index, device, amp, warmed, mesh=mesh,
                            layout=layout)
            if routed is not None:
                feed = channels_last_feed(feed)
            env: Dict[str, Any] = {}
            env.update(state)
            env.update(feed)
            if bops:
                # the forward runs once, on leaf parameters that require grad
                for p in ops[bops[0]].attrs["params"]:
                    env[p] = env[p].detach().requires_grad_(True)
            with torch.enable_grad() if bops else torch.no_grad():
                for op in head:
                    if op.special == "backward":
                        _apply_backward(op, env)
                        if layout is not None:
                            strategy.sync_grads(env, op.attrs["params"],
                                                layout, program)
                    else:
                        op.apply(env, ctx)
            with torch.no_grad():
                if strategy is not None:
                    strategy.run_tail(tail, env, ctx, program)
                else:
                    for unit in tail:
                        if isinstance(unit, Op):
                            unit.apply(env, ctx)
                        else:
                            unit[0].apply_group(unit[1], env, ctx)
            new_state = {n: env[n].detach() for n in out_names if n in env}
            if guard is not None and guard in env \
                    and env[guard].is_floating_point():
                with torch.no_grad():
                    new_state = _guarded(env, guard, state, new_state)
            fetches = tuple(env[n].detach() for n in fetch_names)
            return fetches, new_state

        return step


def _guarded(env, guard: str, state, new_state):
    """The anomaly guard: ``ok`` is all(isfinite) over the guard loss and
    every gradient (not isfinite of a sum, which a large finite loss could
    overflow); where not ``ok``, ``env[guard]`` becomes NaN and each state
    tensor the step read keeps its old value.  Returns the new state."""
    ok = torch.isfinite(env[guard]).all()
    for n, v in env.items():
        if n.endswith("@GRAD"):
            ok = ok & torch.isfinite(v).all()
    env[guard] = torch.where(ok, env[guard],
                             torch.full_like(env[guard], float("nan")))
    return {n: (torch.where(ok, v, state[n]) if n in state else v)
            for n, v in new_state.items()}


def _grouped(ops: Sequence[Op]) -> list:
    """``ops`` with each run of consecutive update ops of one group as one
    ``(group, [ops])`` unit, the other ops as they are."""
    units: list = []
    for op in ops:
        if op.group is None:
            units.append(op)
        elif units and isinstance(units[-1], tuple) \
                and units[-1][0] is op.group:
            units[-1][1].append(op)
        else:
            units.append((op.group, [op]))
    return units


# --------------------------------------------------------------------------- capture


def check_capturable(program: Program) -> None:
    """Raise ``WarmError`` if an op of ``program`` (sub-blocks included)
    reads a device value on the host every run: a ``Print`` op, a ``cond``
    op, or a ``while_loop`` without ``max_trip_count``.  A CUDA graph replays one
    fixed path, so such a step cannot be captured; ``run()`` runs it
    eagerly.  ``while_loop(max_trip_count=N)`` and ``IfElse`` compute
    both ways on the device and capture."""
    for _, op in program.all_ops():
        if op.type == "print":
            raise WarmError(
                f"warm: the program holds a Print op (outputs "
                f"{op.output_names()[:2]}), which reads its values on the "
                f"host every run, and a CUDA graph cannot call the host; "
                f"run() runs such a program eagerly")
        if op.type == "cond" or (op.type == "while_loop"
                                 and op.attrs.get("max_trip_count") is None):
            what = ("a cond op" if op.type == "cond"
                    else "a while_loop op with no max_trip_count")
            raise WarmError(
                f"warm: the program holds {what} (outputs "
                f"{op.output_names()[:2]}), which reads its predicate on "
                f"the host every run, and a CUDA graph cannot branch on the "
                f"device; run() runs such a program eagerly.  "
                f"while_loop(max_trip_count=N) and IfElse capture")


# --------------------------------------------------------------------------- kernel shapes


def check_kernel_shapes(program: Program, device: torch.device) -> None:
    """On a CUDA device, raise on an op whose kernel would refuse its shape
    or its dtype, with the kernel's own message:

    * the flash attention op (``attention``, from
      ``models.attention_core``) with a head dim outside the kernels'
      ``FLASH_HEAD_DIMS``, or a compute dtype other than float32 or
      bfloat16; so too ``scaled_dot_product_attention`` (``nets``) where
      its value heads are as wide as its key heads (it then runs the flash
      kernels; with other widths it runs plain torch ops);
    * a training ``batch_norm`` (not ``is_test``) in a program with a
      backward op, whose backward runs the batch-norm kernels, in anything
      but float32 or bfloat16;
    * ``dynamic_lstm`` in anything but float32;
    * a training ``dropout`` (not ``is_test``) in anything but float32 or
      bfloat16.

    Ops inside an op's sub-block (``layers.recompute``'s, and the body of
    a ``static_rnn`` op, ``StaticRNN`` / ``DynamicRNN``) are checked too.
    A compute dtype is the input's declared dtype as the program's amp
    policy casts it for that op.  The conv kernels' dtypes need no check:
    ``core/fusion.py`` routes only the convs they take.  The check lives
    here and not in the layers: a program is built without knowing where
    it will run, and the CPU runs every shape and dtype on the plain
    versions.  ``Executor.run`` calls it before the step's first op, so a
    refused program changes no parameter or optimizer state."""
    if device.type != "cuda":
        return
    amp = getattr(program, "amp_policy", None)
    has_backward = any(op.special == "backward"
                       for op in program.list_ops())

    for block, op in program.all_ops():
        def var_of(slot):
            name = op.inputs[slot][0]
            return block.vars.get(name) or program.global_block.vars[name]

        def dtype_of(slot):
            dtype = var_of(slot).dtype
            return dtype if amp is None else amp.input_dtype(
                op.type, op.attrs, dtype)

        if op.type == "attention":
            hd = var_of("Q").shape[-1]
            check_flash_head_dim(hd // op.attrs["n_heads"])
            check_flash_dtype(dtype_of("Q"))
        elif op.type == "scaled_dot_product_attention":
            heads = op.attrs["num_heads"]
            hd = var_of("Q").shape[-1] // heads
            if var_of("V").shape[-1] // heads == hd:
                check_flash_head_dim(hd)
                check_flash_dtype(dtype_of("Q"))
        elif (op.type == "batch_norm" and has_backward
              and not op.attrs.get("is_test")):
            check_bn_dtype(dtype_of("X"))
        elif op.type == "dynamic_lstm":
            check_lstm_dtype(dtype_of("Input"))
        elif op.type == "dropout" and not op.attrs.get("is_test"):
            check_dropout_dtype(dtype_of("X"))


# --------------------------------------------------------------------------- backward


def _apply_backward(bop: Op, env) -> None:
    """The autodiff meta-op: gradients of the (summed, scaled) loss with
    respect to the leaf parameters, as ``<param>@GRAD``; the parameters are
    detached again for the ops that follow.  A parameter the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives."""
    loss = env[bop.attrs["loss"]]
    params = bop.attrs["params"]
    if loss.dim() > 0:
        loss = loss.sum()
    leaves = [env[p] for p in params]
    grads = torch.autograd.grad(loss * bop.attrs.get("loss_scale", 1.0),
                                leaves, allow_unused=True)
    for p, leaf, g in zip(params, leaves, grads):
        env[p + "@GRAD"] = torch.zeros_like(leaf) if g is None else g
        env[p] = leaf.detach()
