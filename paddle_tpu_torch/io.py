"""Persistence (PyTorch port of ``paddle_tpu/io.py``): parameter save/load,
checkpoints with checksums and resume, and the inference artifact.

Reference map:
  - save/load persistables       fluid/io.py:81,143; save_op.cc/load_op.cc
  - checkpoint w/ CRC + meta     go/pserver/service.go:119-201,270-276
  - save_inference_model         fluid/io.py:165 (prune to feed/fetch targets)

The on-disk layout is the JAX package's, plain npz and json: one
``{tag}.npz`` per blob (written to a temp file, fsynced, renamed) beside a
``{tag}.meta.json`` with its sha256; ``ckpt-N`` directories with
``state.json`` and a ``latest`` pointer.  So a checkpoint either package
writes for a program restores into the other wherever the persistable
names agree.  Arrays are saved as numpy (bfloat16 as float32) and loaded
back as tensors on the device, and in the dtype, of the scope's variable
of the same name (a name the scope lacks: on ``device``, the card unless
the caller names another).

The inference artifact differs from the reference's StableHLO: the port's
ops are Python closures, and its kernels launch through ``ctypes``, which
neither a serialized Program nor ``torch.export`` can carry.  So
``save_inference_model`` writes ``model.pt2``, ``torch.export`` of the
pruned program's forward with the parameters as an argument, in which
every kernel an inference program can reach is one node of a custom op of
the ``paddle_tpu_torch`` namespace (``flash_fwd``, ``lstm_fwd``,
``conv_igemm``, ``conv_igemm_fused``: the kernel on CUDA tensors, the
plain version on CPU ones); ``params.npz`` with its meta file; and
``inference.json`` with the reference's schema.  A symbolic batch dim is
exported first and the fixed ``example_batch`` is the fallback, as in the
reference.

The checkpoint paths count and time themselves with the reference's names
(``ckpt.saves``, ``ckpt.save_ms``, ``ckpt.restores``, ``ckpt.restore_ms``,
``resilience.ckpt_fallbacks``; spans ``ckpt.save``, ``ckpt.restore``), and
each signature an ``InferenceModel`` prepares counts ``serving.jit_traces``
and registers its flops and bytes in the ``obs.prof`` cost ledger.

ROADMAP A.10 holds the rest of the reference's surface here:
``export_serving_model`` (the native host), the artifact's AOT hooks
(``install``, ``aot_compile``, ``artifact_hash``, ``installed_count``) and
mesh hooks (``shard``, ``place_feeds``, ``serving_mesh``); each hook raises
naming it.

Fault sites (``resilience/faults.py``): ``ckpt.write`` (a checkpoint
save) and ``ckpt.load`` (every blob load).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import zipfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import profiler
from ._device import resolve_device
from .core.executor import (Executor, Scope, _to_numpy, check_capturable,
                            global_scope)
from .core.graphs import Graphs, Staged, WarmError
from .core.program import Program, Variable, default_main_program
from .core.types import convert_dtype, dtype_name
from .obs import metrics as _metrics
from .obs import prof as _prof
from .obs import trace as _trace
from .resilience import faults


class CheckpointStrategyMismatch(RuntimeError):
    """The checkpoint was saved under a packed ZeRO-1 strategy and cannot be
    restored without a matching one."""


class CheckpointCorrupt(IOError):
    """The checkpoint's bytes are wrong: checksum mismatch (or, from
    restore(), every candidate quarantined).  Distinct from environment
    OSErrors (EIO, EMFILE, stale NFS), which must never quarantine an
    intact checkpoint."""


# errors that mean THIS CHECKPOINT is damaged (checksum mismatch, truncated
# npz or json, files missing from a half-written dir): only these may
# trigger the destructive quarantine; environment errors propagate after
# the in-place retry instead of discarding intact checkpoints
_CORRUPTION_ERRORS = (CheckpointCorrupt, FileNotFoundError, ValueError,
                      KeyError, EOFError, zipfile.BadZipFile)

_A10 = "ROADMAP A.10"


# --------------------------------------------------------------------------- params


def _host_copy(value) -> np.ndarray:
    """A numpy copy of a scope value, taken now: a warmed step updates its
    static buffers in place, and a background save must not see that."""
    t = torch.as_tensor(value)
    a = _to_numpy(t)
    return a.copy() if t.device.type == "cpu" else a


def _collect(program: Program, scope: Scope, predicate) -> Dict[str, np.ndarray]:
    out = {}
    for v in program.persistable_vars():
        if predicate(v) and v.name in scope:
            out[v.name] = _host_copy(scope.find_var(v.name))
    return out


def _executor_device(executor):
    return executor.device if isinstance(executor, Executor) else None


def save_params(executor, dirname: str, main_program: Optional[Program] = None,
                scope: Optional[Scope] = None):
    """Trainable parameters only (fluid io.py save_params)."""
    program = main_program or default_main_program()
    names = {p.name for p in program.parameters()}
    _save_blob(dirname, "params",
               _collect(program, scope or global_scope(),
                        lambda v: v.name in names))


def save_persistables(executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None):
    """Everything persistable: parameters, optimizer accumulators, BN
    statistics, counters: a full training state (fluid io.py
    save_persistables)."""
    _save_blob(dirname, "persistables",
               _collect(main_program or default_main_program(),
                        scope or global_scope(), lambda v: True))


def load_params(executor, dirname: str, main_program: Optional[Program] = None,
                scope: Optional[Scope] = None):
    _load_blob(dirname, "params", scope or global_scope(),
               _executor_device(executor))


def load_persistables(executor, dirname: str,
                      main_program: Optional[Program] = None,
                      scope: Optional[Scope] = None):
    _load_blob(dirname, "persistables", scope or global_scope(),
               _executor_device(executor))


def _save_blob(dirname: str, tag: str, arrays: Dict[str, np.ndarray]):
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, f"{tag}.npz")
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic (go checkpoint: temp + rename)
    meta = {"tag": tag, "sha256": _sha256(path), "time": time.time(),
            "n_arrays": len(arrays)}
    with open(os.path.join(dirname, f"{tag}.meta.json"), "w") as f:
        json.dump(meta, f)


def _verified_npz(dirname: str, tag: str):
    """``{tag}.npz`` of ``dirname``, its sha256 checked against the meta file
    when there is one (CheckpointCorrupt on a mismatch)."""
    faults.check("ckpt.load")
    path = os.path.join(dirname, f"{tag}.npz")
    meta_path = os.path.join(dirname, f"{tag}.meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        digest = _sha256(path)
        if digest != meta["sha256"]:
            raise CheckpointCorrupt(
                f"checkpoint {path} checksum mismatch "
                f"(got {digest[:12]}, meta {meta['sha256'][:12]}): refusing "
                f"to load a corrupt checkpoint (cf. go/pserver CRC check)")
    return np.load(path)


def _load_blob(dirname: str, tag: str, scope: Scope, device=None):
    """Every array of the verified blob into ``scope``: on the device and
    in the dtype of the scope's tensor of that name, else on ``device``.
    All arrays are read before the scope changes."""
    data = _verified_npz(dirname, tag)
    arrays = {name: data[name] for name in data.files}
    for name, a in arrays.items():
        old = scope.find_var(name)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if isinstance(old, torch.Tensor):
            t = t.to(device=old.device, dtype=old.dtype)
        else:
            t = t.to(resolve_device(device))
        scope.set_var(name, t)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# --------------------------------------------------------------------------- checkpoint


class CheckpointManager:
    """Periodic training checkpoints with integrity metadata and resume (the
    Go pserver's checkpoint loop, service.go:119-156, plus the master's
    dataset cursor snapshot), with the metadata in a ``latest`` pointer
    file updated atomically.

    Under a ``parallel.Strategy`` every rank calls ``save`` (the state is
    gathered whole, ``Strategy.gather_state``, a collective) and writes the
    directory it was given; ``restore`` puts the whole arrays into the
    scope, and the next run slices each rank's shard."""

    def __init__(self, dirname: str, max_to_keep: int = 3):
        self.dirname = dirname
        self.max_to_keep = max_to_keep
        self._pending = None  # in-flight background save thread
        self._pending_error = None
        self._fallbacks_counted: set = set()  # corrupt steps already counted
        os.makedirs(dirname, exist_ok=True)

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.dirname, f"ckpt-{step}")

    def save(self, step: int, program: Optional[Program] = None,
             scope: Optional[Scope] = None, extra: Optional[dict] = None,
             blocking: bool = True, strategy=None):
        """Write a checkpoint.  ``blocking=False`` copies the state to the
        host now (a consistent snapshot: the next step overwrites a warmed
        step's buffers in place) and does the serialisation, the fsync and
        the pointer flip on a background thread.  A second save joins the
        previous one first; call ``wait()`` before reading ``latest`` from
        outside.

        ``strategy``: the ``parallel.Strategy`` the state was produced
        under.  When it shards optimizer state (ZeRO-1) with accumulators
        it packs, their names and the data-parallel degree are recorded,
        and ``restore`` refuses a mismatched resume, as the reference's."""
        self.wait()
        prog = program or default_main_program()
        scope = scope or global_scope()
        if strategy is not None:
            arrays = strategy.gather_state(prog, scope)
        else:
            arrays = _collect(prog, scope, lambda v: True)
        zero1_packed, zero1_dp = [], None
        if strategy is not None and getattr(strategy, "shard_optimizer_state",
                                            False):
            zero1_packed = strategy.packed_accumulators(prog, list(arrays))
            if zero1_packed:
                # the padded layout depends on the data-parallel degree
                zero1_dp = int(strategy.mesh.shape[strategy.data_axis])

        def _write():
            t0 = time.perf_counter()
            with _trace.span("ckpt.save", step=step):
                faults.check("ckpt.write")
                d = self._ckpt_dir(step)
                _save_blob(d, "persistables", arrays)
                state = {"step": step, "time": time.time(),
                         "extra": extra or {}, "zero1_packed": zero1_packed,
                         "zero1_dp": zero1_dp}
                with open(os.path.join(d, "state.json"), "w") as f:
                    json.dump(state, f)
                self._commit_latest(step)
                self._gc()
            _metrics.counter("ckpt.saves").inc()
            _metrics.histogram("ckpt.save_ms").observe(
                (time.perf_counter() - t0) * 1e3)

        if blocking:
            _write()
        else:
            def _guarded():
                try:
                    _write()
                except BaseException as e:  # surfaced by wait()/next save()
                    self._pending_error = e

            # non-daemon: a clean interpreter exit finishes the fsync and
            # rename rather than discarding the in-flight checkpoint
            self._pending = threading.Thread(target=_guarded, daemon=False)
            self._pending.start()

    def wait(self):
        """Join any in-flight non-blocking save; re-raise its error if it
        failed (a missing checkpoint must not look saved)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise err

    def _commit_latest(self, step: int) -> None:
        """The crash-atomic pointer flip (temp write, fsync, rename)."""
        tmp = os.path.join(self.dirname, "latest.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dirname, "latest"))

    def _latest_on_disk(self) -> Optional[int]:
        """The pointer's value without wait(): _gc runs ON the pending save
        thread, where wait() would join the thread into itself."""
        try:
            with open(os.path.join(self.dirname, "latest")) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def latest_step(self) -> Optional[int]:
        self.wait()  # close the in-process race with a non-blocking save
        p = os.path.join(self.dirname, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def _committed_steps(self) -> list:
        """Step numbers of checkpoint dirs, ascending; quarantined dirs
        (``ckpt-N.corrupt``) are never candidates."""
        steps = []
        for n in os.listdir(self.dirname):
            if n.startswith("ckpt-") and n.split("-", 1)[1].isdigit():
                steps.append(int(n.split("-", 1)[1]))
        return sorted(steps)

    def _verify_step(self, step: int) -> bool:
        """Read-only integrity probe of one checkpoint dir: state.json
        parses and the blob matches its sha256."""
        d = self._ckpt_dir(step)
        try:
            with open(os.path.join(d, "state.json")) as f:
                json.load(f)
            with open(os.path.join(d, "persistables.meta.json")) as f:
                meta = json.load(f)
            return _sha256(os.path.join(d, "persistables.npz")) == meta["sha256"]
        except (OSError, ValueError, KeyError):
            return False

    def intact_steps(self) -> list:
        """Committed steps (<= the latest pointer) whose blobs verify,
        descending: the restore candidates this rank can load.  Each
        corrupt candidate found counts once in ``resilience.ckpt_fallbacks``
        (this rank is about to resume from something older than its newest
        checkpoint)."""
        latest = self.latest_step()
        if latest is None:
            return []
        out = []
        for s in reversed(self._committed_steps()):
            if s > latest:
                continue
            if self._verify_step(s):
                out.append(s)
            elif s not in self._fallbacks_counted:
                # once per corrupt dir per manager: every rollback re-runs
                # the agreement, which must not inflate the count
                self._fallbacks_counted.add(s)
                profiler.incr("resilience.ckpt_fallbacks")
        return out

    def newest_intact_step(self) -> Optional[int]:
        """The step restore() would land on, found without loading or
        quarantining."""
        steps = self.intact_steps()
        return steps[0] if steps else None

    def _quarantine(self, step: int) -> None:
        """Rename a corrupt step dir out of the candidate set (kept for a
        post-mortem, never retried or counted by gc)."""
        d = self._ckpt_dir(step)
        target = d + ".corrupt"
        i = 1
        while os.path.exists(target):
            target = f"{d}.corrupt.{i}"
            i += 1
        try:
            os.replace(d, target)
        except OSError:
            pass  # already gone or unwritable: skip it either way

    def restore(self, scope: Optional[Scope] = None, strategy=None,
                limit_step: Optional[int] = None,
                device=None) -> Optional[dict]:
        """Load the newest committed checkpoint; returns its state dict (the
        data cursor in 'extra') or None if there is none.

        ``limit_step`` caps the walk: the newest committed step <=
        limit_step, even when newer intact ones exist (the cross-rank
        agreement), and the ``latest`` pointer is not moved down for it.

        Each candidate's sha256 is verified before the scope changes.  A
        corrupt or unreadable checkpoint is retried once in place, then
        QUARANTINED (renamed ``*.corrupt``) and restore falls back to the
        next older one; only when every checkpoint is corrupt does it
        raise CheckpointCorrupt.  A checkpoint recorded as packed ZeRO-1
        refuses to load without a matching ``strategy``
        (CheckpointStrategyMismatch): a caller error, so nothing is
        quarantined.  ``device``: where a name the scope lacks goes."""
        from .resilience import RetryPolicy, retry

        t_restore = time.perf_counter()
        latest = self.latest_step()
        if latest is None:
            return None
        # dirs newer than the pointer were never committed (a crash before
        # the pointer flip); never resume from one
        cap = latest if limit_step is None else min(latest, limit_step)
        candidates = [s for s in reversed(self._committed_steps())
                      if s <= cap]
        if not candidates:
            candidates = [cap]  # the pointer names a missing dir: fail below
        last_err = None
        for i, step in enumerate(candidates):
            d = self._ckpt_dir(step)

            def _attempt():
                with open(os.path.join(d, "state.json")) as f:
                    state = json.load(f)
                if state.get("zero1_packed"):
                    dp = None
                    if (strategy is not None
                            and getattr(strategy, "shard_optimizer_state",
                                        False)
                            and getattr(strategy, "data_axis", None)):
                        dp = strategy.mesh.shape.get(strategy.data_axis)
                    saved_dp = state.get("zero1_dp")
                    if dp is None or (saved_dp is not None and dp != saved_dp):
                        got = ("no packing strategy" if dp is None
                               else f"dp={dp}")
                        raise CheckpointStrategyMismatch(
                            f"checkpoint {d} was saved under a packed ZeRO-1 "
                            f"strategy (accumulators {state['zero1_packed']} "
                            f"for data-parallel degree {saved_dp}); restore "
                            f"with the same Strategy(shard_optimizer_state="
                            f"True) over {saved_dp} data-parallel devices "
                            f"(got {got})")
                _load_blob(d, "persistables", scope or global_scope(), device)
                return state

            try:
                # one in-place retry before the destructive quarantine: a
                # transient I/O blip must not discard the newest good
                # checkpoint (real corruption fails both attempts)
                with _trace.span("ckpt.restore", step=step):
                    state = retry(RetryPolicy(max_attempts=2,
                                              base_delay_s=0.1,
                                              max_delay_s=1.0))(_attempt)()
            except CheckpointStrategyMismatch:
                raise
            except _CORRUPTION_ERRORS as e:
                last_err = e
                self._quarantine(step)
                profiler.incr("resilience.ckpt_fallbacks")
                continue
            if i > 0 and limit_step is None:
                # commit the fallback so that the next boot does not walk
                # the quarantined steps again; under an agreement cap the
                # pointer stays, or _gc would destroy the newer intact one
                self._commit_latest(step)
            _metrics.counter("ckpt.restores").inc()
            _metrics.histogram("ckpt.restore_ms").observe(
                (time.perf_counter() - t_restore) * 1e3)
            return state
        raise CheckpointCorrupt(
            f"no intact checkpoint left under {self.dirname} "
            f"(all candidates quarantined; last error: {last_err})")

    def _gc(self):
        steps = self._committed_steps()
        pointer = self._latest_on_disk()
        if pointer is not None:
            # dirs newer than the pointer are crash orphans, never
            # restorable: they must neither survive nor take a keep slot
            for s in steps:
                if s > pointer:
                    shutil.rmtree(self._ckpt_dir(s), ignore_errors=True)
            steps = [s for s in steps if s <= pointer]
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._ckpt_dir(s), ignore_errors=True)


# --------------------------------------------------------------------------- inference

# op types whose kernels an inference step would launch outside a custom
# op, with the condition: torch.export cannot record such a launch
_UNEXPORTED_KERNELS = {
    "dropout": (lambda attrs: not attrs.get("is_test"),
                "threefry_dropout (ops/csrc/dropout.cu)"),
}
_ARTIFACT_FILES = ("model.pt2", "params.npz", "params.meta.json",
                   "inference.json")


class _InferenceModule(torch.nn.Module):
    """The pruned program's forward as a module: ``forward(params, feeds)``
    -> the fetches, with the parameters an argument, not constants."""

    def __init__(self, step):
        super().__init__()
        self._step = step

    def forward(self, params: Dict[str, torch.Tensor],
                feeds: Dict[str, torch.Tensor]):
        fetches, _ = self._step(params, feeds, 0)
        return tuple(fetches)


def _check_exportable(program: Program) -> None:
    """Refuse, naming the op, a program that is not one traced function: a
    host read every run (``check_capturable``: cond, an unbounded
    while_loop, Print) or a kernel launched outside a custom op."""
    try:
        check_capturable(program)
    except WarmError as e:
        raise ValueError(
            f"save_inference_model: the artifact is one traced function, "
            f"and {str(e).replace('warm: ', '')}") from None
    for _, op in program.all_ops():
        entry = _UNEXPORTED_KERNELS.get(op.type)
        if entry is not None and entry[0](op.attrs):
            raise ValueError(
                f"save_inference_model: the program's {op.type} op (outputs "
                f"{op.output_names()[:2]}) launches the {entry[1]} kernel, "
                f"which has no custom op for torch.export; build the "
                f"program for inference (is_test) first")


def _example(var: Variable, batch: int, device) -> torch.Tensor:
    shape = tuple(batch if d is None else int(d) for d in var.shape)
    return torch.zeros(shape, dtype=var.dtype, device=device)


def save_inference_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor=None,
                         main_program: Optional[Program] = None,
                         example_batch: int = 1,
                         scope: Optional[Scope] = None):
    """Prune the program to the fetch targets, bind the current parameters,
    and export (ref fluid io.py:165 save_inference_model): ``model.pt2``
    (``torch.export`` on the executor's device, a symbolic batch dim shared
    by every batch-major feed first, the fixed ``example_batch`` if that
    fails), ``params.npz`` and ``inference.json``.  Refuses a program
    ``_check_exportable`` refuses."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    pruned = program.prune(target_vars)
    _check_exportable(pruned)
    exe = executor if isinstance(executor, Executor) else Executor()
    feed_names = list(feeded_var_names)
    fetch_names = [t.name for t in target_vars]
    step, state = exe.build_raw_step(pruned, feed_names, fetch_names, scope)
    params = {n: torch.as_tensor(v).to(exe.device) for n, v in state.items()}
    block = pruned.global_block
    module = _InferenceModule(step)

    def _export(symbolic: bool):
        # a batch of 1 would be specialised; the symbolic trace takes 2
        batch = max(example_batch, 2) if symbolic else example_batch
        feeds = {n: _example(block.var(n), batch, exe.device)
                 for n in feed_names}
        dyn_batch = torch.export.Dim("b") if symbolic else None
        dynamic = ({n: None for n in params},
                   {n: ({0: dyn_batch} if symbolic
                        and block.var(n).shape[:1] == (None,) else None)
                    for n in feed_names})
        with torch.no_grad():
            return torch.export.export(module, (params, feeds),
                                       dynamic_shapes=dynamic, strict=False)

    symbolic = True
    try:
        exported = _export(True)
    except Exception:  # noqa: BLE001 — the reference's fallback
        symbolic = False
        exported = _export(False)
    os.makedirs(dirname, exist_ok=True)
    torch.export.save(exported, os.path.join(dirname, "model.pt2"))
    _save_blob(dirname, "params", {k: _host_copy(v) for k, v in
                                   params.items()})
    spec = {
        "feed_names": feed_names,
        "fetch_names": fetch_names,
        "example_batch": example_batch,
        "symbolic_batch": symbolic,
        "feeds": {n: {"shape": [example_batch if d is None else int(d)
                                for d in block.var(n).shape],
                      "dtype": dtype_name(block.var(n).dtype)}
                  for n in feed_names},
        "device": exe.device.type,
    }
    with open(os.path.join(dirname, "inference.json"), "w") as f:
        json.dump(spec, f)


def export_serving_model(dirname: str, feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable], executor=None,
                         main_program: Optional[Program] = None,
                         example_batch: int = 1,
                         scope: Optional[Scope] = None):
    """The reference's artifact for its native serving host
    (``native/pjrt_serving.cc``); the port's native host is ROADMAP
    A.10."""
    raise NotImplementedError(
        f"export_serving_model writes the native serving host's artifact, "
        f"which is not ported yet ({_A10}: native.py and capi_server.py); "
        f"save_inference_model writes the port's torch.export artifact")


class InferenceModel:
    """A loaded inference artifact: ``model(feed)`` takes a feed dict of
    numpy arrays (or tensors) and returns the fetch list as numpy arrays.

    Each feed signature (names, shapes, dtypes) is prepared at its first
    call through ``core.graphs``: on the card one CUDA graph of the
    exported program over static feed buffers, which every later call of
    that signature stages and replays; on the CPU the program, run on the
    staged buffers.  ``trace_count()`` counts the signatures prepared
    (unchanged by a repeated signature), as ``serving.jit_traces`` does;
    each prepared signature registers its flops and bytes in the
    ``obs.prof`` cost ledger under ``serving_bucket:<model id>:<rows>``
    (``sig_prefix`` + rows, the key a ``DynamicBatcher`` times it by).

    A call is safe from many threads: one lock per model covers the
    staging, the preparation of a new signature, the replay and the copy
    of the fetches to the host (the static buffers are per signature and
    the card replays one graph at a time anyway).  A first capture holds
    the lock too, so another thread's call of any signature of this model
    waits for it: a CUDA graph capture fails when another thread calls a
    synchronising CUDA function meanwhile, and every graph of a model
    shares one memory pool.  ``feed_specs``,
    ``symbolic_batch``, ``example_batch``, ``params``, ``feed_names``,
    ``fetch_names`` and ``exported`` (the ``torch.export`` program)
    describe it.  The reference's AOT and mesh hooks raise, naming ROADMAP
    A.10."""

    def __init__(self, dirname: str, device=None):
        with open(os.path.join(dirname, "inference.json")) as f:
            spec = json.load(f)
        self.device = resolve_device(device)
        self.exported = torch.export.load(os.path.join(dirname, "model.pt2"))
        saved = spec.get("device", self.device.type)
        if saved != self.device.type:
            from torch.export.passes import move_to_device_pass

            self.exported = move_to_device_pass(self.exported, self.device)
        data = _verified_npz(dirname, "params")
        self.params = {k: torch.from_numpy(np.ascontiguousarray(data[k]))
                       .to(self.device) for k in data.files}
        self.feed_names = list(spec["feed_names"])
        self.fetch_names = list(spec["fetch_names"])
        self.feed_specs = spec.get("feeds")
        self.symbolic_batch = bool(spec.get("symbolic_batch", False))
        self.example_batch = int(spec.get("example_batch", 1))
        self._dtypes = {n: convert_dtype(self.feed_specs[n]["dtype"])
                        for n in self.feed_names}
        self._module = self.exported.module()
        self._graphs = Graphs(self.device)
        self._prepared: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        h = hashlib.sha1()
        for name in ("inference.json", "params.meta.json"):
            with open(os.path.join(dirname, name), "rb") as f:
                h.update(f.read())
        self.model_id = h.hexdigest()
        self.sig_prefix = f"serving_bucket:{self.model_id[:8]}"

    def trace_count(self) -> int:
        return len(self._prepared)

    def __call__(self, feed):
        vals = {}
        for n in self.feed_names:
            v = feed[n]
            if not isinstance(v, torch.Tensor):
                a = np.ascontiguousarray(np.asarray(v))
                # a read-only buffer (a Session feed is np.frombuffer)
                v = torch.from_numpy(a if a.flags.writeable else a.copy())
            vals[n] = v.to(self._dtypes[n])
        sig = tuple((n, tuple(vals[n].shape)) for n in self.feed_names)
        with self._lock:
            entry = self._prepared.get(sig)
            if entry is None:
                self._prepared[sig] = entry = self._prepare(sig, vals)
            else:
                staged, outs, prepared = entry
                staged.stage(vals)
                prepared.replay()
            return [_to_numpy(o) for o in entry[1]["fetches"]]

    def _prepare(self, sig, vals) -> tuple:
        """Stage ``vals`` into a new signature's buffers and prepare it (the
        caller holds the lock); counts ``serving.jit_traces`` and registers
        the signature's cost."""
        staged = Staged([(n, s, self._dtypes[n]) for n, s in sig],
                        self.device)
        staged.stage(vals)
        outs: dict = {}
        module, params, feeds = self._module, self.params, staged.t

        def body():
            with torch.no_grad():
                outs["fetches"] = module(params, dict(feeds))

        t0 = time.perf_counter()
        prepared = self._graphs.prepare(body, count=True)
        ms = (time.perf_counter() - t0) * 1e3
        if prepared.captured:
            prepared.replay()
        profiler.incr("serving.jit_traces")
        rows = int(sig[0][1][0]) if sig and sig[0][1] else 0
        sig_key = f"{self.sig_prefix}:{rows}"
        _prof.register(
            _prof.fingerprint("serving_bucket", repr(sig), self.model_id,
                              [self._dtypes[n] for n in self.feed_names]),
            label=sig_key, sig_key=sig_key, source="live", compile_ms=ms,
            cost=prepared.cost)
        return staged, outs, prepared

    # ---- the reference's AOT and mesh hooks: ROADMAP A.10
    def _a10(self, what: str):
        raise NotImplementedError(
            f"InferenceModel.{what} is not ported yet ({_A10}: the "
            f"compile/ store and the serving mesh hooks of the artifact)")

    def install(self, feed, executable, fingerprint=None):
        self._a10("install")

    def aot_compile(self, feed, fingerprint=None):
        self._a10("aot_compile")

    @property
    def artifact_hash(self):
        self._a10("artifact_hash")

    def installed_count(self):
        self._a10("installed_count")

    def shard(self, serving_mesh):
        self._a10("shard")

    def place_feeds(self, feed):
        self._a10("place_feeds")

    def serving_mesh(self):
        self._a10("serving_mesh")


def load_inference_model(dirname: str, executor=None):
    """Returns (infer, feed_names, fetch_names): ``infer`` is an
    :class:`InferenceModel` on the executor's device (the card without
    one; ``Executor(CPUPlace())`` for the host)."""
    model = InferenceModel(dirname, _executor_device(executor))
    return model, model.feed_names, model.fetch_names


def merge_model(model_dir: str, output_path: str):
    """Pack an inference-model directory (the exported program, the
    parameters and their checksum, the spec) into ONE deployable file
    (ref: ``paddle merge_model``)."""
    import tarfile

    with tarfile.open(output_path, "w") as tar:
        for m in _ARTIFACT_FILES:
            tar.add(os.path.join(model_dir, m), arcname=m)


def load_merged_model(path: str, executor=None):
    """Load a merge_model file; returns (infer, feed_names, fetch_names)
    as load_inference_model does."""
    import tarfile

    d = tempfile.mkdtemp(prefix="paddle_tpu_torch_merged_")
    try:
        with tarfile.open(path) as tar:
            tar.extractall(d, filter="data")
        # load_inference_model reads everything into memory
        return load_inference_model(d, executor)
    finally:
        shutil.rmtree(d, ignore_errors=True)
