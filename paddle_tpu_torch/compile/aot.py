"""The AOT store: prepared steps as durable on-disk artifacts (PyTorch port
of ``paddle_tpu/compile/aot.py``).

The store is content-addressed: the key is a canonical **fingerprint**, a
sha256 over everything that makes a stored step reusable and only that:
the program's text, the argument shapes and dtypes, the sharding
description, the torch and CUDA versions, the hash of every hand-written
kernel library (``ops/_build.py`` names a library by a hash of its source
and nvcc flags, so a rebuilt kernel is another key), and the device (its
name and compute capability).  Anything that could change the stored
graph changes the key, so a stale entry cannot be loaded by construction.

The port's "compile" is a Python run of the step and a CUDA graph capture
(``core/graphs.py``), and a CUDA graph cannot be serialized.  What the
store keeps is the step as an FX graph: ``make_fx`` traces the whole step
(forward, ``torch.autograd.grad``, clip, updates) into aten ops in fake
mode, every hand-written kernel as one ``paddle_tpu_torch::*`` custom-op
node (:func:`trace_step`).  An entry holds one layer, ``exec``: that
``GraphModule`` pickled.  It is exact-environment only, which the key
already is (version, kernel or device skew is another fingerprint, and
is checked again against the meta sidecar before unpickling).  The
reference's second, portable layer (``jax.export``) has no use here: a
``torch.export`` of the graph would be read only where the pickle fails
in the very environment that wrote it, and it cost 38-65 s a write
against the trace's 2.5 s for the LM step at full width on an H100.

A loaded graph is captured like a live step (``Executor.warm``): the
capture itself is never skipped.

**A compile dir must be as trusted as the code.**  Loading an entry
unpickles it, which runs code.  The store makes its directories 0700 and
its files 0600, and reads an entry only when the entry's directory and
both its files belong to this process's user and are writable by no one
else (:func:`_trusted`); any other entry is a miss.  The sha256 sidecar
sits beside the bytes, so it guards against corruption, not tampering:
point ``compile_dir`` (and ``PADDLE_TPU_COMPILE_DIR``) only at a
directory no one else can write.

Write and read discipline is ``CheckpointManager``'s: writes are tmp +
fsync + atomic rename with a sha256 in a meta sidecar; reads verify the
sha256 before deserializing; a corrupt entry is quarantined whole (the
directory renamed ``*.corrupt``, kept for a postmortem) and reported as a
miss.  The caller's contract is "load or prepare live", never "crash on a
bad cache".  ``require_meta`` gates a read on the meta sidecar (a device
count): a mismatch is a miss, not corruption.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import shutil
import sys
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional

from ..obs import metrics as _metrics
from ..obs import trace as _trace

LAYERS = ("exec",)

# the store a process warms through, for ``compile.health()``
_active: Dict[str, Any] = {"store": None}


def kernel_versions() -> Dict[str, str]:
    """The hash naming each kernel library ``ops/_build.py`` builds (of its
    source and the nvcc flags), by source name; a changed kernel source is
    another hash."""
    from ..ops import _build

    return {p.name: _build._target(p).stem.rsplit("-", 1)[-1]
            for p in sorted(_build.CSRC.glob("*.cu"))}


def _versions() -> Dict[str, str]:
    import torch

    kernels = hashlib.sha256(json.dumps(kernel_versions(), sort_keys=True)
                             .encode()).hexdigest()
    return {"torch": torch.__version__, "cuda": str(torch.version.cuda),
            "kernels": kernels}


def backend_of(device=None) -> str:
    """The device field of a fingerprint: ``cpu``, or ``cuda:<name>:sm_<cc>``
    (the card's name and compute capability; never its index or bus id)."""
    import torch

    device = torch.device(device if device is not None else "cpu")
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda:{torch.cuda.get_device_name(device)}:sm_{major}{minor}"


def canonical_sharding(axes, specs: Optional[Dict] = None,
                       extra: Optional[Dict] = None) -> str:
    """The canonical sharding field for :func:`fingerprint`: mesh axis names
    and sizes (in mesh order) and per-argument partition specs, JSON with
    sorted keys.  Device ids, device objects and host names never appear,
    so two identically shaped meshes on different hosts share an entry.
    ``axes``: iterable of (name, size); ``specs``: {group: {arg_name:
    PartitionSpec-like}}; ``extra``: small jsonable context."""
    def _spec(s) -> list:
        if s is None:
            return []
        out = []
        for entry in s:
            if entry is None:
                out.append(None)
            elif isinstance(entry, (tuple, list)):
                out.append([str(x) for x in entry])
            else:
                out.append(str(entry))
        return out

    d: Dict[str, Any] = {"axes": [[str(a), int(s)] for a, s in axes]}
    if specs:
        d["specs"] = {g: {n: _spec(s) for n, s in sorted(group.items())}
                      for g, group in sorted(specs.items())}
    if extra:
        d["extra"] = extra
    return json.dumps(d, sort_keys=True)


def fingerprint(kind: str, ir, arg_sig, *, backend: Optional[str] = None,
                sharding: str = "", donate=(), extra: str = "",
                kv_dtype: str = "") -> str:
    """The canonical identity of a stored step.  ``ir`` is the program text
    (or an artifact's hash); ``arg_sig`` any stable description of the
    argument shapes and dtypes (it is repr()'d); ``backend`` defaults to
    :func:`backend_of` the CPU.  ``kv_dtype``: a serving session's
    quantized-KV regime, the empty string for full precision (so that
    turning quantization on does not re-key a full-precision ladder)."""
    if backend is None:
        backend = backend_of()
    h = hashlib.sha256()
    parts = [kind, ir, repr(arg_sig), sharding, repr(tuple(donate)),
             json.dumps(_versions(), sort_keys=True), backend, extra]
    if kv_dtype:
        parts.append(f"kv_dtype={kv_dtype}")
    for part in parts:
        if isinstance(part, str):
            part = part.encode()
        h.update(part)
        h.update(b"\0")  # unambiguous field boundary
    return h.hexdigest()


def _trusted(path: str) -> bool:
    """Whether ``path`` belongs to this process's user and no one else can
    write it: the condition for unpickling what an entry holds."""
    try:
        st = os.stat(path)
    except OSError:
        return False
    return st.st_uid == os.getuid() and not st.st_mode & 0o022


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# --------------------------------------------------------------------------
# the step as a graph
# --------------------------------------------------------------------------

# each custom op of the port -> the launch counters one call of it adds on
# the card (``ops/_counters.py``: counter name, key)
OP_LAUNCHES = {
    "flash_fwd": (("flash_attention.launches", "fwd"),),
    "flash_bwd": (("flash_attention.launches", "bwd_dkdv"),
                  ("flash_attention.launches", "bwd_dq")),
    "lstm_fwd": (("fused_lstm.launches", "fwd"),),
    "lstm_fwd_train": (("fused_lstm.launches", "fwd"),),
    "lstm_bwd": (("fused_lstm.launches", "bwd"),),
    "bn_bwd_reduce": (("batch_norm_train.launches", "reduce"),),
    "bn_bwd_dx": (("batch_norm_train.launches", "dx"),),
    "dropout_fwd": (("threefry_dropout.launches", "fwd"),),
    "dropout_bwd": (("threefry_dropout.launches", "bwd"),),
    "conv_igemm": (("conv.launches", "igemm"),),
    "conv_igemm_fused": (("conv.launches", "fused"),),
}


def custom_op_counts(gm) -> Dict[str, int]:
    """The ``paddle_tpu_torch::*`` nodes of a graph, by op name."""
    out: Dict[str, int] = {}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = getattr(node.target, "name", lambda: "")()
        if name.startswith("paddle_tpu_torch::"):
            op = name.split("::", 1)[1].split(".", 1)[0]
            out[op] = out.get(op, 0) + 1
    return out


def expected_launches(counts: Dict[str, int]) -> Dict[tuple, int]:
    """The launches one run of a graph with ``counts`` custom-op nodes
    makes on the card, by (counter, key)."""
    out: Dict[tuple, int] = {}
    for op, n in counts.items():
        for key in OP_LAUNCHES.get(op, ()):
            out[key] = out.get(key, 0) + n
    return out


def check_launches(counts: Dict[str, int], launches: Optional[Dict]) -> None:
    """Raise when the counter deltas of the live first run (``launches``,
    ``Prepared.launches`` on the card; None on the CPU, where nothing
    launches) differ from what the graph's custom-op nodes launch: a
    kernel the live step launched outside a custom op would be missing
    from the graph."""
    if launches is None:
        return
    want = expected_launches(counts)
    got = {}
    for name, key in {k for ks in OP_LAUNCHES.values() for k in ks}:
        n = launches.get(name, {}).get(key, 0)
        if n:
            got[(name, key)] = n
    if got != want:
        raise RuntimeError(
            f"the traced step's custom ops launch {want}, but its live run "
            f"launched {got}: a kernel launched outside a custom op would "
            f"be missing from a stored graph")


def trace_step(fn, *args):
    """``make_fx`` of ``fn(*args)`` in fake mode: the aten graph of the whole
    step, ``torch.autograd.grad`` included, with every kernel a custom-op
    node.  A kernel launched outside a custom op reads a fake tensor's data
    pointer and raises here, so such a step is never stored."""
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(fn, tracing_mode="fake")(*args)


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------


class AOTStore:
    """Content-addressed store: ``<dir>/<fingerprint>/`` holding
    ``<layer>.bin`` and ``<layer>.meta.json`` per layer.  Every read
    degrades to None (prepare live); only writes may raise, and callers
    treat even those as best-effort."""

    def __init__(self, dirname: str):
        self.dirname = dirname
        os.makedirs(dirname, mode=0o700, exist_ok=True)

    def activate(self) -> "AOTStore":
        """Make this the store ``compile.health()`` reports."""
        _active["store"] = self
        _metrics.gauge("compile.persistent_cache_enabled").set(1.0)
        return self

    # ------------------------------------------------------------- raw bytes
    def _entry_dir(self, fp: str) -> str:
        return os.path.join(self.dirname, fp)

    def put_bytes(self, fp: str, layer: str, blob: bytes,
                  meta: Optional[Dict] = None) -> str:
        """Atomic layer write: the blob to tmp + fsync + rename, then the
        meta sidecar (sha256, size, versions, creation time)."""
        assert layer in LAYERS, layer
        d = self._entry_dir(fp)
        os.makedirs(d, mode=0o700, exist_ok=True)
        path = os.path.join(d, f"{layer}.bin")
        with _trace.span("compile.aot_write", layer=layer):
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            m = {"fingerprint": fp, "layer": layer,
                 "sha256": _sha256_file(path), "bytes": len(blob),
                 "time": time.time(), **_versions(), **(meta or {})}
            mtmp = os.path.join(d, f"{layer}.meta.json.tmp")
            with os.fdopen(os.open(mtmp, os.O_WRONLY | os.O_CREAT
                                   | os.O_TRUNC, 0o600), "w") as f:
                json.dump(m, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, os.path.join(d, f"{layer}.meta.json"))
        _metrics.counter("compile.aot_writes").inc()
        return path

    def get_bytes(self, fp: str, layer: str, *,
                  require_exact_version: bool = False,
                  require_meta: Optional[Dict] = None) -> Optional[bytes]:
        """Verified read: None on a miss, version skew or an entry that is
        not :func:`_trusted` (another user's, or writable by others: a
        miss, left in place); a checksum mismatch or an unreadable meta
        quarantines the whole entry.  ``require_meta``: keys the meta
        sidecar must match exactly, else a miss (not corruption)."""
        assert layer in LAYERS, layer
        d = self._entry_dir(fp)
        path = os.path.join(d, f"{layer}.bin")
        meta_path = os.path.join(d, f"{layer}.meta.json")
        if not os.path.exists(path) or not os.path.exists(meta_path):
            _metrics.counter("compile.aot_misses").inc()
            return None
        if not all(_trusted(p) for p in (d, path, meta_path)):
            from ..obs import recorder as _recorder

            _recorder.record_event("aot_untrusted", fingerprint=fp,
                                   layer=layer)
            _metrics.counter("compile.aot_misses").inc()
            return None
        with _trace.span("compile.aot_load", layer=layer):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                if require_exact_version:
                    v = _versions()
                    if any(meta.get(k) != v[k] for k in v):
                        # skew is a miss: the entry is intact, it belongs
                        # to another toolchain
                        _metrics.counter("compile.aot_misses").inc()
                        return None
                for k, want in (require_meta or {}).items():
                    if meta.get(k) != want:
                        _metrics.counter("compile.aot_misses").inc()
                        return None
                if _sha256_file(path) != meta["sha256"]:
                    raise IOError(f"aot entry {fp}/{layer} checksum mismatch")
                with open(path, "rb") as f:
                    blob = f.read()
            except (OSError, ValueError, KeyError) as e:
                self._quarantine(fp, reason=str(e))
                _metrics.counter("compile.aot_misses").inc()
                return None
        _metrics.counter("compile.aot_hits").inc()
        return blob

    def _quarantine(self, fp: str, reason: str = "") -> None:
        """Rename the entry out of the addressable set, keeping the bytes
        for a postmortem."""
        d = self._entry_dir(fp)
        target = d + ".corrupt"
        i = 1
        while os.path.exists(target):
            target = f"{d}.corrupt.{i}"
            i += 1
        try:
            os.replace(d, target)
        except OSError:
            pass  # already gone or unwritable: unaddressable either way
        _metrics.counter("compile.aot_corrupt").inc()
        from ..obs import recorder as _recorder

        _recorder.record_event("aot_quarantine", fingerprint=fp,
                               reason=reason)

    # ------------------------------------------------------------ exec layer
    def put_executable(self, fp: str, gm, meta: Optional[Dict] = None) -> str:
        """Persist a traced ``GraphModule``."""
        return self.put_bytes(fp, "exec", pickle.dumps(gm), meta)

    def get_executable(self, fp: str, require_meta: Optional[Dict] = None):
        """Load the exact-environment layer; None on a miss, a version,
        kernel or device skew, or a ``require_meta`` mismatch (all checked
        before unpickling), or a failed unpickle (which quarantines the
        entry: the bytes verified, so the environment drifted in a way the
        gate did not see)."""
        blob = self.get_bytes(fp, "exec", require_exact_version=True,
                              require_meta=require_meta)
        if blob is None:
            return None
        try:
            with warnings.catch_warnings():
                # torch's own pytree specs in the pickle warn on load
                warnings.simplefilter("ignore", FutureWarning)
                return pickle.loads(blob)
        except Exception as e:  # noqa: BLE001 — quarantined, then live
            self._quarantine(fp, reason=f"exec deserialize: {e}")
            return None

    def persist(self, fp: str, graph, meta: Optional[Dict] = None,
                lock=None) -> Dict[str, float]:
        """Best-effort write of ``graph()`` (a trace of the step, which may
        raise: a kernel launched outside a custom op) as ``fp``'s entry,
        both under ``lock`` when given.  A failure is reported on stderr
        and writes nothing: the caller keeps its live step.  Returns the
        seconds of the stages that ran, "trace_s" and "write_s"."""
        secs: Dict[str, float] = {}
        t = time.perf_counter()
        try:
            with lock or contextlib.nullcontext():
                gm = graph()
                secs["trace_s"] = time.perf_counter() - t
                self.put_executable(fp, gm, meta)
                secs["write_s"] = time.perf_counter() - t - secs["trace_s"]
        except Exception as e:  # noqa: BLE001 — persistence is best-effort
            sys.stderr.write(f"paddle_tpu_torch compile: AOT persist failed "
                             f"for {(meta or {}).get('label', fp[:16])} "
                             f"({type(e).__name__}: {e}); continuing with "
                             f"the live step\n")
        return secs

    # --------------------------------------------------------- introspection
    def entries(self) -> List[Dict]:
        """One record per entry: fingerprint, the layers present with sizes
        and ages; quarantined directories have ``corrupt`` set."""
        out = []
        if not os.path.isdir(self.dirname):
            return out
        for name in sorted(os.listdir(self.dirname)):
            d = os.path.join(self.dirname, name)
            if not os.path.isdir(d):
                continue
            rec: Dict[str, Any] = {"fingerprint": name,
                                   "corrupt": ".corrupt" in name, "layers": {}}
            for layer in LAYERS:
                mp = os.path.join(d, f"{layer}.meta.json")
                if os.path.exists(mp):
                    try:
                        with open(mp) as f:
                            m = json.load(f)
                        rec["layers"][layer] = {
                            "bytes": m.get("bytes"), "time": m.get("time"),
                            "torch": m.get("torch"), "label": m.get("label")}
                    except (OSError, ValueError):
                        rec["layers"][layer] = {"unreadable": True}
            out.append(rec)
        return out

    def stats(self) -> Dict:
        es = self.entries()
        live = [e for e in es if not e["corrupt"]]
        return {
            "dir": self.dirname,
            "entries": len(live),
            "quarantined": len(es) - len(live),
            "bytes": sum(lay.get("bytes") or 0
                         for e in live for lay in e["layers"].values()),
            "layers": {layer: sum(1 for e in live if layer in e["layers"])
                       for layer in LAYERS},
        }

    def clear(self, *, include_quarantined: bool = True) -> int:
        """Remove entries; returns how many directories were deleted."""
        n = 0
        if not os.path.isdir(self.dirname):
            return 0
        for name in os.listdir(self.dirname):
            d = os.path.join(self.dirname, name)
            if not os.path.isdir(d):
                continue
            if ".corrupt" in name and not include_quarantined:
                continue
            shutil.rmtree(d, ignore_errors=True)
            n += 1
        return n


def active_store() -> Optional[AOTStore]:
    """The store this process warms through, if any."""
    return _active["store"]
