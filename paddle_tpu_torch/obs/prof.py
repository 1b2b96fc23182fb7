"""Device-time attribution (PyTorch port of ``paddle_tpu/obs/prof.py``).
Three pieces, cheap enough to stay on in production (always-on, sampled,
low overhead):

  CostLedger    one entry per prepared signature, keyed by a fingerprint
                over the signature key, the model description and the
                dtypes (:func:`fingerprint`), so a fused and a composed
                program never share an entry: flops and bytes accessed
                counted at the signature's preparation (:func:`analyze`),
                the preparation's wall-ms, and how the entry was satisfied
                (``live``).  Persisted as a tolerant json sidecar
                (``<dir>/prof_ledger.json``) when a directory is attached:
                a garbage sidecar is quarantined (``*.corrupt``) and the
                ledger starts empty.

  sampled dispatch timing
                the dispatch sites (the continuous decode step and
                prefill-insert, the batcher's batch, the warmed train step)
                call ``tick(key)`` on EVERY dispatch: one dict get, one
                ``itertools.count`` next and a modulo, and no host-device
                synchronisation.  Every Nth call is timed: the caller
                synchronises the current stream after the replay, then
                calls ``tock``.  ``PADDLE_TPU_PROF_SAMPLE`` sets N (0
                disables; at N >= 2 a site's first call is never the
                sample).  Timing wraps the dispatch, never the captured
                body, so sampling adds no capture and no replay.

  hotspots      the join: measured time share per signature (mean sampled
                wall-ms x dispatch count) against ledger intensity (flops /
                bytes accessed), each signature classified memory- or
                compute-bound against a ridge point
                (``PADDLE_TPU_PROF_RIDGE`` flops/byte; 16 by default, the
                reference's operating-point-neutral default, not a figure
                for any card), ranked by share.  ``Session.healthz`` carries
                it; the flight recorder snapshots it into every postmortem.

Reads are lock-free: sites and the ledger republish an immutable snapshot
on every mutation, so a health probe never blocks behind a timed step.
Standard library only at import; :func:`analyze` imports torch when called.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import metrics as _metrics
from . import recorder as _recorder
from . import trace as _trace

SAMPLE_ENV = "PADDLE_TPU_PROF_SAMPLE"
RIDGE_ENV = "PADDLE_TPU_PROF_RIDGE"
DEFAULT_SAMPLE_EVERY = 64
DEFAULT_RIDGE_FLOPS_PER_BYTE = 16.0
LEDGER_BASENAME = "prof_ledger.json"
LEDGER_SCHEMA = "paddle_tpu.prof_ledger.v1"

# ledger entry fields analyze() can fill; anything absent stays absent —
# the report renders what it has (tolerance is the contract throughout)
_COST_FIELDS = ("flops", "bytes_accessed", "argument_bytes", "output_bytes",
                "temp_bytes")


def sample_every() -> int:
    """The live sampling period: every Nth dispatch per site is timed.
    0 disables timing entirely (counting still runs — it IS the cheap
    path)."""
    return _every[0]


def set_sample_every(n: Optional[int]) -> None:
    """Override the env-derived period (tests, benches).  None re-reads the
    environment."""
    if n is None:
        _every[0] = _env_sample_every()
    else:
        _every[0] = max(int(n), 0)


def _env_sample_every() -> int:
    raw = os.environ.get(SAMPLE_ENV, "")
    try:
        return max(int(raw), 0) if raw != "" else DEFAULT_SAMPLE_EVERY
    except ValueError:
        return DEFAULT_SAMPLE_EVERY


_every = [_env_sample_every()]


def ridge_flops_per_byte() -> float:
    raw = os.environ.get(RIDGE_ENV, "")
    try:
        return float(raw) if raw else DEFAULT_RIDGE_FLOPS_PER_BYTE
    except ValueError:
        return DEFAULT_RIDGE_FLOPS_PER_BYTE


# --------------------------------------------------------------------------
# cost extraction: the count of one prepared signature
# --------------------------------------------------------------------------


def analyze(body) -> Dict[str, float]:
    """Best-effort {flops, bytes_accessed} of running ``body()`` once: the
    signature's first eager run (``core/graphs.py``), counted through
    ``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode that
    sums each op's operand bytes, with the hand kernels adding their own
    work (``ops/_cost.py``).  Raises what the body or the count raises:
    ``core/graphs.py`` then runs the body again uncounted, so attribution
    never breaks a warm."""
    from ..ops import _cost

    return _cost.count(body)


def fingerprint(kind: str, sig_key: str, model_desc: str,
                dtypes=()) -> str:
    """The ledger key of one prepared signature: a hash over its kind, its
    signature key, the model description and the dtypes it runs in."""
    import hashlib

    h = hashlib.sha256()
    for part in (kind, sig_key, model_desc, ",".join(str(d) for d in dtypes)):
        h.update(str(part).encode())
        h.update(b"\0")
    return h.hexdigest()[:32]


# --------------------------------------------------------------------------
# CostLedger
# --------------------------------------------------------------------------


class CostLedger:
    """Fingerprint-keyed executable cost table with a tolerant on-disk
    sidecar.  ``register`` merges (new non-None fields win, so a warm load
    refreshes ``source``/``compile_ms`` without erasing the flops the live
    compile recorded); ``attach`` points the ledger at a directory and folds
    any intact sidecar in (disk entries never overwrite live ones).  All
    mutation under one lock; ``snapshot()`` is a lock-free reference read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}
        # every compile dir ever attached, in attach order: registers
        # persist to ALL of them, so a process serving two stores keeps
        # BOTH sidecars current (last-attach-wins would silently stop
        # updating the first store's sidecar and break its warm-restart
        # costs contract).  Foreign entries in a sidecar are harmless:
        # fingerprint-keyed, merged tolerantly at load.
        self._dirs: List[str] = []
        self._snapshot: Dict[str, Dict] = {}

    # ------------------------------------------------------------ persistence
    def path(self) -> Optional[str]:
        return (os.path.join(self._dirs[-1], LEDGER_BASENAME)
                if self._dirs else None)

    def attach(self, dirname: str) -> "CostLedger":
        """Persist in ``dirname``: load the sidecar (tolerantly) and write
        back on every register.  A garbage sidecar is renamed
        ``*.corrupt[.n]`` — kept for postmortem, never trusted — and the
        ledger proceeds empty (the caller's contract is "know costs or
        recompute them", never "crash on a bad cache")."""
        dirname = os.path.abspath(dirname)
        with self._lock:
            if dirname in self._dirs:
                return self  # per-bucket warms re-attach: no sidecar re-read
            self._dirs.append(dirname)
            path = os.path.join(dirname, LEDGER_BASENAME)
            loaded = self._load(path)
            for fp, ent in loaded.items():
                if fp not in self._entries:
                    self._entries[fp] = ent
            self._publish()
        return self

    def _load(self, path: str) -> Dict[str, Dict]:
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                doc = json.load(f)
            entries = doc.get("entries")
            if doc.get("schema") != LEDGER_SCHEMA or not isinstance(entries,
                                                                    dict):
                raise ValueError(f"unrecognized ledger schema in {path}")
            return {str(fp): dict(ent) for fp, ent in entries.items()
                    if isinstance(ent, dict)}
        except Exception as e:  # noqa: BLE001 — tolerate any garbage
            self._quarantine(path, repr(e))
            return {}

    @staticmethod
    def _quarantine(path: str, reason: str) -> None:
        target = path + ".corrupt"
        i = 1
        while os.path.exists(target):
            target = f"{path}.corrupt.{i}"
            i += 1
        try:
            os.replace(path, target)
        except OSError:
            pass  # unreadable AND unmovable: it is unaddressable either way
        _metrics.counter("obs.prof.ledger_corrupt").inc()
        _recorder.record_event("prof_ledger_quarantine", path=path,
                               reason=reason)

    def _persist_locked(self) -> None:
        doc = {"schema": LEDGER_SCHEMA, "time": time.time(),
               "entries": self._entries}
        for d in self._dirs:
            try:
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, LEDGER_BASENAME)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            except Exception:  # noqa: BLE001 — persistence is best-effort
                pass

    # --------------------------------------------------------------- mutation
    def register(self, fingerprint: str, *, label: str, source: str,
                 sig_key: Optional[str] = None,
                 compile_ms: Optional[float] = None,
                 cost: Optional[Dict[str, float]] = None) -> Dict:
        """Record (or refresh) one signature's entry.  ``source`` is how
        THIS process satisfied it (``live``: prepared here; ``aot_exec``: a
        graph loaded from the AOT store); ``cost`` is an
        :func:`analyze` dict.  Merge rule: new non-None values win,
        absent ones keep what the sidecar (or an earlier registration)
        already knew — a warm load without cost data inherits the live
        compile's flops instead of erasing them."""
        with self._lock:
            ent = dict(self._entries.get(fingerprint) or {})
            ent["fingerprint"] = fingerprint
            ent["label"] = label
            ent["source"] = source
            ent["time"] = time.time()
            if sig_key is not None:
                ent["sig_key"] = sig_key
            if compile_ms is not None:
                ent["compile_ms"] = round(float(compile_ms), 3)
            for k, v in (cost or {}).items():
                if v is not None:
                    ent[k] = v
            fl, by = ent.get("flops"), ent.get("bytes_accessed")
            if fl is not None and by:
                ent["intensity"] = round(float(fl) / float(by), 4)
            self._entries[fingerprint] = ent
            self._publish()
            self._persist_locked()
            _metrics.gauge("obs.prof.ledger_entries").set(len(self._entries))
            return dict(ent)

    def _publish(self) -> None:
        # one reference assignment — atomic to concurrent readers
        self._snapshot = {fp: dict(e) for fp, e in self._entries.items()}

    # ------------------------------------------------------------------ reads
    def costs(self, fingerprint: str) -> Optional[Dict]:
        """The known entry for ``fingerprint`` (lock-free) — what a warm
        load consults so restarts know costs without recompiling."""
        e = self._snapshot.get(fingerprint)
        return dict(e) if e is not None else None

    def snapshot(self) -> Dict[str, Dict]:
        return dict(self._snapshot)

    def by_sig_key(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for ent in self._snapshot.values():
            k = ent.get("sig_key")
            if k:
                out[k] = ent
        return out

    def __len__(self) -> int:
        return len(self._snapshot)

    def clear(self) -> None:
        with self._lock:
            self._entries = {}
            self._publish()


# --------------------------------------------------------------------------
# sampled dispatch timing
# --------------------------------------------------------------------------


class _Site:
    __slots__ = ("key", "counter", "calls", "samples", "sum_ms", "max_ms",
                 "last_ms")

    def __init__(self, key: str):
        self.key = key
        # itertools.count: next() is one C-level op, GIL-atomic — the whole
        # cost of an unsampled dispatch is this plus a modulo
        self.counter = itertools.count(1)
        self.calls = 0      # refreshed on sampled calls (exact at sample time)
        self.samples = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0
        self.last_ms = 0.0


_sites_lock = threading.Lock()
_sites: Dict[str, _Site] = {}
_sites_snapshot: Dict[str, Dict] = {}


def _register_site(key: str) -> _Site:
    with _sites_lock:
        site = _sites.get(key)
        if site is None:
            site = _Site(key)
            _sites[key] = site
        return site


def tick(key: str) -> Optional[float]:
    """Per-dispatch sampling decision: returns a ``perf_counter`` stamp when
    THIS call should be timed, else None.  The caller runs the dispatch,
    blocks on its outputs, then calls :func:`tock`.  Cost of the common
    (unsampled) path: one dict get, one count next, one modulo."""
    site = _sites.get(key)
    if site is None:
        site = _register_site(key)
    n = next(site.counter)
    every = _every[0]
    # n % every == 0 with n starting at 1: at every>=2 call #1 (the one that
    # may carry a lazy jit's compile) is never the sample; every=1 means
    # "time everything", first call included
    if not every or n % every:
        return None
    site.calls = n
    return time.perf_counter()


def tock(key: str, t0: float) -> float:
    """Record one sampled dispatch: wall-ms since ``t0`` (the caller already
    blocked on the dispatch outputs, so this is dispatch+device wall time)
    into the site's stats row, the aggregate histogram, and — when tracing
    is enabled — a retroactive ``obs.prof.sample`` span on the ring."""
    t1 = time.perf_counter()
    ms = (t1 - t0) * 1e3
    site = _sites.get(key)
    if site is None:  # tock without tick: tolerate, count nothing
        return ms
    with _sites_lock:
        site.samples += 1
        site.sum_ms += ms
        site.max_ms = max(site.max_ms, ms)
        site.last_ms = ms
        _publish_sites_locked()
    _metrics.counter("obs.prof.samples").inc()
    _metrics.histogram("obs.prof.sample_ms").observe(ms)
    _trace.record_at("obs.prof.sample", t0, t1 - t0, site=key)
    return ms


def _publish_sites_locked() -> None:
    global _sites_snapshot
    snap = {}
    for key, s in _sites.items():
        if not s.samples:
            continue
        snap[key] = {
            "key": key,
            "calls": s.calls,
            "samples": s.samples,
            "mean_ms": s.sum_ms / s.samples,
            "max_ms": s.max_ms,
            "last_ms": s.last_ms,
        }
    _sites_snapshot = snap


def stats_snapshot() -> Dict[str, Dict]:
    """Per-signature timing rows (lock-free reference read).  ``calls`` is
    the dispatch count as of the LAST sample — at most one sampling period
    stale, which is the price of the lock-free hot path."""
    return {k: dict(v) for k, v in _sites_snapshot.items()}


def reset() -> None:
    """Drop all timing sites and the default ledger's entries (tests)."""
    global _sites_snapshot
    with _sites_lock:
        _sites.clear()
        _sites_snapshot = {}
    _default_ledger.clear()
    set_sample_every(None)


# --------------------------------------------------------------------------
# the hotspot / roofline join
# --------------------------------------------------------------------------


def hotspots(top: Optional[int] = None, ridge: Optional[float] = None,
             ledger_obj: Optional[CostLedger] = None) -> Dict:
    """Join measured time share with ledger intensity and rank.

    Per signature: ``est_total_ms = mean sampled wall-ms x dispatch count``
    (an estimate — sampling sees every Nth call), ``share`` of the summed
    estimate, and — when the ledger knows the executable — flops/byte
    ``intensity`` with a memory-/compute-bound verdict against ``ridge``.
    Attribution only: nothing here is a load signal, and readers (healthz,
    fleet status) must never fold it into queue depth or routability."""
    rdg = float(ridge if ridge is not None else ridge_flops_per_byte())
    led = (ledger_obj or _default_ledger).by_sig_key()
    rows: List[Dict] = []
    total = 0.0
    for key, s in stats_snapshot().items():
        est = s["mean_ms"] * max(s["calls"], s["samples"])
        total += est
        row = {"key": key, "calls": s["calls"], "samples": s["samples"],
               "mean_ms": round(s["mean_ms"], 3),
               "max_ms": round(s["max_ms"], 3),
               "_est_raw": est, "est_total_ms": round(est, 1)}
        ent = led.get(key)
        if ent is not None:
            for f in ("label", "source", "compile_ms", "flops",
                      "bytes_accessed", "intensity"):
                if ent.get(f) is not None:
                    row[f] = ent[f]
            inten = ent.get("intensity")
            if inten is not None:
                row["bound"] = "memory" if float(inten) < rdg else "compute"
        rows.append(row)
    for row in rows:
        # share from the UNROUNDED estimates: per-row rounding against the
        # raw total can print a lone site at 100.25%
        est = row.pop("_est_raw")
        row["share"] = round(est / total, 4) if total else 0.0
    rows.sort(key=lambda r: r["est_total_ms"], reverse=True)
    if top is not None:
        rows = rows[:top]
    return {"sample_every": sample_every(),
            "ridge_flops_per_byte": rdg,
            "total_est_ms": round(total, 1),
            "rows": rows}


def hotspots_snapshot(top: int = 5) -> Dict:
    """The healthz/postmortem fold: the same join, bounded rows, built
    entirely from lock-free snapshots — safe from any probe thread."""
    return hotspots(top=top)


def merge_hotspots(snapshots: List[Optional[Dict]]) -> Optional[Dict]:
    """Aggregate several processes' hotspot snapshots (e.g. a fleet's
    per-replica healthz rows) into one view: per signature, ``est_total_ms``
    and calls/samples sum, the mean re-derives from the summed estimate,
    and shares recompute over the fleet total.  Ledger fields (intensity,
    bound, source) are per-executable facts — any contributor's copy is
    THE value.  None/garbage contributors are skipped; returns None when
    nothing usable survives."""
    by_key: Dict[str, Dict] = {}
    sample_every = None
    ridge = None
    for snap in snapshots:
        if not isinstance(snap, dict) or not isinstance(snap.get("rows"),
                                                        list):
            continue
        sample_every = sample_every or snap.get("sample_every")
        ridge = ridge or snap.get("ridge_flops_per_byte")
        for r in snap["rows"]:
            if not isinstance(r, dict) or not r.get("key"):
                continue
            agg = by_key.setdefault(r["key"], {"key": r["key"], "calls": 0,
                                               "samples": 0,
                                               "est_total_ms": 0.0,
                                               "max_ms": 0.0})
            agg["calls"] += int(r.get("calls") or 0)
            agg["samples"] += int(r.get("samples") or 0)
            agg["est_total_ms"] += float(r.get("est_total_ms") or 0.0)
            agg["max_ms"] = max(agg["max_ms"], float(r.get("max_ms") or 0.0))
            for f in ("label", "source", "compile_ms", "flops",
                      "bytes_accessed", "intensity", "bound"):
                if f not in agg and r.get(f) is not None:
                    agg[f] = r[f]
    if not by_key:
        return None
    total = sum(a["est_total_ms"] for a in by_key.values())
    rows = sorted(by_key.values(), key=lambda a: a["est_total_ms"],
                  reverse=True)
    for a in rows:
        a["mean_ms"] = round(a["est_total_ms"] / max(a["calls"],
                                                     a["samples"], 1), 3)
        a["est_total_ms"] = round(a["est_total_ms"], 1)
        a["share"] = round(a["est_total_ms"] / total, 4) if total else 0.0
    return {"sample_every": sample_every,
            "ridge_flops_per_byte": ridge,
            "total_est_ms": round(total, 1),
            "merged_from": sum(1 for s in snapshots
                               if isinstance(s, dict) and s.get("rows")),
            "rows": rows}


def compare_hotspots(a: Dict, b: Dict) -> Dict:
    """Diff two hotspot snapshots (A = baseline, B = candidate) into a
    per-signature time-share delta view — the before/after story of a kernel
    swap (DESIGN.md §24): which signatures gained share, which shrank, and
    which exist in only one regime (e.g. a ``paged_attn=pallas`` fingerprint
    that has no counterpart row under the composed arm).

    Rows join by signature ``key``.  ``share_delta = share_b - share_a``
    (positive = B spends relatively MORE of its time there); ``mean_delta_pct``
    is the per-dispatch wall change where both sides measured the site.
    Sorted by |share_delta| so the headline movement leads.  Ledger facts
    (bound, source) come from whichever side knows them."""
    rows_a = {r["key"]: r for r in a.get("rows", []) if r.get("key")}
    rows_b = {r["key"]: r for r in b.get("rows", []) if r.get("key")}
    out: List[Dict] = []
    for key in sorted(set(rows_a) | set(rows_b)):
        ra, rb = rows_a.get(key), rows_b.get(key)
        sa = float((ra or {}).get("share") or 0.0)
        sb = float((rb or {}).get("share") or 0.0)
        row = {"key": key,
               "share_a": round(sa, 4), "share_b": round(sb, 4),
               "share_delta": round(sb - sa, 4),
               "est_ms_a": (ra or {}).get("est_total_ms"),
               "est_ms_b": (rb or {}).get("est_total_ms"),
               "only_in": "A" if rb is None else ("B" if ra is None else "")}
        ma = float((ra or {}).get("mean_ms") or 0.0)
        mb = float((rb or {}).get("mean_ms") or 0.0)
        if ra is not None and rb is not None and ma > 0:
            row["mean_delta_pct"] = round(100.0 * (mb - ma) / ma, 1)
        for f in ("bound", "source"):
            v = (rb or {}).get(f) or (ra or {}).get(f)
            if v is not None:
                row[f] = v
        out.append(row)
    out.sort(key=lambda r: abs(r["share_delta"]), reverse=True)
    return {"total_est_ms_a": a.get("total_est_ms"),
            "total_est_ms_b": b.get("total_est_ms"),
            "rows": out}


def render_hotspots_compare(d: Dict) -> str:
    """Human table for ``obs hotspots --compare A B --format=table``."""
    lines = [f"hotspot compare: A total~{d.get('total_est_ms_a')}ms vs "
             f"B total~{d.get('total_est_ms_b')}ms "
             f"(share_delta = B - A; positive = B spends more there)",
             f"{'signature':<28}{'share A':>9}{'share B':>9}{'delta':>9}"
             f"{'mean d%':>9}  {'only':<5}{'bound':<8}{'source':<10}"]
    for r in d.get("rows", []):
        md = r.get("mean_delta_pct")
        lines.append(
            f"{r.get('key', '?'):<28}"
            f"{100 * float(r.get('share_a') or 0):>8.1f}%"
            f"{100 * float(r.get('share_b') or 0):>8.1f}%"
            f"{100 * float(r.get('share_delta') or 0):>+8.1f}%"
            f"{(f'{md:+.1f}' if md is not None else '-'):>9}  "
            f"{r.get('only_in') or '-':<5}"
            f"{r.get('bound', '-'):<8}"
            f"{r.get('source', '-'):<10}")
    return "\n".join(lines)


def render_hotspots(h: Dict) -> str:
    """Human table of a :func:`hotspots` report."""
    lines = [f"hotspots: ridge={h.get('ridge_flops_per_byte')} flops/byte, "
             f"sample_every={h.get('sample_every')}, "
             f"total~{h.get('total_est_ms')}ms",
             f"{'signature':<28}{'share':>7}{'est_ms':>10}{'mean_ms':>9}"
             f"{'calls':>8}{'flops/B':>9}  {'bound':<8}{'source':<10}"]
    for r in h.get("rows", []):
        inten = r.get("intensity")
        lines.append(
            f"{r.get('key', '?'):<28}"
            f"{100 * float(r.get('share') or 0):>6.1f}%"
            f"{r.get('est_total_ms', 0):>10}"
            f"{r.get('mean_ms', 0):>9}"
            f"{r.get('calls', 0):>8}"
            f"{(f'{inten:.2f}' if inten is not None else '-'):>9}  "
            f"{r.get('bound', '-'):<8}"
            f"{r.get('source', '-'):<10}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# process-wide default ledger + postmortem provider
# --------------------------------------------------------------------------

_default_ledger = CostLedger()


def ledger() -> CostLedger:
    return _default_ledger


def attach_ledger_near_store(store_dirname: str) -> CostLedger:
    """Point the default ledger's sidecar beside the AOT store: the store
    lives at ``<compile_dir>/aot``, the ledger at
    ``<compile_dir>/prof_ledger.json``, so that a warm restart knows every
    stored step's costs without counting a first run again."""
    parent = os.path.dirname(os.path.abspath(store_dirname))
    return _default_ledger.attach(parent or store_dirname)


def register(fingerprint: str, **kw) -> Dict:
    """Module-level convenience for the dispatch sites (default ledger)."""
    return _default_ledger.register(fingerprint, **kw)


def _postmortem_hotspots() -> Dict:
    # fail-safe by the recorder's provider contract; bounded rows so a
    # postmortem stays readable
    return hotspots_snapshot(top=8)


# the flight recorder snapshots hotspots into every postmortem: an EXIT_HUNG
# or drain-kill dump then says where device time was going when the process
# died (satellite of DESIGN.md §23)
_recorder.register_provider("hotspots", _postmortem_hotspots)
