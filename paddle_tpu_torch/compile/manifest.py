"""The shape manifest: what production actually executed, so the next
generation knows exactly what to warm.

Every (function, shapes, bucket) that runs records itself here with a hit
count; the manifest is persisted alongside checkpoints (atomic tmp+rename,
same discipline as everything else that survives a restart) and read back at
startup by the warmup orchestrator, which warms entries hottest-first.

A manifest is advice, never authority: a corrupt or stale file loads as
empty (a live capture covers the difference).  The port's copy of
``paddle_tpu/compile/manifest.py``; file format and schema are the
reference's.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ..obs import metrics as _metrics

SCHEMA = "paddle_tpu.shape_manifest.v1"

# entry kinds
TRAIN_STEP = "train_step"
SERVING_BUCKET = "serving_bucket"


def feed_signature(feeds) -> Dict[str, Dict]:
    """Canonical {name: {shape, dtype}} of a feed dict (arrays or
    ShapeDtypeStruct-likes) — the manifest's shape vocabulary."""
    import numpy as np

    out = {}
    for n in sorted(feeds):
        v = feeds[n]
        shape = tuple(getattr(v, "shape", np.shape(v)))
        dtype = str(getattr(v, "dtype", np.asarray(v).dtype))
        out[n] = {"shape": [int(d) for d in shape], "dtype": dtype}
    return out


class ShapeManifest:
    """Thread-safe record of executed (kind, name, signature[, bucket])
    entries with hit counts.  ``path`` is where save()/load() persist; a
    manifest without a path is in-memory only (tests)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}  # key -> entry dict

    @staticmethod
    def _key(kind: str, name: str, sig, bucket) -> str:
        return json.dumps([kind, name, sig, bucket], sort_keys=True)

    # -------------------------------------------------------------- recording
    def record(self, kind: str, name: str, sig: Optional[Dict] = None,
               bucket: Optional[int] = None) -> None:
        key = self._key(kind, name, sig, bucket)
        now = time.time()
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self._entries[key] = {"kind": kind, "name": name,
                                      "sig": sig, "bucket": bucket,
                                      "count": 1, "first": now, "last": now}
            else:
                e["count"] += 1
                e["last"] = now

    # ---------------------------------------------------------------- reading
    def entries(self) -> List[Dict]:
        """Warm-priority order: train steps first (the loop cannot make
        progress without one), then serving buckets hottest-first, ties to
        the most recently used."""
        with self._lock:
            es = [dict(e) for e in self._entries.values()]
        return sorted(es, key=lambda e: (e["kind"] != TRAIN_STEP,
                                         -e["count"], -e["last"]))

    def buckets(self, name: Optional[str] = None) -> List[int]:
        """Serving buckets hottest-first (the warmup ordering)."""
        return [e["bucket"] for e in self.entries()
                if e["kind"] == SERVING_BUCKET and e["bucket"] is not None
                and (name is None or e["name"] == name)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------ persistence
    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Atomic write (tmp + fsync + rename).  Best-effort by contract:
        a manifest that fails to persist costs the next boot warmth, not
        this run correctness — so failures are swallowed after counting."""
        path = path or self.path
        if not path:
            return None
        with self._lock:
            doc = {"schema": SCHEMA, "time": time.time(),
                   "entries": list(self._entries.values())}
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            return None
        _metrics.gauge("compile.manifest_entries").set(len(doc["entries"]))
        return path

    @classmethod
    def load(cls, path: str) -> "ShapeManifest":
        """Tolerant load: missing/corrupt/foreign-schema files come back as
        an EMPTY manifest bound to the same path (cold start, not a crash)."""
        m = cls(path)
        try:
            with open(path) as f:
                doc = json.load(f)
            if doc.get("schema") != SCHEMA:
                return m
            for e in doc.get("entries", []):
                key = cls._key(e.get("kind"), e.get("name"), e.get("sig"),
                               e.get("bucket"))
                e.setdefault("count", 1)
                e.setdefault("first", 0.0)
                e.setdefault("last", 0.0)
                m._entries[key] = e
        except (OSError, ValueError, KeyError, TypeError):
            return cls(path)
        _metrics.gauge("compile.manifest_entries").set(len(m._entries))
        return m

    def merge(self, other: "ShapeManifest") -> None:
        """Fold another manifest's counts in (multi-process serving hosts
        sharing one warm list)."""
        with other._lock:
            theirs = {k: dict(v) for k, v in other._entries.items()}
        with self._lock:
            for k, e in theirs.items():
                mine = self._entries.get(k)
                if mine is None:
                    self._entries[k] = e
                else:
                    mine["count"] += e["count"]
                    mine["last"] = max(mine["last"], e["last"])
                    mine["first"] = min(mine["first"], e["first"])
