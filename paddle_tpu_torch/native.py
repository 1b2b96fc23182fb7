"""ctypes binding to the native C++ runtime library (PyTorch port of
``paddle_tpu/native.py``).

The reference implements its runtime services natively (C++ data providers
paddle/gserver/dataproviders/, Go master go/master, Go pserver
checkpointing); the equivalents live in the repository's ``native/*.cc``,
which both packages share.  The port compiles those sources itself, with
the Makefile's flags (``-O2 -std=c++17 -fPIC -pthread``, linked
``-shared``), into ``build/paddle_tpu_torch/native/`` at the root of the
checkout, named by a hash of the sources and the flags; it never writes
under ``native/`` and never loads the library the JAX package builds there.
The build happens at first use, never at import, under an inter-process
file lock, to a temporary name renamed into place: concurrent first uses
(test workers, a supervisor's children) build once and never load a
partial file.  With no C++ compiler every entry point raises
``NativeUnavailable`` with the reason.

Exposed:
  RecordIOWriter / RecordIOReader — CRC-checked record files
  TaskQueue — master-style dataset task dispatch (timeout/requeue/snapshot)
  Prefetcher — threaded record pipeline with streaming shuffle
  crc32(data) -> int

File formats (records, queue snapshots) are the JAX package's byte for
byte: the same C++ writes them.

Fault site (``resilience/faults.py``):
  queue.pop         in ``TaskQueue.get``, before the native pop.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

from .resilience import faults

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "paddle_tpu_torch" \
    / "native"
SOURCES = ("recordio.cc", "taskqueue.cc", "prefetch.cc")
HEADERS = ("paddle_native.h",)
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None
_lib_lock = threading.Lock()
# seconds the last compile in this process took (None: loaded a built one)
build_seconds: Optional[float] = None


class NativeUnavailable(RuntimeError):
    pass


def _grow_call(call, cap: int = 1 << 20):
    """Shared retry-with-bigger-buffer loop for native calls that return -3
    when the caller's buffer is too small (tq_get/tq_payloads contract: the
    item is NOT consumed on -3).  Returns (n, buf)."""
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = call(buf, cap)
        if n == -3:
            cap *= 4
            continue
        return n, buf


def library_path() -> Path:
    """The hashed library path for the current sources and flags."""
    h = hashlib.sha256()
    try:
        for name in SOURCES + HEADERS:
            h.update(name.encode() + b"\0")
            h.update((NATIVE_DIR / name).read_bytes())
    except OSError as e:
        raise NativeUnavailable(f"native sources missing: {e}")
    h.update("\0".join(CXX_FLAGS).encode())
    return Path(BUILD_DIR) / f"libpaddle_native-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the library if its hashed file is missing; returns its path.
    Takes an exclusive ``fcntl`` lock on the build directory's lock file,
    so that one process of many compiles and the others wait and load."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise NativeUnavailable(
            f"native build failed: no C++ compiler {cxx!r} on PATH")
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():  # another process built it while we waited
                return so
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
                   *[str(NATIVE_DIR / s) for s in SOURCES]]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise NativeUnavailable(f"native build failed: {e}")
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeUnavailable(
                    f"native build failed:\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def lib() -> ctypes.CDLL:
    """The loaded native library (building it first if needed)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build()
        try:
            l = ctypes.CDLL(str(path))
        except OSError as e:  # stale/foreign-arch .so
            raise NativeUnavailable(f"cannot load {path}: {e}")
        l.pn_crc32.restype = ctypes.c_uint32
        l.pn_crc32.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        l.rio_writer_open.restype = ctypes.c_void_p
        l.rio_writer_open.argtypes = [ctypes.c_char_p]
        l.rio_writer_write.restype = ctypes.c_int
        l.rio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        l.rio_writer_close.restype = ctypes.c_int
        l.rio_writer_close.argtypes = [ctypes.c_void_p]
        l.rio_reader_open.restype = ctypes.c_void_p
        l.rio_reader_open.argtypes = [ctypes.c_char_p]
        l.rio_reader_peek.restype = ctypes.c_int64
        l.rio_reader_peek.argtypes = [ctypes.c_void_p]
        l.rio_reader_read.restype = ctypes.c_int64
        l.rio_reader_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        l.rio_reader_close.restype = ctypes.c_int
        l.rio_reader_close.argtypes = [ctypes.c_void_p]
        l.tq_create.restype = ctypes.c_void_p
        l.tq_create.argtypes = [ctypes.c_double, ctypes.c_int]
        l.tq_destroy.argtypes = [ctypes.c_void_p]
        l.tq_add.restype = ctypes.c_int
        l.tq_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        l.tq_get.restype = ctypes.c_int64
        l.tq_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        l.tq_finish.restype = ctypes.c_int
        l.tq_finish.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        l.tq_fail.restype = ctypes.c_int
        l.tq_fail.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        l.tq_sweep.restype = ctypes.c_int
        l.tq_sweep.argtypes = [ctypes.c_void_p]
        l.tq_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        l.tq_new_epoch.restype = ctypes.c_int
        l.tq_new_epoch.argtypes = [ctypes.c_void_p]
        l.tq_snapshot.restype = ctypes.c_int
        l.tq_snapshot.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        l.tq_payloads.restype = ctypes.c_int64
        l.tq_payloads.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        l.tq_restore.restype = ctypes.c_void_p
        l.tq_restore.argtypes = [ctypes.c_char_p, ctypes.c_double, ctypes.c_int]
        l.pf_create.restype = ctypes.c_void_p
        l.pf_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
                                ctypes.c_uint64]
        l.pf_next.restype = ctypes.c_int64
        l.pf_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        l.pf_destroy.argtypes = [ctypes.c_void_p]
        _lib = l
        return _lib


def available() -> bool:
    try:
        lib()
        return True
    except NativeUnavailable:
        return False


def crc32(data: bytes) -> int:
    return lib().pn_crc32(data, len(data))


# --------------------------------------------------------------------------- recordio


class RecordIOWriter:
    """CRC-checked record file writer (native/recordio.cc)."""

    def __init__(self, path: str):
        self._h = lib().rio_writer_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path} for writing")

    def write(self, record: bytes) -> None:
        if lib().rio_writer_write(self._h, record, len(record)) != 0:
            raise IOError("recordio write failed")

    def close(self) -> None:
        if self._h:
            lib().rio_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordIOReader:
    """Iterates records; raises IOError on CRC mismatch/corruption."""

    def __init__(self, path: str):
        self._h = lib().rio_reader_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path} (missing or bad magic)")

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        n = lib().rio_reader_peek(self._h)
        if n == -1:
            raise StopIteration
        if n < 0:
            raise IOError("recordio corruption detected")
        buf = ctypes.create_string_buffer(int(n))
        got = lib().rio_reader_read(self._h, buf, n)
        if got < 0:
            raise IOError("recordio corruption detected (CRC mismatch)")
        return buf.raw[:got]

    def close(self) -> None:
        if self._h:
            lib().rio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# --------------------------------------------------------------------------- task queue


class TaskQueue:
    """Master-style task dispatch (native/taskqueue.cc; ref go/master/service.go)."""

    def __init__(self, timeout_s: float = 60.0, failure_max: int = 3, _handle=None):
        self._timeout = timeout_s
        self._fmax = failure_max
        self._retired: List = []  # pre-rewind handles, destroyed only in __del__
        self._h = _handle if _handle is not None else lib().tq_create(timeout_s, failure_max)

    def add(self, task_id: str, payload: str = "") -> None:
        if lib().tq_add(self._h, task_id.encode(), payload.encode()) != 0:
            raise ValueError(f"duplicate task id {task_id!r}")

    def get(self) -> Optional[Tuple[str, str]]:
        """Claim the next task: (task_id, payload), or None when none available.
        A claimed task must be finish()ed or fail()ed before its deadline, or a
        sweep() hands it to someone else."""
        faults.check("queue.pop")
        n, buf = _grow_call(lambda b, cap: lib().tq_get(self._h, b, cap))
        if n == -1:
            return None
        if n < 0:
            raise RuntimeError("tq_get failed")
        blob = buf.raw[:n].decode()
        tid, _, payload = blob.partition("\n")
        return tid, payload

    def finish(self, task_id: str) -> None:
        if lib().tq_finish(self._h, task_id.encode()) != 0:
            raise ValueError(f"task {task_id!r} is not pending")

    def fail(self, task_id: str) -> None:
        if lib().tq_fail(self._h, task_id.encode()) != 0:
            raise ValueError(f"task {task_id!r} is not pending")

    def sweep(self) -> int:
        """Requeue timed-out pending tasks; returns how many moved."""
        return lib().tq_sweep(self._h)

    def counts(self) -> dict:
        c = (ctypes.c_int64 * 4)()
        lib().tq_counts(self._h, c)
        return {"todo": c[0], "pending": c[1], "done": c[2], "failed": c[3]}

    def new_epoch(self) -> int:
        return lib().tq_new_epoch(self._h)

    def snapshot(self, path: str) -> None:
        """Atomic: writes to a temp file, then os.replace — a crash mid-write
        can never destroy the previous good snapshot."""
        tmp = path + ".tmp"
        if lib().tq_snapshot(self._h, tmp.encode()) != 0:
            raise IOError(f"snapshot to {tmp} failed")
        os.replace(tmp, path)

    def payloads(self) -> List[str]:
        """Payloads of all tasks in any state (dataset-identity check)."""
        n, buf = _grow_call(lambda b, cap: lib().tq_payloads(self._h, b, cap),
                            cap=1 << 16)
        blob = buf.raw[:n].decode()
        return [p for p in blob.split("\n") if p]

    @classmethod
    def restore(cls, path: str, timeout_s: float = 60.0, failure_max: int = 3) -> "TaskQueue":
        h = lib().tq_restore(path.encode(), timeout_s, failure_max)
        if not h:
            raise IOError(f"cannot restore task queue from {path} (missing/corrupt)")
        return cls(timeout_s, failure_max, _handle=h)

    def rewind(self, path: str) -> None:
        """Replace this queue's state in place from a snapshot file — the
        Trainer's anomaly rollback re-winds the dataset position without
        invalidating readers that hold a reference to this queue object.

        The pre-rewind handle is RETIRED, not destroyed: an abandoned reader
        thread may still be inside a native call on it (tq_destroy is an
        unsynchronized delete), so it lives until this object's __del__."""
        h = lib().tq_restore(path.encode(), self._timeout, self._fmax)
        if not h:
            raise IOError(f"cannot rewind task queue from {path} (missing/corrupt)")
        old, self._h = self._h, h
        if old:
            self._retired.append(old)

    def __del__(self):
        for h in getattr(self, "_retired", []):
            try:
                lib().tq_destroy(h)
            except Exception:
                pass
        self._retired = []
        h = getattr(self, "_h", None)
        if h:
            try:
                lib().tq_destroy(h)
            except Exception:
                pass
            self._h = None


# --------------------------------------------------------------------------- prefetch


class Prefetcher:
    """Threaded shuffled record pipeline (native/prefetch.cc).  Single-consumer:
    call next()/iterate from one thread."""

    def __init__(self, files: Sequence[str], n_threads: int = 2,
                 shuffle_buffer: int = 0, queue_capacity: int = 1024, seed: int = 0):
        arr = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        self._h = lib().pf_create(arr, len(files), n_threads,
                                  shuffle_buffer, queue_capacity, seed)
        self._buf = ctypes.create_string_buffer(1 << 20)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        while True:
            n = lib().pf_next(self._h, self._buf, len(self._buf))
            if n == -1:
                raise StopIteration
            if n == -3:  # record larger than buffer: grow and retry next record
                self._buf = ctypes.create_string_buffer(len(self._buf) * 2)
                continue
            if n < 0:
                raise IOError("prefetch reader error (missing/corrupt input file)")
            return self._buf.raw[:n]

    def close(self) -> None:
        if self._h:
            lib().pf_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
