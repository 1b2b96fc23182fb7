"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``ops/csrc/`` has a plain C interface.  It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes`` at first use (never at import: the CPU tests import every module
on a host with no ``nvcc``).  Libraries go under ``build/paddle_tpu_torch/``
at the root of the checkout, named by a hash of the source and the flags, so
a changed source builds anew and an unchanged one loads what is there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling and ptxas's report (registers, spills) of each
# kernel, per source name, for the smoke script's report
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}
# ctypes signatures of the C entry points, by source and function name:
# (restype, argtypes), declared by the wrappers when they are imported and
# set once, when the library loads
_signatures: Dict[str, Dict[str, Tuple[type, List[type]]]] = {}


def declare(source_name: str, name: str, restype, argtypes) -> None:
    """Record the ctypes signature of entry point ``name`` of
    ``ops/csrc/<source_name>``; it is set when the library loads."""
    _signatures.setdefault(source_name, {})[name] = (restype, list(argtypes))


def find_nvcc() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then
    ``/usr/local/cuda/bin``, then ``PATH``.  Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "paddle_tpu_torch are built on the machine with "
                           "the card, which needs the CUDA toolkit")
    return found


def _target(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build_library(source_name: str) -> Path:
    """Compile ``ops/csrc/<source_name>`` if its hashed library is missing;
    returns the library's path.  Compiler failures raise with nvcc's
    output.  Takes no lock, so that ``chip_smoke.py`` can run one nvcc per
    source at once (it must build every source within its time limit); the
    library is written under a temporary name and renamed into place."""
    source = CSRC / source_name
    so_path = _target(source)
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(
            f".{os.getpid()}-{threading.get_ident()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed building {source_name} "
                f"(rc={proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so_path)  # atomic: a reader never sees half
        build_seconds[source_name] = time.perf_counter() - t0
        build_logs[source_name] = proc.stdout + proc.stderr
    return so_path


def load_kernel_library(source_name: str) -> ctypes.CDLL:
    """Build ``ops/csrc/<source_name>`` if needed (see
    :func:`build_library`), then load it, once per process, with the
    signatures :func:`declare` recorded for it."""
    with _lock:
        lib = _loaded.get(source_name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source_name)))
            for name, (restype, argtypes) in _signatures.get(
                    source_name, {}).items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _loaded[source_name] = lib
        return lib
