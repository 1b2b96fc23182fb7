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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling, per library name, for the smoke script's report
build_seconds: Dict[str, float] = {}


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


def load_kernel_library(source_name: str) -> ctypes.CDLL:
    """Compile ``ops/csrc/<source_name>`` if its hashed library is missing,
    then load it.  Compiler failures raise with nvcc's output."""
    with _lock:
        lib = _loaded.get(source_name)
        if lib is not None:
            return lib
        source = CSRC / source_name
        so_path = _target(source)
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
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
        lib = ctypes.CDLL(str(so_path))
        _loaded[source_name] = lib
        return lib
