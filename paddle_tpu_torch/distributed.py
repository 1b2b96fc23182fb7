"""Multi-process runtime (PyTorch port of ``paddle_tpu/distributed.py``).

The JAX package ties hosts together with ``jax.distributed`` and then sees
one global device list.  The port is SPMD over processes, one rank per
device: :func:`init` joins this process to the default
``torch.distributed`` process group, after which every rank builds the
same program and runs it under one ``parallel.Strategy``.  Two ways to
start a sharded run:

* torchrun: ``torchrun --nproc-per-node 4 train.py``, and in the script
  ``distributed.init()`` with no arguments (it reads ``WORLD_SIZE``,
  ``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``);
* the reference's arguments: ``init("host:port", num_processes=4,
  process_id=i)`` in each process (or any ``init_method`` URL, such as
  ``file:///tmp/rendezvous``).

:func:`spawn` starts a gang of ranks on this host from one process, with
the ``spawn`` start method, a ``file://`` rendezvous, a timeout on every
process group and a time limit on the whole gang, which it kills on
expiry: the CPU tests and ``tools/dryrun_multichip.py`` run their gloo
gangs this way.
"""
from __future__ import annotations

import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ._device import resolve_device
from .parallel import comm

_device: Optional[torch.device] = None


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, *, device=None,
         backend: Optional[str] = None,
         timeout_s: float = comm.TIMEOUT_S):
    """Join the default process group (idempotent; a no-op for one process).

    ``coordinator_address`` ~ the reference's pserver address ("host:port",
    or an init-method URL), ``num_processes`` ~ num_gradient_servers,
    ``process_id`` ~ trainer_id, as in the JAX package.  With none of them,
    torchrun's environment (``WORLD_SIZE``, ``RANK``) is read; without
    that either, the process runs alone.  ``device``: this rank's device;
    by default, or given as "cuda", the card ``cuda:<LOCAL_RANK or rank>
    % cards``, and with no card this raises (pass ``device="cpu"`` for
    CPU ranks).
    ``backend``: NCCL where each rank owns its own card, gloo otherwise
    (the CPU, or ranks sharing a card; then ``comm.GLOO_STAGED`` is staged
    through host memory).  Every process group, the mesh's subgroups
    included, takes ``timeout_s``.  Returns (process_count,
    process_index)."""
    global _device
    if dist.is_initialized():
        return process_count(), process_index()
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if "WORLD_SIZE" not in env or "RANK" not in env:
            _device = torch.device(device) if device is not None else None
            return 1, 0
        url, n, pid = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError("init: give coordinator_address, num_processes "
                             "and process_id together (or none of them, "
                             "under torchrun)")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        n, pid = int(num_processes), int(process_id)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(env.get("LOCAL_RANK", pid))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if backend is None:
        own_card = (dev.type == "cuda"
                    and torch.cuda.device_count() >= n)
        backend = "nccl" if own_card else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # NCCL binds the rank to its card (else its barrier guesses one)
    extra = {"device_id": dev} if backend == "nccl" else {}
    comm.group_timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=url, world_size=n,
                            rank=pid, timeout=comm.group_timeout, **extra)
    _device = dev
    return n, pid


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def device() -> torch.device:
    """This rank's device (the one ``init`` chose), the card by default."""
    if _device is not None:
        return _device
    return resolve_device(None)


def make_file_dispatcher(files, timeout_s: float = 300.0, failure_max: int = 3,
                         snapshot_path: Optional[str] = None,
                         partition_by_host: bool = True):
    """The reference's master-style task dispatcher needs ``native.
    TaskQueue``, which is ROADMAP A.10; it waits for that port."""
    raise NotImplementedError(
        "make_file_dispatcher needs native.TaskQueue, which is not ported "
        "yet: ROADMAP A.10 (native.py)")


def global_batch_array(local_batch, mesh, axis: str = "dp"):
    """This rank's rows of a global batch, as the JAX package's
    ``make_array_from_process_local_data`` takes a host's local shard: here
    every rank of the mesh is one process, and ``local_batch`` is the
    global batch; rows ``[i * b, (i + 1) * b)`` are rank i's along
    ``axis``, b = rows / size.  A numpy array or tensor in, the same kind
    out."""
    from .parallel.mesh import mesh_axis_size

    n = mesh_axis_size(mesh, axis)
    rows = local_batch.shape[0]
    if rows % n:
        raise ValueError(f"global batch of {rows} rows does not divide over "
                         f"{axis}={n}")
    b = rows // n
    i = mesh.coord(axis)
    return local_batch[i * b:(i + 1) * b]


# ------------------------------------------------------------ gangs


def _rank_main(rank: int, n: int, url: str, device: str, backend, fn,
               args, results, timeout_s: float) -> None:
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        init(url, n, rank, device=device, backend=backend,
             timeout_s=timeout_s)
        out = fn(*args)
        results.put((rank, True, out))
    except Exception:  # noqa: BLE001 — the rank's boundary: reported
        results.put((rank, False, traceback.format_exc()))
    finally:
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # noqa: BLE001
            pass


def spawn(fn: Callable, n_ranks: int, *args, device=None,
          backend: Optional[str] = None, timeout_s: float = 600.0,
          group_timeout_s: float = 90.0) -> list:
    """Run ``fn(*args)`` on a gang of ``n_ranks`` processes on this host and
    return their results by rank.  ``fn`` must be importable (a module's
    top-level function: the ranks start with the ``spawn`` method, never
    ``fork``).  Each rank calls :func:`init` with a ``file://`` rendezvous
    in a fresh directory (no port to collide) and ``device``: by default
    "cuda", rank r on card r % cards (NCCL when each rank has a card of
    its own; this raises without a card), a card that all ranks share
    ("cuda:0": then gloo), or "cpu"; every process group takes
    ``group_timeout_s``.  The gang as a whole has ``timeout_s``: on
    expiry, or when a rank fails or dies, every rank is killed and this
    raises with the ranks' tracebacks.  Kernels are never built in a
    rank: build them in the parent first."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if backend is None and dev.index is not None and n_ranks > 1:
        backend = "gloo"   # the ranks share one card: NCCL refuses
    device = str(dev)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pt-gang-")
    url = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, url, device, backend, fn, args,
                               results, group_timeout_s),
                         daemon=True)
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    out, errors = {}, {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(errors) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                errors["gang"] = f"timed out after {timeout_s} s"
                break
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in out and r not in errors]
                if dead:
                    # let a dying rank's report arrive, then stop
                    time.sleep(1.0)
                    while True:
                        try:
                            rank, ok, val = results.get_nowait()
                        except _queue.Empty:
                            break
                        (out if ok else errors)[rank] = val
                    for r in dead:
                        errors.setdefault(r, f"rank {r} exited with "
                                             f"{procs[r].exitcode}")
                    break
                continue
            (out if ok else errors)[rank] = val
            if not ok:
                break
    finally:
        if errors:
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        msg = "\n".join(f"--- rank {r} ---\n{e}"
                        for r, e in sorted(errors.items(), key=str))
        raise RuntimeError(f"gang of {n_ranks} ranks failed:\n{msg}")
    return [out[r] for r in range(n_ranks)]
