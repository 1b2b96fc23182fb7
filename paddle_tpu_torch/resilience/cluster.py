"""Cluster-level failure handling for gang-scheduled training (the port's
copy of ``paddle_tpu/resilience/cluster.py``).

A scheduler PREEMPTS a host (SIGTERM, a grace period, then SIGKILL), or a
collective HANGS because a peer died and every surviving rank blocks in
it.  The conventions:

  PreemptionGuard   SIGTERM/SIGINT arm a grace flag; the Trainer finishes
                    the in-flight step, checkpoints (the parameters and the
                    dataset queue's cursor) and exits EXIT_PREEMPTED, so
                    the supervisor knows the state on disk is resumable.
  Watchdog          a monitor thread that the train loop beats every step;
                    a step longer than ``hang_timeout_s`` means a hung
                    collective or a dead peer, and the only safe recovery
                    is to die (``os._exit(EXIT_HUNG)``) and let the
                    supervisor restart the gang from the agreed checkpoint.
  agree_restore_step
                    before any restore or rollback, the ranks gather their
                    INTACT checkpoint steps and all restore the newest step
                    every rank holds.  One rank, or no process group: the
                    local answer, no collective.
  restart_count     the supervisor exports its relaunch count to children
                    in PADDLE_TPU_RESTARTS.

The reference exchanges the step sets through ``jax.distributed``'s
key-value store; the port through ``torch.distributed.all_gather_object``
on the default process group, which ``distributed.init`` makes with
``comm.group_timeout``.  The watchdog counts ``resilience.hang_kills`` and
writes the flight recorder's postmortem before it force-exits; the
agreement counts ``resilience.restore_agreements`` and
``resilience.restore_downgrades``.

Fault site (``resilience/faults.py``):
  cluster.heartbeat   in ``Watchdog.beat``: an armed fault DROPS the
                      heartbeat instead of raising, a host whose main
                      thread is stuck in a collective, so that tests fire
                      the watchdog through the real monitor thread.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from datetime import timedelta
from typing import Callable, Optional

try:
    from . import faults
    from .policy import _incr
except ImportError:  # file-loaded standalone (tools/supervise.py): no
    # package, so no fault registry and no counters; the sites are no-ops
    class faults:  # noqa: N801 — stands in for the module
        @staticmethod
        def check(site):
            return None

    def _incr(name):
        return None

# Exit codes the supervisor keys on.  EXIT_PREEMPTED is sysexits'
# EX_TEMPFAIL: the process drained gracefully and the state on disk
# (checkpoint + queue snapshot) is known-good.  EXIT_HUNG is a watchdog
# force-exit: the state on disk is what the last periodic checkpoint
# left, resumable through restore agreement.  Anything else is a crash.
EXIT_PREEMPTED = 75
EXIT_HUNG = 76
RESUMABLE_EXITS = (EXIT_PREEMPTED, EXIT_HUNG)

# the contract between the supervisor parent and its children
RESTARTS_ENV = "PADDLE_TPU_RESTARTS"
SUPERVISED_ENV = "PADDLE_TPU_SUPERVISED"


def _world():
    """(process count, this process's rank) of the default process group;
    (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _postmortem(reason: str, **extra) -> Optional[str]:
    """The flight recorder's postmortem (``obs/recorder.py``), the artifact
    that explains the force-exit about to happen.  Returns the path, or
    None on any failure: never an exception on the crash path."""
    try:
        from ..obs import recorder

        return recorder.dump(reason, extra=extra)
    except Exception:  # noqa: BLE001
        return None


def restart_count() -> int:
    """How many times the supervisor has relaunched this process tree (0 on
    the first launch, or when not running under a supervisor)."""
    try:
        return int(os.environ.get(RESTARTS_ENV, "0"))
    except ValueError:
        return 0


def under_supervisor() -> bool:
    return bool(os.environ.get(SUPERVISED_ENV))


def resumable_exit(code: int = EXIT_PREEMPTED) -> None:
    """Exit with a resumable code after a graceful drain.

    In a gang (more than one rank): ``os._exit``, since the interpreter's
    normal finalization would wait in the process group's shutdown for a
    peer that may be stuck in a collective; the checkpoint the caller just
    wrote is already fsynced.  Alone: raises ``SystemExit(code)`` so that
    in-process callers (and tests) can observe the drain."""
    if _world()[0] > 1:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    raise SystemExit(code)


# --------------------------------------------------------------- preemption


class PreemptionGuard:
    """SIGTERM/SIGINT handler that arms a grace flag instead of killing the
    process.  The Trainer polls ``preempted`` at step boundaries and
    drains: finish the in-flight step, checkpoint, exit EXIT_PREEMPTED.

    A SECOND signal restores the previous handlers and re-raises it, so
    that a process whose drain is itself wedged can still be killed.

    Signal handlers install only from the main thread; ``install()``
    degrades to a no-op elsewhere (``active`` says so), so a Trainer
    driven from a worker thread keeps working, without graceful
    preemption."""

    def __init__(self, signals=None):
        import signal as _signal

        self._signal = _signal
        self.signals = tuple(signals) if signals is not None else (
            _signal.SIGTERM, _signal.SIGINT)
        self._prev = {}
        self._preempted = threading.Event()
        self.active = False

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def _handle(self, signum, frame):
        if self._preempted.is_set():
            # second notice: stop being graceful
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self._preempted.set()
        sys.stderr.write(
            f"paddle_tpu_torch: received signal {signum}; draining: "
            f"finishing the in-flight step, checkpointing, then exiting "
            f"{EXIT_PREEMPTED}\n")
        sys.stderr.flush()

    def install(self) -> "PreemptionGuard":
        try:
            for s in self.signals:
                self._prev[s] = self._signal.signal(s, self._handle)
            self.active = True
        except ValueError:  # not the main thread
            self._prev.clear()
            self.active = False
        return self

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            try:
                self._signal.signal(s, h)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self.active = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()


# ----------------------------------------------------------------- watchdog


class Watchdog:
    """Progress watchdog for the train loop: ``beat()`` every completed
    step; when no beat lands within ``timeout_s`` the monitor thread
    declares the step hung (a dead peer or a wedged collective: the main
    thread is stuck in native code and cannot time out on its own) and
    calls ``on_hang(stalled_s)``, which by default force-exits the process
    with EXIT_HUNG so that the supervisor restarts the gang from the
    agreed checkpoint.

    ``os._exit``, not ``sys.exit``: the main thread is blocked, and an
    exception raised on the monitor thread would die unheard.  The thread
    is a daemon AND joined by ``stop()``, so no watchdog thread outlives
    ``Trainer.train`` on the healthy path."""

    def __init__(self, timeout_s: float,
                 on_hang: Optional[Callable[[float], None]] = None,
                 name: str = "step", poll_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"hang timeout must be positive, got "
                             f"{timeout_s}")
        self.timeout_s = float(timeout_s)
        self.name = name
        self._on_hang = on_hang or self._default_on_hang
        self._poll_s = (poll_s if poll_s is not None
                        else min(self.timeout_s / 4, 1.0))
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False

    def _default_on_hang(self, stalled_s: float) -> None:
        sys.stderr.write(
            f"paddle_tpu_torch watchdog: no progress on '{self.name}' for "
            f"{stalled_s:.1f}s (> {self.timeout_s:.1f}s); presumed hung "
            f"collective or dead peer; force-exiting {EXIT_HUNG} for a gang "
            f"restart\n")
        sys.stderr.flush()
        # postmortem with every thread's stack (the question on a hang is
        # where each thread is stuck, and this monitor thread is the only
        # one still able to say); fail-safe, it cannot block the exit
        _postmortem("hang", watchdog=self.name,
                    stalled_s=round(stalled_s, 3),
                    timeout_s=self.timeout_s)
        os._exit(EXIT_HUNG)

    def start(self) -> "Watchdog":
        self._last = time.monotonic()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"paddle_tpu_torch-watchdog-{self.name}")
        self._thread.start()
        return self

    def beat(self) -> None:
        try:
            faults.check("cluster.heartbeat")
        except BaseException:
            # an injected fault LOSES the heartbeat, as a host whose loop
            # stopped reaching the beat
            return
        self._last = time.monotonic()

    def stalled_s(self) -> float:
        return time.monotonic() - self._last

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            stalled = self.stalled_s()
            if stalled > self.timeout_s:
                self.fired = True
                _incr("resilience.hang_kills")
                self._on_hang(stalled)
                return

    def stop(self) -> None:
        """Idempotent; joins the monitor so that no watchdog thread
        outlives the loop it guards."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join()

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# --------------------------------------------------------------- agreement

# each rank contributes its newest _AGREE_PAD intact steps (max_to_keep is
# normally far smaller)
_AGREE_PAD = 32
_lock = threading.Lock()
_barrier_rounds: dict = {}


def _allgather(obj) -> list:
    """Every rank's ``obj``, by rank, through ``all_gather_object`` on the
    default process group (whose timeout ``distributed.init`` set to
    ``comm.group_timeout``): a control-plane exchange of a few small
    Python objects, for restore time and never for the hot path."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier(tag: str, timeout_s: float = 600.0) -> None:
    """A named sync point of every rank.  The ranks must call the tags in
    the same order; a per-tag round counter keeps repeated barriers
    distinct, and a rank that arrives at another tag or round raises.  On
    a gloo group a rank that never arrives fails the others after
    ``timeout_s`` (``monitored_barrier`` names it); on NCCL after the
    group's own timeout.  A rank that dies before arriving leaves the
    others blocked until then, the condition the Watchdog exists to
    break.  No-op for one rank."""
    if _world()[0] <= 1:
        return
    import torch.distributed as dist

    with _lock:
        rnd = _barrier_rounds.get(tag, 0)
        _barrier_rounds[tag] = rnd + 1
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=timedelta(seconds=timeout_s),
                               wait_all_ranks=True)
    seen = _allgather((tag, rnd))
    if any(s != (tag, rnd) for s in seen):
        raise RuntimeError(f"barrier {tag!r} round {rnd}: the ranks arrived "
                           f"at {seen}; every rank must call the same tags "
                           f"in the same order")


def agree_restore_step(local_steps) -> Optional[int]:
    """Cross-rank restore agreement: every rank contributes its INTACT
    checkpoint steps (``CheckpointManager.intact_steps()``; an int or None
    is accepted too) and every rank gets back the newest step that EVERY
    rank can restore, the maximum of the intersection of the sets; None
    when the intersection is empty (everyone cold-starts).

    The full sets are exchanged, not each rank's newest: with newest {A:
    10, B: 5} and A's step 5 corrupt, the minimum of the newest would send
    A to a step it cannot load.  The intersection is loadable everywhere.

    One rank, or no process group: the newest local step, no
    collective."""
    if local_steps is None:
        mine = []
    elif isinstance(local_steps, int):
        mine = [local_steps]
    else:
        mine = sorted((int(s) for s in local_steps), reverse=True)
    if _world()[0] <= 1:
        return mine[0] if mine else None
    step_sets = [set(s) for s in _allgather(mine[:_AGREE_PAD])]
    common = set.intersection(*step_sets) if step_sets else set()
    _incr("resilience.restore_agreements")
    if not common:
        return None
    agreed = max(common)
    if mine and agreed < mine[0]:
        # this rank gives up newer local state so the gang stays consistent
        _incr("resilience.restore_downgrades")
    return agreed
