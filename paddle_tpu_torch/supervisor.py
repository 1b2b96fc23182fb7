"""Bounded-restart supervisor: the process that outlives the trainer
(PyTorch port of ``paddle_tpu/supervisor.py``).

The reference's answer to dying trainers was the cluster scripts + Go
master: ``paddle/scripts/submit_local.sh.in`` relaunches paddle_trainer,
and the master re-dispatches a dead trainer's tasks after its lease times
out.  In a gang the unit of restart is the GANG: one member dying
(preemption, hang, crash) strands every peer inside a collective, so the
supervisor kills and relaunches all members together and the gang
re-agrees on a restore step (resilience/cluster.py).

Exit-code protocol (resilience.cluster):

  0               finished — stop.
  EXIT_PREEMPTED  graceful drain after SIGTERM/SIGINT: checkpoint + queue
                  snapshot are known-good.  Restart WITHOUT consuming the
                  crash budget and WITHOUT backoff — preemption is the
                  scheduler's doing, not a crash loop (its own bound,
                  ``max_preemptions``, keeps a flapping scheduler finite).
  EXIT_HUNG       watchdog force-exit (hung collective / dead peer).
                  Resumable — restore agreement picks the step — but it
                  spends the crash budget and backs off: a hang that
                  recurs every generation is a real fault, not weather.
  anything else   crash.  Restart with ``resilience.Backoff`` up to
                  ``max_restarts``, then give up with that code.

Classification is by the WORST evidence in the gang, with preemption
winning: when any member exits EXIT_PREEMPTED, its partners' hang-kills
and our own gang teardown (SIGTERM, then SIGKILL past the grace window)
are collateral of the same event, not independent failures.

Import contract: stdlib + resilience.policy/cluster only — no torch.  The
supervisor parent must never initialize CUDA (the children own the card);
``tools/supervise.py`` file-loads this module, which then loads
``resilience/policy.py`` and ``cluster.py`` by file too, to keep even the
package import (which pulls torch) out of the parent.  The counters
(``resilience.restarts``, ``hang_restarts``, ``crash_restarts``,
``preemptions``) and the flight recorder's events count only where the
package is imported, as in the reference.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

try:
    from .resilience import cluster
    from .resilience.policy import Backoff, RetryPolicy
except ImportError:  # file-loaded standalone (scripts/supervise.py)
    import importlib.util as _ilu

    def _load(_name, _path):
        if _name in sys.modules:
            return sys.modules[_name]
        spec = _ilu.spec_from_file_location(_name, _path)
        mod = _ilu.module_from_spec(spec)
        sys.modules[_name] = mod  # dataclasses resolve through sys.modules
        spec.loader.exec_module(mod)
        return mod

    _res = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resilience")
    _policy = _load("_paddle_tpu_torch_sup_policy",
                    os.path.join(_res, "policy.py"))
    cluster = _load("_paddle_tpu_torch_sup_cluster",
                    os.path.join(_res, "cluster.py"))
    Backoff, RetryPolicy = _policy.Backoff, _policy.RetryPolicy


def _incr(name: str) -> None:
    try:
        from .profiler import incr
    except ImportError:
        return
    incr(name)


def _recorder():
    """obs flight recorder, or None when file-loaded standalone (the
    tools/supervise.py parent works without the package)."""
    try:
        from .obs import recorder
    except ImportError:
        return None
    return recorder


def _free_port(host: str = "127.0.0.1") -> int:
    s = socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Supervisor:
    """Relaunch a trainer gang on resumable exits, boundedly.

    ``cmds``: one argv list per gang member (a single argv list means a
    gang of one).  Gangs get fresh process-group identity env per
    generation (``PADDLE_TPU_COORDINATOR_ADDRESS`` on a newly-picked port —
    the old port may sit in TIME_WAIT — plus NUM_HOSTS/TRAINER_ID, which
    ``distributed.init()`` reads), unless
    ``gang_env=False`` because the caller wires identity itself.  Every
    child additionally gets ``PADDLE_TPU_RESTARTS`` (relaunch count, shown
    in serving healthz) and ``PADDLE_TPU_SUPERVISED=1``.

    ``on_spawn(procs)`` fires after each generation launches — tests use
    it to deliver a preemption SIGTERM to a specific member.

    ``compile_dir``: forwarded to every child (and every generation) as
    ``PADDLE_TPU_COMPILE_DIR``: a port child's ``Trainer`` keeps its AOT
    store and shape manifest there, so that each generation after the
    first warm-starts from what the last one recorded (``Trainer.prepare``).
    None leaves whatever the parent environment says.

    ``log_dir``: per-generation child stdout/stderr capture files
    (``gen<G>-r<I>.log``); None inherits the parent's streams."""

    def __init__(self, cmds, max_restarts: int = 5, max_preemptions: int = 64,
                 backoff: Optional[Backoff] = None,
                 env: Optional[dict] = None, gang_env: bool = True,
                 coordinator_host: str = "127.0.0.1",
                 gang_grace_s: float = 15.0,
                 compile_dir: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 on_spawn: Optional[Callable[[List[subprocess.Popen]], None]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if cmds and isinstance(cmds[0], str):
            cmds = [cmds]
        self.cmds: List[List[str]] = [list(c) for c in cmds]
        if not self.cmds:
            raise ValueError("supervisor needs at least one command")
        self.max_restarts = max_restarts
        self.max_preemptions = max_preemptions
        self.backoff = backoff or Backoff(RetryPolicy(
            max_attempts=max(max_restarts, 1), base_delay_s=0.5,
            max_delay_s=30.0, jitter=0.25))
        self.extra_env = dict(env or {})
        self.gang_env = gang_env
        self.coordinator_host = coordinator_host
        self.gang_grace_s = gang_grace_s
        self.compile_dir = compile_dir
        self.log_dir = log_dir
        self.on_spawn = on_spawn
        self._sleep = sleep
        # introspection (healthz-shaped)
        self.restarts = 0          # total relaunches, any reason
        self.preemptions = 0       # preemption-driven relaunches
        self.crash_restarts = 0    # budgeted relaunches (crash or hang)
        self.last_codes: List[int] = []
        self._shutdown_sig: Optional[int] = None
        self._procs: List[subprocess.Popen] = []
        self._signaled: set = set()  # pids the shutdown handler SIGTERMed

    # ------------------------------------------------------------- lifecycle

    def _child_env(self, rank: int, generation: int) -> dict:
        env = dict(os.environ)
        env.update(self.extra_env)
        env[cluster.RESTARTS_ENV] = str(generation)
        env[cluster.SUPERVISED_ENV] = "1"
        if self.compile_dir:
            # literal name: the supervisor's import contract is
            # stdlib-only — importing the package would pull torch into the
            # parent
            env["PADDLE_TPU_COMPILE_DIR"] = self.compile_dir
        if self.gang_env and len(self.cmds) > 1:
            env["PADDLE_TPU_COORDINATOR_ADDRESS"] = self._coord
            env["PADDLE_TPU_NUM_HOSTS"] = str(len(self.cmds))
            env["PADDLE_TPU_TRAINER_ID"] = str(rank)
        return env

    def _spawn(self, generation: int) -> List[subprocess.Popen]:
        if self.gang_env and len(self.cmds) > 1:
            self._coord = f"{self.coordinator_host}:{_free_port(self.coordinator_host)}"
        # build the live list incrementally so a shutdown signal landing
        # mid-spawn still sees (and SIGTERMs) the children already launched
        self._signaled.clear()  # pids can be recycled across generations
        self._procs = procs = []
        for rank, cmd in enumerate(self.cmds):
            out = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                out = open(os.path.join(
                    self.log_dir, f"gen{generation}-r{rank}.log"), "wb")
            procs.append(subprocess.Popen(
                cmd, env=self._child_env(rank, generation),
                stdout=out, stderr=subprocess.STDOUT if out else None))
            if out is not None:
                out.close()  # the child holds the fd now
        if self.on_spawn:
            self.on_spawn(procs)
        return procs

    def _reap(self, procs: List[subprocess.Popen]) -> List[int]:
        """Wait for the gang.  All-zero exits end the generation cleanly; the
        first NONZERO exit triggers gang teardown — the survivors are blocked
        on a collective whose peer is gone, so SIGTERM them (their
        PreemptionGuard drains what it can), escalate to SIGKILL after the
        grace window, and collect every code."""
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return [int(c) for c in codes]
            if self._shutdown_sig is not None:
                break
            if any(c is not None and c != 0 for c in codes):
                break
            self._sleep(0.05)
        # SIGTERM survivors exactly once: children the shutdown handler
        # already signaled are skipped — a SECOND SIGTERM would trip
        # PreemptionGuard's escalation and abort their drains
        for p in procs:
            if p.poll() is None and p.pid not in self._signaled:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self.gang_grace_s
        while time.monotonic() < deadline:
            if all(p.poll() is not None for p in procs):
                break
            self._sleep(0.1)
        for p in procs:
            if p.poll() is None:
                try:
                    p.kill()
                except OSError:
                    pass
        return [int(p.wait()) for p in procs]

    # ------------------------------------------------------------------ run

    def _install_signals(self):
        def fwd(signum, frame):
            # the SUPERVISOR got the preemption notice: pass it down, stop
            # restarting, and exit with the gang's verdict
            self._shutdown_sig = signum
            for p in self._procs:
                if p.poll() is None:
                    try:
                        p.send_signal(signal.SIGTERM)
                        self._signaled.add(p.pid)
                    except OSError:
                        pass

        prev = {}
        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                prev[s] = signal.signal(s, fwd)
        except ValueError:  # not the main thread (in-process tests)
            prev.clear()
        return prev

    def _restore_signals(self, prev):
        for s, h in prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, TypeError):
                pass

    def run(self) -> int:
        prev = self._install_signals()
        try:
            generation = 0
            while True:
                if self._shutdown_sig is not None:
                    # told to stop between generations (during backoff or
                    # before a relaunch): never spawn children just to kill
                    # them — the previous generation's drained state stands
                    return cluster.EXIT_PREEMPTED
                codes = self._reap(self._spawn(generation))
                self.last_codes = codes
                rec = _recorder()
                if rec is not None:
                    rec.record_event("supervisor.generation_exit",
                                     generation=generation, codes=codes)
                if all(c == 0 for c in codes):
                    return 0
                first_bad = next(c for c in codes if c != 0)
                if self._shutdown_sig is not None:
                    # we were told to stop: the children's resumable exits
                    # are the graceful outcome, not a failure to mask
                    return (cluster.EXIT_PREEMPTED
                            if any(c in cluster.RESUMABLE_EXITS for c in codes)
                            else first_bad)
                preempted = any(c == cluster.EXIT_PREEMPTED for c in codes)
                hung = any(c == cluster.EXIT_HUNG for c in codes)
                if preempted:
                    self.preemptions += 1
                    _incr("resilience.preemptions")
                    if self.preemptions > self.max_preemptions:
                        sys.stderr.write(
                            f"supervisor: {self.preemptions - 1} preemptions "
                            f"exceeded max_preemptions={self.max_preemptions}; "
                            f"giving up\n")
                        return cluster.EXIT_PREEMPTED
                    self.backoff.reset()  # not a crash loop: restart clean
                else:
                    self.crash_restarts += 1
                    if hung:
                        _incr("resilience.hang_restarts")
                    else:
                        _incr("resilience.crash_restarts")
                    # supervisor-observed child death: the parent's own
                    # postmortem — gang exit codes, restart counts, and the
                    # spawn/exit event history — complements whatever the
                    # children managed to dump before dying
                    if rec is not None:
                        rec.dump("child_death", extra={
                            "generation": generation, "codes": codes,
                            "hung": hung,
                            "crash_restarts": self.crash_restarts})
                    if self.crash_restarts > self.max_restarts:
                        sys.stderr.write(
                            f"supervisor: exit codes {codes} after "
                            f"{self.crash_restarts - 1} budgeted restart(s) — "
                            f"max_restarts={self.max_restarts} exhausted\n")
                        return first_bad
                    self._sleep(self.backoff.next())
                self.restarts += 1
                _incr("resilience.restarts")
                generation += 1
                sys.stderr.write(
                    f"supervisor: gang exited {codes} "
                    f"({'preemption' if preempted else 'hang' if hung else 'crash'}); "
                    f"relaunching generation {generation} "
                    f"(restarts={self.restarts})\n")
                sys.stderr.flush()
        finally:
            self._restore_signals(prev)
            # never leave orphans, whatever path exited the loop
            for p in self._procs:
                if p.poll() is None:
                    try:
                        p.kill()
                        p.wait()
                    except OSError:
                        pass


def supervise(cmd: Sequence[str], **kw) -> int:
    """One-call form: ``supervise(["python", "train.py"], max_restarts=3)``."""
    return Supervisor(list(cmd), **kw).run()
