"""``paddle_tpu_torch.supervisor`` and ``tools/supervise.py`` on the CPU:
the reference's cases (``tests/test_supervisor.py``) in the port.

* the exit-code protocol: a clean exit; the crash budget exhausted with
  the child's code; preemption not spending the budget; the hang exit
  resumable but budgeted; ``max_preemptions``; the env and the log dir;
  the restart counters (``resilience.restarts``, ``crash_restarts``,
  ``hang_restarts``, ``preemptions``) equal the supervisor's own tallies;
* the queue snapshots: a garbage snapshot and an undecodable one fall back
  to a fresh queue, and the checkpoint's paired snapshot is written by tmp
  + rename and a corrupt one tolerated by the rollback;
* ``tools/supervise.py``: its flags, the compile dir forwarded, and a
  supervising process with no torch in it, run as a script and as
  ``python -m`` (whose exec leaves no torch mapped).

Every child is a ``sys.executable -c`` script that imports no torch (but
the two ranks of the gang case, which join a gloo group through
``distributed.init()``), with the supervisor's own bounds; the
subprocesses run under a timeout."""
import glob
import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import distributed, native, profiler
from paddle_tpu_torch import reader as rdr
from paddle_tpu_torch.reader import recordio
from paddle_tpu_torch.resilience import EXIT_HUNG, EXIT_PREEMPTED, faults
from paddle_tpu_torch.supervisor import Supervisor

REPO = Path(__file__).resolve().parents[1]
SUPERVISE = REPO / "paddle_tpu_torch" / "tools" / "supervise.py"
_PY = sys.executable
COUNTERS = ("restarts", "crash_restarts", "hang_restarts", "preemptions")


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    fluid.reset_default_programs()
    fluid.reset_global_scope()
    yield
    faults.clear()
    torch.set_num_threads(n)


def _counters():
    return {k: profiler.counter(f"resilience.{k}") for k in COUNTERS}


def _run(s: Supervisor):
    """Run ``s``; returns (exit code, counter deltas)."""
    before = _counters()
    rc = s.run()
    after = _counters()
    return rc, {k: after[k] - before[k] for k in COUNTERS}


def _tallies(s, hang=0):
    return {"restarts": s.restarts, "preemptions": s.preemptions,
            "crash_restarts": s.crash_restarts - hang, "hang_restarts": hang}


# ------------------------------------------------------------- protocol


def test_supervisor_clean_exit_no_restarts():
    s = Supervisor([_PY, "-c", "import sys; sys.exit(0)"], max_restarts=3,
                   sleep=lambda d: None)
    rc, d = _run(s)
    assert rc == 0
    assert s.restarts == 0 and s.preemptions == 0 and s.crash_restarts == 0
    assert d == _tallies(s) == dict.fromkeys(COUNTERS, 0)


def test_supervisor_crash_budget_exhausts_with_child_code():
    s = Supervisor([_PY, "-c", "import sys; sys.exit(7)"], max_restarts=2,
                   sleep=lambda d: None)
    rc, d = _run(s)
    assert rc == 7
    # 1 initial launch + 2 budgeted restarts, then give up
    assert s.restarts == 2 and s.crash_restarts == 3 and s.preemptions == 0
    assert s.last_codes == [7]
    # the third crash is counted but not followed by a restart
    assert d == {"restarts": 2, "crash_restarts": 3, "hang_restarts": 0,
                 "preemptions": 0}


def test_supervisor_preemption_does_not_consume_crash_budget():
    child = ("import os, sys; "
             f"sys.exit({EXIT_PREEMPTED} "
             "if int(os.environ['PADDLE_TPU_RESTARTS']) < 2 else 0)")
    s = Supervisor([_PY, "-c", child], max_restarts=0, sleep=lambda d: None)
    rc, d = _run(s)
    assert rc == 0
    assert s.preemptions == 2 and s.restarts == 2 and s.crash_restarts == 0
    assert d == _tallies(s)


def test_supervisor_hang_exit_is_resumable_but_budgeted():
    child = ("import os, sys; "
             f"sys.exit({EXIT_HUNG} "
             "if int(os.environ['PADDLE_TPU_RESTARTS']) < 1 else 0)")
    s = Supervisor([_PY, "-c", child], max_restarts=1, sleep=lambda d: None)
    rc, d = _run(s)
    assert rc == 0
    assert s.crash_restarts == 1 and s.preemptions == 0 and s.restarts == 1
    assert d == _tallies(s, hang=1)


def test_supervisor_max_preemptions_bounds_a_flapping_scheduler():
    s = Supervisor([_PY, "-c", f"import sys; sys.exit({EXIT_PREEMPTED})"],
                   max_restarts=0, max_preemptions=2, sleep=lambda d: None)
    rc, d = _run(s)
    assert rc == EXIT_PREEMPTED
    assert s.preemptions == 3  # the third one trips the bound
    assert d == {"restarts": 2, "crash_restarts": 0, "hang_restarts": 0,
                 "preemptions": 3}


def test_supervisor_exports_env_and_log_dir(tmp_path):
    child = ("import os; print('GEN', os.environ['PADDLE_TPU_RESTARTS'], "
             "'SUP', os.environ['PADDLE_TPU_SUPERVISED'], 'CD', "
             "os.environ.get('PADDLE_TPU_COMPILE_DIR')); "
             f"import sys; sys.exit({EXIT_PREEMPTED} "
             "if int(os.environ['PADDLE_TPU_RESTARTS']) == 0 else 0)")
    logs = tmp_path / "logs"
    s = Supervisor([_PY, "-c", child], max_restarts=0, log_dir=str(logs),
                   compile_dir=str(tmp_path / "cc"), sleep=lambda d: None)
    assert s.run() == 0
    gen0 = (logs / "gen0-r0.log").read_text()
    gen1 = (logs / "gen1-r0.log").read_text()
    assert f"GEN 0 SUP 1 CD {tmp_path / 'cc'}" in gen0
    assert "GEN 1 SUP 1" in gen1


def test_supervisor_gang_identity_env(tmp_path):
    """A gang of two gets the reference's identity env, which the port's
    ``distributed.init`` reads; one member's crash tears the gang down.
    Each member prints its identity and marks it done; rank 0 crashes only
    once rank 1 has printed (under a loaded host rank 1 could otherwise be
    torn down before its first line)."""
    ready = tmp_path / "ready"
    child = ("import os, sys, time; e = os.environ; "
             "print(e['PADDLE_TPU_COORDINATOR_ADDRESS'], "
             "e['PADDLE_TPU_NUM_HOSTS'], e['PADDLE_TPU_TRAINER_ID'], "
             "flush=True); "
             f"m = {str(ready)!r} + e['PADDLE_TPU_RESTARTS']; "
             "e['PADDLE_TPU_TRAINER_ID'] == '1' and open(m, 'w').close(); "
             "t = time.time(); "
             "[time.sleep(0.01) for _ in iter(lambda: os.path.exists(m) "
             "or time.time() - t > 60, True)]; "
             "sys.exit(0 if e['PADDLE_TPU_RESTARTS'] == '1' else "
             "(3 if e['PADDLE_TPU_TRAINER_ID'] == '0' else "
             "time.sleep(60)))")
    logs = tmp_path / "logs"
    s = Supervisor([[_PY, "-c", child]] * 2, max_restarts=1,
                   log_dir=str(logs), gang_grace_s=5.0, sleep=lambda d: None)
    rc, d = _run(s)
    assert rc == 0 and s.crash_restarts == 1
    for g in (0, 1):
        lines = [(logs / f"gen{g}-r{r}.log").read_text().split()
                 for r in (0, 1)]
        assert lines[0][0] == lines[1][0] and lines[0][0].startswith(
            "127.0.0.1:")
        assert [ln[1:] for ln in lines] == [["2", "0"], ["2", "1"]]


_GANG_CHILD = (
    "import torch, torch.distributed as dist\n"
    "from paddle_tpu_torch import distributed\n"
    "n, r = distributed.init(device='cpu', timeout_s=60)\n"
    "t = torch.tensor([r + 1.0])\n"
    "dist.all_reduce(t)\n"
    "print('RANK', r, 'OF', n, 'SUM', int(t.item()), flush=True)\n"
    "dist.destroy_process_group()\n")


def test_supervised_gang_joins_through_distributed_init(tmp_path):
    """The gang's identity env is what the port's ``distributed.init()``
    reads with no arguments: two supervised ranks form a gloo group."""
    logs = tmp_path / "logs"
    s = Supervisor([[_PY, "-c", _GANG_CHILD]] * 2, max_restarts=0,
                   log_dir=str(logs), gang_grace_s=5.0,
                   env={"PYTHONPATH": str(REPO)}, sleep=lambda d: None)
    assert s.run() == 0, [(logs / f"gen0-r{r}.log").read_text()[-2000:]
                          for r in (0, 1)]
    for r in (0, 1):
        assert f"RANK {r} OF 2 SUM 3" in (logs / f"gen0-r{r}.log").read_text()


# ------------------------------------------------------ queue snapshots


def test_garbage_queue_snapshot_falls_back_to_fresh_queue(tmp_path):
    files = [str(tmp_path / f"shard-{i}.rio") for i in range(4)]
    snap = str(tmp_path / "queue.snap")
    with open(snap, "wb") as f:
        f.write(np.random.RandomState(0).bytes(256))  # fails the CRC layer
    q = distributed.make_file_dispatcher(files, snapshot_path=snap)
    assert sorted(q.payloads()) == sorted(files)
    assert q.counts()["todo"] == 4


def test_undecodable_queue_snapshot_falls_back_to_fresh_queue(tmp_path):
    # a snapshot whose bytes pass the CRC layer but hold non-UTF8 payloads
    # restores natively and then raises ValueError from payloads()
    def put_str(b: bytes) -> bytes:
        return struct.pack("<I", len(b)) + b

    blob = struct.pack("<I", 1)                     # one task
    blob += put_str(b"shard-00000")                 # id
    blob += put_str(b"\xff\xfe\xfd not utf8")       # payload: invalid UTF-8
    blob += struct.pack("<I", 0)                    # failures
    blob += put_str(b"shard-00000\n")               # todo
    blob += put_str(b"")                            # done
    blob += put_str(b"")                            # failed
    snap = str(tmp_path / "queue.snap")
    w = native.RecordIOWriter(snap)
    w.write(blob)
    w.close()

    q_raw = native.TaskQueue.restore(snap)
    with pytest.raises(ValueError):
        q_raw.payloads()

    files = [str(tmp_path / f"shard-{i}.rio") for i in range(3)]
    q = distributed.make_file_dispatcher(files, snapshot_path=snap)
    assert sorted(q.payloads()) == sorted(files)
    assert q.counts()["todo"] == 3


def _dump_shards(work, n_shards=4, n_samples=32):
    def src():
        rng = np.random.RandomState(0)
        for _ in range(n_samples):
            xs = rng.rand(4).astype("float32")
            yield xs, np.array([float(xs.sum() > 2.0)], "float32")

    recordio.dump(src, os.path.join(work, "ds"), num_shards=n_shards)
    return sorted(glob.glob(os.path.join(work, "ds-*.rio")))


def test_paired_queue_snapshot_is_atomic_and_missing_pair_tolerated(
        tmp_path):
    work = str(tmp_path)
    files = _dump_shards(work)
    snap = os.path.join(work, "queue.snap")
    q = distributed.make_file_dispatcher(files, timeout_s=30.0,
                                         snapshot_path=snap)
    x = fluid.layers.data("x", [4])
    y = fluid.layers.data("y", [1])
    pred = fluid.layers.fc(x, 1, act="sigmoid")
    loss = fluid.layers.mean(fluid.layers.log_loss(pred, y))
    tr = fluid.Trainer(loss, fluid.optimizer.SGD(0.5), [x, y],
                       checkpoint_dir=os.path.join(work, "ckpt"),
                       checkpoint_every_n_steps=2, task_queue=q,
                       queue_snapshot_path=snap, place=fluid.CPUPlace())
    batched = rdr.batch(recordio.dispatched_reader(q), batch_size=8)
    tr.train(batched, num_passes=1, event_handler=None)

    ckpt_dirs = sorted(glob.glob(os.path.join(work, "ckpt", "ckpt-*")))
    assert ckpt_dirs, "no checkpoints written"
    for d in ckpt_dirs:
        assert not os.path.exists(os.path.join(d, "queue.snap.tmp")), d
        assert os.path.exists(os.path.join(d, "queue.snap")), d

    # corrupt the newest pair: the rollback tolerates it (requeues
    # everything) instead of dying inside recovery
    latest = tr.ckpt.latest_step()
    with open(os.path.join(work, "ckpt", f"ckpt-{latest}", "queue.snap"),
              "wb") as f:
        f.write(b"\x00garbage\x01")
    tr._rollback()
    c = q.counts()
    assert c["todo"] == len(files) and c["done"] == 0, c


# ---------------------------------------------------- tools/supervise.py


_PROBE = ("import os, sys; maps = open(f'/proc/{os.getppid()}/maps').read(); "
          "print('PARENT_TORCH', 'libtorch' in maps, 'GEN', "
          "os.environ['PADDLE_TPU_RESTARTS'], 'CD', "
          "os.environ.get('PADDLE_TPU_COMPILE_DIR')); "
          "sys.exit(9 if os.environ['PADDLE_TPU_RESTARTS'] == '0' else 0)")


@pytest.mark.parametrize("form", ["script", "module"])
def test_supervise_tool_keeps_torch_out_of_the_parent(tmp_path, form):
    """Both forms of the command supervise a crashing child through one
    restart; the supervising process never has libtorch mapped (the
    child reads its parent's memory map)."""
    head = ([_PY, str(SUPERVISE)] if form == "script"
            else [_PY, "-m", "paddle_tpu_torch.tools.supervise"])
    logs = tmp_path / "logs"
    p = subprocess.run(
        head + ["--max-restarts=1", f"--log-dir={logs}",
                f"--compile-dir={tmp_path / 'cc'}", "--gang-grace-s=5",
                "--", _PY, "-c", _PROBE],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert p.returncode == 0, p.stderr
    assert "relaunching generation 1" in p.stderr
    for g in (0, 1):
        out = (logs / f"gen{g}-r0.log").read_text()
        assert f"PARENT_TORCH False GEN {g} CD {tmp_path / 'cc'}" in out


def test_supervise_tool_file_loads_without_the_package(tmp_path):
    src = ("import runpy, sys\n"
           f"mod = runpy.run_path({str(SUPERVISE)!r})\n"
           "rc = mod['main'](['--max-restarts=0', '--', sys.executable, "
           "'-c', 'import sys; sys.exit(4)'])\n"
           "bad = sorted(m for m in sys.modules if m == 'torch' or "
           "m.startswith(('torch.', 'paddle_tpu')))\n"
           "print('RC', rc, 'BAD', bad)\n")
    p = subprocess.run([_PY, "-c", src], capture_output=True, text=True,
                       timeout=120, cwd=str(tmp_path))
    assert p.returncode == 0, p.stderr
    assert "RC 4 BAD []" in p.stdout, p.stdout
    assert "max_restarts=0 exhausted" in p.stderr
    p = subprocess.run([_PY, str(SUPERVISE)], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert p.returncode == 2 and "after --" in p.stderr


def test_forwarded_compile_dir_is_refused_naming_a10(tmp_path, monkeypatch):
    """The compile dir the supervisor forwards is the Trainer's (its AOT
    store and manifest), ahead of the checkpoint dir's."""
    monkeypatch.setenv("PADDLE_TPU_COMPILE_DIR", str(tmp_path))
    x = fluid.layers.data("x", [4])
    loss = fluid.layers.mean(fluid.layers.fc(x, 1))
    tr = fluid.Trainer(loss, fluid.optimizer.SGD(0.1), [x],
                       checkpoint_dir=str(tmp_path / "ckpt"),
                       place=fluid.CPUPlace())
    assert tr.compile_dir == str(tmp_path)
    assert tr.aot_store.dirname == str(tmp_path / "aot")
