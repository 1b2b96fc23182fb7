"""``paddle_tpu_torch.Trainer`` and ``resilience`` against the JAX package's
``paddle_tpu.Trainer`` on the CPU, both started from the same weights (a
step-0 checkpoint of the JAX startup's state, which each Trainer resumes
from; the layout is shared, ``tests/test_torch_io.py``):

* ``uci_housing`` as ``tests/test_data_io.py:170-196`` trains it: 3
  passes, 12 iterations, the cost sequence equal to JAX's at rtol 1e-5,
  ``test()`` equal at rtol 1e-5, the final checkpoint at step 12;
* ``test()`` leaves the training metrics (an ``evaluator.Accuracy``'s
  counts) bitwise as they were, as JAX's does, and its accuracy and the
  train loop's metrics equal JAX's;
* the anomaly guard: a NaN batch skipped with the parameters bitwise
  unchanged over it; the guard off passes NaN through; a rollback that
  replays the pass with the event sequence equal to JAX's (names, ids,
  costs at rtol 1e-5); persistent anomalies raising
  ``AnomalyBudgetExceeded``; every checkpoint corrupt restarting from
  scratch; a task-queue stand-in rewound to the snapshot paired with the
  restored checkpoint;
* a SIGTERM drain that checkpoints and exits ``EXIT_PREEMPTED``; the
  watchdog's ``on_hang`` (a heartbeat fault dropping the beats), and no
  watchdog thread left by a healthy ``train``;
* a training process killed by SIGKILL mid-pass and resumed from its
  checkpoint and queue cursor: its final weights bitwise those of an
  uninterrupted run (the three processes have their own time limits);
* the retry policy (backoff bounds, retry, exhaustion, no retry of a
  logic error) as ``tests/test_resilience.py`` holds the reference's;
* one 2-rank gang (``distributed.spawn``, ``tools/parallel_cases.py``'s
  ``cluster`` case): named barriers, ``agree_restore_step`` with one
  rank's newest checkpoint corrupted (both restore the common step), a
  Trainer resuming in the gang, and ZeRO-1's
  ``CheckpointStrategyMismatch`` with nothing quarantined."""
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.resilience import (Backoff, RetryPolicy,
                                         TransientError, cluster, faults,
                                         retry)

CPU = tfluid.CPUPlace()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    faults.clear()
    yield
    faults.clear()


def _sgd_model(fl):
    x = fl.layers.data("x", [4])
    y = fl.layers.data("y", [1])
    pred = fl.layers.fc(x, 1, act="sigmoid")
    loss = fl.layers.mean(fl.layers.log_loss(pred, y))
    return x, y, loss


def _one_batch(rng, n=8, poison=False):
    xs = rng.rand(n, 4).astype("float32")
    if poison:
        xs[0, 0] = np.nan
    ys = (xs.sum(axis=1, keepdims=True) > 2.0).astype("float32")
    return [(xs[j], ys[j]) for j in range(n)]


def _seed_checkpoint(dirs):
    """Write the JAX startup's whole state (after the JAX Trainer's
    minimize) as a step-0 checkpoint into each of ``dirs``: both Trainers
    resume from it, so they start from the same weights."""
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    src = dirs[0]
    jfluid.io.CheckpointManager(src).save(0, extra={"pass_id": 0})
    for d in dirs[1:]:
        shutil.copytree(src, d)


def _ev(e):
    """An event as (name, its fields), costs as floats."""
    return (type(e).__name__,) + tuple(vars(e).values())


def _assert_events_equal(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g[1:], w[1:]):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=str(g))
            elif isinstance(b, dict):
                assert set(a) == set(b)
                for k in b:
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
            else:
                assert a == b, (g, w)


def _both(build, tmp_path, reader, num_passes=1, **kw):
    """Build and train the same model with each package's Trainer from the
    same step-0 checkpoint; returns {package: (trainer, events)}."""
    out = {}
    dirs = {jfluid: str(tmp_path / "jax"), tfluid: str(tmp_path / "port")}
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
        args, fkw = build(fl)
        extra = {"place": CPU} if fl is tfluid else {}
        tr = fl.Trainer(*args, checkpoint_dir=dirs[fl], **fkw, **kw,
                        **extra)
        if fl is jfluid:
            _seed_checkpoint([dirs[jfluid], dirs[tfluid]])
        events = []
        tr.train(reader, num_passes=num_passes, event_handler=events.append)
        out[fl] = (tr, [_ev(e) for e in events])
    return out


# ------------------------------------------------------------ uci_housing


def _uci(fl):
    x = fl.layers.data("x", [13])
    y = fl.layers.data("y", [1])
    pred = fl.layers.fc(x, 1)
    loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
    return (loss, fl.optimizer.SGD(0.01), [x, y]), {}


def test_uci_housing_trainer_matches_jax(tmp_path):
    """tests/test_data_io.py::test_trainer_event_loop_and_test in both
    packages from one start: 3 passes x 4 batches, the costs at rtol 1e-5
    (falling), ``test()`` at rtol 1e-5, the last checkpoint at step 12."""
    from paddle_tpu_torch.datasets import uci_housing

    reader = tfluid.reader.batch(uci_housing.train(64), 16)
    res = _both(_uci, tmp_path, reader, num_passes=3,
                checkpoint_every_n_steps=10)
    (jtr, jev), (ttr, tev) = res[jfluid], res[tfluid]
    _assert_events_equal(tev, jev)
    costs = [e[3] for e in tev if e[0] == "EndIteration"]
    assert len(costs) == 12 and costs[-1] < costs[0]
    assert sum(e[0] == "EndPass" for e in tev) == 3
    test_reader = tfluid.reader.batch(uci_housing.test(32), 16)
    got, want = ttr.test(test_reader), jtr.test(test_reader)
    np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-5)
    assert tio.CheckpointManager(str(tmp_path / "port")).latest_step() == 12
    assert ttr.exe.compiles == 1 and ttr.exe.replays == 12


def _acc_model(fl):
    x = fl.layers.data("x", [4])
    lab = fl.layers.data("lab", [1], dtype="int32")
    pred = fl.layers.fc(x, 2, act="softmax")
    loss = fl.layers.mean(fl.layers.cross_entropy(pred, lab))
    ev = fl.evaluator.Accuracy(pred, lab)
    return ((loss, fl.optimizer.SGD(0.5), [x, lab]),
            {"extra_fetch": {"acc": ev.metric}}), ev


def test_test_leaves_training_metrics_alone(tmp_path):
    """The train program keeps an ``Accuracy`` evaluator whose counts
    accumulate in the scope; ``test()`` runs the for_test clone (which
    keeps the accumulating op) in a throwaway scope: the training counts
    stay bitwise, in both packages, and the metrics agree with JAX's."""
    def batches():
        rng = np.random.RandomState(5)
        for _ in range(4):
            xs = rng.rand(8, 4).astype("float32")
            yield [(xs[j], np.array([int(xs[j].sum() > 2)], "int32"))
                   for j in range(8)]

    evs = {}

    def build(fl):
        args, ev = _acc_model(fl)
        evs[fl] = ev
        return args

    res = _both(build, tmp_path, batches)
    _assert_events_equal(res[tfluid][1], res[jfluid][1])
    for fl in (jfluid, tfluid):
        tr, _ = res[fl]
        ev = evs[fl]
        before = {n: np.array(np.asarray(v if not isinstance(v, torch.Tensor)
                                         else v.numpy())).copy()
                  for n, v in fl.global_scope().items()}
        out = tr.test(batches, fetch={"acc": ev.metric})
        after = {n: np.asarray(v if not isinstance(v, torch.Tensor)
                               else v.numpy())
                 for n, v in fl.global_scope().items()}
        for n in before:
            assert after[n].tobytes() == before[n].tobytes(), n
        evs[fl] = out["acc"]
    np.testing.assert_allclose(evs[tfluid], evs[jfluid], rtol=1e-5)


# ---------------------------------------------------------- anomaly guard


def _poisoned(n, bad, seed=1):
    def batches():
        rng = np.random.RandomState(seed)
        for i in range(n):
            yield _one_batch(rng, poison=i in bad)

    return batches


def test_nan_batch_skipped_params_bitwise_unchanged():
    """Batches 3 and 7 of 12 are NaN: two AnomalyDetected with NaN costs,
    ten finite EndIterations, global_step 10, and the parameters at
    BeginIteration 4 bitwise those at EndIteration 2 (the skipped step
    wrote nothing)."""
    x, y, loss = _sgd_model(tfluid)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y], place=CPU)
    seen, snaps = [], {}

    def handler(e):
        seen.append(e)
        key = (type(e).__name__, getattr(e, "batch_id", None))
        if key in (("EndIteration", 2), ("BeginIteration", 4)):
            snaps[key] = {n: v.clone() for n, v in
                          tfluid.global_scope().items()}

    tr.train(_poisoned(12, (3, 7)), num_passes=1, event_handler=handler)
    anomalies = [e for e in seen if isinstance(e, tfluid.events.AnomalyDetected)]
    ends = [e for e in seen if isinstance(e, tfluid.events.EndIteration)]
    assert [a.batch_id for a in anomalies] == [3, 7]
    assert all(not np.isfinite(a.cost) for a in anomalies)
    assert len(ends) == 10 and all(np.isfinite(e.cost) for e in ends)
    assert tr.global_step == 10
    a, b = snaps[("EndIteration", 2)], snaps[("BeginIteration", 4)]
    for n in ("fc_w_0", "fc_b_0"):
        assert torch.equal(a[n], b[n]), n
    assert torch.isfinite(tfluid.global_scope().find_var("fc_w_0")).all()


def test_disabled_guard_passes_nan_through():
    x, y, loss = _sgd_model(tfluid)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y],
                        anomaly_guard=False, place=CPU)
    seen = []
    tr.train(_poisoned(4, (1,)), num_passes=1, event_handler=seen.append)
    ends = [e for e in seen if isinstance(e, tfluid.events.EndIteration)]
    assert len(ends) == 4 and not any(
        isinstance(e, tfluid.events.AnomalyDetected) for e in seen)
    assert not np.isfinite(ends[1].cost)
    assert tr.global_step == 4
    assert getattr(tr.program, "anomaly_guard", None) is None


def test_rollback_replays_pass_events_equal_jax(tmp_path):
    """4 good batches, then NaN past a budget of 1: one rollback to the
    step-4 checkpoint, a clean replay of the pass; the event sequence of
    the port equals JAX's (costs rtol 1e-5), ending at step 12."""
    attempts = {}

    def reader_for(fl):
        def batches():
            attempts[fl] = attempts.get(fl, 0) + 1
            rng = np.random.RandomState(2)
            for i in range(8):
                yield _one_batch(rng, poison=attempts[fl] == 1 and i >= 4)
        return batches

    out = {}
    dirs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for fl, d in ((jfluid, dirs[0]), (tfluid, dirs[1])):
        x, y, loss = _sgd_model(fl)
        extra = {"place": CPU} if fl is tfluid else {}
        tr = fl.Trainer(loss, fl.optimizer.SGD(0.5), [x, y],
                        checkpoint_dir=d, checkpoint_every_n_steps=2,
                        anomaly_budget=1, max_rollbacks=2, **extra)
        if fl is jfluid:
            _seed_checkpoint(dirs)
        events = []
        tr.train(reader_for(fl), num_passes=1, event_handler=events.append)
        out[fl] = (tr, [_ev(e) for e in events])
    _assert_events_equal(out[tfluid][1], out[jfluid][1])
    assert attempts[tfluid] == 2
    assert out[tfluid][0].global_step == 4 + 8
    names = [e[0] for e in out[tfluid][1]]
    assert names.count("AnomalyDetected") == 2 and names.count("EndPass") == 1


def test_persistent_anomalies_raise():
    x, y, loss = _sgd_model(tfluid)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y],
                        anomaly_budget=0, max_rollbacks=1, place=CPU)
    with pytest.raises(tfluid.AnomalyBudgetExceeded, match="rollback"):
        tr.train(_poisoned(4, range(4), seed=3), num_passes=1)


def test_rollback_with_every_checkpoint_corrupt_restarts(tmp_path):
    x, y, loss = _sgd_model(tfluid)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y],
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        checkpoint_every_n_steps=2, anomaly_budget=1,
                        max_rollbacks=2, place=CPU)
    attempt = [0]

    def batches():
        attempt[0] += 1
        rng = np.random.RandomState(2)
        for i in range(8):
            yield _one_batch(rng, poison=attempt[0] == 1 and i >= 4)

    real_save = tr.ckpt.save

    def corrupting_save(step, *a, **kw):
        real_save(step, *a, **kw)
        with open(os.path.join(tr.ckpt.dirname, f"ckpt-{step}",
                               "persistables.npz"), "r+b") as f:
            f.write(b"garbage")

    tr.ckpt.save = corrupting_save
    tr.train(batches, num_passes=1)
    assert attempt[0] == 2 and tr.global_step == 8
    assert torch.isfinite(tfluid.global_scope().find_var("fc_w_0")).all()


class ListQueue:
    """A task-queue stand-in with the reference's interface: a cursor over
    ``n`` batches, advanced as the reader pulls; ``snapshot`` writes it,
    ``rewind`` reads it back, ``new_epoch`` starts over."""

    def __init__(self, n):
        self.n, self.cursor, self.rewinds = n, 0, []

    def reader(self, batches):
        def r():
            while self.cursor < self.n:
                self.cursor += 1
                yield batches(self.cursor - 1)
        return r

    def snapshot(self, path):
        with open(path + ".tmp", "w") as f:
            json.dump({"cursor": self.cursor}, f)
        os.replace(path + ".tmp", path)

    def rewind(self, path):
        with open(path) as f:
            self.cursor = json.load(f)["cursor"]
        self.rewinds.append((path, self.cursor))

    def new_epoch(self):
        self.cursor = 0


def test_rollback_rewinds_the_task_queue(tmp_path):
    """A rollback with a live queue: the feed pipeline closed, the queue
    rewound to the snapshot paired with the restored checkpoint (not the
    newer global one), and the replay re-reads the batches after it."""
    x, y, loss = _sgd_model(tfluid)
    snap = str(tmp_path / "queue.snap")
    q = ListQueue(8)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y],
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        checkpoint_every_n_steps=2, task_queue=q,
                        queue_snapshot_path=snap, anomaly_budget=1,
                        max_rollbacks=2, prefetch_depth=1, place=CPU)
    read = []

    def batch(i):
        read.append(i)
        rng = np.random.RandomState(100 + i)
        return _one_batch(rng, poison=not q.rewinds and i >= 4)

    tr.train(q.reader(batch), num_passes=1)
    assert len(q.rewinds) == 1
    path, cursor = q.rewinds[0]
    assert path == os.path.join(str(tmp_path / "ckpt"), "ckpt-4",
                                "queue.snap")
    # the cursor paired with step 4 counts what the reader had pulled by
    # then (the prefetch skew the reference documents); the replay reads
    # on from it and trains what it reads
    assert 4 <= cursor < 8
    assert read[-(8 - cursor):] == list(range(cursor, 8))
    assert tr.global_step == 4 + (8 - cursor)
    assert torch.isfinite(tfluid.global_scope().find_var("fc_w_0")).all()


# -------------------------------------------------- preemption and hangs


def test_sigterm_drain_checkpoints_and_exits_preempted(tmp_path):
    """SIGTERM at the third step: the staged batches train, a checkpoint
    marked ``preempted`` is written with the queue cursor, ``Preempted``
    reaches the handler, and train raises SystemExit(EXIT_PREEMPTED) with
    the old SIGTERM handler back in place."""
    x, y, loss = _sgd_model(tfluid)
    snap = str(tmp_path / "queue.snap")
    q = ListQueue(12)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y],
                        checkpoint_dir=str(tmp_path / "ckpt"),
                        checkpoint_every_n_steps=100, task_queue=q,
                        queue_snapshot_path=snap, prefetch_depth=1,
                        place=CPU)
    seen = []

    def handler(e):
        seen.append(e)
        if isinstance(e, tfluid.events.EndIteration) and e.batch_id == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    old = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc:
        tr.train(q.reader(lambda i: _one_batch(np.random.RandomState(i))),
                 num_passes=1, event_handler=handler)
    assert exc.value.code == cluster.EXIT_PREEMPTED
    assert signal.getsignal(signal.SIGTERM) == old
    pre = [e for e in seen if isinstance(e, tfluid.events.Preempted)]
    assert len(pre) == 1 and pre[0].step == tr.global_step
    trained = sum(isinstance(e, tfluid.events.EndIteration) for e in seen)
    assert 3 <= trained < 12 and tr.global_step == trained
    cm = tio.CheckpointManager(str(tmp_path / "ckpt"))
    assert cm.latest_step() == trained
    with open(os.path.join(cm.dirname, f"ckpt-{trained}",
                           "state.json")) as f:
        assert json.load(f)["extra"]["preempted"] is True
    with open(os.path.join(cm.dirname, f"ckpt-{trained}",
                           "queue.snap")) as f:
        assert json.load(f)["cursor"] >= trained


def test_watchdog_on_hang_fires_and_trainer_leaves_none():
    """A heartbeat fault drops the beats: the monitor calls ``on_hang``
    with the stall; ``stop()`` joins it.  A Trainer with
    ``hang_timeout_s`` trains healthily and leaves no watchdog thread."""
    fired = threading.Event()
    stalls = []

    def on_hang(stalled):
        stalls.append(stalled)
        fired.set()

    wd = cluster.Watchdog(0.2, on_hang=on_hang, poll_s=0.02).start()
    faults.inject("cluster.heartbeat", RuntimeError("lost"))
    deadline = time.monotonic() + 10
    while not fired.is_set() and time.monotonic() < deadline:
        wd.beat()
        time.sleep(0.02)
    wd.stop()
    assert fired.is_set() and wd.fired and stalls[0] > 0.2
    assert not wd.alive()
    with pytest.raises(ValueError, match="positive"):
        cluster.Watchdog(0)
    faults.clear()
    x, y, loss = _sgd_model(tfluid)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y],
                        hang_timeout_s=60.0, place=CPU)
    tr.train(_poisoned(3, ()), num_passes=1)
    assert tr.global_step == 3
    assert not any(t.name.startswith("paddle_tpu_torch-watchdog")
                   for t in threading.enumerate())


def test_compile_dir_and_prepare_name_a10(tmp_path):
    x, y, loss = _sgd_model(tfluid)
    with pytest.raises(NotImplementedError, match="A.10"):
        tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y],
                       compile_dir=str(tmp_path), place=CPU)
    tfluid.reset_default_programs()
    x, y, loss = _sgd_model(tfluid)
    tr = tfluid.Trainer(loss, tfluid.optimizer.SGD(0.5), [x, y], place=CPU)
    with pytest.raises(NotImplementedError, match="A.10"):
        tr.prepare()
    os.environ[cluster.RESTARTS_ENV] = "3"
    try:
        assert cluster.restart_count() == 3
    finally:
        del os.environ[cluster.RESTARTS_ENV]
    assert cluster.restart_count() == 0
    assert cluster.agree_restore_step([3, 7, 5]) == 7
    assert cluster.agree_restore_step(None) is None
    cluster.barrier("alone")  # no process group: a no-op


# ------------------------------------------------------------ retry policy


def test_backoff_with_jitter_stays_within_policy_bounds():
    """tests/test_resilience.py's property over 60 random policies."""
    rng = np.random.RandomState(7)
    for case in range(60):
        policy = RetryPolicy(
            max_attempts=10,
            base_delay_s=float(rng.uniform(0.001, 3.0)),
            max_delay_s=float(rng.uniform(0.5, 10.0)),
            multiplier=float(rng.uniform(1.1, 4.0)),
            jitter=float(rng.uniform(0.0, 1.0)))
        bo = Backoff(policy, seed=case)
        for attempt in range(10):
            ideal = min(policy.base_delay_s * policy.multiplier ** attempt,
                        policy.max_delay_s)
            d = bo.next()
            assert 0.0 <= d <= policy.max_delay_s + 1e-9
            assert d >= ideal * (1 - policy.jitter) - 1e-9
            assert d <= min(ideal * (1 + policy.jitter),
                            policy.max_delay_s) + 1e-9
        bo.reset()
        assert bo.peek() == min(policy.base_delay_s, policy.max_delay_s)


def test_retry_paths_match_the_reference():
    """A transient error retried to success (sleeps between), a logic
    error raised at once, the last error after the attempts run out; the
    same calls and sleeps as the JAX package's ``retry``."""
    from paddle_tpu.resilience import policy as jpolicy

    def run(mod, exc_kind):
        calls, slept = [], []
        pol = mod.RetryPolicy(max_attempts=3, base_delay_s=0.01, jitter=0.0)

        @mod.retry(pol, sleep=slept.append)
        def fn():
            calls.append(1)
            if exc_kind == "transient" and len(calls) < 3:
                raise mod.TransientError("not yet")
            if exc_kind == "logic":
                raise ValueError("logic")
            if exc_kind == "down":
                raise IOError(f"attempt {len(calls)}")
            return "ok"

        try:
            res = fn()
        except Exception as e:  # noqa: BLE001 — compared below
            res = f"{type(e).__name__}: {e}"
        return res, len(calls), slept

    for kind in ("transient", "logic", "down"):
        got = run(sys.modules["paddle_tpu_torch.resilience.policy"], kind)
        assert got == run(jpolicy, kind), kind
    assert issubclass(TransientError, Exception)
    assert retry(RetryPolicy(max_attempts=1))(lambda: 5)() == 5


# ----------------------------------------------------------- crash resume

_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as fluid

work, kill_at = os.environ["WORK"], int(os.environ["KILL_AT"])
snap = os.path.join(work, "queue.snap")


class Cursor:
    # the batches of the pass trained so far: advanced by the handler, so
    # the snapshot a checkpoint takes counts trained batches exactly
    def __init__(self):
        self.done = 0
        if os.path.exists(snap):
            self.rewind(snap)

    def snapshot(self, path):
        with open(path + ".tmp", "w") as f:
            json.dump({"done": self.done}, f)
        os.replace(path + ".tmp", path)

    def rewind(self, path):
        with open(path) as f:
            self.done = json.load(f)["done"]

    def new_epoch(self):
        self.done = 0


rng = np.random.RandomState(0)
batches = []
for _ in range(4):
    xs = rng.rand(8, 4).astype("float32")
    ys = (xs.sum(axis=1, keepdims=True) > 2.0).astype("float32")
    batches.append([(xs[j], ys[j]) for j in range(8)])
cur = Cursor()
x = fluid.layers.data("x", [4])
y = fluid.layers.data("y", [1])
pred = fluid.layers.fc(x, 1, act="sigmoid")
loss = fluid.layers.mean(fluid.layers.log_loss(pred, y))
fluid.default_startup_program().random_seed = 7
tr = fluid.Trainer(loss, fluid.optimizer.SGD(0.5), [x, y],
                   checkpoint_dir=os.path.join(work, "ckpt"),
                   checkpoint_every_n_steps=2, task_queue=cur,
                   queue_snapshot_path=snap, place=fluid.CPUPlace())


def reader():
    yield from batches[cur.done:]


def handler(e):
    if isinstance(e, fluid.events.EndIteration):
        cur.done += 1
        print("STEP", tr.global_step, flush=True)
        if tr.global_step == kill_at:
            print("WAIT", flush=True)
            time.sleep(120)


tr.train(reader, num_passes=3, event_handler=handler)
np.save(os.path.join(work, "final.npy"),
        fluid.global_scope().find_var("fc_w_0").numpy())
print("DONE", tr.global_step, flush=True)
"""


def _spawn(work, kill_at):
    env = dict(os.environ, WORK=str(work), KILL_AT=str(kill_at),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_sigkill_mid_pass_resumes_bitwise(tmp_path):
    """Run 1 is killed (SIGKILL) inside its seventh step (pass 1, batch 2:
    the newest checkpoint is step 6 with the cursor at 2); run 2 resumes
    from it and finishes the 12 steps; its final weights are bitwise those
    of an uninterrupted run 3.  Each process runs under a time limit."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    p1 = _spawn(tmp_path / "a", 6)
    p3 = _spawn(tmp_path / "b", -1)   # the uninterrupted run, alongside
    timer = threading.Timer(120, p1.kill)
    timer.start()
    steps1 = []
    try:
        for line in p1.stdout:
            if line.startswith("STEP"):
                steps1.append(int(line.split()[1]))
            if line.startswith("WAIT"):
                p1.send_signal(signal.SIGKILL)
                break
    finally:
        timer.cancel()
        p1.wait(timeout=30)
    assert p1.returncode == -signal.SIGKILL, p1.stderr.read()
    assert steps1 == list(range(7))
    cm = tio.CheckpointManager(str(tmp_path / "a" / "ckpt"))
    assert cm.latest_step() == 6
    p2 = _spawn(tmp_path / "a", -1)
    out2, err2 = p2.communicate(timeout=120)
    out3, err3 = p3.communicate(timeout=120)
    assert p2.returncode == 0, err2
    assert p3.returncode == 0, err3
    steps2 = [int(ln.split()[1]) for ln in out2.splitlines()
              if ln.startswith("STEP")]
    assert steps2 == list(range(6, 12)), steps2
    assert "DONE 12" in out2 and "DONE 12" in out3
    a = np.load(tmp_path / "a" / "final.npy")
    b = np.load(tmp_path / "b" / "final.npy")
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------- the gang


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """One gang of 2 CPU ranks running the ``cluster`` case."""
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.tools import parallel_cases as pc

    d = str(tmp_path_factory.mktemp("gang"))
    return distributed.spawn(pc.run_cases, 2,
                             {"cluster": {"kind": "cluster", "dir": d}},
                             True, device="cpu", timeout_s=240)


def test_gang_barriers(gang):
    for rank in gang:
        assert "same tags in the same order" in rank["cluster"][
            "barrier_mismatch"]


def test_gang_agrees_on_the_common_step(gang):
    r0, r1 = (g["cluster"] for g in gang)
    assert r0["intact"] == [3, 2, 1] and r1["intact"] == [2, 1]
    assert r0["agreed"] == r1["agreed"] == 2
    assert r0["restored"] == r1["restored"] == 2
    assert r0["restored_bitwise"] and r1["restored_bitwise"]
    # rank 0's newer intact checkpoint stays the pointer
    assert r0["latest_after"] == 3


def test_gang_trainer_resumes_from_the_agreed_step(gang):
    r0, r1 = (g["cluster"] for g in gang)
    agreed = [e for e in r0["trainer_events"] if e[0] == "RestoreAgreed"]
    assert agreed == [("RestoreAgreed", 4, 2)]
    assert [e for e in r1["trainer_events"] if e[0] == "RestoreAgreed"] == \
        [("RestoreAgreed", 2, 2)]
    assert r0["trainer_step"] == r1["trainer_step"] == 2 + 8


def test_gang_trainer_under_a_strategy_matches_one_device(gang):
    """``Trainer(strategy=Strategy(dp 2))`` trains eagerly on each rank's
    rows: its costs (the global loss, the same on both ranks) within rtol
    1e-5 of the same Trainer without a Strategy, its checkpoints whole."""
    r0, r1 = (g["cluster"] for g in gang)
    assert r0["strategy_costs"]["dp2"] == r1["strategy_costs"]["dp2"]
    assert len(r0["strategy_costs"]["dp2"]) == 4
    np.testing.assert_allclose(r0["strategy_costs"]["dp2"],
                               r0["strategy_costs"]["single"], rtol=1e-5)
    assert r0["strategy_ckpt_shape"] == (4, 1)


def test_gang_zero1_checkpoint_refuses_mismatched_restore(gang):
    for g in gang:
        r = g["cluster"]
        assert len(r["zero1_mismatches"]) == 2
        assert "packed ZeRO-1" in r["zero1_mismatches"][0]
        assert "no packing strategy" in r["zero1_mismatches"][0]
        assert "dp=1" in r["zero1_mismatches"][1]
        assert r["zero1_kept"]
        packed, dp = r["zero1_state"]
        assert packed and dp == 2
        assert r["zero1_resumed_bitwise"]
