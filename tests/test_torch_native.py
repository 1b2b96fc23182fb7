"""``paddle_tpu_torch.native``, ``reader.recordio`` and
``distributed.make_file_dispatcher`` against the JAX package's on the CPU.

Both packages compile the same ``native/*.cc``; the port into
``build/paddle_tpu_torch/native/`` under its own file lock.  Held here:

* across packages: records written by either package's ``RecordIOWriter``
  read back byte for byte through the other's reader, and the files are
  byte-identical; ``crc32`` equal; ``recordio.dump`` of one reader into the
  same shard count gives byte-identical shards; one scripted ``TaskQueue``
  sequence (add, get, finish, fail past ``failure_max``, a timeout sweep,
  ``new_epoch``) gives equal ``counts()`` after every step and
  byte-identical snapshots, each restoring in the other package;
* the reference's own cases (``tests/test_native.py``,
  ``tests/test_data_native.py``) in the port, and the dispatcher's rank
  partition;
* ``fluid.Trainer`` over dispatched RecordIO against the JAX Trainer: one
  prefetch thread, no shuffle, the same start weights (a step-0 checkpoint
  of the JAX startup), costs equal at rtol 1e-5 over 8 steps;
* two processes building the library at once into an empty directory:
  exactly one compiles, both load it, and no partial file is left."""
import glob
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import distributed as jdist
from paddle_tpu import native as jnative
from paddle_tpu.reader import recordio as jrecordio
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import distributed, native
from paddle_tpu_torch.reader import recordio
from paddle_tpu_torch.resilience import TransientError, faults

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    faults.clear()
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield
    faults.clear()
    torch.set_num_threads(n)


def _synthetic_reader(n=64, seed=0):
    def read():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            x = rng.rand(4).astype("float32")
            y = np.array([float(x.sum() > 2.0)], dtype="float32")
            yield x, y
    return read


# ------------------------------------------------------ across packages

RECS = [b"hello", b"", b"x" * 100_000, bytes(range(256)), b"\x00" * 7]


def test_records_cross_packages_byte_for_byte(tmp_path):
    for writer_mod, reader_mod in ((jnative, native), (native, jnative)):
        path = str(tmp_path / f"{writer_mod.__name__}.rio")
        with writer_mod.RecordIOWriter(path) as w:
            for r in RECS:
                w.write(r)
        with reader_mod.RecordIOReader(path) as rd:
            assert list(rd) == RECS
        with reader_mod.Prefetcher([path], n_threads=1) as pf:
            assert list(pf) == RECS
    a = (tmp_path / f"{jnative.__name__}.rio").read_bytes()
    b = (tmp_path / f"{native.__name__}.rio").read_bytes()
    assert a == b


def test_crc32_equals_the_reference():
    assert native.crc32(b"123456789") == 0xCBF43926
    rng = np.random.RandomState(0)
    for n in (0, 1, 3, 64, 1000, 65537):
        data = rng.randint(0, 256, n).astype(np.uint8).tobytes()
        assert native.crc32(data) == jnative.crc32(data)


def test_dump_gives_byte_identical_shards(tmp_path):
    ours = recordio.dump(_synthetic_reader(23), str(tmp_path / "t"),
                         num_shards=3)
    theirs = jrecordio.dump(_synthetic_reader(23), str(tmp_path / "j"),
                            num_shards=3)
    assert [os.path.basename(p)[1:] for p in ours] == \
        [os.path.basename(p)[1:] for p in theirs]
    for a, b in zip(ours, theirs):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    # either package streams the other's shards to the same samples
    got = list(recordio.reader(theirs, n_threads=1)())
    want = list(jrecordio.reader(ours, n_threads=1)())
    assert len(got) == len(want) == 23
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    # samples_per_shard caps the total
    capped = recordio.dump(_synthetic_reader(23), str(tmp_path / "c"),
                           num_shards=2, samples_per_shard=4)
    assert len(list(recordio.reader(capped)())) == 8


def _queue_script(mod, tmp_path, tag):
    """Drive one queue of ``mod`` through a scripted sequence; returns the
    counts after every step and the snapshot bytes at three points."""
    q = mod.TaskQueue(timeout_s=0.05, failure_max=2)
    log, snaps = [], []

    def step(what):
        log.append((what, q.counts()))

    def snap(i):
        p = str(tmp_path / f"{tag}-{i}.snap")
        q.snapshot(p)
        snaps.append(Path(p).read_bytes())

    for i in range(6):
        q.add(f"t{i}", f"/data/shard-{i}.rio")
        step(f"add {i}")
    got = [q.get() for _ in range(3)]
    step("get 3")
    assert [t[0] for t in got] == ["t0", "t1", "t2"]
    q.finish("t0")
    step("finish t0")
    q.fail("t1")
    step("fail t1 once")
    snap(0)
    tid, _ = q.get()  # t3 (t1 went to the back of todo)
    assert tid == "t3"
    step("get t3")
    q.finish(tid)
    while (t := q.get()) is not None:
        if t[0] == "t1":
            q.fail("t1")  # its second failure: discarded
        else:
            q.finish(t[0])
        step(f"drain {t[0]}")
    snap(1)
    time.sleep(0.08)  # t2 is still pending past its deadline
    assert q.sweep() == 1
    step("sweep")
    t = q.get()
    q.finish(t[0])
    step("finish swept")
    assert q.new_epoch() == 5
    step("new_epoch")
    snap(2)
    with pytest.raises(ValueError):
        q.finish("nope")
    with pytest.raises(ValueError):
        q.add("t0", "dup")
    return log, snaps, sorted(q.payloads())


def test_task_queue_sequence_matches_the_reference(tmp_path):
    ours, our_snaps, our_payloads = _queue_script(native, tmp_path, "t")
    theirs, their_snaps, their_payloads = _queue_script(jnative, tmp_path,
                                                        "j")
    assert ours == theirs
    assert our_snaps == their_snaps
    assert our_payloads == their_payloads
    # each package restores the other's snapshots to equal queues
    for i in range(3):
        for src, dst in (("j", native), ("t", jnative)):
            a = dst.TaskQueue.restore(str(tmp_path / f"{src}-{i}.snap"))
            b = (native if dst is jnative else jnative).TaskQueue.restore(
                str(tmp_path / f"{src}-{i}.snap"))
            assert a.counts() == b.counts()
            order_a, order_b = [], []
            while (t := a.get()) is not None:
                order_a.append(t)
                a.finish(t[0])
            while (t := b.get()) is not None:
                order_b.append(t)
                b.finish(t[0])
            assert order_a == order_b


# ------------------------------------------ the reference's native cases


def test_recordio_roundtrip(tmp_path):
    path = str(tmp_path / "data.rio")
    recs = [b"hello", b"", b"x" * 100_000, bytes(range(256))]
    with native.RecordIOWriter(path) as w:
        for r in recs:
            w.write(r)
    with native.RecordIOReader(path) as rd:
        got = list(rd)
    assert got == recs


def test_recordio_crc_detects_corruption(tmp_path):
    path = str(tmp_path / "data.rio")
    with native.RecordIOWriter(path) as w:
        w.write(b"A" * 1000)
    blob = bytearray(open(path, "rb").read())
    blob[-10] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with native.RecordIOReader(path) as rd:
        with pytest.raises(IOError):
            next(rd)


def test_recordio_bad_magic(tmp_path):
    path = str(tmp_path / "junk.rio")
    open(path, "wb").write(b"not a recordio file")
    with pytest.raises(IOError):
        native.RecordIOReader(path)


def test_task_queue_dispatch_and_epoch():
    q = native.TaskQueue(timeout_s=60.0, failure_max=3)
    for i in range(5):
        q.add(f"t{i}", f"payload{i}")
    seen = set()
    while True:
        t = q.get()
        if t is None:
            break
        tid, payload = t
        assert payload == f"payload{tid[1:]}"
        q.finish(tid)
        seen.add(tid)
    assert seen == {f"t{i}" for i in range(5)}
    c = q.counts()
    assert c["done"] == 5 and c["todo"] == 0
    assert q.new_epoch() == 5
    assert q.counts()["todo"] == 5


def test_task_queue_timeout_requeue():
    q = native.TaskQueue(timeout_s=0.05, failure_max=3)
    q.add("a", "x")
    tid, _ = q.get()
    assert tid == "a"
    assert q.counts()["pending"] == 1
    time.sleep(0.08)
    assert q.sweep() == 1
    tid2, _ = q.get()
    assert tid2 == "a"


def test_task_queue_failure_max_discards():
    q = native.TaskQueue(timeout_s=60.0, failure_max=2)
    q.add("a", "x")
    q.get()
    q.fail("a")
    assert q.counts()["todo"] == 1
    q.get()
    q.fail("a")
    c = q.counts()
    assert c["failed"] == 1 and c["todo"] == 0


def test_task_queue_snapshot_restore(tmp_path):
    path = str(tmp_path / "queue.snap")
    q = native.TaskQueue(timeout_s=60.0, failure_max=3)
    for i in range(4):
        q.add(f"t{i}", str(i))
    q.get()           # t0 pending: back to todo after restore
    tid, _ = q.get()
    q.finish(tid)     # t1 done
    q.snapshot(path)
    assert not os.path.exists(path + ".tmp")

    r = native.TaskQueue.restore(path, timeout_s=60.0, failure_max=3)
    c = r.counts()
    assert c["done"] == 1 and c["pending"] == 0 and c["todo"] == 3
    got = set()
    while (t := r.get()) is not None:
        got.add(t[0])
        r.finish(t[0])
    assert got == {"t0", "t2", "t3"}
    # rewind in place: the same object, the snapshot's state
    r.rewind(path)
    assert r.counts() == c


def test_task_queue_restore_rejects_corrupt(tmp_path):
    path = str(tmp_path / "queue.snap")
    q = native.TaskQueue()
    q.add("a", "x")
    q.snapshot(path)
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0x1
    open(path, "wb").write(bytes(blob))
    with pytest.raises(IOError):
        native.TaskQueue.restore(path)
    with pytest.raises(IOError):
        q.rewind(path)


def test_task_queue_pop_fault_site():
    q = native.TaskQueue()
    q.add("a", "x")
    with faults.active("queue.pop", TransientError("pop"), count=1):
        with pytest.raises(TransientError):
            q.get()
    assert q.get() == ("a", "x")


def _write_files(tmp_path, n_files=4, per_file=50):
    files = []
    expected = set()
    for i in range(n_files):
        p = str(tmp_path / f"part-{i}.rio")
        with native.RecordIOWriter(p) as w:
            for j in range(per_file):
                rec = f"{i}:{j}".encode()
                w.write(rec)
                expected.add(rec)
        files.append(p)
    return files, expected


def test_prefetcher_complete_and_exact(tmp_path):
    files, expected = _write_files(tmp_path)
    with native.Prefetcher(files, n_threads=3) as pf:
        got = list(pf)
    assert set(got) == expected and len(got) == len(expected)


def test_prefetcher_shuffles(tmp_path):
    files, expected = _write_files(tmp_path, n_files=1, per_file=200)
    with native.Prefetcher(files, n_threads=1, shuffle_buffer=64, seed=7) as pf:
        got = list(pf)
    assert set(got) == expected
    in_order = [f"0:{j}".encode() for j in range(200)]
    assert got != in_order
    # the same seed, the JAX package's permutation
    with jnative.Prefetcher(files, n_threads=1, shuffle_buffer=64,
                            seed=7) as pf:
        assert list(pf) == got


def test_prefetcher_missing_file_reports_error(tmp_path):
    with native.Prefetcher([str(tmp_path / "nope.rio")]) as pf:
        with pytest.raises(IOError):
            next(pf)


# -------------------------------------- the reference's data-path cases


def test_dump_and_stream_roundtrip(tmp_path):
    files = recordio.dump(_synthetic_reader(48), str(tmp_path / "ds"),
                          num_shards=4)
    assert len(files) == 4
    got = list(recordio.reader(files, n_threads=2)())
    assert len(got) == 48
    ref = list(_synthetic_reader(48)())
    got_x = sorted(float(x[0]) for x, _ in got)
    ref_x = sorted(float(x[0]) for x, _ in ref)
    np.testing.assert_allclose(got_x, ref_x)


def test_glob_reader(tmp_path):
    recordio.dump(_synthetic_reader(16), str(tmp_path / "ds"), num_shards=2)
    got = list(recordio.reader(str(tmp_path / "ds-*.rio"))())
    assert len(got) == 16
    with pytest.raises(ValueError, match="no recordio files"):
        recordio.reader(str(tmp_path / "none-*.rio"))


def test_dispatched_reader_elastic(tmp_path):
    """Two sequential readers share one dispatcher; the first stops
    mid-epoch and the second finishes the remaining shards."""
    files = recordio.dump(_synthetic_reader(40), str(tmp_path / "ds"),
                          num_shards=4)
    q = distributed.make_file_dispatcher(files, timeout_s=60.0)

    first = []
    it = recordio.dispatched_reader(q)()
    for i, s in enumerate(it):
        first.append(s)
        if i >= 9:
            break
    it.close()

    rest = list(recordio.dispatched_reader(q)())
    assert len(first) + len(rest) >= 40
    c = q.counts()
    assert c["todo"] == 0 and c["pending"] <= 1


def test_dispatched_reader_retries_a_transient_fault(tmp_path):
    """A transient fault mid-file is retried in place: every record once,
    the task finished, ``resilience.retries`` counted."""
    files = recordio.dump(_synthetic_reader(12), str(tmp_path / "ds"),
                          num_shards=2)
    q = distributed.make_file_dispatcher(files)
    before = tfluid.profiler.counter("resilience.retries")
    with faults.active("reader.pipeline", TransientError("blip"), count=1):
        got = list(recordio.dispatched_reader(q, n_threads=1)())
    assert faults.fired("reader.pipeline") == 1
    assert len(got) == 12
    want = list(jrecordio.dispatched_reader(
        jdist.make_file_dispatcher(files), n_threads=1)())
    for (gx, _), (wx, _) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
    assert q.counts()["done"] == 2
    assert tfluid.profiler.counter("resilience.retries") == before + 1


def test_dispatcher_snapshot_resume(tmp_path):
    files = recordio.dump(_synthetic_reader(30), str(tmp_path / "ds"),
                          num_shards=3)
    snap = str(tmp_path / "queue.snap")
    q = distributed.make_file_dispatcher(files, snapshot_path=snap)
    tid, _ = q.get()
    q.finish(tid)
    q.snapshot(snap)
    del q
    q2 = distributed.make_file_dispatcher(files, snapshot_path=snap)
    assert q2.counts()["done"] == 1 and q2.counts()["todo"] == 2
    # the JAX package resumes the port's snapshot too
    q3 = jdist.make_file_dispatcher(files, snapshot_path=snap)
    assert q3.counts() == q2.counts()


def test_dispatcher_ignores_stale_snapshot(tmp_path):
    files_a = recordio.dump(_synthetic_reader(10), str(tmp_path / "a"),
                            num_shards=2)
    files_b = recordio.dump(_synthetic_reader(10), str(tmp_path / "b"),
                            num_shards=2)
    snap = str(tmp_path / "q.snap")
    qa = distributed.make_file_dispatcher(files_a, snapshot_path=snap)
    tid, _ = qa.get()
    qa.finish(tid)
    qa.snapshot(snap)
    qb = distributed.make_file_dispatcher(files_b, snapshot_path=snap)
    assert qb.counts()["done"] == 0 and qb.counts()["todo"] == 2


def test_dispatcher_partitions_by_rank(monkeypatch):
    files = [f"/d/s{i}.rio" for i in range(7)]
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    q = distributed.make_file_dispatcher(files)
    assert sorted(q.payloads()) == files[1::3]
    q = distributed.make_file_dispatcher(files, partition_by_host=False)
    assert sorted(q.payloads()) == sorted(files)
    monkeypatch.setattr(distributed, "process_count", lambda: 1)
    q = distributed.make_file_dispatcher(files)
    assert [t for t in iter(q.get, None)][0] == ("shard-00000", files[0])


def _trainer(fl, ckpt, q, snap, **kw):
    x = fl.layers.data("x", [4])
    y = fl.layers.data("y", [1])
    pred = fl.layers.fc(x, 1, act="sigmoid")
    loss = fl.layers.mean(fl.layers.log_loss(pred, y))
    return fl.Trainer(loss, fl.optimizer.SGD(0.5), feed_list=[x, y],
                      checkpoint_dir=ckpt, checkpoint_every_n_steps=2,
                      task_queue=q, queue_snapshot_path=snap, **kw)


def _costs(fl, tr, q, passes=2):
    costs = []

    def handler(e):
        if isinstance(e, fl.events.EndIteration):
            costs.append(e.cost)

    batched = fl.reader.batch(
        (recordio if fl is tfluid else jrecordio).dispatched_reader(
            q, n_threads=1), batch_size=16)
    tr.train(batched, num_passes=passes, event_handler=handler)
    return costs


def test_trainer_with_dispatched_recordio(tmp_path):
    """The reference's full loop in the port: shards -> dispatched
    prefetch reader -> Trainer with checkpoints and the queue snapshot."""
    files = recordio.dump(_synthetic_reader(64), str(tmp_path / "ds"),
                          num_shards=4)
    snap = str(tmp_path / "queue.snap")
    q = distributed.make_file_dispatcher(files, snapshot_path=snap)
    tr = _trainer(tfluid, str(tmp_path / "ckpt"), q, snap,
                  place=tfluid.CPUPlace())
    costs = _costs(tfluid, tr, q)
    assert len(costs) == 8  # 64 samples / bs16 x 2 passes (new_epoch refills)
    assert costs[-1] < costs[0]
    assert os.path.exists(snap)
    for d in glob.glob(str(tmp_path / "ckpt" / "ckpt-*")):
        assert os.path.exists(os.path.join(d, "queue.snap"))


def test_trainer_over_dispatched_recordio_matches_jax(tmp_path):
    """The same shards, one prefetch thread and no shuffle (a fixed
    order), the same start weights: the port's costs equal the JAX
    Trainer's at rtol 1e-5 over 8 steps, and each package's final queue
    snapshot restores in the other."""
    files = jrecordio.dump(_synthetic_reader(64, seed=3),
                           str(tmp_path / "ds"), num_shards=4)
    _trainer(jfluid, str(tmp_path / "jckpt"), None, None)
    jfluid.Executor().run(jfluid.default_startup_program())
    jfluid.io.CheckpointManager(str(tmp_path / "jckpt")).save(
        0, extra={"pass_id": 0})
    shutil.copytree(tmp_path / "jckpt", tmp_path / "tckpt")
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()

    jsnap, tsnap = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    jq = jdist.make_file_dispatcher(files, snapshot_path=jsnap)
    jtr = _trainer(jfluid, str(tmp_path / "jckpt"), jq, jsnap)
    want = _costs(jfluid, jtr, jq)
    tq = distributed.make_file_dispatcher(files, snapshot_path=tsnap)
    ttr = _trainer(tfluid, str(tmp_path / "tckpt"), tq, tsnap,
                   place=tfluid.CPUPlace())
    got = _costs(tfluid, ttr, tq)
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert Path(tsnap).read_bytes() == Path(jsnap).read_bytes()
    assert native.TaskQueue.restore(jsnap).counts() == \
        jnative.TaskQueue.restore(tsnap).counts()


_BUILD_CHILD = (
    "import json, sys\n"
    "import paddle_tpu_torch.native as n\n"
    "n.BUILD_DIR = sys.argv[1]\n"
    "ok = n.available()\n"
    "print(json.dumps({'ok': ok, 'built': n.build_seconds is not None,\n"
    "                  'crc': n.crc32(b'123456789') if ok else None}))\n")


def test_concurrent_first_builds_share_one_library(tmp_path):
    build = tmp_path / "native"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                               str(build)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(REPO)) for _ in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(o["ok"] and o["crc"] == 0xCBF43926 for o in outs), outs
    assert sum(o["built"] for o in outs) == 1, outs
    libs = sorted(os.listdir(build))
    assert [n for n in libs if not n.startswith(".")] == [
        Path(native.library_path()).name], libs
    # never under native/: the port's library is keyed and kept apart
    assert str(native.library_path()).startswith(
        str(REPO / "build" / "paddle_tpu_torch" / "native"))
