"""The port's threaded pieces under adversarial use, the four cases of the
JAX package's ``tests/test_concurrency.py`` that need no native task queue
(those are ``tests/test_torch_native.py``'s): a ``DeviceFeeder`` whose
consumer abandons it mid-stream, a reader error reaching the consumer, a
non-blocking checkpoint save whose error surfaces and whose manager
recovers, and overlapping non-blocking saves racing a reader of the
``latest`` pointer.  The AOT store (``compile/aot.py``) writes with the
same tmp + fsync + rename discipline, and ``Trainer.prepare`` warms on a
background thread.  On the CPU, with the bounds of the reference."""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid

CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    fluid.reset_default_programs()
    fluid.reset_global_scope()
    yield


def _thread_count():
    return threading.active_count()


def test_device_feeder_consumer_abandons_mid_stream():
    """A consumer that stops iterating early must unblock the producer
    thread (it would otherwise sit forever on a full queue holding staged
    buffers)."""
    produced = []

    def reader():
        for i in range(10_000):
            produced.append(i)
            yield {"x": np.full((4,), i, "float32")}

    base = _thread_count()
    feeder = fluid.DeviceFeeder(reader, depth=2, device="cpu")
    got = []
    for feed in feeder:
        got.append(int(torch.as_tensor(feed["x"])[0]))
        if len(got) == 3:
            break  # abandon: the generator closed by GC or scope exit
    assert got == [0, 1, 2]
    deadline = time.time() + 10
    while _thread_count() > base and time.time() < deadline:
        time.sleep(0.05)
    assert _thread_count() <= base, "producer thread leaked after abandon"
    # and the producer stopped early rather than draining the whole reader
    assert len(produced) < 100


def test_device_feeder_reader_error_reaches_consumer():
    def reader():
        yield {"x": np.zeros((2,), "float32")}
        raise RuntimeError("disk died")

    feeder = fluid.DeviceFeeder(reader, depth=2, device="cpu")
    it = iter(feeder)
    next(it)
    with pytest.raises(RuntimeError, match="disk died"):
        next(it)


def test_checkpoint_async_error_surfaces_and_recovers(tmp_path,
                                                      monkeypatch):
    """A failed background save must raise at wait() (a silently missing
    checkpoint must never look saved), and the manager must keep working
    afterwards."""
    x = fluid.layers.data("x", [2])
    fluid.layers.fc(x, 2)
    exe = fluid.Executor(CPU)
    exe.run(fluid.default_startup_program())

    mgr = fluid.io.CheckpointManager(str(tmp_path), max_to_keep=2)
    real_save = fluid.io._save_blob
    boom = {"on": True}

    def flaky_save(*a, **kw):
        if boom["on"]:
            raise OSError("disk full")
        return real_save(*a, **kw)

    monkeypatch.setattr(fluid.io, "_save_blob", flaky_save)
    mgr.save(1, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None  # the failed save left no pointer

    boom["on"] = False
    mgr.save(2, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 2
    assert mgr.restore(device="cpu") is not None


def test_checkpoint_overlapping_saves_and_readers(tmp_path):
    """Rapid non-blocking saves racing readers of the pointer file: the
    pointer only ever names a fully written checkpoint, and the last save
    wins."""
    x = fluid.layers.data("x", [2])
    fluid.layers.fc(x, 8)
    exe = fluid.Executor(CPU)
    exe.run(fluid.default_startup_program())

    mgr = fluid.io.CheckpointManager(str(tmp_path), max_to_keep=3)
    errors = []
    stop = threading.Event()

    def reads():
        # an external reader: the pointer file only (no wait())
        while not stop.is_set():
            p = tmp_path / "latest"
            if p.exists():
                step = int(p.read_text())
                d = tmp_path / f"ckpt-{step}"
                if not (d / "state.json").exists():
                    errors.append(f"pointer names incomplete ckpt-{step}")
            time.sleep(0.001)

    t = threading.Thread(target=reads)
    t.start()
    for step in range(1, 11):
        mgr.save(step, blocking=False)
    mgr.wait()
    stop.set()
    t.join(timeout=10)
    assert not errors, errors[:3]
    assert mgr.latest_step() == 10
