"""``paddle_tpu_torch.io`` against the JAX package's ``paddle_tpu.io`` on the
CPU, on the same weights:

* ``save_params`` / ``load_params`` round trip (the blob's arrays equal to
  the JAX package's blob of the same weights), and a checksum mismatch
  that raises;
* ``CheckpointManager``: resume and gc, quarantine and fallback, every
  checkpoint corrupt raising, the ``ckpt.load`` / ``ckpt.write`` fault
  sites, a non-blocking save of warmed state that later steps overwrite
  in place, uncommitted orphans, ``newest_intact_step`` and
  ``limit_step``;
* checkpoints across the packages both ways: a JAX checkpoint restores
  into the port and the port's next step (SGD, Adam) matches JAX's next
  step at rtol 1e-5 (loss, parameters; moments within 1e-5 of their max
  abs), and the reverse;
* the inference artifact after a reset of programs and scope: fc +
  softmax against JAX's ``load_inference_model`` at batch 4 and at batch
  7 (the symbolic batch), rtol 1e-5, no new preparation on a repeated
  signature; a two-layer LM's logits and a small text_lstm from JAX's
  startup weights against JAX's forward (rtol 1e-5 of the largest
  value), their exported graphs naming the port's custom ops and not the
  plain versions' loops; a conv + BN + ReLU program on the fused conv op;
  ``merge_model`` round trip; the refusal of ``cond``, a training
  dropout exported, and the hooks left for ROADMAP A.10.

The ZeRO-1 ``CheckpointStrategyMismatch`` needs a mesh of two ranks: it
is a case of ``tests/test_torch_trainer.py``'s gang."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu.models.text_lstm  # noqa: F401
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.resilience import faults

CPU = tfluid.CPUPlace()
CPU_EXE = tfluid.Executor(CPU)
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


def _sgd_model(fl, opt="sgd"):
    x = fl.layers.data("x", [4])
    y = fl.layers.data("y", [1])
    pred = fl.layers.fc(x, 1, act="sigmoid")
    loss = fl.layers.mean(fl.layers.log_loss(pred, y))
    if opt == "sgd":
        fl.optimizer.SGD(0.5).minimize(loss)
    elif opt == "adam":
        fl.optimizer.Adam(0.05).minimize(loss)
    return x, y, loss


def _batch(seed, n=8, poison=False):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, 4).astype("float32")
    if poison:
        xs[0, 0] = np.nan
    ys = (xs.sum(axis=1, keepdims=True) > 2.0).astype("float32")
    return {"x": xs, "y": ys}


def _scope_np(scope, names=None):
    return {n: np.array(v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else np.asarray(v))
        for n, v in scope.items() if names is None or n in names}


def _ckpt_two_steps(tmp_path):
    """The SGD model two checkpointed steps; returns (manager, w after 1)."""
    _sgd_model(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    cm = tio.CheckpointManager(str(tmp_path / "ckpt"))
    exe.run(feed=_batch(0))
    cm.save(1)
    w1 = tfluid.global_scope().find_var("fc_w_0").clone()
    exe.run(feed=_batch(1))
    cm.save(2)
    return cm, w1, exe


def _corrupt(path, at_middle=True):
    with open(path, "r+b") as f:
        if at_middle:
            f.seek(max(os.path.getsize(path) // 2, 1))
            f.write(b"\xde\xad\xbe\xef")
        else:
            f.write(b"garbage")


# ------------------------------------------------------------------ params


def test_save_load_params_round_trip_matches_jax_blob(tmp_path):
    """The JAX startup's fc weights loaded into the port: the port's
    ``params.npz`` holds the JAX package's arrays for the same names,
    bitwise; zeroed weights come back from it, on the scope's device and
    in its dtype."""
    for fl in (jfluid, tfluid):
        x = fl.layers.data("x", [4])
        fl.layers.fc(x, 3, param_attr=fl.ParamAttr(name="w"))
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    jfluid.io.save_params(jexe, str(tmp_path / "jax"))
    weights = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    scope = tfluid.global_scope()
    tfluid.load_scope(weights, tfluid.default_main_program(), scope,
                      device="cpu")
    tio.save_params(exe, str(tmp_path / "port"))
    want = np.load(tmp_path / "jax" / "params.npz")
    got = np.load(tmp_path / "port" / "params.npz")
    assert sorted(got.files) == sorted(want.files)
    for n in want.files:
        assert got[n].tobytes() == want[n].tobytes(), n
    meta = json.loads((tmp_path / "port" / "params.meta.json").read_text())
    assert meta["tag"] == "params" and meta["n_arrays"] == len(want.files)
    scope.set_var("w", torch.zeros(4, 3))
    tio.load_params(exe, str(tmp_path / "port"))
    w = scope.find_var("w")
    assert w.dtype == torch.float32 and w.device.type == "cpu"
    assert w.numpy().tobytes() == weights["w"].tobytes()


def test_checksum_corruption_raises(tmp_path):
    x = tfluid.layers.data("x", [4])
    tfluid.layers.fc(x, 3, param_attr=tfluid.ParamAttr(name="w"))
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tio.save_persistables(exe, str(tmp_path))
    _corrupt(str(tmp_path / "persistables.npz"))
    with pytest.raises(IOError, match="checksum"):
        tio.load_persistables(exe, str(tmp_path))


# -------------------------------------------------------------- checkpoints


def test_checkpoint_manager_resume_and_gc(tmp_path):
    """tests/test_data_io.py::test_checkpoint_manager_resume in the port."""
    x = tfluid.layers.data("x", [2])
    pred = tfluid.layers.fc(x, 1, param_attr=tfluid.ParamAttr(name="w"),
                            bias_attr=False)
    loss = tfluid.layers.mean(pred)
    tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    cm = tio.CheckpointManager(str(tmp_path), max_to_keep=2)
    xs = np.ones((2, 2), "float32")
    for step in range(1, 6):
        exe.run(feed={"x": xs}, fetch_list=[loss])
        cm.save(step, extra={"cursor": step * 2})
    scope = tfluid.global_scope()
    w5 = scope.find_var("w").clone()
    assert cm.latest_step() == 5
    scope.set_var("w", torch.zeros_like(w5))
    state = cm.restore()
    assert state["step"] == 5 and state["extra"]["cursor"] == 10
    assert torch.equal(scope.find_var("w"), w5)
    kept = [n for n in os.listdir(tmp_path) if n.startswith("ckpt-")]
    assert sorted(kept) == ["ckpt-4", "ckpt-5"]


def test_corrupt_checkpoint_quarantined_and_fallback(tmp_path):
    cm, w1, _ = _ckpt_two_steps(tmp_path)
    assert cm.latest_step() == 2 and cm.intact_steps() == [2, 1]
    _corrupt(os.path.join(cm.dirname, "ckpt-2", "persistables.npz"))
    # the probe reads only: nothing quarantined yet
    assert cm.newest_intact_step() == 1
    assert os.path.exists(os.path.join(cm.dirname, "ckpt-2"))
    state = cm.restore()
    assert state["step"] == 1
    assert not os.path.exists(os.path.join(cm.dirname, "ckpt-2"))
    assert os.path.exists(os.path.join(cm.dirname, "ckpt-2.corrupt"))
    assert cm.latest_step() == 1
    assert torch.equal(tfluid.global_scope().find_var("fc_w_0"), w1)


def test_all_checkpoints_corrupt_raises(tmp_path):
    cm, _, _ = _ckpt_two_steps(tmp_path)
    for step in (1, 2):
        _corrupt(os.path.join(cm.dirname, f"ckpt-{step}", "persistables.npz"),
                 at_middle=False)
    with pytest.raises(tio.CheckpointCorrupt, match="no intact checkpoint"):
        cm.restore()


def test_fault_sites_retry_propagate_and_fall_back(tmp_path):
    """``ckpt.load``: one transient error is absorbed by the in-place
    retry; a persistent environment error propagates and quarantines
    nothing; persistent corruption falls back.  ``ckpt.write``: the
    error surfaces from save and the next save succeeds."""
    cm, _, _ = _ckpt_two_steps(tmp_path)
    faults.inject("ckpt.load", IOError("transient read error"), count=1)
    assert cm.restore()["step"] == 2 and faults.fired("ckpt.load") == 1
    faults.inject("ckpt.load", IOError("disk flaking"), count=2)
    with pytest.raises(IOError, match="disk flaking"):
        cm.restore()
    assert os.path.exists(os.path.join(cm.dirname, "ckpt-2"))
    faults.inject("ckpt.load", tio.CheckpointCorrupt("injected"), count=2)
    assert cm.restore()["step"] == 1
    assert not os.path.exists(os.path.join(cm.dirname, "ckpt-2"))
    faults.inject("ckpt.write", IOError("disk full"), count=1)
    with pytest.raises(IOError, match="disk full"):
        cm.save(3)
    cm.save(3)
    assert cm.latest_step() == 3


def test_gc_removes_uncommitted_orphans_and_limit_step(tmp_path):
    cm, _, _ = _ckpt_two_steps(tmp_path)
    orphan = os.path.join(cm.dirname, "ckpt-99")
    os.makedirs(orphan)
    cm.save(3)
    assert not os.path.exists(orphan)
    cm.save(4)  # four committed: the newest three stay
    assert cm.latest_step() == 4
    assert not os.path.exists(os.path.join(cm.dirname, "ckpt-1"))
    assert os.path.exists(os.path.join(cm.dirname, "ckpt-2"))
    # an agreed older restore leaves the pointer where it was
    assert cm.restore(limit_step=3)["step"] == 3
    assert cm.latest_step() == 4


def test_non_blocking_save_snapshots_warmed_state(tmp_path):
    """A warmed step's state lives in static buffers that every replay
    updates in place: ``save(blocking=False)`` copies it when called, so
    the steps run while the write is in flight do not reach the file."""
    x, y, loss = _sgd_model(tfluid)
    main = tfluid.default_main_program()
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    feed = _batch(2)
    exe.warm(main, [("x", (8, 4), "float32"), ("y", (8, 1), "float32")],
             [loss.name])
    exe.run(main, feed=feed, fetch_list=[loss])
    scope = tfluid.global_scope()
    w_at_save = scope.find_var("fc_w_0").clone()
    cm = tio.CheckpointManager(str(tmp_path / "ckpt"))
    cm.save(1, blocking=False)
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss])
    assert exe.replays == 4
    assert not torch.equal(scope.find_var("fc_w_0"), w_at_save)
    cm.wait()
    assert cm.latest_step() == 1
    saved = np.load(os.path.join(cm.dirname, "ckpt-1", "persistables.npz"))
    assert saved["fc_w_0"].tobytes() == w_at_save.numpy().tobytes()
    # a restore is copied into the static buffers at the next replay
    cm.restore()
    before = exe.replays
    exe.run(main, feed=feed, fetch_list=[loss])
    assert exe.replays == before + 1


# ---------------------------------------------------- across the packages


def _jax_next_step(opt, ckpt_dir, feed):
    _, _, jloss = _sgd_model(jfluid, opt)
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    jfluid.io.CheckpointManager(ckpt_dir).restore()
    out = float(np.asarray(jexe.run(feed=feed, fetch_list=[jloss])[0]))
    return out, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_next_step(opt, ckpt_dir, feed):
    _, _, tloss = _sgd_model(tfluid, opt)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tio.CheckpointManager(ckpt_dir).restore()
    out = float(exe.run(feed=feed, fetch_list=[tloss])[0])
    return out, _scope_np(tfluid.global_scope())


def _assert_states_close(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        if "moment" in n:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(g - w).max() <= 1e-5 * scale, n
        elif n.endswith(".step"):
            assert g.tolist() == w.tolist(), n
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=n)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, opt):
    """The JAX package trains two steps and checkpoints; the port restores
    it and takes the third step; the JAX package does the same from its
    own checkpoint: loss and state agree."""
    _, _, jloss = _sgd_model(jfluid, opt)
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    for s in range(2):
        jexe.run(feed=_batch(s), fetch_list=[jloss])
    d = str(tmp_path / "jax_ckpt")
    jfluid.io.CheckpointManager(d).save(2)
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    want, want_state = _jax_next_step(opt, d, _batch(5))
    got, got_state = _port_next_step(opt, d, _batch(5))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_states_close(got_state, want_state)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_port_checkpoint_restores_into_jax(tmp_path, opt):
    """The reverse: the port trains two steps and checkpoints; the JAX
    package restores it and takes the third step, as the port does from
    its own checkpoint."""
    _, _, tloss = _sgd_model(tfluid, opt)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    for s in range(2):
        exe.run(feed=_batch(s), fetch_list=[tloss])
    d = str(tmp_path / "port_ckpt")
    tio.CheckpointManager(d).save(2)
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    got, got_state = _port_next_step(opt, d, _batch(5))
    want, want_state = _jax_next_step(opt, d, _batch(5))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_states_close(got_state, want_state)


# ------------------------------------------------------------- inference


def _fc_softmax(fl):
    x = fl.layers.data("x", [6])
    h = fl.layers.fc(x, 8, act="relu")
    return fl.layers.fc(h, 3, act="softmax")


def _jax_weights():
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    return jexe, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_with(weights):
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    return exe


def _graph_targets(model):
    return [str(n.target) for n in model.exported.graph.nodes
            if n.op == "call_function"]


def test_fc_softmax_artifact_against_jax_at_two_batches(tmp_path):
    """fc + softmax exported by both packages from the same weights, each
    loaded after a reset of programs and scope: the port's artifact at
    batch 4 (the example batch) and 7 (the symbolic batch) against the
    JAX artifact's outputs, rtol 1e-5; a repeated signature prepares
    nothing new."""
    jpred = _fc_softmax(jfluid)
    jexe, weights = _jax_weights()
    jfluid.io.save_inference_model(str(tmp_path / "jax"), ["x"], [jpred],
                                   jexe, example_batch=4)
    pred = _fc_softmax(tfluid)
    exe = _port_with(weights)
    tio.save_inference_model(str(tmp_path / "port"), ["x"], [pred], exe,
                             example_batch=4)
    spec = json.loads((tmp_path / "port" / "inference.json").read_text())
    want_spec = json.loads((tmp_path / "jax" / "inference.json").read_text())
    for k in ("feed_names", "example_batch", "symbolic_batch", "feeds"):
        assert spec[k] == want_spec[k], k
    assert spec["symbolic_batch"] is True
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    jinfer, _, _ = jfluid.io.load_inference_model(str(tmp_path / "jax"))
    infer, feeds, fetches = tio.load_inference_model(str(tmp_path / "port"), CPU_EXE)
    assert feeds == ["x"] and fetches == spec["fetch_names"]
    rng = np.random.RandomState(0)
    for n in (4, 7):
        xs = rng.rand(n, 6).astype("float32")
        got = infer({"x": xs})[0]
        np.testing.assert_allclose(got, np.asarray(jinfer({"x": xs})[0]),
                                   rtol=1e-5, atol=1e-7)
    assert infer.trace_count() == 2
    infer({"x": xs})
    assert infer.trace_count() == 2
    assert infer.symbolic_batch and infer.example_batch == 4


LM = dict(vocab_size=61, max_len=16, d_model=32, n_heads=4, n_layers=2,
          d_ff=64)


def test_lm_logits_artifact_names_the_flash_op(tmp_path, monkeypatch):
    """The two-layer LM's logits: the port's artifact from JAX's startup
    weights against JAX's forward of the pruned program (flash on its
    Pallas kernel, interpreted) at batch 2 and 3, within 1e-5 of the
    largest logit; the exported graph calls
    ``paddle_tpu_torch.flash_fwd`` once a layer and no softmax of the
    plain version."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")
    T = LM["max_len"]
    outs = {}
    for fl in (jfluid, tfluid):
        toks = fl.layers.data("toks", [T], dtype="int32")
        labs = fl.layers.data("labs", [T, 1], dtype="int32")
        _, outs[fl] = fl.models.transformer.build_lm(toks, labs, **LM)
    jexe, weights = _jax_weights()
    exe = _port_with(weights)
    tio.save_inference_model(str(tmp_path / "lm"), ["toks"], [outs[tfluid]],
                             exe, example_batch=2)
    jinfer = jfluid.default_main_program().prune([outs[jfluid]])
    rng = np.random.RandomState(3)
    feeds = [rng.randint(0, LM["vocab_size"], (n, T)).astype("int32")
             for n in (2, 3)]
    wants = [np.asarray(jexe.run(jinfer, feed={"toks": f},
                                 fetch_list=[outs[jfluid]])[0])
             for f in feeds]
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    infer, _, _ = tio.load_inference_model(str(tmp_path / "lm"), CPU_EXE)
    assert infer.symbolic_batch
    for f, want in zip(feeds, wants):
        got = infer({"toks": f})[0]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    targets = _graph_targets(infer)
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == \
        LM["n_layers"]
    assert not any("softmax" in t for t in targets), targets


def test_text_lstm_artifact_names_the_lstm_op(tmp_path):
    """A small text_lstm (2 x LSTM-8) from JAX's startup weights: the
    port's artifact against JAX's forward at batch 5 (lengths 1-12),
    within 1e-5; its graph calls ``paddle_tpu_torch.lstm_fwd`` once a
    layer and no per-step sigmoid of the plain scan."""
    outs = {}
    for fl in (jfluid, tfluid):
        w = fl.layers.data("w", [12], dtype="int32")
        ln = fl.layers.data("ln", [], dtype="int32")
        lab = fl.layers.data("lab", [1], dtype="int32")
        outs[fl] = fl.models.text_lstm.build(w, ln, lab, 50, emb_dim=8,
                                             hidden=8)[2]
    jexe, weights = _jax_weights()
    exe = _port_with(weights)
    tio.save_inference_model(str(tmp_path / "tl"), ["w", "ln"],
                             [outs[tfluid]], exe, example_batch=2)
    rng = np.random.RandomState(1)
    feed = {"w": rng.randint(0, 50, (5, 12)).astype("int32"),
            "ln": rng.randint(1, 13, (5,)).astype("int32")}
    want = np.asarray(jexe.run(
        jfluid.default_main_program().prune([outs[jfluid]]), feed=feed,
        fetch_list=[outs[jfluid]])[0])
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    infer, _, _ = tio.load_inference_model(str(tmp_path / "tl"), CPU_EXE)
    got = infer(feed)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    targets = _graph_targets(infer)
    assert targets.count("paddle_tpu_torch.lstm_fwd.default") == 2
    assert not any("sigmoid" in t for t in targets), targets
    assert infer.symbolic_batch


def test_conv_bn_relu_artifact_runs_the_fused_conv_op(tmp_path):
    """A 3x3 conv + batch norm (is_test) + ReLU: the exported graph holds
    the fused conv op (``core/fusion.py``'s routing) and the artifact
    gives the pruned program's output at a batch other than the
    example's, bitwise (the same plain version on the CPU)."""
    img = tfluid.layers.data("img", [8, 6, 6])
    c = tfluid.layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
    out = tfluid.layers.batch_norm(c, act="relu")
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tio.save_inference_model(str(tmp_path / "cv"), ["img"], [out], exe,
                             example_batch=2)
    xi = np.random.RandomState(2).rand(3, 8, 6, 6).astype("float32")
    want, = exe.run(tfluid.default_main_program().prune([out]),
                    feed={"img": xi}, fetch_list=[out])
    infer, _, _ = tio.load_inference_model(str(tmp_path / "cv"), CPU_EXE)
    got = infer({"img": xi})[0]
    assert got.tobytes() == want.tobytes()
    assert "paddle_tpu_torch.conv_igemm_fused.default" in \
        _graph_targets(infer)


def test_merge_model_round_trip(tmp_path):
    pred = _fc_softmax(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tio.save_inference_model(str(tmp_path / "m"), ["x"], [pred], exe,
                             example_batch=2)
    xs = np.random.RandomState(4).rand(2, 6).astype("float32")
    want = tio.load_inference_model(str(tmp_path / "m"),
                                    CPU_EXE)[0]({"x": xs})[0]
    tio.merge_model(str(tmp_path / "m"), str(tmp_path / "m.tar"))
    infer, feeds, fetches = tio.load_merged_model(str(tmp_path / "m.tar"),
                                                  CPU_EXE)
    assert feeds == ["x"] and fetches == [pred.name]
    assert infer({"x": xs})[0].tobytes() == want.tobytes()


def test_refused_exports_and_a10_hooks(tmp_path):
    """A ``cond`` program is refused at export, the message naming the op;
    a dropout that is not is_test exports (its kernel is the custom ops
    ``dropout_fwd`` / ``dropout_bwd``) and draws the masks of step 0 at
    every call, as the plain version does; ``export_serving_model`` and
    the artifact's mesh hooks raise naming ROADMAP A.10."""
    x = tfluid.layers.data("x", [4])
    s = tfluid.layers.reduce_sum(x)
    pred = tfluid.layers.greater_than(s, tfluid.layers.fill_constant(
        [1], "float32", 0.0))
    out = tfluid.layers.cond(pred, lambda: x * 2.0, lambda: x * 3.0)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    with pytest.raises(ValueError, match="cond op"):
        tio.save_inference_model(str(tmp_path / "c"), ["x"], [out], exe)
    assert not os.path.exists(tmp_path / "c")
    tfluid.reset_default_programs()
    x = tfluid.layers.data("x", [4])
    d = tfluid.layers.dropout(tfluid.layers.fc(x, 4), 0.5)
    exe.run(tfluid.default_startup_program())
    prog = tfluid.default_main_program()
    for op in prog.global_block.ops:   # a training dropout kept on purpose
        if op.type == "dropout":
            op.attrs["is_test"] = False
    tio._check_exportable(prog)
    step, state = exe.build_raw_step(prog, ["x"], [d.name],
                                     tfluid.global_scope())
    feeds = {"x": torch.from_numpy(
        np.random.RandomState(0).rand(3, 4).astype(np.float32))}
    module = tio._InferenceModule(step)
    with torch.no_grad():   # as save_inference_model exports
        exported = torch.export.export(module, (state, feeds), strict=False)
    assert "paddle_tpu_torch.dropout_fwd" in str(exported.graph)
    got = exported.module()(state, feeds)[0]
    want = module(state, feeds)[0]   # the masks of step 0
    assert torch.equal(got, want) and (got == 0).any() and (got != 0).any()
    with pytest.raises(NotImplementedError, match="A.10"):
        tio.export_serving_model(str(tmp_path / "s"), ["x"], [d], exe)
    pred = _fc_softmax(tfluid)
    exe.run(tfluid.default_startup_program())
    tio.save_inference_model(str(tmp_path / "ok"), ["x"], [pred], exe)
    infer = tio.load_inference_model(str(tmp_path / "ok"), CPU_EXE)[0]
    for hook, args in (("shard", (None,)), ("place_feeds", ({},)),
                       ("serving_mesh", ())):
        with pytest.raises(NotImplementedError, match="A.10"):
            getattr(infer, hook)(*args)


def test_new_modules_import_no_jax():
    """The modules of this slice load no JAX and nothing of
    ``paddle_tpu``."""
    src = ("import sys\n"
           "import paddle_tpu_torch.io, paddle_tpu_torch.trainer\n"
           "import paddle_tpu_torch.reader, paddle_tpu_torch.flags\n"
           "import paddle_tpu_torch.resilience.cluster\n"
           "import paddle_tpu_torch.resilience.policy\n"
           "import paddle_tpu_torch.datasets.common\n"
           "import paddle_tpu_torch.datasets.sk_real\n"
           "bad = sorted(m for m in sys.modules if m == 'jax' or "
           "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu')\n"
           "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
