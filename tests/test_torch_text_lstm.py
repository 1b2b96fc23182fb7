"""paddle_tpu_torch's text_lstm training slice against the JAX package on the
CPU: the program's parameters, two Adam steps of a tiny 2-layer model from
the same numpy weights (JAX with its Pallas LSTM kernel interpreted), and
the layers the model adds (softmax, log_softmax, cross_entropy, accuracy)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.text_lstm  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import (init_text_lstm_params,
                                     text_lstm_param_shapes)

CPU = tfluid.CPUPlace()
TINY = dict(vocab_size=50, emb_dim=8, hidden=16, num_layers=2, class_dim=2)
SEQ = 12


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _build(fl):
    words = fl.layers.data("words", [SEQ], dtype="int32")
    lengths = fl.layers.data("lengths", [-1], dtype="int32",
                             append_batch_size=False)
    label = fl.layers.data("label", [1], dtype="int32")
    loss, acc, pred = fl.models.text_lstm.build(words, lengths, label, **TINY)
    fl.optimizer.Adam(1e-3).minimize(loss)
    return loss, acc, pred


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def test_program_matches_jax():
    """The same persistable names, shapes and dtypes and the same op types
    in the main and startup programs; the parameters are exactly
    ``text_lstm_param_shapes``."""
    _build(jfluid)
    _build(tfluid)
    for jp, tp in ((jfluid.default_main_program(),
                    tfluid.default_main_program()),
                   (jfluid.default_startup_program(),
                    tfluid.default_startup_program())):
        jv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in jp.persistable_vars()}
        tv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in tp.persistable_vars()}
        assert tv == jv
        assert [o.type for o in tp.list_ops()] == \
            [o.type for o in jp.list_ops()]
    params = {p.name: tuple(p.shape)
              for p in tfluid.default_main_program().parameters()}
    assert params == text_lstm_param_shapes(**TINY)
    assert list(params) == ["embedding_w_0", "fc_w_0", "dynamic_lstm_w_0",
                            "dynamic_lstm_b_0", "fc_w_1", "dynamic_lstm_w_1",
                            "dynamic_lstm_b_1", "fc_w_2", "fc_b_0"]


def test_two_adam_steps_match_jax(interpret_mode):
    """Two Adam(1e-3) steps from the same numpy weights on the same feed
    (lengths with 0 and T): losses rtol 1e-5, accuracies equal, every
    parameter within atol 2e-5 (two steps of lr 1e-3 move a weight by at
    most 2e-3), moments within 1e-4 of their max |.|."""
    rng = np.random.RandomState(11)
    feed = {"words": rng.randint(0, TINY["vocab_size"], (5, SEQ)).astype(
                np.int32),
            "lengths": np.array([12, 7, 1, 0, 9], np.int32),
            "label": rng.randint(0, 2, (5, 1)).astype(np.int32)}
    weights = init_text_lstm_params(3, **TINY)

    jloss, jacc, _ = _build(jfluid)
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    for k, v in weights.items():
        jfluid.global_scope().set_var(k, jnp.asarray(v))
    jout = [[float(np.asarray(a)[()] if np.ndim(a) == 0 else np.asarray(a)[0])
             for a in jexe.run(feed=feed, fetch_list=[jloss, jacc])]
            for _ in range(2)]
    after = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}

    tloss, tacc, _ = _build(tfluid)
    texe = tfluid.Executor(CPU)
    texe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    tout = [[float(np.ravel(a)[0])
             for a in texe.run(feed=feed, fetch_list=[tloss, tacc])]
            for _ in range(2)]
    np.testing.assert_allclose([o[0] for o in tout], [o[0] for o in jout],
                               rtol=1e-5)
    assert [o[1] for o in tout] == [o[1] for o in jout]
    assert tout[1][0] < tout[0][0]
    tstate = {n: v.numpy() for n, v in tfluid.global_scope().items()}
    assert set(tstate) == set(after)
    for n, want in after.items():
        got = tstate[n]
        if n.endswith((".moment1", ".moment2")):
            scale = max(float(np.abs(want).max()), 1e-30)
            assert np.abs(got - want).max() <= 1e-4 * scale, n
        else:
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0,
                                       err_msg=n)


# ------------------------------------------------------------ single layers


def _layer_case(fl, which):
    """(output var, feed): probabilities with exact two- and four-way ties
    fed straight to cross_entropy / accuracy, or logits to
    softmax / log_softmax."""
    L = fl.layers
    p = np.array([[0.5, 0.5, 0.0, 0.0], [0.1, 0.2, 0.3, 0.4],
                  [0.25, 0.25, 0.25, 0.25], [0.0, 0.3, 0.3, 0.4],
                  [0.7, 0.1, 0.1, 0.1]], np.float32)
    lab = np.array([[1], [3], [2], [1], [0]], np.int32)
    x = L.data("p", [4])
    y = L.data("lab", [1], dtype="int32")
    feed = {"p": p, "lab": lab}
    if which == "softmax":
        feed["p"] = np.random.RandomState(2).randn(5, 4).astype(np.float32)
        return L.softmax(x), feed
    if which == "log_softmax":
        feed["p"] = np.random.RandomState(2).randn(5, 4).astype(np.float32)
        return L.log_softmax(x), feed
    if which == "cross_entropy":
        return L.cross_entropy(x, y), feed
    if which == "cross_entropy_soft":
        soft = L.data("soft", [4])
        feed["soft"] = np.random.RandomState(3).dirichlet(
            np.ones(4), 5).astype(np.float32)
        return L.cross_entropy(x, soft, soft_label=True), feed
    k = int(which[-1])
    return L.accuracy(x, y, k=k), feed


@pytest.mark.parametrize("which", ["softmax", "log_softmax", "cross_entropy",
                                   "cross_entropy_soft", "accuracy_k1",
                                   "accuracy_k2", "accuracy_k3"])
def test_layer_matches_jax(which):
    """Each layer in a one-op program, both packages, the same feed (atol
    1e-6).  The accuracy rows hold ties, where ``jax.lax.top_k`` takes the
    lower index first: row 0's label 1 (tied with 0) is out of the top 1
    and in the top 2, row 3's label 1 (tied with 2) is in the top 2 only
    by index order, and row 2's label 2 (four-way tie) only in the top
    3."""
    got = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        out, feed = _layer_case(fl, which)
        exe = fl.Executor(CPU) if fl is tfluid else fl.Executor()
        exe.run(fl.default_startup_program())
        got[name] = np.asarray(exe.run(feed=feed, fetch_list=[out])[0])
    assert got["port"].shape == got["jax"].shape
    assert got["port"].dtype == got["jax"].dtype
    np.testing.assert_allclose(got["port"], got["jax"], atol=1e-6, rtol=0)
    if which.startswith("accuracy"):
        assert got["port"].shape == (1,)
        assert got["port"][0] == np.float32({"accuracy_k1": 0.4,
                                             "accuracy_k2": 0.8,
                                             "accuracy_k3": 1.0}[which])
