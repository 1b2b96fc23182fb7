"""``layers.recompute`` (remat) of the port against the JAX package's on the
CPU: a recomputed block with dropout 0 against the reference's
``jax.checkpoint`` block; remat against no remat in the port with dropout
0.1; and the one intended divergence (ROADMAP C.7): the reference's remat
draws each block's dropout tags from a fresh sub-program, so its blocks
repeat the tags 1, 2, ... and share masks, while the port's tags come from
the outer program and remat changes no mask."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.executor import check_kernel_shapes

CPU = tfluid.CPUPlace()
TINY = dict(vocab_size=61, max_len=16, d_model=32, n_heads=4, n_layers=2,
            d_ff=64)


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _block_net(fl, remat):
    """x -> [fc(gelu) -> fc, named parameters] (recomputed or not) -> +x
    -> mean; returns (loss, block output)."""
    L = fl.layers
    x = L.data("x", [5, 8])

    def blk():
        h = L.fc(x, 12, num_flatten_dims=2, act="gelu",
                 param_attr=fl.ParamAttr(name="b.w1"),
                 bias_attr=fl.ParamAttr(name="b.b1"))
        return L.fc(h, 8, num_flatten_dims=2,
                    param_attr=fl.ParamAttr(name="b.w2"),
                    bias_attr=fl.ParamAttr(name="b.b2"))

    out = L.recompute(blk) if remat else blk()
    return L.mean(L.elementwise_add(out, x)), out


def test_recompute_matches_jax():
    """The port's recomputed block against the reference's (dropout 0):
    the block's output and every parameter gradient within the float32
    tolerance of the train tests (atol 1e-5); the parameters keep their
    names on the outer program."""
    feed = {"x": np.random.RandomState(3).randn(4, 5, 8).astype(np.float32)}
    outs = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        loss, out = _block_net(fl, True)
        pg = fl.backward.append_backward(loss)
        prog = fl.default_main_program()
        assert [o.type for o in prog.list_ops()][:2] == [
            "recompute", "elementwise_add"]
        assert sorted(p.name for p in prog.parameters()) == [
            "b.b1", "b.b2", "b.w1", "b.w2"]
        fetch = [out, loss] + [g for _, g in pg]
        if name == "jax":
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            state = {n: np.asarray(v) for n, v in
                     jfluid.global_scope().items()}
            outs[name] = exe.run(feed=feed, fetch_list=fetch)
        else:
            exe = tfluid.Executor(CPU)
            exe.run(tfluid.default_startup_program())
            tfluid.load_scope(state, prog, tfluid.global_scope(),
                              device="cpu")
            outs[name] = exe.run(feed=feed, fetch_list=fetch)
    for a, b in zip(outs["port"], outs["jax"]):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def _lm_step(remat, seed=0):
    """One eager Adam step of the tiny LM with dropout 0.1 from the
    numpy weights of ``seed``: the loss and every gradient."""
    tfluid.reset_default_programs()
    T = TINY["max_len"]
    toks = tfluid.layers.data("toks", [T], dtype="int32")
    labs = tfluid.layers.data("labs", [T, 1], dtype="int32")
    loss, _ = tfluid.models.build_lm(toks, labs, dropout=0.1, remat=remat,
                                     **TINY)
    tfluid.optimizer.Adam(1e-3).minimize(loss)
    prog = tfluid.default_main_program()
    params = tfluid.init_lm_params(seed, **TINY)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(tfluid.default_startup_program(), scope=scope)
    tfluid.load_scope(params, prog, scope, device="cpu")
    scope.step_counter = 9
    rng = np.random.RandomState(5)
    feed = {"toks": rng.randint(0, TINY["vocab_size"], (3, T)).astype(
        np.int32), "labs": rng.randint(0, TINY["vocab_size"], (3, T, 1))
        .astype(np.int32)}
    fetch = [loss] + [f"{n}@GRAD" for n in params]
    return prog, exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)


def test_remat_against_no_remat_with_dropout():
    """The port with dropout 0.1: remat gives the loss of the plain build
    bitwise (the same ops on the same inputs, the same masks) and each
    gradient within 1e-5 of its max abs (the backward may add a residual's
    two contributions in another order); the recomputed blocks' ops are
    walked by ``all_ops`` and checked for the card: the tiny LM's head dim
    8, inside the blocks, is refused there."""
    _, plain = _lm_step(False)
    rprog, remat = _lm_step(True)
    assert plain[0].tobytes() == remat[0].tobytes()
    for a, b in zip(remat[1:], plain[1:]):
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30)
    assert [o.type for o in rprog.list_ops()].count("recompute") == \
        TINY["n_layers"]
    inner = [o.type for b, o in rprog.all_ops()
             if b is not rprog.global_block]
    assert inner.count("attention") == TINY["n_layers"]
    assert inner.count("dropout") == 2 * TINY["n_layers"]
    with pytest.raises(ValueError, match="got D=8"):
        check_kernel_shapes(rprog, torch.device("cuda"))


def _dropout_tags(fl, remat, monkeypatch):
    """The dropout tags of ``build_lm(n_layers=3, dropout=0.1)`` in the
    order the layers were built, read off each dropout op as it is
    appended (the reference keeps its recompute blocks' ops in closures)."""
    tags = []
    mod = fl.layers
    orig = mod.dropout

    def spy(*a, **kw):
        out = orig(*a, **kw)
        tags.append(fl.default_main_program().global_block.ops[-1]
                    .attrs["_tag"])
        return out

    monkeypatch.setattr(mod, "dropout", spy)
    T = TINY["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    fl.models.transformer.build_lm(toks, labs, **dict(TINY, n_layers=3),
                                   dropout=0.1, remat=remat)
    monkeypatch.undo()
    return tags


def test_remat_dropout_tags_pin_the_reference_divergence(monkeypatch):
    """ROADMAP C.7.  Without remat both packages tag their seven dropout
    sites 1..7.  With remat the reference's blocks draw tags from fresh
    sub-programs, [1, 1, 2, 1, 2, 1, 2]: every block's attention dropout
    shares the embedding dropout's mask, and every FFN dropout one mask.
    The port keeps 1..7, as its stated remat contract (numerically
    identical to the plain build) needs."""
    want = list(range(1, 8))
    assert _dropout_tags(jfluid, False, monkeypatch) == want
    jfluid.reset_default_programs()
    assert _dropout_tags(jfluid, True, monkeypatch) == [1, 1, 2, 1, 2, 1, 2]
    assert _dropout_tags(tfluid, False, monkeypatch) == want
    tfluid.reset_default_programs()
    assert _dropout_tags(tfluid, True, monkeypatch) == want
    tags = [o.attrs["_tag"] for _, o in
            tfluid.default_main_program().all_ops() if o.type == "dropout"]
    assert tags == want
