"""``Program.version``, ``Program.to_string`` and ``core/op_info.py`` of the
port against the JAX package's: the same program built in both prints the
same lines, and ``op_info`` types its attrs alike.

Left out of the comparison: attr lines whose value is a dict.  The only
one is the reference's ``hyperparams`` on each optimizer update op, its
optimizer's fields, recorded for its compile store's fingerprint
(``paddle_tpu/optimizer.py::_hyperparam_sig``); the port has no store
(ROADMAP A.10) and its optimizer keeps other fields."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.transformer  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu.core import op_info as j_op_info
from paddle_tpu_torch.core import op_info as t_op_info


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _build(fl, which):
    """fc + softmax-CE + Adam + global-norm clip; ``conv`` puts a conv2d,
    a pool2d and a reshape (tuple attrs) before the fc."""
    L = fl.layers
    lab = L.data("lab", [1], dtype="int32")
    if which == "fc":
        h = L.data("x", [8])
    else:
        img = L.data("img", [3, 8, 8])
        h = L.reshape(L.pool2d(L.conv2d(img, 4, 3, padding=1), 2, "max", 2),
                      [0, 64])
    logits = L.fc(h, 10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        1.0)).minimize(loss)
    return fl.default_main_program()


def _without_dict_attrs(text):
    return [ln for ln in text.splitlines()
            if not (ln.startswith("    attr ") and ": dict = " in ln)]


@pytest.mark.parametrize("which", ["fc", "conv"])
def test_to_string_matches_jax(which):
    """The version line, every var and op line, and the attr lines of int,
    float, bool, str and tuple values (and lists) are equal; the attr types
    that occur are all checked."""
    jtext = _build(jfluid, which).to_string()
    tprog = _build(tfluid, which)
    ttext = tprog.to_string()
    assert str(tprog) == ttext
    assert _without_dict_attrs(ttext) == _without_dict_attrs(jtext)
    kinds = {ln.split(": ", 1)[1].split(" = ")[0]
             for ln in ttext.splitlines() if ln.startswith("    attr ")}
    want = {"int", "float", "bool", "str", "list"} | (
        {"ints"} if which == "conv" else set())
    assert kinds == want
    # dtypes print by their numpy names
    assert "  var[ ] lab: (None, 1) int32" in ttext
    assert ttext.splitlines()[0] == f"Program(version={tprog.version})"


def test_attr_types_match_jax():
    """``op_info.attr_type`` is the same for every attr of every op of the
    program (dict-valued attrs aside, as above)."""
    jprog, tprog = _build(jfluid, "conv"), _build(tfluid, "conv")
    seen = 0
    for jop, top in zip(jprog.list_ops(), tprog.list_ops()):
        assert top.type == jop.type
        for k, v in top.attrs.items():
            if callable(v):
                continue
            assert t_op_info.attr_type(top.type, k) == \
                j_op_info.attr_type(jop.type, k), (top.type, k)
            seen += 1
    assert seen >= 20
    assert t_op_info.get("adam").inferred
    assert set(t_op_info.get("adam").inputs) == {"Param", "Grad", "Accums",
                                                 "Step"}


def test_version_counts_appended_ops():
    """``append_op`` bumps ``version`` as in the reference; ``clone`` keeps
    it; both packages count the same for the same program."""
    j, t = _build(jfluid, "fc"), _build(tfluid, "fc")
    assert t.version == j.version == len(t.list_ops())
    assert t.clone().version == t.version
    assert t.clone(for_test=True).version == t.version
    v = t.version
    t.global_block.append_op(tfluid.core.Op("noop", {}, {}, {"k": (1, 2)},
                                            lambda i, a, c: {}))
    assert t.version == v + 1
    assert t.to_string().splitlines()[-1] == "    attr k: ints = (1, 2)"


def test_explicit_proto_wins_over_observed():
    proto = t_op_info.register_op(
        "probe_op", doc="a probe", ref="x.cc:1", inputs={"X": "in"},
        attrs={"n": t_op_info.AttrSpec("n", "int64", 0)})
    t_op_info.observe(tfluid.core.Op("probe_op", {"X": []}, {}, {"n": 3,
                                                                  "m": 1.5}))
    assert t_op_info.get("probe_op") is proto
    assert t_op_info.attr_type("probe_op", "n") == "int64"
    assert t_op_info.attr_type("probe_op", "m") is None
    t_op_info.observe(tfluid.core.Op("probe_op2", {"X": []}, {"Y": []},
                                     {"n": 3, "f": lambda: 0}))
    assert t_op_info.get("probe_op2").inferred
    assert t_op_info.attr_type("probe_op2", "n") == "int"
    assert "f" not in t_op_info.get("probe_op2").attrs
    assert "op_proto probe_op2 (inferred)" in t_op_info.get(
        "probe_op2").to_string()


def test_to_string_of_bf16_and_amp_program():
    """A bfloat16 variable prints as ``bfloat16`` (JAX's name for it).
    ``amp.enable`` and ``amp.disable`` bump ``version`` in both packages
    (a warmed step holds the policy it was prepared under); apart from the
    version line the program prints as without amp, as the reference's
    does."""
    jprog, prog = _build(jfluid, "fc"), _build(tfluid, "fc")
    before = prog.to_string().splitlines()
    for n, toggle in enumerate(("enable", "disable"), 1):
        getattr(jfluid.amp, toggle)(jprog)
        getattr(tfluid.amp, toggle)(prog)
        assert prog.version == jprog.version == len(prog.list_ops()) + n
        text = prog.to_string()
        assert text.splitlines()[0] == f"Program(version={prog.version})"
        assert text.splitlines()[1:] == before[1:]
        assert _without_dict_attrs(text) == \
            _without_dict_attrs(jprog.to_string())
    blk = prog.global_block
    blk.create_var("h16", (None, 4), "bfloat16")
    assert "  var[ ] h16: (None, 4) bfloat16" in prog.to_string()
    assert str(torch.bfloat16).replace("torch.", "") == \
        np.dtype(jfluid.core.types.convert_dtype("bfloat16")).name


def _build_training_surface(fl, accumulate):
    """dropout, a recomputed block, an L1Decay on a pruned parameter over a
    global L2Decay, and Adam on noam_decay, with ``accumulate`` steps."""
    L = fl.layers
    x = L.data("x", [8])
    lab = L.data("lab", [1], dtype="int32")
    h = L.dropout(L.fc(x, 16, act="relu", param_attr=fl.ParamAttr(
        name="w0", regularizer=fl.regularizer.L1Decay(1e-3),
        update_hook=fl.hooks.StaticPruningHook(0.5))), 0.1)
    h = L.recompute(lambda: L.dropout(L.fc(h, 16, act="relu"), 0.2))
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, 4), lab))
    fl.optimizer.Adam(fl.learning_rate_decay.noam_decay(16, 4),
                      regularization=fl.regularizer.L2Decay(1e-4),
                      accumulate_steps=accumulate).minimize(loss)
    return fl.default_main_program(), fl.default_startup_program()


@pytest.mark.parametrize("accumulate", [1, 4])
def test_to_string_of_training_surface_matches_jax(accumulate):
    """The ops of this slice print line for line as the reference's:
    ``dropout`` (its tag), ``recompute`` (one op over the block's captured
    variables; its sub-block is not printed, as in the reference),
    ``update_hook`` (and ``update_hook_init`` in the startup program),
    ``regularize``, and under accumulation ``grad_accumulate`` and
    ``grad_eff``; ``op_info`` types their attrs alike."""
    jprog, jstart = _build_training_surface(jfluid, accumulate)
    tprog, tstart = _build_training_surface(tfluid, accumulate)
    for j, t in ((jprog, tprog), (jstart, tstart)):
        assert _without_dict_attrs(t.to_string()) == \
            _without_dict_attrs(j.to_string())
    types = [o.type for o in tprog.list_ops()]
    want = {"dropout", "recompute", "update_hook", "regularize"}
    if accumulate > 1:
        want |= {"grad_accumulate", "grad_eff"}
    assert want <= set(types)
    assert "update_hook_init" in [o.type for o in tstart.list_ops()]
    for jop, top in zip(jprog.list_ops(), tprog.list_ops()):
        for k, v in top.attrs.items():
            if not callable(v):
                assert t_op_info.attr_type(top.type, k) == \
                    j_op_info.attr_type(jop.type, k), (top.type, k)
    text = tprog.to_string()
    assert "    attr _tag: int = 1" in text and \
        "    attr dropout_prob: float = 0.1" in text
    assert "dropout_prob: float = 0.2" not in text   # inside the block
