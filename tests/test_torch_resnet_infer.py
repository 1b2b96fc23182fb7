"""paddle_tpu_torch's ResNet inference slice against the JAX package on the
CPU: ``Program.clone(for_test=True)`` and ``Program.prune`` against the
JAX package's on ResNet-50's training program; the inference routing
(``core/fusion.py``) by its counts and its conditions; the routed
``is_test`` programs of the CIFAR ResNet and of one bottleneck block against
the JAX package's pruned programs from the same weights, running
statistics and images, in float32 and under amp; and the step's layout and
state.  ResNet-50 itself is built, not run: a JAX ResNet-50 compile is too
slow here."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.resnet  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.fusion import FUSED_OP_TYPE, route_inference
from paddle_tpu_torch.models import init_resnet_params, init_resnet_stats

CPU = tfluid.CPUPlace()
BF16_U = 2.0 ** -8     # bfloat16's unit roundoff: one rounding <= u |v|
F32_REL = 1e-5         # float32: of max |out|
BF16_SUM_REL = 1e-3    # the sums' share of a bfloat16 element's limit
N_IMG = 8


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


def _softmax_input(program, pred_name):
    (sm,) = [o for o in program.list_ops() if o.type == "softmax"
             and o.outputs["Out"] == [pred_name]]
    return sm.inputs["X"][0]


def _build(fl, model, amp=False):
    """``model`` ("resnet50", "resnet18", "cifar8", "bottleneck") in ``fl``'s
    fresh default programs, as the benchmark configs build it (amp enabled
    after the model); returns (pruned program, prediction, name of the
    fc's pre-softmax output)."""
    if model == "bottleneck":
        img = fl.layers.data("img", [16, 8, 8])
    else:
        img = fl.layers.data("img", [3, 32, 32] if model == "cifar8"
                             else [3, 224, 224])
    label = fl.layers.data("label", [1], dtype="int32")
    if model == "cifar8":
        _, _, pred = fl.models.resnet.build_cifar(img, label, depth=8,
                                                  class_dim=10)
    elif model == "bottleneck":
        y = fl.models.resnet._bottleneck(img, 4, 1)
        y = fl.layers.pool2d(y, 8, "avg", 1, global_pooling=True)
        pred = fl.layers.fc(fl.layers.reshape(y, [0, -1]), 10, act="softmax")
        fl.layers.mean(fl.layers.cross_entropy(pred, label))
    else:
        _, _, pred = fl.models.resnet.build(img, label, class_dim=1000,
                                            depth=int(model[6:]))
    if amp:
        fl.amp.enable()
    pruned = fl.default_main_program().prune([pred])
    return pruned, pred, _softmax_input(pruned, pred.name)


def _bottleneck_arrays(seed):
    """Weights and running statistics of ``_build("bottleneck")``: filters
    N(0, 2 / fan_in), the fc N(0, 1 / fan_in), batch-norm scale and bias
    U(0.5, 1.5) and N(0, 0.1^2), statistics as ``init_resnet_stats``."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in (("conv2d_w_0", (4, 16, 1, 1)),
                        ("conv2d_w_1", (4, 4, 3, 3)),
                        ("conv2d_w_2", (16, 4, 1, 1)), ("fc_w_0", (16, 10))):
        fan_in = np.prod(shape[1:]) if name.startswith("conv") else shape[0]
        out[name] = (rng.standard_normal(shape)
                     * np.sqrt((2.0 if name.startswith("conv") else 1.0)
                               / fan_in)).astype(np.float32)
    out["fc_b_0"] = np.zeros(10, np.float32)
    for i, c in enumerate((4, 4, 16)):
        out[f"batch_norm_w_{i}"] = (rng.rand(c) + 0.5).astype(np.float32)
        out[f"batch_norm_b_{i}"] = (rng.randn(c) * 0.1).astype(np.float32)
        out[f"batch_norm_{2 * i}.w_mean"] = rng.normal(0, 0.1, c).astype(
            np.float32)
        out[f"batch_norm_{2 * i + 1}.w_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
    return out


def _arrays(model):
    if model == "bottleneck":
        return _bottleneck_arrays(3)
    out = init_resnet_params(0, depth=8, class_dim=10, cifar=True)
    out.update(init_resnet_stats(0, depth=8, class_dim=10, cifar=True))
    return out


def _images(model):
    shape = (N_IMG, 16, 8, 8) if model == "bottleneck" else (N_IMG, 3, 32, 32)
    return np.random.RandomState(0).rand(*shape).astype(np.float32)


def _infer(fl, model, amp, arrays, images):
    """(logits, prediction) of ``model``'s pruned program in ``fl`` with
    ``arrays`` loaded over the startup program's state."""
    program, pred, logits = _build(fl, model, amp)
    if fl is tfluid:
        exe = tfluid.Executor(CPU)
        exe.run(tfluid.default_startup_program())
        tfluid.load_scope(arrays, program, tfluid.global_scope(),
                          device="cpu")
    else:
        exe = jfluid.Executor()
        exe.run(jfluid.default_startup_program())
        for k, v in arrays.items():
            jfluid.global_scope().set_var(k, jnp.asarray(v))
    out = exe.run(program, feed={"img": images}, fetch_list=[logits, pred])
    return [np.asarray(o, np.float32) for o in out]


# ------------------------------------------------------------ clone / prune


def test_clone_and_prune_match_jax_on_resnet50():
    """ResNet-50's training program (Momentum, amp) in both packages:
    ``clone(for_test=True)`` and ``prune([prediction])`` give the same op
    types in the same order, ``is_test`` set on the same ops, the same
    persistables read by the kept ops, and the amp policy kept; the
    original programs are left as they were."""
    got = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        img = fl.layers.data("img", [3, 224, 224])
        label = fl.layers.data("label", [1], dtype="int32")
        loss, _, pred = fl.models.resnet.build(img, label, class_dim=1000,
                                               depth=50)
        fl.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
        fl.amp.enable()
        main = fl.default_main_program()
        n_ops = len(main.list_ops())
        progs = (main.clone(for_test=True), main.prune([pred]))
        assert len(main.list_ops()) == n_ops
        assert not any(o.attrs.get("is_test") for o in main.list_ops())
        persist = {v.name for v in main.persistable_vars()}
        got[name] = [([o.type for o in p.list_ops()],
                      [o.attrs.get("is_test") for o in p.list_ops()],
                      sorted({n for o in p.list_ops() for n in o.input_names()
                              if n in persist}),
                      p.amp_policy is not None) for p in progs]
    assert got["port"] == got["jax"]
    (clone_types, _, _, _), (types, is_test, kept, amp) = got["port"]
    assert "momentum" not in clone_types and "backward" not in clone_types
    assert types.count("batch_norm") == 53 and types[-1] == "softmax"
    assert all(t for t, ty in zip(is_test, types) if ty == "batch_norm")
    assert len(kept) == 161 + 2 * 53 and amp


# ------------------------------------------------------------------ routing


@pytest.mark.parametrize("model,fused,plain", [("resnet50", 13, 0),
                                               ("resnet18", 5, 8),
                                               ("cifar8", 2, 3)])
def test_routing_counts(model, fused, plain):
    """The pruned program's 3x3 stride-1 convolutions: each one that BN
    (is_test) and a ReLU follow becomes one fused op, every other runs the
    plain kernel; built only.  ResNet-50: 16 3x3 convolutions, 3 of them
    stride 2; ResNet-18: 5 fused first convolutions of blocks, 8 second
    ones (act=None), 3 stride 2; CIFAR-8: the stem and stage 1's first, and
    the three second ones."""
    program, pred, _ = _build(tfluid, model)
    ops = route_inference(program, [pred.name])
    assert sum(o.type == FUSED_OP_TYPE for o in ops) == fused
    assert sum(o.type == "conv2d" and o.fn.__name__ == "_igemm_fn"
               for o in ops) == plain
    n3x3 = {"resnet50": 16, "resnet18": 16, "cifar8": 7}[model]
    assert sum(o.type == "conv2d" for o in program.list_ops()) - sum(
        o.type == "conv2d" for o in ops) == fused
    assert len(program.list_ops()) - len(ops) == 2 * fused
    assert n3x3 - fused - plain == {"resnet50": 3, "resnet18": 3,
                                    "cifar8": 2}[model]


def _chain_program(case):
    """data -> conv2d 3x3 (pad 1) -> batch_norm(relu), test clone; with
    ``case`` "shared" another op also reads the conv's output.  Returns
    (program, conv output, bn output, relu output)."""
    x = tfluid.layers.data("x", [4, 6, 6])
    c = tfluid.layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
    y = tfluid.layers.batch_norm(c, act="relu")
    if case == "shared":
        y = tfluid.layers.elementwise_add(c, y)
    program = tfluid.default_main_program().clone(for_test=True)
    ops = program.list_ops()
    return program, c.name, ops[1].outputs["Out"][0], ops[2].outputs["Out"][0]


@pytest.mark.parametrize("case", ["fused", "fetch_conv", "fetch_bn",
                                  "shared", "training"])
def test_routing_conditions(case):
    """A fetched conv or batch-norm output, a second reader of the conv's
    output, or a batch norm without is_test keeps the chain unfused: the
    conv alone runs the plain kernel."""
    program, c, y, r = _chain_program(case)
    fetch = {"fetch_conv": [c, r], "fetch_bn": [y, r]}.get(case, [r])
    if case == "training":
        program.global_block.ops[1].attrs["is_test"] = False
    ops = route_inference(program, fetch)
    types = [o.type for o in ops]
    if case == "fused":
        assert types == [FUSED_OP_TYPE]
        assert ops[0].outputs["Out"] == [r]
    else:
        assert types[:3] == ["conv2d", "batch_norm", "relu"]
        assert ops[0].fn.__name__ == "_igemm_fn"


def test_training_program_is_not_routed(monkeypatch):
    """A program with a backward op runs as built: the routing is never
    consulted, so training keeps ``F.conv2d`` (the kernels are forward
    only) and NCHW activations."""
    from paddle_tpu_torch.core import executor

    def refuse(*args, **kwargs):
        raise AssertionError("a training program was routed")

    x = tfluid.layers.data("x", [4, 6, 6])
    y = tfluid.layers.batch_norm(tfluid.layers.conv2d(x, 4, 3, padding=1,
                                                      bias_attr=False),
                                 act="relu")
    loss = tfluid.layers.mean(y)
    tfluid.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    monkeypatch.setattr(executor, "route_inference", refuse)
    images = np.random.RandomState(2).rand(2, 4, 6, 6).astype(np.float32)
    out, act = exe.run(feed={"x": images}, fetch_list=[loss, y],
                       return_numpy=False)
    assert torch.isfinite(out).all() and act.is_contiguous()


def test_amp_policy_that_splits_the_chain_keeps_it_unfused():
    """Under a policy that runs relu in float32 but conv2d in bfloat16 the
    chain's output would change dtype, so it stays three ops; the default
    policy fuses, with x and the filter cast as a conv2d's inputs and the
    statistics left as a batch_norm's."""
    program, _, _, r = _chain_program("fused")
    policy = tfluid.amp.Bf16Policy(extra_f32=["relu"])
    assert [o.type for o in route_inference(program, [r], policy)] == [
        "conv2d", "batch_norm", "relu"]
    (op,) = route_inference(program, [r], tfluid.amp.Bf16Policy())
    assert op.amp_types == {"Input": "conv2d", "Filter": "conv2d",
                            "Scale": "batch_norm", "Bias": "batch_norm",
                            "Mean": "batch_norm", "Variance": "batch_norm"}


# ------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("model", ["cifar8", "bottleneck"])
def test_routed_float32_program_matches_jax(model):
    """The routed float32 is_test program on the CPU (the plain versions)
    against the JAX package's pruned program, same weights, statistics
    and images: the fc's pre-softmax output and the prediction within
    F32_REL of their max |.| (measured 3.3e-7 on CIFAR-8)."""
    arrays, images = _arrays(model), _images(model)
    jl, jp = _infer(jfluid, model, False, arrays, images)
    tl, tp = _infer(tfluid, model, False, arrays, images)
    for got, want in ((tl, jl), (tp, jp)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=F32_REL * np.abs(want).max())


@pytest.mark.parametrize("model", ["cifar8", "bottleneck"])
def test_routed_amp_program_matches_jax(model):
    """Under amp, the JAX package rounds the convolution's output to
    bfloat16 and applies the folded batch norm in bfloat16 (three more
    roundings), while the fused kernel keeps the epilogue in float32 and
    rounds once; through the network these differences compound, so the
    logits are held against the float32 logits (JAX's float32 pruned
    program): the routed amp program's logits are no farther from them
    than the JAX amp program's, in max |.| and in L2 (CIFAR-8: 0.0066 and
    0.0049 of them against JAX's 0.0130 and 0.0084).  Top-1 agrees with
    JAX's amp program on every image whose top-two margin there exceeds
    the two amp programs' distances from the float32 logits together."""
    arrays, images = _arrays(model), _images(model)
    ref, _ = _infer(jfluid, model, False, arrays, images)
    jfluid.reset_default_programs()
    jfluid.reset_global_scope()
    jl, _ = _infer(jfluid, model, True, arrays, images)
    tl, _ = _infer(tfluid, model, True, arrays, images)
    d_jax, d_port = np.abs(jl - ref), np.abs(tl - ref)
    assert d_port.max() <= d_jax.max()
    assert np.linalg.norm(tl - ref) <= np.linalg.norm(jl - ref)
    top2 = np.sort(jl, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > d_jax.max() + d_port.max()
    assert clear.sum() >= N_IMG // 2
    assert np.array_equal(tl.argmax(1)[clear], jl.argmax(1)[clear])


def test_fused_chain_amp_rounding_within_bound():
    """One conv -> batch_norm(is_test) -> relu chain under amp, the fused op
    against the JAX package's three ops.  JAX's output carries the
    roundings of y (the conv), of a and b to bfloat16, of a y and of a y +
    b (to first order at most 3u |a y| + u |b| + u |a y + b|), the kernel's
    one rounding of a y + b; so element by element |d| <= u (3 |a y| + |b|
    + 2 |ref|) + BF16_SUM_REL max |ref|, with y the float32 conv of the
    rounded operands: a bound, not a fit.  The fused op's output is
    bfloat16."""
    rng = np.random.RandomState(3)
    c_in, c_out = 16, 24
    arrays = {
        "conv2d_w_0": (rng.standard_normal((c_out, c_in, 3, 3))
                       / np.sqrt(9 * c_in)).astype(np.float32),
        "batch_norm_w_0": (rng.rand(c_out) + 0.5).astype(np.float32),
        "batch_norm_b_0": (rng.randn(c_out) * 0.1).astype(np.float32),
        "batch_norm_0.w_mean": (rng.randn(c_out) * 0.1).astype(np.float32),
        "batch_norm_1.w_var": (rng.rand(c_out) + 0.5).astype(np.float32)}
    images = rng.rand(4, c_in, 8, 8).astype(np.float32)
    outs = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        x = fl.layers.data("x", [c_in, 8, 8])
        y = fl.layers.batch_norm(fl.layers.conv2d(x, c_out, 3, padding=1,
                                                  bias_attr=False), act="relu")
        fl.amp.enable()
        program = fl.default_main_program().clone(for_test=True)
        if fl is tfluid:
            exe = tfluid.Executor(CPU)
            exe.run(tfluid.default_startup_program())
            tfluid.load_scope(arrays, program, tfluid.global_scope(),
                              device="cpu")
            (op,) = route_inference(program, [y.name], program.amp_policy)
            assert op.type == FUSED_OP_TYPE
            out, = exe.run(program, feed={"x": images}, fetch_list=[y],
                           return_numpy=False)
            assert out.dtype == torch.bfloat16
            outs[name] = out.float().numpy()
        else:
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            for k, v in arrays.items():
                jfluid.global_scope().set_var(k, jnp.asarray(v))
            outs[name] = np.asarray(exe.run(program, feed={"x": images},
                                            fetch_list=[y])[0], np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()  # noqa: E731
    conv = torch.nn.functional.conv2d(bf(images), bf(arrays["conv2d_w_0"]),
                                      padding=1).numpy()
    a = arrays["batch_norm_w_0"] / np.sqrt(arrays["batch_norm_1.w_var"]
                                           + 1e-5)
    b = arrays["batch_norm_b_0"] - arrays["batch_norm_0.w_mean"] * a
    ay = np.abs(conv * a[None, :, None, None])
    ref = outs["jax"]
    lim = BF16_U * (3 * ay + np.abs(b)[None, :, None, None]
                    + 2 * np.abs(ref)) + BF16_SUM_REL * np.abs(ref).max()
    assert np.all(np.abs(outs["port"] - ref) <= lim)


# ------------------------------------------------------------ layout, state


def test_inference_leaves_running_statistics_unchanged():
    """An ``Executor.run`` of the routed CIFAR-8 program leaves every
    running statistic in the scope bitwise as it was, and the images'
    layout does not change the result."""
    arrays, images = _arrays("cifar8"), _images("cifar8")
    program, pred, _ = _build(tfluid, "cifar8")
    exe = tfluid.Executor(CPU)
    scope = tfluid.global_scope()
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(arrays, program, scope, device="cpu")
    stats = {n: scope.find_var(n).clone() for n in arrays
             if n.endswith((".w_mean", ".w_var"))}
    assert len(stats) == 18
    first, = exe.run(program, feed={"img": images}, fetch_list=[pred])
    nhwc = torch.from_numpy(images).contiguous(
        memory_format=torch.channels_last)
    again, = exe.run(program, feed={"img": nhwc}, fetch_list=[pred])
    np.testing.assert_array_equal(first, again)
    for n, v in stats.items():
        assert torch.equal(scope.find_var(n), v), n


def test_layout_channels_last_only_where_routed():
    """A routed program runs on channels_last activations (the feed is put
    there once, and the kernels' outputs and cuDNN's stay there); a program
    the routing leaves alone (a stride-2 3x3) keeps NCHW-contiguous
    activations, as before."""
    outs = {}
    for stride in (1, 2):
        tfluid.reset_default_programs()
        x = tfluid.layers.data("x", [4, 6, 6])
        y = tfluid.layers.batch_norm(tfluid.layers.conv2d(
            x, 8, 3, stride=stride, padding=1, bias_attr=False), act="relu")
        z = tfluid.layers.conv2d(y, 8, 1, bias_attr=False)
        program = tfluid.default_main_program().clone(for_test=True)
        exe = tfluid.Executor(CPU)
        exe.run(tfluid.default_startup_program())
        images = np.random.RandomState(1).rand(2, 4, 6, 6).astype(np.float32)
        outs[stride] = exe.run(program, feed={"x": images},
                               fetch_list=[y, z], return_numpy=False)
    for t in outs[1]:
        assert t.is_contiguous(memory_format=torch.channels_last)
        assert not t.is_contiguous()
    for t in outs[2]:
        assert t.is_contiguous()


def test_init_resnet_stats_names_and_draws():
    """``init_resnet_stats`` gives every running statistic of the program,
    under the names both packages declare, means N(0, 0.1^2) and variances
    in [0.5, 1.5), float32, and loads with ``load_scope``."""
    stats = init_resnet_stats(0, depth=50, class_dim=1000)
    assert len(stats) == 2 * 53
    img = jfluid.layers.data("img", [3, 224, 224])
    label = jfluid.layers.data("label", [1], dtype="int32")
    jfluid.models.resnet.build(img, label, class_dim=1000, depth=50)
    want = {v.name: tuple(v.shape)
            for v in jfluid.default_main_program().persistable_vars()
            if v.name.endswith((".w_mean", ".w_var"))}
    assert {n: a.shape for n, a in stats.items()} == want
    means = np.concatenate([a for n, a in stats.items()
                            if n.endswith(".w_mean")])
    var = np.concatenate([a for n, a in stats.items()
                          if n.endswith(".w_var")])
    assert all(a.dtype == np.float32 for a in stats.values())
    assert abs(means.std() - 0.1) < 0.01 and abs(means.mean()) < 0.01
    assert var.min() >= 0.5 and var.max() < 1.5
    assert init_resnet_stats(0, depth=50).keys() == stats.keys()
    np.testing.assert_array_equal(
        init_resnet_stats(0, depth=50)["batch_norm_0.w_mean"],
        stats["batch_norm_0.w_mean"])
