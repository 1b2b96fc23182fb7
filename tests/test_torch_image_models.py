"""paddle_tpu_torch's image classifiers beyond ResNet (``models.lenet``,
``smallnet``, ``vgg``, ``alexnet`` with ``lrn``, ``googlenet`` with its
inception ``concat``) against the JAX package's on the CPU, each at a small
input size (LeNet 28 px, SmallNet 32, VGG-16 32, AlexNet 96, GoogLeNet 64)
from the JAX startup's weights: one Momentum training step on 2 images
(the loss, and every gradient within 1e-4 of its max abs; the dropout
masks of VGG, AlexNet and GoogLeNet are JAX's threefry bits), and the
three big models built at 224 px as ``tests/test_models.py`` builds them.
The pruned, routed programs are held against JAX's in
``test_torch_image_infer.py`` and the learning checks of
``tests/test_models.py`` run in ``test_torch_image_models_learn.py``
(three files, so that each stays short on one test worker); they share
this file's builders."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid

CPU = tfluid.CPUPlace()
B = 2
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# model -> (models module, channels, image size, build arguments)
MODELS = {"lenet": ("lenet", 1, 28, {}),
          "smallnet": ("smallnet", 3, 32, dict(class_dim=4)),
          "vgg16": ("vgg", 3, 32, dict(class_dim=4, depth=16)),
          "alexnet": ("alexnet", 3, 96, dict(class_dim=4)),
          "googlenet": ("googlenet", 3, 64, dict(class_dim=4))}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run: the suite's workers
    share the host's cores, and torch's thread pool on many small ops
    under that contention runs tens of times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


def _build(fl, model, train=True):
    """``model`` in ``fl``'s fresh default programs, with Momentum(0.01,
    0.9) when ``train`` (benchmark/_common.py::image_spec's optimizer):
    (loss, prediction, logits: the softmax's input)."""
    module, c, size, kw = MODELS[model]
    fl.reset_default_programs()
    img = fl.layers.data("img", [c, size, size])
    label = fl.layers.data("label", [1], dtype="int32")
    loss, _, pred = getattr(fl.models, module).build(img, label, **kw)
    if train:
        fl.optimizer.Momentum(0.01, momentum=0.9).minimize(loss)
    (sm,) = [o for o in fl.default_main_program().list_ops()
             if o.type == "softmax" and o.outputs["Out"] == [pred.name]]
    return loss, pred, sm.inputs["X"][0]


def _feed(model, seed=0, n=B):
    _, c, size, kw = MODELS[model]
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(n, c, size, size).astype(np.float32),
            "label": rng.randint(0, kw.get("class_dim", 10),
                                 (n, 1)).astype(np.int32)}


def _jax_weights():
    jfluid.reset_global_scope()
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    return exe, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_exe(weights, program):
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, program, tfluid.global_scope(), device="cpu")
    return exe


@pytest.mark.parametrize("model", sorted(MODELS))
def test_train_step_matches_jax(model):
    """One Momentum step on 2 images from the JAX startup's weights: the
    same parameter names, the loss within 1e-5 relative, every gradient
    within 1e-4 of its max abs, and every parameter after the update
    within 1e-5 of its max abs."""
    jloss, _, _ = _build(jfluid, model)
    params = [p.name for p in jfluid.default_main_program().parameters()]
    fetch = [jloss] + [f"{n}@GRAD" for n in params]
    jexe, weights = _jax_weights()
    feed = _feed(model)
    want = [np.asarray(a) for a in jexe.run(feed=feed, fetch_list=fetch)]
    jstate = {n: np.asarray(jfluid.global_scope().find_var(n))
              for n in params}
    tloss, _, _ = _build(tfluid, model)
    main = tfluid.default_main_program()
    assert [p.name for p in main.parameters()] == params
    texe = _port_exe(weights, main)
    got = texe.run(feed=feed, fetch_list=[tloss] + fetch[1:])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= GRAD_TOL * scale, name
    for n in params:
        a = tfluid.global_scope().find_var(n).numpy()
        b = jstate[n]
        assert np.abs(a - b).max() <= FWD_TOL * np.abs(b).max(), n


def test_vgg_alexnet_googlenet_build():
    """``tests/test_models.py::test_vgg_alexnet_googlenet_build`` in both
    packages: VGG-16, AlexNet and GoogLeNet at 224 px and 100 classes,
    built only, the prediction [N, 100], and the same persistable names,
    shapes and op types as the JAX package's; VGG-19 too."""
    cases = [("vgg", dict(depth=16)), ("alexnet", {}), ("googlenet", {}),
             ("vgg", dict(depth=19))]
    for module, kw in cases:
        got = {}
        for fl in (jfluid, tfluid):
            fl.reset_default_programs()
            img = fl.layers.data("img", [3, 224, 224])
            label = fl.layers.data("label", [1], dtype="int32")
            _, _, pred = getattr(fl.models, module).build(
                img, label, class_dim=100, **kw)
            assert pred.shape[-1] == 100
            prog = fl.default_main_program()
            got[fl] = ({v.name: tuple(v.shape)
                        for v in prog.persistable_vars()},
                       [o.type or "reduce_mean" for o in prog.list_ops()])
        assert got[tfluid] == got[jfluid], module
    n = sum(int(np.prod(s)) for s in got[tfluid][0].values())
    # VGG-19: 143,667,240 parameters at 1000 classes, 900 x 4097 fewer
    assert n == 143_667_240 - 900 * 4097


def test_train_profile_image_recipes(monkeypatch):
    """``tools/train_profile.py``'s image recipes: at 224 px the inference
    programs' routed convs take the routes the chip run expects
    (``conv_routes``: VGG-19 15 halo and the C = 3 stem on gather under
    amp, 14 halo_f32 and 2 gather in float32, the 64 -> 64 conv at 224
    being too wide for the float32 halo tile; AlexNet 3 halo; GoogLeNet 4
    halo and 6 gather, its ragged inception widths); and at 96 px with 2
    images each recipe runs warmed on the CPU, its batch drawn as
    ``benchmark/_common.py::image_spec`` draws it."""
    from paddle_tpu_torch.tools import train_profile as tp

    want = {("vgg19", True): {"halo": 15, "halo_f32": 0, "gather": 1},
            ("vgg19", False): {"halo": 0, "halo_f32": 14, "gather": 2},
            ("alexnet", True): {"halo": 3, "halo_f32": 0, "gather": 0},
            ("alexnet", False): {"halo": 0, "halo_f32": 3, "gather": 0},
            ("googlenet", True): {"halo": 4, "halo_f32": 0, "gather": 6},
            ("googlenet", False): {"halo": 0, "halo_f32": 4, "gather": 6}}
    for (model, amp), routes in want.items():
        pred, prog, _ = tp.build_image_program(model, amp, infer=True)
        assert tp.conv_routes(prog, [pred.name], 64) == routes, (model, amp)
    orig = tp.image_batch
    monkeypatch.setattr(tp, "RESNET_IMAGE", (3, 96, 96))
    monkeypatch.setattr(tp, "IMAGE_CLASS_DIM", 10)
    monkeypatch.setattr(tp, "IMAGE_MODELS", {
        k: (m, kw, 2) for k, (m, kw, _) in tp.IMAGE_MODELS.items()})
    monkeypatch.setattr(tp, "image_batch",
                        lambda n, device, seed=0, train=True:
                        orig(n, "cpu", seed, train))
    rng = np.random.RandomState(0)
    img = rng.rand(2, 3, 96, 96).astype(np.float32)
    label = rng.randint(0, 10, (2, 1)).astype(np.int32)
    for model in (*tp.IMAGE_MODELS, *tp.IMAGE_INFER):
        fetch, main, startup, params, feed, items, unit = tp._recipe(
            model, amp=False)
        assert (items, unit) == (2, "images")
        np.testing.assert_array_equal(feed["img"].numpy(), img)
        if model in tp.IMAGE_MODELS:
            np.testing.assert_array_equal(feed["label"].numpy(), label)
        else:
            assert "label" not in feed
        exe = tfluid.Executor(CPU)
        scope = tp.train_scope(exe, startup, main, params, "cpu")
        assert exe.warm(main, tp.feed_sig({k: v.numpy() for k, v in
                                           feed.items()}), fetch,
                        scope=scope) == "compiled"
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        assert exe.replays == 1 and np.isfinite(out[0]).all()
