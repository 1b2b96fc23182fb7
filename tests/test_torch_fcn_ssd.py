"""paddle_tpu_torch's FCN segmenter and SSD detector (``models.fcn``,
``models.ssd``) against the JAX package's on the CPU, from the JAX
startup's weights loaded by name (``load_scope``): one training step on 2
images (the loss within 1e-5 relative, every gradient within 1e-4 of its
max abs); the programs pruned to FCN's logits and to SSD's detections,
their 3x3 stride-1 convs routed onto the conv kernel (its plain version on
the CPU: FCN's three, SSD's four heads; SSD's stride-2 conv -> BN -> ReLU
chains stay unfused), within 1e-5 of their max abs; the JAX package's own
learning checks, mirrored (``tests/test_detection.py::
test_ssd_model_trains_and_detects``, ``tests/test_amp.py::
test_amp_fcn_deconv_trains`` and, at 16 px, ``tests/test_models.py::
test_fcn_segmentation_converges``); ``datasets.voc2012``'s masks against
the reference's; and ``tools/train_profile.py``'s fcn and ssd recipes."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.fusion import FUSED_OP_TYPE, route_inference
from paddle_tpu_torch.tools import train_profile as tp

CPU = tfluid.CPUPlace()
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
S_FCN, S_SSD = 16, 32
FCN_KW = dict(num_classes=8, base=8)
SSD_KW = dict(size=S_SSD, num_classes=3, gt=2)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run: the suite's workers
    share the host's cores."""
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


def _fcn(fl, S=S_FCN, **kw):
    img = fl.layers.data("img", [3, S, S])
    lab = fl.layers.data("lab", [S, S], dtype="int32")
    return fl.models.fcn.build(img, lab, **(kw or FCN_KW))


def _ssd(fl, S=S_SSD, G=2, C=3, keep=8):
    img = fl.layers.data("img", [3, S, S])
    gb = fl.layers.data("gb", [G, 4])
    gl = fl.layers.data("gl", [G], dtype="int32")
    loss, (loc, conf, prior, pvar) = fl.models.ssd.build(img, gb, gl,
                                                         num_classes=C)
    dets = fl.models.ssd.infer(loc, conf, prior, pvar, keep_top_k=keep)
    return loss, dets, (gb, gl)


def _fcn_feed(n=2, seed=0, S=S_FCN, classes=8):
    feed = tp.fcn_batch(n, seed, size=S)
    feed["lab"] = np.minimum(feed["lab"], classes - 1).astype(np.int32)
    return feed


def _jax_weights(seed=None):
    if seed is not None:
        jfluid.default_main_program().random_seed = seed
        jfluid.default_startup_program().random_seed = seed
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    return exe, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_exe(weights, program):
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, program, tfluid.global_scope(), device="cpu")
    return exe


@pytest.mark.parametrize("model", ["fcn", "ssd"])
def test_train_step_matches_jax(model):
    """One Adam step on 2 images from the JAX startup's weights: the same
    parameter names, the loss within 1e-5 relative and every gradient
    within 1e-4 of its max abs (FCN: its transposed conv's too; SSD: the
    batch norms' and heads'), and every parameter after the update within
    1e-5 of its max abs."""
    def build(fl):
        fl.reset_default_programs()
        loss = _fcn(fl)[0] if model == "fcn" else _ssd(fl)[0]
        fl.optimizer.Adam(5e-3 if model == "fcn" else 1e-3).minimize(loss)
        return loss

    feed = (_fcn_feed() if model == "fcn"
            else tp.ssd_batch(2, seed=1, **SSD_KW))
    jloss = build(jfluid)
    params = [p.name for p in jfluid.default_main_program().parameters()]
    fetch = [jloss] + [f"{n}@GRAD" for n in params]
    jexe, weights = _jax_weights()
    want = [np.asarray(a) for a in jexe.run(feed=feed, fetch_list=fetch)]
    jstate = {n: np.asarray(jfluid.global_scope().find_var(n))
              for n in params}
    tloss = build(tfluid)
    main = tfluid.default_main_program()
    assert [p.name for p in main.parameters()] == params
    got = _port_exe(weights, main).run(feed=feed,
                                       fetch_list=[tloss] + fetch[1:])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= GRAD_TOL * scale, name
    for n in params:
        a = tfluid.global_scope().find_var(n).numpy()
        b = jstate[n]
        assert np.abs(a - b).max() <= FWD_TOL * np.abs(b).max(), n


def _igemm_ops(routed):
    return sum(o.fn.__name__ == "_igemm_fn" for o in routed)


def test_fcn_pruned_inference_matches_jax():
    """The program pruned to the logits (no loss, label, accuracy or
    optimizer op), its three 3x3 convs (C = 3, 8, 16) routed onto the
    conv kernel, the 1x1 head and the transposed conv on the plain ops;
    3 images, the logits within 1e-5 of their max abs against JAX's pruned
    program."""
    _, _, jlog = _fcn(jfluid)
    jprog = jfluid.default_main_program().prune([jlog])
    jexe, weights = _jax_weights()
    feed = {"img": _fcn_feed(3, seed=1)["img"]}
    want = np.asarray(jexe.run(jprog, feed=feed, fetch_list=[jlog])[0])
    _, _, tlog = _fcn(tfluid)
    prog = tfluid.default_main_program().prune([tlog])
    types = {o.type for o in prog.list_ops()}
    assert "conv2d_transpose" in types and types.isdisjoint(
        {"softmax_with_cross_entropy", "mean", "argmax", "equal"})
    routed = route_inference(prog, [tlog.name])
    assert _igemm_ops(routed) == 3
    got = _port_exe(weights, prog).run(prog, feed=feed, fetch_list=[tlog])[0]
    assert got.shape == want.shape == (3, 8, S_FCN, S_FCN)
    assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max()


def test_ssd_pruned_detect_matches_jax():
    """The program pruned to ``ssd.infer``'s detections: its four 3x3
    heads routed, the stride-2 conv -> batch_norm(is_test) -> relu chains
    left unfused (no ``conv2d_bn_relu`` op: the kernels take stride 1);
    4 images from JAX's startup weights and running statistics, the boxes
    and scores within 1e-5 of their max abs and the labels equal, every
    slot."""
    jdets = _ssd(jfluid)[1]
    jprog = jfluid.default_main_program().prune(list(jdets))
    jexe, weights = _jax_weights()
    feed = tp.ssd_batch(4, seed=2, train=False, **SSD_KW)
    want = [np.asarray(a) for a in jexe.run(jprog, feed=feed,
                                            fetch_list=list(jdets))]
    tdets = _ssd(tfluid)[1]
    prog = tfluid.default_main_program().prune(list(tdets))
    assert "ssd_loss" not in {o.type for o in prog.list_ops()}
    routed = route_inference(prog, [d.name for d in tdets])
    assert _igemm_ops(routed) == 4
    assert FUSED_OP_TYPE not in {o.type for o in routed}
    assert sum(o.type == "conv2d" for o in routed) == 7
    got = _port_exe(weights, prog).run(prog, feed=feed,
                                       fetch_list=list(tdets))
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= FWD_TOL * max(np.abs(b).max(), 1.0)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].shape == (4, 8) and (got[2] >= 0).any()


def test_voc2012_masks_match_the_reference():
    """``datasets.voc2012``'s synthetic readers yield the reference's
    samples bitwise (train seed 0, test seed 1); with no VOCdevkit under
    the data home the detection readers raise as the reference's do."""
    from paddle_tpu.datasets import voc2012 as jvoc

    from paddle_tpu_torch.datasets import voc2012 as tvoc

    for fn in ("train", "test"):
        got = list(getattr(tvoc, fn)(n_synthetic=6, size=24)())
        want = list(jvoc._reader(6, 0 if fn == "train" else 1, 24)())
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.dtype == wi.dtype and gm.dtype == wm.dtype
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
    assert tvoc.NUM_CLASSES == 21 and tvoc.DET_CLASSES == jvoc.DET_CLASSES
    for mod in (tvoc, jvoc):
        with pytest.raises(FileNotFoundError, match="VOC detection data"):
            mod.detection_train()


def test_ssd_model_trains_and_detects():
    """``tests/test_detection.py::test_ssd_model_trains_and_detects`` in
    the port, from the JAX test's seed-8 startup weights (its sweep's
    widest margin): 25 Adam(2e-3) steps on synthetic one-box images until
    the loss falls under 0.6 of the first, then the detections streamed
    into ``DetectionMAP`` (in the same program, so every step's batch
    counts, as in the reference), mAP over 0.33."""
    from paddle_tpu_torch.evaluator import DetectionMAP

    N, S, G, C = 8, 32, 2, 3
    rng = np.random.RandomState(0)
    batches = [tp.ssd_batch(N, rng.randint(2 ** 31), size=S, num_classes=C,
                            gt=G) for _ in range(25)]
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        loss, (boxes, scores, labels), (gbv, glv) = _ssd(fl, S, G, C)
        if fl is tfluid:
            ev = DetectionMAP(boxes, scores, labels, gbv, glv, num_classes=C)
        fl.optimizer.Adam(2e-3).minimize(loss)
    _, weights = _jax_weights(seed=8)
    exe = _port_exe(weights, tfluid.default_main_program())
    losses = [float(exe.run(feed=b, fetch_list=[loss])[0]) for b in batches]
    assert losses[-1] < losses[0] * 0.6, losses
    b, s, lab = exe.run(feed=batches[-1], fetch_list=[boxes, scores, labels])
    assert b.shape == (N, 8, 4) and s.shape == (N, 8) and lab.shape == (N, 8)
    assert np.isfinite(s).all()
    m = ev.eval()
    assert m > 0.33, m


def test_amp_fcn_deconv_trains():
    """``tests/test_amp.py::test_amp_fcn_deconv_trains`` in the port: the
    transposed conv is a bfloat16 op; 40 Adam steps under amp on 16
    synthetic masks at 16 px lower the loss."""
    loss, _, _ = _fcn(tfluid)
    tfluid.optimizer.Adam(5e-3).minimize(loss)
    tfluid.amp.enable()
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    data = list(tfluid.datasets.voc2012.train(n_synthetic=16, size=S_FCN)())
    xs = np.stack([d[0] for d in data])
    ys = np.minimum(np.stack([d[1] for d in data]), 7).astype("int32")
    first = None
    for _ in range(40):
        out, = exe.run(feed={"img": xs, "lab": ys}, fetch_list=[loss])
        first = first if first is not None else float(out)
    assert np.isfinite(out).all() and float(out) < first


def test_fcn_segmentation_converges():
    """``tests/test_models.py::test_fcn_segmentation_converges`` (which the
    JAX package marks slow at 32 px) at 16 px: 200 Adam(5e-3) steps on 64
    synthetic masks, 21 classes, base 8; the per-pixel NLL under 0.3 of
    the first and the pixel accuracy past the all-background rate by
    0.03."""
    loss, acc, _ = _fcn(tfluid, num_classes=21, base=8)
    tfluid.optimizer.Adam(5e-3).minimize(loss)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    data = list(tfluid.datasets.voc2012.train(n_synthetic=64, size=S_FCN)())
    feed = {"img": np.stack([d[0] for d in data]),
            "lab": np.stack([d[1] for d in data]).astype("int32")}
    first = last_acc = None
    for _ in range(200):
        out, a = exe.run(feed=feed, fetch_list=[loss, acc])
        first = first if first is not None else float(out)
        last, last_acc = float(out), float(a)
    assert last < first * 0.3, (first, last)
    base_acc = float((feed["lab"] == 0).mean())
    assert last_acc > base_acc + 0.03, (last_acc, base_acc)


def test_train_profile_fcn_ssd_recipes(monkeypatch):
    """``tools/train_profile.py``'s fcn and ssd recipes: at their full
    sizes (FCN at 256 px, SSD at 300 px) the pruned programs' routed
    convs all take the gather route (``conv_routes``: FCN's C = 3, 16, 32
    and SSD's heads with O = 8 and 42, none a multiple of 64), 3 and 4 a
    step in both dtypes; and at small sizes each recipe runs warmed on the
    CPU, its batch the one the chip run draws."""
    for model, build, n in (("fcn", tp.build_fcn_program, 3),
                            ("ssd", tp.build_ssd_program, 4)):
        for amp in (True, False):
            fetch, prog, _ = build(amp, infer=True)
            names = [f.name for f in (fetch if isinstance(fetch, tuple)
                                      else [fetch])]
            assert tp.conv_routes(prog, names, 32) == {
                "halo": 0, "halo_f32": 0, "gather": n}, (model, amp)
    assert sum(op.type == "ssd_loss" for op in tp.build_ssd_program()[1]
               .list_ops()) == 1
    monkeypatch.setattr(tp, "FCN_SIZE", 16)
    monkeypatch.setattr(tp, "SSD_SIZE", 32)
    monkeypatch.setattr(tp, "FCN_BATCH", 2)
    monkeypatch.setattr(tp, "SSD_BATCH", 2)
    fcn_batch, ssd_batch = tp.fcn_batch, tp.ssd_batch
    monkeypatch.setattr(tp, "fcn_batch", lambda n=2, seed=0, train=True:
                        fcn_batch(n, seed, train, size=16))
    monkeypatch.setattr(tp, "ssd_batch", lambda n=2, seed=0, train=True:
                        ssd_batch(n, seed, train, size=32))
    build_fcn = tp.build_fcn_program
    monkeypatch.setattr(tp, "build_fcn_program", lambda amp, infer:
                        build_fcn(amp, infer, size=16))
    monkeypatch.setattr(tp, "on_card", lambda feed: {
        k: torch.from_numpy(v) for k, v in feed.items()})
    recipes = {m: tp._recipe(m, amp=False) for m in tp.DETECT}
    for model, (fetch, main, startup, params, feed, items, unit) in \
            recipes.items():
        assert (items, unit) == (2, "images")
        assert set(feed) == ({"img"} if model in ("fcn-infer", "ssd-detect")
                             else {"img", "lab"} if model == "fcn"
                             else {"img", "gb", "gl"})
        exe = tfluid.Executor(CPU)
        scope = tp.train_scope(exe, startup, main, params, "cpu")
        assert exe.warm(main, tp.feed_sig(feed), fetch,
                        scope=scope) == "compiled"
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        assert exe.replays == 1 and all(np.isfinite(o).all() for o in out)
