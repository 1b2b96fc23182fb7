"""paddle_tpu_torch's ``layers.detection`` and ``evaluator.DetectionMAP``
against the JAX package on the CPU, mirroring
``tests/test_detection.py``'s detection tests (:26-184, :223-296) and
holding each op to the reference's values and gradients
(``run_both`` of ``test_torch_sequence_ops.py``: outputs within 1e-5 of
their scale, integers bitwise, gradients within 1e-4 of their max abs).
Besides: ``prior_box`` bitwise at SSD300's feature maps and others;
``ssd_loss``'s forced match, where a padded gt (IoU 0 everywhere, so its
best prior is prior 0) writes after a real gt that chose prior 0 and
unforces it, as the reference's scatter does on the CPU; a tie at the
hard-negative rank (the lower index first, as ``jnp.argsort``); and
``detection_output``'s whole arrays, empty slots included (the stable
top-k order among the zeroed scores)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.layers import detection as tdet
from test_torch_sequence_ops import assert_match, run_both

CPU = tfluid.CPUPlace()
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


def _exe(fl):
    exe = fl.Executor() if fl is jfluid else fl.Executor(CPU)
    exe.run(fl.default_startup_program())
    return exe


def _run(fl, build, feed):
    fl.reset_default_programs()
    outs = build(fl)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    return [np.asarray(a) for a in _exe(fl).run(feed=feed, fetch_list=outs)]


def _np_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0,
                                                       None)
    ab = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0,
                                                       None)
    union = aa[:, None] + ab[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _boxes(rng, n, lo=0.0, hi=1.0):
    c = rng.uniform(lo + 0.1, hi - 0.1, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def test_iou_similarity_matches_numpy_and_jax():
    """``test_iou_similarity``: against numpy, and against JAX with a
    batch on one side and on both, values and gradients."""
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 5), _boxes(rng, 3)
    got, = _run(tfluid, lambda fl: fl.layers.iou_similarity(
        fl.layers.data("x", [5, 4]), fl.layers.data("y", [3, 4])),
        {"x": a[None], "y": b[None]})
    np.testing.assert_allclose(got[0], _np_iou(a, b), rtol=1e-5, atol=1e-6)
    feeds = {"x": np.stack([a, _boxes(rng, 5)]),
             "y": np.stack([b, _boxes(rng, 3)])}
    assert_match(*run_both(lambda fl, v: fl.layers.iou_similarity(
        v["x"], v["y"]), feeds), grad_tol=GRAD_TOL)
    feeds["p"] = _boxes(rng, 6)       # unbatched priors against [2, 3, 4]
    assert_match(*run_both(
        lambda fl, v: fl.layers.iou_similarity(v["p"], v["y"]), feeds),
        grad_tol=GRAD_TOL)


# (feature map, image, min sizes, max sizes, aspect ratios, flip, clip,
# step, offset): SSD's two maps at S = 300 and S = 32, and the reference
# test's, and a flipped, stepped, unclipped one
PRIOR_CASES = [
    ((75, 75), (300, 300), [60.0], [120.0], (1.0,), False, True, 0.0, 0.5),
    ((38, 38), (300, 300), [150.0], [240.0], (1.0,), False, True, 0.0, 0.5),
    ((8, 8), (32, 32), [6.4], [12.8], (1.0,), False, True, 0.0, 0.5),
    ((4, 4), (32, 32), [8.0], [16.0], (1.0, 2.0), False, True, 0.0, 0.5),
    ((5, 7), (30, 45), [4.0, 9.0], [7.0], (1.0, 2.0, 3.0), True, False,
     6.5, 0.25),
]


@pytest.mark.parametrize("case", range(len(PRIOR_CASES)))
def test_prior_box_bitwise(case):
    """``test_prior_box_shapes_and_range``, and the boxes and variances
    bitwise equal to JAX's (the matching compares IoUs against them at
    0.5): the written order's roundings, which JAX's compiled step does
    not keep, lie up to 2 ulps off at a small difference of a centre and
    a half size."""
    fmap, img, mins, maxs, ars, flip, clip, step, offset = PRIOR_CASES[case]

    def build(fl):
        im = fl.layers.data("img", [3, *img])
        feat = fl.layers.data("feat", [8, *fmap])
        return fl.layers.prior_box(feat, im, min_sizes=mins, max_sizes=maxs,
                                   aspect_ratios=ars, flip=flip, clip=clip,
                                   step=step, offset=offset)

    feed = {"img": np.zeros((1, 3, *img), "float32"),
            "feat": np.zeros((1, 8, *fmap), "float32")}
    want = _run(jfluid, build, feed)
    got = _run(tfluid, build, feed)
    k = len(mins) * len(ars + tuple(1 / a for a in ars if flip and a != 1)) \
        + len(maxs)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (fmap[0] * fmap[1] * k, 4)
        np.testing.assert_array_equal(a, b)
    b = got[0]
    if clip:
        assert (b >= 0).all() and (b <= 1).all()
    assert (b[:, 2] >= b[:, 0]).all() and (b[:, 3] >= b[:, 1]).all()
    np.testing.assert_allclose(got[1][0], [0.1, 0.1, 0.2, 0.2], rtol=1e-6)


def test_box_coder_roundtrip_and_jax():
    """``test_box_coder_roundtrip``, and encode and decode against JAX,
    values and gradients."""
    rng = np.random.RandomState(1)
    P = 6
    priors = np.sort(rng.rand(P, 2), 0)
    priors = np.concatenate([priors * 0.5, priors * 0.5 + 0.3],
                            -1).astype("float32")
    pvar = np.full((P, 4), 0.1, "float32")
    gt = priors + rng.uniform(-0.05, 0.05, (P, 4)).astype("float32")

    def build(fl, v):
        enc = fl.layers.box_coder(v["p"], v["pv"], v["t"],
                                  "encode_center_size")
        return enc, fl.layers.box_coder(v["p"], v["pv"], enc,
                                        "decode_center_size")

    feeds = {"p": priors[None], "pv": pvar[None], "t": gt[None]}
    res = run_both(build, feeds)
    assert_match(*res, grad_tol=GRAD_TOL)
    np.testing.assert_allclose(res[1][1][0], gt, rtol=1e-4, atol=1e-5)


def _ssd_feeds(rng, N=2, P=8, C=4, G=3):
    priors = np.array([[i / P, i / P, i / P + 0.2, i / P + 0.2]
                       for i in range(P)], "float32")
    gtb = np.zeros((N, G, 4), "float32")
    gtl = np.zeros((N, G), "int32")
    gtb[0, 0] = [0.0, 0.0, 0.22, 0.22]
    gtl[0, 0] = 1
    if N > 1:
        gtb[1, 0] = [0.5, 0.5, 0.7, 0.7]
        gtl[1, 0] = 2
        gtb[1, 1] = [0.3, 0.35, 0.55, 0.5]
        gtl[1, 1] = 3
    return {"loc": rng.randn(N, P, 4).astype("float32") * 0.1,
            "conf": rng.randn(N, P, C).astype("float32"),
            "gb": gtb, "gl": gtl, "pr": priors[None],
            "pv": np.full((1, P, 4), 0.1, "float32")}


def _ssd_build(fl, v):
    return fl.layers.ssd_loss(v["loc"], v["conf"], v["gb"], v["gl"], v["pr"],
                              v["pv"])


def test_ssd_loss_matches_jax():
    """``test_ssd_loss_positive_and_sane`` (finite, positive, [N]) and the
    loss of each image and the gradients of the predictions, the gt boxes
    and the priors against JAX."""
    feeds = _ssd_feeds(np.random.RandomState(2))
    res = run_both(_ssd_build, feeds)
    assert_match(*res, grad_tol=GRAD_TOL)
    out = res[1][0]
    assert out.shape == (2,) and np.isfinite(out).all() and (out > 0).all()


def test_ssd_loss_forced_match_last_gt_wins():
    """Prior 0 is gt 0's best prior, and gt 0's IoU with it (0.19) is under
    the threshold; gts 1 and 2 are padding, score IoU 0 everywhere and so
    choose prior 0 too, after gt 0.  The reference's scatter lets the last
    write win on the CPU: prior 0 is not forced, no prior is positive, and
    the loss is the mined negatives' only.  The port does the same, on any
    device (``ssd_match_and_mine``), and matches JAX's loss and
    gradients; a rule that let the first (or any valid) write win would
    make prior 0 positive."""
    rng = np.random.RandomState(3)
    feeds = _ssd_feeds(rng, N=1, G=3)
    feeds["gb"][0] = 0.0
    feeds["gb"][0, 0] = [0.0, 0.0, 0.1, 0.1]
    feeds["gl"][0] = [2, 0, 0]
    p = torch.from_numpy(feeds["pr"][0])
    iou = tdet._iou_matrix(p, torch.from_numpy(feeds["gb"]))[0]
    assert int(iou[:, 0].argmax()) == 0 and float(iou[0, 0]) < 0.5
    pos, neg, match, _ = tdet.ssd_match_and_mine(
        torch.from_numpy(feeds["conf"]), torch.from_numpy(feeds["gb"]),
        torch.from_numpy(feeds["gl"]), p, 0.5, 3.0)
    assert not pos.any() and not neg.any() and int(match[0, 0]) == 0
    res = run_both(_ssd_build, feeds)
    assert_match(*res, grad_tol=GRAD_TOL)
    # the gt moved to the last slot: now it writes last and prior 0 is
    # forced positive, in both packages
    feeds["gb"][0] = feeds["gb"][0][[1, 2, 0]]
    feeds["gl"][0] = [0, 0, 2]
    pos, _, match, _ = tdet.ssd_match_and_mine(
        torch.from_numpy(feeds["conf"]), torch.from_numpy(feeds["gb"]),
        torch.from_numpy(feeds["gl"]), p, 0.5, 3.0)
    assert pos[0].tolist() == [True] + [False] * 7 and int(match[0, 0]) == 2
    res = run_both(_ssd_build, feeds)
    assert_match(*res, grad_tol=GRAD_TOL)


def test_ssd_loss_mining_tie_takes_the_lower_index():
    """Every negative prior has the same logits, so the same conf loss:
    the 3 x n_pos mined ones are the lowest indices, as ``jnp.argsort``
    orders a tie, which the conf gradient shows (it is zero on the
    negatives not mined)."""
    rng = np.random.RandomState(4)
    feeds = _ssd_feeds(rng, N=1, P=8, G=3)
    feeds["conf"][:] = [0.3, -0.2, 0.1, 0.4]
    res = run_both(_ssd_build, feeds)
    assert_match(*res, grad_tol=GRAD_TOL)
    pos, neg, _, _ = tdet.ssd_match_and_mine(
        torch.from_numpy(feeds["conf"]), torch.from_numpy(feeds["gb"]),
        torch.from_numpy(feeds["gl"]), torch.from_numpy(feeds["pr"][0]), 0.5,
        3.0)
    n_pos = int(pos.sum())
    negs = [i for i in range(8) if not pos[0, i]]
    assert neg[0].nonzero().flatten().tolist() == negs[:3 * n_pos]
    gconf = res[3][res[4].index("conf")][0]
    mined = (pos | neg)[0].numpy()
    assert (np.abs(gconf[~mined]).max() == 0) and np.abs(gconf[mined]).min() > 0


def test_ssd_loss_grads_flow():
    """``test_ssd_loss_grads_flow`` in the port: an fc predicts the
    locations and logits; 12 more SGD steps lower the loss."""
    N, P, C, G = 1, 4, 3, 2
    priors = np.array([[0, 0, 0.5, 0.5], [0.5, 0.5, 1, 1],
                       [0, 0.5, 0.5, 1], [0.5, 0, 1, 0.5]], "float32")
    L = tfluid.layers
    x = L.data("x", [8])
    loc = L.reshape(L.fc(x, P * 4), [-1, P, 4])
    conf = L.reshape(L.fc(x, P * C), [-1, P, C])
    gb = L.data("gb", [G, 4])
    gl = L.data("gl", [G], dtype="int32")
    pr = L.data("pr", [P, 4])
    pv = L.data("pv", [P, 4])
    loss = L.mean(L.ssd_loss(loc, conf, gb, gl, pr, pv))
    tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = _exe(tfluid)
    feed = {"x": np.ones((N, 8), "float32"),
            "gb": np.array([[[0, 0, 0.4, 0.4], [0.6, 0.6, 1, 1]]], "float32"),
            "gl": np.array([[1, 2]], "int32"),
            "pr": priors[None], "pv": np.full((N, P, 4), 0.1, "float32")}
    l1, = exe.run(feed=feed, fetch_list=[loss])
    for _ in range(12):
        l2, = exe.run(feed=feed, fetch_list=[loss])
    assert float(l2) < float(l1)


def _det_build(fl, v, **kw):
    return fl.layers.detection_output(v["loc"], v["conf"], v["pr"], v["pv"],
                                      **kw)


def test_detection_output_nms():
    """``test_detection_output_nms``: two overlapping high-score boxes
    and one apart, NMS keeps two, the survivors sorted by score; whole
    arrays equal to JAX's."""
    P, C = 3, 2
    priors = np.array([[0.1, 0.1, 0.3, 0.3], [0.11, 0.11, 0.31, 0.31],
                       [0.6, 0.6, 0.9, 0.9]], "float32")
    conf = np.zeros((1, P, C), "float32")
    conf[0, :, 1] = [5.0, 4.0, 6.0]
    feeds = {"loc": np.zeros((1, P, 4), "float32"), "conf": conf,
             "pr": priors[None], "pv": np.full((1, P, 4), 0.1, "float32")}
    res = run_both(lambda fl, v: _det_build(fl, v, nms_threshold=0.5,
                                            keep_top_k=3), feeds)
    assert_match(*res, grad_tol=GRAD_TOL)
    bb, ss, ll = res[1]
    assert (ll[0] >= 0).sum() == 2, (ss, ll)
    np.testing.assert_allclose(bb[0, 0], priors[2], atol=1e-5)
    np.testing.assert_allclose(bb[0, 1], priors[0], atol=1e-5)


@pytest.mark.parametrize("score_threshold", [0.01, 0.6])
def test_detection_output_whole_arrays(score_threshold):
    """Random predictions over 40 priors and 5 classes on 3 images, keep 12:
    boxes, scores and labels equal to JAX's in every slot, the empty ones
    (label -1, score 0) included.  At threshold 0.6 most scores are zeroed,
    so the stable order among equal zeros decides which boxes fill the
    slots; the scores' gradient too."""
    rng = np.random.RandomState(5)
    P, C = 40, 5
    priors = _boxes(rng, P)
    feeds = {"loc": (rng.randn(3, P, 4) * 0.2).astype("float32"),
             "conf": (rng.randn(3, P, C) * 1.5).astype("float32"),
             "pr": priors[None], "pv": np.full((1, P, 4), 0.1, "float32")}
    res = run_both(lambda fl, v: _det_build(
        fl, v, score_threshold=score_threshold, keep_top_k=12), feeds)
    assert_match(*res, grad_tol=GRAD_TOL)
    bb, ss, ll = res[1]
    empty = ll == -1
    assert empty.any() == (score_threshold == 0.6)
    assert (ss[empty] == 0).all() and (ss[~empty] > 0).all()
    np.testing.assert_array_equal(bb, res[0][0])


def test_roi_pool_matches_numpy_and_jax():
    """``test_roi_pool_matches_numpy`` (floor / ceil bin edges), and values
    and gradients against JAX, an ROI past the plane (an empty bin reads
    0) included."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 8, 8).astype("float32")
    rois = np.array([[0, 0, 0, 3, 3], [1, 2, 2, 7, 7]], "float32")
    got, = _run(tfluid, lambda fl: fl.layers.roi_pool(
        fl.layers.data("x", [3, 8, 8]), fl.layers.data("rois", [5]), 2, 2,
        spatial_scale=1.0), {"x": x, "rois": rois})
    for r, roi in enumerate(rois):
        bi, x1, y1, x2, y2 = [int(v) for v in roi]
        rw, rh = max(x2 - x1 + 1, 1), max(y2 - y1 + 1, 1)
        for i in range(2):
            for j in range(2):
                h0 = int(np.floor(i * rh / 2)) + y1
                h1 = int(np.ceil((i + 1) * rh / 2)) + y1
                w0 = int(np.floor(j * rw / 2)) + x1
                w1 = int(np.ceil((j + 1) * rw / 2)) + x1
                ref = x[bi, :, h0:h1, w0:w1].max((1, 2))
                np.testing.assert_allclose(got[r, :, i, j], ref, rtol=1e-5)
    rois = np.array([[0, 0, 0, 3, 3], [1, 2, 2, 7, 7], [1, 2.6, 1, 5, 6.4],
                     [0, 6, 6, 13, 13]], "float32")
    res = run_both(lambda fl, v: fl.layers.roi_pool(v["x"], v["rois"], 3, 2,
                                                    spatial_scale=0.8),
                   {"x": x, "rois": rois})
    assert_match(*res, grad_tol=GRAD_TOL)
    assert (res[1][0][3] == 0).any()


def test_detection_map_np():
    """``test_detection_map_np``: one TP at recall 1.0, one FP below it."""
    dets = [(np.array([[0, 0, 1, 1], [2, 2, 3, 3]], "float32"),
             np.array([0.9, 0.8], "float32"),
             np.array([1, 1], "int32"))]
    gts = [(np.array([[0, 0, 1, 1]], "float32"), np.array([1], "int32"))]
    m = tdet.detection_map_np(dets, gts, num_classes=2)
    assert 0.99 <= m <= 1.0 + 1e-6


def _det_vars(fl, K, G):
    L = fl.layers
    return (L.data("db", [K, 4]), L.data("ds", [K]),
            L.data("dl", [K], dtype="int32"), L.data("gb", [G, 4]),
            L.data("gl", [G], dtype="int32"))


def test_detection_map_evaluator_streaming_matches_np():
    """``test_detection_map_evaluator_streaming_matches_np``: the port's
    DetectionMAP over two batches (scores on bin centres, so the
    histogram's quantisation is exact) equals ``detection_map_np``, the
    JAX package's evaluator and the JAX ``detection_map_np``; ``reset``
    clears it."""
    from paddle_tpu.layers.detection import detection_map_np as jmap

    K, G, C = 3, 2, 3
    db1 = np.array([[[0, 0, 1, 1], [2, 2, 3, 3], [0, 0, 0, 0]]], "float32")
    ds1 = np.array([[0.905, 0.805, 0.0]], "float32")
    dl1 = np.array([[1, 1, 0]], "int32")
    gb1 = np.array([[[0, 0, 1, 1], [0, 0, 0, 0]]], "float32")
    gl1 = np.array([[1, 0]], "int32")
    db2 = np.array([[[5, 5, 6, 6], [1, 1, 2, 2], [0, 0, 0, 0]]], "float32")
    ds2 = np.array([[0.705, 0.305, 0.0]], "float32")
    dl2 = np.array([[2, 1, 0]], "int32")
    gb2 = np.array([[[5, 5, 6, 6], [0, 0, 0, 0]]], "float32")
    gl2 = np.array([[2, 0]], "int32")
    got = {}
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        ev = fl.evaluator.DetectionMAP(*_det_vars(fl, K, G), num_classes=C)
        exe = _exe(fl)
        for db, ds, dl, gb, gl in ((db1, ds1, dl1, gb1, gl1),
                                   (db2, ds2, dl2, gb2, gl2)):
            exe.run(feed={"db": db, "ds": ds, "dl": dl, "gb": gb, "gl": gl},
                    fetch_list=[])
        got[fl] = ev.eval()
        if fl is tfluid:
            ev.reset(exe)
            assert ev.eval() == 0.0
    dets = [(db1[0][:2], ds1[0][:2], dl1[0][:2]),
            (db2[0][:2], ds2[0][:2], dl2[0][:2])]
    gts = [(gb1[0][:1], gl1[0][:1]), (gb2[0][:1], gl2[0][:1])]
    ref = tdet.detection_map_np(dets, gts, num_classes=C)
    assert ref == jmap(dets, gts, num_classes=C)
    np.testing.assert_allclose(got[tfluid], ref, rtol=1e-6)
    assert got[tfluid] == got[jfluid]


def test_detection_map_evaluator_used_gt_is_fp():
    """``test_detection_map_evaluator_used_gt_is_fp``: a detection whose
    best-IoU gt is taken is a false positive even where a second gt clears
    the threshold (no fallback), as ``detection_map_np``."""
    K, G, C = 2, 2, 2
    gb = np.array([[[0, 0, 4, 4], [1, 0, 5, 4]]], "float32")
    gl = np.array([[1, 1]], "int32")
    db = np.array([[[0, 0, 4, 4], [0.5, 0, 4.2, 4]]], "float32")
    ds = np.array([[0.905, 0.805]], "float32")
    dl = np.array([[1, 1]], "int32")
    ev = tfluid.evaluator.DetectionMAP(*_det_vars(tfluid, K, G),
                                       num_classes=C)
    _exe(tfluid).run(feed={"db": db, "ds": ds, "dl": dl, "gb": gb, "gl": gl},
                     fetch_list=[])
    ref = tdet.detection_map_np([(db[0], ds[0], dl[0])], [(gb[0], gl[0])],
                                num_classes=C)
    np.testing.assert_allclose(ev.eval(), ref, rtol=1e-6)


def test_detection_map_histograms_match_jax():
    """Random dense detections on 4 images (padding, classes mixed,
    overlapping gts), streamed over two batches into both packages'
    evaluators: the TP, FP and gt-count histograms equal, and the mAP."""
    rng = np.random.RandomState(6)
    K, G, C = 12, 4, 4
    batches = []
    for _ in range(2):
        gb = np.stack([_boxes(rng, G) for _ in range(2)])
        gl = rng.randint(0, C, (2, G)).astype("int32")
        db = np.concatenate([gb + rng.uniform(-0.05, 0.05, gb.shape),
                             np.stack([_boxes(rng, K - G)
                                       for _ in range(2)])], 1)
        ds = rng.uniform(-0.2, 1.0, (2, K)).astype("float32")
        dl = rng.randint(-1, C, (2, K)).astype("int32")
        dl[:, :G] = gl
        batches.append({"db": db.astype("float32"), "ds": ds, "dl": dl,
                        "gb": gb, "gl": gl})
    hists, maps = {}, {}
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
        ev = fl.evaluator.DetectionMAP(*_det_vars(fl, K, G), num_classes=C)
        exe = _exe(fl)
        for feed in batches:
            exe.run(feed=feed, fetch_list=[])
        hists[fl] = [np.asarray(fl.global_scope().find_var(v.name))
                     for v in (ev.tp_hist, ev.fp_hist, ev.n_gt)]
        maps[fl] = ev.eval()
    for a, b in zip(hists[tfluid], hists[jfluid]):
        np.testing.assert_array_equal(a, b)
    assert hists[tfluid][0].sum() > 0 and hists[tfluid][1].sum() > 0
    assert maps[tfluid] == maps[jfluid]


@pytest.mark.parametrize("n_bins", [20, None])
def test_detection_map_at_most_exact_curve_at_evaluator_precision(n_bins):
    """DetectionMAP's histogram curve is a subset of the exact curve's
    points, so its mAP is at most ``chip_smoke._detection_map_f32``'s, the
    exact mAP with recall and precision in float32 as the evaluator (and
    the JAX package's) takes them; over random streams, scores on bin
    centres or raw on the default bins.  The float64 ``detection_map_np``
    reads less than the evaluator on some of them (a float64 recall of
    3 / 10 stays below the 11-point threshold 0.3), so it cannot bound it."""
    import chip_smoke

    torch.set_num_threads(1)
    rng = np.random.RandomState(1)
    C, K, G, B = 5, 12, 4, 4
    below_f64 = 0
    for _ in range(16):
        stream = []
        for _ in range(3):
            xy = rng.rand(B, G, 2).astype(np.float32) * 0.7
            gb = np.concatenate([xy, xy + 0.1 + rng.rand(B, G, 2).astype(
                np.float32) * 0.2], -1)
            pick = rng.randint(0, G, (B, K))
            db = np.clip(np.take_along_axis(gb, pick[..., None], 1)
                         + rng.randn(B, K, 4).astype(np.float32) * 0.04, 0, 1)
            ds = rng.rand(B, K).astype(np.float32)
            if n_bins is not None:
                ds = ((np.floor(ds * n_bins) + 0.5) / n_bins).astype(
                    np.float32)
            stream.append(dict(db=db, ds=ds,
                               dl=rng.randint(1, C, (B, K)).astype(np.int32),
                               gb=gb, gl=rng.randint(0, C, (B, G)).astype(
                                   np.int32)))
        mprog, mstart = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(mprog, mstart):
            ev = tfluid.evaluator.DetectionMAP(
                *_det_vars(tfluid, K, G), num_classes=C,
                **({} if n_bins is None else {"n_bins": n_bins}))
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(mstart, scope=scope)
        for f in stream:
            exe.run(mprog, feed=f, fetch_list=[], scope=scope)
        got = ev.eval(scope=scope)
        dets = [(f["db"][i], f["ds"][i], f["dl"][i]) for f in stream
                for i in range(B)]
        gts = [(f["gb"][i], f["gl"][i]) for f in stream for i in range(B)]
        assert got <= chip_smoke._detection_map_f32(dets, gts, C) + 1e-9
        below_f64 += got > tdet.detection_map_np(dets, gts, C) + 1e-6
    assert below_f64 > 0
