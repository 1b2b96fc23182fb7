"""paddle_tpu_torch's OCR line recognizer (``models.ocr_ctc``: two convs,
``im2sequence`` over the whole height, ``nets.bidirectional_gru``, an fc,
``warpctc`` and ``ctc_greedy_decoder``) against the JAX package's on the
CPU: ``synthetic_lines`` draw for draw, the program's names and ops, one
step's loss and gradients, five Adam steps, the greedy decode, the JAX
test's learning check, the train step and the pruned decode warmed
against eager (the decode's two convs routed onto the conv kernel's plain
version), and ``tools/train_profile.py``'s recipes."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.ocr_ctc as jocr
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.fusion import route_inference
from paddle_tpu_torch.tools import train_profile as tp

CPU = tfluid.CPUPlace()
B = 16
LOSS_REL = 1e-4
GRAD_TOL = 1e-4


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


def _build(fl):
    """The JAX test's program (8x32 lines, 4 classes, hidden 48) with
    Adam(5e-3), in ``fl``'s fresh default programs: (loss, ids, lengths,
    logits)."""
    fl.reset_default_programs()
    L = fl.layers
    img = L.data("img", [1, 8, 32])
    lab = L.data("lab", [4], dtype="int32")
    ll = L.data("ll", [-1], dtype="int32", append_batch_size=False)
    loss, (ids, lens), logits = fl.models.ocr_ctc.build(img, lab, ll,
                                                        num_classes=4)
    fl.optimizer.Adam(5e-3).minimize(loss)
    return loss, ids, lens, logits


def _feed(n=B, seed=0, train=True):
    imgs, labels, lens = jocr.synthetic_lines(n, seed=seed)
    return ({"img": imgs, "lab": labels, "ll": lens} if train
            else {"img": imgs})


def _jax_start():
    jfluid.reset_global_scope()
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    return exe, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_start(weights):
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    return exe


@pytest.mark.parametrize("n,seed", [(48, 0), (7, 3)])
def test_synthetic_lines_matches_jax(n, seed):
    """The port's own copy of ``synthetic_lines`` draws the JAX package's
    images, labels and lengths bitwise."""
    for a, b in zip(tfluid.models.ocr_ctc.synthetic_lines(n, seed=seed),
                    jocr.synthetic_lines(n, seed=seed)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_program_matches_jax():
    """The same parameters in order, persistable names and shapes, and op
    types (JAX's reduce layers shadow their op type with their ``name``
    argument, None, where the port's op is ``reduce_mean``)."""
    _build(jfluid)
    _build(tfluid)
    jp, tp_ = jfluid.default_main_program(), tfluid.default_main_program()
    assert [p.name for p in tp_.parameters()] == [p.name
                                                  for p in jp.parameters()]
    assert {v.name: tuple(v.shape) for v in tp_.persistable_vars()} == {
        v.name: tuple(v.shape) for v in jp.persistable_vars()}
    types = [o.type for o in tp_.list_ops()]
    assert types == [o.type or "reduce_mean" for o in jp.list_ops()]
    assert types.count("dynamic_gru") == 2
    assert "fill_constant_batch_size_like" in types


def test_one_step_loss_and_gradients_match_jax():
    """One step from the JAX startup's weights on 16 lines: the loss
    within 1e-5 relative and every gradient within 1e-4 of its max
    abs."""
    jl, jids, jlens, _ = _build(jfluid)
    params = [p.name for p in jfluid.default_main_program().parameters()]
    fetch = [f"{n}@GRAD" for n in params]
    jexe, weights = _jax_start()
    feed = _feed()
    want = [np.asarray(a) for a in jexe.run(
        feed=feed, fetch_list=[jl, jids, jlens] + fetch)]
    tl, tids, tlens, _ = _build(tfluid)
    got = _port_start(weights).run(feed=feed,
                                   fetch_list=[tl, tids, tlens] + fetch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch, got[3:], want[3:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= GRAD_TOL * scale, name


def _train(fl, loss, exe, steps, feed):
    return [float(np.asarray(exe.run(feed=feed, fetch_list=[loss])[0]))
            for _ in range(steps)]


def test_five_adam_steps_and_decode_match_jax():
    """Five Adam(5e-3) steps from the same weights on 16 lines: each loss
    within 1e-4 relative of JAX's.  Then both packages decode 32 other
    lines from JAX's trained state: the logits within 1e-5 of their max
    abs, the per-step argmax equal wherever the top two logits are further
    apart than twice the largest logit difference, and each line whose
    every step is that clear decoded to the same ids and length."""
    jl, jids, jlens, jlog = _build(jfluid)
    jexe, weights = _jax_start()
    feed = _feed()
    want = _train(jfluid, jl, jexe, 5, feed)
    trained = {n: np.asarray(v) for n, v in jfluid.global_scope().items()}
    tl, tids, tlens, tlog = _build(tfluid)
    texe = _port_start(weights)
    got = _train(tfluid, tl, texe, 5, feed)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    assert got[-1] < got[0]

    test = _feed(32, seed=1)
    jprog = jfluid.default_main_program().prune([jids, jlens, jlog])
    j_ids, j_lens, j_log = (np.asarray(a) for a in jexe.run(
        jprog, feed=test, fetch_list=[jids, jlens, jlog]))
    tprog = tfluid.default_main_program().prune([tids, tlens, tlog])
    scope = tfluid.Scope()
    texe.run(tfluid.default_startup_program(), scope=scope)
    tfluid.load_scope(trained, tprog, scope, device="cpu")
    t_ids, t_lens, t_log = texe.run(tprog, feed=test,
                                    fetch_list=[tids, tlens, tlog],
                                    scope=scope)
    err = float(np.abs(t_log - j_log).max())
    assert err <= 1e-5 * np.abs(j_log).max()
    top2 = np.sort(j_log, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * err
    assert np.array_equal(t_log.argmax(-1)[clear], j_log.argmax(-1)[clear])
    rows = clear.all(axis=1)
    assert rows.sum() >= 16
    np.testing.assert_array_equal(t_ids[rows], j_ids[rows])
    np.testing.assert_array_equal(t_lens[rows], j_lens[rows])


def test_ocr_ctc_learns_glyph_sequences():
    """``tests/test_models.py::test_ocr_ctc_learns_glyph_sequences`` on the
    port: 150 Adam(5e-3) steps on 48 lines, the loss below 0.3 x the
    first, and at least 24 of the 48 lines decoded to exactly their glyph
    ids."""
    imgs, labels, lens = tfluid.models.ocr_ctc.synthetic_lines(48)
    loss, ids, out_lens, _ = _build(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    feed = {"img": imgs, "lab": labels, "ll": lens}
    first = last = None
    for _ in range(150):
        last = float(exe.run(feed=feed, fetch_list=[loss])[0])
        first = last if first is None else first
    assert last < first * 0.3, (first, last)
    got, n = exe.run(feed=feed, fetch_list=[ids, out_lens])
    ok = sum(1 for b in range(48)
             if n[b] == 4 and (got[b, :4] == labels[b]).all())
    assert ok >= 24, f"only {ok}/48 lines decoded exactly"


# ------------------------------------------------------------ warm


def _warm_against_eager(build, weights, feeds):
    """``feeds`` through the program ``build()`` makes ((program, fetch
    list)) by an Executor that warmed its signature and by one that did
    not, from the same weights: every fetch of every run and every state
    tensor after the last bitwise equal.  Returns the warmed fetches."""
    runs = []
    for warm in (True, False):
        tfluid.reset_default_programs()
        main, fetch = build()
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        tfluid.load_scope(weights, main, scope, device="cpu")
        if warm:
            assert exe.warm(main, tp.feed_sig(feeds[0]), fetch,
                            scope=scope) == "compiled"
        outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                for f in feeds]
        assert exe.replays == (len(feeds) if warm else 0)
        runs.append((outs, {n: v.clone() for n, v in scope.items()}))
    (ow, sw), (oe, se) = runs
    for a, b in zip(ow, oe):
        assert [x.tobytes() for x in a] == [y.tobytes() for y in b]
    assert set(sw) == set(se)
    assert all(torch.equal(sw[n], se[n]) for n in sw)
    return ow


def test_warmed_train_and_decode_bitwise_equal_eager():
    """Three warmed train steps (the loss and every gradient, then every
    parameter, moment and optimizer step) and the program pruned to the
    decode warmed (two batches), bitwise equal to eager runs.  The
    decode's two 3x3 convs (1 -> 16 and 16 -> 32 channels) are routed
    onto the conv kernel (its plain version here) and the fed lines put
    into channels_last; its ids equal JAX's."""
    _, jids, jlens, _ = _build(jfluid)
    jexe, weights = _jax_start()
    params = [p.name for p in jfluid.default_main_program().parameters()]

    def train():
        loss = _build(tfluid)[0]
        return (tfluid.default_main_program(),
                [loss] + [f"{n}@GRAD" for n in params])
    _warm_against_eager(train, weights, [_feed(seed=i) for i in range(3)])

    feeds = [_feed(seed=i, train=False) for i in (3, 4)]

    def decode():
        _, ids, lens, _ = _build(tfluid)
        main = tfluid.default_main_program().prune([ids, lens])
        routed = route_inference(main, [ids.name, lens.name])
        assert sum(o.fn.__name__ == "_igemm_fn" for o in routed) == 2
        assert {o.type for o in main.list_ops()}.isdisjoint(
            {"warpctc", "adam"})
        return main, [ids, lens]
    outs = _warm_against_eager(decode, weights, feeds)
    jprog = jfluid.default_main_program().prune([jids, jlens])
    for f, o in zip(feeds, outs):
        want = jexe.run(jprog, feed=f, fetch_list=[jids, jlens])
        np.testing.assert_array_equal(o[0], np.asarray(want[0]))
        np.testing.assert_array_equal(o[1], np.asarray(want[1]))


def test_train_profile_ocr_recipes_run_on_the_cpu():
    """The ``ocr_ctc`` and ``ocr_ctc-decode`` recipes on the CPU: 256
    lines of ``synthetic_lines(256, seed=0)``, the warmed steps replay,
    the decode program holds no CTC loss op, and its fetches are the ids
    and lengths."""
    for model in tp.OCR:
        fetch, main, startup, params, feed, items, unit = tp._recipe(model)
        assert (items, unit) == (tp.OCR_BATCH, "lines")
        assert feed["img"].shape == (tp.OCR_BATCH, 1, 8, 32)
        assert ("lab" in feed) == (model == "ocr_ctc")
        exe = tfluid.Executor(CPU)
        scope = tp.train_scope(exe, startup, main, params, "cpu")
        assert exe.warm(main, tp.feed_sig(feed), fetch,
                        scope=scope) == "compiled"
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        assert exe.replays == 1
        if model == "ocr_ctc":
            assert np.isfinite(out[0])
        else:
            assert out[0].shape == (tp.OCR_BATCH, 16) and out[1].shape == (
                tp.OCR_BATCH,)
            assert "warpctc" not in {o.type for o in main.list_ops()}
    np.testing.assert_array_equal(tp.ocr_batch()["img"],
                                  jocr.synthetic_lines(tp.OCR_BATCH)[0])


def test_ocr_entry_points_default_to_the_card():
    """No fallback: the Executor that runs the ocr_ctc programs and their
    profile take the CUDA card when none is named, and raise without
    one."""
    _build(tfluid)
    if torch.cuda.is_available():
        assert tfluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        tfluid.Executor()
    for model in tp.OCR:
        with pytest.raises(RuntimeError):
            tp.profile(model)
