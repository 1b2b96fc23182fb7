"""The streaming evaluators ``Accuracy``, ``ChunkEvaluator``,
``PrecisionRecall`` and ``CTCError`` (``evaluator.py``), paddle_tpu_torch
against the JAX package on the CPU.

Each evaluator is built in both packages over the same data layers and
fed the same seeded numpy batches through each package's Executor: the
accumulators are held bitwise (their counts are integers in float32) and
``eval()`` within 1e-6; ties in the scores take JAX's order (``Accuracy``:
``lax.top_k``'s lower index first; ``PrecisionRecall``: the first
maximum), and a label outside [0, C) gives ``PrecisionRecall`` a zero
one-hot row, as ``jax.nn.one_hot`` does.  Then the reference's own checks
(``tests/test_evaluators.py:9-67``), and the accumulators as warmed state:
a warmed step's replays bitwise equal to an unwarmed eager step's, and
``reset()`` (``scope.set_var``) copied in by the next replay."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run (the suite's workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C, T, N = 4, 8, 6


def _scores(rng, n=N):
    """Scores on a coarse grid, so rows hold ties."""
    return (rng.randint(0, 4, (n, C)) / 4.0).astype(np.float32)


def _accuracy(fl):
    p = fl.layers.data("p", [C])
    lab = fl.layers.data("lab", [1], dtype="int32")
    return fl.evaluator.Accuracy(p, lab, k=2)


def _accuracy_batch(rng):
    return {"p": _scores(rng), "lab": rng.randint(0, C, (N, 1)).astype(
        np.int32)}


def _precision_recall(fl):
    p = fl.layers.data("p", [C])
    lab = fl.layers.data("lab", [1], dtype="int32")
    return fl.evaluator.PrecisionRecall(p, lab, num_classes=C)


def _precision_recall_batch(rng):
    # labels -1 and C are outside [0, C): a zero one-hot row in both
    return {"p": _scores(rng), "lab": rng.randint(-1, C + 1, (N, 1)).astype(
        np.int32)}


def _chunk(fl):
    p = fl.layers.data("tags", [T], dtype="int32")
    g = fl.layers.data("gold", [T], dtype="int32")
    ln = fl.layers.data("ln", [], dtype="int32")
    return fl.evaluator.ChunkEvaluator(p, g, ln)


def _chunk_batch(rng):
    return {"tags": rng.randint(-1, 6, (N, T)).astype(np.int32),
            "gold": rng.randint(-1, 6, (N, T)).astype(np.int32),
            "ln": rng.randint(1, T + 1, (N,)).astype(np.int32)}


def _ctc(fl):
    x = fl.layers.data("x", [T, C])
    xl = fl.layers.data("xl", [], dtype="int32")
    y = fl.layers.data("y", [5], dtype="int32")
    yl = fl.layers.data("yl", [], dtype="int32")
    return fl.evaluator.CTCError(x, y, xl, yl, blank=0)


def _ctc_batch(rng):
    return {"x": rng.randn(N, T, C).astype(np.float32),
            "xl": rng.randint(1, T + 1, (N,)).astype(np.int32),
            "y": rng.randint(1, C, (N, 5)).astype(np.int32),
            "yl": rng.randint(1, 6, (N,)).astype(np.int32)}


EVALUATORS = {"accuracy": (_accuracy, _accuracy_batch),
              "precision_recall": (_precision_recall,
                                   _precision_recall_batch),
              "chunk": (_chunk, _chunk_batch), "ctc_error": (_ctc,
                                                             _ctc_batch)}


def _stream(fl, name, n_batches=3, seed=0):
    """``name``'s evaluator built in ``fl``, fed ``n_batches`` batches:
    (its eval(), its accumulators as numpy)."""
    build, batch = EVALUATORS[name]
    fl.reset_default_programs()
    fl.reset_global_scope()
    ev = build(fl)
    exe = (fl.Executor(fl.CPUPlace()) if fl is tfluid else fl.Executor())
    exe.run(fl.default_startup_program())
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        exe.run(feed=batch(rng), fetch_list=[])
    states = [np.asarray(fl.global_scope().find_var(v.name))
              for v in ev._states]
    return ev.eval(exe), states


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_evaluator_matches_jax(name):
    want, wstates = _stream(jfluid, name)
    got, tstates = _stream(tfluid, name)
    for a, b in zip(tstates, wstates):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_accuracy_ties_take_the_lower_index():
    """Row [0.5, 0.5, 0.5, 0] with k=2 ranks classes 0 and 1, not 2."""
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    ev = _accuracy(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    p = np.array([[0.5, 0.5, 0.5, 0.0]] * 3, np.float32)
    exe.run(feed={"p": p, "lab": np.array([[0], [1], [2]], np.int32)},
            fetch_list=[ev.metric])
    assert ev.eval(exe) == pytest.approx(2 / 3)


def test_chunk_eval_matches_numpy():
    """``tests/test_evaluators.py:9`` mirrored."""
    from paddle_tpu_torch.layers.sequence import chunk_eval_np

    rng = np.random.RandomState(0)
    types = 3
    tags_p = rng.randint(-1, types * 2, (4, 12)).astype("int32")
    tags_g = rng.randint(-1, types * 2, (4, 12)).astype("int32")
    lens = rng.randint(1, 13, (4,)).astype("int32")
    tfluid.reset_default_programs()
    p = tfluid.layers.data("p", [12], dtype="int32")
    g = tfluid.layers.data("g", [12], dtype="int32")
    ln = tfluid.layers.data("ln", [], dtype="int32")
    out = tfluid.layers.sequence.chunk_eval(p, g, ln)
    exe = tfluid.Executor(tfluid.CPUPlace())
    got, = exe.run(feed={"p": tags_p, "g": tags_g, "ln": lens},
                   fetch_list=[out], scope=tfluid.Scope())
    prec, rec, _ = chunk_eval_np(tags_p, tags_g, lens)
    correct, n_pred, n_gold = got
    np.testing.assert_allclose(correct / max(n_pred, 1), prec, rtol=1e-6)
    np.testing.assert_allclose(correct / max(n_gold, 1), rec, rtol=1e-6)


def test_chunk_evaluator_streams_and_resets():
    """``tests/test_evaluators.py:34`` mirrored."""
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    p = tfluid.layers.data("p", [6], dtype="int32")
    g = tfluid.layers.data("g", [6], dtype="int32")
    ln = tfluid.layers.data("ln", [], dtype="int32")
    ev = tfluid.evaluator.ChunkEvaluator(p, g, ln)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    tags = np.array([[0, 1, -1, -1, -1, -1]], "int32")
    lens = np.array([6], "int32")
    exe.run(feed={"p": tags, "g": tags, "ln": lens}, fetch_list=[])
    exe.run(feed={"p": np.array([[2, 3, -1, -1, -1, -1]], "int32"),
                  "g": tags, "ln": lens}, fetch_list=[])
    prec, rec, _ = ev.eval(exe)
    assert abs(prec - 0.5) < 1e-6 and abs(rec - 0.5) < 1e-6
    ev.reset(exe)
    assert ev.eval(exe) == (0.0, 0.0, 0.0)


def test_precision_recall_evaluator_reference_case():
    """``tests/test_evaluators.py:52`` mirrored."""
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    ev = tfluid.evaluator.PrecisionRecall(
        tfluid.layers.data("p", [3]),
        tfluid.layers.data("lab", [1], dtype="int32"), num_classes=3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    probs = np.eye(3, dtype="float32")[[0, 1, 2, 0]]
    labs = np.array([[0], [1], [2], [1]], "int32")
    exe.run(feed={"p": probs, "lab": labs}, fetch_list=[])
    prec, rec, _ = ev.eval(exe)
    np.testing.assert_allclose(prec, (0.5 + 1 + 1) / 3, rtol=1e-5)
    np.testing.assert_allclose(rec, (1 + 0.5 + 1) / 3, rtol=1e-5)


def test_evaluators_as_warmed_state_and_reset():
    """The four evaluators in one program (``tools/layer_cases.py``'s
    ``evaluator_program``, as the chip script runs it), warmed: each of 6
    replays bitwise equal to an unwarmed eager step on the same batches,
    ``reset()`` after the third zeroes the accumulators and the next
    replay copies the zeros in, so both runs restart from zero; the JAX
    package's accumulators on the same batches and resets bitwise equal."""
    from paddle_tpu_torch.tools.layer_cases import (evaluator_batch,
                                                    evaluator_program)
    from paddle_tpu_torch.tools.train_profile import feed_sig

    rng = np.random.RandomState(4)
    batches = [evaluator_batch(rng) for _ in range(6)]
    runs = []
    for warm in (True, False):
        main, startup, evs, fetch = evaluator_program(tfluid)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        if warm:
            assert exe.warm(main, feed_sig(batches[0]), fetch,
                            scope=scope) == "compiled"
        states = []
        for i, b in enumerate(batches):
            exe.run(main, feed=b, fetch_list=fetch, scope=scope)
            states.append([scope.find_var(v.name).clone()
                           for e in evs for v in e._states])
            if i == 2:
                for e in evs:
                    e.reset(exe, scope)
                assert all((scope.find_var(v.name) == 0).all()
                           for e in evs for v in e._states)
        assert exe.replays == (6 if warm else 0)
        runs.append(states)
    for sw, se in zip(*runs):
        for a, b in zip(sw, se):
            assert torch.equal(a, b)
    # after the reset the fourth step counts its own batch only
    n = batches[3]["p"].shape[0]
    assert float(runs[0][3][1][0]) == n and float(runs[0][2][1][0]) == 3 * n
    main, startup, evs, fetch = evaluator_program(jfluid)
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    for i, b in enumerate(batches):
        exe.run(main, feed=b, fetch_list=[f.name for f in fetch],
                scope=scope)
        want = [np.asarray(scope.find_var(v.name))
                for e in evs for v in e._states]
        for a, w in zip(runs[0][i], want):
            np.testing.assert_array_equal(a.numpy(), w)
        if i == 2:
            for e in evs:
                e.reset(exe, scope)


def test_evaluator_names_match_the_reference():
    """``evaluator.py``'s six public classes equal the reference's."""
    import paddle_tpu.evaluator as jev
    import paddle_tpu_torch.evaluator as tev

    def classes(mod):
        return {n for n, v in vars(mod).items()
                if isinstance(v, type) and v.__module__ == mod.__name__}

    assert classes(tev) == classes(jev)
    assert len(classes(tev)) == 6 and set(tev.__all__) == classes(tev)
