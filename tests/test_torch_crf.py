"""paddle_tpu_torch's linear-chain CRF (``linear_chain_crf``,
``crf_decoding``) and chunk counting (``chunk_eval``, ``chunk_eval_np``)
against the JAX package on the CPU, through the harness of
``test_torch_sequence_ops.py``: the NLL within 1e-5 relative and its
gradient for the emissions and the transition within 2e-5 of max abs, on
ragged lengths (1, T and between), labels as [B, T] and [B, T, 1] and
out-of-range ids (clamped as JAX's gather clamps them); the Viterbi tags
equal on whole arrays, padding included, on random and on tied scores
(each argmax takes the first maximum); the JAX test's brute-force check
(``tests/test_sequence.py::test_linear_chain_crf_nll_and_decode``)
mirrored; the chunk counts against JAX's and against ``chunk_eval_np``."""
import itertools

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from test_torch_sequence_ops import assert_match, run_both

CRF_GRAD_TOL = 2e-5


def _crf_build(label_3d=False):
    def build(fl, v):
        attr = fl.ParamAttr(name="crf_w")
        nll = fl.layers.linear_chain_crf(v["e"], v["lab"], v["len"],
                                         param_attr=attr)
        path = fl.layers.crf_decoding(v["e"], v["len"], param_attr=attr)
        return [nll, path]
    return build


def _crf_feed(B, T, N, lengths, seed, label_3d=False, lo=0, hi=None,
              ties=False):
    rng = np.random.RandomState(seed)
    emis = (rng.randint(0, 2, (B, T, N)).astype(np.float32) if ties
            else rng.standard_normal((B, T, N)).astype(np.float32))
    lab = rng.randint(lo, N if hi is None else hi, (B, T)).astype(np.int32)
    if label_3d:
        lab = lab[..., None]
    return {"e": emis, "lab": lab,
            "len": np.asarray(lengths, np.int32)}


CRF_CASES = {
    "ragged": dict(B=4, T=7, N=5, lengths=[1, 7, 3, 5]),
    "labels_3d": dict(B=3, T=6, N=4, lengths=[6, 2, 1], label_3d=True),
    "clamped_ids": dict(B=3, T=5, N=4, lengths=[5, 4, 2], lo=-3, hi=7),
    "srl_tags": dict(B=2, T=12, N=59, lengths=[12, 9]),
}


@pytest.mark.parametrize("case", sorted(CRF_CASES))
def test_crf_nll_gradient_and_decode_match_jax(case):
    kw = dict(CRF_CASES[case])
    label_3d = kw.pop("label_3d", False)
    feeds = _crf_feed(seed=len(case), label_3d=label_3d, **{
        k: kw[k] for k in kw if k in ("B", "T", "N", "lengths", "lo",
                                      "hi")})
    want, got, jg, tg, names = run_both(_crf_build(label_3d), feeds,
                                        param_scale=0.5)
    assert want[0].shape == (feeds["e"].shape[0], 1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert_match(want, got, jg, tg, names, grad_tol=CRF_GRAD_TOL)
    assert names == ["e", "crf_w"]
    assert want[1].dtype == np.int32


@pytest.mark.parametrize("seed", range(3))
def test_viterbi_first_maximum_on_ties(seed):
    """Emissions and transitions of 0 and 1: many paths tie exactly, and
    both packages keep the first maximum at every step, so the tags (and
    the NLL) agree on whole arrays."""
    feeds = _crf_feed(4, 6, 3, [6, 1, 4, 3], seed, ties=True)
    trans = np.random.RandomState(10 + seed).randint(0, 2, (5, 3)).astype(
        np.float32)
    want, got, jg, tg, names = run_both(_crf_build(), feeds,
                                        params={"crf_w": trans})
    assert_match(want, got, jg, tg, names, grad_tol=CRF_GRAD_TOL)


def test_crf_brute_force():
    """``tests/test_sequence.py::test_linear_chain_crf_nll_and_decode`` on
    the port: for sequence 1 (length 3) the Viterbi path is the best of
    all tag sequences and the NLL is logZ - gold by enumeration."""
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    B, T, N = 3, 5, 4
    rng = np.random.RandomState(5)
    emis = rng.randn(B, T, N).astype("float32")
    lab = rng.randint(0, N, (B, T)).astype("int32")
    ln = np.array([5, 3, 4], "int32")
    seq = tfluid.layers
    ev = seq.data("e", [T, N])
    labv = seq.data("lab", [T], dtype="int32")
    lv = seq.data("len", [-1], dtype="int32", append_batch_size=False)
    nll = seq.linear_chain_crf(ev, labv, lv,
                               param_attr=tfluid.ParamAttr(name="crf_w"))
    path = seq.crf_decoding(ev, lv, param_attr=tfluid.ParamAttr(name="crf_w"))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    nll_v, path_v = exe.run(feed={"e": emis, "lab": lab, "len": ln},
                            fetch_list=[nll, path])
    assert nll_v.shape == (B, 1) and path_v.shape == (B, T)
    assert np.all(nll_v >= -1e-4), "NLL must be nonnegative"
    trans = tfluid.global_scope().find_var("crf_w").numpy()
    start, end, trs = trans[0], trans[1], trans[2:]
    b, L = 1, 3
    scores = {}
    for tags in itertools.product(range(N), repeat=L):
        s = start[tags[0]] + emis[b, 0, tags[0]]
        for t in range(1, L):
            s += trs[tags[t - 1], tags[t]] + emis[b, t, tags[t]]
        s += end[tags[-1]]
        scores[tags] = s
    best = max(scores, key=scores.get)
    np.testing.assert_array_equal(path_v[b, :L], best)
    # padded steps carry the row's last tag
    assert np.all(path_v[b, L:] == path_v[b, L - 1])
    log_z = np.log(np.sum(np.exp(np.array(list(scores.values())))))
    np.testing.assert_allclose(float(nll_v[b, 0]),
                               log_z - scores[tuple(lab[b, :L])], rtol=1e-4)


def _chunk_tags(N, T, n_types, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(-1, 2 * n_types, (N, T)).astype(np.int32),
            rng.randint(-1, 2 * n_types, (N, T)).astype(np.int32),
            rng.randint(0, T + 1, (N,)).astype(np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_chunk_eval_matches_jax_and_chunk_eval_np(seed):
    """The in-graph counts (correct, predicted, labelled) equal JAX's, float32
    [3]; precision and recall from them equal ``chunk_eval_np``'s, in both
    packages; a prediction equal to the labels scores F1 1."""
    pred, gold, ln = _chunk_tags(6, 9, 3, seed)
    pred[0] = gold[0]           # one row right
    want, got, jg, tg, names = run_both(
        lambda fl, v: fl.layers.chunk_eval(v["p"], v["g"], v["n"]),
        {"p": pred, "g": gold, "n": ln})
    assert_match(want, got, jg, tg, names)
    assert got[0].dtype == np.float32 and got[0].shape == (3,)
    np.testing.assert_array_equal(got[0], want[0])
    correct, n_pred, n_lab = (float(c) for c in got[0])
    port = tfluid.layers.chunk_eval_np(pred, gold, ln)
    assert port == jfluid.layers.sequence.chunk_eval_np(pred, gold, ln)
    assert port[0] == pytest.approx(correct / max(n_pred, 1))
    assert port[1] == pytest.approx(correct / max(n_lab, 1))
    assert tfluid.layers.chunk_eval_np(gold, gold, ln)[2] in (0.0, 1.0)
