"""paddle_tpu_torch's CTC (``warpctc``, ``ctc_greedy_decoder``) and
``edit_distance`` against the JAX package on the CPU, through the harness
of ``test_torch_sequence_ops.py``: the CTC NLL within 1e-5 relative and
its gradient for the logits within 1e-5 of max abs, with
``norm_by_times`` (the value unnormalised, the gradient divided by T), a
zero-length label, repeated labels, labels as [B, L, 1] and another blank;
``F.ctc_loss`` as a yardstick for the value (as the JAX package's own test
uses it); the greedy decoder bitwise; the edit distance, normalised and
not, within 1e-6 and against a plain dynamic programme."""
import numpy as np
import pytest
import torch

from test_torch_sequence_ops import assert_match, run_both


def _ctc_build(blank=0, norm_by_times=False):
    def build(fl, v):
        return fl.layers.warpctc(v["x"], v["lab"], v["ll"], v["tl"],
                                 blank=blank, norm_by_times=norm_by_times)
    return build


def _ctc_feed(B, T, C, L, seed, lablen=None, labels=None, blank=0,
              label_3d=False):
    rng = np.random.RandomState(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    ids = [c for c in range(C) if c != blank]
    lab = (np.asarray(labels, np.int32) if labels is not None
           else rng.choice(ids, (B, L)).astype(np.int32))
    lablen = (np.asarray(lablen, np.int32) if lablen is not None
              else rng.randint(1, L + 1, (B,)).astype(np.int32))
    # frames enough for each label with its repeats separated by blanks
    need = np.array([lablen[b] + np.sum(lab[b, 1:lablen[b]]
                                        == lab[b, :lablen[b] - 1])
                     for b in range(B)])
    loglen = np.maximum(need, rng.randint(1, T + 1, (B,))).astype(np.int32)
    if label_3d:
        lab = lab[..., None]
    return {"x": logits, "lab": lab, "ll": loglen, "tl": lablen}


CTC_CASES = {
    "plain": (dict(B=4, T=9, C=5, L=3, seed=3), {}),
    "norm_by_times": (dict(B=4, T=9, C=5, L=3, seed=4),
                      dict(norm_by_times=True)),
    "zero_length_label": (dict(B=3, T=6, C=4, L=2, seed=5, lablen=[0, 2, 1]),
                          {}),
    "repeated_labels": (dict(B=3, T=8, C=4, L=3, seed=6, lablen=[3, 3, 2],
                             labels=[[2, 2, 3], [1, 1, 1], [3, 3, 1]]), {}),
    "labels_3d_blank_2": (dict(B=3, T=7, C=5, L=2, seed=7, blank=2,
                               label_3d=True), dict(blank=2)),
}


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_warpctc_matches_jax(case):
    kw, attrs = CTC_CASES[case]
    feeds = _ctc_feed(**kw)
    want, got, jg, tg, names = run_both(_ctc_build(**attrs), feeds)
    assert want[0].shape == (feeds["x"].shape[0], 1)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert_match(want, got, jg, tg, names)
    assert names == ["x"]
    # the yardstick: torch's own CTC on the same log-probabilities
    lab = feeds["lab"].reshape(feeds["lab"].shape[:2])
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(feeds["x"]), -1).transpose(0, 1),
        torch.from_numpy(lab.astype(np.int64)),
        torch.from_numpy(feeds["ll"].astype(np.int64)),
        torch.from_numpy(feeds["tl"].astype(np.int64)),
        blank=attrs.get("blank", 0), reduction="none")
    np.testing.assert_allclose(got[0][:, 0], ref.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_warpctc_norm_by_times_scales_only_the_gradient():
    """The value with ``norm_by_times`` is the plain one (up to the
    rounding of nll / T + (nll - nll / T), which the JAX package shares),
    and each row's gradient is the plain one divided by the row's T."""
    feeds = _ctc_feed(B=4, T=9, C=5, L=3, seed=4)
    _, plain, _, g_plain, _ = run_both(_ctc_build(), feeds)
    _, normed, _, g_norm, _ = run_both(_ctc_build(norm_by_times=True), feeds)
    np.testing.assert_allclose(normed[0], plain[0], rtol=1e-6)
    T = np.maximum(feeds["ll"], 1).astype(np.float32)[:, None, None]
    np.testing.assert_allclose(g_norm[0], g_plain[0] / T, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("seed,blank", [(1, 0), (2, 0), (3, 2)])
def test_ctc_greedy_decoder_matches_jax(seed, blank):
    """Ids left-packed and padded with -1, and the lengths, int32 and
    bitwise equal; lengths include 0 and T."""
    rng = np.random.RandomState(seed)
    B, T, C = 5, 8, 4
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    logits[1, :, blank] += 10.0                 # an all-blank row
    ln = np.array([T, 0, 1, 5, T], np.int32)
    want, got, jg, tg, names = run_both(
        lambda fl, v: list(fl.layers.ctc_greedy_decoder(v["x"], v["ln"],
                                                        blank=blank)),
        {"x": logits, "ln": ln})
    assert [a.dtype for a in got] == [np.int32, np.int32]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for b in range(B):
        path = logits[b, :ln[b]].argmax(-1)
        exp = [int(p) for i, p in enumerate(path)
               if p != blank and (i == 0 or p != path[i - 1])]
        assert list(got[0][b][:got[1][b]]) == exp
        assert np.all(got[0][b][got[1][b]:] == -1)


def _lev_np(a, b):
    H, R = len(a), len(b)
    d = np.zeros((H + 1, R + 1))
    d[:, 0] = np.arange(H + 1)
    d[0, :] = np.arange(R + 1)
    for i in range(1, H + 1):
        for j in range(1, R + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    return d[H, R]


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_matches_jax(normalized):
    rng = np.random.RandomState(2)
    B, H, R = 6, 7, 6
    hyp = rng.randint(0, 4, (B, H)).astype(np.int32)
    ref = rng.randint(0, 4, (B, R)).astype(np.int32)
    hlen = np.array([0, 7, 3, 1, 5, 7], np.int32)
    rlen = np.array([6, 0, 2, 6, 1, 4], np.int32)
    want, got, jg, tg, names = run_both(
        lambda fl, v: fl.layers.edit_distance(v["h"], v["hl"], v["r"],
                                              v["rl"], normalized=normalized),
        {"h": hyp, "hl": hlen, "r": ref, "rl": rlen})
    assert got[0].shape == (B, 1) and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    exp = np.array([_lev_np(hyp[b, :hlen[b]], ref[b, :rlen[b]])
                    for b in range(B)])
    if normalized:
        exp = exp / np.maximum(rlen, 1)
    np.testing.assert_allclose(got[0][:, 0], exp, rtol=1e-6)
