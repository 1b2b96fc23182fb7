"""The port's ``ContinuousDecodeEngine.warm`` / ``trace_count`` and its
bucketed prefill against the JAX package's engine on the CPU, at
``test_torch_serving``'s sizes: warming prepares every signature and writes
only the trash block, a warmed engine serves the plain, preempt, spec and
sampled request sets with no new signature and the JAX scheduler's streams,
the prefill padded to its prompt bucket matches the JAX prefill around the
bucket edges, a lazily warmed engine serves what a warmed one does, and a
signature that cannot be prepared stops the scheduler."""
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jtf
from paddle_tpu.serving import ContinuousDecodeEngine as JaxEngine
from paddle_tpu.serving import ContinuousScheduler as JaxScheduler
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                      ContinuousScheduler, SamplingParams)
from paddle_tpu_torch.serving.decode import WarmError
from test_torch_serving import (CFG, ENG, LOGIT_ATOL, MATCH_FLOOR,
                                _match_rate, _requests, _serve)

KV_REL = 1e-5         # K/V written by prefill, of the arena's max abs


@pytest.fixture(scope="module")
def params():
    return jtf.init_lm_params(7, **CFG)


@pytest.fixture(scope="module")
def engines(params):
    """One JAX engine and one warmed port engine, shared by the tests that
    serve on them (each leaves the pool with every block free)."""
    te = ContinuousDecodeEngine(params, device="cpu", **ENG, **CFG)
    te.warm()
    return JaxEngine(params, **ENG, **CFG), te


def _n_signatures(eng):
    return len(eng.prompt_buckets) + 2 * len({1, max(1, eng.spec_window)})


def _leaves(pool):
    return list(pool) if isinstance(pool, tuple) else [pool]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_warm_prepares_every_signature_and_writes_only_trash(params,
                                                             kv_dtype):
    te = ContinuousDecodeEngine(params, device="cpu", kv_dtype=kv_dtype,
                                **ENG, **CFG)
    rng = np.random.RandomState(3)
    for leaf in _leaves(te.pool.k) + _leaves(te.pool.v):
        leaf.copy_(torch.as_tensor(
            rng.randint(-100, 100, tuple(leaf.shape))).to(leaf.dtype))
    before = [leaf.clone() for leaf in _leaves(te.pool.k)
              + _leaves(te.pool.v)]
    free = list(te.pool._free)
    assert te.trace_count() == 0
    assert te.warm() == len(te.prompt_buckets) + 4 == _n_signatures(te)
    assert te.trace_count() == _n_signatures(te)
    assert te.warm() == 0
    trash = te.pool.trash
    after = _leaves(te.pool.k) + _leaves(te.pool.v)
    for b, a in zip(before, after):
        assert torch.equal(a[:trash], b[:trash])
    assert not torch.equal(after[0][trash], before[0][trash])
    assert te.pool._free == free
    assert not te.step_dispatches and not te.prefill_dispatches


@pytest.mark.parametrize("arm", ["plain", "preempt", "spec", "sampled"])
def test_warmed_engine_serves_without_new_signatures(engines, arm):
    """``test_scheduler_streams_match_jax``'s request sets, served after
    ``warm()``: the JAX scheduler's streams (match >= 0.98), no leaked
    block, and ``trace_count()`` unchanged."""
    je, te = engines
    sched_kw, sampling, squeeze = {}, None, False
    reqs = _requests(3)
    if arm == "preempt":
        squeeze = True
        reqs = _requests(5, lo=10, hi=16)
    elif arm == "spec":
        sched_kw["spec"] = True
        reqs = [(np.tile(p[:4], 4), g) for p, g in reqs]
    elif arm == "sampled":
        sampling = [None if i % 3 else SamplingParams(
            temperature=0.8, top_k=8 * (i % 2), top_p=0.9, seed=77 + i
        ).to_record() for i in range(len(reqs))]
    traces = te.trace_count()
    _, jout = _serve(lambda e: JaxScheduler(e, **sched_kw), je, reqs,
                     sampling, squeeze=squeeze)
    ts, tout = _serve(lambda e: ContinuousScheduler(e, **sched_kw), te, reqs,
                      sampling, squeeze=squeeze)
    assert te.trace_count() == traces == _n_signatures(te)
    assert [t.size for t in tout] == [t.size for t in jout]
    assert _match_rate(tout, jout) >= MATCH_FLOOR
    assert ts.check_block_accounting() == {
        "free": te.pool.n_blocks, "occupied": 0, "leaked": 0}
    if arm == "preempt":
        assert ts.counters["preemptions"] > 0
    if arm == "spec":
        assert te.step_dispatches[ENG["spec_window"]] > 0


@pytest.mark.parametrize("tl", [7, 8, 9, 15, 16, 17])
def test_bucketed_prefill_matches_jax(engines, tl):
    """Lengths at, under and over the bucket edges 8 and 16: the port pads
    to the same bucket as the JAX engine, and the logits (atol 1e-4) and
    the K/V written at positions < tl (1e-5 of max abs) agree."""
    je, te = engines
    hist = np.random.RandomState(tl).randint(
        2, CFG["vocab_size"], tl).astype(np.int32)
    table = je._trash_table()
    table[:3] = [5, 2, 9]
    n0 = sum(te.prefill_dispatches.values())
    np.testing.assert_allclose(te.prefill(hist, table),
                               je.prefill(hist, table), atol=LOGIT_ATOL,
                               rtol=0)
    pb = min(b for b in te.prompt_buckets if b >= tl)
    assert sum(te.prefill_dispatches.values()) == n0 + 1
    assert te.prefill_dispatches[pb] >= 1
    pos = np.arange(tl)
    blk, off = table[pos // ENG["block_size"]], pos % ENG["block_size"]
    for tside, jside in ((te.pool.k, je.pool.k), (te.pool.v, je.pool.v)):
        got = tside.numpy()[blk, :, :, off]
        want = np.asarray(jside)[blk, :, :, off]
        assert np.abs(got - want).max() <= KV_REL * np.abs(want).max()


def test_lazy_engine_serves_the_warmed_streams(params, engines):
    """An engine that was never warmed prepares each signature at its
    first call and serves the same streams as the warmed one; ``warm()``
    afterwards prepares only the rest."""
    _, warmed = engines
    lazy = ContinuousDecodeEngine(params, device="cpu", **ENG, **CFG)
    reqs = _requests(17, n=6)
    sampling = [SamplingParams(temperature=0.9, top_p=0.8, seed=40 + i)
                if i % 2 else None for i in range(len(reqs))]
    outs = [_serve(ContinuousScheduler, e, reqs, sampling)[1]
            for e in (warmed, lazy)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    n = lazy.trace_count()
    assert 0 < n < _n_signatures(lazy)
    assert lazy.warm() == _n_signatures(lazy) - n


def test_failed_lazy_warm_stops_the_scheduler(params, monkeypatch):
    """A prefill signature whose first run raises is the engine's fault,
    not the request's: every waiter fails with the WarmError and the
    request's blocks go back to the pool."""
    def scatter_fails(*args, **kwargs):
        raise RuntimeError("scatter failed")

    monkeypatch.setattr(TA, "paged_cache_set_window", scatter_fails)
    te = ContinuousDecodeEngine(params, device="cpu", **ENG, **CFG)
    sched = ContinuousScheduler(te)
    hs = [sched.submit(p, g) for p, g in _requests(43, n=3)]
    with pytest.raises(WarmError, match="scatter failed"):
        sched.step()
    for h in hs:
        with pytest.raises(WarmError, match="prefill"):
            h.result(timeout=1)
    assert te.trace_count() == 0
    assert te.pool.blocks_free == te.pool.n_blocks
    assert sched.check_block_accounting()["leaked"] == 0
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit([1, 2], 3)
