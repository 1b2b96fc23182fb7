"""paddle_tpu_torch's continuous-batching serving path against the JAX
package's ``ContinuousDecodeEngine`` / ``ContinuousScheduler`` on the CPU, on
the same weights and the same request sets: teacher-forced step logits,
greedy token streams under staggered joins, pool-pressure preemption, the
speculative window and an int8 pool, and zero leaked blocks.  Then the
port's own host logic: the pool's free guard, admission tiering and aging,
deadlines, sampled-stream determinism and the background loop."""
import time

import numpy as np
import pytest

from paddle_tpu.models import transformer as jtf
from paddle_tpu.serving import ContinuousDecodeEngine as JaxEngine
from paddle_tpu.serving import ContinuousScheduler as JaxScheduler
from paddle_tpu_torch.resilience import Deadline, DeadlineExceeded
from paddle_tpu_torch.serving import (AdmissionShed, ContinuousDecodeEngine,
                                      ContinuousScheduler,
                                      DecodeAdmissionQueue, PagedKVPool,
                                      SamplingParams)

CFG = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
           d_ff=64)
ENG = dict(n_slots=4, block_size=8, prompt_buckets=(8, 16), spec_window=4)
LOGIT_ATOL = 1e-4     # float32 sums in another order
MATCH_FLOOR = 0.98    # greedy token-match rate against the JAX engine


@pytest.fixture(scope="module")
def params():
    return jtf.init_lm_params(7, **CFG)


def _engines(params, **kw):
    eng = dict(ENG, **kw)
    return (JaxEngine(params, **eng, **CFG),
            ContinuousDecodeEngine(params, device="cpu", **eng, **CFG))


def _requests(seed, n=8, lo=3, hi=16):
    rng = np.random.RandomState(seed)
    return [(rng.randint(2, CFG["vocab_size"], int(rng.randint(lo, hi)))
             .astype(np.int32), int(rng.randint(2, 20))) for _ in range(n)]


def _serve(make_sched, eng, reqs, sampling=None, stagger=3, squeeze=False):
    """Submit half, step ``stagger`` times, submit the rest, run to idle.
    ``squeeze`` empties the pool's free list after the stagger and steps
    until growth has preempted a slot, then hands the blocks back."""
    sched = make_sched(eng)
    sampling = sampling or [None] * len(reqs)
    half = len(reqs) // 2
    hs = [sched.submit(p, g, sampling=sp)
          for (p, g), sp in zip(reqs[:half], sampling[:half])]
    for _ in range(stagger):
        sched.step()
    if squeeze:
        stolen, eng.pool._free = eng.pool._free, []
        for _ in range(3 * eng.block_size):
            if sched.counters["preemptions"]:
                break
            sched.step()
        eng.pool._free = stolen + eng.pool._free
    hs += [sched.submit(p, g, sampling=sp)
           for (p, g), sp in zip(reqs[half:], sampling[half:])]
    sched.run_until_idle()
    return sched, [h.result(1) for h in hs]


def _match_rate(a, b):
    agree = sum(int((x[:min(x.size, y.size)] == y[:min(x.size, y.size)])
                    .sum()) for x, y in zip(a, b))
    return agree / max(sum(x.size for x in a), 1)


# ---------------------------------------------------------------- engine


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_teacher_forced_logits_match_jax(params, kv_dtype):
    """Prefill one history into the same blocks in both engines, then feed
    the same tokens through W=1 steps (with a batch-mate in another slot):
    prefill and step logits agree within atol 1e-4, float and int8 pool."""
    je, te = _engines(params, kv_dtype=kv_dtype)
    assert te.kv_dtype == je.kv_dtype
    rng = np.random.RandomState(11)
    hist = [rng.randint(2, CFG["vocab_size"], n).astype(np.int32)
            for n in (13, 5)]
    tables = np.tile(je._trash_table(), (ENG["n_slots"], 1))
    tables[0, :3] = [4, 9, 2]
    tables[2, :2] = [7, 0]
    for i, h in zip((0, 2), hist):
        jl = je.prefill(h, tables[i])
        tl = te.prefill(h, tables[i])
        np.testing.assert_allclose(tl, jl, atol=LOGIT_ATOL, rtol=0)
    pos = np.array([13, 0, 5, 0], np.int32)
    limits = np.array([24, 0, 16, 0], np.int32)
    for _ in range(5):
        toks = rng.randint(2, CFG["vocab_size"], (ENG["n_slots"], 1)
                           ).astype(np.int32)
        jl = je.step_logits(toks, pos, tables, limits)
        tl = te.step_logits(toks, pos, tables, limits)
        np.testing.assert_allclose(tl[[0, 2]], jl[[0, 2]], atol=LOGIT_ATOL,
                                   rtol=0)
        pos[[0, 2]] += 1


def test_prefill_tail_matches_jax(params):
    """The tail rides the W=1 step n_slots tokens per dispatch: the token
    after the tail equals the JAX engine's, greedy and sampled."""
    je, te = _engines(params)
    rng = np.random.RandomState(12)
    hist = rng.randint(2, CFG["vocab_size"], 11).astype(np.int32)
    table = je._trash_table()
    table[:2] = [3, 5]
    for eng in (je, te):
        eng.prefill(hist[:3], table)
    assert (te.prefill_tail(hist[3:], 3, table, 20)
            == je.prefill_tail(hist[3:], 3, table, 20))
    row = (1234, 0, 0.9, 0, 0.95, None)
    assert (te.prefill_tail(hist[-1:], 10, table, 20, samp_row=row)
            == je.prefill_tail(hist[-1:], 10, table, 20, samp_row=row))


# -------------------------------------------------------------- scheduler


@pytest.mark.parametrize("arm", ["plain", "preempt", "spec", "int8",
                                 "sampled"])
def test_scheduler_streams_match_jax(params, arm):
    """The same request set with staggered joins through both schedulers:
    greedy token-match rate >= 0.98 and no leaked blocks.  ``preempt``
    shrinks the pool until the youngest slot is evicted and re-prefilled;
    ``spec`` verifies n-gram drafts in W=4 windows; ``int8`` quantizes the
    pool; ``sampled`` mixes temperature/top-k/top-p streams in."""
    eng_kw, sched_kw, sampling, squeeze = {}, {}, None, False
    reqs = _requests(3)
    if arm == "preempt":
        squeeze = True
        reqs = _requests(5, lo=10, hi=16)
    elif arm == "spec":
        sched_kw["spec"] = True
        reqs = [(np.tile(p[:4], 4), g) for p, g in reqs]
    elif arm == "int8":
        eng_kw["kv_dtype"] = "int8"
    elif arm == "sampled":
        # policies as records: each package decodes them into its own
        # SamplingParams
        sampling = [None if i % 3 else SamplingParams(
            temperature=0.8, top_k=8 * (i % 2), top_p=0.9, seed=77 + i
        ).to_record() for i in range(len(reqs))]
    je, te = _engines(params, **eng_kw)
    js, jout = _serve(lambda e: JaxScheduler(e, **sched_kw), je, reqs,
                      sampling, squeeze=squeeze)
    ts, tout = _serve(lambda e: ContinuousScheduler(e, **sched_kw), te, reqs,
                      sampling, squeeze=squeeze)
    assert [t.size for t in tout] == [t.size for t in jout]
    assert _match_rate(tout, jout) >= MATCH_FLOOR
    census = ts.check_block_accounting()
    assert census == {"free": te.pool.n_blocks, "occupied": 0, "leaked": 0}
    for key in ("prefill_inserts", "retired", "preemptions", "spec_proposed"):
        assert ts.counters[key] == js.counters[key], key
    if arm == "preempt":
        assert ts.counters["preemptions"] > 0
    if arm == "spec":
        assert ts.counters["spec_accepted"] > 0


def test_sampled_streams_repeat_under_fixed_seed(params):
    _, te = _engines(params)
    reqs = _requests(21, n=4)
    samp = [SamplingParams(temperature=1.0, top_p=0.9, seed=5 + i)
            for i in range(4)]
    runs = [_serve(ContinuousScheduler, te, reqs, samp)[1] for _ in range(2)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    other = [SamplingParams(temperature=1.0, top_p=0.9, seed=500 + i)
             for i in range(4)]
    moved = _serve(ContinuousScheduler, te, reqs, other)[1]
    assert any(not np.array_equal(a, b) for a, b in zip(runs[0], moved))


def test_submit_validation(params):
    _, te = _engines(params, n_blocks=6)
    sched = ContinuousScheduler(te)
    with pytest.raises(ValueError, match="not ported"):
        sched.submit([3, 4], 4, sampling=SamplingParams(beam=2))
    with pytest.raises(ValueError, match="not ported"):
        sched.submit([3, 4], 4, sampling=SamplingParams(n=2,
                                                        temperature=1.0))
    with pytest.raises(ValueError, match="max_len"):
        sched.submit(np.ones(60, np.int32), 10)
    with pytest.raises(ValueError, match="KV blocks"):
        sched.submit(np.ones(40, np.int32), 10)


def test_deadlines_shed_waiters_and_retire_slots(params):
    _, te = _engines(params)
    sched = ContinuousScheduler(te)
    clock = [0.0]
    expired = sched.submit([5, 6, 7], 10,
                           deadline=Deadline(1.0, clock=lambda: clock[0]))
    clock[0] = 2.0
    keep = sched.submit([8, 9, 10], 6)
    sched.step()
    with pytest.raises(AdmissionShed):
        expired.result(1)
    late = [0.0]
    mid = sched.submit([11, 12], 30,
                       deadline=Deadline(1.0, clock=lambda: late[0]))
    sched.step()
    late[0] = 5.0
    sched.run_until_idle()
    with pytest.raises(DeadlineExceeded):
        mid.result(1)
    assert keep.result(1).size == 6
    assert sched.counters["sheds"] == 1
    assert sched.check_block_accounting()["leaked"] == 0


def test_background_loop_serves_and_closes(params):
    _, te = _engines(params)
    sched = ContinuousScheduler(te).start()
    try:
        hs = [sched.submit(p, g) for p, g in _requests(31, n=5)]
        outs = [h.result(timeout=60) for h in hs]
        assert [o.size for o in outs] == [g for _, g in _requests(31, n=5)]
    finally:
        sched.close()
    assert not sched._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit([1, 2], 3)
    assert sched.stats()["closed"]


def test_decode_step_failure_fails_every_request(params, monkeypatch):
    """A kernel that raises inside the decode step (outside any one
    request's handling) fails every live slot and waiter with that error and
    ends the background loop, instead of leaving the submitters hanging."""
    from paddle_tpu_torch import ops

    def launch_fails(*args, **kwargs):
        raise RuntimeError("paged_attention kernel launch failed: CUDA error 1")

    monkeypatch.setattr(ops, "paged_attention", launch_fails)
    _, te = _engines(params)
    sched = ContinuousScheduler(te)
    hs = [sched.submit(p, g) for p, g in _requests(41, n=6)]
    sched.start()
    for h in hs:   # 4 seated in slots, 2 still queued
        with pytest.raises(RuntimeError, match="launch failed"):
            h.result(timeout=60)
    sched._thread.join(timeout=10)
    assert not sched._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit([1, 2], 3)
    assert sched.check_block_accounting()["leaked"] == 0
    assert te.pool.blocks_free == te.pool.n_blocks

    _, te = _engines(params)      # synchronous driving raises to the caller
    sched = ContinuousScheduler(te)
    h = sched.submit([3, 4, 5], 5)
    with pytest.raises(RuntimeError, match="launch failed"):
        sched.run_until_idle()
    with pytest.raises(RuntimeError, match="launch failed"):
        h.result(timeout=1)


# ------------------------------------------------------------ host pieces


def test_pool_free_guard_and_lifo():
    pool = PagedKVPool(6, 1, 2, 4, 8, device="cpu")
    a = pool.alloc(3)
    assert a == [0, 1, 2] and pool.blocks_free == 3
    pool.free([1])
    assert pool.alloc(1) == [1]                   # LIFO: last freed first
    assert pool.alloc(10) is None
    for bad, what in (([6], "trash"), ([9], "out-of-range"),
                      ([3], "double-free"), ([0, 0], "double-free")):
        with pytest.raises(ValueError, match=what):
            pool.free(bad)
    assert pool.bad_frees == 4 and pool.blocks_free == 3
    q8 = PagedKVPool(6, 1, 2, 4, 8, kv_dtype="int8", device="cpu")
    assert q8.quantized and q8.bytes_per_token == 2 * 2 * (8 + 4)
    assert pool.bytes_per_token == 2 * 2 * 8 * 4


class _Req:
    def __init__(self, n, deadline=None):
        self.prompt_len = n
        self.deadline = deadline
        self.enqueued_at = 0.0


def test_admission_queue_tiering_and_aging():
    q = DecodeAdmissionQueue([8, 16, 32], max_wait_ms=50.0)
    long_, short = _Req(30), _Req(5)
    q.push(long_)
    q.push(short)
    assert q.pop() is short                       # shortest tier first
    q.push(short)
    long_.enqueued_at = time.monotonic() - 1.0    # aged past the guard
    q._q.sort(key=lambda r: r.enqueued_at)
    assert q.pop(lambda r: r is short) is None    # oldest holds its turn
    assert q.pop() is long_
    dead = _Req(4, deadline=Deadline(0.0))
    q.push(dead)
    assert q.shed_expired() == [dead] and len(q) == 1


# ----------------------------------------------------- the card's limits


@pytest.mark.parametrize("W,Dh,ok", [(1, 64, True), (8, 128, True),
                                     (9, 64, False), (4, 48, False)])
def test_paged_kernel_shape_check(W, Dh, ok):
    """``check_kernel_shape``, which the engine calls on a card before it
    allocates its pool and the kernel's wrapper at every launch."""
    from paddle_tpu_torch.ops.paged_attention import check_kernel_shape

    if ok:
        check_kernel_shape(W, Dh)
        return
    with pytest.raises(ValueError, match=f"got (W={W}|Dh={Dh})"):
        check_kernel_shape(W, Dh)


@pytest.mark.parametrize("eng_kw,cfg_kw,match", [
    (dict(spec_window=9), {}, "windows of 1..8 rows, got W=9"),
    ({}, dict(d_model=96), r"head dims \(16, 32, 64, 128\), got Dh=48")])
def test_card_engine_refuses_kernel_shapes_before_its_pool(params, eng_kw,
                                                           cfg_kw, match):
    """On a CUDA device the engine raises in its constructor, before it
    allocates the pool or loads weights (so no card is needed to see it);
    on the CPU the same engine builds and serves on the plain versions."""
    cfg, eng = dict(CFG, **cfg_kw), dict(ENG, **eng_kw)
    p = jtf.init_lm_params(7, **cfg) if cfg_kw else params
    with pytest.raises(ValueError, match=match):
        ContinuousDecodeEngine(p, device="cuda", **eng, **cfg)
    te = ContinuousDecodeEngine(p, device="cpu", **eng, **cfg)
    sched, outs = _serve(ContinuousScheduler, te, _requests(9, n=4),
                         stagger=1)
    assert all(o.size >= 1 for o in outs)
    assert sched.check_block_accounting()["leaked"] == 0
