"""paddle_tpu_torch's prefix cache against the JAX package on the CPU, at the
reference's own test size and on the same weights: chained digests bit for
bit (float32 and int8 roots), ``PrefixCache`` bookkeeping step for step,
hit streams against the JAX prefix-cached engine under staggered joins
(greedy token match >= 0.98, teacher-forced logits atol 1e-4: float32 sums
in another order), hits against cold prefills within the port,
copy-on-write leaving shared blocks' bytes unchanged, refcount-zero
recycling and LRU eviction, churn with migration and preemption (no leaked
block, the partition clean), no signature prepared after ``warm()``, the
``serving.prefix_match`` fault degrading to a cold prefill, admission
tiering on ``effective_len``, and an abort dropping the cache."""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as jtf
from paddle_tpu.serving import ContinuousDecodeEngine as JaxEngine
from paddle_tpu.serving import ContinuousScheduler as JaxScheduler
from paddle_tpu.serving import prefix as jprefix
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                      ContinuousScheduler,
                                      DecodeAdmissionQueue, DecodeEngine,
                                      bucket_for,
                                      GenerationMigrated, PrefixCache,
                                      chain_hashes, root_for_kv_dtype)
from paddle_tpu_torch.serving import prefix as tprefix

CFG = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
           d_ff=64)
ENG = dict(n_slots=4, block_size=8, prompt_buckets=(8, 16))
LOGIT_ATOL = 1e-4     # float32 sums in another order
MATCH_FLOOR = 0.98    # greedy token-match rate


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jtf.init_lm_params(7, **CFG)


@pytest.fixture(scope="module")
def dense(params):
    """The port's dense greedy oracle."""
    return DecodeEngine(params, batch_buckets=(1,), device="cpu", **CFG)


@pytest.fixture(scope="module")
def ceng(params):
    """One warmed prefix-cache engine for the module (the cache is
    engine-scoped, like the pool: tests use distinct prompt families)."""
    eng = ContinuousDecodeEngine(params, prefix_cache=True, device="cpu",
                                 **ENG, **CFG)
    eng.warm()
    eng.traces_after_warm = eng.trace_count()
    return eng


def _fam(seed, n):
    return np.random.RandomState(seed).randint(
        2, CFG["vocab_size"], n).astype(np.int32)


def _with_tail(fam, seed, n):
    return np.concatenate([fam, _fam(seed, n)])


def _match_rate(a, b):
    agree = sum(int((np.asarray(x) == np.asarray(y)).sum())
                for x, y in zip(a, b))
    return agree / max(sum(len(x) for x in a), 1)


def _ref(dense_eng, p, g):
    return dense_eng.generate(p[None, :], g)[0]


# ------------------------------------------------------------- digests


@pytest.mark.parametrize("kv_dtype", [None, "float32", "int8", "bfloat16"])
def test_digests_bitwise_equal_to_jax(kv_dtype):
    """The root bytes and the chain recipe are the reference's: every
    digest equal bit for bit, at several lengths and block sizes; the int8
    root differs from the float32 one."""
    assert tprefix.ROOT_DIGEST == jprefix.ROOT_DIGEST
    root = root_for_kv_dtype(kv_dtype)
    assert root == jprefix.root_for_kv_dtype(kv_dtype)
    for n, bs in ((0, 8), (7, 8), (8, 8), (41, 8), (100, 16), (257, 16)):
        toks = _fam(n + bs, n)
        assert (chain_hashes(toks, bs, root=root)
                == jprefix.chain_hashes(toks, bs, root=root))
    assert root_for_kv_dtype("int8") != root_for_kv_dtype(None)
    assert PrefixCache(8, kv_dtype=kv_dtype).root == jprefix.PrefixCache(
        8, kv_dtype=kv_dtype).root


def test_chip_smoke_digest_recomputation_is_the_reference_recipe():
    """``chip_smoke.py`` checks each request's digests on the card against
    its own blake2b recomputation; that recomputation is the JAX
    package's chain, bit for bit."""
    import chip_smoke

    for n in (15, 16, 400):
        toks = _fam(n, n)
        assert chip_smoke._blake2b_chain(toks, 16) == \
            jprefix.chain_hashes(toks, 16)


def test_prefix_cache_bookkeeping_step_for_step_against_jax():
    """The same random sequence of register / lookup / match / record /
    acquire / release / evict calls on both caches: every return value,
    counter and stat equal, the match cap, LRU order and refcount guard
    included."""
    rng = np.random.RandomState(0)
    caches = (PrefixCache(8), jprefix.PrefixCache(8))
    fams = [_fam(500 + i, 40) for i in range(3)]
    held = []                     # block lists a "slot" holds
    next_block = 0
    for _ in range(300):
        op = rng.randint(5)
        hist = fams[rng.randint(3)][:int(rng.randint(1, 41))]
        if op == 0:               # register a history's blocks
            digs = chain_hashes(hist, 8)
            got = []
            for i, d in enumerate(digs):
                parent = digs[i - 1] if i else tprefix.ROOT_DIGEST
                got.append(tuple(c.register(d, parent, next_block + i)
                                 for c in caches))
            next_block += len(digs)
            assert all(a == b for a, b in got)
            held.append([next_block - len(digs) + i
                         for i, (a, _) in enumerate(got) if a])
        elif op == 1:             # lookup, match, match_len and record
            outs = [c.match(hist) for c in caches]
            assert outs[0] == outs[1]
            assert caches[0].match_len(hist) == caches[1].match_len(hist)
            assert caches[0].lookup(outs[0][1], hist.size) == \
                caches[1].lookup(outs[1][1], hist.size)
            for c in caches:
                c.record(len(outs[0][0]), outs[0][2])
            if outs[0][0]:
                for c in caches:
                    c.acquire(outs[0][0])
                held.append(list(outs[0][0]))
        elif op == 2 and held:    # a slot releases, deepest first
            blocks = held.pop(int(rng.randint(len(held))))
            for c in caches:
                c.release(list(reversed(blocks)))
        elif op == 3:
            n = int(rng.randint(4))
            assert caches[0].evict(n) == caches[1].evict(n)
        for b in range(next_block):
            assert caches[0].refcount(b) == caches[1].refcount(b)
        assert caches[0].stats() == caches[1].stats()
        assert list(caches[0]._lru) == list(caches[1]._lru)
    assert caches[0].counters["hits"] > 10
    assert caches[0].counters["evictions"] > 0
    blk = next(iter(caches[0]._lru), None)
    if blk is not None:
        for c in caches:
            with pytest.raises(AssertionError, match="refcount drift"):
                c.release([blk])
    assert caches[0].drop_all() == caches[1].drop_all()
    assert caches[0].stats() == caches[1].stats()


# ----------------------------------------------------- against the JAX


def test_hit_streams_match_jax_prefix_engine_under_staggered_joins(params):
    """Both packages' prefix-cached schedulers on the same staggered
    requests sharing a 3-block prefix: hits in both, the same hit counts,
    greedy streams at the floor; then teacher-forced through the hit path
    (a tail prefill against shared blocks, then W=1 steps) on both engines'
    same tables, logits within 1e-4."""
    je = JaxEngine(params, prefix_cache=True, **ENG, **CFG)
    te = ContinuousDecodeEngine(params, prefix_cache=True, device="cpu",
                                **ENG, **CFG)
    traces = te.warm()
    fam = _fam(20, 24)
    reqs = [(_with_tail(fam, 100 + i, 1 + 2 * i), 4 + i) for i in range(6)]
    streams, stats = [], []
    for eng, Sched in ((je, JaxScheduler), (te, ContinuousScheduler)):
        sched = Sched(eng)
        hs = [sched.submit(p, g) for p, g in reqs[:3]]
        for _ in range(2):
            sched.step()
        hs += [sched.submit(p, g) for p, g in reqs[3:]]
        sched.run_until_idle()
        streams.append([h.result(1) for h in hs])
        stats.append(dict(eng.prefix.counters))
        sched.check_block_accounting()
    assert stats[1]["hits"] >= 5 and stats[1] == stats[0]
    assert _match_rate(streams[1], streams[0]) >= MATCH_FLOOR
    assert te.trace_count() == traces

    # teacher-forced through the hit path: blocks 0-2 hold the family's
    # prefix in both arenas; a tail rides the W=1 step through a table
    # that maps them, then the same tokens are fed step by step
    hist = _with_tail(fam, 7, 5)
    cold = je._trash_table()
    cold[:4] = [0, 1, 2, 3]
    hit = je._trash_table()
    hit[:4] = [0, 1, 2, 9]
    for eng in (je, te):
        eng.prefill(hist, cold)
    limit = hist.size + 8
    jt, jrow = je.prefill_tail(hist[24:], 24, hit, limit, return_logits=True)
    tt, trow = te.prefill_tail(hist[24:], 24, hit, limit, return_logits=True)
    np.testing.assert_allclose(trow, jrow, atol=LOGIT_ATOL, rtol=0)
    assert tt == jt
    S = ENG["n_slots"]
    tables = np.tile(je._trash_table(), (S, 1))
    tables[1] = hit
    pos = np.zeros(S, np.int32)
    lims = np.zeros(S, np.int32)
    pos[1], lims[1] = hist.size, limit
    for tok in _fam(8, 6):
        toks = np.zeros((S, 1), np.int32)
        toks[1, 0] = tok
        jl = je.step_logits(toks, pos, tables, lims)
        tl = te.step_logits(toks, pos, tables, lims)
        np.testing.assert_allclose(tl[1], jl[1], atol=LOGIT_ATOL, rtol=0)
        pos[1] += 1


def test_hit_against_cold_within_the_port(params, dense):
    """Within the port, the same requests on a prefix-cached engine and on
    one without: hit streams at the greedy floor against the cold ones and
    the dense oracle, and a hit's first-token logits within 1e-4 of the
    cold prefill's (the tail runs the paged step, the cold prefill the
    dense forward: float32 sums in another order)."""
    cold = ContinuousDecodeEngine(params, device="cpu", **ENG, **CFG)
    hot = ContinuousDecodeEngine(params, prefix_cache=True, device="cpu",
                                 **ENG, **CFG)
    fam = _fam(25, 32)
    reqs = [(_with_tail(fam, 150 + i, 2 + 3 * i), 6) for i in range(6)]
    out = []
    for eng in (cold, hot):
        sched = ContinuousScheduler(eng)
        hs = [sched.submit(p, g) for p, g in reqs]
        sched.run_until_idle()
        out.append([h.result(1) for h in hs])
    assert hot.prefix.counters["hits"] >= 5
    assert _match_rate(out[1], out[0]) >= MATCH_FLOOR
    assert _match_rate(out[1], [_ref(dense, p, g) for p, g in reqs]) \
        >= MATCH_FLOOR
    hist = _with_tail(fam, 160, 6)
    table = cold._trash_table()
    table[:5] = [10, 11, 12, 13, 14]
    row_cold = cold.prefill(hist, table)
    cold.prefill(hist[:32], table)
    _, row_hit = cold.prefill_tail(hist[32:], 32, table, hist.size + 4,
                                   return_logits=True)
    np.testing.assert_allclose(row_hit, row_cold, atol=LOGIT_ATOL, rtol=0)


# ------------------------------------------------------------ the port


def test_cow_divergence_never_mutates_a_shared_block(ceng, dense):
    """A request that shares a prefix and diverges inside block 2 writes
    only private blocks: the shared blocks' K and V bytes are bitwise
    unchanged, a copy-on-write is counted, and the whole chain still
    serves an identical prompt with an identical stream."""
    fam = _fam(21, 24)
    sched = ContinuousScheduler(ceng)
    pa = _with_tail(fam, 200, 4)
    ha = sched.submit(pa, 6)
    sched.run_until_idle()
    digs = chain_hashes(pa, 8)
    shared = [ceng.prefix._by_digest[d] for d in digs[:3]]
    k_before = ceng.pool.k[shared].clone()
    v_before = ceng.pool.v[shared].clone()
    cows = ceng.prefix.counters["cow_copies"]
    pb = np.concatenate([fam[:20], _fam(201, 8)])
    hb = sched.submit(pb, 6)
    sched.run_until_idle()
    assert torch.equal(ceng.pool.k[shared], k_before)
    assert torch.equal(ceng.pool.v[shared], v_before)
    assert ceng.prefix.counters["cow_copies"] > cows
    assert _match_rate([hb.result(1)], [_ref(dense, pb, 6)]) >= MATCH_FLOOR
    hc = sched.submit(pa.copy(), 6)
    sched.run_until_idle()
    np.testing.assert_array_equal(ha.result(1), hc.result(1))
    sched.check_block_accounting()
    assert ceng.trace_count() == ceng.traces_after_warm


def test_refcount_zero_recycle_and_lru_eviction_under_pool_pressure(
        params, dense):
    """More prefix families than a 9-block pool holds keep serving: a dry
    pool reclaims unreferenced cached blocks (evictions counted) before it
    preempts, the partition holds after every request, and the streams
    stay at the floor against the dense oracle."""
    eng = ContinuousDecodeEngine(params, n_slots=2, block_size=8,
                                 n_blocks=9, prompt_buckets=(8, 16),
                                 prefix_cache=True, device="cpu", **CFG)
    traces = eng.warm()
    sched = ContinuousScheduler(eng)
    fams = [_fam(30 + i, 16) for i in range(4)]
    got, want = [], []
    for i in range(12):
        p = _with_tail(fams[i % 4], 300 + i, 3 + (i % 7))
        h = sched.submit(p, 5)
        sched.run_until_idle()
        got.append(h.result(1))
        want.append(_ref(dense, p, 5))
        sched.check_block_accounting()
    assert _match_rate(got, want) >= MATCH_FLOOR
    assert eng.prefix.counters["evictions"] > 0
    assert eng.prefix.counters["hits"] > 0
    census = sched.check_block_accounting()
    assert census["occupied"] == 0 and census["referenced"] == 0
    assert census["free"] + census["cached"] == 9
    assert eng.trace_count() == traces


def test_churn_with_migration_and_preemption_leaks_nothing(params, dense):
    """110 requests in waves through a tight pool: preemptions or evictions
    fire, a mid-run drain migrates every live generation and
    ``resume_prefix`` re-admits the records on a new scheduler over the
    same engine; the partition and refcounts hold every wave, nothing
    leaks, and the streams stay at the floor."""
    eng = ContinuousDecodeEngine(params, n_slots=4, block_size=8,
                                 n_blocks=12, prompt_buckets=(8, 16),
                                 prefix_cache=True, device="cpu", **CFG)
    traces = eng.warm()
    fams = [_fam(40 + i, 16) for i in range(3)]
    sched = ContinuousScheduler(eng)
    rng = np.random.RandomState(9)
    expect = {}
    migrated = resumed = served = 0
    for wave in range(11):
        for j in range(10):
            p = _with_tail(fams[int(rng.randint(3))], 1000 * wave + j,
                           int(rng.randint(2, 7)))
            g = int(rng.randint(3, 10)) if j > 1 else 24
            expect[sched.submit(p, g)] = (p, g)
        served += 10
        sched.step()
        if wave == 5:
            records = sched.snapshot_slots(drain=True)
            migrated = len(records)
            resumed = sum(1 for rec in records if rec["tokens"])
            sched = ContinuousScheduler(eng)
            for rec in records:
                json.dumps(rec)
                assert "blocks" not in rec and "table" not in rec
                h2 = sched.submit(np.asarray(rec["prompt"], np.int32),
                                  rec["max_gen"],
                                  resume_prefix=rec["tokens"] or None,
                                  resume_kv_dtype=rec["kv_dtype"])
                for h, (p, g) in list(expect.items()):
                    if (h.done.is_set()
                            and isinstance(h.error, GenerationMigrated)
                            and np.array_equal(p, rec["prompt"])
                            and g == rec["max_gen"]):
                        del expect[h]
                        expect[h2] = (p, g)
                        break
        sched.run_until_idle()
        sched.check_block_accounting()
    assert served >= 100 and migrated > 0 and resumed > 0
    assert sched.counters["resumed_in"] == resumed
    got = [h.result(1) for h in expect]
    want = [_ref(dense, p, g) for p, g in expect.values()]
    assert _match_rate(got, want) >= MATCH_FLOOR
    assert sched.counters["preemptions"] + eng.prefix.counters["evictions"] \
        > 0, "the tight pool never came under pressure"
    assert eng.prefix.counters["hits"] > 10
    census = sched.check_block_accounting()
    assert census["occupied"] == 0 and census["referenced"] == 0
    assert census["leaked"] == 0
    assert census["free"] + census["cached"] == 12
    assert eng.trace_count() == traces


def test_prefix_match_fault_degrades_to_a_cold_prefill(ceng, dense):
    """An armed ``serving.prefix_match`` makes a sure hit a counted miss:
    the admission pays a cold prefill, the stream is at the floor against
    the dense oracle, nothing aborts."""
    sched = ContinuousScheduler(ceng)
    fam = _fam(60, 24)
    p0 = _with_tail(fam, 700, 4)
    sched.submit(p0, 5)
    sched.run_until_idle()
    hits = ceng.prefix.counters["hits"]
    misses = ceng.prefix.counters["misses"]
    prefill_calls = sum(ceng.prefill_dispatches.values())
    with faults.active("serving.prefix_match", RuntimeError("matcher down"),
                       count=1):
        p1 = _with_tail(fam, 701, 4)
        h1 = sched.submit(p1, 6)
        sched.run_until_idle()
        assert faults.fired("serving.prefix_match") == 1
    assert ceng.prefix.counters["hits"] == hits
    assert ceng.prefix.counters["misses"] > misses
    assert sum(ceng.prefill_dispatches.values()) > prefill_calls
    assert _match_rate([h1.result(1)], [_ref(dense, p1, 6)]) >= MATCH_FLOOR
    assert not sched.stats()["closed"]
    sched.check_block_accounting()
    assert ceng.trace_count() == ceng.traces_after_warm


def test_resume_rides_the_cache_and_cross_dtype_resume_is_cold(ceng,
                                                               dense):
    """A drained stream's record re-admits through the prefix match with no
    full-history prefill, continuing at the floor; the same record from an
    int8 pool re-prefills cold."""
    p = _with_tail(_fam(70, 24), 800, 4)
    sched = ContinuousScheduler(ceng)
    h = sched.submit(p, 12)
    for _ in range(3):
        sched.step()
    records = sched.snapshot_slots(drain=True)
    with pytest.raises(GenerationMigrated):
        h.result(0)
    rec = next(r for r in records if r["seated"])
    assert sched.counters["migrated_out"] == len(records)
    ref = _ref(dense, p, 12)
    for kv, cold in ((rec["kv_dtype"], False), ("int8", True)):
        before = sum(ceng.prefill_dispatches.values())
        s2 = ContinuousScheduler(ceng)
        h2 = s2.submit(np.asarray(rec["prompt"], np.int32), rec["max_gen"],
                       resume_prefix=rec["tokens"], resume_kv_dtype=kv)
        assert h2.cold_resume is cold
        s2.run_until_idle()
        assert _match_rate([h2.result(1)], [ref]) >= MATCH_FLOOR
        assert (sum(ceng.prefill_dispatches.values()) > before) is cold
        s2.check_block_accounting()


class _Waiter:
    def __init__(self, prompt_len):
        self.prompt_len = prompt_len
        self.deadline = None
        self.enqueued_at = 0.0


def test_admission_tiering_keys_on_effective_len():
    """With ``effective_len`` the cheap-first tier is the unshared tail: a
    long prompt whose prefix is cached admits before a shorter cold one;
    without it the order is by prompt length."""
    costs = {}
    q = DecodeAdmissionQueue((8, 16, 32), max_wait_ms=1e6,
                             effective_len=lambda r: costs[id(r)])
    long_cached, mid_cold = _Waiter(30), _Waiter(12)
    costs[id(long_cached)], costs[id(mid_cold)] = 4, 12
    q.push(mid_cold)
    q.push(long_cached)
    assert q.pop() is long_cached
    assert q.pop() is mid_cold
    q2 = DecodeAdmissionQueue((8, 16, 32), max_wait_ms=1e6)
    q2.push(mid_cold)
    q2.push(long_cached)
    assert q2.pop() is mid_cold
    # oversize is a ValueError
    with pytest.raises(ValueError, match="largest bucket"):
        bucket_for([8, 16], 20)


def test_an_abort_drops_the_cache(params, monkeypatch):
    """A step that fails outside any one request aborts the scheduler and
    drops the prefix cache with it (the arenas may be half written): no
    cached block is left, its blocks are back on the free list, and the
    partition holds.  Closing a scheduler keeps the engine's cache."""
    eng = ContinuousDecodeEngine(params, n_slots=2, block_size=8,
                                 prompt_buckets=(8, 16), prefix_cache=True,
                                 device="cpu", **CFG)
    eng.warm()
    first = ContinuousScheduler(eng)
    first.submit(_fam(79, 20), 4)
    first.run_until_idle()
    first.close()
    assert eng.prefix.cached_blocks == 2
    sched = ContinuousScheduler(eng)
    h = sched.submit(_fam(80, 20), 4)
    sched.run_until_idle()
    assert h.result(1).size == 4
    assert eng.prefix.cached_blocks == 4

    def fails(*a, **k):
        raise RuntimeError("paged_attention kernel launch failed")

    h2 = sched.submit(_fam(81, 20), 4)
    monkeypatch.setattr(eng, "step_tokens", fails)
    with pytest.raises(RuntimeError, match="launch failed"):
        sched.run_until_idle()
    with pytest.raises(RuntimeError, match="launch failed"):
        h2.result(1)
    assert eng.prefix.cached_blocks == 0
    assert eng.prefix.evictable_blocks == 0
    assert sched.stats()["closed"]
    assert sched.stats()["prefix"]["cached_blocks"] == 0
    census = sched.check_block_accounting()
    assert census["free"] == eng.pool.n_blocks and census["leaked"] == 0
