"""paddle_tpu_torch's beam and parallel-n forks over copy-on-write blocks
against the JAX package on the CPU, at the reference's own test size and on
the same weights: COW-forked beam search in the continuous batch against
the JAX package's dense ``models.transformer.generate`` (tokens and lens
equal, scores rtol 1e-5, the reference's own limit), a beam group joining
mid-flight, parallel-n branches reproducible, the ``serving.fork`` fault
degrading forks to private copies, and fork / prune / retire churn with the
block partition clean and no signature prepared after ``warm()``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu.models import transformer as jtf
from paddle_tpu_torch.layers import beam as tbeam
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                      ContinuousScheduler, DecodeRequest,
                                      SamplingParams)
from paddle_tpu_torch.serving.decode import _BeamGroup

CFG = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
           d_ff=64)
TP, G, K = 12, 10, 3          # the beam case: one JAX generate signature
SCORE_RTOL = 1e-5             # tests/test_sampling_decode.py:255


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
def ceng(params):
    """One warmed prefix-cache engine for the module (six slots: a K=3
    group joins while other streams run)."""
    eng = ContinuousDecodeEngine(params, n_slots=6, block_size=8,
                                 prompt_buckets=(8, 16), spec_window=4,
                                 prefix_cache=True, device="cpu", **CFG)
    eng.warm()
    eng.traces_after_warm = eng.trace_count()
    return eng


@pytest.fixture(scope="module")
def beam_ref(params):
    """The JAX package's dense beam path at float32, one program for
    (TP, K, G), fed each prompt in turn."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        pv = jfluid.layers.data("prompt", [TP], dtype="int32")
        fetches = jmodels.transformer.generate(
            pv, CFG["vocab_size"], max_len=CFG["max_len"], eos_id=0,
            d_model=CFG["d_model"], n_heads=CFG["n_heads"],
            n_layers=CFG["n_layers"], d_ff=CFG["d_ff"], beam_size=K,
            max_gen=G, decode_dtype="float32")
    prog = main.prune([fetches[0]])
    memo = {}

    def ref(prompt):
        key = tuple(int(t) for t in prompt)
        if key not in memo:
            scope = jfluid.Scope()
            exe = jfluid.Executor()
            exe.run(startup, scope=scope)
            for name, val in params.items():
                scope.set_var(name, np.asarray(val))
            t, s, ln = exe.run(prog, feed={"prompt": np.asarray(
                prompt, np.int32)[None]}, fetch_list=list(fetches),
                scope=scope)
            memo[key] = (t[0], s[0], ln[0])
        return memo[key]

    return ref


def _beam_prompt(seed):
    return np.random.RandomState(seed).randint(
        1, CFG["vocab_size"], TP).astype(np.int32)


def _prompt(seed, n=10):
    return np.random.RandomState(seed).randint(
        2, CFG["vocab_size"], n).astype(np.int32)


def _run(eng, sampling, prompt, g=G, **kw):
    sched = ContinuousScheduler(eng)
    h = sched.submit(prompt, g, sampling=sampling, **kw)
    sched.run_until_idle()
    assert h.error is None, h.error
    return h, sched


def _assert_beams(h, ref):
    d_tok, d_sc, d_len = ref
    np.testing.assert_array_equal(np.asarray(h.beams), d_tok)
    np.testing.assert_array_equal(np.asarray(h.beam_lens), d_len)
    np.testing.assert_allclose(np.asarray(h.beam_scores), d_sc,
                               rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize("lp", [0.0, 0.7])
def test_beam_controller_against_the_dense_beam_loop(lp):
    """The scheduler's host beam controller, fed the log-softmax rows of a
    fixed Markov table (eos made likely), gives ``layers.beam.beam_loop``'s
    tokens, scores and lens bit for bit, the length-penalty re-sort
    included (one order among ties: ``layers.beam.top_k``)."""
    V, G, k, eos = 9, 7, 3, 0
    table = np.random.RandomState(3).randn(V, V).astype(np.float32)
    table[:, eos] += 0.5
    logp = torch.log_softmax(torch.from_numpy(table), dim=-1)

    def step_fn(last, states):
        return logp[last.long()], states

    want = tbeam.beam_loop(step_fn, (torch.zeros(1),), 1,
                           bos_id=torch.tensor([4]), eos_id=eos,
                           beam_size=k, max_len=G, length_penalty=lp)
    req = DecodeRequest([4], G, eos_id=eos,
                        sampling=SamplingParams(beam=k, length_penalty=lp))
    group = _BeamGroup(req, range(k), eos)
    last = [4] * k
    while not group.finished():
        rows = [None if group.done[b] else logp[last[b]].numpy()
                for b in range(k)]
        group.apply(group.select(rows))
        last = [t[-1] for t in group.tokens]
    toks, scores, lens = group.finalize()
    np.testing.assert_array_equal(np.asarray(toks), want[0][0].numpy())
    np.testing.assert_array_equal(scores, want[1][0].numpy())
    np.testing.assert_array_equal(lens, want[2][0].numpy())


@pytest.mark.parametrize("seed", [11, 19])
def test_beam_parity_against_jax_generate(beam_ref, ceng, seed):
    """COW-forked beam search over the continuous batch returns the JAX
    dense path's ranked beams: tokens and lens equal, scores rtol 1e-5;
    ``tokens`` is the winner cut after its eos."""
    p = _beam_prompt(seed)
    h, sched = _run(ceng, SamplingParams(beam=K), p, eos_id=0)
    ref = beam_ref(p)
    _assert_beams(h, ref)
    assert h.tokens == [int(t) for t in ref[0][0][:len(h.tokens)]]
    assert sched.counters["beam_groups"] == 1
    assert sched.counters["forks"] > 0
    assert sched.counters["fork_cow_blocks"] > 0
    assert ceng.trace_count() == ceng.traces_after_warm
    census = sched.check_block_accounting()
    assert census["occupied"] == 0 and census["referenced"] == 0


def test_beam_joins_mid_flight_without_disturbing_batch_mates(beam_ref,
                                                              params):
    """A beam group admitted while greedy streams are mid-flight leaves
    their streams bitwise equal to the same requests served without it
    (prompts shorter than a block: never cached, so both runs take the
    same path) and still matches the JAX beams."""
    eng = ContinuousDecodeEngine(params, n_slots=6, block_size=8,
                                 prompt_buckets=(8, 16), prefix_cache=True,
                                 device="cpu", **CFG)
    n_sig = eng.warm()
    mates = [(_prompt(50 + i, n=5 + i), 14) for i in range(3)]
    alone = ContinuousScheduler(eng)
    hs = [alone.submit(p, g) for p, g in mates]
    alone.run_until_idle()
    solo = [h.result(1) for h in hs]

    bp = _beam_prompt(13)
    sched = ContinuousScheduler(eng)
    gs = [sched.submit(p, g) for p, g in mates]
    for _ in range(3):
        sched.step()
    hb = sched.submit(bp, G, eos_id=0, sampling=SamplingParams(beam=K))
    sched.run_until_idle()
    assert hb.error is None, hb.error
    _assert_beams(hb, beam_ref(bp))
    for a, g in zip(solo, gs):
        np.testing.assert_array_equal(a, g.result(1))
    assert eng.trace_count() == n_sig


def test_parallel_n_reproducible_and_resume_prefix_rejected(ceng):
    """Branch 0 is the plain sampled stream of the root seed; the branches
    differ from each other; the same n-request served twice from the same
    cache state gives the same streams; the children map the root's
    registered prompt block; a parallel-n root cannot resume."""
    p = _prompt(3)
    sp = dict(temperature=0.8, top_k=12, seed=123)
    _run(ceng, SamplingParams(**sp, n=3), p, g=12)   # primes the cache
    runs, scheds = [], []
    for _ in range(2):
        h, s = _run(ceng, SamplingParams(**sp, n=3), p, g=12)
        runs.append([list(b.result(1)) for b in h.branches])
        scheds.append(s)
    assert runs[0] == runs[1]
    assert len({tuple(t) for t in runs[0]}) == 3
    root, _ = _run(ceng, SamplingParams(**sp), p, g=12)
    assert runs[0][0] == root.tokens
    assert scheds[0].counters["forks"] == 2
    assert scheds[0].counters["fork_cow_blocks"] > 0
    assert scheds[0].counters["fork_private"] == 0
    with pytest.raises(ValueError, match="parallel-n"):
        ContinuousScheduler(ceng).submit(
            _prompt(9), 8, resume_prefix=[1, 2],
            sampling=SamplingParams(temperature=0.5, n=3))
    assert ceng.trace_count() == ceng.traces_after_warm


def test_fork_fault_degrades_to_private_copy_beams_unchanged(beam_ref,
                                                             ceng):
    """With ``serving.fork`` armed every fork is a private full-lineage
    re-prefill (counted), and the beams still equal the JAX package's."""
    p = _beam_prompt(17)
    faults.inject("serving.fork", RuntimeError("fork path down"))
    try:
        h, sched = _run(ceng, SamplingParams(beam=K), p, eos_id=0)
        assert faults.fired("serving.fork") >= 1
    finally:
        faults.clear()
    _assert_beams(h, beam_ref(p))
    assert sched.counters["fork_private"] > 0
    assert sched.counters["fork_cow_blocks"] == 0
    sched.check_block_accounting()
    assert ceng.trace_count() == ceng.traces_after_warm


def test_fork_prune_retire_churn_keeps_the_partition(ceng):
    """Greedy, sampled, parallel-n and beam requests mixed: forks, prunes,
    parks and retires prepare no signature, and the partition ends clean
    with every cached block unreferenced."""
    sched = ContinuousScheduler(ceng)
    hs = [sched.submit(_prompt(60), 8),
          sched.submit(_prompt(61), 8, sampling=SamplingParams(
              temperature=0.7, top_k=10, seed=5)),
          sched.submit(_prompt(62), 6, sampling=SamplingParams(
              temperature=0.9, seed=6, n=2))]
    for _ in range(4):
        sched.step()
        sched.check_block_accounting()
    hs.append(sched.submit(_beam_prompt(63), 8, eos_id=0,
                           sampling=SamplingParams(beam=3)))
    for _ in range(200):
        if not sched.step() and not sched.stats()["slots_active"]:
            break
        sched.check_block_accounting()
    for h in hs:
        assert h.done.is_set() and h.error is None, h.error
    assert ceng.trace_count() == ceng.traces_after_warm
    census = sched.check_block_accounting()
    assert census["occupied"] == 0 and census["referenced"] == 0
    assert census["free"] + census["cached"] == ceng.pool.n_blocks
