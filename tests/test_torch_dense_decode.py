"""paddle_tpu_torch's dense decode path and migration records against the
JAX package on the CPU, at the reference's own test size and on the same
weights: the dense KV forms (``init_kv_cache``, ``cache_set``,
``cache_set_prefix``, ``decode_attention``) and ``lm_decode_step`` within
1e-5, ``DecodeEngine.generate`` token-equal to the reference's engine at
the greedy floor, ``generate_naive`` against ``generate``, the
``models.transformer.generate`` program op against the reference's in
float32 (tokens and lens equal, scores rtol 1e-5) and bfloat16,
``snapshot_slots`` records field for field, and a drained-and-resumed
stream against the uninterrupted one."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import ops as jops
from paddle_tpu.models import transformer as jtf
from paddle_tpu.serving import ContinuousDecodeEngine as JaxCEngine
from paddle_tpu.serving import ContinuousScheduler as JaxScheduler
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.serving.sampling import SamplingParams as JaxSamplingParams
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.models import transformer as ttf
from paddle_tpu_torch.models.weights import from_jax_params
from paddle_tpu_torch.serving import (ContinuousDecodeEngine,
                                      ContinuousScheduler, DecodeEngine,
                                      GenerationMigrated, SamplingParams)

CFG = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
           d_ff=64)
ATOL = 1e-5           # float32 sums in another order, one layer or step
MATCH_FLOOR = 0.98    # greedy token-match rate
BF16_AGREE = 0.9      # tests/test_beam.py's bf16 decode agreement rule


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return jtf.init_lm_params(7, **CFG)


def _prompts(seed, n, t):
    return np.random.RandomState(seed).randint(
        1, CFG["vocab_size"], (n, t)).astype(np.int32)


def _match_rate(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((a == b).mean())


def jnp_dtype(name):
    import jax.numpy as jnp

    return jnp.dtype(name)


# ------------------------------------------------------------ the forms


def test_dense_kv_forms_against_jax():
    """cache_set at a Python int and at a staged tensor position,
    cache_set_prefix and decode_attention (float32 and a bfloat16
    out_dtype) against the reference on the same numpy inputs."""
    rng = np.random.RandomState(0)
    B, L, H, T, Dh = 3, 2, 2, 16, 8
    jk, jv = jops.init_kv_cache(B, L, H, T, Dh)
    tk, tv = tops.init_kv_cache(B, L, H, T, Dh)
    assert tuple(tk.shape) == jk.shape and tk.dtype == torch.float32
    pre = rng.randn(B, H, 6, Dh).astype(np.float32)
    jk = jops.cache_set_prefix(jk, 1, pre)
    tops.cache_set_prefix(tk, 1, torch.from_numpy(pre))
    for pos in (6, 7):
        new = rng.randn(B, H, Dh).astype(np.float32)
        jk = jops.cache_set(jk, 1, pos, new)
        tpos = pos if pos == 6 else torch.tensor([pos], dtype=torch.int32)
        tops.cache_set(tk, 1, tpos, torch.from_numpy(new))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    jv = jops.cache_set_prefix(jv, 1, rng.randn(B, H, T, Dh).astype(
        np.float32))
    tv.copy_(torch.from_numpy(np.array(jv)))
    q = rng.randn(B, H, Dh).astype(np.float32)
    for length in (1, 8, torch.tensor([8], dtype=torch.int32)):
        jl = length if isinstance(length, int) else 8
        for od in (None, "bfloat16"):
            jo = jops.decode_attention(
                q, jk[:, 1], jv[:, 1], jl,
                out_dtype=None if od is None else jnp_dtype(od))
            to = tops.decode_attention(
                torch.from_numpy(q), tk[:, 1], tv[:, 1], length,
                out_dtype=None if od is None else torch.bfloat16)
            tol = ATOL if od is None else 1e-2
            np.testing.assert_allclose(to.float().numpy(),
                                       np.asarray(jo, np.float32),
                                       atol=tol, rtol=0)


def test_lm_decode_step_against_jax(params):
    """Prefill caches from the reference's forward, then three decode
    steps in both packages (the position a Python int, then a staged
    tensor): logits within 1e-5, and the caches' new positions too."""
    prm_j = jtf._srv_cast_params({n: np.asarray(v) for n, v in
                                  params.items()}, np.float32)
    prm_t = ttf._srv_cast_params(from_jax_params(params, device="cpu",
                                                 **CFG), torch.float32)
    kw = dict(n_heads=CFG["n_heads"], n_layers=CFG["n_layers"])
    toks = _prompts(1, 2, 9)
    _, kvs = jtf.lm_forward(prm_j, toks, collect_kv=True, **kw)
    Dh = CFG["d_model"] // CFG["n_heads"]
    jk, jv = jops.init_kv_cache(2, CFG["n_layers"], CFG["n_heads"],
                                CFG["max_len"], Dh)
    for i, (kh, vh) in enumerate(kvs):
        jk = jops.cache_set_prefix(jk, i, kh)
        jv = jops.cache_set_prefix(jv, i, vh)
    tk = torch.from_numpy(np.array(jk))
    tv = torch.from_numpy(np.array(jv))
    tok = toks[:, -1]
    for step, pos in enumerate((9, 10, 11)):
        jl, jk, jv = jtf.lm_decode_step(prm_j, tok, pos, jk, jv, **kw)
        tpos = pos if step == 0 else torch.tensor([pos], dtype=torch.int32)
        tl, tk, tv = ttf.lm_decode_step(prm_t, torch.from_numpy(tok), tpos,
                                        tk, tv, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(tk[:, :, :, pos].numpy(),
                                   np.asarray(jk)[:, :, :, pos], atol=ATOL,
                                   rtol=0)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


# ------------------------------------------------------- DecodeEngine


@pytest.fixture(scope="module")
def engines(params):
    kw = dict(prompt_buckets=(8, 16), batch_buckets=(1, 4), **CFG)
    return JaxDecodeEngine(params, **kw), DecodeEngine(params, device="cpu",
                                                       **kw)


def test_decode_engine_generate_against_jax(engines):
    """Batch 3 (padded to the bucket of 4) at two prompt lengths: tokens
    at the greedy floor against the reference's engine, eos freezing
    rows as there; ``warm`` prepares (batch buckets x prompt buckets) +
    batch buckets signatures and ``generate`` prepares none after it."""
    je, te = engines
    assert te.prompt_buckets == je.prompt_buckets == [8, 16]
    assert te.warm() == 2 * 2 + 2
    n = te.trace_count()
    for seed, tp, g, eos in ((3, 7, 20, None), (4, 13, 16, 5)):
        pr = _prompts(seed, 3, tp)
        jt = je.generate(pr, g, eos_id=eos)
        tt = te.generate(pr, g, eos_id=eos)
        assert tt.shape == jt.shape
        assert _match_rate(tt, jt) >= MATCH_FLOOR
    assert te.trace_count() == n
    assert sum(te.dispatches.values()) > 0
    assert te.cache_bytes == 2 * 4 * (1 + 4) * CFG["n_layers"] * \
        CFG["n_heads"] * CFG["max_len"] * (CFG["d_model"] // CFG["n_heads"])


def test_generate_naive_against_generate(engines):
    """The full-recompute arm gives the KV-cached arm's tokens, and
    ``measure`` reports both rates."""
    _, te = engines
    pr = _prompts(5, 3, 9)
    np.testing.assert_array_equal(te.generate_naive(pr, 12),
                                  te.generate(pr, 12))
    m = te.measure(2, 9, 8)
    assert m["tokens_match"] and m["kv_decode_tokens_per_sec"] > 0


# --------------------------------------------------- generate, the op


def _port_generate(params, pr, beam, g, dtype, lp=0.0):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        pv = tfluid.layers.data("prompt", [pr.shape[1]], dtype="int32")
        outs = tfluid.models.transformer.generate(
            pv, CFG["vocab_size"], max_len=CFG["max_len"], eos_id=0,
            d_model=CFG["d_model"], n_heads=CFG["n_heads"],
            n_layers=CFG["n_layers"], d_ff=CFG["d_ff"], beam_size=beam,
            max_gen=g, decode_dtype=dtype, length_penalty=lp)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    tfluid.load_scope(params, main, scope, device="cpu")
    return exe.run(main, feed={"prompt": pr}, fetch_list=list(outs),
                   scope=scope)


def _jax_generate(params, pr, beam, g, dtype, lp=0.0):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        pv = jfluid.layers.data("prompt", [pr.shape[1]], dtype="int32")
        outs = jfluid.models.transformer.generate(
            pv, CFG["vocab_size"], max_len=CFG["max_len"], eos_id=0,
            d_model=CFG["d_model"], n_heads=CFG["n_heads"],
            n_layers=CFG["n_layers"], d_ff=CFG["d_ff"], beam_size=beam,
            max_gen=g, decode_dtype=dtype, length_penalty=lp)
    scope = jfluid.Scope()
    exe = jfluid.Executor()
    exe.run(startup, scope=scope)
    for name, val in params.items():
        scope.set_var(name, np.asarray(val))
    return exe.run(main, feed={"prompt": pr}, fetch_list=list(outs),
                   scope=scope)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_op_against_jax(params, dtype):
    """The program op on 3 prompts, beam 3, a length penalty: in float32
    tokens and lens equal and scores rtol 1e-5; in bfloat16 (both packages
    round at the same points but sum in another order) tokens agree in
    >= 0.9 of positions, as the reference holds its bf16 decode against
    float32, scores within 2e-2 relative, and beams sorted best first."""
    pr = _prompts(6, 3, 8)
    jt, js, jl = _jax_generate(params, pr, 3, 8, dtype, lp=0.6)
    tt, ts, tl = _port_generate(params, pr, 3, 8, dtype, lp=0.6)
    assert tt.shape == jt.shape == (3, 3, 8) and tt.dtype == np.int32
    if dtype == "float32":
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
    else:
        assert _match_rate(tt, jt) >= BF16_AGREE
        np.testing.assert_allclose(ts, js, rtol=2e-2, atol=0)
        assert (ts[:, :-1] >= ts[:, 1:] - 1e-6).all()


# ----------------------------------------------------- migration records


@pytest.fixture(scope="module")
def cont(params):
    kw = dict(n_slots=4, block_size=8, prompt_buckets=(8, 16), **CFG)
    return JaxCEngine(params, **kw), ContinuousDecodeEngine(
        params, device="cpu", **kw)


def _snap_pair(cont, drain):
    reqs = [(_prompts(10 + i, 1, 5 + 2 * i)[0], 12 + i) for i in range(6)]
    out = []
    for eng, Sched, SP in zip(cont, (JaxScheduler, ContinuousScheduler),
                              (JaxSamplingParams, SamplingParams)):
        sched = Sched(eng)
        hs = []
        for i, (p, g) in enumerate(reqs):
            sp = SP(temperature=0.7, seed=40 + i) if i == 2 else None
            hs.append(sched.submit(p, g, eos_id=None, sampling=sp))
        for _ in range(5):
            sched.step()
        out.append((sched, hs, sched.snapshot_slots(drain=drain)))
    return reqs, out


def test_snapshot_records_against_jax_field_for_field(cont):
    """The same requests, five steps, ``snapshot_slots()``: the same
    records in the same order, every field equal but the request ids and
    the tokens (greedy streams at the floor, the sampled one its own);
    a drain's records likewise, every local waiter failing with
    ``GenerationMigrated``, nothing leaked, ``migrated_out`` counted."""
    for drain in (False, True):
        _, ((js, jh, jrec), (ts, th, trec)) = _snap_pair(cont, drain)
        assert len(trec) == len(jrec) == 6
        for a, b in zip(trec, jrec):
            assert set(a) == set(b)
            for k in a:
                if k in ("id", "tokens"):
                    continue
                assert a[k] == b[k], (k, a[k], b[k])
        greedy = [i for i in range(6) if i != 2]
        assert _match_rate(
            np.concatenate([trec[i]["tokens"] for i in greedy]),
            np.concatenate([jrec[i]["tokens"] for i in greedy])) \
            >= MATCH_FLOOR
        if drain:
            for h in th:
                with pytest.raises(GenerationMigrated):
                    h.result(0)
            assert ts.counters["migrated_out"] == 6
            census = ts.check_block_accounting()
            assert census["occupied"] == 0 and census["leaked"] == 0
        else:
            js.run_until_idle()
            ts.run_until_idle()


def test_drained_and_resumed_stream_against_uninterrupted(cont):
    """Streams drained after five steps and resumed from their records on
    a new scheduler (``resume_prefix``) continue as the uninterrupted
    streams do: greedy at the floor, the sampled one identical (its draws
    depend on the seed and the token index only)."""
    _, te = cont
    reqs = [(_prompts(30 + i, 1, 6 + 3 * i)[0], 14) for i in range(4)]
    sps = [None, SamplingParams(temperature=0.8, seed=9), None, None]
    whole = ContinuousScheduler(te)
    hw = [whole.submit(p, g, sampling=sp) for (p, g), sp in zip(reqs, sps)]
    whole.run_until_idle()
    part = ContinuousScheduler(te)
    for (p, g), sp in zip(reqs, sps):
        part.submit(p, g, sampling=sp)
    for _ in range(5):
        part.step()
    recs = part.snapshot_slots(drain=True)
    part.check_block_accounting()
    again = ContinuousScheduler(te)
    hr = [again.submit(np.asarray(r["prompt"], np.int32), r["max_gen"],
                       resume_prefix=r["tokens"],
                       sampling=SamplingParams.from_record(r["sampling"]))
          for r in recs]
    again.run_until_idle()
    assert again.counters["resumed_in"] == sum(1 for r in recs
                                               if r["tokens"])
    got = {tuple(r["prompt"]): h.result(1) for r, h in zip(recs, hr)}
    for (p, _), sp, h in zip(reqs, sps, hw):
        if sp is None:
            assert _match_rate(got[tuple(p)], h.result(1)) >= MATCH_FLOOR
        else:
            np.testing.assert_array_equal(got[tuple(p)], h.result(1))
    census = again.check_block_accounting()
    assert census["occupied"] == 0 and census["leaked"] == 0
