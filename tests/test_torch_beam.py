"""paddle_tpu_torch's beam search (``layers/beam.py``) against the JAX
package on the CPU: the JAX package's beam tests mirrored on the port, with
tokens, scores and lens bitwise equal to JAX's on the Markov-table cases
(a table lookup has no matmul: the same float32 additions); JAX's
``lax.top_k`` order (ties toward the lower index, -0.0 below 0.0) on
crafted ties; and the fixed-count loop, which runs ``max_len`` steps, equal
to the JAX package's early-exit ``while_loop`` where every row finishes
long before ``max_len``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.layers.beam as jbeam
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.layers.beam as tbeam

CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _jax_table_step(last, states, statics, params):
    (tbl,) = params
    return tbl[last], states


def _torch_table_step(last, states, statics, params):
    (tbl,) = params
    return tbl[last.long()], states


def _jax_sum_step(last, states, statics, params):
    (acc,) = states
    (tbl,) = params
    return tbl[last], [acc + last[:, None].astype(jnp.float32)]


def _torch_sum_step(last, states, statics, params):
    (acc,) = states
    (tbl,) = params
    return tbl[last.long()], [acc + last[:, None].to(torch.float32)]


def _beam_program(fl, table, step_fn, K, L, bos=1, eos=0,
                  length_penalty=0.0):
    """The table-driven beam program of ``tests/test_beam.py``: the table
    put into the program by ``assign``, a dummy [N, 1] state, the search
    and its 1-best decode."""
    beam = jbeam if fl is jfluid else tbeam
    tab = fl.layers.assign(table)
    state0 = fl.layers.data("s0", [1])
    toks, scores, lens = beam.beam_search(
        step_fn, [state0], [], [tab], bos_id=bos, eos_id=eos, beam_size=K,
        max_len=L, length_penalty=length_penalty)
    best = beam.beam_search_decode(toks, scores, lens)
    return [toks, scores, lens, *best]


def _run_both(table, K, L, N, seed_state=None, **kw):
    """The beam program in both packages on the same feed; returns (JAX's
    fetches, the port's) as numpy arrays."""
    feed = {"s0": np.zeros((N, 1), np.float32) if seed_state is None
            else seed_state}
    jstep, tstep = kw.pop("steps", (_jax_table_step, _torch_table_step))
    jf = _beam_program(jfluid, table, jstep, K, L, **kw)
    want = [np.asarray(a) for a in jfluid.Executor().run(feed=feed,
                                                         fetch_list=jf)]
    tf = _beam_program(tfluid, table, tstep, K, L, **kw)
    got = tfluid.Executor(CPU).run(feed=feed, fetch_list=tf)
    return want, got


def _assert_bitwise(want, got):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, a.dtype,
                                                          b.dtype)
        assert a.tobytes() == b.tobytes(), (i, a, b)


def _markov_table():
    V = 5
    table = np.full((V, V), -10.0, "float32")
    for s, nxt in {1: 2, 2: 3, 3: 0}.items():
        table[s, nxt] = -0.1
    table[0, 0] = 0.0
    return table


def test_beam_search_follows_markov_chain():
    """``tests/test_beam.py::test_beam_search_follows_markov_chain``: the
    best hypothesis is the chain 1 -> 2 -> 3 -> eos; every output (all
    beams' tokens, scores and lens, and the 1-best) bitwise equal to the
    JAX package's."""
    K, L, N = 3, 6, 2
    want, got = _run_both(_markov_table(), K, L, N)
    _assert_bitwise(want, got)
    toks, scores, lens, best_ids, best_len, best_score = got
    assert toks.dtype == lens.dtype == best_ids.dtype == np.int32
    assert toks.shape == (N, K, L) and scores.shape == (N, K)
    for n in range(N):
        assert list(best_ids[n][:3]) == [2, 3, 0], best_ids[n]
        assert best_len[n] == 2, best_len
        np.testing.assert_allclose(best_score[n], -0.1 * 3, atol=1e-4)


def test_beam_search_reindexes_state():
    """``tests/test_beam.py::test_beam_search_reindexes_state``: a state
    that carries the running token sum survives the beam reshuffles; every
    beam's score is the table sum along its own path, beams sorted, the
    best never below greedy; and every output bitwise equal to JAX's."""
    V, K, L = 4, 2, 4
    table = np.random.RandomState(0).randn(V, V).astype("float32")
    want, got = _run_both(table, K, L, 1,
                          steps=(_jax_sum_step, _torch_sum_step))
    _assert_bitwise(want, got)
    r_tok, r_sc = got[0], got[1]

    def path_score(seq):
        logp, last = 0.0, 1
        for t in seq:
            logp += table[last, t]
            last = t
            if t == 0:
                break
        return logp

    for k in range(K):
        np.testing.assert_allclose(float(r_sc[0, k]),
                                   path_score(list(r_tok[0, k])), atol=1e-4)
    assert r_sc[0, 0] >= r_sc[0, 1]
    greedy, last = 0.0, 1
    for _ in range(L):
        t = int(np.argmax(table[last]))
        greedy += table[last, t]
        last = t
        if t == 0:
            break
    assert float(r_sc[0, 0]) >= greedy - 1e-4


def test_greedy_fast_path_exactly_matches_general_beam1():
    """``tests/test_beam.py::test_greedy_fast_path_exactly_matches_general_
    beam1``: the beam-1 greedy loop gives the general frontier path's
    tokens, scores and lens exactly (per-row bos, length penalty 0.5); and
    JAX's: tokens and lens equal, scores within 1e-6 (each package's own
    log_softmax of the table)."""
    V, T, N = 9, 7, 4
    table = np.random.RandomState(3).randn(V, V).astype("float32")
    table[:, 0] += 0.5  # make eos reachable
    bos = np.array([1, 2, 3, 4], np.int32)

    def tstep(last, states):
        (count,) = states
        logp = torch.log_softmax(torch.from_numpy(table)[last.long()], -1)
        return logp, (count + 1,)

    def trun(force):
        return [a.numpy() for a in tbeam.beam_loop(
            tstep, (torch.zeros((N,), dtype=torch.int32),), N, bos_id=bos,
            eos_id=0, beam_size=1, max_len=T, length_penalty=0.5,
            _force_general=force)]

    def jstep(last, states):
        (count,) = states
        return (jax.nn.log_softmax(jnp.asarray(table)[last], axis=-1),
                (count + 1,))

    g, b = trun(False), trun(True)
    for x, y in zip(g, b):
        assert x.tobytes() == y.tobytes()
    want = [np.asarray(a) for a in jbeam.beam_loop(
        jstep, (jnp.zeros((N,), jnp.int32),), N,
        bos_id=jnp.asarray(bos), eos_id=0, beam_size=1, max_len=T,
        length_penalty=0.5)]
    np.testing.assert_array_equal(g[0], want[0])
    np.testing.assert_allclose(g[1], want[1], rtol=1e-6)
    np.testing.assert_array_equal(g[2], want[2])


def test_top_k_is_jax_order():
    """``top_k`` against ``jax.lax.top_k`` on rows full of ties: repeated
    values, -0.0 beside 0.0, ``_NEG + score`` as a finished beam proposes
    it, and negative values of equal magnitude; values and indices
    equal."""
    rng = np.random.RandomState(5)
    rows = [np.array([0.0, -0.0, 0.0, -0.0, -1.0, -1.0], np.float32),
            np.float32(-1e9) + np.array([-2.5, -2.5, -2.5, -3.0, 0.0, 0.0],
                                        np.float32),
            np.array([-1.5, 2.0, -1.5, 2.0, 2.0, -0.0], np.float32),
            rng.randint(-2, 3, 6).astype(np.float32)]
    x = np.stack(rows)
    for k in (1, 3, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tbeam.top_k(torch.from_numpy(x), k)
        assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert list(tbeam.top_k(torch.from_numpy(x[:1]), 2)[1][0]) == [0, 2]


def test_tied_candidates_break_as_jax_does():
    """A table whose rows tie across tokens (each live beam's best next
    tokens have equal log-probabilities, and two beams reach equal
    scores): K = 3 over 6 steps, all outputs bitwise equal to JAX's; the
    frontier holds equal scores, so the order among them is the tie
    rule's."""
    V = 6
    table = np.full((V, V), -2.0, np.float32)
    table[:, 0] = -3.0                       # eos possible, never best
    table[1, 2] = table[1, 3] = table[1, 4] = -0.5
    table[2, 5] = table[3, 5] = -0.25
    table[4, 1] = -0.25
    table[5, 0] = -0.5
    want, got = _run_both(table, 3, 6, 2)
    _assert_bitwise(want, got)
    scores = got[1]
    assert len(set(scores[0].tolist())) < 3   # ties in the frontier
    # with a length penalty the reorder is JAX's stable argsort too: tokens
    # and lens bitwise; the scores within 1e-6, since the penalty's float32
    # power rounds its last bit differently in XLA and torch
    want, got = _run_both(table, 3, 6, 2, length_penalty=0.7)
    for i in (0, 2, 3, 4):
        assert got[i].tobytes() == want[i].tobytes(), i
    for i in (1, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=0)


def test_fixed_count_loop_equals_early_exit():
    """Every row reaches eos within 4 steps of max_len 20: the JAX package's
    ``while_loop`` stops there, the port runs all 20 steps (its step
    function is called 20 times), and every output, for beam 3 and for the
    greedy beam 1, is bitwise equal to JAX's."""
    table = _markov_table()
    calls = []

    def counted(last, states, statics, params):
        calls.append(1)
        return _torch_table_step(last, states, statics, params)

    for K in (3, 1):
        calls.clear()
        tfluid.reset_default_programs()
        jfluid.reset_default_programs()
        want, got = _run_both(table, K, 20, 3,
                              steps=(_jax_table_step, counted))
        _assert_bitwise(want, got)
        assert len(calls) == 20
        lens = got[2]
        assert lens.max() <= 3 and np.all(got[0][:, :, 4:] == 0)
