"""paddle_tpu_torch's seq2seq + attention (``models/seq2seq.py``) against the
JAX package on the CPU, at the JAX test's sizes (``tests/test_models.py``:
Ts 6, Tt 5, Vs 20, Vt 18, emb 16, hidden 16, B 8): the same persistable
names and shapes; one step's loss and every gradient (from N(0, 0.3^2)
weights, and from the JAX startup's weights carried in with
``load_scope``), and five Adam steps from the startup's weights; the JAX
test's 30-step learning check on the port; the beam decoder mirrored and
held against the JAX package over 8 seeds; ``Executor.warm`` of the
train and the beam programs, bitwise equal to eager runs; and
``tools/train_profile.py``'s seq2seq classes on a CPU step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models.seq2seq  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid

CPU = tfluid.CPUPlace()
Ts, Tt, Vs, Vt, EMB, HID, B = 6, 5, 20, 18, 16, 16, 8
# the decoder test's sizes (tests/test_models.py:105-123)
BTs, BVs, BVt, BEMB, BEAM, BLEN = 5, 12, 10, 8, 3, 7


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _build_train(fl, lr=5e-3):
    src = fl.layers.data("src", [Ts], dtype="int32")
    slen = fl.layers.data("slen", [-1], dtype="int32",
                          append_batch_size=False)
    tgt = fl.layers.data("tgt", [Tt], dtype="int32")
    tlen = fl.layers.data("tlen", [-1], dtype="int32",
                          append_batch_size=False)
    lab = fl.layers.data("lab", [Tt, 1], dtype="int32")
    loss = fl.models.seq2seq.train_net(src, slen, tgt, tlen, lab, Vs, Vt,
                                       emb_dim=EMB, hidden=HID)
    fl.optimizer.Adam(lr).minimize(loss)
    return loss


def _train_feed(rng, const_label=False):
    """The JAX test's batch: lengths 2..T, random ids; with
    ``const_label`` its learnable task (every target 3)."""
    lab = (np.full((B, Tt, 1), 3, "int32") if const_label
           else rng.randint(0, Vt, (B, Tt, 1)).astype("int32"))
    return {"src": rng.randint(0, Vs, (B, Ts)).astype("int32"),
            "slen": rng.randint(2, Ts + 1, (B,)).astype("int32"),
            "tgt": rng.randint(0, Vt, (B, Tt)).astype("int32"),
            "tlen": rng.randint(2, Tt + 1, (B,)).astype("int32"),
            "lab": lab}


def _jax_start():
    """Run the JAX startup program; returns its executor and every
    persistable as numpy (the weights the port is given)."""
    exe = jfluid.Executor()
    exe.run(jfluid.default_startup_program())
    return exe, {n: np.asarray(v) for n, v in jfluid.global_scope().items()}


def _port_start(weights):
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    tfluid.load_scope(weights, tfluid.default_main_program(),
                      tfluid.global_scope(), device="cpu")
    return exe


def _dtype_name(dt):
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def test_program_matches_jax():
    """The same persistable names, shapes and dtypes in the main and the
    startup programs, and the same op types in the main program (the
    decoder is one ``static_rnn`` op in both)."""
    _build_train(jfluid)
    _build_train(tfluid)
    for jp, tp in ((jfluid.default_main_program(),
                    tfluid.default_main_program()),
                   (jfluid.default_startup_program(),
                    tfluid.default_startup_program())):
        jv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in jp.persistable_vars()}
        tv = {v.name: (tuple(v.shape), _dtype_name(v.dtype))
              for v in tp.persistable_vars()}
        assert tv == jv
    jops = [o.type for o in jfluid.default_main_program().list_ops()]
    assert [o.type for o in tfluid.default_main_program().list_ops()] == jops
    assert jops.count("static_rnn") == 1 and jops.count("dynamic_gru") == 2
    params = [p.name for p in tfluid.default_main_program().parameters()]
    assert params == [p.name
                      for p in jfluid.default_main_program().parameters()]
    assert "gru_unit_w_0" in params and "dynamic_gru_w_1" in params


def test_one_step_loss_and_gradients_match_jax():
    """One step from the same weights: the loss within rtol 1e-5, every
    gradient within 1e-5 of its max abs.  The parameters are N(0, 0.3^2)
    from numpy, in both packages: from the startup's Xavier weights the
    attention projection's gradient (``fc_w_4``) is 1e-9 against 1e-2
    for the others, the remainder of a score shift that the softmax
    cancels, so both packages' values are float32 rounding (5e-4 of its
    max apart); at this scale it carries signal and agrees within 1e-6.
    The startup's own weights: the next test."""
    feed = _train_feed(np.random.RandomState(3))
    jloss = _build_train(jfluid)
    params = jfluid.default_main_program().parameters()
    fetch = [f"{p.name}@GRAD" for p in params]
    jexe, weights = _jax_start()
    rng = np.random.RandomState(0)
    for p in params:
        weights[p.name] = (0.3 * rng.standard_normal(p.shape)).astype(
            np.float32)
        jfluid.global_scope().set_var(p.name, jnp.asarray(weights[p.name]))
    want = [np.asarray(a) for a in jexe.run(feed=feed,
                                            fetch_list=[jloss] + fetch)]
    tloss = _build_train(tfluid)
    got = _port_start(weights).run(feed=feed, fetch_list=[tloss] + fetch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch, got[1:], want[1:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= 1e-5 * scale, name


# a gradient whose max |g| is below this share of the step's largest is
# float32 rounding noise (fc_w_4 at the startup's weights, about 1e-8;
# the next smallest, fc_w_2, about 3e-5)
NOISE_SHARE = 1e-6


def test_one_step_gradients_match_jax_at_startup_weights():
    """One step from the JAX startup's own (Xavier) weights carried in with
    ``load_scope``: the loss within rtol 1e-5, every gradient within 1e-5
    of its max abs, except one that is rounding noise (max |g| below
    NOISE_SHARE of the step's largest; printed): that one within 1e-5 of
    the step's largest max |g|, and at most one such."""
    feed = _train_feed(np.random.RandomState(3))
    jloss = _build_train(jfluid)
    params = jfluid.default_main_program().parameters()
    fetch = [f"{p.name}@GRAD" for p in params]
    jexe, weights = _jax_start()
    want = [np.asarray(a) for a in jexe.run(feed=feed,
                                            fetch_list=[jloss] + fetch)]
    tloss = _build_train(tfluid)
    got = _port_start(weights).run(feed=feed, fetch_list=[tloss] + fetch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    top = max(float(np.abs(b).max()) for b in want[1:])
    noise = []
    for name, a, b in zip(fetch, got[1:], want[1:]):
        scale = float(np.abs(b).max())
        if scale < NOISE_SHARE * top:
            noise.append(name)
            print(f"{name}: rounding noise, max |g| {scale:.3e} against "
                  f"{top:.3e}; max |d| {np.abs(a - b).max():.3e}")
            scale = top
        assert np.abs(a - b).max() <= 1e-5 * scale, name
    assert len(noise) <= 1, noise


def test_five_adam_steps_match_jax():
    """Five Adam(5e-3) steps on fresh batches from the same weights: the
    losses within 1e-4 relative."""
    rng = np.random.RandomState(4)
    feeds = [_train_feed(rng) for _ in range(5)]
    jloss = _build_train(jfluid)
    jexe, weights = _jax_start()
    want = [float(np.asarray(jexe.run(feed=f, fetch_list=[jloss])[0]))
            for f in feeds]
    tloss = _build_train(tfluid)
    texe = _port_start(weights)
    got = [float(texe.run(feed=f, fetch_list=[tloss])[0]) for f in feeds]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_seq2seq_trains():
    """``tests/test_models.py::test_seq2seq_trains`` on the port: 30
    Adam(5e-3) steps on the constant-target task, last loss below 0.7 x
    the first."""
    loss = _build_train(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    rng = np.random.RandomState(3)
    losses = [float(exe.run(feed=_train_feed(rng, const_label=True),
                            fetch_list=[loss])[0]) for _ in range(30)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0] * 0.7, losses


def _build_decoder(fl):
    src = fl.layers.data("src", [BTs], dtype="int32")
    slen = fl.layers.data("slen", [-1], dtype="int32",
                          append_batch_size=False)
    return fl.models.seq2seq.beam_search_decoder(
        src, slen, BVs, BVt, bos_id=0, eos_id=1, beam_size=BEAM,
        max_len=BLEN, emb_dim=BEMB, hidden=BEMB)


def _decoder_feed(seed, n=2):
    rng = np.random.RandomState(seed)
    return {"src": rng.randint(0, BVs, (n, BTs)).astype("int32"),
            "slen": rng.randint(1, BTs + 1, (n,)).astype("int32")}


def test_seq2seq_beam_search_decodes():
    """``tests/test_models.py::test_seq2seq_beam_search_decodes`` on the
    port: shapes, int32 tokens, scores sorted best-first."""
    toks, scores = _build_decoder(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    rng = np.random.RandomState(4)
    t, s = exe.run(feed={"src": rng.randint(0, BVs, (2, BTs)).astype("int32"),
                         "slen": np.array([5, 3], "int32")},
                   fetch_list=[toks, scores])
    assert t.shape == (2, BEAM, BLEN) and s.shape == (2, BEAM)
    assert t.dtype == np.int32
    assert np.all(np.diff(s, axis=1) <= 1e-5)


def test_beam_decoder_matches_jax_over_seeds():
    """The decoder on the JAX startup's weights, 8 seeds of 2 sources
    (lengths 1..5): every beam's score within 1e-5 of JAX's, and tokens
    equal in at least 0.98 of the positions (float32 sums in another order
    may flip a near-tied choice, ROADMAP C.5)."""
    jt, js = _build_decoder(jfluid)
    jexe, weights = _jax_start()
    tt, ts = _build_decoder(tfluid)
    texe = _port_start(weights)
    equal = total = 0
    worst = 0.0
    for seed in range(8):
        feed = _decoder_feed(seed)
        wt, ws = (np.asarray(a) for a in jexe.run(feed=feed,
                                                  fetch_list=[jt, js]))
        gt, gs = texe.run(feed=feed, fetch_list=[tt, ts])
        worst = max(worst, float(np.abs(gs - ws).max()))
        equal += int((gt == wt).sum())
        total += gt.size
    print(f"beam decoder against JAX: {equal} of {total} token positions "
          f"equal, worst score difference {worst:.2e}")
    assert worst <= 1e-5
    assert equal >= 0.98 * total, (equal, total)


# ------------------------------------------------------------ warm


def _warm_against_eager(build, weights, feeds, fetch_of):
    """Run ``feeds`` through the program ``build()`` makes by an Executor
    that warmed its signature first and by one that did not, from the same
    weights: every fetch of every run and every state tensor after the
    last must be bitwise equal."""
    runs = []
    for warm in (True, False):
        tfluid.reset_default_programs()
        fetch = fetch_of(build(tfluid))
        main = tfluid.default_main_program()
        exe, scope = tfluid.Executor(CPU), tfluid.Scope()
        exe.run(tfluid.default_startup_program(), scope=scope)
        tfluid.load_scope(weights, main, scope, device="cpu")
        if warm:
            sig = [(n, v.shape, v.dtype.name) for n, v in feeds[0].items()]
            assert exe.warm(main, sig, fetch, scope=scope) == "compiled"
            assert exe.warm(main, sig, fetch, scope=scope) == "cached"
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


def test_warmed_train_steps_bitwise_equal_eager():
    """Three warmed train steps (the body on static buffers) against three
    eager ones: the loss and every gradient of each step, then every
    parameter, moment and optimizer step."""
    _build_train(jfluid)
    _, weights = _jax_start()
    rng = np.random.RandomState(5)
    feeds = [_train_feed(rng) for _ in range(3)]
    params = [p.name for p in jfluid.default_main_program().parameters()]
    outs = _warm_against_eager(
        _build_train, weights, feeds,
        lambda loss: [loss] + [f"{n}@GRAD" for n in params])
    assert len(outs[0]) == 1 + len(params)


def test_warmed_beam_decode_bitwise_equal_eager():
    """The beam decoder warmed: tokens and scores of two batches bitwise
    equal to eager runs."""
    _build_decoder(jfluid)
    _, weights = _jax_start()
    feeds = [_decoder_feed(s, n=3) for s in (10, 11)]
    outs = _warm_against_eager(_build_decoder, weights, feeds, list)
    assert outs[0][0].shape == (3, BEAM, BLEN)


def test_profile_classes_resolve_the_backward_by_forward_op():
    """``tools/train_profile.py``'s seq2seq classes on a CPU step: each op
    runs in its ``s2s::<class>`` range (``_OpRanges`` with a label), and
    every autograd node of the backward is named by the forward op that
    made it, so the GRU, attention and output classes all reach the
    backward; ``_OpRanges()`` alone still names ranges ``op::<type>``."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.tools import train_profile as tp

    _build_train(jfluid)
    _, weights = _jax_start()
    loss = _build_train(tfluid)
    main = tfluid.default_main_program()
    exe = _port_start(weights)
    feed = _train_feed(np.random.RandomState(6))
    classes = tp.seq2seq_op_classes(main)
    assert set(classes.values()) == {"gru", "attention", "output_ce",
                                     "optimizer", "other"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tp._OpRanges(lambda op: tp._S2S + classes.get(id(op), "other")):
            exe.run(main, feed=feed, fetch_list=[loss])
    events = prof.events()
    assert any(e.name == "s2s::optimizer" for e in events)
    name = tp.seq2seq_range_names(events)
    nodes = [e for e in events if e.name.startswith(tp._NODE)]
    assert nodes
    backward = {tp._seq2seq_class("k", [name(a) for a in tp._chain(e)])
                for e in nodes}
    assert {"gru", "attention", "output_ce"} <= backward, backward
    assert tp._seq2seq_class("multi_tensor_apply_kernel", ["s2s::gru"]) \
        == "optimizer"
    assert tp._beam_class("radixSortKernel", ["x", "s2s::beam"]) \
        == "beam_select"
    assert tp._beam_class("gemm", ["s2s::other"]) == "encoder"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tp._OpRanges():
            exe.run(main, feed=feed, fetch_list=[loss])
    ranges = {e.name for e in prof.events() if e.name.startswith("op::")}
    assert {"op::static_rnn", "op::dynamic_gru", "op::adam"} <= ranges
