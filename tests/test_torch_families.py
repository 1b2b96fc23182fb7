"""paddle_tpu_torch's book and demo families (``models.word2vec``,
``recommender``, ``traffic``, ``gan``, ``vae``) and their datasets
(``datasets.imikolov``, ``movielens``) against the JAX package on the
CPU:

* the synthetic readers sample for sample the reference's;
* each family built in both packages with the same parameter names and
  shapes, and one Adam step (GAN: one D step, then one G step) from the
  JAX startup's weights loaded by name: the loss within 1e-5 relative,
  every gradient within 1e-4 of its max abs and every parameter after the
  update within 1e-5 of its max abs (VAE: its noise, ``jax.random.normal``
  within ``NORMAL_ULPS``, is drawn in both at the same step counter);
* the JAX package's convergence tests mirrored at their thresholds
  (``tests/test_models.py``: vae :268, gan :285, word2vec :340,
  recommender :365, traffic :447), on the port's own initialisation;
* VAE's step warmed: a replay bitwise an unwarmed Executor's eager step
  at the same step counter (its noise too), new noise at s + 1;
* GAN's two programs warmed on one scope: alternating replays bitwise
  eager alternations, and the state each replay copies in from the other
  program's buffers (the parameters both read)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.models  # noqa: F401  (jfluid.models)
import paddle_tpu_torch as tfluid

CPU = tfluid.CPUPlace()
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
W2V_NAMES = ["w0", "w1", "w2", "w3"]
REC_NAMES = ["uid", "gender", "age", "job", "mid", "category"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


# ---------------------------------------------------------------- datasets


def test_imikolov_matches_the_reference():
    from paddle_tpu.datasets import imikolov as jimk
    from paddle_tpu_torch.datasets import imikolov

    assert imikolov.VOCAB_SIZE == jimk.VOCAB_SIZE == 2074
    assert imikolov.word_dict() == jimk.word_dict()
    assert (list(imikolov.train(n=5, n_synthetic=300)())
            == list(jimk.train(n=5, n_synthetic=300)()))
    assert (list(imikolov.test(n=3, n_synthetic=50)())
            == list(jimk.test(n=3, n_synthetic=50)()))
    with pytest.raises(NotImplementedError, match="A.12"):
        imikolov.train({"<unk>": 0})


def test_movielens_matches_the_reference():
    from paddle_tpu.datasets import movielens as jml
    from paddle_tpu_torch.datasets import movielens

    for name in ("N_USERS", "N_MOVIES", "N_AGES", "N_JOBS",
                 "N_CATEGORIES"):
        assert getattr(movielens, name) == getattr(jml, name)
    assert (movielens.N_USERS, movielens.N_MOVIES, movielens.N_AGES,
            movielens.N_JOBS, movielens.N_CATEGORIES) == (6040, 3952, 7, 21,
                                                          18)
    for got, want in ((movielens.train(200), jml._reader(200, 0)),
                      (movielens.test(40), jml._reader(40, 1))):
        a, b = list(got()), list(want())
        assert [s[:6] for s in a] == [s[:6] for s in b]
        np.testing.assert_array_equal([s[6] for s in a], [s[6] for s in b])
    with pytest.raises(NotImplementedError, match="A.12"):
        movielens.real_files()


# ---------------------------------------------------------------- builds


def _w2v(fl, V=50, emb=8, hidden=16):
    ws = [fl.layers.data(n, [1], dtype="int32") for n in W2V_NAMES]
    tgt = fl.layers.data("tgt", [1], dtype="int32")
    cost, _ = fl.models.word2vec.build(ws, tgt, vocab_size=V, emb_dim=emb,
                                       hidden=hidden)
    return cost


def _w2v_feed(grams, i, n=64, V=None):
    batch = [grams[(i * n + j) % len(grams)] for j in range(n)]
    arr = np.array(batch, "int32")
    if V is not None:
        arr = arr % V
    f = {nm: arr[:, k:k + 1] for k, nm in enumerate(W2V_NAMES)}
    f["tgt"] = arr[:, 4:5]
    return f


def _rec(fl, emb=8, fc=16):
    vars_ = [fl.layers.data(n, [1], dtype="int32") for n in REC_NAMES]
    rating = fl.layers.data("rating", [1])
    cost, _ = fl.models.recommender.build(*vars_, rating, emb_dim=emb,
                                          fc_size=fc)
    return cost


def _rec_feed(data, i, n=64):
    batch = [data[(i * n + j) % len(data)] for j in range(n)]
    f = {nm: np.array([[b[k]] for b in batch], "int32")
         for k, nm in enumerate(REC_NAMES)}
    f["rating"] = np.stack([b[6] for b in batch])
    return f


TERM, HORIZONS, CLASSES = 12, 6, 4


def _traffic(fl):
    enc = fl.layers.data("enc", [TERM])
    lab = fl.layers.data("lab", [HORIZONS], dtype="int32")
    loss, acc, _ = fl.models.traffic.build(enc, lab, term_num=TERM,
                                           forecasting_num=HORIZONS,
                                           num_classes=CLASSES)
    return loss, acc


def _traffic_feed(rng, n=64):
    xs = rng.randint(0, CLASSES, (n, TERM)).astype("float32")
    return {"enc": xs / (CLASSES - 1.0),
            "lab": xs[:, -HORIZONS:].astype("int32")}


def _vae(fl, D=64, hidden=32, latent=8):
    x = fl.layers.data("x", [D])
    return fl.models.vae.build(x, img_dim=D, hidden=hidden, latent=latent)[0]


def _vae_data(D=64):
    rng = np.random.RandomState(0)
    protos = (rng.rand(4, D) > 0.5).astype("float32")
    return protos[rng.randint(0, 4, 64)]


def _feed(family):
    if family == "word2vec":
        from paddle_tpu_torch.datasets import imikolov

        grams = list(imikolov.train(n=5, n_synthetic=64)())
        return _w2v_feed(grams, 0, n=8, V=50)
    if family == "recommender":
        from paddle_tpu_torch.datasets import movielens

        return _rec_feed(list(movielens.train(16)()), 0, n=8)
    if family == "traffic":
        return _traffic_feed(np.random.RandomState(3), n=8)
    return {"x": _vae_data()[:8]}


BUILDS = {"word2vec": _w2v, "recommender": _rec,
          "traffic": lambda fl: _traffic(fl)[0], "vae": _vae}


def _port_step_against(weights, feed, fetch, main, startup, loss_name,
                       step):
    """One step of the port's ``main`` on the CPU from ``weights`` at step
    counter ``step``: (its fetches, its scope)."""
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.load_scope(weights, main, scope, device="cpu")
    scope.step_counter = step
    got = exe.run(main, feed=feed, fetch_list=[loss_name] + fetch[1:],
                  scope=scope)
    return got, scope


def _compare(got, want, names, tstate, jstate):
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_TOL)
    for name, a, b in zip(names, got[1:], want[1:]):
        scale = max(float(np.abs(b).max()), 1e-30)
        assert np.abs(a - b).max() <= GRAD_TOL * scale, name
    for n, b in jstate.items():
        a = tstate.find_var(n).numpy()
        assert np.abs(a - b).max() <= FWD_TOL * np.abs(b).max(), n


@pytest.mark.parametrize("family", sorted(BUILDS))
def test_one_step_matches_jax(family):
    """One Adam step from the JAX startup's weights, at step counter 3 (the
    VAE draws its noise there)."""
    feed = _feed(family)

    def build(fl):
        fl.reset_default_programs()
        loss = BUILDS[family](fl)
        fl.optimizer.Adam(1e-3).minimize(loss)
        return loss

    jloss = build(jfluid)
    params = [p.name for p in jfluid.default_main_program().parameters()]
    shapes = [tuple(p.shape) for p in jfluid.default_main_program()
              .parameters()]
    fetch = [jloss] + [f"{n}@GRAD" for n in params]
    jexe = jfluid.Executor()
    jexe.run(jfluid.default_startup_program())
    weights = {n: np.asarray(jfluid.global_scope().find_var(n))
               for n in params}
    jfluid.global_scope().step_counter = 3
    want = [np.asarray(a) for a in jexe.run(feed=feed, fetch_list=fetch)]
    jstate = {n: np.asarray(jfluid.global_scope().find_var(n))
              for n in params}

    tloss = build(tfluid)
    main = tfluid.default_main_program()
    assert [p.name for p in main.parameters()] == params
    assert [tuple(p.shape) for p in main.parameters()] == shapes
    got, scope = _port_step_against(weights, feed, fetch, main,
                                    tfluid.default_startup_program(), tloss,
                                    step=3)
    _compare(got, want, fetch[1:], scope, jstate)


def _gan(fl, D_IMG=16, D_Z=8, hidden=32, lr=1e-3):
    return fl.models.gan.build(img_dim=D_IMG, z_dim=D_Z, hidden=hidden,
                               lr=lr)


def _gan_feeds(rng, B=8, D_IMG=16, D_Z=8):
    return ({"img": rng.uniform(-1, 1, (B, D_IMG)).astype("float32"),
             "z": rng.randn(B, D_Z).astype("float32")},
            {"z": rng.randn(B, D_Z).astype("float32")})


def test_gan_alternation_matches_jax():
    """One D step, then one G step, on one scope from the JAX startups'
    weights: the same names and the parameter lists of each side, D's and
    G's losses, their gradients and every parameter after each step."""
    fd, fg = _gan_feeds(np.random.RandomState(1))
    jspec = _gan(jfluid)
    jexe = jfluid.Executor()
    jexe.run(jspec["d_startup"])
    jexe.run(jspec["g_startup"])
    jscope = jfluid.global_scope()
    names = sorted({p.name for p in jspec["d_program"].parameters()})
    weights = {n: np.asarray(jscope.find_var(n)) for n in names}
    tspec = _gan(tfluid)
    assert tfluid.models.gan.G_PARAMS == jfluid.models.gan.G_PARAMS
    assert sorted(p.name for p in tspec["d_program"].parameters()) == names
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(tspec["d_startup"], scope=scope)
    exe.run(tspec["g_startup"], scope=scope)
    tfluid.load_scope(weights, tspec["d_program"], scope, device="cpu")
    for side, feed, plist in (("d", fd, jfluid.models.gan.D_PARAMS),
                              ("g", fg, jfluid.models.gan.G_PARAMS)):
        fetch = [f"{n}@GRAD" for n in plist]
        want = [np.asarray(a) for a in jexe.run(
            jspec[f"{side}_program"], feed=feed,
            fetch_list=[jspec[f"{side}_loss"]] + fetch)]
        got = exe.run(tspec[f"{side}_program"], feed=feed,
                      fetch_list=[tspec[f"{side}_loss"]] + fetch,
                      scope=scope)
        _compare(got, want, fetch, scope,
                 {n: np.asarray(jscope.find_var(n)) for n in names})


# ---------------------------------------------------------- learning mirrors


def _train(feeds_fn, loss, steps, opt, fetch=None):
    opt.minimize(loss)
    exe = tfluid.Executor(CPU)
    exe.run(tfluid.default_startup_program())
    first = last = None
    for i in range(steps):
        out = exe.run(feed=feeds_fn(i), fetch_list=[loss] + (fetch or []))
        if first is None:
            first = float(out[0])
        last = [float(np.asarray(o).reshape(-1)[0]) for o in out]
    return first, last


def test_vae_learns():
    """tests/test_models.py:268: the ELBO on a fixed batch halves in 120
    Adam(3e-3) steps."""
    loss = _vae(tfluid)
    data = _vae_data()
    first, (last,) = _train(lambda i: {"x": data}, loss, 120,
                            tfluid.optimizer.Adam(3e-3))
    assert last < first * 0.5, (first, last)


def test_gan_alternating_training():
    """tests/test_models.py:285: 60 alternations; D's loss falls, G's stays
    below 1.5 x its first."""
    D_IMG, D_Z, B = 16, 8, 32
    spec = _gan(tfluid)
    exe = tfluid.Executor(CPU)
    exe.run(spec["d_startup"])
    exe.run(spec["g_startup"])
    rng = np.random.RandomState(0)
    protos = np.sign(rng.randn(2, D_IMG)).astype("float32") * 0.8

    def real_batch():
        idx = rng.randint(0, 2, B)
        return np.clip(protos[idx] + rng.randn(B, D_IMG).astype("float32")
                       * 0.05, -1, 1)

    d_first = g_first = None
    for _ in range(60):
        d_out, = exe.run(spec["d_program"],
                         feed={"img": real_batch(),
                               "z": rng.randn(B, D_Z).astype("float32")},
                         fetch_list=[spec["d_loss"]])
        g_out, = exe.run(spec["g_program"],
                         feed={"z": rng.randn(B, D_Z).astype("float32")},
                         fetch_list=[spec["g_loss"]])
        if d_first is None:
            d_first, g_first = float(d_out), float(g_out)
        d_last, g_last = float(d_out), float(g_out)
    assert np.isfinite(d_last) and np.isfinite(g_last)
    assert d_last < d_first, (d_first, d_last)
    assert g_last < g_first * 1.5, (g_first, g_last)


def test_word2vec_book():
    """tests/test_models.py:340: the n-gram LM on the imikolov chain (V
    100) falls below 0.7 x its first loss in 200 Adam(1e-2) steps."""
    from paddle_tpu_torch.datasets import imikolov

    V = 100
    ws = [tfluid.layers.data(n, [1], dtype="int32") for n in W2V_NAMES]
    tgt = tfluid.layers.data("tgt", [1], dtype="int32")
    cost, _ = tfluid.models.word2vec.build(ws, tgt, vocab_size=V, emb_dim=16,
                                           hidden=64)
    grams = [tuple(t % V for t in g)
             for g in imikolov.train(n=5, n_synthetic=512)()]
    first, (last,) = _train(lambda i: _w2v_feed(grams, i), cost, 200,
                            tfluid.optimizer.Adam(1e-2))
    assert last < first * 0.7, (first, last)


def test_recommender_system_book():
    """tests/test_models.py:365: the dual-tower regression falls below 0.8
    x its first loss in 50 Adam(5e-3) steps."""
    from paddle_tpu_torch.datasets import movielens

    cost = _rec(tfluid, emb=16, fc=64)
    data = list(movielens.train(512)())
    first, (last,) = _train(lambda i: _rec_feed(data, i), cost, 50,
                            tfluid.optimizer.Adam(5e-3))
    assert last < first * 0.8, (first, last)


def test_traffic_prediction_converges():
    """tests/test_models.py:447: 60 Adam(5e-2) steps; the loss below half
    its first, the accuracy over 0.8."""
    loss, acc = _traffic(tfluid)
    rng = np.random.RandomState(0)
    first, (last, a) = _train(lambda i: _traffic_feed(rng), loss, 60,
                              tfluid.optimizer.Adam(5e-2), [acc])
    assert last < first * 0.5, (first, last)
    assert a > 0.8, a


# ---------------------------------------------------------- warmed steps


def test_vae_warmed_replay_draws_the_eager_noise():
    """The VAE step warmed on the CPU: the replay at step counter s is
    bitwise an unwarmed Executor's eager step at s (loss, gradients,
    parameters and moments), the replay at s + 1 draws new noise (another
    loss), and a replay of the same state at s again is bitwise the
    first."""
    loss = _vae(tfluid)
    tfluid.optimizer.Adam(1e-3).minimize(loss)
    main, startup = (tfluid.default_main_program(),
                     tfluid.default_startup_program())
    params = [p.name for p in main.parameters()]
    fetch = [loss] + [f"{n}@GRAD" for n in params]
    feed = {"x": _vae_data()[:16]}
    s = 2 ** 31 - 1

    def scope_at(exe):
        sc = tfluid.Scope()
        exe.run(startup, scope=sc)
        sc.step_counter = s
        return sc

    exe = tfluid.Executor(CPU)
    scope = scope_at(exe)
    init = {n: v.clone() for n, v in scope.items()}
    assert exe.warm(main, [("x", (16, 64), "float32")], fetch,
                    scope=scope) == "compiled"
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    eager = tfluid.Executor(CPU)
    escope = tfluid.Scope()
    for n, v in init.items():
        escope.set_var(n, v.clone())
    escope.step_counter = s
    want = eager.run(main, feed=feed, fetch_list=fetch, scope=escope)
    assert exe.replays == 1 and eager.replays == 0
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    for n, v in escope.items():
        assert torch.equal(scope.find_var(n), v), n
    nxt = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert nxt[0] != got[0]
    for n, v in init.items():
        scope.set_var(n, v.clone())
    scope.step_counter = s
    again = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    for a, b in zip(again, got):
        assert a.tobytes() == b.tobytes()


def _copy_bytes(exe, program, scope):
    """The bytes the next replay of ``program``'s warmed signature copies
    in: its state the scope holds in another tensor than its buffer."""
    sig = next(s for k, s in exe._cache.items() if k[0] is program)
    return sum(buf.numel() * buf.element_size()
               for n, buf in sig.state.items() if scope.find_var(n) is not buf)


def test_gan_warmed_alternation_matches_eager():
    """D and G warmed on one scope: three alternations of replays bitwise
    three eager alternations (losses and every parameter), and from the
    second alternation on each replay copies in the parameters both
    programs read, 2 x their bytes an alternation."""
    spec = _gan(tfluid)
    feeds = [_gan_feeds(np.random.RandomState(i)) for i in range(3)]

    def startup(exe):
        sc = tfluid.Scope()
        exe.run(spec["d_startup"], scope=sc)
        exe.run(spec["g_startup"], scope=sc)
        return sc

    exe = tfluid.Executor(CPU)
    scope = startup(exe)
    init = {n: v.clone() for n, v in scope.items()}
    for side, feed in (("d", feeds[0][0]), ("g", feeds[0][1])):
        exe.warm(spec[f"{side}_program"],
                 [(n, v.shape, "float32") for n, v in feed.items()],
                 [spec[f"{side}_loss"]], scope=scope)
    eager = tfluid.Executor(CPU)
    escope = tfluid.Scope()
    for n, v in init.items():
        escope.set_var(n, v.clone())
    shared = {p.name for p in spec["d_program"].parameters()}
    shared_bytes = sum(init[n].numel() * 4 for n in shared)
    copied = []
    for fd, fg in feeds:
        row = []
        for side, feed in (("d", fd), ("g", fg)):
            row.append(_copy_bytes(exe, spec[f"{side}_program"], scope))
            got = exe.run(spec[f"{side}_program"], feed=feed,
                          fetch_list=[spec[f"{side}_loss"]], scope=scope)
            want = eager.run(spec[f"{side}_program"], feed=feed,
                             fetch_list=[spec[f"{side}_loss"]],
                             scope=escope)
            assert got[0].tobytes() == want[0].tobytes(), side
        copied.append(sum(row))
    assert exe.replays == 6
    for n, v in escope.items():
        assert torch.equal(scope.find_var(n), v), n
    assert copied[1] == copied[2] == 2 * shared_bytes


@pytest.mark.parametrize("name", ["word2vec", "recommender", "traffic",
                                  "vae", "gan"])
def test_family_recipes_at_full_width(name):
    """``tools/families.py``, as the chip script's families phase trains
    them: each family at its ``build()`` defaults takes one step on the
    CPU from its startup weights on a batch of its size (GAN: a D step,
    then a G step), the loss finite; the batches differ by seed."""
    from paddle_tpu_torch.tools.families import (FAMILY_BATCH, build_family,
                                                 family_batch)
    from paddle_tpu_torch.tools.train_profile import (startup_params,
                                                      train_scope)

    exe = tfluid.Executor(CPU)
    n = FAMILY_BATCH[name]
    batch, other = family_batch(name, 0), family_batch(name, 1)
    if name == "gan":
        spec = build_family(name)
        params = startup_params(spec["d_program"], spec["d_startup"], 0)
        scope = train_scope(exe, spec["d_startup"], spec["d_program"],
                            params, "cpu")
        exe.run(spec["g_startup"], scope=scope)
        tfluid.load_scope(params, spec["d_program"], scope, device="cpu")
        runs = [(spec[f"{s}_program"], spec[f"{s}_loss"], batch[s])
                for s in ("d", "g")]
        first, second = batch["d"]["img"], other["d"]["img"]
        assert batch["d"]["img"].shape == (n, 784)
    else:
        loss, main, startup = build_family(name)
        params = startup_params(main, startup, 0)
        scope = train_scope(exe, startup, main, params, "cpu")
        runs = [(main, loss, batch)]
        key = sorted(batch)[0]
        first, second = batch[key], other[key]
        assert all(len(v) == n for v in batch.values())
    assert not np.array_equal(first, second)
    for prog, loss, feed in runs:
        out, = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        assert np.isfinite(out)
