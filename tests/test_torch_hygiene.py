"""paddle_tpu_torch stands alone: importing it loads no JAX and nothing of
``paddle_tpu``, its sources import neither, and its entry points run on the
CUDA card unless told otherwise (raising when there is none)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"
CFG = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
           d_ff=64)


def test_import_loads_no_jax_and_no_paddle_tpu():
    src = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving.decode\n"
        "import paddle_tpu_torch.ops.paged_attention\n"
        "import paddle_tpu_torch.tools.train_profile\n"
        "import paddle_tpu_torch.tools.seq2seq_parity\n"
        "import paddle_tpu_torch.ops.lstm, paddle_tpu_torch.layers.sequence\n"
        "import paddle_tpu_torch.models.text_lstm\n"
        "import paddle_tpu_torch.models.resnet, paddle_tpu_torch.amp\n"
        "import paddle_tpu_torch.ops.batch_norm\n"
        "import paddle_tpu_torch.layers.beam, paddle_tpu_torch.layers.control_flow\n"
        "import paddle_tpu_torch.models.seq2seq\n"
        "import paddle_tpu_torch.layers.nested, paddle_tpu_torch.layers.mdlstm\n"
        "import paddle_tpu_torch.models.hier_text\n"
        "import paddle_tpu_torch.nets, paddle_tpu_torch.models.ocr_ctc\n"
        "import paddle_tpu_torch.models.lenet, paddle_tpu_torch.models.vgg\n"
        "import paddle_tpu_torch.models.smallnet\n"
        "import paddle_tpu_torch.models.alexnet\n"
        "import paddle_tpu_torch.models.googlenet\n"
        "import paddle_tpu_torch.evaluator, paddle_tpu_torch.datasets.voc2012\n"
        "import paddle_tpu_torch.models.fcn, paddle_tpu_torch.models.ssd\n"
        "import paddle_tpu_torch.layers.detection\n"
        "import paddle_tpu_torch.resilience.faults\n"
        "import paddle_tpu_torch.serving.prefix\n"
        "import paddle_tpu_torch.ops.random\n"
        "import paddle_tpu_torch.datasets.imikolov\n"
        "import paddle_tpu_torch.datasets.movielens\n"
        "import paddle_tpu_torch.models.word2vec\n"
        "import paddle_tpu_torch.models.recommender\n"
        "import paddle_tpu_torch.models.traffic\n"
        "import paddle_tpu_torch.models.gan, paddle_tpu_torch.models.vae\n"
        "import paddle_tpu_torch.layers.misc, paddle_tpu_torch.sparse\n"
        "import paddle_tpu_torch.trainer, paddle_tpu_torch.data_feeder\n"
        "import paddle_tpu_torch.events, paddle_tpu_torch.compile.guard\n"
        "import paddle_tpu_torch.models.ctr, paddle_tpu_torch.datasets.ctr\n"
        "import paddle_tpu_torch.tools.ctr_sparse\n"
        "from paddle_tpu_torch.ops import decode_attention, cache_set\n"
        "from paddle_tpu_torch.ops import _build\n"
        "print('LOADED', sorted(_build._loaded))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    assert "LOADED []" in proc.stdout, proc.stdout   # nothing built at import


def test_sources_import_neither_jax_nor_paddle_tpu():
    pattern = re.compile(
        r"^\s*(import\s+(jax|paddle_tpu)\b(?!_torch)"
        r"|from\s+(jax|paddle_tpu)(\.|\s)(?!_torch))", re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_serving_extras_carry_their_own_copies():
    """The prefix cache, the fault registry and the dense forms are the
    port's own code: the cache carries the root bytes itself (equal to
    the JAX package's, which ``tests/test_torch_prefix_cache.py`` holds)
    and none of the modules names the JAX package."""
    prefix = (PKG / "serving" / "prefix.py").read_text()
    assert 'ROOT_DIGEST = b"paddle-tpu-prefix-root"' in prefix
    for rel in ("serving/prefix.py", "resilience/faults.py",
                "resilience/__init__.py", "serving/decode.py",
                "ops/attention.py", "models/transformer.py"):
        src = (PKG / rel).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|paddle_tpu)\b(?!_)",
                             src, re.M), rel
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import prefix

    assert faults.__name__ == "paddle_tpu_torch.resilience.faults"
    assert prefix.PrefixCache(16).root == prefix.ROOT_DIGEST


def test_entry_points_default_to_cuda():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import ContinuousDecodeEngine, resolve_device
    from paddle_tpu_torch.models import init_lm_params

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert fluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    params = init_lm_params(0, **CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousDecodeEngine(params, **CFG)
    from paddle_tpu_torch import DecodeEngine

    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(params, **CFG)
    dense = DecodeEngine(params, device="cpu", batch_buckets=(1,), **CFG)
    assert dense.generate(np.array([[3, 4, 5]], np.int32), 2).shape == (1, 2)
    eng = ContinuousDecodeEngine(params, device="cpu", **CFG)
    assert eng.pool.k.device.type == "cpu"
    assert eng.model.prm["tok_emb"].device.type == "cpu"
    assert np.isfinite(eng.prefill(np.array([3, 4, 5], np.int32),
                                   eng._trash_table())).all()

    # the training slice: Executor() is the card, CPUPlace() the host, and
    # load_scope puts weights on the card unless told otherwise
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        toks = fluid.layers.data("toks", [8], dtype="int32")
        labs = fluid.layers.data("labs", [8, 1], dtype="int32")
        fluid.models.build_lm(toks, labs, **dict(CFG, max_len=8))
    scope = fluid.Scope()
    weights = init_lm_params(0, **dict(CFG, max_len=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.load_scope(weights, main, scope)
    assert scope.var_names() == []
    exe = fluid.Executor(fluid.CPUPlace())
    assert exe.device.type == "cpu"
    fluid.load_scope(weights, main, scope, device="cpu")
    assert {t.device.type for _, t in scope.items()} == {"cpu"}


@pytest.mark.parametrize("model", ["lenet", "smallnet", "vgg", "alexnet",
                                   "googlenet", "ocr_ctc", "nets", "fcn",
                                   "ssd"])
def test_new_models_default_to_cuda(model):
    """The image classifiers, ocr_ctc, a ``nets`` program, FCN (on
    ``datasets.voc2012``'s masks) and SSD (with ``evaluator.DetectionMAP``
    on its detections) run where the other programs do: ``Executor()``
    and ``load_scope`` take the card unless told otherwise, and raise
    without one; the CPU runs them when asked, and ``reset`` zeroes the
    evaluator on the Executor's device.  ``train_profile`` needs the card
    for the new recipes."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools import train_profile as tp

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        if model == "ocr_ctc":
            img = L.data("img", [1, 8, 32])
            lab = L.data("lab", [4], dtype="int32")
            ll = L.data("ll", [-1], dtype="int32", append_batch_size=False)
            loss = fluid.models.ocr_ctc.build(img, lab, ll, num_classes=4)[0]
            feed = dict(zip(("img", "lab", "ll"),
                            fluid.models.ocr_ctc.synthetic_lines(2)))
        elif model == "fcn":
            img = L.data("img", [3, 16, 16])
            lab = L.data("lab", [16, 16], dtype="int32")
            loss = fluid.models.fcn.build(img, lab, num_classes=4, base=4)[0]
            data = list(fluid.datasets.voc2012.train(2, size=16)())
            feed = {"img": np.stack([d[0] for d in data]),
                    "lab": np.minimum(np.stack([d[1] for d in data]),
                                      3).astype(np.int32)}
        elif model == "ssd":
            img = L.data("img", [3, 32, 32])
            gb = L.data("gb", [2, 4])
            gl = L.data("gl", [2], dtype="int32")
            loss, heads = fluid.models.ssd.build(img, gb, gl, num_classes=3)
            dets = fluid.models.ssd.infer(*heads, keep_top_k=4)
            ev = fluid.evaluator.DetectionMAP(*dets, gb, gl, num_classes=3)
            feed = {"img": np.ones((2, 3, 32, 32), np.float32),
                    "gb": np.array([[[0.1, 0.1, 0.6, 0.6], [0, 0, 0, 0]]] * 2,
                                   np.float32),
                    "gl": np.array([[1, 0]] * 2, np.int32)}
        elif model == "nets":
            x = L.fc(L.data("x", [6, 32]), 32, num_flatten_dims=2)
            loss = L.mean(fluid.nets.scaled_dot_product_attention(
                x, x, x, num_heads=2))
            feed = {"x": np.ones((2, 6, 32), np.float32)}
        else:
            c, size = {"lenet": (1, 28), "alexnet": (3, 96)}.get(model,
                                                                 (3, 32))
            img = L.data("img", [c, size, size])
            label = L.data("label", [1], dtype="int32")
            kw = {} if model == "lenet" else {"class_dim": 4}
            loss = getattr(fluid.models, model).build(img, label, **kw)[0]
            feed = {"img": np.ones((2, c, size, size), np.float32),
                    "label": np.zeros((2, 1), np.int32)}
        fluid.optimizer.SGD(0.1).minimize(loss)
    if torch.cuda.is_available():
        assert fluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    weights = {p.name: scope.find_var(p.name).numpy()
               for p in main.parameters()}
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.load_scope(weights, main, fluid.Scope())
    fluid.load_scope(weights, main, scope, device="cpu")
    out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out)
    if model == "ssd":
        assert {t.device.type for t in (scope.find_var(v.name)
                                         for v in ev._states)} == {"cpu"}
        ev.reset(exe, scope)
        assert ev.eval(scope=scope) == 0.0
        assert {scope.find_var(v.name).device.type
                for v in ev._states} == {"cpu"}
    for name in {"vgg": ("vgg19", "vgg19-infer"),
                 "alexnet": ("alexnet", "alexnet-infer"),
                 "googlenet": ("googlenet", "googlenet-infer"),
                 "ocr_ctc": tp.OCR,
                 "fcn": ("fcn", "fcn-infer"),
                 "ssd": ("ssd", "ssd-detect")}.get(model, ()):
        with pytest.raises(RuntimeError, match="CUDA"):
            tp.profile(name)


@pytest.mark.parametrize("model", ["word2vec", "recommender", "traffic",
                                   "gan", "vae"])
def test_book_families_default_to_cuda(model):
    """The book and demo families run where the other programs do:
    ``Executor()`` and ``load_scope`` take the card unless told otherwise
    and raise without one, and a random op of a step (the VAE's noise)
    draws on the step's device; the CPU runs them when asked.  Their
    sources name neither JAX nor the JAX package."""
    import paddle_tpu_torch as fluid

    for rel in (f"models/{model}.py", "ops/random.py",
                "datasets/imikolov.py", "datasets/movielens.py"):
        src = (PKG / rel).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|paddle_tpu)\b(?!_)",
                             src, re.M), rel
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        L = fluid.layers
        if model == "word2vec":
            ws = [L.data(f"w{i}", [1], dtype="int32") for i in range(5)]
            loss = fluid.models.word2vec.build(ws[:4], ws[4], 20, 4, 8)[0]
            feed = {f"w{i}": np.full((2, 1), i, np.int32) for i in range(5)}
        elif model == "recommender":
            ids = [L.data(n, [1], dtype="int32") for n in
                   ("uid", "gender", "age", "job", "mid", "category")]
            rating = L.data("rating", [1])
            loss = fluid.models.recommender.build(*ids, rating, emb_dim=4,
                                                  fc_size=8)[0]
            feed = {v.name: np.ones((2, 1), np.int32) for v in ids}
            feed["rating"] = np.full((2, 1), 3.0, np.float32)
        elif model == "traffic":
            enc = L.data("enc", [6])
            lab = L.data("lab", [3], dtype="int32")
            loss = fluid.models.traffic.build(enc, lab, term_num=6,
                                              forecasting_num=3)[0]
            feed = {"enc": np.ones((2, 6), np.float32),
                    "lab": np.ones((2, 3), np.int32)}
        elif model == "gan":
            spec = fluid.models.gan.build(img_dim=8, z_dim=4, hidden=8)
            main, startup = spec["g_program"], spec["g_startup"]
            loss = spec["g_loss"]
            feed = {"z": np.ones((2, 4), np.float32)}
        else:
            x = L.data("x", [8])
            loss = fluid.models.vae.build(x, img_dim=8, hidden=8,
                                          latent=2)[0]
            feed = {"x": np.full((2, 8), 0.5, np.float32)}
        if model != "gan":
            fluid.optimizer.Adam(1e-3).minimize(loss)
    if torch.cuda.is_available():
        assert fluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.Executor()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    weights = {p.name: scope.find_var(p.name).numpy()
               for p in main.parameters()}
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.load_scope(weights, main, fluid.Scope())
    fluid.load_scope(weights, main, scope, device="cpu")
    out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out)
    assert {t.device.type for _, t in scope.items()} == {"cpu"}
    from paddle_tpu_torch.tools import train_profile as tp

    with pytest.raises(RuntimeError, match="CUDA"):
        tp.profile("gan-d" if model == "gan" else model)


def test_kernel_library_is_keyed_by_source():
    """The library name carries a hash of the source and the nvcc flags,
    under the checkout's build/ directory (which .gitignore lists)."""
    from paddle_tpu_torch.ops import _build

    for stem in ("paged_attention", "flash_attention", "lstm", "batch_norm"):
        target = _build._target(_build.CSRC / f"{stem}.cu")
        assert target.parent == REPO / "build" / "paddle_tpu_torch"
        assert re.fullmatch(stem + r"-[0-9a-f]{16}\.so", target.name)
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_sparse_engine_defaults_to_cuda():
    """The sparse engine's entry points run where the others do: a
    ``ShardedEmbeddingTable``, its ``SparseEmbeddingTrainer`` and a
    ``DeviceFeeder`` / ``SparseFeeder`` take the card unless told
    otherwise and raise without one; the CPU runs them when asked.  The
    new modules' sources name neither JAX nor the JAX package."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.sparse import ShardedEmbeddingTable, SparseFeeder

    for rel in ("layers/misc.py", "layers/__init__.py", "evaluator.py",
                "events.py", "data_feeder.py", "compile/guard.py",
                "compile/__init__.py", "trainer.py", "sparse/__init__.py",
                "sparse/table.py", "sparse/update.py", "sparse/pipeline.py",
                "models/ctr.py", "datasets/ctr.py", "tools/ctr_sparse.py"):
        src = (PKG / rel).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|paddle_tpu)\b(?!_)",
                             src, re.M), rel
    feeds = [{"sparse": np.array([[1, 2]], np.int64)}]
    if torch.cuda.is_available():
        tab = ShardedEmbeddingTable([5, 4], 2)
        assert tab.storage.device.type == "cuda"
        assert fluid.DeviceFeeder(lambda: iter(feeds)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedEmbeddingTable([5, 4], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ctr.wide_deep_sparse_table([5, 4], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.DeviceFeeder(lambda: iter(feeds))
    tab = ShardedEmbeddingTable([5, 4], 2, device="cpu")
    assert tab.storage.device.type == "cpu"
    staged, = list(SparseFeeder(lambda: iter(feeds), {"sparse": tab}))
    assert {v.device.type for v in staged.values()} == {"cpu"}
    trainer = fluid.SparseEmbeddingTrainer(
        tab, lambda rows, p, b: (rows.sum() + p["w"].sum()),
        {"w": np.ones(2, np.float32)}, fluid.optimizer.SGD(0.1))
    assert trainer.device.type == "cpu"
    assert trainer.params["w"].device.type == "cpu"
    assert {v.device.type for v in trainer.slots.values()} <= {"cpu"}


def test_parallel_modules_load_no_jax_and_no_paddle_tpu():
    """parallel/, distributed.py and the dry run import neither JAX nor
    the JAX package, in their own process, and build nothing."""
    src = (
        "import sys\n"
        "import paddle_tpu_torch.parallel, paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.parallel.comm, paddle_tpu_torch.parallel.ring\n"
        "import paddle_tpu_torch.parallel.ulysses\n"
        "import paddle_tpu_torch.parallel.strategy\n"
        "import paddle_tpu_torch.tools.dryrun_multichip\n"
        "import paddle_tpu_torch.tools.parallel_cases\n"
        "from paddle_tpu_torch.ops import _build\n"
        "print('LOADED', sorted(_build._loaded))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", src], capture_output=True,
                          text=True, timeout=120, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout and "LOADED []" in proc.stdout, \
        proc.stdout
    for rel in ("parallel/__init__.py", "parallel/comm.py",
                "parallel/mesh.py", "parallel/ring.py", "parallel/tp.py",
                "parallel/ulysses.py", "parallel/strategy.py",
                "distributed.py", "tools/dryrun_multichip.py",
                "tools/parallel_cases.py"):
        src = (PKG / rel).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|paddle_tpu)\b(?!_)",
                             src, re.M), rel


def _dist_calls():
    """(file, attribute) of every ``torch.distributed`` call in the port:
    calls through a name bound to ``torch.distributed``."""
    import ast

    out = []
    for f in sorted(PKG.rglob("*.py")):
        tree = ast.parse(f.read_text())
        aliases = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                aliases |= {a.asname or a.name for a in node.names
                            if a.name == "torch.distributed"}
        if not aliases:
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in aliases):
                out.append((f.relative_to(PKG).as_posix(), node.func.attr,
                            node))
    return out


def test_collectives_live_in_comm_and_groups_take_a_timeout():
    """comm.py is the only module of the port that calls torch.distributed
    collectives, and every init_process_group and new_group call passes a
    timeout."""
    calls = _dist_calls()
    collectives = {"all_reduce", "all_gather", "all_gather_into_tensor",
                   "all_gather_single", "reduce_scatter",
                   "reduce_scatter_tensor", "reduce_scatter_single",
                   "all_to_all", "all_to_all_single", "batch_isend_irecv",
                   "isend", "irecv", "send", "recv", "broadcast", "barrier",
                   "reduce", "gather", "scatter"}
    outside = sorted({(f, a) for f, a, _ in calls
                      if a in collectives and f != "parallel/comm.py"})
    assert outside == []
    for name in ("init_process_group", "new_group"):
        made = [(f, node) for f, a, node in calls if a == name]
        assert made, f"the port calls {name} somewhere"
        for f, node in made:
            assert any(k.arg == "timeout" for k in node.keywords), (f, name)
    # the mesh's subgroups are made through comm.new_group, and the default
    # group's timeout reaches them
    src = (PKG / "parallel/mesh.py").read_text()
    assert "comm.new_group(" in src and "dist.new_group" not in src


def test_parallel_defaults_to_cuda():
    """The multi-process entry points run on the card unless told
    otherwise: ``distributed.init`` with a gang's arguments,
    ``distributed.spawn`` and ``dryrun_multichip`` take the card by
    default and raise without one, before any process or group starts."""
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.tools import dryrun_multichip as dry

    if torch.cuda.is_available():
        assert distributed.spawn.__kwdefaults__["device"] is None
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.init("localhost:29500", 2, 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.spawn(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        dry.dryrun_multichip(2)
