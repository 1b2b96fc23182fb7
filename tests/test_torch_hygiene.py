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


def test_kernel_library_is_keyed_by_source():
    """The library name carries a hash of the source and the nvcc flags,
    under the checkout's build/ directory (which .gitignore lists)."""
    from paddle_tpu_torch.ops import _build

    for stem in ("paged_attention", "flash_attention", "lstm", "batch_norm"):
        target = _build._target(_build.CSRC / f"{stem}.cu")
        assert target.parent == REPO / "build" / "paddle_tpu_torch"
        assert re.fullmatch(stem + r"-[0-9a-f]{16}\.so", target.name)
    assert "build/" in (REPO / ".gitignore").read_text().split()
