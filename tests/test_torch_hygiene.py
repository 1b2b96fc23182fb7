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


def test_kernel_library_is_keyed_by_source():
    """The library name carries a hash of the source and the nvcc flags,
    under the checkout's build/ directory (which .gitignore lists)."""
    from paddle_tpu_torch.ops import _build

    for stem in ("paged_attention", "flash_attention"):
        target = _build._target(_build.CSRC / f"{stem}.cu")
        assert target.parent == REPO / "build" / "paddle_tpu_torch"
        assert re.fullmatch(stem + r"-[0-9a-f]{16}\.so", target.name)
    assert "build/" in (REPO / ".gitignore").read_text().split()
