"""paddle_tpu_torch's Transformer LM serving math against the JAX package on
the CPU, on the same weights (the JAX package's ``init_lm_params`` carried
across by ``from_jax_params``): the dense forward and head, and the paged
decode window at W=1 and W=3, including a window that overhangs max_len."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.models import transformer as jtf
from paddle_tpu_torch.models import from_jax_params
from paddle_tpu_torch.models import transformer as ttf
from paddle_tpu_torch.ops import attention as TA

CFG = dict(vocab_size=61, max_len=64, d_model=32, n_heads=2, n_layers=2,
           d_ff=64)
LOGIT_ATOL = 1e-4   # float32, matmul and softmax sums in another order


@pytest.fixture(scope="module")
def params():
    return jtf.init_lm_params(7, **CFG)


@pytest.fixture(scope="module")
def both(params):
    """(JAX cast params, port params) on the same weights."""
    jprm = jtf._srv_cast_params({n: jnp.asarray(v) for n, v in params.items()},
                                jnp.float32)
    return jprm, from_jax_params(params, device="cpu", **CFG)


def test_init_lm_params_same_draws(params):
    mine = ttf.init_lm_params(7, **CFG)
    assert list(mine) == list(params)
    for n in params:
        np.testing.assert_array_equal(mine[n], params[n])


def test_from_jax_params_checks_names_and_shapes(params):
    bad = dict(params)
    bad.pop("blk1.ff2.b")
    with pytest.raises(ValueError, match="missing"):
        from_jax_params(bad, device="cpu", **CFG)
    bad = dict(params, **{"blk0.q.w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(bad, device="cpu", **CFG)


def test_cast_rules_match_jax(params):
    """``.w`` weights and 2-D params take the compute dtype; 1-D layernorm
    and bias params stay float32 — in both packages."""
    jc = jtf._srv_cast_params({n: jnp.asarray(v) for n, v in params.items()},
                              jnp.bfloat16)
    tc = from_jax_params(params, dtype="bfloat16", device="cpu", **CFG)
    for n in params:
        want = "bfloat16" if jc[n].dtype == jnp.bfloat16 else "float32"
        assert str(tc[n].dtype) == f"torch.{want}", n


def test_lm_forward_and_head_match_jax(both):
    jprm, tprm = both
    tokens = np.random.RandomState(0).randint(0, CFG["vocab_size"], (3, 13))
    kw = dict(n_heads=CFG["n_heads"], n_layers=CFG["n_layers"])
    jx, jkv = jtf.lm_forward(jprm, jnp.asarray(tokens, jnp.int32),
                             collect_kv=True, **kw)
    tx, tkv = ttf.lm_forward(tprm, torch.from_numpy(tokens), collect_kv=True,
                             **kw)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    jl = jtf.lm_head_logits(jprm, jx)
    tl = ttf.lm_head_logits(tprm, tx)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("W", [1, 3])
def test_paged_decode_window_matches_jax(both, W):
    """Same arenas, tables, positions and limits through both packages'
    ``lm_paged_decode_window``: logits within atol 1e-4 and the written
    arenas within 1e-5.  Slot 1's window sits at the end of max_len, so its
    positions overhang (pos_emb gathers clamp, writes past the limit go to
    trash); slot 3 is an idle row with an all-trash table."""
    jprm, tprm = both
    S, Bs = 4, 8
    n_tbl = CFG["max_len"] // Bs
    n_blocks = S * n_tbl
    trash = n_blocks
    L, H = CFG["n_layers"], CFG["n_heads"]
    Dh = CFG["d_model"] // H
    rng = np.random.RandomState(W)
    arena = (rng.randn(2, n_blocks + 1, L, H, Bs, Dh) * 0.5).astype(np.float32)
    tables = rng.permutation(n_blocks).reshape(S, n_tbl).astype(np.int32)
    tables[3] = trash
    tables[2, 4:] = trash
    pos0 = np.array([9, CFG["max_len"] - 1, 20, 0], np.int32)
    limits = np.array([40, CFG["max_len"], 30, 0], np.int32)
    toks = rng.randint(0, CFG["vocab_size"], (S, W)).astype(np.int32)
    kw = dict(n_heads=H, n_layers=L, block_size=Bs)
    jlog, jk, jv = jtf.lm_paged_decode_window(
        jprm, jnp.asarray(toks), jnp.asarray(pos0), jnp.asarray(tables),
        jnp.asarray(limits), jnp.asarray(arena[0]), jnp.asarray(arena[1]),
        **kw)
    tk, tv = torch.from_numpy(arena[0].copy()), torch.from_numpy(
        arena[1].copy())
    tlog, tk, tv = ttf.lm_paged_decode_window(
        tprm, torch.from_numpy(toks), torch.from_numpy(pos0),
        torch.from_numpy(tables), torch.from_numpy(limits), tk, tv, **kw)
    assert tuple(tlog.shape) == (S, W, CFG["vocab_size"])
    live = [0, 1, 2]                      # the idle row's logits are garbage
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               atol=LOGIT_ATOL, rtol=0)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:trash],
                                   np.asarray(want)[:trash], atol=1e-5)


def test_decode_window_is_write_then_attend(both):
    """W=1 with every row on the same table: row j attends over rows < j
    written in the same call (what prefill_tail relies on), so the rows'
    logits equal the dense forward's at the same positions."""
    _, tprm = both
    S, Bs, L, H = 4, 8, CFG["n_layers"], CFG["n_heads"]
    n_tbl = CFG["max_len"] // Bs
    Dh = CFG["d_model"] // H
    k, v = TA.init_kv_pool(n_tbl, L, H, Bs, Dh)
    tokens = np.random.RandomState(9).randint(0, CFG["vocab_size"], S)
    table = np.arange(n_tbl, dtype=np.int32)
    logits, _, _ = ttf.lm_paged_decode_window(
        tprm, torch.from_numpy(tokens[:, None]), torch.arange(S),
        torch.from_numpy(np.tile(table, (S, 1))),
        torch.full((S,), CFG["max_len"]), k, v, n_heads=H, n_layers=L,
        block_size=Bs)
    x, _ = ttf.lm_forward(tprm, torch.from_numpy(tokens)[None], n_heads=H,
                          n_layers=L)
    dense = ttf.lm_head_logits(tprm, x[0])
    np.testing.assert_allclose(logits[:, 0].numpy(), dense.numpy(),
                               atol=LOGIT_ATOL, rtol=0)
