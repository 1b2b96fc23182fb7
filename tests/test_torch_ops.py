"""paddle_tpu_torch ops against the JAX package on the CPU: the paged KV pool
(quantize, scatter, gather), decode attention and the plain version of the
paged-attention kernel against the Pallas kernel run by its interpreter,
and per-slot token selection.  Inputs come from numpy seeds and go through
both packages."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import sampling as JS
from paddle_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import sampling as TS
from paddle_tpu_torch.ops.paged_attention import (_kernel_geometry,
                                                  paged_attention,
                                                  paged_attention_reference)

# the plain version against the TPU kernel: float32 sums in another order
ATTN_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pools(quantized, n_blocks, L, H, Bs, Dh):
    if quantized:
        return (JA.init_kv_pool_quant(n_blocks, L, H, Bs, Dh),
                TA.init_kv_pool_quant(n_blocks, L, H, Bs, Dh))
    return (JA.init_kv_pool(n_blocks, L, H, Bs, Dh, jnp.float32),
            TA.init_kv_pool(n_blocks, L, H, Bs, Dh, torch.float32))


def _planes(pool):
    """The arrays of one side of a pool (payload, and scales when int8)."""
    return list(pool) if isinstance(pool, tuple) else [pool]


# ----------------------------------------------------------- quantization


def test_quantize_and_dequantize_kv_bitwise():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 4, 16) * rng.uniform(0.01, 30, (3, 5, 4, 1))
         ).astype(np.float32)
    x[0, 0, 0] = 0.0           # all-zero vector: tiny scale, exact zeros
    x[1, 2, 3, 5] = 1e4        # one large outlier in a row
    jq, js = JA.quantize_kv(jnp.asarray(x))
    tq, ts = TA.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(
        _np(TA.dequantize_kv(tq, ts)),
        np.asarray(JA.dequantize_kv(jq, js)))


# ------------------------------------------------------- scatter / gather


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_set_window_and_gather_bitwise(quantized):
    """Scatter windows of positions (some redirected to trash) into a
    two-layer pool through both packages: every live block is bitwise
    equal, and so is the gathered [S, H, T, Dh] view.  The trash block is
    left out: several rows write it at once and torch does not say which
    lands."""
    S, W, L, H, Bs, Dh, n_tbl = 3, 5, 2, 2, 4, 8, 3
    n_blocks = S * n_tbl
    trash = n_blocks
    rng = np.random.RandomState(1)
    jp, tp = _pools(quantized, n_blocks, L, H, Bs, Dh)
    tables = rng.permutation(n_blocks).reshape(S, n_tbl).astype(np.int32)
    tables[2, 2] = trash                         # an unallocated column
    for layer in range(L):
        for start in (0, W, 2 * W):
            pos = start + np.arange(W)[None, :].repeat(S, 0)
            blk = tables[np.arange(S)[:, None], np.minimum(pos // Bs,
                                                           n_tbl - 1)]
            off = pos % Bs
            new = rng.randn(S, W, H, Dh).astype(np.float32)
            jp = tuple(JA.paged_cache_set_window(p, layer, jnp.asarray(blk),
                                                 jnp.asarray(off),
                                                 jnp.asarray(new))
                       for p in jp)
            for p in tp:
                TA.paged_cache_set_window(p, layer, _t(blk), _t(off), _t(new))
    for j_side, t_side in zip(jp, tp):
        for ja, ta in zip(_planes(j_side), _planes(t_side)):
            np.testing.assert_array_equal(_np(ta)[:trash],
                                          np.asarray(ja)[:trash])
    live = np.where(tables == trash, 0, tables)      # gather without trash
    for layer in range(L):
        for j_side, t_side in zip(jp, tp):
            g_j = JA.paged_gather_kv(j_side, layer, jnp.asarray(live))
            g_t = TA.paged_gather_kv(t_side, layer, _t(live))
            assert tuple(g_t.shape) == (S, H, n_tbl * Bs, Dh)
            np.testing.assert_array_equal(_np(g_t), np.asarray(g_j))


def test_cache_set_window_layout():
    """``pool.at[block_idx, layer, :, offset]``: the indexed dims come first,
    so ``new[s, w, h]`` lands at arena[blk[s, w], layer, h, off[s, w]]."""
    S, W, L, H, Bs, Dh = 2, 3, 2, 4, 8, 5
    k, _ = TA.init_kv_pool(6, L, H, Bs, Dh)
    blk = torch.tensor([[0, 0, 3], [5, 2, 2]])
    off = torch.tensor([[1, 7, 0], [4, 4, 6]])
    new = torch.arange(S * W * H * Dh, dtype=torch.float32).reshape(
        S, W, H, Dh)
    TA.paged_cache_set_window(k, 1, blk, off, new)
    for s in range(S):
        for w in range(W):
            for h in range(H):
                assert torch.equal(k[blk[s, w], 1, h, off[s, w]], new[s, w, h])
    assert not k[:, 0].any()                     # the other layer untouched


# -------------------------------------------------- decode attention


def _attention_case(quantized, W, seed=2):
    """A one-layer pool with partial blocks, unallocated (trash) columns and
    a poisoned trash block; ragged lengths [S, W]."""
    S, H, Bs, Dh, n_tbl = 3, 2, 8, 16, 4
    n_blocks = S * 2 + 1
    trash = n_blocks
    rng = np.random.RandomState(seed)
    jp, tp = _pools(quantized, n_blocks, 1, H, Bs, Dh)
    tables = np.full((S, n_tbl), trash, np.int32)
    tables[:, :2] = rng.permutation(S * 2).reshape(S, 2)
    tables[0, 2] = S * 2                         # slot 0 owns a third block
    T = n_tbl * Bs
    pos = np.arange(T)[None, :].repeat(S, 0)
    blk = tables[np.arange(S)[:, None], pos // Bs]
    off = pos % Bs
    kv = [rng.randn(S, T, H, Dh).astype(np.float32) for _ in range(2)]
    kv[0][:, 3 * Bs:] = kv[1][:, 3 * Bs:] = 7e3   # trash columns poisoned
    for side in range(2):
        jp = tuple(JA.paged_cache_set_window(p, 0, jnp.asarray(blk),
                                             jnp.asarray(off),
                                             jnp.asarray(kv[side]))
                   if i == side else p for i, p in enumerate(jp))
        TA.paged_cache_set_window(tp[side], 0, _t(blk), _t(off), _t(kv[side]))
    top = np.array([3 * Bs - 1, 2 * Bs - 3, Bs + 1])   # mid-block lengths
    lengths = (top[:, None] - np.arange(W)[::-1][None, :]).astype(np.int32)
    q = rng.randn(S, W, H, Dh).astype(np.float32)
    return jp, tp, tables, lengths, q


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("W", [1, 4])
def test_plain_kernel_version_matches_pallas_kernel(W, quantized):
    """The plain version of the CUDA kernel (what ``paged_attention`` runs
    on CPU tensors) and the composed forms it is built from, against the
    Pallas TPU kernel under its interpreter: atol 1e-5."""
    jp, tp, tables, lengths, q = _attention_case(quantized, W)
    if W == 1:
        jq, tq = jnp.asarray(q[:, 0]), _t(q[:, 0])
        jl, tl = jnp.asarray(lengths[:, 0]), _t(lengths[:, 0])
    else:
        jq, tq, jl, tl = jnp.asarray(q), _t(q), jnp.asarray(lengths), \
            _t(lengths)
    want = np.asarray(jax_paged_attention(jq, jp[0], jp[1], 0,
                                          jnp.asarray(tables), jl,
                                          interpret=True))
    got = paged_attention(tq, tp[0], tp[1], 0, _t(tables), tl)
    ref = paged_attention_reference(tq, tp[0], tp[1], 0, _t(tables), tl)
    kc = TA.paged_gather_kv(tp[0], 0, _t(tables))
    vc = TA.paged_gather_kv(tp[1], 0, _t(tables))
    if W == 1:
        composed = TA.paged_decode_attention_single(tq, kc, vc, tl)
    else:
        composed = TA.paged_decode_attention(tq, kc, vc, tl)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert np.isfinite(_np(got)).all()
    for out in (got, ref, composed):
        np.testing.assert_allclose(_np(out), want, rtol=0, atol=ATTN_ATOL)


def test_paged_attention_bf16_out_dtype_matches_jax_composed():
    """Probabilities cast to ``out_dtype`` before the value product, output
    in ``out_dtype``: bfloat16 against the JAX composed form (one bf16 ulp
    at these magnitudes)."""
    jp, tp, tables, lengths, q = _attention_case(False, 4, seed=5)
    kc_j = JA.paged_gather_kv(jp[0], 0, jnp.asarray(tables))
    vc_j = JA.paged_gather_kv(jp[1], 0, jnp.asarray(tables))
    want = JA.paged_decode_attention(jnp.asarray(q), kc_j, vc_j,
                                     jnp.asarray(lengths),
                                     out_dtype=jnp.bfloat16)
    got = paged_attention(_t(q), tp[0], tp[1], 0, _t(tables), _t(lengths),
                          out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_plain_version_counts_no_launch_and_other_devices_raise():
    _, tp, tables, lengths, q = _attention_case(False, 1)
    before = paged_attention.launches
    paged_attention(_t(q[:, 0]), tp[0], tp[1], 0, _t(tables),
                    _t(lengths[:, 0]))
    assert paged_attention.launches == before
    meta = torch.empty((3, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_attention(meta, tp[0], tp[1], 0, _t(tables), _t(lengths[:, 0]))


@pytest.mark.parametrize("W,T,Dh,ok", [
    (1, 1024, 64, True), (4, 1024, 64, True), (8, 4096, 64, True),
    (9, 64, 64, False),            # window beyond the kernel's rows
    (4, 1024, 48, False),          # head dim must divide the block
    (8, 8192, 64, False),          # scores past 227 KB of shared memory
])
def test_kernel_geometry_limits(W, T, Dh, ok):
    if ok:
        nthreads, smem = _kernel_geometry(W, T, Dh)
        assert nthreads % Dh == 0 and smem >= 4 * W * T
    else:
        with pytest.raises(ValueError):
            _kernel_geometry(W, T, Dh)


def test_kernel_limits_match_cuda_source():
    """The wrapper sizes shared memory from its copies of the kernel's
    window and reduction limits; they must equal the .cu constants."""
    import importlib
    import re
    from pathlib import Path

    # the package rebinds the name to the function; fetch the module
    PA = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    src = (Path(PA.__file__).parent / "csrc" / "paged_attention.cu"
           ).read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kMaxW"]) == PA.MAX_WINDOW
    assert int(const["kRedSlots"]) == PA._RED_SLOTS


# ------------------------------------------------------- token selection


def test_hash_uniform_bitwise():
    rng = np.random.RandomState(3)
    seeds = np.concatenate([rng.randint(0, 2 ** 32, 200, dtype=np.uint64),
                            [0, 1, 2 ** 32 - 1, 0x9E3779B9]]).astype(np.uint32)
    subs = np.concatenate([rng.randint(0, 5000, 200),
                           [0, 7, 4095, 2 ** 31 - 1]]).astype(np.int32)
    want = np.asarray(JS._hash_uniform(jnp.asarray(seeds), jnp.asarray(subs)))
    got = TS._hash_uniform(_t(seeds.astype(np.int64)), _t(subs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), want)


def test_masked_select_tokens_matches_jax():
    """Greedy, temperature, top-k, top-p and masked rows on logits without
    near-ties pick the same tokens in both packages."""
    S, V = 12, 37
    rng = np.random.RandomState(4)
    logits = (rng.permutation(S * V).reshape(S, V) * 0.05).astype(np.float32)
    seeds = rng.randint(0, 2 ** 32, S, dtype=np.uint64).astype(np.uint32)
    subs = rng.randint(0, 100, S).astype(np.int32)
    temps = np.array([0, 0, 1.0, 0.7, 1.3, 1.0, 0.9, 1.0, 2.0, 0.5, 1.0, 0],
                     np.float32)
    topks = np.array([0, 0, 0, 5, 0, 1, 3, 0, 0, 10, 4, 0], np.int32)
    topps = np.array([1, 1, 1, 1, 0.9, 1, 0.5, 0.3, 0.95, 0.8, 1, 1],
                     np.float32)
    mask = np.zeros((S, V), np.float32)
    mask[1, logits[1].argmax()] = JS.NEG_MASK         # greedy, masked argmax
    mask[10, rng.permutation(V)[:20]] = JS.NEG_MASK   # sampled, masked
    args = (logits, seeds, subs, temps, topks, topps, mask)
    want = np.asarray(JS.masked_select_tokens(*(jnp.asarray(a)
                                                for a in args)))
    got = TS.masked_select_tokens(_t(logits), _t(seeds.astype(np.int64)),
                                  *(_t(a) for a in args[2:]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    assert mask[10, want[10]] == 0 and want[1] != logits[1].argmax()
