"""paddle_tpu_torch ops against the JAX package on the CPU: the paged KV pool
(quantize, scatter, gather), decode attention and the plain version of the
paged-attention kernel against the Pallas kernel run by its interpreter,
and per-slot token selection.  Inputs come from numpy seeds and go through
both packages."""
import importlib
import re

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

# the package rebinds the name to the function; fetch the module
PA = importlib.import_module("paddle_tpu_torch.ops.paged_attention")

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
    (4, 1024, 48, False),          # head dim the kernel does not take
    (8, 8192, 64, True),           # long T: no score row caps it any more
])
def test_kernel_geometry_limits(W, T, Dh, ok):
    """The split of T at the serving shape (8 slots, 8 heads, block 16) on
    132 SMs: the splits cover every column once, there are at most
    MAX_SPLITS of them, and splits x heads x slots fills the SMs."""
    S, H, Bs, n_sm = 8, 8, 16, 132
    if not ok:
        with pytest.raises(ValueError):
            _kernel_geometry(S, W, H, T // Bs, Dh, n_sm)
        return
    cols, n_splits = _kernel_geometry(S, W, H, T // Bs, Dh, n_sm)
    assert cols >= 1 and n_splits <= PA.MAX_SPLITS
    assert n_splits == -(-(T // Bs) // cols)
    assert n_splits * S * H >= n_sm


def test_kernel_limits_match_cuda_source():
    """The wrapper's copies of the kernel's constants (window, head dims,
    warps of a split block, the stats after each partial row, the most
    splits, the columns staged at once) must equal the .cu's."""
    from pathlib import Path

    src = (Path(PA.__file__).parent / "csrc" / "paged_attention.cu"
           ).read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kMaxW"]) == PA.MAX_WINDOW
    assert int(const["kMaxDh"]) == max(PA.HEAD_DIMS)
    assert int(const["kWarps"]) == PA.SPLIT_WARPS
    assert int(const["kPartExtra"]) == PA._PART_EXTRA
    assert int(const["kMaxSplits"]) == PA.MAX_SPLITS
    assert int(const["kColChunk"]) == PA.COL_CHUNK
    dims = re.search(r"\(Dh != (\d+) && Dh != (\d+) && Dh != (\d+) && "
                     r"Dh != kMaxDh\)", src).groups()
    assert tuple(int(d) for d in dims) + (int(const["kMaxDh"]),) == \
        PA.HEAD_DIMS


def _lane_geometry(kv_dtype, W: int, Dh: int):
    """How a split block's lanes take positions, as elems_per_lane and
    unroll of csrc/paged_attention.cu give it: (values a lane loads at
    once, lanes per position, positions per load instruction, positions per
    lane group per pass), for the window bucket (1, 2, 4 or 8) that holds
    W."""
    wb = 1 if W <= 1 else 2 if W <= 2 else 4 if W <= 4 else 8
    itemsize = torch.empty((), dtype=kv_dtype).element_size()
    elems = {4: 4, 2: 8, 1: 16 if wb <= 4 else 8}[itemsize]
    lanes = Dh // elems
    unroll = (1 if elems == 16 else
              2 if wb == 8 or (elems == 8 and wb == 4) else 4)
    return elems, lanes, 32 // lanes, unroll


def _split_kernel_transcribed(q, k_pool, v_pool, layer, tables, lengths,
                              scale, out_dtype, cols):
    """csrc/paged_attention.cu transcribed: paged_split_kernel over a grid
    of (split, head, slot), the split's columns staged COL_CHUNK at a time,
    its lane groups' online softmax streams, their butterfly merge, the
    warps' merge and the partials or the direct write, then
    paged_combine_kernel's weights and sums.  q [S, W, H, Dh], lengths
    [S, W]."""
    quantized = isinstance(k_pool, tuple)
    ka, va = TA.pool_arena(k_pool), TA.pool_arena(v_pool)
    S, W, H, Dh = q.shape
    NB, _, _, Bs, _ = ka.shape
    n_tbl = tables.shape[1]
    n_splits = -(-n_tbl // cols)
    _, _, NG, U = _lane_geometry(ka.dtype, W, Dh)
    warps = PA.SPLIT_WARPS
    round_p = out_dtype == torch.bfloat16
    ninf = float("-inf")
    qf = q.float()
    out = torch.zeros(S, W, H, Dh)

    def row(arena, planes, blk, r, h):
        x = arena[blk, layer, h, r].float()
        return x, (planes[1][blk, layer, h, r] if quantized else 1.0)

    def merge(a, b):
        (ma, la, aa), (mb, lb, ab) = a, b
        mn = torch.maximum(ma, mb)
        wa = torch.where(ma == ninf, 0.0, torch.exp(ma - mn))
        wb = torch.where(mb == ninf, 0.0, torch.exp(mb - mn))
        return mn, la * wa + lb * wb, aa * wa[:, None] + ab * wb[:, None]

    for s in range(S):
        lens = lengths[s]
        n_live = (n_tbl if int(lens.min()) <= 0 else
                  min(n_tbl, -(-int(lens.max()) // Bs)))
        live_splits = -(-n_live // cols)
        parts = []
        for h in range(H):
            for sp in range(n_splits):
                c0 = sp * cols
                if c0 >= n_live:
                    continue                    # wholly past every row
                c_end = min(c0 + cols, n_live)
                passes = [(base, cc * Bs, min(cc + PA.COL_CHUNK, c_end) * Bs)
                          for cc in range(c0, c_end, PA.COL_CHUNK)
                          for base in range(cc * Bs, min(cc + PA.COL_CHUNK,
                                                         c_end) * Bs,
                                            warps * NG * U)]
                per_warp = []
                for warp in range(warps):
                    streams = []
                    for g in range(NG):
                        m = torch.full((W,), ninf)
                        l, acc = torch.zeros(W), torch.zeros(W, Dh)
                        for base0, _, t_end in passes:
                            base = base0 + warp * NG * U
                            if base >= t_end:
                                continue
                            sc = torch.full((U, W), ninf)
                            pr_v = []
                            for u in range(U):
                                t = base + u * NG + g
                                if t >= t_end:
                                    pr_v.append((torch.zeros(Dh), 0.0))
                                    continue
                                blk = min(max(int(tables[s, t // Bs]), 0),
                                          NB - 1)
                                k, ks = row(ka, k_pool, blk, t % Bs, h)
                                v, vs = row(va, v_pool, blk, t % Bs, h)
                                d = (qf[s, :, h] * k).sum(-1) * scale * ks
                                sc[u] = torch.where(t < lens, d,
                                                    torch.tensor(-1e9))
                                pr_v.append((v, vs))
                            m_new = torch.maximum(m, sc.max(0).values)
                            any_ = m_new != ninf
                            alpha = torch.where(any_, torch.exp(m - m_new),
                                                1.0)
                            p = torch.where(any_, torch.exp(sc - m_new), 0.0)
                            l = l * alpha + p.sum(0)
                            if round_p:
                                p = p.to(torch.bfloat16).float()
                            acc = acc * alpha[:, None]
                            for u, (v, vs) in enumerate(pr_v):
                                acc = acc + (p[u] * vs)[:, None] * v
                            m = m_new
                        streams.append((m, l, acc))
                    off = 1
                    while off < NG:             # butterfly over the groups
                        streams = [merge(streams[g], streams[g ^ off])
                                   for g in range(NG)]
                        off *= 2
                    per_warp.append(streams[0])
                M = torch.stack([w[0] for w in per_warp]).max(0).values
                num, den = torch.zeros(W, Dh), torch.zeros(W)
                for mk, lk, ak in per_warp:
                    wk = torch.where(mk == ninf, 0.0, torch.exp(mk - M))
                    num = num + wk[:, None] * ak
                    den = den + wk * lk
                if live_splits == 1:
                    out[s, :, h] = num / den[:, None]
                else:
                    parts.append((h, sp, M, den, num))
        for h in range(H):
            mine = [p for p in parts if p[0] == h]    # in split order
            if not mine:
                continue
            M = torch.stack([p[2] for p in mine]).max(0).values
            e = [torch.exp(mj - M) for _, _, mj, _, _ in mine]
            den = sum(ej * p[3] for ej, p in zip(e, mine))
            o = torch.zeros(W, Dh)
            for ej, (_, _, _, _, nj) in zip(e, mine):
                o = o + (ej / den)[:, None] * nj
            out[s, :, h] = o
    return out.to(out_dtype)


def _split_case(kind, W, Dh):
    """Pools of `kind` with a poisoned trash block; slot 0 runs nearly to
    the end of its table, slot 1 has a row of length 0 (every column
    counts), slot 2 is short (the later splits lie wholly past its rows)
    and holds out-of-range table entries the kernel clamps."""
    S, H, Bs, n_tbl, L = 3, 2, 4, 6, 2
    nb = S * n_tbl
    rng = np.random.RandomState(W * 7 + Dh)
    shape = (nb + 1, L, H, Bs, Dh)
    kf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    vf = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    kf[nb] = vf[nb] = 30.0
    if kind == "int8":
        kp, vp = TA.quantize_kv(kf), TA.quantize_kv(vf)
        qdt = torch.float32
    else:
        qdt = torch.float32 if kind == "float32" else torch.bfloat16
        kp, vp = kf.to(qdt), vf.to(qdt)
    top = np.array([n_tbl * Bs - 1, 9, 5])
    lengths = (top[:, None] - np.arange(W)[::-1][None, :]).astype(np.int32)
    lengths[1, 0] = 0
    tables = rng.permutation(nb)[:S * n_tbl].reshape(S, n_tbl)
    tables = tables.astype(np.int32)
    tables[2, 1] = -3                   # clamped to block 0
    tables[2, 2:] = nb + 40             # clamped to the trash block
    q = torch.from_numpy(rng.standard_normal((S, W, H, Dh)).astype(
        np.float32)).to(qdt)
    return q, kp, vp, torch.from_numpy(tables), torch.from_numpy(lengths)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("W,Dh", [(1, 64), (4, 16), (8, 32)])
@pytest.mark.parametrize("cols", [1, 2, 4, 6])
def test_split_kernel_arithmetic_matches_plain_version(kind, W, Dh, cols):
    """The split kernel's partials and their combine, transcribed, against
    ``paged_attention_reference`` on the clamped tables, at split lengths
    from one column to the whole table (one split, written directly):
    float32 and int8 atol 2e-5 rtol 1e-5, bfloat16 outputs 2e-2 (they round
    probabilities per stream, before the rescaling)."""
    q, kp, vp, tables, lengths = _split_case(kind, W, Dh)
    nb = TA.pool_arena(kp).shape[0]
    out_dtype = q.dtype
    got = _split_kernel_transcribed(q, kp, vp, 1, tables, lengths,
                                    Dh ** -0.5, out_dtype, cols)
    want = paged_attention_reference(q, kp, vp, 1,
                                     tables.clamp(0, nb - 1), lengths,
                                     out_dtype=out_dtype)
    atol, rtol = (2e-2, 2e-2) if kind == "bfloat16" else (2e-5, 1e-5)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_split_kernel_column_chunks_match_plain_version(monkeypatch, kind):
    """A split longer than the columns a block stages at once walks them
    chunk by chunk (here 2 columns a chunk, so one split of 6 columns takes
    3), against ``paged_attention_reference``, as above."""
    monkeypatch.setattr(PA, "COL_CHUNK", 2)
    q, kp, vp, tables, lengths = _split_case(kind, 4, 16)
    nb = TA.pool_arena(kp).shape[0]
    got = _split_kernel_transcribed(q, kp, vp, 1, tables, lengths, 0.25,
                                    q.dtype, 6)
    want = paged_attention_reference(q, kp, vp, 1,
                                     tables.clamp(0, nb - 1), lengths,
                                     scale=0.25, out_dtype=q.dtype)
    atol, rtol = (2e-2, 2e-2) if kind == "bfloat16" else (2e-5, 1e-5)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=rtol)


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
