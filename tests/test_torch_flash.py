"""paddle_tpu_torch flash attention against the JAX package on the CPU.

The port's plain versions (``_fwd_reference``, ``_bwd_blockwise``, the
autograd Function on CPU tensors) are held against the Pallas kernels
themselves, run by their interpreter (``PADDLE_TPU_PALLAS=interpret``), on
the same numpy-seeded inputs.  The CUDA kernels are held against the same
plain versions on the card by ``chip_smoke.py``."""
import re
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_tpu.ops import attention as JA
from paddle_tpu.ops import flash_attention as jax_flash_attention
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import flash_attention

# forward, float32, against the Pallas kernel: sums in another order
FWD_ATOL = 2e-5
# backward, float32: max |d| relative to max |grad| (tests/test_pallas_ops.py)
BWD_F32_REL = 2e-4
# backward, bfloat16 inputs: p and dS round to bfloat16 at other places
BWD_BF16_REL = 0.08


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _qkv(seed, shape_q, shape_kv):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape_q).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32),
            rng.randn(*shape_kv).astype(np.float32))


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("N,Tq,Tk,D,causal", [
    (3, 80, 80, 32, False),     # several tiles of 32
    (3, 80, 80, 32, True),
    (2, 37, 37, 16, True),      # T not a multiple of any tile
    (1, 50, 70, 16, False),     # Tq != Tk
    (1, 50, 70, 16, True),      # causal, top-left aligned
])
def test_forward_matches_pallas_kernel(interpret_mode, N, Tq, Tk, D, causal):
    """o and lse of ``_fwd_reference`` against ``_fwd_pallas`` (atol 2e-5),
    and the autograd Function's output against the same o."""
    q, k, v = _qkv(N * Tq + D, (N, Tq, D), (N, Tk, D))
    scale = D ** -0.5
    jo, jlse = JA._fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale, causal, 32, 32, interpret=True)
    to, tlse = TA._fwd_reference(_t(q), _t(k), _t(v), scale, causal)
    assert to.dtype == torch.float32 and tlse.dtype == torch.float32
    assert tuple(tlse.shape) == (N, Tq)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=FWD_ATOL,
                               rtol=0)
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=FWD_ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_4d_matches_jax_flash_attention(interpret_mode, causal):
    """[B, H, T, D] operands, Tq != Tk when not causal (atol 2e-5)."""
    Tk = 33 if causal else 65
    q, k, v = _qkv(11, (2, 4, 33, 16), (2, 4, Tk, 16))
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=32, block_k=32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert tuple(got.shape) == (2, 4, 33, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL,
                               rtol=0)


# ---------------------------------------------------------------- backward


@pytest.mark.parametrize("N,T,Tk,D,causal,dt", [
    (2, 37, 37, 16, True, "float32"),
    (1, 50, 70, 16, False, "float32"),
    (2, 33, 33, 16, True, "bfloat16"),
    (2, 80, 80, 32, True, "float32"),
])
def test_backward_matches_pallas_kernels(N, T, Tk, D, causal, dt):
    """dq/dk/dv of ``_bwd_blockwise`` against ``_bwd_pallas`` (both Pallas
    backward kernels, interpreted) on the same (q, k, v, o, lse, g); the
    cases of tests/test_pallas_ops.py, with 4 heads folded into N."""
    q, k, v = _qkv(T + Tk + D, (N * 4, T, D), (N * 4, Tk, D))
    g = np.random.RandomState(5).randn(N * 4, T, D).astype(np.float32)
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    scale = D ** -0.5
    jo, jlse = JA._fwd_pallas(jq, jk, jv, scale, causal, 128, 128,
                              interpret=True)
    want = JA._bwd_pallas(jq, jk, jv, jo, jlse, jg, scale, causal, 128, 128,
                          interpret=True)
    to = _t(np.asarray(jo.astype(jnp.float32))).to(tdt)
    got = TA._bwd_blockwise(_t(q).to(tdt), _t(k).to(tdt), _t(v).to(tdt), to,
                            _t(np.asarray(jlse)), _t(g).to(tdt), scale,
                            causal, 128)
    tol = BWD_F32_REL if dt == "float32" else BWD_BF16_REL
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt, name
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a - b).max() / (np.abs(b).max() + 1e-6)
        assert err < tol, (name, N, T, Tk, D, causal, dt, err)


@pytest.mark.parametrize("causal", [False, True])
def test_function_grads_match_autograd_of_plain_forward(causal):
    """The autograd Function's hand backward against torch autograd through
    ``_fwd_reference`` (atol and rtol 1e-4, float32)."""
    q, k, v = _qkv(21, (2, 40, 16), (2, 40, 16))
    ins1 = [_t(a).requires_grad_(True) for a in (q, k, v)]
    ins2 = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (flash_attention(*ins1, causal=causal, block_k=16) ** 2).sum().backward()
    (TA._fwd_reference(*ins2, 16 ** -0.5, causal)[0] ** 2).sum().backward()
    for a, b in zip(ins1, ins2):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_function_grads_match_jax_grad(interpret_mode):
    """Gradients through the whole Function against ``jax.grad`` through the
    Pallas forward and backward kernels (2e-4 relative to max |grad|)."""
    q, k, v = _qkv(31, (1, 2, 45, 32), (1, 2, 45, 32))

    def jloss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (flash_attention(*ins, causal=True) ** 2).sum().backward()
    for a, b in zip(ins, want):
        b = np.asarray(b)
        err = np.abs(a.grad.numpy() - b).max() / np.abs(b).max()
        assert err < BWD_F32_REL, err


# ------------------------------------------------------- devices, counts


def test_meta_tensors_infer_shapes_and_launch_nothing():
    before = dict(flash_attention.launches)
    for dt in (torch.float32, torch.bfloat16):
        q = torch.empty((2, 3, 17, 64), dtype=dt, device="meta")
        k = torch.empty((2, 3, 29, 64), dtype=dt, device="meta")
        out = flash_attention(q, k, k, causal=True)
        assert out.device.type == "meta" and out.dtype == dt
        assert tuple(out.shape) == (2, 3, 17, 64)
        out3 = flash_attention(q[0], k[0], k[0])
        assert tuple(out3.shape) == (3, 17, 64)
    assert flash_attention.launches == before


def test_plain_versions_count_no_launch_and_other_devices_raise():
    before = dict(flash_attention.launches)
    q, k, v = (_t(a).requires_grad_(True)
               for a in _qkv(3, (2, 20, 16), (2, 20, 16)))
    flash_attention(q, k, v, causal=True).sum().backward()
    assert flash_attention.launches == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(other, other, other)
    # the kernel wrappers take CUDA tensors only; nothing gives way to the
    # plain version
    with pytest.raises(ValueError, match="CUDA"):
        TA.flash_fwd_kernel(q.detach(), k.detach(), v.detach(), 0.25, True)
    assert flash_attention.launches == before


def test_head_dims_match_cuda_source():
    """The wrapper's FLASH_HEAD_DIMS are exactly the D cases the .cu
    dispatches, for both dtypes."""
    src = (Path(TA.__file__).parent / "csrc" / "flash_attention.cu"
           ).read_text()
    for ty in ("float", "__nv_bfloat16"):
        dims = re.findall(r"case (\d+): return FN<" + ty + r", \1>", src)
        assert tuple(int(d) for d in dims) == TA.FLASH_HEAD_DIMS


# ------------------------------------------- the forward kernels' arithmetic


def _fwd_tiles(dtype, D: int):
    """(query rows of a block, keys of a K/V tile) of the forward kernel
    that ``dtype`` inputs run: FwdF32<D> or FwdBF16<D> of
    csrc/flash_attention.cu (test_forward_tiles_match_cuda_source pins
    them)."""
    if dtype == torch.float32:
        return (64 if D == 128 else 128), 64
    return 64, 64


def _fwd_kernel_transcribed(q, k, v, scale, causal):
    """flash_fwd_f32_kernel / flash_fwd_bf16_kernel transcribed: Q tiles
    and K/V tiles of :func:`_fwd_tiles`, the causal tile skip (and the float32
    kernel's skip of the first half of the Q tile where it precedes every
    key of the K tile), the masked fill, the online softmax per K tile
    (bfloat16 inputs round the running, unnormalised p before p . v), and
    o = acc / l, lse = m + log l with l == 0 taken as 1.  Returns (o in
    q's dtype, lse float32)."""
    N, Tq, D = q.shape
    Tk = k.shape[1]
    bq, bk = _fwd_tiles(q.dtype, D)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros(N, Tq, D)
    lse = torch.zeros(N, Tq)
    for q0 in range(0, Tq, bq):
        rows = torch.arange(q0, min(q0 + bq, Tq))
        n_kt = -(-Tk // bk)
        if causal:
            n_kt = min(n_kt, (min(q0 + bq, Tq) - 1) // bk + 1)
        m = torch.full((N, rows.numel()), TA.NEG_INF)
        l = torch.zeros(N, rows.numel())
        acc = torch.zeros(N, rows.numel(), D)
        for kt in range(n_kt):
            keys = torch.arange(kt * bk, min(kt * bk + bk, Tk))
            half = (q.dtype == torch.float32 and causal
                    and q0 + bq // 2 <= kt * bk)
            sub = slice(bq // 2 if half else 0, None)    # rows computed
            s = torch.full((N, rows.numel(), keys.numel()), TA.NEG_INF)
            s[:, sub] = torch.einsum("nqd,nkd->nqk", qf[:, rows[sub]],
                                     kf[:, keys]) * scale
            ok = torch.ones(rows.numel(), keys.numel(), dtype=torch.bool)
            if causal:
                ok = rows[:, None] >= keys[None, :]
            s = torch.where(ok, s, TA.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            if q.dtype == torch.bfloat16:
                p = p.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.einsum("nqk,nkd->nqd", p,
                                                        vf[:, keys])
            m = m_new
        safe = torch.where(l == 0, 1.0, l)
        o[:, rows] = acc / safe[..., None]
        lse[:, rows] = m + torch.log(safe)
    return o.to(q.dtype), lse


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,Tq,Tk,D,causal", [
    (2, 200, 200, 16, True),     # ragged: no multiple of any tile
    (1, 150, 90, 64, False),     # rectangular, Tk < one Q tile
    (1, 90, 150, 64, True),      # rectangular, causal, top-left aligned
    (2, 130, 130, 128, True),    # the 64-row float32 tiles of D = 128
    (1, 70, 200, 128, False),
])
def test_forward_kernel_arithmetic_matches_plain_version(N, Tq, Tk, D,
                                                         causal, dt):
    """The forward kernels' tiling and online softmax, transcribed, against
    ``_fwd_reference`` on the same inputs: lse atol 2e-5; o atol 2e-5 in
    float32 and, in bfloat16, within chip_smoke.py's element-wise limit
    2u (sum_k p_k |v_k| + |o|) + 2e-5, u = 2^-8."""
    q, k, v = (_t(a) for a in _qkv(Tq + Tk + D, (N, Tq, D), (N, Tk, D)))
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    q, k, v = q.to(tdt), k.to(tdt), v.to(tdt)
    scale = D ** -0.5
    o, lse = _fwd_kernel_transcribed(q, k, v, scale, causal)
    ro, rlse = TA._fwd_reference(q, k, v, scale, causal)
    assert o.dtype == tdt and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=FWD_ATOL,
                               rtol=0)
    d = (o.float() - ro.float()).abs()
    if dt == "float32":
        assert float(d.max()) <= FWD_ATOL
    else:
        a_sum = TA._fwd_reference(q.float(), k.float(), v.float().abs(),
                                  scale, causal)[0]
        limit = 2 * 2.0 ** -8 * (a_sum + ro.float().abs()) + FWD_ATOL
        assert bool((d <= limit).all()), float((d / limit).max())


def test_forward_tiles_match_cuda_source():
    """:func:`_fwd_tiles` gives the tiles FwdF32<D> and FwdBF16<D>
    declare."""
    src = (Path(TA.__file__).parent / "csrc" / "flash_attention.cu"
           ).read_text()
    f32 = re.search(r"struct FwdF32 \{.*?BQ = D == 128 \? (\d+) : (\d+);.*?"
                    r"BK = (\d+);", src, re.S).groups()
    bf16 = re.search(r"struct FwdBF16 \{.*?BQ = (\d+), BK = (\d+);", src,
                     re.S).groups()
    assert _fwd_tiles(torch.float32, 128) == (int(f32[0]), int(f32[2]))
    assert _fwd_tiles(torch.float32, 64) == (int(f32[1]), int(f32[2]))
    for D in TA.FLASH_HEAD_DIMS:
        assert _fwd_tiles(torch.bfloat16, D) == tuple(int(x) for x in bf16)


# ------------------------------------ the float32 backward kernels' tiling


def _bwd_f32_tiles(D: int) -> dict:
    """The tiles of the float32 backward kernels: dQ's (query rows of a
    block, keys of a K/V tile), BwdDqF32<D>, and dK/dV's (keys of a block,
    queries of a Q tile), BwdDkdvF32<D>, of csrc/flash_attention.cu
    (test_backward_tiles_match_cuda_source pins them; the same at every
    D)."""
    return {"dq": (64, 64), "dkdv": (64, 64)}


def _tile(x, r0: int, rows: int):
    """Rows [r0, r0 + rows) of x [N, T, ...], zero past T (cp.async's
    zero fill)."""
    out = x.new_zeros((x.shape[0], rows) + tuple(x.shape[2:]))
    take = x[:, r0:r0 + rows]
    out[:, :take.shape[1]] = take
    return out


def _dq_f32_kernel_transcribed(q, k, v, g, lse, delta, scale, causal):
    """flash_bwd_dq_f32_kernel transcribed: a block per (row of N, Q tile)
    loops over its K/V tiles up to the causal limit; zero-filled tiles;
    dP = G . V^T, then S = Q . K^T, p = exp(s scale - lse) masked to
    exactly 0 (also on padded rows and keys), dS = p (dP - delta) scale,
    dq += dS . K."""
    N, Tq, D = q.shape
    Tk = k.shape[1]
    bq, bk = _bwd_f32_tiles(D)["dq"]
    dq = torch.zeros(N, Tq, D)
    for qt in reversed(range(-(-Tq // bq))):     # longest rows first
        q0 = qt * bq
        rows = torch.arange(q0, q0 + bq)
        qs, gs = _tile(q, q0, bq), _tile(g, q0, bq)
        ls, dl = _tile(lse, q0, bq), _tile(delta, q0, bq)
        n_kt = -(-Tk // bk)
        if causal:
            n_kt = min(n_kt, (min(q0 + bq, Tq) - 1) // bk + 1)
        acc = torch.zeros(N, bq, D)
        for kt in range(n_kt):
            k0 = kt * bk
            keys = torch.arange(k0, k0 + bk)
            ks, vs = _tile(k, k0, bk), _tile(v, k0, bk)
            dp = torch.einsum("nqd,nkd->nqk", gs, vs)
            s = torch.einsum("nqd,nkd->nqk", qs, ks)
            ok = (rows[:, None] < Tq) & (keys[None, :] < Tk)
            if causal:
                ok = ok & (rows[:, None] >= keys[None, :])
            p = torch.where(ok, torch.exp(s * scale - ls[..., None]), 0.0)
            ds = p * (dp - dl[..., None]) * scale
            acc += torch.einsum("nqk,nkd->nqd", ds, ks)
        dq[:, q0:q0 + bq] = acc[:, :min(bq, Tq - q0)]
    return dq


def _dkdv_f32_kernel_transcribed(q, k, v, g, lse, delta, scale, causal):
    """flash_bwd_dkdv_f32_kernel transcribed, in the transposed frame: a
    block per (row of N, K tile) holds its K and V tiles (keys are the
    rows of its patches) and loops over Q tiles from the causal diagonal;
    lse and delta are per column, loaded with each Q tile; S^T = K . Q^T, P^T masked to exactly 0, dP^T = V . G^T, dS^T = P^T
    (dP^T - delta) scale, dk += dS^T . Q, dv += P^T . G."""
    N, Tq, D = q.shape
    Tk = k.shape[1]
    bk, bq = _bwd_f32_tiles(D)["dkdv"]
    dk, dv = torch.zeros(N, Tk, D), torch.zeros(N, Tk, D)
    for kt in range(-(-Tk // bk)):               # longest columns first
        k0 = kt * bk
        keys = torch.arange(k0, k0 + bk)
        ks, vs = _tile(k, k0, bk), _tile(v, k0, bk)
        dka, dva = torch.zeros(N, bk, D), torch.zeros(N, bk, D)
        # causal: Q tiles wholly above this K tile see p == 0
        for qt in range(k0 // bq if causal else 0, -(-Tq // bq)):
            q0 = qt * bq
            cols = torch.arange(q0, q0 + bq)
            qs, gs = _tile(q, q0, bq), _tile(g, q0, bq)
            ls, dl = _tile(lse, q0, bq), _tile(delta, q0, bq)
            st = torch.einsum("nkd,nqd->nkq", ks, qs)
            ok = (keys[:, None] < Tk) & (cols[None, :] < Tq)
            if causal:
                ok = ok & (cols[None, :] >= keys[:, None])
            pt = torch.where(ok, torch.exp(st * scale - ls[:, None, :]),
                             0.0)
            dpt = torch.einsum("nkd,nqd->nkq", vs, gs)
            dst = pt * (dpt - dl[:, None, :]) * scale
            dka += torch.einsum("nkq,nqd->nkd", dst, qs)
            dva += torch.einsum("nkq,nqd->nkd", pt, gs)
        dk[:, k0:k0 + bk] = dka[:, :min(bk, Tk - k0)]
        dv[:, k0:k0 + bk] = dva[:, :min(bk, Tk - k0)]
    return dk, dv


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("Tq,Tk,causal", [
    (37, 37, True),      # one ragged tile
    (50, 70, False),     # rectangular
    (70, 50, True),      # rectangular, causal, top-left aligned
    (130, 130, True),    # several tiles, the causal tile limits
])
def test_backward_f32_kernel_tiling_matches_plain_version(Tq, Tk, causal,
                                                          D):
    """The float32 backward kernels' tiling, transcribed, against
    ``_bwd_dq_blockwise`` / ``_bwd_dkdv_blockwise`` on the same (q, k, v,
    g, lse, delta): within 2e-4 of each gradient's max |g| (the tolerance
    chip_smoke.py holds the kernels to)."""
    N = 2
    q, k, v = (_t(a) for a in _qkv(Tq + 3 * Tk + D, (N, Tq, D), (N, Tk, D)))
    g = _t(np.random.RandomState(Tq + D).randn(N, Tq, D))
    scale = D ** -0.5
    o, lse = TA._fwd_reference(q, k, v, scale, causal)
    delta = (o * g).sum(-1)
    args = (q, k, v, g, lse, delta, scale, causal)
    got = (_dq_f32_kernel_transcribed(*args),
           *_dkdv_f32_kernel_transcribed(*args))
    want = (TA._bwd_dq_blockwise(*args, 128),
            *TA._bwd_dkdv_blockwise(*args, 128))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = float((a - b).abs().max()) / float(b.abs().max())
        assert err < BWD_F32_REL, (name, Tq, Tk, causal, D, err)


def test_backward_tiles_match_cuda_source():
    """:func:`_bwd_f32_tiles` gives the tiles BwdDqF32<D> and
    BwdDkdvF32<D> declare."""
    src = (Path(TA.__file__).parent / "csrc" / "flash_attention.cu"
           ).read_text()
    dq = re.search(r"struct BwdDqF32 \{\s+static constexpr int BQ = (\d+);"
                   r"[^\n]*\n\s+static constexpr int BK = (\d+);", src)
    dkdv = re.search(r"struct BwdDkdvF32 \{\s+static constexpr int BK = "
                     r"(\d+);[^\n]*\n\s+static constexpr int BQ = (\d+);",
                     src)
    for D in TA.FLASH_HEAD_DIMS:
        assert _bwd_f32_tiles(D)["dq"] == tuple(int(x) for x in dq.groups())
        assert _bwd_f32_tiles(D)["dkdv"] == tuple(int(x)
                                                  for x in dkdv.groups())
