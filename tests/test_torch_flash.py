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
