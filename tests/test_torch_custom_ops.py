"""The backward kernels as custom ops of the ``paddle_tpu_torch`` namespace
(``flash_bwd``, ``lstm_fwd_train``, ``lstm_bwd``, ``bn_bwd_reduce``,
``bn_bwd_dx``, ``dropout_fwd``, ``dropout_bwd``), on the CPU: each op's
registration checked by ``torch.library.opcheck`` (schema, fake
implementation, autograd registration); each op bitwise its plain version
on the same inputs; each ``autograd.Function`` that calls them, held to
the JAX reference's gradient (``jax.grad`` / ``jax.vjp`` of the JAX
package's op, its Pallas kernels interpreted) with the kernel tests'
bounds; and every op of a training step traced as one node by
``make_fx`` in fake mode, where a raw launch would raise.  On the card
``chip_smoke.py``'s custom-ops phase holds each op bitwise against its
direct kernel wrapper."""
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu.core.program import OpContext as JaxOpContext
from paddle_tpu.ops import flash_attention as jax_flash_attention
from paddle_tpu.ops import fused_lstm as jax_fused_lstm
from paddle_tpu_torch.compile import aot
from paddle_tpu_torch.ops import attention as TA
from paddle_tpu_torch.ops import batch_norm as TB
from paddle_tpu_torch.ops import dropout as dmod
from paddle_tpu_torch.ops import lstm as TL
from paddle_tpu_torch.ops import flash_attention, fused_lstm

OPCHECK = ("test_schema", "test_faketensor", "test_autograd_registration")
ACTS = ("sigmoid", "tanh", "tanh")
T, B, H = 7, 4, 8
CMAP = dmod.CounterMap(base=3, row=12, stride=20, seg=5, off0=1, off1=4)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _rand(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32))


def _flash_args():
    q, k, v = (_rand(i, 2, 12, 16) for i in range(3))
    o, lse = TA._fwd_reference(q, k, v, 0.25, True)
    return (q, k, v, o, lse, _rand(4, 2, 12, 16), 0.25, True, 4)


def _lstm_args(use_peep=True):
    xw, u = _rand(0, T, B, 4 * H), _rand(1, H, 4 * H) / H ** 0.5
    peep = _rand(2, 3, H) * 0.5
    mask = (torch.arange(T)[:, None] < torch.tensor([7, 3, 1, 5])[None, :]
            ).float()
    return xw, u, peep, mask, H, use_peep, *ACTS


def _lstm_bwd_args(use_peep=True):
    xw, u, peep, mask, size, up, *acts = _lstm_args(use_peep)
    hs, hc, cc, gates, cnew = TL._lstm_scan_residuals(xw, u, peep, mask,
                                                      size, up, acts)
    return (_rand(5, T, B, H), _rand(6, B, H), u, peep, mask, hc, cc, gates,
            cnew, size, up, *acts)


def _bn_args():
    x, dy = _rand(0, 4, 3, 5, 5), _rand(1, 4, 3, 5, 5)
    mean = x.mean((0, 2, 3))
    rstd = torch.rsqrt(x.var((0, 2, 3), unbiased=False) + 1e-5)
    return dy, x, mean, rstd


def _bn_dx_args():
    dy, x, mean, rstd = _bn_args()
    dbeta, dgamma = TB.bn_bwd_reduce_reference(dy, x, mean, rstd)
    return dy, x, mean, rstd, _rand(2, 3) + 1.0, dbeta, dgamma, 0


def _dropout_args(staged, mapped):
    step = torch.tensor([7], dtype=torch.int32) if staged else None
    return (_rand(0, 4, 12), step, 0 if staged else 2 ** 32 - 1, 11, 5, 0.3,
            list(CMAP) if mapped else [])


CASES = {
    "flash_bwd": (TA.flash_bwd_op, _flash_args,
                  lambda *a: TA._bwd_blockwise(*a)),
    "lstm_fwd_train": (TL.lstm_fwd_train_op, _lstm_args,
                       lambda *a: TL._lstm_scan_residuals(*a[:6], a[6:])),
    "lstm_bwd": (TL.lstm_bwd_op, _lstm_bwd_args,
                 lambda *a: TL._weight_grads(
                     TL._lstm_reverse_reference(
                         *a[:5], a[7], a[8], a[6], a[9], a[10], a[11:]),
                     a[3], a[5], a[6], a[8], a[9], a[10])),
    "bn_bwd_reduce": (TB.bn_bwd_reduce, _bn_args,
                      TB.bn_bwd_reduce_reference),
    "bn_bwd_dx": (TB.bn_bwd_dx, _bn_dx_args,
                  lambda *a: TB.bn_bwd_dx_reference(*a[:7], None)),
}
for _which, _op in (("fwd", dmod.dropout_fwd_op),
                    ("bwd", dmod.dropout_bwd_op)):
    for _staged in (False, True):
        for _mapped in (False, True):
            CASES[f"dropout_{_which}-{'staged' if _staged else 'imm'}-"
                  f"{'mapped' if _mapped else 'plain'}"] = (
                _op, lambda s=_staged, m=_mapped: _dropout_args(s, m),
                lambda x, step, imm, seed, tag, p, cmap: dmod.dropout_reference(
                    x, dmod.ThreefryKey(seed, imm if step is None else step,
                                        tag), p,
                    dmod.CounterMap(*cmap) if cmap else None))


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_is_registered_and_bitwise_its_plain_version(name):
    op, make, plain = CASES[name]
    args = make()
    torch.library.opcheck(op, args, test_utils=OPCHECK)
    got, want = op(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _strided(t):
    """``t``'s values in a non-contiguous layout (its first two dims
    stored swapped), as a trace can hand an op a view."""
    return t.transpose(0, 1).contiguous().transpose(0, 1)


STRIDED = {
    "flash_fwd": (TA.flash_fwd_op,
                  lambda: tuple(_strided(t) for t in _flash_args()[:3])
                  + (0.25, True)),
    "flash_bwd": (TA.flash_bwd_op,
                  lambda: tuple(_strided(t) if t.dim() == 3 else t
                                for t in _flash_args()[:6])
                  + _flash_args()[6:]),
    "bn_bwd_dx": (TB.bn_bwd_dx,
                  lambda: tuple(t.contiguous(memory_format=torch.channels_last)
                                if isinstance(t, torch.Tensor) and t.dim() == 4
                                else t for t in _bn_dx_args())),
    "dropout_fwd": (dmod.dropout_fwd_op,
                    lambda: (_strided(_rand(0, 4, 12)),)
                    + _dropout_args(False, False)[1:]),
    "dropout_bwd": (dmod.dropout_bwd_op,
                    lambda: (_strided(_rand(0, 4, 12)),)
                    + _dropout_args(True, True)[1:]),
}


@pytest.mark.parametrize("name", sorted(STRIDED))
def test_fake_strides_match_on_strided_inputs(name):
    """Each op's outputs are contiguous on both devices, and its fake
    implementation says so for a view too: a trace (a stored serving bucket
    at batch 1) decides its own views by the fake strides."""
    op, make = STRIDED[name]
    args = make()
    torch.library.opcheck(op, args, test_utils=("test_faketensor",))
    out = op(*args)
    assert all(t.is_contiguous()
               for t in (out if isinstance(out, tuple) else (out,)))


def test_ops_give_shapes_on_meta_tensors():
    """The fake implementation answers for meta tensors: a shape, no
    launch."""
    x = torch.empty(4, 12, device="meta")
    out = dmod.dropout_fwd_op(x, None, 0, 1, 2, 0.5, [])
    assert out.device.type == "meta" and out.shape == x.shape


# --------------------------------------------------- against the reference


def test_flash_function_grads_match_jax(interpret_mode):
    """dq, dk, dv through ``_Flash`` (the ``flash_bwd`` op) against
    ``jax.grad`` through the Pallas kernels, 2e-4 of max |grad|."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 2, 20, 16).astype(np.float32) for _ in range(3))

    def jloss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal=True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (flash_attention(*ins, causal=True) ** 2).sum().backward()
    for a, b in zip(ins, want):
        b = np.asarray(b)
        assert np.abs(a.grad.numpy() - b).max() / np.abs(b).max() < 2e-4


@pytest.mark.parametrize("use_peep", [False, True])
def test_lstm_function_grads_match_jax(interpret_mode, use_peep):
    """d(sum(hs^2) + sum(c_final)) / d(xw, u, peep) through ``_LSTM`` (the
    ``lstm_fwd_train`` and ``lstm_bwd`` ops) against ``jax.grad`` through
    JAX's custom_vjp, atol 1e-4; hs and c_final bitwise the plain
    forward's."""
    xw, u, peep, mask = (a.numpy() for a in _lstm_args(use_peep)[:4])
    kw = dict(size=H, use_peepholes=use_peep, gate_activation=ACTS[0],
              cell_activation=ACTS[1], candidate_activation=ACTS[2])

    def jloss(xw, u, peep):
        hs, c = jax_fused_lstm(xw, u, peep, jnp.asarray(mask), **kw)
        return jnp.sum(hs ** 2) + jnp.sum(c)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                   (xw, u, peep)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (xw, u, peep)]
    hs, c = fused_lstm(*ins, torch.from_numpy(mask), **kw)
    ref_hs, ref_c = TL._lstm_scan(*(t.detach() for t in ins),
                                  torch.from_numpy(mask), H, use_peep, ACTS)
    assert torch.equal(hs.detach(), ref_hs) and torch.equal(c.detach(),
                                                            ref_c)
    ((hs ** 2).sum() + c.sum()).backward()
    for a, b in zip(ins, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_bn_function_grads_match_jax():
    """dx, dgamma, dbeta through ``_BatchNormTrain`` (the ``bn_bwd_reduce``
    and ``bn_bwd_dx`` ops) against ``jax.vjp`` of the JAX package's
    training ``batch_norm`` op, 1e-5 of each max |g|."""
    rng = np.random.RandomState(9)
    x = (rng.standard_normal((4, 3, 5, 5)) * 2 + 0.5).astype(np.float32)
    scale = (rng.rand(3) + 0.5).astype(np.float32)
    bias = rng.standard_normal(3).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jfluid.reset_default_programs()
    jfluid.layers.batch_norm(jfluid.layers.data("x", [3, 5, 5]))
    (op,) = [o for o in jfluid.default_main_program().list_ops()
             if o.type == "batch_norm"]
    stats = (jnp.zeros(3, jnp.float32), jnp.ones(3, jnp.float32))

    def jfwd(a, s, b):
        return op.fn({"X": [a], "Scale": [s], "Bias": [b],
                      "Mean": [stats[0]], "Variance": [stats[1]]},
                     op.attrs, JaxOpContext(jax.random.key(0)))["Out"][0]

    _, vjp = jax.vjp(jfwd, *map(jnp.asarray, (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, scale, bias)]
    out = TB.batch_norm_train(*leaves, 1e-5)[0]
    out.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("staged", [False, True])
def test_dropout_function_matches_jax(staged):
    """y and dx through ``_Dropout`` (the ``dropout_fwd`` and ``dropout_bwd``
    ops), the step an immediate or the staged word, bitwise JAX's
    bernoulli mask for (seed, step, tag) and ``jax.vjp`` of it."""
    seed, step, tag, p = 3, 2 ** 31 + 5, 9, 0.4
    rng = np.random.RandomState(0)
    x = rng.randn(6, 10).astype(np.float32)
    g = rng.randn(6, 10).astype(np.float32)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed),
                                               np.uint32(step)),
                            np.uint32(tag))
    jy, vjp = jax.vjp(lambda a: a * jax.random.bernoulli(
        jk, 1.0 - p, a.shape).astype(a.dtype), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    s = (torch.from_numpy(np.array([step], np.uint32).view(np.int32))
         if staged else step)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = dmod.threefry_dropout(tx, dmod.ThreefryKey(seed, s, tag), p)
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    assert np.array_equal(ty.detach().numpy(), np.asarray(jy))
    assert np.array_equal(tdx.numpy(), np.asarray(jdx))


# ------------------------------------------------------------------ traces


def test_a_training_step_traces_every_kernel_as_one_node():
    """``make_fx`` in fake mode through ``torch.autograd.grad`` of flash,
    LSTM, batch norm and dropout: each kernel one node, the staged step
    word a graph input, the graph bitwise the eager step."""
    q, k, v = (_rand(i, 2, 12, 16) for i in range(3))
    xw, u, peep, mask = _lstm_args()[:4]
    x = _rand(7, 4, 3, 5, 5)
    gamma, beta = torch.ones(3), torch.zeros(3)

    def step(q, k, v, xw, u, peep, mask, x, gamma, beta, word):
        leaves = [t.detach().requires_grad_(True)
                  for t in (q, k, v, xw, u, peep, x, gamma, beta)]
        a = flash_attention(*leaves[:3], causal=True)
        hs, c = fused_lstm(*leaves[3:6], mask, size=H, use_peepholes=True)
        y = TB.batch_norm_train(leaves[6], leaves[7], leaves[8], 1e-5)[0]
        y = dmod.threefry_dropout(y, dmod.ThreefryKey(1, word, 2), 0.5)
        loss = (a ** 2).sum() + (hs ** 2).sum() + c.sum() + (y ** 2).sum()
        return torch.autograd.grad(loss, leaves)

    args = (q, k, v, xw, u, peep, mask, x, gamma, beta,
            torch.tensor([5], dtype=torch.int32))
    gm = make_fx(step, tracing_mode="fake")(*args)
    assert aot.custom_op_counts(gm) == {
        "flash_fwd": 1, "flash_bwd": 1, "lstm_fwd_train": 1, "lstm_bwd": 1,
        "bn_bwd_reduce": 1, "bn_bwd_dx": 1, "dropout_fwd": 1,
        "dropout_bwd": 1}
    for a, b in zip(gm(*args), step(*args)):
        assert torch.equal(a, b)
    other = args[:-1] + (torch.tensor([6], dtype=torch.int32),)
    assert not torch.equal(gm(*other)[6], gm(*args)[6])
