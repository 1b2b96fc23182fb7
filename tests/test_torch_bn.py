"""paddle_tpu_torch's batch-norm backward against the JAX package on the CPU.

The plain versions of the two CUDA kernels (``bn_bwd_reduce_reference``,
``bn_bwd_dx_reference``) are held against ``benchmark/bn_probe.py``'s
Pallas kernels (run by the interpreter) and its XLA forms, and
``batch_norm_train`` (forward and closed-form backward) against
``jax.vjp`` of the JAX batch_norm op's own forward.  The kernels' walk over
a channel (``csrc/batch_norm.cu``: the (channel, split) grid, vector
loads, the position kept by addition, the split-order combine) is
transcribed and held against the plain reduction, since the kernels run
only on the card, where ``chip_smoke.py`` holds them against the plain
versions."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.program import OpContext as JaxOpContext
from paddle_tpu_torch.ops import batch_norm as TB

REPO = Path(__file__).resolve().parents[1]
BF16_U = 2.0 ** -8     # bfloat16's relative spacing: one rounding <= u |v|
SUM_REL = 1e-5         # float32 sums in another order, of sum |terms|


def _load_probe(monkeypatch, n, c, h, w):
    """benchmark/bn_probe.py at [n, c, h, w], its Pallas kernels in
    interpret mode; the probe reads its shape and mode at import."""
    for key, val in (("BN_N", n), ("BN_C", c), ("BN_H", h), ("BN_W", w)):
        monkeypatch.setenv(key, str(val))
    monkeypatch.setenv("BN_PROBE_INTERPRET", "1")
    spec = importlib.util.spec_from_file_location(
        f"bn_probe_{n}_{c}_{h}_{w}", REPO / "benchmark" / "bn_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def _bn_inputs(seed, n, c, h, w, dtype):
    """dy N(0, 1) and x N(0.5, 2^2) in ``dtype`` (one channel constant),
    their batch statistics mean and rstd in float32 (from the rounded x),
    gamma in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, c, h, w)).astype(np.float32) * 2 + 0.5
    x[:, c // 2] = 1.25
    dy = rng.standard_normal((n, c, h, w)).astype(np.float32)
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    x32 = tx.float()
    mean = x32.mean((0, 2, 3))
    var = torch.clamp_min((x32 * x32).mean((0, 2, 3)) - mean * mean, 0.0)
    rstd = torch.rsqrt(var + 1e-5)
    gamma = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5)
    return tdy, tx, mean, rstd, gamma


def _jnp(t):
    """A torch tensor as a jax array of the same dtype (via float32)."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _xhat(x, mean, rstd):
    return (x.float() - mean[None, :, None, None]) * rstd[None, :, None, None]


# ------------------------------------------------------------ against the probe


@pytest.mark.parametrize("shape,dtype", [
    ((2, 16, 8, 8), torch.bfloat16),     # the probe's dtype
    ((3, 6, 7, 7), torch.bfloat16),      # H*W = 49, as at the last stage
    ((3, 5, 7, 7), torch.float32),       # C not a power of two, H*W = 49
    ((2, 12, 4, 6), torch.float32),
    ((4, 3, 8, 8), torch.float32),
])
def test_plain_versions_match_bn_probe(monkeypatch, shape, dtype):
    """dbeta, dgamma and dx of the plain versions against the probe's
    Pallas kernels and its XLA forms on the same dy and x-hat.  The probe
    reads a stored x-hat (bfloat16 at the probe's dtype); the port
    recomputes it from x, mean and rstd in float32, so in bfloat16 dgamma
    may differ by u sum |dy x-hat| and dx by u |g x-hat dgamma / M|.
    The probe writes dx in bfloat16 always: a float32 dx is held to one
    rounding, u |dx|, and also against a float64 reference at 1e-5 of max
    |dx|."""
    n, c, h, w = shape
    probe = _load_probe(monkeypatch, n, c, h, w)
    dy, x, mean, rstd, gamma = _bn_inputs(sum(shape), n, c, h, w, dtype)
    m = n * h * w
    xhat = _xhat(x, mean, rstd)
    xhat_in = xhat.to(dtype)        # what the probe's kernels read

    dbeta, dgamma = TB.bn_bwd_reduce_reference(dy, x, mean, rstd)
    assert dbeta.dtype == dgamma.dtype == torch.float32
    abs_dy = dy.float().abs().sum((0, 2, 3)).numpy()
    abs_dg = (dy.float() * xhat).abs().sum((0, 2, 3)).numpy()
    u = BF16_U if dtype == torch.bfloat16 else 0.0
    flat = (_jnp(dy).reshape(n, c, h * w), _jnp(xhat_in).reshape(n, c, h * w))
    for name, (rb, rg) in (
            ("pallas", probe.pallas_reduce_flat(*flat)),
            ("xla_4d", probe.xla_reduce_4d(_jnp(dy), _jnp(xhat_in)))):
        rb, rg = np.asarray(rb).reshape(c), np.asarray(rg).reshape(c)
        assert np.all(np.abs(dbeta.numpy() - rb) <= SUM_REL * abs_dy), name
        assert np.all(np.abs(dgamma.numpy() - rg)
                      <= (SUM_REL + u) * abs_dg), name

    dx = TB.bn_bwd_dx_reference(dy, x, mean, rstd, gamma, dbeta, dgamma)
    assert dx.dtype == dtype and dx.shape == dy.shape
    g = gamma * rstd
    args = tuple(jnp.asarray(v.numpy())[None, :]
                 for v in (g, dbeta / m, dgamma / m))
    got = dx.float().numpy()
    top = float(np.abs(got).max())
    xterm = (g[None, :, None, None] * xhat * (dgamma / m)[None, :, None, None]
             ).abs().numpy()
    tol = 2 * BF16_U * np.abs(got) + u * xterm + SUM_REL * top
    for name, want in (
            ("pallas", probe.pallas_dx_flat(*flat, *args)),
            ("xla_4d", probe.xla_dx_4d(_jnp(dy), _jnp(xhat_in),
                                        *(a[0] for a in args)))):
        want = np.asarray(jnp.asarray(want, jnp.float32)).reshape(shape)
        assert np.all(np.abs(got - want) <= tol), name

    # float64 from the same rounded inputs
    d64 = dy.double().numpy()
    xh64 = ((x.double() - mean.double()[None, :, None, None])
            * rstd.double()[None, :, None, None]).numpy()
    db64, dg64 = d64.sum((0, 2, 3)), (d64 * xh64).sum((0, 2, 3))
    g64 = (gamma.double() * rstd.double()).numpy()[None, :, None, None]
    dx64 = g64 * (d64 - db64[None, :, None, None] / m
                  - xh64 * dg64[None, :, None, None] / m)
    np.testing.assert_allclose(dbeta.numpy(), db64, rtol=0,
                               atol=SUM_REL * abs_dy.max())
    np.testing.assert_allclose(dgamma.numpy(), dg64, rtol=0,
                               atol=SUM_REL * abs_dg.max())
    lim = (BF16_U * np.abs(dx64) if dtype == torch.bfloat16 else 0.0) \
        + SUM_REL * np.abs(dx64).max()
    assert np.all(np.abs(got - dx64) <= lim)


# ------------------------------------------------------- against jax.vjp


def _jax_bn_op(shape):
    """The JAX batch_norm layer's own op (training), from a fresh program."""
    jfluid.reset_default_programs()
    x = jfluid.layers.data("x", list(shape[1:]))
    jfluid.layers.batch_norm(x)
    (op,) = [o for o in jfluid.default_main_program().list_ops()
             if o.type == "batch_norm"]
    return op


@pytest.mark.parametrize("shape", [(4, 8, 5, 5), (3, 5, 7, 7), (6, 4),
                                   (2, 3, 4, 2, 3)])
def test_batch_norm_train_matches_jax_vjp(shape):
    """Forward (out, batch mean, batch variance) and backward (dx, dgamma,
    dbeta) of ``batch_norm_train`` on CPU tensors against ``jax.vjp`` of
    the JAX op's forward, float32, with a constant channel: out within
    1e-5 of max |out|, each gradient within 1e-5 of its max |g|.  JAX
    differentiates the one-pass forward (mean, E[x^2], the clamp) by
    autodiff; the port's backward is the closed form."""
    rng = np.random.RandomState(len(shape) * 7 + shape[1])
    c = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    x[:, 1] = -0.75
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    op = _jax_bn_op(shape)
    stats = (jnp.zeros(c, jnp.float32), jnp.ones(c, jnp.float32))

    def jax_fwd(a, s, b):
        outs = op.fn({"X": [a], "Scale": [s], "Bias": [b],
                      "Mean": [stats[0]], "Variance": [stats[1]]},
                     op.attrs, JaxOpContext(jax.random.key(0)))
        return outs["Out"][0]

    jout, vjp = jax.vjp(jax_fwd, jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias))
    jgrads = [np.asarray(v) for v in vjp(jnp.asarray(g))]

    leaves = [torch.tensor(v, requires_grad=True) for v in (x, scale, bias)]
    out, bmean, bvar = TB.batch_norm_train(*leaves, 1e-5)
    assert not bmean.requires_grad and not bvar.requires_grad
    dims = (0,) + tuple(range(2, len(shape)))
    np.testing.assert_allclose(bmean.numpy(), x.mean(dims), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bvar.numpy(), x.var(dims), rtol=0, atol=1e-4)
    top = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5 * top)
    out.backward(torch.from_numpy(g))
    for name, leaf, want in zip(("dx", "dgamma", "dbeta"), leaves, jgrads):
        got = leaf.grad.numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)


def test_batch_norm_train_meta_and_counters():
    """Meta tensors (build-time shape inference) give the right shapes and
    dtypes; CPU calls run the plain versions and count no launch; the
    kernel wrappers refuse CPU tensors rather than fall back."""
    x = torch.empty((8191, 6, 3, 3), dtype=torch.bfloat16, device="meta")
    s = torch.empty(6, device="meta")
    out, m, v = TB.batch_norm_train(x, s, s, 1e-5)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert m.shape == v.shape == (6,) and m.dtype == torch.float32
    before = dict(TB.batch_norm_train.launches)
    xc = torch.randn(2, 3, 4, 4, requires_grad=True)
    sc = torch.ones(3, requires_grad=True)
    TB.batch_norm_train(xc, sc, torch.zeros(3), 1e-5)[0].sum().backward()
    assert TB.batch_norm_train.launches == before
    dy, xx, mean, rstd, gamma = _bn_inputs(0, 2, 3, 4, 4, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        TB.bn_bwd_reduce_kernel(dy, xx, mean, rstd)
    with pytest.raises(ValueError, match="CUDA"):
        TB.bn_bwd_dx_kernel(dy, xx, mean, rstd, gamma, mean, rstd)


# ------------------------------------------------- the kernels' walk


def _cuda_constants():
    src = (REPO / "paddle_tpu_torch" / "ops" / "csrc" / "batch_norm.cu"
           ).read_text()
    return int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))


def test_kernel_constants_match_source():
    assert _cuda_constants() == TB.THREADS
    src = (REPO / "paddle_tpu_torch" / "ops" / "csrc" / "batch_norm.cu"
           ).read_text()
    assert "constexpr int kF32 = 0;" in src and "constexpr int kBF16 = 1;" \
        in src
    assert TB._DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1}


def _walk(block_y, thread, c, C, n_rows, hw_v, chunk, V, threads):
    """The element offsets one thread of block (c, block_y) loads, step by
    step as ``Walk`` in csrc/batch_norm.cu computes them (one division at
    the start, then additions)."""
    total = n_rows * hw_v
    begin = block_y * chunk
    end = min(begin + chunk, total)
    j = begin + thread
    n = j // hw_v
    r = j - n * hw_v
    dn, dr = threads // hw_v, threads % hw_v
    row_step = C * hw_v * V
    off = ((n * C + c) * hw_v + r) * V
    offs = []
    while j < end:
        offs.append(off)
        j += threads
        r += dr
        rows = dn
        if r >= hw_v:
            r -= hw_v
            rows += 1
        off += rows * row_step + (dr - (rows - dn) * hw_v) * V
    return offs


@pytest.mark.parametrize("n,c,hw,itemsize,splits", [
    (3, 5, 49, 4, 2), (2, 3, 64, 2, 3), (4, 2, 12, 4, 5), (1, 4, 600, 2, 1),
    (5, 3, 6, 2, 7)])
def test_kernel_walk_covers_each_channel_once(n, c, hw, itemsize, splits):
    """Transcribed walk at a small thread count (so that rows wrap within a
    step and across several rows): every block of channel c loads only
    channel c's values, the splits together load each exactly once, and
    the per-block sums added in split order give the plain reduction."""
    threads = 8
    vec = TB.vector_width(hw, itemsize, [0, 256])
    rng = np.random.RandomState(n * 100 + c * 10 + hw)
    dy = torch.from_numpy(rng.standard_normal((n, c, hw)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, c, hw)).astype(np.float32))
    mean, rstd = x.mean((0, 2)), torch.rsqrt(x.var((0, 2)) + 1e-5)
    hw_v = hw // vec
    chunk = -(-(n * hw_v) // splits)
    fdy, fx = dy.reshape(-1), x.reshape(-1)
    dbeta, dgamma = torch.zeros(c), torch.zeros(c)
    for ch in range(c):
        want = {(i * c + ch) * hw + k for i in range(n) for k in range(hw)}
        seen = []
        for s in range(splits):
            ps = pd = 0.0
            for t in range(threads):
                for off in _walk(s, t, ch, c, n, hw_v, chunk, vec, threads):
                    idx = list(range(off, off + vec))
                    seen += idx
                    g = fdy[idx]
                    ps += float(g.sum())
                    pd += float((g * (fx[idx] - mean[ch])).sum())
            dbeta[ch] += ps
            dgamma[ch] += pd
        assert sorted(seen) == sorted(want)
        dgamma[ch] *= rstd[ch]
    rb, rg = TB.bn_bwd_reduce_reference(dy, x, mean, rstd)
    np.testing.assert_allclose(dbeta.numpy(), rb.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dgamma.numpy(), rg.numpy(), rtol=0, atol=1e-4)


def test_launch_geometry():
    """Vector width: 16 bytes where H*W and the pointers allow, halved
    otherwise; splits: about BLOCKS_PER_SM blocks an SM of 132, never
    below MIN_VECTORS_PER_THREAD loads a thread."""
    assert TB.vector_width(3136, 2, [0, 512]) == 8
    assert TB.vector_width(3136, 4, [0, 512]) == 4
    assert TB.vector_width(196, 2, [0, 512]) == 4
    assert TB.vector_width(49, 2, [0, 512]) == 1
    assert TB.vector_width(3136, 2, [0, 514]) == 1
    assert TB.vector_width(3136, 2, [0, 516]) == 2
    assert TB.n_splits(256, 64, 3136 // 8, 132) == 33
    assert TB.n_splits(256, 2048, 49, 132) == 2
    assert TB.n_splits(2, 64, 1, 132) == 1
    for n, c, hwv in ((256, 256, 392), (256, 128, 196), (4, 2048, 49)):
        s = TB.n_splits(n, c, hwv, 132)
        assert 1 <= s <= TB.MAX_SPLITS
        assert s == 1 or n * hwv // s >= TB.THREADS * \
            TB.MIN_VECTORS_PER_THREAD
