"""paddle_tpu_torch's sequence utilities, time convolutions and reductions
against the JAX package on the CPU: ``sequence_softmax``,
``sequence_expand``, ``sequence_concat``, ``sequence_slice`` (an offset
that JAX clamps included), ``sequence_reverse``, ``im2sequence`` (a
non-square filter and a stride, ``padding`` taken and not applied),
``sequence_conv`` (filter sizes 1, 3 and 4, bias and act) and
``row_conv``, and ``reduce_sum`` / ``mean`` / ``max`` / ``min`` /
``prod``.  Each case builds the layer in both packages on the same numpy
inputs and parameters (drawn by name from a numpy seed) and runs its ops
directly: the forward within 1e-5 of the output's scale, integer outputs
bitwise, and the gradient of every float input and parameter, by
``jax.vjp`` and by torch autograd under one numpy cotangent, within 1e-5
of its max abs.  ``run_both`` is the harness ``test_torch_crf.py`` and
``test_torch_ctc.py`` use too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.core.program import OpContext as JaxOpContext
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.program import OpContext as TorchOpContext

FWD_TOL = 1e-5
GRAD_TOL = 1e-5


def _build(fl, build, feeds):
    """The layer ``build(fl, vars)`` in fresh default programs of package
    ``fl``, on a data variable per feed (the batch dim free, the rest
    declared); returns (outputs, the main program's ops, parameters)."""
    fl.reset_default_programs()
    vs = {}
    for name, arr in feeds.items():
        dtype = "int32" if arr.dtype.kind in "iu" else str(arr.dtype)
        vs[name] = fl.layers.data(name, list(arr.shape[1:]) or [-1],
                                  dtype=dtype,
                                  append_batch_size=arr.ndim > 1)
    outs = build(fl, vs)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    prog = fl.default_main_program()
    return outs, prog.list_ops(), prog.parameters()


def run_both(build, feeds, seed=0, param_scale=0.5, params=None,
             step_key=None):
    """``build(fl, vars) -> Variable or list`` built in both packages and
    run op by op on ``feeds`` (numpy arrays by name) and on parameters
    drawn N(0, param_scale^2) by name from ``seed`` (or given in
    ``params``).  Returns (JAX outputs, port outputs, JAX gradients, port
    gradients, names of the gradients): the gradients are of the sum of
    every float output times a N(0, 1) cotangent, with respect to every
    float feed and every parameter.  ``step_key=(program seed, step)``
    gives both packages the Executor's keys of that step, so that random
    ops draw alike (by default JAX's ops draw from ``PRNGKey(0)``)."""
    jouts, jops, jparams = _build(jfluid, build, feeds)
    touts, tops, tparams = _build(tfluid, build, feeds)
    assert [p.name for p in tparams] == [p.name for p in jparams]
    rng = np.random.RandomState(seed)
    params = dict(params or {})
    for p in jparams:
        if p.name not in params:
            params[p.name] = (param_scale * rng.standard_normal(
                tuple(p.shape))).astype(np.float32)
    arrays = {**feeds, **params}
    diff = [n for n, a in arrays.items() if a.dtype.kind == "f"]

    def jax_fn(*vals):
        env = {n: jnp.asarray(a) for n, a in arrays.items()}
        env.update(zip(diff, vals))
        ctx = JaxOpContext(
            jax.random.PRNGKey(0) if step_key is None else
            jax.random.fold_in(jax.random.key(step_key[0]),
                               np.uint32(step_key[1])))
        for op in jops:
            op.apply(env, ctx)
        return tuple(env[o.name] for o in jouts)

    def torch_fn(*vals):
        env = {n: torch.from_numpy(np.array(a)) for n, a in arrays.items()}
        env.update(zip(diff, vals))
        ctx = (TorchOpContext(device="cpu") if step_key is None else
               TorchOpContext(step_key[0], step_key[1], "cpu"))
        for op in tops:
            op.apply(env, ctx)
        return tuple(env[o.name] for o in touts)

    jvals = [jnp.asarray(arrays[n]) for n in diff]
    shapes = jax.eval_shape(jax_fn, *jvals)
    floats = [i for i, a in enumerate(shapes)
              if jnp.issubdtype(a.dtype, jnp.floating)]
    cots = [rng.standard_normal(shapes[i].shape).astype(shapes[i].dtype)
            for i in floats]

    @jax.jit
    def jax_run(vals, cots):
        # the outputs and the vjp of the float ones, compiled as one
        # program (faster here than dispatching each op eagerly)
        outs, vjp = jax.vjp(jax_fn, *vals)
        full = tuple(cots[floats.index(i)] if i in floats
                     else np.zeros(o.shape, jax.dtypes.float0)
                     for i, o in enumerate(outs))
        return outs, vjp(full) if vals else ()

    jouts_v, jgrads = jax_run(jvals, [jnp.asarray(c) for c in cots])
    want = [np.asarray(a) for a in jouts_v]

    tvals = [torch.from_numpy(np.array(arrays[n])).requires_grad_(True)
             for n in diff]
    touts_v = torch_fn(*tvals)
    got = [t.detach().numpy() for t in touts_v]
    jgrads = [np.asarray(g) for g in jgrads] if floats else []
    tgrads = []
    if floats and diff:
        total = sum((touts_v[i] * torch.from_numpy(c)).sum()
                    for i, c in zip(floats, cots))
        # outputs that no float input reaches (a metric's counts) have
        # zero gradients, as jax.vjp gives them
        grads = (torch.autograd.grad(total, tvals, allow_unused=True)
                 if total.requires_grad else [None] * len(tvals))
        tgrads = [g.numpy() if g is not None else np.zeros_like(arrays[n])
                  for g, n in zip(grads, diff)]
    return want, got, jgrads, tgrads, diff


def assert_match(want, got, jgrads, tgrads, names, fwd_tol=FWD_TOL,
                 grad_tol=GRAD_TOL):
    """Outputs: the same shape and dtype, integers bitwise, floats within
    ``fwd_tol`` of max(1, max |JAX's|); gradients within ``grad_tol`` of
    each one's max abs."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape,
                                                           b.shape, a.dtype,
                                                           b.dtype)
        if b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b)
        else:
            scale = max(1.0, float(np.abs(b).max()) if b.size else 1.0)
            assert np.abs(a - b).max(initial=0.0) <= fwd_tol * scale, i
    for n, a, b in zip(names, tgrads, jgrads):
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
        assert np.abs(a - b).max(initial=0.0) <= grad_tol * scale, n


def _seq(B=4, T=7, D=3, seed=0, lengths=None):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    ln = (np.asarray(lengths, np.int32) if lengths is not None
          else rng.randint(1, T + 1, (B,)).astype(np.int32))
    return x, ln


# ragged lengths with a zero-length row, a length-1 row and a full one
LENGTHS = [0, 1, 7, 4]

UTIL_CASES = {
    "softmax": (lambda fl, v: fl.layers.sequence_softmax(v["x"], v["len"]),
                dict(D=1)),
    "softmax_3d": (lambda fl, v: fl.layers.sequence_softmax(v["x"], v["len"]),
                   dict(D=3)),
    "expand": (lambda fl, v: fl.layers.sequence_expand(v["v"], v["len"], 6),
               dict()),
    "concat": (lambda fl, v: fl.layers.sequence_concat([v["x"], v["y"]]),
               dict()),
    "slice": (lambda fl, v: fl.layers.sequence_slice(v["x"], 2, 3), dict()),
    "slice_clamped": (lambda fl, v: fl.layers.sequence_slice(v["x"], 6, 3),
                      dict()),
    "slice_negative": (lambda fl, v: fl.layers.sequence_slice(v["x"], -2, 4),
                       dict()),
    "reverse": (lambda fl, v: fl.layers.sequence_reverse(v["x"], v["len"]),
                dict()),
}


@pytest.mark.parametrize("case", sorted(UTIL_CASES))
def test_sequence_utilities_match_jax(case):
    build, kw = UTIL_CASES[case]
    x, ln = _seq(lengths=LENGTHS, **kw)
    if kw.get("D") == 1:
        x = x[..., 0]
    rng = np.random.RandomState(1)
    feeds = {"x": x, "len": ln}
    if case == "expand":
        feeds = {"v": rng.standard_normal((4, 5)).astype(np.float32),
                 "len": ln}
    if case == "concat":
        feeds["y"] = rng.standard_normal((4, 2, 3)).astype(np.float32)
    want, *rest = run_both(build, feeds)
    assert_match(want, *rest)
    if case.startswith("softmax"):
        assert np.all(want[0][0] == 0)          # the zero-length row


@pytest.mark.parametrize("filt,stride", [((2, 3), (1, 2)), (3, 2), (1, 1)])
def test_im2sequence_matches_jax(filt, stride):
    """``padding`` is taken and not applied, in both packages."""
    x = np.random.RandomState(2).standard_normal((2, 3, 7, 8)).astype(
        np.float32)
    want, *rest = run_both(
        lambda fl, v: fl.layers.im2sequence(v["img"], filt, stride,
                                            padding=1), {"img": x})
    assert_match(want, *rest)
    kh, kw = (filt, filt) if isinstance(filt, int) else filt
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    oh, ow = (7 - kh) // sh + 1, (8 - kw) // sw + 1
    assert want[0].shape == (2, oh * ow, 3 * kh * kw)


@pytest.mark.parametrize("filter_size,bias,act", [
    (1, True, None), (3, True, "relu"), (3, False, None), (4, True, "tanh")])
def test_sequence_conv_matches_jax(filter_size, bias, act):
    x, ln = _seq(B=4, T=9, D=5, seed=3, lengths=[9, 1, 5, 0])
    want, *rest = run_both(
        lambda fl, v: fl.layers.sequence_conv(
            v["x"], v["len"], 6, filter_size,
            bias_attr=None if bias else False, act=act),
        {"x": x, "len": ln}, param_scale=0.3)
    assert_match(want, *rest)
    assert ("sequence_conv_b_0" in rest[3]) == bias


@pytest.mark.parametrize("future", [0, 2, 9])
def test_row_conv_matches_jax(future):
    x, ln = _seq(B=3, T=8, D=4, seed=4)
    want, *rest = run_both(
        lambda fl, v: fl.layers.row_conv(v["x"], future), {"x": x})
    assert_match(want, *rest)


REDUCES = ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod")


@pytest.mark.parametrize("dim,keep_dim", [(None, False), (None, True),
                                          (1, False), (-1, True),
                                          ([0, 2], False), ([2, 1], True)])
def test_reduce_family_matches_jax(dim, keep_dim):
    """All five reductions over an int, a list or every axis, with and
    without ``keep_dim``, on values with ties (each max / min gradient
    split among the tied elements, as jnp.max's is, ROADMAP C.4)."""
    rng = np.random.RandomState(5)
    x = rng.randint(-2, 3, (3, 4, 5)).astype(np.float32) * 0.5 + 1.5
    want, *rest = run_both(
        lambda fl, v: [getattr(fl.layers, r)(v["x"], dim=dim,
                                             keep_dim=keep_dim)
                       for r in REDUCES], {"x": x})
    assert_match(want, *rest)
    assert np.allclose(want[0], np.sum(x, axis=None if dim is None
                                       else tuple(np.atleast_1d(dim)),
                                       keepdims=keep_dim), rtol=1e-6)
