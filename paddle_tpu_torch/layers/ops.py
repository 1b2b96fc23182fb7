"""Activations (PyTorch port of ``paddle_tpu/layers/ops.py``): the unary
table, the activations that take attributes (``leaky_relu``, ``elu``,
``relu6``, ``pow`` / ``pow_``, ``stanh``, ``brelu``, ``soft_relu``,
``softshrink``, ``hard_shrink``, ``thresholded_relu``, ``hard_sigmoid``,
``swish``) with the reference's defaults, ``prelu`` with its learned
alpha, ``softmax`` and ``log_softmax``: each is a torch one-liner wrapped
into a Program op and registered in ``core/op_info.py`` as the reference
registers it, so ``fc(act="leaky_relu")`` resolves here with the default
attributes.  ``gelu`` is the tanh form, as ``jax.nn.gelu``'s default.
Clips are ``maximum`` then ``minimum``, as ``jnp.clip`` computes them, so a
value on a bound splits its gradient in half as JAX's does (a torch
``clamp`` passes it whole); the bounds are filled on the device, so a
captured step copies nothing from the host."""
from __future__ import annotations

import inspect

import torch
import torch.nn.functional as F

from ..core import op_info
from .helper import LayerHelper

_ACT_REF = "paddle/operators/activation_op.cc"

# name -> elementwise torch fn  (capability list from activation_op.cc)
_UNARY = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "exp": torch.exp,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "round": torch.round,
    "reciprocal": lambda x: 1.0 / x,
    "log": torch.log,
    "square": torch.square,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "sin": torch.sin,
    "cos": torch.cos,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "erf": torch.erf,
    "rsqrt": torch.rsqrt,
    "sign": torch.sign,
}


def _make_unary(name, fn):
    proto = op_info.register_op(
        name, doc=f"Elementwise {name} activation.", ref=_ACT_REF,
        inputs={"X": "input tensor"}, outputs={"Out": "activated tensor"})

    def layer(x, **kwargs):
        helper = LayerHelper(name, **kwargs)
        return helper.append_op(lambda ctx, a, _f=fn: _f(a), {"X": [x]}, op_type=name)

    layer.__name__ = name
    layer.__doc__ = f"{proto.doc} (ref: {proto.ref})"
    return layer


_g = globals()
for _name, _fn in _UNARY.items():
    _g[_name] = _make_unary(_name, _fn)


# ---- activations that take attributes


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _unary_attr(name, tfn):
    """The layer of activation ``name``, ``tfn(x, **attrs)``, its proto
    registered with the attributes and defaults of ``tfn``'s signature;
    the op records only the attributes the caller gives."""
    sig = inspect.signature(tfn)
    attr_specs = {
        p.name: op_info.AttrSpec(p.name, op_info._attr_type(p.default),
                                 default=p.default)
        for p in list(sig.parameters.values())[1:]}
    proto = op_info.register_op(
        name, doc=f"Elementwise {name} activation.", ref=_ACT_REF,
        inputs={"X": "input tensor"}, outputs={"Out": "activated tensor"},
        attrs=attr_specs)

    def layer(x, **attrs):
        helper = LayerHelper(name)
        return helper.append_op(lambda ctx, a, **kw: tfn(a, **kw), {"X": [x]},
                                attrs=attrs, op_type=name)

    layer.__name__ = name
    attrs_doc = ", ".join(f"{a.name}={a.default!r}"
                          for a in attr_specs.values())
    layer.__doc__ = f"{proto.doc} Attrs: {attrs_doc}. (ref: {proto.ref})"
    return layer


leaky_relu = _unary_attr(
    "leaky_relu", lambda x, alpha=0.02: torch.where(x >= 0, x, alpha * x))
elu = _unary_attr(
    "elu", lambda x, alpha=1.0: torch.where(
        x > 0, x, alpha * torch.expm1(torch.where(x > 0, 0.0, x))))
relu6 = _unary_attr("relu6", lambda x, threshold=6.0: _clip(x, 0.0, threshold))
pow_ = _unary_attr("pow", lambda x, factor=1.0: torch.pow(x, factor))
pow = pow_  # noqa: A001 - the reference's layer name
stanh = _unary_attr(
    "stanh", lambda x, scale_a=0.67, scale_b=1.7159:
    scale_b * torch.tanh(scale_a * x))
brelu = _unary_attr("brelu",
                    lambda x, t_min=0.0, t_max=24.0: _clip(x, t_min, t_max))
soft_relu = _unary_attr(
    "soft_relu", lambda x, threshold=40.0: torch.log1p(torch.exp(
        _clip(x, -threshold, threshold))))
softshrink = _unary_attr(
    "softshrink", lambda x, lambda_=0.5: torch.where(
        x > lambda_, x - lambda_, torch.where(x < -lambda_, x + lambda_,
                                              0.0)))
hard_shrink = _unary_attr(
    "hard_shrink",
    lambda x, threshold=0.5: torch.where(x.abs() > threshold, x, 0.0))
thresholded_relu = _unary_attr(
    "thresholded_relu",
    lambda x, threshold=1.0: torch.where(x > threshold, x, 0.0))
hard_sigmoid = _unary_attr(
    "hard_sigmoid",
    lambda x, slope=0.2, offset=0.5: _clip(slope * x + offset, 0.0, 1.0))
swish = _unary_attr("swish",
                    lambda x, beta=1.0: x * torch.sigmoid(beta * x))


def prelu(x, param_attr=None):
    """PReLU with a learned scalar alpha, initialised to 0.25 (ref:
    paddle/operators/prelu_op.cc)."""
    from ..initializer import Constant

    helper = LayerHelper("prelu")
    alpha = helper.create_parameter(param_attr, [1], x.dtype,
                                    default_initializer=Constant(0.25))
    return helper.append_op(
        lambda ctx, a, al: torch.where(a >= 0, a, al * a),
        {"X": [x], "Alpha": [alpha]})


def softmax(x, axis=-1, **kwargs):
    """Softmax over ``axis`` (the last by default)."""
    helper = LayerHelper("softmax", **kwargs)
    return helper.append_op(
        lambda ctx, a, axis: torch.softmax(a, dim=axis), {"X": [x]},
        attrs={"axis": axis})


def log_softmax(x, axis=-1):
    helper = LayerHelper("log_softmax")
    return helper.append_op(
        lambda ctx, a, axis: torch.log_softmax(a, dim=axis), {"X": [x]},
        attrs={"axis": axis})


__all__ = sorted(list(_UNARY) + [
    "brelu", "elu", "hard_shrink", "hard_sigmoid", "leaky_relu",
    "log_softmax", "pow", "pow_", "prelu", "relu6", "soft_relu",
    "softmax", "softshrink", "stanh", "swish", "thresholded_relu"])
