"""Activations (PyTorch port of the activation table of
``paddle_tpu/layers/ops.py``, with ``softmax`` and ``log_softmax``): each is
a torch one-liner wrapped into a Program op, so ``fc(act="softmax")``
resolves here.  ``gelu`` is the tanh form, as ``jax.nn.gelu``'s default."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .helper import LayerHelper

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
    def layer(x, **kwargs):
        helper = LayerHelper(name, **kwargs)
        return helper.append_op(lambda ctx, a, _f=fn: _f(a), {"X": [x]}, op_type=name)

    layer.__name__ = name
    layer.__doc__ = f"Elementwise {name} activation."
    return layer


_g = globals()
for _name, _fn in _UNARY.items():
    _g[_name] = _make_unary(_name, _fn)


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


__all__ = sorted(list(_UNARY) + ["log_softmax", "softmax"])
