"""Dense-math layers (PyTorch port of the ``paddle_tpu/layers/tensor.py``
subset the training slice uses): ``elementwise_add`` with Fluid's ``axis``
mid-broadcast, ``mean`` and ``sums``."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.program import Variable
from .helper import LayerHelper


def _broadcast_y(x, y, axis: int):
    """Fluid's elementwise broadcast: align y's dims to x starting at
    ``axis`` (trailing-1 padding)."""
    if y.dim() == x.dim():
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * axis + list(y.shape) + [1] * (x.dim() - axis - y.dim())
    return y.reshape(shape)


def _elementwise(name, tfn):
    def layer(x: Variable, y, axis: int = -1, act: Optional[str] = None, **kwargs):
        helper = LayerHelper(name, **kwargs)
        if not isinstance(y, Variable):
            out = helper.append_op(
                lambda ctx, a, yv=y: tfn(a, torch.as_tensor(yv, dtype=a.dtype,
                                                            device=a.device)),
                {"X": [x]}, op_type=name)
        else:
            out = helper.append_op(
                lambda ctx, a, b, axis: tfn(a, _broadcast_y(a, b, axis)),
                {"X": [x], "Y": [y]},
                attrs={"axis": axis},
                op_type=name,
            )
        return helper.append_activation(out, act)

    layer.__name__ = name
    return layer


elementwise_add = _elementwise("elementwise_add", torch.add)


def mean(x: Variable, name=None):
    """Full reduction to a scalar (ref: paddle/operators/mean_op.cc)."""
    helper = LayerHelper("mean", name=name)
    return helper.append_op(lambda ctx, a: torch.mean(a), {"X": [x]})


def sums(inputs: Sequence[Variable], name=None):
    """N-ary add (ref: paddle/operators/sum_op.cc)."""
    helper = LayerHelper("sum", name=name)

    def fn(ctx, *arrs):
        out = arrs[0]
        for a in arrs[1:]:
            out = out + a
        return out

    return helper.append_op(fn, {"X": list(inputs)}, op_type="sum")


__all__ = ["elementwise_add", "mean", "sums"]
