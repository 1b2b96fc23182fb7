"""Dense-math layers (PyTorch port of the ``paddle_tpu/layers/tensor.py``
subset the training slices use): ``elementwise_add`` / ``sub`` / ``mul`` /
``div`` / ``pow`` / ``max`` / ``min`` with Fluid's ``axis``
mid-broadcast, ``matmul``, ``mul``, ``mean``, ``sums``, ``reshape``,
``transpose``, ``concat``, ``split``, ``stack``, ``squeeze``,
``unsqueeze``, ``assign``, the reductions ``reduce_sum`` / ``mean`` /
``max`` / ``min`` / ``prod``, ``cast``, ``scale``, ``fill_constant``,
``fill_constant_batch_size_like``, ``argmax`` and the compares
``less_than`` / ``less_equal`` / ``greater_than`` / ``equal`` /
``not_equal``.  ``matmul`` and ``mul`` are
``torch.matmul``: the JAX package computes them outside any Pallas
kernel."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.program import Variable
from ..core.types import convert_dtype
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
elementwise_sub = _elementwise("elementwise_sub", torch.sub)
elementwise_mul = _elementwise("elementwise_mul", torch.mul)
elementwise_div = _elementwise("elementwise_div", torch.div)
elementwise_pow = _elementwise("elementwise_pow", torch.pow)
# a tie's gradient splits in half between x and y, as jnp.maximum's does
elementwise_max = _elementwise("elementwise_max", torch.maximum)
elementwise_min = _elementwise("elementwise_min", torch.minimum)


def matmul(x: Variable, y: Variable, transpose_x: bool = False,
           transpose_y: bool = False, alpha: float = 1.0, name=None):
    """Batched matmul with the last two dims of x and y swapped first when
    asked (a 1-D operand is left as it is), then scaled by ``alpha``."""
    helper = LayerHelper("matmul", name=name)

    def fn(ctx, a, b, transpose_x, transpose_y, alpha):
        if transpose_x and a.dim() >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() >= 2:
            b = b.transpose(-1, -2)
        out = torch.matmul(a, b)
        return out * alpha if alpha != 1.0 else out

    return helper.append_op(
        fn, {"X": [x], "Y": [y]},
        attrs={"transpose_x": transpose_x, "transpose_y": transpose_y,
               "alpha": alpha})


def mul(x: Variable, y: Variable, x_num_col_dims: int = 1,
        y_num_col_dims: int = 1, name=None):
    """x flattened to 2-D at ``x_num_col_dims`` times y flattened at
    ``y_num_col_dims``, the result shaped x's leading dims + y's trailing
    ones (ref: paddle/operators/mul_op.cc)."""
    helper = LayerHelper("mul", name=name)

    def fn(ctx, a, b, x_num_col_dims, y_num_col_dims):
        am = a.reshape(int(np.prod(a.shape[:x_num_col_dims])), -1)
        bm = b.reshape(int(np.prod(b.shape[:y_num_col_dims])), -1)
        return (am @ bm).reshape(tuple(a.shape[:x_num_col_dims])
                                 + tuple(b.shape[y_num_col_dims:]))

    return helper.append_op(
        fn, {"X": [x], "Y": [y]},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})


def _prod(a, axis, keep_dim):
    """``torch.prod`` over ``axis`` (None for all): it takes one dim at a
    time, so each in turn, highest first so the others keep their index."""
    for d in sorted((d % a.dim() for d in (range(a.dim()) if axis is None
                                           else axis)), reverse=True):
        a = torch.prod(a, d, keep_dim)
    return a


_REDUCE = {
    "reduce_sum": lambda a, axis, keep: torch.sum(a, dim=axis, keepdim=keep),
    "reduce_mean": lambda a, axis, keep: torch.mean(a, dim=axis, keepdim=keep),
    # amax / amin: a tie's gradient splits among the tied elements, as
    # jnp.max's does (torch.max(dim) sends it all to one)
    "reduce_max": lambda a, axis, keep: torch.amax(
        a, dim=() if axis is None else axis, keepdim=keep),
    "reduce_min": lambda a, axis, keep: torch.amin(
        a, dim=() if axis is None else axis, keepdim=keep),
    "reduce_prod": _prod,
}


def _reduce(op_type):
    tfn = _REDUCE[op_type]

    def layer(x: Variable, dim=None, keep_dim: bool = False, name=None):
        """Reduce over ``dim`` (an int, a list of ints, or None for every
        axis), keeping the reduced axes as size 1 when ``keep_dim``."""
        helper = LayerHelper(op_type, name=name)
        axis = (tuple(dim) if isinstance(dim, (list, tuple))
                else None if dim is None else (dim,))
        return helper.append_op(
            lambda ctx, a, axis, keep_dim: tfn(a, axis, keep_dim),
            {"X": [x]}, attrs={"axis": axis, "keep_dim": keep_dim},
            op_type=op_type)

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")


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


def reshape(x: Variable, shape: Sequence[int], name=None, **_ignored):
    """Reshape to ``shape``; as in the JAX package, EVERY 0 in ``shape``
    stands for the input's first (batch) dim, not for the dim at its own
    position, and -1 is inferred."""
    helper = LayerHelper("reshape", name=name)
    return helper.append_op(
        lambda ctx, a, shape: a.reshape([a.shape[0] if d == 0 else d
                                         for d in shape]),
        {"X": [x]}, attrs={"shape": tuple(shape)})


def transpose(x: Variable, perm: Sequence[int], name=None):
    helper = LayerHelper("transpose", name=name)
    return helper.append_op(lambda ctx, a, perm: a.permute(perm), {"X": [x]},
                            attrs={"perm": tuple(perm)})


def concat(inputs: Sequence[Variable], axis: int = 0, name=None):
    helper = LayerHelper("concat", name=name)
    return helper.append_op(
        lambda ctx, *arrs, axis: torch.cat(arrs, dim=axis),
        {"X": list(inputs)}, attrs={"axis": axis})


def split(x: Variable, num_or_sections, dim: int = -1, name=None):
    """Split along ``dim`` into ``num_or_sections`` equal parts (an int,
    which must divide the dim) or parts of the given sizes (a list); always
    a list of Variables.  The sizes become the JAX package's cumulative
    split points, which ``torch.tensor_split`` takes (``torch.split`` takes
    sizes)."""
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections

        def fn(ctx, a, dim):
            if a.shape[dim] % n:
                raise ValueError(f"split: dim {dim} of size {a.shape[dim]} "
                                 f"does not split into {n} equal parts")
            return tuple(torch.tensor_split(a, n, dim))
    else:
        secs = list(num_or_sections)
        n = len(secs)
        idxs = np.cumsum(secs)[:-1].tolist()

        def fn(ctx, a, dim):
            return tuple(torch.tensor_split(a, idxs, dim))

    outs = helper.append_op(fn, {"X": [x]}, attrs={"dim": dim}, n_outputs=n)
    return outs if isinstance(outs, list) else [outs]


def stack(inputs: Sequence[Variable], axis: int = 0):
    helper = LayerHelper("stack")
    return helper.append_op(
        lambda ctx, *arrs, axis: torch.stack(arrs, dim=axis),
        {"X": list(inputs)}, attrs={"axis": axis})


def squeeze(x: Variable, axes: Sequence[int]):
    """Drop the size-1 ``axes``; an axis of another size raises, as
    ``jnp.squeeze`` does."""
    helper = LayerHelper("squeeze")

    def fn(ctx, a, axes):
        bad = [d for d in axes if a.shape[d] != 1]
        if bad:
            raise ValueError(f"squeeze: axes {bad} of shape "
                             f"{tuple(a.shape)} are not of size 1")
        return a.squeeze(tuple(axes))

    return helper.append_op(fn, {"X": [x]}, attrs={"axes": tuple(axes)})


def unsqueeze(x: Variable, axes: Sequence[int]):
    """Insert a size-1 dim at each of ``axes``, in sorted order."""
    helper = LayerHelper("unsqueeze")

    def fn(ctx, a, axes):
        for ax in sorted(axes):
            a = a.unsqueeze(ax)
        return a

    return helper.append_op(fn, {"X": [x]}, attrs={"axes": tuple(axes)})


def assign(x, output: Optional[Variable] = None):
    """A copy of a Variable, or a constant from a numpy array (ref:
    paddle/operators/assign_op.cc), written into ``output`` when one is
    given (the op's output takes its name) and into a new Variable
    otherwise.  A constant is moved to a device once, at the first step
    there, and kept: a step captured into a CUDA graph copies nothing from
    the host."""
    helper = LayerHelper("assign")
    out_names = [output.name] if output is not None else None
    if isinstance(x, Variable):
        return helper.append_op(lambda ctx, a: a, {"X": [x]},
                                out_names=out_names)
    arr = np.array(x)
    # JAX's 32-bit mode: 64-bit constants come in as 32-bit ones
    arr = arr.astype({np.dtype(np.float64): np.float32,
                      np.dtype(np.int64): np.int32}.get(arr.dtype, arr.dtype))
    const = torch.from_numpy(arr)
    on_device = {}

    def fn(ctx):
        if ctx.device.type == "meta":
            return torch.empty(const.shape, dtype=const.dtype, device="meta")
        if ctx.device not in on_device:
            on_device[ctx.device] = const.to(ctx.device)
        return on_device[ctx.device]

    return helper.append_op(fn, {}, out_names=out_names)


def cast(x: Variable, dtype):
    helper = LayerHelper("cast")
    dt = convert_dtype(dtype)
    return helper.append_op(lambda ctx, a: a.to(dt), {"X": [x]},
                            op_type="cast")


def scale(x: Variable, scale: float = 1.0, bias: float = 0.0,
          bias_after_scale: bool = True, name=None):
    """``x * scale + bias``, or ``(x + bias) * scale`` when not
    ``bias_after_scale`` (ref: paddle/operators/scale_op.cc)."""
    helper = LayerHelper("scale", name=name)

    def fn(ctx, a, scale, bias, bias_after_scale):
        return a * scale + bias if bias_after_scale else (a + bias) * scale

    return helper.append_op(
        fn, {"X": [x]}, attrs={"scale": scale, "bias": bias,
                               "bias_after_scale": bias_after_scale})


def fill_constant(shape: Sequence[int], dtype, value, name=None):
    """A tensor of ``shape`` filled with ``value`` (ref:
    paddle/operators/fill_constant_op.cc): a ``torch.full`` on the step's
    device, inside the step, so a captured step copies nothing from the
    host."""
    helper = LayerHelper("fill_constant", name=name)
    dt = convert_dtype(dtype)
    shape = tuple(shape)
    return helper.append_op(
        lambda ctx: torch.full(shape, value, dtype=dt, device=ctx.device),
        {}, out_names=[name] if name else None)


def fill_constant_batch_size_like(input: Variable, shape, dtype, value,
                                  input_dim_idx: int = 0,
                                  output_dim_idx: int = 0):
    """``fill_constant`` whose dim ``output_dim_idx`` is ``input``'s dim
    ``input_dim_idx`` (ref:
    paddle/operators/fill_constant_batch_size_like_op.cc)."""
    helper = LayerHelper("fill_constant_batch_size_like")
    dt = convert_dtype(dtype)

    def fn(ctx, a, shape, value, input_dim_idx, output_dim_idx):
        s = list(shape)
        s[output_dim_idx] = a.shape[input_dim_idx]
        return torch.full(tuple(s), value, dtype=dt, device=a.device)

    return helper.append_op(
        fn, {"Input": [input]},
        attrs={"shape": tuple(shape), "value": value,
               "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})


def argmax(x: Variable, axis: int = -1):
    """The index of the largest value along ``axis``, int64; the first
    one among ties, as ``jnp.argmax`` takes it."""
    helper = LayerHelper("argmax")
    return helper.append_op(lambda ctx, a, axis: torch.argmax(a, dim=axis),
                            {"X": [x]}, attrs={"axis": axis})


def cond_compare(name, tfn):
    def layer(x: Variable, y):
        """Element-wise compare of ``x`` with a Variable or a Python
        scalar ``y``: a bool tensor."""
        helper = LayerHelper(name)
        if isinstance(y, Variable):
            return helper.append_op(lambda ctx, a, b: tfn(a, b),
                                    {"X": [x], "Y": [y]}, op_type=name)
        return helper.append_op(lambda ctx, a: tfn(a, y), {"X": [x]},
                                op_type=name)

    layer.__name__ = name
    return layer


less_than = cond_compare("less_than", torch.lt)
less_equal = cond_compare("less_equal", torch.le)
greater_than = cond_compare("greater_than", torch.gt)
equal = cond_compare("equal", torch.eq)
not_equal = cond_compare("not_equal", torch.ne)


__all__ = ["argmax", "assign", "cast", "concat", "cond_compare",
           "elementwise_add", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_mul",
           "elementwise_pow", "elementwise_sub", "equal", "fill_constant",
           "fill_constant_batch_size_like", "greater_than", "less_equal",
           "less_than", "matmul", "mean", "mul", "not_equal",
           "reduce_max", "reduce_mean", "reduce_min", "reduce_prod",
           "reduce_sum", "reshape", "scale", "split", "squeeze", "stack",
           "sums", "transpose", "unsqueeze"]
