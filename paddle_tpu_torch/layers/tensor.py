"""Dense-math layers (PyTorch port of ``paddle_tpu/layers/tensor.py``):
``elementwise_add`` / ``sub`` / ``mul`` / ``div`` / ``pow`` / ``max`` /
``min`` with Fluid's ``axis`` mid-broadcast, ``matmul``, ``mul``, the
shape ops (``reshape``, ``transpose``, ``concat``, ``split``, ``stack``,
``expand``, ``squeeze``, ``unsqueeze``, ``pad``, ``crop``), ``cast``,
``scale``, ``clip``, ``clip_by_norm``, ``l2_distance``, ``l1_norm``, the
reductions, ``mean``, ``sums``, the indexing ops (``top_k``, ``argmax``,
``gather``, ``scatter``, ``one_hot``, ``multiplex``, ``cumsum``), the
creation ops (``fill_constant``, ``fill_constant_batch_size_like``,
``zeros``, ``ones``, ``zeros_like``, ``assign``), the random draws
``gaussian_random`` and ``uniform_random``, ``increment``, the compares,
``is_empty`` and ``sign``.  ``matmul`` and ``mul`` are ``torch.matmul``:
the JAX package computes them outside any Pallas kernel.

Where JAX and torch part ways, the port takes JAX's side (ROADMAP C.4):
``crop`` clamps its offsets so the slice fits, as ``lax.dynamic_slice``
does; ``gather`` (``jnp.take``) wraps a negative index once and fills the
rows of an index outside [-n, n) with NaN (the most negative value for an
integer x), where torch would raise; ``multiplex`` wraps a negative index
once and clamps the rest, as JAX's indexing does, a clamped row passing
no gradient back; ``one_hot`` gives a zero row for an id outside [0,
depth), where ``F.one_hot`` raises; ``top_k`` puts the lower index first
among ties (a stable sort); ``scatter``
drops an index outside [-n, n) and, with ``overwrite`` and a repeated
index, keeps the last update, as JAX does on the CPU, on every device
(``index_put_`` pins no winner on CUDA); its adds run as a one-hot
matmul, in one order on every replay (``index_add_``'s atomics have
none).  Row gathers go through ``F.embedding``, whose backward adds in a
fixed order on the card.  ``gaussian_random`` and ``uniform_random`` draw
JAX's numbers (``ops/random.py``) from the op's key,
``ctx.rng_key(tag)``, so a warmed step's replay at step s draws what an
eager step at s draws."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..core.program import Variable, default_main_program
from ..core.types import convert_dtype
from ..ops import random as jrandom
from ..param_attr import PartitionSpec, seq_axis_of
from .helper import LayerHelper
from .ops import _clip


def _broadcast_y(x, y, axis: int):
    """Fluid's elementwise broadcast: align y's dims to x starting at
    ``axis`` (trailing-1 padding)."""
    if y.dim() == x.dim():
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * axis + list(y.shape) + [1] * (x.dim() - axis - y.dim())
    return y.reshape(shape)


def _constant(y):
    """``y`` (a Python scalar or an array) as a function of the op's
    operand ``a``: a tensor in ``a``'s dtype on its device, a scalar
    filled there and an array moved once per device and dtype, so that a
    captured step copies nothing from the host."""
    if np.ndim(y) == 0:
        return lambda a: torch.full((), y, dtype=a.dtype, device=a.device)
    arr, moved = np.asarray(y), {}

    def const(a):
        key = (a.device, a.dtype)
        if key not in moved:
            moved[key] = torch.as_tensor(arr, dtype=a.dtype, device=a.device)
        return moved[key]

    return const


def _elementwise(name, tfn):
    def layer(x: Variable, y, axis: int = -1, act: Optional[str] = None, **kwargs):
        helper = LayerHelper(name, **kwargs)
        if not isinstance(y, Variable):
            out = helper.append_op(
                lambda ctx, a, yv=_constant(y): tfn(a, yv(a)),
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


def _reduced_dims(x: Variable, dim) -> tuple:
    """The dims of ``x`` a reduce layer's ``dim`` names, sorted."""
    nd = len(x.shape or ())
    axis = (tuple(dim) if isinstance(dim, (list, tuple))
            else None if dim is None else (dim,))
    return tuple(sorted({d % nd for d in (range(nd) if axis is None
                                           else axis)})) if nd else ()


def _batch_groups(lay, batch: bool, seq) -> list:
    """The groups a reduction over the batch (``batch``) and the sequence
    (``seq``, the input's ``SeqAxis`` where dim 1 is reduced) of a
    sharded step sums over: dp, and sp for a sharded sequence."""
    if lay is None:
        return []
    axes = ([lay.data_axis] if batch and lay.data_axis else []) + (
        [seq] if lay.sharded(seq) else [])
    return [lay.mesh.group(a) for a in axes]


def _reduce(op_type):
    tfn = _REDUCE[op_type]

    def layer(x: Variable, dim=None, keep_dim: bool = False, name=None):
        """Reduce over ``dim`` (an int, a list of ints, or None for every
        axis), keeping the reduced axes as size 1 when ``keep_dim``.  Under
        a Strategy that shards the batch (or the sequence), a reduction
        over dim 0 (or dim 1) of a batch-major input is taken over the
        global tensor, and every rank gets the global value: sum and mean
        through ``comm.sum_from`` / ``mean_from``, max and min through
        ``comm.extreme_from`` (a tie's gradient split over every rank's
        ties); ``reduce_prod`` over the batch is refused before the step
        (``Strategy.check_batch_ops``, ROADMAP C.13)."""
        helper = LayerHelper(op_type, name=name)
        axis = (tuple(dim) if isinstance(dim, (list, tuple))
                else None if dim is None else (dim,))
        dims = _reduced_dims(x, dim)
        batch = bool(x.shape) and x.shape[0] is None and 0 in dims
        seq = seq_axis_of(x) if 1 in dims else None

        def fn(ctx, a, axis, keep_dim, _dims=dims, _batch=batch, _seq=seq):
            groups = _batch_groups(ctx.layout, _batch, _seq)
            if not groups:
                return tfn(a, axis, keep_dim)
            from ..parallel import comm

            if op_type == "reduce_sum":
                return comm.sum_from(tfn(a, axis, keep_dim), groups)
            if op_type == "reduce_mean":
                return comm.mean_from(tfn(a, axis, keep_dim), groups)
            m = comm.extreme_from(a, _dims, groups, op_type[len("reduce_"):])
            return m if keep_dim else m.squeeze(_dims)

        return helper.append_op(
            fn, {"X": [x]}, attrs={"axis": axis, "keep_dim": keep_dim},
            op_type=op_type)

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")


def mean(x: Variable, name=None):
    """Full reduction to a scalar (ref: paddle/operators/mean_op.cc).  Under
    a Strategy the mean of a batch-major input is taken over the global
    batch (and the global sequence, when sharded): the ranks' means
    averaged over dp and sp, with an identity backward (the Strategy
    averages the replicated parameters' gradients)."""
    helper = LayerHelper("mean", name=name)
    batch_major = bool(x.shape) and x.shape[0] is None
    seq = seq_axis_of(x)

    def fn(ctx, a, _batch=batch_major, _seq=seq):
        out = torch.mean(a)
        lay = ctx.layout
        if lay is not None and _batch:
            from ..parallel.comm import mean_from

            groups = lay.data_groups(_seq)
            if groups:
                out = mean_from(out, groups)
        return out

    return helper.append_op(fn, {"X": [x]})


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
    out = helper.append_op(lambda ctx, a, perm: a.permute(perm), {"X": [x]},
                           attrs={"perm": tuple(perm)})
    # the output's dims are the input's permuted, and so is their layout
    spec = tuple(x.sharding or ())
    out.sharding = (PartitionSpec(*(spec[p] if p < len(spec) else None
                                    for p in perm)) if any(spec) else None)
    return out


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


def expand(x: Variable, expand_times: Sequence[int], name=None):
    """Tile x ``expand_times`` along each dim (``jnp.tile``; ref:
    paddle/operators/expand_op.cc)."""
    helper = LayerHelper("expand", name=name)
    return helper.append_op(
        lambda ctx, a, expand_times: torch.tile(a, expand_times),
        {"X": [x]}, attrs={"expand_times": tuple(expand_times)})


def pad(x: Variable, paddings: Sequence[int], pad_value: float = 0.0,
        name=None):
    """Constant padding, ``paddings`` flat as [before0, after0, before1,
    after1, ...] (ref: paddle/operators/pad_op.cc)."""
    helper = LayerHelper("pad", name=name)

    def fn(ctx, a, paddings, pad_value):
        flat = []
        for i in reversed(range(a.dim())):   # F.pad: the last dim first
            flat += [paddings[2 * i], paddings[2 * i + 1]]
        return F.pad(a, flat, value=pad_value)

    return helper.append_op(fn, {"X": [x]},
                            attrs={"paddings": tuple(paddings),
                                   "pad_value": pad_value})


def crop(x: Variable, shape: Sequence[int],
         offsets: Optional[Sequence[int]] = None, name=None):
    """The ``shape`` slice of x at ``offsets`` (0s by default), each
    offset clamped to [0, dim - size] as ``lax.dynamic_slice`` clamps it
    (ref: paddle/operators/crop_op.cc)."""
    helper = LayerHelper("crop", name=name)
    offsets = tuple(offsets) if offsets is not None else None

    def fn(ctx, a, shape, offsets):
        off = offsets or (0,) * a.dim()
        for d, (o, n) in enumerate(zip(off, shape)):
            if n > a.shape[d]:
                raise ValueError(f"crop: size {n} exceeds dim {d} of "
                                 f"{tuple(a.shape)}")
            a = a.narrow(d, min(max(int(o), 0), a.shape[d] - n), n)
        return a

    return helper.append_op(fn, {"X": [x]}, attrs={"shape": tuple(shape),
                                                   "offsets": offsets})


def clip(x: Variable, min: float, max: float, name=None):
    """``jnp.clip(x, min, max)``: a value on a bound splits its gradient
    in half, as JAX's does."""
    helper = LayerHelper("clip", name=name)
    return helper.append_op(lambda ctx, a, min, max: _clip(a, min, max),
                            {"X": [x]}, attrs={"min": min, "max": max})


def clip_by_norm(x: Variable, max_norm: float, name=None):
    """x scaled to an L2 norm of at most ``max_norm`` (ref:
    paddle/operators/clip_by_norm_op.cc)."""
    helper = LayerHelper("clip_by_norm", name=name)

    def fn(ctx, a, max_norm):
        norm = torch.sqrt(torch.sum(torch.square(a)))
        cap = torch.full((), max_norm, dtype=norm.dtype, device=norm.device)
        return a * (max_norm / torch.maximum(norm, cap))

    return helper.append_op(fn, {"X": [x]}, attrs={"max_norm": max_norm},
                            axes=tuple(range(len(x.shape))))


def l2_distance(x: Variable, y: Variable, name=None):
    """Per-row Euclidean distance ``sqrt(sum((x_i - y_i)^2) + 1e-12)`` ->
    [N, 1] (ref: gserver/layers/L2DistanceLayer.cpp)."""
    helper = LayerHelper("l2_distance", name=name)

    def fn(ctx, a, b):
        d = (a - b).reshape(a.shape[0], -1)
        return torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)

    return helper.append_op(fn, {"X": [x], "Y": [y]},
                            axes=(-1,))


def l1_norm(x: Variable, name=None):
    """Scalar sum of absolute values; the gradient is sign(x) (ref:
    paddle/operators/l1_norm_op.cc)."""
    helper = LayerHelper("l1_norm", name=name)
    return helper.append_op(lambda ctx, a: torch.sum(torch.abs(a)),
                            {"X": [x]})


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


def top_k(x: Variable, k: int, name=None):
    """The ``k`` largest values along the last dim and their int64
    indices, the lower index first among ties (``lax.top_k``; a stable
    sort; ref: paddle/operators/top_k_op.cc)."""
    helper = LayerHelper("top_k", name=name)

    def fn(ctx, a, k):
        v, i = torch.sort(a, dim=-1, descending=True, stable=True)
        return v[..., :k], i[..., :k]

    return helper.append_op(fn, {"X": [x]}, attrs={"k": k}, n_outputs=2,
                            axes=(-1,))


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 for in-range int ``idx`` through
    ``F.embedding`` (its backward adds in a fixed order on the card)."""
    flat = table.reshape(table.shape[0], -1)
    out = F.embedding(idx.to(torch.int64), flat)
    return out.reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an out-of-range row: NaN for floats, the
    most negative value for signed integers, True for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min


def gather(x: Variable, index: Variable, name=None):
    """Rows of x by ``index`` (``jnp.take(x, index, axis=0)``; ref:
    paddle/operators/gather_op.cc): a negative index counts from the end,
    and an index outside [-n, n) gives a row of the fill value with no
    gradient."""
    helper = LayerHelper("gather", name=name)

    def fn(ctx, a, idx):
        n = a.shape[0]
        idx = idx.to(torch.int64)
        ok = (idx >= -n) & (idx < n)
        safe = torch.where(ok, torch.where(idx < 0, idx + n, idx), 0)
        rows = _rows(a, safe)
        ok = ok.reshape(tuple(ok.shape) + (1,) * (a.dim() - 1))
        return torch.where(ok, rows, torch.full(
            (), _fill_value(a.dtype), dtype=a.dtype, device=a.device))

    return helper.append_op(fn, {"X": [x], "Index": [index]})


def scatter(x: Variable, index: Variable, updates: Variable,
            overwrite: bool = True, name=None):
    """x with its rows ``index`` set to (``overwrite``) or added with the
    rows of ``updates`` (``x.at[index].set`` / ``.add``; ref:
    paddle/operators/scatter_op.cc): a negative index counts from the end,
    one outside [-n, n) is dropped, and a repeated index keeps its last
    update (set) or adds them all (add)."""
    helper = LayerHelper("scatter", name=name)

    def fn(ctx, a, idx, upd, overwrite):
        n = a.shape[0]
        idx = idx.reshape(-1).to(torch.int64)
        m = idx.shape[0]
        upd = upd.reshape((m,) + tuple(a.shape[1:]))
        ok = (idx >= -n) & (idx < n)
        tgt = torch.where(ok, torch.where(idx < 0, idx + n, idx), n)
        if not overwrite:
            hot = (tgt[None, :] == torch.arange(n, device=a.device)[:, None])
            add = hot.to(a.dtype) @ upd.reshape(m, -1)
            return a + add.reshape(a.shape)
        # the winner of each row: its last update (amax of the positions)
        win = torch.full((n + 1,), -1, dtype=torch.int64, device=a.device)
        win = win.scatter_reduce(0, tgt, torch.arange(m, device=a.device),
                                 reduce="amax")[:n]
        hit = (win >= 0).reshape((n,) + (1,) * (a.dim() - 1))
        return torch.where(hit, _rows(upd, win.clamp_min(0)), a)

    return helper.append_op(
        fn, {"X": [x], "Index": [index], "Updates": [updates]},
        attrs={"overwrite": overwrite})


def one_hot(x: Variable, depth: int, dtype="float32"):
    """One-hot rows of ``depth`` for the ids of x (a trailing dim of 1
    dropped), a zero row for an id outside [0, depth), as
    ``jax.nn.one_hot`` gives it."""
    helper = LayerHelper("one_hot")
    dt = convert_dtype(dtype)

    def fn(ctx, a, depth):
        if a.dim() > 1 and a.shape[-1] == 1:
            a = a.squeeze(-1)
        cls = torch.arange(depth, device=a.device)
        return (a.to(torch.int64)[..., None] == cls).to(dt)

    return helper.append_op(fn, {"X": [x]}, attrs={"depth": depth})


def multiplex(inputs: Sequence[Variable], index: Variable):
    """Row i from candidate ``index[i]`` (ref:
    paddle/operators/multiplex_op.cc); a negative index counts from the end
    once and the rest is clamped to [0, n), as JAX's indexing does, and a
    clamped row passes no gradient back, as JAX's does not."""
    helper = LayerHelper("multiplex")

    def fn(ctx, idx, *cands):
        stackd = torch.stack(cands, dim=0)          # [n_cand, batch, ...]
        n, b = stackd.shape[0], stackd.shape[1]
        idx = idx.reshape(-1).to(torch.int64)
        idx = torch.where(idx < 0, idx + n, idx)
        pick = idx.clamp(0, n - 1) * b + torch.arange(b, device=idx.device)
        out = _rows(stackd.reshape((n * b,) + tuple(stackd.shape[2:])),
                    pick)
        # a clamped row reads its value but, as in JAX's gather, passes no
        # gradient back
        ok = ((idx >= 0) & (idx < n)).reshape((b,) + (1,) * (out.dim() - 1))
        return torch.where(ok, out, out.detach())

    return helper.append_op(fn, {"Ids": [index], "X": list(inputs)})


def cumsum(x: Variable, axis: int = -1):
    helper = LayerHelper("cumsum")
    return helper.append_op(lambda ctx, a, axis: torch.cumsum(a, dim=axis),
                            {"X": [x]}, attrs={"axis": axis})


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x: Variable):
    helper = LayerHelper("fill_zeros_like")
    return helper.append_op(lambda ctx, a: torch.zeros_like(a), {"X": [x]})


def _empty_on_meta(ctx, shape, dt):
    return (torch.empty(shape, dtype=dt, device="meta")
            if ctx.device.type == "meta" else None)


def gaussian_random(shape, mean=0.0, std=1.0, dtype="float32"):
    """``mean + std * jax.random.normal`` of the op's key (ref:
    paddle/operators/gaussian_random_op.cc), float32, as XLA compiles it
    in the JAX package's jitted step (``ops/random.py::scaled_normal``)."""
    helper = LayerHelper("gaussian_random")
    tag = default_main_program().next_rng_tag()
    dt = convert_dtype(dtype)
    if dt != torch.float32:
        raise ValueError(f"gaussian_random is ported for float32, got {dt}")
    shape = tuple(shape)

    def fn(ctx):
        meta = _empty_on_meta(ctx, shape, dt)
        if meta is not None:
            return meta
        return jrandom.scaled_normal(ctx.rng_key(tag), shape, mean, std,
                                     ctx.device)

    return helper.append_op(fn, {})


def uniform_random(shape, min=-1.0, max=1.0, dtype="float32"):
    """``jax.random.uniform`` of the op's key on [min, max)."""
    helper = LayerHelper("uniform_random")
    tag = default_main_program().next_rng_tag()
    dt = convert_dtype(dtype)
    shape = tuple(shape)

    def fn(ctx):
        meta = _empty_on_meta(ctx, shape, dt)
        if meta is not None:
            return meta
        return jrandom.uniform(ctx.rng_key(tag), shape, dt, min, max,
                               ctx.device)

    return helper.append_op(fn, {})


def increment(x: Variable, value: float = 1.0, in_place: bool = True):
    """x + ``value`` (cast to x's dtype), written back to x when
    ``in_place``, so a persistable counter advances in the scope (ref:
    paddle/operators/increment_op.cc)."""
    helper = LayerHelper("increment")
    out_names = [x.name] if in_place else None
    return helper.append_op(
        lambda ctx, a, value: a + torch.full((), value, dtype=a.dtype,
                                             device=a.device),
        {"X": [x]}, attrs={"value": value}, out_names=out_names)


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


def is_empty(x: Variable):
    """A 0-d bool: whether x has no elements (ref:
    paddle/operators/is_empty_op.cc)."""
    helper = LayerHelper("is_empty")
    return helper.append_op(
        lambda ctx, a: torch.full((), a.numel() == 0, dtype=torch.bool,
                                  device=a.device), {"X": [x]})


def sign(x, name=None):
    """Elementwise sign (ref: paddle/operators/sign_op.cc), the same values
    as ``layers.ops.sign``."""
    helper = LayerHelper("sign", name=name)
    return helper.append_op(lambda ctx, a: torch.sign(a), {"X": [x]},
                            op_type="sign")


__all__ = ["argmax", "assign", "cast", "clip", "clip_by_norm", "concat",
           "cond_compare", "crop", "cumsum", "elementwise_add",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_mul", "elementwise_pow", "elementwise_sub", "equal",
           "expand", "fill_constant", "fill_constant_batch_size_like",
           "gather", "gaussian_random", "greater_than", "increment",
           "is_empty", "l1_norm", "l2_distance", "less_equal", "less_than",
           "matmul", "mean", "mul", "multiplex", "not_equal", "one_hot",
           "ones", "pad", "reduce_max", "reduce_mean", "reduce_min",
           "reduce_prod", "reduce_sum", "reshape", "scale", "scatter",
           "sign", "split", "squeeze", "stack", "sums", "top_k",
           "transpose", "uniform_random", "unsqueeze", "zeros",
           "zeros_like"]
