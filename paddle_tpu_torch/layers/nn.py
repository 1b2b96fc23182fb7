"""Neural-network layers (PyTorch port of ``paddle_tpu/layers/nn.py``):
fc, embedding, the convolutions and poolings (conv2d, conv2d_transpose,
conv3d, pool2d, pool3d, pool_with_index, unpool, spp, maxout), the
normalisations (batch_norm, layer_norm, lrn), dropout and sampling_id,
the losses, the metrics-as-ops (accuracy, auc, precision_recall,
positive_negative_pair), nce and hsigmoid, the v1 parity layers and
bilinear_interp.  dropout, sampling_id and nce draw JAX's numbers from
the op's key, ``ctx.rng_key(tag)`` (``ops/dropout.py``,
``ops/random.py``).  A clip or max against a constant is ``maximum``, as
JAX's is, so a value on the bound splits its gradient in half.

Numerics follow the JAX package: layer_norm and batch_norm take float32
statistics with ``var = max(E[x^2] - mu^2, 0)`` (not the serving layer
norm's population variance, and not ``torch.nn.BatchNorm2d``'s unbiased
running variance or its reversed momentum); gathers convert int32 ids to
int64 at the gather, since feeds keep their declared int32.  Convolutions
and pooling are NCHW (NCDHW in 3-D), as in the JAX package, and run as the
plain torch ops (cuDNN on the card): the JAX package leaves them to XLA,
outside any Pallas kernel.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.program import Op, Variable
from ..initializer import Constant, Normal, Xavier
from ..ops.batch_norm import batch_norm_train
from ..ops import random as jrandom
from ..ops.dropout import threefry_dropout
from ..param_attr import PartitionSpec, seq_axis_of
from .helper import LayerHelper


# embedding(is_sparse=True) warns once per process that no sharding applies
_sparse_fallback_warned = False


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)

# --------------------------------------------------------------------------- fc


def fc(
    input: Union[Variable, Sequence[Variable]],
    size: int,
    num_flatten_dims: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
):
    """Fully connected layer (mul + elementwise_add + activation).  Multiple
    inputs each get their own weight and are summed."""
    helper = LayerHelper("fc", name=name)
    inputs = [input] if isinstance(input, Variable) else list(input)
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)

    partials = []
    col_axis = None
    for x, pattr in zip(inputs, param_attrs):
        in_features = int(np.prod([d for d in x.shape[num_flatten_dims:]]))
        w = helper.create_parameter(pattr, [in_features, size], x.dtype)
        wspec = tuple(w.sharding or ())
        if len(wspec) > 1 and wspec[1] is not None:
            col_axis = wspec[1]

        def fn(ctx, a, wv, num_flatten_dims, _spec=wspec):
            am = a.reshape(tuple(a.shape[:num_flatten_dims]) + (-1,))
            flat = am.reshape((-1, am.shape[-1]))
            if ctx.mesh is not None and any(_spec):
                # a shard of a tensor-parallel W (parallel/tp.py)
                from ..parallel.tp import sharded_matmul

                out = sharded_matmul(ctx.mesh, flat, wv, _spec)
            else:
                out = flat @ wv
            return out.reshape(tuple(am.shape[:-1]) + (out.shape[-1],))

        partials.append(
            helper.append_op(fn, {"Input": [x], "W": [w]},
                             attrs={"num_flatten_dims": num_flatten_dims}, op_type="mul")
        )
    made = list(partials)
    out = partials[0]
    if len(partials) > 1:
        from .tensor import sums

        out = sums(partials)
        made.append(out)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], out.dtype, is_bias=True)
        out = helper.append_op(lambda ctx, a, bv: a + bv, {"X": [out], "B": [b]},
                               op_type="elementwise_add")
        made.append(out)
    out = helper.append_activation(out, act)
    if col_axis is not None:
        # a column-parallel output is sharded on its last dim (its other
        # dims keep the layout they carry: a sequence shard)
        for v in made + [out]:
            spec = list(v.sharding or ()) + [None] * len(v.shape)
            v.sharding = PartitionSpec(*(spec[:len(v.shape) - 1]
                                         + [col_axis]))
    return out


# --------------------------------------------------------------------------- embedding


def embedding(
    input: Variable,
    size: Sequence[int],
    is_sparse: bool = False,
    padding_idx: Optional[int] = None,
    param_attr=None,
    dtype="float32",
    name: Optional[str] = None,
):
    """Lookup table: the dense gather; rows of ``padding_idx`` read as zeros.

    ``is_sparse`` routes through the sparse engine's ``sparse_lookup``
    (``sparse/table.py``): the same gather forward (out-of-range ids
    clamped, as JAX's clip), and a backward that drops the ``padding_idx``
    row's cotangent (and out-of-range ids') instead of only masking the
    output, so the padding row's gradient is exactly zero even under a
    non-finite cotangent.  A table sharded on its vocab dim takes the
    vocab-parallel lookup under a Strategy (``parallel/tp.py``), with
    ``is_sparse`` the sparse engine's rule on the rank's rows
    (``vocab_sparse_lookup``).  As the reference does for an unsharded
    table, the first ``is_sparse`` layer warns once that no sharding
    applies."""
    helper = LayerHelper("embedding", name=name)
    table = helper.create_parameter(
        param_attr, list(size), dtype, default_initializer=Normal(0.0, 0.02)
    )
    vocab = int(size[0])
    tspec = tuple(table.sharding or ())
    if any(tspec[1:]):
        raise NotImplementedError(
            f"embedding: only the vocab dim of a table may be sharded, got "
            f"{table.sharding}")
    if is_sparse and not tspec:
        global _sparse_fallback_warned
        if not _sparse_fallback_warned:
            _sparse_fallback_warned = True
            warnings.warn(
                "embedding(is_sparse=True) on an unsharded table: no mesh "
                "sharding applies, so the lookup is the dense gather with "
                "the sparse engine's padding_idx cotangent fix.",
                stacklevel=2)

    def fn(ctx, ids, tab, padding_idx, is_sparse, _axis=tspec[:1]):
        if ids.dim() >= 2 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        sharded = ctx.mesh is not None and any(_axis)
        if is_sparse and sharded:
            from ..parallel.tp import vocab_sparse_lookup

            return vocab_sparse_lookup(ctx.mesh, ids, tab, _axis[0], vocab,
                                       padding_idx)
        if is_sparse:
            from ..sparse.table import sparse_lookup

            return sparse_lookup(tab, ids, padding_idx, vocab)
        ids = ids.long()
        if sharded:
            # a vocab-parallel table (parallel/tp.py)
            from ..parallel.tp import vocab_lookup

            out = vocab_lookup(ctx.mesh, ids, tab, _axis[0], vocab)
        else:
            out = F.embedding(ids, tab)
        if padding_idx is not None:
            mask = (ids != padding_idx)[..., None]
            out = out * mask.to(out.dtype)
        return out

    return helper.append_op(fn, {"Ids": [input], "W": [table]},
                            attrs={"padding_idx": padding_idx,
                                   "is_sparse": bool(is_sparse)})


# --------------------------------------------------------------------------- conv


def conv2d(
    input: Variable,
    num_filters: int,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups: int = 1,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    use_cudnn: bool = True,
    name: Optional[str] = None,
):
    """2-D convolution, NCHW input and OIHW filter, with symmetric padding,
    dilation and groups.  The filter defaults to Normal(0, sqrt(2 /
    fan_in)); the bias, unless ``bias_attr`` is False, is an
    ``elementwise_add`` op of its own, as in the JAX package.
    ``use_cudnn`` is accepted for API parity."""
    helper = LayerHelper("conv2d", name=name)
    kh, kw = _pair(filter_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    in_channels = input.shape[1]
    filt_shape = [num_filters, in_channels // groups, kh, kw]
    fan_in = (in_channels // groups) * kh * kw
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(param_attr, filt_shape, input.dtype,
                                default_initializer=Normal(0.0, std))

    def fn(ctx, a, wv, strides, padding, dilation, groups):
        return F.conv2d(a, wv, None, strides, padding, dilation, groups)

    out = helper.append_op(
        fn, {"Input": [input], "Filter": [w]},
        attrs={"strides": (sh, sw), "padding": (ph, pw),
               "dilation": (dh, dw), "groups": groups},
    )
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], out.dtype,
                                    is_bias=True)
        out = helper.append_op(
            lambda ctx, a, bv: a + bv.reshape(1, -1, 1, 1),
            {"X": [out], "B": [b]}, op_type="elementwise_add")
    return helper.append_activation(out, act)


def conv2d_transpose(
    input: Variable,
    num_filters: int,
    filter_size,
    stride=1,
    padding=0,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
):
    """Transposed 2-D convolution, NCHW input and a ``[in, out, kh, kw]``
    filter (Xavier), output size ``(in - 1) * stride - 2 * padding + k``
    (ref: paddle/operators/conv_transpose_op.cc).  The JAX package lowers
    it to ``jax.lax.conv_transpose`` without ``transpose_kernel``, which
    does not flip the filter spatially, where ``F.conv_transpose2d`` (the
    gradient of a convolution) does: so the filter is flipped first.  The
    lax padding ``k - 1 - padding`` may go negative (a crop), as
    ``F.conv_transpose2d``'s padding past ``k - 1`` crops."""
    helper = LayerHelper("conv2d_transpose", name=name)
    kh, kw = _pair(filter_size)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    in_channels = input.shape[1]
    w = helper.create_parameter(param_attr, [in_channels, num_filters, kh, kw],
                                input.dtype, default_initializer=Xavier())

    def fn(ctx, a, wv, strides, padding):
        return F.conv_transpose2d(a, wv.flip((2, 3)), None, strides, padding)

    out = helper.append_op(fn, {"Input": [input], "Filter": [w]},
                           attrs={"strides": (sh, sw), "padding": (ph, pw)})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], out.dtype,
                                    is_bias=True)
        out = helper.append_op(
            lambda ctx, a, bv: a + bv.reshape(1, -1, 1, 1),
            {"X": [out], "B": [b]}, op_type="elementwise_add")
    return helper.append_activation(out, act)


# --------------------------------------------------------------------------- pooling


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(a, pool_type, ksize, strides, padding, exclusive):
    """Max or average pooling of NC(D)HW ``a`` as ``jax.lax.reduce_window``
    computes it: max pads with -inf; average sums with zero padding and
    divides by the window size, or, when ``exclusive`` and there is
    padding, by the count of real cells.  torch's pools take padding of at
    most half the window; past that the padding is applied first."""
    nd = len(ksize)
    maxp, avgp = _MAX_POOL[nd], _AVG_POOL[nd]
    by_count = bool(exclusive and any(padding))
    if all(2 * p <= k for p, k in zip(padding, ksize)):
        if pool_type == "max":
            return maxp(a, ksize, strides, padding)
        return avgp(a, ksize, strides, padding,
                    count_include_pad=not by_count)
    pads = tuple(q for p in reversed(padding) for q in (p, p))
    if pool_type == "max":
        return maxp(F.pad(a, pads, value=float("-inf")), ksize, strides)
    s = avgp(F.pad(a, pads), ksize, strides)
    if not by_count:
        return s
    ones = F.pad(torch.ones_like(a[:1, :1]), pads)
    return s / avgp(ones, ksize, strides)


def pool2d(
    input: Variable,
    pool_size,
    pool_type: str = "max",
    pool_stride=1,
    pool_padding=0,
    global_pooling: bool = False,
    ceil_mode: bool = False,
    exclusive: bool = True,
    name: Optional[str] = None,
):
    """Max pooling (``pool_type="max"``) or average pooling (any other
    type), NCHW.  ``global_pooling`` pools each whole plane.  ``ceil_mode``
    is accepted and ignored, as the JAX package ignores it (output sizes
    round down)."""
    helper = LayerHelper("pool2d", name=name)
    kh, kw = _pair(pool_size)
    sh, sw = _pair(pool_stride)
    ph, pw = _pair(pool_padding)

    def fn(ctx, a, pool_type, ksize, strides, padding, global_pooling,
           exclusive):
        if global_pooling:
            ksize = (a.shape[2], a.shape[3])
            strides = ksize
            padding = (0, 0)
        return _pool(a, pool_type, tuple(ksize), tuple(strides),
                     tuple(padding), exclusive)

    return helper.append_op(
        fn, {"X": [input]},
        attrs={"pool_type": pool_type, "ksize": (kh, kw),
               "strides": (sh, sw), "padding": (ph, pw),
               "global_pooling": global_pooling, "exclusive": exclusive},
    )


def pool_with_index(input: Variable, pool_size, pool_stride=1,
                    pool_padding=0, global_pooling: bool = False, name=None):
    """Max pooling that also returns, for each output, the flat index of
    its maximum in its H*W input plane, int32 (ref:
    paddle/operators/pool_with_index_op.cc); a tie goes to the first cell
    in window order, as in the JAX package.  The JAX package carries the
    index in the input's dtype, so under amp (``pool_with_index`` is a
    bfloat16 op) its indices above 256 round; the port's stay exact, the
    flat argmax indices the op promises.  Padding past half the window,
    which torch's ``max_pool2d`` refuses, is applied first (-inf) and the
    indices mapped back to the unpadded plane."""
    helper = LayerHelper("pool_with_index", name=name)
    kh, kw = _pair(pool_size)
    sh, sw = _pair(pool_stride)
    ph, pw = _pair(pool_padding)

    def fn(ctx, a, ksize, strides, padding, global_pooling):
        if global_pooling:
            ksize = strides = (a.shape[2], a.shape[3])
            padding = (0, 0)
        (kh, kw), (ph, pw) = ksize, padding
        if 2 * ph <= kh and 2 * pw <= kw:
            out, idx = F.max_pool2d(a, ksize, strides, padding,
                                    return_indices=True)
            return out, idx.to(torch.int32)
        out, idx = F.max_pool2d(
            F.pad(a, (pw, pw, ph, ph), value=float("-inf")), ksize, strides,
            return_indices=True)
        wp = a.shape[3] + 2 * pw
        idx = (idx // wp - ph) * a.shape[3] + idx % wp - pw
        return out, idx.to(torch.int32)

    out = helper.append_op(
        fn, {"X": [input]},
        attrs={"ksize": (kh, kw), "strides": (sh, sw), "padding": (ph, pw),
               "global_pooling": global_pooling}, n_outputs=2)
    return out[0], out[1]


def unpool(input: Variable, indices: Variable, unpool_size=None, name=None):
    """Max unpooling: each value added at the flat position
    ``pool_with_index`` recorded in its (H, W) output plane, ``unpool_size``
    (default twice the input's); values whose windows overlapped at one
    position add up, as the JAX package's ``.at[i].add`` does (not
    ``F.max_unpool2d``, which assigns) (ref: paddle/operators/unpool_op.cc)."""
    helper = LayerHelper("unpool", name=name)

    def fn(ctx, a, idx, out_hw):
        n, c, h, w = a.shape
        oh, ow = out_hw if out_hw is not None else (h * 2, w * 2)
        flat = torch.zeros((n, c, oh * ow), dtype=a.dtype, device=a.device)
        out = flat.scatter_add(2, idx.reshape(n, c, h * w).long(),
                               a.reshape(n, c, h * w))
        return out.reshape(n, c, oh, ow)

    return helper.append_op(fn, {"X": [input], "Indices": [indices]},
                            attrs={"out_hw": tuple(unpool_size)
                                   if unpool_size else None})


def spp(input: Variable, pyramid_height: int = 3, pool_type: str = "max",
        name=None):
    """Spatial pyramid pooling (ref: paddle/operators/spp_op.cc): level l
    pools each plane in 2^l x 2^l windows of ceil(H / 2^l) x ceil(W / 2^l)
    cells, stride equal to the window, zero padding at the end (max pads
    with -inf, the average divides by the real cells); the levels' outputs
    flattened and concatenated, [N, C * sum(4^l)].  Not
    ``F.adaptive_*_pool2d``, whose bin edges differ."""
    helper = LayerHelper("spp", name=name)

    def fn(ctx, a, levels, pool_type):
        n, _, h, w = a.shape
        outs = []
        for level in range(levels):
            bins = 2 ** level
            kh, kw = -(-h // bins), -(-w // bins)
            pads = (0, kw * bins - w, 0, kh * bins - h)
            if pool_type == "max":
                o = F.max_pool2d(F.pad(a, pads, value=float("-inf")),
                                 (kh, kw))
            else:
                o = (F.avg_pool2d(F.pad(a, pads), (kh, kw))
                     / F.avg_pool2d(F.pad(torch.ones_like(a[:1, :1]), pads),
                                    (kh, kw)))
            outs.append(o.reshape(n, -1))
        return torch.cat(outs, dim=1)

    return helper.append_op(fn, {"X": [input]},
                            attrs={"levels": pyramid_height,
                                   "pool_type": pool_type})


def _triple(x):
    return tuple(x) if isinstance(x, (list, tuple)) else (x, x, x)


def conv3d(input: Variable, num_filters: int, filter_size, stride=1,
           padding=0, groups: int = 1, param_attr=None, bias_attr=None,
           act=None, name=None):
    """3-D convolution, NCDHW input and OIDHW filter (Normal(0, sqrt(2 /
    fan_in))), symmetric padding and groups; the bias an
    ``elementwise_add`` of its own (ref: paddle/operators/conv_op.cc
    Conv3D)."""
    helper = LayerHelper("conv3d", name=name)
    kd, kh, kw = _triple(filter_size)
    in_channels = input.shape[1]
    fan_in = (in_channels // groups) * kd * kh * kw
    w = helper.create_parameter(
        param_attr, [num_filters, in_channels // groups, kd, kh, kw],
        input.dtype, default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5))

    def fn(ctx, a, wv, strides, padding, groups):
        return F.conv3d(a, wv, None, strides, padding, 1, groups)

    out = helper.append_op(fn, {"Input": [input], "Filter": [w]},
                           attrs={"strides": _triple(stride),
                                  "padding": _triple(padding),
                                  "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], out.dtype,
                                    is_bias=True)
        out = helper.append_op(
            lambda ctx, a, bv: a + bv.reshape(1, -1, 1, 1, 1),
            {"X": [out], "B": [b]}, op_type="elementwise_add")
    return helper.append_activation(out, act)


def pool3d(input: Variable, pool_size, pool_type: str = "max",
           pool_stride=1, pool_padding=0, global_pooling: bool = False,
           name=None):
    """3-D max or average pooling, NCDHW (ref: paddle/operators/pool_op.cc
    Pool3D); the average always divides by the real cells, as the JAX
    package's does."""
    helper = LayerHelper("pool3d", name=name)

    def fn(ctx, a, ksize, strides, padding, pool_type, global_pooling):
        if global_pooling:
            ksize = strides = tuple(a.shape[2:])
            padding = (0, 0, 0)
        return _pool(a, pool_type, tuple(ksize), tuple(strides),
                     tuple(padding), True)

    return helper.append_op(
        fn, {"X": [input]},
        attrs={"ksize": _triple(pool_size), "strides": _triple(pool_stride),
               "padding": _triple(pool_padding), "pool_type": pool_type,
               "global_pooling": global_pooling})


# --------------------------------------------------------------------------- batch_norm


def batch_norm(
    input: Variable,
    act: Optional[str] = None,
    is_test: bool = False,
    momentum: float = 0.9,
    epsilon: float = 1e-5,
    param_attr=None,
    bias_attr=None,
    data_layout: str = "NCHW",
    moving_mean_name: Optional[str] = None,
    moving_variance_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Batch normalisation over every dim but the channel's (dim 1 for
    NCHW, the last for NHWC).

    The running mean and variance are persistable non-trainable variables
    (``<name>.w_mean`` / ``<name>.w_var``; zeros and ones from the startup
    program), and the op's second and third outputs are rewired onto them,
    so each step returns them as new state: ``momentum * old + (1 -
    momentum) * batch``, without gradient.  In training the op runs
    ``ops.batch_norm.batch_norm_train`` (float32 statistics, the output in
    the input's dtype, the backward on the CUDA kernels on the card); with
    ``is_test`` it normalises with the running statistics.  Under amp the
    op is PASSTHROUGH: a bfloat16 activation stays bfloat16 while the
    parameters and statistics stay float32."""
    helper = LayerHelper("batch_norm", name=name)
    ch_axis = 1 if data_layout == "NCHW" else -1
    channels = input.shape[ch_axis]
    scale = helper.create_parameter(param_attr, [channels], input.dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [channels], input.dtype,
                                   is_bias=True)

    block = helper.block
    # two reads of helper.name: two fresh names without a name argument,
    # as the JAX package gives them
    mean_name = moving_mean_name or (helper.name + ".w_mean")
    var_name = moving_variance_name or (helper.name + ".w_var")
    mean_v = block.create_var(mean_name, [channels], input.dtype,
                              persistable=True)
    var_v = block.create_var(var_name, [channels], input.dtype,
                             persistable=True)
    sblock = helper.startup_program.global_block
    if not sblock.has_var(mean_name):
        sblock.create_var(mean_name, [channels], input.dtype, persistable=True)
        sblock.create_var(var_name, [channels], input.dtype, persistable=True)
        cshape, cdt = (int(channels),), input.dtype

        def init_fn(ins, attrs, ctx, _fill):
            return {"Out": [torch.full(cshape, _fill, dtype=cdt,
                                       device=ctx.device)]}

        sblock.append_op(Op("init", {}, {"Out": [mean_name]}, {},
                            lambda i, a, c: init_fn(i, a, c, 0.0)))
        sblock.append_op(Op("init", {}, {"Out": [var_name]}, {},
                            lambda i, a, c: init_fn(i, a, c, 1.0)))

    batch_major = bool(input.shape) and input.shape[0] is None
    seq = seq_axis_of(input)

    def fn(ctx, a, sc, bs, mu, var, is_test, momentum, epsilon, ch_axis,
           _batch=batch_major, _seq=seq):
        axis = ch_axis % a.dim()
        if is_test:
            bshape = [1] * a.dim()
            bshape[axis] = -1
            scale_eff = sc.to(torch.float32) * torch.rsqrt(
                var.to(torch.float32) + epsilon)
            bias_eff = bs.to(torch.float32) - mu.to(torch.float32) * scale_eff
            out = (a * scale_eff.to(a.dtype).reshape(bshape)
                   + bias_eff.to(a.dtype).reshape(bshape))
            return out, mu, var
        # under a Strategy the statistics are the global batch's (ROADMAP
        # C.13): the sums over the data groups
        lay = ctx.layout
        groups = lay.data_groups(_seq) if lay is not None and _batch else ()
        out, bmean, bvar = batch_norm_train(
            a if axis == 1 else a.movedim(axis, 1), sc, bs, epsilon, groups)
        new_mu = momentum * mu + (1 - momentum) * bmean.to(mu.dtype)
        new_var = momentum * var + (1 - momentum) * bvar.to(var.dtype)
        return (out if axis == 1 else out.movedim(1, axis), new_mu.detach(),
                new_var.detach())

    out, _, _ = helper.append_op(
        fn,
        {"X": [input], "Scale": [scale], "Bias": [bias], "Mean": [mean_v],
         "Variance": [var_v]},
        attrs={"is_test": is_test, "momentum": momentum, "epsilon": epsilon,
               "ch_axis": ch_axis},
        n_outputs=3,
    )
    # rewire the stat outputs onto the persistable names so the scope
    # advances
    helper.block.ops[-1].outputs["Out"] = [out.name, mean_name, var_name]
    return helper.append_activation(out, act)


# --------------------------------------------------------------------------- layer_norm


def layer_norm(
    input: Variable,
    scale: bool = True,
    shift: bool = True,
    begin_norm_axis: int = 1,
    epsilon: float = 1e-5,
    param_attr=None,
    bias_attr=None,
    act: Optional[str] = None,
    name: Optional[str] = None,
):
    """Layer normalisation over the dims from ``begin_norm_axis`` on, with
    float32 statistics and the result cast back to the input dtype."""
    helper = LayerHelper("layer_norm", name=name)
    nshape = [int(np.prod(input.shape[begin_norm_axis:]))]
    g = helper.create_parameter(param_attr, nshape, input.dtype,
                                default_initializer=Constant(1.0)) if scale else None
    b = helper.create_parameter(bias_attr, nshape, input.dtype, is_bias=True) if shift else None

    def fn(ctx, a, *gb, begin_norm_axis, epsilon):
        axes = tuple(range(begin_norm_axis, a.dim()))
        x32 = a.to(torch.float32)
        mu = x32.mean(dim=axes, keepdim=True)
        var = torch.clamp_min(
            torch.square(x32).mean(dim=axes, keepdim=True) - torch.square(mu), 0.0)
        out = (x32 - mu) * torch.rsqrt(var + epsilon)
        i = 0
        bshape = (1,) * begin_norm_axis + tuple(a.shape[begin_norm_axis:])
        if scale:
            out = out * gb[i].to(torch.float32).reshape(bshape)
            i += 1
        if shift:
            out = out + gb[i].to(torch.float32).reshape(bshape)
        return out.to(a.dtype)

    ins = {"X": [input]}
    extras = [p for p in (g, b) if p is not None]
    if extras:
        ins["ScaleBias"] = extras
    out = helper.append_op(fn, ins, attrs={"begin_norm_axis": begin_norm_axis,
                                           "epsilon": epsilon},
                           axes=tuple(range(begin_norm_axis, len(input.shape))))
    return helper.append_activation(out, act)


# --------------------------------------------------------------------------- lrn


def lrn(input: Variable, n: int = 5, k: float = 1.0, alpha: float = 1e-4,
        beta: float = 0.75, name=None):
    """Local response normalisation across the channels of NCHW ``input``:
    ``x / (k + alpha * acc) ** beta``, ``acc`` the sum of x^2 over a
    zero-padded window of ``n`` channels centred on each one, all in
    float32, the result cast back to x's dtype (ref:
    paddle/operators/lrn_op.cc; ``paddle_tpu/layers/nn.py:432``).  Not
    ``F.local_response_norm``, which divides ``alpha`` by ``n``."""
    helper = LayerHelper("lrn", name=name)

    def fn(ctx, a, n, k, alpha, beta):
        x32 = a.to(torch.float32)
        half = n // 2
        padded = F.pad(torch.square(x32), (0, 0, 0, 0, half, half))
        acc = sum(padded[:, i:i + a.shape[1]] for i in range(n))
        return (x32 / torch.pow(k + alpha * acc, beta)).to(a.dtype)

    return helper.append_op(fn, {"X": [input]},
                            attrs={"n": n, "k": k, "alpha": alpha,
                                   "beta": beta},
                            axes=(1,))


# --------------------------------------------------------------------------- losses


def softmax_with_cross_entropy(logits: Variable, label: Variable, soft_label: bool = False,
                               return_softmax: bool = False):
    """Fused log-softmax and cross entropy; hard labels [..., 1] (or [...])
    are int ids, gathered as int64.  Logits sharded on the vocab dim (the
    tensor-parallel LM head) take the vocab-parallel form under a
    Strategy (``parallel/tp.py``), hard or soft labels, and the softmax
    ``return_softmax`` gives is sharded as the logits are."""
    helper = LayerHelper("softmax_with_cross_entropy")
    lspec = tuple(logits.sharding or ())
    vaxis = lspec[-1] if len(lspec) == len(logits.shape) else None

    def fn(ctx, lg, lab, soft_label, return_softmax, _axis=vaxis,
           _vocab=logits.shape[-1]):
        if ctx.mesh is not None and _axis is not None:
            from ..parallel.tp import vocab_cross_entropy

            if not soft_label and lab.dim() == lg.dim():
                lab = lab.squeeze(-1)
            return vocab_cross_entropy(ctx.mesh, lg, lab, _axis, _vocab,
                                       soft_label, return_softmax)
        logp = torch.log_softmax(lg, dim=-1)
        if soft_label:
            loss = -torch.sum(lab * logp, dim=-1, keepdim=True)
        else:
            ids = lab.squeeze(-1) if lab.dim() == lg.dim() else lab
            loss = -torch.gather(logp, -1, ids[..., None].long())
        if return_softmax:
            return loss, torch.exp(logp)
        return loss

    outs = helper.append_op(fn, {"Logits": [logits], "Label": [label]},
                            attrs={"soft_label": soft_label, "return_softmax": return_softmax},
                            n_outputs=2 if return_softmax else 1,
                            axes=(-1,))
    if return_softmax and vaxis is not None:
        outs[1].sharding = logits.sharding
    return outs


def cross_entropy(input: Variable, label: Variable, soft_label: bool = False,
                  name=None):
    """Cross entropy on probabilities (not logits): ``-log(p + 1e-8)`` at
    the label, shape [batch, 1]; hard labels are int ids, gathered as
    int64."""
    helper = LayerHelper("cross_entropy", name=name)

    def fn(ctx, p, lab, soft_label):
        eps = 1e-8
        if soft_label:
            return -torch.sum(lab * torch.log(p + eps), dim=-1, keepdim=True)
        ids = lab.squeeze(-1) if lab.dim() == p.dim() else lab
        picked = torch.gather(p, -1, ids[..., None].long())
        return -torch.log(picked + eps)

    return helper.append_op(fn, {"X": [input], "Label": [label]},
                            attrs={"soft_label": soft_label},
                            axes=(-1,))


def square_error_cost(input: Variable, label: Variable, name=None):
    """Element-wise ``(input - label)^2`` (ref:
    paddle/operators/squared_l2_distance_op.cc via fluid layers)."""
    helper = LayerHelper("square_error_cost", name=name)
    return helper.append_op(lambda ctx, a, b: torch.square(a - b),
                            {"X": [input], "Label": [label]})


# --------------------------------------------------------------------------- dropout


def dropout(x: Variable, dropout_prob: float, is_test: bool = False,
            seed=None, name=None):
    """The reference's 'downgrade_in_infer' dropout
    (``paddle_tpu/layers/nn.py:449``): training keeps ``x * mask`` with no
    1 / (1 - p) rescale, ``is_test`` gives ``x * (1 - p)``.  The mask is
    JAX's bernoulli for the op's key, ``ctx.rng_key(tag)``, the tag drawn
    from the program at build time, bit for bit (``ops/dropout.py``; the
    hand-written kernel on the card).  ``seed`` is taken and unused, as in
    the reference.  ``is_test`` scales by 1 - p rounded to x's dtype, as
    JAX's weakly typed scalar is."""
    helper = LayerHelper("dropout", name=name)
    tag = helper.main_program.next_rng_tag()
    seq = seq_axis_of(x)
    spec = tuple(x.sharding or ())
    nd = len(x.shape)
    col = spec[nd - 1] if len(spec) == nd and nd > 1 \
        and not (nd - 1 == 1 and seq is not None) else None
    if any(a is not None and not (i == 1 and seq is not None)
           and not (i == nd - 1 and a == col)
           for i, a in enumerate(spec)):
        raise NotImplementedError(
            f"dropout of a tensor sharded as {x.sharding}: a rank's slice "
            f"may shard the rows, the sequence (dim 1) and the last dim")
    batch_major = bool(x.shape) and x.shape[0] is None

    def fn(ctx, a, dropout_prob, is_test, _tag, _batch=batch_major,
           _seq=seq, _col=col):
        if is_test:
            scale = torch.tensor(1.0 - dropout_prob,
                                 dtype=torch.float64).to(a.dtype).item()
            return a * scale
        # under a Strategy a rank draws the global tensor's mask at its
        # rows, sequence positions and tensor-parallel columns
        # (ops/dropout.py CounterMap)
        lay = ctx.layout
        cmap = (lay.counter_map(a.shape, _seq, _batch, _col)
                if lay is not None and (_batch or _col is not None)
                else None)
        return threefry_dropout(a, ctx.rng_key(_tag), dropout_prob, cmap)

    out = helper.append_op(fn, {"X": [x]},
                           attrs={"dropout_prob": dropout_prob,
                                  "is_test": is_test, "_tag": tag})
    if col is not None:
        out.sharding = x.sharding   # a tensor-parallel slice stays one
    return out


# --------------------------------------------------------------------------- metrics


def _topk_counts(p, lab, k: int, ctx, seq, batch: bool):
    """(correct, entries, rows) of a top-k test of ``p`` against ``lab``:
    the entries whose label is among the k largest along the last dim,
    the entries tested, and the rows of dim 0, as float32 (the rows a
    Python float).  ``jax.lax.top_k`` puts the lower index first among
    equal values; ``torch.topk`` leaves the order of ties unspecified, so
    the top k come from a stable descending sort, which keeps JAX's
    order.  Under a Strategy that shards a batch-major ``p`` (``batch``)
    over dp, and its sequence over ``seq``, the counts are those of the
    global batch: the first two summed over the ranks (exact in float32),
    the rows the local ones times dp."""
    topi = torch.sort(p, dim=-1, descending=True, stable=True).indices
    ids = lab.squeeze(-1) if lab.dim() == p.dim() else lab
    correct = torch.any(topi[..., :k] == ids[..., None].long(), dim=-1)
    # the entry count filled on the device: no host copy, so a step that
    # holds it can be captured in a CUDA graph
    counts = torch.stack([correct.to(torch.float32).sum(),
                          torch.full((), float(correct.numel()),
                                     dtype=torch.float32, device=p.device)])
    rows = float(p.shape[0])
    lay = ctx.layout
    if lay is not None and batch:
        from ..parallel import comm

        for g in lay.data_groups(seq):
            counts = comm.all_reduce(counts, g)
        if lay.data_axis is not None:
            rows *= comm.size(lay.mesh.group(lay.data_axis))
    return counts[0], counts[1], rows


def accuracy(input: Variable, label: Variable, k: int = 1, name=None):
    """Top-k accuracy of a batch, a [1] float32 (:func:`_topk_counts`: the
    global batch's rate under a Strategy that shards the batch or the
    sequence)."""
    helper = LayerHelper("accuracy", name=name)
    seq = seq_axis_of(input)
    batch = bool(input.shape) and input.shape[0] is None

    def fn(ctx, p, lab, k, _seq=seq, _batch=batch):
        correct, total, _ = _topk_counts(p, lab, k, ctx, _seq, _batch)
        return (correct / total)[None]

    return helper.append_op(fn, {"Out": [input], "Label": [label]},
                            attrs={"k": k},
                            axes=(-1,))


def maxout(x: Variable, groups: int, name=None):
    """Max over ``groups`` consecutive channels, NCHW (ref:
    paddle/operators/maxout_op.cc); ``amax``, so a tie splits its
    gradient as ``jnp.max``'s does."""
    helper = LayerHelper("maxout", name=name)

    def fn(ctx, a, groups):
        n, c, h, w = a.shape
        return torch.amax(a.reshape(n, c // groups, groups, h, w), dim=2)

    return helper.append_op(fn, {"X": [x]}, attrs={"groups": groups},
                            axes=(1,))


def _full(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``v`` in ``like``'s dtype on its device, filled
    there (a captured step copies nothing from the host)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def sampling_id(x: Variable, name=None):
    """One id per row drawn from the row's probabilities (ref:
    gserver/layers/SamplingIdLayer.cpp): ``jax.random.categorical`` of
    ``log(max(p, 1e-20))`` under the op's key (``ops/random.py``); x [N,
    C], int32 [N]."""
    helper = LayerHelper("sampling_id", name=name)
    tag = helper.main_program.next_rng_tag()

    def fn(ctx, a, _tag):
        if a.device.type == "meta":
            return torch.empty(a.shape[:-1], dtype=torch.int32,
                               device="meta")
        a = a.to(torch.float32)
        logp = torch.log(torch.maximum(a, _full(1e-20, a)))
        return jrandom.categorical(ctx.rng_key(_tag), logp,
                                   axis=-1).to(torch.int32)

    return helper.append_op(fn, {"X": [x]}, attrs={"_tag": tag},
                            axes=(-1,))


# --------------------------------------------------------------------------- losses


def sigmoid_cross_entropy_with_logits(x: Variable, label: Variable,
                                      name=None):
    """``max(x, 0) - x * label + log1p(exp(-|x|))`` (ref:
    paddle/operators/sigmoid_cross_entropy_with_logits_op.cc)."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)

    def fn(ctx, lg, lab):
        return (torch.maximum(lg, _full(0.0, lg)) - lg * lab
                + torch.log1p(torch.exp(-torch.abs(lg))))

    return helper.append_op(fn, {"X": [x], "Label": [label]})


def smooth_l1(x: Variable, y: Variable, sigma: float = 1.0):
    """Smooth L1 of x - y summed over the last dim (ref:
    paddle/operators/smooth_l1_loss_op.cc)."""
    helper = LayerHelper("smooth_l1")

    def fn(ctx, a, b, sigma):
        d = a - b
        s2 = sigma * sigma
        absd = torch.abs(d)
        out = torch.where(absd < 1.0 / s2, 0.5 * s2 * d * d,
                          absd - 0.5 / s2)
        return torch.sum(out, dim=-1, keepdim=True)

    return helper.append_op(fn, {"X": [x], "Y": [y]}, attrs={"sigma": sigma},
                            axes=(-1,))


def huber_loss(x, y, delta: float = 1.0):
    """ref: paddle/operators/huber_loss_op.cc."""
    helper = LayerHelper("huber_loss")

    def fn(ctx, a, b, delta):
        d = b - a
        absd = torch.abs(d)
        return torch.where(absd <= delta, 0.5 * d * d,
                           delta * (absd - 0.5 * delta))

    return helper.append_op(fn, {"X": [x], "Y": [y]}, attrs={"delta": delta})


def log_loss(input: Variable, label: Variable, epsilon: float = 1e-4):
    """ref: paddle/operators/log_loss_op.cc."""
    helper = LayerHelper("log_loss")

    def fn(ctx, p, lab, epsilon):
        return (-lab * torch.log(p + epsilon)
                - (1 - lab) * torch.log(1 - p + epsilon))

    return helper.append_op(fn, {"X": [input], "Label": [label]},
                            attrs={"epsilon": epsilon})


def hinge_loss(logits: Variable, label: Variable):
    """``max(0, 1 - (2 label - 1) logits)``, labels in {0, 1} (ref:
    paddle/operators/hinge_loss_op.cc)."""
    helper = LayerHelper("hinge_loss")

    def fn(ctx, lg, lab):
        y = 2.0 * lab - 1.0
        return torch.maximum(_full(0.0, lg), 1.0 - y * lg)

    return helper.append_op(fn, {"X": [logits], "Label": [label]})


def rank_loss(label: Variable, left: Variable, right: Variable):
    """RankNet's pairwise loss (ref: paddle/operators/rank_loss_op.cc)."""
    helper = LayerHelper("rank_loss")

    def fn(ctx, lab, l, r):
        d = l - r
        return torch.log1p(torch.exp(d)) - lab * d

    return helper.append_op(fn, {"Label": [label], "Left": [left],
                                 "Right": [right]})


def margin_rank_loss(label: Variable, left: Variable, right: Variable,
                     margin: float = 0.0):
    """ref: paddle/operators/margin_rank_loss_op.cc."""
    helper = LayerHelper("margin_rank_loss")

    def fn(ctx, lab, l, r, margin):
        return torch.maximum(_full(0.0, l), -lab * (l - r) + margin)

    return helper.append_op(fn, {"Label": [label], "X1": [left],
                                 "X2": [right]}, attrs={"margin": margin})


def cos_sim(x: Variable, y: Variable):
    """Row cosine similarity ``x.y / (|x| |y| + 1e-12)`` -> [N, 1] (ref:
    paddle/operators/cos_sim_op.cc)."""
    helper = LayerHelper("cos_sim")

    def fn(ctx, a, b):
        xn = torch.sqrt(torch.sum(a * a, dim=-1, keepdim=True))
        yn = torch.sqrt(torch.sum(b * b, dim=-1, keepdim=True))
        return torch.sum(a * b, dim=-1, keepdim=True) / (xn * yn + 1e-12)

    return helper.append_op(fn, {"X": [x], "Y": [y]},
                            axes=(-1,))


def squared_l2_norm(x: Variable):
    """``sum(x^2)`` as a [1] (ref: paddle/operators/squared_l2_norm_op.cc)."""
    helper = LayerHelper("squared_l2_norm")
    return helper.append_op(lambda ctx, a: torch.sum(torch.square(a))[None],
                            {"X": [x]})


def squared_l2_distance(x: Variable, y: Variable):
    """``sum((x - y)^2)`` over the last dim (ref:
    paddle/operators/squared_l2_distance_op.cc)."""
    helper = LayerHelper("squared_l2_distance")
    return helper.append_op(
        lambda ctx, a, b: torch.sum(torch.square(a - b), dim=-1,
                                    keepdim=True), {"X": [x], "Y": [y]},
                            axes=(-1,))


def modified_huber_loss(input: Variable, label: Variable, name=None):
    """Labels {0, 1} mapped to {-1, +1}; quadratic inside the margin,
    linear outside (ref: paddle/operators/modified_huber_loss_op.cc)."""
    helper = LayerHelper("modified_huber_loss", name=name)

    def fn(ctx, p, lab):
        y = 2.0 * lab.to(p.dtype) - 1.0
        z = p * y
        return torch.where(z < -1.0, -4.0 * z,
                           torch.maximum(_full(0.0, z), 1.0 - z) ** 2)

    return helper.append_op(fn, {"X": [input], "Y": [label]})


# --------------------------------------------------------------------------- metrics


def auc(input: Variable, label: Variable, curve: str = "ROC",
        num_thresholds: int = 200):
    """Batch AUC of the ROC or the PR curve, a trapezoid over
    ``num_thresholds`` thresholds ``arange(n) * float32(1 / (n - 1))``,
    which are ``jnp.linspace(0, 1, n)``'s values bit for bit (ref:
    paddle/operators/auc_op.cc); a [1]."""
    if curve not in ("ROC", "PR"):
        raise ValueError(f"auc: curve must be 'ROC' or 'PR', got {curve!r}")
    helper = LayerHelper("auc")

    def fn(ctx, p, lab, num_thresholds, curve):
        score = (p[:, 1] if p.dim() == 2 and p.shape[1] == 2
                 else p.reshape(-1))
        y = lab.reshape(-1).to(torch.float32)
        th = torch.arange(num_thresholds, dtype=torch.float32,
                          device=p.device)
        if num_thresholds > 1:
            th = th * float(np.float32(1.0 / (num_thresholds - 1)))
        pred = (score[None, :] >= th[:, None]).to(torch.float32)
        tp = torch.sum(pred * y[None, :], dim=1)
        fp = torch.sum(pred * (1 - y)[None, :], dim=1)
        pos = torch.sum(y) + 1e-8
        neg = torch.sum(1 - y) + 1e-8
        recall = tp / pos
        if curve == "PR":
            precision = tp / torch.maximum(tp + fp, _full(1e-8, tp))
            return torch.abs(torch.trapezoid(precision, recall))[None]
        return torch.abs(torch.trapezoid(recall, fp / neg))[None]

    return helper.append_op(fn, {"Out": [input], "Label": [label]},
                            attrs={"num_thresholds": num_thresholds,
                                   "curve": curve},
                            axes=(0,))


def precision_recall(input: Variable, label: Variable, num_classes: int,
                     name=None):
    """The batch's macro precision, recall and F1 over the classes that
    occur in the labels, a [3] (ref: paddle/operators/
    precision_recall_op.cc)."""
    helper = LayerHelper("precision_recall", name=name)

    def fn(ctx, p, lab, num_classes):
        cls = torch.arange(num_classes, device=p.device)
        oh_p = (torch.argmax(p, dim=-1).reshape(-1)[:, None] == cls).to(
            torch.float32)
        oh_y = (lab.reshape(-1).to(torch.int64)[:, None] == cls).to(
            torch.float32)
        tp = torch.sum(oh_p * oh_y, dim=0)
        fp = torch.sum(oh_p * (1 - oh_y), dim=0)
        fn_ = torch.sum((1 - oh_p) * oh_y, dim=0)
        support = torch.sum(oh_y, dim=0) > 0
        eps = _full(1e-8, tp)
        prec = torch.where(support, tp / torch.maximum(tp + fp, eps), 0.0)
        rec = torch.where(support, tp / torch.maximum(tp + fn_, eps), 0.0)
        nsup = torch.clamp_min(torch.sum(support), 1).to(torch.float32)
        mp = torch.sum(prec) / nsup
        mr = torch.sum(rec) / nsup
        f1 = 2 * mp * mr / torch.maximum(mp + mr, eps)
        return torch.stack([mp, mr, f1])

    return helper.append_op(fn, {"MaxProbs": [input], "Labels": [label]},
                            attrs={"num_classes": num_classes},
                            axes=(0,))


def positive_negative_pair(score: Variable, label: Variable,
                           query_id: Variable, name=None):
    """Within each query, the pairs of higher label ordered right and
    wrong by score, a tie counting half to each: [3] = (negative pairs,
    positive pairs, positive / (positive + negative)) (ref:
    paddle/operators/positive_negative_pair_op.cc)."""
    helper = LayerHelper("positive_negative_pair", name=name)

    def fn(ctx, s, lab, qid):
        s = s.reshape(-1)
        y = lab.reshape(-1).to(s.dtype)
        q = qid.reshape(-1)
        valid = (q[:, None] == q[None, :]) & (y[:, None] > y[None, :])
        pos = torch.sum(valid & (s[:, None] > s[None, :])).to(s.dtype)
        neg = torch.sum(valid & (s[:, None] < s[None, :])).to(s.dtype)
        ties = torch.sum(valid & (s[:, None] == s[None, :])).to(s.dtype)
        posf = pos + 0.5 * ties
        negf = neg + 0.5 * ties
        ratio = posf / torch.maximum(posf + negf, _full(1e-8, posf))
        return torch.stack([negf, posf, ratio])

    return helper.append_op(fn, {"Score": [score], "Label": [label],
                                 "QueryID": [query_id]},
                            axes=(0,))


# --------------------------------------------------------------------------- misc ops


def _param_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a parameter (2-D, or 1-D as a column) through
    ``F.embedding``: its backward adds in a fixed order on the card, where
    advanced indexing's adds with atomics (a warmed step's replay must be
    bitwise its eager step)."""
    if table.dim() == 1:
        return F.embedding(ids, table[:, None])[..., 0]
    return F.embedding(ids, table)


def bilinear_tensor_product(x: Variable, y: Variable, size: int,
                            param_attr=None, bias_attr=None, act=None,
                            name=None):
    """``out[:, k] = x W_k y^T + b`` (ref:
    paddle/operators/bilinear_tensor_product_op.cc)."""
    helper = LayerHelper("bilinear_tensor_product", name=name)
    dx, dy = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(param_attr, [size, dx, dy], x.dtype)
    out = helper.append_op(
        lambda ctx, a, b, wv: torch.einsum("ni,kij,nj->nk", a, wv, b),
        {"X": [x], "Y": [y], "W": [w]})
    if bias_attr is not False:
        bias = helper.create_parameter(bias_attr, [size], out.dtype,
                                       is_bias=True)
        out = helper.append_op(lambda ctx, a, bv: a + bv,
                               {"X": [out], "B": [bias]},
                               op_type="elementwise_add")
    return helper.append_activation(out, act)


def conv_shift(x: Variable, y: Variable, name=None):
    """Circular convolution (ref: paddle/operators/conv_shift_op.cc):
    ``out[i, j] = sum_k x[i, (j + k - M // 2) mod N] * y[i, k]``, y's width
    M odd and at most N.  The shifted windows are an ``unfold`` of x padded
    circularly, whose backward is a fixed-order sum."""
    helper = LayerHelper("conv_shift", name=name)

    def fn(ctx, a, b):
        big_n, m = a.shape[1], b.shape[1]
        half = m // 2
        padded = torch.cat([a[:, big_n - half:], a, a[:, :m - 1 - half]],
                           dim=1)
        return torch.einsum("njk,nk->nj", padded.unfold(1, m, 1), b)

    return helper.append_op(fn, {"X": [x], "Y": [y]},
                            axes=(-1,))


def nce(input: Variable, label: Variable, num_total_classes: int,
        num_neg_samples: int = 10, param_attr=None, bias_attr=None,
        name=None):
    """Noise-contrastive estimation with uniform noise, the per-example
    loss [N, 1] (ref: paddle/operators/nce_op.cc): the negatives are
    ``jax.random.randint(key, (N, num_neg_samples), 0, num_total_classes)``
    of the op's key (``ops/random.py``), bitwise, and the noise log
    probability is ``log(num_neg_samples / num_total_classes)``."""
    helper = LayerHelper("nce", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_total_classes, dim],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [num_total_classes], input.dtype,
                                is_bias=True)
    tag = helper.main_program.next_rng_tag()

    def fn(ctx, a, lab, wv, bv, n_neg, n_cls, tag):
        nrows = a.shape[0]
        if a.device.type == "meta":
            neg = torch.zeros((nrows, n_neg), dtype=torch.int64,
                              device="meta")
        else:
            neg = jrandom.randint(ctx.rng_key(tag), (nrows, n_neg), 0,
                                  n_cls, a.device).to(torch.int64)
        ids = torch.cat([lab.reshape(-1, 1).to(torch.int64), neg], dim=1)
        logits = (torch.einsum("nd,nsd->ns", a, _param_rows(wv, ids))
                  + _param_rows(bv, ids))
        log_pn = torch.log(_full(n_neg / n_cls, a))
        delta = logits - log_pn
        pos = F.logsigmoid(delta[:, 0])
        negs = torch.sum(F.logsigmoid(-delta[:, 1:]), dim=1)
        return (-(pos + negs))[:, None]

    return helper.append_op(
        fn, {"Input": [input], "Label": [label], "W": [w], "B": [b]},
        attrs={"n_neg": num_neg_samples, "n_cls": num_total_classes,
               "tag": tag},
                            axes=(-1,))


def hsigmoid(input: Variable, label: Variable, num_classes: int,
             param_attr=None, bias_attr=None, name=None):
    """Hierarchical sigmoid over a complete binary tree (ref: v1
    gserver/layers/HierarchicalSigmoidLayer.cpp): class c is heap node c +
    num_classes (root 1), the loss the sum of binary cross-entropies along
    the root-to-leaf path; every path is unrolled to ``bit_length(C)``
    steps with a validity mask.  The per-example loss [N, 1]."""
    helper = LayerHelper("hsigmoid", name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, [num_classes - 1, dim],
                                input.dtype)
    b = helper.create_parameter(bias_attr, [num_classes - 1], input.dtype,
                                is_bias=True)
    max_depth = int(num_classes).bit_length()

    def fn(ctx, x, lab, wv, bv, n_cls, max_depth):
        code = lab.reshape(-1).to(torch.int64) + n_cls      # leaf heap id
        ks = torch.arange(1, max_depth + 1, device=x.device)
        # path length = floor(log2(code)), by integer compares
        length = torch.sum(code[:, None] >= (1 << ks)[None, :], dim=1)
        s = torch.arange(max_depth, device=x.device)
        shift = length[:, None] - s[None, :]                # [N, D]
        valid = shift > 0
        node = code[:, None] >> shift.clamp(0, 31)          # ancestor at s
        bit = (code[:, None] >> (shift - 1).clamp(0, 31)) & 1
        idx = (node - 1).clamp(0, n_cls - 2)                # internal row
        logits = (torch.einsum("nd,nsd->ns", x, _param_rows(wv, idx))
                  + _param_rows(bv, idx))
        # jax.nn.softplus is logaddexp(x, 0)
        bce = (torch.logaddexp(logits, torch.zeros_like(logits))
               - bit.to(logits.dtype) * logits)
        return torch.sum(bce * valid.to(logits.dtype), dim=1)[:, None]

    return helper.append_op(
        fn, {"X": [input], "Label": [label], "W": [w], "B": [b]},
        attrs={"n_cls": num_classes, "max_depth": max_depth},
                            axes=(-1,))


# ------------------------------------------------------- v1 misc layer parity


def _per_row(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.reshape((-1,) + (1,) * (like.dim() - 1))


def scaling(x: Variable, weight: Variable, name=None):
    """``out[i] = weight[i] * x[i]`` (ref: v1 ScalingLayer.cpp)."""
    helper = LayerHelper("scaling", name=name)
    return helper.append_op(lambda ctx, a, w: a * _per_row(w, a),
                            {"X": [x], "Weight": [weight]})


def interpolation(x: Variable, y: Variable, weight: Variable, name=None):
    """``w * x + (1 - w) * y`` with a per-row w (ref: v1
    InterpolationLayer.cpp)."""
    helper = LayerHelper("interpolation", name=name)

    def fn(ctx, a, b, w):
        w = _per_row(w, a)
        return w * a + (1.0 - w) * b

    return helper.append_op(fn, {"X": [x], "Y": [y], "Weight": [weight]})


def power(x: Variable, weight: Variable, name=None):
    """``x[i] ** w[i]`` with a per-row exponent (ref: v1 PowerLayer.cpp)."""
    helper = LayerHelper("power", name=name)
    return helper.append_op(lambda ctx, a, w: a ** _per_row(w, a),
                            {"X": [x], "Weight": [weight]})


def slope_intercept(x: Variable, slope: float = 1.0, intercept: float = 0.0,
                    name=None):
    """``slope * x + intercept`` (ref: v1 SlopeInterceptLayer.cpp)."""
    helper = LayerHelper("slope_intercept", name=name)
    return helper.append_op(lambda ctx, a, s, b: a * s + b, {"X": [x]},
                            attrs={"s": slope, "b": intercept})


def sum_to_one_norm(x: Variable, name=None):
    """Rows divided by their sums; a sum within 1e-12 of 0 reads 1e-12
    (ref: v1 SumToOneNormLayer.cpp)."""
    helper = LayerHelper("sum_to_one_norm", name=name)

    def fn(ctx, a):
        s = torch.sum(a, dim=-1, keepdim=True)
        return a / torch.where(torch.abs(s) < 1e-12, 1e-12, s)

    return helper.append_op(fn, {"X": [x]},
                            axes=(-1,))


def linear_comb(x: Variable, weight: Variable, size: int, name=None):
    """x [N, K * size], weight [N, K] -> the weighted sum of the K
    sub-vectors, [N, size] (ref: v1 LinearCombinationLayer)."""
    helper = LayerHelper("linear_comb", name=name)

    def fn(ctx, a, w, size):
        k = a.shape[-1] // size
        return torch.einsum("nk,nkd->nd", w, a.reshape(a.shape[0], k, size))

    return helper.append_op(fn, {"X": [x], "Weight": [weight]},
                            attrs={"size": size},
                            axes=(-1,))


def out_prod(x: Variable, y: Variable, name=None):
    """Row-wise outer product: [N, A], [N, B] -> [N, A * B] (ref: v1
    OuterProdLayer.cpp)."""
    helper = LayerHelper("out_prod", name=name)
    return helper.append_op(
        lambda ctx, a, b: (a[:, :, None] * b[:, None, :]).reshape(
            a.shape[0], -1), {"X": [x], "Y": [y]})


def repeat(x: Variable, num_repeats: int, as_row_vector: bool = True,
           name=None):
    """The features repeated ``num_repeats`` times along dim 1: the whole
    row tiled (``as_row_vector``, the reference's default) or each element
    in turn (ref: v1 FeatureMapExpandLayer / RepeatLayer)."""
    helper = LayerHelper("repeat", name=name)

    def fn(ctx, a, r, row):
        if row:
            return torch.tile(a, (1, r) + (1,) * (a.dim() - 2))
        return torch.repeat_interleave(a, r, dim=1)

    return helper.append_op(fn, {"X": [x]},
                            attrs={"r": num_repeats, "row": as_row_vector},
                            axes=(1,))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image``'s triangle weights [n_in, n_out] for one dim
    (``compute_weight_mat`` with scale n_out / n_in, translation 0 and
    antialiasing): half-pixel centres, and the kernel widened by n_in /
    n_out when the dim shrinks.  float32 on ``device``, built there."""
    scale = float(np.float32(n_out / n_in))
    inv = float(np.float32(1.0) / np.float32(scale))
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.abs(sample[None, :] - src[:, None]) / kernel_scale
    w = torch.clamp_min(1 - torch.abs(x), 0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def bilinear_interp(input: Variable, out_h: int, out_w: int, name=None):
    """Bilinear resize of NCHW images to ``out_h`` x ``out_w`` as
    ``jax.image.resize(method="bilinear")`` computes it: half-pixel
    centres and, where a dim shrinks, the antialiasing triangle filter
    (``F.interpolate(align_corners=False)`` matches it only where a dim
    grows); a dim that keeps its size is left alone (ref: v1
    BilinearInterpLayer.cpp)."""
    helper = LayerHelper("bilinear_interp", name=name)

    def fn(ctx, a, out_h, out_w):
        if a.shape[2] != out_h:
            wh = _resize_weights(a.shape[2], out_h, a.device).to(a.dtype)
            a = torch.einsum("nchw,ho->ncow", a, wh)
        if a.shape[3] != out_w:
            ww = _resize_weights(a.shape[3], out_w, a.device).to(a.dtype)
            a = torch.einsum("nchw,wp->nchp", a, ww)
        return a

    return helper.append_op(fn, {"X": [input]},
                            attrs={"out_h": out_h, "out_w": out_w})


def selective_fc(x: Variable, select: Variable, size: int, param_attr=None,
                 bias_attr=None, act: Optional[str] = None, name=None):
    """A fully connected layer whose unselected outputs are zero: ``(x W +
    b) * select``, select [N, size] in {0, 1} (ref: v1
    SelectiveFullyConnectedLayer)."""
    helper = LayerHelper("selective_fc", name=name)
    w = helper.create_parameter(param_attr, [x.shape[-1], size], x.dtype)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], x.dtype, is_bias=True)
        out = helper.append_op(
            lambda ctx, a, sel, wv, bv: (a @ wv + bv) * sel.to(a.dtype),
            {"X": [x], "Select": [select], "W": [w], "B": [b]})
    else:
        out = helper.append_op(
            lambda ctx, a, sel, wv: (a @ wv) * sel.to(a.dtype),
            {"X": [x], "Select": [select], "W": [w]})
    return helper.append_activation(out, act)


__all__ = ["accuracy", "auc", "batch_norm", "bilinear_interp",
           "bilinear_tensor_product", "conv2d", "conv2d_transpose", "conv3d",
           "conv_shift", "cos_sim", "cross_entropy", "dropout", "embedding",
           "fc", "hinge_loss", "hsigmoid", "huber_loss", "interpolation",
           "layer_norm", "linear_comb", "log_loss", "lrn", "margin_rank_loss",
           "maxout", "modified_huber_loss", "nce", "out_prod", "pool2d",
           "pool3d", "pool_with_index", "positive_negative_pair", "power",
           "precision_recall", "rank_loss", "repeat", "sampling_id",
           "scaling", "selective_fc", "sigmoid_cross_entropy_with_logits",
           "slope_intercept", "smooth_l1", "softmax_with_cross_entropy",
           "spp", "square_error_cost", "squared_l2_distance",
           "squared_l2_norm", "sum_to_one_norm", "unpool"]
