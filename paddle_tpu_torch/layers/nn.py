"""Neural-network layers (PyTorch port of the ``paddle_tpu/layers/nn.py``
subset the training slices use): fc, embedding, conv2d,
conv2d_transpose, conv3d, pool2d, pool3d, pool_with_index, unpool, spp,
batch_norm, layer_norm, lrn, dropout, softmax_with_cross_entropy,
cross_entropy, square_error_cost and accuracy.

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

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.program import Op, Variable
from ..initializer import Constant, Normal, Xavier
from ..ops.batch_norm import batch_norm_train
from ..ops.dropout import threefry_dropout
from .helper import LayerHelper


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
    for x, pattr in zip(inputs, param_attrs):
        in_features = int(np.prod([d for d in x.shape[num_flatten_dims:]]))
        w = helper.create_parameter(pattr, [in_features, size], x.dtype)

        def fn(ctx, a, wv, num_flatten_dims):
            am = a.reshape(tuple(a.shape[:num_flatten_dims]) + (-1,))
            flat = am.reshape((-1, am.shape[-1]))
            out = flat @ wv
            return out.reshape(tuple(am.shape[:-1]) + (size,))

        partials.append(
            helper.append_op(fn, {"Input": [x], "W": [w]},
                             attrs={"num_flatten_dims": num_flatten_dims}, op_type="mul")
        )
    out = partials[0]
    if len(partials) > 1:
        from .tensor import sums

        out = sums(partials)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], out.dtype, is_bias=True)
        out = helper.append_op(lambda ctx, a, bv: a + bv, {"X": [out], "B": [b]},
                               op_type="elementwise_add")
    return helper.append_activation(out, act)


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
    """Lookup table: the dense gather; rows of ``padding_idx`` read as zeros
    (and so get no gradient).  ``is_sparse`` routes through the sparse
    engine in the JAX package, which is not ported yet."""
    if is_sparse:
        raise NotImplementedError(
            "embedding(is_sparse=True) is not ported yet: the sparse engine "
            "is ROADMAP A.8")
    helper = LayerHelper("embedding", name=name)
    table = helper.create_parameter(
        param_attr, list(size), dtype, default_initializer=Normal(0.0, 0.02)
    )

    def fn(ctx, ids, tab, padding_idx, is_sparse):
        if ids.dim() >= 2 and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        ids = ids.long()
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

    def fn(ctx, a, sc, bs, mu, var, is_test, momentum, epsilon, ch_axis):
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
        out, bmean, bvar = batch_norm_train(
            a if axis == 1 else a.movedim(axis, 1), sc, bs, epsilon)
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
                                           "epsilon": epsilon})
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
                                   "beta": beta})


# --------------------------------------------------------------------------- losses


def softmax_with_cross_entropy(logits: Variable, label: Variable, soft_label: bool = False,
                               return_softmax: bool = False):
    """Fused log-softmax and cross entropy; hard labels [..., 1] (or [...])
    are int ids, gathered as int64."""
    helper = LayerHelper("softmax_with_cross_entropy")

    def fn(ctx, lg, lab, soft_label, return_softmax):
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
                            n_outputs=2 if return_softmax else 1)
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
                            attrs={"soft_label": soft_label})


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

    def fn(ctx, a, dropout_prob, is_test, _tag):
        if is_test:
            scale = torch.tensor(1.0 - dropout_prob,
                                 dtype=torch.float64).to(a.dtype).item()
            return a * scale
        return threefry_dropout(a, ctx.rng_key(_tag), dropout_prob)

    return helper.append_op(fn, {"X": [x]},
                            attrs={"dropout_prob": dropout_prob,
                                   "is_test": is_test, "_tag": tag})


# --------------------------------------------------------------------------- metrics


def accuracy(input: Variable, label: Variable, k: int = 1, name=None):
    """Top-k accuracy of a batch, a [1] float32.  ``jax.lax.top_k`` puts
    the lower index first among equal values; ``torch.topk`` leaves the
    order of ties unspecified, so the top k come from a stable descending
    sort, which keeps JAX's order."""
    helper = LayerHelper("accuracy", name=name)

    def fn(ctx, p, lab, k):
        topi = torch.sort(p, dim=-1, descending=True, stable=True).indices
        ids = lab.squeeze(-1) if lab.dim() == p.dim() else lab
        correct = torch.any(topi[..., :k] == ids[..., None].long(), dim=-1)
        return torch.mean(correct.to(torch.float32))[None]

    return helper.append_op(fn, {"Out": [input], "Label": [label]},
                            attrs={"k": k})


__all__ = ["accuracy", "batch_norm", "conv2d", "conv2d_transpose", "conv3d",
           "cross_entropy", "dropout", "embedding", "fc", "layer_norm", "lrn",
           "pool2d", "pool3d", "pool_with_index", "softmax_with_cross_entropy",
           "spp", "square_error_cost", "unpool"]
