"""Composite networks (PyTorch port of ``paddle_tpu/nets.py``, all 14 of its
functions under the same names and parameters; ref:
python/paddle/v2/fluid/nets.py and v1 trainer_config_helpers/networks.py).

Each is a composition of the port's layers, so each runs what those layers
run: ``simple_lstm`` / ``bidirectional_lstm`` the LSTM kernels
(``dynamic_lstm``), ``img_conv_group`` and ``img_conv_bn_pool`` with batch
norm the batch-norm backward kernels in a training program, and a pruned
program's 3x3 stride-1 convolutions the conv kernels (``core/fusion.py``;
the depthwise conv of ``img_separable_conv`` has groups > 1 and stays on
``F.conv2d``).  ``scaled_dot_product_attention`` is one op whose body
calls ``ops.flash_attention`` (the flash kernels on the card) when the
value head width equals the key head width, and the reference's own einsum
and softmax otherwise.  ``simple_attention`` adds its two projections with
the Variable ``+``, as the reference does (``elementwise_add``)."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from . import layers
from .layers.helper import LayerHelper
from .ops.attention import flash_attention


def simple_img_conv_pool(input, num_filters: int, filter_size, pool_size,
                         pool_stride, act: Optional[str] = None,
                         pool_type: str = "max", param_attr=None):
    """conv2d + pool2d (ref: fluid/nets.py:6)."""
    conv = layers.conv2d(input, num_filters, filter_size, act=act,
                         param_attr=param_attr)
    return layers.pool2d(conv, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter: Sequence[int], pool_size,
                   conv_padding: Union[int, Sequence[int]] = 1,
                   conv_filter_size: Union[int, Sequence[int]] = 3,
                   conv_act: Optional[str] = None,
                   conv_with_batchnorm: Union[bool, Sequence[bool]] = False,
                   conv_batchnorm_drop_rate: Union[float, Sequence[float]] = 0.0,
                   pool_stride=1, pool_type: str = "max"):
    """Stacked convs, each with an optional batch norm and dropout, then one
    pool: the VGG building block (ref: fluid/nets.py:29)."""
    n = len(conv_num_filter)

    def per(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n

    paddings, fsizes = per(conv_padding), per(conv_filter_size)
    with_bn = per(conv_with_batchnorm)
    drop = per(conv_batchnorm_drop_rate)
    tmp = input
    for i in range(n):
        tmp = layers.conv2d(tmp, conv_num_filter[i], fsizes[i],
                            padding=paddings[i],
                            act=None if with_bn[i] else conv_act)
        if with_bn[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if drop[i] > 0:
                tmp = layers.dropout(tmp, dropout_prob=drop[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, length, num_filters: int, filter_size: int,
                       act: str = "sigmoid", pool_type: str = "max"):
    """sequence_conv + sequence_pool, the text-classification backbone
    (ref: fluid/nets.py:86)."""
    conv = layers.sequence_conv(input, length, num_filters, filter_size,
                                act=act)
    return layers.sequence_pool(conv, length, pool_type=pool_type)


def simple_lstm(input, length, size: int, act: str = "tanh",
                is_reverse: bool = False, use_peepholes: bool = True):
    """An fc projection (no bias) + dynamic_lstm (ref: networks.py:632);
    ``act`` is the cell and candidate activation.  Returns (hidden [B, T,
    size], cell)."""
    proj = layers.fc(input, 4 * size, num_flatten_dims=2, bias_attr=False)
    return layers.dynamic_lstm(proj, length, size, is_reverse=is_reverse,
                               use_peepholes=use_peepholes,
                               cell_activation=act, candidate_activation=act)


def simple_gru(input, length, size: int, is_reverse: bool = False):
    """An fc projection (no bias) + dynamic_gru (ref: networks.py:1076).
    Returns hidden [B, T, size]."""
    proj = layers.fc(input, 3 * size, num_flatten_dims=2, bias_attr=False)
    hs, _ = layers.dynamic_gru(proj, length, size, is_reverse=is_reverse)
    return hs


def bidirectional_lstm(input, length, size: int,
                       return_concat: bool = True):
    """Forward and backward simple_lstm, concatenated feature-wise, or the
    pair (ref: networks.py:1310)."""
    fwd, _ = simple_lstm(input, length, size, is_reverse=False)
    bwd, _ = simple_lstm(input, length, size, is_reverse=True)
    if return_concat:
        return layers.concat([fwd, bwd], axis=2)
    return fwd, bwd


def bidirectional_gru(input, length, size: int, return_concat: bool = True):
    """Forward and backward simple_gru (ref: networks.py:1226)."""
    fwd = simple_gru(input, length, size, is_reverse=False)
    bwd = simple_gru(input, length, size, is_reverse=True)
    if return_concat:
        return layers.concat([fwd, bwd], axis=2)
    return fwd, bwd


def img_conv_bn_pool(input, num_filters: int, filter_size, pool_size,
                     pool_stride, act: Optional[str] = None,
                     pool_type: str = "max", dropout_rate: float = 0.0):
    """conv2d (padding 0) + batch_norm + optional dropout + pool2d (ref:
    networks.py:231)."""
    conv = layers.conv2d(input, num_filters, filter_size, act=None)
    bn = layers.batch_norm(conv, act=act)
    if dropout_rate > 0:
        bn = layers.dropout(bn, dropout_prob=dropout_rate)
    return layers.pool2d(bn, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def img_separable_conv(input, num_channels: int, num_out_channels: int,
                       filter_size, stride=1, padding=0,
                       depth_multiplier: int = 1, act: Optional[str] = None):
    """Depthwise conv (groups = in-channels) + pointwise 1x1 conv (ref:
    networks.py:439)."""
    depthwise = layers.conv2d(input, num_channels * depth_multiplier,
                              filter_size, stride=stride, padding=padding,
                              groups=num_channels, act=None)
    return layers.conv2d(depthwise, num_out_channels, 1, act=act)


def dot_product_attention(encoded_sequence, encoded_lengths,
                          transformed_state):
    """softmax(<state, enc_t>) over the valid steps, and the context
    (ref: networks.py:1498).  encoded_sequence [B, T, D], transformed_state
    [B, D] -> (context [B, D], weights [B, T])."""
    T = encoded_sequence.shape[1]
    scores = layers.reshape(
        layers.matmul(encoded_sequence,
                      layers.unsqueeze(transformed_state, [2])), [-1, T])
    w = layers.sequence_softmax(scores, encoded_lengths)
    ctx = layers.reduce_sum(
        layers.elementwise_mul(encoded_sequence,
                               layers.reshape(w, [-1, T, 1])), dim=1)
    return ctx, w


def multi_head_attention(query, key, value, key_proj_size: int,
                         value_proj_size: int, head_num: int,
                         out_size: Optional[int] = None):
    """Multi-head attention with learned q/k/v projections, heads attended
    by ``scaled_dot_product_attention``, then an output projection (ref:
    networks.py:1580).  query [B, Tq, Dq], key and value [B, Tk, Dk] ->
    [B, Tq, out_size]."""
    assert key_proj_size % head_num == 0
    assert value_proj_size % head_num == 0
    q = layers.fc(query, key_proj_size, num_flatten_dims=2, bias_attr=False)
    k = layers.fc(key, key_proj_size, num_flatten_dims=2, bias_attr=False)
    v = layers.fc(value, value_proj_size, num_flatten_dims=2,
                  bias_attr=False)
    attended = scaled_dot_product_attention(q, k, v, num_heads=head_num)
    return layers.fc(attended, out_size or value_proj_size,
                     num_flatten_dims=2, bias_attr=False)


def glu(input, dim: int = -1):
    """Gated linear unit: halves a and b along ``dim``, a * sigmoid(b)."""
    a, b = layers.split(input, 2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def simple_attention(encoded_sequence, encoded_lengths, decoder_state,
                     attention_size: Optional[int] = None):
    """Additive (Bahdanau) attention over a padded encoder sequence (ref: v1
    networks.py simple_attention): encoded_sequence [N, T, H],
    decoder_state [N, D] -> context [N, H], padding steps masked out of the
    softmax."""
    H = encoded_sequence.shape[-1]
    T = encoded_sequence.shape[1]
    attention_size = attention_size or H
    dec_proj = layers.fc(decoder_state, attention_size, bias_attr=False)
    enc_proj = layers.fc(encoded_sequence, attention_size,
                         num_flatten_dims=2, bias_attr=False)
    expanded = layers.sequence_expand(dec_proj, encoded_lengths, max_len=T)
    e = layers.fc(layers.tanh(enc_proj + expanded), 1,
                  num_flatten_dims=2, bias_attr=False)
    e = layers.reshape(e, [-1, T])
    w = layers.sequence_softmax(e, encoded_lengths)
    return layers.reduce_sum(
        layers.elementwise_mul(encoded_sequence,
                               layers.reshape(w, [-1, T, 1])), dim=1)


def scaled_dot_product_attention(queries, keys, values, num_heads: int = 1):
    """Multi-head scaled dot-product attention over dense [N, T, D]
    tensors, one op of type ``scaled_dot_product_attention``: queries and
    keys split into heads of D / num_heads, values into heads of Dv /
    num_heads.  With equal head widths the heads go through
    ``ops.flash_attention`` (non-causal, scale head_dim^-0.5; on CUDA
    tensors the flash kernels, which ``Executor.run`` checks first:
    ``check_kernel_shapes``); with unequal ones through the reference's
    einsum and softmax."""
    assert queries.shape[-1] % num_heads == 0
    assert values.shape[-1] % num_heads == 0
    helper = LayerHelper("scaled_dot_product_attention")

    def fn(ctx, q, k, v, num_heads):
        N, Tq, D = q.shape
        Tk, Dv = k.shape[1], v.shape[2]
        hd, hv = D // num_heads, Dv // num_heads
        qh = q.reshape(N, Tq, num_heads, hd).transpose(1, 2)
        kh = k.reshape(N, Tk, num_heads, hd).transpose(1, 2)
        vh = v.reshape(N, Tk, num_heads, hv).transpose(1, 2)
        if hv == hd:
            out = flash_attention(qh, kh, vh)
        else:
            s = torch.einsum("nhqd,nhkd->nhqk", qh, kh) * (hd ** -0.5)
            out = torch.einsum("nhqk,nhkv->nhqv", torch.softmax(s, -1), vh)
        return out.transpose(1, 2).reshape(N, Tq, Dv)

    return helper.append_op(fn, {"Q": [queries], "K": [keys], "V": [values]},
                            attrs={"num_heads": num_heads})


__all__ = ["bidirectional_gru", "bidirectional_lstm", "dot_product_attention",
           "glu", "img_conv_bn_pool", "img_conv_group", "img_separable_conv",
           "multi_head_attention", "scaled_dot_product_attention",
           "sequence_conv_pool", "simple_attention", "simple_gru",
           "simple_img_conv_pool", "simple_lstm"]
