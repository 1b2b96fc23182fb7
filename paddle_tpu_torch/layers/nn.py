"""Neural-network layers (PyTorch port of the ``paddle_tpu/layers/nn.py``
subset the training slices use): fc, embedding, layer_norm,
softmax_with_cross_entropy, cross_entropy and accuracy.

Numerics follow the JAX package: layer_norm takes float32 statistics with
``var = max(E[x^2] - mu^2, 0)`` (not the serving layer norm's population
variance); gathers convert int32 ids to int64 at the gather, since feeds
keep their declared int32.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.program import Variable
from ..initializer import Constant, Normal
from .helper import LayerHelper

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


__all__ = ["accuracy", "cross_entropy", "embedding", "fc", "layer_norm",
           "softmax_with_cross_entropy"]
