"""The tail-parity v1 layers (PyTorch port of ``paddle_tpu/layers/misc.py``):
the last of the reference's gserver layers, each a few plain torch ops.

Differences from torch's own forms that the port takes JAX's side of:
``kmax_seq_score`` is ``lax.top_k`` over ``-inf``-masked scores, the lower
index first among ties (the masked tail too, where k exceeds a length),
as a stable descending sort gives it, and its output is int32;
``cross_channel_norm`` adds 1e-12 after the square root of a float32 sum
of squares, ``l2_normalize`` adds its epsilon inside the root and
``cos_sim_vec_mat`` 1e-12 after the product of the norms; ``rotate`` is
``flip(swapaxes(-1, -2), -2)``; ``scale_sub_region`` takes 1-based
inclusive indices.  ``data_norm``'s statistics are numpy constants,
turned into its offsets and divisors on the host and moved to a device
once, outside any capture.  ``Print`` prints on the host
every time its op runs, its header plain text; a CUDA graph cannot call
the host, so ``Executor.warm`` refuses a program that holds one
(``core/executor.py::check_capturable``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.program import Variable
from ..initializer import Constant
from .helper import LayerHelper


def _moved(arrays: dict):
    """``arrays`` (name -> numpy array or None) as a function of an operand
    ``a``: the tensors on ``a``'s device in ``a``'s dtype, moved once per
    device and dtype."""
    cache = {}

    def get(a):
        key = (a.device, a.dtype)
        if key not in cache:
            cache[key] = {k: None if v is None else
                          torch.as_tensor(v, dtype=a.dtype, device=a.device)
                          for k, v in arrays.items()}
        return cache[key]

    return get


def cos_sim_vec_mat(vec: Variable, mat: Variable, cos_scale: float = 1.0,
                    name=None):
    """Cosine similarity between a vector and each row of a per-sample
    matrix (ref: gserver/layers/CosSimVecMatLayer.cpp).  vec: [N, D]; mat:
    [N, K*D] viewed as K rows of D; out: [N, K]."""
    helper = LayerHelper("cos_sim_vec_mat", name=name)
    d = int(vec.shape[-1])

    def fn(ctx, v, m, d, cos_scale):
        rows = m.reshape(m.shape[0], -1, d)                      # [N, K, D]
        num = torch.einsum("nd,nkd->nk", v, rows)
        den = (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
               * torch.linalg.vector_norm(rows, dim=-1) + 1e-12)
        return cos_scale * num / den

    return helper.append_op(fn, {"X": [vec], "Y": [mat]},
                            attrs={"d": d, "cos_scale": cos_scale},
                            axes=(-1,))


def cross_channel_norm(x: Variable, param_attr=None, name=None):
    """Per-position L2 normalisation across channels with a learned
    per-channel scale (ref: gserver/layers/CrossChannelNormLayer.cpp, SSD's
    Norm layer).  x: [N, C, H, W]."""
    helper = LayerHelper("cross_channel_norm", name=name)
    c = int(x.shape[1])
    scale = helper.create_parameter(param_attr, [c], x.dtype,
                                    default_initializer=Constant(1.0))

    def fn(ctx, a, sc):
        norm = torch.sqrt(torch.sum(torch.square(a.float()), dim=1,
                                    keepdim=True)) + 1e-12
        return (a / norm.to(a.dtype)) * sc.reshape(1, -1, 1, 1).to(a.dtype)

    return helper.append_op(fn, {"X": [x], "Scale": [scale]},
                            axes=(1,))


def data_norm(x: Variable, strategy: str = "z-score", mean=None, std=None,
              min_val=None, max_val=None, name=None):
    """Normalise inputs with dataset statistics (ref:
    gserver/layers/DataNormLayer.h: z-score, min-max, decimal-scaling).
    The statistics are numpy arrays; the offsets and divisors are computed
    from them in numpy float32, as the reference's numpy arithmetic gives
    them (the decimal-scaling exponent in torch's float32), and moved to a
    device once."""
    helper = LayerHelper("data_norm", name=name)

    def f32(v):
        return None if v is None else np.asarray(v, "float32")

    mean, std, lo, hi = f32(mean), f32(std), f32(min_val), f32(max_val)
    if strategy == "z-score":
        consts = {"sub": mean, "div": std + 1e-12}
    elif strategy == "min-max":
        consts = {"sub": lo, "div": hi - lo + 1e-12}
    elif strategy == "decimal-scaling":
        if hi is None:
            raise ValueError("data_norm decimal-scaling needs max_val")
        # per-feature smallest j with max(|x_f|) / 10^j < 1, in torch's
        # float32 log10 on the host (numpy's reads log10(100) as 2.0000002,
        # where XLA's and torch's read 2)
        j = torch.ceil(torch.log10(torch.clamp_min(
            torch.from_numpy(np.abs(hi)), 1e-12)))
        consts = {"sub": None,
                  "div": (10.0 ** torch.clamp_min(j, 0.0)).numpy()}
    else:
        raise ValueError(f"unknown data_norm strategy {strategy!r}")
    get = _moved(consts)

    def fn(ctx, a, strategy):
        c = get(a)
        return (a if c["sub"] is None else a - c["sub"]) / c["div"]

    return helper.append_op(fn, {"X": [x]}, attrs={"strategy": strategy})


def eos_check(ids: Variable, eos_id: int, name=None):
    """1.0 where the id equals the end-of-sequence id (ref:
    gserver/layers/EosIdCheckLayer.cpp)."""
    helper = LayerHelper("eos_check", name=name)

    def fn(ctx, a, eos_id):
        return (a == eos_id).to(torch.float32)

    return helper.append_op(fn, {"X": [ids]}, attrs={"eos_id": eos_id})


def factorization_machine(x: Variable, factor_size: int, param_attr=None,
                          name=None):
    """Second-order FM interaction score (ref:
    gserver/layers/FactorizationMachineLayer.cpp):
    y = 0.5 * sum_f((x V)^2 - (x^2)(V^2)).  x: [N, D] -> [N, 1]."""
    helper = LayerHelper("factorization_machine", name=name)
    d = int(x.shape[-1])
    v = helper.create_parameter(param_attr, [d, factor_size], x.dtype)

    def fn(ctx, a, vv):
        s1 = torch.square(a @ vv)                     # [N, F]
        s2 = torch.square(a) @ torch.square(vv)       # [N, F]
        return 0.5 * torch.sum(s1 - s2, dim=-1, keepdim=True)

    return helper.append_op(fn, {"X": [x], "V": [v]},
                            axes=(-1,))


def featuremap_expand(x: Variable, num_filters: int,
                      as_row_vector: bool = True, name=None):
    """Replicate each row num_filters times into a feature map (ref:
    gserver/layers/FeatureMapExpandLayer.cpp).  x: [N, D] ->
    [N, num_filters*D]: the row tiled, or each column repeated."""
    helper = LayerHelper("featuremap_expand", name=name)

    def fn(ctx, a, num_filters, as_row_vector):
        if as_row_vector:
            return a.repeat(1, num_filters)
        return torch.repeat_interleave(a, num_filters, dim=-1)

    return helper.append_op(fn, {"X": [x]},
                            attrs={"num_filters": num_filters,
                                   "as_row_vector": as_row_vector})


def kmax_seq_score(score: Variable, lengths: Optional[Variable], k: int,
                   name=None):
    """Indices of the k largest scores within each (masked) sequence (ref:
    gserver/layers/KmaxSeqScoreLayer.cpp).  score: [N, T]; out int32
    [N, k], the lower index first among ties (``lax.top_k``'s order)."""
    helper = LayerHelper("kmax_seq_score", name=name)
    ins = {"X": [score]}
    if lengths is not None:
        ins["Length"] = [lengths]

    def fn(ctx, a, *rest, k):
        if rest:
            pos = torch.arange(a.shape[1], device=a.device)[None, :]
            a = torch.where(pos < rest[0].reshape(-1, 1), a,
                            torch.full_like(a, float("-inf")))
        idx = torch.sort(a, dim=-1, descending=True, stable=True).indices
        return idx[:, :k].to(torch.int32)

    return helper.append_op(fn, ins, attrs={"k": k},
                            axes=(-1,))


def outer_prod(x: Variable, y: Variable, name=None):
    """Per-row outer product (ref: gserver/layers/OuterProdLayer.cpp).
    x: [N, D1], y: [N, D2] -> [N, D1*D2]."""
    helper = LayerHelper("outer_prod", name=name)

    def fn(ctx, a, b):
        return torch.einsum("ni,nj->nij", a, b).reshape(a.shape[0], -1)

    return helper.append_op(fn, {"X": [x], "Y": [y]})


def Print(x: Variable, message: str = "", summarize: int = 8, name=None):
    """Print a tensor's first ``summarize`` values each time the op runs
    (ref: gserver/layers/PrintLayer.cpp; fluid Print op); the output is the
    input.  The header ``"<message> shape=<shape>"`` is plain text, never a
    format string.  The JAX package calls back from its compiled step; the
    port prints eagerly, reading the values on the host, which is why
    ``Executor.warm`` refuses a program holding one."""
    helper = LayerHelper("print", name=name)

    def fn(ctx, a, message, summarize):
        if a.device.type != "meta":
            print(f"{message} shape={tuple(a.shape)}",
                  a.detach().reshape(-1)[:summarize].cpu().numpy())
        return a

    return helper.append_op(fn, {"X": [x]},
                            attrs={"message": message or x.name,
                                   "summarize": summarize})


def rotate(x: Variable, name=None):
    """Rotate each feature map 90 degrees counter-clockwise (ref:
    gserver/layers/RotateLayer.cpp).  x: [N, C, H, W] -> [N, C, W, H]."""
    helper = LayerHelper("rotate", name=name)

    def fn(ctx, a):
        return torch.flip(a.transpose(-1, -2), dims=(-2,))

    return helper.append_op(fn, {"X": [x]})


def l2_normalize(x: Variable, axis: int = -1, epsilon: float = 1e-12,
                 name=None):
    """Row L2 normalisation (ref: gserver/layers/RowL2NormLayer.cpp), the
    epsilon inside the root."""
    helper = LayerHelper("l2_normalize", name=name)

    def fn(ctx, a, axis, epsilon):
        n = torch.sqrt(torch.sum(torch.square(a.float()), dim=axis,
                                 keepdim=True) + epsilon)
        return a / n.to(a.dtype)

    return helper.append_op(fn, {"X": [x]},
                            attrs={"axis": axis, "epsilon": epsilon})


def scale_shift(x: Variable, param_attr=None, bias_attr=None, name=None):
    """y = w * x + b with a scalar learned w and b (ref:
    gserver/layers/ScaleShiftLayer.cpp)."""
    helper = LayerHelper("scale_shift", name=name)
    w = helper.create_parameter(param_attr, [1], x.dtype,
                                default_initializer=Constant(1.0))
    b = helper.create_parameter(bias_attr, [1], x.dtype, is_bias=True)

    def fn(ctx, a, wv, bv):
        return a * wv.reshape(()).to(a.dtype) + bv.reshape(()).to(a.dtype)

    return helper.append_op(fn, {"X": [x], "W": [w], "B": [b]})


def scale_sub_region(x: Variable, indices: Variable, value: float, name=None):
    """Scale a per-sample box of the feature map by ``value`` (ref:
    gserver/layers/ScaleSubRegionLayer.h).  x: [N, C, H, W]; indices: [N, 6]
    1-based inclusive (c0, c1, h0, h1, w0, w1)."""
    helper = LayerHelper("scale_sub_region", name=name)

    def fn(ctx, a, idx, value):
        n, c, h, w = a.shape
        dev = a.device
        ci = torch.arange(c, device=dev)[None, :, None, None]
        hi = torch.arange(h, device=dev)[None, None, :, None]
        wi = torch.arange(w, device=dev)[None, None, None, :]
        idx = idx.to(torch.int32)

        def col(j):
            return idx[:, j, None, None, None] - 1

        inside = ((ci >= col(0)) & (ci <= col(1)) & (hi >= col(2))
                  & (hi <= col(3)) & (wi >= col(4)) & (wi <= col(5)))
        return torch.where(inside, a * value, a)

    return helper.append_op(fn, {"X": [x], "Indices": [indices]},
                            attrs={"value": value})


def sequence_reshape(x: Variable, new_dim: int, name=None):
    """Change the row width of sequence data, T*D kept per sample (ref:
    gserver/layers/SequenceReshapeLayer.cpp).  x: [N, T, D] ->
    [N, T*D/new_dim, new_dim]."""
    helper = LayerHelper("sequence_reshape", name=name)

    def fn(ctx, a, new_dim):
        n, t, d = a.shape
        if (t * d) % new_dim != 0:
            raise ValueError(
                f"sequence_reshape: new_dim={new_dim} must divide T*D={t * d}")
        return a.reshape(n, (t * d) // new_dim, new_dim)

    return helper.append_op(fn, {"X": [x]}, attrs={"new_dim": new_dim})


def dot_prod(x: Variable, y: Variable, name=None):
    """Row-wise dot product (ref: gserver/layers/DotProdLayer.cpp).
    x, y: [N, D] -> [N, 1]."""
    helper = LayerHelper("dot_prod", name=name)

    def fn(ctx, a, b):
        return torch.sum(a * b, dim=-1, keepdim=True)

    return helper.append_op(fn, {"X": [x], "Y": [y]},
                            axes=(-1,))


def cross_entropy_over_beam(scores: Variable, gold: Variable,
                            gold_score: Optional[Variable] = None,
                            step_mask: Optional[Variable] = None, name=None):
    """Beam-search training loss (ref: gserver/layers/CrossEntropyOverBeam.cpp):
    at each expansion step, cross-entropy over the beam's candidate scores
    with the gold candidate as the target.

    scores: [N, S, W]; gold: [N, S] int, an index into W or -1 where the
    gold dropped out of the beam; gold_score: [N, S], the gold's own score,
    appended as candidate W: a competitor on dropped steps only (-1e30
    elsewhere); without it a dropped step costs 0; step_mask: [N, S] 1.0
    for real steps.  Returns the mean over sequences of the summed CE."""
    helper = LayerHelper("cross_entropy_over_beam", name=name)

    def fn(ctx, sc, gd, *rest, has_gold, has_mask):
        gs = rest[0] if has_gold else None
        mask = rest[int(has_gold)] if has_mask else None
        W = sc.shape[-1]
        gd = gd.to(torch.int64)
        dropped = gd < 0
        if gs is not None:
            col = torch.where(dropped, gs, torch.full_like(gs, -1e30))
            sc = torch.cat([sc, col[..., None]], dim=-1)
            tgt = torch.where(dropped, torch.full_like(gd, W), gd)
        else:
            tgt = torch.where(dropped, torch.zeros_like(gd), gd)
        logp = torch.log_softmax(sc, dim=-1)
        ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        if gs is None:
            ce = torch.where(dropped, torch.zeros_like(ce), ce)
        if mask is not None:
            ce = ce * mask
        return torch.mean(torch.sum(ce, dim=-1))

    ins = {"Scores": [scores], "Gold": [gold]}
    extra = [v for v in (gold_score, step_mask) if v is not None]
    if extra:
        ins["Extra"] = extra
    return helper.append_op(fn, ins,
                            attrs={"has_gold": gold_score is not None,
                                   "has_mask": step_mask is not None},
                            axes=(0,))


__all__ = ["Print", "cos_sim_vec_mat", "cross_channel_norm",
           "cross_entropy_over_beam", "data_norm", "dot_prod", "eos_check",
           "factorization_machine", "featuremap_expand", "kmax_seq_score",
           "l2_normalize", "outer_prod", "rotate", "scale_shift",
           "scale_sub_region", "sequence_reshape"]
