"""2-level nested (sub-)sequences (PyTorch port of
``paddle_tpu/layers/nested.py``).

A 2-level nested sequence is a dense tensor ``[batch, S, W, ...]`` (S the
most sub-sequences a row has, W the most tokens a sub-sequence has) with
two int length tensors:

    n_sub   [batch]     valid sub-sequences per row   (the outer level)
    sub_len [batch, S]  tokens in each sub-sequence   (the inner level)

Padding lives on both axes; every op masks with both (the reference's
2-level LoD made static).  ``nested_to_flat`` and
``nested_sequence_select`` left-pack through a spill row that is sliced
away, built out of place (``index_put`` on zeros), so that autograd and a
CUDA graph capture both hold.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.program import Variable
from .control_flow import StaticRNN
from .helper import LayerHelper


def _inner_mask(sub_len, W: int, dtype=torch.float32):
    """[B, S, W] validity from sub_len [B, S] (a padded sub-sequence slot
    has sub_len 0, so the outer mask is implied)."""
    return (torch.arange(W, device=sub_len.device)[None, None, :]
            < sub_len[:, :, None]).to(dtype)


def _outer_mask(n_sub, S: int, dtype=torch.float32):
    """[B, S] validity from n_sub [B]."""
    return (torch.arange(S, device=n_sub.device)[None, :]
            < n_sub[:, None]).to(dtype)


# ------------------------------------------------------------------ pooling


def nested_sequence_pool(input: Variable, n_sub: Variable, sub_len: Variable,
                         pool_type: str = "average", name=None) -> Variable:
    """Pool each sub-sequence to one vector: [B, S, W, ...] -> [B, S, ...]
    (average / sum / sqrt / max / first / last), a 1-level sequence of
    length ``n_sub``.  ``max`` over no valid token gives the dtype's
    lowest value; ``last`` reads token max(sub_len - 1, 0)."""
    helper = LayerHelper("nested_sequence_pool", name=name)

    def fn(ctx, x, ns, sl, pool_type):
        W = x.shape[2]
        trail = (1,) * (x.dim() - 3)
        m = _inner_mask(sl, W, x.dtype).reshape(tuple(x.shape[:3]) + trail)
        if pool_type in ("average", "sum", "sqrt"):
            s = torch.sum(x * m, dim=2)
            denom = torch.clamp_min(sl.to(x.dtype), 1).reshape(
                tuple(sl.shape) + trail)
            if pool_type == "average":
                return s / denom
            if pool_type == "sqrt":
                return s / torch.sqrt(denom)
            return s
        if pool_type == "max":
            # amax: a tie's gradient splits as jnp.max's does
            return torch.amax(torch.where(m > 0, x, torch.finfo(x.dtype).min),
                              dim=2)
        if pool_type == "first":
            return x[:, :, 0]
        if pool_type == "last":
            idx = torch.clamp_min(sl.long() - 1, 0).reshape(
                tuple(sl.shape) + (1,) * (x.dim() - 2))
            return torch.take_along_dim(x, idx, dim=2)[:, :, 0]
        raise ValueError(f"unknown pool_type {pool_type!r}")

    return helper.append_op(
        fn, {"X": [input], "NSub": [n_sub], "SubLen": [sub_len]},
        attrs={"pool_type": pool_type})


def nested_sequence_first_step(input: Variable, n_sub: Variable,
                               sub_len: Variable):
    """First token of every sub-sequence: [B, S, W, ...] -> [B, S, ...]."""
    return nested_sequence_pool(input, n_sub, sub_len, "first")


def nested_sequence_last_step(input: Variable, n_sub: Variable,
                              sub_len: Variable):
    """Last valid token of every sub-sequence: [B, S, W, ...] -> [B, S, ...]."""
    return nested_sequence_pool(input, n_sub, sub_len, "last")


# ----------------------------------------------------------------- expansion


def nested_sequence_expand(x: Variable, sub_len: Variable, max_sub_len: int,
                           name=None) -> Variable:
    """One vector per sub-sequence to every inner position: [B, S, ...] ->
    [B, S, W, ...], zero past each sub-sequence's length."""
    helper = LayerHelper("nested_sequence_expand", name=name)

    def fn(ctx, xv, sl, W):
        out = xv[:, :, None].expand(
            tuple(xv.shape[:2]) + (W,) + tuple(xv.shape[2:]))
        m = _inner_mask(sl, W, xv.dtype).reshape(
            tuple(xv.shape[:2]) + (W,) + (1,) * (xv.dim() - 2))
        return out * m

    return helper.append_op(fn, {"X": [x], "SubLen": [sub_len]},
                            attrs={"W": max_sub_len})


def _packed(values, b_idx, slot, rows: int):
    """``values`` [B, K, ...] put at rows ``slot`` [B, K] of zeros [B, rows
    + 1, ...], out of place; row ``rows`` is the spill row, sliced away."""
    B = values.shape[0]
    out = values.new_zeros((B, rows + 1) + tuple(values.shape[2:]))
    return out.index_put((b_idx, slot), values)[:, :rows]


def nested_to_flat(input: Variable, n_sub: Variable, sub_len: Variable,
                   max_len: Optional[int] = None, name=None):
    """Concatenate each row's sub-sequences, dropping inner padding:
    [B, S, W, ...] -> ([B, T, ...], length [B]), T = max_len or S * W.
    Tokens past a truncating ``max_len`` are dropped and the length
    clamped to T."""
    helper = LayerHelper("nested_to_flat", name=name)

    def fn(ctx, x, ns, sl, T):
        B, S, W = x.shape[:3]
        T = T or S * W
        keep = _inner_mask(sl, W, torch.int64).reshape(B, S * W)
        pos = torch.cumsum(keep, dim=1) - 1            # target slot per token
        feat = x.reshape((B, S * W) + tuple(x.shape[3:]))
        b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * W)
        # padding and truncated tokens -> the spill row
        slot = torch.where(keep > 0, torch.clamp_max(pos, T), T)
        n_valid = torch.clamp_max(keep.sum(dim=1), T).to(torch.int32)
        return _packed(feat, b_idx, slot, T), n_valid

    outs = helper.append_op(
        fn, {"X": [input], "NSub": [n_sub], "SubLen": [sub_len]},
        attrs={"T": max_len}, n_outputs=2)
    return outs[0], outs[1]


def nested_sequence_select(input: Variable, n_sub: Variable,
                           sub_len: Variable, selected: Variable, name=None):
    """Select sub-sequences by per-row indices (ref
    gserver/layers/SubNestedSequenceLayer.cpp).  ``selected``: [B, K] int
    indices, -1 for padding.  Returns (out [B, K, W, ...], new_n_sub [B],
    new_sub_len [B, K]): only the valid selections, left-packed in
    ``selected`` order.  The raw index is checked against S and n_sub
    before it is clamped, so an out-of-range one never aliases group
    S - 1."""
    helper = LayerHelper("nested_sequence_select", name=name)

    def fn(ctx, x, ns, sl, sel):
        B, S = x.shape[:2]
        K = sel.shape[1]
        valid = (sel >= 0) & (sel < ns[:, None]) & (sel < S)
        idx = torch.clamp(sel.long(), 0, S - 1)
        b_idx = torch.arange(B, device=x.device)[:, None].expand(B, K)
        picked = x[b_idx, idx]                         # [B, K, W, ...]
        picked_sl = sl[b_idx, idx]
        pos = torch.cumsum(valid.long(), dim=1) - 1
        slot = torch.where(valid, pos, K)              # invalid -> spill row
        new_ns = valid.sum(dim=1).to(ns.dtype)
        return (_packed(picked, b_idx, slot, K), new_ns,
                _packed(picked_sl, b_idx, slot, K))

    outs = helper.append_op(
        fn, {"X": [input], "NSub": [n_sub], "SubLen": [sub_len],
             "Sel": [selected]}, n_outputs=3)
    return outs[0], outs[1], outs[2]


# ---------------------------------------------------------------- nested RNN


class NestedDynamicRNN(StaticRNN):
    """RNN over sub-sequence groups (ref RecurrentGradientMachine.cpp's
    outer recurrence): the port's ``StaticRNN`` stepping the outer (S)
    axis.  A ``step_input`` of shape [B, S, W, ...] yields [B, W, ...] per
    step, the whole sub-sequence, and ``step_sub_len`` its lengths [B], so
    the body can run any inner sequence op (``dynamic_gru``,
    ``sequence_pool``); the inner op is an op of the body's sub-block, so
    the whole nesting is one ``static_rnn`` op.  Called with
    ``lengths=n_sub``: outer memories hold and outputs are zero past each
    row's sub-sequence count.

        rnn = NestedDynamicRNN()
        with rnn.step():
            sent = rnn.step_input(x)          # x: [B, S, W, D] -> [B, W, D]
            slen = rnn.step_sub_len(sub_len)  # sub_len: [B, S] -> [B]
            enc, _ = seq.dynamic_gru(..., slen, H)    # inner recurrence
            h = rnn.memory(shape=[H])
            nh = fluid.layers.fc([seq.sequence_pool(enc, slen, 'last'), h], H)
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out, = rnn(lengths=n_sub)             # [B, S, H]
    """

    def step_sub_len(self, sub_len: Variable) -> Variable:
        """Per-outer-step inner lengths: sub_len [B, S] -> [B] in the body."""
        return self.step_input(sub_len)


__all__ = ["NestedDynamicRNN", "nested_sequence_expand",
           "nested_sequence_first_step", "nested_sequence_last_step",
           "nested_sequence_pool", "nested_sequence_select", "nested_to_flat"]
