"""Variable-length sequence layers (PyTorch port of the part of
``paddle_tpu/layers/sequence.py`` the LSTM and seq2seq paths use): the
length mask, ``sequence_pool`` with its six pool types,
``sequence_first_step`` / ``sequence_last_step``, ``dynamic_lstm``,
``dynamic_gru`` and the single steps ``lstm_unit`` and ``gru_unit``.

Sequences are dense padded tensors ``[batch, max_len, ...]`` with an int32
``length`` vector ``[batch]``, as in the JAX package; ragged-ness is a mask.
Lengths stay int32 at the feed and become int64 only at the gather.  The
GRU recurrence is a ``lax.scan`` in the JAX package, no Pallas kernel, so
its port is a Python loop over T of torch ops, on the card as on the CPU
(each step's kernels replay from the step's CUDA graph once
``Executor.warm`` captured it).  The rest of the JAX module (sequence conv,
CRF, CTC, ...) is ROADMAP A.7.
"""
from __future__ import annotations

import torch

from ..core.program import Variable
from .helper import LayerHelper


_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda v: v}


def _mask(length, max_len: int, dtype=torch.float32):
    """[batch, max_len] 1/0 validity mask from lengths."""
    t = torch.arange(max_len, device=length.device)
    return (t[None, :] < length[:, None]).to(dtype)


# --------------------------------------------------------------------------- pooling


def sequence_pool(input: Variable, length: Variable, pool_type: str = "average",
                  name=None):
    """average / sum / sqrt / max / last / first over the valid timesteps
    of each sequence.  ``last`` reads step max(len - 1, 0), so a length-0
    row reads step 0; ``max`` over no valid step gives the dtype's lowest
    value."""
    helper = LayerHelper("sequence_pool", name=name)

    def fn(ctx, x, ln, pool_type):
        T = x.shape[1]
        trail = (1,) * (x.dim() - 2)
        me = _mask(ln, T, x.dtype).reshape(x.shape[:2] + trail)
        if pool_type in ("average", "sum", "sqrt"):
            s = torch.sum(x * me, dim=1)
            n = torch.clamp_min(ln.to(x.dtype), 1).reshape((-1,) + trail)
            if pool_type == "average":
                return s / n
            if pool_type == "sqrt":
                return s / torch.sqrt(n)
            return s
        if pool_type == "max":
            neg = torch.finfo(x.dtype).min
            return torch.amax(torch.where(me > 0, x, neg), dim=1)
        if pool_type == "last":
            idx = torch.clamp_min(ln.long() - 1, 0).reshape((-1, 1) + trail)
            return torch.take_along_dim(x, idx, dim=1).squeeze(1)
        if pool_type == "first":
            return x[:, 0]
        raise ValueError(f"unknown pool_type {pool_type}")

    return helper.append_op(fn, {"X": [input], "Length": [length]},
                            attrs={"pool_type": pool_type})


def sequence_first_step(input: Variable, length: Variable):
    return sequence_pool(input, length, "first")


def sequence_last_step(input: Variable, length: Variable):
    return sequence_pool(input, length, "last")


# --------------------------------------------------------------------------- LSTM


def dynamic_lstm(
    input: Variable,
    length: Variable,
    size: int,
    param_attr=None,
    bias_attr=None,
    use_peepholes: bool = True,
    is_reverse: bool = False,
    gate_activation: str = "sigmoid",
    cell_activation: str = "tanh",
    candidate_activation: str = "tanh",
    name=None,
):
    """LSTM over a padded batch.  ``input`` is the pre-projected gate input
    [batch, T, 4*size] (x @ Wx done by an upstream fc); returns (hidden
    [batch, T, size], last_cell [batch, size]).  Runs ``ops.fused_lstm``
    (the CUDA kernels on the card, the plain versions on the CPU); gate
    order i, f, c, o.  The bias is [4*size] gate biases, then [3*size]
    peephole weights when ``use_peepholes``.  ``is_reverse`` flips the
    whole padded time axis, not each row within its length: a short row's
    padded steps come first and its state stays zero through them."""
    helper = LayerHelper("dynamic_lstm", name=name)
    size = int(size)
    w = helper.create_parameter(param_attr, [size, 4 * size], input.dtype)
    bias_width = 7 * size if use_peepholes else 4 * size
    b = helper.create_parameter(bias_attr, [bias_width], input.dtype,
                                is_bias=True)

    def fn(ctx, x, ln, wv, bv, use_peepholes, is_reverse, gate_activation,
           cell_activation, candidate_activation, size):
        from ..ops import fused_lstm

        T = x.shape[1]
        gates_b = bv[:4 * size]
        if use_peepholes:
            peep = torch.stack([bv[4 * size:5 * size], bv[5 * size:6 * size],
                                bv[6 * size:7 * size]])
        else:
            peep = torch.zeros((3, size), dtype=x.dtype, device=x.device)
        m = _mask(ln, T, x.dtype)
        xs = (x.transpose(0, 1) + gates_b).contiguous()   # [T, B, 4H]
        ms = m.transpose(0, 1).contiguous()                # [T, B]
        if is_reverse:
            xs, ms = xs.flip(0), ms.flip(0)
        hs, c_final = fused_lstm(
            xs, wv, peep, ms, size=size, use_peepholes=use_peepholes,
            gate_activation=gate_activation, cell_activation=cell_activation,
            candidate_activation=candidate_activation)
        hs = hs.transpose(0, 1)
        if is_reverse:
            hs = hs.flip(1)
        return hs, c_final

    outs = helper.append_op(
        fn, {"Input": [input], "Length": [length], "Weight": [w], "Bias": [b]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation, "size": size},
        n_outputs=2,
    )
    return outs[0], outs[1]


# --------------------------------------------------------------------------- GRU


def dynamic_gru(
    input: Variable,
    length: Variable,
    size: int,
    param_attr=None,
    bias_attr=None,
    is_reverse: bool = False,
    gate_activation: str = "sigmoid",
    candidate_activation: str = "tanh",
    name=None,
):
    """GRU over a padded batch (ref: paddle/operators/gru_op.cc).  ``input``
    is [batch, T, 3*size] pre-projected; the weight is [size, 3*size] =
    [update | reset gates (2H) ; candidate (H)] and the bias [3*size] is
    added to the whole projection.  Returns (hidden [batch, T, size], zero
    at padded steps, and the last carried state [batch, size]): a padded
    step carries h.  ``is_reverse`` flips the whole padded time axis, as
    ``dynamic_lstm`` does."""
    helper = LayerHelper("dynamic_gru", name=name)
    size = int(size)
    w = helper.create_parameter(param_attr, [size, 3 * size], input.dtype)
    b = helper.create_parameter(bias_attr, [3 * size], input.dtype,
                                is_bias=True)

    def fn(ctx, x, ln, wv, bv, is_reverse, gate_activation,
           candidate_activation, size):
        ga, ca = _ACT[gate_activation], _ACT[candidate_activation]
        B, T, _ = x.shape
        w_g = wv[:, :2 * size]    # update + reset
        w_c = wv[:, 2 * size:]    # candidate
        xs = (x + bv).transpose(0, 1)             # [T, B, 3H]
        ms = _mask(ln, T, x.dtype).transpose(0, 1)  # [T, B]
        if is_reverse:
            xs, ms = xs.flip(0), ms.flip(0)
        h = x.new_zeros((B, size))
        hs = []
        for t in range(T):
            xg = xs[t]
            g = xg[:, :2 * size] + h @ w_g
            u, r = torch.chunk(ga(g), 2, dim=-1)
            cand = ca(xg[:, 2 * size:] + (r * h) @ w_c)
            h_new = u * h + (1 - u) * cand
            mt1 = ms[t][:, None]
            hs.append(h_new * mt1)
            h = h_new * mt1 + h * (1 - mt1)
        out = torch.stack(hs, 1) if hs else x.new_zeros((B, 0, size))
        if is_reverse:
            out = out.flip(1)
        return out, h

    outs = helper.append_op(
        fn, {"Input": [input], "Length": [length], "Weight": [w], "Bias": [b]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "candidate_activation": candidate_activation, "size": size},
        n_outputs=2,
    )
    return outs[0], outs[1]


def lstm_unit(x_t: Variable, hidden_t_prev: Variable, cell_t_prev: Variable,
              forget_bias: float = 0.0, param_attr=None, bias_attr=None):
    """One LSTM step (ref: paddle/operators/lstm_unit_op.cc) for an RNN
    body.  ``x_t`` is [batch, 4*size] pre-projected gates, in the order i,
    f, c, o; returns (h, c)."""
    helper = LayerHelper("lstm_unit")
    size = hidden_t_prev.shape[-1]
    w = helper.create_parameter(param_attr, [size, 4 * size], x_t.dtype)
    b = helper.create_parameter(bias_attr, [4 * size], x_t.dtype,
                                is_bias=True)

    def fn(ctx, xt, h, c, wv, bv, forget_bias):
        g = xt + h @ wv + bv
        gi, gf, gc, go = torch.chunk(g, 4, dim=-1)
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf + forget_bias)
        o = torch.sigmoid(go)
        c_new = f * c + i * torch.tanh(gc)
        return o * torch.tanh(c_new), c_new

    outs = helper.append_op(fn, {"X": [x_t], "H": [hidden_t_prev],
                                 "C": [cell_t_prev], "W": [w], "B": [b]},
                            attrs={"forget_bias": forget_bias}, n_outputs=2)
    return outs[0], outs[1]


def gru_unit(x_t: Variable, hidden_t_prev: Variable, size: int,
             param_attr=None, bias_attr=None):
    """One GRU step (ref: paddle/operators/gru_unit_op.cc), with
    ``dynamic_gru``'s weight layout; returns the new hidden state."""
    helper = LayerHelper("gru_unit")
    size = int(size)
    w = helper.create_parameter(param_attr, [size, 3 * size], x_t.dtype)
    b = helper.create_parameter(bias_attr, [3 * size], x_t.dtype,
                                is_bias=True)

    def fn(ctx, xt, h, wv, bv, size):
        xg = xt + bv
        g = xg[:, :2 * size] + h @ wv[:, :2 * size]
        u, r = torch.chunk(torch.sigmoid(g), 2, dim=-1)
        cand = torch.tanh(xg[:, 2 * size:] + (r * h) @ wv[:, 2 * size:])
        return u * h + (1 - u) * cand

    return helper.append_op(fn, {"X": [x_t], "H": [hidden_t_prev],
                                 "W": [w], "B": [b]}, attrs={"size": size})


__all__ = ["dynamic_gru", "dynamic_lstm", "gru_unit", "lstm_unit",
           "sequence_first_step", "sequence_last_step", "sequence_pool"]
