"""Variable-length sequence layers (PyTorch port of
``paddle_tpu/layers/sequence.py``, all 22 of its public functions): the
length mask; pooling (``sequence_pool`` and its first / last steps); the
sequence utilities ``sequence_softmax``, ``sequence_expand``,
``sequence_concat``, ``sequence_slice``, ``sequence_reverse`` and
``im2sequence``; the time convolutions ``sequence_conv`` and ``row_conv``;
the recurrences ``dynamic_lstm`` (on the LSTM kernels), ``dynamic_gru`` and
the single steps ``lstm_unit`` and ``gru_unit``; the linear-chain CRF
(``linear_chain_crf``, ``crf_decoding``) with ``chunk_eval`` and its host
twin ``chunk_eval_np``; CTC (``warpctc``, ``ctc_greedy_decoder``) and
``edit_distance``.

Sequences are dense padded tensors ``[batch, max_len, ...]`` with an int32
``length`` vector ``[batch]``, as in the JAX package; ragged-ness is a mask.
Lengths stay int32 at the feed and become int64 only at the gather.  The
GRU recurrence, the CRF's forward algorithm and Viterbi, the CTC alpha
recursion and the edit-distance rows are ``lax.scan``s in the JAX package,
no Pallas kernel, so their port is a Python loop over T of torch ops, on
the card as on the CPU (each step's kernels replay from the step's CUDA
graph once ``Executor.warm`` captured it).  Nothing in a loop reads a
device value on the host (``.item()``, boolean-mask indexing, ``nonzero``):
that would stop a capture.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

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


def sequence_softmax(input: Variable, length: Variable, name=None):
    """Softmax over each sequence's valid positions (ref:
    paddle/operators/sequence_softmax_op.cc); padded positions get 0, and a
    zero-length row is all zeros."""
    helper = LayerHelper("sequence_softmax", name=name)

    def fn(ctx, x, ln):
        m = _mask(ln, x.shape[1], x.dtype)
        m = m.reshape(m.shape + (1,) * (x.dim() - 2))
        z = torch.where(m > 0, x, torch.finfo(x.dtype).min)
        return torch.softmax(z, dim=1) * m

    return helper.append_op(fn, {"X": [input], "Length": [length]})


def sequence_expand(x: Variable, length: Variable, max_len: int, name=None):
    """Broadcast per-sequence vectors [batch, d] over each sequence's steps
    (ref: paddle/operators/sequence_expand_op.cc): [batch, max_len, d],
    zero past each length."""
    helper = LayerHelper("sequence_expand", name=name)

    def fn(ctx, a, ln, max_len):
        out = a[:, None].expand((a.shape[0], max_len) + tuple(a.shape[1:]))
        m = _mask(ln, max_len, a.dtype)
        return out * m.reshape(m.shape + (1,) * (a.dim() - 1))

    return helper.append_op(fn, {"X": [x], "Length": [length]},
                            attrs={"max_len": max_len})


def sequence_concat(inputs: Sequence[Variable], name=None):
    """Concatenate along the time axis (ref:
    paddle/operators/sequence_concat_op.cc)."""
    helper = LayerHelper("sequence_concat", name=name)
    return helper.append_op(lambda ctx, *xs: torch.cat(xs, dim=1),
                            {"X": list(inputs)})


def sequence_slice(input: Variable, offset: int, length_: int, name=None):
    """Steps [offset, offset + length_) of every sequence (ref:
    paddle/operators/sequence_slice_op.cc, static offsets).  The offset is
    taken as ``lax.dynamic_slice_in_dim`` takes it in the JAX package: a
    negative one counts from the end (T + offset), then it is clamped into
    [0, T - length_]; torch slicing would do neither."""
    helper = LayerHelper("sequence_slice", name=name)

    def fn(ctx, x, offset, length_):
        T = x.shape[1]
        start = int(offset) + (T if offset < 0 else 0)
        start = min(max(start, 0), T - length_)
        return x[:, start:start + length_]

    return helper.append_op(fn, {"X": [input]},
                            attrs={"offset": offset, "length_": length_})


def sequence_reverse(input: Variable, length: Variable, name=None):
    """Reverse each sequence within its valid region; padded steps stay
    where they are."""
    helper = LayerHelper("sequence_reverse", name=name)

    def fn(ctx, x, ln):
        idx = torch.arange(x.shape[1], device=x.device)[None, :]
        rev = ln.long()[:, None] - 1 - idx
        rev = torch.where(rev >= 0, rev, idx)
        return torch.take_along_dim(
            x, rev.reshape(rev.shape + (1,) * (x.dim() - 2)), dim=1)

    return helper.append_op(fn, {"X": [input], "Length": [length]})


def im2sequence(input: Variable, filter_size=1, stride=1, padding=0,
                name=None):
    """Image patches to a sequence (ref: paddle/operators/im2sequence, the
    reference's block_expand): [n, c, h, w] -> [n, oh * ow, c * kh * kw],
    each patch's features ordered (c, kh, kw).  As in the JAX package the
    patches are VALID ones: ``padding`` is taken and not applied."""
    helper = LayerHelper("im2sequence", name=name)
    kh, kw = ((filter_size, filter_size) if isinstance(filter_size, int)
              else filter_size)
    sh, sw = (stride, stride) if isinstance(stride, int) else stride

    def fn(ctx, x, kh, kw, sh, sw):
        return F.unfold(x, (kh, kw), stride=(sh, sw)).transpose(1, 2)

    return helper.append_op(fn, {"X": [input]},
                            attrs={"kh": kh, "kw": kw, "sh": sh, "sw": sw})


# --------------------------------------------------------------------------- seq conv


def _shifted(x, shift: int):
    """x [b, T, d] moved ``shift`` steps earlier along T (x[t + shift] at
    t), zero where t + shift falls outside [0, T)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :, None]
    keep = t >= -shift if shift < 0 else t < T - shift
    return torch.roll(x, -shift, dims=1) * keep


def sequence_conv(input: Variable, length: Variable, num_filters: int,
                  filter_size: int = 3, param_attr=None, bias_attr=None,
                  act=None, name=None):
    """1-D convolution over time with the context window centred on each
    step, context_start = -(filter_size - 1) // 2 (ref:
    paddle/operators/sequence_conv_op.cc); padded steps read as zero.  The
    filter is [filter_size * d, num_filters]; the bias is its own
    ``elementwise_add`` op, then ``act``."""
    helper = LayerHelper("sequence_conv", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [filter_size * d, num_filters],
                                input.dtype)

    def fn(ctx, x, ln, wv, filter_size):
        start = -((filter_size - 1) // 2)
        xm = x * _mask(ln, x.shape[1], x.dtype)[..., None]
        cols = [_shifted(xm, start + k) for k in range(filter_size)]
        return torch.cat(cols, dim=-1) @ wv          # [b, T, k * d] @ w

    out = helper.append_op(fn, {"X": [input], "Length": [length],
                                "Filter": [w]},
                           attrs={"filter_size": filter_size})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], out.dtype,
                                    is_bias=True)
        out = helper.append_op(lambda ctx, a, bv: a + bv,
                               {"X": [out], "B": [b]},
                               op_type="elementwise_add")
    return helper.append_activation(out, act)


def row_conv(input: Variable, future_context_size: int, param_attr=None,
             name=None):
    """Lookahead convolution (ref: paddle/operators/row_conv_op.cc, from
    DeepSpeech2): out[t] = sum_k x[t + k] * w[k], k = 0..future_context_size,
    zero past the end."""
    helper = LayerHelper("row_conv", name=name)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr, [future_context_size + 1, d],
                                input.dtype)

    def fn(ctx, x, wv, future_context_size):
        out = torch.zeros_like(x)
        for k in range(future_context_size + 1):
            out = out + _shifted(x, k) * wv[k][None, None, :]
        return out

    return helper.append_op(fn, {"X": [input], "Filter": [w]},
                            attrs={"future_context_size": future_context_size})


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


# --------------------------------------------------------------------------- CRF


def _gather_ids(ids, n: int):
    """Tag ids as JAX's gather takes them: (the id clamped into [0, n), the
    mask of ids in range).  A negative id first counts from the end; the
    value is read at the clamped id, and an id out of range passes no
    gradient back (the gradient's scatter drops it)."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    return ids.clamp(0, n - 1), (ids >= 0) & (ids < n)


def _grad_where(v, ok):
    """``v``, with its gradient kept only where ``ok``."""
    return torch.where(ok, v, v.detach())


def linear_chain_crf(input: Variable, label: Variable, length: Variable,
                     param_attr=None, name=None):
    """Linear-chain CRF negative log-likelihood (ref:
    paddle/operators/linear_chain_crf_op.cc; v1 CRFLayer.cpp).

    input: emissions [batch, T, n_tags]; label: [batch, T] or [batch, T, 1]
    int; length: [batch].  The transition parameter is [n_tags + 2,
    n_tags]: row 0 the start weights, row 1 the end weights, rows 2.. the
    transitions.  Returns the per-sequence NLL [batch, 1].  A label id out
    of range reads as JAX's gather reads it (``_gather_ids``).  The forward
    algorithm runs T - 1 steps of logsumexp over [batch, n_tags, n_tags]; a
    padded step carries alpha, and the gold path's last tag."""
    helper = LayerHelper("linear_chain_crf", name=name)
    n_tags = input.shape[-1]
    transition = helper.create_parameter(param_attr, [n_tags + 2, n_tags],
                                         input.dtype)

    def fn(ctx, emis, lab, ln, trans):
        B, T, N = emis.shape
        start, end, trs = trans[0], trans[1], trans[2:]
        m = _mask(ln, T, emis.dtype)
        if lab.dim() == 3:
            lab = lab.squeeze(-1)
        lab, lab_ok = _gather_ids(lab, N)

        # log partition by the forward algorithm
        alpha = start[None, :] + emis[:, 0]
        for t in range(1, T):
            m_t = m[:, t, None]
            scores = alpha[:, :, None] + trs[None, :, :] + emis[:, t, None, :]
            alpha = torch.logsumexp(scores, dim=1) * m_t + alpha * (1 - m_t)
        log_z = torch.logsumexp(alpha + end[None, :], dim=-1)

        # the gold path's score
        prev, prev_ok = lab[:, 0], lab_ok[:, 0]
        score = _grad_where(
            torch.take_along_dim(emis[:, 0], prev[:, None], dim=1)[:, 0]
            + start[prev], prev_ok)
        for t in range(1, T):
            l_t, ok_t, m_t = lab[:, t], lab_ok[:, t], m[:, t]
            e_t = torch.take_along_dim(emis[:, t], l_t[:, None], dim=1)[:, 0]
            s_t = (_grad_where(trs[prev, l_t], prev_ok & ok_t)
                   + _grad_where(e_t, ok_t))
            score = score + s_t * m_t
            prev = torch.where(m_t > 0, l_t, prev)
            prev_ok = torch.where(m_t > 0, ok_t, prev_ok)
        return (log_z - (score + _grad_where(end[prev], prev_ok)))[:, None]

    return helper.append_op(fn, {"Emission": [input], "Label": [label],
                                 "Length": [length],
                                 "Transition": [transition]})


def crf_decoding(input: Variable, length: Variable, param_attr=None,
                 name=None):
    """Viterbi decoding (ref: paddle/operators/crf_decoding_op.cc): the
    best tag path int32 [batch, T].  Shares the transition with
    ``linear_chain_crf`` by ``param_attr`` name.  Each argmax takes the
    first maximum, as ``jnp.argmax`` does; a padded step carries the score,
    and the backtrack carries the last tag through it, so padded positions
    hold the tag of the step after them (the row's last tag at its end)."""
    helper = LayerHelper("crf_decoding", name=name)
    n_tags = input.shape[-1]
    transition = helper.create_parameter(param_attr, [n_tags + 2, n_tags],
                                         input.dtype)

    def fn(ctx, emis, ln, trans):
        B, T, N = emis.shape
        start, end, trs = trans[0], trans[1], trans[2:]
        m = _mask(ln, T, emis.dtype)
        score = start[None, :] + emis[:, 0]
        back = []
        for t in range(1, T):
            m_t = m[:, t, None]
            cand = score[:, :, None] + trs[None, :, :] + emis[:, t, None, :]
            back.append(torch.argmax(cand, dim=1))
            score = torch.amax(cand, dim=1) * m_t + score * (1 - m_t)
        tag = torch.argmax(score + end[None, :], dim=-1)
        path = [tag]
        for t in range(T - 1, 0, -1):
            prev = torch.take_along_dim(back[t - 1], tag[:, None], dim=1)[:, 0]
            tag = torch.where(m[:, t] > 0, prev, tag)
            path.append(tag)
        return torch.stack(path[::-1], dim=1).to(torch.int32)

    return helper.append_op(fn, {"Emission": [input], "Length": [length],
                                 "Transition": [transition]})


# --------------------------------------------------------------------------- metrics


def chunk_eval_np(pred_tags: np.ndarray, gold_tags: np.ndarray,
                  lengths: np.ndarray, scheme: str = "IOB",
                  n_types: Optional[int] = None):
    """Host-side chunk precision, recall and F1 (ref:
    paddle/operators/chunk_eval_op.cc, gserver ChunkEvaluator.cpp).  Tags
    follow the reference's IOB encoding: tag = type_index * 2 + {0=B, 1=I},
    negative = outside."""

    def extract(tags, ln):
        chunks = set()
        start = None
        ctype = None
        for i in range(ln):
            t = int(tags[i])
            if t < 0:
                if start is not None:
                    chunks.add((start, i - 1, ctype))
                    start = None
                continue
            tag, typ = t % 2, t // 2
            if tag == 0:  # B
                if start is not None:
                    chunks.add((start, i - 1, ctype))
                start, ctype = i, typ
            else:  # I
                if start is None or typ != ctype:
                    if start is not None:
                        chunks.add((start, i - 1, ctype))
                    start, ctype = i, typ
        if start is not None:
            chunks.add((start, ln - 1, ctype))
        return chunks

    tp = fp = fn_ = 0
    for p, g, ln in zip(pred_tags, gold_tags, lengths):
        pc = extract(p, int(ln))
        gc = extract(g, int(ln))
        tp += len(pc & gc)
        fp += len(pc - gc)
        fn_ += len(gc - pc)
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn_, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-8)
    return prec, rec, f1


def chunk_eval(pred: Variable, label: Variable, lengths: Variable,
               name=None):
    """In-graph chunk counts for IOB tags (ref:
    paddle/operators/chunk_eval_op.cc).  pred / label: [N, T] int tag ids
    (type * 2 + {0: B, 1: I}, negative = outside); lengths [N].  Returns
    float32 [3] = (correct, predicted, labelled) chunk counts.  A position
    starts a chunk unless it is an I continuing the previous position's
    type; a chunk is correct when both sequences start it at the same
    position with the same type and end it at the same position.  Each
    chunk's end is a reverse running minimum (``flip`` + ``cummin``)."""
    helper = LayerHelper("chunk_eval", name=name)

    def fn(ctx, p, g, ln):
        N, T = p.shape[0], p.shape[1]
        pos = torch.arange(T, device=p.device)[None, :]
        valid_mask = pos < ln.reshape(-1, 1)

        def marks(tags):
            valid = (tags >= 0) & valid_mask
            typ = torch.div(tags, 2, rounding_mode="floor")
            is_i = torch.remainder(tags, 2) == 1
            no = torch.zeros_like(valid[:, :1])
            prev_valid = torch.cat([no, valid[:, :-1]], 1)
            prev_typ = torch.cat([torch.full_like(typ[:, :1], -1),
                                  typ[:, :-1]], 1)
            continues = is_i & prev_valid & (prev_typ == typ)
            start = valid & ~continues
            next_start = torch.cat([start[:, 1:], no], 1)
            next_valid = torch.cat([valid[:, 1:], no], 1)
            end = valid & (~next_valid | next_start)
            idx = torch.where(end, pos, T)
            e = torch.cummin(idx.flip(1), dim=1).values.flip(1)
            return start, typ, e

        ps, pt, pe = marks(p)
        gs, gt, ge = marks(g)
        correct = torch.sum(ps & gs & (pt == gt) & (pe == ge))
        return torch.stack([correct, torch.sum(ps),
                            torch.sum(gs)]).to(torch.float32)

    return helper.append_op(fn, {"Inference": [pred], "Label": [label],
                                 "SeqLen": [lengths]})


# --------------------------------------------------------------------------- CTC


def warpctc(input: Variable, label: Variable, logit_length: Variable,
            label_length: Variable, blank: int = 0,
            norm_by_times: bool = False, name=None):
    """CTC negative log-likelihood (ref: v1 CTCLayer.cpp and the warp-ctc
    wrapper paddle/cuda/src/hl_warpctc_wrap.cc): the forward algorithm in
    log space over the extended label sequence (blank, l1, blank, ...,
    blank), in float32 whatever the input's dtype, differentiated by
    autograd.  input: raw logits [batch, T, classes] (softmax applied
    here); label [batch, L] int, padded; logit_length, label_length
    [batch].  A zero-length label works, and so do repeated labels (the
    skip between equal labels is not allowed).  Returns the per-sequence
    NLL [batch, 1].  ``norm_by_times`` divides only the gradient by each
    sequence's T; the value stays unnormalised.  ``F.ctc_loss`` is not
    used: on the card it copies the lengths to the host, which a CUDA
    graph capture forbids, and it differentiates by a formula of its
    own.  Each step's emission is read by a product with the extended
    labels' one-hot, not a gather, so that the backward is deterministic
    on the card."""
    helper = LayerHelper("warpctc", name=name)

    def fn(ctx, logits, lab, loglen, lablen, blank, norm_by_times):
        B, T, C = logits.shape
        if lab.dim() == 3:
            lab = lab.squeeze(-1)
        L = lab.shape[1]
        S = 2 * L + 1
        dev = logits.device
        neg = -1e30
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = lab.long()
        # the skip s - 2 -> s where ext[s] is a label unlike ext[s - 2]
        skip_ok = torch.cat(
            [torch.zeros((B, 2), dtype=torch.bool, device=dev),
             (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])], dim=1)
        # emit[b, t, s] = logp[b, t, ext[b, s]], as the product with ext's
        # one-hot: a gather's backward adds a repeated id's gradients (the
        # blank's, a repeated label's) with atomics on the card, in another
        # order each run; the product's backward is a batched matmul, one
        # fixed order.  Each sum has one nonzero term, so the values are
        # the gather's
        onehot = (ext[:, :, None] == torch.arange(C, device=dev)).to(
            logp.dtype)                                     # [B, S, C]
        emit = torch.bmm(logp, onehot.transpose(1, 2))      # [B, T, S]
        emit_t = emit.transpose(0, 1)                      # [T, B, S]
        lab_on = (lablen > 0)[:, None]
        alpha = torch.cat(
            [emit_t[0, :, :1],
             torch.where(lab_on, emit_t[0, :, 1:2], neg),
             torch.full((B, S - 2), neg, device=dev)], dim=1)
        pad1 = torch.full((B, 1), neg, device=dev)
        pad2 = torch.full((B, 2), neg, device=dev)
        for t in range(1, T):
            a1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
            a2 = torch.where(skip_ok, torch.cat([pad2, alpha[:, :-2]], dim=1),
                             neg)
            new = torch.logsumexp(torch.stack([alpha, a1, a2]), dim=0) \
                + emit_t[t]
            # past a sequence's last frame alpha stays: the loop ends
            # holding alpha at each row's own last frame
            alpha = torch.where((t < loglen)[:, None], new, alpha)
        idx_last = 2 * lablen.long()[:, None]
        a_end = torch.gather(alpha, 1, idx_last)[:, 0]
        a_pre = torch.gather(alpha, 1, torch.clamp_min(idx_last - 1, 0))[:, 0]
        a_pre = torch.where(lab_on[:, 0], a_pre, neg)
        nll = -torch.logsumexp(torch.stack([a_end, a_pre]), dim=0)
        if norm_by_times:
            scaled = nll / torch.clamp_min(loglen.to(nll.dtype), 1)
            nll = scaled + (nll - scaled).detach()
        return nll[:, None].to(logits.dtype)

    return helper.append_op(
        fn, {"Logits": [input], "Label": [label],
             "LogitsLength": [logit_length], "LabelLength": [label_length]},
        attrs={"blank": blank, "norm_by_times": norm_by_times})


def ctc_greedy_decoder(input: Variable, length: Variable, blank: int = 0,
                       name=None):
    """Best-path CTC decode (ref: the decode half of v1
    CTCErrorEvaluator.cpp): the per-step argmax, repeats collapsed, blanks
    dropped.  Returns (ids int32 [batch, T], left-packed and padded with
    -1; out_length int32 [batch]).  The packing is a ``scatter_`` into a
    [batch, T + 1] buffer whose last column takes the dropped steps."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)

    def fn(ctx, logits, ln, blank):
        B, T, _ = logits.shape
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
        t = torch.arange(T, device=logits.device)[None, :]
        keep = (ids != blank) & (ids != prev) & (t < ln[:, None])
        pos = torch.cumsum(keep, dim=1) - 1
        out = torch.full((B, T + 1), -1, dtype=torch.int32,
                         device=logits.device)
        out.scatter_(1, torch.where(keep, pos, T), ids)
        return out[:, :T], keep.sum(dim=1).to(torch.int32)

    outs = helper.append_op(fn, {"Logits": [input], "SeqLen": [length]},
                            attrs={"blank": blank}, n_outputs=2)
    return outs[0], outs[1]


def edit_distance(hyp: Variable, hyp_length: Variable, ref: Variable,
                  ref_length: Variable, normalized: bool = False, name=None):
    """Levenshtein distance between padded id sequences (ref: the
    edit-distance half of v1 CTCErrorEvaluator.cpp), float32 [batch, 1];
    divided by the reference's length when ``normalized``.  The loop runs
    over hypothesis tokens; each DP row is one prefix-min transform,
    new_row[j] = min_{k <= j} c[k] + (j - k) (``torch.cummin``), where c
    folds the delete and substitute candidates."""
    helper = LayerHelper("edit_distance", name=name)

    def fn(ctx, hyp, hlen, ref, rlen, normalized):
        if hyp.dim() == 3:
            hyp = hyp.squeeze(-1)
        if ref.dim() == 3:
            ref = ref.squeeze(-1)
        B, H = hyp.shape
        R = ref.shape[1]
        j_idx = torch.arange(R + 1, dtype=torch.float32, device=hyp.device)
        row = j_idx.expand(B, R + 1)
        for i in range(1, H + 1):
            sub_cost = (hyp[:, i - 1, None] != ref).to(torch.float32)
            c = torch.cat([torch.full((B, 1), float(i), device=hyp.device),
                           torch.minimum(row[:, 1:] + 1.0,
                                         row[:, :-1] + sub_cost)], dim=1)
            new_row = torch.cummin(c - j_idx, dim=1).values + j_idx
            row = torch.where((i <= hlen)[:, None], new_row, row)
        d = torch.gather(row, 1, rlen.long()[:, None])[:, 0]
        if normalized:
            d = d / torch.clamp_min(rlen.to(torch.float32), 1)
        return d[:, None]

    return helper.append_op(fn, {"Hyp": [hyp], "HypLength": [hyp_length],
                                 "Ref": [ref], "RefLength": [ref_length]},
                            attrs={"normalized": normalized})


__all__ = ["chunk_eval", "chunk_eval_np", "crf_decoding",
           "ctc_greedy_decoder", "dynamic_gru", "dynamic_lstm",
           "edit_distance", "gru_unit", "im2sequence", "linear_chain_crf",
           "lstm_unit", "row_conv", "sequence_concat", "sequence_conv",
           "sequence_expand", "sequence_first_step", "sequence_last_step",
           "sequence_pool", "sequence_reverse", "sequence_slice",
           "sequence_softmax", "warpctc"]
