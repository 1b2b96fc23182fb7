"""Decoder-only Transformer LM (PyTorch port of
``paddle_tpu/models/transformer.py``): the training graph ``build_lm`` over
the Program API, the serving block math (the ``_srv_*`` section: the
dense prefill and decode forms, and the paged window), and ``generate``,
beam generation over the dense caches as one program op.

Parameters keep the JAX names (``tok_emb``, ``blk0.q.w``, ...) and live in a
plain ``dict[str, Tensor]`` (``nn.ParameterDict`` refuses keys with dots).

Numerics follow the JAX package:
  * layernorm statistics in float32 with the population variance;
  * ``_srv_mmul`` accumulates in float32 and casts back to the compute dtype;
  * GELU is the tanh approximation (``jax.nn.gelu``'s default);
  * masked scores take the finite fill -1e9;
  * the LM head returns float32 logits from compute-dtype inputs;
  * gathers clamp out-of-range positions explicitly (JAX clamps implicitly;
    torch would raise): a speculative window overhanging ``max_len`` reads
    the last position embedding.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import layers
from .. import ops as _ops
from ..core import unique_name
from ..core.program import Op, Variable
from ..initializer import Normal
from ..layers.helper import LayerHelper
from ..param_attr import ParamAttr, PartitionSpec, SeqAxis, seq_axis_of

Params = Dict[str, torch.Tensor]


def lm_param_shapes(vocab_size: int, max_len: int, d_model: int = 512,
                    n_heads: int = 8, n_layers: int = 6, d_ff: int = 2048,
                    tie_embeddings: bool = True):
    """Name -> shape for every LM parameter (the JAX ``build_lm`` names)."""
    shapes = {"tok_emb": (vocab_size, d_model), "pos_emb": (max_len, d_model)}
    for i in range(n_layers):
        nm = f"blk{i}"
        shapes[f"{nm}.ln1.g"] = (d_model,)
        shapes[f"{nm}.ln1.b"] = (d_model,)
        for s in ("q", "k", "v", "o"):
            shapes[f"{nm}.{s}.w"] = (d_model, d_model)
        shapes[f"{nm}.o.b"] = (d_model,)
        shapes[f"{nm}.ln2.g"] = (d_model,)
        shapes[f"{nm}.ln2.b"] = (d_model,)
        shapes[f"{nm}.ff1.w"] = (d_model, d_ff)
        shapes[f"{nm}.ff1.b"] = (d_ff,)
        shapes[f"{nm}.ff2.w"] = (d_ff, d_model)
        shapes[f"{nm}.ff2.b"] = (d_model,)
    shapes["lnf.g"] = (d_model,)
    shapes["lnf.b"] = (d_model,)
    if not tie_embeddings:
        shapes["lm_head.w"] = (d_model, vocab_size)
    return shapes


def init_lm_params(seed: int, vocab_size: int, max_len: int, d_model: int = 512,
                   n_heads: int = 8, n_layers: int = 6, d_ff: int = 2048,
                   tie_embeddings: bool = True, init_std: float = 0.02):
    """Numpy init of the LM parameters: the same ``RandomState`` draws as the
    JAX package, so one seed gives the same weights in both."""
    rng = np.random.RandomState(seed)
    params = {}
    for n, shape in lm_param_shapes(vocab_size, max_len, d_model, n_heads,
                                    n_layers, d_ff, tie_embeddings).items():
        if n.endswith(".g"):
            params[n] = np.ones(shape, "float32")
        elif n.endswith(".b"):
            params[n] = np.zeros(shape, "float32")
        else:
            params[n] = (rng.randn(*shape) * init_std).astype("float32")
    return params


# ------------------------------------------------------------- training graph


def attention_core(q, k, v, causal: bool, n_heads: int, use_sp: bool,
                   sp_strategy: str = "ring"):
    """[N, T, H*D] q/k/v -> attention output [N, T, H*D], one op.  On one
    device it runs ``ops.flash_attention`` (the hand-written kernels on
    the card).  Under a Strategy a rank holds its heads (q/k/v from
    column-parallel fcs: H / tp of them) and, when q is sequence-sharded
    (a ``SeqAxis`` on dim 1, which needs ``use_sp``), its sequence chunk:
    then sequence parallelism runs as ring attention (``ring``, contiguous
    chunks; ``ring_striped``, the zigzag chunks, which q's layout must
    be) or Ulysses all-to-all (``ulysses``, n_heads / tp divisible by
    sp)."""
    if sp_strategy not in ("ring", "ring_striped", "ulysses"):
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}: "
                         f"ring | ring_striped | ulysses")
    seq = seq_axis_of(q)
    if seq is not None and not use_sp:
        raise ValueError(f"q is sequence-sharded over {seq!r}: attention "
                         f"over the whole sequence needs use_sp=True")
    if use_sp and seq is not None \
            and (sp_strategy == "ring_striped") != seq.striped:
        raise ValueError(
            f"sp_strategy {sp_strategy!r} needs the "
            f"{'striped' if sp_strategy == 'ring_striped' else 'contiguous'}"
            f" sequence layout, and q's is {seq!r}")
    helper = LayerHelper("attention")
    hd_full = q.shape[-1]

    def fn(ctx, qv, kv, vv, causal, n_heads, use_sp, sp_strategy,
           _hd=hd_full, _seq=seq):
        N, T, HD = qv.shape
        heads_here = n_heads * HD // _hd   # H / tp on a tensor-parallel rank
        D = HD // heads_here

        def heads(z):
            return z.reshape(N, z.shape[1], heads_here, D).transpose(1, 2)

        lay = ctx.layout
        if lay is not None and lay.sharded(_seq):
            qh, kh, vh = heads(qv), heads(kv), heads(vv)
            if sp_strategy == "ulysses":
                from ..parallel.ulysses import ulysses_attention

                out = ulysses_attention(qh, kh, vh, ctx.mesh, axis=_seq,
                                        causal=causal)
            else:
                from ..parallel.ring import ring_attention

                out = ring_attention(qh, kh, vh, ctx.mesh, axis=_seq,
                                     causal=causal, striped=_seq.striped)
        else:
            out = _ops.flash_attention(heads(qv), heads(kv), heads(vv),
                                       causal=causal)
        return out.transpose(1, 2).reshape(N, T, HD)

    out = helper.append_op(fn, {"Q": [q], "K": [k], "V": [v]},
                           attrs={"causal": causal, "n_heads": n_heads,
                                  "use_sp": use_sp, "sp_strategy": sp_strategy})
    out.sharding = q.sharding   # heads sharded as q's (tensor parallel)
    return out


def _maybe(use_tp):
    """The tensor-parallel or the plain fc builders (column, row)."""
    if use_tp:
        from ..parallel import tp as _tp

        return _tp.column_parallel_fc, _tp.row_parallel_fc

    def plain(x, size, **kw):
        return layers.fc(x, size, **kw)

    return plain, plain


def transformer_block(x, d_model: int, n_heads: int, d_ff: int, causal=True,
                      dropout=0.0, use_tp=False, use_sp=False,
                      sp_strategy="ring", name=""):
    """Pre-LN block with deterministic parameter names (``{name}.q.w``,
    ...), the names ``lm_param_shapes`` lists.  With ``dropout > 0``, a
    dropout after the attention's output projection and one after ff2, as
    in the reference.  ``use_tp``: Megatron's layout (``parallel/tp.py``):
    q/k/v and ff1 column-parallel, the attention output and ff2
    row-parallel, two all-reduces a block forward."""
    col, row = _maybe(use_tp)

    def pa(suffix):
        return ParamAttr(name=f"{name}.{suffix}")

    h = layers.layer_norm(x, begin_norm_axis=2, param_attr=pa("ln1.g"),
                          bias_attr=pa("ln1.b"))
    q = col(h, d_model, num_flatten_dims=2, bias_attr=False,
            name=f"{name}.q", param_attr=pa("q.w"))
    k = col(h, d_model, num_flatten_dims=2, bias_attr=False,
            name=f"{name}.k", param_attr=pa("k.w"))
    v = col(h, d_model, num_flatten_dims=2, bias_attr=False,
            name=f"{name}.v", param_attr=pa("v.w"))
    att = attention_core(q, k, v, causal, n_heads, use_sp, sp_strategy)
    att = row(att, d_model, num_flatten_dims=2, name=f"{name}.o",
              param_attr=pa("o.w"), bias_attr=pa("o.b"))
    if dropout > 0:
        att = layers.dropout(att, dropout)
    x = layers.elementwise_add(x, att)
    h2 = layers.layer_norm(x, begin_norm_axis=2, param_attr=pa("ln2.g"),
                           bias_attr=pa("ln2.b"))
    f = col(h2, d_ff, num_flatten_dims=2, act="gelu", name=f"{name}.ff1",
            param_attr=pa("ff1.w"), bias_attr=pa("ff1.b"))
    f = row(f, d_model, num_flatten_dims=2, name=f"{name}.ff2",
            param_attr=pa("ff2.w"), bias_attr=pa("ff2.b"))
    if dropout > 0:
        f = layers.dropout(f, dropout)
    return layers.elementwise_add(x, f)


def build_lm(
    tokens: Variable,
    labels: Variable,
    vocab_size: int,
    max_len: int,
    d_model: int = 512,
    n_heads: int = 8,
    n_layers: int = 6,
    d_ff: int = 2048,
    dropout: float = 0.0,
    use_tp: bool = False,
    use_sp: bool = False,
    sp_strategy: str = "ring",
    tie_embeddings: bool = True,
    remat: bool = False,
):
    """Decoder-only LM training graph (the Transformer-base flagship).
    tokens/labels: [N, T] / [N, T, 1] int32.  Returns (loss, logits).

    ``dropout > 0`` puts a dropout after the positional add and two in each
    block (1 + 2 x n_layers sites, Transformer-base's P_drop); its masks
    are JAX's, bit for bit.  ``remat=True`` wraps each block in
    ``layers.recompute``: each block's activations are recomputed in the
    backward instead of kept, with the same masks, so the step computes
    what the plain build computes.

    Under ``Executor(strategy=...)``: ``use_tp`` shards the blocks
    Megatron's way and the tied embedding over the vocab (``tok_emb``
    [V/tp, d]; the head's logits are vocab-sharded and the cross entropy
    takes the vocab-parallel form); ``use_sp`` marks ``tokens`` and
    ``labels`` sequence-sharded over ``sp`` (``SeqAxis("sp")`` on dim 1,
    striped for ``ring_striped``), so each rank carries its sequence chunk
    through every block (its memory scales with T / sp), reads the
    position embedding at its global positions, and attends by
    ``sp_strategy``.  On one device both are the plain build."""
    if use_sp:
        seq = SeqAxis("sp", striped=sp_strategy == "ring_striped")
        tokens.sharding = PartitionSpec(None, seq)
        labels.sharding = PartitionSpec(None, seq)
    emb_attr = ParamAttr(name="tok_emb", initializer=Normal(0.0, 0.02),
                         sharding=PartitionSpec("tp", None) if use_tp
                         else None)
    x = layers.embedding(tokens, [vocab_size, d_model], param_attr=emb_attr)
    pos_attr = ParamAttr(name="pos_emb", initializer=Normal(0.0, 0.02))
    helper = LayerHelper("pos_embed")
    pos_w = helper.create_parameter(pos_attr, [max_len, d_model], x.dtype)

    def add_pos(ctx, h, pw, _seq=seq_axis_of(x)):
        lay = ctx.layout
        if lay is not None and lay.sharded(_seq):
            # this rank's chunk sits at its global positions
            return h + pw[lay.seq_positions(_seq, h.shape[1], h.device)][None]
        return h + pw[None, : h.shape[1]]

    x = helper.append_op(add_pos, {"X": [x], "Pos": [pos_w]})
    if dropout > 0:
        x = layers.dropout(x, dropout)
    for i in range(n_layers):
        def blk(x=x, i=i):
            return transformer_block(x, d_model, n_heads, d_ff, causal=True,
                                     dropout=dropout, use_tp=use_tp,
                                     use_sp=use_sp, sp_strategy=sp_strategy,
                                     name=f"blk{i}")

        x = layers.recompute(blk) if remat else blk()
    x = layers.layer_norm(x, begin_norm_axis=2, param_attr=ParamAttr(name="lnf.g"),
                          bias_attr=ParamAttr(name="lnf.b"))
    if tie_embeddings:
        helper2 = LayerHelper("lm_head")

        def head(ctx, h, w):
            if ctx.mesh is not None and use_tp:
                # h is replicated over tp, w the rank's vocab rows: the
                # gradient of h sums over tp
                from ..parallel import comm

                h = comm.copy_to(h, ctx.mesh.group("tp"))
            return torch.matmul(h, w.t())

        logits = helper2.append_op(head, {"X": [x], "W": [helper.block.var("tok_emb")]})
        if use_tp:
            logits.sharding = PartitionSpec(None, seq_axis_of(logits), "tp")
    else:
        logits = layers.fc(x, vocab_size, num_flatten_dims=2, bias_attr=False,
                           param_attr=ParamAttr(name="lm_head.w"))
    ce = layers.softmax_with_cross_entropy(logits, labels)
    loss = layers.mean(ce)
    return loss, logits


# ----------------------------------------------------------------- block math


def _srv_ln(h, g, b, cd):
    """float32-statistics layernorm regardless of compute dtype."""
    hf = h.to(torch.float32)
    mu = hf.mean(dim=-1, keepdim=True)
    var = hf.var(dim=-1, keepdim=True, correction=0)
    return ((hf - mu) * torch.rsqrt(var + 1e-5) * g + b).to(cd)


def _srv_mmul(a, w, cd):
    """Compute-dtype matmul with float32 accumulation, back to ``cd``."""
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(a, w).to(cd)
    return torch.matmul(a.to(torch.float32), w.to(torch.float32)).to(cd)


def _srv_cast_params(params: Params, cd) -> Params:
    """Cast once, outside the decode loop: every 2-D parameter and every
    ``.w`` weight to the compute dtype; 1-D layernorm/bias params stay
    float32."""
    return {n: (v.to(cd) if v.dim() >= 2 or n.endswith(".w") else v)
            for n, v in params.items()}


class SrvShard(NamedTuple):
    """A rank's part in the serving forms when tensor parallelism splits
    them (``serving/mesh.py``); ``shard=None`` in the forms is one device.
    ``row_reduce(name, y)``: the product ``y`` of row-parallel weight
    ``name`` summed over the ranks (``y`` itself for a weight held whole);
    ``vocab_block(w)``: the rank's columns of a head weight [D, V];
    ``head_gather(y)``: the logits' vocab blocks gathered."""
    row_reduce: Callable
    vocab_block: Callable
    head_gather: Callable


def _whole(name, y):
    return y


def _srv_qkv(prm, nm, x, cd):
    h = _srv_ln(x, prm[f"{nm}.ln1.g"], prm[f"{nm}.ln1.b"], cd)
    return tuple(_srv_mmul(h, prm[f"{nm}.{s}.w"], cd) for s in ("q", "k", "v"))


def _srv_attn_out_ffn(prm, nm, x, o, cd, shard=None):
    """Output projection + residual, then the FFN sublayer (the o and ff2
    products summed over tp by ``shard``)."""
    red = _whole if shard is None else shard.row_reduce
    x = x + red(f"{nm}.o.w", _srv_mmul(o, prm[f"{nm}.o.w"], cd)) \
        + prm[f"{nm}.o.b"].to(cd)
    h2 = _srv_ln(x, prm[f"{nm}.ln2.g"], prm[f"{nm}.ln2.b"], cd)
    f = F.gelu(_srv_mmul(h2, prm[f"{nm}.ff1.w"], cd)
               + prm[f"{nm}.ff1.b"].to(cd), approximate="tanh")
    return x + red(f"{nm}.ff2.w", _srv_mmul(f, prm[f"{nm}.ff2.w"], cd)) \
        + prm[f"{nm}.ff2.b"].to(cd)


def _srv_block_full(prm, nm, x, n_heads, Dh, scale, cd, shard=None):
    """Prefill block: full causal attention over x [N, T, D]; returns the new
    x and this layer's head-major K/V [N, H, T, Dh]."""
    q, k, v = _srv_qkv(prm, nm, x, cd)

    def heads(z):
        return z.reshape(z.shape[:-1] + (n_heads, Dh)).transpose(-3, -2)

    qh, kh, vh = heads(q), heads(k), heads(v)
    s = torch.matmul(qh.to(torch.float32),
                     kh.to(torch.float32).transpose(-1, -2)) * scale
    Tq = s.shape[-1]
    mask = torch.tril(torch.ones((Tq, Tq), dtype=torch.bool, device=x.device))
    s = torch.where(mask, s, torch.full_like(s, -1e9))
    a = torch.softmax(s, dim=-1).to(cd)
    o = torch.matmul(a.to(torch.float32), vh.to(torch.float32)).to(cd)
    o = o.transpose(-3, -2).reshape(x.shape[:-1] + (-1,))
    x = _srv_attn_out_ffn(prm, nm, x, o, cd, shard)
    return x, kh, vh


def lm_forward(prm: Params, tokens: torch.Tensor, *, n_heads: int,
               n_layers: int, cd=None, collect_kv: bool = False,
               head_dim=None, shard=None):
    """Full causal forward over tokens [N, T]: returns (final-layernormed
    x [N, T, D], per-layer [(kh, vh)] head-major K/V when ``collect_kv``
    else None).  ``prm`` must already be cast via ``_srv_cast_params``, or
    be a rank's view of its shards (``serving.mesh.ShardedParams``, with
    ``n_heads`` the rank's heads of width ``head_dim`` and its
    ``shard``)."""
    tok = prm["tok_emb"]
    cd = cd or tok.dtype
    Dh = head_dim or tok.shape[1] // n_heads
    scale = 1.0 / math.sqrt(Dh)
    tokens = tokens.long()
    T = tokens.shape[1]
    x = (tok[tokens] + prm["pos_emb"][None, :T]).to(cd)
    kvs = [] if collect_kv else None
    for i in range(n_layers):
        x, kh, vh = _srv_block_full(prm, f"blk{i}", x, n_heads, Dh, scale, cd,
                                    shard)
        if collect_kv:
            kvs.append((kh, vh))
    x = _srv_ln(x, prm["lnf.g"], prm["lnf.b"], cd)
    return x, kvs


def _srv_head(head_w, x, shard=None):
    """float32 logits of hidden states x [..., D] against ``head_w`` [V, D]
    (operands upcast: a bfloat16 matmul would return bfloat16); under
    ``shard`` the rank's vocab block, gathered."""
    w = head_w.to(torch.float32).t()
    if shard is None:
        return torch.matmul(x.to(torch.float32), w)
    return shard.head_gather(torch.matmul(x.to(torch.float32),
                                          shard.vocab_block(w)))


def lm_head_logits(prm: Params, x: torch.Tensor,
                   tie_embeddings: bool = True, shard=None) -> torch.Tensor:
    """LM head over hidden states x [..., D] -> float32 logits [..., V]."""
    return _srv_head(prm["tok_emb"] if tie_embeddings
                     else prm["lm_head.w"].t(), x, shard)


def _srv_block_decode(prm, nm, i, x, ck, cv, t, n_heads, Dh, scale, cd):
    """One decode position through layer ``i`` against the dense caches:
    x [M, D], caches [M, L, H, T_max, Dh]; writes this position's K/V into
    slot ``t`` (a Python int or a one-element tensor) and attends to slots
    <= t."""
    q, k, v = _srv_qkv(prm, nm, x, cd)
    ck = _ops.cache_set(ck, i, t, k.reshape(-1, n_heads, Dh))
    cv = _ops.cache_set(cv, i, t, v.reshape(-1, n_heads, Dh))
    o = _ops.decode_attention(q.reshape(-1, n_heads, Dh), ck[:, i], cv[:, i],
                              t + 1, scale=scale, out_dtype=cd)
    x = _srv_attn_out_ffn(prm, nm, x, o.reshape(x.shape), cd)
    return x, ck, cv


def lm_decode_step(prm: Params, token, pos, ck, cv, *, n_heads: int,
                   n_layers: int, cd=None, tie_embeddings: bool = True):
    """One KV-cached decode step over the dense caches: ``token`` [N]
    int32, ``pos`` the cache slot it occupies (a Python int or a
    one-element tensor on the device), caches [N, L, H, T_max, Dh],
    written in place.  Returns (logits [N, V] float32, ck, cv)."""
    cd = cd or prm["tok_emb"].dtype
    d_model = prm["tok_emb"].shape[1]
    Dh = d_model // n_heads
    scale = 1.0 / math.sqrt(Dh)
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(1).long()
        pe = prm["pos_emb"].index_select(0, pos)
    else:
        pe = prm["pos_emb"][int(pos)][None]
    x = (prm["tok_emb"][token.long()] + pe).to(cd)
    for i in range(n_layers):
        x, ck, cv = _srv_block_decode(prm, f"blk{i}", i, x, ck, cv, pos,
                                      n_heads, Dh, scale, cd)
    x = _srv_ln(x, prm["lnf.g"], prm["lnf.b"], cd)
    return lm_head_logits(prm, x, tie_embeddings), ck, cv


def paged_window_coords(tables, pos0, limits, W: int, block_size: int,
                        trash: int):
    """(pos, blk, off) [S, W]: the positions of a decode window of W tokens
    a slot from ``pos0`` [S] and their arena coordinates through the block
    ``tables`` [S, n_tbl]; a position at or past its slot's ``limits``
    maps to the ``trash`` block."""
    tables, pos0, limits = tables.long(), pos0.long(), limits.long()
    S, n_tbl = tables.shape
    rows = torch.arange(S, device=tables.device)
    pos = pos0[:, None] + torch.arange(W, device=tables.device)[None, :]
    blk = tables[rows[:, None], torch.clamp(pos // block_size,
                                            max=n_tbl - 1)]
    blk = torch.where(pos < limits[:, None], blk, torch.full_like(blk, trash))
    return pos, blk, pos % block_size


def _srv_block_paged(prm, nm, i, x, pk, pv, blk, off, tables, lengths,
                     hshape, scale, cd, shard=None, kv_out=None):
    """A decode window through layer ``i`` against the paged pool: x [S, D]
    with blk/off/lengths [S] (W = 1, the plain step) or x [S, W, D] with
    them [S, W]; ``hshape`` the head-major form of q, k and v.  Every
    row's K/V is written before any row attends (write-then-attend), then
    each row attends causally over its slot's blocks through the paged
    attention kernel (its plain version on CPU tensors).  ``kv_out`` =
    (k, v) [L, S, W, H, Dh]: this layer's new rows are copied there too."""
    q, k, v = _srv_qkv(prm, nm, x, cd)
    kh, vh = k.reshape(hshape), v.reshape(hshape)
    if kv_out is not None:
        kv_out[0][i].copy_(kh.reshape(kv_out[0][i].shape))
        kv_out[1][i].copy_(vh.reshape(kv_out[1][i].shape))
    set_kv = (_ops.paged_cache_set if x.dim() == 2
              else _ops.paged_cache_set_window)
    pk = set_kv(pk, i, blk, off, kh)
    pv = set_kv(pv, i, blk, off, vh)
    o = _ops.paged_attention(q.reshape(hshape), pk, pv, i, tables, lengths,
                             scale=scale, out_dtype=cd)
    x = _srv_attn_out_ffn(prm, nm, x, o.reshape(x.shape[:-1] + (-1,)), cd,
                          shard)
    return x, pk, pv


def lm_paged_decode_window(prm: Params, toks, pos0, tables, limits, pk, pv, *,
                           n_heads: int, n_layers: int, block_size: int,
                           cd=None, tie_embeddings: bool = True,
                           head_dim=None, shard=None, kv_out=None):
    """A decode window of W tokens per slot against the paged KV pool:
    ``toks`` [S, W] (W = 1 is the plain step, W > 1 the speculative verify
    window), ``pos0`` [S] each slot's first window position, ``tables``
    [S, n_tbl] block tables, ``limits`` [S] each slot's total-length budget
    (0 for an empty slot), pk/pv the arenas (written in place).  Window
    position j of slot s lands at pos0[s] + j and attends to positions
    < pos0[s] + j + 1.  Positions at or past the slot's limit write to the
    trash block.  Returns (logits [S, W, V] float32, pk, pv).  ``prm``,
    ``n_heads``, ``head_dim`` and ``shard`` as ``lm_forward``'s (the
    arenas then hold the rank's heads); ``kv_out`` as
    ``_srv_block_paged``'s."""
    tok, pe = prm["tok_emb"], prm["pos_emb"]
    cd = cd or tok.dtype
    Dh = head_dim or tok.shape[1] // n_heads
    scale = 1.0 / math.sqrt(Dh)
    toks, tables = toks.long(), tables.long()
    S, W = toks.shape
    pos, blk, off = paged_window_coords(tables, pos0, limits, W, block_size,
                                        _ops.pool_arena(pk).shape[0] - 1)
    x = (tok[toks] + pe[torch.clamp(pos, max=pe.shape[0] - 1)]).to(cd)
    if W == 1:
        # the plain step's forms: rows [S, D]
        x, pos, blk, off = x[:, 0], pos[:, 0], blk[:, 0], off[:, 0]
        hshape = (S, n_heads, Dh)
    else:
        hshape = (S, W, n_heads, Dh)
    for i in range(n_layers):
        x, pk, pv = _srv_block_paged(prm, f"blk{i}", i, x, pk, pv, blk, off,
                                     tables, pos + 1, hshape, scale, cd,
                                     shard, kv_out)
    x = _srv_ln(x, prm["lnf.g"], prm["lnf.b"], cd)
    y = _srv_head(tok if tie_embeddings else prm["lm_head.w"].t(), x, shard)
    return (y[:, None, :] if W == 1 else y), pk, pv


def generate(
    prompt: Variable,
    vocab_size: int,
    max_len: int,
    eos_id: int,
    d_model: int = 512,
    n_heads: int = 8,
    n_layers: int = 6,
    d_ff: int = 2048,
    beam_size: int = 4,
    max_gen: int = 32,
    tie_embeddings: bool = True,
    length_penalty: float = 0.0,
    decode_dtype: str = "bfloat16",
):
    """Beam generation with a KV-cached incremental decode, as ONE program
    op: a prefill over ``prompt`` [N, Tp] (all positions real tokens) fills
    dense head-major caches [N*K, L, H, Tp + max_gen, Dh], then
    ``layers.beam.beam_loop`` drives ``lm_decode_step`` one token a step.
    Shares parameters with ``build_lm`` by name.  Returns (tokens [N, beam,
    max_gen] int32, scores [N, beam], lens [N, beam] int32), best first.

    ``decode_dtype`` is the compute and cache dtype of the loop (default
    bfloat16); layernorm statistics, scores, softmax and logits stay
    float32.  "float32" agrees token for token with the full forward."""
    from ..layers import beam as beam_lib
    from .weights import torch_dtype  # weights imports this module

    helper = LayerHelper("transformer_generate")
    T_total = int(prompt.shape[1]) + max_gen
    if T_total > max_len:
        raise ValueError(
            f"prompt length {int(prompt.shape[1])} + max_gen {max_gen} "
            f"exceeds the positional-embedding table max_len={max_len}")
    Dh = d_model // n_heads
    scale = 1.0 / math.sqrt(Dh)
    p = {}
    for n, shape in lm_param_shapes(vocab_size, max_len, d_model, n_heads,
                                    n_layers, d_ff, tie_embeddings).items():
        p[n] = helper.create_parameter(ParamAttr(name=n), list(shape),
                                       is_bias=n.endswith(".b"))
    pnames = sorted(p)

    def fn(ins, attrs, ctx):
        cd = torch_dtype(decode_dtype)
        prm = _srv_cast_params(dict(zip(pnames, ins["Param"])), cd)
        prompt_v = ins["Prompt"][0].long()
        N, Tp = prompt_v.shape
        dev = prompt_v.device
        # the prefill covers prompt[:, :-1]; its last token is the loop's
        # first input, at position Tp - 1
        ck, cv = _ops.init_kv_cache(N, n_layers, n_heads, T_total, Dh, cd,
                                    device=dev)
        if Tp > 1:
            x = (prm["tok_emb"][prompt_v[:, :-1]]
                 + prm["pos_emb"][None, :Tp - 1]).to(cd)
            for i in range(n_layers):
                x, kh, vh = _srv_block_full(prm, f"blk{i}", x, n_heads, Dh,
                                            scale, cd)
                _ops.cache_set_prefix(ck, i, kh)
                _ops.cache_set_prefix(cv, i, vh)

        def step_fn(last, states):
            pos, ck, cv = states          # every row advances in lockstep
            logits, ck, cv = lm_decode_step(
                prm, last, pos[:1], ck, cv, n_heads=n_heads,
                n_layers=n_layers, cd=cd, tie_embeddings=tie_embeddings)
            return torch.log_softmax(logits, dim=-1), (pos + 1, ck, cv)

        pos0 = torch.full((N,), Tp - 1, dtype=torch.int32, device=dev)
        tokens, scores, lens = beam_lib.beam_loop(
            step_fn, (pos0, ck, cv), N, bos_id=prompt_v[:, -1].int(),
            eos_id=eos_id, beam_size=beam_size, max_len=max_gen,
            length_penalty=length_penalty, device=dev)
        return {"Out": [tokens, scores, lens]}

    block = helper.block
    out_tok = block.create_var(unique_name.generate("tfgen.tokens"),
                               (None, beam_size, max_gen), "int32")
    out_sc = block.create_var(unique_name.generate("tfgen.scores"),
                              (None, beam_size), "float32")
    out_len = block.create_var(unique_name.generate("tfgen.lens"),
                               (None, beam_size), "int32")
    block.append_op(Op(
        "transformer_generate",
        {"Prompt": [prompt.name], "Param": [p[n].name for n in pnames]},
        {"Out": [out_tok.name, out_sc.name, out_len.name]},
        {"beam_size": beam_size, "max_gen": max_gen}, fn))
    return out_tok, out_sc, out_len


class TransformerLM(nn.Module):
    """The serving LM on one device: the cast parameters (held in a plain
    dict under their JAX names) and the forward forms the engine runs.
    On a rank of a serving mesh ``params`` is the rank's view of its
    shards (``serving.mesh.ShardedParams``), ``n_heads`` the rank's heads
    of width ``head_dim`` and ``shard`` its tensor-parallel hooks.
    Inference only: nothing here tracks gradients."""

    def __init__(self, params: Params, *, n_heads: int, n_layers: int,
                 tie_embeddings: bool = True, cd=None, head_dim=None,
                 shard=None):
        super().__init__()
        self.prm = params
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.tie_embeddings = bool(tie_embeddings)
        self.cd = cd or params["tok_emb"].dtype
        self.head_dim = head_dim
        self.shard = shard

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, collect_kv: bool = False):
        """Dense causal forward: (x [N, T, D], per-layer K/V or None)."""
        return lm_forward(self.prm, tokens, n_heads=self.n_heads,
                          n_layers=self.n_layers, cd=self.cd,
                          collect_kv=collect_kv, head_dim=self.head_dim,
                          shard=self.shard)

    @torch.no_grad()
    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 LM-head logits of hidden states x [..., D]."""
        return lm_head_logits(self.prm, x, self.tie_embeddings, self.shard)

    @torch.no_grad()
    def decode_window(self, toks, pos0, tables, limits, pk, pv, *,
                      block_size: int, kv_out=None):
        """``lm_paged_decode_window`` on this model's parameters."""
        return lm_paged_decode_window(
            self.prm, toks, pos0, tables, limits, pk, pv,
            n_heads=self.n_heads, n_layers=self.n_layers,
            block_size=block_size, cd=self.cd,
            tie_embeddings=self.tie_embeddings, head_dim=self.head_dim,
            shard=self.shard, kv_out=kv_out)
