"""Decoder-only Transformer LM (PyTorch port of
``paddle_tpu/models/transformer.py``): the training graph ``build_lm`` over
the Program API, and the serving block math (the ``_srv_*`` section).

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
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import layers
from .. import ops as _ops
from ..core.program import Variable
from ..initializer import Normal
from ..layers.helper import LayerHelper
from ..param_attr import ParamAttr

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
    """[N, T, H*D] q/k/v -> attention output [N, T, H*D], one op that runs
    ``ops.flash_attention`` (the hand-written kernels on the card).
    Sequence parallelism (``use_sp``) is ROADMAP A.9 and raises."""
    if use_sp:
        raise NotImplementedError(
            "use_sp (ring / Ulysses sequence parallelism) is not ported yet: "
            "parallelism is ROADMAP A.9")
    if sp_strategy not in ("ring", "ring_striped", "ulysses"):
        raise ValueError(f"unknown sp_strategy {sp_strategy!r}: "
                         f"ring | ring_striped | ulysses")
    helper = LayerHelper("attention")

    def fn(ctx, qv, kv, vv, causal, n_heads, use_sp, sp_strategy):
        N, T, HD = qv.shape
        D = HD // n_heads

        def heads(z):
            return z.reshape(N, z.shape[1], n_heads, D).transpose(1, 2)

        out = _ops.flash_attention(heads(qv), heads(kv), heads(vv),
                                   causal=causal)
        return out.transpose(1, 2).reshape(N, T, HD)

    return helper.append_op(fn, {"Q": [q], "K": [k], "V": [v]},
                            attrs={"causal": causal, "n_heads": n_heads,
                                   "use_sp": use_sp, "sp_strategy": sp_strategy})


def transformer_block(x, d_model: int, n_heads: int, d_ff: int, causal=True,
                      dropout=0.0, use_tp=False, use_sp=False,
                      sp_strategy="ring", name=""):
    """Pre-LN block with deterministic parameter names (``{name}.q.w``,
    ...), the names ``lm_param_shapes`` lists."""
    if use_tp:
        raise NotImplementedError(
            "use_tp (Megatron tensor parallelism) is not ported yet: "
            "parallelism is ROADMAP A.9")
    if dropout > 0:
        raise NotImplementedError(
            "dropout > 0 is not ported yet: dropout with its generator is "
            "ROADMAP A.6")

    def pa(suffix):
        return ParamAttr(name=f"{name}.{suffix}")

    h = layers.layer_norm(x, begin_norm_axis=2, param_attr=pa("ln1.g"),
                          bias_attr=pa("ln1.b"))
    q = layers.fc(h, d_model, num_flatten_dims=2, bias_attr=False,
                  name=f"{name}.q", param_attr=pa("q.w"))
    k = layers.fc(h, d_model, num_flatten_dims=2, bias_attr=False,
                  name=f"{name}.k", param_attr=pa("k.w"))
    v = layers.fc(h, d_model, num_flatten_dims=2, bias_attr=False,
                  name=f"{name}.v", param_attr=pa("v.w"))
    att = attention_core(q, k, v, causal, n_heads, use_sp, sp_strategy)
    att = layers.fc(att, d_model, num_flatten_dims=2, name=f"{name}.o",
                    param_attr=pa("o.w"), bias_attr=pa("o.b"))
    x = layers.elementwise_add(x, att)
    h2 = layers.layer_norm(x, begin_norm_axis=2, param_attr=pa("ln2.g"),
                           bias_attr=pa("ln2.b"))
    f = layers.fc(h2, d_ff, num_flatten_dims=2, act="gelu", name=f"{name}.ff1",
                  param_attr=pa("ff1.w"), bias_attr=pa("ff1.b"))
    f = layers.fc(f, d_model, num_flatten_dims=2, name=f"{name}.ff2",
                  param_attr=pa("ff2.w"), bias_attr=pa("ff2.b"))
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
    ``remat``, ``dropout > 0``, ``use_tp`` and ``use_sp`` are not ported
    yet and raise (ROADMAP A.6 recompute and dropout, A.9 parallelism)."""
    if remat:
        raise NotImplementedError(
            "remat=True (layers.recompute) is not ported yet: recompute is "
            "ROADMAP A.6")
    if dropout > 0:
        raise NotImplementedError(
            "dropout > 0 is not ported yet: dropout with its generator is "
            "ROADMAP A.6")
    if use_tp or use_sp:
        raise NotImplementedError(
            "use_tp / use_sp are not ported yet: parallelism is ROADMAP A.9")
    emb_attr = ParamAttr(name="tok_emb", initializer=Normal(0.0, 0.02))
    x = layers.embedding(tokens, [vocab_size, d_model], param_attr=emb_attr)
    pos_attr = ParamAttr(name="pos_emb", initializer=Normal(0.0, 0.02))
    helper = LayerHelper("pos_embed")
    pos_w = helper.create_parameter(pos_attr, [max_len, d_model], x.dtype)

    def add_pos(ctx, h, pw):
        return h + pw[None, : h.shape[1]]

    x = helper.append_op(add_pos, {"X": [x], "Pos": [pos_w]})
    for i in range(n_layers):
        x = transformer_block(x, d_model, n_heads, d_ff, causal=True,
                              sp_strategy=sp_strategy, name=f"blk{i}")
    x = layers.layer_norm(x, begin_norm_axis=2, param_attr=ParamAttr(name="lnf.g"),
                          bias_attr=ParamAttr(name="lnf.b"))
    if tie_embeddings:
        helper2 = LayerHelper("lm_head")

        def head(ctx, h, w):
            return torch.matmul(h, w.t())

        logits = helper2.append_op(head, {"X": [x], "W": [helper.block.var("tok_emb")]})
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


def _srv_qkv(prm, nm, x, cd):
    h = _srv_ln(x, prm[f"{nm}.ln1.g"], prm[f"{nm}.ln1.b"], cd)
    return tuple(_srv_mmul(h, prm[f"{nm}.{s}.w"], cd) for s in ("q", "k", "v"))


def _srv_attn_out_ffn(prm, nm, x, o, cd):
    """Output projection + residual, then the FFN sublayer."""
    x = x + _srv_mmul(o, prm[f"{nm}.o.w"], cd) + prm[f"{nm}.o.b"].to(cd)
    h2 = _srv_ln(x, prm[f"{nm}.ln2.g"], prm[f"{nm}.ln2.b"], cd)
    f = F.gelu(_srv_mmul(h2, prm[f"{nm}.ff1.w"], cd)
               + prm[f"{nm}.ff1.b"].to(cd), approximate="tanh")
    return x + _srv_mmul(f, prm[f"{nm}.ff2.w"], cd) + prm[f"{nm}.ff2.b"].to(cd)


def _srv_block_full(prm, nm, x, n_heads, Dh, scale, cd):
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
    o = o.transpose(-3, -2).reshape(x.shape)
    x = _srv_attn_out_ffn(prm, nm, x, o, cd)
    return x, kh, vh


def lm_forward(prm: Params, tokens: torch.Tensor, *, n_heads: int,
               n_layers: int, cd=None, collect_kv: bool = False):
    """Full causal forward over tokens [N, T]: returns (final-layernormed
    x [N, T, D], per-layer [(kh, vh)] head-major K/V when ``collect_kv``
    else None).  ``prm`` must already be cast via ``_srv_cast_params``."""
    cd = cd or prm["tok_emb"].dtype
    d_model = prm["tok_emb"].shape[1]
    Dh = d_model // n_heads
    scale = 1.0 / math.sqrt(Dh)
    tokens = tokens.long()
    T = tokens.shape[1]
    x = (prm["tok_emb"][tokens] + prm["pos_emb"][None, :T]).to(cd)
    kvs = [] if collect_kv else None
    for i in range(n_layers):
        x, kh, vh = _srv_block_full(prm, f"blk{i}", x, n_heads, Dh, scale, cd)
        if collect_kv:
            kvs.append((kh, vh))
    x = _srv_ln(x, prm["lnf.g"], prm["lnf.b"], cd)
    return x, kvs


def lm_head_logits(prm: Params, x: torch.Tensor,
                   tie_embeddings: bool = True) -> torch.Tensor:
    """LM head over hidden states x [..., D] -> float32 logits [..., V]
    (operands upcast: a bfloat16 matmul would return bfloat16)."""
    head_w = prm["tok_emb"] if tie_embeddings else prm["lm_head.w"].t()
    return torch.matmul(x.to(torch.float32), head_w.to(torch.float32).t())


def _srv_block_decode_paged1(prm, nm, i, x, pk, pv, blk, off, tables,
                             lengths, n_heads, Dh, scale, cd):
    """One decode position per slot through layer ``i`` against the paged
    pool: x [S, D]; write this position's K/V, then attend through the paged
    attention kernel (its plain version on CPU tensors)."""
    q, k, v = _srv_qkv(prm, nm, x, cd)
    pk = _ops.paged_cache_set(pk, i, blk, off, k.reshape(-1, n_heads, Dh))
    pv = _ops.paged_cache_set(pv, i, blk, off, v.reshape(-1, n_heads, Dh))
    o = _ops.paged_attention(q.reshape(-1, n_heads, Dh), pk, pv, i, tables,
                             lengths, scale=scale, out_dtype=cd)
    x = _srv_attn_out_ffn(prm, nm, x, o.reshape(x.shape), cd)
    return x, pk, pv


def _srv_block_decode_paged(prm, nm, i, x, pk, pv, blk, off, tables, lengths,
                            n_heads, Dh, scale, cd):
    """A decode WINDOW through layer ``i``: x [S, W, D]; blk/off [S, W]
    arena coordinates; lengths [S, W].  Every row's K/V is written before
    any row attends (write-then-attend), then each window row attends
    causally over its slot's blocks."""
    q, k, v = _srv_qkv(prm, nm, x, cd)
    S, W, _ = x.shape

    def heads(z):
        return z.reshape(S, W, n_heads, Dh)

    pk = _ops.paged_cache_set_window(pk, i, blk, off, heads(k))
    pv = _ops.paged_cache_set_window(pv, i, blk, off, heads(v))
    o = _ops.paged_attention(heads(q), pk, pv, i, tables, lengths,
                             scale=scale, out_dtype=cd)
    x = _srv_attn_out_ffn(prm, nm, x, o.reshape(S, W, -1), cd)
    return x, pk, pv


def lm_paged_decode_window(prm: Params, toks, pos0, tables, limits, pk, pv, *,
                           n_heads: int, n_layers: int, block_size: int,
                           cd=None, tie_embeddings: bool = True):
    """A decode window of W tokens per slot against the paged KV pool:
    ``toks`` [S, W] (W = 1 is the plain step, W > 1 the speculative verify
    window), ``pos0`` [S] each slot's first window position, ``tables``
    [S, n_tbl] block tables, ``limits`` [S] each slot's total-length budget
    (0 for an empty slot), pk/pv the arenas (written in place).  Window
    position j of slot s lands at pos0[s] + j and attends to positions
    < pos0[s] + j + 1.  Positions at or past the slot's limit write to the
    trash block.  Returns (logits [S, W, V] float32, pk, pv)."""
    cd = cd or prm["tok_emb"].dtype
    d_model = prm["tok_emb"].shape[1]
    max_len = prm["pos_emb"].shape[0]
    Dh = d_model // n_heads
    scale = 1.0 / math.sqrt(Dh)
    toks, pos0 = toks.long(), pos0.long()
    tables, limits = tables.long(), limits.long()
    S, W = toks.shape
    n_tbl = tables.shape[1]
    trash = _ops.pool_arena(pk).shape[0] - 1
    rows = torch.arange(S, device=toks.device)
    if W == 1:
        pos = pos0
        blk = tables[rows, torch.clamp(pos // block_size, max=n_tbl - 1)]
        blk = torch.where(pos < limits, blk, torch.full_like(blk, trash))
        off = pos % block_size
        x = (prm["tok_emb"][toks[:, 0]]
             + prm["pos_emb"][torch.clamp(pos, max=max_len - 1)]).to(cd)
        for i in range(n_layers):
            x, pk, pv = _srv_block_decode_paged1(
                prm, f"blk{i}", i, x, pk, pv, blk, off, tables, pos + 1,
                n_heads, Dh, scale, cd)
        x = _srv_ln(x, prm["lnf.g"], prm["lnf.b"], cd)
        return lm_head_logits(prm, x, tie_embeddings)[:, None, :], pk, pv
    pos = pos0[:, None] + torch.arange(W, device=toks.device)[None, :]
    blk = tables[rows[:, None], torch.clamp(pos // block_size, max=n_tbl - 1)]
    blk = torch.where(pos < limits[:, None], blk, torch.full_like(blk, trash))
    off = pos % block_size
    x = (prm["tok_emb"][toks]
         + prm["pos_emb"][torch.clamp(pos, max=max_len - 1)]).to(cd)
    for i in range(n_layers):
        x, pk, pv = _srv_block_decode_paged(
            prm, f"blk{i}", i, x, pk, pv, blk, off, tables, pos + 1,
            n_heads, Dh, scale, cd)
    x = _srv_ln(x, prm["lnf.g"], prm["lnf.b"], cd)
    return lm_head_logits(prm, x, tie_embeddings), pk, pv


class TransformerLM(nn.Module):
    """The serving LM on one device: the cast parameters (held in a plain
    dict under their JAX names) and the forward forms the engine runs.
    Inference only: nothing here tracks gradients."""

    def __init__(self, params: Params, *, n_heads: int, n_layers: int,
                 tie_embeddings: bool = True):
        super().__init__()
        self.prm = params
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.tie_embeddings = bool(tie_embeddings)
        self.cd = params["tok_emb"].dtype

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, collect_kv: bool = False):
        """Dense causal forward: (x [N, T, D], per-layer K/V or None)."""
        return lm_forward(self.prm, tokens, n_heads=self.n_heads,
                          n_layers=self.n_layers, cd=self.cd,
                          collect_kv=collect_kv)

    @torch.no_grad()
    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """float32 LM-head logits of hidden states x [..., D]."""
        return lm_head_logits(self.prm, x, self.tie_embeddings)

    @torch.no_grad()
    def decode_window(self, toks, pos0, tables, limits, pk, pv, *,
                      block_size: int):
        """``lm_paged_decode_window`` on this model's parameters."""
        return lm_paged_decode_window(
            self.prm, toks, pos0, tables, limits, pk, pv,
            n_heads=self.n_heads, n_layers=self.n_layers,
            block_size=block_size, cd=self.cd,
            tie_embeddings=self.tie_embeddings)
