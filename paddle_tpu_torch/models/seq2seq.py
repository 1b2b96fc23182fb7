"""Seq2seq with attention and beam-search generation (PyTorch port of
``paddle_tpu/models/seq2seq.py``; ref: fluid book machine_translation,
``BASELINE.json`` configs[2]).

Training is the layer DSL end to end: a bidirectional GRU encoder and an
attention decoder as a DynamicRNN with the encoder states as static
inputs.  Generation is one ``beam_search`` op over a torch step function
(``layers/beam.py``).  The JAX package runs the GRU recurrences, the
attention step and the beam loop as XLA (``lax.scan``,
``lax.while_loop``), no Pallas kernel, so the plain torch code here is the
port's version on the card as on the CPU; ``Executor.warm`` captures each
step whole as one CUDA graph.  Parameters are created in the JAX
package's order under its names, so the same model built in both packages
has the same persistable names and ``load_scope`` carries weights across.
"""
from __future__ import annotations

import torch

from .. import layers
from ..layers import beam as beam_lib
from ..layers import control_flow as cf
from ..layers import sequence as seq
from ..layers.helper import LayerHelper


def encoder(src_ids, src_len, vocab_size, emb_dim=256, hidden=512):
    """Embedding, a forward and a reverse GRU over their own projections,
    concatenated: [N, Ts, 2H]."""
    emb = layers.embedding(src_ids, [vocab_size, emb_dim])
    fwd_proj = layers.fc(emb, 3 * hidden, num_flatten_dims=2, bias_attr=False)
    fwd, _ = seq.dynamic_gru(fwd_proj, src_len, hidden)
    bwd_proj = layers.fc(emb, 3 * hidden, num_flatten_dims=2, bias_attr=False)
    bwd, _ = seq.dynamic_gru(bwd_proj, src_len, hidden, is_reverse=True)
    return layers.concat([fwd, bwd], axis=2)


def _attend(dp, ep, es):
    """The additive attention score and context: dp [N, D] the projected
    decoder state, ep / es [N, Ts, D] the projected and plain encoder
    states."""
    e = torch.tanh(ep + dp[:, None, :])                 # [N, Ts, D]
    a = torch.softmax(torch.sum(e, dim=-1), dim=-1)     # simplified score
    return torch.einsum("nt,ntd->nd", a, es)


def _attention_step(dec_state, enc_proj, enc_states, att_w_name):
    """Bahdanau-style additive attention from layers (ref:
    trainer_config_helpers/networks.py simple_attention)."""
    dec_proj = layers.fc(dec_state, enc_proj.shape[-1], bias_attr=False,
                         param_attr=None)
    helper = LayerHelper("attention_score")
    return helper.append_op(lambda ctx, dp, ep, es: _attend(dp, ep, es),
                            {"Dp": [dec_proj], "Ep": [enc_proj],
                             "Es": [enc_states]})


def train_net(src_ids, src_len, tgt_ids, tgt_len, labels, src_vocab,
              tgt_vocab, emb_dim=256, hidden=512):
    """The teacher-forced training graph: ``tgt_ids`` are the decoder
    inputs (<s> w1 w2 ...), ``labels`` the shifted targets.  Returns the
    loss averaged over the valid target tokens."""
    enc = encoder(src_ids, src_len, src_vocab, emb_dim, hidden)
    enc_proj = layers.fc(enc, hidden, num_flatten_dims=2, bias_attr=False)
    dec_boot = layers.fc(seq.sequence_pool(enc, src_len, "last"), hidden,
                         act="tanh")

    tgt_emb = layers.embedding(tgt_ids, [tgt_vocab, emb_dim])

    rnn = cf.DynamicRNN()
    with rnn.step():
        x_t = rnn.step_input(tgt_emb)
        h = rnn.memory(init=dec_boot)
        enc_s = rnn.static_input(enc)
        enc_p = rnn.static_input(enc_proj)
        ctx_vec = _attention_step(h, enc_p, enc_s, None)
        inp = layers.concat([x_t, ctx_vec], axis=1)
        gru_in = layers.fc(inp, 3 * hidden, bias_attr=False)
        nh = seq.gru_unit(gru_in, h, hidden)
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    dec_hidden, = rnn(lengths=tgt_len)

    logits = layers.fc(dec_hidden, tgt_vocab, num_flatten_dims=2)
    ce = layers.softmax_with_cross_entropy(logits, labels)
    # mask the padded target positions; average over the valid tokens
    helper = LayerHelper("masked_token_loss")

    def fn(ctx, ce_v, ln):
        T = ce_v.shape[1]
        m = (torch.arange(T, device=ce_v.device)[None, :]
             < ln[:, None]).to(ce_v.dtype)
        return torch.sum(ce_v.squeeze(-1) * m) / torch.clamp_min(
            torch.sum(m), 1.0)

    return helper.append_op(fn, {"CE": [ce], "Len": [tgt_len]})


def beam_search_decoder(src_ids, src_len, src_vocab, tgt_vocab, bos_id,
                        eos_id, beam_size=4, max_len=32, emb_dim=256,
                        hidden=512, length_penalty=0.0):
    """Beam generation over the attention-GRU decoder through the generic
    ``layers.beam.beam_search`` op, with its own parameters.  Returns
    (token ids [N, beam, max_len], scores [N, beam]), beams best-first; the
    op's third output, the lengths, is ``beam_search_decode``'s input for
    the 1-best."""
    enc = encoder(src_ids, src_len, src_vocab, emb_dim, hidden)
    enc_proj = layers.fc(enc, hidden, num_flatten_dims=2, bias_attr=False)
    dec_boot = layers.fc(seq.sequence_pool(enc, src_len, "last"), hidden,
                         act="tanh")

    helper = LayerHelper("beam_search")
    emb_w = helper.create_parameter(None, [tgt_vocab, emb_dim], "float32")
    gru_in_w = helper.create_parameter(
        None, [emb_dim + enc.shape[-1], 3 * hidden], "float32")
    gru_w = helper.create_parameter(None, [hidden, 3 * hidden], "float32")
    gru_b = helper.create_parameter(None, [3 * hidden], "float32",
                                    is_bias=True)
    out_w = helper.create_parameter(None, [hidden, tgt_vocab], "float32")
    out_b = helper.create_parameter(None, [tgt_vocab], "float32",
                                    is_bias=True)
    attn_w = helper.create_parameter(None, [hidden, hidden], "float32")
    H = hidden

    def step_fn(last, states, statics, params):
        (h,) = states
        enc_b, encp_b = statics
        emb, giw, gw, gb, ow, ob, aw = params
        x = emb[last.long()]                                 # [M, E]
        ctxv = _attend(h @ aw, encp_b, enc_b)
        xg = torch.cat([x, ctxv], -1) @ giw + gb
        g = xg[:, :2 * H] + h @ gw[:, :2 * H]
        u, r = torch.chunk(torch.sigmoid(g), 2, dim=-1)
        cand = torch.tanh(xg[:, 2 * H:] + (r * h) @ gw[:, 2 * H:])
        hn = u * h + (1 - u) * cand
        logp = torch.log_softmax(hn @ ow + ob, dim=-1)       # [M, V]
        return logp, [hn]

    out_tok, out_sc, _ = beam_lib.beam_search(
        step_fn, [dec_boot], [enc, enc_proj],
        [emb_w, gru_in_w, gru_w, gru_b, out_w, out_b, attn_w],
        bos_id, eos_id, beam_size, max_len, length_penalty=length_penalty)
    return out_tok, out_sc


__all__ = ["beam_search_decoder", "encoder", "train_net"]
