"""Generic beam-search layers (PyTorch port of ``paddle_tpu/layers/beam.py``;
ref: paddle/operators/beam_search_op.cc, beam_search_decode_op.cc).

The search keeps a dense [batch, beam] frontier and writes tokens into a
static [batch, beam, max_len] buffer, as the JAX package does; the JAX
package runs it as one ``lax.while_loop``, which is XLA, not a Pallas
kernel, so its port is a Python loop of torch ops on the card as on the
CPU.  Two levels:
  - ``beam_loop`` / ``tile_beam``: the torch core;
  - ``beam_search`` / ``beam_search_decode``: layers over Variables,
    parameterized by a torch-level step function.

Two differences from the JAX loop, each giving the same outputs:

* **A fixed number of steps.**  ``lax.while_loop`` stops once every row is
  done; a CUDA graph cannot branch on the device, so this loop always runs
  ``max_len`` steps.  Once every row is done, each further step changes
  nothing: every beam proposes only eos at zero added cost (``_NEG``
  elsewhere), so the candidates at eos are the frontier's own scores, to
  the bit (``s + 0.0 == s``), and the others lie about 1e9 below them.
  The last selection left the frontier sorted best-first, ties by lower
  index, so the selection picks the identity beam order again: the token
  buffer is gathered by the identity, eos is written over the eos it
  was filled with, and scores, lengths and done flags stay as they are.
  (This needs every frontier score above ``_NEG``, about -1e9, plus the
  best score: true once the first step has filled the frontier from beam
  0, which it does whenever the vocabulary has at least ``beam_size``
  tokens.)  The greedy loop (beam 1) writes eos at zero cost into done
  rows already.  So the fixed-count outputs equal the early-exit ones.
* **JAX's top_k order.**  ``jax.lax.top_k`` on the CPU orders values in
  float32's total order (-0.0 below 0.0) and breaks ties toward the lower
  flat index; ``torch.topk`` leaves ties unspecified, and ties are common
  here (a finished beam proposes ``_NEG + score`` for every non-eos
  token).  :func:`top_k` takes ``torch.topk`` of an int64 key that holds
  the value's total-order bits above the complemented index, so the order
  is JAX's and no two keys tie.  The ``length_penalty`` reorder, a stable
  ``argsort`` of the negated scores in JAX, is the same selection.

Ids are int32 at the edges, as the JAX package returns them: tokens, lens
and ``beam_search_decode``'s ids; gathers index with int64.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..core import unique_name
from ..core.program import Op, Variable
from .helper import LayerHelper

_NEG = -1e9


def tile_beam(x: torch.Tensor, beam_size: int) -> torch.Tensor:
    """[N, ...] -> [N*beam, ...], each row repeated beam_size times."""
    return x.repeat_interleave(beam_size, dim=0)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the ``k`` largest entries of each row of a
    float32 ``x`` [R, C], in ``jax.lax.top_k``'s order: float32's total
    order (-0.0 below 0.0), ties toward the lower index."""
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    key = ordered * (1 << 32) + ((1 << 32) - 1 - idx)
    _, pos = torch.topk(key, k, dim=-1)
    return torch.take_along_dim(x, pos, dim=-1), pos


def _bos(bos_id, n: int, device) -> torch.Tensor:
    """bos as an int32 [n]: an int (filled on the device, so that a CUDA
    graph capture copies nothing from the host), or a per-row [n] array
    (prompted generation continues from each row's last prompt token)."""
    if isinstance(bos_id, int):
        return torch.full((n,), bos_id, dtype=torch.int32, device=device)
    return torch.as_tensor(bos_id).to(device=device, dtype=torch.int32)


def _greedy_loop(step_fn, init_states, batch, bos_id, eos_id, max_len,
                 length_penalty, device):
    """beam_size=1 specialisation of beam_loop: the same emission semantics
    (done rows emit eos at zero added cost), no frontier, no state
    gathers."""
    N = batch
    tokens = torch.full((N, 1, max_len), eos_id, dtype=torch.int32,
                        device=device)
    last = _bos(bos_id, N, device)
    scores = torch.zeros((N,), dtype=torch.float32, device=device)
    done = torch.zeros((N,), dtype=torch.bool, device=device)
    lens = torch.zeros((N,), dtype=torch.int32, device=device)
    eos = torch.full((N,), eos_id, dtype=torch.int32, device=device)
    states = tuple(init_states)
    for t in range(max_len):
        logp, states = step_fn(last, states)
        # argmax over scores + logp, not raw logp: the same float32
        # additions as the general path's candidates, so that ties break
        # alike (argmax keeps the first maximum in both packages)
        cand = scores[:, None] + logp
        nxt = torch.argmax(cand, dim=-1)
        new_sc = torch.take_along_dim(cand, nxt[:, None], dim=-1)[:, 0]
        tok = torch.where(done, eos, nxt.to(torch.int32))
        scores = torch.where(done, scores, new_sc)
        tokens[:, 0, t] = tok
        lens = lens + (~done & (tok != eos_id)).to(torch.int32)
        done = done | (tok == eos_id)
        last = tok
    if length_penalty > 0:
        scores = scores / ((5.0 + lens.to(torch.float32)) / 6.0) \
            ** length_penalty
    return tokens, scores[:, None], lens[:, None]


def beam_loop(
    step_fn: Callable,
    init_states: Sequence[torch.Tensor],
    batch: int,
    bos_id,
    eos_id: int,
    beam_size: int,
    max_len: int,
    length_penalty: float = 0.0,
    _force_general: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beam search over a dense [N, K] frontier, ``max_len`` steps (see the
    module docstring for why that equals the JAX package's early exit).

    ``step_fn(last_tokens [N*K] int32, states) -> (logp [N*K, V],
    new_states)`` where every state has leading dim N*K (init_states come
    in as [N, ...] and are beam-tiled here).  Returns (tokens [N, K,
    max_len] int32, scores [N, K] float32, lens [N, K] int32), beams sorted
    best-first; ``lens`` counts tokens before eos; ``length_penalty`` α
    applies GNMT's ((5 + len) / 6)^α at the end.  beam_size=1 takes the
    greedy loop (argmax, no state gathers), with the general path's
    outputs.  ``device`` is where the loop's own tensors live (the first
    state's device when not given)."""
    if device is None:
        device = init_states[0].device
    N, K = batch, beam_size
    if K == 1 and not _force_general:
        return _greedy_loop(step_fn, init_states, batch, bos_id, eos_id,
                            max_len, length_penalty, device)
    M = N * K
    states = tuple(tile_beam(s, K) for s in init_states)
    tokens = torch.full((N, K, max_len), eos_id, dtype=torch.int32,
                        device=device)
    # only beam 0 is live at t=0, else the K copies of the same hypothesis
    # would fill the frontier with duplicates
    scores = torch.full((N, K), _NEG, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    last = _bos(bos_id, N, device)[:, None].expand(N, K)
    done = torch.zeros((N, K), dtype=torch.bool, device=device)
    lens = torch.zeros((N, K), dtype=torch.int32, device=device)
    eos_only = None
    for t in range(max_len):
        logp, new_states = step_fn(last.reshape(M), states)
        V = logp.shape[-1]
        logp = logp.reshape(N, K, V)
        if eos_only is None:
            # masked_fill, not an indexed store: a CUDA graph capture may
            # not copy the host's 0.0 into one element
            eos_only = torch.full((V,), _NEG, dtype=logp.dtype,
                                  device=device).masked_fill_(
                torch.arange(V, device=device) == eos_id, 0.0)
        # finished beams propose only eos at zero added cost (keeps them in
        # the frontier at their final score, as the reference's pruning
        # does)
        logp = torch.where(done[..., None], eos_only, logp)
        cand = scores[..., None] + logp                    # [N, K, V]
        top_s, top_i = top_k(cand.reshape(N, K * V), K)
        beam_idx = top_i // V
        tok = (top_i % V).to(torch.int32)
        tokens = torch.take_along_dim(tokens, beam_idx[..., None], dim=1)
        tokens[:, :, t] = tok

        def resel(s):
            sk = s.reshape((N, K) + tuple(s.shape[1:]))
            bi = beam_idx.reshape((N, K) + (1,) * (sk.dim() - 2))
            return torch.take_along_dim(sk, bi, dim=1).reshape(s.shape)

        states = tuple(resel(s) for s in new_states)
        done_sel = torch.take_along_dim(done, beam_idx, dim=1)
        lens_sel = torch.take_along_dim(lens, beam_idx, dim=1)
        lens = lens_sel + (~done_sel & (tok != eos_id)).to(torch.int32)
        done = done_sel | (tok == eos_id)
        scores, last = top_s, tok
    if length_penalty > 0:
        scores = scores / ((5.0 + lens.to(torch.float32)) / 6.0) \
            ** length_penalty
        # jnp.argsort(-scores) is stable: the same selection as top_k's
        _, order = top_k(scores, K)
        tokens = torch.take_along_dim(tokens, order[..., None], dim=1)
        scores = torch.take_along_dim(scores, order, dim=1)
        lens = torch.take_along_dim(lens, order, dim=1)
    return tokens, scores, lens


def beam_search(
    step_fn: Callable,
    init_states: Sequence[Variable],
    statics: Sequence[Variable],
    params: Sequence[Variable],
    bos_id: int,
    eos_id: int,
    beam_size: int,
    max_len: int,
    length_penalty: float = 0.0,
    name: Optional[str] = None,
) -> Tuple[Variable, Variable, Variable]:
    """Beam-search generation as ONE program op (ref: beam_search_op.cc,
    lifted to a layer parameterized by a step function).

    ``step_fn(last [M] int32, states, statics, params) -> (logp [M, V],
    new_states)`` is a torch-level callable: ``states`` are tensors with
    leading dim M = batch*beam (init_states [N, ...] are beam-tiled),
    ``statics`` beam-tiled read-only tensors (encoder states), ``params``
    the parameter tensors.  Returns Variables (tokens [N, beam, max_len]
    int32, scores [N, beam], lens [N, beam] int32), beams sorted
    best-first."""
    helper = LayerHelper("beam_search", name=name)
    n_states = len(init_states)
    n_statics = len(statics)

    def fn(ins, attrs, ctx):
        state_vals = list(ins.get("State", []))
        static_vals = [tile_beam(s, beam_size) for s in ins.get("Static", [])]
        param_vals = list(ins.get("Param", []))
        N = (state_vals[0].shape[0] if state_vals
             else static_vals[0].shape[0] // beam_size)

        def step(last, states):
            logp, new_states = step_fn(last, list(states), static_vals,
                                       param_vals)
            return logp, tuple(new_states)

        tokens, scores, lens = beam_loop(
            step, state_vals, N, bos_id, eos_id, beam_size, max_len,
            length_penalty=length_penalty, device=ctx.device)
        return {"Out": [tokens, scores, lens]}

    block = helper.block
    out_tok = block.create_var(unique_name.generate("beam.tokens"),
                               (None, beam_size, max_len), "int32")
    out_sc = block.create_var(unique_name.generate("beam.scores"),
                              (None, beam_size), "float32")
    out_len = block.create_var(unique_name.generate("beam.lens"),
                               (None, beam_size), "int32")
    block.append_op(Op(
        "beam_search",
        {"State": [v.name for v in init_states],
         "Static": [v.name for v in statics],
         "Param": [v.name for v in params]},
        {"Out": [out_tok.name, out_sc.name, out_len.name]},
        {"beam_size": beam_size, "max_len": max_len, "bos": bos_id,
         "eos": eos_id, "n_states": n_states, "n_statics": n_statics}, fn))
    return out_tok, out_sc, out_len


def beam_search_decode(
    tokens: Variable,
    scores: Variable,
    lens: Variable,
    name: Optional[str] = None,
) -> Tuple[Variable, Variable, Variable]:
    """Each batch row's best hypothesis (ref: beam_search_decode_op.cc; the
    dense token buffer already holds the hypotheses, so decode is a gather
    over the best beam).  Returns (ids [N, max_len] int32, eos past the
    hypothesis's length; length [N] int32; score [N])."""
    helper = LayerHelper("beam_search_decode", name=name)

    def fn(ctx, tok, sc, ln):
        best = torch.argmax(sc, dim=1)
        ids = torch.take_along_dim(tok, best[:, None, None], dim=1)[:, 0]
        length = torch.take_along_dim(ln, best[:, None], dim=1)[:, 0]
        score = torch.take_along_dim(sc, best[:, None], dim=1)[:, 0]
        return ids, length, score

    outs = helper.append_op(fn, {"Tokens": [tokens], "Scores": [scores],
                                 "Lens": [lens]}, n_outputs=3,
                            axes=(1,))
    return tuple(outs)


__all__ = ["beam_loop", "beam_search", "beam_search_decode", "tile_beam",
           "top_k"]
