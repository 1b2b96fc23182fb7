"""Switch mixture-of-experts with expert parallelism over the ``ep`` mesh
axis (PyTorch port of ``paddle_tpu/parallel/moe.py``).

:func:`switch_moe_apply` is the reference's arithmetic on one device:
top-1 (argmax) routing, each token's position in its expert's buffer the
cumulative count of the tokens before it that chose that expert, tokens
past the capacity dropped (their output 0), the ``[S, E, C]`` dispatch
and combine tensors contracted with the expert-stacked weights, and the
Switch load-balancing loss ``E * sum_e frac_e * mean_p_e``.  The einsums
are plain ``torch.einsum``: the reference computes them outside any
Pallas kernel.

:func:`switch_moe` is the Program layer.  Under a Strategy the JAX
package lets GSPMD place the collectives; here they are explicit:

* a rank holds its ``E / ep`` experts (the Strategy slices ``w1``, ``b1``,
  ``w2``, ``b2`` by their ``P("ep", ...)`` spec) and the tokens of its dp
  rows, the same on every rank of its ep group;
* capacity is the global batch's: ``cap`` counts the global tokens, and a
  token's position is its global cumulative count, the rank's own plus
  the counts of the dp ranks before it (an all-gather of ``[E]`` counts),
  so the same tokens are dropped as on one device; ``frac`` and
  ``mean_p`` of the aux loss are global means (``comm.mean_from``);
* a rank dispatches its tokens to its local experts only, and the sum
  over ep (``comm.reduce_from``) gives each token its expert's output;
* gradients: the combine path is partial on each ep rank and the aux
  loss path whole on each, so one all-reduce over ep cannot serve both.
  The token features and the gate values enter the expert path through
  ``comm.copy_to`` over ep (identity forward, the gradient all-reduced
  over ep); the aux loss reads the probabilities directly.  Every rank
  then ends the step with the single device's gradient for ``gate_w``,
  its expert shard and ``x`` (after the Strategy's average over dp);
* jitter draws the global ``[S, E]`` uniform from ``ctx.rng_key(tag)``
  (``ops/random.py``, bitwise JAX's) and the rank takes its rows;
* a sequence-sharded input (a ``SeqAxis`` on dim 1 of ``x`` [N, T, d]) is
  gathered over its sequence axis into the global order first
  (``comm.gather_shards``), so that the rank routes its dp rows' tokens in
  the order of the unsharded sequence: routing, capacity and the dropped
  tokens are those of JAX's ``switch_moe`` on the whole sequence; the
  output keeps the rank's positions.  The gather's backward sums the
  cotangents over the sequence ranks (``comm.py``'s convention).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..layers.helper import LayerHelper
from ..ops import random as jrandom
from ..param_attr import ParamAttr, PartitionSpec as P, seq_axis_of
from . import comm
from .mesh import mesh_axis_size
from .strategy import shard_order


def _gates(x, gate_w, noise):
    """(probs, gate, onehot) of the tokens ``x``: argmax routing, the
    chosen expert's probability, its one-hot row."""
    logits = x @ gate_w
    if noise is not None:
        logits = logits + noise
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    return probs, gate, F.one_hot(expert, gate_w.shape[1]).to(x.dtype)


def _dispatch(onehot, offset, cap):
    """[S, E, C] 0/1: each token's slot in its expert's buffer, its
    position the tokens before it that chose that expert (``offset`` [E]
    of them on earlier ranks); a token past ``cap`` is dropped."""
    pos = (torch.cumsum(onehot, dim=0) - 1.0 + offset) * onehot
    keep = (pos < cap).to(onehot.dtype) * onehot
    # one_hot of an index past the capacity is a zero row in JAX; the
    # clamped index is masked by keep
    slot = F.one_hot(pos.long().clamp(0, cap - 1), cap).to(onehot.dtype)
    return slot * keep[..., None]


def _capacity(n_tokens, n_experts, capacity_factor) -> int:
    return max(int(n_tokens / n_experts * capacity_factor), 1)


def _experts(xin, w1, b1, w2, b2):
    h = torch.relu(torch.einsum("ecd,edf->ecf", xin, w1) + b1[:, None, :])
    return torch.einsum("ecf,efd->ecd", h, w2) + b2[:, None, :]


def switch_moe_apply(x, gate_w, w1, b1, w2, b2, capacity_factor: float = 1.25,
                     rng=None, jitter: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 (Switch) MoE.  x: [S, d] tokens; gate_w: [d, E]; w1: [E, d, f];
    w2: [E, f, d]; ``rng`` a threefry key (``ops/random.py``) for the
    jitter.  Returns (y [S, d], aux_loss scalar)."""
    S = x.shape[0]
    E = gate_w.shape[1]
    noise = None
    if jitter and rng is not None:
        noise = jrandom.uniform(rng, (S, E), x.dtype, 1.0 - jitter,
                                1.0 + jitter, device=x.device)
    probs, gate, onehot = _gates(x, gate_w, noise)
    dispatch = _dispatch(onehot, 0.0, _capacity(S, E, capacity_factor))
    combine = dispatch * gate[:, None, None]
    xin = torch.einsum("sec,sd->ecd", dispatch, x)
    out = _experts(xin, w1, b1, w2, b2)
    y = torch.einsum("sec,ecd->sd", combine, out)     # dropped tokens -> 0
    frac = torch.mean(onehot, dim=0)
    mean_p = torch.mean(probs, dim=0)
    return y, E * torch.sum(frac * mean_p)


def switch_moe_sharded(x, gate_w, w1, b1, w2, b2, capacity_factor, mesh,
                       layout, axis: str = "ep", noise_fn=None):
    """:func:`switch_moe_apply` of this rank's tokens ``x`` [S_l, d] (its dp
    rows, the same on its ep group) with its ``E / ep`` experts ``w1`` ...
    ``b2`` on ``mesh`` under the step's ``layout``: the same tokens routed
    and dropped as over the global batch on one device.  ``noise_fn(S, E,
    offset)`` gives the rank's rows of the global jitter (or None)."""
    S_l = x.shape[0]
    E = gate_w.shape[1]
    ep = mesh_axis_size(mesh, axis)
    e_local = w1.shape[0]
    if e_local * ep != E:
        raise ValueError(f"switch_moe: {e_local} local experts over "
                         f"{axis}={ep} is not the gate's {E}")
    dp_group = (mesh.group(layout.data_axis)
                if layout is not None and layout.data_axis else None)
    n_dp = comm.size(dp_group) if dp_group is not None else 1
    rank_dp = comm.rank_in(dp_group) if dp_group is not None else 0
    noise = noise_fn(S_l * n_dp, E, rank_dp * S_l) if noise_fn else None
    probs, gate, onehot = _gates(x, gate_w, noise)
    # a token's position counts the tokens of the earlier dp ranks too:
    # the exclusive prefix of their per-expert counts
    offset = 0.0
    if n_dp > 1:
        every = comm.all_gather(onehot.sum(0)[None], dp_group, 0)
        offset = every[:rank_dp].sum(0)
    dispatch = _dispatch(onehot, offset, _capacity(S_l * n_dp, E,
                                                   capacity_factor))
    ep_group = mesh.group(axis) if ep > 1 else None
    lo = (mesh.coord(axis) if ep > 1 else 0) * e_local
    disp = dispatch[:, lo:lo + e_local]
    xe, ge = x, gate
    if ep_group is not None:
        # the expert path's gradients are partial on each ep rank: summed
        # over ep on the way back (the aux path below is whole on each)
        xe, ge = comm.copy_to(x, ep_group), comm.copy_to(gate, ep_group)
    xin = torch.einsum("sec,sd->ecd", disp, xe)
    out = _experts(xin, w1, b1, w2, b2)
    y = torch.einsum("sec,ecd->sd", disp * ge[:, None, None], out)
    if ep_group is not None:
        y = comm.reduce_from(y, ep_group)
    frac = torch.mean(onehot, dim=0)
    mean_p = torch.mean(probs, dim=0)
    if n_dp > 1:
        frac = comm.mean_from(frac, [dp_group])
        mean_p = comm.mean_from(mean_p, [dp_group])
    return y, E * torch.sum(frac * mean_p)


def switch_moe(x, num_experts: int, d_ff: int, capacity_factor: float = 1.25,
               axis: str = "ep", aux_weight: float = 0.01, jitter: float = 0.0,
               param_attr=None, name: Optional[str] = None):
    """Program-level Switch-MoE FFN over ``x`` [N, T, d] (or [N, d]).  Expert
    weights are stacked [E, ...] and sharded over ``axis``; returns
    (y, aux_loss [1]).  ``aux_loss`` is already scaled by ``aux_weight`` —
    add it to the training loss as-is.  A sequence-sharded ``x`` is routed
    on its whole sequence (module docstring)."""
    helper = LayerHelper("switch_moe", name=name)
    d = x.shape[-1]
    seq = seq_axis_of(x)

    def eattr(spec):
        a = ParamAttr.to_attr(param_attr)
        return dataclasses.replace(a, sharding=spec, name=None)

    gate_w = helper.create_parameter(ParamAttr.to_attr(param_attr),
                                     [d, num_experts], x.dtype)
    w1 = helper.create_parameter(eattr(P(axis, None, None)),
                                 [num_experts, d, d_ff], x.dtype)
    b1 = helper.create_parameter(eattr(P(axis, None)), [num_experts, d_ff],
                                 x.dtype, is_bias=True)
    w2 = helper.create_parameter(eattr(P(axis, None, None)),
                                 [num_experts, d_ff, d], x.dtype)
    b2 = helper.create_parameter(eattr(P(axis, None)), [num_experts, d],
                                 x.dtype, is_bias=True)
    tag = helper.main_program.next_rng_tag()

    def fn(ctx, xv, gw, w1v, b1v, w2v, b2v, cf, aw, jit_, tag, _seq=seq):
        lay = ctx.layout
        mine = None
        if lay is not None and lay.sharded(_seq):
            # route the rank's rows on their whole sequence
            order, mine = shard_order(ctx.mesh, _seq, xv.shape[1], xv.device)
            xv = comm.gather_shards(xv, [(1, ctx.mesh.group(_seq), order,
                                          mine, True)])
        shape = xv.shape
        flat = xv.reshape(-1, shape[-1])
        key = (ctx.rng_key(tag) if jit_ and ctx.device.type != "meta"
               else None)
        if ctx.mesh is None:
            y, aux = switch_moe_apply(flat, gw, w1v, b1v, w2v, b2v, cf, key,
                                      jit_)
        else:
            def noise_fn(S, E, offset):
                if key is None:
                    return None
                u = jrandom.uniform(key, (S, E), flat.dtype, 1.0 - jit_,
                                    1.0 + jit_, device=flat.device)
                return u[offset:offset + flat.shape[0]]

            y, aux = switch_moe_sharded(flat, gw, w1v, b1v, w2v, b2v, cf,
                                        ctx.mesh, ctx.layout, axis, noise_fn)
        y = y.reshape(shape)
        if mine is not None:
            y = y.index_select(1, mine)
        return y, (aw * aux)[None]

    out = helper.append_op(
        fn, {"X": [x], "GateW": [gate_w], "W1": [w1], "B1": [b1],
             "W2": [w2], "B2": [b2]},
        attrs={"cf": capacity_factor, "aw": aux_weight, "jit_": jitter,
               "tag": tag},
        n_outputs=2)
    return out[0], out[1]
