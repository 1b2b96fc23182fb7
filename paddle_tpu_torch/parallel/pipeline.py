"""Pipeline parallelism over the ``pp`` mesh axis (PyTorch port of
``paddle_tpu/parallel/pipeline.py``).

The JAX package runs the GPipe schedule as a ``lax.scan`` inside
``shard_map``: each device along ``pp`` holds its contiguous slice of the
stacked stage weights, activations hop stage to stage with
``lax.ppermute``, and JAX differentiates through the scan (the ppermute's
transpose shifts the cotangent back).  Here the same schedule is a Python
loop over ``M + S - 1`` ticks on every rank of the pp group:

* each tick a rank folds its ``n_stages / S`` stages over its input: the
  tick's microbatch on the first rank, what the previous rank sent on the
  others;
* activations hop by ``comm.shift``, the differentiable ring shift (its
  backward shifts the cotangent the other way);
* the last rank keeps its outputs of ticks ``S - 1 ...``; the masked sum
  over pp (``comm.reduce_from``: identity backward) replicates them, and
  the input enters through ``comm.copy_to`` over pp, so every rank's
  upstream gradient is whole.

Every rank builds the same graph: the choices that depend on the rank
(which input, which outputs are kept) are ``torch.where`` over a
rank-dependent flag, not Python branches, so every rank runs every
shift's backward in the same order.  The Strategy has already cut the
feed over dp, so ``gpipe`` pipelines the rank's rows as they are (the
reference's ``data_axis`` slicing is GSPMD's).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..layers.helper import LayerHelper
from ..param_attr import ParamAttr, PartitionSpec as P
from . import comm
from .mesh import mesh_axis_size


def _tree_index(params, s):
    if isinstance(params, (tuple, list)):
        return type(params)(_tree_index(p, s) for p in params)
    return params[s]


def _n_stages(params) -> int:
    while isinstance(params, (tuple, list)):
        params = params[0]
    return int(params.shape[0])


def gpipe(stage_fn: Callable, stacked_params, x, mesh, axis: str = "pp",
          n_microbatches: Optional[int] = None):
    """Run ``stage_fn(params_s, h)`` for stages s = 0..n_stages-1 as a
    pipeline.  ``stacked_params``: a tensor or a tuple of tensors whose
    leading axis is the rank's stages (the Strategy's slice of the
    ``n_stages`` over S = ``mesh.shape[axis]``; all of them without a
    mesh).  ``x``: this rank's rows [B, ...], B divisible by
    ``n_microbatches`` (default S).  Returns the final stage's output [B,
    ...] on every rank of the pp group; with S == 1 (or no mesh) the plain
    sequential fold."""
    S = mesh_axis_size(mesh, axis)
    n_local = _n_stages(stacked_params)

    def run_stages(h):
        for s in range(n_local):
            h = stage_fn(_tree_index(stacked_params, s), h)
        return h

    if S == 1:
        return run_stages(x)
    M = n_microbatches or S
    B = x.shape[0]
    if B % M:
        raise ValueError(f"gpipe: batch {B} not divisible by {M} "
                         f"microbatches")
    group = mesh.group(axis)
    idx = mesh.coord(axis)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == S - 1, device=x.device)
    xm = comm.copy_to(x, group).reshape(M, B // M, *x.shape[1:])
    recv = torch.zeros_like(xm[0])
    outs = []
    for t in range(M + S - 1):
        inp = torch.where(first, xm[min(t, M - 1)], recv)
        out = run_stages(inp)
        if t >= S - 1:
            outs.append(torch.where(last, out, torch.zeros_like(out)))
        if t < M + S - 2:
            recv = comm.shift(out, group)
    y = comm.reduce_from(torch.stack(outs), group)
    return y.reshape(B, *y.shape[2:])


def pipeline_fc_stack(x, size: int, n_stages: Optional[int] = None,
                      act: str = "relu", axis: str = "pp",
                      n_microbatches: Optional[int] = None, param_attr=None,
                      name: Optional[str] = None):
    """Program-level pipelined MLP: ``n_stages`` fc(size->size)+act stages
    whose weights are stacked [S, ...] and sharded over ``axis``; forward
    runs the GPipe schedule.  ``x``: [N, size]."""
    helper = LayerHelper("pipeline_fc_stack", name=name)
    d = x.shape[-1]
    if d != size:
        raise ValueError("pipeline_fc_stack stages are size->size")

    def attr(spec):
        a = ParamAttr.to_attr(param_attr)
        return dataclasses.replace(a, sharding=spec, name=None)

    S = n_stages or 1
    w = helper.create_parameter(attr(P(axis, None, None)), [S, d, size],
                                x.dtype)
    b = helper.create_parameter(attr(P(axis, None)), [S, size], x.dtype,
                                is_bias=True)
    actfn = {"relu": torch.relu, "tanh": torch.tanh, None: lambda a: a}[act]

    def fn(ctx, xv, wv, bv, n_micro):
        def stage(params, h):
            pw, pb = params
            return actfn(h @ pw + pb)

        return gpipe(stage, (wv, bv), xv, ctx.mesh, axis=axis,
                     n_microbatches=n_micro)

    return helper.append_op(fn, {"X": [x], "W": [w], "B": [b]},
                            attrs={"n_micro": n_microbatches})
