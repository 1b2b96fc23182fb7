"""Ulysses sequence parallelism: all-to-all head <-> sequence resharding
(PyTorch port of ``paddle_tpu/parallel/ulysses.py``).

Where the ring streams K/V around ``sp``, Ulysses keeps the attention
local: this rank's sequence chunk [B, H, t, D] of q, k and v goes through
one ``comm.all_to_all`` to a head slice of the whole sequence
[B, H/sp, T, D]; the rank runs ``ops.flash_attention`` (the flash kernels
on the card) over the full sequence for its heads; a second all-to-all
restores sequence sharding.  Two collectives a call (and two in the
backward), no per-step ring latency; H % sp == 0 is required.  The
chunks are contiguous blocks of the sequence in rank order.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import comm


def _local_attention(q, k, v, scale, causal):
    # the flash kernels, not a dense einsum: after the all-to-all each rank
    # attends over the FULL sequence
    from ..ops import flash_attention

    return flash_attention(q, k, v, causal=causal, scale=scale)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str = "sp", causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: this rank's chunk [batch, heads, t, head_dim] of a sequence
    sharded over ``axis``; returns the rank's chunk of the output.  heads
    must divide by the axis size."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return _local_attention(q, k, v, scale, causal)
    H = q.shape[1]
    if H % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({H}) divisible by {axis}={n}; "
            f"use ring_attention for head counts below the mesh axis")
    group = mesh.group(axis)

    def seq2head(x):
        return comm.all_to_all(x, group, split_dim=1, concat_dim=2)

    oh = _local_attention(seq2head(q), seq2head(k), seq2head(v), scale,
                          causal)
    return comm.all_to_all(oh.contiguous(), group, split_dim=2, concat_dim=1)
