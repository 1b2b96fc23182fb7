"""Per-slot token selection for the continuous decode step (PyTorch port of
``paddle_tpu/ops/sampling.py``): greedy / temperature / top-k / top-p plus an
additive constrained-decoding mask, all slots in one pass.

The draw for token index ``i`` of a stream is ``hash(seed, i)``, a splitmix32
hash computed exactly as the JAX package computes it: the uint32 arithmetic
runs in int64 with ``& 0xFFFFFFFF`` after every multiply and add (torch's
uint32 arithmetic is incomplete), and the multiply is split in 16-bit halves
so no int64 product overflows.  The uniforms are bitwise equal to JAX's.
"""
from __future__ import annotations

import torch

# The additive-mask "minus infinity": finite so masked rows never produce NaN
# through softmax/cumsum.
NEG_MASK = -1e9

_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a uint32 const."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix32/murmur3 finalizer on uint32 values held in int64."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash_uniform(seeds: torch.Tensor, substeps: torch.Tensor) -> torch.Tensor:
    """One deterministic uniform in [0, 1) per slot from (seed, substep)."""
    s = seeds.to(torch.int64) & _U32
    t = substeps.to(torch.int64) & _U32
    h = _mix(s ^ _GOLDEN)
    h = _mix((h + _mul32(t, _GOLDEN)) & _U32)
    return h.to(torch.float32) * (2.0 ** -32)


def masked_select_tokens(logits, seeds, substeps, temps, topks, topps, mask):
    """Select one token per slot from step logits.

    Args (S = slot count, V = vocab): ``logits`` [S, V] float32; ``seeds``
    [S] (uint32 values); ``substeps`` [S] token index of the draw;
    ``temps`` [S] temperature, <= 0 means greedy; ``topks`` [S] top-k
    cutoff, <= 0 disables; ``topps`` [S] nucleus mass, >= 1 disables;
    ``mask`` [S, V] additive mask (0 allowed, NEG_MASK forbidden).

    Policies compose in the probability-sorted domain (stable descending
    sort): top-k keeps the first k positions, top-p the smallest prefix with
    mass >= p (the argmax always survives), and the draw is an inverse-CDF
    pick over the kept mass.  Returns chosen [S] int32."""
    S, V = logits.shape
    x = logits.to(torch.float32) + mask
    greedy = torch.argmax(x, dim=-1).to(torch.int32)

    temps = temps.to(torch.float32)
    scaled = x / torch.clamp_min(temps, 1e-6)[:, None]
    order = torch.sort(-scaled, dim=-1, stable=True).indices
    sorted_sc = torch.gather(scaled, -1, order)
    pos = torch.arange(V, device=logits.device)[None, :]

    k = topks.to(torch.int64)[:, None]
    sorted_sc = torch.where((k > 0) & (pos >= k),
                            torch.full_like(sorted_sc, NEG_MASK), sorted_sc)

    probs = torch.softmax(sorted_sc, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    p = topps.to(torch.float32)[:, None]
    kept = torch.where((p < 1.0) & (pos > 0) & ((csum - probs) >= p),
                       torch.zeros_like(probs), probs)
    ccs = torch.cumsum(kept, dim=-1)

    u = _hash_uniform(seeds, substeps) * ccs[:, -1]
    idx = torch.clamp((ccs <= u[:, None]).sum(dim=-1), 0, V - 1)
    sampled = torch.gather(order, -1, idx[:, None])[:, 0]
    return torch.where(temps <= 0.0, greedy,
                       sampled.to(torch.int32)).to(torch.int32)
