"""Parameter update hooks (PyTorch port of ``paddle_tpu/hooks.py``; ref
``paddle/parameter/ParameterUpdaterHook.cpp:57-106`` StaticPruningHook).

The mask is a persistable ``<param>@prune_mask`` variable, computed once
by the startup program from the freshly initialised value, which the
startup program also zeroes where the mask is 0; ``Optimizer.minimize``
multiplies the gradient by the mask (an ``update_hook`` op) before
regularization, so the pruned coordinates stay zero, moments included.
"""
from __future__ import annotations

import torch


def mask_name(param_name: str) -> str:
    """Name of the persistable mask var of a hooked parameter, the one
    place ``layers/helper.py`` and ``optimizer.py`` agree on."""
    return f"{param_name}@prune_mask"


class StaticPruningHook:
    """Keep the largest-|value| ``(1 - sparsity_ratio)`` fraction of a
    parameter fixed at init time; zero the rest and mask their gradients.

    Exact count: ``round(size * (1 - sparsity_ratio))`` entries keep mask
    1.0, ties broken by index order, like the reference's partial_sort over
    (|value|, index) pairs: a stable descending sort (``torch.topk``'s ties
    are unspecified)."""

    def __init__(self, sparsity_ratio: float = 0.6):
        if not 0.0 <= sparsity_ratio <= 1.0:
            raise ValueError(f"sparsity_ratio must be in [0, 1], "
                             f"got {sparsity_ratio}")
        self.sparsity_ratio = float(sparsity_ratio)

    def mask_for(self, value: torch.Tensor) -> torch.Tensor:
        """[shape] mask in value's dtype with exactly round(size * (1 -
        ratio)) ones, chosen by descending |value|."""
        flat = torch.abs(value).reshape(-1)
        n = flat.shape[0]
        keep = int(round(n * (1.0 - self.sparsity_ratio)))
        order = torch.sort(-flat, stable=True).indices
        mask = torch.zeros((n,), dtype=value.dtype, device=value.device)
        mask[order[:keep]] = 1
        return mask.reshape(value.shape)

    def __repr__(self):
        return f"StaticPruningHook(sparsity_ratio={self.sparsity_ratio})"
