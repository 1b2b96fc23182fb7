"""Gradient clipping (PyTorch port of ``paddle_tpu/clip.py``).  Clip objects
transform the (param, grad) dict between backward and the optimizer update
ops.  ``GradientClipByGlobalNorm`` takes one norm over all gradients and
scales each by ``clip / max(norm, clip)``."""
from __future__ import annotations

import torch


class BaseGradientClip:
    def transform(self, grads: dict) -> dict:
        """grads: name -> tensor.  Returns the transformed dict."""
        raise NotImplementedError


class GradientClipByValue(BaseGradientClip):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def transform(self, grads):
        return {k: torch.clamp(g, self.min, self.max) for k, g in grads.items()}


class GradientClipByNorm(BaseGradientClip):
    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def transform(self, grads):
        out = {}
        for k, g in grads.items():
            n = torch.sqrt(torch.sum(torch.square(g)))
            out[k] = g * (self.clip_norm / torch.clamp_min(n, self.clip_norm))
        return out


class GradientClipByGlobalNorm(BaseGradientClip):
    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def transform(self, grads):
        gn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
        scale = self.clip_norm / torch.clamp_min(gn, self.clip_norm)
        return {k: g * scale for k, g in grads.items()}
