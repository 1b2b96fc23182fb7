"""Gradient clipping (PyTorch port of ``paddle_tpu/clip.py``).  Clip objects
transform the (param, grad) dict between backward and the optimizer update
ops.  ``GradientClipByGlobalNorm`` takes one norm over all gradients and
scales each by ``clip / max(norm, clip)``.

Under a mesh (``Executor(strategy=...)``) a rank holds its shard of a
sharded parameter's gradient: the norms take ``mesh`` and ``specs`` (the
sharded gradients' layouts, by name), add a sharded gradient's squares
over the mesh axes it is sharded on, and count a replicated one once."""
from __future__ import annotations

import torch


def _sq_sum(g, spec, mesh):
    s = torch.sum(torch.square(g))
    if mesh is not None and spec is not None:
        from .parallel import comm

        for axis in spec:
            if axis is not None:
                s = comm.all_reduce(s, mesh.group(axis))
    return s


class BaseGradientClip:
    def transform(self, grads: dict, mesh=None, specs=None) -> dict:
        """grads: name -> tensor.  Returns the transformed dict."""
        raise NotImplementedError


class GradientClipByValue(BaseGradientClip):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def transform(self, grads, mesh=None, specs=None):
        return {k: torch.clamp(g, self.min, self.max) for k, g in grads.items()}


class GradientClipByNorm(BaseGradientClip):
    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def transform(self, grads, mesh=None, specs=None):
        specs = specs or {}
        out = {}
        for k, g in grads.items():
            n = torch.sqrt(_sq_sum(g, specs.get(k), mesh))
            out[k] = g * (self.clip_norm / torch.clamp_min(n, self.clip_norm))
        return out


class GradientClipByGlobalNorm(BaseGradientClip):
    def __init__(self, clip_norm: float):
        self.clip_norm = clip_norm

    def transform(self, grads, mesh=None, specs=None):
        # the norm as the reference takes it: each gradient's sum of
        # squares, added in the program's order (under a mesh: the
        # replicated gradients' in that order, then the sharded ones' sum,
        # all-reduced over their axes); the scaling is one multi-tensor
        # multiply
        specs = specs or {}
        if mesh is None or not specs:
            total = sum(torch.sum(torch.square(g)) for g in grads.values())
        else:
            total = sum(torch.sum(torch.square(g)) for k, g in grads.items()
                        if k not in specs)
            by_axes: dict = {}
            for k, g in grads.items():
                if k in specs:
                    axes = tuple(a for a in specs[k] if a is not None)
                    by_axes[axes] = (by_axes.get(axes, 0)
                                     + torch.sum(torch.square(g)))
            from .parallel import comm

            for axes, s in by_axes.items():
                for axis in axes:
                    s = comm.all_reduce(s, mesh.group(axis))
                total = total + s
        gn = torch.sqrt(total)
        scale = self.clip_norm / torch.clamp_min(gn, self.clip_norm)
        from . import flags

        if flags.get("log_clipping") and not (
                gn.is_cuda and torch.cuda.is_current_stream_capturing()):
            # the reference's FLAGS_log_clipping line, which it prints from
            # inside the compiled step; here a host read of the norm, so a
            # captured step (a CUDA graph cannot call the host) prints it
            # only in its capture-time run, not at replay (ROADMAP C.4)
            if float(scale) < 1.0:
                # the clip as the reference's step holds it, a float32
                cn = float(torch.tensor(self.clip_norm, dtype=torch.float32))
                print(f"clipping global grad norm {float(gn):.4} -> {cn}",
                      flush=True)
        return dict(zip(grads, torch._foreach_mul(list(grads.values()),
                                                  scale)))
