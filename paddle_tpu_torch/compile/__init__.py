"""Compile-time guards (PyTorch port of the part of ``paddle_tpu/compile``
that the sparse engine uses): ``guard.RecompileGuard``.  The
content-addressed store, the warmup manifests and the AOT paths are ROADMAP
A.10."""
from .guard import RecompileBudgetExceeded, RecompileGuard

__all__ = ["RecompileBudgetExceeded", "RecompileGuard"]
