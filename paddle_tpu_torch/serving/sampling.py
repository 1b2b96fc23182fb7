"""Per-request decoding policy (the port's copy of
``paddle_tpu/serving/sampling.py``).

``SamplingParams`` says how logits become tokens: greedy (the default),
temperature / top-k / top-p sampling with a per-stream seed, and a
constrained-decoding mask hook.  Draw ``i`` of a stream depends on
(seed, i) only (``ops/sampling.py``), so a preempted stream replays the
same draws.  The parallel-n and beam fields are carried for record
compatibility; this port's scheduler refuses them (not yet ported).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..ops.sampling import NEG_MASK

__all__ = ["SamplingParams", "NEG_MASK", "branch_seed"]

_SEED_MIX = 0x9E3779B9  # golden-ratio odd constant (splitmix/Weyl idiom)
_U32 = 0xFFFFFFFF


def branch_seed(seed: int, branch: int) -> int:
    """The seed branch ``branch`` of a parallel-n group samples under;
    branch 0 IS the root seed."""
    return (int(seed) + _SEED_MIX * int(branch)) & _U32


@dataclass
class SamplingParams:
    """One request's decoding policy.  Defaults are greedy, single stream."""

    temperature: float = 0.0   # <= 0 means greedy
    top_k: int = 0             # <= 0 disables
    top_p: float = 1.0         # >= 1 disables
    seed: int = 0              # stream PRNG identity
    n: int = 1                 # parallel sampled continuations
    beam: int = 0              # beam width; 0/1 = no beam search
    length_penalty: float = 0.0
    # host-side hook: mask_fn(history_tokens: list[int], vocab: int) ->
    # additive float32 [V] (0 allowed / NEG_MASK forbidden) or a bool vector
    mask_fn: Optional[Callable] = field(default=None, repr=False)

    def __post_init__(self):
        self.temperature = float(self.temperature)
        self.top_k = int(self.top_k)
        self.top_p = float(self.top_p)
        self.seed = int(self.seed) & _U32
        self.n = int(self.n)
        self.beam = int(self.beam)
        self.length_penalty = float(self.length_penalty)
        if self.n < 1:
            raise ValueError(f"sampling n must be >= 1, got {self.n}")
        if self.beam < 0:
            raise ValueError(f"beam width must be >= 0, got {self.beam}")
        if self.beam > 1 and self.n > 1:
            raise ValueError("beam search and parallel-n are exclusive")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def is_greedy(self) -> bool:
        """True when token selection is plain argmax (no PRNG draw)."""
        return self.temperature <= 0.0

    @property
    def is_default(self) -> bool:
        """True for greedy, unforked, unmasked: the plain argmax path."""
        return (self.is_greedy and self.n == 1 and self.beam <= 1
                and self.mask_fn is None)

    def mask_row(self, history, vocab: int):
        """The constrained-decoding hook for one step: additive float32 [V],
        all-zero when unconstrained.  Bool outputs convert (True = allowed);
        malformed shapes raise."""
        if self.mask_fn is None:
            return np.zeros(vocab, np.float32)
        m = np.asarray(self.mask_fn(list(history), vocab))
        if m.shape != (vocab,):
            raise ValueError(
                f"mask_fn returned shape {m.shape}, want ({vocab},)")
        if m.dtype == np.bool_:
            return np.where(m, 0.0, NEG_MASK).astype(np.float32)
        return m.astype(np.float32)

    def to_record(self) -> dict:
        """Record payload (mask_fn is a host object and does not travel)."""
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed, "n": self.n,
                "beam": self.beam, "length_penalty": self.length_penalty}

    @classmethod
    def from_record(cls, d: Optional[dict]) -> "SamplingParams":
        """Strict decode: known keys type-checked, unknown keys ignored."""
        if d is None:
            return cls()
        if not isinstance(d, dict):
            raise ValueError(
                f"sampling must be an object, got {type(d).__name__}")
        kw = {}
        for k, cast in (("temperature", float), ("top_k", int),
                        ("top_p", float), ("seed", int), ("n", int),
                        ("beam", int), ("length_penalty", float)):
            if k in d:
                v = d[k]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(f"sampling.{k} must be a number, "
                                     f"got {v!r}")
                kw[k] = cast(v)
        return cls(**kw)
