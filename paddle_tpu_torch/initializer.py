"""Parameter initializers (PyTorch port of ``paddle_tpu/initializer.py``).
An initializer is a callable ``(shape, dtype, generator) -> Tensor`` that
draws from the ``torch.Generator`` it is given, on that generator's device;
the LayerHelper records one init op per parameter into the startup Program.
The draws are torch's, not JAX's: tests that compare the two packages load
the same numpy weights into both (``models.weights.load_scope``)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch


class Initializer:
    def __call__(self, shape, dtype, generator: torch.Generator):
        raise NotImplementedError


def _empty(shape, dtype, generator):
    return torch.empty(tuple(shape), dtype=dtype, device=generator.device)


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, generator):
        return _empty(shape, dtype, generator).fill_(self.value)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, generator):
        return _empty(shape, dtype, generator).uniform_(
            self.low, self.high, generator=generator)


class Normal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale = loc, scale

    def __call__(self, shape, dtype, generator):
        return self.loc + self.scale * _empty(shape, dtype, generator).normal_(
            generator=generator)


class TruncatedNormal(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, shape, dtype, generator):
        z = torch.nn.init.trunc_normal_(_empty(shape, dtype, generator), 0.0,
                                        1.0, -2.0, 2.0, generator=generator)
        return self.loc + self.scale * z


def _fans(shape: Sequence[int]) -> tuple:
    """fan_in/fan_out as the reference computes them (for conv weights
    [out_c, in_c, *k], the receptive field multiplies both fans)."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Xavier(Initializer):
    """Glorot init."""

    def __init__(self, uniform: bool = True, fan_in: Optional[int] = None,
                 fan_out: Optional[int] = None):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, shape, dtype, generator):
        fin, fout = _fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        if self.uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            return Uniform(-limit, limit)(shape, dtype, generator)
        return Normal(0.0, math.sqrt(2.0 / (fin + fout)))(shape, dtype,
                                                          generator)


class MSRA(Initializer):
    """He/Kaiming init."""

    def __init__(self, uniform: bool = True, fan_in: Optional[int] = None):
        self.uniform, self.fan_in = uniform, fan_in

    def __call__(self, shape, dtype, generator):
        fin, _ = _fans(shape)
        fin = self.fan_in or fin
        if self.uniform:
            limit = math.sqrt(6.0 / fin)
            return Uniform(-limit, limit)(shape, dtype, generator)
        return Normal(0.0, math.sqrt(2.0 / fin))(shape, dtype, generator)


# fluid-compatible aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
MSRAInitializer = MSRA
