"""JAX's random transforms over the port's threefry bits: ``uniform``,
``normal``, ``split``, ``randint``, ``gumbel`` and ``categorical``,
transcribed from ``jax/_src/random.py`` (jax 0.9.0) over
``ops/dropout.py``'s ``threefry2x32``, which gives ``jax.random.bits``
bit for bit.

A key is an op's :class:`~paddle_tpu_torch.ops.dropout.ThreefryKey`
(``OpContext.rng_key(tag)``) or the pair of its uint32 words, Python ints
in an eager step and 0-d int64 tensors on the step's device in a warmed
one, where the step counter is a staged device word: a replay at step s
then draws what an eager step at s draws.  Every transform is plain torch
on the given device (by default the words' device, else the CUDA card);
uint32 arithmetic runs in int64 with 32-bit masks, as ``ops/sampling.py``
does.  The port adds no kernel here: the JAX package leaves these to XLA,
outside any Pallas kernel.

* ``bits`` (``_threefry_random_bits_partitionable``): element i of a
  shape is ``x0 ^ x1`` of ``threefry2x32(key, (i >> 32, i & M32))``, i
  the row-major index.
* ``uniform`` (``_uniform`` :435): the mantissa trick, ``bits >> (32 -
  23) | bits(1.0)`` viewed as a float in [1, 2), minus 1, times ``max -
  min`` plus ``min``, then ``max(min, .)``; float32, and the 16-bit
  floats from 16 (float16) or 8 (bfloat16) bits, as JAX takes them.
  Bitwise JAX's on the CPU: XLA's CPU code fuses the scale and shift into
  one fused multiply-add (rounded once; in float32 for float16) and
  rounds each bfloat16 step, so the port does the same, the FMA emulated
  exactly in float64 (:func:`fma32`), which gives the same bits on the
  card.
* ``normal`` (``_normal_real`` :867): ``sqrt(2) * erf_inv(u)`` with u
  ``uniform`` on [nextafter(-1, 0), 1).  ``erf_inv`` is XLA's
  single-precision one (Giles' degree-9 polynomials on ``w = -log1p(-x^2)``,
  split at w = 5, as the CHLO lowering of ``chlo.erf_inv`` writes it),
  transcribed op for op with its steps fused as XLA fuses them;
  ``torch.erfinv`` is another approximation.  The transcription still
  goes through torch's ``log1p``, whose last bit may differ from XLA's CPU
  one, so ``normal`` is held to JAX's within ``NORMAL_ULPS`` units in the
  last place, not bitwise (``tests/test_torch_random.py``: 2^20 draws
  within the limit, more than 95% of them bitwise).
* ``split`` (``_threefry_split_foldlike``): key i of ``split(key, n)`` is
  the word pair ``threefry2x32(key, (i >> 32, i & M32))``.
* ``randint`` (``_randint`` :581): splits the key, draws two words per
  element and reduces them by the span multiplier ``(2^16 mod span)^2 mod
  span``, the products and the sum wrapped to 32 bits; int32 (JAX's
  default integer in its 32-bit mode).  Bitwise JAX's.
* ``gumbel`` (``_gumbel`` :1723, mode "low", JAX's default while
  ``use_high_dynamic_range_gumbel`` is off): ``-log(-log(u))``, u uniform
  on [tiny, 1).  ``categorical`` (:1739) is the argmax of ``gumbel +
  logits`` along ``axis``, the first maximum winning, as ``jnp.argmax``
  and ``torch.argmax`` both take it; the ids are JAX's unless two entries
  lie within the last bits of ``log``, where torch's and XLA's may round
  apart (gumbel values are held to JAX's within ``GUMBEL_TOL`` of
  max(1, |g|)).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from .._device import resolve_device
from .dropout import M32, ThreefryKey, Word, threefry2x32

Words = Tuple[Word, Word]
KeyLike = Union[ThreefryKey, Words, Sequence[int]]

# normal's limit against jax.random.normal (and the card's against the
# CPU's), in float32 units in the last place: one ulp of log1p moves w by
# about one ulp, which the polynomial and the sqrt(2) scale carry through
# by a few; twice the worst reading (chip_smoke.py's layers phase prints
# the card's against the CPU's)
NORMAL_ULPS = 6
# gumbel's limit against jax.random.gumbel, relative to max(1, |g|)
GUMBEL_TOL = 1e-6

_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))
# the float32 constants of XLA's erf_inv (w < 5, then w >= 5)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# each float dtype's nmant, the bits JAX draws for it and the bits of 1.0
_FLOATS = {torch.float32: (23, 32, 0x3F800000),
           torch.float16: (10, 16, 0x3C00),
           torch.bfloat16: (7, 8, 0x3F80)}
_VIEW_INT = {torch.float32: torch.int32, torch.float16: torch.int16,
             torch.bfloat16: torch.int16}


def key_words(key: KeyLike) -> Words:
    """The key's two uint32 words."""
    if isinstance(key, ThreefryKey):
        return key.words()
    k0, k1 = key
    return k0, k1


def _device(words: Words, device):
    """``device``, else the words' device (a warmed step's), else the CUDA
    card (raising when there is none): as every entry point of the port,
    the CPU only when asked."""
    if device is not None:
        return torch.device(device)
    for w in words:
        if isinstance(w, torch.Tensor):
            return w.device
    return resolve_device(None)


def split(key: KeyLike, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as ``num`` word pairs."""
    k0, k1 = key_words(key)
    return [threefry2x32(k0, k1, i >> 32, i & M32) for i in range(int(num))]


def bits(key: KeyLike, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in [0,
    2^32), on ``device`` (by default the words' device, or the card)."""
    words = key_words(key)
    dev = _device(words, device)
    n = int(np.prod(tuple(shape), dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=dev)
    x0, x1 = threefry2x32(words[0], words[1], i >> 32, i & M32)
    return (x0 ^ x1).reshape(tuple(shape))


def _scalar(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``v`` rounded to ``dtype`` (``convert_element_type``
    of a Python scalar), filled on the device: a captured step copies
    nothing from the host."""
    return torch.full((), float(v), dtype=dtype, device=device)


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add
    (XLA's CPU code fuses the uniform's scale-and-shift and the erf_inv
    polynomial's steps into FMAs): the float64 product is exact, the sum
    and its error come from Knuth's TwoSum, and the sum is rounded to odd
    before its rounding to float32, which then rounds as the exact value
    would.  Plain float64 torch ops, the same on every device."""
    a, b, c = (t.to(torch.float64) if isinstance(t, torch.Tensor) else t
               for t in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.to(torch.float32)


def uniform(key: KeyLike, shape: Sequence[int], dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, bitwise."""
    if dtype not in _FLOATS:
        raise ValueError(f"uniform takes float32, float16 or bfloat16, got "
                         f"{dtype}")
    nmant, nbits, one = _FLOATS[dtype]
    b = bits(key, shape, device)
    if nbits < 32:
        b = b & ((1 << nbits) - 1)
    # below 2^15 for the 16-bit floats, so the int16 cast keeps the bits
    f = ((b >> (nbits - nmant)) | one).to(_VIEW_INT[dtype])
    floats = f.view(dtype) - _scalar(1.0, dtype, f.device)
    lo = _scalar(minval, dtype, f.device)
    hi = _scalar(maxval, dtype, f.device)
    if dtype == torch.bfloat16:
        # XLA's CPU code rounds each bfloat16 step, unfused
        return torch.maximum(lo, floats * (hi - lo) + lo)
    # and fuses the float32 and float16 steps, the latter in float32
    return torch.maximum(lo, fma32(floats, hi - lo, lo).to(dtype))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision ``erf_inv``, op for op (float32)."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(x.dtype)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, w, torch.where(lt, c_lt, c_ge).to(x.dtype))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: KeyLike, shape: Sequence[int], dtype=torch.float32,
           device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32, within NORMAL_ULPS."""
    if dtype != torch.float32:
        raise ValueError(f"normal is ported for float32, got {dtype}")
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return _SQRT2_F32 * erf_inv(u)


def scaled_normal(key: KeyLike, shape: Sequence[int], mean: float,
                  std: float, device=None) -> torch.Tensor:
    """``mean + std * jax.random.normal(key, shape)`` as XLA compiles it
    inside a jitted step, where its simplifier folds ``std * sqrt(2)``
    into one float32 constant and the multiply-add fuses:
    ``fma(float32(std) * float32(sqrt 2), erf_inv(u), mean)`` (float32;
    within NORMAL_ULPS of JAX's, as ``normal``)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, torch.float32, lo, 1.0, device)
    c = float(np.float32(std) * np.float32(_SQRT2_F32))
    return fma32(_scalar(c, torch.float32, u.device), erf_inv(u),
                 _scalar(mean, torch.float32, u.device))


def randint(key: KeyLike, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32),
    bitwise: ids in [minval, maxval), or minval where maxval <= minval."""
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    out_of_range = maxval > hi32
    minval = min(max(int(minval), lo32), hi32)
    maxval = min(max(int(maxval), lo32), hi32)
    k1, k2 = split(key)
    higher, lower = bits(k1, shape, device), bits(k2, shape, device)
    span = (maxval - minval) & M32
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & M32
    if span == 0:
        # the whole 32-bit range: XLA's x rem 0 is x, the multiplier 0
        offset = lower
    else:
        mult = ((((1 << 16) % span) ** 2) & M32) % span
        offset = (((higher % span) * mult) & M32) + (lower % span)
        offset = (offset & M32) % span
    return (minval + offset).to(torch.int32)


def gumbel(key: KeyLike, shape: Sequence[int], dtype=torch.float32,
           device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in mode "low" (float32)."""
    tiny = float(torch.finfo(dtype).tiny)
    u = uniform(key, shape, dtype, tiny, 1.0, device)
    return -torch.log(-torch.log(u))


def categorical(key: KeyLike, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: int64 ids of the
    first maximum of ``gumbel + logits`` along ``axis``."""
    g = gumbel(key, tuple(logits.shape), logits.dtype, logits.device)
    return torch.argmax(g + logits, dim=axis)


__all__ = ["GUMBEL_TOL", "NORMAL_ULPS", "bits", "categorical", "erf_inv",
           "fma32", "gumbel", "key_words", "normal", "randint",
           "scaled_normal", "split", "uniform"]
