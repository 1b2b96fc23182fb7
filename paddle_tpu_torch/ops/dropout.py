"""Dropout's keep mask from JAX's threefry2x32, with a hand-written CUDA
kernel (``csrc/dropout.cu``).

The JAX package's dropout (``paddle_tpu/layers/nn.py:449-458``) keeps an
element where ``jax.random.bernoulli(ctx.rng(tag), 1 - p, shape)`` is
true, with ``ctx.rng(tag) = fold_in(fold_in(key(seed), step), tag)``
(``paddle_tpu/core/executor.py:265``, ``core/program.py:149``).  The port
draws the same mask, bit for bit, from the same (seed, step, tag):

* ``key(seed)`` is the word pair (0, seed & 0xFFFFFFFF): in JAX's default
  32-bit mode the seed keeps its low 32 bits;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* element i of the bits is ``x0 ^ x1`` of ``threefry2x32(op key, (i >> 32,
  i & 0xFFFFFFFF))``, i the row-major index (``jax_threefry_partitionable``);
* keep where float32 ``bitcast((bits >> 9) | 0x3F800000) - 1 < float32(1 -
  p)``.

:class:`ThreefryKey` holds (seed, step, tag); the step is a Python int in
an eager step and, in a warmed step, the 0-d int32 device tensor into
which the Executor stages the step counter before each replay (uint32
bits), so that a replay draws that step's masks.  ``words()`` derives the
op key: on the host for an int step, as 0-d tensors otherwise.

:func:`threefry_dropout` is a ``torch.autograd.Function``: y = x * keep,
dx = dy * keep, the mask drawn again in the backward rather than stored.
On CUDA tensors both run the kernel (``dropout_launch``, on x in the
forward and on dy in the backward), which derives the op key itself from
the seed, the step (the staged device word or an immediate) and the tag;
or they raise: there is no fallback.  On CPU tensors they run the plain version,
:func:`dropout_reference`: the same threefry in int64 tensor ops masked
to 32 bits.  A multiply by 0 or 1 is exact, so kernel and plain version
agree bitwise.  ``threefry_dropout.launches`` counts kernel launches
(``{"fwd": n, "bwd": n}``) and ``dtype_launches`` the same by the
operand's dtype; plain-version calls never count.

Under a mesh a rank holds a slice of the tensor the single-device step
would drop out: a :class:`CounterMap` maps its local element indices to
the global ones, in the kernel and in the plain version alike, so the
slice draws the global tensor's bits at its elements (dp rows, sp
sequence positions, contiguous or striped, and the tp columns of a
last dim sharded over a model axis).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from . import _build, _cost

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_build.declare("dropout.cu", "dropout_launch", ctypes.c_int,
               [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int]
               + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])

Word = Union[int, torch.Tensor]


# ------------------------------------------------------------ threefry


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: Word, k1: Word, c0: Word, c1: Word):
    """JAX's threefry2x32 of the counter (c0, c1) under the key (k0, k1),
    on 32-bit words held in Python ints or int64 tensors (broadcast):
    returns the pair (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0, x1 = (c0 + ks[0]) & M32, (c1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_words(seed: int) -> tuple:
    """``jax.random.key(seed)``'s two words in JAX's default 32-bit mode,
    where a seed keeps its low 32 bits: (0, seed & 0xFFFFFFFF)."""
    return 0, int(seed) & M32


class ThreefryKey:
    """The key of one random op in one step: ``fold_in(fold_in(key(seed),
    step), tag)``.  ``step`` is an int or a one-element int32 tensor
    holding the step's uint32 bits (the staged step counter of a warmed
    step)."""

    __slots__ = ("seed", "step", "tag")

    def __init__(self, seed: int, step: Word, tag: int):
        self.seed, self.step, self.tag = int(seed), step, int(tag)

    def step_word(self) -> Word:
        if isinstance(self.step, torch.Tensor):
            return self.step.reshape(()).to(torch.int64) & M32
        return int(self.step) & M32

    def words(self) -> tuple:
        """The op key's two uint32 words: ints for an int step, 0-d int64
        tensors on the step's device otherwise."""
        s0, s1 = seed_words(self.seed)
        k0, k1 = threefry2x32(s0, s1, 0, self.step_word())
        return threefry2x32(k0, k1, 0, self.tag)


class CounterMap(NamedTuple):
    """Where a rank's slice of a tensor lies in the global tensor, so that
    its mask draws the bits the global tensor would draw at those
    elements: local row-major index i maps to the global index

        base + i                                   when row == 0
        base + (i // row) * stride + f(i % row)    otherwise,
        f(c) = off0 + c if c < seg else off1 + c   when row2 == 0,
        f(c) = h(c // row2) * stride2 + off2 + c % row2   otherwise,
        h(q) = off0 + q if q < seg else off1 + q

    ``row`` the local row, ``stride`` the global row, and the row made of
    at most two runs that are contiguous in the global row: one level for
    a batch row with the sequence slice of a rank or the two half-blocks
    of the striped layout (``row`` the elements of one local batch row),
    or for a tensor-parallel slice of the last dim (``row`` the local
    width, ``stride`` the global width, ``off0`` the rank's first
    column).  With both a sequence slice and a tensor-parallel last dim,
    a second level: ``row2`` / ``stride2`` the local and global widths,
    ``off2`` the rank's first column, and ``seg`` / ``off0`` / ``off1``
    count the sequence slice's inner rows.
    ``parallel.strategy.StepLayout.counter_map`` builds it."""

    base: int = 0
    row: int = 0
    stride: int = 0
    seg: int = 0
    off0: int = 0
    off1: int = 0
    row2: int = 0
    stride2: int = 0
    off2: int = 0


def global_index(i: torch.Tensor, cmap: Optional[CounterMap]) -> torch.Tensor:
    """The global element index of local indices ``i`` (int64) under
    ``cmap`` (the identity for None)."""
    if cmap is None:
        return i
    if cmap.row == 0:
        return i + cmap.base
    r = torch.div(i, cmap.row, rounding_mode="floor")
    c = i - r * cmap.row
    if cmap.row2 == 0:
        return cmap.base + r * cmap.stride + torch.where(
            c < cmap.seg, cmap.off0 + c, cmap.off1 + c)
    q = torch.div(c, cmap.row2, rounding_mode="floor")
    c2 = c - q * cmap.row2
    return (cmap.base + r * cmap.stride
            + torch.where(q < cmap.seg, cmap.off0 + q, cmap.off1 + q)
            * cmap.stride2 + cmap.off2 + c2)


def threefry_bits(key: ThreefryKey, shape: Sequence[int],
                  device=None, cmap: Optional[CounterMap] = None
                  ) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 tensor values in
    [0, 2^32), on ``device`` (the step's, when it is a tensor); with
    ``cmap``, the bits of a global tensor at this slice's elements."""
    k0, k1 = key.words()
    if device is None:
        device = key.step.device if isinstance(key.step,
                                               torch.Tensor) else "cpu"
    n = int(np.prod(shape, dtype=np.int64))
    i = global_index(torch.arange(n, dtype=torch.int64, device=device), cmap)
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & M32)
    return (x0 ^ x1).reshape(tuple(shape))


def keep_prob(dropout_prob: float) -> float:
    """``float32(1 - p)``, the bound bernoulli compares the uniforms to."""
    return float(np.float32(1.0 - float(dropout_prob)))


def keep_mask(key: ThreefryKey, shape: Sequence[int], dropout_prob: float,
              device=None, cmap: Optional[CounterMap] = None) -> torch.Tensor:
    """``jax.random.bernoulli(key, 1 - p, shape)``: bool (with ``cmap``, a
    slice of the global tensor's mask)."""
    bits = threefry_bits(key, shape, device, cmap)
    u = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    return u < keep_prob(dropout_prob)


def dropout_reference(x: torch.Tensor, key: ThreefryKey,
                      dropout_prob: float,
                      cmap: Optional[CounterMap] = None) -> torch.Tensor:
    """Plain version of the kernel: ``x * keep`` in x's dtype."""
    return x * keep_mask(key, x.shape, dropout_prob, x.device,
                         cmap).to(x.dtype)


# ------------------------------------------------------------ the kernel


def check_dropout_dtype(dtype: torch.dtype) -> None:
    """Raise on a dtype the kernel does not take; ``Executor.run`` calls
    this before the first op of a program whose dropout runs on a card."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the dropout kernel takes float32 or bfloat16, got "
                         f"{dtype}")


def _launch(which: str, x: torch.Tensor, key: ThreefryKey,
            dropout_prob: float,
            cmap: Optional[CounterMap] = None) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"the dropout kernel runs on CUDA tensors, not "
                         f"{x.device.type}")
    check_dropout_dtype(x.dtype)
    x = x.contiguous()
    out = torch.empty_like(x)
    s0, s1 = seed_words(key.seed)
    if isinstance(key.step, torch.Tensor):
        step = key.step
        if (step.device != x.device or step.dtype != torch.int32
                or step.numel() != 1):
            raise ValueError(f"the staged step word must be one int32 on "
                             f"{x.device}, got {step.dtype} "
                             f"{tuple(step.shape)} on {step.device}")
        ptr, imm = step.data_ptr(), 0
    else:
        ptr, imm = None, int(key.step) & M32
    fn = _build.load_kernel_library("dropout.cu").dropout_launch
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), s0, s1, ptr, imm,
                key.tag & M32, keep_prob(dropout_prob),
                _DTYPE_CODE[x.dtype], *(cmap or CounterMap()),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dropout_launch ({which}) failed: CUDA error "
                           f"{rc}")
    threefry_dropout.launches[which] += 1
    if _cost._active:
        _cost.add(*_cost.dropout_work(x.numel(), x.element_size()))
    threefry_dropout.dtype_launches[str(x.dtype).replace("torch.", "")][
        which] += 1
    return out


def dropout_fwd_kernel(x, key: ThreefryKey, dropout_prob: float,
                       cmap: Optional[CounterMap] = None):
    """One launch of the forward kernel: ``x * keep``."""
    return _launch("fwd", x, key, dropout_prob, cmap)


def dropout_bwd_kernel(dy, key: ThreefryKey, dropout_prob: float,
                       cmap: Optional[CounterMap] = None):
    """One launch of the backward kernel: ``dy * keep``, the forward's
    mask drawn again."""
    return _launch("bwd", dy, key, dropout_prob, cmap)


class _Dropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, key, dropout_prob, cmap):
        ctx.key, ctx.p, ctx.cmap = key, dropout_prob, cmap
        if x.device.type == "cpu":
            return dropout_reference(x, key, dropout_prob, cmap)
        return dropout_fwd_kernel(x, key, dropout_prob, cmap)

    @staticmethod
    def backward(ctx, g):
        if g.device.type == "cpu":
            return (dropout_reference(g, ctx.key, ctx.p, ctx.cmap), None,
                    None, None)
        return (dropout_bwd_kernel(g, ctx.key, ctx.p, ctx.cmap), None, None,
                None)


def threefry_dropout(x: torch.Tensor, key: ThreefryKey,
                     dropout_prob: float,
                     cmap: Optional[CounterMap] = None) -> torch.Tensor:
    """``x * keep`` with JAX's bernoulli mask for ``key``, differentiable
    (the gradient is ``dy * keep``).  With ``cmap`` (a rank's slice under a
    mesh), the global tensor's mask at the slice's elements.  CUDA tensors
    run the kernel or raise; CPU tensors run the plain version; meta
    tensors give an empty output of the right shape and launch nothing."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"threefry_dropout runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    if x.device.type == "meta":
        return torch.empty_like(x)
    return _Dropout.apply(x, key, float(dropout_prob), cmap)


threefry_dropout.launches = {"fwd": 0, "bwd": 0}
threefry_dropout.dtype_launches = {dt: {"fwd": 0, "bwd": 0}
                                   for dt in ("float32", "bfloat16")}
