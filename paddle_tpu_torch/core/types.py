"""Core type system: dtypes, places (PyTorch port of
``paddle_tpu/core/types.py``).

``convert_dtype`` gives torch dtypes.  A ``Place`` names the device the
Executor runs on: ``Place("gpu", i)`` is CUDA card ``i`` and ``CPUPlace()``
the host; ``Place.torch_device()`` gives the ``torch.device`` and raises
when there is no card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device

# --------------------------------------------------------------------------- dtypes

_DTYPE_ALIASES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "float64": torch.float64,
    "fp64": torch.float64,
    "float16": torch.float16,
    "fp16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}


def convert_dtype(dtype: Any) -> torch.dtype:
    """Normalise a user dtype spec (string, numpy or torch dtype) to a torch
    dtype; None means float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    key = dtype.lower() if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _DTYPE_ALIASES[key]
    except KeyError:
        raise TypeError(f"unsupported dtype {dtype!r}") from None


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (bfloat16 has none and raises)."""
    return torch.empty((), dtype=dtype).numpy().dtype


# --------------------------------------------------------------------------- places


@dataclass(frozen=True)
class Place:
    """Device selector.  ``kind`` is 'gpu' (a CUDA card) or 'cpu'; ``index``
    picks the card."""

    kind: str = "gpu"
    index: int = 0

    def torch_device(self) -> torch.device:
        """The ``torch.device``; for a card, raises when there is none (the
        port never drops to the CPU on its own)."""
        if self.kind == "cpu":
            return torch.device("cpu")
        if self.kind != "gpu":
            raise ValueError(f"unknown place kind {self.kind!r}: gpu | cpu")
        resolve_device()             # raises without a card; TF32 off
        return torch.device("cuda", self.index)


def CPUPlace(index: int = 0) -> Place:
    return Place("cpu", index)


# --------------------------------------------------------------------------- shapes

ShapeLike = Sequence[Optional[int]]


def normalize_shape(shape: ShapeLike) -> Tuple[Optional[int], ...]:
    """-1 / None mark the (leading) batch dimension, resolved at feed time."""
    out = []
    for d in shape:
        if d is None or (isinstance(d, int) and d < 0):
            out.append(None)
        else:
            out.append(int(d))
    return tuple(out)
