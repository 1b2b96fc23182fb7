"""Data-declaration layer (PyTorch port of ``paddle_tpu/layers/io.py``).
Creates a feed Variable; shape gets a leading batch dim (None) unless
append_batch_size=False."""
from __future__ import annotations

from typing import Sequence

from ..core.program import Variable, default_main_program


def data(
    name: str,
    shape: Sequence[int],
    dtype="float32",
    lod_level: int = 0,
    append_batch_size: bool = True,
) -> Variable:
    block = default_main_program().global_block
    full_shape = ([None] + list(shape)) if append_batch_size else list(shape)
    return block.create_var(
        name, full_shape, dtype, lod_level=lod_level
    )
