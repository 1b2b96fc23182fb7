"""Carry LM weights into the port: a numpy dict under the JAX names (from a
checkpoint, a trained scope, or ``init_lm_params`` of either package) becomes
the port's cast parameter dict on a device."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._device import resolve_device
from .transformer import _srv_cast_params, lm_param_shapes

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"float32"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported compute dtype {dtype!r}") from None


def from_jax_params(params: Dict[str, np.ndarray], *, vocab_size: int,
                    max_len: int, d_model: int, n_heads: int, n_layers: int,
                    d_ff: int, tie_embeddings: bool = True, dtype="float32",
                    device=None) -> Dict[str, torch.Tensor]:
    """Check every name and shape against ``lm_param_shapes`` and return the
    port's parameters: float32 tensors on ``device`` (the CUDA card unless
    given), then cast by ``_srv_cast_params`` to the compute ``dtype``."""
    want = lm_param_shapes(vocab_size, max_len, d_model, n_heads, n_layers,
                           d_ff, tie_embeddings)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise ValueError(f"LM parameter names disagree with lm_param_shapes: "
                         f"missing {missing}, unexpected {extra}")
    dev = resolve_device(device)
    out = {}
    for name, shape in want.items():
        arr = np.asarray(params[name], dtype=np.float32)
        if arr.shape != tuple(shape):
            raise ValueError(f"parameter {name} has shape {arr.shape}, "
                             f"expected {tuple(shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    return _srv_cast_params(out, torch_dtype(dtype))
