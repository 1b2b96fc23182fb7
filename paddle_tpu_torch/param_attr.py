"""ParamAttr: per-parameter configuration (PyTorch port of
``paddle_tpu/param_attr.py``): name, initializer, learning-rate multiplier,
regularizer (``regularizer.py``), trainability and update hook
(``hooks.py``).  ``sharding`` keeps its place in the record; the
LayerHelper refuses it until parallel layouts (ROADMAP A.9) are ported."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class ParamAttr:
    name: Optional[str] = None
    initializer: Any = None
    learning_rate: float = 1.0
    regularizer: Any = None
    trainable: bool = True
    sharding: Any = None
    update_hook: Any = None

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr(trainable=arg) if arg else ParamAttr(trainable=False)
        # an initializer instance
        return ParamAttr(initializer=arg)
