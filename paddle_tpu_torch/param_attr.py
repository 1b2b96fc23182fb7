"""ParamAttr: per-parameter configuration (PyTorch port of
``paddle_tpu/param_attr.py``): name, initializer, learning-rate multiplier,
regularizer (``regularizer.py``), trainability and update hook
(``hooks.py``), and ``sharding``: the parameter's layout over a mesh, a
:class:`PartitionSpec` (one mesh axis name or None per dim, as
``jax.sharding.PartitionSpec``).  Under ``Executor(strategy=...)`` a rank
holds its shard of a sharded parameter (``parallel/strategy.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: a tuple with one entry per
    dim, a mesh axis name or None (replicated along that dim).
    ``PartitionSpec(None, "tp")`` shards dim 1 over ``tp``; a spec shorter
    than the rank leaves the trailing dims replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class SeqAxis(str):
    """A PartitionSpec entry for a sequence dim sharded over the mesh axis
    it names: contiguous blocks, or (``striped``) ring_striped's zigzag,
    where rank d of n holds the half-blocks d and 2n - 1 - d of 2n.  It is
    the axis name (compares and hashes as that str), so whatever reads a
    spec's axes reads it alike.  ``build_lm(use_sp=True)`` puts it on dim 1
    of the token and label feeds, and each layer carries it from a
    sequence-sharded input to its outputs (``LayerHelper.append_op``)."""

    striped = False

    def __new__(cls, axis: str, striped: bool = False):
        self = super().__new__(cls, axis)
        self.striped = bool(striped)
        return self

    def __reduce__(self):
        return SeqAxis, (str(self), self.striped)

    def __repr__(self):
        return (f"SeqAxis({str(self)!r}"
                + (", striped=True)" if self.striped else ")"))


def seq_axis_of(var) -> Optional[SeqAxis]:
    """The :class:`SeqAxis` on dim 1 of a batch-major Variable (dims
    [batch, sequence, ...]), else None."""
    shape = tuple(var.shape or ())
    spec = tuple(getattr(var, "sharding", None) or ())
    if len(shape) > 1 and shape[0] is None and len(spec) > 1 \
            and isinstance(spec[1], SeqAxis):
        return spec[1]
    return None


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
