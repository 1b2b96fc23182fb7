"""Program IR: Variable / Op / Block / Program (PyTorch port of
``paddle_tpu/core/program.py``).

A Program is an inspectable record of op closures over torch tensors; the
Executor runs it op by op, eagerly.  Shapes are inferred when a layer is
declared, by running the op's function on ``device="meta"`` tensors
(layers/helper.py).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from . import unique_name
from .types import convert_dtype, normalize_shape

# --------------------------------------------------------------------------- Variable


class Variable:
    """Symbolic handle in a Program: shape (None marks the batch dim resolved
    at feed time), torch dtype, persistability (persistable vars live in the
    Scope across steps: parameters and optimizer state)."""

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Sequence[Optional[int]],
        dtype: Any = "float32",
        *,
        persistable: bool = False,
        trainable: bool = False,
        lod_level: int = 0,
        regularizer: Any = None,
    ):
        self.block = block
        self.name = name
        self.shape = normalize_shape(shape)
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.trainable = trainable
        self.lod_level = lod_level
        self.regularizer = regularizer

    @property
    def program(self) -> "Program":
        return self.block.program

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype})")


# --------------------------------------------------------------------------- Op


def _mix64(x: int) -> int:
    """splitmix64 finaliser: spreads (seed, step, tag) over 63 bits."""
    x &= (1 << 64) - 1
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    return x & ((1 << 63) - 1)


class OpContext:
    """Runtime context handed to op closures: the step's device, the seed
    material for ``rng`` and the program's amp policy
    (``paddle_tpu_torch.amp.Bf16Policy``, or None)."""

    def __init__(self, seed: int = 0, step: int = 0, device=None, amp=None):
        self.seed = int(seed)
        self.step = int(step)
        self.device = torch.device(device if device is not None else "cpu")
        self.amp = amp

    def rng(self, tag: int) -> torch.Generator:
        """A generator on the step's device, seeded deterministically from
        (program seed, step counter, tag): the same program, step and tag
        draw the same numbers.  It cannot give JAX's bits."""
        dev = self.device if self.device.type != "meta" else "cpu"
        gen = torch.Generator(device=dev)
        gen.manual_seed(_mix64(_mix64(_mix64(self.seed) + self.step)
                               + int(tag)))
        return gen


@dataclass
class Op:
    """One recorded operation.  ``fn(ins, attrs, ctx) -> outs`` where
    ins/outs map slot names to lists of tensors."""

    type: str
    inputs: Dict[str, List[str]]
    outputs: Dict[str, List[str]]
    attrs: Dict[str, Any]
    fn: Optional[Callable] = None
    special: Optional[str] = None  # 'backward' is interpreted by the Executor

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def apply(self, env: Dict[str, Any], ctx: OpContext) -> None:
        ins = {
            slot: [env[n] for n in names] for slot, names in self.inputs.items()
        }
        if ctx.amp is not None:
            ins = ctx.amp.cast_ins(self.type, self.attrs, ins)
        outs = self.fn(ins, self.attrs, ctx)
        for slot, names in self.outputs.items():
            vals = outs.get(slot, [])
            if len(vals) != len(names):
                raise RuntimeError(
                    f"op {self.type}: slot {slot} produced {len(vals)} values, "
                    f"declared {len(names)}"
                )
            for name, val in zip(names, vals):
                env[name] = val


# --------------------------------------------------------------------------- Block


class Block:
    """Flat op/var container."""

    def __init__(self, program: "Program", idx: int = 0):
        self.program = program
        self.idx = idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Op] = []

    def var(self, name: str) -> Variable:
        v = self.vars.get(name)
        if v is None:
            raise KeyError(f"no variable named {name!r} in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def create_var(self, name: Optional[str] = None, shape=(), dtype="float32",
                   **kw) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, shape, dtype, **kw)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype="float32", **kw) -> Variable:
        kw.setdefault("persistable", True)
        kw.setdefault("trainable", True)
        v = self.create_var(name, shape, dtype, **kw)
        self.program._parameters[name] = v
        return v

    def append_op(self, op: Op) -> Op:
        self.ops.append(op)
        return op


# --------------------------------------------------------------------------- Program


class Program:
    """Ordered op list + var table.  One Program typically holds forward +
    backward + optimizer update ops, like a Fluid ProgramDesc after
    append_backward."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._parameters: Dict[str, Variable] = {}
        self.random_seed: int = 0
        self._rng_tag = 0
        self.amp_policy = None   # set by amp.enable

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def parameters(self) -> List[Variable]:
        return list(self._parameters.values())

    def persistable_vars(self) -> List[Variable]:
        return [v for v in self.global_block.vars.values() if v.persistable]

    def next_rng_tag(self) -> int:
        """Unique tag for an op that consumes randomness (see OpContext.rng)."""
        self._rng_tag += 1
        return self._rng_tag

    def list_ops(self) -> List[Op]:
        return list(self.global_block.ops)


# --------------------------------------------------------------------------- defaults

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main: Program, startup: Optional[Program] = None):
    """Redirect layer construction to the given programs."""
    global _main_program, _startup_program
    om, os_ = _main_program, _startup_program
    _main_program = main
    if startup is not None:
        _startup_program = startup
    try:
        yield
    finally:
        _main_program, _startup_program = om, os_


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    unique_name.reset()
