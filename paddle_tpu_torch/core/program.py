"""Program IR: Variable / Op / Block / Program (PyTorch port of
``paddle_tpu/core/program.py``).

A Program is an inspectable record of op closures over torch tensors; the
Executor runs it op by op, eagerly.  Shapes are inferred when a layer is
declared, by running the op's function on ``device="meta"`` tensors
(layers/helper.py).
"""
from __future__ import annotations

import contextlib
import copy
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
    ins/outs map slot names to lists of tensors.  Under amp the inputs are
    cast as the policy casts an op of ``type``, or, where ``amp_types``
    names an op type for a slot (an op that stands for a chain of ops,
    ``core/fusion.py``), that slot as the policy casts that type."""

    type: str
    inputs: Dict[str, List[str]]
    outputs: Dict[str, List[str]]
    attrs: Dict[str, Any]
    fn: Optional[Callable] = None
    special: Optional[str] = None  # 'backward' is interpreted by the Executor
    amp_types: Optional[Dict[str, str]] = None

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def apply(self, env: Dict[str, Any], ctx: OpContext) -> None:
        ins = {
            slot: [env[n] for n in names] for slot, names in self.inputs.items()
        }
        if ctx.amp is not None and self.amp_types is None:
            ins = ctx.amp.cast_ins(self.type, self.attrs, ins)
        elif ctx.amp is not None:
            ins = {slot: ctx.amp.cast_ins(self.amp_types[slot], self.attrs,
                                          {slot: vals})[slot]
                   for slot, vals in ins.items()}
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


def _op_key(op: Op):
    return (op.type, tuple(sorted((k, tuple(v))
                                  for k, v in op.outputs.items())))


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

    # ---- cloning (ref: fluid Program.clone; used for the test/eval program)
    def clone(self, for_test: bool = False) -> "Program":
        """A copy with its own variables and ops.  The ops share their
        closures with this program's, so an attr the closure reads at run
        time (``is_test``) is the clone's own.  ``for_test`` sets
        ``is_test`` on every op that has it and drops the backward and
        optimizer ops; the amp policy carries over."""
        p = Program.__new__(Program)
        p.blocks = [Block(p, 0)]
        p._parameters = {}
        p.random_seed = self.random_seed
        p._rng_tag = self._rng_tag
        p.amp_policy = self.amp_policy
        blk = p.global_block
        for name, v in self.global_block.vars.items():
            nv = copy.copy(v)
            nv.block = blk
            blk.vars[name] = nv
            if name in self._parameters:
                p._parameters[name] = nv
        for op in self.global_block.ops:
            nop = Op(
                type=op.type,
                inputs={k: list(vs) for k, vs in op.inputs.items()},
                outputs={k: list(vs) for k, vs in op.outputs.items()},
                attrs=dict(op.attrs),
                fn=op.fn,
                special=op.special,
                amp_types=op.amp_types,
            )
            if for_test and "is_test" in nop.attrs:
                nop.attrs["is_test"] = True
            blk.ops.append(nop)
        if for_test:
            # drop backward/optimize ops: the eval program is forward-only
            blk.ops = [o for o in blk.ops if o.special != "backward"
                       and not o.attrs.get("is_optimizer_op")]
        return p

    def prune(self, targets: Sequence[Variable]) -> "Program":
        """The test clone with only the ops that ``targets`` reach, found in
        reverse order (ref: paddle/framework/prune.cc); kept ops are
        matched by (type, outputs), as in the JAX package."""
        needed = {t.name for t in targets}
        kept_rev: List[Op] = []
        for op in reversed(self.global_block.ops):
            if op.special == "backward" or op.attrs.get("is_optimizer_op"):
                continue
            if needed & set(op.output_names()):
                kept_rev.append(op)
                needed |= set(op.input_names())
        p = self.clone(for_test=True)
        keyset = {_op_key(o) for o in kept_rev}
        p.global_block.ops = [o for o in p.global_block.ops
                              if _op_key(o) in keyset]
        return p


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
