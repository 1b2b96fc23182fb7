"""Control flow (PyTorch port of the ``paddle_tpu/layers/control_flow.py``
subset the training slices use): ``recompute`` with the helpers it needs
(``_hoist_parameters``, ``_exec_sub``, ``_captured_names``).  StaticRNN,
DynamicRNN, ``cond`` and the while loops are ROADMAP A.7.

A construct's body is recorded into a sub-Program; the construct becomes
ONE op in the outer program whose closure runs the body's ops.
Parameters created inside the body are hoisted to the outer program so
that the Executor threads them as state, under their own names.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..core import unique_name
from ..core.program import (Op, OpContext, Program, default_main_program,
                            program_guard)
from .helper import LayerHelper


def _hoist_parameters(sub: Program, outer: Program):
    """Parameters created while recording the body live in the
    sub-program; re-register them on the outer program so state threading
    sees them (ref ``control_flow.py:30``)."""
    outer_block = outer.global_block
    names = []
    for name, v in sub._parameters.items():
        if not outer_block.has_var(name):
            nv = outer_block.create_parameter(name, v.shape, v.dtype,
                                              regularizer=v.regularizer,
                                              trainable=v.trainable)
            nv.optimize_attr = getattr(v, "optimize_attr",
                                       {"learning_rate": 1.0})
        names.append(name)
    # non-parameter persistables (e.g. batch-norm statistics) too
    for name, v in sub.global_block.vars.items():
        if v.persistable and not outer_block.has_var(name):
            outer_block.create_var(name, v.shape, v.dtype, persistable=True,
                                   trainable=v.trainable)
            names.append(name)
    return names


def _exec_sub(ops: List[Op], env: Dict, ctx: OpContext):
    for op in ops:
        op.apply(env, ctx)
    return env


def _captured_names(ops: List[Op], out_names: Sequence[str], outer: Program):
    """Outer vars a recorded sub-block reads: inputs not produced inside,
    plus outputs the block never produces (identity outputs of an outer
    var)."""
    produced, needed = set(), []
    for op in ops:
        for n in op.input_names():
            if n not in produced and n not in needed:
                needed.append(n)
        produced |= set(op.output_names())
    for n in out_names:
        if n not in produced and n not in needed:
            needed.append(n)
    return [n for n in needed if outer.global_block.has_var(n)]


def recompute(fn: Callable, name=None):
    """Activation rematerialisation over a sub-block (the reference's
    ``jax.checkpoint``, ``control_flow.py:312``).

    ``fn()`` builds layers, recorded as a sub-program, and returns its
    output Variable(s).  The block's activations are not kept for the
    backward: ``torch.utils.checkpoint`` (non-reentrant, since the
    Executor's backward is ``torch.autograd.grad``; no RNG state, since a
    random op draws from its threefry key, ``ctx.rng_key``) runs its ops
    again in the backward.  Parameters created inside are hoisted and
    trained under their own names.

    One divergence from the reference, on purpose: a random op inside the
    block draws its tag from the OUTER program, so ``remat`` changes no
    dropout mask (the reference's block draws tags from its fresh
    sub-program, and each block repeats the tags 1, 2, ...; its own
    contract says remat is numerically identical to the plain build).

        h = layers.recompute(lambda: my_transformer_block(x))
    """
    helper = LayerHelper("recompute", name=name)
    outer = default_main_program()
    sub = Program()
    sub._rng_tag = outer._rng_tag
    with program_guard(sub):
        out = fn()
    outer._rng_tag = sub._rng_tag
    outs = out if isinstance(out, (list, tuple)) else [out]
    _hoist_parameters(sub, outer)
    ops = list(sub.global_block.ops)
    out_names = [o.name for o in outs]
    cap = _captured_names(ops, out_names, outer)

    def op_fn(ins, attrs, ctx):
        def runner(*cvals):
            env = dict(zip(cap, cvals))
            _exec_sub(ops, env, ctx)
            return tuple(env[n] for n in out_names)

        if not torch.is_grad_enabled():
            return {"Out": list(runner(*ins["Cap"]))}
        res = checkpoint(runner, *ins["Cap"], use_reentrant=False,
                         preserve_rng_state=False)
        return {"Out": list(res)}

    block = helper.block

    def _tmpl(n):
        sub_blk = sub.global_block
        return sub_blk.var(n) if sub_blk.has_var(n) \
            else outer.global_block.var(n)

    out_vars = [block.create_var(unique_name.generate("recompute.out"),
                                 _tmpl(n).shape, _tmpl(n).dtype)
                for n in out_names]
    block.append_op(Op("recompute", {"Cap": cap},
                       {"Out": [v.name for v in out_vars]}, {}, op_fn,
                       sub_block=sub.global_block))
    return out_vars if len(out_vars) > 1 else out_vars[0]


__all__ = ["recompute"]
