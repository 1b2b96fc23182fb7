"""LayerHelper: the bridge between layer functions and the Program IR
(PyTorch port of ``paddle_tpu/layers/helper.py``).

  - creates parameters in the main program AND records their init op in the
    startup program;
  - creates output variables with build-time shape inference: the op's
    function runs on ``device="meta"`` tensors, which carry shapes and dtypes
    and no data (the counterpart of ``jax.eval_shape``), so a program is
    built without touching the card;
  - appends ops.

Dynamic (batch) dims: Variables store None for the batch axis; for the meta
run a sentinel extent stands in and is mapped back to None in outputs.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from ..core import unique_name
from ..core.program import (Block, Op, OpContext, Program, Variable,
                            default_main_program, default_startup_program)
from ..core.types import convert_dtype
from ..initializer import Constant, Xavier
from ..param_attr import ParamAttr

_BATCH_SENTINEL = 8191  # prime, large enough to never collide with a static dim


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
        self.main_program: Program = default_main_program()
        self.startup_program: Program = default_startup_program()

    @property
    def name(self) -> str:
        """The layer's ``name`` argument, or a fresh unique name on each read
        (as in the JAX package, whose batch_norm reads it twice)."""
        n = self.kwargs.get("name")
        return n or unique_name.generate(self.layer_type)

    @property
    def block(self) -> Block:
        return self.main_program.global_block

    # ------------------------------------------------------------- parameters
    def create_parameter(
        self,
        attr: Union[ParamAttr, None],
        shape: Sequence[int],
        dtype="float32",
        is_bias: bool = False,
        default_initializer=None,
    ) -> Variable:
        attr = ParamAttr.to_attr(attr)
        if attr.sharding is not None:
            raise NotImplementedError(
                "ParamAttr(sharding=...) is not ported yet: parallel layouts "
                "are ROADMAP A.9")
        name = attr.name or unique_name.generate(f"{self.layer_type}_{'b' if is_bias else 'w'}")
        init = attr.initializer or default_initializer or (Constant(0.0) if is_bias else Xavier())
        shape = tuple(int(s) for s in shape)
        if self.block.has_var(name):
            # parameter sharing by name
            return self.block.var(name)
        param = self.block.create_parameter(
            name,
            shape,
            dtype,
            regularizer=attr.regularizer,
            trainable=attr.trainable,
        )
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        # record the init op in the startup program
        sblock = self.startup_program.global_block
        svar = sblock.create_var(name, shape, dtype, persistable=True,
                                 trainable=attr.trainable)
        self.startup_program._parameters[name] = svar
        tag = self.startup_program.next_rng_tag()
        dt = convert_dtype(dtype)

        def init_fn(ins, attrs, ctx: OpContext, _init=init, _shape=shape,
                    _dt=dt, _tag=tag):
            return {"Out": [_init(_shape, _dt, ctx.rng(_tag))]}

        sblock.append_op(Op("init", {}, {"Out": [name]}, {"shape": shape}, init_fn))

        if attr.update_hook is not None:
            # static pruning (hooks.py): the startup program computes the
            # persistable mask from the freshly initialised value and zeroes
            # the pruned weights; Optimizer.minimize finds the hook on the
            # parameter and masks its gradient every step
            from ..hooks import mask_name

            hook = attr.update_hook
            mname = mask_name(name)
            param.update_hook = hook
            self.block.create_var(mname, shape, dtype, persistable=True,
                                  trainable=False)
            sblock.create_var(mname, shape, dtype, persistable=True,
                              trainable=False)

            def hook_fn(ins, attrs, ctx, _hook=hook):
                value = ins["Param"][0]
                mask = _hook.mask_for(value)
                return {"Out": [mask, value * mask]}

            sblock.append_op(Op("update_hook_init",
                                {"Param": [name]}, {"Out": [mname, name]},
                                {"hook": repr(hook)}, hook_fn))
        return param

    # ------------------------------------------------------------- op append
    def append_op(
        self,
        fn: Callable,
        inputs: Dict[str, Sequence[Variable]],
        attrs: Optional[Dict[str, Any]] = None,
        n_outputs: int = 1,
        op_type: Optional[str] = None,
        out_names: Optional[Sequence[str]] = None,
    ) -> Union[Variable, List[Variable]]:
        """Append an op whose closure maps positional tensors to a tensor or
        a tuple of tensors: ``fn(ctx, *tensors, **attrs)``, plain PyTorch.
        Output shapes and dtypes come from running it on meta tensors.
        ``out_names`` names the outputs (default: fresh unique names)."""
        attrs = dict(attrs or {})
        op_type = op_type or self.layer_type
        in_vars: List[Variable] = []
        in_slots: Dict[str, List[str]] = {}
        for slot, vs in inputs.items():
            vs = list(vs)
            in_slots[slot] = [v.name for v in vs]
            in_vars.extend(vs)

        # ---- build-time shape inference
        metas = [torch.empty(tuple(_BATCH_SENTINEL if d is None else d
                                   for d in v.shape),
                             dtype=v.dtype, device="meta") for v in in_vars]
        with torch.no_grad():
            res = fn(OpContext(device="meta"), *metas, **attrs)
        res = res if isinstance(res, tuple) else (res,)

        out_vars: List[Variable] = []
        lod = in_vars[0].lod_level if in_vars else 0
        for i, t in enumerate(res):
            shape = tuple(None if d == _BATCH_SENTINEL else d for d in t.shape)
            name = (out_names[i] if out_names
                    else unique_name.generate(f"{op_type}.out"))
            ov = self.block.create_var(name, shape, t.dtype, lod_level=lod)
            out_vars.append(ov)

        slot_names = {"Out": [v.name for v in out_vars]}

        def op_fn(ins, op_attrs, ctx, _fn=fn, _slots=in_slots):
            arrays = [a for slot in _slots for a in ins[slot]]
            res = _fn(ctx, *arrays, **op_attrs)
            res = res if isinstance(res, tuple) else (res,)
            return {"Out": list(res)}

        self.block.append_op(Op(op_type, in_slots, slot_names, attrs, op_fn))
        return out_vars[0] if n_outputs == 1 and len(out_vars) == 1 else out_vars

    # ------------------------------------------------------------- activation
    def append_activation(self, x: Variable, act: Optional[str]) -> Variable:
        if act is None:
            return x
        from . import ops as _ops

        fn = getattr(_ops, act, None)
        if fn is None:
            raise ValueError(f"unknown activation {act!r}")
        return fn(x)
