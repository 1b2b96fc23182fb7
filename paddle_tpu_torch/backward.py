"""append_backward: program-level autodiff (PyTorch port of
``paddle_tpu/backward.py``).

A single 'backward' meta-op is appended; the Executor runs the forward once
on leaf parameters and differentiates it with ``torch.autograd.grad`` (see
core/executor.py ``_apply_backward``).  Gradient variables use the
reference's ``<name>@GRAD`` naming so the clip and optimizer ops compose as
in the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .core.program import Op, Variable

GRAD_SUFFIX = "@GRAD"


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[set] = None,
    loss_scale: float = 1.0,
) -> List[Tuple[Variable, Variable]]:
    program = loss.program
    block = program.global_block
    no_grad = set(no_grad_set or ())
    if parameter_list is not None:
        params = list(parameter_list)
    else:
        params = [p.name for p in program.parameters() if p.trainable and p.name not in no_grad]
    if not params:
        raise ValueError("append_backward: no trainable parameters in program")

    grad_names = []
    for p in params:
        pv = block.var(p)
        gv = block.create_var(p + GRAD_SUFFIX, pv.shape, pv.dtype)
        grad_names.append(gv.name)

    block.append_op(
        Op(
            type="backward",
            inputs={"Loss": [loss.name]},
            outputs={"Grads": grad_names},
            attrs={
                "loss": loss.name,
                "params": params,
                "loss_scale": loss_scale,
            },
            fn=None,
            special="backward",
        )
    )
    return [(block.var(p), block.var(p + GRAD_SUFFIX)) for p in params]
