"""Automatic mixed precision: bfloat16 compute, float32 master weights
(PyTorch port of ``paddle_tpu/amp.py``).

Parameters and optimizer state stay float32 in the Scope.  When the
Executor runs an op of a program with an amp policy, the op's float inputs
are cast first, by op type: to bfloat16 for the matmul, convolution and
elementwise bulk of a network (``BF16_OPS``), to float32 for everything
else (reductions, losses, optimizer updates), and not at all for the
normalisation layers (``PASSTHROUGH_OPS``), which keep a bfloat16
activation in bfloat16 and take their statistics in float32 themselves.
Optimizer ops always run in float32.  Gradients come back float32 through
the casts, since autograd differentiates with respect to the float32
master parameters.  bfloat16 has float32's exponent range, so there is no
loss scaling.

Usage::

    loss = ...build model...
    fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    fluid.amp.enable()          # or enable(program)
    exe.run(...)                # the step now runs bf16/f32 mixed
"""
from __future__ import annotations

from typing import Optional

import torch

from .core.program import Program, default_main_program

# op types that run in bfloat16 (the JAX package's list); any type not
# listed runs in float32
BF16_OPS = frozenset({
    "fc", "conv2d", "conv2d_transpose", "conv3d", "matmul", "mul",
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
    "relu", "relu6", "leaky_relu", "prelu", "elu", "brelu", "soft_relu",
    "sigmoid", "tanh", "stanh", "hard_sigmoid", "swish", "maxout",
    "pool2d", "pool3d", "pool_with_index", "dropout", "pad", "crop",
    "concat", "split", "reshape", "transpose", "expand", "scale",
    "sequence_conv", "row_conv", "im2sequence", "lookup_table",
    "flash_attention", "bilinear_tensor_product", "conv_shift",
})

# op types whose inputs are left as they arrive: they handle mixed dtypes
# themselves (bfloat16 activations, float32 parameters and statistics)
PASSTHROUGH_OPS = frozenset({"batch_norm", "layer_norm", "lrn"})

_FLOATS = (torch.float32, torch.bfloat16)


class Bf16Policy:
    """Per-op-type dtype policy.  ``compute_dtype(op_type, attrs)`` is the
    dtype float inputs are cast to before the op runs, or None to leave
    them."""

    def __init__(self, extra_bf16=(), extra_f32=()):
        self._bf16 = (BF16_OPS | frozenset(extra_bf16)) - frozenset(extra_f32)
        self._passthrough = (PASSTHROUGH_OPS - frozenset(extra_f32)
                             - frozenset(extra_bf16))

    def compute_dtype(self, op_type: str, attrs) -> Optional[torch.dtype]:
        if attrs.get("is_optimizer_op"):
            return torch.float32
        if op_type in self._passthrough:
            return None
        if op_type in self._bf16:
            return torch.bfloat16
        return torch.float32

    def input_dtype(self, op_type: str, attrs,
                    dtype: torch.dtype) -> torch.dtype:
        """The dtype an input of ``dtype`` has when an op of ``op_type``
        runs: the compute dtype for a float32 or bfloat16 input, ``dtype``
        itself for any other (float16 and integers are not cast)."""
        want = self.compute_dtype(op_type, attrs)
        return want if want is not None and dtype in _FLOATS else dtype

    def cast_ins(self, op_type: str, attrs, ins):
        """``ins`` (slot -> list of tensors) with every float32 or bfloat16
        tensor cast to the op's compute dtype; integer tensors and anything
        else pass unchanged."""
        want = self.compute_dtype(op_type, attrs)
        if want is None:
            return ins
        return {slot: [a.to(want) if isinstance(a, torch.Tensor)
                       and a.dtype in _FLOATS and a.dtype != want else a
                       for a in arrs]
                for slot, arrs in ins.items()}


def enable(program: Optional[Program] = None,
           policy: Optional[Bf16Policy] = None) -> Bf16Policy:
    """Turn on bfloat16 amp for ``program`` (the default main program)."""
    program = program or default_main_program()
    program.amp_policy = policy or Bf16Policy()
    program._version += 1  # a warmed step froze the old policy: re-key it
    return program.amp_policy


def disable(program: Optional[Program] = None) -> None:
    program = program or default_main_program()
    program.amp_policy = None
    program._version += 1
