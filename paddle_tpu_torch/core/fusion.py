"""Inference routing: the 3x3 convolutions of a forward-only program onto
the implicit-GEMM kernels (``ops/conv.py``).

The JAX package leaves a test program's conv2d -> batch_norm(is_test) ->
relu chains to XLA, which fuses the normalisation into the convolution's
epilogue (``paddle_tpu/models/resnet.py``).  The port has no XLA; this is
its counterpart, a plain function over the op list that
``Executor._build_step`` calls for a program with no ``backward`` op, on
every device (the CPU runs the same routed ops on the plain versions):

* **fused chain**: a ``conv2d`` with a 3x3 filter, stride 1, padding 1,
  dilation 1 and groups 1, whose output only an NCHW ``batch_norm`` with
  ``is_test`` reads, whose output only a ``relu`` reads, neither output
  fetched, becomes one ``conv2d_bn_relu`` op at the relu's place: the
  batch norm folded to ``a = scale * rsqrt(var + eps)``, ``b = bias - mean
  * a`` in float32 (``layers/nn.py``'s ``is_test`` formula) and
  ``igemm_conv_fused``.  The conv's own bias (``conv2d``'s
  ``elementwise_add`` op on slot ``B``, as ``nets.img_conv_group`` builds
  it) may stand between the conv and the batch norm, read by it alone and
  not fetched: it folds into ``b`` as ``b + a * conv_bias``.  Under amp
  the inputs are cast as the three ops would cast them (``Op.amp_types``):
  x and the filter as a conv2d's, the statistics and the conv's bias as a
  batch_norm's (left as they are); a policy under which
  the chain's output would not come out in the conv's compute dtype keeps
  the chain unfused;
* **plain conv**: any other conv2d of that geometry keeps its type and
  runs ``igemm_conv``;
* everything else (the stem's 7x7, the 1x1s, the stride-2 3x3s, and any
  conv whose compute dtype, after the amp policy, is neither float32 nor
  bfloat16, which the kernels do not take) stays on ``F.conv2d``, as the
  JAX package leaves those convolutions to XLA.

The model is NCHW and the kernels NHWC: an NCHW tensor in
``torch.channels_last`` memory format is an NHWC tensor, so the step puts
its 4-D float feeds into channels_last once (:func:`channels_last_feed`)
when the routing changed something, and cuDNN, the pools and the
elementwise ops keep that format; the kernels' NHWC outputs are returned
as NCHW views in it.  Each routed op turns its OIHW filter into HWIO once a
step.  The routed ops write no running statistic: an inference step leaves
them as they were.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import torch

from ..ops.conv import igemm_conv, igemm_conv_fused
from .program import Op, Program

FUSED_OP_TYPE = "conv2d_bn_relu"
_BN_SLOTS = ("Scale", "Bias", "Mean", "Variance")
_CONV_BIAS = "ConvBias"


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC; free for a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


def _igemm_fn(ins, attrs, ctx):
    (x,), (w,) = ins["Input"], ins["Filter"]
    return {"Out": [igemm_conv(_nhwc(x), _hwio(w)).permute(0, 3, 1, 2)]}


def _fused_fn(ins, attrs, ctx):
    (x,), (w,) = ins["Input"], ins["Filter"]
    sc, bs, mu, var = (ins[k][0].to(torch.float32) for k in _BN_SLOTS)
    a = sc * torch.rsqrt(var + attrs["epsilon"])
    b = bs - mu * a
    if _CONV_BIAS in ins:
        b = b + a * ins[_CONV_BIAS][0].to(torch.float32)
    y = igemm_conv_fused(_nhwc(x), _hwio(w), a, b)
    return {"Out": [y.permute(0, 3, 1, 2)]}


# the dtypes the conv kernels take (ops/conv.py)
KERNEL_CONV_DTYPES = (torch.float32, torch.bfloat16)


def compute_dtype(program: Program, name: str, op_type: str, attrs,
                  amp=None) -> torch.dtype:
    """The dtype variable ``name`` has when an op of ``op_type`` reads it:
    its declared dtype, cast as the amp policy casts that op's inputs."""
    dtype = program.global_block.vars[name].dtype
    return dtype if amp is None else amp.input_dtype(op_type, attrs, dtype)


def is_igemm_conv(op: Op, program: Program, amp=None) -> bool:
    """Whether ``op`` is a conv2d the kernels compute: 3x3 filter, stride
    1, padding 1, dilation 1, groups 1, and input and filter of one compute
    dtype (after ``amp``) that the kernels take."""
    if op.type != "conv2d":
        return False
    at = op.attrs
    if (tuple(at["strides"]), tuple(at["padding"]), tuple(at["dilation"]),
            at["groups"]) != ((1, 1), (1, 1), (1, 1), 1):
        return False
    (x,), (w,) = op.inputs["Input"], op.inputs["Filter"]
    dx, dw = (compute_dtype(program, n, "conv2d", at, amp) for n in (x, w))
    if dx != dw or dx not in KERNEL_CONV_DTYPES:
        return False
    return tuple(program.global_block.vars[w].shape[2:]) == (3, 3)


def _sole_reader(name, readers, fetched) -> Optional[int]:
    """The position of the one op that reads ``name``, when ``name`` is not
    fetched and has that one reader; else None."""
    if name in fetched or len(readers[name]) != 1:
        return None
    return readers[name][0]


def _is_conv_bias(op: Op, c: str, o: int, program: Program) -> bool:
    """Whether ``op`` is a conv2d's bias add on ``c``: an elementwise_add
    of ``c`` (slot X) and a [o] vector (slot B), as ``layers.conv2d``
    appends it."""
    if op.type != "elementwise_add" or op.inputs.get("X") != [c]:
        return False
    bias = op.inputs.get("B") or []
    return (len(bias) == 1 and tuple(program.global_block.vars[bias[0]]
                                     .shape) == (o,))


def _fused_chain(i, ops, readers, fetched, amp, program) -> Optional[tuple]:
    """(h, j, k): the positions of the conv bias add (or None), the
    batch_norm and the relu that fuse with the conv at ``i``, or None."""
    conv = ops[i]
    (c,) = conv.outputs["Out"]
    j = _sole_reader(c, readers, fetched)
    if j is None:
        return None
    h = None
    o = program.global_block.vars[conv.inputs["Filter"][0]].shape[0]
    if _is_conv_bias(ops[j], c, o, program):
        h, c = j, ops[j].outputs["Out"][0]
        j = _sole_reader(c, readers, fetched)
        if j is None:
            return None
    bn = ops[j]
    if (bn.type != "batch_norm" or not bn.attrs.get("is_test")
            or bn.attrs.get("ch_axis") != 1 or bn.inputs["X"] != [c]):
        return None
    y = bn.outputs["Out"][0]
    k = _sole_reader(y, readers, fetched)
    if k is None:
        return None
    relu = ops[k]
    if relu.type != "relu" or relu.inputs["X"] != [y]:
        return None
    if amp is not None and (
            amp.compute_dtype("conv2d", conv.attrs)
            != amp.compute_dtype("relu", relu.attrs)
            or (h is not None and amp.compute_dtype(
                "elementwise_add", ops[h].attrs)
                != amp.compute_dtype("conv2d", conv.attrs))
            or amp.compute_dtype("batch_norm", bn.attrs) is not None):
        return None
    return h, j, k


def _fused_op(conv: Op, bias: Optional[Op], bn: Op, relu: Op) -> Op:
    ins = {"Input": list(conv.inputs["Input"]),
           "Filter": list(conv.inputs["Filter"])}
    ins.update({s: list(bn.inputs[s]) for s in _BN_SLOTS})
    amp_types = {"Input": "conv2d", "Filter": "conv2d"}
    amp_types.update({s: "batch_norm" for s in _BN_SLOTS})
    if bias is not None:
        # left as it is, as the statistics: the fold is float32
        ins[_CONV_BIAS] = list(bias.inputs["B"])
        amp_types[_CONV_BIAS] = "batch_norm"
    return Op(FUSED_OP_TYPE, ins, {"Out": list(relu.outputs["Out"])},
              {"epsilon": bn.attrs["epsilon"]}, _fused_fn,
              amp_types=amp_types)


def route_inference(program: Program, fetch_names: Sequence[str],
                    amp=None) -> Optional[List[Op]]:
    """The op list a forward-only step of ``program`` runs, with its 3x3
    stride-1 convolutions routed as the module says, or None when no op
    was routed (the program then runs as it is)."""
    ops = program.list_ops()
    readers: Dict[str, List[int]] = defaultdict(list)
    for idx, op in enumerate(ops):
        for n in set(op.input_names()):
            readers[n].append(idx)
    fetched = set(fetch_names)
    routed: List[Optional[Op]] = list(ops)
    changed = False
    for i, op in enumerate(ops):
        if not is_igemm_conv(op, program, amp):
            continue
        changed = True
        chain = _fused_chain(i, ops, readers, fetched, amp, program)
        if chain is None:
            routed[i] = Op(op.type, op.inputs, op.outputs, op.attrs,
                           _igemm_fn)
            continue
        h, j, k = chain
        routed[k] = _fused_op(op, None if h is None else ops[h], ops[j],
                              ops[k])
        routed[i] = routed[j] = None
        if h is not None:
            routed[h] = None
    if not changed:
        return None
    return [op for op in routed if op is not None]


def channels_last_feed(feed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``feed`` with every 4-D float tensor in channels_last memory
    format (one copy each; the values are unchanged)."""
    return {n: v.contiguous(memory_format=torch.channels_last)
            if v.dim() == 4 and v.is_floating_point() else v
            for n, v in feed.items()}
