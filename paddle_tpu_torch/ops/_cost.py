"""The work of one prepared signature: flops and bytes accessed, counted
while its body runs once eagerly (``count``), never at a replay.

This is the port's counterpart of XLA's ``cost_analysis()``, which the
reference reads off each compiled executable (``paddle_tpu/obs/prof.py::
analyze``):

  * flops through ``torch.utils.flop_counter.FlopCounterMode`` (the matmul
    and convolution families, and the formulas registered below for the
    port's custom ops);
  * bytes accessed as the sum of each dispatched op's tensor input and
    output bytes (views and uninitialised allocations move none), XLA's
    per-op "bytes accessed" reckoning.

The hand kernels are ``ctypes`` launches that neither mode sees.  The four
custom ops (``flash_fwd``, ``lstm_fwd``, ``conv_igemm``,
``conv_igemm_fused``) are seen as one op each: a registered flop formula
and their operands' bytes.  Every other launch wrapper calls :func:`add`
with its kernel's work from its shapes, the work that ``chip_smoke.py``'s
bound reckons for that kernel; inside a custom op's implementation
:func:`add` adds nothing, so that no launch is counted twice.  Outside a
count :func:`add` is one list check.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

_active: List[Dict[str, float]] = []   # the counts open, innermost last
_in_custom = [0]                      # depth of custom ops being dispatched

_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias")


def add(flops: float, nbytes: float) -> None:
    """Add one hand-kernel launch's work to the innermost open count (none
    open, or inside a custom op already counted as one op: nothing)."""
    if _active and not _in_custom[0]:
        c = _active[-1]
        c["flops"] += float(flops)
        c["bytes_accessed"] += float(nbytes)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _bytes_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Bytes(TorchDispatchMode):
        def __init__(self, out: Dict[str, float]):
            super().__init__()
            self.out = out

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            custom = func.namespace == "paddle_tpu_torch"
            if custom:
                _in_custom[0] += 1
            try:
                res = func(*args, **kwargs)
            finally:
                if custom:
                    _in_custom[0] -= 1
            name = func.__name__.split(".")[0]
            if not func.is_view and name not in _FREE:
                self.out["bytes_accessed"] += float(
                    _nbytes(args) + _nbytes(kwargs) + _nbytes(res))
            return res

    return _Bytes


def count(body: Callable[[], None]) -> Dict[str, float]:
    """Run ``body()`` once under the counting modes; returns ``{"flops",
    "bytes_accessed"}``.  Raises what ``body`` raises."""
    from torch.utils.flop_counter import FlopCounterMode

    _register_formulas()
    out = {"flops": 0.0, "bytes_accessed": 0.0}
    flops = FlopCounterMode(display=False)
    _active.append(out)
    try:
        with flops, _bytes_mode()(out):
            body()
    finally:
        _active.pop()
    out["flops"] += float(flops.get_total_flops())
    return out


# ------------------------------------------------------------ kernel work
#
# Each returns (flops, bytes) of one launch: the operations and the bytes
# (each input read once, each output written once) of the bound that
# chip_smoke.py reckons for the kernel.


def flash_work(kernel: str, N: int, Tq: int, Tk: int, D: int, causal: bool,
               itemsize: int) -> tuple:
    """Two products in the forward (q.k, p.v), four in dK/dV, three in dQ,
    over the score entries the mask keeps."""
    if causal:
        pairs = N * float(np.minimum(np.arange(1, Tq + 1), Tk).sum())
    else:
        pairs = float(N * Tq * Tk)
    products = {"fwd": 2, "bwd_dkdv": 4, "bwd_dq": 3}[kernel]
    q_b, kv_b, st_b = N * Tq * D * itemsize, N * Tk * D * itemsize, N * Tq * 4
    nbytes = {"fwd": 2 * q_b + 2 * kv_b + st_b,
              "bwd_dkdv": 2 * q_b + 4 * kv_b + 2 * st_b,
              "bwd_dq": 3 * q_b + 2 * kv_b + 2 * st_b}[kernel]
    return 2.0 * D * pairs * products, float(nbytes)


def paged_work(q: torch.Tensor, lengths: torch.Tensor, tables: torch.Tensor,
               heads: int, head_dim: int, block: int, kv_itemsize: int,
               quantized: bool) -> tuple:
    """The live K/V tiles read once (scales too when quantized), q, the
    tables and lengths read once, the output written once; the score and
    value multiply-adds over the live positions.  Reads the lengths, so
    it syncs: a count runs once, at a signature's preparation."""
    W = q.shape[1]
    live = lengths.reshape(lengths.shape[0], -1).max(dim=1).values
    live_pos = (-(-live.to(torch.int64).cpu() // block) * block).double()
    per_pos = heads * head_dim * kv_itemsize + (heads * 4 if quantized
                                                else 0)
    nbytes = (2 * float(live_pos.sum()) * per_pos
              + 2 * q.numel() * q.element_size()
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = float((2 * 2 * W * heads * head_dim * live_pos).sum())
    return flops, nbytes


def lstm_work(kernel: str, T: int, B: int, H: int, n_valid: int) -> tuple:
    """The recurrent product over the (step, row) pairs the mask keeps;
    float32 operands as ``chip_smoke._lstm_bound`` lists them (the
    kernel's own launch: the backward without du)."""
    tbh, bh, u = T * B * H, B * H, H * 4 * H
    flops = 2.0 * n_valid * H * 4 * H
    if kernel == "fwd":
        elems = 4 * tbh + u + 3 * H + T * B + tbh + 2 * (tbh + bh) \
            + 4 * tbh + tbh
    else:
        elems = tbh + bh + u + 3 * H + T * B + 4 * tbh + tbh + (tbh + bh) \
            + 4 * tbh
    return flops, 4.0 * elems


def bn_work(kernel: str, n: int, c: int, hw: int, itemsize: int) -> tuple:
    """Reduction: dy, x in, mean, rstd in, dbeta, dgamma out, 3 operations
    an element; dx: dy, x in, five vectors in, dx out, 4 an element."""
    elems = n * c * hw
    nbytes = ({"reduce": 2, "dx": 3}[kernel] * elems * itemsize
              + {"reduce": 4, "dx": 5}[kernel] * c * 4)
    return float({"reduce": 3, "dx": 4}[kernel] * elems), float(nbytes)


def conv_work(fused: bool, n, h, w, c, o, itemsize: int) -> tuple:
    """x, w (and the epilogue's a, b) read once, the output written once;
    2 N H W 9 C O for the nine taps, plus 3 an output fused."""
    nbytes = (n * h * w * c + 9 * c * o + n * h * w * o) * itemsize \
        + (2 * o * 4 if fused else 0)
    flops = 2.0 * n * h * w * 9 * c * o + (3.0 * n * h * w * o if fused
                                            else 0.0)
    return flops, float(nbytes)


def dropout_work(n: int, itemsize: int) -> tuple:
    """x read and y written once; the mask's integer work is not counted
    as floating-point operations."""
    return 0.0, 2.0 * n * itemsize


# -------------------------------------------- the custom ops' flop formulas

_registered = [False]


def _register_formulas() -> None:
    if _registered[0]:
        return
    from torch.utils.flop_counter import register_flop_formula

    ops = torch.ops.paddle_tpu_torch

    @register_flop_formula(ops.flash_fwd)
    def _flash(q, k, v, scale, causal, out_shape=None, **kw):
        N, Tq, D = q
        return int(flash_work("fwd", N, Tq, k[1], D, causal, 4)[0])

    @register_flop_formula(ops.lstm_fwd)
    def _lstm(xw, u, peep, mask, *args, out_shape=None, **kw):
        # every (step, row) pair: the formula sees shapes, not the mask
        T, B = xw[0], xw[1]
        H = u[0]
        return int(2 * T * B * H * 4 * H)

    def _conv(x, w, *args, fused=False):
        n, h, wd, c = x
        o = w[-1]
        return int(conv_work(fused, n, h, wd, c, o, 4)[0])

    @register_flop_formula(ops.conv_igemm)
    def _conv_plain(x, w, out_shape=None, **kw):
        return _conv(x, w)

    @register_flop_formula(ops.conv_igemm_fused)
    def _conv_fused(x, w, a, b, *args, out_shape=None, **kw):
        return _conv(x, w, fused=True)

    _registered[0] = True
