"""Batch normalisation in training, with a hand-written CUDA backward.

``batch_norm_train(x, scale, bias, eps)`` is a ``torch.autograd.Function``
over NCHW-like input (channels on dim 1, any trailing dims):

* its forward is plain PyTorch and follows the JAX package's op
  (``paddle_tpu/layers/nn.py:339-377``) exactly: float32 mean and E[x^2]
  over every dim but 1, ``bvar = max(E[x^2] - mean^2, 0)``, ``scale_eff =
  scale * rsqrt(bvar + eps)``, ``out = x * scale_eff + bias_eff`` in x's
  dtype.  It returns (out, batch mean, batch variance; the two statistics
  carry no gradient) and saves x, mean and rstd, not the normalised x;
* its backward is the closed form dbeta = sum dy, dgamma = sum dy * xhat,
  dx = scale * rstd * (dy - dbeta / M - xhat * dgamma / M), with
  ``xhat = (x - mean) * rstd`` and M the values a channel.  On CUDA tensors
  it runs the two kernels of ``csrc/batch_norm.cu`` (the ports of
  ``benchmark/bn_probe.py``'s Pallas ``_red_kernel`` and ``_dx_kernel``),
  or raises: there is no fallback.  On CPU tensors it runs their plain
  versions, :func:`bn_bwd_reduce_reference` and :func:`bn_bwd_dx_reference`.
  The dx kernel takes M as an argument: under a Strategy's data axes the
  statistics, dbeta and dgamma are the global batch's (see
  :func:`batch_norm_train`).

JAX differentiates the one-pass forward by autodiff (through mean, E[x^2]
and the clamp at 0); the closed form is the same function's gradient
wherever the clamp is not active, and both give the variance path nothing
for a constant channel.

``batch_norm_train.launches`` counts kernel calls, one per call of each
kernel wrapper (a reduction with more than one split enqueues its combine
launch too): ``{"reduce": n, "dx": n}``.  Plain-version calls never count.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, _cost

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# constants of csrc/batch_norm.cu (kThreads); a test pins them
THREADS = 256
# the (channel, split) grid: splits so that C x splits gives about
# BLOCKS_PER_SM blocks of THREADS threads an SM (two waves at full
# occupancy), each block with at least MIN_VECTORS_PER_THREAD loads a
# thread
BLOCKS_PER_SM = 16
MIN_VECTORS_PER_THREAD = 4
MAX_SPLITS = 65535

_sm_counts: dict = {}

_build.declare("batch_norm.cu", "bn_bwd_reduce_launch", ctypes.c_int,
               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
               + [ctypes.c_void_p])
_build.declare("batch_norm.cu", "bn_bwd_dx_launch", ctypes.c_int,
               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
               + [ctypes.c_longlong, ctypes.c_void_p])


# ------------------------------------------------------------ plain versions


def _per_channel(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[C] viewed to broadcast over ``like`` (channels on dim 1)."""
    return v.reshape((1, -1) + (1,) * (like.dim() - 2))


def _reduce_dims(x: torch.Tensor) -> tuple:
    return (0,) + tuple(range(2, x.dim()))


def bn_bwd_reduce_reference(dy, x, mean, rstd):
    """Plain version of the reduction kernel: (dbeta, dgamma) float32 [C],
    dbeta = sum dy and dgamma = sum dy * (x - mean) * rstd over every dim
    but 1, accumulated in float32."""
    dyf = dy.to(torch.float32)
    xhat = (x.to(torch.float32) - _per_channel(mean, x)) * _per_channel(rstd,
                                                                        x)
    dims = _reduce_dims(x)
    return dyf.sum(dims), (dyf * xhat).sum(dims)


def bn_bwd_dx_reference(dy, x, mean, rstd, gamma, dbeta, dgamma, count=None):
    """Plain version of the dx kernel: gamma * rstd * (dy - dbeta / M -
    xhat * dgamma / M) in float32, returned in dy's dtype; M is ``count``,
    the values a channel that dbeta and dgamma sum over (by default this
    batch's, N x HW)."""
    m = count or dy.numel() // max(dy.shape[1], 1)
    g = gamma.to(torch.float32) * rstd
    xhat = (x.to(torch.float32) - _per_channel(mean, x)) * _per_channel(rstd,
                                                                        x)
    dx = _per_channel(g, x) * (dy.to(torch.float32)
                               - _per_channel(dbeta / m, x)
                               - xhat * _per_channel(dgamma / m, x))
    return dx.to(dy.dtype)


# ------------------------------------------------------------------ kernels


def _sm_count(dev: torch.device) -> int:
    n = _sm_counts.get(dev.index)
    if n is None:
        n = _sm_counts[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def vector_width(hw: int, itemsize: int, pointers) -> int:
    """Values a thread loads at once: the widest of 16 bytes (4 float32, 8
    bfloat16) and its halves that divides HW and every pointer's
    alignment."""
    vec = 16 // itemsize
    while vec > 1 and (hw % vec or any(p % (vec * itemsize)
                                       for p in pointers)):
        vec //= 2
    return vec


def n_splits(n: int, c: int, hw_vectors: int, n_sm: int) -> int:
    """Splits of each channel's n x hw_vectors vectors: enough that c x
    splits blocks give about BLOCKS_PER_SM blocks an SM, and none so many
    that a block's threads get fewer than MIN_VECTORS_PER_THREAD loads."""
    want = -(-BLOCKS_PER_SM * n_sm // c)
    cap = max(1, (n * hw_vectors) // (THREADS * MIN_VECTORS_PER_THREAD))
    return max(1, min(want, cap, MAX_SPLITS))


def check_bn_dtype(dtype: torch.dtype) -> None:
    """Raise on a dtype the backward kernels do not take: ``_geometry``
    calls this at every launch, and ``Executor.run`` before the first step
    of a training program on a card."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the batch-norm kernels take float32 or bfloat16 "
                         f"dy and x of one dtype, got {dtype}")


def _geometry(dy, x, vectors):
    """(N, C, HW, splits, vec, dtype code) of a launch; raises on what the
    kernels do not take.  ``vectors`` are the operands read and written
    with vector loads."""
    if dy.device.type != "cuda":
        raise ValueError(f"the batch-norm kernels run on CUDA tensors, not "
                         f"{dy.device.type}")
    if x.device != dy.device:
        raise ValueError(f"dy and x must lie on one device: {dy.device}, "
                         f"{x.device}")
    check_bn_dtype(dy.dtype)
    if x.dtype != dy.dtype:
        raise ValueError(f"the batch-norm kernels take float32 or bfloat16 "
                         f"dy and x of one dtype, got {dy.dtype}, {x.dtype}")
    if dy.shape != x.shape or dy.dim() < 2:
        raise ValueError(f"dy and x must be one [N, C, ...] shape, got "
                         f"{tuple(dy.shape)}, {tuple(x.shape)}")
    n, c = int(x.shape[0]), int(x.shape[1])
    hw = x.numel() // max(n * c, 1)
    if max(n, hw) >= 2 ** 31:
        raise ValueError(f"batch too large for the batch-norm kernels: N={n}, "
                         f"HW={hw}")
    vec = vector_width(hw, x.element_size(), [t.data_ptr() for t in vectors])
    return n, c, hw, n_splits(n, c, hw // vec, _sm_count(x.device)), vec, \
        _DTYPE_CODE[x.dtype]


def _channel_vectors(c: int, dev, *vs):
    out = []
    for v in vs:
        if v.numel() != c:
            raise ValueError(f"per-channel operands must have {c} values, got "
                             f"{tuple(v.shape)}")
        out.append(v.to(device=dev, dtype=torch.float32).contiguous())
    return out


def _call(name: str, args, dev) -> None:
    fn = getattr(_build.load_kernel_library("batch_norm.cu"), name)
    args = args + (torch.cuda.current_stream(dev).cuda_stream,)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def bn_bwd_reduce_kernel(dy, x, mean, rstd):
    """One call of the reduction kernel (and, with more than one split, its
    combine): (dbeta, dgamma) float32 [C]."""
    dy, x = dy.contiguous(), x.contiguous()
    n, c, hw, splits, vec, code = _geometry(dy, x, (dy, x))
    mean, rstd = _channel_vectors(c, x.device, mean, rstd)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    dgamma = torch.empty_like(dbeta)
    part = (torch.empty((2, splits, c), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    _call("bn_bwd_reduce_launch",
          (dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           None if part is None else part[0].data_ptr(),
           None if part is None else part[1].data_ptr(),
           dbeta.data_ptr(), dgamma.data_ptr(), n, c, hw, splits, vec, code),
          x.device)
    batch_norm_train.launches["reduce"] += 1
    if _cost._active:
        _cost.add(*_cost.bn_work("reduce", n, c, hw, x.element_size()))
    return dbeta, dgamma


def bn_bwd_dx_kernel(dy, x, mean, rstd, gamma, dbeta, dgamma, count=None):
    """One call of the dx kernel: dx in dy's dtype and shape; ``count`` is
    M, as in the plain version."""
    dy, x = dy.contiguous(), x.contiguous()
    dx = torch.empty_like(x)
    n, c, hw, splits, vec, code = _geometry(dy, x, (dy, x, dx))
    count = int(count or n * hw)
    mean, rstd, gamma, dbeta, dgamma = _channel_vectors(
        c, x.device, mean, rstd, gamma, dbeta, dgamma)
    _call("bn_bwd_dx_launch",
          (dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           gamma.data_ptr(), dbeta.data_ptr(), dgamma.data_ptr(),
           dx.data_ptr(), n, c, hw, splits, vec, code, count), x.device)
    batch_norm_train.launches["dx"] += 1
    if _cost._active:
        _cost.add(*_cost.bn_work("dx", n, c, hw, x.element_size()))
    return dx


# The backward pair as the custom ops ``torch.ops.paddle_tpu_torch.
# bn_bwd_reduce`` (dy, x, mean, rstd) -> (dbeta, dgamma) and ``bn_bwd_dx``
# (dy, x, mean, rstd, gamma, dbeta, dgamma, count) -> dx (``count`` M, 0 for
# this call's N x HW): the kernels on CUDA tensors, the plain versions on
# CPU ones, a fake implementation for the shapes.  ``_BatchNormTrain``
# calls them, so that a trace of a training step (``compile/aot.py``)
# holds each kernel as one node.


@torch.library.custom_op("paddle_tpu_torch::bn_bwd_reduce", mutates_args=(),
                         device_types="cpu")
def bn_bwd_reduce(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return bn_bwd_reduce_reference(dy, x, mean, rstd)


@bn_bwd_reduce.register_kernel("cuda")
def _bn_bwd_reduce_cuda(dy, x, mean, rstd):
    return bn_bwd_reduce_kernel(dy, x, mean, rstd)


@bn_bwd_reduce.register_fake
def _bn_bwd_reduce_fake(dy, x, mean, rstd):
    c = x.shape[1]
    return (x.new_empty((c,), dtype=torch.float32),
            x.new_empty((c,), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::bn_bwd_dx", mutates_args=(),
                         device_types="cpu")
def bn_bwd_dx(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
              rstd: torch.Tensor, gamma: torch.Tensor, dbeta: torch.Tensor,
              dgamma: torch.Tensor, count: int = 0) -> torch.Tensor:
    return bn_bwd_dx_reference(dy, x, mean, rstd, gamma, dbeta, dgamma,
                               count or None).contiguous()


@bn_bwd_dx.register_kernel("cuda")
def _bn_bwd_dx_cuda(dy, x, mean, rstd, gamma, dbeta, dgamma, count=0):
    return bn_bwd_dx_kernel(dy, x, mean, rstd, gamma, dbeta, dgamma,
                            count or None)


@bn_bwd_dx.register_fake
def _bn_bwd_dx_fake(dy, x, mean, rstd, gamma, dbeta, dgamma, count=0):
    return x.new_empty(x.shape, dtype=dy.dtype)


# ------------------------------------------------------------------ public


def _global_moments(x32, dims, groups):
    """(mean, E[x^2], count) of each channel over this rank's rows and the
    ranks of ``groups``: the float32 sums of x and x^2 all-reduced (one
    call a group), the count the rank's times the ranks (a Strategy cuts
    the batch into equal shards)."""
    from ..parallel import comm

    count = x32.numel() // max(x32.shape[1], 1)
    sums = torch.stack([x32.sum(dims), torch.square(x32).sum(dims)])
    for g in groups:
        sums = comm.all_reduce(sums, g)
        count *= comm.size(g)
    return sums[0] / count, sums[1] / count, count


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, groups):
        # the JAX package's training forward, statistics in float32; under
        # a Strategy over the global batch (the sums over the data groups)
        dims = _reduce_dims(x)
        x32 = x.to(torch.float32)
        if groups:
            mean, ex2, count = _global_moments(x32, dims, groups)
        else:
            mean, ex2, count = x32.mean(dims), torch.square(x32).mean(dims), \
                None
        bvar = torch.clamp_min(ex2 - torch.square(mean), 0.0)
        rstd = torch.rsqrt(bvar + eps)
        scale_eff = scale.to(torch.float32) * rstd
        bias_eff = bias.to(torch.float32) - mean * scale_eff
        out = (x * _per_channel(scale_eff.to(x.dtype), x)
               + _per_channel(bias_eff.to(x.dtype), x))
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.dtypes = (scale.dtype, bias.dtype)
        ctx.groups, ctx.count = groups, count
        ctx.mark_non_differentiable(mean, bvar)
        return out, mean, bvar

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        x, mean, rstd, scale = ctx.saved_tensors
        dy = g_out.to(x.dtype)
        dbeta, dgamma = bn_bwd_reduce(dy, x, mean, rstd)
        dx = None
        if ctx.needs_input_grad[0]:
            gb, gg = dbeta, dgamma
            if ctx.groups:
                # dx takes the global sums and count; the parameters keep
                # the rank's partials, which the Strategy's gradient
                # average over dp turns into the single device's
                from ..parallel import comm

                both = torch.stack([dbeta, dgamma])
                for g in ctx.groups:
                    both = comm.all_reduce(both, g)
                gb, gg = both[0], both[1]
            dx = bn_bwd_dx(dy, x, mean, rstd, scale, gb, gg,
                           int(ctx.count or 0))
        return (dx, dgamma.to(ctx.dtypes[0]), dbeta.to(ctx.dtypes[1]), None,
                None)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float, groups=()):
    """Batch normalisation of ``x`` [N, C, ...] over every dim but 1, with
    float32 statistics: returns (out in x's dtype, batch mean [C], batch
    variance [C]), the statistics float32 and without gradient.  The
    backward runs the CUDA kernels on CUDA tensors and their plain versions
    on CPU tensors; meta tensors give outputs of the right shapes.

    ``groups``: the process groups the batch is sharded over (a Strategy's
    data axes; ``x`` is this rank's equal share).  The statistics are then
    the global batch's, every rank's alike: the sums of x and x^2
    all-reduced.  In the backward the reduction kernel's per-rank dbeta
    and dgamma are all-reduced for the dx kernel, which takes the global
    count M, and returned unreduced as the parameters' gradients (the
    Strategy averages them over dp)."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"batch_norm_train runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    return _BatchNormTrain.apply(x, scale, bias, float(eps), tuple(groups))


batch_norm_train.launches = {"reduce": 0, "dx": 0}
