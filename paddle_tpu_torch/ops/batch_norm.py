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

import torch

from . import _build

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
               + [ctypes.c_void_p])


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


def bn_bwd_dx_reference(dy, x, mean, rstd, gamma, dbeta, dgamma):
    """Plain version of the dx kernel: gamma * rstd * (dy - dbeta / M -
    xhat * dgamma / M) in float32, returned in dy's dtype."""
    m = dy.numel() // max(dy.shape[1], 1)
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
    return dbeta, dgamma


def bn_bwd_dx_kernel(dy, x, mean, rstd, gamma, dbeta, dgamma):
    """One call of the dx kernel: dx in dy's dtype and shape."""
    dy, x = dy.contiguous(), x.contiguous()
    dx = torch.empty_like(x)
    n, c, hw, splits, vec, code = _geometry(dy, x, (dy, x, dx))
    mean, rstd, gamma, dbeta, dgamma = _channel_vectors(
        c, x.device, mean, rstd, gamma, dbeta, dgamma)
    _call("bn_bwd_dx_launch",
          (dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           gamma.data_ptr(), dbeta.data_ptr(), dgamma.data_ptr(),
           dx.data_ptr(), n, c, hw, splits, vec, code), x.device)
    batch_norm_train.launches["dx"] += 1
    return dx


def bn_bwd_reduce(dy, x, mean, rstd):
    """(dbeta, dgamma): the kernel on CUDA tensors, the plain version on CPU
    ones."""
    if x.device.type == "cpu":
        return bn_bwd_reduce_reference(dy, x, mean, rstd)
    return bn_bwd_reduce_kernel(dy, x, mean, rstd)


def bn_bwd_dx(dy, x, mean, rstd, gamma, dbeta, dgamma):
    """dx: the kernel on CUDA tensors, the plain version on CPU ones."""
    if x.device.type == "cpu":
        return bn_bwd_dx_reference(dy, x, mean, rstd, gamma, dbeta, dgamma)
    return bn_bwd_dx_kernel(dy, x, mean, rstd, gamma, dbeta, dgamma)


# ------------------------------------------------------------------ public


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        # the JAX package's training forward, statistics in float32
        dims = _reduce_dims(x)
        x32 = x.to(torch.float32)
        mean = x32.mean(dims)
        bvar = torch.clamp_min(
            torch.square(x32).mean(dims) - torch.square(mean), 0.0)
        rstd = torch.rsqrt(bvar + eps)
        scale_eff = scale.to(torch.float32) * rstd
        bias_eff = bias.to(torch.float32) - mean * scale_eff
        out = (x * _per_channel(scale_eff.to(x.dtype), x)
               + _per_channel(bias_eff.to(x.dtype), x))
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.dtypes = (scale.dtype, bias.dtype)
        ctx.mark_non_differentiable(mean, bvar)
        return out, mean, bvar

    @staticmethod
    def backward(ctx, g_out, g_mean, g_var):
        x, mean, rstd, scale = ctx.saved_tensors
        dy = g_out.to(x.dtype)
        dbeta, dgamma = bn_bwd_reduce(dy, x, mean, rstd)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = bn_bwd_dx(dy, x, mean, rstd, scale, dbeta, dgamma)
        return (dx, dgamma.to(ctx.dtypes[0]), dbeta.to(ctx.dtypes[1]), None)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """Batch normalisation of ``x`` [N, C, ...] over every dim but 1, with
    float32 statistics: returns (out in x's dtype, batch mean [C], batch
    variance [C]), the statistics float32 and without gradient.  The
    backward runs the CUDA kernels on CUDA tensors and their plain versions
    on CPU tensors; meta tensors give outputs of the right shapes."""
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"batch_norm_train runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    return _BatchNormTrain.apply(x, scale, bias, float(eps))


batch_norm_train.launches = {"reduce": 0, "dx": 0}
