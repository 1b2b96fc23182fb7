"""3x3 SAME convolution as an implicit GEMM, plain and with a folded batch
norm and a ReLU, with hand-written CUDA kernels.

``igemm_conv(x_nhwc, w_hwio)`` and ``igemm_conv_fused(x_nhwc, w_hwio, a,
b)`` keep the layout and signatures of ``benchmark/conv_probe.py``'s
``igemm_conv`` / ``igemm_conv_fused``: x is an un-padded ``[N, H, W, C]``
tensor, the padding is SAME (one zero row and column on each side), w is
``[3, 3, C, O]``, and the output is ``[N, H, W, O]`` in x's dtype.  The
fused form returns ``max(conv * a + b, 0)`` with ``a`` and ``b`` ``[O]``
vectors of any float dtype, used in float32.

* On CUDA tensors they launch the kernels of ``csrc/conv.cu`` (the ports
  of the probe's Pallas ``_igemm_kernel`` and ``_igemm_fused_kernel``), or
  raise: there is no fallback.  float32 and bfloat16, any N, H, W, C, O.
* On CPU tensors they run the plain versions,
  :func:`igemm_conv_reference` and :func:`igemm_conv_fused_reference`,
  which transcribe the probe's ``_igemm_accumulate`` and epilogue: nine
  shifted ``[N, H, W, C] @ [C, O]`` products of the zero-padded x summed in
  float32 from operands in the input dtype, then (fused) ``acc * a + b``
  and ``max(., 0)`` in float32, and one rounding to x's dtype.

``launches`` counts kernel calls, one per call of each wrapper:
``{"igemm": n, "fused": n}``.  Plain-version calls never count.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"igemm": 0, "fused": 0}

_build.declare("conv.cu", "igemm_conv_launch", ctypes.c_int,
               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
               + [ctypes.c_void_p])


# ------------------------------------------------------------ plain versions


def _accumulate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``[N, H, W, O]``: the nine shifted products of the
    zero-padded x with ``w[dy, dx]``, each product's operands in the input
    dtype and its sum in float32 (a bfloat16 product is exact in
    float32)."""
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += (xp[:, dy:dy + h, dx:dx + wd, :].to(torch.float32)
                    @ w[dy, dx].to(torch.float32))
    return acc


def igemm_conv_reference(x_nhwc: torch.Tensor,
                         w_hwio: torch.Tensor) -> torch.Tensor:
    """Plain version of the conv kernel: ``[N, H, W, O]`` in x's dtype."""
    return _accumulate(x_nhwc, w_hwio).to(x_nhwc.dtype)


def igemm_conv_fused_reference(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                               a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel: ``max(conv * a + b, 0)`` in
    float32, rounded once to x's dtype."""
    y = _accumulate(x_nhwc, w_hwio) * a.to(torch.float32) \
        + b.to(torch.float32)
    return torch.clamp_min(y, 0.0).to(x_nhwc.dtype)


# ------------------------------------------------------------------ kernels


def _check(x: torch.Tensor, w: torch.Tensor):
    """(N, H, W, C, O) of a launch; raises on what the kernels do not
    take."""
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"the conv kernels take float32 or bfloat16 x and w "
                         f"of one dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"the conv kernels take x [N, H, W, C] and w [3, 3, "
                         f"C, O], got {tuple(x.shape)}, {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the conv kernels take contiguous NHWC x and HWIO w")
    n, h, wd, c = (int(s) for s in x.shape)
    o = int(w.shape[3])
    if min(n, h, wd, c, o) < 1:
        raise ValueError(f"empty conv operands {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if n * h * wd >= 2 ** 31:
        raise ValueError(f"too many output pixels for the conv kernels: "
                         f"{n * h * wd}")
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernels run on CUDA tensors, not "
                         f"{x.device.type}")
    if w.device != x.device:
        raise ValueError(f"x and w must lie on one device: {x.device}, "
                         f"{w.device}")
    return n, h, wd, c, o


def _launch(x, w, a, b, fused: bool) -> torch.Tensor:
    n, h, wd, c, o = _check(x, w)
    out = torch.empty((n, h, wd, o), dtype=x.dtype, device=x.device)
    per = 16 // x.element_size()
    vec = int(c % per == 0 and o % per == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, w, out)))
    lib = _build.load_kernel_library("conv.cu")
    args = (x.data_ptr(), w.data_ptr(),
            a.data_ptr() if fused else None, b.data_ptr() if fused else None,
            out.data_ptr(), n, h, wd, c, o, _DTYPE_CODE[x.dtype], int(fused),
            vec)
    with torch.cuda.device(x.device):
        rc = lib.igemm_conv_launch(
            *args, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"igemm_conv_launch failed: CUDA error {rc}")
    return out


def _epilogue_vector(v: torch.Tensor, o: int, dev) -> torch.Tensor:
    if v.numel() != o:
        raise ValueError(f"a and b must have {o} values, got "
                         f"{tuple(v.shape)}")
    return v.reshape(o).to(device=dev, dtype=torch.float32).contiguous()


def igemm_conv_kernel(x_nhwc: torch.Tensor,
                      w_hwio: torch.Tensor) -> torch.Tensor:
    """One launch of the conv kernel."""
    out = _launch(x_nhwc, w_hwio, None, None, fused=False)
    launches["igemm"] += 1
    return out


def igemm_conv_fused_kernel(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the fused kernel."""
    o = int(w_hwio.shape[-1])
    a = _epilogue_vector(a, o, x_nhwc.device)
    b = _epilogue_vector(b, o, x_nhwc.device)
    out = _launch(x_nhwc, w_hwio, a, b, fused=True)
    launches["fused"] += 1
    return out


# ------------------------------------------------------------------ public


def igemm_conv(x_nhwc: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, ``[N, H, W, C] x [3, 3, C, O] -> [N, H, W, O]``: the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if x_nhwc.device.type == "cpu":
        return igemm_conv_reference(x_nhwc, w_hwio)
    return igemm_conv_kernel(x_nhwc, w_hwio)


def igemm_conv_fused(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max(conv * a + b, 0)``: the kernel on CUDA tensors, the plain
    version on CPU ones."""
    if x_nhwc.device.type == "cpu":
        return igemm_conv_fused_reference(x_nhwc, w_hwio, a, b)
    return igemm_conv_fused_kernel(x_nhwc, w_hwio, a, b)
