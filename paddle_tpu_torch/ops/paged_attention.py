"""Fused paged decode attention straight off the paged KV arenas.

``paged_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/paged_attention.cu`` (the port of the Pallas TPU kernel
``paddle_tpu/ops/paged_attention.py::_decode_kernel``).  On CUDA tensors it
launches that kernel, or raises; on CPU tensors it runs the plain PyTorch
version ``paged_attention_reference`` (gather with ``paged_gather_kv``, then
``paged_decode_attention[_single]``).  There is no fallback from the kernel
to the plain version.

``paged_attention.launches`` counts kernel launches (never plain-version
calls), so a run can show that its decode steps went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import (paged_decode_attention, paged_decode_attention_single,
                        paged_gather_kv, pool_arena)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# kMaxW and kRedSlots of csrc/paged_attention.cu: the shared-memory size
# below is computed from them, so they change together (a test pins both)
MAX_WINDOW = 8
_RED_SLOTS = 32
MAX_SHARED_BYTES = 232448    # what one Hopper block may use (227 KB)


def _normalise(q, lengths, scale):
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]                                  # [S, 1, H, Dh]
    if lengths.dim() == 1:
        lengths = lengths[:, None]                      # [S, 1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lengths = lengths.expand(q.shape[0], q.shape[1])
    return q, lengths, float(scale), squeeze


def paged_attention_reference(q: torch.Tensor, k_pool, v_pool, layer: int,
                              tables: torch.Tensor, lengths: torch.Tensor, *,
                              scale: Optional[float] = None,
                              out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: gather each slot's blocks,
    then the composed decode attention.  Same shapes and dtypes as
    :func:`paged_attention`."""
    kc = paged_gather_kv(k_pool, layer, tables)
    vc = paged_gather_kv(v_pool, layer, tables)
    if q.dim() == 3:
        lens = lengths if lengths.dim() == 1 else lengths[:, 0]
        return paged_decode_attention_single(q, kc, vc, lens, scale=scale,
                                             out_dtype=out_dtype)
    if lengths.dim() == 1:
        lengths = lengths[:, None].expand(q.shape[0], q.shape[1])
    return paged_decode_attention(q, kc, vc, lengths, scale=scale,
                                  out_dtype=out_dtype)


def _kernel_geometry(W: int, T: int, Dh: int):
    """(threads per block, dynamic shared bytes) for one launch; raises on a
    shape the kernel does not take."""
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"paged_attention kernel takes windows of 1.."
                         f"{MAX_WINDOW} rows, got W={W}")
    nthreads = 256
    if Dh > nthreads or nthreads % Dh:
        raise ValueError(f"paged_attention kernel needs a head dim dividing "
                         f"{nthreads}, got Dh={Dh}")
    groups = nthreads // Dh
    smem = 4 * (W * Dh + W * T + groups * W * Dh + _RED_SLOTS)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"paged_attention kernel needs {smem} bytes of shared memory "
            f"(W={W}, T={T}), over the {MAX_SHARED_BYTES} a block may use")
    return nthreads, smem


def _launch_kernel(q, k_pool, v_pool, layer, tables, lengths, scale,
                   out_dtype):
    quantized = isinstance(k_pool, tuple)
    if quantized != isinstance(v_pool, tuple):
        raise ValueError("k_pool and v_pool must both be quantized or not")
    k_arena, v_arena = pool_arena(k_pool), pool_arena(v_pool)
    dev = q.device
    operands = [k_arena, v_arena, tables, lengths]
    if quantized:
        operands += [k_pool[1], v_pool[1]]
    for t in operands:
        if t.device != dev:
            raise ValueError(f"paged_attention operands must all lie on "
                             f"{dev}, found one on {t.device}")
    S, W, H, Dh = q.shape
    if k_arena.dim() != 5 or k_arena.shape != v_arena.shape:
        raise ValueError("arenas must be [n_blocks+1, L, H, Bs, Dh] and "
                         "match each other")
    NB, L, Ha, Bs, Dha = k_arena.shape
    if (Ha, Dha) != (H, Dh):
        raise ValueError(f"arena heads/head_dim {(Ha, Dha)} != q's {(H, Dh)}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range for L={L}")
    if not (k_arena.is_contiguous() and v_arena.is_contiguous()):
        raise ValueError("paged_attention needs contiguous arenas")
    if quantized:
        if k_arena.dtype != torch.int8 or v_arena.dtype != torch.int8:
            raise ValueError("a quantized pool holds int8 payloads")
        for sc in (k_pool[1], v_pool[1]):
            if (sc.dtype != torch.float32 or sc.shape != (NB, L, H, Bs)
                    or not sc.is_contiguous()):
                raise ValueError("scale planes must be contiguous float32 "
                                 "[n_blocks+1, L, H, Bs]")
    elif k_arena.dtype not in (torch.float32, torch.bfloat16) \
            or v_arena.dtype != k_arena.dtype:
        raise ValueError(f"float arenas must be float32 or bfloat16, got "
                         f"{k_arena.dtype}/{v_arena.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    n_tbl = tables.shape[1]
    if tables.shape[0] != S:
        raise ValueError(f"tables has {tables.shape[0]} rows for {S} slots")
    nthreads, smem = _kernel_geometry(W, n_tbl * Bs, Dh)

    lib = _build.load_kernel_library("paged_attention.cu")
    fn = lib.paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])

    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((S, W, H, Dh), dtype=out_dtype, device=dev)
    ks = k_pool[1].data_ptr() if quantized else None
    vs = v_pool[1].data_ptr() if quantized else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), ks, vs,
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                S, W, H, Dh, Bs, n_tbl, NB, L, int(layer), scale,
                _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_arena.dtype],
                _DTYPE_CODE[out_dtype], nthreads, smem, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


def paged_attention(q: torch.Tensor, k_pool, v_pool, layer: int,
                    tables: torch.Tensor, lengths: torch.Tensor, *,
                    scale: Optional[float] = None,
                    out_dtype=None) -> torch.Tensor:
    """Decode attention straight off the paged arenas.

    ``q`` [S, H, Dh] (plain W=1 step) or [S, W, H, Dh] (speculative window);
    ``k_pool``/``v_pool`` arenas from ``init_kv_pool`` / ``init_kv_pool_quant``
    (a quantized pool is the ``(int8 payload, float32 scales)`` pair);
    ``tables`` [S, n_tbl] block tables (unallocated entries hold the trash
    index); ``lengths`` [S] or [S, W] per-row attention lengths.  Returns
    [S, H, Dh] or [S, W, H, Dh] in ``out_dtype`` (default ``q.dtype``).

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`paged_attention_reference`."""
    out_dtype = out_dtype if out_dtype is not None else q.dtype
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, layer, tables,
                                         lengths, scale=scale,
                                         out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu tensors, not "
                         f"{q.device.type}")
    q4, lens, scale_f, squeeze = _normalise(q, lengths, scale)
    out = _launch_kernel(q4, k_pool, v_pool, int(layer), tables, lens,
                         scale_f, out_dtype)
    return out[:, 0] if squeeze else out


paged_attention.launches = 0
