"""Fused paged decode attention straight off the paged KV arenas.

``paged_attention`` is the wrapper of the hand-written CUDA kernel
``csrc/paged_attention.cu`` (the port of the Pallas TPU kernel
``paddle_tpu/ops/paged_attention.py::_decode_kernel``).  On CUDA tensors it
launches that kernel, or raises; on CPU tensors it runs the plain PyTorch
version ``paged_attention_reference`` (gather with ``paged_gather_kv``, then
``paged_decode_attention[_single]``).  There is no fallback from the kernel
to the plain version.

``paged_attention.launches`` counts the calls that launch the kernel (never
plain-version calls), so a run can show that its decode steps went through
the kernel.  It counts one per call, also when the call enqueues two device
launches (the split kernel and the combine of the splits), as the LSTM
counters count one per call of T launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, _cost
from .attention import (paged_decode_attention, paged_decode_attention_single,
                        paged_gather_kv, pool_arena)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# constants of csrc/paged_attention.cu (kMaxW, the head dims it dispatches
# with kMaxDh the largest, kWarps, kPartExtra, kMaxSplits, kColChunk): they
# change together, and tests/test_torch_ops.py pins them
MAX_WINDOW = 8
HEAD_DIMS = (16, 32, 64, 128)
SPLIT_WARPS = 4
_PART_EXTRA = 2              # m and l after each row's Dh partial sums
MAX_SPLITS = 64
COL_CHUNK = 32               # table columns a split block stages at once
# how the wrapper splits T: about BLOCKS_PER_SM split blocks for each SM
BLOCKS_PER_SM = 4

_sm_counts: dict = {}

_build.declare("paged_attention.cu", "paged_attention_launch", ctypes.c_int,
               [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
               + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


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


def check_kernel_shape(W: int, Dh: int) -> None:
    """Raise on a window width or head dim the kernel does not take: the
    wrapper calls this at every launch, and ``ContinuousDecodeEngine``
    when it is made on a card, before it allocates its pool."""
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"paged_attention kernel takes windows of 1.."
                         f"{MAX_WINDOW} rows, got W={W}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got Dh={Dh}")


def _kernel_geometry(S: int, W: int, H: int, n_tbl: int, Dh: int,
                     n_sm: int):
    """(columns per split, splits) for one launch on a card of ``n_sm``
    SMs: enough splits that splits x heads x slots gives about
    BLOCKS_PER_SM blocks an SM, and at most MAX_SPLITS of them (long
    tables take longer splits).  Raises on a shape the kernel does not
    take."""
    check_kernel_shape(W, Dh)
    want = -(-BLOCKS_PER_SM * n_sm // (S * H))
    cols = max(-(-n_tbl // want), -(-n_tbl // MAX_SPLITS))
    return cols, -(-n_tbl // cols)


def _sm_count(dev: torch.device) -> int:
    n = _sm_counts.get(dev.index)
    if n is None:
        n = _sm_counts[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


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
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("paged_attention needs 16-byte aligned arenas")
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
    cols, n_splits = _kernel_geometry(S, W, H, n_tbl, Dh, _sm_count(dev))

    if not q.is_contiguous():
        q = q.contiguous()
    if tables.dtype != torch.int32 or not tables.is_contiguous():
        tables = tables.to(torch.int32).contiguous()
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty((S, W, H, Dh), dtype=out_dtype, device=dev)
    part = (torch.empty(S * H * n_splits * W * (Dh + _PART_EXTRA),
                        dtype=torch.float32, device=dev)
            if n_splits > 1 else None)
    fn = _build.load_kernel_library("paged_attention.cu").paged_attention_launch
    args = (q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
            k_pool[1].data_ptr() if quantized else None,
            v_pool[1].data_ptr() if quantized else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            S, W, H, Dh, Bs, n_tbl, NB, L, layer, scale,
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_arena.dtype],
            _DTYPE_CODE[out_dtype], cols, n_splits,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    if _cost._active:
        _cost.add(*_cost.paged_work(q, lengths, tables, H, Dh, Bs,
                                    k_arena.element_size(), quantized))
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
