"""Attention (PyTorch port of ``paddle_tpu/ops/attention.py``): the dense KV
caches of the dense decode path, the paged KV pool and its composed
decode-attention forms, and flash attention with its
hand-written CUDA kernels (``csrc/flash_attention.cu``).

K/V live in a preallocated arena of fixed-size blocks,
``[n_blocks + 1, L, H, block_size, Dh]`` (head-major, as in the JAX package),
and each decode slot owns a table of block indices.  Block ``n_blocks`` is
the TRASH block: unallocated table entries hold its index, so writes for
inactive slots and positions past a slot's budget land there and can never
corrupt a live slot.

A quantized arena is the ``(int8 payload, float32 scales)`` pair with scales
``[n_blocks + 1, L, H, block_size]``: symmetric absmax int8 per position and
head, quantized at scatter and dequantized at gather.

Unlike JAX, these functions write the arenas IN PLACE (``index_put_``); they
still return the pool so call sites read as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, _cost

KV_QMAX = 127.0


# ------------------------------------------------------- dense KV caches
#
# Static-size caches for the dense decode forms (``serving.DecodeEngine``,
# ``models.transformer.generate``): one [B, L, H, T_max, Dh] slab per batch,
# allocated once; every step writes one position and attends to a masked
# prefix.  Plain PyTorch, as the JAX package computes them outside any
# Pallas kernel.


def init_kv_cache(batch: int, n_layers: int, n_heads: int, max_len: int,
                  head_dim: int, dtype=torch.float32, device=None):
    """Head-major [B, L, H, T_max, Dh] K and V caches."""
    shape = (batch, n_layers, n_heads, max_len, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def cache_set(cache: torch.Tensor, layer: int, pos, new: torch.Tensor):
    """Write one position's per-head projection ``new`` [B, H, Dh] into
    slot ``pos`` of ``cache`` [B, L, H, T, Dh], in place.  ``pos`` is a
    Python int or a one-element integer tensor on the cache's device (a
    staged input: no host value enters the write)."""
    lay = cache.select(1, layer)
    if isinstance(pos, torch.Tensor):
        lay.index_copy_(2, pos.reshape(1).long(),
                        new.to(cache.dtype)[:, :, None])
    else:
        lay[:, :, int(pos)] = new.to(cache.dtype)
    return cache


def cache_set_prefix(cache: torch.Tensor, layer: int, new: torch.Tensor):
    """Write a prefill's whole prefix ``new`` [B, H, T_prefix, Dh] into
    slots [0, T_prefix) of layer ``layer``, in place."""
    cache.select(1, layer)[:, :, :new.shape[2]] = new.to(cache.dtype)
    return cache


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length, *,
                     scale: Optional[float] = None,
                     out_dtype=None) -> torch.Tensor:
    """One query position against a static-size cache: q [B, H, Dh],
    k_cache/v_cache [B, H, T_max, Dh]; attends to slots < ``length`` (a
    Python int or an integer tensor).  Float32 scores and softmax, the
    probabilities cast to ``out_dtype`` before the value product (float32
    accumulation).  Returns [B, H, Dh]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("mhd,mhtd->mht", q.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    t = torch.arange(k_cache.shape[2], device=k_cache.device)
    if isinstance(length, torch.Tensor):
        length = length.reshape(-1)[:1].to(k_cache.device)
    valid = (t < length)[None, None, :]
    return _masked_softmax_attend(s, v_cache, valid, out_dtype, q.dtype,
                                  "mht,mhtd->mhd")


# ------------------------------------------------------------ paged KV pool


def init_kv_pool(n_blocks: int, n_layers: int, n_heads: int, block_size: int,
                 head_dim: int, dtype=torch.float32, device=None):
    """Paged K and V arenas [n_blocks + 1, L, H, block_size, Dh]; the final
    block (index ``n_blocks``) is the trash block for redirected writes."""
    shape = (n_blocks + 1, n_layers, n_heads, block_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_pool_quant(n_blocks: int, n_layers: int, n_heads: int,
                       block_size: int, head_dim: int, device=None):
    """int8 K and V arenas with their scale planes:
    ``((k_int8, k_scales), (v_int8, v_scales))``.  Zero arenas dequantize to
    exact zeros, so trash reads stay finite as in the float pool."""
    shape = (n_blocks + 1, n_layers, n_heads, block_size, head_dim)
    sshape = (n_blocks + 1, n_layers, n_heads, block_size)

    def side():
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device))

    return side(), side()


def pool_arena(pool):
    """The payload array of a paged arena: the arena itself for float pools,
    the int8 payload for quantized ``(payload, scales)`` pairs."""
    return pool[0] if isinstance(pool, tuple) else pool


def quantize_kv(new: torch.Tensor):
    """Symmetric per-position-per-head int8: ``new`` [..., H, Dh] ->
    (int8 [..., H, Dh], scales [..., H] float32).  An all-zero vector
    quantizes to zeros with a tiny non-zero scale."""
    x = new.to(torch.float32)
    absmax = x.abs().amax(dim=-1)
    scale = torch.clamp_min(absmax, 1e-30) / KV_QMAX
    q = torch.clamp(torch.round(x / scale[..., None]), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: ``q`` int8 [..., Dh] with ``scale``
    broadcast over the trailing dim."""
    return (q.to(torch.float32) * scale[..., None]).to(out_dtype)


def paged_cache_set(pool, layer: int, block_idx: torch.Tensor,
                    offset: torch.Tensor, new: torch.Tensor):
    """Scatter one position per slot: ``block_idx``/``offset`` [S],
    ``new`` [S, H, Dh].  The window form covers this shape."""
    return paged_cache_set_window(pool, layer, block_idx, offset, new)


def paged_cache_set_window(pool, layer: int, block_idx: torch.Tensor,
                           offset: torch.Tensor, new: torch.Tensor):
    """Scatter a window of positions per slot, in place: ``block_idx`` /
    ``offset`` [..., W] integer tensors, ``new`` [..., W, H, Dh].

    JAX writes ``pool.at[block_idx, layer, :, offset]``: the slice between
    the array indices puts the indexed dims first, so the update is
    [..., W, H, Dh].  Here the layer is selected and the (H, Bs) dims are
    swapped on a view, which leaves exactly the two indexed dims in front.
    Several trash-bound rows may write the trash block at once; which one
    lands is unspecified and harmless."""
    idx = (block_idx.long(), offset.long())
    if isinstance(pool, tuple):
        arena, scales = pool
        q, s = quantize_kv(new)
        arena.select(1, layer).transpose(1, 2).index_put_(idx, q)
        scales.select(1, layer).transpose(1, 2).index_put_(idx, s)
        return pool
    pool.select(1, layer).transpose(1, 2).index_put_(idx, new.to(pool.dtype))
    return pool


def paged_cache_put_window(pool, layer: int, block_idx: torch.Tensor,
                           offset: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor):
    """:func:`paged_cache_set_window` of rows already quantized: ``q`` int8
    [..., W, H, Dh] and ``scale`` float32 [..., W, H] into an int8
    ``(payload, scales)`` pool, as :func:`quantize_kv` gave them."""
    idx = (block_idx.long(), offset.long())
    arena, scales = pool
    arena.select(1, layer).transpose(1, 2).index_put_(idx, q)
    scales.select(1, layer).transpose(1, 2).index_put_(idx, scale)
    return pool


def paged_gather_kv(pool, layer: int, tables: torch.Tensor) -> torch.Tensor:
    """Gather each slot's blocks into a contiguous view: ``tables``
    [S, n_tbl] -> [S, H, n_tbl * block_size, Dh].  Trash entries gather
    finite garbage that the length mask removes.  A quantized pool
    dequantizes here (payload * per-position scale, float32)."""
    tables = tables.long()
    if isinstance(pool, tuple):
        arena, scales = pool
        g = dequantize_kv(arena.select(1, layer)[tables],   # [S,n,H,Bs,Dh]
                          scales.select(1, layer)[tables])
    else:
        g = pool.select(1, layer)[tables]                   # [S,n,H,Bs,Dh]
    s, n_tbl, h, bs, dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(s, h, n_tbl * bs, dh)


def _masked_softmax_attend(scores, v, valid, out_dtype, q_dtype, eq_v):
    s = torch.where(valid, scores, torch.full_like(scores, -1e9))
    a = torch.softmax(s, dim=-1)
    if out_dtype is not None:
        a = a.to(out_dtype)
    # f32 accumulation of the promoted operands, as preferred_element_type
    o = torch.einsum(eq_v, a.to(torch.float32), v.to(torch.float32))
    return o.to(out_dtype if out_dtype is not None else q_dtype)


def paged_decode_attention_single(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, lengths: torch.Tensor, *,
                                  scale: Optional[float] = None,
                                  out_dtype=None) -> torch.Tensor:
    """One query per slot against gathered K/V with per-slot lengths:
    q [S, H, Dh], k/v [S, H, T, Dh], lengths [S] -> [S, H, Dh].  Float32
    scores and softmax; probabilities cast to ``out_dtype`` before the value
    product; masked scores take the finite fill -1e9."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("mhd,mhtd->mht", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    t = torch.arange(k.shape[2], device=k.device)
    valid = t[None, None, :] < lengths.to(k.device)[:, None, None]
    return _masked_softmax_attend(s, v, valid, out_dtype, q.dtype,
                                  "mht,mhtd->mhd")


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None,
                           out_dtype=None) -> torch.Tensor:
    """Windowed decode attention over gathered K/V: q [S, W, H, Dh], k/v
    [S, H, T, Dh], lengths [S, W] (window row j of slot s attends to
    positions < lengths[s, j]) -> [S, W, H, Dh].  Same numerics policy as
    :func:`paged_decode_attention_single`."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("swhd,shtd->swht", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    t = torch.arange(k.shape[2], device=k.device)
    valid = t[None, None, None, :] < lengths.to(k.device)[:, :, None, None]
    return _masked_softmax_attend(s, v, valid, out_dtype, q.dtype,
                                  "swht,shtd->swhd")


# ------------------------------------------------------------ flash attention
#
# ``flash_attention`` is a ``torch.autograd.Function``.  On CPU tensors its
# forward is ``_fwd_reference`` and its backward ``_bwd_blockwise`` (the JAX
# package's paths off the TPU).  On CUDA tensors it launches the hand-written
# kernels of ``csrc/flash_attention.cu`` (forward; dK/dV and dQ backward
# passes) or raises: there is no fallback to the plain versions.  On meta
# tensors it only gives the output's shape and dtype, so a program can be
# built without the card.  ``flash_attention.launches`` counts kernel
# launches per kernel, and ``flash_attention.dtype_launches`` the same
# launches by the operands' dtype ("float32", "bfloat16"); plain-version
# calls never count.

NEG_INF = -1e30
FLASH_HEAD_DIMS = (16, 32, 64, 128)   # the head dims the CUDA kernels take
_FLASH_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, causal: bool):
    """Plain version of the forward kernel: q [N, Tq, D], k/v [N, Tk, D] ->
    (o [N, Tq, D] in q's dtype, lse [N, Tq] float32).  Products accumulate
    in float32 (bfloat16 operands are exact there); causal masking is
    top-left with the finite fill -1e30; bfloat16 probabilities are rounded
    to v's dtype before the value product."""
    s = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pn = p / l
    if q.dtype != torch.float32:
        pn = pn.to(v.dtype).float()
    o = torch.einsum("nqk,nkd->nqd", pn, v.float())
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _bwd_tiles(q, k, v, g, lse, delta, scale: float, causal: bool,
               block_k: int):
    """The recompute the backward kernels share, one K/V block of
    ``block_k`` columns at a time: yields (k block, p, dS) in float32, p
    and dS [N, Tq, block_k] tiles rounded through q's dtype when that is
    bfloat16 (as in the kernels)."""
    f32_in = q.dtype == torch.float32
    kv_len = k.shape[1]
    block_k = min(block_k, kv_len)
    qf, gf = q.float(), g.float()
    qpos = torch.arange(q.shape[1], device=q.device)
    for k0 in range(0, kv_len, block_k):
        ks = k[:, k0:k0 + block_k].float()
        vs = v[:, k0:k0 + block_k].float()
        s = torch.einsum("nqd,nkd->nqk", qf, ks) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            kpos = k0 + torch.arange(ks.shape[1], device=q.device)
            p = p.masked_fill(qpos[:, None] < kpos[None, :], 0.0)
        dp = torch.einsum("nqd,nkd->nqk", gf, vs)
        ds = p * (dp - delta[..., None]) * scale
        if not f32_in:
            p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
        yield ks, p, ds


def _bwd_dkdv_blockwise(q, k, v, g, lse, delta, scale: float, causal: bool,
                        block_k: int):
    """Plain version of the dK/dV kernel: (dk, dv) in k's and v's dtypes,
    dv = p^T . g and dk = dS^T . q per K/V block."""
    qf, gf = q.float(), g.float()
    dks, dvs = [], []
    for _, p, ds in _bwd_tiles(q, k, v, g, lse, delta, scale, causal,
                               block_k):
        dvs.append(torch.einsum("nqk,nqd->nkd", p, gf))
        dks.append(torch.einsum("nqk,nqd->nkd", ds, qf))
    return torch.cat(dks, dim=1).to(k.dtype), torch.cat(dvs, dim=1).to(v.dtype)


def _bwd_dq_blockwise(q, k, v, g, lse, delta, scale: float, causal: bool,
                      block_k: int):
    """Plain version of the dQ kernel: dq = sum over K/V blocks of dS . k,
    in q's dtype."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for ks, _, ds in _bwd_tiles(q, k, v, g, lse, delta, scale, causal,
                                block_k):
        dq = dq + torch.einsum("nqk,nkd->nqd", ds, ks)
    return dq.to(q.dtype)


def _bwd_blockwise(q, k, v, o, lse, g, scale: float, causal: bool,
                   block_k: int):
    """Plain version of the two backward kernels: delta = rowsum(o * g) in
    float32, then the dK/dV and dQ passes over K/V blocks of ``block_k``
    columns.  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    delta = (o.float() * g.float()).sum(dim=-1)
    dk, dv = _bwd_dkdv_blockwise(q, k, v, g, lse, delta, scale, causal,
                                 block_k)
    dq = _bwd_dq_blockwise(q, k, v, g, lse, delta, scale, causal, block_k)
    return dq, dk, dv


def check_flash_head_dim(D: int) -> None:
    """Raise on a head dim the CUDA kernels do not take: the wrappers call
    this at every launch, and ``Executor.run`` before a program's first
    step on a card."""
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims "
                         f"{FLASH_HEAD_DIMS}, got D={D}")


def check_flash_dtype(dtype: torch.dtype) -> None:
    """Raise on a dtype the CUDA kernels do not take: the wrappers call this
    at every launch, and ``Executor.run`` before a program's first step on
    a card."""
    if dtype not in _FLASH_DTYPE_CODE:
        raise ValueError(f"the flash kernels take float32 or bfloat16, got "
                         f"{dtype}")


def _check_flash_operands(q, k, v, *rest) -> None:
    """Raise on anything the CUDA kernels do not take: q/k/v (and g) on one
    CUDA device, contiguous, float32 or bfloat16 alike, q [N, Tq, D] and
    k/v [N, Tk, D] with D in FLASH_HEAD_DIMS."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors, not "
                         f"{q.device.type}")
    for t in (k, v) + rest:
        if t.device != q.device:
            raise ValueError(f"flash operands must all lie on {q.device}, "
                             f"found one on {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash operands must share one dtype, got "
                             f"{q.dtype} and {t.dtype}")
    check_flash_dtype(q.dtype)
    for t in (q, k, v) + rest:
        if not t.is_contiguous():
            raise ValueError("the flash kernels need contiguous operands")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash kernels need q [N, Tq, D] and k/v "
                         f"[N, Tk, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    check_flash_head_dim(q.shape[2])
    if min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError("flash operands must not be empty")
    for t in rest:
        if t.shape != q.shape:
            raise ValueError(f"g must have q's shape {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")


def _check_stats(q, *stats) -> None:
    for t in stats:
        if (t.dtype != torch.float32 or t.device != q.device
                or tuple(t.shape) != tuple(q.shape[:2])
                or not t.is_contiguous()):
            raise ValueError(f"lse and delta must be contiguous float32 "
                             f"[N, Tq] = {tuple(q.shape[:2])} on {q.device}")


# each entry point: its pointers, then N, Tq, Tk, D, scale, causal, dtype,
# stream
_FLASH_TAIL = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
_build.declare("flash_attention.cu", "flash_fwd_launch", ctypes.c_int,
               [ctypes.c_void_p] * 5 + _FLASH_TAIL)
_build.declare("flash_attention.cu", "flash_bwd_dkdv_launch", ctypes.c_int,
               [ctypes.c_void_p] * 8 + _FLASH_TAIL)
_build.declare("flash_attention.cu", "flash_bwd_dq_launch", ctypes.c_int,
               [ctypes.c_void_p] * 7 + _FLASH_TAIL)


def _flash_entry(name: str):
    return getattr(_build.load_kernel_library("flash_attention.cu"), name)


def _count(kernel: str, dtype: torch.dtype) -> None:
    flash_attention.launches[kernel] += 1
    flash_attention.dtype_launches[str(dtype).replace("torch.", "")][
        kernel] += 1


def _launch(fn, ptrs, q, k, scale, causal, kernel: str) -> None:
    N, Tq, D = q.shape
    if _cost._active:
        _cost.add(*_cost.flash_work(kernel, N, Tq, k.shape[1], D,
                                    bool(causal), q.element_size()))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, N, Tq, k.shape[1], D, float(scale), int(bool(causal)),
                _FLASH_DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def flash_fwd_kernel(q, k, v, scale: float, causal: bool):
    """One launch of the forward kernel: (o in q's dtype, lse float32
    [N, Tq])."""
    _check_flash_operands(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(_flash_entry("flash_fwd_launch"),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr()), q, k, scale, causal, "fwd")
    _count("fwd", q.dtype)
    return o, lse


def flash_bwd_dkdv_kernel(q, k, v, g, lse, delta, scale: float,
                          causal: bool):
    """One launch of the dK/dV kernel: (dk, dv).  ``g`` in q's dtype,
    ``lse`` and ``delta`` float32 [N, Tq]."""
    _check_flash_operands(q, k, v, g)
    _check_stats(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_flash_entry("flash_bwd_dkdv_launch"),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, k, scale, causal, "bwd_dkdv")
    _count("bwd_dkdv", q.dtype)
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale: float, causal: bool):
    """One launch of the dQ kernel: dq in q's dtype."""
    _check_flash_operands(q, k, v, g)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q)
    _launch(_flash_entry("flash_bwd_dq_launch"),
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k, scale, causal, "bwd_dq")
    _count("bwd_dq", q.dtype)
    return dq


def flash_bwd_kernels(q, k, v, o, lse, g, scale: float, causal: bool):
    """The backward on the card: delta = rowsum(o * g) in float32 and g cast
    to q's dtype (as the JAX package does outside its kernels), then the
    dK/dV and dQ kernels.  Returns (dq, dk, dv)."""
    delta = (o.float() * g.float()).sum(dim=-1).contiguous()
    g = g.to(q.dtype).contiguous()
    dk, dv = flash_bwd_dkdv_kernel(q, k, v, g, lse, delta, scale, causal)
    dq = flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, causal)
    return dq, dk, dv


# The forward as the custom op ``torch.ops.paddle_tpu_torch.flash_fwd``
# (q, k, v, scale, causal) -> (o, lse): its CPU implementation is the plain
# version, its CUDA one the kernel, chosen by the tensors' device; a fake
# implementation gives the shapes (symbolic ones too).  ``_Flash`` and the
# no-gradient path call it, so an eager step, a captured one and
# ``torch.export`` of an inference program (``io.save_inference_model``,
# whose graph then holds this op as one node) launch the same kernel.


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float, causal: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    o, lse = _fwd_reference(q, k, v, scale, causal)
    return o.contiguous(), lse.contiguous()


@flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, scale, causal):
    # an exported graph hands the op views: at batch 1 the heads' reshape
    # of a transposed tensor stays a strided view
    return flash_fwd_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                            scale, causal)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, scale, causal):
    # contiguous, as both implementations return them: a trace decides
    # its views by these strides
    return (q.new_empty(q.shape),
            q.new_empty(q.shape[:2], dtype=torch.float32))


# The backward as the custom op ``torch.ops.paddle_tpu_torch.flash_bwd``
# (q, k, v, o, lse, g, scale, causal, block_k) -> (dq, dk, dv): on CUDA
# tensors the dK/dV and dQ kernels (``flash_bwd_kernels``; ``block_k`` sizes
# only the plain version's K blocks), on CPU ones ``_bwd_blockwise``.  So a
# trace of a training step (``compile/aot.py``) holds the backward as one
# node, as it holds the forward.


@torch.library.custom_op("paddle_tpu_torch::flash_bwd", mutates_args=(),
                         device_types="cpu")
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                 scale: float, causal: bool, block_k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(t.contiguous() for t in _bwd_blockwise(
        q, k, v, o, lse, g, scale, causal, block_k))


@flash_bwd_op.register_kernel("cuda")
def _flash_bwd_cuda(q, k, v, o, lse, g, scale, causal, block_k):
    return flash_bwd_kernels(q.contiguous(), k.contiguous(), v.contiguous(),
                             o, lse.contiguous(), g, scale, causal)


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, o, lse, g, scale, causal, block_k):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


class _Flash(torch.autograd.Function):
    """Flash attention over [N, T, D] with its hand-written gradient; saves
    (q, k, v, o, lse) for the backward.  Both directions are custom ops."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_k):
        o, lse = flash_fwd_op(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.block_k = scale, causal, block_k
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_op(q, k, v, o, lse, g, ctx.scale, ctx.causal,
                                  ctx.block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_k: int = 128) -> torch.Tensor:
    """Attention over [batch, heads, T, head_dim] (or [N, T, D]) operands,
    differentiable.  CUDA tensors run the kernels (which pick their own
    tiles) or raise; CPU tensors run the plain versions, where
    ``block_k`` is the backward's K block (the JAX signature's ``block_q``
    only sized the TPU kernel's grid and has no counterpart here); meta
    tensors give an empty output of the right shape and dtype and launch
    nothing.  Without a gradient to take, the forward is one call of the
    custom op ``paddle_tpu_torch::flash_fwd``."""
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device.type}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    squeeze = q.dim() == 4
    if squeeze:
        b, h, tq, d = q.shape
        tk = k.shape[2]
        # contiguous: at b = 1 a reshape of transposed heads is a view
        q = q.reshape(b * h, tq, d).contiguous()
        k = k.reshape(b * h, tk, d).contiguous()
        v = v.reshape(b * h, tk, d).contiguous()
    if q.device.type == "meta":
        out = torch.empty(q.shape, dtype=q.dtype, device="meta")
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out = _Flash.apply(q, k, v, float(scale), bool(causal), int(block_k))
    else:
        out = flash_fwd_op(q, k, v, float(scale), bool(causal))[0]
    if squeeze:
        out = out.reshape(b, h, tq, d)
    return out


flash_attention.launches = {"fwd": 0, "bwd_dkdv": 0, "bwd_dq": 0}
flash_attention.dtype_launches = {
    dt: {"fwd": 0, "bwd_dkdv": 0, "bwd_dq": 0}
    for dt in ("float32", "bfloat16")}
