"""Paged KV pool and decode attention, composed forms (PyTorch port of
``paddle_tpu/ops/attention.py``'s paged section).

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

from typing import Optional

import torch

KV_QMAX = 127.0


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
