"""Ring attention: sequence parallelism over the mesh's ``sp`` axis
(PyTorch port of ``paddle_tpu/parallel/ring.py``).

Each rank holds one chunk of the sequence of q, k and v and streams the
K/V chunks around the ring (``comm.ring_shift``), merging one
online-softmax partial per chunk pair, so the full [T, T] scores never
exist and K/V never leave the ring.  Causal masking uses global
positions.

The port is SPMD over processes, so ``ring_attention`` takes the rank's
own chunk, [B, H, t, D], in the layout the mesh's step gives it
(``parallel/strategy.py``): contiguous block ``idx`` of T, or, with
``striped=True`` (the zigzag layout), the half-blocks ``idx`` and
``2n-1-idx`` of T / 2n, concatenated; positions are monotone within a
chunk either way, so the diagonal pair's local causal mask is the
positional one.  In-ring pairs are, contiguous and causal, fully live or
fully masked (skipped); striped and causal, exactly half live as one
mask-free shape (holder earlier in the ring: full q x the early k half;
later: the late q half x full k), so every rank's every step costs half a
block.

On the card each chunk pair's forward is one launch of the port's flash
forward kernel (PERF.md row 2), which returns a normalised partial
(lse, 1, o) for ``_merge``, as ``_flash_chunk`` does on the TPU; the
backward follows ``_ring_shard_bwd``: it re-rings K/V, dK/dV ride with
their block and are home after n shifts, and each live pair's gradients
are one launch each of the flash backward pair (rows 3-4) given the
merged lse and D = rowsum(dO * O), the same arithmetic as the reference's
``pair_grads``.  On the CPU the kernels' plain versions run.  ``n == 1``
takes the plain ``_block_attn`` path, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import attention as _attn
from . import comm

NEG_INF = -1e30


def _block_attn(q, k, v, bias, scale):
    """One (q_block, kv_block) partial: (m, l, o) stats; q [B, H, Tq, D]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhqk,bhkd->bhqd", p, v)


def _causal_bias(q, k):
    tq, tk = q.shape[2], k.shape[2]
    mask = torch.arange(tq, device=q.device)[:, None] >= torch.arange(
        tk, device=q.device)[None, :]
    return torch.where(mask, 0.0, torch.finfo(q.dtype).min)[None, None]


def _merge(m1, l1, o1, m2, l2, o2):
    """Merge two online-softmax partials (raw or normalised convention)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def _flat(x):
    b, h, t, d = x.shape
    return x.reshape(b * h, t, d).contiguous()


def _chunk(q, k, v, scale, causal):
    """One chunk pair through the flash forward kernel (its plain version
    on the CPU): the normalised partial (lse, 1, o float32) over
    [B, H, Tq]."""
    b, h, tq, d = q.shape
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    if q.device.type == "cuda":
        o, lse = _attn.flash_fwd_kernel(qf, kf, vf, scale, causal)
    else:
        o, lse = _attn._fwd_reference(qf, kf, vf, scale, causal)
    lse = lse.reshape(b, h, tq)
    return lse, torch.ones_like(lse), o.reshape(b, h, tq, d).float()


def _pair_grads(q, k, v, do, lse, delta, scale, causal):
    """(dq, dk, dv) float32 of one chunk pair given the merged lse and
    delta: the flash backward pair on the card, its plain version on the
    CPU."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    args = (_flat(q), _flat(k), _flat(v), _flat(do.to(q.dtype)),
            lse.reshape(b * h, tq).contiguous(),
            delta.reshape(b * h, tq).contiguous())
    if q.device.type == "cuda":
        dk, dv = _attn.flash_bwd_dkdv_kernel(*args, scale, causal)
        dq = _attn.flash_bwd_dq_kernel(*args, scale, causal)
    else:
        dk, dv = _attn._bwd_dkdv_blockwise(*args, scale, causal, 128)
        dq = _attn._bwd_dq_blockwise(*args, scale, causal, 128)
    return (dq.reshape(b, h, tq, d).float(), dk.reshape(b, h, tk, d).float(),
            dv.reshape(b, h, tk, d).float())


def _ring_forward(q, k, v, group, n, idx, causal, scale, striped):
    th = q.shape[2] // 2
    m, l, o = _chunk(q, k, v, scale, causal)
    kr, vr = k, v
    for i in range(n - 1):
        kr, vr = comm.ring_shift((kr, vr), group)
        e = (idx - i - 1) % n
        if striped and causal:
            if e < idx:
                m, l, o = _merge(m, l, o, *_chunk(q, kr[:, :, :th],
                                                  vr[:, :, :th], scale,
                                                  False))
            else:
                hm, hl, ho = _merge(m[..., th:], l[..., th:], o[:, :, th:],
                                    *_chunk(q[:, :, th:], kr, vr, scale,
                                            False))
                m = torch.cat([m[..., :th], hm], dim=-1)
                l = torch.cat([l[..., :th], hl], dim=-1)
                o = torch.cat([o[:, :, :th], ho], dim=2)
        elif not causal or e < idx:
            m, l, o = _merge(m, l, o, *_chunk(q, kr, vr, scale, False))
        # else: a fully masked pair (the holder is later in the sequence)
    return m, l, o


def _ring_backward(q, k, v, out, lse, do, group, n, idx, causal, scale,
                   striped):
    delta = (do.float() * out.float()).sum(dim=-1)
    dq, dk0, dv0 = _pair_grads(q, k, v, do, lse, delta, scale, causal)
    kr, vr, dkr, dvr = comm.ring_shift((k, v, dk0, dv0), group)
    th = q.shape[2] // 2
    for j in range(1, n):
        e = (idx - j) % n
        if striped and causal:
            if e < idx:
                g = _pair_grads(q, kr[:, :, :th].contiguous(),
                                vr[:, :, :th].contiguous(), do, lse, delta,
                                scale, False)
                dq = dq + g[0]
                pad = torch.zeros_like(g[1])
                dkr = dkr + torch.cat([g[1], pad], dim=2)
                dvr = dvr + torch.cat([g[2], pad], dim=2)
            else:
                g = _pair_grads(q[:, :, th:], kr, vr, do[:, :, th:],
                                lse[..., th:], delta[..., th:], scale, False)
                dq = dq + torch.cat([torch.zeros_like(g[0]), g[0]], dim=2)
                dkr, dvr = dkr + g[1], dvr + g[2]
        elif not causal or e < idx:
            g = _pair_grads(q, kr, vr, do, lse, delta, scale, False)
            dq, dkr, dvr = dq + g[0], dkr + g[1], dvr + g[2]
        kr, vr, dkr, dvr = comm.ring_shift((kr, vr, dkr, dvr), group)
    return dq.to(q.dtype), dkr.to(k.dtype), dvr.to(v.dtype)


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, n, idx, causal, scale, striped):
        m, l, o = _ring_forward(q, k, v, group, n, idx, causal, scale,
                                striped)
        out = (o / l[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.args = (group, n, idx, causal, scale, striped)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, do, *ctx.args)
        return (dq, dk, dv) + (None,) * 6


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None,
                   striped: bool = False) -> torch.Tensor:
    """Sequence-parallel attention over this rank's chunk of q/k/v,
    [batch, heads, t, head_dim] (contiguous, or striped: see the module
    docstring); returns the rank's chunk of the output.  Differentiable;
    every rank of the axis's group calls it together."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = mesh.shape.get(axis, 1)
    if n == 1:
        m, l, o = _block_attn(q, k, v, _causal_bias(q, k) if causal
                              else None, scale)
        return (o / l[..., None]).to(q.dtype)
    if striped and q.shape[2] % 2:
        raise ValueError(f"striped ring attention needs an even chunk "
                         f"length, got {q.shape[2]}")
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       mesh.group(axis), n, mesh.coord(axis), bool(causal),
                       float(scale), bool(striped))


def ring_launches(n: int, idx: int, causal: bool, striped: bool) -> int:
    """Flash kernel launches of one ring call on rank ``idx`` of ``n``: the
    forward's, and each of the two backward kernels' (live chunk pairs)."""
    if n == 1:
        return 0
    if not causal or striped:
        return n
    return idx + 1
