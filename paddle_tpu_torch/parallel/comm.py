"""The one module of the port that calls ``torch.distributed`` collectives,
as ``paddle_tpu/parallel/compat.py`` is the one place that calls
``shard_map`` in the JAX package.

JAX's parallel layer is GSPMD: it annotates layouts and XLA inserts the
collectives.  PyTorch has no such partitioner, so the port is SPMD over
processes, one rank per device, and every collective is explicit and
lives here:

* :func:`all_reduce` (sum, max, min), :func:`all_gather`,
  :func:`reduce_scatter`, :func:`all_to_all` and :func:`ring_shift` (the
  reference's ``lax.ppermute`` to the next rank of a ring, as
  ``batch_isend_irecv``), each over one process group (a mesh axis's
  slice, ``Mesh.group(axis)``);
* Megatron's two autograd functions, :func:`copy_to` (identity forward,
  all-reduce of the gradient) and :func:`reduce_from` (all-reduce
  forward, identity backward); :func:`mean_from` (the mean over groups
  forward, identity backward: a loss averaged over dp and sp, whose
  replicated parameters' gradients the Strategy averages), :func:`sum_from`
  (the sum over groups forward, the gradient times the ranks backward,
  which the Strategy's average divides back), :func:`extreme_from` (the
  max or min over groups, its gradient split among the global ties), the
  differentiable :func:`all_to_all` of Ulysses and :func:`shift` (the
  ring shift whose backward shifts the cotangent back, ``lax.ppermute``'s
  transpose, for GPipe); :func:`gather_shards`, the whole tensor from the
  ranks' shards, with which the Strategy carries an op that mixes batch
  rows (each rank runs it on the whole tensors).

A gradient convention ties these together: an activation sharded over
the data axes (dp, and sp for a sharded sequence) carries, on each rank,
n times its true cotangent, n the ranks it is sharded over, so that the
Strategy's average of the replicated parameters' gradients over those
ranks is the single device's gradient.  A replicated value (a global
loss) carries its true cotangent.  Each function that turns shards into
a replicated value scales its backward to keep this.

The backend is chosen once, when the process group is made
(``distributed.init``): NCCL where each rank owns its own card, the
production path; gloo for the CPU and for ranks that share one card
(NCCL refuses two ranks on one device).  Gloo runs every collective here
on CUDA tensors but send / recv, which it cannot take from device memory
(``writev: Bad address``): :func:`ring_shift` on a gloo group with CUDA
tensors (``GLOO_STAGED``) is staged through pinned host memory (copied
out, run on the host, copied back) and counted in ``staged``.  That is a
transport, not a fallback: every kernel still runs on the card.
Without an initialised process group every collective is the identity
(one rank).
"""
from __future__ import annotations

import collections
import time
from datetime import timedelta
from typing import List, Sequence

import torch
import torch.distributed as dist

# a process group's default timeout: a collective that one rank misses
# fails after this long instead of waiting forever
TIMEOUT_S = 120.0
# the default group's timeout (distributed.init sets it), which every
# subgroup of a mesh takes too (new_group)
group_timeout = timedelta(seconds=TIMEOUT_S)

# collective name -> calls made (all backends), and -> calls staged
# through pinned host memory (gloo with CUDA tensors)
calls: collections.Counter = collections.Counter()
staged: collections.Counter = collections.Counter()
# collective name -> host seconds inside it (a gloo call returns when its
# data has arrived; an NCCL call when it is enqueued)
seconds: collections.Counter = collections.Counter()
# the collectives staged through host memory on a gloo group with CUDA
# tensors: gloo's send / recv cannot take device memory (the others can)
GLOO_STAGED = frozenset({"ring_shift", "shift"})

# the names this torch has (newer releases deprecate the *_tensor names)
_gather_single = (getattr(dist, "all_gather_single", None)
                  or getattr(dist, "all_gather_into_tensor", None))
_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                   or getattr(dist, "reduce_scatter_tensor", None))


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def size(group) -> int:
    return dist.get_world_size(group) if active() else 1


def rank_in(group) -> int:
    return dist.get_rank(group) if active() else 0


def backend(group=None) -> str:
    return str(dist.get_backend(group)) if active() else "none"


def new_group(ranks: Sequence[int]):
    """A process group over ``ranks`` (global ranks) with the default
    group's timeout.  Collective: every rank of the default group calls it,
    in the same order, including the ranks not in ``ranks``."""
    return dist.new_group(list(ranks), timeout=group_timeout)


def reset_counts() -> None:
    calls.clear()
    staged.clear()
    seconds.clear()


# ------------------------------------------------------------ transport


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def _run(name: str, group, fn, inputs: Sequence[torch.Tensor],
         outputs: Sequence[torch.Tensor]) -> None:
    """``fn(inputs, outputs)`` runs the collective; one of ``GLOO_STAGED``
    on a gloo group with CUDA tensors runs on pinned host copies, the
    results copied back into ``outputs``."""
    calls[name] += 1
    t0 = time.perf_counter()
    dev = inputs[0].device
    if (name in GLOO_STAGED and dev.type == "cuda"
            and backend(group) == "gloo"):
        staged[name] += 1
        h_in = [_host(t) for t in inputs]
        h_out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in outputs]
        fn(h_in, h_out)
        for o, h in zip(outputs, h_out):
            o.copy_(h, non_blocking=False)
    else:
        fn(list(inputs), list(outputs))
    seconds[name] += time.perf_counter() - t0


# ------------------------------------------------------------ collectives


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or max, or min) of ``t`` over the group's ranks, as a new
    tensor."""
    if not active():
        return t.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    out = t.detach().clone().contiguous()

    def fn(ins, outs):
        if ins[0].data_ptr() != outs[0].data_ptr():
            outs[0].copy_(ins[0])
        dist.all_reduce(outs[0], op=red, group=group)

    _run("all_reduce", group, fn, [out], [out])
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order."""
    n = size(group)
    if not active():
        return t.clone()
    src = t.detach().reshape(-1).contiguous()
    flat = torch.empty(n * src.numel(), dtype=t.dtype, device=t.device)

    def fn(ins, outs):
        _gather_single(outs[0], ins[0], group=group)

    _run("all_gather", group, fn, [src], [flat])
    parts = list(flat.view((n,) + tuple(t.shape)).unbind(0))
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``t`` over the group
    (``t.shape[dim]`` divisible by the group's size)."""
    n = size(group)
    if not active():
        return t.clone()
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide by the group's {n} ranks")
    src = torch.stack(t.detach().chunk(n, dim=dim)).contiguous()
    out = torch.empty(src[0].numel(), dtype=t.dtype, device=t.device)

    def fn(ins, outs):
        _scatter_single(outs[0], ins[0], group=group)

    _run("reduce_scatter", group, fn, [src.reshape(-1)], [out])
    return out.view(src.shape[1:])


def _all_to_all(t: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = size(group)
    if not active():
        return t.clone()
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not divide by the group's {n} ranks")
    # chunk j of split_dim goes to rank j; rank j's chunk lands at slot j
    src = torch.stack(t.detach().chunk(n, dim=split_dim)).contiguous()
    out = torch.empty_like(src)

    def fn(ins, outs):
        dist.all_to_all_single(outs[0], ins[0], group=group)

    _run("all_to_all", group, fn, [src], [out])
    return torch.cat(list(out.unbind(0)), dim=concat_dim)


def ring_shift(tensors: Sequence[torch.Tensor], group, step: int = 1,
               name: str = "ring_shift") -> List[torch.Tensor]:
    """Each rank sends ``tensors`` to the next rank of the group's ring and
    returns those of the previous rank (``lax.ppermute`` with the
    permutation j -> j + 1 mod n); ``step=-1`` shifts the other way."""
    n = size(group)
    if not active() or n == 1:
        return [t.clone() for t in tensors]
    r = rank_in(group)

    def glob(i):
        return i if group is None else dist.get_global_rank(group, i)

    nxt, prv = glob((r + step) % n), glob((r - step) % n)
    src = [t.detach().contiguous() for t in tensors]
    dst = [torch.empty_like(t) for t in src]

    def fn(ins, outs):
        ops = [dist.P2POp(dist.isend, t, nxt, group=group) for t in ins]
        ops += [dist.P2POp(dist.irecv, t, prv, group=group) for t in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _run(name, group, fn, src, dst)
    return dst


def barrier(group=None) -> None:
    if active():
        dist.barrier(group=group)


# ------------------------------------------------------------ autograd


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        out, n = x, 1
        for g in groups:
            out = all_reduce(out, g)
            n *= size(g)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.n = 1
        for g in groups:
            x = all_reduce(x, g)
            ctx.n *= size(g)
        return x

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


class _ExtremeFrom(torch.autograd.Function):
    """The max (or min) of ``x`` over ``dims`` and over the ranks of
    ``groups``, kept dims; the gradient goes to the elements equal to the
    global extreme, split evenly among the ties of every rank (as
    ``jnp.max``'s), times the ranks (the convention above)."""

    @staticmethod
    def forward(ctx, x, dims, groups, op):
        red = torch.amax if op == "max" else torch.amin
        m = red(x, dim=dims, keepdim=True)
        n = 1
        for g in groups:
            m = all_reduce(m, g, op)
            n *= size(g)
        ctx.save_for_backward(x, m)
        ctx.args = (dims, groups, n)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        dims, groups, n = ctx.args
        hit = (x == m).to(g.dtype)
        count = hit.sum(dim=dims, keepdim=True)
        for grp in groups:
            count = all_reduce(count, grp)
        return g * n * hit / count, None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift([x], group, 1, "shift")[0]

    @staticmethod
    def backward(ctx, g):
        return ring_shift([g], ctx.group, -1, "shift")[0], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def _gather_dim(x: torch.Tensor, group, dim: int, order) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` and put in the global
    order (``order``: the gathered positions' permutation, or None)."""
    if x.dtype == torch.bool:
        return _gather_dim(x.to(torch.uint8), group, dim, order).bool()
    out = all_gather(x, group, dim)
    return out if order is None else out.index_select(
        dim, order.to(out.device))


class _GatherShards(torch.autograd.Function):
    """The whole tensor from each rank's shard: one all-gather a sharded
    dim.  Backward, a dim sharded over a data axis (``summed``) sums the
    cotangent over that axis's ranks before taking the rank's part, since
    every rank computed the whole op from the same whole input; a dim
    sharded over a model axis takes the rank's part only."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = steps
        for dim, group, order, mine, _ in steps:
            x = _gather_dim(x, group, dim, order)
        return x

    @staticmethod
    def backward(ctx, g):
        for dim, group, _, mine, summed in reversed(ctx.steps):
            if summed:
                g = all_reduce(g, group)
            g = g.index_select(dim, mine.to(g.device))
        return g, None


def gather_shards(x: torch.Tensor, steps) -> torch.Tensor:
    """``x`` gathered whole over ``steps``, each ``(dim, group, order,
    mine, summed)``: the dim, the group it is sharded over, the
    permutation into the global order (None when the ranks' blocks are in
    order), the rank's global positions along it, and whether the axis is
    a data axis.  Differentiable under the gradient convention above:
    the whole tensor is replicated, a data-sharded input gets the sum of
    the ranks' cotangents at its positions (n times its true cotangent
    when every rank's is the true one)."""
    if not x.requires_grad:
        with torch.no_grad():
            for dim, group, order, _, _ in steps:
                x = _gather_dim(x, group, dim, order)
        return x
    return _GatherShards.apply(x, tuple(steps))


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward; the gradient all-reduced over the
    group (the input of a column-parallel layer)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over the group forward; identity backward (the
    output of a row-parallel layer, a vocab-parallel lookup)."""
    return _ReduceFrom.apply(x, group)


def mean_from(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``groups`` (one after another)
    forward; identity backward: each rank's gradient is its own term's,
    and the Strategy averages the replicated parameters' gradients."""
    return _MeanFrom.apply(x, tuple(groups))


def sum_from(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``groups`` forward; backward, the
    gradient times the number of those ranks: a replicated sum of sharded
    terms, whose replicated parameters' gradients the Strategy averages
    (so that average is the single device's gradient)."""
    return _SumFrom.apply(x, tuple(groups))


def extreme_from(x: torch.Tensor, dims: Sequence[int], groups: Sequence,
                 op: str = "max") -> torch.Tensor:
    """The max (``op="max"``) or min of ``x`` over ``dims`` (kept as size
    1) and over the ranks of ``groups``; differentiable, a tie's gradient
    split among the equal elements of every rank."""
    return _ExtremeFrom.apply(x, tuple(dims), tuple(groups), op)


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`ring_shift` of one tensor to the next rank, differentiable:
    the backward shifts the cotangent to the previous rank, as JAX
    transposes ``lax.ppermute``.  Staged through pinned host memory on a
    gloo group with CUDA tensors (``GLOO_STAGED``)."""
    return _Shift.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``x`` along ``split_dim`` into one chunk per rank, send chunk j
    to rank j, and concatenate the chunks received along ``concat_dim`` in
    rank order (``lax.all_to_all(..., tiled=True)``); differentiable."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)
