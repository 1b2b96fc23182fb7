"""Tensor-parallel layers (PyTorch port of ``paddle_tpu/parallel/tp.py``).

The JAX package expresses Megatron as layouts and lets GSPMD place the
all-reduces.  Here the same layouts (``ParamAttr.sharding``) are read by
the layers themselves (``layers/nn.py``: ``fc``, ``embedding``,
``softmax_with_cross_entropy``), which call the functions below on the
rank's shards, with ``comm.py``'s two Megatron functions:

* a column-parallel fc (W [in, out/tp]) takes its input through
  ``copy_to`` (the gradient all-reduced over tp) and leaves its output
  sharded on the last dim;
* a row-parallel fc (W [in/tp, out]) takes a last-dim-sharded input and
  all-reduces its product (``reduce_from``); its replicated bias is added
  after the sum;
* a vocab-parallel lookup (table [V/tp, D]) masks the ids outside the
  rank's rows, gathers locally and all-reduces; ids are clamped to
  [0, V-1] first, as JAX's gather clamps them (ROADMAP C.4); the sparse
  lookup (``is_sparse``) builds the rank's table cotangent by the sparse
  engine's padding and drop rule, without atomics;
* the cross entropy over vocab-sharded logits takes the max, the sum of
  exponentials and the target logit (or, with soft labels, the label
  mass and the label-weighted logits) each over tp (the max without a
  gradient: the loss does not depend on it); its softmax stays sharded
  on the vocab.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..layers import nn as _nn
from ..param_attr import ParamAttr, PartitionSpec as P
from . import comm


def _attr_with(attr, spec) -> ParamAttr:
    a = ParamAttr.to_attr(attr)
    if a.sharding is None:
        # never mutate a caller-shared ParamAttr (parameter-sharing pattern)
        a = dataclasses.replace(a, sharding=spec)
    return a


def column_parallel_fc(x, size: int, axis: str = "tp", param_attr=None,
                       bias_attr=None, act=None, num_flatten_dims: int = 1,
                       name=None):
    """fc with W sharded [in, out/tp]; the output stays sharded on its last
    dim."""
    return _nn.fc(
        x, size,
        num_flatten_dims=num_flatten_dims,
        param_attr=_attr_with(param_attr, P(None, axis)),
        bias_attr=False if bias_attr is False else _attr_with(bias_attr,
                                                              P(axis)),
        act=act, name=name,
    )


def row_parallel_fc(x, size: int, axis: str = "tp", param_attr=None,
                    bias_attr=None, act=None, num_flatten_dims: int = 1,
                    name=None):
    """fc with W sharded [in/tp, out]; its product is all-reduced over tp."""
    return _nn.fc(
        x, size,
        num_flatten_dims=num_flatten_dims,
        param_attr=_attr_with(param_attr, P(axis, None)),
        bias_attr=False if bias_attr is False else _attr_with(bias_attr,
                                                              P()),
        act=act, name=name,
    )


def vocab_parallel_embedding(ids, size, axis: str = "tp", param_attr=None,
                             dtype="float32", name=None):
    """Embedding table sharded over the vocab dim: a masked local gather and
    an all-reduce over tp."""
    return _nn.embedding(ids, size, param_attr=_attr_with(param_attr,
                                                          P(axis, None)),
                         dtype=dtype, name=name)


# ------------------------------------------------------------ on shards


def sharded_matmul(mesh, x: torch.Tensor, w: torch.Tensor,
                   spec) -> torch.Tensor:
    """``x @ w`` for a W sharded by ``spec``: column (None, axis) or row
    (axis, None); x is [rows, in] (in/tp for a row-parallel W)."""
    spec = tuple(spec) + (None,) * (2 - len(spec))
    if spec[1] is not None:
        return comm.copy_to(x, mesh.group(spec[1])) @ w
    if spec[0] is not None:
        return comm.reduce_from(x @ w, mesh.group(spec[0]))
    return x @ w


def _local_ids(mesh, ids: torch.Tensor, axis: str, local_rows: int,
               vocab: int):
    """(ids relative to the rank's rows, clamped into them; mask of the
    ids the rank holds), ids clamped to [0, vocab - 1] first."""
    ids = ids.long().clamp(0, vocab - 1)
    rel = ids - mesh.coord(axis) * local_rows
    inside = (rel >= 0) & (rel < local_rows)
    return rel.clamp(0, local_rows - 1), inside


def vocab_lookup(mesh, ids: torch.Tensor, table: torch.Tensor, axis: str,
                 vocab: int) -> torch.Tensor:
    """The rows of a vocab-sharded table: each rank gathers the ids it
    holds, the others read zeros, and the sum over tp is the lookup."""
    rel, inside = _local_ids(mesh, ids, axis, table.shape[0], vocab)
    out = F.embedding(rel, table) * inside[..., None].to(table.dtype)
    return comm.reduce_from(out, mesh.group(axis))


class _VocabSparseLookup(torch.autograd.Function):
    """The rank's part of a sparse lookup on a vocab-sharded table: rows of
    the ids it holds (ids clamped into [0, V - 1] first, JAX's gather),
    the others zero, the padding rows' output zero.  Backward, the table
    cotangent by the sparse engine's rule (``sparse/table.py``:
    ``scatter_index``, JAX's ``mode="drop"``): the padding occurrences and
    the ids JAX drops go to a scratch row past the rank's rows, as do the
    ids another rank holds, so no ``index_add_`` atomics and a padding
    row's gradient exactly zero."""

    @staticmethod
    def forward(ctx, tab, ids, padding_idx, vocab, row0):
        from ..sparse.table import gather_index

        rows = tab.shape[0]
        ctx.save_for_backward(ids)
        ctx.args = (padding_idx, vocab, row0, rows)
        g = gather_index(ids, vocab) - row0
        inside = (g >= 0) & (g < rows)
        if padding_idx is not None:
            inside = inside & (ids != padding_idx)
        out = F.embedding(g.clamp(0, rows - 1), tab)
        return out * inside[..., None].to(out.dtype)

    @staticmethod
    def backward(ctx, cot):
        from ..sparse.table import scatter_index

        ids, = ctx.saved_tensors
        padding_idx, vocab, row0, rows = ctx.args
        rel = scatter_index(ids, vocab) - row0
        keep = (rel >= 0) & (rel < rows)
        if padding_idx is not None:
            keep = keep & (ids != padding_idx)
        safe = torch.where(keep, rel, torch.full_like(rel, rows))
        g = torch.ops.aten.embedding_dense_backward(
            cot.contiguous(), safe, rows + 1, rows, False)
        return g[:rows], None, None, None, None


def vocab_sparse_lookup(mesh, ids: torch.Tensor, table: torch.Tensor,
                        axis: str, vocab: int, padding_idx=None):
    """``embedding(is_sparse=True)`` on a table sharded on its vocab dim:
    each rank looks up the ids it holds with the sparse engine's
    cotangent rule (``_VocabSparseLookup``), and the sum over tp
    (``comm.reduce_from``) is the lookup."""
    row0 = mesh.coord(axis) * table.shape[0]
    out = _VocabSparseLookup.apply(table, ids, padding_idx, vocab, row0)
    return comm.reduce_from(out, mesh.group(axis))


def vocab_cross_entropy(mesh, logits: torch.Tensor, label: torch.Tensor,
                        axis: str, vocab: int, soft_label: bool = False,
                        return_softmax: bool = False):
    """Softmax cross entropy over logits sharded on the vocab (last) dim,
    with m (the max), the sum of exponentials and the label term each
    over tp, so ``lse = log(sum exp(l - m)) + m`` is global: hard labels
    (``label`` the ids) give ``lse - l[label]``; soft labels (``label``
    [..., V], the whole row or the rank's slice of it) give
    ``lse * sum(label) - sum(label * l)``, both sums partial over the
    rank's vocab and summed over tp.  [..., 1] like the unsharded op;
    with ``return_softmax`` also the rank's vocab slice of the softmax,
    ``exp(l - lse)``."""
    group = mesh.group(axis)
    m = comm.all_reduce(logits.detach().amax(dim=-1, keepdim=True), group,
                        "max")
    se = comm.reduce_from(torch.exp(logits - m).sum(dim=-1, keepdim=True),
                          group)
    lse = torch.log(se) + m
    if soft_label:
        w = logits.shape[-1]
        if label.shape[-1] != w:
            label = label.narrow(-1, mesh.coord(axis) * w, w)
        label = label.to(logits.dtype)
        dot = comm.reduce_from((label * logits).sum(dim=-1, keepdim=True),
                               group)
        mass = comm.reduce_from(label.sum(dim=-1, keepdim=True), group)
        loss = lse * mass - dot
    else:
        rel, inside = _local_ids(mesh, label, axis, logits.shape[-1], vocab)
        tgt = torch.gather(logits, -1, rel[..., None]) \
            * inside[..., None].to(logits.dtype)
        loss = lse - comm.reduce_from(tgt, group)
    if return_softmax:
        return loss, torch.exp(logits - lse)
    return loss
