"""CTR models: wide&deep and DeepFM (PyTorch port of
``paddle_tpu/models/ctr.py``; ref: BASELINE.json configs[3], the
high-dim-sparse workload of the reference's sparse parameter server).

Each categorical field is an embedding table named ``{prefix}_emb_{f}``
(the reference's names, so ``load_scope`` carries a JAX scope across);
``is_sparse=True`` routes every lookup through the sparse engine's
``sparse_lookup``.  The programs are written with the Variable sugar, as
the reference's are.  The FM second-order term is the
0.5 * ((sum v)^2 - sum v^2) identity.

The streaming sparse arm (``wide_deep_sparse_*``) runs outside the Program
graph: one fused ``[sum(vocabs), 1 + emb_dim]`` table over all fields
(column 0 of a row is the field's wide weight, the rest its deep
embedding), driven by ``trainer.SparseEmbeddingTrainer`` over a
``sparse.SparseFeeder`` stream."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import layers
from ..datasets import ctr as ctr_data


def _field_embeddings(sparse_ids, vocabs, dim, prefix, shard_spec=None,
                      is_sparse=False):
    """sparse_ids: [N, F] int; returns [N, F, dim] stacked per-field
    lookups."""
    from ..param_attr import ParamAttr

    embs = []
    for f, v in enumerate(vocabs):
        ids_f = layers.reshape(sparse_ids[:, f], [-1, 1])
        attr = ParamAttr(name=f"{prefix}_emb_{f}", sharding=shard_spec)
        embs.append(layers.embedding(ids_f, [v, dim], param_attr=attr,
                                     is_sparse=is_sparse))
    return layers.concat([layers.reshape(e, [-1, 1, dim]) for e in embs],
                         axis=1)


def wide_deep(dense, sparse_ids, label, vocabs: Optional[Sequence[int]] = None,
              emb_dim: int = 8, hidden: Sequence[int] = (64, 32),
              shard_spec=None, is_sparse: bool = False):
    """Wide & Deep (Cheng et al.): wide = linear over dense + per-field 1-d
    embeddings; deep = MLP over the concatenated field embeddings and
    dense.  Returns (loss, prob)."""
    vocabs = list(vocabs or ctr_data.FIELD_VOCABS)
    F_ = len(vocabs)

    wide_emb = _field_embeddings(sparse_ids, vocabs, 1, "wide", shard_spec,
                                 is_sparse)
    wide = layers.reduce_sum(layers.reshape(wide_emb, [-1, F_]), dim=1,
                             keep_dim=True) \
        + layers.fc(dense, 1, bias_attr=False)

    deep_emb = _field_embeddings(sparse_ids, vocabs, emb_dim, "deep",
                                 shard_spec, is_sparse)
    x = layers.concat([layers.reshape(deep_emb, [-1, F_ * emb_dim]), dense],
                      axis=1)
    for h in hidden:
        x = layers.fc(x, h, act="relu")
    deep = layers.fc(x, 1, bias_attr=False)

    logit = wide + deep
    prob = layers.sigmoid(logit)
    loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(
        logit, layers.cast(label, "float32")))
    return loss, prob


def deepfm(dense, sparse_ids, label, vocabs: Optional[Sequence[int]] = None,
           emb_dim: int = 8, hidden: Sequence[int] = (64, 32),
           shard_spec=None, is_sparse: bool = False):
    """DeepFM (Guo et al.): shared field embeddings feed both the FM
    second-order interaction and the deep MLP (none for an empty
    ``hidden``: a pure FM).  Returns (loss, prob)."""
    vocabs = list(vocabs or ctr_data.FIELD_VOCABS)
    F_ = len(vocabs)

    first = _field_embeddings(sparse_ids, vocabs, 1, "fm1", shard_spec,
                              is_sparse)
    first_order = layers.reduce_sum(layers.reshape(first, [-1, F_]), dim=1,
                                    keep_dim=True) \
        + layers.fc(dense, 1, bias_attr=False)

    v = _field_embeddings(sparse_ids, vocabs, emb_dim, "fm2", shard_spec,
                          is_sparse)                          # [N, F, d]
    sum_sq = layers.square(layers.reduce_sum(v, dim=1))       # (sum v)^2
    sq_sum = layers.reduce_sum(layers.square(v), dim=1)       # sum v^2
    second_order = layers.scale(
        layers.reduce_sum(sum_sq - sq_sum, dim=1, keep_dim=True), scale=0.5)

    logit = first_order + second_order
    if hidden:
        x = layers.concat([layers.reshape(v, [-1, F_ * emb_dim]), dense],
                          axis=1)
        for h in hidden:
            x = layers.fc(x, h, act="relu")
        logit = logit + layers.fc(x, 1, bias_attr=False)
    prob = layers.sigmoid(logit)
    loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(
        logit, layers.cast(label, "float32")))
    return loss, prob


# -------------------------------------------------- sparse-engine arm


def wide_deep_sparse_table(vocabs: Optional[Sequence[int]] = None,
                           emb_dim: int = 8, mesh=None, seed: int = 0,
                           max_ids_per_batch: Optional[int] = None,
                           device=None):
    """The fused [sum(vocabs), 1 + emb_dim] ShardedEmbeddingTable behind
    ``wide_deep_sparse_loss`` (wide weight in column 0), on ``device``
    (the CUDA card unless given)."""
    from ..sparse.table import ShardedEmbeddingTable

    vocabs = list(vocabs or ctr_data.FIELD_VOCABS)
    return ShardedEmbeddingTable(vocabs, 1 + emb_dim, mesh=mesh, seed=seed,
                                 name="ctr_wide_deep",
                                 max_ids_per_batch=max_ids_per_batch,
                                 device=device)


def wide_deep_sparse_params(vocabs: Optional[Sequence[int]] = None,
                            emb_dim: int = 8, dense_dim: Optional[int] = None,
                            hidden: Sequence[int] = (64, 32), seed: int = 0):
    """The dense-tower parameters (all but the table) of the sparse
    wide&deep arm as numpy arrays, the reference's draws."""
    vocabs = list(vocabs or ctr_data.FIELD_VOCABS)
    dense_dim = ctr_data.NUM_DENSE if dense_dim is None else int(dense_dim)
    F_ = len(vocabs)
    rng = np.random.RandomState(seed)
    dims = [F_ * emb_dim + dense_dim] + list(hidden)
    params = {"wide_w": (rng.standard_normal((dense_dim, 1)) * 0.02)
              .astype(np.float32)}
    for i in range(len(hidden)):
        params[f"w{i}"] = (rng.standard_normal((dims[i], dims[i + 1]))
                           * (2.0 / dims[i]) ** 0.5).astype(np.float32)
        params[f"b{i}"] = np.zeros((dims[i + 1],), np.float32)
    params["w_out"] = (rng.standard_normal((dims[-1], 1)) * 0.02) \
        .astype(np.float32)
    return params


def wide_deep_sparse_loss(rows, params, batch, *, n_fields: int,
                          emb_dim: int = 8, field: str = "sparse"):
    """Wide&deep forward and loss over gathered unique table rows.

    ``rows``: [bucket, 1 + emb_dim], the differentiated leaf (its gradient
    is the segment-summed per-row cotangent).  ``batch`` carries the
    SparseFeeder's staging: ``<field>__inv`` [N, F], ``<field>__mask``
    [N, F], ``dense`` [N, 13] and ``label`` [N] or [N, 1].  ``rows[inv]``
    is ``F.embedding``, whose backward adds duplicates in a fixed order
    (sorted by index, stable), the same whether the leaf is the gathered
    rows or the whole table, so the two arms' gradients agree bitwise.
    The sigmoid cross-entropy is the reference's stable form."""
    inv = batch[field + "__inv"]
    mask = batch[field + "__mask"]
    emb = F.embedding(inv.long(), rows) * mask[..., None]   # [N, F, 1+d]
    dense = batch["dense"]
    n = dense.shape[0]
    wide = emb[..., 0].sum(dim=1, keepdim=True) + dense @ params["wide_w"]
    x = torch.cat([emb[..., 1:].reshape(n, n_fields * emb_dim), dense],
                  dim=1)
    zero = x.new_zeros(())
    i = 0
    while f"w{i}" in params:
        x = torch.maximum(x @ params[f"w{i}"] + params[f"b{i}"], zero)
        i += 1
    logit = (wide + x @ params["w_out"]).reshape(-1)
    y = batch["label"].reshape(-1).to(logit.dtype)
    ce = (torch.maximum(logit, zero) - logit * y
          + torch.log1p(torch.exp(-torch.abs(logit))))
    return ce.mean()
