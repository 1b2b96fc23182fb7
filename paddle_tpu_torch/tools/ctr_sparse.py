"""The sparse CTR A/B at ``benchmark/ctr_sparse.py``'s settings, as
``chip_smoke.py``'s sparse phase and the CPU tests run it: the same
wide&deep model (``models.ctr``'s sparse arm: one fused
``[sum(FIELD_VOCABS), 1 + EMB_DIM]`` table, the wide weight in column 0)
trained by two arms on one fixed-seed zipfian id stream with one Adagrad
rule, step for step:

* the sparse arm, the engine end to end: ``SparseEmbeddingTrainer`` over a
  ``SparseFeeder`` stream (dedup on the producer thread, one capture per
  bucket rung, the row-touched apply);
* the dense arm (``DenseArm``): the whole table is the differentiated
  leaf, its gradient the dense ``[V, D]`` one, and the optimizer applies
  over all V rows every step.

Both gather rows through ``F.embedding`` (``models.ctr``), so the two arms'
losses and touched rows agree bitwise.  The stream's batches are numpy
draws (``make_feed``); the warm-up batches cover every rung the stream
hits (``warm_batches``), and both arms train them first."""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

BATCH = 256
STREAM_STEPS = 100
EMB_DIM = 8
HIDDEN = (64, 32)
LR = 0.05
ZIPF_A = 1.3
TABLE_SEED, PARAM_SEED, STREAM_SEED, WARM_SEED = 3, 4, 20, 77


def zipf_batch(rng, vocabs, batch: int = BATCH) -> np.ndarray:
    """One [batch, F] id batch, zipfian per field (a few hot ids, a huge
    tail)."""
    cols = [(rng.zipf(ZIPF_A, batch) - 1) % v for v in vocabs]
    return np.stack(cols, axis=1).astype(np.int64)


def make_feed(rng, vocabs, dense_dim: int, batch: int = BATCH) -> dict:
    """A feed: zipfian ids, uniform dense features, and labels tied to the
    first dense feature so the loss moves."""
    ids = zipf_batch(rng, vocabs, batch)
    dense = rng.rand(batch, dense_dim).astype(np.float32)
    label = (dense[:, 0] + 0.1 * rng.randn(batch) > 0.5).astype(np.int64)
    return {"sparse": ids, "dense": dense, "label": label}


def stream(vocabs, dense_dim: int, n: int = STREAM_STEPS,
           seed: int = STREAM_SEED, batch: int = BATCH) -> list:
    rng = np.random.RandomState(seed)
    return [make_feed(rng, vocabs, dense_dim, batch) for _ in range(n)]


def warm_batches(table, feeds, vocabs, dense_dim: int, seed: int = WARM_SEED,
                 batch: int = BATCH, tries: int = 400) -> list:
    """One batch of the stream's distribution (another seed) for each rung
    ``feeds`` hit, so a stream after them captures nothing."""
    need = {table.dedup(f["sparse"]).bucket for f in feeds}
    rng = np.random.RandomState(seed)
    warm, covered = [], set()
    for _ in range(tries):
        f = make_feed(rng, vocabs, dense_dim, batch)
        b = table.dedup(f["sparse"]).bucket
        if b in need - covered:
            covered.add(b)
            warm.append(f)
        if covered == need:
            return warm
    raise RuntimeError(f"warm-up could not cover rungs {need - covered}")


def loss_fn(n_fields: int, emb_dim: int = EMB_DIM):
    from ..models import ctr

    return partial(ctr.wide_deep_sparse_loss, n_fields=n_fields,
                   emb_dim=emb_dim)


class DenseArm:
    """The dense-apply arm: the table (the reference's numpy draw of
    ``table_seed``) is the differentiated leaf, the gradient the dense
    ``[V, D]`` one, the optimizer's ``_update`` over the whole table and
    over each tower parameter every step; ``lr`` and ``t`` 0-d float32
    tensors, as the sparse trainer stages them.  Eager on ``device``."""

    def __init__(self, vocabs, emb_dim, params, opt, table_seed: int,
                 device, max_ids_per_batch=None):
        from ..models import ctr
        from ..sparse.update import init_dense_state

        self.table = ctr.wide_deep_sparse_table(
            vocabs, emb_dim, seed=table_seed, device=device,
            max_ids_per_batch=max_ids_per_batch)
        self.value = self.table.value.clone()
        self.opt = opt
        self.slots = {a: torch.full_like(self.value, float(f))
                      for a, f in type(opt)._accum_defaults.items()}
        self.params = {k: torch.as_tensor(v).to(device).clone()
                       for k, v in params.items()}
        self.state = init_dense_state(opt, self.params)
        self.loss_fn = loss_fn(len(vocabs), emb_dim)
        self.device = torch.device(device)
        self.global_step = 0

    def batch(self, feed) -> tuple:
        """(gids, batch) of a raw feed on the arm's device."""
        gids = torch.from_numpy(self.table.global_ids(feed["sparse"]))
        n, f = feed["sparse"].shape
        batch = {"dense": torch.from_numpy(feed["dense"]),
                 "label": torch.from_numpy(feed["label"]),
                 "sparse__mask": torch.ones((n, f), dtype=torch.float32)}
        dev = self.device
        return gids.to(dev), {k: v.to(dev) for k, v in batch.items()}

    def step_body(self, gids, batch, lr, t):
        from ..sparse.update import apply_dense

        leaf = self.value.detach().requires_grad_(True)
        names = list(self.params)
        leaves = [self.params[k].detach().requires_grad_(True)
                  for k in names]
        with torch.enable_grad():
            loss = self.loss_fn(leaf, dict(zip(names, leaves)),
                                dict(batch, sparse__inv=gids))
            grads = torch.autograd.grad(loss, [leaf] + leaves)
        with torch.no_grad():
            self.value, self.slots = self.opt._update(
                self.value, grads[0], self.slots, lr, t)
            self.params, self.state = apply_dense(
                self.opt, self.params, dict(zip(names, grads[1:])),
                self.state, lr, t)
        return loss.detach()

    def step(self, feed):
        gids, batch = self.batch(feed)
        dev = self.device
        lr = torch.tensor(float(self.opt._lr_value(torch.tensor(
            self.global_step, dtype=torch.int32))), dtype=torch.float32,
            device=dev)
        t = torch.tensor(float(self.global_step + 1), dtype=torch.float32,
                         device=dev)
        loss = self.step_body(gids, batch, lr, t)
        self.global_step += 1
        return loss
