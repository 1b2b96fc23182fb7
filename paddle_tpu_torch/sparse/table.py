"""Embedding tables with dedup-and-bucket lookup (PyTorch port of
``paddle_tpu/sparse/table.py``, DESIGN.md §26).

The table stays resident in device memory.  The host prepares ids: ``dedup``
takes a batch's unique ids (``np.unique``) and pads them to a small static
ladder of unique-count buckets, so every step has one of a few fixed
shapes (one CUDA graph per rung, captured at its first visit); dead bucket
slots and ``padding_idx`` occurrences carry the sentinel id ``vocab``.

Sentinel rows.  The JAX package gathers with ``mode="clip"`` (an id below
0 reads row 0, an id at or past ``vocab`` row ``vocab - 1``) and scatters
with ``mode="drop"`` (an id in [-vocab, 0) counts from the end once, any
other id outside [0, vocab) is dropped).  Torch has neither: ``F.embedding``
and ``index_select`` raise on an index out of range (on the card as a
device-side assert), and ``index_put_`` can neither drop an index nor name
a winner among repeated ones on CUDA.  So the table's storage has one
scratch row past the table, ``[vocab + 1, dim]``, with ``value`` the
``[:vocab]`` view: a gather clamps its index into [0, vocab - 1]
(``gather_index``), and a scatter sends every index JAX would drop to the
scratch row (``scatter_index``), so the live uids, unique by construction,
are the only writes that land in the table.

``sparse_lookup`` is the ``embedding(is_sparse=True)`` path: the gather
times the padding mask forward, and a backward that drops the padding
row's and the out-of-range ids' cotangents (the padding row gets exactly
zero, even from an ``inf`` or ``nan`` cotangent).  It builds the table's
gradient with ``embedding_dense_backward`` over ids remapped to one
skipped index, not ``index_add_``, whose atomics on the card would break
the bitwise equality of a replayed step with an eager one.

Over a serving mesh (``mesh=``, a ``serving.mesh.ServingMesh``) the rows
are laid out over ``fsdp x tp`` as ``SpecLayout.embeddings()`` says,
fitted to the table's shape: a rank's storage is its block of rows plus
its own scratch row.  A gather is the owner's rows summed over the mesh
(the other ranks add exact zeros, so the lookup is bitwise the unsharded
one), and an update touches only the owner's rows (``local_uids`` maps a
global uid to the rank's row, or to its scratch row).  The one-device
mesh keeps the unsharded table.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..core.graphs import Graphs, Staged
from ..obs import metrics as _metrics

DEFAULT_MIN_BUCKET = 64


# ------------------------------------------------------------------ ladder


def bucket_ladder(max_unique: int, min_bucket: int = DEFAULT_MIN_BUCKET):
    """Powers-of-two unique-count buckets from ``min_bucket`` up to the
    first rung covering ``max_unique``: the static shape set every dedup
    pads to."""
    if max_unique < 1:
        raise ValueError(f"max_unique must be >= 1, got {max_unique}")
    b = 1
    while b < min_bucket:
        b <<= 1
    ladder = [b]
    while ladder[-1] < max_unique:
        ladder.append(ladder[-1] * 2)
    return tuple(ladder)


def bucket_for(n_unique: int, ladder: Sequence[int]) -> int:
    """Smallest rung holding ``n_unique`` ids.  Exceeding the top rung
    raises: the ladder is sized to the batch at table build time, never
    grown at run time (a new rung is a new capture)."""
    for b in ladder:
        if n_unique <= b:
            return int(b)
    raise ValueError(
        f"{n_unique} unique ids exceed the bucket ladder {tuple(ladder)} — "
        f"size the ladder to the batch's id capacity at table build time")


class DedupBatch(NamedTuple):
    """Host-side dedup of one batch's ids, padded to a ladder rung.

    ``uids``: [bucket] int32 global row ids, the tail (and any padding_idx
    occurrence) the sentinel ``vocab``; ``inv``: ids-shaped int32 inverse
    indices into ``uids``; ``mask``: ids-shaped float32, 0.0 where the id
    was ``padding_idx``; ``n_unique``: live rows (<= bucket); ``bucket``:
    the rung."""

    uids: np.ndarray
    inv: np.ndarray
    mask: np.ndarray
    n_unique: int
    bucket: int


# ----------------------------------------------------- clip and drop


def gather_index(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """``ids`` as JAX's ``take(mode="clip")`` reads them: clamped into
    [0, vocab - 1], as int64."""
    return ids.long().clamp(0, vocab - 1)


def scatter_index(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """``ids`` as JAX's ``.at[ids].set(mode="drop")`` writes them, over a
    storage with a scratch row at ``vocab``: an id in [-vocab, 0) counts
    from the end once; every id JAX drops (below -vocab, or at or past
    ``vocab``) goes to the scratch row ``vocab``.  int64."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + vocab, ids)
    return torch.where((ids < 0) | (ids >= vocab),
                       torch.full_like(ids, vocab), ids)


# ----------------------------------------------------- graph-path lookup


class _SparseLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tab, ids, padding_idx, vocab):
        ctx.save_for_backward(ids)
        ctx.padding_idx, ctx.vocab = padding_idx, vocab
        out = F.embedding(gather_index(ids, vocab), tab)
        if padding_idx is not None:
            out = out * (ids != padding_idx)[..., None].to(out.dtype)
        return out

    @staticmethod
    def backward(ctx, cot):
        ids, = ctx.saved_tensors
        vocab, pad = ctx.vocab, ctx.padding_idx
        safe = scatter_index(ids, vocab)
        if pad is not None:
            keep = ids != pad
            safe = torch.where(keep, safe, torch.full_like(safe, vocab))
            cot = cot * keep[..., None].to(cot.dtype)
        g = torch.ops.aten.embedding_dense_backward(
            cot.contiguous(), safe, vocab + 1, vocab, False)
        return g[:vocab], None, None, None


def sparse_lookup(tab, ids, padding_idx: Optional[int], vocab: int):
    """The lookup ``layers.embedding(is_sparse=True)`` routes to: the gather
    (JAX's clip) times the padding-output mask; its backward drops the
    ``padding_idx`` occurrences and the out-of-range ids (JAX's drop) by
    remapping them to one extra row that ``embedding_dense_backward``
    skips, so the padding row's gradient is exactly zero even under a
    non-finite cotangent."""
    return _SparseLookup.apply(tab, ids, padding_idx, vocab)


# ------------------------------------------------------------------ table


class ShardedEmbeddingTable:
    """An embedding table plus its host-side dedup machinery.

    ``vocabs`` may be one vocabulary size or a per-field list: the fields
    fuse into one table with per-field row offsets (the DLRM idiom), so a
    single dedup covers every field and a step does one gather and one
    scatter.  ``padding_idx`` is a global row index (offsets applied).

    The initial values are the reference's numpy draw (``RandomState(seed)``
    standard normal times ``init_scale``), bit for bit, on ``device`` (the
    CUDA card unless given).  ``storage`` is ``[vocab + 1, dim]``, its last
    row the scratch row of the sentinel design (module docstring); ``value``
    is the ``[:vocab]`` view, which the row-touched apply updates in place.

    ``mesh``: a ``serving.mesh.ServingMesh`` or None (module docstring).
    Over a real mesh ``storage`` holds this rank's rows; ``row0`` is the
    first, ``rows`` their count.  Ids at or past ``vocab`` and below 0 go
    to the scratch row in an update (an update of a negative id, which
    JAX wraps, is dropped)."""

    def __init__(self, vocabs: Union[int, Sequence[int]], dim: int, *,
                 mesh=None, padding_idx: Optional[int] = None,
                 dtype="float32", seed: int = 0, init_scale: float = 0.02,
                 name: str = "sparse_table",
                 max_ids_per_batch: Optional[int] = None,
                 min_bucket: int = DEFAULT_MIN_BUCKET, device=None):
        if mesh is not None and not hasattr(mesh, "axes"):
            raise TypeError(f"mesh must be a serving.mesh.ServingMesh, got "
                            f"{type(mesh).__name__}")
        vs = [int(vocabs)] if np.isscalar(vocabs) else [int(v) for v in vocabs]
        if any(v < 1 for v in vs):
            raise ValueError(f"vocab sizes must be >= 1, got {vs}")
        self.field_vocabs = tuple(vs)
        self.offsets = np.concatenate(
            [[0], np.cumsum(vs[:-1])]).astype(np.int64)
        self.vocab = int(sum(vs))
        self.dim = int(dim)
        self.name = name
        self.padding_idx = padding_idx
        self.dtype = np.dtype(dtype)
        cap = min(self.vocab, int(max_ids_per_batch or self.vocab))
        self.ladder = bucket_ladder(cap, min_bucket=min_bucket)
        self.mesh = mesh
        self.spec = None
        self.row0, self.rows, self._groups = 0, self.vocab, []
        if mesh is not None and mesh.mesh is not None:
            from ..serving.mesh import SpecLayout, _fit_spec, _names

            layout = getattr(mesh, "layout", None) or SpecLayout()
            spec = _fit_spec(layout.embeddings(), (self.vocab, self.dim),
                             mesh.axes)
            axes = _names(spec[0]) if len(spec) else ()
            self.spec = spec
            if axes:
                n, idx = 1, 0
                for a in axes:
                    n *= mesh.axis(a)
                    idx = idx * mesh.axis(a) + mesh.coord(a)
                self.rows = self.vocab // n
                self.row0 = idx * self.rows
                self._groups = [mesh.group(a) for a in axes]
        self.device = resolve_device(device)
        rng = np.random.RandomState(seed)
        host = (rng.standard_normal((self.vocab, self.dim))
                * init_scale).astype(self.dtype)
        self.storage = torch.zeros((self.rows + 1, self.dim),
                                   dtype=torch.from_numpy(host).dtype,
                                   device=self.device)
        self.storage[:self.rows].copy_(torch.from_numpy(
            host[self.row0:self.row0 + self.rows]))
        self._graphs = Graphs(self.device)
        self._lookups = {}
        self._traces = 0

    @property
    def value(self) -> torch.Tensor:
        """The table, ``[vocab, dim]``: a view of ``storage`` (over a mesh,
        this rank's ``[rows, dim]``)."""
        return self.storage[:self.rows]

    # ------------------------------------------------------------- host side
    def global_ids(self, ids) -> np.ndarray:
        """Per-field ids [..., F] -> fused-table row ids (offsets applied).
        Single-field tables pass ids through unchanged."""
        ids = np.asarray(ids)
        if len(self.field_vocabs) == 1:
            return ids.astype(np.int64)
        if ids.shape[-1] != len(self.field_vocabs):
            raise ValueError(
                f"expected trailing field dim {len(self.field_vocabs)}, "
                f"got ids shape {ids.shape}")
        return ids.astype(np.int64) + self.offsets

    def dedup(self, ids) -> DedupBatch:
        """Host dedup-and-bucket for one batch (``np.unique`` + ladder pad),
        the reference's arrays.  Runs on the pipeline's producer thread,
        overlapped with the device step."""
        gids = self.global_ids(ids)
        flat = gids.reshape(-1)
        if self.padding_idx is not None:
            mask = (flat != self.padding_idx)
        else:
            mask = np.ones(flat.shape, dtype=bool)
        uids, inv = np.unique(flat, return_inverse=True)
        n = int(uids.shape[0])
        bucket = bucket_for(n, self.ladder)
        padded = np.full((bucket,), self.vocab, dtype=np.int32)
        padded[:n] = uids
        if self.padding_idx is not None:
            # the padding row is frozen at the id level: its uid becomes the
            # sentinel, so the update scatter drops it whatever its gradient
            padded[padded == self.padding_idx] = self.vocab
        return DedupBatch(uids=padded,
                          inv=inv.astype(np.int32).reshape(gids.shape),
                          mask=mask.astype(np.float32).reshape(gids.shape),
                          n_unique=n, bucket=bucket)

    # ----------------------------------------------------------- device side
    def gather(self, uids: torch.Tensor) -> torch.Tensor:
        """The rows of ``uids`` (JAX's clip), ``[len(uids), dim]``; over a
        mesh the owner's rows, summed over the mesh."""
        gi = gather_index(uids, self.vocab)
        if not self._groups:
            return F.embedding(gi, self.value)
        from ..parallel import comm

        local = gi - self.row0
        mine = (local >= 0) & (local < self.rows)
        out = F.embedding(local.clamp(0, self.rows - 1), self.value) \
            * mine[:, None].to(self.storage.dtype)
        for g in self._groups:
            out = comm.all_reduce(out, g)
        return out

    def local_uids(self, uids: torch.Tensor) -> torch.Tensor:
        """``uids`` as this rank's storage rows for an update: the rank's own
        rows, every other id its scratch row ``rows``.  The identity on an
        unsharded table."""
        if not self._groups:
            return uids
        si = scatter_index(torch.as_tensor(uids), self.vocab) - self.row0
        return torch.where((si >= 0) & (si < self.rows), si,
                           torch.full_like(si, self.rows))

    def lookup(self, ids) -> torch.Tensor:
        """Whole lookup: host dedup, then the gather and the expand
        (``rows[inv] * mask``) on the device, prepared once per signature
        (bucket and ids shape): on the card a CUDA graph captured at the
        signature's first visit, on the CPU the body run on static
        buffers; ``traces`` counts them.  Serves inference and the parity
        tests; training fuses the gather into its step
        (``trainer.SparseEmbeddingTrainer``)."""
        db = self.dedup(ids)
        _metrics.gauge("sparse.bucket.occupancy").set(
            db.n_unique / float(db.bucket))
        key = (db.bucket, db.inv.shape)
        prep = self._lookups.get(key)
        if prep is None:
            staged = Staged([("uids", (db.bucket,), np.int32),
                             ("inv", db.inv.shape, np.int32),
                             ("mask", db.mask.shape, np.float32)],
                            self.device)
            outs = {}

            def body(t=staged.t, outs=outs):
                rows = self.gather(t["uids"])
                out = F.embedding(t["inv"].long(), rows)
                outs["out"] = out * t["mask"][..., None].to(out.dtype)

            staged.stage({"uids": db.uids, "inv": db.inv, "mask": db.mask})
            with torch.no_grad():
                prep = (staged, self._graphs.prepare(body), outs)
            self._lookups[key] = prep
            self._traces += 1
            _metrics.counter("sparse.lookup.traces").inc()
        staged, run, outs = prep
        staged.stage({"uids": db.uids, "inv": db.inv, "mask": db.mask})
        with torch.no_grad():
            run.replay()
        return outs["out"].clone()

    @property
    def traces(self) -> int:
        """Signatures the lookup has prepared (one per ladder rung hit)."""
        return self._traces

    # ------------------------------------------------------------- identity
    def describe(self) -> str:
        """Canonical JSON descriptor (sorted keys, no device ids), the
        reference's string for a table with no mesh."""
        from ..serving.mesh import _spec_to_jsonable

        d = {"vocab": self.vocab, "dim": self.dim,
             "fields": list(self.field_vocabs),
             "dtype": self.dtype.name, "padding_idx": self.padding_idx,
             "ladder": list(self.ladder),
             "spec": (_spec_to_jsonable(self.spec) if self.spec is not None
                      else None),
             "axes": dict(self.mesh.axes) if self.mesh is not None else {}}
        return json.dumps(d, sort_keys=True)
