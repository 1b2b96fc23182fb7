"""Sparse embedding engine (PyTorch port of ``paddle_tpu/sparse``,
DESIGN.md §26): fused embedding tables with dedup-and-bucket lookups, the
row-touched optimizer apply, and the streaming id pipeline.  A table may be
sharded over a serving mesh (``ShardedEmbeddingTable(mesh=)``)."""
from .pipeline import SparseFeeder
from .table import (DedupBatch, ShardedEmbeddingTable, bucket_for,
                    bucket_ladder, sparse_lookup)
from .update import (RowTouchedOptimizer, apply_dense,
                     count_dense_materializations, init_dense_state,
                     segment_rows)

__all__ = [
    "DedupBatch", "RowTouchedOptimizer", "ShardedEmbeddingTable",
    "SparseFeeder", "apply_dense", "bucket_for", "bucket_ladder",
    "count_dense_materializations", "init_dense_state", "segment_rows",
    "sparse_lookup",
]
