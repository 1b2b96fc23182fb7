"""The port's serving path: continuous batching over a paged KV pool, with
the prefix cache, beam and parallel-n forks and migration records, and the
dense ``DecodeEngine``."""
from .batcher import (AdmissionShed, DecodeAdmissionQueue,
                      build_bucket_ladder, bucket_for)
from .decode import (ContinuousDecodeEngine, ContinuousScheduler,
                     DecodeEngine, DecodeRequest, GenerationMigrated,
                     PagedKVPool)
from .prefix import PrefixCache, chain_hashes, root_for_kv_dtype
from .sampling import SamplingParams, branch_seed

__all__ = ["AdmissionShed", "ContinuousDecodeEngine", "ContinuousScheduler",
           "DecodeAdmissionQueue", "DecodeEngine", "DecodeRequest",
           "GenerationMigrated", "PagedKVPool", "PrefixCache",
           "SamplingParams", "branch_seed", "bucket_for",
           "build_bucket_ladder", "chain_hashes", "root_for_kv_dtype"]
