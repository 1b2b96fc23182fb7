"""The port's serving path: continuous batching over a paged KV pool."""
from .batcher import (AdmissionShed, DecodeAdmissionQueue,
                      build_bucket_ladder, bucket_for)
from .decode import (ContinuousDecodeEngine, ContinuousScheduler,
                     DecodeRequest, PagedKVPool)
from .sampling import SamplingParams, branch_seed

__all__ = ["AdmissionShed", "ContinuousDecodeEngine", "ContinuousScheduler",
           "DecodeAdmissionQueue", "DecodeRequest", "PagedKVPool",
           "SamplingParams", "branch_seed", "bucket_for",
           "build_bucket_ladder"]
