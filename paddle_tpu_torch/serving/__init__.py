"""The port's serving path: the request batcher (``DynamicBatcher``, the
``capi_server.Session``'s micro-batcher), continuous batching over a paged KV pool, with
the prefix cache, beam and parallel-n forks and migration records, the
dense ``DecodeEngine``, and the mesh-sharded tier (``mesh``: the layout
table, the serving mesh and the sharded LM a ``ContinuousDecodeEngine(
mesh=)`` runs)."""
from .batcher import (AdmissionShed, BatchPolicy, DecodeAdmissionQueue,
                      DynamicBatcher, build_bucket_ladder, bucket_for)
from .decode import (ContinuousDecodeEngine, ContinuousScheduler,
                     DecodeEngine, DecodeRequest, GenerationMigrated,
                     PagedKVPool)
from .mesh import ServingMesh, SpecLayout, make_serving_mesh, mesh_from_env
from .prefix import PrefixCache, chain_hashes, root_for_kv_dtype
from .sampling import SamplingParams, branch_seed

__all__ = ["AdmissionShed", "BatchPolicy", "ContinuousDecodeEngine",
           "ContinuousScheduler", "DecodeAdmissionQueue", "DecodeEngine",
           "DynamicBatcher", "DecodeRequest",
           "GenerationMigrated", "PagedKVPool", "PrefixCache",
           "SamplingParams", "ServingMesh", "SpecLayout", "branch_seed",
           "bucket_for", "build_bucket_ladder", "chain_hashes",
           "make_serving_mesh", "mesh_from_env", "root_for_kv_dtype"]
