"""Parallelism (PyTorch port of ``paddle_tpu/parallel``): SPMD over
processes, one rank per device, every collective explicit in ``comm.py``.

* ``make_mesh`` / ``Mesh``: the ranks of the process group on named axes
  (dp, tp, sp, pp, ep), one process group per slice of each axis;
* ``Strategy``: how an Executor runs a Program on a mesh (dp feed
  slicing, sharded parameters, gradient averaging, ZeRO-1, global
  fetches);
* ``tp``: Megatron column / row-parallel fc and the vocab-parallel
  embedding;
* ``ring_attention`` and ``ulysses_attention``: sequence parallelism;
* ``gpipe`` / ``pipeline_fc_stack`` (GPipe over pp) and ``switch_moe`` /
  ``switch_moe_apply`` (Switch experts over ep).
"""
from . import comm, tp
from .mesh import Mesh, make_mesh, mesh_axis_size
from .moe import switch_moe, switch_moe_apply
from .pipeline import gpipe, pipeline_fc_stack
from .ring import ring_attention
from .strategy import LocalFeed, StepLayout, Strategy
from .ulysses import ulysses_attention
from ..param_attr import PartitionSpec, SeqAxis

P = PartitionSpec

__all__ = ["LocalFeed", "Mesh", "P", "PartitionSpec", "SeqAxis", "StepLayout",
           "Strategy", "comm", "gpipe",
           "make_mesh", "mesh_axis_size", "pipeline_fc_stack",
           "ring_attention", "switch_moe", "switch_moe_apply", "tp",
           "ulysses_attention"]
