"""Parallelism (PyTorch port of ``paddle_tpu/parallel``): SPMD over
processes, one rank per device, every collective explicit in ``comm.py``.

* ``make_mesh`` / ``Mesh``: the ranks of the process group on named axes
  (dp, tp, sp, pp, ep), one process group per slice of each axis;
* ``Strategy``: how an Executor runs a Program on a mesh (dp feed
  slicing, sharded parameters, gradient averaging, ZeRO-1, global
  fetches);
* ``tp``: Megatron column / row-parallel fc and the vocab-parallel
  embedding;
* ``ring_attention`` and ``ulysses_attention``: sequence parallelism.

``pipeline`` (GPipe) and ``moe`` (Switch experts) are ROADMAP A.9 part 2.
"""
from . import comm, tp
from .mesh import Mesh, make_mesh, mesh_axis_size
from .ring import ring_attention
from .strategy import StepLayout, Strategy
from .ulysses import ulysses_attention
from ..param_attr import PartitionSpec, SeqAxis

P = PartitionSpec

__all__ = ["Mesh", "P", "PartitionSpec", "SeqAxis", "StepLayout",
           "Strategy", "comm",
           "make_mesh", "mesh_axis_size", "ring_attention", "tp",
           "ulysses_attention"]
