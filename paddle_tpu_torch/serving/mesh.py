"""Mesh-sharded serving (PyTorch port of ``paddle_tpu/serving/mesh.py``).

Three pieces, as in the reference:

  ``SpecLayout``        the name -> PartitionSpec table of the Transformer
                        LM's parameters (``lm_param_shapes`` naming) over
                        the serving axes ``data`` / ``fsdp`` / ``tp``;
  ``make_serving_mesh`` the mesh, on the port's ``parallel.make_mesh`` over
                        the ranks of the default process group, degrading
                        gracefully: axes collapse (fsdp first, then tp,
                        then data) until the mesh fits the ranks, down to
                        one, where no mesh exists and the engine takes its
                        exact single-device path;
  ``ServingMesh``       the resolved handle: fitted per-parameter specs (an
                        axis that does not divide a dim is dropped from
                        it), a rank's shards of a parameter dict, and the
                        canonical descriptor (axis names, sizes and specs,
                        never a rank number).

The port is SPMD over processes, one rank per device: every rank builds
the same engine and runs the same scheduler over the same requests, and
:class:`ShardedParams` gives the LM's serving forms
(``models/transformer.py``) the rank's shards and tp hooks, with explicit
collectives (``parallel/comm.py``), where the JAX package lets
GSPMD place them:

* ``tp``: q, k, v and ff1 are column-parallel, o and ff2 row-parallel
  (their products summed over tp), the KV arena and the paged kernel
  hold ``H / tp`` heads a rank when ``heads_shardable``; the LM head is
  vocab-parallel, its logits gathered over tp;
* ``fsdp``: a parameter's fsdp shard is all-gathered at use, as GSPMD
  does;
* ``data``: the decode engine runs a rank's slots' rows and gathers the
  logits and the new K/V rows over data (``serving/decode.py``).

Numerics: sharding ``data`` leaves per-row math as it is; ``fsdp`` /
``tp`` split matmul contractions (partial sums, then a sum over ranks),
which reassociates float adds, so those steps agree within the stated
tolerance, not bitwise.  The reference's gauges are published here:
``serving.mesh.devices`` and the ``serving.mesh.axis_size`` labeled gauge
when a ServingMesh is made, ``serving.mesh.collapsed_axes`` by
``make_serving_mesh``, ``serving.mesh.params_sharded`` (and the span
``serving.mesh.shard_params``) by the placement pass.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..param_attr import PartitionSpec as P

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
SERVING_AXES = (DATA_AXIS, FSDP_AXIS, TP_AXIS)

MESH_ENV = "PADDLE_TPU_SERVING_MESH"


class SpecLayout:
    """Canonical PartitionSpecs for the Transformer LM's parameters.  One
    method per family; ``spec_for(name, shape)`` routes a name to its
    family.  Unknown names are replicated: sharding is opted into per
    family, never guessed."""

    def __init__(self, data_axis: str = DATA_AXIS, fsdp_axis: str = FSDP_AXIS,
                 tp_axis: str = TP_AXIS):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis

    def embeddings(self):
        """Token / position tables: rows over fsdp x tp."""
        return P((self.fsdp_axis, self.tp_axis), None)

    def qkv_projection(self):
        """Column-parallel: input dim over fsdp, heads (output) over tp."""
        return P(self.fsdp_axis, self.tp_axis)

    def attn_output(self):
        """Row-parallel output projection: tp on the input (head) dim."""
        return P(self.tp_axis, self.fsdp_axis)

    def ffn_up(self):
        return P(self.fsdp_axis, self.tp_axis)

    def ffn_down(self):
        return P(self.tp_axis, self.fsdp_axis)

    def norm_or_bias(self):
        """1-D layernorm gains and biases: replicated."""
        return P()

    def lm_head(self):
        return P(self.fsdp_axis, self.tp_axis)

    def activations(self):
        """Runtime activations: batch over data."""
        return P(self.data_axis)

    def spec_for(self, name: str, shape: Sequence[int]):
        """The table row of one parameter name."""
        if name in ("tok_emb", "pos_emb"):
            return self.embeddings()
        if name == "lm_head.w":
            return self.lm_head()
        if name.endswith((".ln1.g", ".ln1.b", ".ln2.g", ".ln2.b")) \
                or name in ("lnf.g", "lnf.b") or name.endswith(".b"):
            return self.norm_or_bias()
        if name.endswith((".q.w", ".k.w", ".v.w")):
            return self.qkv_projection()
        if name.endswith(".o.w"):
            return self.attn_output()
        if name.endswith(".ff1.w"):
            return self.ffn_up()
        if name.endswith(".ff2.w"):
            return self.ffn_down()
        return P()


def _normalize_axes(spec: Union[str, Mapping[str, int], None]
                    ) -> Dict[str, int]:
    """Parse a mesh request: ``"data=2,tp=4"``, ``{"data": 2}`` or None.
    An unknown axis name or a size below 1 is a ValueError."""
    if not spec:
        return {}
    if isinstance(spec, str):
        axes: Dict[str, int] = {}
        for part in spec.replace(";", ",").split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"mesh axis {part!r}: expected name=size "
                                 f"(e.g. 'data=2,tp=4')")
            k, v = part.split("=", 1)
            axes[k.strip()] = int(v)
    else:
        axes = {k: int(v) for k, v in spec.items()}
    for k in axes:
        if k not in SERVING_AXES:
            raise ValueError(f"unknown serving mesh axis {k!r}: "
                             f"expected one of {SERVING_AXES}")
    if any(v < 1 for v in axes.values()):
        raise ValueError(f"mesh axis sizes must be >= 1, got {axes}")
    return axes


def fit_axes(requested: Mapping[str, int], n_devices: int) -> Dict[str, int]:
    """Degrade a requested layout onto ``n_devices``: while the product
    exceeds the device count, halve an axis, ``fsdp`` first, then ``tp``,
    then ``data``.  On one device every axis is 1."""
    sizes = {a: int(requested.get(a, 1)) for a in SERVING_AXES}
    order = (FSDP_AXIS, TP_AXIS, DATA_AXIS)
    while int(np.prod(list(sizes.values()))) > max(int(n_devices), 1):
        for axis in order:
            if sizes[axis] > 1:
                sizes[axis] = sizes[axis] // 2 or 1
                break
        else:  # pragma: no cover - a product of 1s never exceeds n >= 1
            break
    return sizes


def _fit_spec(spec, shape: Sequence[int], axis_sizes: Mapping[str, int]):
    """Collapse a table spec onto a shape and a mesh: axes of size 1 are
    dropped, and an axis that does not divide its dim is dropped from
    that dim; trailing Nones are dropped (the canonical form)."""
    if spec is None:
        return P()
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        dim = int(shape[i]) if i < len(shape) else 0
        kept, factor = [], 1
        for nm in names:
            sz = int(axis_sizes.get(nm, 1))
            if sz <= 1:
                continue
            if dim <= 0 or dim % (factor * sz) != 0:
                continue
            kept.append(nm)
            factor *= sz
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _spec_to_jsonable(spec) -> list:
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            out.append(list(entry))
        else:
            out.append(str(entry))
    return out


def _names(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


class ServingMesh:
    """A resolved serving mesh: the port's ``parallel.Mesh`` over the
    serving axes (or None), the fitted axis sizes and the layout table.

    ``mesh is None`` is the one-device degradation: ``shard_params``
    returns its input and the engine takes its exact single-device
    path."""

    def __init__(self, mesh, axes: Dict[str, int],
                 layout: Optional[SpecLayout] = None):
        self.mesh = mesh
        self.axes = dict(axes)
        self.layout = layout or SpecLayout()
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        _metrics.gauge("serving.mesh.devices").set(float(self.size))
        for a in SERVING_AXES:
            _metrics.labeled_gauge("serving.mesh.axis_size").set(
                float(self.axes.get(a, 1)), axis=a)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.axes.values()))) if self.axes else 1

    def axis(self, name: str) -> int:
        return int(self.axes.get(name, 1))

    def group(self, name: str):
        """The process group of this rank's slice along ``name`` (None for
        an axis of size 1 or the one-device degradation)."""
        if self.mesh is None or self.axis(name) <= 1:
            return None
        return self.mesh.group(name)

    def coord(self, name: str) -> int:
        if self.mesh is None or self.axis(name) <= 1:
            return 0
        return self.mesh.coord(name)

    def heads_shardable(self, n_heads: int) -> bool:
        """Whether the KV arena's and attention's head axis shards over
        ``tp``: tp > 1 and dividing ``n_heads``; otherwise the heads are
        replicated (a partial head shard would split the attention
        contraction)."""
        tp = self.axis(TP_AXIS)
        return tp > 1 and int(n_heads) % tp == 0

    def param_specs(self, shapes: Mapping[str, Sequence[int]]
                    ) -> Dict[str, object]:
        """name -> fitted PartitionSpec for every parameter of ``shapes``."""
        return {n: _fit_spec(self.layout.spec_for(n, s), s, self.axes)
                for n, s in shapes.items()}

    def shard_of(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the full tensor ``t`` under ``spec``: along
        a dim sharded over several axes the block index is row-major over
        them, as a JAX mesh lays such a dim out."""
        for i, entry in enumerate(spec):
            names = _names(entry)
            if not names:
                continue
            n = math.prod(self.axis(a) for a in names)
            idx = 0
            for a in names:
                idx = idx * self.axis(a) + self.coord(a)
            k = t.shape[i] // n
            t = t.narrow(i, idx * k, k)
        return t.contiguous()

    def shard_params(self, params: Mapping[str, object]) -> Dict[str, object]:
        """This rank's shards of a full parameter dict, per the fitted
        table.  The identity on the one-device degradation."""
        if self.mesh is None:
            return dict(params)
        shapes = {n: tuple(np.shape(v)) for n, v in params.items()}
        specs = self.param_specs(shapes)
        with _trace.span("serving.mesh.shard_params", params=len(params)):
            out = {n: self.shard_of(torch.as_tensor(v), specs[n])
                   for n, v in params.items()}
        _metrics.gauge("serving.mesh.params_sharded").set(
            float(sum(1 for n in params if tuple(specs[n]))))
        return out

    def describe(self, shapes: Optional[Mapping[str, Sequence[int]]] = None
                 ) -> str:
        """The canonical sharding descriptor: axis names and sizes (and the
        fitted spec of each parameter of ``shapes``), JSON with sorted
        keys; no rank number appears."""
        d: Dict[str, object] = {
            "axes": [[a, int(self.axes.get(a, 1))] for a in SERVING_AXES]}
        if shapes is not None:
            d["params"] = {n: _spec_to_jsonable(s) for n, s in
                           sorted(self.param_specs(shapes).items())}
        return json.dumps(d, sort_keys=True)

    def summary(self) -> Dict[str, object]:
        """Axis sizes and device count (the scheduler's ``stats()["mesh"]``)."""
        return {"axes": {a: int(self.axes.get(a, 1)) for a in SERVING_AXES},
                "devices": self.size, "sharded": self.mesh is not None}


def make_serving_mesh(spec: Union[str, Mapping[str, int], None] = None,
                      devices: Optional[Sequence[int]] = None,
                      layout: Optional[SpecLayout] = None
                      ) -> Optional[ServingMesh]:
    """The serving mesh of an axis request (``"data=2,tp=4"``, a dict, or
    None / "" = off) over ``devices`` (global ranks; default: every rank of
    the default process group, one device a rank).  None when no mesh was
    requested; a one-device ServingMesh (``mesh is None``) when the request
    collapses to one rank.  Axis order data, fsdp, tp (tp last: its
    slices are adjacent ranks).  Collective, as ``parallel.make_mesh``:
    every rank calls it with the same arguments."""
    axes = _normalize_axes(spec)
    if not axes:
        return None
    from ..parallel import make_mesh
    from ..parallel.mesh import _world

    devices = list(devices if devices is not None else range(_world()[0]))
    fitted = fit_axes(axes, len(devices))
    collapsed = sum(1 for a in axes
                    if int(axes[a]) > 1 and fitted.get(a, 1) < int(axes[a]))
    _metrics.gauge("serving.mesh.collapsed_axes").set(float(collapsed))
    sizes = {a: fitted[a] for a in SERVING_AXES if fitted[a] > 1}
    if not sizes:
        return ServingMesh(None, {}, layout=layout)
    return ServingMesh(make_mesh(sizes, devices=devices), sizes,
                       layout=layout)


def mesh_from_env(env: Optional[Mapping[str, str]] = None
                  ) -> Optional[ServingMesh]:
    """The mesh that ``PADDLE_TPU_SERVING_MESH`` requests (``"data=2,tp=4"``;
    unset or empty: no mesh)."""
    import os

    spec = (env or os.environ).get(MESH_ENV, "")
    return make_serving_mesh(spec) if spec else None


# ------------------------------------------------------------ the model


class ShardedParams(Mapping):
    """The serving LM's parameters on a rank of a ServingMesh: ``params``
    (full tensors under the JAX names, already cast) kept as the rank's
    shards over ``fsdp`` and ``tp``, each read (``[name]``) in the form
    ``models/transformer.py``'s serving forms compute with.  A read
    gathers the parameter over fsdp, as GSPMD does, and gives q, k, v and
    ff1 (weight and bias) as the rank's tp column block and o and ff2 as
    its row block when tp shards the heads (``heads_shardable``) or d_ff;
    the rest whole.  ``heads`` is the rank's head count and ``shard`` the
    forms' tp hooks: the row-parallel products summed over tp, and the
    head vocab-parallel, its logits gathered.  The ``data`` axis is the
    engine's: it hands the model its rows."""

    def __init__(self, params, mesh: ServingMesh, n_heads: int):
        from ..models.transformer import SrvShard

        self.sm = mesh
        self.tp = mesh.axis(TP_AXIS)
        self.tp_group = mesh.group(TP_AXIS)
        heads_tp = mesh.heads_shardable(n_heads)
        self.heads = n_heads // self.tp if heads_tp else n_heads
        ffn_tp = self.tp > 1 and params["blk0.ff1.w"].shape[1] % self.tp == 0
        self.vocab_tp = self.tp > 1 and \
            params["tok_emb"].shape[0] % self.tp == 0
        # name -> the dim of the rank's tp block; the row-parallel weights
        self.tp_dim, self.row = {}, set()
        for n in params:
            part = n.split(".", 1)[-1]
            if (heads_tp and part in ("q.w", "k.w", "v.w")) or (
                    ffn_tp and part in ("ff1.w", "ff1.b")):
                self.tp_dim[n] = 1 if part.endswith(".w") else 0
            elif (heads_tp and part == "o.w") or (ffn_tp and part == "ff2.w"):
                self.tp_dim[n] = 0
                self.row.add(n)
        self.specs = mesh.param_specs({n: tuple(v.shape)
                                       for n, v in params.items()})
        self.shards = mesh.shard_params(params)
        self.shard = SrvShard(self._row_reduce, self._vocab_block,
                              self._head_gather)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.use(name, self.tp_dim.get(name))

    def __iter__(self):
        return iter(self.shards)

    def __len__(self) -> int:
        return len(self.shards)

    def use(self, name: str, tp_dim: Optional[int] = None) -> torch.Tensor:
        """Parameter ``name`` gathered over fsdp, and over tp unless its tp
        block on ``tp_dim`` is wanted (sliced locally when the rank holds
        that dim whole)."""
        from ..parallel import comm

        t = self.shards[name]
        held = None
        for i, entry in enumerate(self.specs[name]):
            names = _names(entry)
            if names == (TP_AXIS,):
                held = i
                continue
            # gather the minor axis first: the block index is row-major
            for a in reversed(names):
                t = comm.all_gather(t, self.sm.group(a), i)
        if held is not None and held != tp_dim:
            t = comm.all_gather(t, self.tp_group, held)
            held = None
        if tp_dim is not None and held is None and self.tp > 1:
            k = t.shape[tp_dim] // self.tp
            t = t.narrow(tp_dim, self.sm.coord(TP_AXIS) * k, k)
        return t

    def _row_reduce(self, name: str, y: torch.Tensor) -> torch.Tensor:
        from ..parallel import comm

        return comm.all_reduce(y, self.tp_group) if name in self.row else y

    def _vocab_block(self, w: torch.Tensor) -> torch.Tensor:
        if not self.vocab_tp:
            return w
        k = w.shape[-1] // self.tp
        return w.narrow(-1, self.sm.coord(TP_AXIS) * k, k)

    def _head_gather(self, y: torch.Tensor) -> torch.Tensor:
        from ..parallel import comm

        return comm.all_gather(y, self.tp_group, y.dim() - 1) \
            if self.vocab_tp else y
