"""Row-touched optimizer apply, the sparse half of the train step (PyTorch
port of ``paddle_tpu/sparse/update.py``).

The gradient of a step's gathered unique rows is a ``[bucket, D]`` buffer;
the dense ``[V, D]`` gradient never exists.  The touched parameter rows and
their optimizer slot rows are gathered, the optimizer's own ``_update``
runs on them, and both are written back in place.  Bit-exactness on the
touched rows is by construction: the same ``_update`` the dense path calls,
on the same (row, grad, slot) values.  Untouched rows are never read or
written (for Adam, lazy Adam: no decay on absent ids); the dead bucket
slots and ``padding_idx`` carry the sentinel id, whose writes land in the
storages' scratch row (``table.scatter_index``), and the live uids are
unique, so the scatter has one writer per row.

``count_dense_materializations`` has no jaxpr to walk in the port: it runs
the step once under a ``TorchDispatchMode`` and counts the ops that return
a fresh tensor of the table's shape.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .table import gather_index, scatter_index


def segment_rows(cot, inv, bucket: int):
    """Sum output cotangents ``cot`` [..., D] into per-unique-row gradients
    [bucket, D] by the inverse indices ``inv`` [...] from dedup: what the
    backward of ``rows[inv]`` gives, through ``embedding_dense_backward``
    (its fixed order of adds, no atomics)."""
    cot = torch.as_tensor(cot)
    d = cot.shape[-1]
    return torch.ops.aten.embedding_dense_backward(
        cot.reshape(-1, d).contiguous(),
        torch.as_tensor(inv).reshape(-1).long(), int(bucket), -1, False)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` (in range) of ``table``, through ``F.embedding``."""
    return torch.nn.functional.embedding(idx, table)


class RowTouchedOptimizer:
    """Wraps an ``optimizer.Optimizer`` and applies its ``_update`` rule to
    touched rows only.  The optimizer is used as a rule object
    (``_update``, ``_accum_defaults``, ``_lr_value``); none of its
    program-building runs.  ``lr`` and ``t`` are tensors on the table's
    device, so a captured step reads the values staged for each replay."""

    def __init__(self, opt):
        self.opt = opt
        self.slot_names = tuple(sorted(type(opt)._accum_defaults))

    def init_slots(self, table) -> Dict[str, torch.Tensor]:
        """A ``[V + 1, D]`` slot storage per accumulator (the table's
        layout, scratch row included), filled with the optimizer's
        default, on the table's device."""
        defaults = type(self.opt)._accum_defaults
        return {a: torch.full(tuple(table.storage.shape), float(defaults[a]),
                              dtype=table.storage.dtype,
                              device=table.storage.device)
                for a in self.slot_names}

    def apply_rows(self, storage, slots: Dict[str, torch.Tensor], uids,
                   row_grad, lr, t):
        """One row-touched apply, in place.  ``storage`` and each slot are
        ``[V + 1, D]`` (the last row scratch), ``uids`` [bucket] (the
        sentinel ``V`` in dead slots), ``row_grad`` [bucket, D].  The rows
        gather as JAX's clip reads them, and scatter back as JAX's drop
        writes them, the dropped writes into the scratch row.  Returns
        (storage, slots)."""
        vocab = storage.shape[0] - 1
        uids = torch.as_tensor(uids, device=storage.device)
        gi, si = gather_index(uids, vocab), scatter_index(uids, vocab)
        rows = _rows(storage[:vocab], gi)
        srows = {k: _rows(slots[k][:vocab], gi) for k in self.slot_names}
        new_rows, new_srows = self.opt._update(rows, row_grad, srows, lr, t)
        storage.index_copy_(0, si, new_rows)
        for k in self.slot_names:
            slots[k].index_copy_(0, si, new_srows[k])
        return storage, slots


# ------------------------------------------------- dense-parameter mirror


def init_dense_state(opt, params: Dict[str, torch.Tensor]):
    """Accumulators for a dict of dense (non-table) parameters, with the
    optimizer's own defaults."""
    defaults = type(opt)._accum_defaults
    return {k: {a: torch.full_like(p, f) for a, f in defaults.items()}
            for k, p in params.items()}


def apply_dense(opt, params, grads, state, lr, t):
    """``opt._update`` over every dense parameter (the tower weights of a
    CTR model).  Returns (new params, new state)."""
    new_p, new_s = {}, {}
    for k, p in params.items():
        new_p[k], new_s[k] = opt._update(p, grads[k], state[k], lr, t)
    return new_p, new_s


# ------------------------------------------- dense-materialization probe


class _FreshCounter(TorchDispatchMode):
    def __init__(self, shapes):
        super().__init__()
        self.shapes = shapes
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = set()
        for a in torch.utils._pytree.tree_leaves((args, kwargs)):
            if isinstance(a, torch.Tensor):
                ins.add(a.untyped_storage().data_ptr())
        for o in torch.utils._pytree.tree_leaves(out):
            if (isinstance(o, torch.Tensor) and tuple(o.shape) in self.shapes
                    and o.untyped_storage().data_ptr() not in ins):
                self.count += 1
        return out


def count_dense_materializations(fn, shape, *example_args) -> int:
    """Run ``fn(*example_args)`` once under a ``TorchDispatchMode`` and count
    the ops (the backward's included) that return a fresh tensor of the
    table's ``shape`` [V, D] or of its storage's [V + 1, D]: not written in
    place and not a view of an input.  That is the signature of a dense
    gradient or temporary; writing rows into the existing table is not.
    The sparse step reads 0 and the dense arm more than 0, the reference's
    two-sided pin.  ``fn`` runs: give it state it may change."""
    shape = tuple(int(s) for s in shape)
    shapes = {shape, (shape[0] + 1,) + shape[1:]}
    with _FreshCounter(shapes) as mode:
        fn(*example_args)
    return mode.count
