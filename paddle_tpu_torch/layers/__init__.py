"""Layer library (PyTorch port of ``paddle_tpu/layers``).  ``ops``,
``tensor``, ``nn``, ``sequence``, ``beam``, ``control_flow``
(``StaticRNN``, ``DynamicRNN``, ``cond``, ``while_loop``, ``IfElse``,
``recompute``), ``nested``, ``mdlstm`` and ``detection`` are ported whole:
every function of the reference's ``ops.py``, ``tensor.py`` and
``nn.py`` has its counterpart here, the random layers
(``gaussian_random``, ``uniform_random``, ``sampling_id``, ``nce``,
``dropout``) drawing JAX's numbers from the op's key; so are ``misc``
(the reference's 16 tail-parity layers).

Importing this module installs the operator sugar on Variable: ``+ - * /``
and their reflected forms, unary ``-``, ``@`` and ``[]``, each the
reference's layer, so that a program built with the sugar has the
reference's op list.  ``y / x`` with a Python scalar ``y`` is
``elementwise_pow(x, -1.0) * y`` and ``y - x`` is ``scale(x, -1.0,
bias=y)``, as in the reference (two roundings, not one division); ``[]``
indexes as JAX does (``_jax_getitem``)."""
from . import (beam, control_flow, detection, io, mdlstm, misc, nested, nn,
               ops, sequence, tensor)
from .beam import beam_search, beam_search_decode  # noqa: F401
from .control_flow import (DynamicRNN, IfElse, StaticRNN, cond,  # noqa: F401
                           recompute, while_loop)
from .detection import *  # noqa: F401,F403
from .io import data  # noqa: F401
from .mdlstm import md_lstm  # noqa: F401
from .misc import (Print, cos_sim_vec_mat, cross_channel_norm,  # noqa: F401
                   cross_entropy_over_beam, data_norm, dot_prod, eos_check,
                   factorization_machine, featuremap_expand, kmax_seq_score,
                   l2_normalize, outer_prod, rotate, scale_shift,
                   scale_sub_region, sequence_reshape)
from .nested import (NestedDynamicRNN, nested_sequence_expand,  # noqa: F401
                     nested_sequence_first_step, nested_sequence_last_step,
                     nested_sequence_pool, nested_sequence_select,
                     nested_to_flat)
from .sequence import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

import builtins as _builtins  # noqa: E402  (the layers shadow abs, min, max)

from ..core.program import Variable as _Variable  # noqa: E402


def _clamp_index(i: int, n: int):
    """A static integer index as JAX's gather reads it: a negative one
    counts from the end once, then it is clamped into [0, n - 1] (torch
    raises where JAX clamps).  Returns (the index, whether it was in
    range): JAX's gather transpose drops a clamped index's gradient."""
    i = int(i)
    if i < 0:
        i += n
    return _builtins.min(_builtins.max(i, 0), n - 1), 0 <= i < n


def _jax_getitem(a, item, moved=None):
    """``a[item]`` with JAX's rules for a static index: ints and integer
    arrays clamped (``_clamp_index``: the value read at the clamped
    position, no gradient back through a clamped index), slices clamped at
    both ends as Python's are (a negative step by a flip), ``None`` a new
    axis and ``Ellipsis`` the dims not named.  Slices and ints are views;
    an integer array is an ``index_select`` whose index tensor is moved to
    the device once (``moved``, a dict per op), so a captured step copies
    nothing from the host."""
    import numpy as np
    import torch

    moved = {} if moved is None else moved
    items = list(item) if isinstance(item, tuple) else [item]
    n_named = _builtins.sum(1 for it in items
                            if it is not None and it is not Ellipsis)
    if any(it is Ellipsis for it in items):
        k = items.index(Ellipsis)
        items[k:k + 1] = [slice(None)] * (a.dim() - n_named)
    out, dim = a, 0
    for it in items:
        if it is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(it, slice):
            idx = range(*it.indices(out.shape[dim]))
            step = _builtins.abs(idx.step)
            if len(idx) == 0:
                out = out.narrow(dim, 0, 0)
            else:
                lo = _builtins.min(idx[0], idx[-1])
                out = out.narrow(dim, lo, (len(idx) - 1) * step + 1)
                if idx.step < 0:
                    out = out.flip(dim)
                if step > 1:
                    out = out[(slice(None),) * dim
                              + (slice(None, None, step),)]
            dim += 1
        elif isinstance(it, (int, np.integer)) and not isinstance(it, bool):
            i, ok = _clamp_index(it, out.shape[dim])
            out = out.select(dim, i)
            if not ok:
                out = out.detach()
        else:
            arr = np.asarray(it)
            if arr.dtype.kind not in "iu":
                raise TypeError(f"Variable[{item!r}]: only ints, integer "
                                f"arrays, slices, None and Ellipsis index "
                                f"a Variable")
            n = out.shape[dim]
            key = (a.device, dim, n)
            if key not in moved:
                pairs = [_clamp_index(i, n) for i in arr.reshape(-1)]
                shape = [1] * out.dim()
                shape[dim] = len(pairs)
                moved[key] = (
                    torch.tensor([p[0] for p in pairs], dtype=torch.long,
                                 device=a.device),
                    None if all(p[1] for p in pairs) else torch.tensor(
                        [p[1] for p in pairs], device=a.device).reshape(
                            shape))
            index, ok = moved[key]
            sel = out.index_select(dim, index)
            if ok is not None:
                sel = torch.where(ok, sel, sel.detach())
            out = sel.reshape(tuple(out.shape[:dim]) + arr.shape
                              + tuple(out.shape[dim + 1:]))
            dim += arr.ndim
    return out


def _install_math_hooks():
    from . import tensor as t

    def _getitem(x, item):
        from .helper import LayerHelper

        helper = LayerHelper("slice")
        return helper.append_op(
            lambda ctx, a, _moved={}: _jax_getitem(a, item, _moved),
            {"X": [x]}, op_type="slice")

    hooks = {
        "add": lambda x, y: t.elementwise_add(x, y),
        "sub": lambda x, y: t.elementwise_sub(x, y),
        "rsub": lambda x, y: t.scale(x, scale=-1.0, bias=float(y))
        if not isinstance(y, _Variable) else t.elementwise_sub(y, x),
        "mul": lambda x, y: t.elementwise_mul(x, y),
        "div": lambda x, y: t.elementwise_div(x, y),
        "rdiv": lambda x, y: t.elementwise_pow(x, -1.0) * float(y)
        if not isinstance(y, _Variable) else t.elementwise_div(y, x),
        "neg": lambda x: t.scale(x, scale=-1.0),
        "matmul": lambda x, y: t.matmul(x, y),
        "getitem": _getitem,
    }
    _Variable._math_hook.update(hooks)


_install_math_hooks()
