"""Optimizers as in-program update ops (PyTorch port of the
``paddle_tpu/optimizer.py`` subset the training slices use: the base class
with ``minimize`` on the ``accumulate_steps == 1`` path, ``SGD``,
``Momentum`` and ``Adam``).

The optimizer is part of the program: after the backward op come the
``grad_clip`` op (when a clipper is given), one update op per parameter and
the ``increment`` of the step counter.  Accumulators (moments, the step) are
persistable scope vars initialised by the startup program.  Update ops
return new tensors; the Executor puts them in the scope in place of the old.

Each update op names its group, the optimizer that made it (``Op.group``).
The Executor runs each run of consecutive update ops of one group as one
call of ``apply_group``: the same rule over lists of tensors
(``_update_group``, written with ``torch._foreach_*`` in ``_update``'s
expression order, so that on the CPU it is bitwise equal to the per-op
rule), a few multi-tensor kernels in place of one chain of elementwise
kernels per parameter.

Not ported yet, and refused: ``accumulate_steps > 1`` (ROADMAP A.6,
gradient accumulation), regularization (A.6, regularizers) and parameter
update hooks (A.6, hooks).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .backward import append_backward
from .core import unique_name
from .core.program import Op, Program, Variable, default_startup_program

LRType = Union[float, Callable]


class Optimizer:
    _accum_defaults: Dict[str, float] = {}

    def __init__(self, learning_rate: LRType = 0.001, regularization=None, grad_clip=None,
                 global_step: Optional[Variable] = None, name: Optional[str] = None,
                 accumulate_steps: int = 1):
        self._lr = learning_rate
        if regularization is not None:
            raise NotImplementedError(
                "Optimizer(regularization=...) is not ported yet: "
                "regularizers are ROADMAP A.6")
        self._grad_clip = grad_clip
        self._name = name or unique_name.generate(type(self).__name__.lower())
        self._step_name = f"{self._name}.step"
        self._lr_mults: Dict[str, float] = {}  # parameter -> lr multiplier
        if int(accumulate_steps) != accumulate_steps or accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be a positive integer, "
                             f"got {accumulate_steps!r}")
        if accumulate_steps > 1:
            raise NotImplementedError(
                "accumulate_steps > 1 is not ported yet: gradient "
                "accumulation is ROADMAP A.6")

    # ------------------------------------------------------------------ helpers
    def _ensure_var(self, name, shape, dtype, fill=0.0):
        """persistable accumulator in main program + constant init in startup."""
        block = self._main_program.global_block
        if block.has_var(name):
            return block.var(name)
        v = block.create_var(name, shape, dtype, persistable=True)
        sblock = self._startup_program.global_block
        if not sblock.has_var(name):
            sblock.create_var(name, shape, dtype, persistable=True)
            shape_t = tuple(int(s) for s in shape)

            def init_fn(ins, attrs, ctx, _s=shape_t, _d=v.dtype, _f=fill):
                return {"Out": [torch.full(_s, _f, dtype=_d, device=ctx.device)]}

            sblock.append_op(Op("init", {}, {"Out": [name]}, {}, init_fn))
        return v

    def _accumulators_for(self, param: Variable) -> List[Tuple[str, Variable]]:
        out = []
        for aname, fill in self._accum_defaults.items():
            v = self._ensure_var(f"{param.name}.{self._name}.{aname}", param.shape,
                                 param.dtype, fill)
            out.append((aname, v))
        return out

    def _lr_value(self, step):
        lr = self._lr
        if callable(lr):
            return lr(step)
        return lr

    # ------------------------------------------------------------------ the rule
    def _update(self, param, grad, accums: Dict[str, torch.Tensor], lr, t):
        """Return (new_param, new_accums).  Subclasses implement."""
        raise NotImplementedError

    def _update_group(self, params: List[torch.Tensor],
                      grads: List[torch.Tensor],
                      accums: Dict[str, List[torch.Tensor]], lr, t):
        """``_update`` over lists (parameters of one dtype and learning-rate
        multiplier), in its expression order: return (new_params,
        new_accums).  Subclasses implement."""
        raise NotImplementedError

    def apply_group(self, ops: Sequence[Op], env: Dict[str, Any],
                    ctx) -> None:
        """Run ``ops``, consecutive update ops of this optimizer, on
        ``env``: one ``_update_group`` call per (dtype, device,
        learning-rate multiplier) of their parameters, each op's inputs
        read (and cast by the amp policy) as ``Op.apply`` reads them."""
        keys = list(self._accum_defaults)
        parts: Dict[tuple, list] = {}
        for op in ops:
            ins = op.read(env, ctx)
            p = ins["Param"][0]
            mult = self._lr_mults[op.inputs["Param"][0]]
            parts.setdefault((p.dtype, p.device, mult), []).append((op, ins))
        for (dtype, _, mult), members in parts.items():
            step = members[0][1]["Step"][0][0]
            lr = self._lr_value(step) * mult
            t = (step + 1).to(dtype)
            new_ps, new_accs = self._update_group(
                [ins["Param"][0] for _, ins in members],
                [ins["Grad"][0] for _, ins in members],
                {k: [ins["Accums"][i] for _, ins in members]
                 for i, k in enumerate(keys)}, lr, t)
            for j, (op, _) in enumerate(members):
                op.write(env, {"Out": [new_ps[j]]
                               + [new_accs[k][j] for k in keys]})

    # ------------------------------------------------------------------ minimize
    def minimize(
        self,
        loss: Variable,
        startup_program: Optional[Program] = None,
        parameter_list: Optional[Sequence[str]] = None,
        no_grad_set: Optional[set] = None,
    ):
        program = loss.program
        self._main_program = program
        self._startup_program = startup_program or default_startup_program()
        block = program.global_block
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        for p, _ in params_grads:
            if p.regularizer is not None:
                raise NotImplementedError(
                    f"parameter {p.name!r} carries a regularizer: "
                    f"regularizers are ROADMAP A.6")

        # --- gradient clipping (global-norm needs every grad in one op)
        if self._grad_clip is not None:
            gnames = [g.name for _, g in params_grads]

            def clip_fn(ins, attrs, ctx, _clip=self._grad_clip,
                        _names=tuple(gnames)):
                out = _clip.transform(dict(zip(_names, ins["Grads"])))
                return {"Out": [out[n] for n in _names]}

            block.append_op(Op("grad_clip", {"Grads": gnames}, {"Out": gnames},
                               {"is_optimizer_op": True}, clip_fn))

        # --- per-param update ops
        step_var = self._ensure_var(self._step_name, (1,), "int32", 0)
        for p, g in params_grads:
            accums = self._accumulators_for(p)
            lr_mult = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
            self._lr_mults[p.name] = lr_mult
            acc_names = [v.name for _, v in accums]
            acc_keys = [k for k, _ in accums]

            def upd_fn(ins, attrs, ctx, _keys=tuple(acc_keys), _mult=lr_mult):
                param_v = ins["Param"][0]
                grad_v = ins["Grad"][0]
                step = ins["Step"][0][0]
                accs = dict(zip(_keys, ins["Accums"]))
                lr = self._lr_value(step) * _mult
                t = (step + 1).to(param_v.dtype)
                new_p, new_accs = self._update(param_v, grad_v, accs, lr, t)
                return {"Out": [new_p] + [new_accs[k] for k in _keys]}

            block.append_op(
                Op(type(self).__name__.lower(),
                   {"Param": [p.name], "Grad": [g.name], "Accums": acc_names,
                    "Step": [step_var.name]},
                   {"Out": [p.name] + acc_names},
                   {"is_optimizer_op": True},
                   upd_fn, group=self)
            )

        # --- advance the step counter
        def inc_fn(ins, attrs, ctx):
            return {"Out": [ins["X"][0] + 1]}

        block.append_op(Op("increment", {"X": [step_var.name]}, {"Out": [step_var.name]},
                           {"is_optimizer_op": True}, inc_fn))
        return None, params_grads


# ----------------------------------------------------------------------- rules


class SGD(Optimizer):
    """ref: paddle/operators/sgd_op.cc."""

    def _update(self, p, g, a, lr, t):
        return p - lr * g, a

    def _update_group(self, ps, gs, a, lr, t):
        return torch._foreach_sub(ps, torch._foreach_mul(gs, lr)), a


class Momentum(Optimizer):
    """ref: paddle/operators/momentum_op.cc.  The JAX package's rule, one
    ``velocity`` accumulator: v = m * v + g; p -= lr * v, or with Nesterov
    p -= lr * (g + m * v) (``torch.optim.SGD``'s dampening and Nesterov
    forms are not used)."""

    _accum_defaults = {"velocity": 0.0}

    def __init__(self, learning_rate, momentum: float = 0.9,
                 use_nesterov: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, p, g, a, lr, t):
        v = self._momentum * a["velocity"] + g
        if self._nesterov:
            return p - lr * (g + self._momentum * v), {"velocity": v}
        return p - lr * v, {"velocity": v}

    def _update_group(self, ps, gs, a, lr, t):
        mu = self._momentum
        v = torch._foreach_add(torch._foreach_mul(a["velocity"], mu), gs)
        d = torch._foreach_add(gs, torch._foreach_mul(v, mu)) \
            if self._nesterov else v
        return torch._foreach_sub(ps, torch._foreach_mul(d, lr)), \
            {"velocity": v}


class Adam(Optimizer):
    """ref: paddle/operators/adam_op.cc.  The JAX package's rule: epsilon is
    added outside sqrt(vhat), and t = step + 1 in the parameter's dtype
    (``torch.optim.Adam`` places epsilon elsewhere and is not used)."""

    _accum_defaults = {"moment1": 0.0, "moment2": 0.0}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _update(self, p, g, a, lr, t):
        m = self._b1 * a["moment1"] + (1 - self._b1) * g
        v = self._b2 * a["moment2"] + (1 - self._b2) * torch.square(g)
        mhat = m / (1 - torch.pow(self._b1, t))
        vhat = v / (1 - torch.pow(self._b2, t))
        return p - lr * mhat / (torch.sqrt(vhat) + self._eps), {"moment1": m, "moment2": v}

    def _update_group(self, ps, gs, a, lr, t):
        b1, b2 = self._b1, self._b2
        m = torch._foreach_add(torch._foreach_mul(a["moment1"], b1),
                               torch._foreach_mul(gs, 1 - b1))
        # square(g) is g * g, bit for bit
        v = torch._foreach_add(torch._foreach_mul(a["moment2"], b2),
                               torch._foreach_mul(torch._foreach_mul(gs, gs),
                                                  1 - b2))
        mhat = torch._foreach_div(m, 1 - torch.pow(b1, t))
        vhat = torch._foreach_div(v, 1 - torch.pow(b2, t))
        denom = torch._foreach_add(torch._foreach_sqrt(vhat), self._eps)
        new_p = torch._foreach_sub(
            ps, torch._foreach_div(torch._foreach_mul(mhat, lr), denom))
        return new_p, {"moment1": m, "moment2": v}

