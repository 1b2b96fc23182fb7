"""Optimizers as in-program update ops (PyTorch port of
``paddle_tpu/optimizer.py``): the base class with ``minimize``, SGD,
Momentum, Adagrad, Adam, Adamax, Adadelta, RMSProp, DecayedAdagrad, Ftrl,
ProximalGD, ProximalAdagrad and ModelAverage.

The optimizer is part of the program: after the backward op come, in the
reference's order, the ``grad_accumulate`` / ``grad_eff`` pair of each
parameter (``accumulate_steps > 1``), the ``update_hook`` ops (parameters
with a ``StaticPruningHook``), the ``regularize`` ops (a parameter's own
regularizer wins over the optimizer's), the ``grad_clip`` op (when a
clipper is given), one update op per parameter and the ``increment`` of
the step counter.  Accumulators (moments, the step, accumulated
gradients) are persistable scope vars initialised by the startup program.
Update ops return new tensors; the Executor puts them in the scope in
place of the old.

The learning rate is a float or a schedule (``learning_rate_decay``), a
callable from the step, a 0-d int32 tensor on the step's device, to a 0-d
float32 tensor there; every rule takes either.  Under accumulation the
reference gates each op with ``lax.cond`` on the step; here each gated op
computes its result and ``torch.where`` keeps the old value on the N - 1
micro-steps of N that do not apply, so no branch reads the step on the
host and a warmed step's graph holds them all.  The schedule and the bias
correction count applies, as in the reference.

Each update op names its group, the optimizer that made it (``Op.group``).
The Executor runs each run of consecutive update ops of one group as one
call of ``apply_group``: the same rule over lists of tensors
(``_update_group``, written with ``torch._foreach_*`` in ``_update``'s
expression order, so that on the CPU it is bitwise equal to the per-op
rule), a few multi-tensor kernels in place of one chain of elementwise
kernels per parameter.  Ftrl, ProximalGD and ProximalAdagrad have no
multi-tensor form (their sign, where and power steps) and loop over
``_update``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .backward import append_backward
from .core import unique_name
from .core.program import (Op, Program, Variable, default_main_program,
                           default_startup_program)

LRType = Union[float, Callable]


class Optimizer:
    _accum_defaults: Dict[str, float] = {}

    def __init__(self, learning_rate: LRType = 0.001, regularization=None, grad_clip=None,
                 global_step: Optional[Variable] = None, name: Optional[str] = None,
                 accumulate_steps: int = 1):
        """``accumulate_steps=N``: every run adds the raw mean gradient into
        a persistable accumulator; hooks, regularization, clipping and the
        update rule act only on each N-th run, on the accumulated gradient
        (so global-norm clipping sees the big batch's gradient).  The
        schedule advances per apply, not per micro-batch."""
        self._lr = learning_rate
        self._regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or unique_name.generate(type(self).__name__.lower())
        self._step_name = f"{self._name}.step"
        self._lr_mults: Dict[str, float] = {}  # parameter -> lr multiplier
        if int(accumulate_steps) != accumulate_steps or accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be a positive integer, "
                             f"got {accumulate_steps!r}")
        self._accumulate = int(accumulate_steps)

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

    def _schedule(self, step, dtype, mult):
        """(lr, t, apply) of an update at the optimizer step ``step``: the
        learning rate times the parameter's multiplier, the bias-correction
        count t in ``dtype``, and, under accumulation, the 0-d bool that is
        true on the micro-steps that apply (None without accumulation).
        Under accumulation lr and t count applies."""
        n = self._accumulate
        if n == 1:
            return self._lr_value(step) * mult, (step + 1).to(dtype), None
        applies = (step + 1) // n
        lr = self._lr_value(torch.clamp_min(applies - 1, 0)) * mult
        return lr, applies.to(dtype), (step + 1) % n == 0

    # ------------------------------------------------------------------ the rule
    def _update(self, param, grad, accums: Dict[str, torch.Tensor], lr, t):
        """Return (new_param, new_accums).  Subclasses implement."""
        raise NotImplementedError

    def _update_group(self, params: List[torch.Tensor],
                      grads: List[torch.Tensor],
                      accums: Dict[str, List[torch.Tensor]], lr, t):
        """``_update`` over lists (parameters of one dtype and learning-rate
        multiplier), in its expression order: return (new_params,
        new_accums).  This default loops over ``_update``; a rule with a
        multi-tensor form overrides it."""
        new_ps, new_accs = [], {k: [] for k in accums}
        for j, (p, g) in enumerate(zip(params, grads)):
            np_, na = self._update(p, g, {k: v[j] for k, v in accums.items()},
                                   lr, t)
            new_ps.append(np_)
            for k in accums:
                new_accs[k].append(na[k])
        return new_ps, new_accs

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
            lr, t, apply = self._schedule(step, dtype, mult)
            olds = [[ins["Param"][0]] + list(ins["Accums"])
                    for _, ins in members]
            new_ps, new_accs = self._update_group(
                [old[0] for old in olds],
                [ins["Grad"][0] for _, ins in members],
                {k: [old[1 + i] for old in olds] for i, k in enumerate(keys)},
                lr, t)
            for j, (op, _) in enumerate(members):
                outs = [new_ps[j]] + [new_accs[k][j] for k in keys]
                op.write(env, {"Out": _gate(apply, outs, olds[j])})

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

        # --- gradient accumulation: every run adds the raw mean gradient
        #     into a persistable accumulator (reset on the first micro-step
        #     of a cycle); the rest of the chain reads a fresh effective
        #     gradient, the accumulator on apply steps and zeros otherwise
        N = self._accumulate
        if N > 1:
            step_for_acc = self._ensure_var(self._step_name, (1,), "int32", 0)
            gated = []
            for p, g in params_grads:
                acc = self._ensure_var(f"{p.name}.{self._name}.grad_acc",
                                       p.shape, p.dtype, 0.0)

                def acc_fn(ins, attrs, ctx, _N=N):
                    step = ins["Step"][0][0]
                    a = torch.where(step % _N == 0,
                                    torch.zeros_like(ins["Acc"][0]),
                                    ins["Acc"][0])
                    return {"Out": [a + ins["Grad"][0] / float(_N)]}

                block.append_op(Op("grad_accumulate",
                                   {"Acc": [acc.name], "Grad": [g.name],
                                    "Step": [step_for_acc.name]},
                                   {"Out": [acc.name]},
                                   {"is_optimizer_op": True}, acc_fn))
                eff = block.create_var(
                    unique_name.generate(f"{p.name}.{self._name}.grad_eff"),
                    p.shape, p.dtype)

                def eff_fn(ins, attrs, ctx, _N=N):
                    step = ins["Step"][0][0]
                    a = ins["Acc"][0]
                    return {"Out": [torch.where((step + 1) % _N == 0, a,
                                                torch.zeros_like(a))]}

                block.append_op(Op("grad_eff",
                                   {"Acc": [acc.name],
                                    "Step": [step_for_acc.name]},
                                   {"Out": [eff.name]},
                                   {"is_optimizer_op": True}, eff_fn))
                gated.append((p, eff))
            params_grads = gated

        # --- update hooks: mask gradients first, so pruned coordinates see
        #     zero gradient from step 0 (the reference's update()-time dotMul)
        for p, g in params_grads:
            if getattr(p, "update_hook", None) is None:
                continue
            from .hooks import mask_name

            def hook_fn(ins, attrs, ctx, _N=N):
                g_v = ins["Grad"][0]
                out = g_v * ins["Mask"][0]
                if _N > 1:
                    out = torch.where(_applies(ins, _N), out, g_v)
                return {"Out": [out]}

            hook_ins = {"Grad": [g.name], "Mask": [mask_name(p.name)]}
            if N > 1:
                hook_ins["Step"] = [self._step_name]
            block.append_op(Op("update_hook", hook_ins,
                               {"Out": [g.name]}, {"is_optimizer_op": True},
                               hook_fn))

        # --- regularization (a parameter's own regularizer wins over the
        #     optimizer's; ref fluid/regularizer.py append_regularization_ops)
        for p, g in params_grads:
            reg = p.regularizer or self._regularization
            if reg is None:
                continue

            def reg_fn(ins, attrs, ctx, _reg=reg, _N=N):
                g_v = ins["Grad"][0]
                out = g_v + _reg.grad_term(ins["Param"][0])
                if _N > 1:
                    out = torch.where(_applies(ins, _N), out, g_v)
                return {"Out": [out]}

            reg_ins = {"Param": [p.name], "Grad": [g.name]}
            if N > 1:
                reg_ins["Step"] = [self._step_name]
            block.append_op(Op("regularize", reg_ins,
                               {"Out": [g.name]}, {"is_optimizer_op": True},
                               reg_fn))

        # --- gradient clipping (global-norm needs every grad in one op)
        if self._grad_clip is not None:
            gnames = [g.name for _, g in params_grads]

            def clip_fn(ins, attrs, ctx, _clip=self._grad_clip,
                        _names=tuple(gnames), _N=N):
                gs = ins["Grads"]
                out = _clip.transform(dict(zip(_names, gs)))
                outs = [out[n] for n in _names]
                if _N > 1:
                    outs = _gate(_applies(ins, _N), outs, gs)
                return {"Out": outs}

            clip_ins = {"Grads": gnames}
            if N > 1:
                clip_ins["Step"] = [self._step_name]
            block.append_op(Op("grad_clip", clip_ins, {"Out": gnames},
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
                step = ins["Step"][0][0]
                accs = dict(zip(_keys, ins["Accums"]))
                lr, t, apply = self._schedule(step, param_v.dtype, _mult)
                new_p, new_accs = self._update(param_v, ins["Grad"][0], accs,
                                               lr, t)
                outs = [new_p] + [new_accs[k] for k in _keys]
                return {"Out": _gate(apply, outs,
                                     [param_v] + list(ins["Accums"]))}

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


def _applies(ins, n: int):
    """True (a 0-d bool tensor) on the micro-steps that apply."""
    return (ins["Step"][0][0] + 1) % n == 0


def _gate(apply, new: List[torch.Tensor], old: List[torch.Tensor]):
    """``new`` where ``apply`` (a 0-d bool tensor), else ``old``; ``new``
    as it is when ``apply`` is None."""
    if apply is None:
        return list(new)
    return [torch.where(apply, a, b) for a, b in zip(new, old)]


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


class Adagrad(Optimizer):
    """ref: paddle/operators/adagrad_op.cc."""

    _accum_defaults = {"moment": 0.0}

    def __init__(self, learning_rate, epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._eps = epsilon

    def _update(self, p, g, a, lr, t):
        m = a["moment"] + torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self._eps), {"moment": m}

    def _update_group(self, ps, gs, a, lr, t):
        m = torch._foreach_add(a["moment"], torch._foreach_mul(gs, gs))
        denom = torch._foreach_add(torch._foreach_sqrt(m), self._eps)
        return torch._foreach_sub(ps, torch._foreach_div(
            torch._foreach_mul(gs, lr), denom)), {"moment": m}


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


class Adamax(Optimizer):
    """ref: paddle/operators/adamax_op.cc."""

    _accum_defaults = {"moment": 0.0, "inf_norm": 0.0}

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _update(self, p, g, a, lr, t):
        m = self._b1 * a["moment"] + (1 - self._b1) * g
        u = torch.maximum(self._b2 * a["inf_norm"], torch.abs(g) + self._eps)
        lr_t = lr / (1 - torch.pow(self._b1, t))
        return p - lr_t * m / u, {"moment": m, "inf_norm": u}

    def _update_group(self, ps, gs, a, lr, t):
        b1 = self._b1
        m = torch._foreach_add(torch._foreach_mul(a["moment"], b1),
                               torch._foreach_mul(gs, 1 - b1))
        u = torch._foreach_maximum(
            torch._foreach_mul(a["inf_norm"], self._b2),
            torch._foreach_add(torch._foreach_abs(gs), self._eps))
        lr_t = lr / (1 - torch.pow(b1, t))
        return torch._foreach_sub(ps, torch._foreach_div(
            torch._foreach_mul(m, lr_t), u)), {"moment": m, "inf_norm": u}


class Adadelta(Optimizer):
    """ref: paddle/operators/adadelta_op.cc."""

    _accum_defaults = {"avg_squared_grad": 0.0, "avg_squared_update": 0.0}

    def __init__(self, learning_rate=1.0, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._eps, self._rho = epsilon, rho

    def _update(self, p, g, a, lr, t):
        g2 = self._rho * a["avg_squared_grad"] + (1 - self._rho) * torch.square(g)
        upd = -torch.sqrt((a["avg_squared_update"] + self._eps)
                          / (g2 + self._eps)) * g
        u2 = self._rho * a["avg_squared_update"] + (1 - self._rho) * torch.square(upd)
        return p + lr * upd, {"avg_squared_grad": g2, "avg_squared_update": u2}

    def _update_group(self, ps, gs, a, lr, t):
        rho, eps = self._rho, self._eps
        asu = a["avg_squared_update"]
        g2 = torch._foreach_add(
            torch._foreach_mul(a["avg_squared_grad"], rho),
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - rho))
        upd = torch._foreach_mul(torch._foreach_neg(torch._foreach_sqrt(
            torch._foreach_div(torch._foreach_add(asu, eps),
                               torch._foreach_add(g2, eps)))), gs)
        u2 = torch._foreach_add(
            torch._foreach_mul(asu, rho),
            torch._foreach_mul(torch._foreach_mul(upd, upd), 1 - rho))
        return torch._foreach_add(ps, torch._foreach_mul(upd, lr)), \
            {"avg_squared_grad": g2, "avg_squared_update": u2}


class RMSProp(Optimizer):
    """ref: paddle/operators/rmsprop_op.cc (with momentum, as in the
    reference)."""

    _accum_defaults = {"mean_square": 0.0, "moment": 0.0}

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._eps, self._momentum = rho, epsilon, momentum

    def _update(self, p, g, a, lr, t):
        ms = self._rho * a["mean_square"] + (1 - self._rho) * torch.square(g)
        mom = self._momentum * a["moment"] + lr * g / torch.sqrt(ms + self._eps)
        return p - mom, {"mean_square": ms, "moment": mom}

    def _update_group(self, ps, gs, a, lr, t):
        rho = self._rho
        ms = torch._foreach_add(
            torch._foreach_mul(a["mean_square"], rho),
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - rho))
        mom = torch._foreach_add(
            torch._foreach_mul(a["moment"], self._momentum),
            torch._foreach_div(torch._foreach_mul(gs, lr), torch._foreach_sqrt(
                torch._foreach_add(ms, self._eps))))
        return torch._foreach_sub(ps, mom), {"mean_square": ms, "moment": mom}


class DecayedAdagrad(Optimizer):
    """ref: paddle/operators/decayed_adagrad_op.cc."""

    _accum_defaults = {"moment": 0.0}

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._eps = decay, epsilon

    def _update(self, p, g, a, lr, t):
        m = self._decay * a["moment"] + (1 - self._decay) * torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self._eps), {"moment": m}

    def _update_group(self, ps, gs, a, lr, t):
        d = self._decay
        m = torch._foreach_add(
            torch._foreach_mul(a["moment"], d),
            torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - d))
        denom = torch._foreach_add(torch._foreach_sqrt(m), self._eps)
        return torch._foreach_sub(ps, torch._foreach_div(
            torch._foreach_mul(gs, lr), denom)), {"moment": m}


class Ftrl(Optimizer):
    """ref: paddle/operators/ftrl_op.cc.  No multi-tensor form: the grouped
    call loops over ``_update``."""

    _accum_defaults = {"squared": 0.0, "linear": 0.0}

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _update(self, p, g, a, lr, t):
        n, z = a["squared"], a["linear"]
        new_n = n + torch.square(g)
        sigma = (torch.pow(new_n, -self._lr_power)
                 - torch.pow(n, -self._lr_power)) / lr
        new_z = z + g - sigma * p
        new_p = torch.where(
            torch.abs(new_z) > self._l1,
            (self._l1 * torch.sign(new_z) - new_z)
            / ((torch.pow(new_n, -self._lr_power)) / lr + 2 * self._l2),
            torch.zeros_like(p),
        )
        return new_p, {"squared": new_n, "linear": new_z}


class ProximalGD(Optimizer):
    """ref: paddle/operators/proximal_gd_op.cc.  No multi-tensor form: the
    grouped call loops over ``_update``."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _update(self, p, g, a, lr, t):
        prox = p - lr * g
        new_p = (torch.sign(prox)
                 * torch.clamp_min(torch.abs(prox) - lr * self._l1, 0.0)
                 / (1.0 + lr * self._l2))
        return new_p, a


class ProximalAdagrad(Optimizer):
    """ref: paddle/operators/proximal_adagrad_op.cc.  No multi-tensor form:
    the grouped call loops over ``_update``."""

    _accum_defaults = {"moment": 0.0}

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2 = l1, l2

    def _update(self, p, g, a, lr, t):
        m = a["moment"] + torch.square(g)
        alr = lr / torch.sqrt(m + 1e-12)
        prox = p - alr * g
        new_p = torch.sign(prox) * torch.clamp_min(
            torch.abs(prox) - alr * self._l1, 0.0) / (1.0 + alr * self._l2)
        return new_p, {"moment": m}


# fluid-compatible aliases
SGDOptimizer = SGD
MomentumOptimizer = Momentum
AdagradOptimizer = Adagrad
AdamOptimizer = Adam
AdamaxOptimizer = Adamax
AdadeltaOptimizer = Adadelta
RMSPropOptimizer = RMSProp
DecayedAdagradOptimizer = DecayedAdagrad
FtrlOptimizer = Ftrl


# ----------------------------------------------------------------------- averaging


class ModelAverage:
    """Parameter averaging (ref: paddle/parameter/AverageOptimizer.cpp, v1
    ``average_window``).  Made AFTER ``opt.minimize(loss)``: appends
    in-program accumulation ops (sum += param, num += 1, both halved when
    num reaches ``max_average_window``, the reference's window restart).
    At eval time::

        with model_average.apply(exe):    # params <- sum / num
            ... run eval ...              # params restored on exit
    """

    def __init__(self, params_grads=None, max_average_window: int = 10000,
                 program: Optional[Program] = None):
        program = program or default_main_program()
        self._program = program
        block = program.global_block
        params = [p for p, _ in params_grads] if params_grads else program.parameters()
        self._params = [p for p in params if p.trainable]
        self._max_window = max_average_window
        self._sums = {}
        startup = default_startup_program()
        self._num_name = unique_name.generate("model_average.num")

        def mk_state(name, shape, dtype):
            v = block.create_var(name, shape, dtype, persistable=True)
            startup.global_block.create_var(name, shape, dtype,
                                            persistable=True)
            shape_t = tuple(int(s) for s in shape)

            def init_fn(ins, attrs, ctx, _s=shape_t, _d=v.dtype):
                return {"Out": [torch.zeros(_s, dtype=_d, device=ctx.device)]}

            startup.global_block.append_op(
                Op("init", {}, {"Out": [name]}, {}, init_fn))
            return v

        num_v = mk_state(self._num_name, (1,), "float32")
        for p in self._params:
            sv = mk_state(f"{p.name}.avg_sum", p.shape, p.dtype)
            self._sums[p.name] = sv

            def acc_fn(ins, attrs, ctx, _w=float(max_average_window)):
                s, pv, n = ins["Sum"][0], ins["Param"][0], ins["Num"][0]
                s = torch.where(n[0] >= _w, s * 0.5, s)
                return {"Out": [s + pv]}

            block.append_op(Op("average_accumulate",
                               {"Sum": [sv.name], "Param": [p.name],
                                "Num": [num_v.name]},
                               {"Out": [sv.name]}, {"is_optimizer_op": True},
                               acc_fn))

        def num_fn(ins, attrs, ctx, _w=float(max_average_window)):
            n = ins["Num"][0]
            n = torch.where(n[0] >= _w, n * 0.5, n)
            return {"Out": [n + 1.0]}

        block.append_op(Op("average_count", {"Num": [num_v.name]},
                           {"Out": [num_v.name]}, {"is_optimizer_op": True},
                           num_fn))

    def apply(self, executor=None, scope=None):
        """Context manager: swap the parameters for their running averages
        (sum / num, in each parameter's dtype); restore them on exit.  It
        reads num on the host, once: call it between steps."""
        from .core.executor import global_scope

        scope = scope or global_scope()

        @contextlib.contextmanager
        def guard():
            saved = {}
            n = float(np.asarray(scope.find_var(self._num_name).cpu())[0])
            if n > 0:
                for p in self._params:
                    saved[p.name] = scope.find_var(p.name)
                    avg = scope.find_var(self._sums[p.name].name) / n
                    scope.set_var(p.name, avg.to(saved[p.name].dtype))
            try:
                yield
            finally:
                for name, v in saved.items():
                    scope.set_var(name, v)

        return guard()
