"""Control flow (PyTorch port of ``paddle_tpu/layers/control_flow.py``):
``StaticRNN`` and ``DynamicRNN``, ``cond``, ``while_loop``, ``IfElse`` and
``recompute``, with the helpers they share (``_hoist_parameters``,
``_exec_sub``, ``_captured_names``).

A construct's body is recorded into a sub-Program; the construct becomes
ONE op in the outer program whose closure runs the body's ops (the op's
``sub_block``, and for the false branch of ``cond`` / ``IfElse`` its
``else_block``, which the checks that walk a program's ops read).
Parameters created inside the body are hoisted to the outer program so
that the Executor threads them as state, under their own names.  The JAX
package runs an RNN body under ``lax.scan``; here it runs once per step in
a Python loop, which autograd records and ``Executor.warm`` captures with
the rest of the step.

A CUDA graph cannot branch on a device value.  So ``IfElse`` (both
branches, merged by row) and ``while_loop(max_trip_count=N)`` (N masked
body evaluations) read nothing on the host and capture; ``cond`` and the
unbounded ``while_loop`` read their predicate on the host, run eagerly,
and ``Executor.warm`` refuses a program that holds them.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..core import unique_name
from ..core.program import (Op, OpContext, Program, Variable,
                            default_main_program, program_guard)
from .helper import LayerHelper


def _hoist_parameters(sub: Program, outer: Program):
    """Parameters created while recording the body live in the
    sub-program; re-register them on the outer program so state threading
    sees them (ref ``control_flow.py:30``)."""
    outer_block = outer.global_block
    names = []
    for name, v in sub._parameters.items():
        if not outer_block.has_var(name):
            nv = outer_block.create_parameter(name, v.shape, v.dtype,
                                              regularizer=v.regularizer,
                                              trainable=v.trainable)
            nv.optimize_attr = getattr(v, "optimize_attr",
                                       {"learning_rate": 1.0})
        names.append(name)
    # non-parameter persistables (e.g. batch-norm statistics) too
    for name, v in sub.global_block.vars.items():
        if v.persistable and not outer_block.has_var(name):
            outer_block.create_var(name, v.shape, v.dtype, persistable=True,
                                   trainable=v.trainable)
            names.append(name)
    return names


def _exec_sub(ops: List[Op], env: Dict, ctx: OpContext):
    for op in ops:
        op.apply(env, ctx)
    return env


def _captured_names(ops: List[Op], out_names: Sequence[str], outer: Program):
    """Outer vars a recorded sub-block reads: inputs not produced inside,
    plus outputs the block never produces (identity outputs of an outer
    var)."""
    produced, needed = set(), []
    for op in ops:
        for n in op.input_names():
            if n not in produced and n not in needed:
                needed.append(n)
        produced |= set(op.output_names())
    for n in out_names:
        if n not in produced and n not in needed:
            needed.append(n)
    return [n for n in needed if outer.global_block.has_var(n)]


class StaticRNN:
    """RNN over a fixed max length (ref ``control_flow.py:75``;
    recurrent_op.cc).  Usage::

        rnn = StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)            # x: [batch, T, d] -> xt: [batch, d]
            h = rnn.memory(shape=[hidden], batch_ref=xt)
            nh = fluid.layers.fc([xt, h], hidden, act='tanh')
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out, = rnn()                           # [batch, T, hidden]

    Called with ``lengths``, a padded step (t >= length) holds every
    memory and emits zero outputs."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or unique_name.generate("static_rnn")
        self.sub_program = Program()
        self.outer_program = default_main_program()
        self._seq_inputs: List[tuple] = []     # (outer var, inner var)
        self._static_inputs: List[tuple] = []  # whole at every step
        self._memories: List[dict] = []
        self._outputs: List[Variable] = []
        self._recorded = False

    @contextlib.contextmanager
    def step(self):
        with program_guard(self.sub_program):
            yield
        self._recorded = True

    # ---- body-building API
    def step_input(self, x: Variable) -> Variable:
        inner = self.sub_program.global_block.create_var(
            unique_name.generate(f"{self.name}.x"),
            (x.shape[0],) + tuple(x.shape[2:]), x.dtype)
        self._seq_inputs.append((x, inner))
        return inner

    def static_input(self, x: Variable) -> Variable:
        """A non-sequence input seen whole at every step (the encoder states
        of an attention decoder)."""
        inner = self.sub_program.global_block.create_var(
            unique_name.generate(f"{self.name}.static"), x.shape, x.dtype)
        self._static_inputs.append((x, inner))
        return inner

    def memory(self, init: Optional[Variable] = None,
               shape: Optional[Sequence[int]] = None, value: float = 0.0,
               batch_ref: Optional[Variable] = None,
               dtype="float32") -> Variable:
        """A carried state: ``init`` (a Variable [batch, ...]) or ``shape``
        (without the batch dim) filled with ``value``; ``batch_ref`` is
        accepted for the reference's signature (the batch comes from the
        step inputs)."""
        del batch_ref
        if init is not None:
            inner_shape, inner_dtype = init.shape, init.dtype
        else:
            if shape is None:
                raise ValueError("memory needs init= or shape=")
            inner_shape, inner_dtype = (None,) + tuple(shape), dtype
        inner = self.sub_program.global_block.create_var(
            unique_name.generate(f"{self.name}.mem"), inner_shape,
            inner_dtype)
        self._memories.append({"inner": inner, "init": init, "shape": shape,
                               "value": value, "updated": None})
        return inner

    def update_memory(self, mem: Variable, new: Variable):
        for m in self._memories:
            if m["inner"] is mem:
                m["updated"] = new
                return
        raise ValueError("update_memory: unknown memory variable")

    def step_output(self, o: Variable):
        self._outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    # ---- finalize: append one op to the outer program
    def __call__(self, lengths: Optional[Variable] = None):
        if not (self._recorded and self._outputs):
            raise ValueError(f"{type(self).__name__}: record a step with "
                             f"outputs first")
        if any(m["updated"] is None for m in self._memories):
            raise ValueError("every memory needs update_memory")
        helper = LayerHelper("static_rnn")
        _hoist_parameters(self.sub_program, self.outer_program)

        sub_ops = list(self.sub_program.global_block.ops)
        seq_in_names = [iv.name for _, iv in self._seq_inputs]
        static_names = [iv.name for _, iv in self._static_inputs]
        mem_specs = [
            {"inner": m["inner"].name,
             "shape": tuple(m["shape"]) if m["init"] is None else None,
             "value": m["value"], "dtype": m["inner"].dtype}
            for m in self._memories]
        updated_names = [m["updated"].name for m in self._memories]
        out_names = [o.name for o in self._outputs]
        param_names = sorted(
            set(self.sub_program._parameters)
            | {v.name for v in self.sub_program.global_block.vars.values()
               if v.persistable})
        outer_inputs: Dict[str, List[str]] = {
            "X": [ov.name for ov, _ in self._seq_inputs],
            "Static": [ov.name for ov, _ in self._static_inputs],
            "Params": param_names,
            "MemInit": [m["init"].name for m in self._memories
                        if m["init"] is not None],
        }
        if lengths is not None:
            outer_inputs["Length"] = [lengths.name]

        def fn(ins, attrs, ctx):
            xs = ins["X"]
            consts = dict(zip(param_names, ins["Params"]))
            consts.update(zip(static_names, ins.get("Static", [])))
            inits = iter(ins.get("MemInit", []))
            B, T = xs[0].shape[0], xs[0].shape[1]
            carry = [next(inits) if spec["shape"] is None else
                     torch.full((B,) + spec["shape"], spec["value"],
                                dtype=spec["dtype"], device=xs[0].device)
                     for spec in mem_specs]
            ln = ins.get("Length", [None])[0]
            if ln is not None:
                mask = (torch.arange(T, device=ln.device)[None, :]
                        < ln[:, None]).to(xs[0].dtype).t()   # [T, B]
            else:
                mask = torch.ones((T, B), dtype=xs[0].dtype,
                                  device=xs[0].device)
            steps = [[] for _ in out_names]
            for t in range(T):
                env = dict(consts)
                env.update((n, x[:, t]) for n, x in zip(seq_in_names, xs))
                env.update((spec["inner"], c)
                           for spec, c in zip(mem_specs, carry))
                _exec_sub(sub_ops, env, ctx)
                mt = mask[t]
                new = []
                for uname, c in zip(updated_names, carry):
                    nc = env[uname]
                    m = mt.reshape((-1,) + (1,) * (nc.dim() - 1))
                    new.append(nc * m + c * (1 - m))
                carry = new
                # outputs at padded steps are zero, as dynamic_lstm's
                for acc, n in zip(steps, out_names):
                    o = env[n]
                    acc.append(o * mt.reshape((-1,) + (1,) * (o.dim() - 1)))
            return {"Out": [torch.stack(acc, 1) for acc in steps]}

        t_dim = self._seq_inputs[0][0].shape[1] if self._seq_inputs else None
        block = helper.block
        out_vars = [block.create_var(unique_name.generate(f"{self.name}.out"),
                                     (None, t_dim) + tuple(o.shape[1:]),
                                     o.dtype)
                    for o in self._outputs]
        block.append_op(Op("static_rnn", outer_inputs,
                           {"Out": [v.name for v in out_vars]}, {}, fn,
                           sub_block=self.sub_program.global_block))
        return out_vars  # always a list; unpack with `out, = rnn()`


class DynamicRNN(StaticRNN):
    """Length-aware RNN (ref ``control_flow.py:249``; the reference's
    LoDTensorArray and rank table become the masked loop): the same API,
    called with ``lengths``; padded steps hold the memories and emit
    zeros."""


def recompute(fn: Callable, name=None):
    """Activation rematerialisation over a sub-block (the reference's
    ``jax.checkpoint``, ``control_flow.py:312``).

    ``fn()`` builds layers, recorded as a sub-program, and returns its
    output Variable(s).  The block's activations are not kept for the
    backward: ``torch.utils.checkpoint`` (non-reentrant, since the
    Executor's backward is ``torch.autograd.grad``; no RNG state, since a
    random op draws from its threefry key, ``ctx.rng_key``) runs its ops
    again in the backward.  Parameters created inside are hoisted and
    trained under their own names.

    One divergence from the reference, on purpose: a random op inside the
    block draws its tag from the OUTER program, so ``remat`` changes no
    dropout mask (the reference's block draws tags from its fresh
    sub-program, and each block repeats the tags 1, 2, ...; its own
    contract says remat is numerically identical to the plain build).

        h = layers.recompute(lambda: my_transformer_block(x))
    """
    helper = LayerHelper("recompute", name=name)
    outer = default_main_program()
    sub = Program()
    sub._rng_tag = outer._rng_tag
    with program_guard(sub):
        out = fn()
    outer._rng_tag = sub._rng_tag
    outs = out if isinstance(out, (list, tuple)) else [out]
    _hoist_parameters(sub, outer)
    ops = list(sub.global_block.ops)
    out_names = [o.name for o in outs]
    cap = _captured_names(ops, out_names, outer)

    def op_fn(ins, attrs, ctx):
        def runner(*cvals):
            env = dict(zip(cap, cvals))
            _exec_sub(ops, env, ctx)
            return tuple(env[n] for n in out_names)

        if not torch.is_grad_enabled():
            return {"Out": list(runner(*ins["Cap"]))}
        res = checkpoint(runner, *ins["Cap"], use_reentrant=False,
                         preserve_rng_state=False)
        return {"Out": list(res)}

    block = helper.block

    def _tmpl(n):
        sub_blk = sub.global_block
        return sub_blk.var(n) if sub_blk.has_var(n) \
            else outer.global_block.var(n)

    out_vars = [block.create_var(unique_name.generate("recompute.out"),
                                 _tmpl(n).shape, _tmpl(n).dtype)
                for n in out_names]
    for v, n in zip(out_vars, out_names):
        v.sharding = _tmpl(n).sharding   # the block's output layout
    block.append_op(Op("recompute", {"Cap": cap},
                       {"Out": [v.name for v in out_vars]}, {}, op_fn,
                       sub_block=sub.global_block))
    return out_vars if len(out_vars) > 1 else out_vars[0]


# --------------------------------------------------------------------------- cond


def _branch_var(sub: Program, outer: Program, name: str) -> Variable:
    blk = sub.global_block
    return blk.var(name) if blk.has_var(name) else outer.global_block.var(name)


def cond(pred: Variable, true_fn: Callable, false_fn: Callable, name=None):
    """Two-branch conditional (ref ``control_flow.py:259``;
    paddle/operators/cond_op.cc).  ``true_fn()`` and ``false_fn()`` build
    layers, each recorded as a sub-program, and return the same number of
    Variables of the same shapes and dtypes (raises ValueError otherwise,
    where JAX's ``lax.cond`` trace raises).

    At run time the predicate (one element) is read on the host and only
    the taken branch runs, as ``lax.cond`` runs one: an untaken branch's
    parameters get zero gradients, and its ops are not differentiated (a
    ``torch.where`` over both branches would give ``0 * inf = NaN`` where
    the untaken branch's local derivative is infinite).  The host read
    cannot live in a CUDA graph: ``Executor.warm`` refuses a program with
    a ``cond`` op, which ``run()`` runs eagerly."""
    helper = LayerHelper("cond", name=name)
    outer = default_main_program()

    branches = []
    for f in (true_fn, false_fn):
        sub = Program()
        with program_guard(sub):
            out = f()
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        _hoist_parameters(sub, outer)
        branches.append((list(sub.global_block.ops), [o.name for o in outs],
                         sub))
    (_, t_names, t_sub), (_, f_names, f_sub) = branches
    if len(t_names) != len(f_names):
        raise ValueError(f"cond: the true branch returns {len(t_names)} "
                         f"outputs, the false branch {len(f_names)}")
    tmpl = []
    for i, (tn, fn_) in enumerate(zip(t_names, f_names)):
        tv, fv = _branch_var(t_sub, outer, tn), _branch_var(f_sub, outer, fn_)
        if tuple(tv.shape) != tuple(fv.shape) or tv.dtype != fv.dtype:
            raise ValueError(
                f"cond: output {i} is {tuple(tv.shape)} {tv.dtype} in the "
                f"true branch and {tuple(fv.shape)} {fv.dtype} in the false "
                f"branch; both branches must give the same shapes and "
                f"dtypes")
        tmpl.append(tv)

    cap_all = sorted(set(_captured_names(*branches[0][:2], outer))
                     | set(_captured_names(*branches[1][:2], outer)))

    def fn(ins, attrs, ctx):
        taken = bool(ins["Cond"][0].reshape(()))    # the host read
        ops, out_names, _ = branches[0 if taken else 1]
        env = dict(zip(cap_all, ins["Cap"]))
        _exec_sub(ops, env, ctx)
        return {"Out": [env[n] for n in out_names]}

    block = helper.block
    out_vars = [block.create_var(unique_name.generate("cond.out"), tv.shape,
                                 tv.dtype) for tv in tmpl]
    block.append_op(Op("cond", {"Cond": [pred.name], "Cap": cap_all},
                       {"Out": [v.name for v in out_vars]}, {}, fn,
                       sub_block=t_sub.global_block,
                       else_block=f_sub.global_block))
    return out_vars if len(out_vars) > 1 else out_vars[0]


# --------------------------------------------------------------------------- while


def while_loop(cond_fn: Callable, body_fn: Callable,
               loop_vars: Sequence[Variable],
               max_trip_count: Optional[int] = None, name=None):
    """General while loop (ref ``control_flow.py:447``;
    paddle/operators/while_op.cc).  ``cond_fn`` and ``body_fn`` are
    torch-level callables over the loop state (where the reference's are
    jnp-level): ``cond_fn(*state)`` gives a one-element bool tensor,
    ``body_fn(*state)`` the new state, each tensor of its old shape and
    dtype.  Returns the final state as a list of Variables.

    - ``max_trip_count=N``: exactly N body evaluations, each merged as
      ``torch.where(active, new, state)`` cast to the state's dtype (the
      reference's scan body), so the state freezes once ``cond_fn`` goes
      false and N truncates the loop.  Nothing is read on the host: the
      loop captures in a warmed step.
    - no bound: a Python loop that reads ``cond_fn`` on the host every
      trip, and autograd records the trips (an O(T) tape; the reference's
      custom VJP recomputes each state from the start instead, O(1)
      residuals and O(T^2) body evaluations, because XLA has no dynamic
      residual stack; the gradients are the same).  ``Executor.warm``
      refuses a program with such a loop."""
    helper = LayerHelper("while_loop", name=name)

    def fn(ctx, *arrays, max_trip_count):
        state = tuple(arrays)
        if max_trip_count is not None:
            for _ in range(max_trip_count):
                active = cond_fn(*state)
                new = tuple(body_fn(*state))
                state = tuple(torch.where(active, n, s).to(s.dtype)
                              for n, s in zip(new, state))
            return state
        if ctx.device.type == "meta":    # build-time shapes: one body run
            new = tuple(body_fn(*state))
            for i, (n, s) in enumerate(zip(new, state)):
                if n.shape != s.shape or n.dtype != s.dtype:
                    raise ValueError(
                        f"while_loop: body output {i} is {tuple(n.shape)} "
                        f"{n.dtype}, its loop variable {tuple(s.shape)} "
                        f"{s.dtype}")
            return new
        while bool(cond_fn(*state)):     # the host read
            state = tuple(body_fn(*state))
        return state

    outs = helper.append_op(fn, {"X": list(loop_vars)},
                            attrs={"max_trip_count": max_trip_count},
                            n_outputs=len(loop_vars))
    return outs if isinstance(outs, list) else [outs]


# --------------------------------------------------------------------------- IfElse


class IfElse:
    """Batch-partitioned two-branch conditional (ref ``control_flow.py:491``;
    fluid IfElse, paddle/operators/cond_op.cc).  As in the reference's
    lowering, BOTH branch bodies run over the whole batch and the outputs
    merge row by row with the [N, 1] bool mask (``torch.where``): nothing
    is read on the host, so the op captures in a warmed step.

        ie = layers.IfElse(cond)          # cond: [N, 1] bool
        with ie.true_block():
            d = ie.input(x)
            ie.output(layers.fc(d, 10))
        with ie.false_block():
            d = ie.input(x)
            ie.output(layers.fc(d, 10))
        out, = ie()

    A branch may read an outer Variable without ``input()`` and return
    one unchanged."""

    def __init__(self, cond: Variable, name: Optional[str] = None):
        self.name = name or unique_name.generate("ifelse")
        self.cond = cond
        self.outer_program = default_main_program()
        self._subs = {True: Program(), False: Program()}
        self._inputs = {True: [], False: []}   # (outer var, inner var)
        self._outputs = {True: [], False: []}
        self._branch: Optional[bool] = None

    @contextlib.contextmanager
    def _block(self, branch: bool):
        self._branch = branch
        with program_guard(self._subs[branch]):
            yield
        self._branch = None

    def true_block(self):
        return self._block(True)

    def false_block(self):
        return self._block(False)

    def input(self, x: Variable) -> Variable:
        if self._branch is None:
            raise ValueError("IfElse.input() outside a block")
        inner = self._subs[self._branch].global_block.create_var(
            unique_name.generate(f"{self.name}.in"), x.shape, x.dtype)
        self._inputs[self._branch].append((x, inner))
        return inner

    def output(self, *outs: Variable):
        if self._branch is None:
            raise ValueError("IfElse.output() outside a block")
        self._outputs[self._branch].extend(outs)

    def __call__(self):
        t_outs, f_outs = self._outputs[True], self._outputs[False]
        if not (t_outs and f_outs and len(t_outs) == len(f_outs)):
            raise ValueError("IfElse: both blocks must produce the same "
                             "number of outputs")
        helper = LayerHelper("ifelse")
        outer = self.outer_program
        specs = {}
        for br in (True, False):
            _hoist_parameters(self._subs[br], outer)
            specs[br] = {
                "ops": list(self._subs[br].global_block.ops),
                "in": [iv.name for _, iv in self._inputs[br]],
                "outer_in": [ov.name for ov, _ in self._inputs[br]],
                "out": [o.name for o in self._outputs[br]],
            }
        param_names = sorted(
            set().union(*(set(self._subs[b]._parameters) for b in specs))
            | {v.name for b in specs
               for v in self._subs[b].global_block.vars.values()
               if v.persistable})
        # outer vars a branch reads without input() or returns unchanged
        cap_all = sorted({
            n for br in specs
            for n in _captured_names(specs[br]["ops"], specs[br]["out"],
                                     outer)
            if n not in param_names})

        outer_inputs = {
            "Cond": [self.cond.name],
            "TrueIn": specs[True]["outer_in"],
            "FalseIn": specs[False]["outer_in"],
            "Cap": cap_all,
            "Params": param_names,
        }

        def fn(ins, attrs, ctx):
            consts = dict(zip(param_names, ins["Params"]))
            consts.update(zip(cap_all, ins.get("Cap", [])))

            def run(br, key):
                env = dict(consts)
                env.update(zip(specs[br]["in"], ins[key]))
                _exec_sub(specs[br]["ops"], env, ctx)
                return [env[n] for n in specs[br]["out"]]

            mask = ins["Cond"][0].to(torch.bool)
            merged = []
            for t, f in zip(run(True, "TrueIn"), run(False, "FalseIn")):
                m = mask.reshape((-1,) + (1,) * (t.dim() - 1)) if t.dim() \
                    else mask.reshape(())
                merged.append(torch.where(m, t, f))
            return {"Out": merged}

        block = helper.block
        tmpl = [_branch_var(self._subs[True], outer, n)
                for n in specs[True]["out"]]
        out_vars = [block.create_var(
            unique_name.generate(f"{self.name}.out"), tv.shape, tv.dtype)
            for tv in tmpl]
        block.append_op(Op("ifelse", outer_inputs,
                           {"Out": [v.name for v in out_vars]}, {}, fn,
                           sub_block=self._subs[True].global_block,
                           else_block=self._subs[False].global_block))
        return out_vars


__all__ = ["DynamicRNN", "IfElse", "StaticRNN", "cond", "recompute",
           "while_loop"]
