"""Scope + Executor (PyTorch port of ``paddle_tpu/core/executor.py``).

``Executor.run`` runs the whole Program once per call, op by op, eagerly on
the Executor's device: the inputs are (persistable state, feed, step
counter), the outputs (fetches, new persistable state).  The Scope maps
names to tensors on that device.

The backward meta-op: JAX re-traces the forward prefix inside ``jax.grad``
and relies on XLA's CSE to run it once.  Here the forward ops run once,
with the trainable parameters as leaf tensors that require grad; the
``backward`` op calls ``torch.autograd.grad`` on the (scaled, summed) loss,
and every op after it runs under ``torch.no_grad()``.  The new state is
detached.  Updated parameters and moments are new tensors: the scope's old
tensors are replaced, not written in place.  A program with an amp policy
(``amp.enable``) has each op's inputs cast by it before the op runs
(``Op.apply``).  A program with no backward op (an inference program, such
as ``Program.prune``'s) runs with its 3x3 stride-1 convolutions routed onto
the implicit-GEMM kernels (``core/fusion.py``).

Nothing compiles per shape in torch, so there is no executable cache, no
persistent compile cache, no ``warm`` and no dispatch sampling.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.attention import check_flash_head_dim
from .fusion import channels_last_feed, route_inference
from .program import (
    Op,
    OpContext,
    Program,
    Variable,
    default_main_program,
)
from .types import Place

# --------------------------------------------------------------------------- Scope


class Scope:
    """Persistable state: name -> torch.Tensor."""

    def __init__(self):
        self._vars: Dict[str, torch.Tensor] = {}
        self.step_counter = 0

    def find_var(self, name: str):
        return self._vars.get(name)

    def var_names(self) -> List[str]:
        return list(self._vars)

    def set_var(self, name: str, value) -> None:
        self._vars[name] = value

    def items(self):
        return self._vars.items()

    def __contains__(self, name: str) -> bool:
        return name in self._vars


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def reset_global_scope():
    global _global_scope
    _global_scope = Scope()


def state_out_names(program, state_names):
    """Persistable names the step returns as new state: the incoming state
    plus every persistable an op writes."""
    persistable = {v.name for v in program.persistable_vars()}
    produced = {
        n for op in program.list_ops() for n in op.output_names() if n in persistable
    }
    return sorted(set(state_names) | produced)


# --------------------------------------------------------------------------- helpers


def _check_feed_shape(shape, var: Variable):
    """Validate non-batch dims against the declared var shape at the feed
    boundary, with an error naming the variable."""
    name = var.name
    declared = tuple(var.shape)
    if len(shape) != len(declared):
        raise ValueError(
            f"feed '{name}': rank {len(shape)} (shape {tuple(shape)}) does not "
            f"match declared rank {len(declared)} (shape {declared}); the "
            f"first declared dim is the batch axis unless the var was built "
            f"with append_batch_size=False")
    for i, (got, want) in enumerate(zip(shape, declared)):
        if want is not None and want != -1 and got != want:
            raise ValueError(
                f"feed '{name}': dim {i} is {got} but the variable declares "
                f"{want} (declared shape {declared}, fed shape {tuple(shape)})")


def _as_feed_array(value, var: Optional[Variable], device: torch.device):
    """A feed as a tensor on ``device``, shape-checked and cast to the
    declared dtype (int32 ids stay int32: ops that gather convert them)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    if var is not None:
        _check_feed_shape(tuple(t.shape), var)
        if t.dtype != var.dtype:
            t = t.to(var.dtype)
    return t.to(device)


def _fetch_name(f: Union[str, Variable]) -> str:
    return f if isinstance(f, str) else f.name


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


# --------------------------------------------------------------------------- Executor


class Executor:
    """Runs Programs on one device: ``Executor()`` is the CUDA card (and
    raises when there is none), ``Executor(CPUPlace())`` the host."""

    def __init__(self, place: Optional[Place] = None, strategy=None):
        if strategy is not None:
            raise NotImplementedError(
                "Executor(strategy=...) is not ported yet: parallel "
                "strategies are ROADMAP A.9")
        self.place = place or Place("gpu", 0)
        self.device = self.place.torch_device()

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        program = program or default_main_program()
        check_kernel_shapes(program, self.device)
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        scope = scope or global_scope()

        block = program.global_block
        feed_vals = {name: _as_feed_array(value, block.vars.get(name),
                                          self.device)
                     for name, value in feed.items()}
        fetch_names = [_fetch_name(f) for f in fetch_list]
        state_in_names = sorted(self._state_in_names(program, scope,
                                                     feed_vals, fetch_names))
        step = self._build_step(program, state_in_names, fetch_names)
        state = {n: scope.find_var(n) for n in state_in_names}
        fetches, new_state = step(state, feed_vals, scope.step_counter)
        scope.step_counter += 1
        for n, v in new_state.items():
            scope.set_var(n, v)
        if return_numpy:
            fetches = [_to_numpy(v) for v in fetches]
        return fetches

    def _state_in_names(self, program, scope, feed_vals, fetch_names):
        referenced, produced, read_first = set(), set(), set()
        for op in program.global_block.ops:
            for n in op.input_names():
                referenced.add(n)
                if n not in produced:
                    read_first.add(n)
            for n in op.output_names():
                referenced.add(n)
                produced.add(n)
        names = []
        for v in program.persistable_vars():
            n = v.name
            if n in feed_vals or (n not in referenced and n not in fetch_names):
                continue
            if n in scope:
                names.append(n)
            elif n in read_first or n not in produced:
                raise RuntimeError(
                    f"persistable variable {n!r} is read by the program before any op "
                    f"produces it and is not in the scope — did you run the startup "
                    f"program? (ref executor.cc:78-88 var creation)"
                )
        return names

    def build_raw_step(self, program: Program, feed_names, fetch_names,
                       scope: Scope):
        """Return (step_fn, state_dict): the whole-program step
        ``step_fn(state, feed, step) -> (fetches, new_state)`` and the
        current persistable state, for harnesses that drive the step
        themselves (benchmarks, entry points)."""
        check_kernel_shapes(program, self.device)
        feed_stub = {n: None for n in feed_names}
        state_names = sorted(self._state_in_names(program, scope, feed_stub,
                                                  fetch_names))
        fn = self._build_step(program, state_names, fetch_names)
        state = {n: scope.find_var(n) for n in state_names}
        return fn, state

    def _build_step(self, program: Program, state_names, fetch_names):
        if getattr(program, "anomaly_guard", None) is not None:
            raise NotImplementedError(
                "program.anomaly_guard is not ported yet (ROADMAP A.6)")
        amp = getattr(program, "amp_policy", None)
        ops = program.list_ops()
        out_names = state_out_names(program, state_names)
        bops = [i for i, op in enumerate(ops) if op.special == "backward"]
        if len(bops) > 1:
            raise NotImplementedError(
                "more than one backward op in a program is not ported")
        routed = None if bops else route_inference(program, fetch_names, amp)
        if routed is not None:
            ops = routed
        device = self.device
        seed = program.random_seed or 0

        def step(state, feed, step_index: int):
            ctx = OpContext(seed, step_index, device, amp)
            if routed is not None:
                feed = channels_last_feed(feed)
            env: Dict[str, Any] = {}
            env.update(state)
            env.update(feed)
            if bops:
                # the forward runs once, on leaf parameters that require grad
                for p in ops[bops[0]].attrs["params"]:
                    env[p] = env[p].detach().requires_grad_(True)
            with torch.enable_grad() if bops else torch.no_grad():
                for op in ops:
                    if op.special == "backward":
                        _apply_backward(op, env)
                        break
                    op.apply(env, ctx)
            if bops:
                with torch.no_grad():
                    for op in ops[bops[0] + 1:]:
                        op.apply(env, ctx)
            new_state = {n: env[n].detach() for n in out_names if n in env}
            fetches = tuple(env[n].detach() for n in fetch_names)
            return fetches, new_state

        return step


# --------------------------------------------------------------------------- kernel shapes


def check_kernel_shapes(program: Program, device: torch.device) -> None:
    """On a CUDA device, raise on an op whose kernel would refuse its shape:
    the flash attention op (``attention``, from ``models.attention_core``)
    with a head dim outside the kernels' ``FLASH_HEAD_DIMS``.  The check
    lives here and not in ``build_lm``: a program is built without knowing
    where it will run, and the CPU runs every head dim on the plain
    versions.  ``Executor.run`` calls it before the step's first op, so a
    refused program changes no parameter or optimizer state."""
    if device.type != "cuda":
        return
    block = program.global_block
    for op in program.list_ops():
        if op.type == "attention":
            hd = block.vars[op.inputs["Q"][0]].shape[-1]
            check_flash_head_dim(hd // op.attrs["n_heads"])


# --------------------------------------------------------------------------- backward


def _apply_backward(bop: Op, env) -> None:
    """The autodiff meta-op: gradients of the (summed, scaled) loss with
    respect to the leaf parameters, as ``<param>@GRAD``; the parameters are
    detached again for the ops that follow.  A parameter the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives."""
    loss = env[bop.attrs["loss"]]
    params = bop.attrs["params"]
    if loss.dim() > 0:
        loss = loss.sum()
    leaves = [env[p] for p in params]
    grads = torch.autograd.grad(loss * bop.attrs.get("loss_scale", 1.0),
                                leaves, allow_unused=True)
    for p, leaf, g in zip(params, leaves, grads):
        env[p + "@GRAD"] = torch.zeros_like(leaf) if g is None else g
        env[p] = leaf.detach()
