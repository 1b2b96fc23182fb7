"""Learning-rate schedules, computed in the step from the optimizer's step
counter (PyTorch port of ``paddle_tpu/learning_rate_decay.py``).

Each function returns a callable ``step -> lr`` to pass as
``learning_rate=`` to any Optimizer: ``step`` is the optimizer's step (a
0-d int32 tensor on the step's device), ``lr`` a 0-d float32 tensor on the
same device, computed in float32 in the reference's order of operations.
Nothing is read back to the host, so a warmed step's CUDA graph computes
each replay's learning rate from the live step.
"""
from __future__ import annotations

import torch


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    def sched(step):
        e = step.to(torch.float32) / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate * torch.pow(decay_rate, e)

    return sched


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    def sched(step):
        e = step.to(torch.float32) / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate * torch.exp(-decay_rate * e)

    return sched


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    def sched(step):
        e = step.to(torch.float32) / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate / (1.0 + decay_rate * e)

    return sched


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    def sched(step):
        s = step.to(torch.float32)
        if cycle:
            div = torch.clamp_min(torch.ceil(s / decay_steps), 1.0)
            ds = decay_steps * div
        else:
            ds = decay_steps
            s = torch.clamp_max(s, float(decay_steps))
        return ((learning_rate - end_learning_rate)
                * torch.pow(1 - s / ds, power) + end_learning_rate)

    return sched


def piecewise_decay(boundaries, values):
    assert len(values) == len(boundaries) + 1

    def sched(step):
        s = step.to(torch.float32)
        lr = torch.full((), values[-1], dtype=torch.float32, device=s.device)
        for b, v in zip(reversed(boundaries), reversed(values[:-1])):
            lr = torch.where(s < b, v, lr)
        return lr

    return sched


def noam_decay(d_model, warmup_steps, scale=1.0):
    """The Transformer's schedule (Vaswani et al. 2017, eq. 3)."""

    def sched(step):
        s = torch.clamp_min(step.to(torch.float32), 1.0)
        return scale * (d_model ** -0.5) * torch.minimum(
            s ** -0.5, s * warmup_steps ** -1.5)

    return sched
