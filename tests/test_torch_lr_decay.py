"""The port's learning-rate schedules (``learning_rate_decay.py``) against
the JAX package's on the CPU, step by step: every schedule, staircase and
cycle variants, over steps that include ``piecewise_decay``'s boundaries
(each side of each) and ``noam_decay``'s warm-up edge (steps 0 and 1 clamp
to 1; the peak at the warm-up step).  Each returns a 0-d float32 tensor
on the step's device.  Tolerance rtol 1e-6: both compute in float32 in the
same order of operations, but pow, exp and rsqrt come from two libraries,
each within an ulp or two."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.learning_rate_decay as jlr
import paddle_tpu_torch.learning_rate_decay as tlr

STEPS = [0, 1, 2, 3, 4, 5, 9, 10, 11, 99, 100, 101, 399, 400, 401, 1000,
         4000, 123457]
SCHEDULES = {
    "exponential": ("exponential_decay", (0.1, 100, 0.5), {}),
    "exponential_staircase": ("exponential_decay", (0.1, 100, 0.5),
                              {"staircase": True}),
    "natural_exp": ("natural_exp_decay", (0.1, 100, 0.5), {}),
    "natural_exp_staircase": ("natural_exp_decay", (0.1, 100, 0.5),
                              {"staircase": True}),
    "inverse_time": ("inverse_time_decay", (0.1, 100, 0.5), {}),
    "inverse_time_staircase": ("inverse_time_decay", (0.1, 100, 0.5),
                               {"staircase": True}),
    "polynomial": ("polynomial_decay", (0.1, 400), {}),
    "polynomial_power2": ("polynomial_decay", (0.1, 400, 0.001, 2.0), {}),
    "polynomial_cycle": ("polynomial_decay", (0.1, 400),
                         {"power": 0.5, "cycle": True}),
    "piecewise": ("piecewise_decay", ([10, 100, 400], [1.0, 0.5, 0.1, 0.01]),
                  {}),
    "noam": ("noam_decay", (512, 4000), {}),
    "noam_small": ("noam_decay", (32, 4), {"scale": 0.01}),
}


@pytest.mark.parametrize("which", sorted(SCHEDULES))
def test_schedule_matches_jax(which):
    name, args, kw = SCHEDULES[which]
    jsched = getattr(jlr, name)(*args, **kw)
    tsched = getattr(tlr, name)(*args, **kw)
    got, want = [], []
    for s in STEPS:
        t = tsched(torch.tensor(s, dtype=torch.int32))
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert t.dim() == 0 and t.device.type == "cpu"
        got.append(t.item())
        want.append(float(np.asarray(jsched(jnp.asarray(s, jnp.int32)),
                                     np.float32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_piecewise_boundaries_and_noam_peak():
    """The values the boundaries select, exactly, and noam's peak at its
    warm-up step with steps 0 and 1 equal (clamped)."""
    pw = tlr.piecewise_decay([10, 100], [1.0, 0.5, 0.25])
    vals = [pw(torch.tensor(s, dtype=torch.int32)).item()
            for s in (9, 10, 99, 100)]
    assert vals == [1.0, 0.5, 0.5, 0.25]
    noam = tlr.noam_decay(512, 4000)
    lrs = [noam(torch.tensor(s, dtype=torch.int32)).item()
           for s in (0, 1, 3999, 4000, 4001)]
    assert lrs[0] == lrs[1] and lrs[3] > lrs[2] and lrs[3] > lrs[4]
    np.testing.assert_allclose(lrs[3], 512 ** -0.5 * 4000 ** -0.5,
                               rtol=1e-6)
