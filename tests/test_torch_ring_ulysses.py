"""The port's sequence parallelism on a gang of 4 CPU ranks over gloo (the
``gang`` fixture runs every case): ring attention, contiguous and striped,
causal and not, over sp = 4 and over the sp slices of a {dp: 2, sp: 2}
mesh, and Ulysses, causal and not; the output and the q/k/v gradients of
sum(out * w), gathered to global order, against the JAX package's
attention (``paddle_tpu.ops.flash_attention`` and ``jax.vjp`` on the same
numpy inputs), the contiguous causal ring also against the JAX package's
own ``ring_attention`` on the conftest's CPU mesh; Ulysses' head-count
error as the reference words it; the one-rank ring path.  Limits: values
within 1e-5 and gradients within 1e-4 of their max abs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import ops as jops
from paddle_tpu import parallel as jpar
from paddle_tpu_torch import distributed, parallel as tpar
from paddle_tpu_torch.parallel.ring import ring_launches
from paddle_tpu_torch.tools import parallel_cases as pc

RANKS = 4
SHAPE = (2, 4, 32, 16)   # B, H, T, D

CASES = {
    "ring_sp4": dict(kind="ring", mesh={"sp": 4}, causal=False),
    "ring_sp4_causal": dict(kind="ring", mesh={"sp": 4}, causal=True),
    "ring_sp4_striped": dict(kind="ring", mesh={"sp": 4}, causal=False,
                             striped=True),
    "ring_sp4_striped_causal": dict(kind="ring", mesh={"sp": 4},
                                    causal=True, striped=True),
    "ring_dp2_sp2_causal": dict(kind="ring", mesh={"dp": 2, "sp": 2},
                                causal=True),
    "ring_dp2_sp2_striped_causal": dict(kind="ring", mesh={"dp": 2, "sp": 2},
                                        causal=True, striped=True),
    "ulysses_sp4": dict(kind="ulysses", mesh={"sp": 4}, causal=False),
    "ulysses_sp4_causal": dict(kind="ulysses", mesh={"sp": 4}, causal=True),
    "ulysses_dp2_sp2_causal": dict(kind="ulysses", mesh={"dp": 2, "sp": 2},
                                   causal=True),
}


def _inputs(seed=9):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype("float32") for _ in range(4)]


def _jax_attention(q, k, v, w, causal, fn=None):
    """(out, dq, dk, dv) of sum(out * w) in the JAX package."""
    fn = fn or (lambda q, k, v: jops.flash_attention(q, k, v, causal=causal))
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(w))]


@pytest.fixture(scope="module")
def gang():
    q, k, v, w = _inputs()
    specs = {name: dict(spec, kind="attention", attn=spec["kind"],
                        qkv=(q, k, v), w=w)
             for name, spec in CASES.items()}
    # the head-count guard: 2 heads over sp = 4
    specs["ulysses_heads"] = dict(kind="attention", attn="ulysses",
                                  mesh={"sp": 4}, causal=False,
                                  qkv=(q[:, :2], k[:, :2], v[:, :2]),
                                  w=w[:, :2])
    return distributed.spawn(pc.run_cases, RANKS, specs, device="cpu",
                             timeout_s=300)[0]


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_parallel_matches_jax(gang, case):
    q, k, v, w = _inputs()
    want = _jax_attention(q, k, v, w, CASES[case]["causal"])
    got = gang[case]
    for key, ref, tol in zip(("out", "dq", "dk", "dv"), want,
                             (1e-5, 1e-4, 1e-4, 1e-4)):
        _close(got[key], ref, tol, f"{case} {key}")


def test_contiguous_causal_ring_matches_jax_ring_attention(gang):
    """Against the JAX package's ring_attention over sp = 4 on the CPU
    mesh (its shard_map and custom VJP), values and all three gradients."""
    q, k, v, w = _inputs()
    mesh = jpar.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    want = _jax_attention(q, k, v, w, True, lambda q, k, v:
                          jpar.ring_attention(q, k, v, mesh, causal=True))
    got = gang["ring_sp4_causal"]
    for key, ref, tol in zip(("out", "dq", "dk", "dv"), want,
                             (1e-5, 1e-4, 1e-4, 1e-4)):
        _close(got[key], ref, tol, key)


def test_ulysses_head_count_error_matches_jax(gang):
    q, k, v, _ = _inputs()
    mesh = jpar.make_mesh({"sp": 4}, devices=jax.devices()[:4])
    with pytest.raises(ValueError) as jerr:
        jpar.ulysses_attention(jnp.asarray(q[:, :2]), jnp.asarray(k[:, :2]),
                               jnp.asarray(v[:, :2]), mesh)
    assert gang["ulysses_heads"]["error"] == str(jerr.value)
    assert "divisible" in gang["ulysses_heads"]["error"]


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_ring_is_the_plain_block(causal):
    """n == 1 takes the plain _block_attn path, as the reference does."""
    q, k, v, w = _inputs()
    mesh = tpar.make_mesh({"sp": 1})
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tpar.ring_attention(tq, tk, tv, mesh, causal=causal)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    want = _jax_attention(q, k, v, w, causal)
    for got, ref, tol in zip([out] + list(grads), want,
                             (1e-5, 1e-4, 1e-4, 1e-4)):
        _close(got.detach().numpy(), ref, tol, "n == 1")


def test_ring_launch_prediction():
    """The flash launches a ring call makes per rank (the chip phase holds
    the counts to this): contiguous causal rank i runs i + 1 live pairs,
    striped or non-causal n."""
    assert [ring_launches(2, i, True, False) for i in range(2)] == [1, 2]
    assert [ring_launches(4, i, True, True) for i in range(4)] == [4] * 4
    assert [ring_launches(4, i, False, False) for i in range(4)] == [4] * 4
    assert ring_launches(1, 0, True, False) == 0
