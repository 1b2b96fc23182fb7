"""paddle_tpu_torch's fused LSTM and sequence layers against the JAX package
on the CPU.

The port's plain versions (``_lstm_scan`` forward, autograd through it
backward, both behind the ``fused_lstm`` autograd Function on CPU tensors)
are held against JAX's ``fused_lstm`` with its Pallas kernel run by the
interpreter (``PADDLE_TPU_PALLAS=interpret``) and its ``jax.vjp`` backward,
on the same numpy-seeded inputs.  A transcription of the CUDA kernels'
arithmetic (``csrc/lstm.cu``: the residual layout and the reverse
recurrence) is held against the plain backward here, since the kernels
themselves run only on the card, where ``chip_smoke.py`` holds them against
the plain versions."""
import re
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jfluid
from paddle_tpu.ops import fused_lstm as jax_fused_lstm
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import fused_lstm
from paddle_tpu_torch.ops import lstm as TL

CPU = tfluid.CPUPlace()
FWD_ATOL = 1e-5      # hs, c_final: float32, sums in another order
GRAD_ATOL = 1e-4     # gradients, as tests/test_pallas_ops.py holds them
# (gate, cell, candidate): the default, then every code in every slot
ACTS = [("sigmoid", "tanh", "tanh"), ("sigmoid", "identity", "relu"),
        ("tanh", "relu", "identity"), ("relu", "tanh", "sigmoid"),
        ("identity", "sigmoid", "tanh")]
T, B, H = 9, 5, 16
LENGTHS = np.array([9, 4, 0, 1, 7])   # ragged, with 0 and T


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


@pytest.fixture(autouse=True)
def fresh_port_state():
    tfluid.reset_default_programs()
    tfluid.reset_global_scope()
    yield


def _inputs(seed, acts=ACTS[0]):
    """xw N(0, 1), U N(0, 1/H) (gate pre-activations spread around O(1)),
    peep N(0, 0.5^2), and the 1/0 mask of LENGTHS.  Unbounded gates (relu,
    identity) take xw N(0, 0.5^2) and peep N(0, 0.05^2): with the cell
    feeding the gates through the peepholes they would otherwise grow
    without bound (to 1e17 in 9 steps)."""
    rng = np.random.RandomState(seed)
    bounded = acts[0] in ("sigmoid", "tanh")
    xw = rng.standard_normal((T, B, 4 * H)) * (1.0 if bounded else 0.5)
    u = rng.standard_normal((H, 4 * H)) / np.sqrt(H)
    peep = rng.standard_normal((3, H)) * (0.5 if bounded else 0.05)
    mask = np.arange(T)[:, None] < LENGTHS[None, :]
    return tuple(a.astype(np.float32) for a in (xw, u, peep, mask))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _kw(use_peep, acts):
    return dict(size=H, use_peepholes=use_peep, gate_activation=acts[0],
                cell_activation=acts[1], candidate_activation=acts[2])


# --------------------------------------------------------------- fused_lstm


@pytest.mark.parametrize("acts", ACTS)
@pytest.mark.parametrize("use_peep", [False, True])
def test_forward_matches_jax_pallas_kernel(interpret_mode, use_peep, acts):
    """hs and c_final against JAX's fused_lstm (Pallas kernel interpreted),
    atol 1e-5; padded steps emit exact zeros."""
    xw, u, peep, mask = _inputs(1, acts)
    jhs, jc = jax_fused_lstm(*(jnp.asarray(a) for a in (xw, u, peep, mask)),
                             **_kw(use_peep, acts))
    hs, c = fused_lstm(_t(xw), _t(u), _t(peep), _t(mask), **_kw(use_peep, acts))
    assert tuple(hs.shape) == (T, B, H) and tuple(c.shape) == (B, H)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=FWD_ATOL, rtol=0)
    assert np.all(hs.numpy()[mask == 0] == 0)
    assert np.all(c.numpy()[2] == 0)           # the length-0 row


@pytest.mark.parametrize("use_peep,acts", [
    (False, ACTS[0]), (True, ACTS[0]), (True, ACTS[1]), (False, ACTS[2]),
    (True, ACTS[3]), (True, ACTS[4])])
def test_grads_match_jax_grad(interpret_mode, use_peep, acts):
    """d(sum(hs^2) + sum(c_final)) / d(xw, u, peep) against jax.grad through
    JAX's custom_vjp (atol 1e-4)."""
    xw, u, peep, mask = _inputs(2, acts)
    kw = _kw(use_peep, acts)

    def jloss(xw, u, peep):
        hs, c = jax_fused_lstm(xw, u, peep, jnp.asarray(mask), **kw)
        return jnp.sum(hs ** 2) + jnp.sum(c)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (xw, u, peep)))
    ins = [_t(a, True) for a in (xw, u, peep)]
    hs, c = fused_lstm(*ins, _t(mask), **kw)
    ((hs ** 2).sum() + c.sum()).backward()
    for name, a, b in zip(("xw", "u", "peep"), ins, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)
    if not use_peep:
        assert np.all(ins[2].grad.numpy() == 0)


def test_unused_output_gets_a_zero_cotangent():
    """Only hs reaches the loss: c_final's cotangent is None and is taken
    as zeros, as jax.custom_vjp gives; mask gets no gradient."""
    xw, u, peep, mask = _inputs(3)
    ins = [_t(a, True) for a in (xw, u, peep)]
    m = _t(mask, True)
    hs, _ = fused_lstm(*ins, m, **_kw(True, ACTS[0]))
    hs.sum().backward()
    want = TL._lstm_scan_vjp(_t(xw), _t(u), _t(peep), _t(mask), H, True,
                             ACTS[0], torch.ones(T, B, H), torch.zeros(B, H))
    for a, b in zip(ins, want):
        np.testing.assert_allclose(a.grad.numpy(), b.numpy(), atol=1e-6,
                                   rtol=0)
    assert m.grad is None


# ------------------------------------- the CUDA kernels' arithmetic, on CPU


_D = {"sigmoid": lambda y: y * (1 - y), "tanh": lambda y: 1 - y * y,
      "relu": lambda y: (y > 0).to(y.dtype), "identity": torch.ones_like}


def _kernel_forward(xw, u, peep, mask, use_peep, acts):
    """lstm_fwd_launch transcribed: (hs, hc, cc, gates, cnew) in the
    kernel's layout (hc, cc [T+1, B, H] with the zero state in slot 0)."""
    ga, ca, cda = (TL._ACT[a] for a in acts)
    t_, b_ = xw.shape[:2]
    hc = torch.zeros(t_ + 1, b_, H)
    cc = torch.zeros(t_ + 1, b_, H)
    hs, gates, cnew = (torch.zeros(t_, b_, w) for w in (H, 4 * H, H))
    p0, p1, p2 = peep if use_peep else torch.zeros(3, H)
    for t in range(t_):
        g = xw[t] + hc[t] @ u
        gi, gf, gc, go = torch.split(g, H, dim=-1)
        cp = cc[t]
        i, f = ga(gi + cp * p0), ga(gf + cp * p1)
        cd = cda(gc)
        cn = f * cp + i * cd
        o = ga(go + cn * p2)
        hn = o * ca(cn)
        m = mask[t][:, None]
        hc[t + 1] = hn * m + hc[t] * (1 - m)
        cc[t + 1] = cn * m + cp * (1 - m)
        hs[t] = hn * m
        gates[t] = torch.cat([i, f, cd, o], dim=-1)
        cnew[t] = cn
    return hs, hc, cc, gates, cnew


def _kernel_backward(g_hs, g_c, u, peep, mask, gates, cnew, cc, size,
                     use_peep, acts):
    """lstm_bwd_launch transcribed: the reverse recurrence, t = T-1 .. 0,
    with dh and dc carried in [B, H] buffers; returns dxw."""
    ga, ca, cda = acts
    act_c = TL._ACT[ca]
    t_, b_ = gates.shape[:2]
    p0, p1, p2 = peep if use_peep else torch.zeros(3, H)
    dxw = torch.zeros(t_, b_, 4 * H)
    dh_buf = torch.zeros(b_, H)
    dc = g_c.clone()
    for t in range(t_ - 1, -1, -1):
        if t == t_ - 1:
            dh = torch.zeros(b_, H)
        else:
            dh = dxw[t + 1] @ u.t() + dh_buf * (1 - mask[t + 1][:, None])
        i, f, cd, o = torch.split(gates[t], H, dim=-1)
        cn, cp, m = cnew[t], cc[t], mask[t][:, None]
        dhn = (g_hs[t] + dh) * m
        ch = act_c(cn)
        dcn = dc * m + dhn * o * _D[ca](ch)
        dzo = dhn * ch * _D[ga](o)
        dcn = dcn + dzo * p2
        dzi = dcn * cd * _D[ga](i)
        dzf = dcn * cp * _D[ga](f)
        dzc = dcn * i * _D[cda](cd)
        dc = dcn * f + dc * (1 - m) + dzi * p0 + dzf * p1
        dxw[t] = torch.cat([dzi, dzf, dzc, dzo], dim=-1)
        dh_buf = dh
    return dxw


@pytest.mark.parametrize("use_peep,acts", [
    (False, ACTS[0]), (True, ACTS[0]), (True, ACTS[1]), (True, ACTS[2]),
    (False, ACTS[3]), (True, ACTS[4])])
def test_kernel_arithmetic_matches_plain_versions(monkeypatch, use_peep,
                                                  acts):
    """The kernels' forward and reverse recurrence, transcribed in torch,
    with ``lstm_bwd_cuda``'s own dU matmul and peephole sums on top (the
    reverse kernel swapped for its transcription): hs and c_final against
    ``_lstm_scan`` (atol 1e-6) and (dxw, du, dpeep) against
    ``_lstm_scan_vjp`` (atol 1e-5)."""
    xw, u, peep, mask = (_t(a) for a in _inputs(4, acts))
    rng = np.random.RandomState(5)
    g_hs = _t(rng.standard_normal((T, B, H)))
    g_c = _t(rng.standard_normal((B, H)))
    hs, hc, cc, gates, cnew = _kernel_forward(xw, u, peep, mask, use_peep,
                                              acts)
    want_hs, want_c = TL._lstm_scan(xw, u, peep, mask, H, use_peep, acts)
    np.testing.assert_allclose(hs.numpy(), want_hs.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(cc[-1].numpy(), want_c.numpy(), atol=1e-6,
                               rtol=0)
    monkeypatch.setattr(TL, "lstm_bwd_kernel", _kernel_backward)
    got = TL.lstm_bwd_cuda(g_hs, g_c, u, peep, mask, hc, cc, gates, cnew, H,
                           use_peep, acts)
    want = TL._lstm_scan_vjp(xw, u, peep, mask, H, use_peep, acts, g_hs, g_c)
    for name, a, b in zip(("dxw", "du", "dpeep"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_activation_codes_match_cuda_source():
    src = (Path(TL.__file__).parent / "csrc" / "lstm.cu").read_text()
    enum = re.search(r"enum Act \{([^}]*)\}", src).group(1)
    codes = {name.lower(): int(v) for name, v in
             re.findall(r"k(\w+) = (\d+)", enum)}
    assert codes == TL.ACT_CODE


# ------------------------------------------------------- devices, counts


def test_meta_tensors_give_shapes_and_launch_nothing():
    before = dict(fused_lstm.launches)
    xw = torch.empty((7, 3, 64), device="meta")
    hs, c = fused_lstm(xw, torch.empty((16, 64), device="meta"),
                       torch.empty((3, 16), device="meta"),
                       torch.empty((7, 3), device="meta"), size=16)
    assert hs.device.type == "meta" and tuple(hs.shape) == (7, 3, 16)
    assert tuple(c.shape) == (3, 16)
    # a whole text_lstm program is built on meta tensors, without a card
    words = tfluid.layers.data("words", [20], dtype="int32")
    lengths = tfluid.layers.data("lengths", [-1], dtype="int32",
                                 append_batch_size=False)
    label = tfluid.layers.data("label", [1], dtype="int32")
    loss, acc, pred = tfluid.models.text_lstm.build(
        words, lengths, label, 30, emb_dim=8, hidden=16)
    tfluid.optimizer.Adam(1e-3).minimize(loss)
    assert loss.shape == () and acc.shape == (1,) and pred.shape == (None, 2)
    assert fused_lstm.launches == before


def test_plain_versions_count_no_launch_and_kernels_take_cuda_only():
    before = dict(fused_lstm.launches)
    xw, u, peep, mask = (_t(a) for a in _inputs(6))
    xw.requires_grad_(True)
    hs, c = fused_lstm(xw, u, peep, mask, size=H)
    (hs.sum() + c.sum()).backward()
    assert fused_lstm.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        TL.lstm_fwd_kernel(xw.detach(), u, peep, mask, H, False, ACTS[0],
                           True)
    with pytest.raises(ValueError, match="unknown LSTM activation"):
        fused_lstm(xw, u, peep, mask, size=H, gate_activation="softmax")
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_lstm(other, u, peep, mask, size=H)
    assert fused_lstm.launches == before


# ------------------------------------------------------------ layers


def _seq_program(fl, which, use_peep=False, is_reverse=False):
    """(fetch vars, feed, weights) of a one-layer program: an fc over the
    fed sequence, then ``which`` ("lstm" or a pool type)."""
    L = fl.layers
    D = 6
    rng = np.random.RandomState(7)
    x = L.data("x", [T, D])
    lengths = L.data("lengths", [-1], dtype="int32", append_batch_size=False)
    feed = {"x": rng.standard_normal((B, T, D)).astype(np.float32),
            "lengths": LENGTHS.astype(np.int32)}
    if which == "lstm":
        proj = L.fc(x, 4 * H, num_flatten_dims=2, bias_attr=False)
        hs, c = L.dynamic_lstm(proj, lengths, H, use_peepholes=use_peep,
                               is_reverse=is_reverse)
        loss = L.sums([L.mean(L.square(hs)), L.mean(c)])
        outs = [hs, c]
        weights = {"fc_w_0": rng.standard_normal((D, 4 * H)) / np.sqrt(D),
                   "dynamic_lstm_w_0": rng.standard_normal((H, 4 * H))
                   / np.sqrt(H),
                   "dynamic_lstm_b_0": rng.standard_normal(
                       (7 if use_peep else 4) * H) * 0.5}
    else:
        y = L.fc(x, 3, num_flatten_dims=2, bias_attr=False)
        out = L.sequence_pool(y, lengths, which)
        loss = L.mean(out)    # "max" of a length-0 row is finfo.min
        outs = [out]
        weights = {"fc_w_0": rng.standard_normal((D, 3))}
    pg = fl.backward.append_backward(loss)
    weights = {k: v.astype(np.float32) for k, v in weights.items()}
    return outs + [g for _, g in pg], feed, weights


def _run_both(which, **kw):
    got = {}
    for name, fl in (("jax", jfluid), ("port", tfluid)):
        fetch, feed, weights = _seq_program(fl, which, **kw)
        if name == "jax":
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            for k, v in weights.items():
                jfluid.global_scope().set_var(k, jnp.asarray(v))
            got[name] = [np.asarray(a) for a in
                         exe.run(feed=feed, fetch_list=fetch)]
        else:
            exe = tfluid.Executor(CPU)
            exe.run(tfluid.default_startup_program())
            tfluid.load_scope(weights, tfluid.default_main_program(),
                              tfluid.global_scope(), device="cpu")
            got[name] = exe.run(feed=feed, fetch_list=fetch)
        got[name + "_names"] = [f.name for f in fetch]
    assert got["jax_names"] == got["port_names"]
    return got


@pytest.mark.parametrize("is_reverse", [False, True])
@pytest.mark.parametrize("use_peep", [False, True])
def test_dynamic_lstm_matches_jax(interpret_mode, use_peep, is_reverse):
    """hidden, last cell and the fc / LSTM weight and bias gradients of a
    one-layer program, both packages from the same weights (outputs atol
    1e-5, gradients 1e-4).  Reverse flips the whole padded axis: the
    length-0 row stays zero and a short row's valid steps come last."""
    got = _run_both("lstm", use_peep=use_peep, is_reverse=is_reverse)
    for i, (n, a, b) in enumerate(zip(got["port_names"], got["port"],
                                      got["jax"])):
        np.testing.assert_allclose(a, b, atol=FWD_ATOL if i < 2 else GRAD_ATOL,
                                   rtol=0, err_msg=n)
    hs = got["port"][0]
    assert np.all(hs[2] == 0)                            # length 0
    assert np.all(hs[3, 1:] == 0) and np.any(hs[3, 0] != 0)   # length 1


@pytest.mark.parametrize("pool_type", ["average", "sum", "sqrt", "max",
                                       "last", "first"])
def test_sequence_pool_matches_jax(pool_type):
    """Output and weight gradient of each pool type over ragged lengths
    (0 and T included), atol 1e-5; "last" reads step max(len - 1, 0)."""
    got = _run_both(pool_type)
    for n, a, b in zip(got["port_names"], got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, atol=FWD_ATOL, rtol=0, err_msg=n)
