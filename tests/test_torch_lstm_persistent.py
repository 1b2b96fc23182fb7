"""The persistent route of paddle_tpu_torch's LSTM kernels, on the CPU.

The kernels (``csrc/lstm.cu``: ``lstm_fwd_persistent``,
``lstm_bwd_persistent``) run only on the card, where ``chip_smoke.py``
holds them against the plain versions.  Here a torch transcription of
their schedule is held against the plain versions (``_lstm_scan``,
``_lstm_scan_vjp``), with the JAX package's ``fused_lstm`` as the anchor:
blocks of 32 rows x 16 units, each with its U slice, its warps' depth
ranges and their partial sums added in the kernels' order, and the
per-row-group barrier.  The blocks run one step at a time in a random
order, any block whose row group's counter allows it (so one row group
may run steps ahead of another), and every value one block writes for
another (h of the forward, dgates of the reverse) reads as NaN until its
writer has arrived at the barrier: a read before the barrier, of the
wrong slot or of another row group shows as NaN in the outputs.

Also here: ``lstm_route`` at the shapes the port runs, the tile and
shared-memory constants against the ``.cu``, the reverse's U swizzle and
the kernels' shared-memory read patterns (bank conflicts), and the
wrappers' refusals and counters on the CPU."""
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops import fused_lstm as jax_fused_lstm
from paddle_tpu_torch.ops import fused_lstm
from paddle_tpu_torch.ops import lstm as TL

SRC = (Path(TL.__file__).parent / "csrc" / "lstm.cu").read_text()
H100 = dict(n_sm=132, smem_optin=232448)   # an H100's limits
ACTS = ("sigmoid", "tanh", "tanh")
FWD_ATOL, GRAD_ATOL = 1e-5, 1e-4
# (T, B, H): two row groups (the second ragged) x two unit tiles (the
# second ragged, warps past H padding), and a depth over two warp ranges
SHAPES = [(6, 40, 24), (5, 35, 72)]


def _inputs(T, B, H, seed):
    rng = np.random.RandomState(seed)
    xw = rng.standard_normal((T, B, 4 * H))
    u = rng.standard_normal((H, 4 * H)) / np.sqrt(H)
    peep = rng.standard_normal((3, H)) * 0.5
    lengths = rng.randint(0, T + 1, B)
    lengths[:2] = (T, 0)
    mask = np.arange(T)[:, None] < lengths[None, :]
    g_hs = rng.standard_normal((T, B, H))
    g_c = rng.standard_normal((B, H))
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (xw, u, peep, mask, g_hs, g_c))


class _Published:
    """A cross-block buffer: what a block writes stays in its own staging
    until it arrives at the barrier; readers see NaN until then."""

    def __init__(self, shape, init=None):
        self.seen = torch.full(shape, float("nan"))
        self.staged = self.seen.clone()
        if init is not None:
            init(self.seen)
            init(self.staged)

    def write(self, index, value):
        self.staged[index] = value

    def publish(self, index):
        self.seen[index] = self.staged[index]


def _run_blocks(n_units, n_rows, T, step, seed):
    """Run ``step(bu, br, s)`` for every block (bu, br) and step s, one
    block step at a time in a random order among the blocks whose row
    group's counter has reached n_units * s; step returns its arrival
    callback (called when s + 1 < T, as the kernels arrive)."""
    rng = np.random.RandomState(seed)
    done = {(bu, br): 0 for bu in range(n_units) for br in range(n_rows)}
    counter = [0] * n_rows
    while any(s < T for s in done.values()):
        ready = [blk for blk, s in done.items()
                 if s < T and counter[blk[1]] >= n_units * s]
        assert ready, "the barrier would deadlock"
        bu, br = ready[rng.randint(len(ready))]
        s = done[(bu, br)]
        arrive = step(bu, br, s)
        if s + 1 < T:
            arrive()
            counter[br] += 1
        done[(bu, br)] = s + 1


def _forward(xw, u, peep, mask, H, use_peep, acts, seed, run=None):
    """lstm_fwd_persistent transcribed: (hs, hc, cc, gates, cnew); ``run``
    schedules the block steps (``_run_blocks``)."""
    ga, ca, cda = (TL._ACT[a] for a in acts)
    T, B = xw.shape[:2]
    R, J, W = TL.P_ROWS, TL.P_UNITS, TL.P_WARPS
    kw = TL.fwd_warp_depth(H)
    Hp = W * kw
    hc = _Published((T + 1, B, H), lambda t: t[0].zero_())
    cc, hs = torch.zeros(T + 1, B, H), torch.zeros(T, B, H)
    gates, cnew = torch.zeros(T, B, 4 * H), torch.zeros(T, B, H)
    n_units, n_rows = -(-H // J), -(-B // R)
    state = {}

    def step(bu, br, t):
        j0, b0 = bu * J, br * R
        rows = slice(b0, min(b0 + R, B))
        units = slice(j0, min(j0 + J, H))
        nb, nj = rows.stop - b0, units.stop - j0
        us = torch.zeros(Hp, J, 4)     # U [Hp][16][4], zero past H
        for g in range(4):
            us[:H, :nj, g] = u[:, g * H + j0:g * H + units.stop]
        h_car, c_car = state.get((bu, br), (torch.zeros(nb, nj),) * 2)
        total = torch.zeros(R, J, 4)
        if t > 0:
            hb = torch.zeros(R, Hp)    # zero-filled past B and H
            hb[:nb, :H] = hc.seen[t, rows]
            for w in range(W):         # the warps' sums, in warp order
                k = slice(w * kw, (w + 1) * kw)
                total = total + torch.einsum("rk,kjg->rjg", hb[:, k], us[k])
        s = xw[t, rows].reshape(nb, 4, H)[:, :, units].permute(0, 2, 1) \
            + total[:nb, :nj]
        p0, p1, p2 = (peep[:, units] if use_peep
                      else torch.zeros(3, nj))
        cp = c_car
        i = ga(s[..., 0] + cp * p0) if use_peep else ga(s[..., 0])
        f = ga(s[..., 1] + cp * p1) if use_peep else ga(s[..., 1])
        cd = cda(s[..., 2])
        cn = f * cp + i * cd
        o = ga(s[..., 3] + cn * p2) if use_peep else ga(s[..., 3])
        hn = o * ca(cn)
        m = mask[t, rows][:, None]
        h_new, c_new = hn * m + h_car * (1 - m), cn * m + cp * (1 - m)
        state[(bu, br)] = (h_new, c_new)
        hc.write((t + 1, rows, units), h_new)
        cc[t + 1, rows, units] = c_new
        hs[t, rows, units] = hn * m
        for g, v in enumerate((i, f, cd, o)):
            gates[t, rows, g * H + j0:g * H + units.stop] = v
        cnew[t, rows, units] = cn
        return lambda: hc.publish((t + 1, rows, units))

    (run or _run_blocks)(n_units, n_rows, T, step, seed)
    return hs, hc.staged, cc, gates, cnew


def _backward(g_hs, g_c, u, peep, mask, gates, cnew, cc, H, use_peep, acts,
              seed):
    """lstm_bwd_persistent transcribed: dxw [T, B, 4H]."""
    ga, ca, cda = acts
    act_c = TL._ACT[ca]
    d = {"sigmoid": lambda y: y * (1 - y), "tanh": lambda y: 1 - y * y,
         "relu": lambda y: (y > 0).float(), "identity": torch.ones_like}
    T, B = gates.shape[:2]
    R, J, W = TL.P_ROWS, TL.P_UNITS, TL.P_WARPS
    cw, chunk, parts = TL.bwd_warp_depth(H), TL.BWD_CHUNK, TL.BWD_LANE_PARTS
    Dp = W * cw
    dxw = _Published((T, B, 4 * H))
    n_units, n_rows = -(-H // J), -(-B // R)
    state = {}

    def part_depths(w, kp):
        """The depths lane part kp of warp w multiplies: in each chunk of
        its range, four in each half."""
        return [w * cw + n * chunk + hh * chunk // 2 + kp * 4 + c4
                for n in range(cw // chunk) for hh in range(2)
                for c4 in range(4)]

    def step(bu, br, s):
        t = T - 1 - s
        j0, b0 = bu * J, br * R
        rows = slice(b0, min(b0 + R, B))
        units = slice(j0, min(j0 + J, H))
        nb, nj = rows.stop - b0, units.stop - j0
        us = torch.zeros(Dp, J)        # U rows of the tile, [Dp][16]
        us[:4 * H, :nj] = u[units].t()
        dh_car, dc_car = state.get((bu, br), (torch.zeros(nb, nj),
                                              g_c[rows, units].clone()))
        dh = torch.zeros(nb, nj)
        if s > 0:
            dg = torch.zeros(R, Dp)    # zero-filled past B and 4H
            dg[:nb, :4 * H] = dxw.seen[t + 1, rows]
            total = torch.zeros(R, J)
            for w in range(W):         # the 32 parts, in order
                for kp in range(parts):
                    c = part_depths(w, kp)
                    total = total + dg[:, c] @ us[c]
            dh = total[:nb, :nj] + dh_car * (1 - mask[t + 1, rows][:, None])
        gr = gates[t, rows].reshape(nb, 4, H)[:, :, units]
        i, f, cd, o = gr.unbind(1)
        cn, cp = cnew[t, rows, units], cc[t, rows, units]
        m = mask[t, rows][:, None]
        p0, p1, p2 = (peep[:, units] if use_peep else torch.zeros(3, nj))
        dhn = (g_hs[t, rows, units] + dh) * m
        ch = act_c(cn)
        dcn = dc_car * m + dhn * o * d[ca](ch)
        dzo = dhn * ch * d[ga](o)
        dcn = dcn + dzo * p2
        dzi, dzf = dcn * cd * d[ga](i), dcn * cp * d[ga](f)
        dzc = dcn * i * d[cda](cd)
        dcp = dcn * f + dc_car * (1 - m) + dzi * p0 + dzf * p1
        state[(bu, br)] = (dh, dcp)
        for g, v in enumerate((dzi, dzf, dzc, dzo)):
            dxw.write((t, rows, slice(g * H + j0, g * H + units.stop)), v)
        return lambda: [dxw.publish((t, rows, slice(g * H + j0,
                                                    g * H + units.stop)))
                        for g in range(4)]

    _run_blocks(n_units, n_rows, T, step, seed)
    return dxw.staged


@pytest.mark.parametrize("order_seed", [0, 1])
@pytest.mark.parametrize("use_peep", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"T{t}B{b}H{h}"
                                               for t, b, h in SHAPES])
def test_persistent_schedule_matches_plain_versions(monkeypatch, shape,
                                                    use_peep, order_seed):
    """The persistent forward against ``_lstm_scan`` and JAX's fused_lstm
    (atol 1e-5), then ``lstm_bwd_cuda`` with the reverse kernel swapped for
    the persistent transcription against ``_lstm_scan_vjp`` (dxw, du,
    dpeep, atol 1e-4), blocks in a random order with every cross-block
    value NaN until published."""
    T, B, H = shape
    xw, u, peep, mask, g_hs, g_c = _inputs(T, B, H, 3 + H)
    hs, hc, cc, gates, cnew = _forward(xw, u, peep, mask, H, use_peep, ACTS,
                                       order_seed)
    want_hs, want_c = TL._lstm_scan(xw, u, peep, mask, H, use_peep, ACTS)
    for got, want in ((hs, want_hs), (cc[-1], want_c), (hc[1:], None)):
        assert torch.isfinite(got).all()
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=FWD_ATOL, rtol=0)
    jhs, jc = jax_fused_lstm(*(jnp.asarray(a.numpy())
                               for a in (xw, u, peep, mask)), size=H,
                             use_peepholes=use_peep)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), atol=FWD_ATOL,
                               rtol=0)
    np.testing.assert_allclose(cc[-1].numpy(), np.asarray(jc), atol=FWD_ATOL,
                               rtol=0)

    def kernel(g_hs, g_c, u, peep, mask, gates, cnew, cc, size, use_peep,
               acts):
        return _backward(g_hs, g_c, u, peep, mask, gates, cnew, cc, size,
                         use_peep, acts, order_seed)

    monkeypatch.setattr(TL, "lstm_bwd_kernel", kernel)
    got = TL.lstm_bwd_cuda(g_hs, g_c, u, peep, mask, hc, cc, gates, cnew, H,
                           use_peep, ACTS)
    want = TL._lstm_scan_vjp(xw, u, peep, mask, H, use_peep, ACTS, g_hs, g_c)
    for name, a, b in zip(("dxw", "du", "dpeep"), got, want):
        assert torch.isfinite(a).all(), name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_a_read_before_the_barrier_shows():
    """The transcription's poison works: the forward with its wait dropped
    (blocks of a row group in any order in one step, reading h a step
    early) gives NaN."""
    T, B, H = 4, 8, 32
    xw, u, peep, mask, _, _ = _inputs(T, B, H, 0)
    mask[:] = 1

    def early(n_units, n_rows, T_, step, seed):
        # every block of step s runs before anyone arrives from step s - 1
        arrivals = []
        for s in range(T_):
            for blk in [(bu, br) for br in range(n_rows)
                        for bu in range(n_units)][::-1]:
                arrivals.append(step(*blk, s))
            if s == 0:
                continue
            for a in arrivals:
                a()
            arrivals = []

    hs = _forward(xw, u, peep, mask, H, False, ACTS, 0, run=early)[0]
    assert torch.isnan(hs).any()
    hs = _forward(xw, u, peep, mask, H, False, ACTS, 0)[0]
    assert torch.isfinite(hs).all()


# ------------------------------------------------------------ routes


@pytest.mark.parametrize("T,B,H,route", [
    (100, 128, 512, "persistent"),   # text_lstm's layers: 32 x 4 blocks
    (100, 16, 512, "persistent"),    # chip_smoke's parity step
    (37, 3, 40, "persistent"),       # chip_smoke's dynamic_lstm layer case
    (1, 32, 576, "persistent"),      # the widest tile that fits
    (100, 256, 512, "step"),         # 256 blocks on 132 SMs
    (100, 128, 640, "step"),         # U slice and h over shared memory
    (9, 5, 18, "step"),              # H % 4 != 0: no 16-byte copies
])
def test_lstm_route(T, B, H, route):
    assert TL.lstm_route(T, B, H, **H100) == route


def test_lstm_route_follows_the_card():
    """The same shape on a card with fewer SMs or less shared memory."""
    assert TL.lstm_route(100, 128, 512, n_sm=100, smem_optin=232448) == "step"
    assert TL.lstm_route(100, 128, 512, n_sm=132,
                         smem_optin=TL.bwd_smem_bytes(512) - 1) == "step"
    assert TL.fwd_smem_bytes(512) == 197120
    assert TL.bwd_smem_bytes(512) == 212992


def _cu_int(name):
    hit = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert hit, name
    return hit.group(1)


def test_tile_constants_match_cuda_source():
    """The persistent tile's constants in ``ops/lstm.py`` are the ones
    ``csrc/lstm.cu`` compiles with (change both together)."""
    assert int(_cu_int("kPRows")) == TL.P_ROWS
    assert int(_cu_int("kPUnits")) == TL.P_UNITS
    assert int(_cu_int("kPThreads")) == TL.P_THREADS
    assert _cu_int("kPWarps") == "kPThreads / 32"
    assert int(_cu_int("kFwdDepthAlign")) == TL.FWD_DEPTH_ALIGN
    assert int(_cu_int("kBwdChunk")) == TL.BWD_CHUNK
    assert int(_cu_int("kBwdStages")) == TL.BWD_STAGES
    assert int(_cu_int("kBwdPitch")) == TL.BWD_PITCH
    assert int(_cu_int("kBwdLaneParts")) == TL.BWD_LANE_PARTS
    assert "return 8 * ((H + kFwdDepthAlign - 1) / kFwdDepthAlign);" in SRC
    assert "return kBwdChunk * ((H + 63) / 64);" in SRC


def _bwd_u_index():
    """``bwd_u_index`` of the .cu as a Python function (its expression is
    Python too)."""
    body = re.search(r"int bwd_u_index\(int c, int unit\) \{\s*return ([^;]+);",
                     SRC).group(1)
    return eval("lambda c, unit: " + " ".join(body.split()))


def _wavefronts(word_addresses):
    """Shared-memory passes for one warp-wide read of 4-word vectors: the
    most distinct vectors that fall on one bank."""
    per_bank = {}
    for a in set(word_addresses):
        for w in range(a, a + 4):
            per_bank.setdefault(w % 32, set()).add(a)
    return max(len(v) for v in per_bank.values())


def test_reverse_u_swizzle_is_a_bijection_without_bank_conflicts():
    """The reverse's U layout holds every (depth, unit) once in Dp x 16
    floats, keeps a unit quad contiguous (a float4), and a warp's U reads
    (4 depth parts x 2 unit quads, for each of the 8 reads of a chunk) take
    one pass."""
    idx = _bwd_u_index()
    Dp = TL.P_WARPS * TL.bwd_warp_depth(512)
    seen = {idx(c, j) for c in range(Dp) for j in range(TL.P_UNITS)}
    assert seen == set(range(Dp * TL.P_UNITS))
    for c in range(0, Dp, 7):
        for q in range(4):
            base = idx(c, 4 * q)
            assert base % 4 == 0
            assert [idx(c, 4 * q + i) for i in range(4)] == list(
                range(base, base + 4))
    for c0 in range(0, 256, 16):
        for c4 in range(4):
            for hi in (0, 8):
                reads = [idx(c0 + kp * 4 + c4, hi + ug * 4)
                         for kp in range(4) for ug in range(2)]
                assert _wavefronts(reads) == 1


def test_shared_memory_read_patterns():
    """The other float4 reads of a warp: the forward's h rows (4 row groups,
    rows Hp + 4 apart) take one pass, its U (8 unit pairs at one depth) one;
    the reverse's ring rows (4 row groups x 4 depth parts, kBwdPitch apart)
    two, the least for 16 distinct vectors."""
    for H in (40, 512, 576):
        hp = TL.P_WARPS * TL.fwd_warp_depth(H) + 4
        for k in range(0, 64, 4):
            for r in range(TL.P_ROWS // 4):
                assert _wavefronts([(rg + 4 * r) * hp + k
                                    for rg in range(4)]) == 1
        assert _wavefronts([(k * TL.P_UNITS + cg) * 4 for cg in range(8)
                            for k in (5,)]) == 1
    for hh in range(2):
        for r in range(8):
            assert _wavefronts([(rg + 4 * r) * TL.BWD_PITCH + hh * 16 + kp * 4
                                for rg in range(4) for kp in range(4)]) == 2


# ------------------------------------------------------------ wrappers


def test_cpu_calls_count_no_route_and_the_kernels_refuse():
    """On the CPU neither counter moves (the plain versions run); the kernel
    wrappers raise on a non-CUDA operand, and the dtype check on anything
    but float32."""
    before = dict(fused_lstm.route_launches), dict(fused_lstm.launches)
    xw, u, peep, mask, g_hs, g_c = _inputs(4, 3, 8, 1)
    xw.requires_grad_(True)
    hs, c = fused_lstm(xw, u, peep, mask, size=8)
    (hs.sum() + c.sum()).backward()
    assert (dict(fused_lstm.route_launches), dict(fused_lstm.launches)) \
        == before
    with pytest.raises(ValueError, match="CUDA"):
        TL.lstm_fwd_kernel(xw.detach(), u, peep, mask, 8, False, ACTS, True)
    with pytest.raises(ValueError, match="CUDA"):
        TL.lstm_bwd_kernel(g_hs, g_c, u, peep, mask, torch.zeros(4, 3, 32),
                           torch.zeros(4, 3, 8), torch.zeros(5, 3, 8), 8,
                           False, ACTS)
    for dtype in (torch.bfloat16, torch.float16, torch.float64):
        with pytest.raises(ValueError, match="take float32"):
            TL.check_lstm_dtype(dtype)
    TL.check_lstm_dtype(torch.float32)
    assert set(fused_lstm.route_launches) == {"persistent", "step"}
