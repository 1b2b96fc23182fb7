"""The bfloat16 flash backward kernels of paddle_tpu_torch
(``flash_bwd_dkdv_bf16_kernel``, ``flash_bwd_dq_bf16_kernel`` in
``ops/csrc/flash_attention.cu``) transcribed on the CPU.

The kernels run only on the card, where ``chip_smoke.py`` holds them
against the plain versions.  Here their walk is transcribed lane by lane,
with the tile constants and the shared-memory leading dimension read from
the source, and held against the plain versions (``_bwd_dkdv_blockwise``,
``_bwd_dq_blockwise`` of ``ops/attention.py``, which
``tests/test_torch_flash.py`` holds against the Pallas kernels):

* the schedule: one block per (row of N, tile) in launch order, the
  longest causal columns (dK/dV) or rows (dQ) first, the causal tile skip,
  a two-stage ring whose stages alternate, zero-filled rows past the
  ragged edge and NaN everywhere no copy wrote (the row padding, a stage
  not yet loaded), so a read of the wrong place shows;
* ``ldmatrix`` (``.x4``, with and without ``.trans``) from each lane's
  address as the kernel computes it (``a_frag``, also for .trans, and
  ``b_pair``), and ``mma.sync.m16n8k16`` through the A, B and C lane maps
  of the PTX ISA, each map checked to cover its tile exactly once;
* p = 2^(s scale log2(e) - lse log2(e)) and dS (p^T and dS^T in dK/dV)
  computed in the C fragments with the masks of the kernel (lse and delta
  per column in dK/dV, per row in dQ), rounded to bfloat16 and reused as
  A fragments (two m16n8 C tiles make one m16n8k16 A fragment);
* every output element stored once, from its fragment, rounded once.

The limit is ``chip_smoke.py``'s for the bfloat16 backward: element by
element, 2u |g| + 1e-3 max |g| with u = 2^-8."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as TA

CU = Path(TA.__file__).parent / "csrc" / "flash_attention.cu"
BF16_U = 2.0 ** -8     # bfloat16's unit roundoff
# the sums' share of the limit, as chip_smoke.py sets it
BF16_SUM_REL = float(re.search(
    r"^FLASH_BWD_BF16_SUM_REL = (\S+)$",
    (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text(),
    re.M).group(1))
SMEM_MAX = 232448      # an H100 block's shared memory at most, in bytes
WARPS = 4              # 128 threads a block
LOG2E = float(np.float32(1.4426950408889634))   # kLog2e

# ------------------------------------------------------------ tile constants


def _tiles(kernel: str, D: int) -> dict:
    """The tiles of the bfloat16 backward kernels: dK/dV's (keys of a
    block, queries of a Q tile) and dQ's (queries of a block, keys of a K/V
    tile), with the bf16 tiles' leading dimension in elements
    (``BwdDkdvBF16<D>``, ``BwdDqBF16<D>``;
    test_tiles_match_cuda_source pins them)."""
    narrow = 32 if D == 128 else 64
    if kernel == "dkdv":
        return {"BK": 64, "BQ": narrow, "LD": D + 8}
    return {"BQ": 64, "BK": narrow, "LD": D + 8}


def _struct(name: str) -> str:
    m = re.search(r"struct " + name + r" \{(.*?)\n\};", CU.read_text(), re.S)
    assert m is not None, name
    return m.group(1)


def _declared(name: str, D: int) -> dict:
    """BK, BQ, LD and kSmemBytes as ``name``<D> declares them."""
    body = _struct(name)
    out = {}
    for key in ("BK", "BQ", "LD", "kSmemBytes"):
        m = re.search(r"static constexpr int " + key + r"\s*=\s*([^;]+);",
                      body)
        assert m is not None, (name, key)
        expr = re.sub(r"D == 128 \? (\d+) : (\d+)",
                      lambda g: g.group(1) if D == 128 else g.group(2),
                      m.group(1))
        out[key] = int(eval(expr, {}, dict(out, D=D)))
    return out


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_tiles_match_cuda_source(D):
    """:func:`_tiles` gives the tiles and the leading dimension the structs
    declare, and their shared memory is the layout the transcription
    walks (dK/dV: K, V, two stages of Q and G in bf16, two stages of lse
    and delta in float32; dQ: Q, G and two stages of K and V), within an
    H100 block's limit."""
    dkdv, dq = _declared("BwdDkdvBF16", D), _declared("BwdDqBF16", D)
    want = _tiles("dkdv", D)
    assert {k: dkdv[k] for k in want} == want
    want = _tiles("dq", D)
    assert {k: dq[k] for k in want} == want
    assert dkdv["kSmemBytes"] == (2 * (2 * dkdv["BK"] + 4 * dkdv["BQ"])
                                  * dkdv["LD"] + 4 * 4 * dkdv["BQ"])
    assert dq["kSmemBytes"] == 2 * (2 * dq["BQ"] + 4 * dq["BK"]) * dq["LD"]
    assert max(dkdv["kSmemBytes"], dq["kSmemBytes"]) <= SMEM_MAX
    # four warps of 16 rows own a block's rows; whole m16n8k16 steps
    assert dkdv["BK"] == dq["BQ"] == 16 * WARPS
    assert dkdv["BQ"] % 16 == 0 and dq["BK"] % 16 == 0


def test_kernels_are_the_ones_the_launchers_run():
    """The bf16 branches of dkdv() and dq() launch these kernels on their
    structs' grids with 128 threads, and the old kernels are gone."""
    src = CU.read_text()
    for kern, struct, grid in (("flash_bwd_dkdv_bf16_kernel", "BwdDkdvBF16",
                                "n_kt = (Tk + G::BK - 1) / G::BK"),
                               ("flash_bwd_dq_bf16_kernel", "BwdDqBF16",
                                "n_qt = (Tq + G::BQ - 1) / G::BQ")):
        m = re.search(r"using G = " + struct + r"<D>;\s*auto kern = "
                      + kern + r"<D>;(.*?)return \(int\)cudaGetLastError",
                      src, re.S)
        assert m is not None, kern
        assert grid in m.group(1) and "kFwdThreads" in m.group(1)
    assert "kFwdThreads = 128;" in src
    assert "recompute_p_ds" not in src and "load_tile_t" not in src


# ------------------------------------------------------ the warp's machinery

LANE = torch.arange(32)
GRP, QUAD = LANE // 4, LANE % 4
_I4, _E2 = torch.arange(4), torch.arange(2)
# mma.sync.m16n8k16 with bf16 A (row) and B (col), f32 C: (row, column) of
# each register's element(s)
A_ROW = (GRP[:, None, None] + 8 * (_I4 % 2)[None, :, None]
         + 0 * _E2).expand(32, 4, 2)
A_COL = 2 * QUAD[:, None, None] + 8 * (_I4 // 2)[None, :, None] + _E2
B_K = (2 * QUAD[:, None, None] + 8 * _E2[None, :, None]
       + _E2[None, None, :])                          # [lane, reg, half]
B_N = GRP[:, None, None].expand(32, 2, 2)
C_ROW = GRP[:, None] + 8 * (_I4 // 2)[None, :]        # [lane, element]
C_COL = 2 * QUAD[:, None] + (_I4 % 2)[None, :]


def test_mma_lane_maps_cover_each_tile_once():
    for rows, cols, shape in ((A_ROW, A_COL, (16, 16)), (B_K, B_N, (16, 8)),
                              (C_ROW, C_COL, (16, 8))):
        seen = torch.zeros(shape, dtype=torch.int64)
        seen.index_put_((rows.reshape(-1), cols.reshape(-1)),
                        torch.ones(rows.numel(), dtype=torch.int64),
                        accumulate=True)
        assert bool((seen == 1).all())


def mma(c, a, b):
    """``mma_bf16``: c [..., 32, 4] += A . B for one 16 x 8 tile, k = 16,
    from a [..., 32, 4, 2] and b [..., 32, 2, 2] (bf16 values) through the
    lane maps; the products are exact in float32."""
    pre = c.shape[:-2]
    A = torch.full(pre + (16, 16), float("nan"))
    A[..., A_ROW, A_COL] = a
    B = torch.full(pre + (16, 8), float("nan"))
    B[..., B_K, B_N] = b
    C = torch.full(pre + (16, 8), float("nan"))
    C[..., C_ROW, C_COL] = c
    return (C + A @ B)[..., C_ROW, C_COL]


def ldmatrix_x4(smem, off, trans=False):
    """``ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16``: lane L gives
    the address ``off`` [..., 32] (elements of the flat bf16 tile ``smem``
    [B, n]) of row L % 8 of matrix L // 8; register i of lane L receives
    row L // 4 of matrix i (of its transpose with .trans), elements
    2 (L % 4) and 2 (L % 4) + 1.  Returns [B, ..., 32, 4, 2]."""
    assert bool((off % 8 == 0).all()), "ldmatrix rows are 16-byte aligned"
    data = smem[:, off[..., None] + torch.arange(8)]      # [B, ..., 32, 8]
    mats = data.reshape(data.shape[:-2] + (4, 8, 8))
    if trans:
        mats = mats.transpose(-1, -2)
    cols = 2 * QUAD[:, None, None] + _E2[None, None, :]
    return mats[..., _I4[None, :, None], GRP[:, None, None], cols]


def a_frag(base, r0, c0, LD):
    """The kernel's ``a_frag``: the A fragment of rows [r0, r0 + 16),
    columns [c0, c0 + 16) of a row-major tile at ``base``."""
    return base + (r0 + (LANE & 15)) * LD + c0 + (LANE >> 4) * 8


def b_pair(base, r0, c0, LD):
    """``b_pair``: B fragments of two 8-row tiles of a [n][k] tile."""
    return (base + (r0 + (LANE & 7) + ((LANE >> 4) << 3)) * LD + c0
            + ((LANE >> 3) & 1) * 8)


def c_to_a(c, kk):
    """``c_to_a``: the A fragment of k-step kk from C tiles 2 kk, 2 kk + 1
    (c [..., NT, 32, 4]), rounded to bfloat16."""
    a = torch.stack([c[..., 2 * kk, :, 0:2], c[..., 2 * kk, :, 2:4],
                     c[..., 2 * kk + 1, :, 0:2], c[..., 2 * kk + 1, :, 2:4]],
                    dim=-2)
    return a.to(torch.bfloat16).float()


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_ldmatrix_phases_hit_eight_bank_groups(D):
    """Each 8-lane phase of every ldmatrix the kernels issue reads 8 rows
    of 16 bytes from 8 different groups of 4 banks (no conflict), at the
    leading dimension both structs declare."""
    for kernel in ("dkdv", "dq"):
        LD = _tiles(kernel, D)["LD"]
        for fn in (a_frag, b_pair):
            for r0 in (0, 16, 48):
                for c0 in range(0, D, 16):
                    byte = fn(0, r0, c0, LD) * 2
                    for ph in range(4):
                        groups = (byte[8 * ph:8 * ph + 8] // 16) % 8
                        assert len(set(groups.tolist())) == 8, (
                            kernel, fn.__name__, D, r0, c0, ph)


# -------------------------------------------------- the kernels transcribed


class _Smem:
    """A block's shared memory, one per row of N: flat bf16 tiles as
    float32, NaN until a copy writes them."""

    def __init__(self, B: int, elems: int):
        self.bf = torch.full((B, elems), float("nan"))

    def async_tile(self, dst, src, row0, rows, ROWS, LD):
        """``async_tile``: rows [row0, row0 + ROWS) of src [B, T, D] at
        element ``dst`` with leading dimension LD, zero past ``rows``; the
        row padding is left as it was."""
        D = src.shape[2]
        for r in range(ROWS):
            gr = row0 + r
            self.bf[:, dst + r * LD:dst + r * LD + D] = (
                src[:, gr].float() if gr < rows else 0.0)


def _stats_tile(x, row0, rows, ROWS):
    """``async_stats``: x [B, T] rows [row0, row0 + ROWS), zero past
    ``rows``."""
    out = torch.zeros(x.shape[0], ROWS)
    take = x[:, row0:min(row0 + ROWS, rows)]
    out[:, :take.shape[1]] = take
    return out


def _store(out, count, row, acc):
    """The bf162 stores of one fragment half: lane L of warp w writes
    acc [B, W, ND, 32, 2] to row ``row`` [B, W, 32] (none where -1),
    columns 8 t + 2 (L % 4) and the next."""
    B, W, ND = acc.shape[:3]
    shape = (B, W, ND, 32, 2)
    b = torch.arange(B)[:, None, None, None, None].expand(shape)
    r = row[:, :, None, :, None].expand(shape)
    c = (8 * torch.arange(ND)[:, None, None] + 2 * QUAD[:, None]
         + _E2).expand(shape)
    keep = r >= 0
    idx = (b[keep], r[keep], c[keep])
    out[idx] = acc[keep].to(torch.bfloat16)
    count.index_put_(idx, torch.ones(int(keep.sum()), dtype=torch.int64),
                     accumulate=True)


def dkdv_transcribed(q, k, v, g, lse, delta, scale, causal):
    """``flash_bwd_dkdv_bf16_kernel`` for every block in launch order;
    also returns the blocks' Q-tile counts in that order."""
    N, Tq, D = q.shape
    Tk = k.shape[1]
    tl = _tiles("dkdv", D)
    BK, BQ, LD = tl["BK"], tl["BQ"], tl["LD"]
    KS, NQ, QS, ND = D // 16, BQ // 8, BQ // 16, D // 8
    n_kt = -(-Tk // BK)
    n_qt = -(-Tq // BQ)
    k_s, v_s = 0, BK * LD
    q_s, g_s = 2 * BK * LD, 2 * BK * LD + 2 * BQ * LD
    warp = torch.arange(WARPS)[:, None]                    # [W, 1]
    kr = warp * 16 + GRP[None, :]                          # [W, 32]
    sl2 = float(np.float32(scale) * np.float32(LOG2E))
    dk = torch.full((N, Tk, D), float("nan"), dtype=torch.bfloat16)
    dv = dk.clone()
    count_k = torch.zeros(N, Tk, D, dtype=torch.int64)
    count_v = count_k.clone()
    work = []
    # blockIdx = kt * N + n: every n of one K tile runs at once here
    for kt in range(n_kt):
        k0 = kt * BK
        qt0 = k0 // BQ if causal else 0
        work.append(max(n_qt - qt0, 0))
        sm = _Smem(N, 2 * BK * LD + 4 * BQ * LD)
        lse_s = torch.full((N, 2, BQ), float("nan"))
        dl_s = lse_s.clone()
        sm.async_tile(k_s, k, k0, Tk, BK, LD)
        sm.async_tile(v_s, v, k0, Tk, BK, LD)
        sm.async_tile(q_s, q, qt0 * BQ, Tq, BQ, LD)
        sm.async_tile(g_s, g, qt0 * BQ, Tq, BQ, LD)
        lse_s[:, 0] = _stats_tile(lse, qt0 * BQ, Tq, BQ)
        dl_s[:, 0] = _stats_tile(delta, qt0 * BQ, Tq, BQ)
        dka = torch.zeros(N, WARPS, ND, 32, 4)
        dva = torch.zeros(N, WARPS, ND, 32, 4)
        for qt in range(qt0, n_qt):
            st = (qt - qt0) & 1
            if qt + 1 < n_qt:
                nx, q1 = st ^ 1, (qt + 1) * BQ
                sm.async_tile(q_s + nx * BQ * LD, q, q1, Tq, BQ, LD)
                sm.async_tile(g_s + nx * BQ * LD, g, q1, Tq, BQ, LD)
                lse_s[:, nx] = _stats_tile(lse, q1, Tq, BQ)
                dl_s[:, nx] = _stats_tile(delta, q1, Tq, BQ)
            qb, gb = q_s + st * BQ * LD, g_s + st * BQ * LD
            lb, db = lse_s[:, st], dl_s[:, st]
            q0 = qt * BQ
            sT = torch.zeros(N, WARPS, NQ, 32, 4)
            dpT = torch.zeros(N, WARPS, NQ, 32, 4)
            for ks in range(KS):
                ka = ldmatrix_x4(sm.bf, a_frag(k_s, warp * 16, ks * 16, LD))
                va = ldmatrix_x4(sm.bf, a_frag(v_s, warp * 16, ks * 16, LD))
                for jp in range(NQ // 2):
                    b = ldmatrix_x4(sm.bf, b_pair(qb, jp * 16, ks * 16,
                                                  LD).expand(WARPS, 32))
                    sT[:, :, 2 * jp] = mma(sT[:, :, 2 * jp], ka,
                                           b[..., 0:2, :])
                    sT[:, :, 2 * jp + 1] = mma(sT[:, :, 2 * jp + 1], ka,
                                               b[..., 2:4, :])
                    b = ldmatrix_x4(sm.bf, b_pair(gb, jp * 16, ks * 16,
                                                  LD).expand(WARPS, 32))
                    dpT[:, :, 2 * jp] = mma(dpT[:, :, 2 * jp], va,
                                            b[..., 0:2, :])
                    dpT[:, :, 2 * jp + 1] = mma(dpT[:, :, 2 * jp + 1], va,
                                                b[..., 2:4, :])
            # p^T and dS^T: rows are keys, columns queries (lse and delta
            # per column)
            for j in range(NQ):
                c = 8 * j + C_COL                                  # [32, 4]
                qp = q0 + c
                kp = k0 + kr[:, :, None] + 8 * (_I4 // 2)          # [W,32,4]
                ok = (qp < Tq) & (kp < Tk)
                if causal:
                    ok = ok & (qp >= kp)
                ls2 = lb[:, c][:, None] * LOG2E                  # [B,1,32,4]
                dl = db[:, c][:, None]
                p = torch.where(ok, torch.exp2(sT[:, :, j] * sl2 - ls2), 0.0)
                sT[:, :, j] = p
                dpT[:, :, j] = p * (dpT[:, :, j] - dl) * scale
            for kk in range(QS):
                pa, da = c_to_a(sT, kk), c_to_a(dpT, kk)
                for tp in range(ND // 2):
                    b = ldmatrix_x4(sm.bf, a_frag(gb, kk * 16, tp * 16,
                                                   LD).expand(WARPS, 32),
                                    trans=True)
                    dva[:, :, 2 * tp] = mma(dva[:, :, 2 * tp], pa,
                                            b[..., 0:2, :])
                    dva[:, :, 2 * tp + 1] = mma(dva[:, :, 2 * tp + 1], pa,
                                                b[..., 2:4, :])
                    b = ldmatrix_x4(sm.bf, a_frag(qb, kk * 16, tp * 16,
                                                   LD).expand(WARPS, 32),
                                    trans=True)
                    dka[:, :, 2 * tp] = mma(dka[:, :, 2 * tp], da,
                                            b[..., 0:2, :])
                    dka[:, :, 2 * tp + 1] = mma(dka[:, :, 2 * tp + 1], da,
                                                b[..., 2:4, :])
        for h in range(2):
            kp = (k0 + kr + 8 * h).expand(N, WARPS, 32)
            row = torch.where(kp < Tk, kp, -1)
            _store(dk, count_k, row, dka[..., 2 * h:2 * h + 2])
            _store(dv, count_v, row, dva[..., 2 * h:2 * h + 2])
    assert bool((count_k == 1).all() and (count_v == 1).all()), \
        "each dk and dv element stored once"
    return dk, dv, work


def dq_transcribed(q, k, v, g, lse, delta, scale, causal):
    """``flash_bwd_dq_bf16_kernel`` for every block in launch order; also
    returns the blocks' K/V-tile counts in that order."""
    N, Tq, D = q.shape
    Tk = k.shape[1]
    tl = _tiles("dq", D)
    BQ, BK, LD = tl["BQ"], tl["BK"], tl["LD"]
    KS, NK, KK, ND = D // 16, BK // 8, BK // 16, D // 8
    n_qt = -(-Tq // BQ)
    q_s, g_s = 0, BQ * LD
    k_s, v_s = 2 * BQ * LD, 2 * BQ * LD + 2 * BK * LD
    warp = torch.arange(WARPS)[:, None]
    sl2 = float(np.float32(scale) * np.float32(LOG2E))
    dq = torch.full((N, Tq, D), float("nan"), dtype=torch.bfloat16)
    count = torch.zeros(N, Tq, D, dtype=torch.int64)
    work = []
    # blockIdx = i * N + n with qt = n_qt - 1 - i: the longest rows first
    for i in range(n_qt):
        qt = n_qt - 1 - i
        q0 = qt * BQ
        r0 = q0 + warp * 16 + GRP[None, :]                  # [W, 32]
        n_kt = -(-Tk // BK)
        if causal:
            n_kt = min(n_kt, (min(q0 + BQ, Tq) - 1) // BK + 1)
        work.append(n_kt)
        sm = _Smem(N, 2 * BQ * LD + 4 * BK * LD)
        sm.async_tile(q_s, q, q0, Tq, BQ, LD)
        sm.async_tile(g_s, g, q0, Tq, BQ, LD)
        sm.async_tile(k_s, k, 0, Tk, BK, LD)
        sm.async_tile(v_s, v, 0, Tk, BK, LD)
        rows = r0[:, :, None] + 8 * (_I4 // 2)             # [W, 32, 4]
        inside = rows < Tq
        ls2 = torch.where(inside, lse[:, rows.clamp(max=Tq - 1)] * LOG2E,
                          0.0)
        dl = torch.where(inside, delta[:, rows.clamp(max=Tq - 1)], 0.0)
        dqa = torch.zeros(N, WARPS, ND, 32, 4)
        for kt in range(n_kt):
            k0 = kt * BK
            if kt + 1 < n_kt:
                nx = (kt + 1) & 1
                sm.async_tile(k_s + nx * BK * LD, k, k0 + BK, Tk, BK, LD)
                sm.async_tile(v_s + nx * BK * LD, v, k0 + BK, Tk, BK, LD)
            if kt == 0:
                qf = [ldmatrix_x4(sm.bf, a_frag(q_s, warp * 16, ks * 16, LD))
                      for ks in range(KS)]
                gf = [ldmatrix_x4(sm.bf, a_frag(g_s, warp * 16, ks * 16, LD))
                      for ks in range(KS)]
            kb, vb = k_s + (kt & 1) * BK * LD, v_s + (kt & 1) * BK * LD
            s = torch.zeros(N, WARPS, NK, 32, 4)
            dp = torch.zeros(N, WARPS, NK, 32, 4)
            for ks in range(KS):
                for jp in range(NK // 2):
                    b = ldmatrix_x4(sm.bf, b_pair(kb, jp * 16, ks * 16,
                                                  LD).expand(WARPS, 32))
                    s[:, :, 2 * jp] = mma(s[:, :, 2 * jp], qf[ks],
                                          b[..., 0:2, :])
                    s[:, :, 2 * jp + 1] = mma(s[:, :, 2 * jp + 1], qf[ks],
                                              b[..., 2:4, :])
                    b = ldmatrix_x4(sm.bf, b_pair(vb, jp * 16, ks * 16,
                                                  LD).expand(WARPS, 32))
                    dp[:, :, 2 * jp] = mma(dp[:, :, 2 * jp], gf[ks],
                                           b[..., 0:2, :])
                    dp[:, :, 2 * jp + 1] = mma(dp[:, :, 2 * jp + 1], gf[ks],
                                               b[..., 2:4, :])
            # dS in place of dP (lse and delta per row)
            for j in range(NK):
                kp = k0 + 8 * j + C_COL                             # [32, 4]
                ok = inside & (kp < Tk)
                if causal:
                    ok = ok & (rows >= kp)
                p = torch.where(ok, torch.exp2(s[:, :, j] * sl2 - ls2), 0.0)
                dp[:, :, j] = p * (dp[:, :, j] - dl) * scale
            for kk in range(KK):
                da = c_to_a(dp, kk)
                for tp in range(ND // 2):
                    b = ldmatrix_x4(sm.bf, a_frag(kb, kk * 16, tp * 16,
                                                   LD).expand(WARPS, 32),
                                    trans=True)
                    dqa[:, :, 2 * tp] = mma(dqa[:, :, 2 * tp], da,
                                            b[..., 0:2, :])
                    dqa[:, :, 2 * tp + 1] = mma(dqa[:, :, 2 * tp + 1], da,
                                                b[..., 2:4, :])
        for h in range(2):
            qp = (r0 + 8 * h).expand(N, WARPS, 32)
            _store(dq, count, torch.where(qp < Tq, qp, -1),
                   dqa[..., 2 * h:2 * h + 2])
    assert bool((count == 1).all()), "each dq element stored once"
    return dq, work


def _inputs(N, Tq, Tk, D, causal, seed):
    rng = np.random.RandomState(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    q, k, v, g = mk(N, Tq, D), mk(N, Tk, D), mk(N, Tk, D), mk(N, Tq, D)
    scale = D ** -0.5
    o, lse = TA._fwd_reference(q, k, v, scale, causal)
    delta = (o.float() * g.float()).sum(dim=-1)
    return q, k, v, g, lse, delta, scale


def _assert_within_limit(name, got, want):
    """chip_smoke's bfloat16 backward limit, element by element."""
    assert got.dtype == torch.bfloat16
    gf, wf = got.float(), want.float()
    assert bool(torch.isfinite(gf).all()), name
    tol = 2 * BF16_U * wf.abs() + BF16_SUM_REL * float(wf.abs().max())
    worst = float(((gf - wf).abs() / (tol + 1e-30)).max())
    assert worst <= 1.0, (name, worst)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("Tq,Tk", [(37, 37), (50, 70)])
@pytest.mark.parametrize("causal", [False, True])
def test_transcribed_kernels_match_plain_versions(Tq, Tk, causal, D):
    """Both kernels, transcribed, against ``_bwd_dkdv_blockwise`` and
    ``_bwd_dq_blockwise`` on the same bf16 (q, k, v, g) and the plain
    forward's lse and delta, for a ragged T (one partial tile) and
    Tq != Tk (two K tiles, causal top-left)."""
    args = _inputs(2, Tq, Tk, D, causal, Tq + 3 * Tk + D)
    q, k, v, g, lse, delta, scale = args
    dk, dv, _ = dkdv_transcribed(q, k, v, g, lse, delta, scale, causal)
    dq, _ = dq_transcribed(q, k, v, g, lse, delta, scale, causal)
    pk, pv = TA._bwd_dkdv_blockwise(q, k, v, g, lse, delta, scale, causal,
                                    128)
    pq = TA._bwd_dq_blockwise(q, k, v, g, lse, delta, scale, causal, 128)
    for name, got, want in (("dk", dk, pk), ("dv", dv, pv), ("dq", dq, pq)):
        _assert_within_limit(name, got, want)


@pytest.mark.parametrize("D", [16, 128])
def test_causal_schedule_skips_tiles_and_runs_longest_first(D):
    """Several tiles (T = 200): the blocks in launch order carry
    non-increasing work, the first one every tile of its row or column
    and the causal skip the rest (dK/dV from the diagonal Q tile on, dQ up
    to its diagonal K/V tile), and the results hold the limit."""
    T = 200
    q, k, v, g, lse, delta, scale = _inputs(1, T, T, D, True, 5 + D)
    dk, dv, work_kv = dkdv_transcribed(q, k, v, g, lse, delta, scale, True)
    dq, work_q = dq_transcribed(q, k, v, g, lse, delta, scale, True)
    kv, qt = _tiles("dkdv", D), _tiles("dq", D)
    assert work_kv == [-(-T // kv["BQ"]) - k0 // kv["BQ"]
                       for k0 in range(0, T, kv["BK"])]
    assert work_q == [min(-(-T // qt["BK"]), (min(q0 + qt["BQ"], T) - 1)
                          // qt["BK"] + 1)
                      for q0 in reversed(range(0, T, qt["BQ"]))]
    assert work_kv == sorted(work_kv, reverse=True)
    assert work_q == sorted(work_q, reverse=True)
    pk, pv = TA._bwd_dkdv_blockwise(q, k, v, g, lse, delta, scale, True, 128)
    pq = TA._bwd_dq_blockwise(q, k, v, g, lse, delta, scale, True, 128)
    for name, got, want in (("dk", dk, pk), ("dv", dv, pv), ("dq", dq, pq)):
        _assert_within_limit(name, got, want)


def test_dtype_counts_sit_beside_the_launch_counts():
    """``flash_attention.dtype_launches`` holds, for each dtype the kernels
    take, one count per kernel of ``flash_attention.launches``, and a
    forward and backward on CPU tensors (the plain versions) moves none of
    them, in either dtype."""
    from paddle_tpu_torch.ops import flash_attention

    assert set(flash_attention.dtype_launches) == {"float32", "bfloat16"}
    for counts in flash_attention.dtype_launches.values():
        assert set(counts) == set(flash_attention.launches)
    before = {dt: dict(c) for dt, c in flash_attention.dtype_launches.items()}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (t.to(dt).requires_grad_(True)
                   for t in _inputs(1, 20, 20, 16, True, 3)[:3])
        flash_attention(q, k, v, causal=True).float().sum().backward()
    assert flash_attention.dtype_launches == before
