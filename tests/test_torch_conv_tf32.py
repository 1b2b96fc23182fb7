"""The halo_f32 route of paddle_tpu_torch's 3x3 convolution
(``halo_f32_kernel`` in ``ops/csrc/conv.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
the plain versions.  Here:

* the split: ``cvt.rna.tf32.f32`` emulated bit for bit in numpy (add
  0x1000 to the magnitude's bits, keep the top 19), each operand split into
  hi = rna(v) and lo = rna(v - hi), and the three products lo.hi, hi.lo,
  hi.hi each taken in float32 and summed in float32, held against the
  plain versions (``igemm_conv_reference``, ``igemm_conv_fused_reference``)
  and against ``benchmark/conv_probe.py``'s Pallas kernels run by the
  interpreter, within ``CONV_F32_REL`` of max |out|.  The measured worst
  is 2.8e-7 of max |out| at these shapes, 0.014 of the limit;
* the walk: the kernel's copies (w split and packed as
  ``halo_f32_pack_w`` packs it, the raw halo as [4-channel group][point]
  [4]), its A fragments read from registers (rows lane / 4 (+ 8), channels
  lane % 4 (+ 4) of each 16-row warp slice) and its K-major B descriptors
  (no-swizzle core matrices of 8 output channels x 16 bytes, LBO along K,
  SBO along N) transcribed with the tile constants read from the source,
  and held against the plain versions;
* the shared memory of the two-stage ring at the route's pitch limit;
* the route the wrapper picks is checked in
  ``tests/test_torch_conv_halo.py::test_conv_route``."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu_torch.ops import conv as TC

REPO = Path(__file__).resolve().parents[1]
CU = REPO / "paddle_tpu_torch" / "ops" / "csrc" / "conv.cu"
CONV_F32_REL = 2e-5    # chip_smoke.py's float32 conv limit, of max |out|
TF32_U = 2.0 ** -11    # TF32's unit roundoff (10 stored mantissa bits)
SMEM_PER_SM = 232448   # an H100 block's shared memory at most, in bytes

# (N, H, W, C, O): small shapes for the split (the last the CIFAR stem's
# C = 3: the split does not need the route's channel multiples)
SPLIT_SHAPES = [(2, 8, 8, 16, 24), (1, 6, 7, 64, 64), (2, 5, 5, 3, 16)]
# the walk: several images in one tile, one image narrower than it, two
# steps of channels or more, tiles that cut across rows and images with
# three output-channel tiles
WALK_SHAPES = [(2, 8, 8, 64, 64), (3, 7, 7, 64, 128), (1, 5, 9, 128, 64),
               (2, 12, 20, 64, 192)]


@pytest.fixture(scope="module")
def probe():
    """benchmark/conv_probe.py, loaded as a module (its Pallas kernels run
    with ``interpret=True``)."""
    spec = importlib.util.spec_from_file_location(
        "conv_probe_for_tf32_tests", REPO / "benchmark" / "conv_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _consts():
    """The ``HaloF32`` tile constants of the source."""
    m = re.search(r"struct HaloF32 \{\s*static constexpr int ([^;]+);",
                  CU.read_text())
    assert m is not None
    return {k.strip(): int(v) for k, v in
            (kv.split("=") for kv in m.group(1).split(","))}


def rna_tf32(v):
    """``cvt.rna.tf32.f32``: to 10 mantissa bits, to nearest, ties away
    from zero (0x1000 added to the magnitude's bits, the low 13 cleared);
    float32 in, float32 out."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    mag = (bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)
    out = (mag & np.uint32(0xFFFFE000)) | (bits & np.uint32(0x80000000))
    return out.view(np.float32)


def split(v):
    """(hi, lo) of ``tf32_split``: hi = rna(v), lo = rna(v - hi), the
    difference taken in float32."""
    v = np.asarray(v, np.float32)
    hi = rna_tf32(v)
    return hi, rna_tf32(v - hi)


def three_pass(a, b):
    """a @ b as the kernel's three TF32 passes: lo.hi, then hi.lo, then
    hi.hi, each product of float32 operands in float32 (exact: 11 x 11
    significant bits) and the sum in float32."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = np.matmul(al, bh)
    acc = acc + np.matmul(ah, bl)
    return acc + np.matmul(ah, bh)


def _inputs(seed, shape):
    n, h, w, c, o = shape
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)).astype(
        np.float32)
    a = rng.rand(o).astype(np.float32) + 0.5
    b = (rng.standard_normal(o) * 0.3).astype(np.float32)
    return x, wt, a, b


def _conv_three_pass(x, w):
    """The nine taps of the zero-padded x, each tap's product in three
    passes, summed in float32 tap by tap."""
    n, h, wd, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((n, h, wd, w.shape[-1]), np.float32)
    for dy in range(3):
        for dx in range(3):
            acc += three_pass(xp[:, dy:dy + h, dx:dx + wd, :], w[dy, dx])
    return acc


def _fused(acc, a, b):
    """The epilogue: multiply, then add, each rounded in float32, ReLU."""
    return np.maximum((acc * a).astype(np.float32) + b, 0.0)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def test_split_is_exact_in_tf32_and_within_its_bound():
    """hi and lo have their low 13 bits clear; v = hi + lo + e with |e| <=
    u^2 |v| (u = 2^-11); a product's three passes are within 3 u^2 (1 +
    u) |a b| of a b (the dropped lo.lo and the two splits' remainders),
    over magnitudes from 2^-60 to 2^60 and both signs."""
    rng = np.random.RandomState(0)
    v = (rng.standard_normal(200000) * np.exp2(
        rng.randint(-60, 60, 200000))).astype(np.float32)
    v[:4] = [1.0, -1.0, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -12]   # ties
    hi, lo = split(v)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    assert hi[2] == 1 + 2.0 ** -10 and lo[2] == -2.0 ** -11   # away from 0
    e = np.abs(v.astype(np.float64) - hi - lo)
    assert np.all(e <= TF32_U ** 2 * np.abs(v.astype(np.float64)))
    a, b = v[:100000], v[100000:]
    (ah, al), (bh, bl) = split(a), split(b)
    exact = a.astype(np.float64) * b
    got = (al.astype(np.float64) * bh + ah.astype(np.float64) * bl
           + ah.astype(np.float64) * bh)
    assert np.all(np.abs(got - exact)
                  <= 3 * TF32_U ** 2 * (1 + TF32_U) * np.abs(exact))


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_three_passes_match_plain_versions_and_pallas(probe, shape):
    """The conv and the fused conv in three TF32 passes against the plain
    versions and the probe's interpreted Pallas kernels, within
    CONV_F32_REL of max |out|; the worst stays under a tenth of it."""
    x, w, a, b = _inputs(sum(shape) + 5, shape)
    acc = _conv_three_pass(x, w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    plain = TC.igemm_conv_reference(tx, tw).numpy()
    plain_fused = TC.igemm_conv_fused_reference(tx, tw, ta, tb).numpy()
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    pallas = np.asarray(probe.igemm_conv(jx, jw, interpret=True))
    pallas_fused = np.asarray(probe.igemm_conv_fused(
        jx, jw, jnp.asarray(a), jnp.asarray(b), interpret=True))
    worst = max(_rel(acc, plain), _rel(acc, pallas),
                _rel(_fused(acc, a, b), plain_fused),
                _rel(_fused(acc, a, b), pallas_fused))
    assert worst <= 0.1 * CONV_F32_REL, worst


def _group_stride(points: int) -> int:
    """``halo_group_stride``: the points rounded to 4 mod 8."""
    return (points + 3) // 8 * 8 + 4


def _grid_pixel(q, n, h, wd):
    """``grid_pixel``: the output pixel of grid point q, -1 for none."""
    q = np.asarray(q)
    g = wd + 2
    big_r, col = np.floor_divide(q, g), np.mod(q, g)
    img, row = big_r // (h + 1), big_r % (h + 1)
    ok = (q >= 0) & (img < n) & (row >= 1) & (col >= 1) & (col <= wd)
    return np.where(ok, (img * h + row - 1) * wd + col - 1, -1)


def _pack_w(w, bn, kc):
    """``halo_f32_pack_w``: w [3, 3, C, O] split, each (4 channels, output
    channel) unit to 16-byte unit ((((o / bn) (C / kc) + c / kc) 2 9 + tap)
    (kc / 4) + (c % kc) / 4) bn + o % bn, hi there and lo 9 (kc / 4) bn
    units on; as a flat float32 array."""
    c_in, o = w.shape[2], w.shape[3]
    hi, lo = split(w.reshape(9, c_in // 4, 4, o))
    out = np.full(2 * w.size, np.nan, np.float32).reshape(-1, 4)
    tap, cq, oo = np.meshgrid(np.arange(9), np.arange(c_in // 4),
                              np.arange(o), indexing="ij")
    c = 4 * cq
    dst = ((((oo // bn) * (c_in // kc) + c // kc) * 2 * 9 + tap)
           * (kc // 4) + (c % kc) // 4) * bn + oo % bn
    out[dst] = np.moveaxis(hi, 2, -1)
    out[dst + 9 * (kc // 4) * bn] = np.moveaxis(lo, 2, -1)
    return out.reshape(-1)


def _walk(x, w):
    """The float32 accumulator ``halo_f32_kernel`` builds (each step's
    three-pass products summed in ``part``, then added into ``acc``), and
    how many times each output pixel is written, as its copies, its
    fragment loads and its descriptors address shared memory (in floats:
    byte offsets / 4)."""
    k = _consts()
    bm, bn, kc = k["BM"], k["BN"], k["KC"]
    n, h, wd, c_in = x.shape
    o = w.shape[-1]
    g = wd + 2
    points = bm + 2 * g + 2
    gs = _group_stride(points)
    w_tap = kc * bn                     # kF32WTap / 4
    w_half = 9 * w_tap                  # kF32WHalf / 4
    w_elems = 2 * w_half                # kF32WBytes / 4
    xf = x.reshape(-1, c_in)
    wp = _pack_w(w, bn, kc)
    n_steps = c_in // kc
    acc_out = np.zeros((n * h * wd, o), np.float32)
    writes = np.zeros(n * h * wd, np.int64)
    n_rows = (n * (h + 1) - 1) * g      # grid points from row 1 on
    lane4 = np.arange(4)
    # the halo copies' destinations (grp, point)
    grp_i, p_i = np.meshgrid(np.arange(kc // 4), np.arange(points),
                             indexing="ij")
    h_dst = (w_elems + (grp_i * gs + p_i) * 4)[..., None] + lane4
    # A, row i of the tile, channel kk: thread (warp i / 16 % 4, lane
    # 4 (i % 8) + kk % 4) register (kk / 4) 2 + (i % 16) / 8 reads halo
    # float ((kk / 4) GS + p) 4 + kk % 4, p = i + shift; rows of the second
    # half of a 16-row slice are its fragment's a1 / a3 (p + 8)
    i_a, k_a = np.meshgrid(np.arange(bm), np.arange(kc), indexing="ij")
    a_off = ((k_a // 4) * gs + i_a) * 4 + k_a % 4
    # B, depth kk, column nn: K-major core matrices, LBO = BN 16 bytes
    # along K, SBO = 128 along N, 16 bytes a row
    k_b, n_b = np.meshgrid(np.arange(kc), np.arange(bn), indexing="ij")
    b_off = (k_b // 4) * (bn * 16 // 4) + (n_b // 8) * (128 // 4) \
        + (n_b % 8) * 4 + k_b % 4
    for t in range(-(-n_rows // bm)):
        q0 = g + t * bm
        src = _grid_pixel(q0 - g - 1 + np.arange(points), n, h, wd)
        dst = _grid_pixel(q0 + np.arange(bm), n, h, wd)
        for o0 in range(0, o, bn):
            acc = np.zeros((bm, bn), np.float32)
            for s in range(n_steps):
                part = np.zeros((bm, bn), np.float32)
                c0 = s * kc
                stage = np.full(w_elems + gs * kc, np.nan, np.float32)
                # the bulk copy: the packed slice of (o0 / bn, s) verbatim
                start = ((o0 // bn) * n_steps + s) * w_elems
                stage[:w_elems] = wp[start:start + w_elems]
                vals = xf[np.maximum(src, 0)[None, :, None],
                          c0 + grp_i[..., None] * 4 + lane4]
                stage[h_dst] = np.where((src >= 0)[None, :, None], vals,
                                        0.0)
                halo = stage[w_elems:]
                for tap in range(9):
                    shift = (tap // 3) * g + tap % 3
                    bh = stage[tap * w_tap + b_off]
                    bl = stage[w_half + tap * w_tap + b_off]
                    ah, al = split(halo[a_off + shift * 4])
                    part = part + np.matmul(al, bh)
                    part = part + np.matmul(ah, bl)
                    part = part + np.matmul(ah, bh)
                # the step's products promoted into the float32 sum
                acc = acc + part
            keep = dst >= 0
            acc_out[dst[keep], o0:o0 + bn] = acc[keep]
            if o0 == 0:
                np.add.at(writes, dst[keep], 1)
    return acc_out.reshape(n, h, wd, o), writes


@pytest.mark.parametrize("shape", WALK_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_walk_matches_plain_version(shape):
    """The transcribed walk, then the epilogue, against both plain
    versions within CONV_F32_REL of max |out|; every output pixel is
    written once, only the grid's pixel points are stored, and no NaN
    (an address outside what the copies wrote) reaches the sums."""
    n, h, wd, c, o = shape
    assert TC.conv_route(torch.float32, n, h, wd, c, o, True) == "halo_f32"
    x, w, a, b = _inputs(sum(shape) + 7, shape)
    acc, writes = _walk(x, w)
    assert np.array_equal(writes, np.ones_like(writes))
    assert np.isfinite(acc).all()
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert _rel(acc, TC.igemm_conv_reference(tx, tw).numpy()) \
        <= CONV_F32_REL
    assert _rel(_fused(acc, a, b),
                TC.igemm_conv_fused_reference(tx, tw, ta, tb).numpy()) \
        <= CONV_F32_REL


def test_walk_addressing_matches_source():
    """The copies', fragments' and descriptors' addressing the
    transcription uses are the ones the source writes."""
    src = CU.read_text()
    for expr in ("((((int64_t)(o / BN) * (C / KC) + c / KC) * 2 * 9 + tap) *"
                 "\n             (KC / 4) + (c % KC) / 4) * BN + o % BN;",
                 "wp[dst + 9 * (KC / 4) * BN] =",
                 "w_tile + (int64_t)s * (kF32WBytes / 4), kF32WBytes,",
                 "w_tile = wp + (int64_t)(o0 / BN) * n_steps * (kF32WBytes"
                 " / 4);",
                 "cp_async16(hb + (grp * GS + p) * 16, src, pix >= 0);",
                 "x + (int64_t)pix * C + c0 + grp * 4",
                 "const int r0 = wg * 128 + wq * 16 + (lane >> 2);",
                 "const int p = r0 + mi * 64 + (tap / 3) * G + tap % 3;",
                 "const float* g0 = hs + (2 * ks * GS + p) * 4 + t4;",
                 "const float* g1 = g0 + GS * 4;",
                 "const float v[4] = {g0[0], g0[32], g1[0], g1[32]};",
                 "const uint32_t wt = wb + tap * kF32WTap + ks * 2 * BN * 16;",
                 "const uint64_t bh = gmma_desc(wt, BN * 16, 128);",
                 "const uint64_t bl = gmma_desc(wt + kF32WHalf, BN * 16, 128);",
                 "acc[mi][i] = __fadd_rn(acc[mi][i], part[mi][i]);",
                 "gmma_m64n64k8_tf32(part[mi], al[mi][ks], bh, keep);\n"
                 "          gmma_m64n64k8_tf32(part[mi], ah[mi][ks], bl, 1);\n"
                 "          gmma_m64n64k8_tf32(part[mi], ah[mi][ks], bh, 1);",
                 "const int keep = tap > 0 || ks > 0;",
                 "lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));",
                 "cvt.rna.tf32.f32",
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                 "constexpr int kF32WTap = HaloF32::KC * HaloF32::BN * 4;",
                 "constexpr int kF32WHalf = 9 * kF32WTap;",
                 "constexpr int kF32WBytes = 2 * kF32WHalf;",
                 "const int q0 = G + (int)(blockIdx.x / n_ot) * BM;"):
        assert expr in src, expr
    k = _consts()
    assert k["kMaxPitch"] == TC.HALO_F32_MAX_PITCH
    assert k["BM"] == TC._HALO_BM


def _smem_bytes(pitch, k):
    """``halo_f32_smem_bytes``: the ring's stages, their barriers and the
    halo's pixel table."""
    points = k["BM"] + 2 * pitch + 2
    stage = 2 * 9 * k["KC"] * k["BN"] * 4 + _group_stride(points) \
        * k["KC"] * 4
    stage = (stage + 127) // 128 * 128
    return k["kStages"] * stage + 8 * k["kStages"] + points * 4


def test_shared_memory_fits_at_the_pitch_limit():
    """The ring fits one block at the route's pitch limit and not 8 points
    past it (the limit is the budget's), one block fits at every ResNet
    width, and the staged float32 output tile fits the ring it reuses."""
    k = _consts()
    assert _smem_bytes(k["kMaxPitch"], k) + 1024 <= SMEM_PER_SM
    assert _smem_bytes(k["kMaxPitch"] + 8, k) + 1024 > SMEM_PER_SM
    for wd in (56, 28, 14, 7):
        assert _smem_bytes(wd + 2, k) + 1024 <= SMEM_PER_SM, wd
    assert k["BM"] * (k["BN"] + 8) * 4 <= k["kStages"] * 2 * 9 * k["KC"] \
        * k["BN"] * 4
