"""The halo route of paddle_tpu_torch's 3x3 convolution (``halo_kernel`` in
``ops/csrc/conv.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
the plain versions.  Here its walk is transcribed, with the tile constants
and the shared-memory addressing read from the source, and held against
the plain versions (``igemm_conv_reference``, ``igemm_conv_fused_reference``
of ``ops/conv.py``, which ``tests/test_torch_conv.py`` holds against
``benchmark/conv_probe.py``'s Pallas kernels):

* the images on one grid of pitch W + 2 (a zero column each side of a row,
  a zero row before, between and after the images), tiles of BM consecutive
  grid points cutting across rows and images;
* w packed as ``halo_pack_w`` packs it ([output tile][step][tap][8-channel
  output group][k][8], so that a stage's w is one contiguous bulk copy);
* each step's stage written as the copies write it (the packed w slice,
  the halo as [8-channel group][point][8], zero where a point holds no
  pixel), then read back through the wgmma descriptors' addressing
  (no-swizzle core matrices of 8 rows x 16 bytes, LBO along K, SBO along M
  or N), each tap a shifted start into the same halo;
* the epilogue dropping the pitch columns, zero rows and points past the
  images, every output pixel written exactly once.

``conv_route`` is checked on ResNet's four stride-1 shapes, the CIFAR stem,
ragged channels, float32, misaligned pointers and a row too wide."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import conv as TC

REPO = Path(__file__).resolve().parents[1]
CU = REPO / "paddle_tpu_torch" / "ops" / "csrc" / "conv.cu"
BF16_U = 2.0 ** -8     # bfloat16's unit roundoff: one rounding <= u |v|
BF16_SUM_REL = 1e-3    # the sums' share of a bfloat16 element's limit
SMEM_PER_SM = 232448   # an H100 block's shared memory at most, in bytes

# (N, H, W, C, O): several images in one tile, one image narrower than it,
# two 64-channel chunks, and tiles that cut across rows and images with
# three output-channel tiles
SHAPES = [(2, 8, 8, 64, 64), (3, 7, 7, 64, 128), (1, 5, 9, 128, 64),
          (2, 12, 20, 64, 192)]


def _halo_consts():
    """The ``Halo`` tile constants of the source."""
    m = re.search(r"struct Halo \{\s*static constexpr int ([^;]+);",
                  CU.read_text())
    assert m is not None
    return {k.strip(): int(v) for k, v in
            (kv.split("=") for kv in m.group(1).split(","))}


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


def _inputs(seed, shape):
    n, h, w, c, o = shape
    rng = np.random.RandomState(seed)
    tx = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(
        np.float32)).to(torch.bfloat16)
    tw = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                           / np.sqrt(9 * c)).astype(np.float32)).to(
        torch.bfloat16)
    a = torch.from_numpy(rng.rand(o).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.standard_normal(o).astype(np.float32) * 0.3)
    return tx, tw, a, b


def _pack_w(w, bn, kc):
    """``halo_pack_w``: w [3, 3, C, O] as 16-byte rows (8 outputs) moved to
    row ((((o / bn) (C / kc) + c / kc) 9 + tap) (bn / 8) + (o % bn) / 8) kc
    + c % kc."""
    c, o = w.shape[2], w.shape[3]
    rows = w.reshape(9 * c * (o // 8), 8).float()
    i = torch.arange(rows.shape[0])
    kr, oc = i // (o // 8), i % (o // 8)
    tap, ci = kr // c, kr % c
    dst = ((((oc // (bn // 8)) * (c // kc) + ci // kc) * 9 + tap)
           * (bn // 8) + oc % (bn // 8)) * kc + ci % kc
    out = torch.full_like(rows, float("nan"))
    out[dst] = rows
    return out.reshape(-1)


def _halo_walk(x, w):
    """The float32 accumulator ``halo_kernel`` builds, and how many times
    each output pixel is written, as its copies and descriptors address
    shared memory (in bfloat16 elements: byte offsets / 2)."""
    k = _halo_consts()
    bm, bn, kc = k["BM"], k["BN"], k["KC"]
    n, h, wd, c = x.shape
    o = w.shape[-1]
    g = wd + 2
    points = bm + 2 * g + 2
    gs = _group_stride(points)
    w_tap = kc * bn                     # kHaloWTap / 2
    w_elems = 9 * w_tap                 # kHaloWBytes / 2
    xf = x.reshape(-1, c).float()
    wp = _pack_w(w, bn, kc)
    n_steps = c // kc
    acc_out = torch.zeros(n * h * wd, o)
    writes = torch.zeros(n * h * wd, dtype=torch.int64)
    n_rows = (n * (h + 1) - 1) * g      # grid points from row 1 on
    lane8 = torch.arange(8)
    # the halo copies' destinations (grp, point)
    grp_i, p_i = torch.meshgrid(torch.arange(kc // 8), torch.arange(points),
                                indexing="ij")
    h_dst = (w_elems + (grp_i * gs + p_i) * 8)[..., None] + lane8
    # the descriptors' reads: A rows i, depth kk; B depth kk, columns nn
    i_a, k_a = torch.meshgrid(torch.arange(64), torch.arange(16),
                              indexing="ij")
    a_off = (i_a // 8) * (128 // 2) + (i_a % 8) * 8 \
        + (k_a // 8) * (gs * 16 // 2) + k_a % 8
    k_b, n_b = torch.meshgrid(torch.arange(16), torch.arange(bn),
                              indexing="ij")
    b_off = (k_b // 8) * (128 // 2) + (k_b % 8) * 8 \
        + (n_b // 8) * (kc * 16 // 2) + n_b % 8
    for t in range(-(-n_rows // bm)):
        q0 = g + t * bm
        src = torch.from_numpy(_grid_pixel(q0 - g - 1 + np.arange(points),
                                           n, h, wd))
        dst = torch.from_numpy(_grid_pixel(q0 + np.arange(bm), n, h, wd))
        for o0 in range(0, o, bn):
            acc = torch.zeros(bm, bn)
            for s in range(c // kc):
                c0 = s * kc
                stage = torch.full((w_elems + gs * kc,), float("nan"))
                # the bulk copy: the packed slice of (o0 / bn, s) verbatim
                start = ((o0 // bn) * n_steps + s) * w_elems
                stage[:w_elems] = wp[start:start + w_elems]
                vals = xf[src.clamp(min=0)[None, :, None],
                          c0 + grp_i[..., None] * 8 + lane8]
                stage[h_dst] = torch.where((src >= 0)[None, :, None], vals,
                                           0.0)
                for tap in range(9):
                    shift = (tap // 3) * g + tap % 3
                    b_tile = stage[tap * w_tap + b_off]
                    for m64 in range(bm // 64):
                        start = w_elems + (m64 * 64 + shift) * 8
                        a_tile = stage[start + a_off]
                        acc[m64 * 64:(m64 + 1) * 64] += a_tile @ b_tile
            keep = dst >= 0
            acc_out[dst[keep], o0:o0 + bn] = acc[keep]
            if o0 == 0:
                writes.index_add_(0, dst[keep],
                                  torch.ones(int(keep.sum()),
                                             dtype=torch.int64))
    return acc_out.reshape(n, h, wd, o), writes


def _assert_bf16_close(got, want):
    """Element by element within 2u |want| + BF16_SUM_REL max |want|: each
    side rounds once to bfloat16 from float32 sums taken in another
    order."""
    got, want = got.float(), want.float()
    lim = 2 * BF16_U * want.abs() + BF16_SUM_REL * want.abs().max()
    worst = float(((got - want).abs() / lim).max())
    assert worst <= 1.0, worst


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_halo_walk_matches_plain_version(shape):
    """The transcribed walk, then the epilogue (multiply and add each
    rounded, ReLU, one rounding), against both plain versions; every output
    pixel is written once and only the grid's pixel points are stored."""
    n, h, wd, c, o = shape
    assert TC.conv_route(torch.bfloat16, n, h, wd, c, o, True) == "halo"
    tx, tw, a, b = _inputs(sum(shape) + 3, shape)
    acc, writes = _halo_walk(tx, tw)
    assert torch.equal(writes, torch.ones_like(writes))
    _assert_bf16_close(acc.to(torch.bfloat16),
                       TC.igemm_conv_reference(tx, tw))
    fused = torch.clamp_min(acc * a + b, 0.0).to(torch.bfloat16)
    _assert_bf16_close(fused, TC.igemm_conv_fused_reference(tx, tw, a, b))


def test_grid_covers_each_pixel_once_across_tiles():
    """The tiles of BM grid points from G on reach every pixel of every
    image once, and a tile's halo holds every tap of its rows."""
    bm = _halo_consts()["BM"]
    for n, h, wd in ((256, 56, 56), (256, 7, 7), (3, 13, 9), (1, 1, 1)):
        g = wd + 2
        n_rows = (n * (h + 1) - 1) * g
        q = g + np.arange(-(-n_rows // bm) * bm)
        pix = _grid_pixel(q, n, h, wd)
        got = np.sort(pix[pix >= 0])
        assert np.array_equal(got, np.arange(n * h * wd))
        # the taps of row r sit at halo point r + dy G + dx < BM + 2 G + 2
        assert (bm - 1) + 2 * g + 2 < bm + 2 * g + 2


def _smem_bytes(pitch, k):
    """``halo_smem_bytes``: the ring's stages, their barriers and the
    halo's pixel table."""
    points = k["BM"] + 2 * pitch + 2
    w_bytes = 9 * k["KC"] * k["BN"] * 2
    stage = w_bytes + _group_stride(points) * k["KC"] * 2
    stage = (stage + 127) // 128 * 128
    return k["kStages"] * stage + 8 * k["kStages"] + points * 4


def test_halo_shared_memory_fits():
    """Two blocks share an SM at every ResNet width (the source's claim),
    the widest pitch still fits one block, and the staged output tile fits
    the ring it reuses."""
    k = _halo_consts()
    for wd in (56, 28, 14, 7):
        assert 2 * (_smem_bytes(wd + 2, k) + 1024) <= SMEM_PER_SM, wd
    assert _smem_bytes(k["kMaxPitch"], k) + 1024 <= SMEM_PER_SM
    assert k["BM"] * (k["BN"] + 8) * 2 <= k["kStages"] * 9 * k["KC"] \
        * k["BN"] * 2


def test_walk_addressing_matches_source():
    """The loader's destinations and the descriptors' strides the
    transcription uses are the ones the source writes."""
    src = CU.read_text()
    for expr in ("((((int64_t)(oc / (BN / 8)) * (C / KC) + c / KC) * 9 + "
                 "tap) *\n             (BN / 8) + oc % (BN / 8)) * KC + c % "
                 "KC;",
                 "w_tile + (int64_t)s * (kHaloWBytes / 2), kHaloWBytes,",
                 "w_tile = wp + (int64_t)(o0 / BN) * n_steps *",
                 "hb + (grp * GS + p) * 16",
                 "gmma_desc(wb + tap * kHaloWTap, 128, KC * 16)",
                 "gmma_desc(hb + (wg * 128 + mi * 64 + shift) * 16,",
                 "GS * 16, 128)",
                 "const int shift = (tap / 3) * G + tap % 3;",
                 "const int q0 = G + (int)(blockIdx.x / n_ot) * BM;",
                 "s_src[p] = grid_pixel(q0 - G - 1 + p, N, H, W, G);",
                 "return (halo_points(G) + 3) / 8 * 8 + 4;",
                 "return Halo::BM + 2 * G + 2;",
                 "p, 1, 1, 0, 1;"):
        assert expr in src, expr
    assert _halo_consts()["kMaxPitch"] == TC.HALO_MAX_PITCH
    assert _halo_consts()["BM"] == TC._HALO_BM


RESNET = [(256, 56, 56, 64, 64), (256, 28, 28, 128, 128),
          (256, 14, 14, 256, 256), (256, 7, 7, 512, 512)]


@pytest.mark.parametrize("case,want", [
    *[(("bfloat16", *s, True), "halo") for s in RESNET],
    (("bfloat16", 256, 32, 32, 3, 16, True), "gather"),      # CIFAR stem
    (("bfloat16", 3, 13, 9, 3, 40, True), "gather"),         # ragged
    (("bfloat16", 3, 13, 9, 16, 24, True), "gather"),        # ragged, 16 B
    (("bfloat16", 4, 8, 8, 64, 96, True), "gather"),         # O % 64
    (("bfloat16", 4, 8, 8, 96, 64, True), "gather"),         # C % 64
    (("float32", 256, 56, 56, 64, 64, True), "halo_f32"),    # float32
    (("bfloat16", 256, 56, 56, 64, 64, False), "gather"),    # misaligned
    (("bfloat16", 1, 4, 254, 64, 64, True), "halo"),         # widest row
    (("bfloat16", 1, 4, 255, 64, 64, True), "gather"),       # too wide
    *[(("float32", *s, True), "halo_f32") for s in RESNET[1:]],
    (("float32", 256, 32, 32, 3, 16, True), "gather"),       # CIFAR stem
    (("float32", 3, 13, 9, 3, 40, True), "gather"),          # ragged
    (("float32", 3, 13, 9, 16, 24, True), "gather"),         # ragged, 16 B
    (("float32", 4, 8, 8, 96, 64, True), "gather"),          # C % 64
    (("float32", 256, 56, 56, 64, 64, False), "gather"),     # misaligned
    (("float32", 1, 4, 182, 64, 64, True), "halo_f32"),      # widest row
    (("float32", 1, 4, 183, 64, 64, True), "gather"),        # too wide
    (("float16", 4, 8, 8, 64, 64, True), "gather"),          # other dtype
], ids=lambda v: v if isinstance(v, str) else "-".join(map(str, v)))
def test_conv_route(case, want):
    dtype, n, h, w, c, o, aligned = case
    assert TC.conv_route(getattr(torch, dtype), n, h, w, c, o,
                         aligned) == want


def test_plain_calls_count_no_route():
    """CPU tensors run the plain versions: no route counts a launch, in
    either dtype."""
    before = dict(TC.route_launches)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(1, 4, 4, 64, dtype=dtype)
        w = torch.zeros(3, 3, 64, 64, dtype=dtype)
        TC.igemm_conv(x, w)
        TC.igemm_conv_fused(x, w, torch.ones(64), torch.zeros(64))
    assert TC.route_launches == before == {"halo": 0, "halo_f32": 0,
                                           "gather": 0}


def test_profile_classes_both_routes_by_name():
    """``train_profile`` counts each route's kernel under the fused or the
    plain conv class by its name (a ctypes launch has no host event above
    its kernel); the packing of w, on either halo route, is conv prep."""
    from paddle_tpu_torch.tools.train_profile import (_conv_pack_kernel,
                                                      _igemm_class)

    ns = "void (anonymous namespace)::"
    assert _igemm_class(ns + "halo_kernel<true>(const __nv_bfloat16 *)") \
        == "fused_kernel"
    assert _igemm_class(ns + "halo_kernel<false>(const __nv_bfloat16 *)") \
        == "igemm_kernel"
    assert _igemm_class(
        ns + "igemm_kernel<__nv_bfloat16, true, true>(const int *)") \
        == "fused_kernel"
    assert _igemm_class(ns + "halo_f32_kernel<true>(const float *)") \
        == "fused_kernel"
    assert _igemm_class(ns + "halo_f32_kernel<false>(const float *)") \
        == "igemm_kernel"
    assert _igemm_class(ns + "igemm_kernel<float, false, true>(const int *)") \
        == "igemm_kernel"
    # the gather route's instances by their output-channel tile
    assert _igemm_class(ns + "igemm_kernel<float, true, 48>(const float *)") \
        == "fused_kernel"
    assert _igemm_class(
        ns + "igemm_kernel<__nv_bfloat16, false, 8>(const __nv_bfloat16 *)") \
        == "igemm_kernel"
    assert _igemm_class(ns + "halo_pack_w(const uint4 *, uint4 *)") is None
    assert _igemm_class(ns + "halo_f32_pack_w(const float *, float4 *)") \
        is None
    assert _igemm_class("sm90_xmma_fprop_implicit_gemm") is None
    for name in ("halo_pack_w(const uint4 *, uint4 *)",
                 "halo_f32_pack_w(const float *, float4 *)",
                 "gather_f32_pack_w(const float *, float4 *, int, int, int, "
                 "int, int, int)",
                 "gather_bf16_pack_w(const __nv_bfloat16 *, uint4 *, int, "
                 "int, int, int, int, int)"):
        assert _conv_pack_kernel(ns + name)
        assert _igemm_class(ns + name) is None
    assert not _conv_pack_kernel(ns + "halo_f32_kernel<true>(const float *)")
