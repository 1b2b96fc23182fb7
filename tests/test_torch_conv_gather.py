"""The gather route of paddle_tpu_torch's 3x3 convolution (``igemm_kernel``
in ``ops/csrc/conv.cu``) on the CPU.

The kernel runs only on the card, where ``chip_smoke.py`` holds it against
the plain versions.  Here its walk is transcribed with the constants read
from the source: the persistent blocks' tiles, each a patch of the images'
grid (the images one under another, a zero row between two) and its halo
(zero off the grid), w loaded once where it fits, the 16-byte granules of
channels (zero past C), each unit's tap
as a shift of the row's halo point, two units to an mma's k (a zero unit
past the chunk), w's rows [tap][8 outputs][channel][8 outputs], the output
channels a block takes (BN, picked by O), the bfloat16 products summed in
float32 and the float32 ones as three TF32 passes into a fresh accumulator
each chunk, then the output staged through shared memory at the shift that
aligns each segment and stored in 16-byte pieces, element by element at a
segment's ends.  The transcription is held against ``igemm_conv_reference``
and ``igemm_conv_fused_reference`` in both dtypes, with every output
written once, every 16-byte store aligned and no unwritten shared memory
(NaN here) reaching a sum; the shared memory of every patch is held to a
block's 227 KB; the addressing is pinned to the source."""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import conv as TC
from test_torch_conv import _assert_close, _inputs, _np
from test_torch_conv_tf32 import split

REPO = Path(__file__).resolve().parents[1]
CU = REPO / "paddle_tpu_torch" / "ops" / "csrc" / "conv.cu"
SMEM_PER_SM = 232448   # an H100 block's shared memory at most, in bytes

# (N, H, W, C, O), small cases of each model shape class: ocr_ctc's C = 1,
# the stems' C = 3 (patches cut by the image's edge), FCN's C = 16, SSD's
# heads (O = 8, 42), GoogLeNet's C = 96 and 160 with O = 128 (two
# output-channel tiles), W in {7, 9, 32} and others
MODEL_SHAPES = [(2, 8, 32, 1, 16), (1, 11, 32, 3, 64), (2, 13, 34, 3, 16),
                (1, 19, 19, 16, 32), (2, 9, 9, 32, 42), (1, 10, 9, 32, 8),
                (1, 9, 7, 16, 42), (1, 7, 7, 96, 128), (2, 5, 7, 160, 24),
                (1, 6, 9, 3, 128)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run (the suite's workers
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gather_consts() -> dict:
    """``Gather``'s constants, the rows a warp multiplies, the ring's
    offset, the resident w's and a streamed stage's budgets, the staged
    rows' padding and the BN values the launch dispatches on, from the
    source."""
    src = CU.read_text()
    m = re.search(r"struct Gather \{\s*static constexpr int ([^;]+);", src)
    assert m is not None
    k = {kv.split("=")[0].strip(): int(kv.split("=")[1])
         for kv in m.group(1).split(",")}
    k["pad"] = int(re.search(r"constexpr int kGatherPad = (\d+);",
                             src).group(1))
    k["ring"] = int(re.search(r"constexpr int kGatherRing = (\d+);",
                              src).group(1))
    for key, name in (("wres", "kGatherWRes"), ("stage", "kGatherStage")):
        k[key] = int(re.search(r"constexpr int %s = (\d+) \* 1024;" % name,
                               src).group(1)) * 1024
    body = src[src.index("int dispatch_gather("):]
    body = body[:body.index("default:")]
    k["BNS"] = tuple(int(v) for v in re.findall(r"GATHER_CASE\((\d+)\)\n",
                                                 body))
    k["warp_rows"] = k["BM"] // (k["kThreads"] // 32)
    k["smem_max"] = int(re.search(r"constexpr int kGatherSmemMax = (\d+);",
                                  src).group(1))
    return k


def stage_bytes(th, tw, bn, c, elt, cgs):
    """``gather_stage_bytes``: a halo, and w unless resident (float32 w
    twice: its hi and lo parts)."""
    w = 16 * cgs * 9 * bn * (2 if elt == 4 else 1)
    return 16 * cgs * (th + 2) * (tw + 2) \
        + (0 if TC.gather_resident(c, bn, elt, cgs) else w)


def smem_bytes(th, tw, bn, c, elt, cgs, k):
    """``gather_smem_bytes``: the zero bytes, resident w, the ring's stages
    and, unless it fits a stage, the staged output."""
    w = 16 * cgs * 9 * bn * (2 if elt == 4 else 1)
    chunks = -(-c // (cgs * 16 // elt))
    stage = stage_bytes(th, tw, bn, c, elt, cgs)
    staged = th * tw * (bn + k["pad"]) * elt
    return k["ring"] + (chunks * w if TC.gather_resident(c, bn, elt, cgs)
                        else 0) \
        + k["kStages"] * stage + (0 if staged <= stage else staged)


def _pixel(rr, col, h, wd, ng):
    """``gather_pixel``: grid pixel (rr, col) as an index of x's pixels,
    -1 off the grid and on the zero rows (numpy arrays)."""
    n, hh = rr // (h + 1), rr % (h + 1)
    ok = (rr >= 0) & (rr < ng) & (col >= 0) & (col < wd) & (hh < h)
    return np.where(ok, (n * h + hh) * wd + col, -1)


def _segment(covers, sg, h0, w0, o0, h, wd, o, tw, bn, ng):
    """``gather_segment``: None where it holds no pixel of an image, else
    (its first element in out, its length, its first staged pixel)."""
    ph, pw = (sg, 0) if covers else divmod(sg, tw)
    pix = int(_pixel(np.array(h0 + ph), np.array(w0 + pw), h, wd, ng))
    if pix < 0:
        return None
    if covers:
        return pix * o, min(tw, wd - w0) * o, ph * tw
    return pix * o + o0, min(bn, o - o0), sg


def pack_f32(w, bn, cgs):
    """``gather_f32_pack_w``: w [3, 3, C, O] split into hi and lo, float4
    unit ((((ot n_ch + ch) 2 + half) 9 + tap) BN / 8 + nb) CGs 8 + gs 8 +
    n8 holding channels (ch CGs + gs) 4 .. + 4 of output ot BN + nb 8 + n8,
    zero past C and O; a flat float32 array."""
    c_in, o = w.shape[2], w.shape[3]
    nb_all, n_ot = bn // 8, -(-o // bn)
    n_ch = -(-c_in // (4 * cgs))
    wf = w.reshape(9, c_in, o)
    ot, ch, tap, nb, gs, n8, kk = np.meshgrid(
        np.arange(n_ot), np.arange(n_ch), np.arange(9), np.arange(nb_all),
        np.arange(cgs), np.arange(8), np.arange(4), indexing="ij")
    oo, cc = ot * bn + nb * 8 + n8, (ch * cgs + gs) * 4 + kk
    ok = (oo < o) & (cc < c_in)
    v = np.where(ok, wf[tap, np.minimum(cc, c_in - 1),
                        np.minimum(oo, o - 1)], 0.0).astype(np.float32)
    hi, lo = split(v)
    unit = ((((ot * n_ch + ch) * 2) * 9 + tap) * nb_all + nb) * cgs * 8 \
        + gs * 8 + n8
    half = 9 * nb_all * cgs * 8
    out = np.full(n_ot * n_ch * 2 * half * 4, np.nan, np.float32)
    out[unit * 4 + kk] = hi
    out[(unit + half) * 4 + kk] = lo
    return out


def _w_row(tap, blk, cl, nb, cgs):
    """``gather_w_row``: bfloat16 w's row of channel cl for n-block blk of
    tap ``tap``, a granule's 8 rows swizzled by the n-block."""
    return (tap * nb + blk) * cgs * 8 + (cl & ~7) + ((cl & 7) ^ (blk & 7))


def pack_bf16(w, bn, cgs):
    """``gather_bf16_pack_w``: w [3, 3, C, O] a row of 8 outputs a unit,
    (output tile, chunk) images of 9 BN / 8 CGs 8 rows, row ``_w_row``,
    zero past C and O; a flat array."""
    c_in, o = w.shape[2], w.shape[3]
    nb, n_ot = bn // 8, -(-o // bn)
    n_ch = -(-c_in // (8 * cgs))
    wf = w.reshape(9, c_in, o)
    ot, ch, tap, blk, cl, k = np.meshgrid(
        np.arange(n_ot), np.arange(n_ch), np.arange(9), np.arange(nb),
        np.arange(cgs * 8), np.arange(8), indexing="ij")
    oo, cc = ot * bn + blk * 8 + k, ch * cgs * 8 + cl
    ok = (oo < o) & (cc < c_in)
    out = np.full(n_ot * n_ch * 9 * nb * cgs * 8 * 8, np.nan, np.float32)
    row = (ot * n_ch + ch) * 9 * nb * cgs * 8 + _w_row(tap, blk, cl, nb, cgs)
    out[row * 8 + k] = np.where(ok, wf[tap, np.minimum(cc, c_in - 1),
                                       np.minimum(oo, o - 1)], 0.0)
    return out


def walk(x, w, kind, base=0, blocks=None):
    """The float32 sums ``igemm_kernel<T, kFused, BN>`` stores for x [N, H,
    W, C] and w [3, 3, C, O] (numpy float32 arrays of ``kind``'s values),
    before the epilogue (which acts on each output alone), as its copies,
    fragments and stores address shared and device memory; ``base``: out's
    first element's address in elements, mod 16 bytes; ``blocks``: the
    persistent grid (a multiple of the output-channel tiles; default 3 of
    them).  Returns (sums [N, H, W, O], writes per element of device memory
    around out, 16-byte stores, element stores)."""
    k = gather_consts()
    elt = 2 if kind == "bfloat16" else 4
    per = 16 // elt
    n_img, h, wd, c_in = x.shape
    o = w.shape[-1]
    bm = k["BM"]
    th, tw = TC.gather_patch(n_img, h, wd)
    bn = TC.gather_bn(o)
    cgs = TC.gather_step_granules(elt, th, tw, c_in, bn)
    assert th * tw <= bm and bn in k["BNS"] and 1 <= cgs <= k["kGranules"]
    nb = bn // 8
    ng = n_img * (h + 1) - 1
    n_w, n_ot = -(-wd // tw), -(-o // bn)
    n_tiles = -(-ng // th) * n_w * n_ot
    blocks = min(blocks or 3 * n_ot, n_tiles)
    assert blocks % n_ot == 0
    pw_, rows = tw + 2, th * tw
    np_ = (th + 2) * pw_
    ck = cgs * per
    n_ch = -(-c_in // ck)
    res = TC.gather_resident(c_in, bn, elt, cgs)
    covers = n_ot == 1
    sx = bn + k["pad"]
    ov = o if covers else bn
    xf, wf = x.reshape(-1), w.reshape(-1)
    # the packed w: float32 always, bfloat16 where it streams
    wp = pack_f32(w, bn, cgs) if kind == "float32" else (
        pack_bf16(w, bn, cgs) if not res else None)
    w_half = 9 * bn * cgs * 4          # floats of a chunk's hi (or lo) rows
    total = n_img * h * wd * o
    mem = np.full(base + total + 2 * per, np.nan, np.float32)
    writes = np.zeros(mem.size, np.int64)
    vec_stores = elem_stores = 0
    r = np.arange(bm)
    pa = np.where(r < rows, (r // tw) * pw_ + r % tw, 0)
    lane = np.arange(per)
    cols = np.arange(bn)

    def w_row(tap, blk, cl):
        return _w_row(tap, blk, cl, nb, cgs)

    def load_w(ot, ch):
        """One chunk's w as its stage holds it: the packed image (float32:
        hi rows then lo rows of a granule's 4 channels of an output;
        streamed bfloat16: rows of 8 outputs of a channel), or resident
        bfloat16 loaded from w into the same rows."""
        o0, c0 = ot * bn, ch * ck
        if kind == "float32":
            start = (ot * n_ch + ch) * 2 * w_half
            return wp[start:start + 2 * w_half]
        if not res:
            size = 9 * nb * cgs * 8 * 8
            return wp[(ot * n_ch + ch) * size:(ot * n_ch + ch + 1) * size]
        cg = min(cgs, -(-(c_in - c0) // per))
        ws = np.full(9 * nb * cgs * 8 * 8, np.nan, np.float32)
        tap, cl, ol = np.meshgrid(np.arange(9), np.arange(cg * per), cols,
                                  indexing="ij")
        ok = (c0 + cl < c_in) & (o0 + ol < o)
        src = (tap * c_in + c0 + cl) * o + o0 + ol
        ws[w_row(tap, ol // 8, cl) * 8 + ol % 8] = np.where(
            ok, wf[np.where(ok, src, 0)], 0.0)
        return ws

    def b_rows(ws, gu, tu, half=0):
        """B's values of unit (granule gu, tap tu): [per channels, BN]."""
        if kind == "bfloat16":
            return ws[w_row(tu, cols[None, :] // 8, gu * 8 + lane[:, None])
                      * 8 + cols[None, :] % 8]
        return ws[half * w_half + ((((tu * nb + cols[None, :] // 8) * cgs
                                     + gu) * 8 + cols[None, :] % 8) * 4
                                   + lane[:, None])]

    for blk in range(blocks):
        ot = blk % n_ot
        o0 = ot * bn
        w_res = [load_w(ot, ch) for ch in range(n_ch)] if res else None
        for t in range(blk, n_tiles, blocks):
            assert t % n_ot == ot
            patch = t // n_ot
            h0, w0 = (patch // n_w) * th, (patch % n_w) * tw
            acc = np.zeros((bm, bn), np.float32)
            for ch in range(n_ch):
                c0 = ch * ck
                cg = min(cgs, -(-(c_in - c0) // per))
                # the halo: granule g of point p at (g NP + p) per + j
                halo = np.full(cgs * np_ * per, np.nan, np.float32)
                p, g, j = np.meshgrid(np.arange(np_), np.arange(cg), lane,
                                      indexing="ij")
                hr = p // pw_
                pix = _pixel(h0 - 1 + hr, w0 - 1 + (p - hr * pw_), h, wd, ng)
                c = c0 + g * per + j
                inside = (pix >= 0) & (c < c_in)
                halo[(g * np_ + p) * per + j] = np.where(
                    inside, xf[np.where(inside, pix * c_in + c, 0)], 0.0)
                ws = w_res[ch] if res else load_w(ot, ch)
                nu = 9 * cg
                part = np.zeros((bm, bn), np.float32)
                for ks in range(-(-nu // 2)):
                    a_t = np.zeros((bm, 2 * per), np.float32)
                    bh = np.zeros((2 * per, bn), np.float32)
                    bl = np.zeros((2 * per, bn), np.float32)
                    for q in range(2):
                        u = 2 * ks + q
                        if u >= nu:          # the zero unit
                            continue
                        gu, tu = divmod(u, 9)
                        shift = (tu // 3) * pw_ + tu % 3
                        a_t[:, q * per:(q + 1) * per] = halo[
                            ((gu * np_ + pa + shift) * per)[:, None] + lane]
                        bh[q * per:(q + 1) * per] = b_rows(ws, gu, tu)
                        if kind == "float32":
                            bl[q * per:(q + 1) * per] = b_rows(ws, gu, tu, 1)
                    if kind == "bfloat16":
                        acc = acc + a_t @ bh
                    else:                    # bh, bl: the packed hi, lo
                        ah, al = split(a_t)
                        part = part + al @ bh
                        part = part + ah @ bl
                        part = part + ah @ bh
                if kind == "float32":        # the chunk's fresh accumulator
                    acc = acc + part
            # the staged tile, a row of BN + pad a pixel; then the stores
            so = np.full(rows * sx, np.nan, np.float32)
            for row in range(rows):
                so[row * sx:row * sx + bn] = acc[row]
            segs = [_segment(covers, sg, h0, w0, o0, h, wd, o, tw, bn, ng)
                    for sg in range(th if covers else rows)]
            twv, bnv = min(tw, wd - w0), min(bn, o - o0)
            if o % per == 0 and base % per == 0:
                # every segment starts on a 16-byte boundary: whole pieces
                for sg, got in enumerate(segs):
                    if got is None:
                        continue
                    first, length, px = got
                    for q in range(length // per):
                        e = q * per + np.arange(per)
                        src = (px + e // ov) * sx + e % ov
                        assert np.array_equal(src, src[0] + np.arange(per))
                        assert src[0] % per == 0
                        assert (base + first + q * per) % per == 0
                        mem[base + first + e] = so[src]
                        writes[base + first + e] += 1
                        vec_stores += 1
                continue
            qs = ((tw * o if covers else bn) + 2 * per - 2) // per
            for i in range(len(segs) * qs):
                sg, q = divmod(i, qs)
                got = segs[sg]
                if got is None:
                    continue
                first, length, px = got
                sh = (base + first) % per
                lo = q * per - sh            # the piece's first element
                vs, ve = max(lo, 0), min(lo + per, length)
                if vs >= ve:
                    continue
                e = np.arange(vs, ve)
                src = (px + e // ov) * sx + e % ov
                mem[base + first + e] = so[src]
                writes[base + first + e] += 1
                if vs == lo and ve == lo + per:
                    assert (base + first + lo) % per == 0
                    vec_stores += 1
                else:
                    elem_stores += ve - vs
    sums = mem[base:base + total].reshape(n_img, h, wd, o)
    return sums, writes, vec_stores, elem_stores


def held(shape, kind, base=0, blocks=None):
    """The walk on seeded inputs, then the epilogue (multiply and add each
    rounded, ReLU, one rounding to the dtype), against both plain
    versions; returns the walk's store counts."""
    tdt = DTYPES[kind]
    tx, tw, a, b = _inputs(sum(shape) + 9, shape, tdt)
    sums, writes, vec, elem = walk(_np(tx), _np(tw), kind, base, blocks)
    total = sums.size
    assert np.array_equal(writes[base:base + total], np.ones(total))
    assert not writes[:base].any() and not writes[base + total:].any()
    assert np.isfinite(sums).all()
    acc = torch.from_numpy(sums)
    _assert_close(_np(acc.to(tdt)), _np(TC.igemm_conv_reference(tx, tw)),
                  kind)
    fused = torch.clamp_min(acc * a + b, 0.0).to(tdt)
    _assert_close(_np(fused),
                  _np(TC.igemm_conv_fused_reference(tx, tw, a, b)), kind)
    return vec, elem


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_walk_matches_plain_versions_at_model_shape_classes(shape, kind):
    """The walk against the plain versions at small cases of each model
    shape class, out 16-byte aligned: every output written once."""
    n, h, w, c, o = shape
    assert TC.conv_route(DTYPES[kind], n, h, w, c, o, True) == "gather"
    held(shape, kind)


@pytest.mark.parametrize("blocks", [1, 2, 64])
def test_walk_any_persistent_grid(blocks):
    """Blocks walking several tiles each, or one a tile: the same sums,
    every output written once, each block on one output-channel tile
    (GoogLeNet's class: two tiles of outputs, w past the resident budget,
    so streamed with the halo)."""
    for kind in DTYPES:
        held((2, 7, 7, 96, 128), kind, blocks=2 * blocks)


@pytest.mark.parametrize("base", [1, 3])
@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_walk_stores_any_alignment_once(kind, base):
    """out at any element alignment: the staged shift keeps each 16-byte
    store aligned, every element still written once, and only a segment's
    ends stored element by element (at most 2 (per - 1) elements a
    segment)."""
    shape = (2, 9, 9, 32, 42)       # O = 42: no row is 16-byte aligned
    vec, elem = held(shape, kind, base)
    per = 16 // DTYPES[kind].itemsize
    segments = 2 * 9                 # covers: one an image row
    assert vec > 0 and elem <= segments * 2 * (per - 1)


def test_walk_stores_aligned_rows_whole():
    """Where every segment starts and ends on a 16-byte boundary (O a
    multiple of 16 bytes, out aligned) no element is stored alone."""
    for kind in DTYPES:
        vec, elem = held((2, 8, 32, 1, 16), kind)
        assert vec > 0 and elem == 0, kind


def test_streamed_w_matches_plain_versions():
    """Past the resident budget (all of w's chunks for one output tile over
    kGatherWRes bytes) w streams through the ring with the halo, in chunks
    whose stage fits kGatherStage, copied from its packed images (both
    dtypes); the walk is the same sums, and the scratch is the packed
    size."""
    k = gather_consts()
    shape = (1, 4, 5, 160, 64)
    th, tw = TC.gather_patch(1, 4, 5)
    for kind in DTYPES:
        elt = DTYPES[kind].itemsize
        cgs = TC.gather_step_granules(elt, th, tw, 160, 64)
        assert not TC.gather_resident(160, 64, elt, cgs)
        assert stage_bytes(th, tw, 64, 160, elt, cgs) <= k["stage"]
        assert cgs == {"bfloat16": 4, "float32": 2}[kind]
        held(shape, kind, blocks=2)
        # the scratch the launch allocates holds the packed w exactly
        w = np.zeros((3, 3, 160, 64), np.float32)
        packed = (pack_f32 if kind == "float32" else pack_bf16)(w, 64, cgs)
        assert TC.gather_scratch_numel(160, 64, cgs, elt) == packed.size
    assert TC.gather_scratch_numel(32, 42, 4, 2) == 0   # resident bf16


def test_patch_and_bn_choice():
    """BN is the least of 8, 16, 24, 32, 48, 64 that holds all of O (64
    past it); a patch holds at most BM pixels, splits the grid's rows and
    W into equal parts up to the last, and is the recorded one at the
    models' shapes."""
    k = gather_consts()
    assert TC.GATHER_BNS == k["BNS"] == (8, 16, 24, 32, 48, 64)
    assert {o: TC.gather_bn(o) for o in (1, 8, 9, 16, 17, 32, 42, 48, 64,
                                         65, 128, 288, 320)} == {
        1: 8, 8: 8, 9: 16, 16: 16, 17: 24, 32: 32, 42: 48, 48: 48, 64: 64,
        65: 64, 128: 64, 288: 64, 320: 64}
    for n, h, w in itertools.product((1, 3), (1, 2, 3, 7, 13, 75, 200),
                                     (1, 2, 3, 7, 9, 16, 31, 38, 129, 300)):
        th, tw = TC.gather_patch(n, h, w)
        ng = n * (h + 1) - 1
        assert 1 <= th <= ng and 1 <= tw <= w
        assert th * tw <= k["BM"]
        n_h, n_w = -(-ng // th), -(-w // tw)
        assert -(-ng // n_h) == th and -(-w // n_w) == tw
    assert {s: TC.gather_patch(*s) for s in (
        (32, 256, 256), (64, 224, 224), (32, 128, 128), (32, 64, 64),
        (32, 75, 75), (32, 38, 38), (128, 28, 28), (128, 14, 14),
        (128, 7, 7), (256, 8, 32), (256, 4, 16))} == {
        (32, 256, 256): (8, 16), (64, 224, 224): (8, 16),
        (32, 128, 128): (8, 16), (32, 64, 64): (8, 16),
        (32, 75, 75): (8, 15), (32, 38, 38): (16, 8),
        (128, 28, 28): (9, 14), (128, 14, 14): (9, 14),
        (128, 7, 7): (18, 7), (256, 8, 32): (8, 16), (256, 4, 16): (8, 16)}


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_shared_memory_fits_every_patch(kind):
    """Every launch fits a block's 227 KB (kGatherSmemMax, the attribute the
    launch sets) at every patch it can take (TH TW <= BM, so at any W the
    gather route takes) with the step granules the host picks; w
    stays resident at the models' shapes but GoogLeNet's, and in float32
    VGG-19's c224, FCN's c64 and SSD's conf heads."""
    k = gather_consts()
    elt = DTYPES[kind].itemsize
    assert (TC.GATHER_GRANULES, TC.GATHER_W_RES, TC.GATHER_STAGE) == (
        k["kGranules"], k["wres"], k["stage"])
    assert k["smem_max"] == SMEM_PER_SM
    for bn in k["BNS"]:
        worst = 0
        for tw in range(1, k["BM"] + 1):
            for th in range(1, k["BM"] // tw + 1):
                for c in (1, 3, 32, 64, 512):
                    cgs = TC.gather_step_granules(elt, th, tw, c, bn)
                    worst = max(worst, smem_bytes(th, tw, bn, c, elt, cgs,
                                                  k))
        assert worst <= SMEM_PER_SM, (bn, worst)
    import chip_smoke
    streamed = set()
    for label, n, h, w, c, o, routes in chip_smoke.CONV_MODEL_CASES:
        if routes.get(DTYPES[kind]) != "gather":
            continue
        th, tw = TC.gather_patch(n, h, w)
        bn = TC.gather_bn(o)
        cgs = TC.gather_step_granules(elt, th, tw, c, bn)
        assert smem_bytes(th, tw, bn, c, elt, cgs, k) <= SMEM_PER_SM
        assert stage_bytes(th, tw, bn, c, elt, cgs) <= k["stage"]
        if not TC.gather_resident(c, bn, elt, cgs):
            streamed.add(label)
    assert streamed == {"googlenet c28 96", "googlenet c14 144",
                        "googlenet c7 160"} | (
        {"vgg19 c224", "fcn c64", "ssd conf75", "ssd conf38"}
        if kind == "float32" else set())


def test_addressing_matches_source():
    """The copies', packing's, fragments' and stores' addressing the
    transcription uses are the ones the source writes."""
    src = CU.read_text()
    for expr in (
            "struct Gather {\n  static constexpr int BM = 128, kGranules = "
            "4, kStages = 3, kThreads = 256;\n};",
            "constexpr int kGatherSegs = 128;",
            "constexpr int kGatherUnits = kGatherSegs + 4 * Gather::BM;",
            "constexpr int kGatherRing = 1024;",
            "constexpr int kGatherWRes = 80 * 1024;",
            "constexpr int kGatherStage = 40 * 1024;",
            "constexpr int kGatherPad = 8;",
            "return BN * elt <= 64 ? 3 : 2;",
            "return 16 * CG * 9 * BN * (elt == 4 ? 2 : 1);",
            "return 16 * CG * (TH + 2) * (TW + 2);",
            "const int n = R / (H + 1), h = R - n * (H + 1);",
            "return h < H ? (n * H + h) * W + col : -1;",
            "atab[u] = ok ? (gu * NP + (tu / 3) * PW + tu % 3) * 16 : 0;",
            "btab[u] = ok ? ((tu * NB) * CGs + gu) * 128 : 0;",
            "const int ua = 2 * ks + (lane >> 4), ub = 2 * ks + ((lane >> 3) "
            "& 1);",
            "const uint32_t wsl = ws + (lane & 7) * 16;",
            "const int nbl = (lane >> 4) * CGs * 128;",
            "ldsm_x4(af, ua < nu ? hs + pa * 16 + atab[ua] : zero);",
            "const uint32_t brow = wsl + btab[ub];",
            "const uint32_t at = brow + j * CGs * 128 + nbl;",
            "hr[k] = p < NP ? p / PW : -1;",
            "const int n0 = h0 >= 1 ? (h0 - 1) / (H + 1) : -1;",
            "const int row0 = h0 - 1 - n0 * (H + 1);   // H: a zero row",
            "while (row > H) row -= H + 1, ++n;",
            "const int64_t off = ((int64_t)(n * H + row) * W + col) * C + c0;",
            "cp_async16(hs + 16 * (g * NP + p), in ? x + off + g * per : x, "
            "in);",
            "pv[k][j] = (in && c0 + j < C) ? x[off + j] : zero_of<T>();",
            "return (tap * NB + nb) * CGs * 8 + (cl & ~7) + ((cl & 7) ^ (nb & "
            "7));",
            "cp_async16(ws + gather_w_row(tap, q, cl, NB, CGs) * 8,",
            "cp_async4(ws + gather_w_row(tap, ol / 8, cl, NB, CGs) * 8 + ol % "
            "8,",
            "ws[gather_w_row(tap, ol / 8, cl, NB, CGs) * 8 + ol % 8] =",
            "ldsm_x4_t(b4, bok ? bsw + (nb * CGs * 8 + ((lane & 7) ^ (nb & "
            "7)))",
            "const int o = ot * BN + nb * 8 + n8, c0 = (ch * CGs + gs) * 4;",
            "const int c = ch * CGs * 8 + cl, o = ot * BN + nb * 8;",
            "wp[(int64_t)(ot * n_ch + ch) * chunk + gather_w_row(tap, nb, cl, "
            "NB,",
            "if (elt == 4 || !gather_resident(C, BN, elt, CGs)) {",
            "const int64_t dst = ((int64_t)(ot * n_ch + ch) * 2 * 9 + tap) *",
            "(nb * CGs + gs) * 8 + n8;",
            "wp[dst + half] =",
            "(int64_t)(ot * n_ch + ch) * wb,",
            "ldsm_x4(l4, bok ? at + wlo : zero);",
            "tf32_split(__uint_as_float(af[e]), ah[e], al[e]);",
            "mma_tf32(acc[j], al, bh[j][0], bh[j][1]);",
            "mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);",
            "mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);",
            "acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);",
            "const int ra = r0 + (lane & 15);",
            "const int pa = ra < rows ? (ra / TW) * PW + ra % TW : 0;",
            "const int r = r0 + g + 8 * hh;",
            "T* d = so + r * SX + 2 * t4;",
            "const int ot = (int)blockIdx.x % n_ot, o0 = ot * BN;",
            "const int t = (int)blockIdx.x + (s / n_ch) * (int)gridDim.x;",
            "const int patch = t / n_ot, ch = s % n_ch;",
            "const int h0 = (patch / nW) * TH, w0 = (patch % nW) * TW;",
            "grid = grid / n_ot * n_ot;",
            "segs[sg] = gather_segment(covers, sg, h0, w0, H, W, TW, NG);",
            "const int ph = covers ? sg : sg / TW, pw = covers ? 0 : sg - ph "
            "* TW;",
            "uint4* dst = reinterpret_cast<uint4*>(out + (int64_t)pix * O);",
            "so + (ph * TW + pw) * SX + (q - pw * OP) * per));",
            "__stcs(reinterpret_cast<uint4*>(out + (int64_t)pix * O + o0 +",
            "*reinterpret_cast<const uint4*>(so + r * SX + q * per));",
            "const int vec_o = O % per == 0 && (uintptr_t)out % 16 == 0;",
            "const int QS = ((covers ? TW * O : BN) + 2 * per - 2) / per;",
            "const int64_t first = (int64_t)pix * O + (covers ? 0 : o0);",
            "const int len = covers ? TWv * O : BNv;",
            "const int px = covers ? sg * TW : sg;",
            "const int sh = (int)((base + first) & (per - 1));",
            "const int lo = q * per - sh;   // the piece's first element",
            "const int vs = max(lo, 0), ve = min(lo + per, len);",
            "int pk = px + vs / Ov, c = vs - (vs / Ov) * Ov;",
            "e[k] = so[pk * SX + c];",
            "out[first + k] = so[pk * SX + c];",
            "if (++c == Ov) c = 0, ++pk;",
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"):
        assert expr in src, expr
    k = gather_consts()
    assert (k["BM"], k["warp_rows"]) == (TC.GATHER_BM, TC.GATHER_WARP_ROWS)
