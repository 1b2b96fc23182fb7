"""paddle_tpu_torch's 3x3 implicit-GEMM convolution against the JAX package
on the CPU.

The plain versions of the two CUDA kernels (``igemm_conv_reference``,
``igemm_conv_fused_reference``) are held against
``benchmark/conv_probe.py``'s Pallas kernels (run by the interpreter), its
XLA forms and ``F.conv2d``.  The kernels' walk over K (``csrc/conv.cu``:
slices of one tap and BK channels, each pixel's taps gathered from NHWC x
by a pixel offset, zeros outside the image, w read as the row-major [9C, O]
matrix) is transcribed with the slice depths read from the source and held
against the plain version, since the kernels run only on the card, where
``chip_smoke.py`` holds them against the plain versions."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops import conv as TC

REPO = Path(__file__).resolve().parents[1]
CU = REPO / "paddle_tpu_torch" / "ops" / "csrc" / "conv.cu"
BF16_U = 2.0 ** -8     # bfloat16's unit roundoff: one rounding <= u |v|
F32_REL = 2e-5         # float32 sums in another order, of max |out|
BF16_SUM_REL = 1e-3    # the sums' share of a bfloat16 element's limit

# (N, H, W, C, O): two ResNet-like shapes, a ragged one, a 1x1 plane (the
# centre tap alone) and the CIFAR stem's C = 3
SHAPES = [(2, 8, 8, 16, 24), (2, 7, 5, 24, 40), (1, 1, 1, 8, 8),
          (2, 6, 6, 3, 16)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def probe():
    """benchmark/conv_probe.py, loaded as a module (its Pallas kernels run
    with ``interpret=True``)."""
    spec = importlib.util.spec_from_file_location(
        "conv_probe_for_tests", REPO / "benchmark" / "conv_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, shape, dtype):
    """x N(0, 1) [N, H, W, C], w N(0, 1 / (9C)) [3, 3, C, O] rounded to
    ``dtype``, a in [0.5, 1.5) and b N(0, 0.3^2) float32 [O]: as numpy
    float32 arrays of the rounded values and as torch tensors."""
    n, h, w, c, o = shape
    rng = np.random.RandomState(seed)
    tx = torch.from_numpy(rng.standard_normal((n, h, w, c)).astype(
        np.float32)).to(dtype)
    tw = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                           / np.sqrt(9 * c)).astype(np.float32)).to(dtype)
    a = torch.from_numpy(rng.rand(o).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.standard_normal(o).astype(np.float32) * 0.3)
    return tx, tw, a, b


def _np(t):
    return t.float().numpy()


def _assert_close(got, want, kind):
    """float32: within F32_REL of max |want|.  bfloat16, element by element:
    within 2u |want| + BF16_SUM_REL max |want| (each side rounds once to
    bfloat16 from float32 sums that differ in their last bits)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    if kind == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_REL * top)
    else:
        lim = 2 * BF16_U * np.abs(want) + BF16_SUM_REL * top
        assert np.all(np.abs(got - want) <= lim), \
            float((np.abs(got - want) / lim).max())


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_pallas_kernels(probe, shape, kind):
    """Both plain versions against the probe's Pallas kernels run by the
    interpreter, on the same rounded operands; the output keeps x's
    dtype."""
    tdt, jdt = DTYPES[kind]
    tx, tw, a, b = _inputs(sum(shape), shape, tdt)
    jx, jw = jnp.asarray(_np(tx), jdt), jnp.asarray(_np(tw), jdt)
    got = TC.igemm_conv(tx, tw)
    assert got.dtype == tdt and tuple(got.shape) == shape[:3] + (shape[4],)
    want = probe.igemm_conv(jx, jw, interpret=True)
    _assert_close(_np(got), want, kind)
    got = TC.igemm_conv_fused(tx, tw, a, b)
    assert got.dtype == tdt
    want = probe.igemm_conv_fused(jx, jw, jnp.asarray(a.numpy()),
                                  jnp.asarray(b.numpy()), interpret=True)
    _assert_close(_np(got), want, kind)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_match_conv2d_and_xla(probe, shape):
    """float32: the conv against ``F.conv2d`` on NCHW / OIHW permutes with
    padding 1, and the fused form against the probe's XLA
    ``xla_fused_nhwc`` (conv, scale and shift, ReLU), within F32_REL of
    max |out|."""
    tx, tw, a, b = _inputs(sum(shape) + 1, shape, torch.float32)
    want = F.conv2d(tx.permute(0, 3, 1, 2), tw.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)
    _assert_close(TC.igemm_conv(tx, tw).numpy(), want.numpy(), "float32")
    want = probe.xla_fused_nhwc(jnp.asarray(tx.numpy()),
                                jnp.asarray(tw.numpy()),
                                jnp.asarray(a.numpy()),
                                jnp.asarray(b.numpy()))
    _assert_close(TC.igemm_conv_fused(tx, tw, a, b).numpy(), want,
                  "float32")


def _tiles():
    """{dtype name: (BM, BN, BK, threads)} of ``Tile<T>`` in the source."""
    src = CU.read_text()
    out = {}
    for ctype, kind in (("__nv_bfloat16", "bfloat16"), ("float", "float32")):
        m = re.search(r"struct Tile<%s> \{\s*static constexpr int BM = (\d+), "
                      r"BN = (\d+), BK = (\d+), kThreads = (\d+);"
                      % re.escape(ctype), src)
        assert m is not None, ctype
        out[kind] = tuple(int(g) for g in m.groups())
    return out


def _kernel_walk(x, w, bk):
    """The float32 accumulator ``igemm_kernel`` builds, as its
    ``load_slice`` addresses it: K in slices of one tap (dy, dx) and ``bk``
    channels from c0; a row's A values at flat offset (p + dy W + dx) C + c
    of x, zero where (h + dy, w + dx) leaves the image or c >= C; B at
    (tap C + c) O + o of w, zero where c >= C."""
    n, h, wd, c_in = x.shape
    o = w.shape[-1]
    m = n * h * wd
    xf, wf = x.reshape(-1).float(), w.reshape(-1).float()
    p = torch.arange(m)
    s_h, s_w = (p % (h * wd)) // wd, (p % (h * wd)) % wd
    n_c = -(-c_in // bk)
    acc = torch.zeros(m, o)
    cols = torch.arange(o)
    for it in range(9 * n_c):
        tap, c0 = it // n_c, (it % n_c) * bk
        dy, dx = tap // 3 - 1, tap % 3 - 1
        c = c0 + torch.arange(bk)
        ih, iw = s_h[:, None] + dy, s_w[:, None] + dx
        ok = (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd) & (c < c_in)[None]
        off = (p[:, None] + dy * wd + dx) * c_in + c[None]
        a_tile = torch.where(ok, xf[off.clamp(0, xf.numel() - 1)], 0.0)
        offb = (tap * c_in + c)[:, None] * o + cols[None]
        b_tile = torch.where((c < c_in)[:, None],
                             wf[offb.clamp(0, wf.numel() - 1)], 0.0)
        acc += a_tile @ b_tile
    return acc.reshape(n, h, wd, o)


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_walk_matches_plain_version(shape, kind):
    """The transcribed walk, at the source's slice depth for the dtype,
    then the epilogue (multiply and add each rounded, ReLU, one rounding
    to the dtype), against the plain versions."""
    tdt, _ = DTYPES[kind]
    bk = _tiles()[kind][2]
    tx, tw, a, b = _inputs(sum(shape) + 2, shape, tdt)
    acc = _kernel_walk(tx, tw, bk)
    _assert_close(_np(acc.to(tdt)), _np(TC.igemm_conv_reference(tx, tw)),
                  kind)
    fused = torch.clamp_min(acc * a + b, 0.0).to(tdt)
    _assert_close(_np(fused),
                  _np(TC.igemm_conv_fused_reference(tx, tw, a, b)), kind)


def test_tiles_and_dtype_codes_match_source():
    """The tiles the kernel comments describe (128 x 64; BK 32 in bf16 on
    four warps, 16 in float32 on 256 threads) and the dtype codes the
    wrapper sends."""
    assert _tiles() == {"bfloat16": (128, 64, 32, 128),
                        "float32": (128, 64, 16, 256)}
    src = CU.read_text()
    assert "enum DType { kF32 = 0, kBF16 = 1 };" in src
    assert TC._DTYPE_CODE == {torch.float32: 0, torch.bfloat16: 1}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The kernel wrappers raise on dtypes, shapes, layouts and devices the
    kernel does not take, before any launch; ``launches`` stays 0 on CPU
    tensors, which run the plain versions."""
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(3, 3, 8, 8)
    with pytest.raises(ValueError, match="one dtype"):
        TC.igemm_conv_kernel(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        TC.igemm_conv_kernel(x.double(), w.double())
    with pytest.raises(ValueError, match=r"\[3, 3, C, O\]"):
        TC.igemm_conv_kernel(x, torch.zeros(1, 1, 8, 8))
    with pytest.raises(ValueError, match=r"\[3, 3, C, O\]"):
        TC.igemm_conv_kernel(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        TC.igemm_conv_kernel(x.permute(0, 2, 1, 3), w)
    with pytest.raises(ValueError, match="CUDA tensors"):
        TC.igemm_conv_kernel(x, w)
    with pytest.raises(ValueError, match="8 values"):
        TC.igemm_conv_fused_kernel(x, w, torch.ones(4), torch.zeros(8))
    before = dict(TC.launches)
    TC.igemm_conv(x, w)
    TC.igemm_conv_fused(x, w, torch.ones(8), torch.zeros(8))
    assert TC.launches == before == {"igemm": 0, "fused": 0}
