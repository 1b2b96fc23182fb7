"""3x3 SAME convolution as an implicit GEMM, plain and with a folded batch
norm and a ReLU, with hand-written CUDA kernels.

``igemm_conv(x_nhwc, w_hwio)`` and ``igemm_conv_fused(x_nhwc, w_hwio, a,
b)`` keep the layout and signatures of ``benchmark/conv_probe.py``'s
``igemm_conv`` / ``igemm_conv_fused``: x is an un-padded ``[N, H, W, C]``
tensor, the padding is SAME (one zero row and column on each side), w is
``[3, 3, C, O]``, and the output is ``[N, H, W, O]`` in x's dtype.  The
fused form returns ``max(conv * a + b, 0)`` with ``a`` and ``b`` ``[O]``
vectors of any float dtype, used in float32.

* On CUDA tensors they launch the kernels of ``csrc/conv.cu`` (the ports
  of the probe's Pallas ``_igemm_kernel`` and ``_igemm_fused_kernel``), or
  raise: there is no fallback.  float32 and bfloat16, any N, H, W, C, O.
  :func:`conv_route` picks the kernel by shape before the launch: the halo
  route (``halo_kernel``, wgmma over a halo tile) for bfloat16 with C and O
  multiples of 64, 16-byte aligned pointers and W + 2 <= 256, which is
  every ResNet 3x3 stride-1 conv; the halo_f32 route (``halo_f32_kernel``,
  the same halo tile with float32 products as three TF32 wgmma passes) for
  float32 with the same channels and pointers and W + 2 <= 184; the gather
  route (``igemm_kernel``) for everything else: a persistent block walks
  patches of the images' grid (:func:`gather_patch`), staging each patch's
  halo once, for BN output channels (:func:`gather_bn`) whose w stays in
  shared memory where it fits; K in chunks of 16-byte granules of channels
  (:func:`gather_step_granules`), float32 as three TF32 mma.sync passes.
  All are hand kernels; a launch that fails on any raises.  A halo-route
  call enqueues two kernels: ``halo_pack_w`` packs w into a scratch tensor
  in the kernel's stage layout, then ``halo_kernel``; a halo_f32 call
  likewise ``halo_f32_pack_w`` (w split into its TF32 hi and lo parts,
  scratch of twice w's size), then ``halo_f32_kernel``; a float32 gather
  call ``gather_f32_pack_w`` (w split and packed a stage's chunk at a
  time, scratch of :func:`gather_scratch_numel` values), then
  ``igemm_kernel``, and a bfloat16 one whose w streams likewise
  ``gather_bf16_pack_w``.
* On CPU tensors they run the plain versions,
  :func:`igemm_conv_reference` and :func:`igemm_conv_fused_reference`,
  which transcribe the probe's ``_igemm_accumulate`` and epilogue: nine
  shifted ``[N, H, W, C] @ [C, O]`` products of the zero-padded x summed in
  float32 from operands in the input dtype, then (fused) ``acc * a + b``
  and ``max(., 0)`` in float32, and one rounding to x's dtype.

``launches`` counts kernel calls, one per call of each wrapper:
``{"igemm": n, "fused": n}``; ``route_launches`` the same calls by route,
``{"halo": n, "halo_f32": n, "gather": n}``.  Plain-version calls never count.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"igemm": 0, "fused": 0}
route_launches = {"halo": 0, "halo_f32": 0, "gather": 0}

# ``Halo::kMaxPitch`` of csrc/conv.cu: the widest W + 2 the halo route takes
HALO_MAX_PITCH = 256
# ``HaloF32::kMaxPitch``: the widest W + 2 (to 8 points) whose two-stage
# ring fits the block's shared memory on the halo_f32 route
HALO_F32_MAX_PITCH = 184
# the halo routes' tile rows (``Halo::BM``, ``HaloF32::BM``): grid points
# up to the last tile's halo are ints in the kernels
_HALO_BM = 256

# ``Gather`` of csrc/conv.cu: a gather tile's patch holds at most
# GATHER_BM pixels, its warps multiply GATHER_WARP_ROWS rows each, a step
# takes at most GATHER_GRANULES 16-byte granules of channels; w stays in
# shared memory up to GATHER_W_RES bytes, else streams in stages of at most
# GATHER_STAGE bytes; the kernel is built for the output-channel tiles
# GATHER_BNS
GATHER_BM = 128
GATHER_WARP_ROWS = 16
GATHER_GRANULES = 4
GATHER_W_RES = 80 * 1024
GATHER_STAGE = 40 * 1024
GATHER_BNS = (8, 16, 24, 32, 48, 64)

_build.declare("conv.cu", "igemm_conv_launch", ctypes.c_int,
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
               + [ctypes.c_void_p])
_build.declare("conv.cu", "conv_halo_launch", ctypes.c_int,
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
               + [ctypes.c_void_p])


def conv_route(dtype: torch.dtype, n: int, h: int, w: int, c: int, o: int,
               aligned: bool) -> str:
    """The kernel a launch takes: with C and O multiples of 64, x, w and
    out 16-byte aligned (``aligned``) and the grid of pitch W + 2 within int
    range, ``"halo"`` for bfloat16 with W + 2 <= ``HALO_MAX_PITCH`` and
    ``"halo_f32"`` for float32 with W + 2 <= ``HALO_F32_MAX_PITCH``;
    ``"gather"`` otherwise (the CIFAR stem's C = 3, ragged channels,
    misaligned pointers, rows too wide)."""
    pitch = w + 2
    limit = {torch.bfloat16: HALO_MAX_PITCH,
             torch.float32: HALO_F32_MAX_PITCH}.get(dtype, 0)
    if (c % 64 == 0 and o % 64 == 0 and aligned and pitch <= limit
            and (n * (h + 1) - 1) * pitch + 2 * pitch + 2 * _HALO_BM
            < 2 ** 31 - 1):
        return "halo" if dtype == torch.bfloat16 else "halo_f32"
    return "gather"


def gather_bn(o: int) -> int:
    """The gather kernel's output-channel tile for O outputs: the least of
    GATHER_BNS that holds all of O, or the widest for O > 64 (64-wide
    tiles)."""
    return next((bn for bn in GATHER_BNS if bn >= o), GATHER_BNS[-1])


@functools.lru_cache(maxsize=None)
def gather_patch(n: int, h: int, w: int) -> tuple:
    """(TH, TW): the patch of a gather tile, TH TW <= GATHER_BM pixels of
    the images' grid (the N images' rows one under another, a zero row
    between two: N (H + 1) - 1 rows of W).  Of the widths that split W into
    equal parts (the last part no narrower than the rest need be), and for
    each the rows that split the grid so, the patch that costs the least:
    a tile's rows in whole warps plus its halo's (TH + 2)(TW + 2) points
    plus 32 for its fixed work, times the tiles; a tie goes to the wider
    patch (longer output rows)."""
    rows_all, bm = n * (h + 1) - 1, GATHER_BM
    best = None
    for tw in range(1, min(w, bm) + 1):
        n_w = -(-w // tw)
        if -(-w // n_w) != tw:
            continue
        n_h = -(-rows_all // (bm // tw))
        th = -(-rows_all // n_h)
        rows = -(-th * tw // GATHER_WARP_ROWS) * GATHER_WARP_ROWS
        cost = n_h * n_w * (rows + (th + 2) * (tw + 2) + 32)
        if best is None or (cost, -tw) < best[0]:
            best = ((cost, -tw), (th, tw))
    return best[1]


def _gather_w_bytes(bn: int, cg: int, elt: int) -> int:
    """``gather_w_bytes``: one chunk's w in shared memory (float32: its hi
    and lo parts)."""
    return 16 * cg * 9 * bn * (2 if elt == 4 else 1)


def gather_resident(c: int, bn: int, elt: int, cgs: int) -> bool:
    """``gather_resident``: whether all of w's chunks of ``cgs`` granules
    for one output tile stay in shared memory."""
    per = 16 // elt
    chunks = -(-c // (cgs * per))
    return chunks * _gather_w_bytes(bn, cgs, elt) <= GATHER_W_RES


def gather_step_granules(elt: int, th: int, tw: int, c: int,
                         bn: int) -> int:
    """The granules (16 bytes of channels) a gather step takes: the most,
    up to GATHER_GRANULES and C's, whose stage (the halo, and w where it
    streams) fits GATHER_STAGE bytes; one at least."""
    for cgs in range(min(GATHER_GRANULES, -(-c // (16 // elt))), 0, -1):
        stage = 16 * cgs * (th + 2) * (tw + 2)
        if not gather_resident(c, bn, elt, cgs):
            stage += _gather_w_bytes(bn, cgs, elt)
        if stage <= GATHER_STAGE:
            return cgs
    return 1


def gather_scratch_numel(c: int, o: int, cgs: int, elt: int) -> int:
    """Values (of ``elt`` bytes) of a gather launch's scratch: w packed a
    (output tile, chunk) at a time as its stages hold it, float32's split
    into TF32 hi and lo parts; none for bfloat16 w that stays resident."""
    bn = gather_bn(o)
    if elt == 2 and gather_resident(c, bn, elt, cgs):
        return 0
    per = 16 // elt
    return -(-o // bn) * -(-c // (per * cgs)) * 9 * bn * cgs * per \
        * (2 if elt == 4 else 1)


# ------------------------------------------------------------ plain versions


def _accumulate(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``[N, H, W, O]``: the nine shifted products of the
    zero-padded x with ``w[dy, dx]``, each product's operands in the input
    dtype and its sum in float32 (a bfloat16 product is exact in
    float32)."""
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += (xp[:, dy:dy + h, dx:dx + wd, :].to(torch.float32)
                    @ w[dy, dx].to(torch.float32))
    return acc


def igemm_conv_reference(x_nhwc: torch.Tensor,
                         w_hwio: torch.Tensor) -> torch.Tensor:
    """Plain version of the conv kernel: ``[N, H, W, O]`` in x's dtype."""
    return _accumulate(x_nhwc, w_hwio).to(x_nhwc.dtype)


def igemm_conv_fused_reference(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                               a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel: ``max(conv * a + b, 0)`` in
    float32, rounded once to x's dtype."""
    y = _accumulate(x_nhwc, w_hwio) * a.to(torch.float32) \
        + b.to(torch.float32)
    return torch.clamp_min(y, 0.0).to(x_nhwc.dtype)


# ------------------------------------------------------------------ kernels


def _check(x: torch.Tensor, w: torch.Tensor):
    """(N, H, W, C, O) of a launch; raises on what the kernels do not
    take."""
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"the conv kernels take float32 or bfloat16 x and w "
                         f"of one dtype, got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"the conv kernels take x [N, H, W, C] and w [3, 3, "
                         f"C, O], got {tuple(x.shape)}, {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the conv kernels take contiguous NHWC x and HWIO w")
    n, h, wd, c = (int(s) for s in x.shape)
    o = int(w.shape[3])
    if min(n, h, wd, c, o) < 1:
        raise ValueError(f"empty conv operands {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if n * h * wd >= 2 ** 31:
        raise ValueError(f"too many output pixels for the conv kernels: "
                         f"{n * h * wd}")
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernels run on CUDA tensors, not "
                         f"{x.device.type}")
    if w.device != x.device:
        raise ValueError(f"x and w must lie on one device: {x.device}, "
                         f"{w.device}")
    return n, h, wd, c, o


def _launch(x, w, a, b, fused: bool) -> torch.Tensor:
    n, h, wd, c, o = _check(x, w)
    out = torch.empty((n, h, wd, o), dtype=x.dtype, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
    route = conv_route(x.dtype, n, h, wd, c, o, aligned)
    lib = _build.load_kernel_library("conv.cu")
    ptrs = (x.data_ptr(), w.data_ptr(),
            a.data_ptr() if fused else None, b.data_ptr() if fused else None,
            out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route in ("halo", "halo_f32"):
            # scratch for w in the kernel's stage layout (float32: its TF32
            # hi and lo parts, twice w's size)
            wp = torch.empty(w.numel() * (2 if route == "halo_f32" else 1),
                             dtype=w.dtype, device=w.device)
            name = "conv_halo_launch"
            rc = lib.conv_halo_launch(*ptrs, wp.data_ptr(), n, h, wd, c, o,
                                      _DTYPE_CODE[x.dtype], int(fused),
                                      stream)
        else:
            th, tw = gather_patch(n, h, wd)
            bn = gather_bn(o)
            cgs = gather_step_granules(x.element_size(), th, tw, c, bn)
            # scratch for w packed by the launch (float32, streamed bf16)
            numel = gather_scratch_numel(c, o, cgs, x.element_size())
            wp = (torch.empty(numel, dtype=x.dtype, device=x.device)
                  if numel else None)
            name = "igemm_conv_launch"
            rc = lib.igemm_conv_launch(*ptrs, wp.data_ptr() if wp is not None
                                       else None, n, h, wd, c, o, th, tw, bn,
                                       cgs, _DTYPE_CODE[x.dtype], int(fused),
                                       stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    route_launches[route] += 1
    return out


def _epilogue_vector(v: torch.Tensor, o: int, dev) -> torch.Tensor:
    if v.numel() != o:
        raise ValueError(f"a and b must have {o} values, got "
                         f"{tuple(v.shape)}")
    return v.reshape(o).to(device=dev, dtype=torch.float32).contiguous()


def igemm_conv_kernel(x_nhwc: torch.Tensor,
                      w_hwio: torch.Tensor) -> torch.Tensor:
    """One launch of the conv kernel."""
    out = _launch(x_nhwc, w_hwio, None, None, fused=False)
    launches["igemm"] += 1
    return out


def igemm_conv_fused_kernel(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the fused kernel."""
    o = int(w_hwio.shape[-1])
    a = _epilogue_vector(a, o, x_nhwc.device)
    b = _epilogue_vector(b, o, x_nhwc.device)
    out = _launch(x_nhwc, w_hwio, a, b, fused=True)
    launches["fused"] += 1
    return out


# ------------------------------------------------------------------ public


def igemm_conv(x_nhwc: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv, ``[N, H, W, C] x [3, 3, C, O] -> [N, H, W, O]``: the
    kernel on CUDA tensors, the plain version on CPU ones."""
    if x_nhwc.device.type == "cpu":
        return igemm_conv_reference(x_nhwc, w_hwio)
    return igemm_conv_kernel(x_nhwc, w_hwio)


def igemm_conv_fused(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``max(conv * a + b, 0)``: the kernel on CUDA tensors, the plain
    version on CPU ones."""
    if x_nhwc.device.type == "cpu":
        return igemm_conv_fused_reference(x_nhwc, w_hwio, a, b)
    return igemm_conv_fused_kernel(x_nhwc, w_hwio, a, b)
