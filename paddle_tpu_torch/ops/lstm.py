"""The fused LSTM recurrence (PyTorch port of ``paddle_tpu/ops/lstm.py``).

The input projection ``x @ Wx + b`` for all steps is one large matmul done
by the caller; what is left per step (``h @ U``, the gates, the masked cell
update) is the recurrence.  ``fused_lstm`` is a ``torch.autograd.Function``:

* CPU tensors run the plain versions: ``_lstm_scan`` (a Python loop over T
  of torch ops, the JAX package's scan reference) forward, and
  ``_lstm_scan_vjp`` (``torch.autograd.grad`` through a recompute of
  ``_lstm_scan``, the counterpart of ``_fused_bwd``) backward;
* CUDA tensors run the hand-written kernels of ``csrc/lstm.cu`` (forward,
  and the reverse recurrence for the backward), or raise: there is no
  fallback to the plain versions;
* meta tensors give outputs of the right shapes and launch nothing, so a
  program is built without the card.

Each kernel call takes one of two routes, chosen by shape before the launch
(:func:`lstm_route`): ``"persistent"``, one cooperative launch for the whole
sequence with each block's U slice resident in shared memory, or
``"step"``, one launch per step.  ``fused_lstm.launches`` counts
kernel-library calls by kernel (``fwd``, ``bwd``) and
``fused_lstm.route_launches`` the same calls by route; plain-version calls
never count.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda v: v}
# the activation codes of csrc/lstm.cu (a test pins them to the source)
ACT_CODE = {"sigmoid": 0, "tanh": 1, "relu": 2, "identity": 3}

# the persistent route's tile and shared memory (csrc/lstm.cu; a test pins
# them to the source): a block owns P_ROWS batch rows x P_UNITS hidden units
# with P_THREADS threads in P_WARPS warps, each warp one range of the depth
P_ROWS, P_UNITS, P_THREADS = 32, 16, 256
P_WARPS = P_THREADS // 32
FWD_DEPTH_ALIGN = 64
BWD_CHUNK, BWD_STAGES, BWD_PITCH, BWD_LANE_PARTS = 32, 2, 40, 4


def fwd_warp_depth(H: int) -> int:
    """Depth of h_{t-1} and U a warp of the persistent forward takes."""
    return 8 * -(-H // FWD_DEPTH_ALIGN)


def bwd_warp_depth(H: int) -> int:
    """Depth of dgates_{t+1} and U a warp of the persistent reverse takes,
    a whole number of ring chunks."""
    return BWD_CHUNK * -(-H // 64)


def fwd_smem_bytes(H: int) -> int:
    """Shared memory of a persistent forward block: U [Hp][16][4] resident,
    then h_{t-1} [32][Hp + 4], whose space the warps' partial sums take."""
    hp = P_WARPS * fwd_warp_depth(H)
    red = P_WARPS * P_ROWS * P_UNITS * 4
    return 4 * (hp * P_UNITS * 4 + max(P_ROWS * (hp + 4), red))


def bwd_smem_bytes(H: int) -> int:
    """Shared memory of a persistent reverse block: the tile's 16 rows of U
    over the padded depth, then each warp's ring (the partial sums reuse
    it)."""
    ring = P_WARPS * BWD_STAGES * P_ROWS * BWD_PITCH
    return 4 * (P_WARPS * bwd_warp_depth(H) * P_UNITS + ring)


def lstm_route(T: int, B: int, H: int, n_sm: int, smem_optin: int) -> str:
    """The route both kernels of a call take on a card with ``n_sm`` SMs and
    ``smem_optin`` bytes of opt-in shared memory a block: ``"persistent"``
    when H is a multiple of 4 (16-byte copies of h and dgates), both
    kernels' tiles fit the shared memory and the grid of ceil(H/16) x
    ceil(B/32) blocks fits one block an SM, so that every block is resident
    at once; ``"step"`` otherwise.  T does not change the route."""
    del T
    grid = -(-H // P_UNITS) * -(-B // P_ROWS)
    if (H % 4 == 0 and max(fwd_smem_bytes(H), bwd_smem_bytes(H)) <= smem_optin
            and grid <= n_sm):
        return "persistent"
    return "step"


# ------------------------------------------------------------ plain versions


def _lstm_scan(xw, u, peep, mask, size: int, use_peepholes: bool, acts):
    """Plain version of the forward kernel: xw [T, B, 4H], u [H, 4H], peep
    [3, H], mask [T, B] -> (hs [T, B, H] zero at padded steps, c_final
    [B, H] frozen at each row's last valid step)."""
    ga, ca, cda = (_ACT[a] for a in acts)
    T, B = xw.shape[0], xw.shape[1]
    h = xw.new_zeros((B, size))
    c = xw.new_zeros((B, size))
    hs = []
    for t in range(T):
        g = xw[t] + h @ u
        gi, gf, gc, go = torch.split(g, size, dim=-1)
        if use_peepholes:
            i, f = ga(gi + c * peep[0]), ga(gf + c * peep[1])
        else:
            i, f = ga(gi), ga(gf)
        c_new = f * c + i * cda(gc)
        o = ga(go + c_new * peep[2]) if use_peepholes else ga(go)
        h_new = o * ca(c_new)
        m = mask[t][:, None]
        h = h_new * m + h * (1 - m)
        c = c_new * m + c * (1 - m)
        hs.append(h_new * m)
    out = torch.stack(hs) if hs else xw.new_zeros((0, B, size))
    return out, c


def _lstm_scan_vjp(xw, u, peep, mask, size: int, use_peepholes: bool, acts,
                   g_hs, g_c):
    """Plain version of the backward kernel: (dxw, du, dpeep) of
    ``_lstm_scan`` against the cotangents (g_hs, g_c), by autograd through
    a recompute.  dpeep is zero when the peepholes are off."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xw, u, peep)]
        hs, c_final = _lstm_scan(*leaves, mask, size, use_peepholes, acts)
        grads = torch.autograd.grad((hs, c_final), leaves, (g_hs, g_c),
                                    allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads))


# ------------------------------------------------------------------ kernels


def check_lstm_dtype(dtype: torch.dtype) -> None:
    """Raise on a dtype the CUDA kernels do not take: the wrappers call this
    at every launch, and ``Executor.run`` before a program's first step on
    a card."""
    if dtype != torch.float32:
        raise ValueError(f"the LSTM kernels take float32, got {dtype}")


def _check_operands(xw, u, peep, mask, size: int) -> None:
    """Raise on anything the CUDA kernels do not take: every operand a
    contiguous float32 tensor on one CUDA device, xw [T, B, 4H], u [H, 4H],
    peep [3, H], mask [T, B] with H = size."""
    if xw.device.type != "cuda":
        raise ValueError(f"the LSTM kernels run on CUDA tensors, not "
                         f"{xw.device.type}")
    for t in (xw, u, peep, mask):
        if t.device != xw.device:
            raise ValueError(f"LSTM operands must all lie on {xw.device}, "
                             f"found one on {t.device}")
        check_lstm_dtype(t.dtype)
        if not t.is_contiguous():
            raise ValueError("the LSTM kernels need contiguous operands")
    H = int(size)
    if xw.dim() != 3 or xw.shape[2] != 4 * H:
        raise ValueError(f"xw must be [T, B, 4*size] = [T, B, {4 * H}], got "
                         f"{tuple(xw.shape)}")
    T, B = xw.shape[0], xw.shape[1]
    for name, t, want in (("u", u, (H, 4 * H)), ("peep", peep, (3, H)),
                          ("mask", mask, (T, B))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")


def _act_codes(use_peepholes: bool, acts):
    return (int(bool(use_peepholes)),) + tuple(ACT_CODE[a] for a in acts)


def _entry(name: str, n_ptr: int):
    fn = getattr(_build.load_kernel_library("lstm.cu"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


_limits = {}


def device_limits(dev: torch.device) -> tuple:
    """(SM count, opt-in shared memory a block in bytes) of CUDA device
    ``dev``, from the CUDA runtime, read once per device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _limits:
        fn = _build.load_kernel_library("lstm.cu").lstm_device_limits
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        n_sm, smem = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(ctypes.byref(n_sm), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"lstm_device_limits failed: CUDA error {rc}")
        _limits[index] = (n_sm.value, smem.value)
    return _limits[index]


def _route(dev, T: int, B: int, H: int) -> str:
    return lstm_route(T, B, H, *device_limits(dev))


def _sync(dev, B: int) -> torch.Tensor:
    """The persistent route's arrival counters, one per row group, zero."""
    return torch.zeros(-(-B // P_ROWS), dtype=torch.int32, device=dev)


def _launch(fn, ptrs, dev, T: int, B: int, H: int, codes) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, T, B, H, *codes, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def lstm_fwd_kernel(xw, u, peep, mask, size: int, use_peepholes: bool, acts,
                    residuals: bool):
    """One call of the forward kernel on the route :func:`lstm_route` gives
    (one device launch persistent, T on the step route).  Returns (hs, hc,
    cc, gates, cnew): hs [T, B, H]; the carried state hc, cc [T + 1, B, H]
    with the zero initial state in slot 0 (c_final is cc[T]); with
    ``residuals`` the activated gates [T, B, 4H] and c_new [T, B, H] for
    the backward, else None for both."""
    _check_operands(xw, u, peep, mask, size)
    T, B, H = xw.shape[0], xw.shape[1], int(size)
    route = _route(xw.device, T, B, H)
    hs = torch.empty((T, B, H), dtype=xw.dtype, device=xw.device)
    hc = torch.empty((T + 1, B, H), dtype=xw.dtype, device=xw.device)
    cc = torch.empty_like(hc)
    hc[0].zero_()
    cc[0].zero_()
    gates = cnew = None
    if residuals:
        gates = torch.empty_like(xw)
        cnew = torch.empty_like(hs)
    ptrs = (xw.data_ptr(), u.data_ptr(), peep.data_ptr(), mask.data_ptr(),
            hs.data_ptr(), hc.data_ptr(), cc.data_ptr(),
            0 if gates is None else gates.data_ptr(),
            0 if cnew is None else cnew.data_ptr())
    if route == "persistent":
        _launch(_entry("lstm_fwd_persistent_launch", 10),
                ptrs + (_sync(xw.device, B).data_ptr(),), xw.device, T, B, H,
                _act_codes(use_peepholes, acts))
    else:
        _launch(_entry("lstm_fwd_launch", 9), ptrs, xw.device, T, B, H,
                _act_codes(use_peepholes, acts))
    fused_lstm.launches["fwd"] += 1
    fused_lstm.route_launches[route] += 1
    return hs, hc, cc, gates, cnew


def lstm_bwd_kernel(g_hs, g_c, u, peep, mask, gates, cnew, cc, size: int,
                    use_peepholes: bool, acts):
    """One call of the reverse-recurrence kernel on the route
    :func:`lstm_route` gives (one device launch persistent, T on the step
    route): the gate gradients dxw [T, B, 4H] from the cotangents g_hs
    [T, B, H] and g_c [B, H] and the forward's residuals."""
    _check_operands(gates, u, peep, mask, size)
    T, B, H = gates.shape[0], gates.shape[1], int(size)
    for name, t, want in (("g_hs", g_hs, (T, B, H)), ("g_c", g_c, (B, H)),
                          ("cnew", cnew, (T, B, H)), ("cc", cc, (T + 1, B, H))):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or t.device != gates.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {want} on "
                             f"{gates.device}")
    route = _route(gates.device, T, B, H)
    dh = torch.empty((B, H), dtype=torch.float32, device=gates.device)
    dc = g_c.clone()
    dxw = torch.empty_like(gates)
    ptrs = (g_hs.data_ptr(), u.data_ptr(), peep.data_ptr(), mask.data_ptr(),
            gates.data_ptr(), cnew.data_ptr(), cc.data_ptr(), dh.data_ptr(),
            dc.data_ptr(), dxw.data_ptr())
    if route == "persistent":
        _launch(_entry("lstm_bwd_persistent_launch", 11),
                ptrs + (_sync(gates.device, B).data_ptr(),), gates.device, T,
                B, H, _act_codes(use_peepholes, acts))
    else:
        _launch(_entry("lstm_bwd_launch", 10), ptrs, gates.device, T, B, H,
                _act_codes(use_peepholes, acts))
    fused_lstm.launches["bwd"] += 1
    fused_lstm.route_launches[route] += 1
    return dxw


def lstm_bwd_cuda(g_hs, g_c, u, peep, mask, hc, cc, gates, cnew, size: int,
                  use_peepholes: bool, acts):
    """The backward on the card: the reverse-recurrence kernel, then, as the
    JAX package computes them outside any kernel, du = sum_t h_{t-1}^T
    dxw_t (one matmul over [T*B, H] x [T*B, 4H]) and the peephole sums.
    Returns (dxw, du, dpeep)."""
    dxw = lstm_bwd_kernel(g_hs, g_c, u, peep, mask, gates, cnew, cc, size,
                          use_peepholes, acts)
    T, B, H = gates.shape[0], gates.shape[1], int(size)
    du = hc[:T].reshape(T * B, H).t() @ dxw.reshape(T * B, 4 * H)
    if use_peepholes:
        c_prev = cc[:T]
        dpeep = torch.stack([(dxw[..., :H] * c_prev).sum((0, 1)),
                             (dxw[..., H:2 * H] * c_prev).sum((0, 1)),
                             (dxw[..., 3 * H:] * cnew).sum((0, 1))])
    else:
        dpeep = torch.zeros_like(peep)
    return dxw, du, dpeep


# ------------------------------------------------------------------ public


class _LSTM(torch.autograd.Function):
    """The recurrence with its gradient; returns (hs, c_final)."""

    @staticmethod
    def forward(ctx, xw, u, peep, mask, size, use_peepholes, acts):
        ctx.size, ctx.use_peepholes, ctx.acts = size, use_peepholes, acts
        ctx.on_cpu = xw.device.type == "cpu"
        ctx.hs_like = dict(size=(xw.shape[0], xw.shape[1], size),
                           dtype=xw.dtype, device=xw.device)
        if ctx.on_cpu:
            hs, c_final = _lstm_scan(xw, u, peep, mask, size, use_peepholes,
                                     acts)
            ctx.save_for_backward(xw, u, peep, mask)
            return hs, c_final
        residuals = any(ctx.needs_input_grad[:3])
        hs, hc, cc, gates, cnew = lstm_fwd_kernel(
            xw, u, peep, mask, size, use_peepholes, acts, residuals)
        if residuals:
            ctx.save_for_backward(u, peep, mask, hc, cc, gates, cnew)
        return hs, cc[-1].clone()

    @staticmethod
    def backward(ctx, g_hs, g_c):
        # an unused output's cotangent arrives as None: zeros, as
        # jax.custom_vjp gives
        if g_hs is None:
            g_hs = torch.zeros(**ctx.hs_like)
        if g_c is None:
            g_c = torch.zeros(**dict(ctx.hs_like,
                                     size=ctx.hs_like["size"][1:]))
        args = (ctx.size, ctx.use_peepholes, ctx.acts)
        saved = ctx.saved_tensors
        if ctx.on_cpu:
            xw, u, peep, mask = saved
            dxw, du, dpeep = _lstm_scan_vjp(xw, u, peep, mask, *args, g_hs,
                                            g_c)
        else:
            u, peep, mask, hc, cc, gates, cnew = saved
            dxw, du, dpeep = lstm_bwd_cuda(
                g_hs.to(torch.float32).contiguous(),
                g_c.to(torch.float32).contiguous(), u, peep, mask, hc, cc,
                gates, cnew, *args)
        return dxw, du, dpeep, None, None, None, None


def fused_lstm(xw: torch.Tensor, u: torch.Tensor, peep: torch.Tensor,
               mask: torch.Tensor, *, size: int, use_peepholes: bool = False,
               gate_activation: str = "sigmoid", cell_activation: str = "tanh",
               candidate_activation: str = "tanh"):
    """Run an LSTM over a padded batch.

    xw: [T, B, 4*size] pre-projected gate inputs (x @ Wx + bias, gate order
        i, f, c, o), time-major.
    u: [size, 4*size] recurrent weight.
    peep: [3, size] peephole weights (ignored, and given a zero gradient,
        when use_peepholes is False).
    mask: [T, B] float 1/0 valid-step mask (no gradient).
    Returns (hs [T, B, size] zero past each row's length, c_final [B, size]
    frozen at each row's last valid step).  CUDA tensors run the kernels
    (contiguous float32 only) or raise; CPU tensors run the plain versions;
    meta tensors give empty outputs of the right shapes."""
    acts = (gate_activation, cell_activation, candidate_activation)
    for a in acts:
        if a not in ACT_CODE:
            raise ValueError(f"unknown LSTM activation {a!r}: one of "
                             f"{sorted(ACT_CODE)}")
    if xw.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fused_lstm runs on cuda or cpu tensors, not "
                         f"{xw.device.type}")
    size = int(size)
    if xw.device.type == "meta":
        T, B = xw.shape[0], xw.shape[1]
        return (torch.empty((T, B, size), dtype=xw.dtype, device="meta"),
                torch.empty((B, size), dtype=xw.dtype, device="meta"))
    return _LSTM.apply(xw, u, peep, mask, size, bool(use_peepholes), acts)


fused_lstm.launches = {"fwd": 0, "bwd": 0}
fused_lstm.route_launches = {"persistent": 0, "step": 0}
