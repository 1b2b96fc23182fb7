"""Time the paged decode-attention, flash-forward and flash-backward kernels
of one checkout of the port, or (``--conv``) its 3x3 conv kernels, or
(``--lstm``) its LSTM kernels, so that two versions can be compared in
turns on one card.

    python3 paddle_tpu_torch/tools/kernel_turns.py --tree DIR [--label L]
    python3 paddle_tpu_torch/tools/kernel_turns.py --tree DIR --conv
    python3 paddle_tpu_torch/tools/kernel_turns.py --tree DIR --lstm

Imports ``paddle_tpu_torch`` from the checkout ``DIR`` (another version of
this package: only ``paged_attention``, ``quantize_kv``,
``flash_fwd_kernel``, ``flash_bwd_dkdv_kernel`` and ``flash_bwd_dq_kernel``
and the plain versions beside them are called, with the signatures every
version so far has), builds its kernels there, and runs ``chip_smoke.py``'s
kernel cases from the checkout this script lies in: paged attention for
float32, bfloat16 and int8 arenas at W=1 and W=4 (8 slots, 8 heads, Dh 64,
block 16, T 1024), and the flash forward, dK/dV and dQ kernels at N=64,
T=1024, D=64, causal, in float32 and bfloat16.  Each case: the largest
difference from the plain version (for the backward also over the
gradient's max |g|), the event-timed call and the device time
(``chip_smoke.both_ms``), and the bound; the flash kernels' registers and
spills as ptxas reported them when this run built them.  Prints one JSON
line.  With ``--conv`` the cases are instead ``igemm_conv_kernel`` and
``igemm_conv_fused_kernel`` (the signatures every version since the conv
kernels came has) at ``chip_smoke.py``'s four ResNet stride-1 shapes
(c56, c28, c14, c7) in bfloat16 and in float32, and the plain kernel at
each of its ``CONV_MODEL_CASES`` in the dtypes it lists (the fused one too
at ``CONV_GATHER_FUSED``), each with the route this checkout's
``conv_route`` gives it, its worst error over ``chip_smoke``'s limit
against the plain version, the two times and the bound, and ptxas's
report for ``conv.cu``.  With ``--lstm``
they are the LSTM kernels at ``chip_smoke.py``'s text_lstm case (T=100,
B=128, H=512, float32, no peepholes, lengths 50-100): ``lstm_fwd_kernel``
with the backward's residuals (as training calls it), ``lstm_bwd_kernel``
(the reverse recurrence alone) and ``lstm_bwd_cuda`` (the whole backward:
the kernel, the du matmul and the peephole sums), the signatures every
version since the LSTM kernels came has; each with its error against the
plain version (the backward's over each gradient's max |g|), the two times
and the bound, the route counts where the version has them, and ptxas's
report for ``lstm.cu``.  With ``--bf16-cases`` they are the bfloat16
backward pair at the shapes of ``BF16_CASES`` (D in {16, 32, 64, 128},
causal or not, ragged, Tq != Tk; inputs from ``chip_smoke._flash_inputs``):
each case run twice, with the worst error over ``chip_smoke.py``'s
element-wise limit against the plain versions and, on the same limit,
both the kernels' and the plain versions' against the float64 arithmetic
(``chip_smoke._bwd_f64``), and whether the second run repeats the first
bit for bit.  With ``--dropout`` they are the dropout kernels,
``dropout_fwd_kernel`` and ``dropout_bwd_kernel`` with no counter map (the
signatures every version since the kernel came has), at the LM's
[8, 1024, 512] in float32 and bfloat16 (p = 0.1), each bitwise against
the plain version, its two times and the bound; where the version takes a
counter map (``ops/dropout.py::CounterMap``), the same kernels again on
one rank's slice of a {dp 2, sp 2} striped layout ([4, 512, 512], the
two-run map), and in every version unmapped at that size; and ptxas's
report for ``dropout.cu``.  Run it for the old
and the new checkout in turns,
in one call on one card (old, new, new, old): the card's power limit and
its neighbours differ between calls.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]   # the checkout holding chip_smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="checkout whose paddle_tpu_torch is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--conv", action="store_true",
                    help="time the conv kernels instead")
    ap.add_argument("--lstm", action="store_true",
                    help="time the LSTM kernels instead")
    ap.add_argument("--bf16-cases", action="store_true",
                    help="check the bf16 backward pair at BF16_CASES instead")
    ap.add_argument("--dropout", action="store_true",
                    help="time the dropout kernels instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import importlib.util

    import numpy as np
    import torch

    # this checkout's chip_smoke (its cases), whichever tree is timed
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import paddle_tpu_torch
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as TA
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference)

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns needs a CUDA card")
    dev = torch.device("cuda")
    if args.conv or args.lstm or args.bf16_cases or args.dropout:
        turn = (_conv_turn if args.conv else
                _lstm_turn if args.lstm else
                _dropout_turn if args.dropout else _bf16_cases_turn)
        print(json.dumps({"label": args.label or args.tree,
                          "package": str(Path(paddle_tpu_torch.__file__)
                                         .parent),
                          "card": paddle_tpu_torch.card_info(0),
                          **turn(cs, dev)}))
        return 0
    res = {"label": args.label or args.tree,
           "package": str(Path(paddle_tpu_torch.__file__).parent),
           "card": paddle_tpu_torch.card_info(0), "paged": {}, "flash": {}}
    rng = np.random.RandomState(0)
    for kind in ("float32", "bfloat16", "int8"):
        for W in (1, 4):
            q, kp, vp, tables, lengths = cs._kernel_inputs(kind, W, dev, rng)
            qq = q[:, 0] if W == 1 else q
            ll = lengths[:, 0] if W == 1 else lengths
            got = paged_attention(qq, kp, vp, cs.KLAYER, tables, ll)
            want = paged_attention_reference(qq, kp, vp, cs.KLAYER, tables,
                                             ll, out_dtype=q.dtype)
            ms, dev_ms = cs.both_ms(lambda i: paged_attention(
                qq, kp, vp, i % cs.KL, tables, ll))
            res["paged"][f"{kind} W={W}"] = {
                "max_abs_err": float((got.float() - want.float()).abs()
                                     .max()),
                "ms": ms, "device_ms": dev_ms,
                "bound_ms": cs._bound(kind, W, q, lengths)[0]}
    N, T, D = 64, 1024, 64
    for dtype in (torch.float32, torch.bfloat16):
        frng = np.random.RandomState(1)
        q, k, v = (torch.from_numpy(frng.standard_normal((N, T, D)).astype(
            np.float32)).to(dev, dtype) for _ in range(3))
        scale = D ** -0.5
        o, lse = TA.flash_fwd_kernel(q, k, v, scale, True)
        ro, rlse = TA._fwd_reference(q, k, v, scale, True)
        ms, dev_ms = cs.both_ms(lambda i: TA.flash_fwd_kernel(q, k, v, scale,
                                                            True))
        res["flash"][str(dtype).replace("torch.", "")] = {
            "o_max_abs_err": float((o.float() - ro.float()).abs().max()),
            "lse_max_abs_err": float((lse - rlse).abs().max()),
            "ms": ms, "device_ms": dev_ms,
            "bound_ms": cs._flash_bound("fwd", N, T, T, D, True, dtype)[0]}
        # the backward pair on the forward's (o, lse) and a cotangent g
        g = torch.from_numpy(frng.standard_normal((N, T, D)).astype(
            np.float32)).to(dev, dtype)
        delta = (ro.float() * g.float()).sum(dim=-1).contiguous()
        args = (q, k, v, g, rlse, delta, scale, True)
        for kern, fn, plain in (
                ("bwd_dkdv", TA.flash_bwd_dkdv_kernel,
                 TA._bwd_dkdv_blockwise),
                ("bwd_dq", TA.flash_bwd_dq_kernel, TA._bwd_dq_blockwise)):
            got, want = fn(*args), plain(*args, 128)
            if kern == "bwd_dq":
                got, want = (got,), (want,)
            diffs = [float((a.float() - b.float()).abs().max())
                     for a, b in zip(got, want)]
            rels = [d / float(b.float().abs().max())
                    for d, b in zip(diffs, want)]
            ms, dev_ms = cs.both_ms(lambda i, fn=fn: fn(*args))
            res["flash"][f"{kern} {str(dtype).replace('torch.', '')}"] = {
                "max_abs_err": max(diffs), "max_rel_err": max(rels),
                "ms": ms, "device_ms": dev_ms,
                "bound_ms": cs._flash_bound(kern, N, T, T, D, True,
                                            dtype)[0]}
    res["ptxas"] = [
        {"kernel": name, "registers": regs, "spill_bytes": spill}
        for name, regs, spill in cs._ptxas_report(
            _build.build_logs.get("flash_attention.cu", ""))]
    print(json.dumps(res))
    return 0


# (N = B*H, Tq, Tk, D, causal) of --bf16-cases
BF16_CASES = [(64, 1024, 1024, 64, True), (8, 50, 70, 16, False),
              (8, 37, 37, 16, True), (4, 200, 200, 32, True),
              (4, 200, 130, 128, True), (4, 130, 200, 128, False),
              (4, 300, 300, 64, False), (2, 70, 50, 64, True),
              (4, 257, 257, 128, True), (3, 129, 129, 16, False)]


def _bf16_cases_turn(cs, dev) -> dict:
    """The bf16 backward cases (see the module note): {"cases": [...],
    "ptxas": [...]}."""
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import attention as TA

    out = []
    for N, Tq, Tk, D, causal in BF16_CASES:
        q, k, v, g = cs._flash_inputs(N, Tq, Tk, D, torch.bfloat16, dev)
        scale = D ** -0.5
        ro, rlse = TA._fwd_reference(q, k, v, scale, causal)
        runs = [TA.flash_bwd_kernels(q, k, v, ro, rlse, g, scale, causal)
                for _ in range(2)]
        torch.cuda.synchronize()
        plain = TA._bwd_blockwise(q, k, v, ro, rlse, g, scale, causal, 128)
        delta = (ro.float() * g.float()).sum(dim=-1)
        ref = cs._bwd_f64(q, k, v, g, rlse, delta, scale, causal)
        rec = {"case": [N, Tq, Tk, D, causal],
               "repeats": all(bool(torch.equal(a, b))
                              for a, b in zip(*runs)),
               "finite": all(bool(torch.isfinite(t.float()).all())
                             for t in runs[0])}
        for n, got, want, r in zip(("dq", "dk", "dv"), runs[0], plain, ref):
            rec[n] = {"vs_plain": cs._bf16_bwd_worst(got, want),
                      "kernel_vs_f64": cs._bf16_bwd_worst(got, r),
                      "plain_vs_f64": cs._bf16_bwd_worst(want, r)}
        out.append(rec)
        del runs, plain, ref
    return {"cases": out, "ptxas": [
        {"kernel": name, "registers": regs, "spill_bytes": spill}
        for name, regs, spill in cs._ptxas_report(
            _build.build_logs.get("flash_attention.cu", ""))]}


def _conv_turn(cs, dev) -> dict:
    """The conv cases (see the module note): {"conv": {case: record},
    "ptxas": [...]}."""
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import conv as TC

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    shapes = {label: dims for label, *dims in cs.CONV_CASES}
    cases = [(label, shapes[label], dtype, ("igemm", "fused"))
             for dtype in (torch.bfloat16, torch.float32)
             for label in ("c56", "c28", "c14", "c7")]
    fused_too = getattr(cs, "CONV_GATHER_FUSED", ())
    cases += [(label, dims, dtype,
               ("igemm", "fused") if label in fused_too else ("igemm",))
              for label, *dims, routes in cs.CONV_MODEL_CASES
              for dtype in routes]
    out = {}
    for label, (n, h, w, c, o), dtype, kerns in cases:
        kind = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev)
        gen.manual_seed(n + h * w + c + o)
        x = torch.randn((n, h, w, c), generator=gen,
                        device=dev).to(dtype)
        wt = (torch.randn((3, 3, c, o), generator=gen, device=dev)
              / (9 * c) ** 0.5).to(dtype)
        a = torch.rand(o, generator=gen, device=dev) + 0.5
        b = torch.randn(o, generator=gen, device=dev) * 0.3
        for kern, fn, plain in (
                ("igemm", lambda i: TC.igemm_conv_kernel(x, wt),
                 lambda: TC.igemm_conv_reference(x, wt)),
                ("fused", lambda i: TC.igemm_conv_fused_kernel(
                    x, wt, a, b),
                 lambda: TC.igemm_conv_fused_reference(x, wt, a, b))):
            if kern not in kerns:
                continue
            got, want = fn(0), plain()
            top = float(want.float().abs().max())
            if dtype == torch.float32:
                worst = cs._abs(got, want) / (cs.CONV_F32_REL * top)
            else:
                worst = cs._worst(got, want,
                                  2 * cs.BF16_U * want.float().abs()
                                  + cs.CONV_BF16_SUM_REL * top)
            del got, want
            ms, dev_ms = cs.both_ms(fn)
            out[f"{kern} {label} {kind}"] = {
                "route": TC.conv_route(dtype, n, h, w, c, o, True),
                "worst_over_limit": worst, "ms": ms,
                "device_ms": dev_ms,
                "bound_ms": cs._conv_bound(kern, n, h, w, c, o,
                                           dtype)[0]}
        del x, wt
        torch.cuda.empty_cache()
    return {"conv": out, "ptxas": [
        {"kernel": name, "registers": regs, "spill_bytes": spill}
        for name, regs, spill in cs._ptxas_report(
            _build.build_logs.get("conv.cu", ""))]}


def _lstm_turn(cs, dev) -> dict:
    """The LSTM cases (see the module note): {"lstm": {kernel: record},
    "route_launches": ..., "ptxas": [...]}."""
    import numpy as np
    import torch

    from paddle_tpu_torch.ops import _build, fused_lstm
    from paddle_tpu_torch.ops import lstm as TL

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    T, B, H = cs.LSTM_SHAPE
    lengths = np.random.RandomState(0).randint(T // 2, T + 1, B)
    xw, u, peep, mask, g_hs, g_c = cs._lstm_inputs(T, B, H, lengths, dev,
                                                    T + B + H)
    args = (H, False, cs.LSTM_ACTS)
    routes = dict(getattr(fused_lstm, "route_launches", {}))
    hs, hc, cc, gates, cnew = TL.lstm_fwd_kernel(xw, u, peep, mask, *args,
                                                 True)
    rhs, rc = TL._lstm_scan(xw, u, peep, mask, *args)
    got = TL.lstm_bwd_cuda(g_hs, g_c, u, peep, mask, hc, cc, gates, cnew,
                           *args)
    want = TL._lstm_scan_vjp(xw, u, peep, mask, *args, g_hs, g_c)
    routes = {k: v - routes[k]
              for k, v in getattr(fused_lstm, "route_launches", {}).items()}
    err_b = {n: cs._abs(a, b) / max(float(b.abs().max()), 1e-30)
             for n, a, b in zip(("dxw", "du", "dpeep"), got, want)}
    n_valid = int(mask.sum())
    out = {}
    for kern, fn, err, bound in (
            ("fwd", lambda i: TL.lstm_fwd_kernel(xw, u, peep, mask, *args,
                                                 True),
             {"hs, c_final": max(cs._abs(hs, rhs), cs._abs(cc[-1], rc))},
             cs._lstm_bound("fwd", T, B, H, n_valid)),
            ("bwd_kernel", lambda i: TL.lstm_bwd_kernel(
                g_hs, g_c, u, peep, mask, gates, cnew, cc, *args),
             {"dxw": err_b["dxw"]},
             cs._lstm_bound("bwd", T, B, H, n_valid, whole=False)),
            ("bwd", lambda i: TL.lstm_bwd_cuda(
                g_hs, g_c, u, peep, mask, hc, cc, gates, cnew, *args),
             err_b, cs._lstm_bound("bwd", T, B, H, n_valid))):
        ms, dev_ms = cs.both_ms(fn)
        out[kern] = {"err": err, "ms": ms, "device_ms": dev_ms,
                     "bound_ms": bound[0], "bound_by": bound[1]}
    return {"lstm": out, "route_launches": routes, "ptxas": [
        {"kernel": name, "registers": regs, "spill_bytes": spill}
        for name, regs, spill in cs._ptxas_report(
            _build.build_logs.get("lstm.cu", ""))]}


def _dropout_turn(cs, dev) -> dict:
    """The dropout cases (see the module note): {"dropout": {case:
    record}, "ptxas": [...]}."""
    import torch

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import dropout as dmod

    shape, p = (8, 1024, 512), 0.1
    key = dmod.ThreefryKey(cs.DROPOUT_SEED, 3, 5)
    # the slice's size unmapped too: what its size costs without the map
    cases = [("whole", shape, ()), ("unmapped slice-size", (4, 512, 512),
                                    ())]
    if hasattr(dmod, "CounterMap"):
        # rank 3 of {dp 2, sp 2} (dp 1, sp 1), striped: rows 4-7, the
        # half-blocks 1 and 2 of 4
        B, T, D, n, idx = 8, 1024, 512, 2, 1
        t, th = T // n, T // (2 * n)
        cmap = dmod.CounterMap(base=B // 2 * T * D, row=t * D, stride=T * D,
                               seg=th * D, off0=idx * th * D,
                               off1=(2 * n - 1 - idx) * th * D - th * D)
        cases.append(("dp2 sp2 striped slice", (B // 2, t, D), (cmap,)))
    out = {}
    for label, shp, extra in cases:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(dev).manual_seed(5)
            x = torch.randn(shp, device=dev, generator=gen).to(dtype)
            want = dmod.dropout_reference(x, key, p, *extra)
            bound_ms, bound_by = cs._dropout_bound(x.numel(), dtype)
            for kern, fn in (("fwd", dmod.dropout_fwd_kernel),
                             ("bwd", dmod.dropout_bwd_kernel)):
                got = fn(x, key, p, *extra)
                ms, dev_ms = cs.both_ms(lambda i, fn=fn: fn(x, key, p,
                                                            *extra))
                out[f"{label} {kern} {str(dtype).replace('torch.', '')}"] = {
                    "shape": list(shp), "bitwise": bool(torch.equal(got,
                                                                    want)),
                    "ms": ms, "device_ms": dev_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}
    return {"dropout": out, "ptxas": [
        {"kernel": name, "registers": regs, "spill_bytes": spill}
        for name, regs, spill in cs._ptxas_report(
            _build.build_logs.get("dropout.cu", ""))]}


if __name__ == "__main__":
    sys.exit(main())
