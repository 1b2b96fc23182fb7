"""paddle_tpu_torch's ``nets`` against the JAX package's on the CPU, as
``tests/test_nets.py`` drives them (all but its two ``hsigmoid`` tests,
whose layer is not ported): each composite built in both packages on the
same numpy inputs, run from the JAX startup's weights, its outputs within
1e-5 of their max abs and the gradient of sum(out^2) with respect to every
parameter within 1e-4 of its max abs.  Besides: the flash path of
``scaled_dot_product_attention`` (JAX's Pallas kernels interpreted) and its
refusal on a card at head dim 8, ``img_separable_conv`` left on
``F.conv2d`` in a pruned program while a plain 3x3 conv beside it is
routed, ``img_conv_group`` with batch norm fused when pruned, ``split`` by
sections, and ``lrn`` against the reference and against
``F.local_response_norm``, which computes something else."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as jfluid
import paddle_tpu.nets  # noqa: F401  (jfluid.nets)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.executor import check_kernel_shapes
from paddle_tpu_torch.core.fusion import FUSED_OP_TYPE, route_inference

CPU = tfluid.CPUPlace()
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread while these tests run: the suite's workers
    share the host's cores, and torch's thread pool on many small ops
    under that contention runs tens of times slower than one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
    yield


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS", "interpret")


def _is_float(fl, v):
    if fl is tfluid:
        return v.dtype.is_floating_point
    return np.dtype(v.dtype).kind == "f"


def _data(fl, feeds):
    """A data variable per feed: the batch dim free; a 1-D feed (lengths)
    declared [-1] without a batch dim."""
    return {n: fl.layers.data(
        n, list(a.shape[1:]) or [-1],
        dtype="int32" if a.dtype.kind in "iu" else "float32",
        append_batch_size=a.ndim > 1) for n, a in feeds.items()}


def _both(build, feeds, grads=True):
    """``build(fl, vars) -> Variable or list`` in both packages' fresh
    default programs; with ``grads`` the loss sum(out^2) over the float
    outputs and its backward.  Runs the JAX startup, loads its state into
    the port's scope and runs one step of each on ``feeds``.  Returns
    (JAX's fetches, the port's, the fetch names): the outputs, then the
    loss and each parameter's gradient."""
    res, weights = {}, None
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
        outs = build(fl, _data(fl, feeds))
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        fetch, names = list(outs), [o.name for o in outs]
        main = fl.default_main_program()
        if grads:
            L = fl.layers
            loss = L.sums([L.reduce_sum(L.square(o)) for o in outs
                           if _is_float(fl, o)])
            fl.backward.append_backward(loss)
            gnames = [f"{p.name}@GRAD" for p in main.parameters()]
            fetch += [loss] + gnames
            names += ["loss"] + gnames
        if fl is jfluid:
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            weights = {n: np.asarray(v)
                       for n, v in jfluid.global_scope().items()}
        else:
            exe = tfluid.Executor(CPU)
            exe.run(tfluid.default_startup_program())
            tfluid.load_scope(weights, main, tfluid.global_scope(),
                              device="cpu")
        res[fl] = [np.asarray(a) for a in exe.run(feed=feeds,
                                                  fetch_list=fetch)]
    return res[jfluid], res[tfluid], names


# a gradient whose max abs is below this share of the step's largest is
# float32 rounding noise around an exact zero (a conv bias before a batch
# norm, which the normalisation cancels): it is held within GRAD_TOL of the
# largest, as chip_smoke.py's SEQ2SEQ_NOISE_SHARE holds such a gradient
NOISE_SHARE = 1e-6


def _assert_close(want, got, names, n_out):
    """Outputs within FWD_TOL of max(1, max |.|), integers bitwise, the
    loss within rtol FWD_TOL, each gradient within GRAD_TOL of its max abs
    (or of the largest one's, below NOISE_SHARE of it)."""
    assert len(got) == len(want)
    top = max([float(np.abs(b).max(initial=0.0)) for b in want[n_out + 1:]],
              default=0.0)
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if b.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        scale = max(float(np.abs(b).max(initial=0.0)), 1e-30)
        tol = GRAD_TOL if i > n_out else FWD_TOL
        if i < n_out:
            scale = max(scale, 1.0)
        elif i > n_out and scale < NOISE_SHARE * top:
            scale = top
        assert np.abs(a - b).max(initial=0.0) <= tol * scale, (name,)


def _check(build, feeds, grads=True):
    want, got, names = _both(build, feeds, grads)
    n_out = len(names) - (len([n for n in names if n.endswith("@GRAD")]) + 1
                          if grads else 0)
    _assert_close(want, got, names, n_out)
    return got


# ------------------------------------------------------------ the mirrors


def test_simple_img_conv_pool_and_group():
    """``simple_img_conv_pool`` (conv pad 0: 16 -> 14, pool / 2 -> 7) and
    ``img_conv_group`` with batch norm (the convs padded: 16 -> 16, pool /
    2 -> 8), values and gradients against JAX's."""
    rng = np.random.RandomState(2)
    feeds = {"img": rng.rand(2, 3, 16, 16).astype("float32")}

    def build(fl, v):
        a = fl.nets.simple_img_conv_pool(v["img"], num_filters=4,
                                         filter_size=3, pool_size=2,
                                         pool_stride=2, act="relu")
        b = fl.nets.img_conv_group(v["img"], conv_num_filter=[4, 4],
                                   pool_size=2, pool_stride=2,
                                   conv_act="relu", conv_with_batchnorm=True)
        return [a, b]

    ra, rb = _check(build, feeds)[:2]
    assert ra.shape == (2, 4, 7, 7)
    assert rb.shape == (2, 4, 8, 8)


def test_sequence_conv_pool():
    rng = np.random.RandomState(3)
    feeds = {"x": rng.rand(3, 7, 5).astype("float32"),
             "len": np.array([7, 4, 2], "int32")}
    r = _check(lambda fl, v: fl.nets.sequence_conv_pool(
        v["x"], v["len"], num_filters=6, filter_size=3), feeds)[0]
    assert r.shape == (3, 6)


def test_glu():
    """glu on [3, 8] against its closed form a * sigmoid(b) and JAX's;
    and behind an fc, its gradients against JAX's."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 8).astype("float32")
    r = _check(lambda fl, v: fl.nets.glu(v["x"]), {"x": x}, grads=False)[0]
    a, b = x[:, :4], x[:, 4:]
    np.testing.assert_allclose(r, a / (1 + np.exp(-b)), rtol=1e-5)
    _check(lambda fl, v: fl.nets.glu(fl.layers.fc(v["x"], 6), dim=1),
           {"x": x})


def test_simple_attention_masks_padding():
    rng = np.random.RandomState(5)
    B, T, H, D = 3, 6, 8, 4
    feeds = {"enc": rng.randn(B, T, H).astype("float32"),
             "len": np.array([6, 3, 1], "int32"),
             "st": rng.randn(B, D).astype("float32")}
    r = _check(lambda fl, v: fl.nets.simple_attention(v["enc"], v["len"],
                                                      v["st"]), feeds)[0]
    assert r.shape == (B, H)
    # a length-1 sequence attends only to its first step
    np.testing.assert_allclose(r[2], feeds["enc"][2, 0], rtol=1e-4,
                               atol=1e-5)


def _sdpa_numpy(q, k, v, heads):
    hd, hv = q.shape[-1] // heads, v.shape[-1] // heads
    out = np.empty(q.shape[:2] + (v.shape[-1],), np.float32)
    for b in range(q.shape[0]):
        for h in range(heads):
            s = (q[b, :, h * hd:(h + 1) * hd] @ k[b, :, h * hd:(h + 1) * hd].T
                 / np.sqrt(hd))
            w = np.exp(s - s.max(-1, keepdims=True))
            w /= w.sum(-1, keepdims=True)
            out[b, :, h * hv:(h + 1) * hv] = w @ v[b, :, h * hv:(h + 1) * hv]
    return out


def test_scaled_dot_product_attention_matches_numpy(interpret_mode):
    """The reference test's case (B 2, T 8, D 16, 2 heads: head dim 8):
    values against numpy and JAX's (its Pallas kernel interpreted); the
    program runs on the CPU, and on a card ``check_kernel_shapes`` refuses
    it before its first op, since the flash kernels take head dims 16, 32,
    64 and 128.  Behind q/k/v projections, the gradients against JAX's."""
    rng = np.random.RandomState(6)
    B, T, D, heads = 2, 8, 16, 2
    feeds = {n: rng.randn(B, T, D).astype("float32") for n in "qkv"}

    def build(fl, v):
        return fl.nets.scaled_dot_product_attention(v["q"], v["k"], v["v"],
                                                    num_heads=heads)

    r = _check(build, feeds, grads=False)[0]
    np.testing.assert_allclose(r, _sdpa_numpy(feeds["q"], feeds["k"],
                                              feeds["v"], heads),
                               rtol=1e-5, atol=1e-5)
    program = tfluid.default_main_program()
    (op,) = [o for o in program.list_ops()
             if o.type == "scaled_dot_product_attention"]
    assert op.attrs == {"num_heads": heads}
    check_kernel_shapes(program, torch.device("cpu"))
    with pytest.raises(ValueError, match="head dims"):
        check_kernel_shapes(program, torch.device("cuda"))

    def projected(fl, v):
        L = fl.layers
        q, k, vv = (L.fc(v[n], D, num_flatten_dims=2) for n in "qkv")
        return fl.nets.scaled_dot_product_attention(q, k, vv,
                                                    num_heads=heads)

    _check(projected, feeds)


def test_scaled_dot_product_attention_flash_head_dim(interpret_mode):
    """Head dim 16, Tq != Tk: the flash path, values and gradients against
    JAX's; accepted for a card by ``check_kernel_shapes``, and refused in
    float16, which the kernels do not take."""
    rng = np.random.RandomState(7)
    feeds = {"q": rng.randn(2, 5, 32).astype("float32"),
             "kv": rng.randn(2, 9, 32).astype("float32")}

    def build(fl, v):
        L = fl.layers
        q = L.fc(v["q"], 32, num_flatten_dims=2)
        k = L.fc(v["kv"], 32, num_flatten_dims=2)
        vv = L.fc(v["kv"], 32, num_flatten_dims=2)
        return fl.nets.scaled_dot_product_attention(q, k, vv, num_heads=2)

    _check(build, feeds)
    program = tfluid.default_main_program()
    check_kernel_shapes(program, torch.device("cuda"))
    tfluid.amp.enable(program, tfluid.amp.Bf16Policy(
        extra_bf16=("scaled_dot_product_attention",)))
    check_kernel_shapes(program, torch.device("cuda"))

    tfluid.reset_default_programs()
    q = tfluid.layers.data("q", [5, 32], dtype="float16")
    kv = tfluid.layers.data("kv", [9, 32], dtype="float16")
    tfluid.nets.scaled_dot_product_attention(q, kv, kv, num_heads=2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        check_kernel_shapes(tfluid.default_main_program(),
                            torch.device("cuda"))


def test_simple_and_bidirectional_recurrent_helpers():
    """simple_lstm, simple_gru, bidirectional_lstm and bidirectional_gru
    on lengths 7, 4, 2: values and gradients against JAX's."""
    B, T, D, H = 3, 7, 5, 6
    rng = np.random.RandomState(0)
    feeds = {"x": rng.randn(B, T, D).astype("float32"),
             "ln": np.array([7, 4, 2], "int32")}

    def build(fl, v):
        h_l, _ = fl.nets.simple_lstm(v["x"], v["ln"], H)
        h_g = fl.nets.simple_gru(v["x"], v["ln"], H)
        h_bl = fl.nets.bidirectional_lstm(v["x"], v["ln"], H)
        h_bg = fl.nets.bidirectional_gru(v["x"], v["ln"], H)
        return [h_l, h_g, h_bl, h_bg]

    o1, o2, o3, o4 = _check(build, feeds)[:4]
    assert o1.shape == (B, T, H) and o2.shape == (B, T, H)
    assert o3.shape == (B, T, 2 * H) and o4.shape == (B, T, 2 * H)
    program = tfluid.default_main_program()
    assert [o.type for o in program.list_ops()].count("dynamic_lstm") == 3
    assert [o.type for o in program.list_ops()].count("dynamic_gru") == 3

    def pair(fl, v):
        return list(fl.nets.bidirectional_gru(v["x"], v["ln"], H,
                                              return_concat=False))
    _check(pair, feeds)


def test_img_conv_helpers_and_separable():
    """img_conv_bn_pool and img_separable_conv (depthwise, groups = 4,
    then a 1x1): values and gradients against JAX's."""
    rng = np.random.RandomState(1)
    feeds = {"img": rng.randn(2, 4, 12, 12).astype("float32")}

    def build(fl, v):
        a = fl.nets.img_conv_bn_pool(v["img"], num_filters=8, filter_size=3,
                                     pool_size=2, pool_stride=2, act="relu")
        b = fl.nets.img_separable_conv(v["img"], num_channels=4,
                                       num_out_channels=10, filter_size=3,
                                       padding=1, act="relu")
        return [a, b]

    oa, ob = _check(build, feeds)[:2]
    assert oa.shape[1] == 8 and ob.shape == (2, 10, 12, 12)


def test_dot_product_attention_masks_and_normalizes():
    rng = np.random.RandomState(2)
    feeds = {"enc": rng.randn(2, 5, 4).astype("float32"),
             "ln": np.array([5, 2], "int32"),
             "st": rng.randn(2, 4).astype("float32")}

    def build(fl, v):
        st = fl.layers.fc(v["st"], 4)
        return list(fl.nets.dot_product_attention(v["enc"], v["ln"], st))

    c, w = _check(build, feeds)[:2]
    np.testing.assert_allclose(w.sum(axis=1), 1.0, rtol=1e-5)
    assert np.all(w[1, 2:] < 1e-6)
    np.testing.assert_allclose(c, np.einsum("bt,btd->bd", w, feeds["enc"]),
                               rtol=1e-5, atol=1e-6)


def test_multi_head_attention_helper():
    """Key projections 16 wide, value projections 32 (head widths 4 and
    8): the reference's einsum path, values and gradients against JAX's;
    a program ``check_kernel_shapes`` accepts for a card, since it runs no
    flash kernel."""
    rng = np.random.RandomState(0)
    feeds = {"q": rng.randn(2, 6, 10).astype("float32"),
             "kv": rng.randn(2, 9, 14).astype("float32")}
    o = _check(lambda fl, v: fl.nets.multi_head_attention(
        v["q"], v["kv"], v["kv"], key_proj_size=16, value_proj_size=32,
        head_num=4, out_size=12), feeds)[0]
    assert o.shape == (2, 6, 12)
    check_kernel_shapes(tfluid.default_main_program(), torch.device("cuda"))


# ------------------------------------------------------------ routing


def _prune_both(build, feeds):
    """``build`` in both packages, pruned to its output; the port's routed
    program on the CPU against JAX's pruned one from the JAX startup's
    state.  Returns the port's pruned program and output name."""
    got = {}
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        fl.reset_global_scope()
        out = build(fl, _data(fl, feeds))
        pruned = fl.default_main_program().prune([out])
        if fl is jfluid:
            exe = jfluid.Executor()
            exe.run(jfluid.default_startup_program())
            weights = {n: np.asarray(v)
                       for n, v in jfluid.global_scope().items()}
        else:
            exe = tfluid.Executor(CPU)
            exe.run(tfluid.default_startup_program())
            tfluid.load_scope(weights, pruned, tfluid.global_scope(),
                              device="cpu")
        got[fl] = np.asarray(exe.run(pruned, feed=feeds,
                                     fetch_list=[out])[0])
    want = got[jfluid]
    np.testing.assert_allclose(got[tfluid], want, rtol=0,
                               atol=FWD_TOL * max(1.0, np.abs(want).max()))
    return pruned, out.name


def test_img_separable_conv_stays_unrouted():
    """The depthwise 3x3 conv of ``img_separable_conv`` (stride 1, padding
    1, groups 4) keeps its ``F.conv2d`` in a pruned program; a plain 3x3
    conv after it is routed onto the conv kernel; values against JAX's."""
    rng = np.random.RandomState(8)
    feeds = {"img": rng.randn(2, 4, 10, 10).astype("float32")}

    def build(fl, v):
        h = fl.nets.img_separable_conv(v["img"], num_channels=4,
                                       num_out_channels=8, filter_size=3,
                                       padding=1, act="relu")
        return fl.layers.conv2d(h, 6, 3, padding=1)

    program, out = _prune_both(build, feeds)
    ops = program.list_ops()
    routed = route_inference(program, [out])
    convs = [(a, b) for a, b in zip(ops, routed) if a.type == "conv2d"]
    assert [a.attrs["groups"] for a, _ in convs] == [4, 1, 1]
    # the depthwise and the 1x1 keep their op; the 3x3 plain conv is new
    assert [b is a for a, b in convs] == [True, True, False]

    tfluid.reset_default_programs()
    img = tfluid.layers.data("img", [4, 10, 10])
    sep = tfluid.nets.img_separable_conv(img, num_channels=4,
                                         num_out_channels=8, filter_size=3,
                                         padding=1)
    assert route_inference(tfluid.default_main_program().prune([sep]),
                           [sep.name]) is None


def test_img_conv_group_with_batch_norm_fuses_when_pruned():
    """``img_conv_group(conv_with_batchnorm=True, conv_act="relu")``
    pruned: each conv -> batch_norm(is_test) -> relu chain becomes one
    ``conv2d_bn_relu`` op; values against JAX's pruned program."""
    rng = np.random.RandomState(9)
    feeds = {"img": rng.rand(2, 3, 12, 12).astype("float32")}

    def build(fl, v):
        return fl.nets.img_conv_group(v["img"], conv_num_filter=[8, 8],
                                      pool_size=2, pool_stride=2,
                                      conv_act="relu",
                                      conv_with_batchnorm=True)

    program, out = _prune_both(build, feeds)
    types = [o.type for o in route_inference(program, [out])]
    assert types.count(FUSED_OP_TYPE) == 2
    assert "batch_norm" not in types and "conv2d" not in types


# ------------------------------------------------------------ layers


def test_split_by_sections_matches_jax():
    """split into sizes [1, 3, 2] along dim 1 and into 2 equal parts along
    dim 2 (a list always), values and gradients against JAX's."""
    rng = np.random.RandomState(10)
    feeds = {"x": rng.randn(3, 6, 4).astype("float32")}

    def build(fl, v):
        h = fl.layers.fc(v["x"], 4, num_flatten_dims=2)
        parts = fl.layers.split(h, [1, 3, 2], dim=1)
        halves = fl.layers.split(h, 2, dim=2)
        assert isinstance(halves, list) and len(halves) == 2
        return parts + halves

    got = _check(build, feeds)
    assert [g.shape for g in got[:5]] == [(3, 1, 4), (3, 3, 4), (3, 2, 4),
                                          (3, 6, 2), (3, 6, 2)]


def test_lrn_matches_the_reference_not_local_response_norm():
    """lrn (n 5, k 1, alpha 1e-4, beta 0.75) against JAX's and a numpy
    transcription of the reference, values and gradients; a bfloat16 input
    (amp leaves lrn's input as it comes) is computed in float32 and
    rounded once to bfloat16.
    ``F.local_response_norm`` divides alpha by n (an average over the
    window), so it gives another result: here it differs by more than
    1e-4 of the output."""
    rng = np.random.RandomState(11)
    x = (rng.randn(2, 7, 3, 3) * 20).astype("float32")
    feeds = {"x": x}
    out = _check(lambda fl, v: fl.layers.lrn(v["x"], n=5), feeds,
                 grads=False)[0]
    _check(lambda fl, v: fl.layers.lrn(fl.layers.conv2d(v["x"], 7, 1), n=5),
           feeds)
    sq = np.pad(x.astype(np.float64) ** 2, ((0, 0), (2, 2), (0, 0), (0, 0)))
    acc = sum(sq[:, i:i + 7] for i in range(5))
    want = x / (1.0 + 1e-4 * acc) ** 0.75
    np.testing.assert_allclose(out, want, rtol=1e-5)
    other = F.local_response_norm(torch.from_numpy(x), 5, alpha=1e-4,
                                  beta=0.75, k=1.0).numpy()
    assert np.abs(other - out).max() > 1e-4 * np.abs(out).max()

    tfluid.reset_default_programs()
    tfluid.layers.lrn(tfluid.layers.data("x", [7, 3, 3]), n=5)
    (op,) = tfluid.default_main_program().list_ops()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    r = op.fn({"X": [xb]}, op.attrs, None)["Out"][0]
    r32 = op.fn({"X": [xb.float()]}, op.attrs, None)["Out"][0]
    assert r.dtype == torch.bfloat16
    assert torch.equal(r, r32.to(torch.bfloat16))


@pytest.mark.parametrize("case", ["fused", "fetch_bias_add", "shared_bias_add",
                                  "amp", "amp_split"])
def test_conv_bias_folds_into_the_fused_chain(case):
    """conv2d (with its bias add) -> batch_norm(is_test) -> relu, as
    ``img_conv_group`` builds it: one ``conv2d_bn_relu`` op, the bias
    folded into the batch norm's shift (its value checked against the
    three ops on the CPU); a fetched or shared bias-add output keeps the
    chain unfused (the conv alone on the plain kernel); under amp the bias
    stays float32 like the statistics, and a policy that runs the bias add
    in float32 while the conv runs in bfloat16 keeps the chain unfused."""
    x = tfluid.layers.data("x", [4, 6, 6])
    c = tfluid.layers.conv2d(x, 4, 3, padding=1)
    y = tfluid.layers.batch_norm(c, act="relu")
    if case == "shared_bias_add":
        y = tfluid.layers.elementwise_add(c, y)
    program = tfluid.default_main_program().clone(for_test=True)
    ops = program.list_ops()
    assert [o.type for o in ops[:4]] == ["conv2d", "elementwise_add",
                                         "batch_norm", "relu"]
    r = ops[3].outputs["Out"][0]
    fetch = [c.name, r] if case == "fetch_bias_add" else [r]
    amp = {"amp": tfluid.amp.Bf16Policy(),
           "amp_split": tfluid.amp.Bf16Policy(
               extra_f32=["elementwise_add"])}.get(case)
    routed = route_inference(program, fetch, amp)
    if case in ("fused", "amp"):
        assert [o.type for o in routed] == [FUSED_OP_TYPE]
        if case == "amp":
            assert routed[0].amp_types["ConvBias"] == "batch_norm"
            return
        rng = np.random.RandomState(12)
        exe = tfluid.Executor(CPU)
        exe.run(tfluid.default_startup_program())
        scope = tfluid.global_scope()
        for v in program.persistable_vars():
            shape = tuple(v.shape)
            val = (rng.uniform(0.5, 1.5, shape) if v.name.endswith("w_var")
                   else rng.standard_normal(shape) * 0.5)
            scope.set_var(v.name, torch.from_numpy(val.astype(np.float32)))
        xs = torch.from_numpy(rng.standard_normal((2, 4, 6, 6)).astype(
            np.float32))
        got = exe.run(program, feed={"x": xs}, fetch_list=[r])[0]
        env = {n: scope.find_var(n) for n in scope.var_names()}
        env["x"] = xs
        from paddle_tpu_torch.core.program import OpContext
        for op in ops:
            op.apply(env, OpContext(device="cpu"))
        want = env[r].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        types = [o.type for o in routed]
        assert types[:4] == ["conv2d", "elementwise_add", "batch_norm",
                             "relu"]
        assert routed[0].fn.__name__ == "_igemm_fn"
