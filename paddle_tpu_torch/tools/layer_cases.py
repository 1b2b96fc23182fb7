"""The layer cases of the ported layer surface: each of the 14 activations
of ``layers/ops.py`` that take attributes (and ``prelu``), the 21 names of
``layers/tensor.py`` and the 30 of ``layers/nn.py`` that the slice of
ROADMAP A.12 part 1 ported, the 16 layers of ``layers/misc.py``
(``MISC_CASES``) and the Variable operator sugar (``SUGAR_CASES``: a
scalar ``/`` and ``-``, ``[]`` out of range, negative, with ``None`` and
``Ellipsis``), as ``name -> (build(fl, vars), feeds)``, where
``fl`` is a package (``paddle_tpu_torch``, or the JAX package in the CPU
tests) and ``feeds`` numpy arrays made from fixed seeds.

``tests/test_torch_layer_surface.py`` runs every case in both packages on
the CPU; ``chip_smoke.py``'s layers phase runs it through :func:`run_case`
on the card and on the CPU, forward and gradient.  The random cases
(``RANDOM``) draw from the Executor's key of one (seed, step)."""
from __future__ import annotations

import numpy as np
import torch

# the (program seed, step counter) whose keys the random cases draw from
STEP_KEY = (3, 12)


def _r(*shape, seed=0, scale=1.0, low=None, high=None):
    rng = np.random.RandomState(seed)
    if low is not None:
        return rng.uniform(low, high, shape).astype(np.float32)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ids(*shape, hi, seed=0, lo=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int32)


X = {"x": _r(4, 6, seed=1, scale=3.0)}
POS = {"x": _r(4, 6, seed=2, low=0.5, high=2.0)}

# name -> (build(fl, vars), feeds); the layers of layers/ops.py
ACT_CASES = {
    "leaky_relu": (lambda fl, v: fl.layers.leaky_relu(v["x"]), X),
    "leaky_relu_alpha": (lambda fl, v: fl.layers.leaky_relu(v["x"],
                                                            alpha=0.3), X),
    "elu": (lambda fl, v: fl.layers.elu(v["x"], alpha=0.7), X),
    "relu6": (lambda fl, v: fl.layers.relu6(v["x"], threshold=2.0), X),
    "pow": (lambda fl, v: fl.layers.pow(v["x"], factor=2.5), POS),
    "pow_": (lambda fl, v: fl.layers.ops.pow_(v["x"]), POS),
    "stanh": (lambda fl, v: fl.layers.stanh(v["x"]), X),
    "brelu": (lambda fl, v: fl.layers.brelu(v["x"], t_min=-1.0,
                                            t_max=2.0), X),
    "soft_relu": (lambda fl, v: fl.layers.soft_relu(v["x"], threshold=2.0),
                  X),
    "softshrink": (lambda fl, v: fl.layers.softshrink(v["x"], lambda_=1.0),
                   X),
    "hard_shrink": (lambda fl, v: fl.layers.hard_shrink(v["x"]), X),
    "thresholded_relu": (lambda fl, v: fl.layers.thresholded_relu(v["x"]),
                         X),
    "hard_sigmoid": (lambda fl, v: fl.layers.hard_sigmoid(v["x"]), X),
    "swish": (lambda fl, v: fl.layers.swish(v["x"], beta=1.5), X),
    "prelu": (lambda fl, v: fl.layers.prelu(v["x"]), X),
}

IDX = np.array([0, 3, -1, 2, -4], np.int32)
TENSOR_CASES = {
    "clip": (lambda fl, v: fl.layers.clip(v["x"], -1.0, 2.0), X),
    "clip_by_norm": (lambda fl, v: fl.layers.clip_by_norm(v["x"], 2.0), X),
    "clip_by_norm_inside": (lambda fl, v: fl.layers.clip_by_norm(v["x"],
                                                                 100.0), X),
    "crop": (lambda fl, v: fl.layers.crop(v["x"], [2, 3], [1, 2]), X),
    "crop_clamped": (lambda fl, v: fl.layers.crop(v["x"], [3, 4], [3, 5]),
                     X),
    "cumsum": (lambda fl, v: fl.layers.cumsum(v["x"], axis=1), X),
    "expand": (lambda fl, v: fl.layers.expand(v["x"], [2, 3]), X),
    "gather": (lambda fl, v: fl.layers.gather(v["x"], v["i"]),
               {**X, "i": IDX}),
    "increment": (lambda fl, v: fl.layers.increment(v["x"], 2.5), X),
    "increment_out_of_place": (lambda fl, v: fl.layers.increment(
        v["x"], -1.0, in_place=False), X),
    "is_empty": (lambda fl, v: fl.layers.is_empty(v["x"]), X),
    "l1_norm": (lambda fl, v: fl.layers.l1_norm(v["x"]), X),
    "l2_distance": (lambda fl, v: fl.layers.l2_distance(v["x"], v["y"]),
                    {**X, "y": _r(4, 6, seed=3)}),
    "multiplex": (lambda fl, v: fl.layers.multiplex([v["a"], v["b"],
                                                     v["c"]], v["i"]),
                  {"a": _r(5, 3, seed=4), "b": _r(5, 3, seed=5),
                   "c": _r(5, 3, seed=6),
                   "i": np.array([[0], [2], [7], [-1], [-5]], np.int32)}),
    "one_hot": (lambda fl, v: fl.layers.one_hot(v["i"], 4),
                {"i": np.array([[0], [3], [4], [-1], [2]], np.int32)}),
    "ones": (lambda fl, v: [fl.layers.ones([2, 3]),
                            fl.layers.ones([4], "int32")], {}),
    "zeros": (lambda fl, v: [fl.layers.zeros([2, 3]),
                             fl.layers.zeros([4], "int32")], {}),
    "zeros_like": (lambda fl, v: fl.layers.elementwise_add(
        fl.layers.zeros_like(v["x"]), v["x"]), X),
    "pad": (lambda fl, v: fl.layers.pad(v["x"], [1, 0, 2, 3], 0.5), X),
    "scatter": (lambda fl, v: fl.layers.scatter(v["x"], v["i"], v["u"]),
                {**X, "i": np.array([1, 1, 9, -1, 1], np.int32),
                 "u": _r(5, 6, seed=7)}),
    "scatter_add": (lambda fl, v: fl.layers.scatter(
        v["x"], v["i"], v["u"], overwrite=False),
        {**X, "i": np.array([1, 1, 9, -1, 1], np.int32),
         "u": _r(5, 6, seed=7)}),
    "sign": (lambda fl, v: fl.layers.sign(v["x"]),
             {"x": np.array([[-2.0, 0.0, 3.0]], np.float32)}),
    "top_k": (lambda fl, v: fl.layers.top_k(v["x"], 3),
              {"x": np.array([[1.0, 3.0, 3.0, 2.0, 3.0],
                              [0.5, -1.0, 0.5, 0.5, 4.0]], np.float32)}),
    "top_k_random": (lambda fl, v: fl.layers.top_k(v["x"], 4), X),
    "gaussian_random": (lambda fl, v: [
        fl.layers.gaussian_random([4, 6], mean=0.5, std=2.0),
        fl.layers.gaussian_random([33])], {}),
    "uniform_random": (lambda fl, v: [
        fl.layers.uniform_random([4, 6], -2.0, 3.0),
        fl.layers.uniform_random([33])], {}),
}
# the cases whose layers draw from the step key
RANDOM = {"gaussian_random", "uniform_random", "sampling_id", "nce",
          "nce_many"}

PROBS = np.random.RandomState(8).dirichlet(np.ones(5), 6).astype(
    np.float32)
IMG = {"x": _r(2, 6, 3, 4, seed=9)}
NN_CASES = {
    "maxout": (lambda fl, v: fl.layers.maxout(v["x"], 3), IMG),
    "sampling_id": (lambda fl, v: fl.layers.sampling_id(v["p"]),
                    {"p": PROBS}),
    "sigmoid_cross_entropy_with_logits": (
        lambda fl, v: fl.layers.sigmoid_cross_entropy_with_logits(
            v["x"], v["y"]),
        {**X, "y": _r(4, 6, seed=10, low=0.0, high=1.0)}),
    "smooth_l1": (lambda fl, v: fl.layers.smooth_l1(v["x"], v["y"], 0.8),
                  {**X, "y": _r(4, 6, seed=11)}),
    "huber_loss": (lambda fl, v: fl.layers.huber_loss(v["x"], v["y"], 1.5),
                   {**X, "y": _r(4, 6, seed=11)}),
    "log_loss": (lambda fl, v: fl.layers.log_loss(v["p"], v["y"]),
                 {"p": _r(6, 1, seed=12, low=0.05, high=0.95),
                  "y": np.array([[0], [1], [1], [0], [1], [0]],
                                np.float32)}),
    "hinge_loss": (lambda fl, v: fl.layers.hinge_loss(v["x"], v["y"]),
                   {"x": _r(6, 1, seed=13),
                    "y": np.array([[0], [1], [1], [0], [1], [0]],
                                  np.float32)}),
    "rank_loss": (lambda fl, v: fl.layers.rank_loss(v["y"], v["l"], v["r"]),
                  {"y": np.array([[0], [1], [1], [0]], np.float32),
                   "l": _r(4, 1, seed=14), "r": _r(4, 1, seed=15)}),
    "margin_rank_loss": (lambda fl, v: fl.layers.margin_rank_loss(
        v["y"], v["l"], v["r"], 0.1),
        {"y": np.array([[-1], [1], [1], [-1]], np.float32),
         "l": _r(4, 1, seed=14), "r": _r(4, 1, seed=15)}),
    "cos_sim": (lambda fl, v: fl.layers.cos_sim(v["x"], v["y"]),
                {**X, "y": _r(4, 6, seed=16)}),
    "squared_l2_norm": (lambda fl, v: fl.layers.squared_l2_norm(v["x"]), X),
    "squared_l2_distance": (lambda fl, v: fl.layers.squared_l2_distance(
        v["x"], v["y"]), {**X, "y": _r(4, 6, seed=16)}),
    "modified_huber_loss": (lambda fl, v: fl.layers.modified_huber_loss(
        v["x"], v["y"]), {"x": _r(8, 1, seed=17, scale=2.0),
                          "y": _ids(8, 1, hi=2, seed=18)}),
    "auc_roc": (lambda fl, v: fl.layers.auc(v["p"], v["y"]),
                {"p": _r(64, 2, seed=19, low=0.0, high=1.0),
                 "y": _ids(64, 1, hi=2, seed=20)}),
    "auc_pr": (lambda fl, v: fl.layers.auc(v["p"], v["y"], "PR", 37),
               {"p": _r(64, 1, seed=19, low=0.0, high=1.0),
                "y": _ids(64, 1, hi=2, seed=20)}),
    "precision_recall": (lambda fl, v: fl.layers.precision_recall(
        v["p"], v["y"], 4), {"p": _r(16, 4, seed=21),
                             "y": _ids(16, 1, hi=3, seed=22)}),
    "positive_negative_pair": (lambda fl, v: fl.layers.positive_negative_pair(
        v["s"], v["y"], v["q"]),
        {"s": np.round(_r(12, 1, seed=23), 1),
         "y": _ids(12, 1, hi=3, seed=24).astype(np.float32),
         "q": _ids(12, 1, hi=3, seed=25)}),
    "bilinear_tensor_product": (lambda fl, v: fl.layers.bilinear_tensor_product(
        v["x"], v["y"], 3, act="tanh"), {**X, "y": _r(4, 5, seed=26)}),
    "conv_shift": (lambda fl, v: fl.layers.conv_shift(v["x"], v["y"]),
                   {**X, "y": _r(4, 3, seed=27)}),
    "conv_shift_wide": (lambda fl, v: fl.layers.conv_shift(v["x"], v["y"]),
                        {**X, "y": _r(4, 5, seed=28)}),
    "nce": (lambda fl, v: fl.layers.nce(v["x"], v["y"], 11, 4),
            {**X, "y": _ids(4, 1, hi=11, seed=29)}),
    "nce_many": (lambda fl, v: fl.layers.nce(v["x"], v["y"], 2074, 25),
                 {**X, "y": _ids(4, 1, hi=2074, seed=29)}),
    "hsigmoid": (lambda fl, v: fl.layers.hsigmoid(v["x"], v["y"], 7),
                 {**X, "y": np.array([[0], [6], [3], [5]], np.int32)}),
    "hsigmoid_pow2": (lambda fl, v: fl.layers.hsigmoid(v["x"], v["y"], 8),
                      {**X, "y": np.array([[0], [7], [4], [1]], np.int32)}),
    "scaling": (lambda fl, v: fl.layers.scaling(v["x"], v["w"]),
                {**X, "w": _r(4, 1, seed=30)}),
    "interpolation": (lambda fl, v: fl.layers.interpolation(v["x"], v["y"],
                                                            v["w"]),
                      {**X, "y": _r(4, 6, seed=31),
                       "w": _r(4, 1, seed=32, low=0.0, high=1.0)}),
    "power": (lambda fl, v: fl.layers.power(v["x"], v["w"]),
              {**POS, "w": _r(4, 1, seed=33, low=0.5, high=2.0)}),
    "slope_intercept": (lambda fl, v: fl.layers.slope_intercept(
        v["x"], 1.5, -0.25), X),
    "sum_to_one_norm": (lambda fl, v: fl.layers.sum_to_one_norm(v["x"]),
                        POS),
    "linear_comb": (lambda fl, v: fl.layers.linear_comb(v["x"], v["w"], 2),
                    {**X, "w": _r(4, 3, seed=34)}),
    "out_prod": (lambda fl, v: fl.layers.out_prod(v["x"], v["y"]),
                 {**X, "y": _r(4, 3, seed=35)}),
    "repeat": (lambda fl, v: fl.layers.repeat(v["x"], 3), X),
    "repeat_elements": (lambda fl, v: fl.layers.repeat(v["x"], 2, False),
                        X),
    "bilinear_interp_up": (lambda fl, v: fl.layers.bilinear_interp(
        v["x"], 7, 9), IMG),
    "bilinear_interp_down": (lambda fl, v: fl.layers.bilinear_interp(
        v["x"], 2, 3), {"x": _r(2, 3, 7, 9, seed=36)}),
    "bilinear_interp_mixed": (lambda fl, v: fl.layers.bilinear_interp(
        v["x"], 3, 8), {"x": _r(2, 3, 7, 5, seed=37)}),
    "selective_fc": (lambda fl, v: fl.layers.selective_fc(
        v["x"], v["s"], 5, act="sigmoid"),
        {**X, "s": _ids(4, 5, hi=2, seed=38)}),
    "selective_fc_no_bias": (lambda fl, v: fl.layers.selective_fc(
        v["x"], v["s"], 5, bias_attr=False),
        {**X, "s": _ids(4, 5, hi=2, seed=38)}),
}

SCORES = np.array([[0.1, 0.9, 0.5, 0.9, 0.7, 0.2],
                   [0.8, 0.2, 0.8, 0.3, 0.95, 0.95],
                   [0.4, 0.4, 0.4, 0.4, 0.4, 0.4],
                   [-1.0, 2.0, 0.0, 2.0, 1.0, 3.0]], np.float32)
BEAM = {"s": _r(4, 3, 5, seed=50),
        "g": np.array([[1, -1, 4], [0, 2, -1], [-1, -1, 3], [4, 0, 1]],
                      np.int32),
        "gs": _r(4, 3, seed=51),
        "m": np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]],
                      np.float32)}
# the 16 layers of layers/misc.py
MISC_CASES = {
    "cos_sim_vec_mat": (lambda fl, v: fl.layers.cos_sim_vec_mat(
        v["v"], v["m"], cos_scale=2.0),
        {"v": _r(3, 4, seed=40), "m": _r(3, 8, seed=41)}),
    "cross_channel_norm": (lambda fl, v: fl.layers.cross_channel_norm(
        v["x"]), IMG),
    "data_norm_z_score": (lambda fl, v: fl.layers.data_norm(
        v["x"], "z-score", mean=[0.5, -1.0, 2.0], std=[1.0, 3.0, 0.5]),
        {"x": _r(5, 3, seed=42, scale=2.0)}),
    "data_norm_min_max": (lambda fl, v: fl.layers.data_norm(
        v["x"], "min-max", min_val=[-3.0, -1.0, 0.0],
        max_val=[3.0, 2.0, 5.0]), {"x": _r(5, 3, seed=42, scale=2.0)}),
    "data_norm_decimal": (lambda fl, v: fl.layers.data_norm(
        v["x"], "decimal-scaling", max_val=[100.0, 37.0, 0.5]),
        {"x": _r(5, 3, seed=42, scale=20.0)}),
    "eos_check": (lambda fl, v: fl.layers.eos_check(v["i"], eos_id=1),
                  {"i": np.array([[1], [7], [1], [0]], np.int32)}),
    "factorization_machine": (lambda fl, v: fl.layers.factorization_machine(
        v["x"], 3), {"x": _r(4, 5, seed=43)}),
    "featuremap_expand": (lambda fl, v: fl.layers.featuremap_expand(
        v["x"], 3), X),
    "featuremap_expand_col": (lambda fl, v: fl.layers.featuremap_expand(
        v["x"], 2, as_row_vector=False), X),
    "kmax_seq_score": (lambda fl, v: fl.layers.kmax_seq_score(
        v["s"], v["n"], k=4),
        {"s": SCORES, "n": np.array([5, 6, 2, 3], np.int32)}),
    "kmax_seq_score_unmasked": (lambda fl, v: fl.layers.kmax_seq_score(
        v["s"], None, k=3), {"s": SCORES}),
    "outer_prod": (lambda fl, v: fl.layers.outer_prod(v["x"], v["y"]),
                   {**X, "y": _r(4, 3, seed=44)}),
    "Print": (lambda fl, v: fl.layers.Print(v["x"], message="x{0}}{",
                                            summarize=4), X),
    "rotate": (lambda fl, v: fl.layers.rotate(v["x"]), IMG),
    "l2_normalize": (lambda fl, v: fl.layers.l2_normalize(v["x"]), X),
    "l2_normalize_axis1": (lambda fl, v: fl.layers.l2_normalize(
        v["x"], axis=1, epsilon=1e-3), IMG),
    "scale_shift": (lambda fl, v: fl.layers.scale_shift(v["x"]), X),
    "scale_sub_region": (lambda fl, v: fl.layers.scale_sub_region(
        v["x"], v["i"], 2.5),
        {"x": _r(2, 3, 4, 5, seed=45),
         "i": np.array([[1, 2, 2, 4, 1, 3], [3, 3, 1, 1, 2, 5]], np.int32)}),
    "sequence_reshape": (lambda fl, v: fl.layers.sequence_reshape(v["x"], 8),
                         {"x": _r(2, 4, 6, seed=46)}),
    "dot_prod": (lambda fl, v: fl.layers.dot_prod(v["x"], v["y"]),
                 {**X, "y": _r(4, 6, seed=47)}),
    "cross_entropy_over_beam": (lambda fl, v: fl.layers.cross_entropy_over_beam(
        v["s"], v["g"], gold_score=v["gs"], step_mask=v["m"]), BEAM),
    "cross_entropy_over_beam_no_gold": (
        lambda fl, v: fl.layers.cross_entropy_over_beam(v["s"], v["g"]),
        {"s": BEAM["s"], "g": BEAM["g"]}),
}

# the Variable operator sugar; each operator appends the reference's layer
SUGAR_CASES = {
    "sugar_arith": (lambda fl, v: (v["x"] + v["y"]) * v["x"] - v["y"] / v["x"],
                    {**POS, "y": _r(4, 6, seed=48)}),
    "sugar_scalar": (lambda fl, v: [2.0 + v["x"], v["x"] * 3.0, v["x"] - 1.5,
                                    v["x"] / 4.0, 1.0 * v["x"]], X),
    "sugar_rdiv": (lambda fl, v: 7.0 / v["x"], POS),
    "sugar_rsub": (lambda fl, v: 3.0 - v["x"], X),
    "sugar_neg": (lambda fl, v: -v["x"], X),
    "sugar_matmul": (lambda fl, v: v["x"] @ fl.layers.transpose(
        v["y"], [1, 0]), {**X, "y": _r(4, 6, seed=49)}),
    "getitem_int": (lambda fl, v: [v["x"][:, 2], v["x"][:, -1],
                                   v["x"][1]], X),
    "getitem_out_of_range": (lambda fl, v: [v["x"][:, 10], v["x"][:, -10],
                                            v["x"][:, -7]], X),
    "getitem_slices": (lambda fl, v: [v["x"][:, -3:], v["x"][:, -10:2],
                                      v["x"][:, 4:100], v["x"][1:3, ::-2],
                                      v["x"][:, 5:1:-3]], X),
    "getitem_none_ellipsis": (lambda fl, v: [v["x"][None, 1],
                                             v["x"][..., 2],
                                             v["x"][:, None, ..., 3]], IMG),
    "getitem_array": (lambda fl, v: v["x"][:, np.array([0, 9, -1, -9, 2])],
                      X),
}

CASES = {**ACT_CASES, **TENSOR_CASES, **NN_CASES, **MISC_CASES,
         **SUGAR_CASES}


# the evaluators' program: Accuracy and PrecisionRecall over one score and
# label pair, ChunkEvaluator over IOB tags, CTCError over CTC logits
EV_C, EV_T, EV_N = 4, 8, 6


def evaluator_program(fl):
    """The four streaming evaluators of ``evaluator.py`` (``Accuracy`` at
    k = 2, ``PrecisionRecall``, ``ChunkEvaluator``, ``CTCError``) in new
    Programs of package ``fl``: (main, startup, evaluators, fetch), the
    fetch the accuracy's running rate."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        L = fl.layers
        p = L.data("p", [EV_C])
        lab = L.data("lab", [1], dtype="int32")
        tags = L.data("tags", [EV_T], dtype="int32")
        gold = L.data("gold", [EV_T], dtype="int32")
        ln = L.data("ln", [], dtype="int32")
        x = L.data("x", [EV_T, EV_C])
        xl = L.data("xl", [], dtype="int32")
        y = L.data("y", [5], dtype="int32")
        yl = L.data("yl", [], dtype="int32")
        evs = [fl.evaluator.Accuracy(p, lab, k=2),
               fl.evaluator.PrecisionRecall(p, lab, num_classes=EV_C),
               fl.evaluator.ChunkEvaluator(tags, gold, ln),
               fl.evaluator.CTCError(x, y, xl, yl, blank=0)]
    return main, startup, evs, [evs[0].metric]


def evaluator_batch(rng, n: int = EV_N) -> dict:
    """One batch for ``evaluator_program``: scores on a coarse grid (rows
    with ties), labels with some outside [0, C) (a zero one-hot row for
    PrecisionRecall; Accuracy never matches them), IOB tags, CTC logits
    and labels."""
    C, T = EV_C, EV_T
    return {"p": (rng.randint(0, 4, (n, C)) / 4.0).astype(np.float32),
            "lab": rng.randint(-1, C + 1, (n, 1)).astype(np.int32),
            "tags": rng.randint(-1, 6, (n, T)).astype(np.int32),
            "gold": rng.randint(-1, 6, (n, T)).astype(np.int32),
            "ln": rng.randint(1, T + 1, (n,)).astype(np.int32),
            "x": rng.randn(n, T, C).astype(np.float32),
            "xl": rng.randint(1, T + 1, (n,)).astype(np.int32),
            "y": rng.randint(1, C, (n, 5)).astype(np.int32),
            "yl": rng.randint(1, 6, (n,)).astype(np.int32)}


def _data_vars(fl, feeds):
    """A data variable per feed: the batch dim free, the rest declared (a
    1-D feed declared [-1] without a batch dim), int feeds int32."""
    vs = {}
    for name, arr in feeds.items():
        dtype = "int32" if arr.dtype.kind in "iu" else str(arr.dtype)
        vs[name] = fl.layers.data(name, list(arr.shape[1:]) or [-1],
                                  dtype=dtype,
                                  append_batch_size=arr.ndim > 1)
    return vs


def run_case(case: str, device, seed: int = 5, param_scale: float = 0.5):
    """The port's layer ``case`` built in fresh default programs and its
    ops run directly on ``device`` (a random case at ``STEP_KEY``), on its
    feeds and on parameters drawn N(0, param_scale^2) by name from
    ``seed``.  Returns (outputs, gradients, gradient names) as numpy: the
    gradients of the sum of every float output times a N(0, 1) cotangent
    (from the same seed) with respect to every float feed and parameter;
    zeros where no float input reaches the outputs."""
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.core.program import OpContext

    build, feeds = CASES[case]
    fl.reset_default_programs()
    outs = build(fl, _data_vars(fl, feeds))
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    prog = fl.default_main_program()
    rng = np.random.RandomState(seed)
    arrays = dict(feeds)
    for p in prog.parameters():
        arrays[p.name] = (param_scale * rng.standard_normal(
            tuple(p.shape))).astype(np.float32)
    diff = [n for n, a in arrays.items() if a.dtype.kind == "f"]
    env = {n: torch.from_numpy(np.array(a)).to(device)
           for n, a in arrays.items()}
    leaves = [env[n].requires_grad_(True) for n in diff]
    ctx = OpContext(STEP_KEY[0], STEP_KEY[1], device)
    for op in prog.list_ops():
        op.apply(env, ctx)
    vals = [env[o.name] for o in outs]
    total = None
    for v in vals:
        if v.dtype.is_floating_point:
            cot = torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
                np.float32)).to(device=device, dtype=v.dtype)
            term = (torch.nan_to_num(v) * cot).sum()
            total = term if total is None else total + term
    grads = [None] * len(leaves)
    if leaves and total is not None and total.requires_grad:
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return ([v.detach().cpu().numpy() for v in vals],
            [np.zeros(arrays[n].shape, np.float32) if g is None
             else g.cpu().numpy() for g, n in zip(grads, diff)], diff)
