"""Cases of the parallel layer that a gang of ranks runs: the CPU tests
(``tests/test_torch_parallel.py``, ``test_torch_ring_ulysses.py``,
``test_torch_strategy.py``) spawn one gang per file that runs all of a
file's cases (``run_cases``) and hold rank 0's results against the JAX
package; ``chip_smoke.py``'s parallel phase runs its legs here too.

The program builders take the package as an argument (``fl``, and its
``parallel`` as ``par``): the JAX package and the port share the API, so
one builder makes the same program in both.  Nothing here imports either
package's JAX side.
"""
from __future__ import annotations

import numpy as np
import torch

# ------------------------------------------------------------ builders


def build_mlp(fl, par):
    x = fl.layers.data("x", [8])
    y = fl.layers.data("y", [1], dtype="int32")
    h = fl.layers.fc(x, 16, act="relu", param_attr=fl.ParamAttr(name="w1"),
                     bias_attr=fl.ParamAttr(name="b1"))
    logits = fl.layers.fc(h, 4, param_attr=fl.ParamAttr(name="w2"),
                          bias_attr=fl.ParamAttr(name="b2"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss


def build_megatron(fl, par, clip=None):
    """column-parallel fc -> row-parallel fc -> fc, Adam (the reference's
    tests/test_parallel.py Megatron block)."""
    x = fl.layers.data("x", [12])
    y = fl.layers.data("y", [1], dtype="int32")
    h = par.tp.column_parallel_fc(x, 32, act="relu",
                                  param_attr=fl.ParamAttr(name="col.w"),
                                  bias_attr=fl.ParamAttr(name="col.b"))
    h2 = par.tp.row_parallel_fc(h, 12, param_attr=fl.ParamAttr(name="row.w"),
                                bias_attr=fl.ParamAttr(name="row.b"))
    logits = fl.layers.fc(h2, 4, param_attr=fl.ParamAttr(name="out.w"),
                          bias_attr=fl.ParamAttr(name="out.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    grad_clip = None if clip is None else \
        fl.clip.GradientClipByGlobalNorm(clip)
    fl.optimizer.Adam(1e-2, grad_clip=grad_clip).minimize(loss)
    return loss


def build_megatron_clip(fl, par):
    return build_megatron(fl, par, clip=0.05)


def build_vocab(fl, par):
    ids = fl.layers.data("ids", [1], dtype="int32")
    y = fl.layers.data("y", [1], dtype="int32")
    emb = par.tp.vocab_parallel_embedding(
        ids, [64, 16], param_attr=fl.ParamAttr(name="table"))
    logits = fl.layers.fc(emb, 4, param_attr=fl.ParamAttr(name="head.w"),
                          bias_attr=fl.ParamAttr(name="head.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    fl.optimizer.SGD(0.5).minimize(loss)
    return loss


def build_zero1(fl, par):
    x = fl.layers.data("x", [8])
    lab = fl.layers.data("lab", [1], dtype="int32")
    h = fl.layers.fc(x, 16, act="relu", param_attr=fl.ParamAttr(name="z1.w"),
                     bias_attr=fl.ParamAttr(name="z1.b"))
    logits = fl.layers.fc(h, 4, param_attr=fl.ParamAttr(name="z2.w"),
                          bias_attr=fl.ParamAttr(name="z2.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.Adam(1e-2, name="adam_z").minimize(loss)
    return loss


def build_zero1_packed(fl, par):
    """w [7, 5] and bias [5]: no axis divides by dp = 4 (packed)."""
    x = fl.layers.data("x", [7])
    lab = fl.layers.data("lab", [1], dtype="int32")
    logits = fl.layers.fc(x, 5, param_attr=fl.ParamAttr(name="zp.w"),
                          bias_attr=fl.ParamAttr(name="zp.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.Adam(1e-2, name="adam_p").minimize(loss)
    return loss


def build_accum(fl, par, accumulate=2):
    x = fl.layers.data("x", [8])
    lab = fl.layers.data("lab", [1], dtype="int32")
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        fl.layers.fc(x, 4, param_attr=fl.ParamAttr(name="za.w"),
                     bias_attr=fl.ParamAttr(name="za.b")), lab))
    fl.optimizer.Adam(1e-2, accumulate_steps=accumulate,
                      name="adam_a").minimize(loss)
    return loss


def build_accum_1(fl, par):
    return build_accum(fl, par, 1)


def build_dropout(fl, par):
    """x [N, 16, 32] -> dropout 0.5 -> fc -> mean: the mask of a
    batch-major activation (fetched as ``drop``)."""
    x = fl.layers.data("x", [16, 32])
    d = fl.layers.dropout(x, 0.5, name="drop")
    out = fl.layers.fc(d, 8, num_flatten_dims=2,
                       param_attr=fl.ParamAttr(name="dw"),
                       bias_attr=fl.ParamAttr(name="db"))
    loss = fl.layers.mean(out)
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, d


def build_mlp_sum(fl, par, momentum=False):
    """fc-relu-fc with a ``reduce_sum`` loss over the batch (ROADMAP
    C.13); SGD(0.1), or Momentum(0.1, 0.9) with ``momentum``."""
    x = fl.layers.data("x", [8])
    y = fl.layers.data("y", [1], dtype="int32")
    h = fl.layers.fc(x, 16, act="relu", param_attr=fl.ParamAttr(name="w1"),
                     bias_attr=fl.ParamAttr(name="b1"))
    logits = fl.layers.fc(h, 4, param_attr=fl.ParamAttr(name="w2"),
                          bias_attr=fl.ParamAttr(name="b2"))
    loss = fl.layers.reduce_sum(
        fl.layers.softmax_with_cross_entropy(logits, y))
    opt = (fl.optimizer.Momentum(0.1, momentum=0.9) if momentum
           else fl.optimizer.SGD(0.1))
    opt.minimize(loss)
    return loss


def build_mlp_bn(fl, par):
    """fc -> batch_norm -> relu -> fc, a mean loss: the training statistics
    over the global batch (ROADMAP C.13)."""
    x = fl.layers.data("x", [8])
    y = fl.layers.data("y", [1], dtype="int32")
    # no bias before the normalisation (its gradient is zero)
    h = fl.layers.fc(x, 16, param_attr=fl.ParamAttr(name="w1"),
                     bias_attr=False)
    h = fl.layers.batch_norm(h, act="relu",
                             param_attr=fl.ParamAttr(name="bn.s"),
                             bias_attr=fl.ParamAttr(name="bn.b"),
                             moving_mean_name="bn.m",
                             moving_variance_name="bn.v")
    logits = fl.layers.fc(h, 4, param_attr=fl.ParamAttr(name="w2"),
                          bias_attr=fl.ParamAttr(name="b2"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss


def build_reduce_ops(fl, par):
    """h = x @ rw (no bias); the loss adds reduce_max and reduce_min over
    the batch, reduce_mean over (batch, features) and the mean of a
    reduce_sum over the features (local): (loss, max, min, mean)."""
    x = fl.layers.data("x", [4])
    h = fl.layers.fc(x, 3, param_attr=fl.ParamAttr(name="rw"),
                     bias_attr=False)
    mx = fl.layers.reduce_max(h, dim=0)
    mn = fl.layers.reduce_min(h, dim=0, keep_dim=True)
    me = fl.layers.reduce_mean(h, dim=[0, 1])
    rs = fl.layers.reduce_sum(h, dim=1)
    loss = fl.layers.sums([fl.layers.reduce_sum(mx),
                           fl.layers.scale(fl.layers.reduce_sum(mn), 0.5),
                           me, fl.layers.mean(rs)])
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, mx, mn, me


def build_carry_grads(fl, par):
    """h = fc(x [N, 6], 4); the loss adds the mean of ``cumsum`` over the
    batch, 0.01 x the sum of ``matmul(h, h, transpose_x=True)`` and the
    mean of ``sum_to_one_norm`` of a [None] vector times that vector,
    SGD(0.1): (loss, cumsum, matmul), every op but fc and the means one
    that mixes batch rows."""
    L = fl.layers
    x = L.data("x", [6])
    h = L.fc(x, 4, act="sigmoid", param_attr=fl.ParamAttr(name="cg.w"),
             bias_attr=fl.ParamAttr(name="cg.b"))
    c = L.cumsum(h, axis=0)
    m = L.matmul(h, h, transpose_x=True)
    v = L.reduce_sum(h, dim=1)
    s = L.sum_to_one_norm(v)
    loss = L.sums([L.mean(c), L.scale(L.reduce_sum(m), 0.01),
                   L.mean(L.elementwise_mul(s, v))])
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, c, m


def build_moe(fl, par, capacity_factor=1.0, jitter=0.0):
    """fc-relu -> switch_moe (4 experts) -> fc, the cross entropy plus the
    aux loss, Adam: the reference's ``test_switch_moe_layer_trains_on_mesh``
    at a capacity that drops tokens."""
    x = fl.layers.data("x", [8])
    lab = fl.layers.data("lab", [1], dtype="int32")
    h = fl.layers.fc(x, 16, act="relu", param_attr=fl.ParamAttr(name="m.w"),
                     bias_attr=fl.ParamAttr(name="m.b"))
    y, aux = par.switch_moe(h, num_experts=4, d_ff=32,
                            capacity_factor=capacity_factor, jitter=jitter)
    logits = fl.layers.fc(y, 4, param_attr=fl.ParamAttr(name="o.w"),
                          bias_attr=fl.ParamAttr(name="o.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab)) \
        + aux
    fl.optimizer.Adam(1e-2).minimize(loss)
    return loss, aux


def build_moe_jitter(fl, par):
    return build_moe(fl, par, capacity_factor=1.25, jitter=0.1)


def _seq_data(fl, par, name, shape, dtype="float32"):
    """A batch-major feed whose sequence (dim 1) the port shards over
    ``sp`` (a ``SeqAxis``, as ``build_lm(use_sp=True)`` marks its feeds);
    the JAX package's feeds carry no such mark."""
    v = fl.layers.data(name, shape, dtype=dtype)
    if hasattr(par, "SeqAxis"):
        v.sharding = par.P(None, par.SeqAxis("sp"))
    return v


def build_moe_seq(fl, par, T=8, d=8, hidden=16, experts=4, d_ff=32,
                  cf=1.0, classes=4):
    """fc-relu -> switch_moe (4 experts, capacity 1.0: tokens dropped) ->
    fc over x [N, T, d] whose sequence the port shards over sp: the cross
    entropy per position plus the aux loss, Adam."""
    x = _seq_data(fl, par, "x", [T, d])
    lab = _seq_data(fl, par, "lab", [T, 1], "int32")
    h = fl.layers.fc(x, hidden, num_flatten_dims=2, act="relu",
                     param_attr=fl.ParamAttr(name="m.w"),
                     bias_attr=fl.ParamAttr(name="m.b"))
    y, aux = par.switch_moe(h, num_experts=experts, d_ff=d_ff,
                            capacity_factor=cf)
    logits = fl.layers.fc(y, classes, num_flatten_dims=2,
                          param_attr=fl.ParamAttr(name="o.w"),
                          bias_attr=fl.ParamAttr(name="o.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab)) \
        + aux
    fl.optimizer.Adam(1e-2).minimize(loss)
    return loss, aux


def build_tp_extras(fl, par, T=8, d=12, d_ff=16, vocab=8, p=0.25):
    """x [N, T, d] (its sequence sharded over sp in the port) -> a
    column-parallel fc to ``d_ff`` -> dropout ``p`` on the
    tensor-parallel shard -> a row-parallel fc -> column-parallel logits
    over ``vocab`` classes -> the soft-label cross entropy with
    ``return_softmax`` (vocab-parallel under tp), SGD(0.1): (loss, the
    dropout's output, the softmax)."""
    L = fl.layers
    x = _seq_data(fl, par, "x", [T, d])
    soft = _seq_data(fl, par, "soft", [T, vocab])
    h = par.tp.column_parallel_fc(x, d_ff, act="relu", num_flatten_dims=2,
                                  param_attr=fl.ParamAttr(name="tx.c.w"),
                                  bias_attr=fl.ParamAttr(name="tx.c.b"))
    dr = L.dropout(h, p)
    h2 = par.tp.row_parallel_fc(dr, d, num_flatten_dims=2,
                                param_attr=fl.ParamAttr(name="tx.r.w"),
                                bias_attr=fl.ParamAttr(name="tx.r.b"))
    logits = par.tp.column_parallel_fc(
        h2, vocab, num_flatten_dims=2,
        param_attr=fl.ParamAttr(name="tx.o.w"),
        bias_attr=fl.ParamAttr(name="tx.o.b"))
    ce, sm = L.softmax_with_cross_entropy(logits, soft, soft_label=True,
                                          return_softmax=True)
    loss = L.mean(ce)
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, dr, sm


def build_tp_mixing(fl, par):
    """h = column_parallel_fc(x [N, 12], 16) (sharded on its last dim under
    tp): ``softmax`` along that dim and ``reduce_sum`` over it, which
    have no tensor-parallel form, SGD(0.1): (loss, the softmax, the
    sum)."""
    L = fl.layers
    x = L.data("x", [12])
    h = par.tp.column_parallel_fc(x, 16, act="tanh",
                                  param_attr=fl.ParamAttr(name="tm.w"),
                                  bias_attr=fl.ParamAttr(name="tm.b"))
    sm = L.softmax(h)
    r = L.reduce_sum(h, dim=-1)
    loss = L.sums([L.mean(L.elementwise_mul(sm, sm)), L.mean(r)])
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, sm, r


def build_seq_carry(fl, par):
    """h = fc(x [N, 8, 4], 3) with x's sequence sharded over sp (the port):
    reduce_sum over the batch keeping the sequence, cumsum along the
    sequence, SGD(0.1): (loss, the sum, the cumsum), both carried by the
    Strategy over a sharded sequence."""
    L = fl.layers
    x = _seq_data(fl, par, "x", [8, 4])
    h = L.fc(x, 3, num_flatten_dims=2, act="tanh",
             param_attr=fl.ParamAttr(name="sc.w"),
             bias_attr=fl.ParamAttr(name="sc.b"))
    r = L.reduce_sum(h, dim=0)
    c = L.cumsum(h, axis=1)
    loss = L.sums([L.mean(L.elementwise_mul(r, r)), L.mean(c)])
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, r, c


def build_seq_ops(fl, par):
    """h = fc(x [N, 8, 4], 4) with x's sequence sharded over sp (the port),
    then three ops along the sequence that a layer declares (``Op.axes``)
    and no attribute names: ``sequence_reverse`` within each length,
    ``row_conv`` (2 steps of lookahead) and ``sequence_conv`` (a window of
    3), SGD(0.1): (loss, the three outputs)."""
    L = fl.layers
    x = _seq_data(fl, par, "x", [8, 4])
    ln = L.data("len", [], dtype="int32")
    h = L.fc(x, 4, num_flatten_dims=2, act="tanh",
             param_attr=fl.ParamAttr(name="so.w"),
             bias_attr=fl.ParamAttr(name="so.b"))
    r = L.sequence_reverse(h, ln)
    c = L.row_conv(h, 2, param_attr=fl.ParamAttr(name="so.rc"))
    v = L.sequence_conv(h, ln, 3, 3, param_attr=fl.ParamAttr(name="so.sc"),
                        bias_attr=False)
    loss = L.sums([L.mean(L.elementwise_mul(r, c)), L.mean(v)])
    fl.optimizer.SGD(0.1).minimize(loss)
    return loss, r, c, v


def build_pipe(fl, par):
    """pipeline_fc_stack (4 stages, 4 microbatches) -> fc, a mean cross
    entropy, SGD(0.05): the reference's
    ``test_pipeline_fc_stack_trains_on_mesh``."""
    x = fl.layers.data("x", [16])
    lab = fl.layers.data("lab", [1], dtype="int32")
    h = par.pipeline_fc_stack(x, 16, n_stages=4, n_microbatches=4)
    logits = fl.layers.fc(h, 3, param_attr=fl.ParamAttr(name="p.w"),
                          bias_attr=fl.ParamAttr(name="p.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.SGD(0.05).minimize(loss)
    return loss


def build_conv_bn(fl, par):
    """Two 3x3 convs (16 channels, no bias), each batch_norm + relu, a
    global average pool, fc 10, a mean cross entropy; Momentum(0.1, 0.9):
    NCHW [N, 16, 32, 32]."""
    img = fl.layers.data("img", [16, 32, 32])
    lab = fl.layers.data("lab", [1], dtype="int32")
    h = img
    for i in range(2):
        h = fl.layers.conv2d(h, 16, 3, padding=1,
                             param_attr=fl.ParamAttr(name=f"cb{i}.w"),
                             bias_attr=False)
        h = fl.layers.batch_norm(h, act="relu",
                                 param_attr=fl.ParamAttr(name=f"cb{i}.s"),
                                 bias_attr=fl.ParamAttr(name=f"cb{i}.b"),
                                 moving_mean_name=f"cb{i}.m",
                                 moving_variance_name=f"cb{i}.v")
    h = fl.layers.pool2d(h, 1, pool_type="avg", global_pooling=True)
    logits = fl.layers.fc(h, 10, param_attr=fl.ParamAttr(name="cb.fc.w"),
                          bias_attr=fl.ParamAttr(name="cb.fc.b"))
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.Momentum(0.1, momentum=0.9).minimize(loss)
    return loss


CTR_VOCABS = [50, 32, 8, 12]


def build_ctr_tp(fl, par, P=None, is_sparse=False, vocabs=None, emb_dim=4,
                 hidden=(16, 8)):
    """wide_deep with every field table vocab-sharded over tp
    (``shard_spec``), Adam; ``is_sparse`` routes the lookups through the
    sparse engine's rule.  ``P``: the package's PartitionSpec (default
    ``par.P``; the JAX package's is ``jax.sharding.PartitionSpec``)."""
    vocabs = list(vocabs or CTR_VOCABS)
    dense = fl.layers.data("dense", [13])
    sparse = fl.layers.data("sparse", [len(vocabs)], dtype="int32")
    label = fl.layers.data("label", [1], dtype="int32")
    loss, _ = fl.models.ctr.wide_deep(dense, sparse, label, vocabs=vocabs,
                                      emb_dim=emb_dim, hidden=hidden,
                                      shard_spec=(P or par.P)("tp", None),
                                      is_sparse=is_sparse)
    fl.optimizer.Adam(1e-2).minimize(loss)
    return loss


TINY_LM = dict(vocab_size=64, max_len=16, d_model=32, n_heads=4, n_layers=2,
               d_ff=64)


def build_lm(fl, par, use_tp=False, use_sp=False, sp_strategy="ring",
             dropout=0.0, clip=1.0, cfg=None):
    cfg = dict(cfg or TINY_LM)
    T = cfg["max_len"]
    toks = fl.layers.data("toks", [T], dtype="int32")
    labs = fl.layers.data("labs", [T, 1], dtype="int32")
    loss, logits = fl.models.transformer.build_lm(
        toks, labs, use_tp=use_tp, use_sp=use_sp, sp_strategy=sp_strategy,
        dropout=dropout, **cfg)
    fl.optimizer.Adam(1e-3, grad_clip=fl.clip.GradientClipByGlobalNorm(
        clip)).minimize(loss)
    return loss, logits


def build_lm_metrics(fl, par, cfg=None, use_tp=False):
    """The LM of ``build_lm`` fetching next-token ``accuracy`` of its
    logits, with an ``Accuracy`` evaluator over them: (loss, accuracy,
    the evaluator's rate, its correct and total counts).  ``use_tp``: the
    tensor-parallel head, whose logits are sharded on the vocabulary."""
    loss, logits = build_lm(fl, par, use_tp=use_tp, cfg=cfg)
    labs = fl.default_main_program().global_block.vars["labs"]
    acc = fl.layers.accuracy(logits, labs)
    ev = fl.evaluator.Accuracy(logits, labs)
    return loss, acc, ev.metric, ev.correct, ev.total


BUILDERS = {"mlp": build_mlp, "megatron": build_megatron,
            "megatron_clip": build_megatron_clip, "vocab": build_vocab,
            "zero1": build_zero1, "zero1_packed": build_zero1_packed,
            "accum": build_accum, "accum_1": build_accum_1,
            "dropout": build_dropout, "lm": build_lm,
            "mlp_sum": build_mlp_sum, "mlp_bn": build_mlp_bn,
            "reduce_ops": build_reduce_ops, "moe": build_moe,
            "carry_grads": build_carry_grads, "moe_seq": build_moe_seq,
            "seq_carry": build_seq_carry, "tp_extras": build_tp_extras,
            "seq_ops": build_seq_ops,
            "lm_metrics": build_lm_metrics, "tp_mixing": build_tp_mixing,
            "moe_jitter": build_moe_jitter, "pipe": build_pipe,
            "ctr_tp": build_ctr_tp, "conv_bn": build_conv_bn}


def mixing_program(fl, which: str):
    """A program holding one layer that mixes batch rows (ROADMAP C.13),
    which a Strategy carries over a sharded batch: (its feeds at 4 rows,
    the Variables to fetch).  ``which``: a layer (accuracy, auc,
    chunk_eval, reduce_prod), an op along, into or out of the batch dim
    (cumsum and argmax over dim 0, matmul with x transposed, matmul of a
    batch-major y, gather and scatter of a batch-major x, sum_to_one_norm
    of a [None] vector), or an evaluator (Accuracy, ChunkEvaluator,
    PrecisionRecall, CTCError, DetectionMAP: its metric, when it has one,
    and its states)."""
    L = fl.layers
    rng = np.random.RandomState(0)
    n, C, T = 4, 2, 5
    p = L.data("p", [C])
    lab = L.data("lab", [1], dtype="int32")
    feed = {"p": rng.rand(n, C).astype("float32"),
            "lab": rng.randint(0, C, (n, 1)).astype("int32")}
    if which in ("chunk_eval", "ChunkEvaluator", "CTCError"):
        tags = L.data("tags", [T], dtype="int32")
        gold = L.data("gold", [T], dtype="int32")
        ln = L.data("ln", [], dtype="int32")
        feed.update(tags=rng.randint(-1, 4, (n, T)).astype("int32"),
                    gold=rng.randint(-1, 4, (n, T)).astype("int32"),
                    ln=np.full((n,), T, "int32"))
    ev = out = None
    if which == "accuracy":
        out = L.accuracy(p, lab)
    elif which == "auc":
        out = L.auc(p, lab)
    elif which == "chunk_eval":
        out = L.chunk_eval(tags, gold, ln)
    elif which == "reduce_prod":
        out = L.reduce_prod(p)
    elif which == "cumsum":
        out = L.cumsum(p, axis=0)
    elif which == "argmax":
        out = L.argmax(p, axis=0)
    elif which == "matmul_tx":
        out = L.matmul(p, p, transpose_x=True)
    elif which == "matmul_y":
        q = L.data("q", [3, -1], append_batch_size=False)
        feed["q"] = rng.rand(3, n).astype("float32")
        out = L.matmul(q, p)
    elif which in ("gather", "scatter"):
        idx = L.data("idx", [], dtype="int32")
        feed["idx"] = np.array([3, 0, 1, 1], "int32")
        if which == "gather":
            out = L.gather(p, idx)
        else:
            out = L.scatter(p, idx, p)
    elif which == "sum_to_one_norm":
        v = L.data("v", [])
        feed["v"] = rng.rand(n).astype("float32") + 0.1
        out = L.sum_to_one_norm(v)
    elif which == "Accuracy":
        ev = fl.evaluator.Accuracy(p, lab)
    elif which == "PrecisionRecall":
        ev = fl.evaluator.PrecisionRecall(p, lab, num_classes=C)
    elif which == "ChunkEvaluator":
        ev = fl.evaluator.ChunkEvaluator(tags, gold, ln)
    elif which == "CTCError":
        x = L.data("x", [T, C])
        y = L.data("y", [2], dtype="int32")
        feed.update(x=rng.randn(n, T, C).astype("float32"),
                    y=rng.randint(1, C, (n, 2)).astype("int32"))
        ev = fl.evaluator.CTCError(x, y, ln, L.data("yl", [], dtype="int32"))
        feed["yl"] = np.full((n,), 2, "int32")
    elif which == "DetectionMAP":
        K, G = 3, 2
        db = L.data("db", [K, 4])
        ds = L.data("ds", [K])
        dl = L.data("dl", [K], dtype="int32")
        gb = L.data("gb", [G, 4])
        gl = L.data("gl", [G], dtype="int32")
        feed.update(db=rng.rand(n, K, 4).astype("float32"),
                    ds=rng.rand(n, K).astype("float32"),
                    dl=rng.randint(1, C, (n, K)).astype("int32"),
                    gb=rng.rand(n, G, 4).astype("float32"),
                    gl=rng.randint(1, C, (n, G)).astype("int32"))
        ev = fl.evaluator.DetectionMAP(db, ds, dl, gb, gl, num_classes=C)
    else:
        raise ValueError(which)
    if ev is not None:
        out = ([ev.metric] if getattr(ev, "metric", None) is not None
               else []) + list(ev._states)
    return feed, list(out) if isinstance(out, (list, tuple)) else [out]


MIXING = ("accuracy", "auc", "chunk_eval", "reduce_prod", "cumsum",
          "argmax", "matmul_tx", "matmul_y", "gather", "scatter",
          "Accuracy", "PrecisionRecall", "ChunkEvaluator", "CTCError",
          "DetectionMAP")


def fetch_names(built, fetch) -> list:
    """Fetch names, where ``"$i"`` names the i-th Variable a builder
    returned."""
    return [built[int(f[1:])].name if f.startswith("$") else f
            for f in fetch]


# ------------------------------------------------------------ in a rank


def _fresh():
    import paddle_tpu_torch as fluid

    fluid.reset_default_programs()
    fluid.reset_global_scope()
    return fluid


def program_case(spec: dict) -> dict:
    """Build ``spec["build"]`` (with ``spec.get("kw")``), run its startup,
    load ``spec["init"]`` (full numpy arrays by name), then run
    ``spec["feeds"]`` (one feed dict per step) under a Strategy on
    ``spec["mesh"]`` (None: unsharded), fetching the loss and
    ``spec["fetch"]`` (names, ``"$i"`` the builder's i-th output) each
    step (through ``DeviceFeeder(sharding=strategy)`` with
    ``spec["feeder"]``).  Returns the fetches, each step's feeds as the
    Executor took them (type and shape), the gathered final state of
    ``spec.get("state", [])`` names and, under ZeRO-1, the coverage dict
    and the local shapes."""
    fluid = _fresh()
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.core.types import Place

    out = BUILDERS[spec["build"]](fluid, parallel, **spec.get("kw", {}))
    loss = out[0] if isinstance(out, tuple) else out
    strategy = None
    if spec.get("mesh") is not None:
        mesh = parallel.make_mesh(spec["mesh"])
        if not mesh.in_mesh:
            return {"idle": True}     # a sub-mesh leaves this rank out
        strategy = parallel.Strategy(
            mesh, data_axis=spec.get("data_axis", "dp"),
            shard_optimizer_state=spec.get("zero1", False))
    device = spec.get("device", "cpu")
    exe = fluid.Executor(Place("cpu") if device == "cpu" else None,
                         strategy=strategy)
    main, scope = fluid.default_main_program(), fluid.global_scope()
    exe.run(fluid.default_startup_program())
    if spec.get("init"):
        # the full arrays; under a Strategy the scope gets this rank's shards
        fluid.load_scope(spec["init"], main, scope, device=exe.device,
                         strategy=strategy)
    scope.step_counter = spec.get("step_counter", 0)
    fetch = [loss.name] + fetch_names(out, spec.get("fetch", []))
    feeds = spec["feeds"]
    if spec.get("feeder"):
        # each rank stages only its part of every batch
        feeds = fluid.DeviceFeeder(lambda: iter(spec["feeds"]),
                                   sharding=strategy, device=exe.device)
    steps, staged = [], []
    for feed in feeds:
        staged.append({n: (type(feed).__name__, tuple(v.shape))
                       for n, v in feed.items()})
        steps.append([np.asarray(v) for v in exe.run(feed=feed,
                                                     fetch_list=fetch)])
    res = {"steps": steps, "staged": staged}
    names = spec.get("state", [])
    if names:
        res["state"] = fluid.gather_scope(main, scope, strategy, names)
    if strategy is not None and strategy.shard_optimizer_state:
        res["coverage"] = strategy.last_shard_coverage
        res["local_shapes"] = {n: tuple(scope.find_var(n).shape)
                               for n in scope.var_names()}
    return res


def shard_seq(x: np.ndarray, n: int, idx: int, striped: bool, dim: int = 2):
    """Rank ``idx``'s chunk of the sequence dim ``dim`` of x over n ranks
    (contiguous, or striped)."""
    from paddle_tpu_torch.parallel.strategy import seq_index

    return np.take(x, seq_index(x.shape[dim], n, idx, striped), axis=dim)


def attention_case(spec: dict) -> dict:
    """Ring or Ulysses attention (``spec["attn"]``) over this rank's chunks
    of the global
    q/k/v (``spec["qkv"]``, [B, H, T, D]) on ``spec["mesh"]`` (rows of B
    over dp when the mesh has it, T over sp): the output and the q/k/v
    gradients of sum(out * w), gathered to global arrays in global order.
    A ValueError raised by the call (before any collective) is returned as
    ``{"error": message}``."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.parallel import comm

    mesh = parallel.make_mesh(spec["mesh"])
    n, idx = mesh.shape["sp"], mesh.coord("sp")
    striped = spec.get("striped", False)
    dp = mesh.shape.get("dp", 1)
    r = mesh.coord("dp") if "dp" in mesh.shape else 0

    def local(a):
        a = a[r * (a.shape[0] // dp):(r + 1) * (a.shape[0] // dp)]
        return torch.from_numpy(np.ascontiguousarray(
            shard_seq(a, n, idx, striped)))

    q, k, v = (local(a).requires_grad_(True) for a in spec["qkv"])
    w = local(spec["w"])
    try:
        if spec["attn"] == "ring":
            out = parallel.ring_attention(q, k, v, mesh, causal=spec["causal"],
                                          striped=striped)
        else:
            out = parallel.ulysses_attention(q, k, v, mesh,
                                             causal=spec["causal"])
    except ValueError as exc:
        return {"error": str(exc)}
    gq, gk, gv = torch.autograd.grad((out * w).sum(), (q, k, v))

    def glob(t):
        t = comm.all_gather(t.detach(), mesh.group("sp"), 2)
        if striped:
            perm = np.concatenate([shard_seq(np.arange(t.shape[2])[None, None],
                                             n, d, True)[0, 0]
                                   for d in range(n)])
            t = t[:, :, np.argsort(perm)]
        if dp > 1:
            t = comm.all_gather(t, mesh.group("dp"), 0)
        return t.numpy()

    return {"out": glob(out), "dq": glob(gq), "dk": glob(gk), "dv": glob(gv)}


def collectives_case(spec: dict) -> dict:
    """Each collective of comm.py on a mesh of {"a": 2, "b": n / 2}: every
    rank's result, to hold against what the definitions give."""
    import torch.distributed as dist

    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.parallel import comm

    mesh = parallel.make_mesh(spec["mesh"])
    rank = dist.get_rank()
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 100 * rank
    out = {}
    for axis in mesh.axis_names:
        g = mesh.group(axis)
        out[axis] = {
            "ranks": mesh.axis_ranks(axis),
            "sum": comm.all_reduce(x, g).numpy(),
            "max": comm.all_reduce(x, g, "max").numpy(),
            "gather1": comm.all_gather(x, g, 1).numpy(),
            "scatter0": comm.reduce_scatter(x, g, 0).numpy(),
            "a2a": comm.all_to_all(x, g, 0, 1).numpy(),
            "shift": comm.ring_shift([x], g)[0].numpy(),
        }
    return {"rank": rank, "coords": mesh.coords, "by_axis": out}


def _zero_counters() -> None:
    from ..ops import _counters

    snap = _counters.snapshot()
    _counters.restore(_counters.delta(snap, snap))


def lm_leg_case(spec: dict) -> dict:
    """One leg of the chip phase on this rank: the LM of ``spec["cfg"]``
    (``build_lm`` with ``spec["kw"]``) under a Strategy on
    ``spec["mesh"]`` (ZeRO-1 with ``spec["zero1"]``), on this rank's
    device, from ``init_lm_params(spec["seed"])``; ``spec["steps"]`` steps
    on ``spec["feed"]``, the first fetching every gradient (and the first
    dropout's output, with dropout).  Rank 0 holds them against the
    single-card step saved at ``spec["ref"]`` (``torch.save`` of {"loss":
    [...], "grads": {name: tensor}, "mask": bool tensor or None}).
    Returns, per rank: the losses, the worst gradient error over its max
    abs (and its name), whether the mask is bitwise the reference's, the
    kernel launches of the steps, the collectives called and staged, ms
    per step and the peak memory."""
    import time

    from ..models.transformer import init_lm_params
    from ..ops import attention as _attn, dropout as _drop
    from ..parallel import comm

    fluid = _fresh()
    from paddle_tpu_torch import parallel

    cfg = spec["cfg"]
    loss, _ = build_lm(fluid, parallel, cfg=cfg, **spec.get("kw", {}))
    main = fluid.default_main_program()
    mesh = parallel.make_mesh(spec["mesh"])
    strategy = parallel.Strategy(mesh, shard_optimizer_state=spec.get(
        "zero1", False))
    from paddle_tpu_torch.core.types import Place

    exe = fluid.Executor(Place("cpu") if spec.get("device") == "cpu"
                         else None, strategy=strategy)
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    fluid.load_scope(init_lm_params(spec["seed"], **cfg), main, scope,
                     device=exe.device)
    grads = [p.name + "@GRAD" for p in main.parameters()]
    drops = [op.outputs["Out"][0] for op in main.list_ops()
             if op.type == "dropout"]
    first = [loss.name] + grads + drops[:1]
    dev = exe.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_counters()
    comm.reset_counts()
    outs, ms = [], []
    for i in range(spec["steps"]):
        comm.barrier()
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        outs.append(exe.run(feed=spec["feed"],
                            fetch_list=first if i == 0 else [loss]))
        if cuda:
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    res = {"coords": mesh.coords,
           "losses": [float(np.ravel(o[0])[0]) for o in outs],
           "flash": dict(_attn.flash_attention.launches),
           "dropout": dict(_drop.threefry_dropout.launches),
           "calls": dict(comm.calls), "staged": dict(comm.staged),
           "comm_s": dict(comm.seconds),
           "backend": comm.backend(),
           "ms": ms,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else 0}
    if mesh.rank == 0:
        ref = torch.load(spec["ref"])
        worst, where = 0.0, None
        for n, g in zip(grads, outs[0][1:1 + len(grads)]):
            r = ref["grads"][n].numpy()
            err = float(np.abs(g - r).max()) / max(float(np.abs(r).max()),
                                                   1e-30)
            if err >= worst:
                worst, where = err, n
        res["grad_worst"], res["grad_worst_name"] = worst, where
        res["ref_losses"] = ref["loss"]
        if drops:
            res["mask_equal"] = bool(np.array_equal(
                outs[0][-1] == 0, ref["mask"].numpy()))
    return res


def gpipe_case(spec: dict) -> dict:
    """``gpipe`` of a tanh fc stack on ``spec["mesh"]`` (pp, and dp rows
    when the mesh has dp): the rank's stages of the full ``spec["w"]`` [S,
    d, d] and ``spec["b"]`` [S, d], its rows of ``spec["x"]``, ``spec["m"]``
    microbatches; the output and the gradients of sum(y * g) for w, b and
    x, gathered to the full arrays (summed over dp)."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.parallel import comm

    mesh = parallel.make_mesh(spec["mesh"])
    pp, r = mesh.shape["pp"], mesh.coord("pp")
    dp = mesh.shape.get("dp", 1)
    d = mesh.coord("dp") if dp > 1 else 0
    k = spec["w"].shape[0] // pp
    rows = spec["x"].shape[0] // dp
    w = torch.from_numpy(spec["w"][r * k:(r + 1) * k]).requires_grad_(True)
    b = torch.from_numpy(spec["b"][r * k:(r + 1) * k]).requires_grad_(True)
    x = torch.from_numpy(spec["x"][d * rows:(d + 1) * rows]).requires_grad_(
        True)
    g = torch.from_numpy(spec["g"][d * rows:(d + 1) * rows])

    def stage(params, h):
        pw, pb = params
        return torch.tanh(h @ pw + pb)

    before = comm.calls["shift"]
    y = parallel.gpipe(stage, (w, b), x, mesh, n_microbatches=spec["m"])
    gw, gb, gx = torch.autograd.grad((y * g).sum(), (w, b, x))
    shifts = comm.calls["shift"] - before
    if dp > 1:
        gw, gb = (comm.all_reduce(t, mesh.group("dp")) for t in (gw, gb))
        y, gx = (comm.all_gather(t, mesh.group("dp"), 0) for t in (y, gx))
    gw, gb = (comm.all_gather(t, mesh.group("pp"), 0) for t in (gw, gb))
    return {"y": y.detach().numpy(), "gw": gw.numpy(), "gb": gb.numpy(),
            "gx": gx.numpy(), "shifts": shifts}


def drive_scheduler(eng, n_req: int, max_gen: int, seed: int = 7,
                    vocab: int = 200, reqs=None) -> list:
    """The reference's mesh-test drive: ``n_req`` prompts of 3-14 tokens
    drawn from ``seed`` (or ``reqs``, (prompt, max_gen) pairs) through a
    ContinuousScheduler until idle, all submitted at once: (the token
    streams, the scheduler, the handles, the wall seconds)."""
    import time

    from ..serving import ContinuousScheduler

    if reqs is None:
        rng = np.random.RandomState(seed)
        reqs = [(rng.randint(2, vocab, int(rng.randint(3, 15))), max_gen)
                for _ in range(n_req)]
    sched = ContinuousScheduler(eng)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(eng.device)
    t0 = time.perf_counter()
    handles = [sched.submit(p, max_gen=g) for p, g in reqs]
    sched.run_until_idle()
    if cuda:
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    out = [np.asarray(r.result(10)) for r in handles]
    return out, sched, handles, wall


def probe_inputs(eng):
    """The reference's teacher-forced probe: every slot at position 0 with
    token 5, its own first block, limit 30."""
    S = eng.n_slots
    tables = np.tile(np.full(eng.n_tbl, eng.pool.trash, np.int32), (S, 1))
    for s in range(S):
        tables[s, 0] = s
    return (np.full((S, 1), 5, np.int32), np.zeros(S, np.int32), tables,
            np.full(S, 30, np.int32))


def serve_case(spec: dict) -> dict:
    """The decode engine on a serving mesh (``spec["mesh"]``, e.g.
    "data=4"): ``spec["params"]`` (numpy, JAX names) at ``spec["cfg"]``;
    ``warm()`` (its count, or the WarmError's message), the probe's step
    logits, then the reference's drive (``spec["n_req"]``,
    ``spec["max_gen"]``, or ``spec["reqs"]``): the streams, the wall and
    the TTFTs, the scheduler's mesh stats, the block accounting,
    dispatches, replays and paged launches (counters set to 0 after the
    probe)."""
    from ..core.graphs import WarmError
    from ..ops.paged_attention import paged_attention
    from ..serving import ContinuousDecodeEngine, make_serving_mesh

    sm = make_serving_mesh(spec["mesh"])
    params = spec["params"]
    if callable(params):
        params = params()
    eng = ContinuousDecodeEngine(params, mesh=sm,
                                 device=spec.get("device", "cpu"),
                                 **spec["cfg"])
    del params
    try:
        warm = eng.warm()
    except WarmError as exc:
        warm = str(exc)
    logits = eng.step_logits(*probe_inputs(eng))
    _zero_counters()
    for c in (eng.step_dispatches, eng.prefill_dispatches, eng.replays):
        c.clear()
    streams, sched, handles, wall = drive_scheduler(
        eng, spec.get("n_req", 0), spec.get("max_gen", 0),
        reqs=spec.get("reqs"))
    ttft = [1e3 * (h.t_first_token - h.t_submit) for h in handles]
    return {"warm": warm, "logits": logits, "streams": streams,
            "wall_s": wall, "ttft_ms": ttft,
            "prefills": sum(eng.prefill_dispatches.values()),
            "mesh": sched.stats()["mesh"],
            "blocks": sched.check_block_accounting(),
            "steps": sum(eng.step_dispatches.values()),
            "replays": sum(eng.replays.values()),
            "paged": paged_attention.launches,
            "pool_heads": eng.pool.n_heads, "rows": eng._rows}


def table_case(spec: dict) -> dict:
    """``ShardedEmbeddingTable(mesh=)`` on ``spec["mesh"]`` ("fsdp=2", ...):
    the lookup of ``spec["ids"]``, then one row-touched Adagrad(0.1)
    apply of ones on the dedup's uids; the lookup, the whole table after
    the apply (each rank's rows gathered) and the table's spec and rows.
    A rank a sub-mesh leaves out returns ``{"idle": True}``."""
    from .. import optimizer as opt_mod
    from ..parallel import comm
    from ..serving import make_serving_mesh
    from ..sparse import RowTouchedOptimizer, ShardedEmbeddingTable

    sm = make_serving_mesh(spec["mesh"])
    if sm is not None and sm.mesh is not None and not sm.mesh.in_mesh:
        return {"idle": True}     # a sub-mesh leaves this rank out
    tab = ShardedEmbeddingTable(spec["vocabs"], 4, mesh=sm, seed=9,
                                padding_idx=0, max_ids_per_batch=32,
                                device="cpu")
    ids = spec["ids"]
    out = tab.lookup(ids).numpy()
    db = tab.dedup(ids)
    row_opt = RowTouchedOptimizer(opt_mod.Adagrad(0.1))
    slots = row_opt.init_slots(tab)
    grad = torch.ones((db.uids.shape[0], 4))
    row_opt.apply_rows(tab.storage, slots, tab.local_uids(
        torch.from_numpy(db.uids)), grad, 0.1, 1)
    value = tab.value
    for g in reversed(tab._groups):
        value = comm.all_gather(value, g, 0)
    return {"lookup": out, "value": value.numpy(), "rows": tab.rows,
            "row0": tab.row0, "describe": tab.describe()}


def c13_case(spec: dict) -> dict:
    """``program_case`` with the batch-norm and dropout kernels' launches
    of its steps (the counters set to 0 before it)."""
    from ..ops.batch_norm import batch_norm_train
    from ..ops.dropout import threefry_dropout

    _zero_counters()
    res = program_case(spec)
    res["bn"] = dict(batch_norm_train.launches)
    res["dropout"] = dict(threefry_dropout.launches)
    return res


def ppep_case(spec: dict) -> dict:
    """The pp + ep program (``dryrun_multichip.ppep_two_steps``) for
    ``spec["n"]`` ranks' axes on this rank's device, at ``spec["dims"]``
    (d_ff, experts, stages, micro, cf, classes) on ``spec["feed"]``: the
    losses, ms a step and the peak memory."""
    from . import dryrun_multichip as dry
    from paddle_tpu_torch import parallel

    mesh = parallel.make_mesh(dry.ppep_axes(spec["n"]))
    dev = torch.device(spec.get("device", "cuda"))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = {}
    losses = dry.ppep_two_steps(spec["n"], spec["feed"],
                                parallel.Strategy(mesh),
                                "cpu" if not cuda else None, record=rec,
                                **spec.get("dims", {}))
    return {"losses": losses, "ms": rec["ms"], "coords": mesh.coords,
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}


def mixing_case(spec: dict) -> dict:
    """Each program of ``mixing_program`` (``spec["which"]``) run two steps
    on its feed under a Strategy on ``spec["mesh"]`` (None: unsharded):
    the fetches of each step, or the error raised, and the ops the
    Strategy's plan carried (their types)."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.core.types import Place

    out = {}
    for which in spec["which"]:
        fluid = _fresh()
        feed, fetch = mixing_program(fluid, which)
        strategy = None
        if spec.get("mesh") is not None:
            mesh = parallel.make_mesh(spec["mesh"])
            if not mesh.in_mesh:
                return {"idle": True}
            strategy = parallel.Strategy(mesh)
        exe = fluid.Executor(Place("cpu") if spec.get("device", "cpu")
                             == "cpu" else None, strategy=strategy)
        exe.run(fluid.default_startup_program())
        main = fluid.default_main_program()
        try:
            steps = [exe.run(feed=feed, fetch_list=fetch) for _ in range(2)]
            err = None
        except (NotImplementedError, ValueError) as exc:
            steps, err = None, str(exc)
        carried = []
        if strategy is not None:
            for plan in strategy._plans.get(main, {}).values():
                carried += sorted(op.type for op, _ in (plan or {}).values())
        out[which] = {"steps": steps, "error": err, "carried": carried}
    return out


def _cluster_model(fl):
    """fc(x [4]) -> sigmoid, the log loss, SGD(0.5): the resilience
    tests' model."""
    x = fl.layers.data("x", [4])
    y = fl.layers.data("y", [1])
    pred = fl.layers.fc(x, 1, act="sigmoid")
    loss = fl.layers.mean(fl.layers.log_loss(pred, y))
    return x, y, loss


def cluster_batches(n: int, seed: int = 0) -> list:
    """``n`` batches of 8 (x, y) samples of the cluster case's model."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xs = rng.rand(8, 4).astype("float32")
        ys = (xs.sum(axis=1, keepdims=True) > 2.0).astype("float32")
        out.append([(xs[j], ys[j]) for j in range(8)])
    return out


def _corrupt_blob(d: str, step: int) -> None:
    import os

    with open(os.path.join(d, f"ckpt-{step}", "persistables.npz"),
              "r+b") as f:
        f.write(b"garbage")


def cluster_case(spec: dict) -> dict:
    """``resilience.cluster`` and the checkpoint paths on a gang (one
    directory a rank under ``spec["dir"]``): named barriers (a repeated tag
    and a mismatched one); ``agree_restore_step`` with rank 1's newest
    checkpoint corrupted (every rank restores the newest common step,
    the pointers left where they were); a Trainer resuming on every rank
    (``RestoreAgreed``, the agreed step, the steps that follow); and a
    ZeRO-1 checkpoint over dp = 2: ``CheckpointStrategyMismatch`` with no
    strategy and with dp = 1, nothing quarantined, then a restore with the
    same strategy whose next step is bitwise the step without it."""
    import os

    import torch.distributed as dist

    import paddle_tpu_torch as fl
    from paddle_tpu_torch import io, parallel
    from paddle_tpu_torch.resilience import cluster

    rank = dist.get_rank()
    base = os.path.join(spec["dir"], f"rank{rank}")
    out: dict = {}
    cluster.barrier("start")
    cluster.barrier("start")
    try:
        cluster.barrier("odd" if rank else "even", timeout_s=30)
    except RuntimeError as e:
        out["barrier_mismatch"] = str(e)

    # agreement: steps 1-3 on every rank, rank 1's step 3 corrupt
    _fresh()
    _, _, loss = _cluster_model(fl)
    fl.optimizer.SGD(0.5).minimize(loss)
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    feeder = fl.DataFeeder(fl.default_main_program().global_block.vars[n]
                           for n in ("x", "y"))
    cm = io.CheckpointManager(os.path.join(base, "agree"))
    weights = {}
    for step, batch in enumerate(cluster_batches(3), 1):
        exe.run(feed=feeder.feed(batch), fetch_list=[loss])
        cm.save(step)
        weights[step] = fl.global_scope().find_var("fc_w_0").clone()
    if rank == 1:
        _corrupt_blob(cm.dirname, 3)
    out["intact"] = cm.intact_steps()
    out["agreed"] = cluster.agree_restore_step(out["intact"])
    state = cm.restore(limit_step=out["agreed"])
    out["restored"] = state["step"]
    out["restored_bitwise"] = bool(torch.equal(
        fl.global_scope().find_var("fc_w_0"), weights[state["step"]]))
    out["latest_after"] = cm.latest_step()

    # the Trainer's resume in a gang: 1 pass of 4 batches, checkpoints at
    # 2 and 4; rank 1's 4 corrupted; a new Trainer resumes for 2 passes
    d = os.path.join(base, "trainer")
    for run in range(2):
        _fresh()
        x, y, loss = _cluster_model(fl)
        events = []
        tr = fl.Trainer(loss, fl.optimizer.SGD(0.5), [x, y],
                        checkpoint_dir=d, checkpoint_every_n_steps=2,
                        place=fl.CPUPlace())
        tr.train(lambda: iter(cluster_batches(4)), num_passes=run + 1,
                 event_handler=events.append)
        if run == 0 and rank == 1:
            _corrupt_blob(d, 4)
    out["trainer_events"] = [
        (type(e).__name__,) + tuple(vars(e).values())
        for e in events if type(e).__name__ in ("RestoreAgreed", "BeginPass")]
    out["trainer_step"] = tr.global_step

    # the Trainer under a Strategy over dp = 2 (its steps eager, its
    # checkpoints gathered whole) against the same Trainer without one
    out["strategy_costs"] = {}
    for arm in ("single", "dp2"):
        _fresh()
        x, y, loss = _cluster_model(fl)
        costs = []
        tr = fl.Trainer(
            loss, fl.optimizer.SGD(0.5), [x, y],
            strategy=(parallel.Strategy(parallel.make_mesh({"dp": 2}))
                      if arm == "dp2" else None),
            checkpoint_dir=os.path.join(base, f"strategy_{arm}"),
            checkpoint_every_n_steps=2, place=fl.CPUPlace())
        tr.train(lambda: iter(cluster_batches(4, seed=1)), num_passes=1,
                 event_handler=lambda e: costs.append(e.cost)
                 if type(e).__name__ == "EndIteration" else None)
        out["strategy_costs"][arm] = costs
    out["strategy_ckpt_shape"] = tuple(np.load(os.path.join(
        base, "strategy_dp2", "ckpt-4", "persistables.npz"))["fc_w_0"].shape)

    # ZeRO-1: Adam on fc(x [7], 5), no dim divisible by dp = 2 (packed)
    _fresh()
    x = fl.layers.data("x", [7])
    lab = fl.layers.data("lab", [1], dtype="int32")
    logits = fl.layers.fc(x, 5)
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, lab))
    fl.optimizer.Adam(1e-2).minimize(loss)
    strategy = parallel.Strategy(parallel.make_mesh({"dp": 2}),
                                 shard_optimizer_state=True)
    other = parallel.Strategy(parallel.make_mesh({"dp": 1, "tp": 2}),
                              shard_optimizer_state=True)
    exe = fl.Executor(fl.CPUPlace(), strategy=strategy)
    exe.run(fl.default_startup_program())
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(8, 7).astype("float32"),
              "lab": rng.randint(0, 5, (8, 1)).astype("int32")}
             for _ in range(2)]
    exe.run(feed=feeds[0], fetch_list=[loss])
    cm = io.CheckpointManager(os.path.join(base, "zero1"))
    cm.save(1, strategy=strategy)
    want = exe.run(feed=feeds[1], fetch_list=[loss])[0]
    mismatches = []
    for st in (None, other):
        try:
            cm.restore(strategy=st)
        except io.CheckpointStrategyMismatch as e:
            mismatches.append(str(e))
    out["zero1_mismatches"] = mismatches
    out["zero1_kept"] = os.path.isdir(os.path.join(cm.dirname, "ckpt-1"))
    state = cm.restore(strategy=strategy)
    out["zero1_state"] = (state["zero1_packed"], state["zero1_dp"])
    got = exe.run(feed=feeds[1], fetch_list=[loss])[0]
    out["zero1_resumed_bitwise"] = got.tobytes() == want.tobytes()
    return out


KINDS = {"c13": c13_case, "cluster": cluster_case, "ppep": ppep_case, "table": table_case, "serve": serve_case, "gpipe": gpipe_case, "mixing": mixing_case, "program": program_case, "attention": attention_case,
         "collectives": collectives_case, "lm_leg": lm_leg_case}


def run_cases(cases: dict, keep_all_ranks: bool = False):
    """Run each case (name -> spec with "kind") on this rank, in order;
    rank 0 returns {name: result}, the other ranks None (unless
    ``keep_all_ranks``)."""
    import torch.distributed as dist

    torch.manual_seed(0)
    res = {name: KINDS[spec["kind"]](spec) for name, spec in cases.items()}
    if keep_all_ranks or dist.get_rank() == 0:
        return res
    return None
