"""Streaming metrics as graph state (PyTorch port of
``paddle_tpu/evaluator.py``): the ``Evaluator`` base, ``Accuracy``,
``ChunkEvaluator``, ``PrecisionRecall``, ``CTCError`` and
``DetectionMAP``.  The accumulators are persistable variables that ops
appended to the program update each step, so they ride a warmed step's
state like parameters do (every replay updates them in place), and only
``eval()`` reads them on the host.  ``reset()`` puts zeros in the scope
with ``set_var``; the next replay of a warmed step copies them into its
buffers.  Counts are integers in float32, exact on any device.

``Accuracy`` ranks the top k as ``lax.top_k`` does (a stable descending
sort, the lower index first among ties); ``PrecisionRecall`` takes the
first maximum as the prediction and gives a label outside [0, C) a zero
one-hot row, as ``jax.nn.one_hot`` does."""
from __future__ import annotations

import numpy as np
import torch

from .core import unique_name
from .core.executor import global_scope
from .core.program import (Op, Variable, default_main_program,
                           default_startup_program)
from .layers.detection import _iou_matrix
from .layers.helper import LayerHelper
from .layers.nn import _topk_counts
from .param_attr import seq_axis_of

__all__ = ["Accuracy", "CTCError", "ChunkEvaluator", "DetectionMAP",
           "Evaluator", "PrecisionRecall"]


class Evaluator:
    """Base: persistable accumulator state, set by the startup program, and
    ``reset()``."""

    def __init__(self, name: str):
        self.helper = LayerHelper(name)
        self._states = []

    def _create_state(self, suffix: str, shape, dtype="float32", fill=0.0):
        name = unique_name.generate(f"{self.helper.layer_type}.{suffix}")
        block = default_main_program().global_block
        v = block.create_var(name, shape, dtype, persistable=True)
        sblock = default_startup_program().global_block
        sblock.create_var(name, shape, dtype, persistable=True)
        shape_t = tuple(int(s) for s in shape)

        def init_fn(ins, attrs, ctx, _s=shape_t, _d=v.dtype, _f=fill):
            return {"Out": [torch.full(_s, _f, dtype=_d, device=ctx.device)]}

        sblock.append_op(Op("init", {}, {"Out": [name]}, {}, init_fn))
        self._states.append(v)
        return v

    def reset(self, executor, scope=None):
        """Zero every accumulator, on ``executor``'s device."""
        scope = scope or global_scope()
        for v in self._states:
            scope.set_var(v.name, torch.zeros(tuple(int(s) for s in v.shape),
                                              dtype=v.dtype,
                                              device=executor.device))


def _host(scope, v) -> np.ndarray:
    return scope.find_var(v.name).detach().cpu().numpy()


class Accuracy(Evaluator):
    """Streaming top-k accuracy (ref: fluid evaluator.py Accuracy;
    accuracy_op.cc): correct and total counts, and the running rate as the
    op's output ``metric``.  Under a Strategy that shards the batch the
    counts are summed over its ranks, so each rank's state is the single
    device's."""

    def __init__(self, input: Variable, label: Variable, k: int = 1):
        super().__init__("accuracy_evaluator")
        self.correct = self._create_state("correct", (1,), "float32")
        self.total = self._create_state("total", (1,), "float32")
        block = default_main_program().global_block

        seq = seq_axis_of(input)
        batch = bool(input.shape) and input.shape[0] is None

        def fn(ins, attrs, ctx, _seq=seq, _batch=batch):
            corr, _, rows = _topk_counts(ins["Out"][0], ins["Label"][0],
                                         k, ctx, _seq, _batch)
            new_c = ins["Correct"][0] + corr[None]
            new_t = ins["Total"][0] + rows
            return {"Out": [new_c, new_t, new_c / torch.clamp_min(new_t,
                                                                  1.0)]}

        out = block.create_var(
            unique_name.generate("accuracy_evaluator.rate"), (1,), "float32")
        block.append_op(Op("accuracy_accumulate",
                           {"Out": [input.name], "Label": [label.name],
                            "Correct": [self.correct.name],
                            "Total": [self.total.name]},
                           {"Out": [self.correct.name, self.total.name,
                                    out.name]}, {}, fn, axes=(-1,)))
        self.metric = out

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        c, t = _host(scope, self.correct), _host(scope, self.total)
        return float(c[0] / max(t[0], 1.0))


class ChunkEvaluator(Evaluator):
    """Streaming chunk precision / recall / F1 for IOB sequence tagging
    (ref: fluid evaluator ChunkEvaluator; gserver ChunkEvaluator.cpp): the
    (correct, inferred, labelled) chunk counts of ``layers.chunk_eval``
    summed in graph state; ``batch_counts`` is the batch's own."""

    def __init__(self, pred: Variable, label: Variable, lengths: Variable):
        super().__init__("chunk_evaluator")
        from .layers.sequence import chunk_eval

        self.counts = self._create_state("counts", (3,), "float32")
        batch = chunk_eval(pred, label, lengths)
        block = default_main_program().global_block

        def fn(ins, attrs, ctx):
            return {"Out": [ins["Acc"][0] + ins["Batch"][0]]}

        block.append_op(Op("chunk_accumulate",
                           {"Acc": [self.counts.name], "Batch": [batch.name]},
                           {"Out": [self.counts.name]}, {}, fn))
        self.batch_counts = batch

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        c = _host(scope, self.counts)
        correct, inferred, labeled = float(c[0]), float(c[1]), float(c[2])
        prec = correct / max(inferred, 1.0)
        rec = correct / max(labeled, 1.0)
        f1 = 2 * prec * rec / max(prec + rec, 1e-8)
        return prec, rec, f1


class PrecisionRecall(Evaluator):
    """Streaming macro precision / recall / F1 over classes (ref:
    paddle/operators/precision_recall_op.cc): per-class tp, fp and fn in a
    [3, C] state."""

    def __init__(self, input: Variable, label: Variable, num_classes: int):
        super().__init__("precision_recall_evaluator")
        self.num_classes = num_classes
        self.stats = self._create_state("stats", (3, num_classes), "float32")
        block = default_main_program().global_block

        def fn(ins, attrs, ctx):
            p, lab, acc = ins["P"][0], ins["Label"][0], ins["Acc"][0]
            classes = torch.arange(num_classes, device=p.device)
            pred = torch.argmax(p, dim=-1).reshape(-1)
            y = lab.reshape(-1).long()
            oh_p = (pred[:, None] == classes).to(torch.float32)
            oh_y = (y[:, None] == classes).to(torch.float32)
            tp = torch.sum(oh_p * oh_y, dim=0)
            fp = torch.sum(oh_p * (1 - oh_y), dim=0)
            fn_ = torch.sum((1 - oh_p) * oh_y, dim=0)
            return {"Out": [acc + torch.stack([tp, fp, fn_])]}

        block.append_op(Op("precision_recall_accumulate",
                           {"P": [input.name], "Label": [label.name],
                            "Acc": [self.stats.name]},
                           {"Out": [self.stats.name]}, {}, fn,
                           axes=(0, -1)))

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        s = _host(scope, self.stats)
        tp, fp, fn_ = s[0], s[1], s[2]
        support = (tp + fn_) > 0
        if not support.any():
            return 0.0, 0.0, 0.0
        prec = np.where(support, tp / np.maximum(tp + fp, 1e-8), 0.0)
        rec = np.where(support, tp / np.maximum(tp + fn_, 1e-8), 0.0)
        mp = float(prec[support].mean())
        mr = float(rec[support].mean())
        f1 = 2 * mp * mr / max(mp + mr, 1e-8)
        return mp, mr, f1


class CTCError(Evaluator):
    """Streaming sequence error rate (ref:
    gserver/evaluators/CTCErrorEvaluator.cpp): the summed edit distance
    between the best-path decodes (``layers.ctc_greedy_decoder``) and the
    labels (``layers.edit_distance``), over the summed label length."""

    def __init__(self, input: Variable, label: Variable,
                 logit_length: Variable, label_length: Variable,
                 blank: int = 0):
        super().__init__("ctc_error_evaluator")
        from .layers.sequence import ctc_greedy_decoder, edit_distance

        self.dist = self._create_state("dist", (1,), "float32")
        self.ref_len = self._create_state("ref_len", (1,), "float32")
        hyp, hyp_len = ctc_greedy_decoder(input, logit_length, blank=blank)
        d = edit_distance(hyp, hyp_len, label, label_length)
        block = default_main_program().global_block

        def fn(ins, attrs, ctx):
            new_d = ins["DistAcc"][0] + torch.sum(ins["D"][0])[None]
            new_r = ins["RefAcc"][0] + torch.sum(
                ins["RefLen"][0].to(torch.float32))[None]
            return {"Out": [new_d, new_r]}

        block.append_op(Op("ctc_error_accumulate",
                           {"D": [d.name], "RefLen": [label_length.name],
                            "DistAcc": [self.dist.name],
                            "RefAcc": [self.ref_len.name]},
                           {"Out": [self.dist.name, self.ref_len.name]}, {},
                           fn, axes=(0,)))
        self.batch_distance = d

    def eval(self, executor=None, scope=None):
        scope = scope or global_scope()
        d = float(_host(scope, self.dist)[0])
        r = float(_host(scope, self.ref_len)[0])
        return d / max(r, 1.0)


class DetectionMAP(Evaluator):
    """Streaming detection mAP as graph state (ref:
    gserver/evaluators/DetectionMAPEvaluator.cpp).

    Each step matches its batch in the program: detections (dense, padded;
    a score <= 0 is padding) are greedily matched high score first against
    the ground truths of their class (gt label 0 is padding) at
    ``iou_threshold``, a detection whose best-IoU gt is taken counting as a
    false positive (no fallback to the second best), in K fixed trips with
    no host read.  TP / FP counts land in per-class score histograms of
    ``n_bins`` buckets over [0, 1], persistable accumulators, so the only
    approximation against the exact evaluator (``detection_map_np``) is the
    score quantisation to 1 / n_bins.  ``eval()`` folds the [C, n_bins]
    state into 11-point interpolated AP on the host.

    Inputs (dense batch convention): det_boxes [B, K, 4], det_scores
    [B, K], det_labels [B, K] int, gt_boxes [B, G, 4], gt_labels [B, G]
    int.
    """

    def __init__(self, det_boxes, det_scores, det_labels, gt_boxes, gt_labels,
                 num_classes: int, iou_threshold: float = 0.5,
                 n_bins: int = 100):
        super().__init__("detection_map_evaluator")
        self.num_classes = num_classes
        self.n_bins = n_bins
        C, NB = num_classes, n_bins
        self.tp_hist = self._create_state("tp", (C, NB), "float32")
        self.fp_hist = self._create_state("fp", (C, NB), "float32")
        self.n_gt = self._create_state("ngt", (C,), "float32")
        block = default_main_program().global_block

        def fn(ins, attrs, ctx):
            db, ds = ins["DB"][0], ins["DS"][0]
            dl = ins["DL"][0].long()
            gb, gl = ins["GB"][0], ins["GL"][0].long()
            K = ds.shape[1]
            order = torch.argsort(-ds, dim=1, stable=True)
            db = torch.gather(db, 1, order[..., None].expand(-1, -1, 4))
            ds = torch.gather(ds, 1, order)
            dl = torch.gather(dl, 1, order)
            valid_d = ds > 0
            valid_g = gl > 0
            iou = _iou_matrix(db, gb)                           # [B, K, G]
            used = torch.zeros_like(valid_g)
            hits = []
            for i in range(K):
                cand = (gl == dl[:, i:i + 1]) & valid_g
                iou_i = torch.where(cand, iou[:, i], torch.full_like(
                    iou[:, i], -1.0))
                j = torch.argmax(iou_i, dim=1, keepdim=True)    # [B, 1]
                hit = ((torch.gather(iou_i, 1, j) >= iou_threshold)
                       & ~torch.gather(used, 1, j) & valid_d[:, i:i + 1])
                used = used.scatter(1, j, torch.gather(used, 1, j) | hit)
                hits.append(hit)
            hits = torch.cat(hits, dim=1)                       # [B, K]
            tp = (hits & valid_d).to(torch.float32)
            fp = (valid_d & ~hits).to(torch.float32)
            bins = (ds * NB).to(torch.int64).clamp(0, NB - 1)
            cell = (dl.clamp(0, C - 1) * NB + bins).reshape(-1)
            tp_h = torch.zeros(C * NB, device=ds.device).scatter_add(
                0, cell, tp.reshape(-1))
            fp_h = torch.zeros(C * NB, device=ds.device).scatter_add(
                0, cell, fp.reshape(-1))
            ngt = torch.zeros(C, device=ds.device).scatter_add(
                0, gl.clamp(0, C - 1).reshape(-1),
                valid_g.to(torch.float32).reshape(-1))
            return {"Out": [ins["TP"][0] + tp_h.reshape(C, NB),
                            ins["FP"][0] + fp_h.reshape(C, NB),
                            ins["NGT"][0] + ngt]}

        block.append_op(Op(
            "detection_map_accumulate",
            {"DB": [det_boxes.name], "DS": [det_scores.name],
             "DL": [det_labels.name], "GB": [gt_boxes.name],
             "GL": [gt_labels.name], "TP": [self.tp_hist.name],
             "FP": [self.fp_hist.name], "NGT": [self.n_gt.name]},
            {"Out": [self.tp_hist.name, self.fp_hist.name, self.n_gt.name]},
            {}, fn, axes=(0,)))

    def eval(self, executor=None, scope=None):
        """The mAP so far: per class with ground truth, the 11-point
        interpolated AP of the histograms walked from the highest bin
        down; their mean."""
        scope = scope or global_scope()
        tp, fp, ngt = (scope.find_var(v.name).cpu().numpy()
                       for v in (self.tp_hist, self.fp_hist, self.n_gt))
        aps = []
        for c in range(1, self.num_classes):
            if ngt[c] <= 0:
                continue
            ctp = np.cumsum(tp[c][::-1])
            cfp = np.cumsum(fp[c][::-1])
            if ctp[-1] + cfp[-1] == 0:
                aps.append(0.0)
                continue
            recall = ctp / ngt[c]
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                sel = recall >= t
                ap += (precision[sel].max() if sel.any() else 0.0) / 11
            aps.append(float(ap))
        return float(np.mean(aps)) if aps else 0.0
