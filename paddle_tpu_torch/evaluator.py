"""Streaming metrics as graph state (PyTorch port of
``paddle_tpu/evaluator.py``: the ``Evaluator`` base and
``DetectionMAP``).  The accumulators are persistable variables that ops
appended to the program update each step, so they ride a warmed step's
state like parameters do, and only ``eval()`` reads them on the host.
``Accuracy``, ``ChunkEvaluator``, ``PrecisionRecall`` and ``CTCError`` are
not ported yet (ROADMAP A.12)."""
from __future__ import annotations

import numpy as np
import torch

from .core import unique_name
from .core.executor import global_scope
from .core.program import Op, default_main_program, default_startup_program
from .layers.detection import _iou_matrix
from .layers.helper import LayerHelper

__all__ = ["DetectionMAP", "Evaluator"]


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
            {}, fn))

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
