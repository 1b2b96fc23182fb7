"""Object-detection layers, SSD-style (PyTorch port of
``paddle_tpu/layers/detection.py``): ``prior_box``, ``iou_similarity``,
``box_coder``, ``ssd_loss``, ``detection_output``, ``roi_pool`` and the
host-side ``detection_map_np``.

Everything keeps a static shape and reads nothing back to the host, so a
step that holds these ops captures as one CUDA graph.  Ground truth comes
padded to [N, G, 4] with labels [N, G] (0 pads).  The JAX package maps
each image through ``jax.vmap``; here every op is batched over N.

Three points where plain torch would differ from the reference:

* ``ssd_loss``'s forced match writes each gt's best prior with a scatter
  whose indices repeat (padded gts score IoU 0 everywhere, so their best
  prior is prior 0); on the CPU the last write in gt order wins.  The
  port takes, for each prior, the largest gt index that chose it
  (``scatter_reduce`` with ``amax``), which gives that on any device;
  ``index_put_`` with repeated indices has no defined winner on CUDA.
* ``jnp.argsort`` (the hard-negative ranking) and ``lax.top_k`` (the NMS)
  put the lower index first among equal values; ``torch.topk`` does not
  promise an order, so both are stable sorts here.  Most of
  ``detection_output``'s scores are 0 after its threshold, so this
  decides which boxes fill the empty slots.
* ``prior_box``'s boxes depend on shapes only: they are computed once per
  device on the CPU in float32, rounded as the reference's compiled step
  rounds them (the matching's ``> 0.5`` compares IoUs against them), and
  kept.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.program import Variable
from .helper import LayerHelper

__all__ = [
    "prior_box", "iou_similarity", "box_coder", "ssd_loss",
    "detection_output", "roi_pool", "detection_map_np",
]


# --------------------------------------------------------------------------- priors


def _prior_boxes(fh, fw, ih, iw, whs, variance, step, offset, clip, dtype):
    """(boxes [fh * fw * K, 4], variances) on the CPU, each value rounded
    as the reference's compiled step rounds it: XLA turns its ``(i +
    offset) * step / size`` into ``(i + offset) * c`` with the constant
    ``c = step * (1 / size)``, each factor rounded to float32, which
    differs from the written order's roundings by an ulp here and
    there."""
    def scale(st, size):
        one = torch.tensor(1.0, dtype=dtype)
        return torch.tensor(st, dtype=dtype) * (one / size)

    cx = (torch.arange(fw, dtype=dtype) + offset) * scale(step or iw / fw, iw)
    cy = (torch.arange(fh, dtype=dtype) + offset) * scale(step or ih / fh, ih)
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    wh = torch.tensor(whs, dtype=torch.float64).to(dtype)
    k = wh.shape[0]
    cxy = torch.stack([cxg, cyg], -1).reshape(fh * fw, 1, 2)
    half = wh.reshape(1, k, 2) / 2
    boxes = torch.cat([(cxy - half).reshape(-1, 2),
                       (cxy + half).reshape(-1, 2)], -1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float64).to(dtype)
    return boxes, var.expand(boxes.shape).contiguous()


def prior_box(
    input: Variable,
    image: Variable,
    min_sizes: Sequence[float],
    max_sizes: Sequence[float] = (),
    aspect_ratios: Sequence[float] = (1.0,),
    variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
    flip: bool = False,
    clip: bool = False,
    step: float = 0.0,
    offset: float = 0.5,
    name: Optional[str] = None,
):
    """Anchor boxes for one feature map (ref PriorBox.cpp).  Returns
    (boxes [HW*K, 4] in [xmin, ymin, xmax, ymax] normalised coords,
    variances [HW*K, 4]); K per cell: each min size at each aspect ratio,
    then sqrt(min * max) for each max size."""
    helper = LayerHelper("prior_box", name=name)
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    cache = {}

    def fn(ctx, feat, img):
        fh, fw = int(feat.shape[2]), int(feat.shape[3])
        ih, iw = int(img.shape[2]), int(img.shape[3])
        whs = []
        for k, ms in enumerate(min_sizes):
            for ar in ars:
                whs.append((ms * math.sqrt(ar) / iw, ms / math.sqrt(ar) / ih))
            if k < len(max_sizes):
                s = math.sqrt(ms * max_sizes[k])
                whs.append((s / iw, s / ih))
        if feat.device.type == "meta":
            shape = (fh * fw * len(whs), 4)
            return (torch.empty(shape, dtype=feat.dtype, device="meta"),
                    torch.empty(shape, dtype=feat.dtype, device="meta"))
        key = (feat.device, feat.dtype, fh, fw, ih, iw)
        if key not in cache:
            cache[key] = tuple(
                t.to(feat.device) for t in _prior_boxes(
                    fh, fw, ih, iw, whs, variance, step, offset, clip,
                    feat.dtype))
        return cache[key]

    out = helper.append_op(fn, {"Input": [input], "Image": [image]},
                           n_outputs=2)
    return out[0], out[1]


# --------------------------------------------------------------------------- IoU / coding


def _iou_matrix(a, b):
    """Corner boxes a [..., P, 4] and b [..., G, 4] -> IoU [..., P, G],
    the leading dims broadcast."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp_min(0)
              * (a[..., 3] - a[..., 1]).clamp_min(0))
    area_b = ((b[..., 2] - b[..., 0]).clamp_min(0)
              * (b[..., 3] - b[..., 1]).clamp_min(0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def iou_similarity(x: Variable, y: Variable, name=None):
    """IoU matrix between two corner-box sets ([P, 4], [G, 4] -> [P, G]);
    a leading batch dim on either side maps over it."""
    helper = LayerHelper("iou_similarity", name=name)
    return helper.append_op(lambda ctx, a, b: _iou_matrix(a, b),
                            {"X": [x], "Y": [y]})


def _center_size(priors):
    pw = priors[:, 2] - priors[:, 0]
    ph = priors[:, 3] - priors[:, 1]
    pcx = (priors[:, 0] + priors[:, 2]) / 2
    pcy = (priors[:, 1] + priors[:, 3]) / 2
    return pw, ph, pcx, pcy


def _encode_boxes(gt, priors, pvar):
    """Center-size encoding of corner gt [..., P, 4] against priors
    [P, 4]."""
    pw, ph, pcx, pcy = _center_size(priors)
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-8)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    tx = (gcx - pcx) / (pw * pvar[:, 0])
    ty = (gcy - pcy) / (ph * pvar[:, 1])
    tw = torch.log(gw / pw) / pvar[:, 2]
    th = torch.log(gh / ph) / pvar[:, 3]
    return torch.stack([tx, ty, tw, th], -1)


def _decode_boxes(loc, priors, pvar):
    pw, ph, pcx, pcy = _center_size(priors)
    cx = loc[..., 0] * pvar[:, 0] * pw + pcx
    cy = loc[..., 1] * pvar[:, 1] * ph + pcy
    w = torch.exp(loc[..., 2] * pvar[:, 2]) * pw
    h = torch.exp(loc[..., 3] * pvar[:, 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _unbatched(p, pv):
    """A batched feed of the same priors: its first row."""
    return (p[0], pv[0]) if p.dim() == 3 else (p, pv)


def box_coder(prior: Variable, prior_var: Variable, target: Variable,
              code_type: str = "encode_center_size", name=None):
    """Encode corner boxes against priors, or decode offsets back to
    corners.  target: [.., P, 4] (decode) or [P, 4] (encode)."""
    helper = LayerHelper("box_coder", name=name)
    enc = code_type.startswith("encode")

    def fn(ctx, p, pv, t):
        p, pv = _unbatched(p, pv)
        return _encode_boxes(t, p, pv) if enc else _decode_boxes(t, p, pv)

    return helper.append_op(fn, {"Prior": [prior], "PriorVar": [prior_var],
                                 "Target": [target]})


# --------------------------------------------------------------------------- SSD loss


def ssd_match_and_mine(conf, gbox, glab, p, thr: float, ratio: float):
    """The matching and hard-negative mining of ``ssd_loss`` on tensors:
    conf [N, P, C] logits, gbox [N, G, 4], glab [N, G], priors p [P, 4].
    Returns (pos, neg, match, closs): the positive and mined negative
    masks [N, P], each prior's gt index [N, P] and its conf loss [N, P]
    against its target label (background where not positive)."""
    n, P = conf.shape[0], p.shape[0]
    G = gbox.shape[1]
    dev = conf.device
    valid = glab > 0                                           # [N, G]
    iou = _iou_matrix(p, gbox) * valid[:, None, :]              # [N, P, G]
    best_iou = iou.amax(dim=2)                                  # [N, P]
    best_gt = torch.argmax(iou, dim=2)                          # first max
    best_prior = torch.argmax(iou, dim=1)                       # [N, G]
    # forced match, the last gt in order winning a prior chosen twice
    gts = torch.arange(G, device=dev).expand(n, G)
    last = torch.full((n, P), -1, dtype=torch.int64, device=dev).scatter_reduce(
        1, best_prior, gts, "amax")
    chosen = last >= 0
    forced = chosen & torch.gather(valid, 1, last.clamp_min(0))
    pos = forced | (best_iou > thr)
    match = torch.where(forced, last, best_gt)
    tgt_label = torch.where(pos, torch.gather(glab.long(), 1, match),
                            torch.zeros_like(match))
    logp = torch.log_softmax(conf, dim=-1)
    closs = -torch.gather(logp, 2, tgt_label[..., None])[..., 0]
    n_pos = pos.sum(dim=1, keepdim=True)                         # [N, 1]
    neg_loss = torch.where(pos, torch.full_like(closs, float("-inf")),
                           closs).detach()
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=dev).expand(n, P).contiguous())
    n_neg = torch.minimum((ratio * n_pos).to(torch.int32), P - n_pos)
    neg = ~pos & (rank < n_neg)
    return pos, neg, match, closs


def ssd_loss(
    location: Variable,       # [N, P, 4] predicted offsets
    confidence: Variable,     # [N, P, C] class logits (class 0 = background)
    gt_box: Variable,         # [N, G, 4] corner boxes, zero-padded
    gt_label: Variable,       # [N, G] int labels in [1, C), 0 pads
    prior: Variable,          # [P, 4]
    prior_var: Variable,      # [P, 4]
    overlap_threshold: float = 0.5,
    neg_pos_ratio: float = 3.0,
    loc_weight: float = 1.0,
    conf_weight: float = 1.0,
    name=None,
):
    """MultiBox loss (ref MultiBoxLossLayer.cpp): match priors to ground
    truth (each gt's best prior forced positive, plus any prior with IoU
    over the threshold), conf softmax-CE with hard-negative mining at
    neg:pos ratio, smooth-L1 on matched locations; normalised by the
    positive count.  Returns the loss of each image, [N]."""
    helper = LayerHelper("ssd_loss", name=name)

    def fn(ctx, loc, conf, gbox, glab, p, pv, thr, ratio, lw, cw):
        p, pv = _unbatched(p, pv)
        pos, neg, match, closs = ssd_match_and_mine(conf, gbox, glab, p,
                                                    thr, ratio)
        conf_l = torch.where(pos | neg, closs, torch.zeros_like(closs)).sum(1)
        matched = torch.gather(gbox, 1, match[..., None].expand(-1, -1, 4))
        d = loc - _encode_boxes(matched, p, pv)
        ad = d.abs()
        sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)
        loc_l = torch.where(pos, sl1, torch.zeros_like(sl1)).sum(1)
        denom = pos.sum(1).clamp_min(1).to(loc.dtype)
        return (cw * conf_l + lw * loc_l) / denom

    return helper.append_op(
        fn, {"Loc": [location], "Conf": [confidence], "GtBox": [gt_box],
             "GtLab": [gt_label], "Prior": [prior], "PriorVar": [prior_var]},
        attrs={"thr": overlap_threshold, "ratio": neg_pos_ratio,
               "lw": loc_weight, "cw": conf_weight},
                            axes=(1,))


# --------------------------------------------------------------------------- output


def _top_k(x, k: int):
    """``lax.top_k`` over the last dim: the k largest, descending, the
    lower index first among equal values."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def detection_output(
    location: Variable,      # [N, P, 4]
    confidence: Variable,    # [N, P, C] logits
    prior: Variable,         # [P, 4]
    prior_var: Variable,     # [P, 4]
    nms_threshold: float = 0.45,
    score_threshold: float = 0.01,
    keep_top_k: int = 100,
    name=None,
):
    """Decode + class-wise NMS (ref DetectionOutputLayer.cpp).  Per image
    and class the top ``keep_top_k`` scores over the threshold, a greedy
    suppression in ``keep_top_k`` fixed trips (box j survives if no
    higher-scoring survivor overlaps it over ``nms_threshold``), then the
    top ``keep_top_k`` over all classes.  Returns (boxes [N, K, 4],
    scores [N, K], labels [N, K] int32 with -1 for empty slots)."""
    helper = LayerHelper("detection_output", name=name)

    def fn(ctx, loc, conf, p, pv, nms_thr, score_thr, topk):
        p, pv = _unbatched(p, pv)
        n, P, C = conf.shape
        boxes = _decode_boxes(loc, p, pv)                       # [N, P, 4]
        probs = torch.softmax(conf, dim=-1)[..., 1:].transpose(1, 2)
        s = torch.where(probs > score_thr, probs, torch.zeros_like(probs))
        k = min(topk, P)
        top_s, idx = _top_k(s, k)                               # [N, C-1, k]
        b = torch.gather(boxes[:, None].expand(-1, C - 1, -1, -1), 2,
                         idx[..., None].expand(-1, -1, -1, 4))
        over = _iou_matrix(b, b) > nms_thr                      # [N, C-1, k, k]
        keep = top_s > 0
        for j in range(1, k):
            sup = (keep[..., :j] & over[..., j, :j]).any(-1)
            keep[..., j] &= ~sup
        cls_s = torch.where(keep, top_s, torch.zeros_like(top_s))
        labels = torch.arange(1, C, dtype=torch.int32,
                              device=conf.device).repeat_interleave(k)
        top2, idx2 = _top_k(cls_s.reshape(n, -1), topk)
        lab = torch.where(top2 > 0, labels[idx2],
                          torch.full_like(idx2, -1, dtype=torch.int32))
        out_b = torch.gather(b.reshape(n, -1, 4), 1,
                             idx2[..., None].expand(-1, -1, 4))
        return out_b, top2, lab

    out = helper.append_op(
        fn, {"Loc": [location], "Conf": [confidence], "Prior": [prior],
             "PriorVar": [prior_var]},
        attrs={"nms_thr": nms_threshold, "score_thr": score_threshold,
               "topk": keep_top_k},
        n_outputs=3,
                           axes=(1,))
    return out[0], out[1], out[2]


# --------------------------------------------------------------------------- roi pool


def roi_pool(input: Variable, rois: Variable, pooled_height: int,
             pooled_width: int, spatial_scale: float = 1.0, name=None):
    """Max pooling over ROI bins (ref roi_pool_op.cc / ROIPoolLayer.cpp).
    rois: [R, 5] = (batch_idx, x1, y1, x2, y2) in input coords *
    1/spatial_scale.  Each output bin is a masked max over H and W, with
    the reference's floor / ceil bin edges and 0 for an empty bin."""
    helper = LayerHelper("roi_pool", name=name)

    def fn(ctx, x, r, ph, pw, scale):
        r = r.reshape(-1, 5).to(x.dtype)   # [R, 5] or batch-led [1, R, 5]
        H, W = x.shape[2], x.shape[3]
        bi = r[:, 0].to(torch.int64)
        x1, y1, x2, y2 = (torch.round(r[:, i] * scale) for i in range(1, 5))
        rw = (x2 - x1 + 1).clamp_min(1.0)
        rh = (y2 - y1 + 1).clamp_min(1.0)
        bin_h, bin_w = (rh / ph)[:, None], (rw / pw)[:, None]
        iy = torch.arange(ph, dtype=x.dtype, device=x.device)
        ix = torch.arange(pw, dtype=x.dtype, device=x.device)
        h0 = (torch.floor(iy * bin_h) + y1[:, None]).clamp(0, H).long()
        h1 = (torch.ceil((iy + 1) * bin_h) + y1[:, None]).clamp(0, H).long()
        w0 = (torch.floor(ix * bin_w) + x1[:, None]).clamp(0, W).long()
        w1 = (torch.ceil((ix + 1) * bin_w) + x1[:, None]).clamp(0, W).long()
        hs = torch.arange(H, device=x.device)
        ws = torch.arange(W, device=x.device)
        mh = (hs >= h0[..., None]) & (hs < h1[..., None])      # [R, ph, H]
        mw = (ws >= w0[..., None]) & (ws < w1[..., None])      # [R, pw, W]
        img = x[bi]                                            # [R, C, H, W]
        ninf = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
        t = torch.where(mh[:, :, None, :, None], img[:, None], ninf).amax(3)
        o = torch.where(mw[:, :, None, None, :], t[:, None], ninf).amax(4)
        o = o.permute(0, 3, 2, 1)                              # [R, C, ph, pw]
        return torch.where(torch.isfinite(o), o, torch.zeros_like(o))

    return helper.append_op(fn, {"X": [input], "ROIs": [rois]},
                            attrs={"ph": pooled_height, "pw": pooled_width,
                                   "scale": spatial_scale},
                            axes=(0,))


# --------------------------------------------------------------------------- mAP


def _iou_np(a, b):
    """``_iou_matrix`` in numpy, float32 as the reference computes it."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (np.clip(a[:, 2] - a[:, 0], 0, None)
              * np.clip(a[:, 3] - a[:, 1], 0, None))
    area_b = (np.clip(b[:, 2] - b[:, 0], 0, None)
              * np.clip(b[:, 3] - b[:, 1], 0, None))
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, np.float32(0.0))


def detection_map_np(detections, ground_truths, num_classes: int,
                     iou_threshold: float = 0.5):
    """Host-side mAP (ref DetectionMAPEvaluator.cpp), 11-point
    interpolated.

    detections: list over images of (boxes [K,4], scores [K], labels [K]);
    ground_truths: list over images of (boxes [G,4], labels [G])."""
    aps = []
    for c in range(1, num_classes):
        records = []  # (score, is_tp)
        n_gt = 0
        for (db, ds, dl), (gb, gl) in zip(detections, ground_truths):
            gsel = np.asarray(gl) == c
            gtb = np.asarray(gb)[gsel]
            n_gt += len(gtb)
            used = np.zeros(len(gtb), bool)
            sel = (np.asarray(dl) == c) & (np.asarray(ds) > 0)
            for s, box in sorted(zip(np.asarray(ds)[sel], np.asarray(db)[sel]),
                                 key=lambda t: -t[0]):
                if len(gtb) == 0:
                    records.append((s, False))
                    continue
                ious = _iou_np(box[None], gtb)[0]
                j = int(np.argmax(ious))
                if ious[j] >= iou_threshold and not used[j]:
                    used[j] = True
                    records.append((s, True))
                else:
                    records.append((s, False))
        if n_gt == 0:
            continue
        records.sort(key=lambda t: -t[0])
        if len(records) == 0:
            aps.append(0.0)
            continue
        tps = np.cumsum([r[1] for r in records])
        fps = np.cumsum([not r[1] for r in records])
        recall = tps / n_gt
        precision = tps / np.maximum(tps + fps, 1e-9)
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11
        aps.append(float(ap))
    return float(np.mean(aps)) if aps else 0.0
