"""SSD single-shot detector (PyTorch port of ``paddle_tpu/models/ssd.py``;
ref: the v1 detection stack, gserver/layers/PriorBox.cpp,
MultiBoxLossLayer.cpp, DetectionOutputLayer.cpp and
DetectionMAPEvaluator.cpp, assembled as the reference's SSD config does:
multi-scale feature maps, per-map loc / conf heads, the multibox matching
loss, decode + NMS output).

The small-backbone variant of the JAX package; the head and prior
plumbing scale with the backbone."""
from __future__ import annotations

from .. import layers


def _head(feat, k, channels, name):
    """3x3 conv head emitting [N, HW*K, channels] in (hw-major, k-inner)
    order, prior_box's layout."""
    out = layers.conv2d(feat, k * channels, 3, padding=1, name=name)
    n, _, h, w = out.shape
    out = layers.transpose(out, [0, 2, 3, 1])            # [N, H, W, K*C]
    return layers.reshape(out, [0, int(h) * int(w) * k, channels])


def build(img, gt_box, gt_label, num_classes: int = 4):
    """img: [N, 3, S, S]; gt_box: [N, G, 4] normalised corner boxes
    (0-padded); gt_label: [N, G] int (0 = padding).  Returns
    (loss, (loc, conf, prior, prior_var))."""
    x = layers.conv2d(img, 16, 3, padding=1, stride=2, bias_attr=False)
    x = layers.batch_norm(x, act="relu")
    x = layers.conv2d(x, 32, 3, padding=1, stride=2, bias_attr=False)
    f1 = layers.batch_norm(x, act="relu")                # stride 4
    x = layers.conv2d(f1, 64, 3, padding=1, stride=2, bias_attr=False)
    f2 = layers.batch_norm(x, act="relu")                # stride 8

    locs, confs, priors, pvars = [], [], [], []
    S = int(img.shape[2])  # prior_box takes pixel sizes: scale the fractions
    for i, (feat, mins, maxs) in enumerate(
            ((f1, [0.2 * S], [0.4 * S]), (f2, [0.5 * S], [0.8 * S]))):
        p, pv = layers.prior_box(feat, img, min_sizes=mins, max_sizes=maxs,
                                 aspect_ratios=(1.0,), clip=True)
        k = 2  # 1 aspect ratio + 1 max-size box
        locs.append(_head(feat, k, 4, name=f"ssd_loc{i}"))
        confs.append(_head(feat, k, num_classes, name=f"ssd_conf{i}"))
        priors.append(p)
        pvars.append(pv)

    loc = layers.concat(locs, axis=1)                    # [N, P, 4]
    conf = layers.concat(confs, axis=1)                  # [N, P, C]
    prior = layers.concat(priors, axis=0)                # [P, 4]
    prior_var = layers.concat(pvars, axis=0)
    loss = layers.mean(layers.ssd_loss(loc, conf, gt_box, gt_label,
                                       prior, prior_var))
    return loss, (loc, conf, prior, prior_var)


def infer(loc, conf, prior, prior_var, keep_top_k: int = 20):
    """Decode + NMS: returns (boxes [N, K, 4], scores [N, K], labels
    [N, K])."""
    return layers.detection_output(loc, conf, prior, prior_var,
                                   keep_top_k=keep_top_k)
