"""Traffic-speed forecasting over several horizons (PyTorch port of
``paddle_tpu/models/traffic.py``; ref: v1_api_demo/traffic_prediction/
trainer_config.py): a road link's past ``term_num`` readings classify its
speed class at each of ``forecasting_num`` future horizons.  One shared
link encoder (``link_vec.w``) feeds one [emb -> horizons * classes] head
reshaped to [N, horizons, classes], one softmax cross entropy over the
horizon axis, as the JAX package builds it."""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr


def build(link_encode, labels, term_num: int = 24, forecasting_num: int = 24,
          emb_size: int = 16, num_classes: int = 4):
    """link_encode: [N, term_num] past readings; labels: [N,
    forecasting_num] int32 speed classes.  Returns (loss, avg_acc, scores
    [N, F, C])."""
    if int(link_encode.shape[-1]) != term_num:
        raise ValueError(f"link_encode width {link_encode.shape[-1]} != "
                         f"term_num {term_num}")
    vec = layers.fc(link_encode, emb_size,
                    param_attr=ParamAttr(name="link_vec.w"))
    heads = layers.fc(vec, forecasting_num * num_classes, bias_attr=True)
    logits = layers.reshape(heads, [0, forecasting_num, num_classes])
    lab3 = layers.reshape(labels, [0, forecasting_num, 1])
    ce, scores = layers.softmax_with_cross_entropy(logits, lab3,
                                                   return_softmax=True)
    loss = layers.mean(ce)
    pred_flat = layers.reshape(scores, [-1, num_classes])
    lab_flat = layers.reshape(lab3, [-1, 1])
    acc = layers.accuracy(pred_flat, lab_flat)
    return loss, acc, scores
