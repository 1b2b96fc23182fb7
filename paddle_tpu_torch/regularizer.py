"""Weight-decay regularizers appended as in-step gradient transforms
(PyTorch port of ``paddle_tpu/regularizer.py``): ``Optimizer.minimize``
appends a ``regularize`` op per parameter that adds ``grad_term(param)``
to its gradient before clipping and the update.  A parameter's own
``ParamAttr(regularizer=...)`` wins over the optimizer's."""
from __future__ import annotations

import torch


class WeightDecayRegularizer:
    def grad_term(self, param):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def grad_term(self, param):
        return self.coeff * param


class L1Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def grad_term(self, param):
        return self.coeff * torch.sign(param)


L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay
