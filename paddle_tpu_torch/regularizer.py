"""Weight-decay regularizers (paddle_tpu/regularizer.py): objects whose
``grad_term(param)`` the optimizer adds to a parameter's gradient before
clipping and the update rule (``Optimizer.apply_gradients_pure``)."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def grad_term(self, param_value):
        return self.coeff * torch.sign(param_value)


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def grad_term(self, param_value):
        return self.coeff * param_value
