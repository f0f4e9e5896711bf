"""LayerNorm (paddle_tpu/nn/layer/norm.py): biased variance over the last
axis, epsilon 1e-5, unit weight and zero bias at init."""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .. import functional as F

__all__ = ["LayerNorm"]


class LayerNorm(torch.nn.LayerNorm):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None):
        super().__init__(normalized_shape, eps=epsilon, device=device,
                         dtype=dtype)

    def forward(self, x):
        x, weight, bias = F.amp_op("layer_norm", x, self.weight, self.bias)
        return tF.layer_norm(x, self.normalized_shape, weight, bias,
                             self.eps)
