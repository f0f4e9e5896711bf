"""LayerNorm (paddle_tpu/nn/layer/norm.py): biased variance over the last
axis, epsilon 1e-5, unit weight and zero bias at init."""
from __future__ import annotations

import torch

__all__ = ["LayerNorm"]


class LayerNorm(torch.nn.LayerNorm):
    def __init__(self, normalized_shape, epsilon=1e-5, device=None,
                 dtype=None):
        super().__init__(normalized_shape, eps=epsilon, device=device,
                         dtype=dtype)
