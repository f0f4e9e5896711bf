"""Common layers: Linear, Embedding, Dropout
(paddle_tpu/nn/layer/common.py).

Layout differs from the JAX package in one place: the JAX ``Linear``
keeps its weight as [in, out] and computes ``x @ W``; these keep torch's
[out, in] and compute ``x @ W.T``. ``paddle_tpu_torch.bridge`` transposes
Linear weights, and only those, when it copies JAX parameters across.
Each forward is the functional op with its AMP cast point
(``functional.amp_op``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .. import functional as F

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(torch.nn.Linear):
    """y = x @ W.T + b, W [out, in]."""

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(torch.nn.Embedding):
    """Row lookup in a [num_embeddings, dim] table (not transposed)."""

    def forward(self, x):
        weight, x = F.amp_op("embedding", self.weight, x)
        return tF.embedding(x, weight)


class Dropout(torch.nn.Dropout):
    """Upscale-in-train dropout; identity in eval mode."""

    def forward(self, x):
        return F.dropout(x, self.p, self.training)
