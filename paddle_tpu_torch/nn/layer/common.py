"""Common layers: Linear, Embedding, Dropout
(paddle_tpu/nn/layer/common.py).

Layout differs from the JAX package in one place: the JAX ``Linear``
keeps its weight as [in, out] and computes ``x @ W``; these keep torch's
[out, in] and compute ``x @ W.T``. ``paddle_tpu_torch.bridge`` transposes
Linear weights, and only those, when it copies JAX parameters across.
"""
from __future__ import annotations

import torch

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(torch.nn.Linear):
    """y = x @ W.T + b, W [out, in]."""


class Embedding(torch.nn.Embedding):
    """Row lookup in a [num_embeddings, dim] table (not transposed)."""


class Dropout(torch.nn.Dropout):
    """Upscale-in-train dropout; identity in eval mode."""
