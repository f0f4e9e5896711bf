"""Common layers: Linear, Embedding, Dropout (paddle_tpu/nn/layer/common.py).

``Linear`` keeps the JAX package's layout: weight [in, out], y = x @ W + b
(``functional.linear``). Each forward is the functional op, whose AMP
cast point is the JAX op's.
"""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """y = x @ W + b, W [in_features, out_features] (Xavier-uniform), b
    [out_features] (zeros); ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform())
        self.bias = self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.weight.shape[0]}, out={self.weight.shape[1]}"


class Embedding(Layer):
    """Row lookup in a [num_embeddings, dim] table (N(0, 1) at init; the
    ``padding_idx`` row zero, and zero in every lookup)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)


class Dropout(Layer):
    """Upscale-in-train dropout (``mode`` as the JAX layer); identity in
    eval mode."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training, mode=self.mode)
