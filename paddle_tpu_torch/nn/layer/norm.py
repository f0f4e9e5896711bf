"""LayerNorm (paddle_tpu/nn/layer/norm.py): biased variance over the
trailing ``normalized_shape`` axes, epsilon 1e-5, unit weight and zero
bias at init."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape,
                                          attr=bias_attr, is_bias=True)

    def forward(self, x):
        begin = -len(self._normalized_shape)
        return F.layer_norm(x, self.weight, self.bias, self._epsilon,
                            begin_norm_axis=begin)
