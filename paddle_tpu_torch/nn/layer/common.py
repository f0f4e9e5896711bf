"""Common layers (paddle_tpu/nn/layer/common.py): Linear, Embedding, the
dropouts, Identity, Flatten, the Pad layers, Bilinear and the two
distances.

``Linear`` keeps the JAX package's layout: weight [in, out], y = x @ W + b
(``functional.linear``). Each forward is the functional op, whose AMP
cast point is the JAX op's. ``Dropout2D`` / ``Dropout3D`` are the JAX
layer's: elementwise dropout, as ``Dropout`` (the channelwise forms are
``functional.dropout2d`` / ``dropout3d``). The layers over the conv ops:
``Upsample`` and its two fixed-mode forms (``interpolate``, which is
``jax.image.resize``: ``align_corners`` is kept and ignored),
``PixelShuffle``, ``Unfold`` and ``RowConv``. TreeConv and
BilinearTensorProduct, over item 9's ops, wait for ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import torch

from ... import ops
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
           "AlphaDropout", "Flatten", "Pad1D", "Pad2D", "Pad3D", "Identity",
           "Bilinear", "CosineSimilarity", "PairwiseDistance", "Upsample",
           "UpsamplingBilinear2D", "UpsamplingNearest2D", "PixelShuffle",
           "Unfold", "RowConv"]


class Identity(Layer):
    def forward(self, x):
        return x


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


class Dropout2D(Dropout):
    pass


class Dropout3D(Dropout):
    pass


class AlphaDropout(Layer):
    """SELU-preserving dropout (``functional.alpha_dropout``); identity in
    eval mode."""

    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return ops.flatten(x, self.start_axis, self.stop_axis)


class _PadN(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format=None):
        super().__init__()
        self._pad = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 2
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, list(self._pad), mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW"):
        if isinstance(padding, int):
            padding = [padding] * 4
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadN):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        if isinstance(padding, int):
            padding = [padding] * 6
        super().__init__(padding, mode, value, data_format)


class Bilinear(Layer):
    """out[b, o] = x1[b] W[o] x2[b] + bias[o], W [out, in1, in2]
    (Xavier-uniform)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter([out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PairwiseDistance(Layer):
    """The p-norm of |x - y| + epsilon over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        d = ops.abs(ops.add(x, ops.scale(y, -1.0)))
        d = ops.add(d, ops.full_like(d, self.epsilon))
        return ops.norm(d, p=self.p, axis=-1, keepdim=self.keepdim)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "bilinear", True, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, "nearest", False, data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW"):
        super().__init__()
        self.factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.factor)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class RowConv(Layer):
    """The lookahead conv of DeepSpeech 2 (``ops.row_conv``): weight
    [future_context_size + 1, num_channels], Xavier-normal."""

    def __init__(self, num_channels, future_context_size, param_attr=None):
        super().__init__()
        self.weight = self.create_parameter(
            [future_context_size + 1, num_channels], attr=param_attr,
            default_initializer=I.XavierNormal())

    def forward(self, x):
        return ops.row_conv(x, self.weight)
