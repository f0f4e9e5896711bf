"""Convolution layers (paddle_tpu/nn/layer/conv.py): Conv1D/2D/3D and
their transposes over ``functional``'s conv ops.

A conv layer's weight is OI<spatial> ([out, in / groups, k...]), a
transposed one's IO<spatial> ([in, out / groups, k...]), Kaiming-uniform
at a = sqrt(5) over fan_in = in * prod(k); the bias is uniform in
+-1 / sqrt(fan_in). The layers always create that layout, also under
``data_format="NHWC"``, where the op reads HWIO weights: so
``Conv2D(..., data_format="NHWC")`` raises in the forward, as the JAX
layer does (ROADMAP "Reference quirks").
"""
from __future__ import annotations

import numpy as np

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose",
           "Conv1DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False):
        super().__init__()
        if isinstance(kernel_size, int):
            kernel_size = (kernel_size,) * nd
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = in_channels * int(np.prod(kernel_size))
        if transpose:
            wshape = [in_channels, out_channels // groups] + list(kernel_size)
        else:
            wshape = [out_channels, in_channels // groups] + list(kernel_size)
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in,
                                                 negative_slope=np.sqrt(5.0),
                                                 nonlinearity="leaky_relu"))
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, stride=self._stride,
                        padding=self._padding, dilation=self._dilation,
                        groups=self._groups, data_format=self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True)
        self._output_padding = output_padding

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias,
                                  stride=self._stride, padding=self._padding,
                                  output_padding=self._output_padding,
                                  dilation=self._dilation, groups=self._groups,
                                  data_format=self._data_format)


class Conv1DTranspose(_ConvNd):
    """reference operators/conv_transpose_op.cc (1-D); weight IOK."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True)
        self._output_padding = output_padding

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias,
                                  stride=self._stride, padding=self._padding,
                                  output_padding=self._output_padding,
                                  dilation=self._dilation,
                                  groups=self._groups,
                                  data_format=self._data_format)


class Conv3DTranspose(_ConvNd):
    """reference operators/conv_transpose_op.cc (3-D); weight IODHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True)
        self._output_padding = output_padding

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias,
                                  stride=self._stride, padding=self._padding,
                                  output_padding=self._output_padding,
                                  dilation=self._dilation,
                                  groups=self._groups,
                                  data_format=self._data_format)
