"""Pooling layers (paddle_tpu/nn/layer/pooling.py): the max, average and
adaptive pools in 1-D, 2-D and 3-D over ``functional``'s pool ops, and
the fluid-era ``Pool2D``. ``return_mask`` is accepted and not applied,
as in the JAX layers (``ops.max_pool2d_with_index`` gives the indices).
"""
from __future__ import annotations

from ... import ops
from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool1D", "MaxPool2D", "AvgPool1D", "AvgPool2D",
           "AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "AvgPool3D", "MaxPool3D"]


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, **self.args)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.args = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, **self.args)


class MaxPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, name=None):
        super().__init__()
        self.args = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode)

    def forward(self, x):
        return F.max_pool1d(x, **self.args)


class AvgPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        x4 = ops.unsqueeze(x, 2)
        out = F.avg_pool2d(x4, (1, self.kernel_size),
                           stride=(1, self.stride or self.kernel_size),
                           padding=(0, self.padding), ceil_mode=self.ceil_mode,
                           exclusive=self.exclusive)
        return ops.squeeze(out, 2)


class AvgPool3D(Layer):
    """reference operators/pool_op.cc pool3d (avg); NCDHW."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None):
        super().__init__()
        self.args = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)

    def forward(self, x):
        return F.avg_pool3d(x, **self.args)


class MaxPool3D(Layer):
    """reference operators/pool_op.cc pool3d (max); NCDHW."""

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCDHW", name=None):
        super().__init__()
        self.args = dict(kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode,
                         data_format=data_format)

    def forward(self, x):
        return F.max_pool3d(x, **self.args)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size)


class Pool2D(Layer):
    """fluid-era pooling layer (reference fluid/dygraph/nn.py Pool2D)."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, ceil_mode=False,
                 exclusive=True, data_format="NCHW", name=None):
        super().__init__()
        self.args = dict(pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling, ceil_mode=ceil_mode)
        self.exclusive = exclusive

    def forward(self, x):
        a = self.args
        size = x.shape[2:] if a["global_pooling"] else a["pool_size"]
        stride = a["pool_stride"] if not a["global_pooling"] else size
        if a["pool_type"] == "max":
            return F.max_pool2d(x, size, stride=stride,
                                padding=a["pool_padding"],
                                ceil_mode=a["ceil_mode"])
        return F.avg_pool2d(x, size, stride=stride,
                            padding=a["pool_padding"],
                            ceil_mode=a["ceil_mode"],
                            exclusive=self.exclusive)


__all__ += ["AdaptiveAvgPool1D", "AdaptiveMaxPool1D", "AdaptiveAvgPool3D",
            "AdaptiveMaxPool3D", "Pool2D"]
