"""Activation layers (paddle_tpu/nn/layer/activation.py): each forward is
the functional op of the same name, so it runs through the port's op with
its AMP cast point."""
from __future__ import annotations

from ... import ops
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "LeakyReLU", "PReLU", "ELU", "SELU", "CELU",
           "GELU", "Sigmoid", "Hardsigmoid", "Hardswish", "Hardtanh",
           "Hardshrink", "Softshrink", "Tanhshrink", "Silu", "Swish", "Mish",
           "Softplus", "Softsign", "Softmax", "LogSoftmax", "LogSigmoid",
           "Tanh", "ThresholdedReLU", "Maxout", "GLU"]


def _unary(fname, **defaults):
    """A layer class over the one-argument op ``fname``."""
    class _Act(Layer):
        def __init__(self, name=None, **kwargs):
            super().__init__()
            self.kwargs = {**defaults, **kwargs}

        def forward(self, x):
            return getattr(F, fname)(x, **self.kwargs)
    _Act.__name__ = _Act.__qualname__ = fname
    return _Act


ReLU = _unary("relu")
ReLU6 = _unary("relu6")
Sigmoid = _unary("sigmoid")
Tanh = _unary("tanh")
Silu = _unary("silu")
Swish = _unary("swish")
Mish = _unary("mish")
Softsign = _unary("softsign")
LogSigmoid = _unary("log_sigmoid")
Hardswish = _unary("hardswish")
Hardsigmoid = _unary("hardsigmoid")
Tanhshrink = _unary("tanhshrink")


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    """Learned negative slope: one (``num_parameters`` 1) or one per
    channel of axis 1."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        w = self.weight
        if w.shape[0] > 1 and x.ndim > 2:
            w = ops.reshape(w, [1, -1] + [1] * (x.ndim - 2))
        return F.prelu(x, w)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)
