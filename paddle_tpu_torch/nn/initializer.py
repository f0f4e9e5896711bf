"""Weight initializers (paddle_tpu/nn/initializer.py).

An initializer is called with a shape and a dtype and returns the initial
value, a CPU tensor drawn from an explicit generator: the port's default
one (``core/rng.py``, which ``paddle.seed`` restarts) unless the call
passes its own. Draws are made on the CPU and in float32 (then cast), so
one seed gives the same parameters on every device. The numbers are not
the JAX package's: its ``jax.random`` bits have no torch counterpart.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng as _rng
from ..core.dtype import to_torch_dtype

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "calculate_gain"]


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv2d": 1.0,
             "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4.0}
    return gains[nonlinearity]


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    # conv weight OIHW: fan_in = C_in * k*k, fan_out = C_out * k*k
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype="float32", generator=None):
        out = self._draw(tuple(int(s) for s in shape),
                         generator or _rng.generator("cpu"))
        return out.to(to_torch_dtype(dtype) or torch.float32)

    def _draw(self, shape, g):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, g):
        return torch.full(shape, float(self.value))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _draw(self, shape, g):
        return torch.empty(shape).uniform_(self.low, self.high, generator=g)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, g):
        return torch.empty(shape).normal_(self.mean, self.std, generator=g)


class TruncatedNormal(Initializer):
    """N(mean, std) truncated at two standard deviations."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, g):
        out = torch.empty(shape)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=g)
        return out * self.std + self.mean


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, g):
        fi, fo = _fans(shape)
        limit = self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                             + (self.fan_out or fo)))
        return torch.empty(shape).uniform_(-limit, limit, generator=g)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, g):
        fi, fo = _fans(shape)
        std = self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                           + (self.fan_out or fo)))
        return torch.empty(shape).normal_(0.0, std, generator=g)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, g):
        fi = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return torch.empty(shape).uniform_(-limit, limit, generator=g)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, g):
        fi = self.fan_in or _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return torch.empty(shape).normal_(0.0, gain / math.sqrt(fi),
                                          generator=g)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _draw(self, shape, g):
        v = self.value
        arr = v.detach().cpu().float() if isinstance(v, torch.Tensor) \
            else torch.from_numpy(np.asarray(v, dtype=np.float32))
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"Assign shape {tuple(arr.shape)} != param "
                             f"shape {shape}")
        return arr.clone()
