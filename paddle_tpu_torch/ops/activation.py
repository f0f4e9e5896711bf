"""Activation ops (paddle_tpu/ops/activation.py). Where torch has the
function with the JAX op's formula it is one call (``gelu`` exact or
tanh-approximate, ``softmax`` ...); otherwise the JAX op's formula."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ._dispatch import defop
from ..core import rng as _rng
from ..core.flop_count import uncounted
from ..core.dtype import as_float

__all__ = ["relu", "relu6", "leaky_relu", "prelu", "elu", "selu", "celu",
           "gelu", "sigmoid", "hardsigmoid", "hardswish", "hardtanh",
           "hardshrink", "softshrink", "tanhshrink", "silu", "swish", "mish",
           "softplus", "softsign", "softmax", "log_softmax", "log_sigmoid",
           "gumbel_softmax", "maxout", "thresholded_relu", "glu",
           "normalize"]


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


@defop
def relu(x):
    return torch.relu(x)


@defop
def relu6(x):
    return tF.relu6(as_float(x))


@defop
def leaky_relu(x, negative_slope=0.01):
    return tF.leaky_relu(as_float(x), negative_slope)


@defop
def prelu(x, weight):
    return torch.where(torch.ge(x, 0), x, torch.mul(weight, x))


@defop
def elu(x, alpha=1.0):
    return tF.elu(as_float(x), alpha)


@defop
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return torch.mul(torch.where(torch.gt(x, 0), x,
                                 torch.mul(torch.expm1(x), alpha)), scale)


@defop
def celu(x, alpha=1.0):
    return tF.celu(as_float(x), alpha)


@defop
def gelu(x, approximate=False):
    x = as_float(x)
    out = tF.gelu(x, approximate="tanh" if approximate else "none")
    if x.device.type == "cpu" and not approximate:
        # torch's vectorized CPU kernel gives nan for +inf (a lone +inf
        # gives inf); jax.nn.gelu gives inf, as the card does (ROADMAP
        # Queue 3 C7). Not counted by paddle.flops: the card has no such
        # step
        with uncounted():
            out = torch.where(x == math.inf, x, out)
    return out


@defop
def sigmoid(x):
    return torch.sigmoid(x)


@defop
def hardsigmoid(x, slope=0.1666667, offset=0.5):
    return torch.clamp(torch.add(torch.mul(x, slope), offset), 0.0, 1.0)


@defop
def hardswish(x):
    return torch.mul(x, torch.clamp(torch.add(torch.div(x, 6.0), 0.5),
                                    0.0, 1.0))


@defop
def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002
    return torch.clamp(x, min, max)


@defop
def hardshrink(x, threshold=0.5):
    x = as_float(x)
    return torch.where(torch.gt(torch.abs(x), threshold), x, _zero(x))


@defop
def softshrink(x, threshold=0.5):
    return torch.where(torch.gt(x, threshold), torch.sub(x, threshold),
                       torch.where(torch.lt(x, -threshold),
                                   torch.add(x, threshold), _zero(x)))


@defop
def tanhshrink(x):
    return torch.sub(x, torch.tanh(x))


@defop
def silu(x):
    return tF.silu(x)


swish = silu


@defop
def mish(x):
    x = as_float(x)
    return torch.mul(x, torch.tanh(tF.softplus(x)))


@defop
def softplus(x, beta=1.0, threshold=20.0):
    bx = torch.mul(x, beta)
    safe = torch.div(torch.log1p(torch.exp(torch.clamp_max(bx, threshold))),
                     beta)
    return torch.where(torch.gt(bx, threshold), x, safe)


@defop
def softsign(x):
    return tF.softsign(x)


@defop
def softmax(x, axis=-1):
    return torch.softmax(as_float(x), axis)


@defop
def log_softmax(x, axis=-1):
    return torch.log_softmax(as_float(x), axis)


@defop
def log_sigmoid(x):
    return tF.logsigmoid(as_float(x))


@defop
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1):
    u = torch.rand(x.shape, generator=_rng.generator(x.device),
                   dtype=x.dtype, device=x.device)
    g = torch.neg(torch.log(torch.neg(torch.log(u.clamp_min(1e-20)))))
    y = torch.softmax(torch.div(torch.add(x, g), temperature), axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = torch.add(y_hard, torch.sub(y, y.detach()))   # straight-through
    return y


@defop
def maxout(x, groups, axis=1):
    axis = axis % x.ndim
    shape = list(x.shape)
    shape[axis] = shape[axis] // groups
    shape.insert(axis + 1, groups)
    return torch.amax(torch.reshape(x, shape), dim=axis + 1)


@defop
def thresholded_relu(x, threshold=1.0):
    x = as_float(x)
    return torch.where(torch.gt(x, threshold), x, _zero(x))


@defop
def glu(x, axis=-1):
    a, b = torch.chunk(x, 2, dim=axis)
    return torch.mul(a, torch.sigmoid(b))


@defop
def normalize(x, p=2, axis=1, epsilon=1e-12):
    x = as_float(x)
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return torch.div(x, torch.clamp_min(n, epsilon))
