"""Tensor creation ops (paddle_tpu/ops/creation.py).

New tensors land on the current device (``device.get_device``: the card
unless ``set_device("cpu")``); the ``*_like`` ops follow their input.
Random draws come from the port's generator of that device
(``core/rng.py``): the same seed repeats a run, but the numbers are not
the JAX package's (its ``jax.random`` bits have no torch counterpart).
"""
from __future__ import annotations

import numpy as np
import torch

from ._dispatch import defop, wrap
from ..core import rng as _rng
from ..core.dtype import to_torch_dtype
from ..device import resolve_device

__all__ = ["zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
           "arange", "linspace", "logspace", "eye", "empty", "empty_like",
           "diag", "diagflat", "tril", "triu", "meshgrid", "uniform", "rand",
           "normal", "randn", "randint", "randperm", "bernoulli", "poisson",
           "multinomial", "standard_normal"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype="float32"):
    return wrap(torch.zeros(_shape(shape), dtype=to_torch_dtype(dtype),
                            device=resolve_device()))


def ones(shape, dtype="float32"):
    return wrap(torch.ones(_shape(shape), dtype=to_torch_dtype(dtype),
                           device=resolve_device()))


def full(shape, fill_value, dtype="float32"):
    return wrap(torch.full(_shape(shape), _scalar(fill_value),
                           dtype=to_torch_dtype(dtype),
                           device=resolve_device()))


@defop
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=to_torch_dtype(dtype))


@defop
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=to_torch_dtype(dtype))


@defop
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, _scalar(fill_value), dtype=to_torch_dtype(dtype))


def arange(start=0, end=None, step=1, dtype=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    td = to_torch_dtype(dtype)
    if td is None:
        td = torch.int64 if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) \
            else torch.float32
    return wrap(torch.arange(start, end, step, dtype=td,
                             device=resolve_device()))


def linspace(start, stop, num, dtype=None):
    return wrap(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)),
                               dtype=to_torch_dtype(dtype) or torch.float32,
                               device=resolve_device()))


def logspace(start, stop, num, base=10.0, dtype=None):
    return wrap(torch.logspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), base=base,
                               dtype=to_torch_dtype(dtype) or torch.float32,
                               device=resolve_device()))


def eye(num_rows, num_columns=None, dtype="float32"):
    m = num_rows if num_columns is None else num_columns
    return wrap(torch.eye(num_rows, m, dtype=to_torch_dtype(dtype),
                          device=resolve_device()))


def empty(shape, dtype="float32"):
    return zeros(shape, dtype)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype=dtype)


def diag(x, offset=0, padding_value=0):
    out = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        keep = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(keep, out, torch.full_like(out, padding_value))
    return wrap(out)


def diagflat(x, offset=0):
    return wrap(torch.diagflat(x, offset))


def tril(x, diagonal=0):
    from .manipulation import _tril
    return _tril(x, diagonal=diagonal)


def triu(x, diagonal=0):
    from .manipulation import _triu
    return _triu(x, diagonal=diagonal)


def meshgrid(*args):
    arrs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return tuple(wrap(torch.meshgrid(*arrs, indexing="ij")))


# -- random -----------------------------------------------------------------

def _gen(dev, seed=0):
    if seed:
        return torch.Generator(device=dev).manual_seed(int(seed))
    return _rng.generator(dev)


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0):  # noqa: A002
    dev = resolve_device()
    u = torch.rand(_shape(shape), generator=_gen(dev, seed),
                   dtype=to_torch_dtype(dtype), device=dev)
    return wrap(u * (_scalar(max) - _scalar(min)) + _scalar(min))


def rand(shape, dtype="float32"):
    return uniform(shape, dtype, 0.0, 1.0)


def normal(mean=0.0, std=1.0, shape=None):
    dev = resolve_device()
    z = torch.randn(_shape(shape if shape is not None else ()),
                    generator=_gen(dev), device=dev)
    return wrap(z * _scalar(std) + _scalar(mean))


def randn(shape, dtype="float32"):
    dev = resolve_device()
    return wrap(torch.randn(_shape(shape), generator=_gen(dev),
                            dtype=to_torch_dtype(dtype), device=dev))


def standard_normal(shape, dtype="float32"):
    return randn(shape, dtype)


def randint(low=0, high=None, shape=(1,), dtype="int64"):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return wrap(torch.randint(int(low), int(high), _shape(shape),
                              generator=_gen(dev),
                              dtype=to_torch_dtype(dtype), device=dev))


def randperm(n, dtype="int64"):
    dev = resolve_device()
    return wrap(torch.randperm(int(n), generator=_gen(dev),
                               dtype=to_torch_dtype(dtype), device=dev))


def bernoulli(x):
    return wrap(torch.bernoulli(x, generator=_gen(x.device)).to(x.dtype))


def poisson(x):
    return wrap(torch.poisson(x, generator=_gen(x.device)).to(x.dtype))


def multinomial(x, num_samples=1, replacement=False):
    """Draws from the rows of ``x`` (unnormalized probabilities); without
    replacement by the Gumbel top-k trick, as the JAX op."""
    g = _gen(x.device)
    logits = torch.log(torch.clamp_min(x.float(), 1e-30))
    if replacement:
        out = torch.multinomial(torch.softmax(logits, -1).reshape(
            -1, x.shape[-1]), num_samples, True, generator=g)
        out = out.reshape(*x.shape[:-1], num_samples)
    else:
        u = torch.rand(x.shape, generator=g, device=x.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out = torch.topk(logits + gumbel, num_samples, dim=-1).indices
    return wrap(out.to(torch.int64))
