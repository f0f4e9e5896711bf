"""Comparison, logical and predicate ops (paddle_tpu/ops/logic.py;
``allclose`` is the op of paddle_tpu/ops/math_extra.py, which the JAX
registry holds under that name). Every output is bool (``allclose`` and
``equal_all`` a 0-d one) and carries no gradient."""
from __future__ import annotations

import torch

from ._dispatch import defop, wrap

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "isnan", "isinf", "isfinite",
           "isclose", "allclose", "equal_all", "is_empty"]


def _cmp(fn, flipped, x, y):
    """fn(x, y) where x may be a Python scalar (then flipped(y, x))."""
    if isinstance(x, torch.Tensor):
        return fn(x, y)
    return flipped(y, x)


def _t(v, like):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, device=like.device)


@defop
def equal(x, y):
    return _cmp(torch.eq, torch.eq, x, y)


@defop
def not_equal(x, y):
    return _cmp(torch.ne, torch.ne, x, y)


@defop
def greater_than(x, y):
    return _cmp(torch.gt, torch.lt, x, y)


@defop
def greater_equal(x, y):
    return _cmp(torch.ge, torch.le, x, y)


@defop
def less_than(x, y):
    return _cmp(torch.lt, torch.gt, x, y)


@defop
def less_equal(x, y):
    return _cmp(torch.le, torch.ge, x, y)


@defop
def logical_and(x, y):
    return torch.logical_and(x, _t(y, x))


@defop
def logical_or(x, y):
    return torch.logical_or(x, _t(y, x))


@defop
def logical_xor(x, y):
    return torch.logical_xor(x, _t(y, x))


@defop
def logical_not(x):
    return torch.logical_not(x)


@defop
def bitwise_and(x, y):
    return torch.bitwise_and(x, y)


@defop
def bitwise_or(x, y):
    return torch.bitwise_or(x, y)


@defop
def bitwise_xor(x, y):
    return torch.bitwise_xor(x, y)


@defop
def bitwise_not(x):
    return torch.bitwise_not(x)


@defop
def isnan(x):
    return torch.isnan(x)


@defop
def isinf(x):
    return torch.isinf(x)


@defop
def isfinite(x):
    return torch.isfinite(x)


@defop
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(x, _t(y, x), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@defop
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.as_tensor(torch.allclose(x, _t(y, x), rtol=rtol, atol=atol,
                                          equal_nan=equal_nan),
                           device=x.device)


def equal_all(x, y):
    return wrap(torch.as_tensor(tuple(x.shape) == tuple(y.shape)
                                and bool(torch.equal(x, y)),
                                device=x.device))


@defop
def is_empty(x):
    return torch.as_tensor(x.numel() == 0)
