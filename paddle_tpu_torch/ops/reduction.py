"""Reduction ops (paddle_tpu/ops/reduction.py).

``axis`` is None (every axis), an int or a list of ints; ``keepdim``
keeps the reduced axes as size 1, for ``axis=None`` too. ``max`` and
``min`` return a tensor (Paddle's meaning), and ``median`` averages the
two middle values of an even count, as ``jnp.median``.
"""
from __future__ import annotations

import builtins

import torch

from ._dispatch import defop
from ..core.dtype import as_float, to_torch_dtype

__all__ = ["sum", "mean", "max", "min", "amax", "amin", "prod", "logsumexp",
           "argmax", "argmin", "all", "any", "std", "var", "median",
           "quantile", "nansum", "nanmean", "count_nonzero", "mode",
           "kthvalue"]


def _dims(x, axis):
    """``axis`` as torch's ``dim`` argument: a tuple of every axis for
    None."""
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _moved_flat(x, axis):
    """(x with the reduced axes flattened into the last one, the axis to
    reduce, the shape that keepdim gives)."""
    dims = _dims(x, axis)
    dims = (dims,) if isinstance(dims, int) else dims
    dims = tuple(d % builtins.max(x.ndim, 1) for d in dims)
    keep_shape = tuple(1 if i in dims else s for i, s in enumerate(x.shape))
    rest = [i for i in range(x.ndim) if i not in dims]
    xm = x.permute(*rest, *dims) if x.ndim else x.reshape(1)
    xm = xm.reshape(*[x.shape[i] for i in rest], -1)
    return xm, keep_shape


@defop(name="sum")
def sum(x, axis=None, dtype=None, keepdim=False):  # noqa: A001
    out = torch.sum(x, dim=_dims(x, axis), keepdim=keepdim)
    return out.to(to_torch_dtype(dtype)) if dtype is not None else out


@defop
def mean(x, axis=None, keepdim=False):
    return torch.mean(as_float(x), dim=_dims(x, axis), keepdim=keepdim)


@defop(name="max")
def max(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@defop(name="min")
def min(x, axis=None, keepdim=False):  # noqa: A001
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@defop
def amax(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@defop
def amin(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@defop
def prod(x, axis=None, keepdim=False, dtype=None):
    xm, keep_shape = _moved_flat(x, axis)
    out = torch.prod(xm, -1)
    if keepdim:
        out = out.reshape(keep_shape)
    return out.to(to_torch_dtype(dtype)) if dtype is not None else out


@defop
def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


@defop
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmax(x, dim=axis, keepdim=keepdim)
    if axis is None and keepdim:
        out = out.reshape((1,) * x.ndim)
    return out.to(to_torch_dtype(dtype or "int64"))


@defop
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    out = torch.argmin(x, dim=axis, keepdim=keepdim)
    if axis is None and keepdim:
        out = out.reshape((1,) * x.ndim)
    return out.to(to_torch_dtype(dtype or "int64"))


@defop(name="all")
def all(x, axis=None, keepdim=False):  # noqa: A001
    return torch.all(x, dim=_dims(x, axis), keepdim=keepdim)


@defop(name="any")
def any(x, axis=None, keepdim=False):  # noqa: A001
    return torch.any(x, dim=_dims(x, axis), keepdim=keepdim)


@defop
def std(x, axis=None, unbiased=True, keepdim=False):
    x = as_float(x)
    return torch.std(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@defop
def var(x, axis=None, unbiased=True, keepdim=False):
    x = as_float(x)
    return torch.var(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@defop
def median(x, axis=None, keepdim=False):
    xm, keep_shape = _moved_flat(as_float(x), axis)
    out = torch.quantile(xm, 0.5, dim=-1)
    return out.reshape(keep_shape) if keepdim else out


@defop
def quantile(x, q, axis=None, keepdim=False):
    x = as_float(x)
    xm, keep_shape = _moved_flat(x, axis)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = torch.quantile(xm, qt, dim=-1)
    if keepdim:
        out = out.reshape(*qt.shape, *keep_shape)
    return out


@defop
def nansum(x, axis=None, keepdim=False):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim)


@defop
def nanmean(x, axis=None, keepdim=False):
    return torch.nanmean(as_float(x), dim=_dims(x, axis), keepdim=keepdim)


@defop
def count_nonzero(x, axis=None, keepdim=False):
    return torch.sum(torch.ne(x, 0).to(torch.int64), dim=_dims(x, axis),
                     keepdim=keepdim)


@defop
def mode(x, axis=-1, keepdim=False):
    """Most frequent value along ``axis`` (ties: the smallest value) and
    its index, the JAX op's algorithm: a stable sort, run starts, each
    run's length, the earliest longest run; the index is that of the
    run's last element in sorted order."""
    ax = axis % x.ndim
    xm = torch.movedim(x, ax, -1)
    n = xm.shape[-1]
    xs, sort_idx = torch.sort(xm, dim=-1, stable=True)
    idxs = torch.arange(n, device=x.device)
    is_start = torch.cat(
        [torch.ones(xs.shape[:-1] + (1,), dtype=torch.bool,
                    device=x.device), torch.ne(xs[..., 1:], xs[..., :-1])],
        dim=-1)
    start = torch.cummax(torch.where(is_start, idxs, 0), dim=-1).values
    runlen = idxs - start + 1
    best = torch.argmax(runlen, dim=-1, keepdim=True)
    values = torch.take_along_dim(xs, best, dim=-1)
    indices = torch.take_along_dim(sort_idx, best, dim=-1)
    if keepdim:
        return torch.movedim(values, -1, ax), torch.movedim(indices, -1, ax)
    return values[..., 0], indices[..., 0]


@defop
def kthvalue(x, k, axis=-1, keepdim=False):
    idx = torch.argsort(x, dim=axis, stable=True)
    pos = torch.narrow(idx, axis, k - 1, 1)
    val = torch.take_along_dim(x, pos, dim=axis)
    if not keepdim:
        val, pos = val.squeeze(axis), pos.squeeze(axis)
    return val, pos.to(torch.int64)
