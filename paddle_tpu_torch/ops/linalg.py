"""The matmul family of paddle_tpu/ops/linalg.py: ``matmul``, ``dot``,
``bmm``, ``mv``, ``outer``, ``inner``, ``cross``, ``norm``, ``p_norm``,
``dist``, ``multi_dot`` and ``einsum``. The decompositions and solvers
(cholesky, inverse, svd, qr, eigh, solve ...) and ``histogram`` are not
ported yet (ROADMAP Queue 1 item 9). A bf16 product accumulates in f32 on
the card's tensor cores, as the JAX op asks with
``FLAGS_use_bf16_matmul``."""
from __future__ import annotations

import torch

from ._dispatch import defop

__all__ = ["matmul", "dot", "bmm", "mv", "outer", "inner", "cross", "norm",
           "p_norm", "dist", "multi_dot", "einsum"]


@defop
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.ndim > 1:
        x = torch.swapaxes(x, -1, -2)
    if transpose_y and y.ndim > 1:
        y = torch.swapaxes(y, -1, -2)
    return torch.matmul(x, y)


@defop
def dot(x, y):
    return torch.sum(torch.mul(x, y), dim=-1)


@defop
def bmm(x, y):
    return torch.matmul(x, y)


@defop
def mv(x, vec):
    return torch.matmul(x, vec)


@defop
def outer(x, y):
    return torch.outer(torch.reshape(x, (-1,)), torch.reshape(y, (-1,)))


@defop
def inner(x, y):
    return torch.inner(x, y)


@defop
def cross(x, y, axis=None):
    return torch.linalg.cross(x, y, dim=-1 if axis is None else axis)


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


@defop
def norm(x, p="fro", axis=None, keepdim=False):
    ax = _axes(axis)
    if p == "fro":
        if axis is None:
            return torch.sqrt(torch.sum(torch.square(x)))
        return torch.sqrt(torch.sum(torch.square(x), dim=ax,
                                    keepdim=keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=() if ax is None else ax,
                          keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=() if ax is None else ax,
                          keepdim=keepdim)
    if p == 0:
        return torch.sum(torch.ne(x, 0).to(x.dtype), dim=ax, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=ax,
                               keepdim=keepdim), 1.0 / p)


@defop
def p_norm(x, porder=2.0, axis=-1, keepdim=False, epsilon=1e-12):
    return torch.pow(torch.add(torch.sum(torch.pow(torch.abs(x), porder),
                                         dim=axis, keepdim=keepdim),
                               epsilon), 1.0 / porder)


@defop
def dist(x, y, p=2.0):
    d = torch.abs(torch.sub(x, y))
    if p == 0:
        return torch.sum(torch.ne(d, 0).to(x.dtype))
    if p == float("inf"):
        return torch.amax(d)
    if p == float("-inf"):
        return torch.amin(d)
    return torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)


@defop
def multi_dot(*xs):
    return torch.linalg.multi_dot(xs)


@defop
def einsum(equation, *operands):
    return torch.einsum(equation, *operands)
