"""The matmul family of paddle_tpu/ops/linalg.py: ``matmul``, ``dot``,
``bmm``, ``mv``, ``outer``, ``inner``, ``cross``, ``norm``, ``p_norm``,
``dist``, ``multi_dot`` and ``einsum``; the decompositions and solvers
(``cholesky`` ... ``lstsq``) and ``histogram``. A bf16 product
accumulates in f32 on the card's tensor cores, as the JAX op asks with
``FLAGS_use_bf16_matmul``.

The decompositions are torch.linalg's (cuSOLVER on the card). Where the
JAX op fixes a convention torch does not share, the port takes JAX's:
``matrix_rank``'s ``tol`` is an absolute bound on the singular values
(``jnp.linalg.matrix_rank(rtol=tol)``), its default ``max(s) * max(m, n)
* eps``; ``lstsq`` is jnp's SVD solve (cutoff ``rcond * s[0]``, default
``eps * max(m, n)``; residuals always returned) on every device, where
torch's CUDA lstsq (``gels``) gives no rank; ``qr(mode="r")`` gives R's
rows as a tuple, as the JAX op's ``tuple(...)`` over jnp's bare R does;
``histogram`` bins by ``searchsorted`` over ``linspace`` edges as
``jnp.histogram`` (float counts, the last edge closed).
"""
from __future__ import annotations

import torch

from ._dispatch import defop

__all__ = ["matmul", "dot", "bmm", "mv", "outer", "inner", "cross", "norm",
           "p_norm", "dist", "multi_dot", "einsum", "cholesky", "inverse",
           "pinv", "matrix_power", "det", "slogdet", "svd", "qr", "eigh",
           "eigvalsh", "matrix_rank", "solve", "triangular_solve", "lstsq",
           "histogram"]


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


# -- decompositions, solvers, histogram -----------------------------------

@defop
def cholesky(x, upper=False):
    L = torch.linalg.cholesky(x)
    return torch.swapaxes(L, -1, -2) if upper else L


@defop
def inverse(x):
    return torch.linalg.inv(x)


@defop
def pinv(x, rcond=1e-15):
    return torch.linalg.pinv(x, rtol=rcond)


@defop
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@defop
def det(x):
    return torch.linalg.det(x)


@defop
def slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return sign, logdet


@defop
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@defop
def qr(x, mode="reduced"):
    q, r = torch.linalg.qr(x, mode=mode)
    return tuple(r) if mode == "r" else (q, r)


@defop
def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO=UPLO)
    return w, v


@defop
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@defop
def matrix_rank(x, tol=None, hermitian=False):
    if x.ndim < 2:
        return torch.any(x != 0).to(torch.int32)
    s = torch.linalg.svdvals(x)
    if tol is None:
        bound = torch.amax(s, -1) * max(x.shape[-2:]) \
            * torch.finfo(s.dtype).eps
    else:
        bound = torch.as_tensor(tol, dtype=s.dtype, device=s.device)
    return torch.sum(s > bound[..., None], -1)


@defop
def solve(x, y):
    return torch.linalg.solve(x, y)


@defop
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    if transpose:
        x, upper = torch.swapaxes(x, -1, -2), not upper
    vec = y.ndim == 1
    out = torch.linalg.solve_triangular(x, y[:, None] if vec else y,
                                        upper=upper,
                                        unitriangular=unitriangular)
    return out[:, 0] if vec else out


@defop
def lstsq(x, y, rcond=None):
    m, n = x.shape
    b = y[:, None] if y.ndim == 1 else y
    eps = torch.finfo(x.dtype).eps
    cut = eps * max(m, n) if rcond is None else (eps if rcond < 0 else rcond)
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    mask = (s > 0) & (s >= cut * s[0])
    rank = torch.sum(mask)
    s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                        torch.zeros_like(s))[:, None]
    sol = vt.T @ (s_inv * (u.T @ b))
    resid = torch.sum(torch.square(b - x @ sol), 0)
    return (sol.reshape(-1) if y.ndim == 1 else sol), resid, rank, s


@defop
def histogram(x, bins=100, min=0, max=0):  # noqa: A002
    flat = x.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = torch.amin(flat), torch.amax(flat)
    else:
        lo = torch.as_tensor(min, dtype=flat.dtype, device=flat.device)
        hi = torch.as_tensor(max, dtype=flat.dtype, device=flat.device)
    flat_range = hi == lo              # jnp widens an empty range by 0.5
    lo, hi = torch.where(flat_range, lo - 0.5, lo), \
        torch.where(flat_range, hi + 0.5, hi)
    step = torch.arange(bins + 1, dtype=flat.dtype, device=flat.device) \
        / bins                         # jnp.linspace: lo (1 - s) + hi s
    edges = torch.where(step == 1, hi, lo * (1 - step) + hi * step)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=flat.dtype, device=flat.device)
    counts = counts.index_add(0, idx, torch.ones_like(flat))
    return counts[1:bins + 1]
