"""Normalization, dropout and embedding ops (paddle_tpu/ops/norm_ops.py).

``layer_norm`` is torch's fused layer norm over the axes from
``begin_norm_axis`` on (biased variance, as the JAX formula);
``batch_norm`` keeps the JAX op's functional contract (running stats in,
updated stats out, variance as E[x²] - E[x]² in both the normalization and
the update); ``dropout`` is torch's fused dropout kernel, drawing from the
device's default generator (``paddle.seed`` seeds it). ``embedding`` is
the dense lookup; ``_sparse_embedding`` the eager lookup of
``functional.embedding(sparse=True)`` on a trainable table, whose
backward gives the table a sparse COO gradient of the looked-up rows
(``core/selected_rows.py``; the ``padding_idx`` rows stay in it with
zero values, as the JAX tape's SelectedRows keeps them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from ._dispatch import defop

__all__ = ["layer_norm", "batch_norm", "instance_norm", "group_norm",
           "rms_norm", "dropout", "embedding", "local_response_norm",
           "data_norm", "l2_normalize", "lrn"]


@defop
def layer_norm(x, weight=None, bias=None, epsilon=1e-05, begin_norm_axis=-1):
    begin = begin_norm_axis % x.ndim
    return tF.layer_norm(x, tuple(x.shape[begin:]), weight, bias, epsilon)


def _sync_moments(mean, mean_sq, axis):
    """(mean, E[x^2]) averaged over ``axis`` in one all-reduce, where a
    region binds it."""
    from ..distributed import mesh as mesh_mod
    if not mesh_mod.in_spmd_region(axis) \
            or mesh_mod.mesh_axis_size(axis) == 1:
        return mean, mean_sq
    from ..distributed.collective import (ReduceOp, _allreduce_raw,
                                          copy_to_region)
    both = _allreduce_raw.raw(torch.stack([mean, mean_sq]), axis,
                              ReduceOp.AVG)
    both = copy_to_region(both, axis)
    return both[0], both[1]


def _bshape(x, c_axis):
    shape = [1] * x.ndim
    shape[c_axis] = -1
    return shape


@defop
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", sync_axis=None):
    """Returns (out, new_running_mean, new_running_var). ``sync_axis``
    (inside a region over it): the moments averaged over the axis's ranks
    (synchronized batch norm) by the differentiable all-reduce, then
    consumed by each rank as its own (``collective.copy_to_region``)."""
    c_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != c_axis)
    bshape = _bshape(x, c_axis)
    if training:
        mean = torch.mean(x, dim=axes)
        mean_sq = torch.mean(torch.square(x), dim=axes)
        if sync_axis is not None:
            mean, mean_sq = _sync_moments(mean, mean_sq, sync_axis)
        var = torch.sub(mean_sq, torch.square(mean))
        new_rm = torch.add(torch.mul(running_mean, momentum),
                           torch.mul(mean, 1 - momentum))
        new_rv = torch.add(torch.mul(running_var, momentum),
                           torch.mul(var, 1 - momentum))
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    out = torch.mul(torch.sub(x, torch.reshape(mean, bshape)),
                    torch.rsqrt(torch.add(torch.reshape(var, bshape),
                                          epsilon)))
    if weight is not None:
        out = torch.mul(out, torch.reshape(weight, bshape))
    if bias is not None:
        out = torch.add(out, torch.reshape(bias, bshape))
    return out, new_rm, new_rv


def _affine(out, weight, bias):
    shape = (1, -1) + (1,) * (out.ndim - 2)
    if weight is not None:
        out = torch.mul(out, torch.reshape(weight, shape))
    if bias is not None:
        out = torch.add(out, torch.reshape(bias, shape))
    return out


@defop
def instance_norm(x, weight=None, bias=None, epsilon=1e-05):
    axes = tuple(range(2, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    out = torch.mul(torch.sub(x, mean), torch.rsqrt(torch.add(var, epsilon)))
    return _affine(out, weight, bias)


@defop
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-05,
               data_format="NCHW"):
    n, c = x.shape[0], x.shape[1]
    xg = torch.reshape(x, (n, num_groups, c // num_groups, *x.shape[2:]))
    axes = tuple(range(2, xg.ndim))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.var(xg, dim=axes, keepdim=True, correction=0)
    out = torch.reshape(torch.mul(torch.sub(xg, mean),
                                  torch.rsqrt(torch.add(var, epsilon))),
                        x.shape)
    return _affine(out, weight, bias)


@defop
def rms_norm(x, weight=None, epsilon=1e-06):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = torch.mul(x, torch.rsqrt(torch.add(var, epsilon)))
    return out if weight is None else torch.mul(out, weight)


@defop(name="dropout_op")
def _dropout(x, p, mode):
    keep = 1.0 - p
    if keep <= 0.0:                     # p = 1: drop everything
        return torch.zeros_like(x)
    out = tF.dropout(x, p=p, training=True)
    if mode == "upscale_in_train":
        return out
    return torch.mul(out, keep)         # downscale_in_infer: no upscale


def dropout(x, p=0.5, training=True, mode="upscale_in_train", axis=None):
    """Identity when not training or p == 0 (no op recorded)."""
    if not training or p == 0.0:
        return x
    return _dropout(x, p=float(p), mode=mode)


@defop
def embedding(weight, ids, padding_idx=None, sparse=False):
    out = tF.embedding(ids, weight)
    if padding_idx is not None:
        if padding_idx < 0:
            padding_idx = weight.shape[0] + padding_idx
        keep = torch.ne(ids, padding_idx).unsqueeze(-1).to(out.dtype)
        out = torch.mul(out, keep)
    return out


class _SparseLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        out = tF.embedding(ids, weight)
        keep = None
        if padding_idx is not None:
            keep = torch.ne(ids, padding_idx).unsqueeze(-1).to(out.dtype)
            out = torch.mul(out, keep)
        ctx.save_for_backward(ids)
        ctx.keep = keep
        ctx.shape = weight.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if ctx.keep is not None:
            g = torch.mul(g, ctx.keep)
        vals = g.reshape(-1, ctx.shape[-1])
        return torch.sparse_coo_tensor(ids.reshape(1, -1), vals, ctx.shape,
                                       is_coalesced=False), None, None


def _sparse_embedding(weight, ids, padding_idx=None):
    """The rows of ``weight`` at ``ids``; ``weight``'s gradient is sparse
    (the looked-up rows only, never dense)."""
    if padding_idx is not None and padding_idx < 0:
        padding_idx = weight.shape[0] + padding_idx
    from ._dispatch import wrap
    return wrap(_SparseLookup.apply(weight, ids, padding_idx))


@defop
def local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0):
    sq = torch.square(x)
    c = x.shape[1]
    half = size // 2
    pads = [0, 0] * (x.ndim - 2) + [half, size - 1 - half]
    padded = tF.pad(sq, pads)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = torch.add(acc, padded[:, i:i + c])
    return torch.div(x, torch.pow(torch.add(torch.mul(acc, alpha), k), beta))


@defop
def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4):
    means = torch.div(batch_sum, batch_size)
    var = torch.sub(torch.div(batch_square_sum, batch_size),
                    torch.square(means))
    scales = torch.reciprocal(torch.sqrt(torch.add(var, epsilon)))
    return torch.mul(torch.sub(x, means), scales)


@defop
def l2_normalize(x, axis=-1, epsilon=1e-12):
    n = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return torch.div(x, torch.clamp_min(n, epsilon))


def lrn(x, n=5, k=1.0, alpha=1e-4, beta=0.75, data_format="NCHW"):
    return local_response_norm(x, size=n, alpha=alpha, beta=beta, k=k)
