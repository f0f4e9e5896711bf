"""Shape, indexing and rearrangement ops (paddle_tpu/ops/manipulation.py).

Where torch returns a view (``reshape`` of a contiguous tensor,
``transpose``, ``split``, ``expand`` ...) the op returns it: no copy, as
XLA would fuse one away. ``unique``, ``unique_consecutive`` and
``nonzero`` have data-dependent sizes and run on the host (numpy), as the
JAX ops do, their result landing back on the input's device.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as tF

from ._dispatch import defop, wrap

__all__ = ["reshape", "transpose", "moveaxis", "swapaxes", "t", "concat",
           "stack", "split", "chunk", "unbind", "squeeze", "unsqueeze",
           "flatten", "expand", "expand_as", "broadcast_to", "tile", "flip",
           "roll", "rot90", "gather", "gather_nd", "index_select",
           "index_sample", "take_along_axis", "put_along_axis", "scatter",
           "scatter_nd_add", "scatter_nd", "where", "nonzero",
           "masked_select", "masked_fill", "pad", "topk", "sort", "argsort",
           "unique", "unique_consecutive", "diagonal", "repeat_interleave",
           "as_strided_slice", "slice", "strided_slice", "getitem",
           "setitem", "one_hot", "tensordot", "searchsorted", "bincount",
           "as_real", "as_complex", "crop", "unstack", "reverse",
           "space_to_depth", "shuffle_channel", "temporal_shift",
           "shard_index", "gather_tree", "pad_constant_like",
           "partial_concat", "partial_sum", "pad2d", "pad3d", "set_value"]


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


@defop
def reshape(x, shape):
    return torch.reshape(x, tuple(_int(s) for s in shape))


@defop
def transpose(x, perm=None):
    if perm is None:
        perm = tuple(reversed(range(x.ndim)))
    return torch.permute(x, tuple(int(p) for p in perm))


@defop
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@defop
def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


@defop
def t(x):
    return torch.permute(x, tuple(reversed(range(x.ndim))))


@defop(name="concat")
def _concat(*xs, axis=0):
    return torch.cat(xs, dim=axis)


def concat(x, axis=0):
    return _concat(*x, axis=_int(axis))


@defop(name="stack")
def _stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


def stack(x, axis=0):
    return _stack(*x, axis=axis)


@defop(name="split_op")
def _split(x, sections, axis):
    if isinstance(sections, int):
        if x.shape[axis] % sections:
            raise ValueError(f"split: axis {axis} of size {x.shape[axis]} "
                             f"does not divide into {sections} sections")
        return tuple(torch.split(x, x.shape[axis] // sections, dim=axis))
    return tuple(torch.split(x, list(sections), dim=axis))


def split(x, num_or_sections, axis=0):
    """Paddle's split: an int is a count of equal sections, a list holds
    section sizes (one of them may be -1, the rest)."""
    axis = _int(axis)
    if isinstance(num_or_sections, (list, tuple)):
        total = x.shape[axis]
        secs = [_int(s) for s in num_or_sections]
        known = builtins.sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else total - known for s in secs]
        return list(_split(x, secs, axis))
    return list(_split(x, int(num_or_sections), axis))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


@defop(name="unbind_op")
def _unbind(x, axis):
    return tuple(torch.unbind(x, dim=axis))


@defop
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(a for a in axis if x.shape[a] == 1)
    return torch.squeeze(x, axis) if axis else x.view_as(x)


@defop
def unsqueeze(x, axis):
    if isinstance(axis, int):
        axis = (axis,)
    nd = x.ndim + len(axis)
    for a in sorted(int(a) % nd for a in axis):
        x = torch.unsqueeze(x, a)
    return x


@defop
def flatten(x, start_axis=0, stop_axis=-1):
    if x.ndim == 0:
        return torch.reshape(x, (1,))
    return torch.flatten(x, start_axis, stop_axis)


@defop
def expand(x, shape):
    return x.expand(*[_int(s) for s in shape])


@defop
def expand_as(x, y):
    return x.expand(y.shape)


@defop
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(_int(s) for s in shape))


@defop
def tile(x, repeat_times):
    return torch.tile(x, tuple(_int(r) for r in repeat_times))


@defop
def flip(x, axis):
    axis = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(x, axis)


@defop
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


@defop
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


def _take(x, index, axis):
    axis = axis % x.ndim
    out = torch.index_select(x, axis, torch.reshape(index, (-1,)))
    return torch.reshape(out, (*x.shape[:axis], *index.shape,
                               *x.shape[axis + 1:]))


@defop
def gather(x, index, axis=0):
    return _take(x, index, _int(axis))


@defop
def gather_nd(x, index):
    return x[tuple(torch.unbind(index, dim=-1))]


@defop
def index_select(x, index, axis=0):
    return _take(x, index, axis)


@defop
def index_sample(x, index):
    return torch.gather(x, 1, index)


@defop
def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices, dim=axis)


@defop
def put_along_axis(x, indices, values, axis):
    if not isinstance(values, torch.Tensor):
        return torch.scatter(x, axis, indices, values)
    return torch.scatter(x, axis, indices,
                         values.to(x.dtype).expand(indices.shape))


@defop
def scatter(x, index, updates, overwrite=True):
    if overwrite:
        return torch.index_put(x, (index,), updates.to(x.dtype))
    base = torch.index_put(x, (index,),
                           torch.zeros_like(updates, dtype=x.dtype))
    return torch.index_put(base, (index,), updates.to(x.dtype),
                           accumulate=True)


@defop
def scatter_nd_add(x, index, updates):
    return torch.index_put(x, tuple(torch.unbind(index, dim=-1)),
                           updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape):
    z = wrap(torch.zeros(tuple(_int(s) for s in shape), dtype=updates.dtype,
                         device=updates.device))
    return scatter_nd_add(z, index, updates)


@defop
def where(condition, x=None, y=None):
    if x is None and y is None:
        return tuple(torch.nonzero(condition, as_tuple=True))
    return torch.where(condition, x, y)


def _host(x):
    """x's values on the host (numpy). A host-reading op cannot be
    recorded into a static Program: a Variable raises, naming the op."""
    if type(x).__name__ in ("Variable", "StaticParam"):
        import sys
        raise TypeError(f"{sys._getframe(1).f_code.co_name} reads values "
                        "on the host (a data-dependent output shape); it "
                        "cannot be recorded into a static Program")
    t = x.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _back(arr, like):
    return wrap(torch.from_numpy(np.ascontiguousarray(arr)).to(like.device))


def nonzero(x, as_tuple=False):
    nz = np.nonzero(_host(x))
    if as_tuple:
        return tuple(_back(n, x) for n in nz)
    return _back(np.stack(nz, axis=1).astype(np.int64), x)


@defop
def masked_select(x, mask):
    return torch.masked_select(x, mask)


@defop
def masked_fill(x, mask, value):
    return torch.where(mask, value, x)


def _pad_indices(n, lo, hi, mode, device):
    """Source indices of a dim of size n padded by (lo, hi) in ``mode``."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return torch.clamp(i, 0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    period = 2 * (n - 1)                                   # reflect
    j = torch.remainder(i, period) if period else torch.zeros_like(i)
    return torch.where(j >= n, period - j, j)


@defop
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    nd = x.ndim
    pad = [_int(p) for p in pad]
    if len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # paddle F.pad: the first pair pads the LAST spatial dim
        n_spatial = len(pad) // 2
        spatial = [(pad[2 * i], pad[2 * i + 1])
                   for i in range(n_spatial)][::-1]
        if data_format.upper().endswith("C"):
            cfg = [(0, 0)] * (nd - n_spatial - 1) + spatial + [(0, 0)]
        else:
            cfg = [(0, 0)] * (nd - n_spatial) + spatial
    if mode == "constant":
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        return tF.pad(x, flat, mode="constant", value=value)
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_indices(x.shape[d], lo, hi, mode, x.device))
    return x


@defop(name="topk_op")
def _topk(x, k, axis, largest):
    # a stable sort cut to k: ties come lower index first, as lax.top_k
    # gives them (torch.topk leaves their order open)
    vals, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k).to(torch.int64)


def topk(x, k, axis=-1, largest=True, sorted=True):  # noqa: A002
    return _topk(x, _int(k), axis, largest)


@defop
def sort(x, axis=-1, descending=False):
    out = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(out, [axis]) if descending else out


@defop
def argsort(x, axis=-1, descending=False):
    idx = torch.argsort(x, dim=axis, stable=True)
    if descending:
        idx = torch.flip(idx, [axis])
    return idx.to(torch.int64)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64"):
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        res = (res,)
    outs = tuple(_back(r, x) for r in res)
    return outs if len(outs) > 1 else outs[0]


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    xv = _host(x)
    if axis is None:
        xv = xv.reshape(-1)
        keep = np.concatenate([[True], xv[1:] != xv[:-1]])
    else:
        xv = np.moveaxis(xv, axis, 0)
        flat = xv.reshape(xv.shape[0], -1)
        keep = np.concatenate([[True], (flat[1:] != flat[:-1]).any(axis=1)])
    vals = xv[keep]
    if axis is not None:
        vals = np.moveaxis(vals, 0, axis)
    outs = [_back(vals, x)]
    if return_inverse:
        outs.append(_back(np.cumsum(keep) - 1, x))
    if return_counts:
        idx = np.flatnonzero(keep)
        outs.append(_back(np.diff(np.append(idx, len(keep))), x))
    return tuple(outs) if len(outs) > 1 else outs[0]


@defop(name="tril")
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@defop(name="triu")
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@defop
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@defop
def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@defop
def as_strided_slice(x, axes, starts, ends, strides):
    idx = [builtins.slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[ax] = builtins.slice(st, en, sd)
    return x[tuple(idx)]


def slice(x, axes, starts, ends):  # noqa: A001 - paddle API name
    return as_strided_slice(x, list(axes), [_int(s) for s in starts],
                            [_int(e) for e in ends], [1] * len(axes))


def strided_slice(x, axes, starts, ends, strides):
    return as_strided_slice(x, [int(a) for a in axes],
                            [_int(s) for s in starts],
                            [_int(e) for e in ends],
                            [_int(s) for s in strides])


def _positive_steps(x, idx):
    """(dims to flip, ``idx`` with every negative-step slice made a
    positive-step slice of the flipped dim): torch's indexing takes no
    negative step. A slice s of a dim of size n reads n-1-i in the flip
    for each i it reads in x."""
    items = idx if isinstance(idx, tuple) else (idx,)
    if not any(isinstance(i, builtins.slice) and i.step is not None
               and _int(i.step) < 0 for i in items):
        return (), idx

    def width(i):
        if i is None or i is Ellipsis:
            return 0
        if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
            return i.ndim
        return 1
    n_ell = x.ndim - builtins.sum(width(i) for i in items)
    dims, out, d = [], [], 0
    for i in items:
        if i is Ellipsis:
            d += n_ell
        elif isinstance(i, builtins.slice) and i.step is not None \
                and _int(i.step) < 0:
            n = x.shape[d]
            start, stop, step = i.indices(n)
            dims.append(d)
            i = builtins.slice(n - 1 - start, n - 1 - stop, -step)
        d += width(i)
        out.append(i)
    return tuple(dims), tuple(out) if isinstance(idx, tuple) else out[0]


@defop(name="getitem")
def _getitem(x, idx):
    dims, idx = _positive_steps(x, idx)
    return (torch.flip(x, dims) if dims else x)[idx]


def getitem(x, idx):
    return _getitem(x, idx=idx)


@defop(name="setitem")
def _setitem(x, v, idx):
    dims, idx = _positive_steps(x, idx)
    out = torch.flip(x, dims) if dims else torch.clone(x)
    out[idx] = v.to(x.dtype) if isinstance(v, torch.Tensor) else v
    return torch.flip(out, dims) if dims else out


def setitem(x, idx, value):
    return _setitem(x, value, idx=idx)


@defop
def one_hot(x, num_classes):
    classes = torch.arange(num_classes, device=x.device)
    return torch.eq(torch.unsqueeze(x, -1), classes).to(torch.float32)


@defop
def tensordot(x, y, axes=2):
    return torch.tensordot(x, y, dims=axes)


@defop
def searchsorted(sorted_sequence, values, right=False):
    return torch.searchsorted(sorted_sequence, values,
                              right=right).to(torch.int64)


@defop
def bincount(x, weights=None, minlength=0):
    out = torch.bincount(x, weights=weights, minlength=minlength)
    return out if weights is None else out.to(weights.dtype)


@defop
def as_real(x):
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


@defop
def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


@defop
def crop(x, shape, offsets):
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


@defop
def unbind(x, axis=0):
    return tuple(torch.unbind(x, dim=axis))


@defop
def unstack(x, axis=0, num=None):
    return unbind.raw(x, axis=axis)


@defop
def reverse(x, axis):
    axis = [axis] if isinstance(axis, int) else list(axis)
    return torch.flip(x, axis)


@defop
def space_to_depth(x, blocksize, data_format="NCHW"):
    n, c, h, w = x.shape
    b = int(blocksize)
    x = torch.reshape(x, (n, c, h // b, b, w // b, b))
    x = torch.permute(x, (0, 3, 5, 1, 2, 4))
    return torch.reshape(x, (n, c * b * b, h // b, w // b))


@defop
def shuffle_channel(x, group):
    n, c, h, w = x.shape
    g = int(group)
    x = torch.reshape(x, (n, g, c // g, h, w))
    return torch.reshape(torch.swapaxes(x, 1, 2), (n, c, h, w))


@defop
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    nt, c, h, w = x.shape
    n = nt // seg_num
    x5 = torch.reshape(x, (n, seg_num, c, h, w))
    fold = int(c * shift_ratio)
    pre = tF.pad(x5[:, 1:, :fold], (0, 0, 0, 0, 0, 0, 0, 1))
    post = tF.pad(x5[:, :-1, fold:2 * fold], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([pre, post, x5[:, :, 2 * fold:]], dim=2)
    return torch.reshape(out, (nt, c, h, w))


@defop
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    size = index_num // nshards
    hit = torch.eq(torch.floor_divide(x, size), shard_id)
    return torch.where(hit, torch.remainder(x, size),
                       torch.full_like(x, ignore_value))


@defop
def gather_tree(ids, parents):
    """Backtrace beam-search ids [max_time, batch, beam] along the parent
    pointers (the JAX op's reverse scan as a loop)."""
    beams = torch.arange(ids.shape[2], device=ids.device,
                         dtype=parents.dtype).expand(ids.shape[1:])
    toks = []
    for step in range(ids.shape[0] - 1, -1, -1):
        toks.append(torch.gather(ids[step], -1, beams))
        beams = torch.gather(parents[step], -1, beams)
    return torch.stack(toks[::-1], dim=0)


@defop
def pad_constant_like(x, y, pad_value=0.0):
    flat = []
    for a, b in reversed(list(zip(x.shape, y.shape))):
        flat += [0, int(a) - int(b)]
    return tF.pad(y, flat, value=pad_value)


def _parts(xs, start_index, length):
    parts = []
    for t in xs:
        end = t.shape[1] if length == -1 else start_index + length
        parts.append(t[:, start_index:end])
    return parts


@defop
def partial_concat(xs, start_index=0, length=-1):
    return torch.cat(_parts(xs, start_index, length), dim=1)


@defop
def partial_sum(xs, start_index=0, length=-1):
    parts = _parts(xs, start_index, length)
    out = parts[0]
    for p in parts[1:]:
        out = torch.add(out, p)
    return out


def pad2d(x, paddings, mode="constant", pad_value=0.0, data_format="NCHW"):
    t_, b, l_, r = (int(p) for p in paddings)
    return pad(x, [l_, r, t_, b], mode=mode, value=pad_value,
               data_format=data_format)


def pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW"):
    f, bk, t_, b, l_, r = (int(p) for p in paddings)
    return pad(x, [l_, r, t_, b, f, bk], mode=mode, value=value,
               data_format=data_format)


@defop
def set_value(x, value, item=None):
    v = value.to(x.dtype) if isinstance(value, torch.Tensor) else value
    if item is None:
        return torch.broadcast_to(torch.as_tensor(v, dtype=x.dtype,
                                                  device=x.device),
                                  x.shape).clone()
    out = torch.clone(x)
    out[item] = v
    return out
