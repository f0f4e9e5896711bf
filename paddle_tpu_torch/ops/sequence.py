"""Sequence ops (paddle_tpu/ops/sequence.py): the reference's sequence_*
family over the packed (values, row_splits) form of ``core/ragged.py``.

Every op is a segment reduction, a gather or a mask over the packed
values (``index_add`` / ``scatter_reduce`` over the segment ids), so a
ragged batch stays one tensor on its device; the ops whose output length
depends on the data (expand, concat, slice, erase, unpad) read the
lengths on the host, as the JAX package's eager forms do. All ops take a
``RaggedTensor`` or a (values, row_splits) pair and, like the JAX ops,
join the registry as plain functions (no cast point, no version).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import to_torch_dtype
from ..core.ragged import RaggedTensor, _as_torch, _host
from ._dispatch import wrap

__all__ = ["sequence_pool", "sequence_softmax", "sequence_expand",
           "sequence_concat", "sequence_reverse", "sequence_first_step",
           "sequence_last_step", "sequence_slice", "sequence_pad",
           "sequence_unpad", "sequence_mask", "sequence_expand_as",
           "sequence_enumerate", "sequence_erase", "sequence_reshape",
           "sequence_scatter", "sequence_conv",
           "sequence_topk_avg_pooling"]


def _as_ragged(x, row_splits=None):
    if isinstance(x, RaggedTensor):
        return x
    return RaggedTensor(x, row_splits)


def _seg_sum(values, sid, n):
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, sid, values)


def _seg_extreme(values, sid, n, reduce):
    fill = -torch.inf if reduce == "amax" else torch.inf
    if not values.is_floating_point():
        info = torch.iinfo(values.dtype)
        fill = info.min if reduce == "amax" else info.max
    out = torch.full((n,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    idx = sid.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    return out.scatter_reduce(0, idx, values, reduce, include_self=False)


def _per_row(v, n, like):
    return v.reshape((n,) + (1,) * (like.ndim - 1))


def sequence_pool(x, pool_type="sum", row_splits=None):
    """reference sequence_pool_op.cc: {sum, average, max, min, sqrt, first,
    last} over each sequence. Returns [nrows, ...]."""
    r = _as_ragged(x, row_splits)
    sid = r.segment_ids()
    n = r.nrows
    pt = pool_type.lower()
    if pt == "sum":
        return wrap(_seg_sum(r.values, sid, n))
    if pt in ("average", "mean", "sqrt"):
        s = _seg_sum(r.values, sid, n)
        cnt = torch.clamp(r.lengths, min=1).to(s.dtype)
        if pt == "sqrt":
            cnt = torch.sqrt(cnt)
        return wrap(s / _per_row(cnt, n, s))
    if pt == "max":
        return wrap(_seg_extreme(r.values, sid, n, "amax"))
    if pt == "min":
        return wrap(_seg_extreme(r.values, sid, n, "amin"))
    if pt == "first":
        return sequence_first_step(r)
    if pt == "last":
        return sequence_last_step(r)
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_first_step(x, row_splits=None):
    r = _as_ragged(x, row_splits)
    return wrap(r.values[r.row_splits[:-1].to(torch.int64)])


def sequence_last_step(x, row_splits=None):
    r = _as_ragged(x, row_splits)
    return wrap(r.values[torch.clamp(r.row_splits[1:] - 1, min=0)
                         .to(torch.int64)])


def sequence_softmax(x, row_splits=None):
    """reference sequence_softmax_op.cc: softmax within each sequence."""
    r = _as_ragged(x, row_splits)
    sid = r.segment_ids()
    n = r.nrows
    mx = _seg_extreme(r.values, sid, n, "amax")
    e = torch.exp(r.values - mx[sid])
    denom = _seg_sum(e, sid, n)
    return RaggedTensor(wrap(e / denom[sid]), r.row_splits)


def sequence_expand(x, ref, row_splits=None):
    """reference sequence_expand_op.cc: row i of ``x`` repeated to the
    length of sequence i of ``ref``."""
    r = _as_ragged(ref, row_splits)
    vals = _as_torch(x, r.values.device)
    reps = _host(r.lengths).astype(np.int64)
    idx = torch.as_tensor(np.repeat(np.arange(len(reps)), reps),
                          device=vals.device)
    return RaggedTensor(wrap(vals[idx]), r.row_splits)


def sequence_concat(xs):
    """reference sequence_concat_op.cc: concat per sequence."""
    rs = [_as_ragged(x) for x in xs]
    n = rs[0].nrows
    if any(r.nrows != n for r in rs):
        raise ValueError("sequence_concat needs equal sequence counts")
    lists = [r.to_list() for r in rs]
    return RaggedTensor.from_rows([torch.cat([ls[i] for ls in lists], 0)
                                   for i in range(n)])


def sequence_reverse(x, row_splits=None):
    """reference sequence_reverse_op.h: reverse within each sequence."""
    r = _as_ragged(x, row_splits)
    starts = r.row_splits[:-1].to(torch.int64)
    ends = r.row_splits[1:].to(torch.int64)
    sid = r.segment_ids()
    pos = torch.arange(r.values.shape[0], device=r.values.device)
    mirrored = starts[sid] + (ends[sid] - 1 - pos)
    return RaggedTensor(wrap(r.values[mirrored]), r.row_splits)


def sequence_slice(x, offset, length, row_splits=None):
    """reference sequence_slice_op.h: per sequence [offset, offset+length)."""
    r = _as_ragged(x, row_splits)
    offset = _host(offset).reshape(-1)
    length = _host(length).reshape(-1)
    rows = r.to_list()
    return RaggedTensor.from_rows(
        [rows[i][int(offset[i]):int(offset[i]) + int(length[i])]
         for i in range(r.nrows)])


def sequence_pad(x, pad_value=0, maxlen=None, row_splits=None):
    """reference sequence_pad_op.cc: packed -> (padded, lengths)."""
    r = _as_ragged(x, row_splits)
    return wrap(r.to_padded(maxlen=maxlen, pad_value=pad_value)), \
        wrap(r.lengths)


def sequence_unpad(x, lengths):
    """reference sequence_unpad_op.cc: (padded, lengths) -> packed."""
    return RaggedTensor.from_padded(_as_torch(x), lengths)


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """reference sequence_mask_op.cc: [n] lengths -> [n, maxlen] 0/1."""
    lv = _as_torch(lengths)
    if maxlen is None:
        maxlen = int(lv.max())
    col = torch.arange(int(maxlen), dtype=lv.dtype, device=lv.device)
    return wrap((col < lv[..., None]).to(to_torch_dtype(dtype)))


def sequence_expand_as(x, ref, row_splits=None):
    """reference sequence_expand_as_op.cc: x's rows map 1:1 onto ref's
    sequences."""
    return sequence_expand(x, ref, row_splits)


def sequence_enumerate(x, win_size, pad_value=0, row_splits=None):
    """reference sequence_enumerate_op.cc: per position, the window of the
    next ``win_size`` ids, padded past each sequence's end."""
    r = _as_ragged(x, row_splits)
    ends = r.row_splits[1:].to(torch.int64)
    sid = r.segment_ids()
    total = r.values.shape[0]
    pos = torch.arange(total, device=r.values.device)
    pad = torch.as_tensor(pad_value, dtype=r.values.dtype,
                          device=r.values.device)
    cols = []
    for w in range(win_size):
        idx = pos + w
        gathered = r.values[torch.clamp(idx, max=total - 1)]
        cols.append(torch.where(idx < ends[sid], gathered, pad))
    return RaggedTensor(wrap(torch.stack(cols, -1)), r.row_splits)


def sequence_erase(x, tokens, row_splits=None):
    """reference sequence_erase_op.cc: drop the listed tokens from every
    sequence."""
    r = _as_ragged(x, row_splits)
    drop = torch.as_tensor(_host(tokens).reshape(-1),
                           dtype=r.values.dtype, device=r.values.device)
    return RaggedTensor.from_rows([row[~torch.isin(row, drop)]
                                   for row in r.to_list()])


def sequence_reshape(x, new_dim, row_splits=None):
    """reference sequence_reshape_op.cc: re-chunk each sequence's payload
    into rows of width ``new_dim``."""
    r = _as_ragged(x, row_splits)
    old_dim = int(np.prod(r.values.shape[1:])) or 1
    total = _host(r.lengths).astype(np.int64) * old_dim
    if (total % new_dim).any():
        raise ValueError("sequence_reshape: per-sequence payload must be "
                         "divisible by new_dim")
    new_lens = total // new_dim
    splits = np.zeros(len(new_lens) + 1, np.int32)
    np.cumsum(new_lens, out=splits[1:])
    return RaggedTensor(wrap(torch.reshape(r.values, (-1, new_dim))), splits)


def sequence_scatter(x, index, updates):
    """reference sequence_scatter_op.cc: scatter-add ``updates`` (ragged,
    positions ``index`` per sequence) into the dense rows of ``x``."""
    xv = _as_torch(x)
    idx = _as_ragged(index)
    upd = updates.values if isinstance(updates, RaggedTensor) \
        else _as_torch(updates, xv.device)
    sid = idx.segment_ids()
    flat_pos = idx.values.to(torch.int64)
    return wrap(xv.index_put((sid, flat_pos), upd.to(xv.dtype),
                             accumulate=True))


def sequence_conv(x, weight, context_length, context_start=None,
                  bias=None, row_splits=None):
    """reference sequence_conv_op.cc: 1-D conv along each sequence with a
    [context_length * d_in, d_out] filter; taps outside the sequence
    read 0."""
    r = _as_ragged(x, row_splits)
    if context_start is None:
        context_start = -((context_length - 1) // 2)
    sid = r.segment_ids()
    starts = r.row_splits[:-1].to(torch.int64)
    ends = r.row_splits[1:].to(torch.int64)
    total = r.values.shape[0]
    pos = torch.arange(total, device=r.values.device)
    taps = []
    for c in range(context_length):
        idx = pos + context_start + c
        valid = (idx >= starts[sid]) & (idx < ends[sid])
        g = r.values[torch.clamp(idx, 0, total - 1)]
        taps.append(torch.where(valid[:, None], g, torch.zeros((), dtype=g.dtype,
                                                               device=g.device)))
    ctx = torch.cat(taps, -1)                     # [total, ctx * d_in]
    out = ctx @ _as_torch(weight, ctx.device)
    if bias is not None:
        out = out + _as_torch(bias, ctx.device)
    return RaggedTensor(wrap(out), r.row_splits)


def sequence_topk_avg_pooling(x, topks, row_splits=None):
    """reference sequence_topk_avg_pooling_op.cc: per sequence and k in
    ``topks``, the mean of its top-k values (per feature column)."""
    r = _as_ragged(x, row_splits)
    padded = r.to_padded(pad_value=-np.inf)       # [n, maxlen, ...]
    srt = torch.flip(torch.sort(padded, dim=1).values, dims=(1,))
    lens = r.lengths
    outs = []
    for k in topks:
        top = srt[:, :k]
        take = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
        cnt = torch.clamp(lens, max=k).to(take.dtype)
        outs.append(take.sum(1) / torch.clamp(cnt, min=1).reshape(
            (-1,) + (1,) * (take.ndim - 2)))
    return wrap(torch.stack(outs, 1) if len(topks) > 1 else outs[0])
