"""Long-tail op families (paddle_tpu/ops/op_tail.py): 14 registry names
under the JAX names and versions.

The beam-search pair is batched-dense ([batch, beam] lanes, a stable
top-k over beam x vocab, as ``lax.top_k`` orders ties: lower index
first); the segment reductions are ``index_add`` / ``scatter_reduce``;
``truncated_normal`` and ``sampling_id`` draw from an explicit
``torch.Generator`` (the port's generator of the device, or one seeded
from ``seed``), so only their distributions are JAX's. ``print_op`` and
``assert_op`` keep the JAX ops' eager behaviour (the port has no traced
mode).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng as _rng
from ..core.dtype import to_torch_dtype
from ..device import resolve_device
from ._dispatch import defop, raw_scope, wrap

__all__ = [
    "spectral_norm", "beam_search", "beam_search_decode",
    "segment_sum", "segment_mean", "segment_max", "segment_min",
    "truncated_normal", "spp", "sampling_id", "dequantize_log",
    "positive_negative_pair", "print_op", "assert_op",
]


def _host(x):
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "") \
        if isinstance(x, torch.Tensor) else str(np.asarray(x).dtype)


def print_op(x, message="", summarize=20, first_n=-1):
    """reference print_op.cc: print tensor values as a pass-through,
    honouring ``first_n`` per message (the JAX op's eager form)."""
    if first_n and first_n > 0:
        seen = getattr(print_op, "_counts", None)
        if seen is None:
            seen = print_op._counts = {}
        seen[message] = seen.get(message, 0) + 1
        if seen[message] > first_n:
            return x
    flat = _host(x).reshape(-1)
    head = flat[:summarize] if summarize and summarize > 0 else flat
    print(f"{message} shape={tuple(x.shape)} dtype={_dtype_name(x)} "
          f"values={head.tolist()}")
    return x


def assert_op(cond, data=None, summarize=20):
    """reference assert_op.cc: raise AssertionError when cond is false
    anywhere (the JAX op's eager form), with ``data`` summarized."""
    if not bool(_host(cond).all()):
        extra = ""
        if data is not None:
            items = data if isinstance(data, (list, tuple)) else [data]
            extra = "; data=" + ", ".join(
                str(_host(d).reshape(-1)[:summarize].tolist())
                for d in items)
        raise AssertionError("Assert failed" + extra)
    return cond


@defop
def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12):
    """reference spectral_norm_op.cc: the weight over its largest singular
    value, from power iteration on the given u / v seed vectors."""
    w = torch.movedim(weight, dim, 0)
    h = w.shape[0]
    mat = w.reshape(h, -1)
    for _ in range(max(int(power_iters), 0)):
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = mat @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ mat @ v
    out = mat / (sigma + eps)
    return torch.movedim(out.reshape(w.shape), 0, dim)


@defop(version=2)
def beam_search(pre_ids, pre_scores, scores, beam_size, end_id,
                is_accumulated=True):
    """reference beam_search_op.cc, batched-dense: one step of beam
    expansion. pre_ids / pre_scores [B, K]; scores [B, K, V]: accumulated
    log-probs when ``is_accumulated``, else the step's normalized
    probabilities (``log`` of them is added to pre_scores, version 2).
    Returns (selected_ids [B, K], selected_scores [B, K], parent_idx
    [B, K] int32). A finished lane (pre_id == end_id) offers only end_id,
    at its frozen score."""
    b, k, vsz = scores.shape
    if not is_accumulated:
        scores = pre_scores[:, :, None] + torch.log(scores)
    finished = pre_ids == end_id
    is_end = torch.arange(vsz, device=scores.device) == end_id
    frozen = torch.where(is_end, pre_scores[:, :, None],
                         torch.full_like(scores, -math.inf))
    total = torch.where(finished[:, :, None], frozen, scores)
    flat = total.reshape(b, k * vsz)
    # a stable sort cut to k: ties lower index first, as lax.top_k
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    parent = torch.div(top_idx, vsz, rounding_mode="floor").to(torch.int32)
    ids = (top_idx % vsz).to(pre_ids.dtype)
    return ids, top_scores, parent


@defop
def beam_search_decode(step_ids, step_parents, end_id):
    """reference beam_search_decode_op.cc, batched-dense: backtrack the
    per-step (ids, parents) trellis [T, B, K] into sequences [B, K, T]."""
    t, b, k = step_ids.shape
    lane = torch.arange(k, device=step_ids.device).expand(b, k)
    toks = []
    for s in range(t - 1, -1, -1):
        toks.append(torch.take_along_dim(step_ids[s], lane, dim=1))
        lane = torch.take_along_dim(step_parents[s], lane, dim=1).long()
    return torch.stack(toks[::-1], dim=2)


def _segment(op_name, data, segment_ids, num_segments=None):
    with raw_scope():
        return wrap(_segment_raw(op_name, data, segment_ids, num_segments))


def _segment_raw(op_name, data, segment_ids, num_segments):
    seg = torch.as_tensor(segment_ids).to(data.device).long().reshape(-1)
    if num_segments is None:
        num_segments = int(seg.max()) + 1 if seg.numel() else 0
    n = int(num_segments)
    # ids outside [0, n) are dropped, as jax.ops.segment_* drops them
    keep = (seg >= 0) & (seg < n)
    seg, rows = seg[keep], data[keep]
    shape = (n,) + tuple(data.shape[1:])
    if op_name in ("sum", "mean"):
        s = torch.zeros(shape, dtype=data.dtype, device=data.device) \
            .index_add(0, seg, rows)
        if op_name == "sum":
            return s
        cnt = torch.zeros((n,), dtype=data.dtype, device=data.device) \
            .index_add(0, seg, torch.ones_like(seg, dtype=data.dtype))
        return s / torch.clamp(cnt, min=1).reshape(
            (n,) + (1,) * (data.dim() - 1))
    # an empty segment holds the reduction's identity, as in JAX
    if data.dtype.is_floating_point:
        fill = -math.inf if op_name == "max" else math.inf
    else:
        info = torch.iinfo(data.dtype)
        fill = info.min if op_name == "max" else info.max
    out = torch.full(shape, fill, dtype=data.dtype, device=data.device)
    idx = seg.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(rows)
    return out.scatter_reduce(
        0, idx, rows, reduce="amax" if op_name == "max" else "amin")


def segment_sum(data, segment_ids, num_segments=None):
    """reference segment_pool_op.cc SUM (paddle.incubate.segment_sum)."""
    return _segment("sum", data, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments=None):
    return _segment("mean", data, segment_ids, num_segments)


def segment_max(data, segment_ids, num_segments=None):
    return _segment("max", data, segment_ids, num_segments)


def segment_min(data, segment_ids, num_segments=None):
    return _segment("min", data, segment_ids, num_segments)


def truncated_normal(shape, mean=0.0, std=1.0, dtype="float32"):
    """reference truncated_gaussian_random_op.cc: N(mean, std) cut at two
    standard deviations, by the inverse CDF of a uniform draw over
    [Phi(-2), Phi(2)) from the port's generator of the current device."""
    dev = resolve_device()
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(tuple(int(s) for s in shape), generator=_rng.generator(dev),
                   dtype=torch.float64, device=dev)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (1.0 - 2.0 * lo) * u) - 1.0)
    z = z.clamp(-2.0, 2.0)
    return wrap((z * std + mean).to(to_torch_dtype(dtype)))


def spp(x, pyramid_height=3, pool_type="max"):
    """reference spp_op.cc (spatial pyramid pooling): the concat of
    adaptive pools at 1x1, 2x2, ... 2^(h-1) bins, flattened per image."""
    from . import concat
    from .conv import adaptive_avg_pool2d, adaptive_max_pool2d
    pool = adaptive_max_pool2d if pool_type == "max" else adaptive_avg_pool2d
    n = x.shape[0]
    outs = [pool(x, output_size=(2 ** level, 2 ** level)).reshape([n, -1])
            for level in range(int(pyramid_height))]
    return concat(outs, axis=1)


def sampling_id(x, min=0.0, max=1.0, seed=0):  # noqa: A002
    """reference sampling_id_op.cc: r ~ U[min, max) per row, then the
    first index where cumsum(p) crosses r (the inverse-CDF walk). The
    draw comes from a generator seeded by ``seed``, or from the port's
    generator of x's device."""
    p = x
    g = torch.Generator(device=p.device).manual_seed(int(seed)) if seed \
        else _rng.generator(p.device)
    r = torch.rand(p.shape[:-1], generator=g, dtype=p.dtype,
                   device=p.device) * (max - min) + min
    c = torch.cumsum(p, dim=-1)
    idx = torch.sum(c < r[..., None], dim=-1)
    return wrap(torch.clamp(idx, 0, p.shape[-1] - 1).to(torch.int64))


@defop
def dequantize_log(x, dict_table):
    """reference dequantize_log_op.cc: int8 -> float through a 128-entry
    log-scale table; negative codes mirror with sign."""
    xi = x.to(torch.int32)
    code = torch.where(xi < 0, xi + 128, xi)
    val = dict_table[code.long()]
    return torch.where(xi < 0, -val, val)


@defop
def positive_negative_pair(score, label, query_ids):
    """reference positive_negative_pair_op.cc: within each query, the
    pairs ranked concordantly (positive), discordantly (negative) and
    tied (neutral) between predicted scores and labels."""
    s = score.reshape(-1)
    y = label.reshape(-1).to(torch.float32)
    q = query_ids.reshape(-1)
    same_q = q[:, None] == q[None, :]
    upper = torch.triu(torch.ones_like(same_q, dtype=torch.bool), diagonal=1)
    valid = same_q & upper & (y[:, None] != y[None, :])
    ds = s[:, None] - s[None, :]
    dy = y[:, None] - y[None, :]
    pos = torch.sum((valid & (ds * dy > 0)).to(torch.float32))
    neg = torch.sum((valid & (ds * dy < 0)).to(torch.float32))
    neu = torch.sum((valid & (ds == 0)).to(torch.float32))
    return pos, neg, neu
