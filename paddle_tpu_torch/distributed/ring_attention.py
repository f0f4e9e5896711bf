"""Ring and Ulysses attention: sequence (context) parallelism
(paddle_tpu/distributed/ring_attention.py).

Q, K and V are sharded along the sequence over the ``sp`` mesh axis. In
ring attention K/V blocks rotate around the ring (``p2p_permute``) while
each rank merges its queries' attention over every block in log space, so
no rank holds more than its own s/n keys at once. Each block's attention
is the port's ``flash_attention(..., return_lse=True)``: on CUDA tensors
the flash kernels, on CPU tensors their plain version. Causality per ring
step is one of three cases by the block's source rank: full (an earlier
rank's keys), diagonal (its own, causal) or skip (a later rank's: no
visible key, no work).

``ulysses_attention`` is the all-to-all alternative (sequence-sharded to
head-sharded, full local attention, back), for heads >= the sp degree.

Forward only here: the backward through the ring waits for ROADMAP Queue
1 item 7b.
"""
from __future__ import annotations

import torch

from ..core import monitor
from ..ops._dispatch import defop
from . import mesh as mesh_mod

__all__ = ["ring_attention", "ulysses_attention",
           "sequence_parallel_attention", "ring_stats", "reset_ring_stats"]

_NEG = -1e9
_stats = {"steps": 0, "skipped": 0}


def ring_stats():
    """{"steps", "skipped"}: ring steps run and causal ring steps skipped
    (no visible key) since the last ``reset_ring_stats()``."""
    return dict(_stats)


def reset_ring_stats():
    _stats.update(steps=0, skipped=0)


def _attend(q, k, v, causal, scale):
    from ..ops.cuda.flash_attention import flash_attention
    o, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                             return_lse=True)
    return o, lse


def _ring_attention_raw(q, k, v, axis, causal, scale):
    """q, k, v: [batch, heads, seq_local, dim] on each rank, the sequence
    sharded along ``axis``. Per ring step, block (o_i, lse_i) merges into
    (num, m, l) in f32; block i came from rank (my - i) mod n."""
    from .collective import _ppermute_raw
    n = mesh_mod.mesh_axis_size(axis)
    my = mesh_mod.axis_index(axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, s, d = q.shape
    num = torch.zeros(b, h, s, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(b, h, s, dtype=torch.float32, device=q.device)
    perm = tuple((j, (j + 1) % n) for j in range(n))
    k_cur, v_cur = k, v
    for i in range(n):
        src = (my - i) % n
        _stats["steps"] += 1
        if causal and src > my:
            _stats["skipped"] += 1
            monitor.stat_add("ring_attention.skipped_steps")
        else:
            o_i, lse_i = _attend(q, k_cur, v_cur, causal and src == my,
                                 scale)
            m_new = torch.maximum(m, lse_i)
            sc_old = torch.exp(m - m_new)
            sc_new = torch.exp(lse_i - m_new)
            num = num * sc_old[..., None] + o_i.float() * sc_new[..., None]
            l = l * sc_old + sc_new
            m = m_new
        if i + 1 < n:   # the last block needs no further rotation
            k_cur = _ppermute_raw.raw(k_cur, axis, perm)
            v_cur = _ppermute_raw.raw(v_cur, axis, perm)
    out = num / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype)


@defop(name="ring_attention")
def _ring_attention_op(q, k, v, axis, causal, scale):
    return _ring_attention_raw(q, k, v, axis, causal, scale)


def _dense(q, k, v, causal, scale):
    from ..nn.functional import scaled_dot_product_attention
    return scaled_dot_product_attention(q, k, v, is_causal=causal,
                                        scale=scale, training=False)


def _forward_only(name, q, k, v):
    """The sharded forward carries no gradient (its backward through the
    ring or the all-to-all is ROADMAP Queue 1 item 7b): refuse inputs that
    ask for one rather than return an output that drops it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            f"{name}: the backward inside an SPMD region is ROADMAP Queue 1 "
            "item 7b; call it under torch.no_grad() or on inputs that need "
            "no gradient")


def ring_attention(q, k, v, axis="sp", causal=False, scale=None):
    """Per-rank attention over ring-rotated K/V. Call inside a shard_map
    region with the sequence sharded on ``axis``, forward only; outside
    one it is exact single-process attention, with its gradient."""
    if not mesh_mod.in_spmd_region(axis):
        return _dense(q, k, v, causal, scale)
    _forward_only("ring_attention", q, k, v)
    with torch.no_grad():
        return _ring_attention_op(q, k, v, axis=axis, causal=causal,
                                  scale=scale)


def _seq_to_head(x, axis, n):
    """[b, h, s/n, d] -> [b, h/n, s, d]: head group j to axis index j,
    sequence chunks gathered in rank order."""
    from .collective import _alltoall_raw
    b, h, s, d = x.shape
    y = x.reshape(b, n, h // n, s, d).permute(1, 0, 2, 3, 4).contiguous()
    y = _alltoall_raw.raw(y, axis)               # [n (src), b, h/n, s, d]
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _head_to_seq(x, axis, n):
    """[b, h/n, s, d] -> [b, h, s/n, d], the inverse."""
    from .collective import _alltoall_raw
    b, hn, s, d = x.shape
    y = x.reshape(b, hn, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()
    y = _alltoall_raw.raw(y, axis)               # [n (head group), ...]
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * hn, s // n, d)


def _ulysses_raw(q, k, v, axis, causal, scale):
    """All-to-all: [b, h, s/n, d] -> [b, h/n, s, d], full attention
    locally (the flash kernels on CUDA tensors), then back."""
    n = mesh_mod.mesh_axis_size(axis)
    h = q.shape[1]
    if h % n:
        raise ValueError(f"heads {h} not divisible by sp degree {n}")
    qh, kh, vh = (_seq_to_head(t, axis, n) for t in (q, k, v))
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    out, _ = _attend(qh, kh, vh, causal, sc)
    return _head_to_seq(out, axis, n)


@defop(name="ulysses_attention")
def _ulysses_op(q, k, v, axis, causal, scale):
    return _ulysses_raw(q, k, v, axis, causal, scale)


def ulysses_attention(q, k, v, axis="sp", causal=False, scale=None):
    """As ``ring_attention``, through all-to-alls."""
    if not mesh_mod.in_spmd_region(axis):
        return _dense(q, k, v, causal, scale)
    _forward_only("ulysses_attention", q, k, v)
    with torch.no_grad():
        return _ulysses_op(q, k, v, axis=axis, causal=causal, scale=scale)


def sequence_parallel_attention(q, k, v, mesh=None, axis="sp", causal=False,
                                scale=None, mode="ring"):
    """Global [b, h, s, d] tensors on every rank: shard the sequence over
    ``axis``, run ring or Ulysses attention under shard_map, return the
    global result (no gradient) on every rank."""
    from ..core.tensor import Tensor
    mesh = mesh or mesh_mod.auto_mesh()
    spec = mesh_mod.P(None, None, axis, None)
    fn = _ring_attention_raw if mode == "ring" else _ulysses_raw

    def local(ql, kl, vl):
        return fn(ql, kl, vl, axis, causal, scale)

    with torch.no_grad():
        raw = [t.detach().as_subclass(torch.Tensor) for t in (q, k, v)]
        out = mesh_mod.shard_map(local, mesh=mesh,
                                 in_specs=(spec, spec, spec),
                                 out_specs=spec)(*raw)
    return out.as_subclass(Tensor) if isinstance(q, Tensor) else out
