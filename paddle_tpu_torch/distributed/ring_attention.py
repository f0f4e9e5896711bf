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

The ring's backward is one ``torch.autograd.Function`` over the whole
ring (``_Ring``), not autograd over the per-block flash calls: a block's
flash backward with its own lse and ``rowsum(dO * o_i)`` is not the
block's share of the merged output's gradient (the flash function drops
the lse's cotangent). It recomputes with the global lse and
``delta = rowsum(dO * O)`` of the merged output instead, through the
flash dq and dk/dv kernels.
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


def _ring_forward(q, k, v, axis, causal, scale, mesh):
    """(out in q's dtype, global lse [b, h, s] f32). Per ring step, block
    (o_i, lse_i) merges into (num, m, l) in f32; block i came from rank
    (my - i) mod n."""
    from .collective import _ppermute_plain
    n = mesh.shape[axis]
    my = mesh.axis_index(axis)
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
            k_cur = _ppermute_plain(k_cur, axis, perm, mesh)
            v_cur = _ppermute_plain(v_cur, axis, perm, mesh)
    l = torch.clamp_min(l, 1e-30)
    out = num / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _ring_backward(q, k, v, o, lse, do, axis, causal, scale, mesh):
    """(dq, dk, dv) of the ring. ``delta = rowsum(dO * O)`` of the merged
    output once, then K/V rotate again: at each step the flash dq and
    dk/dv kernels run on the visiting block with the global lse and delta
    (causal on the diagonal, nothing for a later rank's block). dq sums
    locally; each block's dk/dv partials travel with it in f32 and take
    one more hop home."""
    from ..ops.cuda.flash_attention import (flash_bwd_dkv, flash_bwd_dq,
                                            flash_delta)
    from .collective import _ppermute_plain
    n = mesh.shape[axis]
    my = mesh.axis_index(axis)
    b, h, s, d = q.shape
    flat = lambda t: t.reshape(b * h, s, t.shape[-1]).contiguous()  # noqa: E731
    qf, dof = flat(q), flat(do.to(q.dtype))
    lse_f = lse.reshape(b * h, s).contiguous()
    delta = flash_delta(flat(o), dof).contiguous()
    dq = torch.zeros(b * h, s, d, dtype=torch.float32, device=q.device)
    k_cur, v_cur = flat(k), flat(v)
    dk_acc = torch.zeros(b * h, s, d, dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros_like(dk_acc)
    perm = tuple((j, (j + 1) % n) for j in range(n))
    for i in range(n):
        src = (my - i) % n
        if not (causal and src > my):
            diag = causal and src == my
            dq += flash_bwd_dq(qf, k_cur, v_cur, None, dof, lse_f, delta,
                                 diag, scale).float()
            dk_i, dv_i = flash_bwd_dkv(qf, k_cur, v_cur, None, dof, lse_f,
                                         delta, diag, scale)
            dk_acc += dk_i.float()
            dv_acc += dv_i.float()
        if i + 1 < n:
            k_cur = _ppermute_plain(k_cur, axis, perm, mesh)
            v_cur = _ppermute_plain(v_cur, axis, perm, mesh)
        # the partials follow their block; after the last step they are
        # one hop short of home
        dk_acc = _ppermute_plain(dk_acc, axis, perm, mesh)
        dv_acc = _ppermute_plain(dv_acc, axis, perm, mesh)
    shape = (b, h, s, d)
    return (dq.to(q.dtype).reshape(shape), dk_acc.to(k.dtype).reshape(shape),
            dv_acc.to(v.dtype).reshape(shape))


class _Ring(torch.autograd.Function):
    """The whole ring as one function: the forward saves q, k, v, the
    merged output and the global lse; the backward is ``_ring_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale, mesh):
        out, lse = _ring_forward(q, k, v, axis, causal, scale, mesh)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal, ctx.scale, ctx.mesh = axis, causal, scale, mesh
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, o, lse, do, ctx.axis,
                                    ctx.causal, ctx.scale, ctx.mesh)
        return dq, dk, dv, None, None, None, None


def _ring_attention_raw(q, k, v, axis, causal, scale):
    """q, k, v: [batch, heads, seq_local, dim] on each rank, the sequence
    sharded along ``axis``; differentiable in q, k and v."""
    mesh = mesh_mod.region_mesh(axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    plain = [t.as_subclass(torch.Tensor) for t in (q, k, v)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in plain):
        return _Ring.apply(*plain, axis, bool(causal), float(scale), mesh)
    with torch.no_grad():
        return _ring_forward(*plain, axis, bool(causal), float(scale),
                             mesh)[0]


@defop(name="ring_attention")
def _ring_attention_op(q, k, v, axis, causal, scale):
    return _ring_attention_raw(q, k, v, axis, causal, scale)


def _dense(q, k, v, causal, scale):
    from ..nn.functional import scaled_dot_product_attention
    return scaled_dot_product_attention(q, k, v, is_causal=causal,
                                        scale=scale, training=False)


def ring_attention(q, k, v, axis="sp", causal=False, scale=None):
    """Per-rank attention over ring-rotated K/V. Call inside a shard_map
    region with the sequence sharded on ``axis``; outside one it is exact
    single-process attention. Both carry the gradient."""
    if not mesh_mod.in_spmd_region(axis):
        return _dense(q, k, v, causal, scale)
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
    """As ``ring_attention``, through all-to-alls (differentiable: the
    all_to_all's backward is the exchange back, around the flash
    function's own backward)."""
    if not mesh_mod.in_spmd_region(axis):
        return _dense(q, k, v, causal, scale)
    return _ulysses_op(q, k, v, axis=axis, causal=causal, scale=scale)


def sequence_parallel_attention(q, k, v, mesh=None, axis="sp", causal=False,
                                scale=None, mode="ring"):
    """Global [b, h, s, d] tensors on every rank: shard the sequence over
    ``axis``, run ring or Ulysses attention under shard_map, return the
    global result on every rank. Inputs that need a gradient get the
    global one on every rank (the JAX package's result carries none)."""
    from ..core.tensor import Tensor
    mesh = mesh or mesh_mod.auto_mesh()
    spec = mesh_mod.P(None, None, axis, None)
    fn = _ring_attention_raw if mode == "ring" else _ulysses_raw

    def local(ql, kl, vl):
        return fn(ql, kl, vl, axis, causal, scale)

    raw = [t.as_subclass(torch.Tensor) for t in (q, k, v)]
    out = mesh_mod.shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                             out_specs=spec)(*raw)
    return out.as_subclass(Tensor) if isinstance(q, Tensor) else out
