"""Pipeline parallelism (paddle_tpu/distributed/pipeline.py).

One process per stage on the ``pp`` axis of a region (``shard_map`` or
``MeshGuard``), tick-synchronous as in the JAX package: at each tick
every rank runs its stage once, then one ppermute hands each stage's
output to the next rank. Stage 0 injects a fresh micro-batch each tick
and the last stage emits finished ones. The backward is autograd over
the loop: each ppermute's backward is the inverse permutation. The
ppermutes are chained by a zero-size token, so every rank runs their
backwards in the same order (the last tick's first) whatever its own
graph looks like, and no rank waits on a permute another rank has not
reached. A rank whose tick is a bubble (no micro-batch at it) runs no
stage and sends zeros, where the JAX program computes on the garbage it
discards.

Stages are homogeneous (hidden -> hidden, one shape and dtype): apply the
embedding before the pipeline and the head after, as ``pipeline_loss``
does with its ``loss_fn`` on the last stage.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import mesh as mesh_mod

__all__ = ["micro_batch", "gpipe", "interleaved", "pipeline_loss",
           "bubble_fraction", "schedule_ticks", "schedule_collectives"]


def micro_batch(x, num_micro):
    """[B, ...] -> [num_micro, B/num_micro, ...]"""
    b = x.shape[0]
    assert b % num_micro == 0, (b, num_micro)
    return x.reshape((num_micro, b // num_micro) + tuple(x.shape[1:]))


class _Hop(torch.autograd.Function):
    """One tick's ppermute to the next rank, chained to the previous tick's
    by ``token``: the backward of tick t runs only once tick t+1's has,
    on every rank."""

    @staticmethod
    def forward(ctx, x, token, axis, mesh):
        from .collective import _ppermute_plain
        n = mesh.shape[axis]
        ctx.axis, ctx.mesh, ctx.n = axis, mesh, n
        perm = tuple((i, (i + 1) % n) for i in range(n))
        return _ppermute_plain(x, axis, perm, mesh), token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        from .collective import _ppermute_plain
        back = tuple(((i + 1) % ctx.n, i) for i in range(ctx.n))
        return _ppermute_plain(g.contiguous(), ctx.axis, back, ctx.mesh), \
            g_token, None, None


class _Ticks:
    """The tick loop's carry and ppermute chain on one rank."""

    def __init__(self, x_micro, axis):
        self.axis = axis
        self.mesh = mesh_mod.region_mesh(axis)
        self.n = mesh_mod.mesh_axis_size(axis)
        self.rank = mesh_mod.axis_index(axis)
        like = x_micro[0]
        self.zeros = torch.zeros(like.shape, dtype=like.dtype,
                                 device=like.device)
        self.carry = self.zeros
        self.token = torch.zeros((), device=like.device,
                                 requires_grad=torch.is_grad_enabled())
        self.outs = [None] * x_micro.shape[0]

    def hop(self, h_out):
        if self.n == 1:
            self.carry = h_out
            return
        self.carry, self.token = _Hop.apply(h_out.contiguous(), self.token,
                                            self.axis, self.mesh)

    def finish(self):
        """[M, mb, ...]: the finished micro-batches on the last stage,
        zeros elsewhere; every rank's result depends on the whole chain."""
        outs = [o if o is not None else self.zeros for o in self.outs]
        out = torch.stack(outs)
        if self.token.requires_grad:
            out = out + (self.token * 0).to(out.dtype)
        return out


def _check_schedule(schedule):
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")


def gpipe(stage_fn: Callable, x_micro, axis: str = "pp", schedule="gpipe"):
    """Pipelined forward inside a region over ``axis``.

    stage_fn(h) -> h: THIS rank's stage, hidden-shaped in and out.
    x_micro: [M, mb, ...] hidden-shaped micro-batches (only stage 0 reads
    them). Returns [M, mb, ...]: the finished outputs on the LAST stage
    (zeros elsewhere).

    schedule "gpipe": F-then-B under autograd, every micro-batch's
    activations held until the backward; "1f1b": each tick under
    ``recompute``, so only the tick boundaries' hiddens stay and a stage's
    activations are recomputed when its micro-batch's backward comes (the
    activation bound of 1F1B, the JAX package's single-program form)."""
    from .recompute import recompute
    _check_schedule(schedule)
    t = _Ticks(x_micro, axis)
    M = x_micro.shape[0]
    for tick in range(M + t.n - 1):
        m = tick - t.rank                 # the micro-batch at this stage
        if 0 <= m < M:
            h = x_micro[m] if t.rank == 0 else t.carry
            h_out = recompute(stage_fn, h) if schedule == "1f1b" \
                else stage_fn(h)
            if t.rank == t.n - 1:
                t.outs[m] = h_out
        else:
            h_out = t.zeros
        t.hop(h_out)
    return t.finish()


def interleaved(chunk_fns, x_micro, axis: str = "pp", remat=True):
    """Interleaved virtual stages (Megatron's interleaved 1F1B as one
    tick-synchronous program): each rank holds v chunks, global stage
    c*n + r is chunk c on rank r, and micro-batches circulate the ring v
    times in groups of n. At tick t rank r runs chunk ((t - r) // n) mod
    v on micro-batch ((t - r) // (v n)) n + (t - r) mod n. Ticks: v M + n
    - 1 (gpipe: M + n - 1 ticks of v chunks). M must be a multiple of n.
    Returns [M, mb, ...] finished outputs on the LAST stage."""
    from .recompute import recompute
    t = _Ticks(x_micro, axis)
    n, v = t.n, len(chunk_fns)
    M = x_micro.shape[0]
    if M % n != 0:
        raise ValueError(
            f"interleaved schedule needs num_micro ({M}) divisible by the "
            f"pp size ({n}) — microbatches inject in groups of n")
    for tick in range(v * M + n - 1):
        rel = tick - t.rank
        m = (rel // (v * n)) * n + rel % n if rel >= 0 else M
        if m < M:
            c = (rel // n) % v
            h = x_micro[m] if t.rank == 0 and c == 0 else t.carry
            fn = chunk_fns[c]
            h_out = recompute(fn, h) if remat else fn(h)
            if t.rank == n - 1 and c == v - 1:
                t.outs[m] = h_out
        else:
            h_out = t.zeros
        t.hop(h_out)
    return t.finish()


def schedule_ticks(num_micro: int, num_stages: int, schedule: str = "gpipe",
                   num_virtual: int = 1) -> int:
    """Chunk-time ticks a schedule takes: gpipe / 1f1b run M+n-1 ticks of
    full per-rank depth (v chunk-times each); interleaved runs v*M + n - 1
    single-chunk ticks. A single stage is M serial micro-batches (v*M);
    M < n still runs M+n-1 ticks."""
    num_micro = max(int(num_micro), 0)
    num_stages = max(int(num_stages), 1)
    num_virtual = max(int(num_virtual), 1)
    if num_micro == 0:
        return 0
    if schedule == "interleaved":
        return num_virtual * num_micro + num_stages - 1
    return num_virtual * (num_micro + num_stages - 1)


def pipeline_loss(stage_fn, loss_fn, x_micro, labels_micro, axis="pp",
                  schedule="gpipe"):
    """Mean micro-batch loss of the pipelined stack, the same scalar on
    every rank (a psum over ``axis``: its gradient reaches each rank's
    stage through the permutes). ``loss_fn`` runs on the last stage only.
    schedule "gpipe" / "1f1b", or "interleaved" with ``stage_fn`` a LIST
    of this rank's chunk functions."""
    from .collective import ReduceOp, _allreduce_raw
    n = mesh_mod.mesh_axis_size(axis)
    rank = mesh_mod.axis_index(axis)
    if schedule == "interleaved":
        outs = interleaved(list(stage_fn), x_micro, axis)
    else:
        outs = gpipe(stage_fn, x_micro, axis, schedule=schedule)
    M = x_micro.shape[0]
    if rank == n - 1:
        total = sum(loss_fn(outs[m], labels_micro[m]).float()
                    for m in range(M))
    else:
        total = outs.float().sum() * 0    # keeps the chain in the graph
    if n > 1:
        total = _allreduce_raw(total, axis=axis, op=ReduceOp.SUM)
    return total / M


def bubble_fraction(num_micro: int, num_stages: int,
                    schedule: str = "gpipe", num_virtual: int = 1) -> float:
    """The bubble (n-1)/(M+n-1), (n-1)/(vM+n-1) interleaved; zero for one
    stage or no micro-batch."""
    num_micro = max(int(num_micro), 0)
    num_stages = max(int(num_stages), 1)
    num_virtual = max(int(num_virtual), 1)
    if num_stages <= 1 or num_micro == 0:
        return 0.0
    if schedule == "interleaved":
        return (num_stages - 1) / (num_virtual * num_micro
                                   + num_stages - 1)
    return (num_stages - 1) / (num_micro + num_stages - 1)


def schedule_collectives(num_micro: int, num_stages: int,
                         hidden_bytes: int, schedule: str = "gpipe",
                         num_virtual: int = 1, axis: str = "pp",
                         tiers=None) -> dict:
    """The schedule's collectives: one ppermute of the hidden micro-batch
    a tick (the forward's; the backward mirrors each). A single stage
    prices as zero ppermutes. ``tiers`` ({axis: {"tier", "gbps"}}) adds
    ``tier`` / ``cost_us`` for the stage axis's link."""
    if max(int(num_stages), 1) <= 1:
        out = {"kind": "ppermute", "axis": axis, "count": 0,
               "bytes_per_tick": int(hidden_bytes), "total_bytes": 0}
    else:
        ticks = schedule_ticks(num_micro, num_stages, schedule,
                               num_virtual)
        out = {"kind": "ppermute", "axis": axis, "count": ticks,
               "bytes_per_tick": int(hidden_bytes),
               "total_bytes": ticks * int(hidden_bytes)}
    if tiers and axis in tiers:
        m = tiers[axis]
        g = float(m.get("gbps", 0.0))
        out["tier"] = str(m.get("tier", "ici"))
        out["cost_us"] = round(out["total_bytes"] / (g * 1e3), 3) \
            if g > 0 else 0.0
    return out
