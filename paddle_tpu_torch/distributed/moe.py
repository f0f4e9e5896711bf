"""Mixture-of-Experts with expert parallelism (paddle_tpu/distributed/
moe.py): Switch routing (top-1 softmax gate with capacity), experts
sharded over the ``ep`` mesh axis, tokens dispatched to the experts'
ranks by an all-to-all and combined back by a second one (Switch /
GShard). The expert FFN is batched matmuls (``torch.einsum``), as the JAX
package's is ``jnp.einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from .. import nn
from ..ops._dispatch import defop
from . import mesh as mesh_mod

__all__ = ["MoELayer", "switch_route"]


def switch_route(gate_logits, num_experts, capacity, k=1):
    """Top-1 routing with capacity: (dispatch, combine), each [tokens,
    experts, capacity]; dispatch one-hot, combine gate-weighted. Tokens
    past an expert's ``capacity`` are dropped (an all-zero dispatch row),
    and their count is added to the monitor counter
    ``moe.dropped_tokens`` (one host read)."""
    probs = torch.softmax(gate_logits, dim=-1)               # [T, E]
    gate, expert = torch.max(probs, dim=-1)                  # [T]
    onehot = torch.nn.functional.one_hot(expert, num_experts) \
        .to(probs.dtype)                                     # [T, E]
    # position of each token within its expert's queue
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0         # [T, E]
    keep = (pos < capacity) & (onehot > 0)
    n = int(gate_logits.shape[0] - keep.sum())
    if n:
        from ..core import monitor
        monitor.stat_add("moe.dropped_tokens", n)
    pos_cap = torch.clamp(pos, 0, capacity - 1).to(torch.int64)
    slot = torch.nn.functional.one_hot(pos_cap, capacity) > 0
    dispatch = (keep[..., None] & slot).to(probs.dtype)
    combine = dispatch * gate[:, None, None]
    return dispatch, combine


def _to_experts(xin, axis, ep):
    """[E, C, d] -> [E/ep, ep*C, d]: expert group j to axis index j, the
    ranks' tokens concatenated on the capacity dim in rank order."""
    from .collective import _alltoall_raw
    e, c, d = xin.shape
    y = _alltoall_raw.raw(xin.reshape(ep, e // ep, c, d).contiguous(), axis)
    return y.permute(1, 0, 2, 3).reshape(e // ep, ep * c, d)


def _from_experts(out, axis, ep):
    """[E/ep, ep*C, d] -> [E, C, d], the inverse."""
    from .collective import _alltoall_raw
    el, epc, d = out.shape
    c = epc // ep
    y = out.reshape(el, ep, c, d).permute(1, 0, 2, 3).contiguous()
    return _alltoall_raw.raw(y, axis).reshape(ep * el, c, d)


def _moe_raw(xv, gate_w, w_up, b_up, w_down, b_down, axis, e_total, e_local,
             cap_factor):
    b, s, d = xv.shape
    tokens = xv.reshape(b * s, d)
    T = tokens.shape[0]
    in_region = mesh_mod.in_spmd_region(axis)
    ep = mesh_mod.mesh_axis_size(axis) if in_region else 1
    capacity = int(cap_factor * T / e_total) + 1
    logits = tokens @ gate_w                                  # [T, E]
    dispatch, combine = switch_route(logits, e_total, capacity)
    xin = torch.einsum("tec,td->ecd", dispatch, tokens)       # [E, C, d]
    if ep > 1:
        xin = _to_experts(xin, axis, ep)                      # [E/ep, C*ep, d]
    h = torch.einsum("ecd,edh->ech", xin, w_up) + b_up[:, None, :]
    h = torch.nn.functional.gelu(h, approximate="tanh")      # jax.nn.gelu
    out = torch.einsum("ech,ehd->ecd", h, w_down) + b_down[:, None, :]
    if ep > 1:
        out = _from_experts(out, axis, ep)                    # [E, C, d]
    y = torch.einsum("tec,ecd->td", combine, out)
    return y.reshape(b, s, d)


_OP = []


def _moe_op():
    """The layer's op, registered as "moe_layer" at the first forward (the
    JAX package defines it in ``MoELayer.forward``)."""
    if not _OP:
        _OP.append(defop(_moe_raw, name="moe_layer"))
    return _OP[0]


class MoELayer(nn.Layer):
    """Expert-parallel FFN block. Outside a region all experts run
    locally (the dense fallback); inside one over ``axis`` (ep), each rank
    holds num_experts / ep experts and tokens move by all-to-all. The
    expert weights are stacked: w_up [E_local, d_model, d_hidden], b_up
    [E_local, d_hidden], w_down [E_local, d_hidden, d_model], b_down
    [E_local, d_model]. The gate is the same on every rank: its gradient
    from one rank's tokens is that rank's part (sum it over ``axis``, as
    a replicated parameter's)."""

    def __init__(self, d_model, d_hidden, num_experts, capacity_factor=1.25,
                 axis="ep", activation="gelu", k=1):
        super().__init__()
        from ..nn import initializer as I
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.axis = axis
        ep = mesh_mod.mesh_axis_size(axis)
        assert num_experts % ep == 0, (num_experts, ep)
        self.experts_per_rank = num_experts // ep
        self.gate = nn.Linear(d_model, num_experts, bias_attr=False)
        self.w_up = self.create_parameter(
            [self.experts_per_rank, d_model, d_hidden],
            default_initializer=I.XavierUniform())
        self.b_up = self.create_parameter([self.experts_per_rank, d_hidden],
                                          is_bias=True)
        self.w_down = self.create_parameter(
            [self.experts_per_rank, d_hidden, d_model],
            default_initializer=I.XavierUniform())
        self.b_down = self.create_parameter([self.experts_per_rank, d_model],
                                            is_bias=True)

    def _slice_jax_param(self, name, arr):
        """This rank's experts of a whole [num_experts, ...] stack (the
        bridge's hook), by its index on the default mesh's ``axis``."""
        if name in ("w_up", "b_up", "w_down", "b_down") \
                and arr.shape[0] == self.num_experts \
                and self.experts_per_rank != self.num_experts:
            m = mesh_mod.get_mesh()
            r = m.coords()[self.axis]
            e = self.experts_per_rank
            return arr[r * e:(r + 1) * e]
        return arr

    def forward(self, x):
        ep = mesh_mod.mesh_axis_size(self.axis) \
            if mesh_mod.in_spmd_region(self.axis) else 1
        if ep == 1 and self.experts_per_rank != self.num_experts:
            raise RuntimeError("MoELayer built for ep>1 used outside SPMD")
        return _moe_op()(x, self.gate.weight, self.w_up, self.b_up,
                         self.w_down, self.b_down, axis=self.axis,
                         e_total=self.num_experts,
                         e_local=self.experts_per_rank,
                         cap_factor=self.capacity_factor)
