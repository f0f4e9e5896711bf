"""Sharding rules: the tensor-parallel presets by parameter name
(paddle_tpu/distributed/sharding.py), device-free.

A rule gives a parameter a ``PartitionSpec`` (one mesh axis or None per
dim) by name pattern; ``to_placements`` turns a spec into DTensor
placements (``Shard(d)`` / ``Replicate()``, one per mesh axis) for
``torch.distributed.tensor``. Conventions (a Linear weight is [in, out]):

  column-parallel (shard the output dim): qkv / q / k / v projections,
                                          ffn up-projection
  row-parallel (shard the input dim):     attention out-projection, ffn
                                          down-projection
  vocab-parallel (shard rows):            word embeddings / tied LM head

``build_param_shardings``, ``shard_optimizer_state`` and
``group_sharded_parallel`` (ZeRO) wait for ROADMAP Queue 1 item 7b, with
hapi's ZeRO.
"""
from __future__ import annotations

import re

from . import mesh as mesh_mod
from .mesh import P, PartitionSpec

__all__ = ["param_spec_for", "build_param_shardings", "COLUMN_PARALLEL",
           "ROW_PARALLEL", "VOCAB_PARALLEL", "add_tp_rule",
           "remove_tp_rule", "shard_optimizer_state",
           "group_sharded_parallel", "named_param_specs", "mesh_like",
           "to_placements", "PartitionSpec", "P"]

_ITEM_7B = "waits for ROADMAP Queue 1 item 7b (ZeRO, with hapi's fleet " \
           "strategy)"

COLUMN_PARALLEL = [
    r"qkv_proj\.weight$", r"q_proj\.weight$", r"k_proj\.weight$",
    r"v_proj\.weight$", r"linear1\.weight$", r"fc1\.weight$",
    r"mlm_transform\.weight$",
]
COLUMN_PARALLEL_BIAS = [
    r"qkv_proj\.bias$", r"q_proj\.bias$", r"k_proj\.bias$",
    r"v_proj\.bias$", r"linear1\.bias$", r"fc1\.bias$",
    r"mlm_transform\.bias$",
]
ROW_PARALLEL = [
    r"out_proj\.weight$", r"linear2\.weight$", r"fc2\.weight$",
]
VOCAB_PARALLEL = [
    r"word_embeddings\.weight$", r"wte\.weight$",
]

_extra_rules = []  # (regex, P | spec_builder(ndim) -> P)


def add_tp_rule(pattern: str, spec):
    """Register a custom tensor-parallel rule (the last added wins).
    ``spec`` is a PartitionSpec or a callable ``(ndim) -> P``; a fixed
    spec with more entries than the parameter has dims raises when the
    rule matches, naming the rule."""
    _extra_rules.append((re.compile(pattern), spec))


def remove_tp_rule(pattern: str) -> int:
    """Unregister every rule added for ``pattern``; returns how many."""
    before = len(_extra_rules)
    _extra_rules[:] = [(rx, sp) for rx, sp in _extra_rules
                       if rx.pattern != pattern]
    return before - len(_extra_rules)


def _resolve_rule_spec(rx, spec, name, ndim) -> P:
    spec = spec(ndim) if callable(spec) else spec
    if spec is None:
        spec = P()
    if len(tuple(spec)) > ndim:
        raise ValueError(
            f"tp rule {rx.pattern!r} produced PartitionSpec {spec} with "
            f"{len(tuple(spec))} entries for rank-{ndim} param {name!r} — "
            "register a callable spec builder (ndim -> P) or scope the "
            "pattern to params of the right rank")
    return spec


def _match(name, patterns):
    return any(re.search(p, name) for p in patterns)


def param_spec_for(name: str, ndim: int, mesh=None,
                   zero_dp: bool = False) -> P:
    """PartitionSpec for a parameter by name pattern."""
    m = mesh or mesh_mod.get_mesh()
    axes = set(m.axis_names) if m is not None else set()
    has_tp = "tp" in axes

    for rx, spec in reversed(_extra_rules):
        if rx.search(name):
            return _resolve_rule_spec(rx, spec, name, ndim)
    if has_tp and ndim >= 2:
        if _match(name, COLUMN_PARALLEL):
            return P(*([None] * (ndim - 1) + ["tp"]))
        if _match(name, ROW_PARALLEL):
            return P(*(["tp"] + [None] * (ndim - 1)))
        if _match(name, VOCAB_PARALLEL):
            return P(*(["tp"] + [None] * (ndim - 1)))
    if has_tp and ndim == 1 and _match(name, COLUMN_PARALLEL_BIAS):
        return P("tp")
    if zero_dp and "dp" in axes and ndim >= 1:
        return P(*(["dp"] + [None] * (ndim - 1)))
    return P()


def _validate_divisible(spec: P, shape, mesh, name: str = None) -> P:
    """Drop axis shardings that do not divide the dim (replication for
    that dim), counting each in ``sharding.nondivisible_fallback``; a spec
    with more entries than the tensor has dims raises."""
    entries = tuple(spec)
    if len(entries) > len(shape):
        raise ValueError(
            f"PartitionSpec {spec} has {len(entries)} entries but "
            f"{'param ' + repr(name) + ' ' if name else ''}shape "
            f"{tuple(shape)} has only {len(shape)} dims — trailing axes "
            "would be silently dropped")
    new = []
    for dim, ax in zip(shape,
                       entries + (None,) * (len(shape) - len(entries))):
        if ax is None:
            new.append(None)
        else:
            axes = (ax,) if isinstance(ax, str) else tuple(ax)
            size = 1
            for a in axes:
                size *= mesh.shape[a] if a in mesh.axis_names else 1
            if dim % size == 0:
                new.append(ax)
            else:
                from ..core import monitor as _monitor
                _monitor.stat_add("sharding.nondivisible_fallback")
                new.append(None)
    return P(*new)


def mesh_like(mesh):
    """A Mesh passes through; an {axis: size} dict (tier grammar
    accepted) becomes a stand-in with ``axis_names`` / ``shape``; None is
    the registered default."""
    if mesh is None:
        return mesh_mod.get_mesh()
    if isinstance(mesh, dict):
        from types import SimpleNamespace
        return SimpleNamespace(axis_names=tuple(mesh),
                               shape=mesh_mod.axis_sizes(mesh))
    return mesh


def named_param_specs(layer, mesh=None, zero_dp=False, by="storage"):
    """{storage name or dotted path: PartitionSpec} for a Layer's
    parameters (by="storage": a static parameter's scope name or the
    parameter's name; by="dotted": the module path)."""
    mesh = mesh_like(mesh)
    out = {}
    for dotted, p in layer.named_parameters():
        spec = param_spec_for(dotted, len(p.shape), mesh, zero_dp=zero_dp)
        key = dotted if by == "dotted" else (
            getattr(p, "scope_name", None) or getattr(p, "name", dotted))
        out[key] = spec
    return out


def to_placements(spec: P, mesh, shape=None):
    """DTensor placements of ``spec`` on ``mesh``: per mesh axis,
    ``Shard(d)`` for the dim it shards, else ``Replicate()``. With
    ``shape``, non-dividing axes fall back to replication first
    (``_validate_divisible``)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = mesh_like(mesh)
    if shape is not None:
        spec = _validate_divisible(spec, shape, mesh)
    out = []
    for axis in mesh.axis_names:
        dim = None
        for d, entry in enumerate(tuple(spec)):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            if axis in axes:
                dim = d
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def build_param_shardings(params, mesh=None, zero_dp=False):
    raise NotImplementedError(f"build_param_shardings {_ITEM_7B}")


def shard_optimizer_state(slot_tree, param_shardings):
    raise NotImplementedError(f"shard_optimizer_state {_ITEM_7B}")


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None):
    raise NotImplementedError(f"group_sharded_parallel {_ITEM_7B}")
