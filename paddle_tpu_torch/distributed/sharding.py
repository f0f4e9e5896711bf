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

ZeRO (``zero_dp``): every parameter not already tp-sharded shards dim 0
over dp in the specs; ``group_sharded_parallel`` and a fleet strategy's
``sharding`` mark the model and optimizer, and ``Model.fit`` then runs
its update through ``ZeroStep``: a reduce-scatter of the gradients over
dp, an update of this rank's shard of the f32 masters and slots, and an
all-gather of the parameters. There the shard of a parameter is a 1/dp
chunk of its flattened values, padded with zeros to a multiple of dp, so
a rank's master shard is the same bytes as that slice of the whole
master.
"""
from __future__ import annotations

import re

import torch

from ..core import monitor as _monitor
from . import mesh as mesh_mod
from .mesh import P, PartitionSpec

__all__ = ["param_spec_for", "build_param_shardings", "COLUMN_PARALLEL",
           "ROW_PARALLEL", "VOCAB_PARALLEL", "add_tp_rule",
           "remove_tp_rule", "shard_optimizer_state",
           "group_sharded_parallel", "named_param_specs", "mesh_like",
           "to_placements", "ParamSharding", "ZeroStep", "PartitionSpec",
           "P"]

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


class ParamSharding:
    """A parameter's sharding on a mesh: its PartitionSpec (non-dividing
    axes dropped) and the DTensor placements of that spec."""

    def __init__(self, spec, mesh):
        self.spec = spec
        self.mesh = mesh
        self.placements = to_placements(spec, mesh)

    def __eq__(self, other):
        return isinstance(other, ParamSharding) and self.spec == other.spec

    def __repr__(self):
        return f"ParamSharding({self.spec!r}, {self.placements!r})"


def build_param_shardings(params, mesh=None, zero_dp=False):
    """{name: ParamSharding} of a {name: tensor} tree by the TP presets
    (and ZeRO's dp rule with ``zero_dp``) on ``mesh`` (the default mesh,
    else a pure dp mesh over the world)."""
    m = mesh_like(mesh) if mesh is not None else mesh_mod.auto_mesh()
    out = {}
    for name, v in params.items():
        spec = param_spec_for(name, len(v.shape), m, zero_dp=zero_dp)
        spec = _validate_divisible(spec, tuple(v.shape), m, name=name)
        out[name] = ParamSharding(spec, m)
    return out


def shard_optimizer_state(slot_tree, param_shardings):
    """Optimizer slots inherit their parameter's sharding."""
    return {k: {s: param_shardings[k] for s in slots}
            for k, slots in slot_tree.items()}


def group_sharded_parallel(model, optimizer, level="os_g", scaler=None):
    """paddle.distributed.sharding.group_sharded_parallel: marks the model
    and optimizer for ZeRO sharded data parallel ("os", "os_g" and
    "p_g_os" all run ``Model.fit``'s sharded step: the gradients
    reduce-scattered, the masters and slots sharded; the parameters are
    gathered whole after each update)."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"group_sharded_parallel level {level!r}: choose "
                         "'os', 'os_g' or 'p_g_os'")
    model._zero_dp = True
    if optimizer is not None:
        optimizer._zero_dp = True
    return model, optimizer, scaler


class _ShardedGlobalNorm:
    """ClipGradByGlobalNorm over gradient shards: the squares summed over
    dp, then the same scale as the whole-gradient clip."""

    def __init__(self, clip, pg):
        self.clip_norm = clip.clip_norm
        self.pg = pg

    def apply(self, grads, params_meta=None):
        from .collective import _all_reduce_
        if not grads:
            return {}
        sq = torch.stack([g.float().pow(2).sum()
                          for g in grads.values()]).sum()
        _all_reduce_(sq.reshape(1), self.pg)
        norm = sq.sqrt()
        scale = torch.where(norm > self.clip_norm,
                            self.clip_norm / norm.clamp_min(1e-12),
                            torch.ones_like(norm))
        return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}


def _by_dtype(named):
    """[[(name, tensor)] of one dtype], in order."""
    out = {}
    for k, v in named:
        out.setdefault(v.dtype, []).append((k, v))
    return list(out.values())


class ZeroStep:
    """ZeRO's sharded update over the ``dp`` axis of ``mesh``, for the
    trainable ``named`` parameters of ``optimizer``. Chunk r of a
    parameter (length c = ceil(numel / dp)) is rank r's: its slots and f32
    master live here, and the optimizer's whole slots, where it has them,
    are cut to this rank's chunks and dropped from it. Every rank calls
    each method together."""

    def __init__(self, optimizer, named, mesh):
        from ..optimizer.clip import ClipGradByGlobalNorm, ClipGradByValue
        from ..optimizer.optimizer import Lamb
        if isinstance(optimizer, Lamb) or type(optimizer).__name__ in (
                "Lars", "LarsMomentum"):
            raise NotImplementedError(
                f"ZeRO with {type(optimizer).__name__}: its per-tensor "
                "trust ratio needs whole tensors")
        clip = optimizer._grad_clip
        if clip is not None and not isinstance(clip, (ClipGradByGlobalNorm,
                                                      ClipGradByValue)):
            raise NotImplementedError(
                f"ZeRO with {type(clip).__name__}: per-tensor norms need "
                "whole gradients (ClipGradByGlobalNorm and ClipGradByValue "
                "run on the shards)")
        self.optimizer = optimizer
        self.mesh = mesh
        self.dp = int(mesh.shape["dp"])
        self.rank = mesh.axis_index("dp")
        self.pg, self.ranks = mesh.group("dp")
        self.clip = _ShardedGlobalNorm(clip, self.pg) \
            if isinstance(clip, ClipGradByGlobalNorm) else None
        self.layout, self.slots = {}, {}
        for name, p in named:
            n = p.numel()
            self.layout[name] = (n, -(-n // self.dp))
            whole = optimizer._slots.pop(name, None)
            if whole is None:
                shard = self.chunk(name, p.detach())
                sl = optimizer._init_slots_for(name, shard)
                if optimizer._multi_precision and shard.dtype in (
                        torch.float16, torch.bfloat16):
                    sl["master"] = shard.float()
            else:
                sl = {k: self.chunk(name, v) for k, v in whole.items()}
            self.slots[name] = sl

    def chunk(self, name, t):
        """This rank's chunk of ``t`` (parameter ``name``'s shape)
        flattened and zero-padded."""
        n, c = self.layout[name]
        flat, r = t.reshape(-1), self.rank
        part = flat[min(r * c, n):min((r + 1) * c, n)]
        if part.numel() < c:
            part = torch.cat([part, flat.new_zeros(c - part.numel())])
        return part.clone()

    def reduce_scatter(self, grads):
        """{name: this rank's chunk of the gradient summed over dp}: per
        dtype one reduce-scatter of the gradients laid out [dp, chunks]."""
        from . import collective as C
        out = {}
        for group in _by_dtype(grads.items()):
            rows = []
            for k, g in group:
                n, c = self.layout[k]
                flat = g.reshape(-1)
                if c * self.dp > n:
                    flat = torch.cat([flat, flat.new_zeros(c * self.dp - n)])
                rows.append(flat.reshape(self.dp, c))
            buf = torch.cat(rows, 1).reshape(-1).contiguous()
            with mesh_mod.MeshGuard(self.mesh):
                mine = C._reduce_scatter_raw.raw(buf, "dp", "sum")
            off = 0
            for k, _ in group:
                c = self.layout[k][1]
                out[k] = mine[off:off + c]
                off += c
        _monitor.stat_add("zero.reduce_scatter_bytes",
                          sum(g.numel() * g.element_size()
                              for g in grads.values()))
        return out

    def update(self, named, grad_chunks, lr, t):
        """This rank's new parameter chunks from its gradient chunks; the
        slots advance."""
        opt = self.optimizer
        new_p, self.slots = opt.apply_gradients_pure(
            {k: self.chunk(k, p.detach()) for k, p in named}, grad_chunks,
            self.slots, lr, t, param_meta=opt._param_meta(dict(named)),
            grad_clip=self.clip)
        return new_p

    def all_gather(self, named, chunks):
        """Write the parameters whole from every rank's new chunks: per
        dtype one all-gather."""
        from . import collective as C
        params = dict(named)
        for group in _by_dtype(chunks.items()):
            buf = torch.cat([v for _, v in group]).contiguous()
            parts = C._gather_list(buf, self.pg, self.ranks)
            off = 0
            for k, _ in group:
                n, c = self.layout[k]
                whole = torch.cat([pt[off:off + c] for pt in parts])[:n]
                params[k].detach().copy_(whole.view(params[k].shape))
                off += c

    def state_bytes(self):
        """Bytes of this rank's chunks of the optimizer state."""
        return sum(v.numel() * v.element_size()
                   for sl in self.slots.values() for v in sl.values())

    def consolidate(self, shapes):
        """Gather the slot chunks whole into the optimizer (an all-gather
        a slot), ``shapes`` {name: the parameter's shape}."""
        from . import collective as C
        for name, sl in self.slots.items():
            n, _ = self.layout[name]
            self.optimizer._slots[name] = {
                k: torch.cat(C._gather_list(v.contiguous(), self.pg,
                                            self.ranks))[:n]
                .reshape(shapes[name]) for k, v in sl.items()}
