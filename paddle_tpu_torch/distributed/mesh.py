"""Named-mesh registry over ``torch.distributed``
(paddle_tpu/distributed/mesh.py).

The JAX package is single-controller: one process holds an N-device mesh
and ``shard_map`` runs its body once per shard. The port is multi-process
SPMD: one process per mesh position, and a ``Mesh`` is a named view of the
world's ranks (rank r sits at the row-major coordinates of r in the mesh
shape), so a mesh's size must equal the world size. Each axis's process
groups (one per line of ranks along it) come from ``dist.new_group``,
made on first use in the same order on every rank.

``shard_map(f, mesh, in_specs, out_specs)`` keeps JAX's global-in /
global-out contract: every rank passes the global tensors, the wrapper
takes the rank's shard by ``in_specs``, runs ``f`` with the mesh's axes
bound (``in_spmd_region``), and gathers each output by ``out_specs``, so
every rank returns the global result. The gather carries gradients back
to each rank's shard, and an input's sharded dims gather their
gradients back, so every rank holds the global gradient too.

Axis-name conventions: dp data, tp tensor, pp pipeline, sp sequence, ep
expert parallel.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["init_mesh", "init_hybrid_mesh", "get_mesh", "set_mesh",
           "reset_mesh", "mesh_axis_size", "in_spmd_region", "MeshGuard",
           "auto_mesh", "shard_map", "axis_sizes", "axis_tiers",
           "LINK_TIERS", "DEFAULT_TIER", "Mesh", "PartitionSpec", "P",
           "axis_index", "world_rank", "world_size"]

# ---------------------------------------------------------------------------
# two-tier topology grammar: an axis value is an int size (tier "ici") or
# {"size": 2, "tier": "dcn"[, "gbps": 50.0]}. "ici" is the link within a
# node (NVLink on the H100), "dcn" the network between nodes; their
# default bandwidths are FLAGS_topology_{ici,dcn}_gbps.
# ---------------------------------------------------------------------------

LINK_TIERS = ("ici", "dcn")
DEFAULT_TIER = "ici"


def _tier_gbps(tier: str) -> float:
    from ..core.flags import flag as _flag
    if tier == "dcn":
        return float(_flag("FLAGS_topology_dcn_gbps"))
    return float(_flag("FLAGS_topology_ici_gbps"))


def _axis_entry(value):
    """(size, tier_meta | None) for one axis value of a mesh description."""
    if isinstance(value, dict):
        size = int(value.get("size", 1))
        tier = str(value.get("tier", DEFAULT_TIER))
        if tier not in LINK_TIERS:
            raise ValueError(
                f"unknown link tier {tier!r} (choose from {LINK_TIERS})")
        gbps = float(value.get("gbps", _tier_gbps(tier)))
        return size, {"tier": tier, "gbps": gbps}
    return int(value), None


def axis_sizes(shape: Dict[str, object]) -> Dict[str, int]:
    """{axis: int} from a mesh description dict, tier grammar accepted."""
    return {str(k): _axis_entry(v)[0] for k, v in shape.items()}


def axis_tiers(mesh_or_shape) -> Dict[str, dict]:
    """{axis: {"tier": str, "gbps": float}} for every axis of a mesh
    description dict or a Mesh; axes without a declared tier get the
    "ici" default."""
    out: Dict[str, dict] = {}
    if mesh_or_shape is None:
        return out
    if isinstance(mesh_or_shape, dict):
        for k, v in mesh_or_shape.items():
            _, meta = _axis_entry(v)
            out[str(k)] = meta or {"tier": DEFAULT_TIER,
                                   "gbps": _tier_gbps(DEFAULT_TIER)}
        return out
    declared = dict(getattr(mesh_or_shape, "_link_tiers", {}) or {})
    for name in getattr(mesh_or_shape, "axis_names", ()):
        meta = declared.get(name)
        if isinstance(meta, str):
            meta = {"tier": meta, "gbps": _tier_gbps(meta)}
        out[str(name)] = dict(meta) if meta else \
            {"tier": DEFAULT_TIER, "gbps": _tier_gbps(DEFAULT_TIER)}
    return out


class PartitionSpec(tuple):
    """One entry per tensor dim: None (not sharded), an axis name or a
    tuple of axis names (jax.sharding.PartitionSpec's layout)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _dist_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if _dist_up() else 1


def world_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if _dist_up() else 0


_pg_lock = threading.Lock()
_pgs: Dict[tuple, object] = {}


def _new_group(ranks):
    """The process group of ``ranks`` (global ranks, in order), made once:
    None for the whole world. Every rank must ask for the same groups in
    the same order (``dist.new_group`` is collective over the world)."""
    import torch.distributed as dist
    key = tuple(int(r) for r in ranks)
    if len(key) == world_size() and sorted(key) == list(key):
        return None
    with _pg_lock:
        if key not in _pgs:
            _pgs[key] = dist.new_group(list(key))
        return _pgs[key]


class Mesh:
    """A named view of the world's ranks: ``devices`` holds the global
    rank at each coordinate (row-major), ``shape`` {axis: size}."""

    def __init__(self, shape: Dict[str, int], tiers=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        sizes = [int(s) for s in self.shape.values()]
        self.devices = np.arange(int(np.prod(sizes)) if sizes else 1) \
            .reshape(sizes)
        self._link_tiers = dict(tiers or {})

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        rank = world_rank() if rank is None else int(rank)
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """Row-major index of ``rank`` over ``axes`` (a name or a tuple)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def lines(self, axes) -> List[List[int]]:
        """The groups of global ranks that differ only along ``axes``,
        each in row-major order over ``axes``; the groups in the order of
        their first rank."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in pos]
        arr = np.transpose(self.devices, rest + pos)
        n = int(np.prod([self.devices.shape[p] for p in pos])) if pos else 1
        return [list(map(int, row)) for row in arr.reshape(-1, n)]

    def line(self, axes, rank: Optional[int] = None) -> List[int]:
        rank = world_rank() if rank is None else int(rank)
        for ln in self.lines(axes):
            if rank in ln:
                return ln
        raise ValueError(f"rank {rank} is not in the mesh {self.shape}")

    def group(self, axes, members=None):
        """(process group, global ranks) of this rank's line along
        ``axes``, cut to the axis indices ``members`` when given; the
        group is None for the world, and the ranks [] when this rank is
        not a member. Makes every line's group on first use."""
        me = world_rank()
        mine = None
        for ln in self.lines(axes):
            ranks = ln if members is None else [ln[m] for m in members]
            pg = _new_group(ranks) if len(ranks) > 1 else None
            if me in ranks:
                mine = (pg, ranks)
        return mine if mine is not None else (None, [])

    def __repr__(self):
        return f"Mesh({self.shape})"


_lock = threading.Lock()
_meshes: Dict[str, Mesh] = {}
_default_name: Optional[str] = None


def init_mesh(shape: Dict[str, int] = None, name: str = "default",
              devices=None) -> Mesh:
    """Declare a named mesh over the world's ranks (the c_comm_init
    analog). ``shape``: ordered {axis: size}, tier grammar accepted; its
    product must equal the world size (one process per mesh position).
    Defaults to a pure data-parallel mesh over the world."""
    global _default_name
    n = world_size()
    if shape is None:
        shape = {"dp": n}
    tiers = {k: m for k, m in
             ((k, _axis_entry(v)[1]) for k, v in shape.items()) if m}
    sizes = axis_sizes(shape)
    need = int(np.prod(list(sizes.values()))) if sizes else 1
    if need != n:
        raise ValueError(
            f"mesh shape {sizes} holds {need} ranks but the world has {n}: "
            "the port runs one process per mesh position (start the ranks "
            "with distributed.spawn or init_parallel_env)")
    mesh = Mesh(sizes, tiers)
    with _lock:
        _meshes[name] = mesh
        if _default_name is None or name == "default":
            _default_name = name
    return mesh


def init_hybrid_mesh(ici_shape: Dict[str, int],
                     dcn_shape: Dict[str, int] = None,
                     name: str = "default") -> Mesh:
    """A mesh with between-node ("dcn") axes outermost over per-node
    ("ici") axes: ranks are grouped by node (``PADDLE_LOCAL_SIZE`` ranks
    a node, default the whole world in one node), so collectives over the
    inner axes stay inside a node.

      init_hybrid_mesh({"tp": 4}, {"dp": 2})   # 2 nodes x 4 cards
    """
    import os
    n = world_size()
    per_node = int(os.environ.get("PADDLE_LOCAL_SIZE", n))
    if n % per_node:
        raise ValueError(f"uneven nodes: {n} ranks, {per_node} a node")
    n_nodes = n // per_node
    if dcn_shape is None:
        dcn_shape = {"dp": n_nodes}
    overlap = set(dcn_shape) & set(ici_shape)
    if overlap:
        raise ValueError(
            f"axis name(s) {sorted(overlap)} appear in both dcn_shape and "
            "ici_shape; hybrid axes must be distinct (e.g. dp over DCN, "
            "tp/sp over ICI)")
    need_dcn = int(np.prod(list(axis_sizes(dcn_shape).values())))
    need_ici = int(np.prod(list(axis_sizes(ici_shape).values())))
    if need_dcn != n_nodes:
        raise ValueError(f"dcn_shape {dcn_shape} needs {need_dcn} nodes, "
                         f"have {n_nodes}")
    if need_ici != per_node:
        raise ValueError(f"ici_shape {ici_shape} needs {need_ici} ranks a "
                         f"node, have {per_node}")
    shape = dict(axis_sizes(dcn_shape))
    shape.update(axis_sizes(ici_shape))
    mesh = Mesh(shape, {ax: {"tier": "dcn", "gbps": _tier_gbps("dcn")}
                        for ax in dcn_shape})
    return set_mesh(mesh, name)


def set_mesh(mesh: Mesh, name: str = "default"):
    global _default_name
    with _lock:
        _meshes[name] = mesh
        _default_name = name
    return mesh


def reset_mesh(name: str = None):
    """Drop a registered mesh (all of them when name is None)."""
    global _default_name
    with _lock:
        if name is None:
            _meshes.clear()
            _default_name = None
        else:
            _meshes.pop(name, None)
            if _default_name == name:
                _default_name = next(iter(_meshes), None)


def get_mesh(name: str = None) -> Optional[Mesh]:
    with _lock:
        if name is not None:
            return _meshes.get(name)
        if _default_name is not None:
            return _meshes.get(_default_name)
    return None


def auto_mesh() -> Mesh:
    """Get-or-create the default mesh (pure DP over the world)."""
    m = get_mesh()
    if m is None:
        m = init_mesh()
    return m


# ---------------------------------------------------------------------------
# SPMD regions
# ---------------------------------------------------------------------------

_region = threading.local()


def _bound() -> Optional[Mesh]:
    stack = getattr(_region, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def _spmd(mesh: Mesh):
    stack = getattr(_region, "stack", None)
    if stack is None:
        stack = _region.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def region_mesh(axis: str = None) -> Optional[Mesh]:
    """The mesh bound by the innermost shard_map region (holding
    ``axis``), else None."""
    m = _bound()
    if m is None or (axis is not None and axis not in m.axis_names):
        return None
    return m


def mesh_axis_size(axis: str, name: str = None) -> int:
    """Size of a mesh axis: the bound region's mesh inside shard_map,
    else the registered mesh's (1 when the axis is absent)."""
    m = region_mesh(axis)
    if m is not None:
        return int(m.shape[axis])
    m = get_mesh(name)
    if m is None or axis not in m.axis_names:
        return 1
    return int(m.shape[axis])


def axis_index(axis) -> int:
    """This rank's index along ``axis`` (a name or a tuple) of the bound
    region's mesh (lax.axis_index)."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    m = region_mesh(names[0])
    if m is None:
        return 0
    return m.axis_index(names)


def in_spmd_region(axis: str = None) -> bool:
    """True inside a shard_map region where ``axis`` is bound (any axis
    when None)."""
    m = _bound()
    if m is None:
        return False
    return axis is None or axis in m.axis_names


class MeshGuard:
    """``with MeshGuard(mesh):`` binds the mesh's axes for the block, as
    a shard_map region does."""

    def __init__(self, mesh: Mesh = None, name: str = None):
        self.name = name
        self.mesh = mesh or get_mesh(name)

    def __enter__(self):
        if self.mesh is None:
            with _lock:
                have = sorted(_meshes)
            want = self.name if self.name is not None else "<default>"
            raise RuntimeError(
                f"MeshGuard: no mesh named {want!r} in the mesh registry "
                f"(registered: {have or 'none'}). Declare one with "
                "init_mesh({'dp': n, ...}) / init_hybrid_mesh(...) or "
                "pass a Mesh explicitly: MeshGuard(mesh)")
        self._cm = _spmd(self.mesh)
        self._cm.__enter__()
        return self.mesh

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


# ---------------------------------------------------------------------------
# shard_map: global in, global out
# ---------------------------------------------------------------------------

def _dim_axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _narrow_local(x, spec, mesh: Mesh):
    for d, entry in enumerate(tuple(spec)):
        axes = _dim_axes(entry)
        if not axes:
            continue
        n = int(np.prod([mesh.shape[a] for a in axes]))
        if x.shape[d] % n:
            raise ValueError(f"shard_map: dim {d} of size {x.shape[d]} is "
                             f"not divisible by axes {axes} of size {n}")
        chunk = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(axes) * chunk, chunk)
    return x


class _ShardIn(torch.autograd.Function):
    """This rank's shard of a global input; the backward gathers the
    shards' gradients along each sharded dim, so every rank holds the
    global input's whole gradient (a replicated dim's is whole on each
    rank already)."""

    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _narrow_local(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        from . import collective
        for d, entry in reversed(list(enumerate(tuple(ctx.spec)))):
            axes = _dim_axes(entry)
            if axes and int(np.prod([ctx.mesh.shape[a] for a in axes])) > 1:
                pg, ranks = ctx.mesh.group(axes)
                g = torch.cat(collective._gather_list(g.contiguous(), pg,
                                                      ranks), d)
        return g, None, None


def _local_shard(x, spec, mesh: Mesh):
    if not isinstance(x, torch.Tensor) or spec is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad and any(
            _dim_axes(e) for e in tuple(spec)):
        return _ShardIn.apply(x, spec, mesh)
    return _narrow_local(x, spec, mesh)


class _GatherCat(torch.autograd.Function):
    """All-gather along ``dim`` over ``ranks``' group, concatenated in
    rank order; the backward takes this rank's slice of the gradient
    (every rank holds the same global gradient)."""

    @staticmethod
    def forward(ctx, x, dim, axes, mesh):
        from . import collective
        pg, ranks = mesh.group(axes)
        parts = collective._gather_list(x.contiguous(), pg, ranks)
        ctx.dim, ctx.index, ctx.size = dim, ranks.index(world_rank()), \
            x.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


def gather_cat(x, dim, axes, mesh: Mesh):
    """``x`` gathered along ``dim`` over the ranks of this rank's line
    along ``axes``, in order; differentiable."""
    from ..ops._dispatch import retype_in_place
    return retype_in_place(_GatherCat.apply(x, dim, axes, mesh), None)


def _global_out(y, spec, mesh: Mesh):
    if not isinstance(y, torch.Tensor) or spec is None:
        return y
    for d, entry in enumerate(tuple(spec)):
        axes = _dim_axes(entry)
        if axes and int(np.prod([mesh.shape[a] for a in axes])) > 1:
            y = gather_cat(y, d, axes, mesh)
    return y


def _prefix_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a pytree, ``specs`` a prefix of it (one
    PartitionSpec for a whole subtree, as shard_map's specs are)."""
    import torch.utils._pytree as pytree
    if specs is None or isinstance(specs, PartitionSpec):
        return pytree.tree_map(lambda leaf: fn(leaf, specs), tree)
    if isinstance(tree, (list, tuple)) and isinstance(specs, (list, tuple)):
        if len(tree) != len(specs):
            raise ValueError(f"shard_map: {len(specs)} specs for "
                             f"{len(tree)} values")
        out = [_prefix_map(fn, t, s) for t, s in zip(tree, specs)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if isinstance(tree, dict) and isinstance(specs, dict):
        return {k: _prefix_map(fn, tree[k], specs[k]) for k in tree}
    raise TypeError(f"shard_map: specs {specs!r} do not match {type(tree)}")


def shard_map(f, mesh=None, in_specs=None, out_specs=None, check=False):
    """``f`` run per rank on its shards of global inputs, its outputs
    gathered back to global ones on every rank."""
    def wrapped(*args):
        m = mesh or auto_mesh()
        local = _prefix_map(lambda x, s: _local_shard(x, s, m), tuple(args),
                            in_specs if not isinstance(in_specs, list)
                            else tuple(in_specs))
        with _spmd(m):
            out = f(*local)
        return _prefix_map(lambda y, s: _global_out(y, s, m), out,
                           out_specs)
    return wrapped
