"""Collective communication (paddle_tpu/distributed/collective.py) over
``torch.distributed``.

Inside an SPMD region (``mesh.shard_map`` or ``MeshGuard``) a collective
runs over the process group of this rank's line along the named mesh axis
(``Group`` narrows it to a subset of the axis indices: members reduce
among themselves, the others keep their own value). Outside a region, or
when the axis has size 1, a collective is the identity, as the JAX
package's are with one process; over a larger axis it raises.

Transport: ``nccl`` where each rank has its own card, ``gloo`` on the CPU
and where ranks share one card (NCCL refuses two ranks on one device).
gloo takes CUDA tensors for some ops only, so for a CUDA tensor on a gloo
group the port probes each op once (``transport_table``; every rank must
make its first collective on a CUDA tensor together) and stages the ops
gloo refuses through pinned host buffers, counted in the monitor counter
``dist.staged_bytes``. Point-to-point ops are staged on gloo by rule:
gloo's send and recv read the tensor's pointer as host memory. The
kernels still run on the card; only the bytes between ranks move through
the host. Reduce-scatter is probed on host tensors too, since gloo has it
on some torch versions only; where it is missing it is an all-reduce,
then the chunk.
"""
from __future__ import annotations

import torch

from ..core import monitor
from ..core.tensor import Tensor
from ..ops._dispatch import defop
from . import mesh as mesh_mod
from .env import get_world_size

__all__ = ["ReduceOp", "all_reduce", "all_gather", "all_gather_object",
           "reduce", "broadcast", "scatter", "alltoall", "reduce_scatter",
           "hierarchical_all_reduce", "send", "recv", "p2p_permute",
           "barrier", "split", "new_group", "wait", "get_group", "Group",
           "transport_table", "probe_transport", "copy_to_region"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A mesh axis, or a subset of its indices (the JAX package's
    ``axis_index_groups`` partition: [members] + singletons)."""

    def __init__(self, axis_name="dp", ranks=None, group_id=0):
        self.axis = axis_name
        self.ranks = sorted(ranks) if ranks is not None else None
        self.id = group_id

    @property
    def nranks(self):
        if self.ranks is not None:
            return len(self.ranks)
        return mesh_mod.mesh_axis_size(self.axis)

    def get_group_rank(self, rank):
        if self.ranks is not None:
            return self.ranks.index(rank) if rank in self.ranks else -1
        return rank

    def index_groups(self):
        """[members] + singletons over the axis; None for the whole axis."""
        if self.ranks is None:
            return None
        n = mesh_mod.mesh_axis_size(self.axis)
        if list(self.ranks) == list(range(n)):
            return None
        others = [[r] for r in range(n) if r not in self.ranks]
        return [list(self.ranks)] + others


_groups = {0: Group("dp", group_id=0)}


def new_group(ranks=None, backend=None, axis_name="dp"):
    gid = max(_groups) + 1
    g = Group(axis_name, ranks, gid)
    _groups[gid] = g
    return g


def get_group(gid=0):
    return _groups.get(gid)


def _axis_of(group) -> str:
    if group is None or group == 0:
        return "dp"
    if isinstance(group, Group):
        return group.axis
    if isinstance(group, str):
        return group
    return "dp"


def _groups_of(group):
    return group.index_groups() if isinstance(group, Group) else None


def _hashable(groups):
    if groups is None:
        return None
    return tuple(tuple(g) for g in groups)


def _in_region(axis):
    return mesh_mod.in_spmd_region(axis)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

# the collectives the port is built on; gloo's point-to-point ops are
# staged by rule and not probed
PRIMITIVES = ("all_reduce", "all_gather", "broadcast", "all_to_all",
              "reduce_scatter")
_transport = {}     # device type -> {op: mode}


def _backend(pg=None) -> str:
    import torch.distributed as dist
    return str(dist.get_backend(pg)).lower()


def _reduce_scatter_fn():
    import torch.distributed as dist
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


def _run_primitive(op, x, pg, ranks):
    import torch.distributed as dist
    n = len(ranks)
    if op == "all_reduce":
        dist.all_reduce(x, group=pg)
        return x
    if op == "all_gather":
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x, group=pg)
        return out
    if op == "broadcast":
        dist.broadcast(x, src=ranks[0], group=pg)
        return x
    if op == "reduce_scatter":
        out = x.new_empty(x.shape[0] // n)
        _reduce_scatter_fn()(out, x, group=pg)
        return out
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=pg)
    return out


def _runs(op, x, ranks):
    try:
        _run_primitive(op, x, None, ranks)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        return True
    except (RuntimeError, ValueError, NotImplementedError):
        return False


def probe_transport(device=None):
    """Probe once per device type how the installed torch's backend moves
    each primitive: {op: "native" | "staged" | "all_reduce"}. "staged"
    goes through pinned host buffers (gloo on CUDA tensors; p2p by rule);
    "all_reduce" is reduce_scatter where the backend has none: an
    all-reduce, then the chunk. A collective call: every rank calls it
    together (the first collective on a CUDA tensor does, and the first
    reduce_scatter)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type in _transport:
        return dict(_transport[device.type])
    if not mesh_mod._dist_up():
        return {}
    ranks = list(range(mesh_mod.world_size()))
    n = len(ranks)
    if _backend() != "gloo":
        table = {op: "native" for op in PRIMITIVES + ("p2p",)}
    elif device.type != "cuda":
        # gloo has every primitive on host tensors but reduce-scatter,
        # which only some torch versions give it
        table = {op: "native" for op in PRIMITIVES + ("p2p",)}
        if not _runs("reduce_scatter", torch.ones(n), ranks):
            table["reduce_scatter"] = "all_reduce"
    else:
        table = {}
        for op in PRIMITIVES:
            if _runs(op, torch.ones(n, device=device), ranks):
                table[op] = "native"
            elif op != "reduce_scatter" or _runs(op, torch.ones(n), ranks):
                table[op] = "staged"
            else:
                table[op] = "all_reduce"
        table["p2p"] = "staged"
    _transport[device.type] = table
    return dict(table)


def transport_table(device_type="cuda"):
    """The probed table of ``device_type`` (empty until its first
    collective that probes)."""
    return dict(_transport.get(device_type, {}))


def _mode(op, x):
    """How ``op`` moves ``x`` (``probe_transport``'s modes). CPU tensors
    are probed for reduce_scatter alone: gloo has the rest on the host."""
    if op == "p2p":
        return "staged" if x.is_cuda and _backend() == "gloo" else "native"
    if _backend() != "gloo" or (not x.is_cuda and op != "reduce_scatter"):
        return "native"
    if x.device.type not in _transport:
        probe_transport(x.device)
    return _transport[x.device.type].get(op, "native")


def _staged(op, x):
    return _mode(op, x) == "staged"


def _host(x):
    monitor.stat_add("dist.staged_bytes", x.numel() * x.element_size())
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _reduce_op(op):
    import torch.distributed as dist
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN}[op]


def _all_reduce_(x, pg, op=ReduceOp.SUM):
    """In-place all-reduce of contiguous ``x`` over ``pg``; its bytes
    counted in ``dist.all_reduce_bytes``."""
    import torch.distributed as dist
    monitor.stat_add("dist.all_reduce_bytes", x.numel() * x.element_size())
    if _staged("all_reduce", x):
        h = _host(x)
        dist.all_reduce(h, op=_reduce_op(op), group=pg)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=_reduce_op(op), group=pg)
    return x


def _group_order(ranks):
    """Position in the process group (ranked by global rank) of each of
    ``ranks``, which a multi-axis line lists in its own order."""
    order = sorted(ranks)
    return [order.index(r) for r in ranks]


def _reduce_scatter_(x, pg, ranks, op):
    """This rank's chunk of the reduction of contiguous ``x`` over
    ``pg``: chunk j of dim 0 belongs to ranks[j]."""
    n = len(ranks)
    pos = _group_order(ranks)
    inv = [pos.index(i) for i in range(n)]
    x = x.reshape(n, -1, *x.shape[1:])[inv].reshape(x.shape).contiguous()
    shape = (x.shape[0] // n, *x.shape[1:])
    if _staged("reduce_scatter", x):
        h = _host(x)
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        _reduce_scatter_fn()(out, h, op=_reduce_op(op), group=pg)
        return out.to(x.device)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    _reduce_scatter_fn()(out, x, op=_reduce_op(op), group=pg)
    return out


def _gather_list(x, pg, ranks):
    """[x of each rank in ``ranks``], in that order; this rank's bytes
    counted in ``dist.all_gather_bytes``."""
    import torch.distributed as dist
    if len(ranks) <= 1:
        return [x]
    monitor.stat_add("dist.all_gather_bytes", x.numel() * x.element_size())
    if _staged("all_gather", x):
        h = _host(x)
        out = [torch.empty_like(h) for _ in ranks]
        dist.all_gather(out, h, group=pg)
        out = [o.to(x.device) for o in out]
    else:
        out = [torch.empty_like(x) for _ in ranks]
        dist.all_gather(out, x, group=pg)
    return [out[i] for i in _group_order(ranks)]


def _broadcast_(x, pg, src):
    import torch.distributed as dist
    if _staged("broadcast", x):
        h = _host(x)
        dist.broadcast(h, src=src, group=pg)
        x.copy_(h)
    else:
        dist.broadcast(x, src=src, group=pg)
    return x


def _all_to_all(x, pg, ranks):
    """all_to_all_single over ``ranks``: chunk j of dim 0 goes to
    ranks[j]; chunk j of the result came from it. Counter
    ``dist.all_to_all_bytes``: the bytes of ``x``."""
    import torch.distributed as dist
    pos = _group_order(ranks)
    inv = [pos.index(i) for i in range(len(ranks))]
    x = x.reshape(len(ranks), -1, *x.shape[1:])[inv].reshape(x.shape)
    monitor.stat_add("dist.all_to_all_bytes", x.numel() * x.element_size())
    if _staged("all_to_all", x):
        h = _host(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=pg)
        out = out.to(x.device)
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=pg)
    return out.reshape(len(ranks), -1, *x.shape[1:])[pos].reshape(x.shape)


def _exchange(sends, recvs):
    """Point-to-point: ``sends`` [(tensor, global dst)], ``recvs`` [(buffer,
    global src)]; waits for all."""
    import torch.distributed as dist
    staged = any(_staged("p2p", t) for t, _ in sends + recvs)
    hs = [(_host(t) if staged else t, d) for t, d in sends]
    hr = [(torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
           if staged else b, s) for b, s in recvs]
    works = [dist.irecv(b, src=s) for b, s in hr]
    works += [dist.isend(t, dst=d) for t, d in hs]
    for w in works:
        w.wait()
    if staged:
        for (b, _), (h, _) in zip(recvs, hr):
            monitor.stat_add("dist.staged_bytes", h.numel() * h.element_size())
            b.copy_(h)


# ---------------------------------------------------------------------------
# ops (registry names as the JAX package's)
# ---------------------------------------------------------------------------

def _axis_group(axis, members=None):
    """(pg, global ranks) of this rank's line along ``axis`` of the bound
    mesh, cut to ``members``; ranks [] for a non-member."""
    m = mesh_mod.region_mesh(axis)
    return m.group(axis, members)


def _plain(x):
    return x.detach().as_subclass(torch.Tensor).contiguous()


def _ready(x):
    """``_plain(x)``, with the transport probed first when ``x`` is the
    first CUDA tensor of a gloo job: every rank of a collective calls
    this, members of a subgroup or not, so the probe (a world collective)
    cannot wait on a rank that skips it."""
    y = _plain(x)
    if y.is_cuda and "cuda" not in _transport and mesh_mod._dist_up() \
            and _backend() == "gloo":
        probe_transport(y.device)
    return y


def _wants_grad(x):
    return torch.is_grad_enabled() and isinstance(x, torch.Tensor) \
        and x.requires_grad


def _allreduce_plain(x, axis, op, groups=None, mesh=None):
    members = list(groups[0]) if groups else None
    m = mesh or mesh_mod.region_mesh(axis)
    pg, ranks = m.group(axis, members)
    y = _ready(x).clone()
    if len(ranks) <= 1:        # a non-member, or a line of one rank
        return y
    if op == ReduceOp.PROD:
        return torch.prod(torch.stack(_gather_list(y, pg, ranks)), 0)
    if op == ReduceOp.AVG:
        _all_reduce_(y, pg, ReduceOp.SUM)
        return y / len(ranks)
    return _all_reduce_(y, pg, op)


class _AllReduceFn(torch.autograd.Function):
    """psum / pmean over the axis; the result is the same on every rank
    and holds its whole cotangent there, so the backward is the identity
    (over n for the mean)."""

    @staticmethod
    def forward(ctx, x, axis, op, mesh):
        ctx.n = 1 if op == ReduceOp.SUM else mesh.shape[axis]
        return _allreduce_plain(x, axis, op, None, mesh)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.n == 1 else g / ctx.n), None, None, None


class _CopyFn(torch.autograd.Function):
    """The identity whose backward sums the cotangent over the axis: a
    replicated value consumed by each rank as its own."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _allreduce_plain(g, ctx.axis, ReduceOp.SUM, None,
                                ctx.mesh), None, None


def copy_to_region(x, axis):
    """``x`` (the same on every rank of ``axis``) for a per-rank
    consumer: the identity, its gradient summed over ``axis``. Outside a
    region, or over one rank, the identity."""
    m = mesh_mod.region_mesh(axis)
    if m is None or m.shape[axis] == 1 or not _wants_grad(x):
        return x
    return _CopyFn.apply(x, axis, m)


@defop(name="c_allreduce")
def _allreduce_raw(x, axis, op, groups=None):
    """All-reduce over ``axis``, optionally over a subset of its indices
    (``groups[0]``; the others keep their value). PROD is exact: a gather,
    then the product in member order, as the JAX package's is. SUM and
    AVG over the whole axis carry a gradient (``_AllReduceFn``)."""
    if groups is None and op in (ReduceOp.SUM, ReduceOp.AVG) \
            and _wants_grad(x):
        return _AllReduceFn.apply(x, axis, op, mesh_mod.region_mesh(axis))
    return _allreduce_plain(x, axis, op, groups)


def _rebound(tensor, out):
    """Paddle mutates the argument in place (the JAX package rebinds)."""
    if isinstance(tensor, Tensor):
        with torch.no_grad():
            torch.Tensor.copy_(tensor, out)
        return tensor
    return out


def _outside(name, axis):
    raise RuntimeError(
        f"{name} over axis '{axis}' called outside an SPMD region; wrap the "
        "computation in paddle_tpu_torch.distributed.mesh.shard_map (or a "
        "MeshGuard)")


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    axis = _axis_of(group)
    if not _in_region(axis):
        if get_world_size() == 1 or mesh_mod.mesh_axis_size(axis) == 1:
            return tensor  # identity in single-process semantics
        _outside("all_reduce", axis)
    out = _allreduce_raw(tensor, axis=axis, op=op,
                         groups=_hashable(_groups_of(group)))
    return _rebound(tensor, out)


class _AllGatherFn(torch.autograd.Function):
    """[x of each rank] stacked; the result is the same on every rank, so
    the backward is this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        pg, ranks = mesh.group(axis)
        ctx.index = mesh.axis_index(axis)
        return torch.stack(_gather_list(_ready(x), pg, ranks))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


@defop(name="c_allgather")
def _allgather_raw(x, axis):
    m = mesh_mod.region_mesh(axis)
    if _wants_grad(x):
        return _AllGatherFn.apply(x, axis, m)
    pg, ranks = m.group(axis)
    return torch.stack(_gather_list(_ready(x), pg, ranks))


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    axis = _axis_of(group)
    if not _in_region(axis):
        if mesh_mod.mesh_axis_size(axis) == 1:
            tensor_list.append(tensor)
            return tensor_list
        _outside("all_gather", axis)
    gathered = _allgather_raw(tensor, axis=axis)
    for i in range(gathered.shape[0]):
        tensor_list.append(gathered[i])
    return tensor_list


def all_gather_object(obj_list, obj, group=None):
    """Every rank's ``obj`` over the group's axis when it has more than
    one rank (torch.distributed.all_gather_object), else ``obj``."""
    axis = _axis_of(group)
    m = mesh_mod.region_mesh(axis) or mesh_mod.get_mesh()
    if m is None or axis not in m.axis_names or m.shape[axis] == 1 \
            or not mesh_mod._dist_up():
        obj_list.append(obj)
        return obj_list
    import torch.distributed as dist
    pg, ranks = m.group(axis)
    out = [None] * len(ranks)
    dist.all_gather_object(out, obj, group=pg)
    obj_list.extend(out)
    return obj_list


@defop(name="c_reduce")
def _reduce_raw(x, axis, op, dst, groups=None):
    red = _allreduce_raw.raw(x, axis, op, groups)
    return red if mesh_mod.axis_index(axis) == dst else _plain(x).clone()


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    axis = _axis_of(group)
    if not _in_region(axis):
        if mesh_mod.mesh_axis_size(axis) == 1:
            return tensor
        _outside("reduce", axis)
    out = _reduce_raw(tensor, axis=axis, op=op, dst=dst,
                      groups=_hashable(_groups_of(group)))
    return _rebound(tensor, out)


@defop(name="c_broadcast")
def _broadcast_raw(x, axis, src, members=None):
    """``src``'s value (an axis index) on every member; non-members keep
    their own."""
    pg, ranks = _axis_group(axis, list(members) if members else None)
    y = _ready(x).clone()
    if len(ranks) <= 1:
        return y
    line = mesh_mod.region_mesh(axis).line(axis)
    return _broadcast_(y, pg, line[src])


def broadcast(tensor, src=0, group=None, sync_op=True):
    axis = _axis_of(group)
    if not _in_region(axis):
        if mesh_mod.mesh_axis_size(axis) == 1:
            return tensor
        _outside("broadcast", axis)
    members = tuple(group.ranks) if isinstance(group, Group) and \
        group.ranks is not None else None
    out = _broadcast_raw(tensor, axis=axis, src=src, members=members)
    return _rebound(tensor, out)


@defop(name="c_scatter")
def _scatter_raw(stacked, axis, src):
    full = _broadcast_raw.raw(stacked, axis, src, None)
    return full[mesh_mod.axis_index(axis)].clone()


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    axis = _axis_of(group)
    if not _in_region(axis):
        if mesh_mod.mesh_axis_size(axis) == 1:
            if tensor_list:
                return _rebound(tensor, tensor_list[0])
            return tensor
        _outside("scatter", axis)
    stacked = torch.stack([_plain(t) for t in tensor_list]) if tensor_list \
        else tensor
    out = _scatter_raw(stacked, axis=axis, src=src)
    return _rebound(tensor, out)


def _alltoall_plain(x, axis, mesh):
    pg, ranks = mesh.group(axis)
    y = _ready(x)
    if len(ranks) <= 1:
        return y.clone()
    return _all_to_all(y, pg, ranks)


class _AllToAllFn(torch.autograd.Function):
    """The tiled all_to_all on dim 0; its transpose (split and concat
    swapped) is, in this layout, the same exchange."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _alltoall_plain(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _alltoall_plain(g.contiguous(), ctx.axis, ctx.mesh), None, \
            None


@defop(name="c_alltoall")
def _alltoall_raw(x, axis):
    """Chunk j of dim 0 to axis index j; chunk j of the result from it."""
    m = mesh_mod.region_mesh(axis)
    if _wants_grad(x):
        return _AllToAllFn.apply(x, axis, m)
    return _alltoall_plain(x, axis, m)


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    axis = _axis_of(group)
    if not _in_region(axis):
        if mesh_mod.mesh_axis_size(axis) == 1:
            if out_tensor_list is not None:
                out_tensor_list.extend(in_tensor_list)
                return out_tensor_list
            return in_tensor_list
        _outside("alltoall", axis)
    x = torch.stack([_plain(t) for t in in_tensor_list]) \
        if isinstance(in_tensor_list, list) else in_tensor_list
    out = _alltoall_raw(x, axis=axis)
    if out_tensor_list is not None:
        for i in range(out.shape[0]):
            out_tensor_list.append(out[i])
        return out_tensor_list
    return out


@defop(name="c_reducescatter")
def _reduce_scatter_raw(x, axis, op):
    """Chunk r (along dim 0) of the reduction on axis index r: the
    backend's reduce-scatter where the transport probe found one, else an
    all-reduce, then the chunk. PROD is exact through a gather, as
    all_reduce's is."""
    n = mesh_mod.mesh_axis_size(axis)
    if x.shape[0] % n != 0:
        raise ValueError(
            f"reduce_scatter: leading dim {x.shape[0]} not divisible by "
            f"axis '{axis}' size {n}")
    y = _ready(x)
    pg, ranks = _axis_group(axis)
    if len(ranks) <= 1:
        return y.clone()
    if op == ReduceOp.PROD or _mode("reduce_scatter", y) == "all_reduce":
        red = _allreduce_raw.raw(y, axis, op, None)
        chunk = x.shape[0] // n
        return red.narrow(0, mesh_mod.axis_index(axis) * chunk,
                          chunk).clone()
    out = _reduce_scatter_(y, pg, ranks,
                           ReduceOp.SUM if op == ReduceOp.AVG else op)
    return out / n if op == ReduceOp.AVG else out


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    axis = _axis_of(group)
    if not _in_region(axis):
        if mesh_mod.mesh_axis_size(axis) == 1:
            src = tensor_list[0] if tensor_list else tensor
            return _rebound(tensor, src) if src is not tensor else tensor
        _outside("reduce_scatter", axis)
    x = torch.cat([_plain(t) for t in tensor_list]) if tensor_list \
        else tensor
    out = _reduce_scatter_raw(x, axis=axis, op=op)
    return _rebound(tensor, out) if tensor.shape == out.shape else out


@defop(name="c_hierarchical_allreduce")
def _hierarchical_allreduce_raw(x, inner_axis, outer_axis, op):
    """Two-tier all-reduce: reduce-scatter over the fast ``inner_axis``,
    all-reduce of the 1/n shard over the slow ``outer_axis``, all-gather
    over ``inner_axis``. Equal to one all-reduce over both axes for SUM /
    AVG while the slow tier moves 1/n of the bytes; MAX / MIN / PROD nest
    the flat form per axis."""
    n_in = mesh_mod.mesh_axis_size(inner_axis)
    n_out = mesh_mod.mesh_axis_size(outer_axis)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        red = _allreduce_raw.raw(x, inner_axis, op, None)
        return _allreduce_raw.raw(red, outer_axis, op, None)
    shape = x.shape
    flat = _ready(x).reshape(-1)
    pad = (-flat.shape[0]) % n_in
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shard = _reduce_scatter_raw.raw(flat, inner_axis, ReduceOp.SUM)
    shard = _allreduce_raw.raw(shard, outer_axis, ReduceOp.SUM, None)
    pg, ranks = _axis_group(inner_axis)
    full = torch.cat(_gather_list(shard.contiguous(), pg, ranks))
    if pad:
        full = full[:-pad]
    out = full.reshape(shape)
    if op == ReduceOp.AVG:
        out = out / (n_in * n_out)
    return out


def hierarchical_all_reduce(tensor, op=ReduceOp.SUM, inner_axis="dp",
                            outer_axis="pod", sync_op=True):
    """All-reduce across a two-tier mesh: within a node, then between
    nodes; a plain all_reduce when either axis is unbound."""
    if not _in_region(inner_axis):
        return all_reduce(tensor, op=op, group=outer_axis)
    if not _in_region(outer_axis):
        return all_reduce(tensor, op=op, group=inner_axis)
    out = _hierarchical_allreduce_raw(tensor, inner_axis=inner_axis,
                                      outer_axis=outer_axis, op=op)
    return _rebound(tensor, out)


def _ppermute_plain(x, axis, perm, mesh):
    line = mesh.line(axis)
    me = mesh.axis_index(axis)
    y = _plain(x)
    out = torch.zeros_like(y)
    if (me, me) in perm:                     # to itself: no transfer
        out.copy_(y)
    sends = [(y, line[d]) for s, d in perm if s == me and d != me]
    recvs = [(out, line[s]) for s, d in perm if d == me and s != me]
    if sends or recvs:
        _exchange(sends, recvs)
    return out


class _PPermuteFn(torch.autograd.Function):
    """collective_permute; the backward sends each cotangent back along
    the inverse permutation."""

    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return _ppermute_plain(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute_plain(g, ctx.axis, inverse, ctx.mesh), None, \
            None, None


@defop(name="send_v2")
def _ppermute_raw(x, axis, perm):
    """collective_permute: ``perm`` [(src, dst)] of axis indices; a rank
    that receives nothing gets zeros."""
    m = mesh_mod.region_mesh(axis)
    if _wants_grad(x):
        return _PPermuteFn.apply(x, axis, perm, m)
    return _ppermute_plain(x, axis, perm, m)


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send to axis index ``dst`` of the group's axis
    (send_v2); the receiver calls ``recv``."""
    axis = _axis_of(group)
    m = mesh_mod.region_mesh(axis) or mesh_mod.get_mesh()
    if m is None or axis not in m.axis_names:
        raise RuntimeError(f"send: no mesh with axis '{axis}'")
    _exchange([(_plain(tensor), m.line(axis)[dst])], [])
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Point-to-point receive into ``tensor`` from axis index ``src``."""
    axis = _axis_of(group)
    m = mesh_mod.region_mesh(axis) or mesh_mod.get_mesh()
    if m is None or axis not in m.axis_names:
        raise RuntimeError(f"recv: no mesh with axis '{axis}'")
    buf = torch.empty(tensor.shape, dtype=tensor.dtype, device=tensor.device)
    _exchange([], [(buf, m.line(axis)[src])])
    return _rebound(tensor, buf) if isinstance(tensor, Tensor) else \
        tensor.copy_(buf)


def p2p_permute(x, perm, axis="pp"):
    """collective_permute over an axis: perm = [(src, dst), ...]."""
    if not _in_region(axis):
        if mesh_mod.mesh_axis_size(axis) == 1:
            return x
        _outside("p2p_permute", axis)
    return _ppermute_raw(x, axis=axis, perm=tuple(tuple(p) for p in perm))


def barrier(group=None):
    """Every rank of the world reaches this point."""
    if mesh_mod._dist_up() and mesh_mod.world_size() > 1:
        import torch.distributed as dist
        dist.barrier()


def wait(tensor, group=None, use_calc_stream=True):
    return tensor  # every collective here returns completed


def split(x, num_partitions, axis="tp"):
    """Megatron-style sharded view: this rank's part of ``x``'s last dim
    (the first part outside a region)."""
    from .. import ops
    parts = ops.split(x, num_partitions, axis=-1)
    if not _in_region(axis):
        return parts[0]
    return parts[mesh_mod.axis_index(axis)]

