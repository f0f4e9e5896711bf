"""Data-parallel training entry points (paddle_tpu/distributed/parallel.py).

``DataParallel`` keeps the JAX package's semantics: called on the global
batch, it returns the global outputs, and after the backward every rank
holds the gradients of the unwrapped model on the whole global batch. The
forward takes this rank's shard of the batch (dim 0) along the ``dp``
axis, runs the layer, and all-gathers the outputs through a gather whose
backward takes this rank's slice of the gradient. When a backward reaches
the gathered outputs, before any parameter's gradient of that backward,
the gradients accumulated so far are set aside; at its end the new
gradients are summed over ``dp`` in one flattened all-reduce a dtype and
added to them. So accumulating over several backwards sums global
gradients, as in the JAX package, and ``apply_collective_grads`` after a
backward finds nothing left to do. A term of the loss that reads a
parameter outside the wrapped layer is summed over ``dp`` with the rest.
A 0-d output (a loss the layer reduced itself) is the mean of the ranks'
values: the global value only when the layer's reduction is a mean over
shards of equal weight, so a layer should return per-example outputs and
the loss be taken after the gather. A batch some tensor of which does
not divide over ``dp`` along dim 0 is not sharded: every rank runs it
whole, as the JAX package replicates such an input, and its gradients
are the whole batch's with no sum.

``batch_divides``, ``shard_batch``, ``gather_batch`` and ``sum_over_dp``
are the pieces of this data parallelism; ``Model.fit``'s data-parallel
step (hapi/model.py) is built from the same pieces.
"""
from __future__ import annotations

import torch

from ..core import monitor as _monitor
from ..nn.layer.layers import Layer
from . import mesh as mesh_mod
from .env import ParallelEnv, get_world_size

__all__ = ["init_parallel_env", "DataParallel", "ParallelEnv",
           "get_world_size", "batch_divides", "shard_batch", "gather_batch",
           "sum_over_dp"]


def init_parallel_env(mesh_shape=None):
    """Join the process group (when PADDLE_TRAINERS_NUM > 1, see
    bootstrap.py) and declare the default mesh over the world."""
    from .bootstrap import maybe_initialize_distributed
    maybe_initialize_distributed()
    mesh_mod.init_mesh(mesh_shape)
    return ParallelEnv()


def batch_divides(values, mesh):
    """Whether every tensor of ``values`` with a dim 0 divides over the
    ``dp`` axis of ``mesh``; each one that does not is counted in
    ``sharding.nondivisible_fallback``."""
    n = int(mesh.shape["dp"])
    ok = True
    for x in values:
        if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] % n:
            _monitor.stat_add("sharding.nondivisible_fallback")
            ok = False
    return ok


def shard_batch(x, mesh):
    """This rank's 1/dp of ``x`` along dim 0 (a 0-d or non-tensor value
    as it is)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    chunk = x.shape[0] // int(mesh.shape["dp"])
    return x.narrow(0, mesh.axis_index("dp") * chunk, chunk)


def gather_batch(y, mesh):
    """The ranks' ``y`` along dim 0, differentiable (the backward is this
    rank's slice); a 0-d ``y`` is the ranks' mean."""
    if not isinstance(y, torch.Tensor):
        return y
    if y.dim() == 0:
        return mesh_mod.gather_cat(y.reshape(1), 0, "dp", mesh).mean()
    return mesh_mod.gather_cat(y, 0, "dp", mesh)


def sum_over_dp(tensors, mesh):
    """Sum ``tensors`` over the ``dp`` axis of ``mesh`` in place, one
    flattened all-reduce a dtype. Returns the bytes reduced."""
    from .collective import _all_reduce_
    pg, _ = mesh.group("dp")
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    moved = 0
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        _all_reduce_(flat, pg)
        moved += flat.numel() * flat.element_size()
        off = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
    return moved


class DataParallel(Layer):
    """reference fluid/dygraph/parallel.py:313 DataParallel, over the
    default mesh's ``dp`` axis. Parameters and buffers are broadcast from
    dp index 0 when wrapped, so every rank starts from the same state."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False):
        super().__init__()
        self._layers = layers
        self._mesh = mesh_mod.auto_mesh()
        self._pending = False
        self._held = {}
        self.allreduce_bytes = 0
        if self._dp() > 1:
            from .collective import _broadcast_
            pg, ranks = self._mesh.group("dp")
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    _broadcast_(t.data, pg, ranks[0])

    def _dp(self):
        m = self._mesh
        return int(m.shape["dp"]) if "dp" in m.axis_names else 1

    def _gather(self, y):
        out = gather_batch(y, self._mesh)
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out.register_hook(self._on_grad)
        return out

    def _on_grad(self, g):
        # the gradient reached the gathered output, ahead of every
        # parameter's gradient of this backward: hold the gradients so far
        # aside, and sum the new ones once the backward is done
        if not self._pending:
            self._pending = True
            self._held = {}
            for p in self._layers.parameters():
                if p.grad is not None:
                    self._held[p] = p.grad
                    p.grad = None
            torch.autograd.Variable._execution_engine.queue_callback(
                self.apply_collective_grads)
        return g

    def forward(self, *inputs, **kwargs):
        if self._dp() == 1 or not batch_divides(
                list(inputs) + list(kwargs.values()), self._mesh):
            return self._layers(*inputs, **kwargs)
        import torch.utils._pytree as pytree
        inputs = [shard_batch(x, self._mesh) for x in inputs]
        kwargs = {k: shard_batch(v, self._mesh) for k, v in kwargs.items()}
        out = self._layers(*inputs, **kwargs)
        return pytree.tree_map(self._gather, out)

    def scale_loss(self, loss):
        return loss  # the gradients are the global batch's already

    def apply_collective_grads(self):
        """Sum the last backward's parameter gradients over dp (one
        flattened all-reduce a dtype) and add back those held aside. The
        backward calls it at its end, so a call after ``backward()``
        finds nothing pending and is a no-op, as the JAX package's is."""
        if not self._pending:
            return
        self._pending = False
        self.allreduce_bytes = sum_over_dp(
            [p.grad.detach().as_subclass(torch.Tensor)
             for p in self._layers.parameters() if p.grad is not None],
            self._mesh)
        held, self._held = self._held, {}
        with torch.no_grad():
            for p, g in held.items():
                if p.grad is not None:
                    g.add_(p.grad)
                p.grad = g

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)
