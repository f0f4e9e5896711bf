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
the loss be taken after the gather.
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from . import mesh as mesh_mod
from .env import ParallelEnv, get_world_size

__all__ = ["init_parallel_env", "DataParallel", "ParallelEnv",
           "get_world_size"]


def init_parallel_env(mesh_shape=None):
    """Join the process group (when PADDLE_TRAINERS_NUM > 1, see
    bootstrap.py) and declare the default mesh over the world."""
    from .bootstrap import maybe_initialize_distributed
    maybe_initialize_distributed()
    mesh_mod.init_mesh(mesh_shape)
    return ParallelEnv()


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

    def _shard(self, x):
        n = self._dp()
        if not isinstance(x, torch.Tensor) or x.dim() == 0 \
                or x.shape[0] % n:
            return x
        chunk = x.shape[0] // n
        return x.narrow(0, self._mesh.axis_index("dp") * chunk, chunk)

    def _gather(self, y):
        if not isinstance(y, torch.Tensor):
            return y
        if y.dim() == 0:
            g = mesh_mod.gather_cat(y.reshape(1), 0, "dp", self._mesh)
            out = g.mean()
        else:
            out = mesh_mod.gather_cat(y, 0, "dp", self._mesh)
        if out.requires_grad:
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
        if self._dp() == 1:
            return self._layers(*inputs, **kwargs)
        import torch.utils._pytree as pytree
        inputs = [self._shard(x) for x in inputs]
        kwargs = {k: self._shard(v) for k, v in kwargs.items()}
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
        from .collective import _all_reduce_
        pg, _ = self._mesh.group("dp")
        by_dtype = {}
        for p in self._layers.parameters():
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p)
        moved = 0
        for params in by_dtype.values():
            grads = [p.grad.detach().as_subclass(torch.Tensor)
                     for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads])
            _all_reduce_(flat, pg)
            moved += flat.numel() * flat.element_size()
            off = 0
            with torch.no_grad():
                for g in grads:
                    n = g.numel()
                    g.copy_(flat[off:off + n].view_as(g))
                    off += n
        self.allreduce_bytes = moved
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
