"""LocalSGD: periodic parameter averaging over the dp axis
(paddle_tpu/distributed/localsgd.py; the reference's LocalSGD and
AdaptiveLocalSGD meta-optimizers, Lin et al. 2018).

Each rank is a replica with its own parameters: it takes ``k_steps``
purely local updates on its shard of the batch, then the parameters are
averaged over ``axis``. The JAX package expresses the replicas as a
leading replica dim sharded over dp inside one program; here each
process holds its own copy, so a replica is a rank's state and the sync
is one all-reduce a parameter.
"""
from __future__ import annotations

import torch

from . import mesh as mesh_mod

__all__ = ["local_sgd_step", "LocalSGD", "replicate_for_localsgd"]


def _pmean(x, axis):
    from .collective import ReduceOp, _allreduce_raw
    return _allreduce_raw.raw(x, axis, ReduceOp.AVG)


def local_sgd_step(step_fn, axis="dp", k_steps=4):
    """Wrap a per-replica update into a LocalSGD update.

    step_fn(params, batch) -> (loss, new_params): a PURE local update (no
    cross-replica reduction of its own). Returns fn(params, counter,
    batch) -> (loss, new_params, counter + 1) for use inside a region over
    ``axis``: it steps locally and averages the parameters over ``axis``
    whenever the new counter is a multiple of ``k_steps``. The loss is
    averaged every step (a scalar) for logging."""
    def wrapped(params, counter, batch):
        loss, new_params = step_fn(params, batch)
        counter = counter + 1
        if int(counter) % k_steps == 0:
            new_params = {k: _pmean(v, axis) for k, v in new_params.items()}
        return _pmean(torch.as_tensor(loss).float(), axis), new_params, \
            counter

    return wrapped


def replicate_for_localsgd(params, axis="dp", mesh=None):
    """This rank's private replica of a {name: tensor} parameter dict (the
    JAX package tiles a leading replica dim sharded over ``axis``; here
    the rank's copy is its replica)."""
    return {k: v.detach().clone() for k, v in params.items()}


class LocalSGD:
    """The trainer object: owns this rank's replica and the sync counter.

        trainer = LocalSGD(step_fn, params, k_steps=4)   # under a mesh
        for batch in data:                                # [dp*b, ...]
            loss = trainer.step(batch)
        params = trainer.averaged_params()

    ``step`` takes the global batch (every rank passes the same) and
    steps on this rank's shard along dim 0. Adaptive (the reference's
    AdaptiveLocalSGDOptimizer): k grows by one whenever the synced loss
    improves by less than ``rel_tol``, capped at ``max_k_steps``."""

    def __init__(self, step_fn, params, axis="dp", k_steps=4, mesh=None,
                 adaptive=False, max_k_steps=16, rel_tol=0.01):
        self.mesh = mesh or mesh_mod.get_mesh()
        self.axis = axis
        self.k_steps = int(k_steps)
        self.adaptive = adaptive
        self.max_k_steps = int(max_k_steps)
        self.rel_tol = float(rel_tol)
        self._step_fn = step_fn
        self.params = replicate_for_localsgd(params, axis, self.mesh)
        self.counter = 0
        self._last_sync_loss = None

    def step(self, batch):
        """batch: leading dim = dp_degree * per_replica_batch."""
        k = self.k_steps
        with mesh_mod.MeshGuard(self.mesh):
            local = mesh_mod._narrow_local(batch, mesh_mod.P(self.axis),
                                           self.mesh)
            loss, self.params, self.counter = local_sgd_step(
                self._step_fn, self.axis, k)(self.params, self.counter,
                                             local)
        loss = float(loss)
        if self.adaptive and self.counter % k == 0:
            if self._last_sync_loss is not None and \
                    loss > self._last_sync_loss * (1 - self.rel_tol):
                self.k_steps = min(self.k_steps + 1, self.max_k_steps)
            self._last_sync_loss = loss
        return loss

    def averaged_params(self):
        """The replicas' average (in f32, back in each dtype)."""
        with mesh_mod.MeshGuard(self.mesh):
            return {k: _pmean(v.float(), self.axis).to(v.dtype)
                    for k, v in self.params.items()}
