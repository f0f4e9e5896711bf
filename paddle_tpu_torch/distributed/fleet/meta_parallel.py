"""Hybrid-parallel building blocks (paddle_tpu/distributed/fleet/
meta_parallel.py): Megatron-style tensor-parallel layers for per-rank code
inside a shard_map region, a layer list split into pipeline stages, and
the RNG tracker.

Each rank holds its shard of a parallel layer's weight. The
identity-forward / all-reduce-backward pair (the column layer's input
copy) and the all-reduce-forward / identity-backward pair (the row
layer's output reduction) are ``collective``'s ``_CopyFn`` and
``_AllReduceFn``, registered under the JAX package's op names.
"""
from __future__ import annotations

import contextlib

import torch

from ... import nn
from ...ops._dispatch import defop
from .. import mesh as mesh_mod

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "PipelineLayer", "LayerDesc",
           "get_rng_state_tracker"]


@defop(name="mp_allreduce_identity_bwd")
def _allreduce_fwd_identity_bwd(x, axis):
    """f(x) = all-reduce of x over ``axis``; its gradient is the identity
    (the RowParallelLinear output reduction)."""
    from ..collective import ReduceOp, _AllReduceFn
    return _AllReduceFn.apply(x, axis, ReduceOp.SUM,
                              mesh_mod.region_mesh(axis))


@defop(name="mp_identity_allreduce_bwd")
def _identity_fwd_allreduce_bwd(x, axis):
    """f(x) = x with the gradient all-reduced over ``axis`` (the
    ColumnParallelLinear input copy)."""
    from ..collective import _CopyFn
    return _CopyFn.apply(x, axis, mesh_mod.region_mesh(axis))


class ColumnParallelLinear(nn.Layer):
    """Output-dim sharded linear: weight shard [in, out/tp] on each rank."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, axis="tp", name=None):
        super().__init__()
        self.axis = axis
        tp = mesh_mod.mesh_axis_size(axis)
        assert out_features % tp == 0, (out_features, tp)
        self.out_per_shard = out_features // tp
        self.gather_output = gather_output
        self.inner = nn.Linear(in_features, self.out_per_shard,
                               weight_attr=weight_attr,
                               bias_attr=None if has_bias else False)

    @property
    def weight(self):
        return self.inner.weight

    def forward(self, x):
        region = mesh_mod.in_spmd_region(self.axis)
        if region:
            x = _identity_fwd_allreduce_bwd(x, axis=self.axis)
        out = self.inner(x)
        if self.gather_output and region:
            out = mesh_mod.gather_cat(out, out.dim() - 1, self.axis,
                                      mesh_mod.region_mesh(self.axis))
        return out


class RowParallelLinear(nn.Layer):
    """Input-dim sharded linear: weight shard [in/tp, out] on each rank."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, axis="tp", name=None):
        super().__init__()
        self.axis = axis
        tp = mesh_mod.mesh_axis_size(axis)
        assert in_features % tp == 0, (in_features, tp)
        self.in_per_shard = in_features // tp
        self.input_is_parallel = input_is_parallel
        self.inner = nn.Linear(self.in_per_shard, out_features,
                               weight_attr=weight_attr, bias_attr=False)
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None

    @property
    def weight(self):
        return self.inner.weight

    def forward(self, x):
        region = mesh_mod.in_spmd_region(self.axis)
        if not self.input_is_parallel and region:
            idx = mesh_mod.axis_index(self.axis)
            x = x.narrow(x.dim() - 1, idx * self.in_per_shard,
                         self.in_per_shard)
        out = self.inner(x)
        if region:
            out = _allreduce_fwd_identity_bwd(out, axis=self.axis)
        if self.bias is not None:
            out = out + self.bias
        return out


class VocabParallelEmbedding(nn.Layer):
    """Vocab-sharded embedding: rows [rank*V/tp, (rank+1)*V/tp) on each
    rank; a masked local lookup, then an all-reduce (identity backward)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 axis="tp", name=None):
        super().__init__()
        self.axis = axis
        tp = mesh_mod.mesh_axis_size(axis)
        assert num_embeddings % tp == 0
        self.per_shard = num_embeddings // tp
        self.inner = nn.Embedding(self.per_shard, embedding_dim,
                                  weight_attr=weight_attr)

    @property
    def weight(self):
        return self.inner.weight

    def forward(self, ids):
        if not mesh_mod.in_spmd_region(self.axis):
            return self.inner(ids)
        lo = mesh_mod.axis_index(self.axis) * self.per_shard
        ids = ids.as_subclass(torch.Tensor)
        local = ids - lo
        valid = (local >= 0) & (local < self.per_shard)
        safe = torch.where(valid, local, torch.zeros_like(local))
        emb = torch.nn.functional.embedding(safe, self.inner.weight)
        emb = emb * valid[..., None].to(emb.dtype)
        return _allreduce_fwd_identity_bwd(emb, axis=self.axis)


class LayerDesc:
    """Deferred layer construction for pipeline stages
    (reference fleet/meta_parallel/parallel_layers/pp_layers.py)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.layer_cls(*self.args, **self.kwargs)


class PipelineLayer(nn.Layer):
    """Stage container: a layer list split uniformly into pp stages
    (reference pp_layers.py PipelineLayer). Outside a region over ``pp``
    (or at pp 1) ``forward`` runs the stages in turn; inside one each rank
    runs its own stage in the tick-synchronous schedule of
    ``distributed.pipeline`` over ``num_micro`` micro-batches ("gpipe" or
    "1f1b"; with ``num_virtual_pipeline_stages`` v > 1 the list splits
    into n * v chunks, chunk c*n + r on rank r, run interleaved), and
    returns the finished outputs on the last stage (zeros elsewhere).
    ``pipeline_loss`` takes ``loss_fn`` on the last stage, the mean over
    micro-batches on every rank."""

    def __init__(self, layers, num_stages=None, loss_fn=None,
                 partition_method="uniform", num_micro=None,
                 schedule="gpipe", num_virtual_pipeline_stages=1, **kwargs):
        super().__init__()
        self.descs = list(layers)
        self.num_stages = num_stages or mesh_mod.mesh_axis_size("pp")
        self.loss_fn = loss_fn
        self.num_micro = num_micro or self.num_stages
        self.schedule = schedule
        self.num_virtual = int(num_virtual_pipeline_stages)
        n = len(self.descs)
        chunks = self.num_stages * self.num_virtual
        per = -(-n // chunks)
        self.stage_bounds = [(i * per, min((i + 1) * per, n))
                             for i in range(chunks)]
        built = [d.build() if isinstance(d, LayerDesc) else d
                 for d in self.descs]
        self.stages = nn.LayerList([
            nn.Sequential(*built[lo:hi]) for lo, hi in self.stage_bounds])

    def stage_fn(self, stage_idx):
        return self.stages[stage_idx]

    def _pipelined(self):
        return mesh_mod.in_spmd_region("pp") \
            and mesh_mod.mesh_axis_size("pp") > 1

    def _local(self):
        """This rank's stage, or its chunks (shallow to deep)."""
        r, n = mesh_mod.axis_index("pp"), mesh_mod.mesh_axis_size("pp")
        if self.num_virtual > 1:
            return [self.stages[c * n + r] for c in range(self.num_virtual)]
        return self.stages[r]

    def forward(self, x):
        if not self._pipelined():
            for s in self.stages:
                x = s(x)
            return x
        from ..pipeline import gpipe, interleaved, micro_batch
        xm = micro_batch(x, self.num_micro)
        if self.num_virtual > 1:
            outs = interleaved(self._local(), xm, "pp")
        else:
            outs = gpipe(self._local(), xm, "pp", schedule=self.schedule)
        return outs.reshape((x.shape[0],) + tuple(outs.shape[2:]))

    def pipeline_loss(self, x, labels):
        """The mean micro-batch ``loss_fn`` of the pipelined stack, the
        same on every rank (outside a pp region: of the stages in turn)."""
        from ..pipeline import micro_batch, pipeline_loss
        if not self._pipelined():
            xm, lm = micro_batch(x, self.num_micro), \
                micro_batch(labels, self.num_micro)
            total = sum(self.loss_fn(self.forward(xm[m]), lm[m]).float()
                        for m in range(self.num_micro))
            return total / self.num_micro
        schedule = "interleaved" if self.num_virtual > 1 else self.schedule
        return pipeline_loss(self._local(), self.loss_fn,
                             micro_batch(x, self.num_micro),
                             micro_batch(labels, self.num_micro), "pp",
                             schedule=schedule)


class _RNGTracker:
    """Named random streams (model-parallel dropout): ``add(name, seed)``
    makes a port ``Generator`` and a torch one; ``rng_state(name)`` draws
    from them inside the block (the port's default generator and torch's
    default CPU / current-card generators swapped in, then restored)."""

    def __init__(self):
        self._gens = {}

    def add(self, name, seed):
        from ...core import rng
        if name in self._gens:
            raise ValueError(f"rng state {name!r} already exists")
        self._gens[name] = (rng.Generator(seed),
                            torch.Generator().manual_seed(int(seed)))

    @contextlib.contextmanager
    def rng_state(self, name="global_seed"):
        from ...core import rng
        if name not in self._gens:
            yield
            return
        port_gen, torch_gen = self._gens[name]
        devices = [torch.cuda.current_device()] \
            if torch.cuda.is_available() else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(int(torch.randint(
                0, 2 ** 62, (), generator=torch_gen)))
            prev, rng._default = rng._default, port_gen
            try:
                yield
            finally:
                rng._default = prev


_tracker = _RNGTracker()


def get_rng_state_tracker():
    return _tracker
