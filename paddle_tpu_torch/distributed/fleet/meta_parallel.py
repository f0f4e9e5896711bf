"""Hybrid-parallel building blocks (paddle_tpu/distributed/fleet/
meta_parallel.py): Megatron-style tensor-parallel layers for per-rank code
inside a shard_map region, a layer list split into pipeline stages, and
the RNG tracker.

Each rank holds its shard of a parallel layer's weight. The
identity-forward / all-reduce-backward pair (the column layer's input
copy) and the all-reduce-forward / identity-backward pair (the row
layer's output reduction) are ``collective``'s ``_CopyFn`` and
``_AllReduceFn``, registered under the JAX package's op names. The
layers' forwards are functions of (input, weight, bias, axis, mesh),
shared by the layers (over the region's mesh) and ``tensor_parallel``
(over the mesh it is given).
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ... import nn
from ...ops._dispatch import defop
from .. import mesh as mesh_mod

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "PipelineLayer", "LayerDesc",
           "get_rng_state_tracker", "tensor_parallel", "whole_parameters"]


@defop(name="mp_allreduce_identity_bwd")
def _allreduce_fwd_identity_bwd(x, axis, mesh=None):
    """f(x) = all-reduce of x over ``axis`` of ``mesh`` (default: the
    region's); its gradient is the identity (the row layer's output
    reduction)."""
    from ..collective import ReduceOp, _AllReduceFn
    if mesh is None:
        mesh = mesh_mod.region_mesh(axis)
    return _AllReduceFn.apply(x, axis, ReduceOp.SUM, mesh)


@defop(name="mp_identity_allreduce_bwd")
def _identity_fwd_allreduce_bwd(x, axis, mesh=None):
    """f(x) = x with the gradient all-reduced over ``axis`` of ``mesh``
    (default: the region's; the column layer's input copy)."""
    from ..collective import _CopyFn
    if mesh is None:
        mesh = mesh_mod.region_mesh(axis)
    return _CopyFn.apply(x, axis, mesh)


def _column_forward(x, weight, bias, axis, mesh, gather):
    """The column layer's forward: the input copy (all-reduce backward),
    then ``x @ weight + bias`` on this rank's output features; ``gather``
    concatenates every rank's features."""
    from ...nn import functional as F
    out = F.linear(_identity_fwd_allreduce_bwd(x, axis=axis, mesh=mesh),
                   weight, bias)
    if gather:
        out = mesh_mod.gather_cat(out, out.dim() - 1, axis, mesh)
    return out


def _row_forward(x, weight, bias, axis, mesh, idx=None):
    """The row layer's forward: ``x`` (this rank's input features; with
    ``idx``, the whole input narrowed to rank ``idx``'s) times this
    rank's rows, the partial sums all-reduced (identity backward), then
    the bias."""
    from ...nn import functional as F
    if idx is not None:
        x = x.narrow(x.dim() - 1, idx * weight.shape[0], weight.shape[0])
    out = _allreduce_fwd_identity_bwd(F.linear(x, weight), axis=axis,
                                      mesh=mesh)
    return out if bias is None else out + bias


def _vocab_forward(ids, weight, axis, mesh, idx):
    """The vocab layer's forward: rank ``idx`` holds rows [idx * V/tp,
    (idx + 1) * V/tp); a masked local lookup, then an all-reduce
    (identity backward)."""
    from ...nn import functional as F
    per = weight.shape[0]
    local = ids.as_subclass(torch.Tensor) - idx * per
    valid = (local >= 0) & (local < per)
    safe = torch.where(valid, local, torch.zeros_like(local))
    emb = F.embedding(safe, weight)
    emb = emb * valid[..., None].to(emb.dtype)
    return _allreduce_fwd_identity_bwd(emb, axis=axis, mesh=mesh)


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
        if not mesh_mod.in_spmd_region(self.axis):
            return self.inner(x)
        return _column_forward(x, self.inner.weight, self.inner.bias,
                               self.axis, mesh_mod.region_mesh(self.axis),
                               self.gather_output)


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
        if not mesh_mod.in_spmd_region(self.axis):
            out = self.inner(x)
            return out if self.bias is None else out + self.bias
        idx = None if self.input_is_parallel \
            else mesh_mod.axis_index(self.axis)
        return _row_forward(x, self.inner.weight, self.bias, self.axis,
                            mesh_mod.region_mesh(self.axis), idx)


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
        return _vocab_forward(ids, self.inner.weight, self.axis,
                              mesh_mod.region_mesh(self.axis),
                              mesh_mod.axis_index(self.axis))


# ---------------------------------------------------------------------------
# a whole network over a tp axis by the rule tables (Model.fit's GSPMD
# presets, paddle_tpu/hapi/model.py _sharding_plan)
# ---------------------------------------------------------------------------

_QKV = ("qkv_proj", "q_proj", "k_proj", "v_proj")
_PAIRS = {"qkv_proj": "out_proj", "q_proj": "out_proj", "k_proj": "out_proj",
          "v_proj": "out_proj", "fc1": "fc2", "linear1": "linear2"}


def _spec_kind(spec):
    """"column" (P(None, 'tp')), "row" / "vocab" (P('tp', None)), "bias"
    (P('tp')) or None of a 1-d / 2-d spec over the tp axis."""
    ents = [(e,) if isinstance(e, str) else tuple(e or ())
            for e in tuple(spec)]
    if len(ents) == 2 and not ents[0] and ents[1] == ("tp",):
        return "column"
    if len(ents) == 2 and ents[0] == ("tp",) and not ents[1]:
        return "row"
    if len(ents) == 1 and ents[0] == ("tp",):
        return "bias"
    return None


def _chunk(t, dim, idx, n, blocks=1):
    """Rank ``idx``'s 1/n of ``t`` along ``dim``: of each of ``blocks``
    equal blocks (a fused qkv's q, k and v) when blocks > 1."""
    if blocks == 1:
        size = t.shape[dim] // n
        return t.narrow(dim, idx * size, size)
    parts = t.chunk(blocks, dim)
    return torch.cat([_chunk(p, dim, idx, n) for p in parts], dim)


def _unchunk(pieces, dim, blocks=1):
    """The whole tensor from every rank's ``_chunk``."""
    if blocks == 1:
        return torch.cat(pieces, dim)
    per = [p.chunk(blocks, dim) for p in pieces]
    return torch.cat([torch.cat([q[b] for q in per], dim)
                      for b in range(blocks)], dim)


def tensor_parallel(net, mesh, axis="tp"):
    """Shard ``net``'s parameters over ``axis`` of ``mesh`` in place by
    ``distributed/sharding.py``'s rule tables (``param_spec_for``, the
    planner's installed rules among them), and make its layers run the
    Megatron chain the specs imply, through the parallel layers' forwards
    (``_column_forward``, ``_row_forward``, ``_vocab_forward``) over
    ``mesh``:

    - a column-parallel Linear (weight P(None, tp), bias P(tp)) takes its
      input through the identity whose backward is the all-reduce, and
      gives its output features' shard; a row-parallel Linear (weight
      P(tp, None)) multiplies its input features' shard and all-reduces
      the partial sums (identity backward), then adds its bias. A column
      layer paired with a row one (qkv -> out_proj, fc1 -> fc2, linear1
      -> linear2 in one parent) hands the shard on: one all-reduce
      forward and one backward a pair. An unpaired column layer gathers
      its output; an unpaired row layer takes its shard of a whole input.
    - A fused qkv is sharded head-wise (each rank holds the same heads of
      q, k and v), and its MultiHeadAttention runs its 1/tp of the heads.
    - A vocab-parallel Embedding (weight P(tp, None)) looks its rows up
      masked and all-reduces; a read of its ``weight`` from outside (the
      tied LM head: the fused CE kernel needs the whole vocabulary)
      all-gathers the table, whose backward takes this rank's rows, as
      GSPMD does in front of a custom call.

    Everything else stays replicated and gets the same gradient on every
    tp rank. Returns ``net``."""
    from ...nn.layer import Embedding, Linear, MultiHeadAttention
    from .. import sharding as SH
    n = int(mesh.shape[axis])
    if n <= 1 or getattr(net, "_tp_layout", None) is not None:
        return net
    if mesh.size != mesh_mod.world_size():
        raise ValueError(
            f"a {mesh.shape} mesh has {mesh.size} positions but the world "
            f"has {mesh_mod.world_size()} ranks (one process a position)")
    idx = mesh.axis_index(axis)
    layout = {}
    kinds = {}
    mods = dict(net.named_modules())
    for name, mod in mods.items():
        if not isinstance(mod, (Linear, Embedding)):
            continue
        w = mod._parameters.get("weight")
        if w is None:
            continue
        pre = f"{name}." if name else ""
        spec = SH._validate_divisible(
            SH.param_spec_for(pre + "weight", w.dim(), mesh), w.shape, mesh)
        kind = _spec_kind(spec)
        if kind in ("row", "column") and isinstance(mod, Embedding):
            kind = "vocab" if kind == "row" else None
        if kind is not None:
            kinds[name] = kind
    # pairing inside one parent
    paired = set()
    for name, kind in kinds.items():
        parent, _, leaf = name.rpartition(".")
        partner = _PAIRS.get(leaf)
        if kind == "column" and partner is not None:
            pname = f"{parent}.{partner}" if parent else partner
            if kinds.get(pname) == "row":
                paired.update((name, pname))
    heads = {}
    for name, mod in mods.items():
        if isinstance(mod, MultiHeadAttention):
            projs = [f"{name}.{p}" if name else p for p in _QKV
                     if hasattr(mod, p)]
            if projs and all(p in paired for p in projs) \
                    and mod.num_heads % n == 0:
                heads[name] = mod
            else:
                paired.difference_update(
                    projs + [f"{name}.out_proj" if name else "out_proj"])
    with torch.no_grad():
        for name, kind in kinds.items():
            mod = mods[name]
            pre = f"{name}." if name else ""
            blocks = 3 if name.rpartition(".")[2] == "qkv_proj" \
                and name in paired else 1
            w = mod._parameters["weight"]
            dim = 1 if kind == "column" else 0
            w.data = _chunk(w.data, dim, idx, n, blocks).contiguous()
            layout[pre + "weight"] = (dim, blocks)
            b = mod._parameters.get("bias")
            if kind == "column" and b is not None:
                # the output features' bias follows them (P(tp) by the
                # rule tables)
                b.data = _chunk(b.data, 0, idx, n, blocks).contiguous()
                layout[pre + "bias"] = (0, blocks)
            _patch(mod, kind, name in paired, axis, mesh, idx)
    for mod in heads.values():
        mod.num_heads //= n
        mod.embed_dim //= n
    net._tp_layout = layout
    net._tp_mesh = (mesh, axis)
    return net


def _patch(mod, kind, paired, axis, mesh, idx):
    """Give ``mod`` (this instance only) the forward of its tp kind: the
    parallel layers' forwards above, over ``mesh``."""
    p = mod._parameters
    if kind == "column":
        def forward(x):
            return _column_forward(x, p["weight"], p.get("bias"), axis,
                                   mesh, not paired)
    elif kind == "row":
        def forward(x):
            return _row_forward(x, p["weight"], p.get("bias"), axis, mesh,
                                None if paired else idx)
    else:  # vocab
        def forward(ids):
            return _vocab_forward(ids, p["weight"], axis, mesh, idx)
        mod._tp_whole = (axis, mesh)
        mod.__class__ = _gathered_weight_class(type(mod))
    mod.forward = forward


class _GatheredWeight:
    """``weight`` read from outside a vocab-parallel layer's forward is
    the whole table, all-gathered over the tp axis."""

    @property
    def weight(self):
        axis, mesh = self._tp_whole
        return mesh_mod.gather_cat(self._parameters["weight"], 0, axis, mesh)


@functools.cache
def _gathered_weight_class(cls):
    return type(f"VocabParallel{cls.__name__}", (_GatheredWeight, cls), {})


def whole_parameters(net, values=None):
    """{name: the whole parameter} of a ``tensor_parallel`` network (its
    shards gathered over the tp axis; the replicated ones as they are),
    detached; ``values`` ({name: this rank's shard}, e.g. the optimizer's
    f32 masters) gathered by the same layout in their place."""
    from .. import collective
    layout = getattr(net, "_tp_layout", None) or {}
    mesh, axis = getattr(net, "_tp_mesh", (None, None))
    out = {}
    named = values.items() if values is not None \
        else net.named_parameters()
    for name, p in named:
        t = p.detach()
        if name in layout:
            dim, blocks = layout[name]
            pg, ranks = mesh.group(axis)
            parts = collective._gather_list(t.contiguous(), pg, ranks)
            t = _unchunk(parts, dim, blocks)
        out[name] = t
    return out


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
