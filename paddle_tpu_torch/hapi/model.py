"""High-level Model API (paddle_tpu/hapi/model.py): ``Model`` with
``prepare``, ``fit``, ``evaluate``, ``predict``, the batch-level steps,
``save`` / ``load`` and ``summary``.

The JAX package traces forward, backward and the optimizer into one
jitted step. The port's step is eager PyTorch on the network's device
(``next(network.parameters()).device``; batches are moved there with
``non_blocking``): the forward under ``amp.auto_cast``, ``autograd.grad``
of the (scaled) loss, then the optimizer's ``apply_gradients_pure``. It
keeps the JAX step's semantics:

- every trainable parameter gets a gradient, zeros where the loss does
  not reach it (``jax.value_and_grad``'s zeros), so its moments and
  AdamW's decay move; a parameter with ``requires_grad=False`` (JAX's
  ``stop_gradient``) is left as it is and gets no slots;
- ``_step_count`` advances before the update and is its step ``t``; the
  learning rate is read before the scheduler steps, and ``fit`` steps
  ``NoamDecay``, ``OneCycleLR``, ``CyclicLR`` and ``LinearWarmup`` per
  batch and every other scheduler per epoch;
- with a GradScaler (f16 AMP) the loss is scaled inside the
  differentiated region, ``GradScaler.apply_pure`` unscales and checks on
  the device, and where it finds an inf or a nan the old parameters and
  slots are kept by ``torch.where`` (no host read); ``_step_count`` has
  advanced all the same (the eager ``GradScaler.step`` would not have
  advanced it, so the step does not use it);
- ``accumulate_grad_batches``: scaled gradients are summed over the
  micro-batches; at the update they are unscaled once, then multiplied
  by ``1 / count`` in f32 (JAX promotes a 16-bit gradient times its f32
  factor to f32); the count advances only on the update;
- with no metrics and no accumulation, ``fit``'s ``logs["loss"]`` is a
  ``_LazyLoss`` over the device loss, read on the host only when the
  window of ``FLAGS_executor_max_inflight`` steps overflows, at
  ``log_freq`` boundaries, at the epoch end or when a callback reads it.
  Counter ``hapi/loss_reads`` counts the host reads of a loss.

- ``FLAGS_check_nan_inf``: the step runs as one compiled step of the
  JAX package does (``numeric_check.step_scope``: no per-op checks), and
  its loss and new parameters are swept before they are written back;
- ``fit(auto_checkpoint_dir=...)``: ``incubate/checkpoint``'s
  ``TrainingCheckpoint`` restores the newest verified step (parameters,
  optimizer, generators, the DataLoader's position) and fit resumes at
  the batch after it; a save every ``auto_checkpoint_freq`` steps,
  ``keep_checkpoint_max`` kept, and a ``PreemptionGuard`` that saves the
  last completed batch on SIGTERM.

Under a default mesh whose ``dp`` axis has more than one rank (one
process a rank, every rank calling ``fit`` with the same global batches)
the step is data-parallel, as the JAX engine's GSPMD step is, built from
``distributed/parallel.py``'s pieces: each rank runs the network on its
1/dp of the batch (dim 0) with BatchNorm's moments averaged over dp
(GSPMD's global batch statistics), the outputs are gathered (a 0-d
output is the ranks' mean), and the loss is taken on the global outputs
and labels, so every rank holds the global loss; its gradients are the
rank's shares, summed over dp. A ``DataParallel`` network runs its
wrapped layer in this step, so the batch is sharded and summed once. A
batch some tensor of which does not divide over dp (fit's last batch
with ``drop_last=False``) runs whole on every rank, as the JAX engine
replicates it, and dp index 0's gradients stand for the sum (the other
ranks add zeros). The sum over dp:

- plain: one all-reduce a dtype, then the same update on every rank;
- ZeRO (``strategy.sharding`` / ``group_sharded_parallel``):
  ``distributed.sharding.ZeroStep``'s reduce-scatter of the gradients,
  update of this rank's chunks of the parameters, f32 masters and slots,
  and all-gather of the new parameters. ``consolidate_zero`` (before
  ``save``) gathers the slots whole;
- LocalSGD (``strategy.localsgd`` / ``adaptive_localsgd``): each rank
  steps its own replica on its shard with its local loss, and every k-th
  step the parameters and f32 masters are averaged over dp (buffers every
  step; the logged loss is the ranks' mean). ``finalize_localsgd`` (at
  fit's end and before evaluate, predict and save) averages parameters
  and slots.

``strategy.recompute`` recomputes the Transformer layers (or the
``recompute_configs["layers"]`` patterns) and ``strategy.amp`` with its
``amp_configs`` is the AMP of ``prepare``. A mesh with a tp or pp axis of
more than one rank raises naming ROADMAP Queue 1 item 7c (the JAX
engine's GSPMD presets). Not here: ``torch.compile`` and CUDA graphs (the
JAX engine has neither); the elastic step pulse (item 7c).
"""
from __future__ import annotations

import contextlib
import os
import warnings

import numpy as np
import torch

from ..core import flags as _flags
from ..core import monitor as _monitor
from ..core import numeric_check as _nc
from ..core import trace as _trace
from ..framework.io import load as _load, save as _save, to_numpy
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model", "InputSpec"]


def _unported(what, needs, item):
    return NotImplementedError(
        f"{what} needs {needs}, which paddle_tpu_torch does not have yet "
        f"(ROADMAP Queue 1 item {item})")


def _flat_groups(named_tensors):
    """{dtype: [(name, tensor)]} in order."""
    out = {}
    for k, v in named_tensors:
        out.setdefault(v.dtype, []).append((k, v))
    return out


def _read_loss(lval):
    """The loss on the host: one device read, counted."""
    _monitor.stat_add("hapi/loss_reads")
    return float(lval)


class _LazyLoss:
    """``logs["loss"]`` in the async fit loop: reads the exact loss of its
    own step on first use (float() / format() / np.asarray), draining the
    window in submission order first, so a callback that reads every
    batch sees exact values at the cost of a sync per batch."""

    __slots__ = ("step", "_lval", "_drain", "_val")

    def __init__(self, step, lval, drain):
        self.step = step
        self._lval = lval
        self._drain = drain
        self._val = None

    def _materialize(self):
        """Called by the window drain, in submission order."""
        if self._val is None:
            try:
                self._val = _read_loss(self._lval)
            except Exception as e:
                raise RuntimeError(
                    f"hapi pipelined step {self.step} failed: "
                    f"{type(e).__name__}: {e}") from e
            self._lval = None
        return self._val

    def value(self):
        if self._val is None:
            self._drain(self.step)  # in-order: names the first failure
        return self._val if self._val is not None else self._materialize()

    def __float__(self):
        return self.value()

    def __format__(self, spec):
        return format(self.value(), spec)

    def __repr__(self):
        return repr(self.value())

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.value())
        return arr.astype(dtype) if dtype is not None else arr


class InputSpec:
    """Shape / dtype declaration of one input (``None`` or -1 for a free
    dimension)."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _device(net):
    for t in net.parameters():
        return t.device
    return torch.device("cpu")


def _to_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device, non_blocking=True)


class _Engine:
    """The eager train / eval / predict steps of one Model."""

    def __init__(self, model):
        self.model = model
        self._accum_grads = None
        self._accum_count = 0
        self._zero = None
        self._localsgd = None

    def _amp_ctx(self):
        cfg = self.model._amp_configs
        if not cfg:
            return contextlib.nullcontext()
        from .. import amp as amp_mod
        return amp_mod.auto_cast(
            level=cfg["level"], dtype=cfg["dtype"],
            custom_white_list=cfg.get("custom_white_list"),
            custom_black_list=cfg.get("custom_black_list"))

    def _scaler(self):
        cfg = self.model._amp_configs
        return cfg.get("scaler") if cfg else None

    def _forward_loss(self, inputs, labels, plan=None):
        """(loss, outputs). With a data-parallel ``plan`` whose batch is
        sharded the network runs on this rank's shard with BatchNorm
        synced over dp, and the outputs are gathered (LocalSGD: labels
        sharded, the loss local)."""
        net = self.model.network
        if plan is None:
            with self._amp_ctx():
                outs = _to_list(net(*inputs))
                loss = None
                if self.model._loss is not None and labels is not None:
                    loss = self.model._compute_loss(outs, list(labels))
            return loss, outs
        from ..distributed import mesh as mesh_mod
        from ..distributed import parallel as par
        from ..nn.layer.norm import sync_batch_stats
        if isinstance(net, par.DataParallel):
            net = net._layers
        mesh, sharded = plan["mesh"], plan["sharded"]
        local = plan["mode"] == "localsgd"
        shard = (lambda x: par.shard_batch(x, mesh)) if sharded \
            else (lambda x: x)
        sync = sync_batch_stats("dp") if sharded and not local \
            else contextlib.nullcontext()
        with self._amp_ctx(), mesh_mod.MeshGuard(mesh), sync:
            outs = _to_list(net(*[shard(x) for x in inputs]))
            if local:
                labels = [shard(y) for y in labels] if labels else labels
            elif sharded:
                outs = [par.gather_batch(o, mesh) for o in outs]
            loss = None
            if self.model._loss is not None and labels is not None:
                loss = self.model._compute_loss(outs, list(labels))
        return loss, outs

    # ---- data parallel -----------------------------------------------------
    def _plan(self, inputs, labels):
        """None for one process; else the step's data parallelism over the
        default mesh's dp axis: {"mesh", "dp", "mode" ("dp", "zero" or
        "localsgd"), "sharded" (whether the batch divides over dp)}."""
        from ..distributed import mesh as mesh_mod
        from ..distributed.parallel import batch_divides
        mesh = mesh_mod.get_mesh()
        if mesh is None or mesh.size == 1:
            return None
        wide = [a for a in mesh.axis_names if a != "dp" and mesh.shape[a] > 1]
        if wide:
            raise _unported(f"Model.fit under a mesh with {wide} axes",
                            "the GSPMD presets over tp / pp meshes", "7c")
        model = self.model
        strat = getattr(model._optimizer, "_dist_strategy", None)
        if strat is not None and (getattr(strat, "localsgd", False) or
                                  getattr(strat, "adaptive_localsgd", False)):
            mode = "localsgd"
        elif getattr(model._optimizer, "_zero_dp", False) \
                or getattr(model.network, "_zero_dp", False):
            mode = "zero"
        else:
            mode = "dp"
        batch = list(inputs) + (list(labels or []) if mode == "localsgd"
                                else [])
        return {"mesh": mesh, "dp": int(mesh.shape["dp"]), "mode": mode,
                "sharded": batch_divides(batch, mesh)}

    def _batch(self, values):
        dev = _device(self.model.network)
        return [_to_tensor(v, dev) for v in values]

    # ---- train -------------------------------------------------------------
    def train_batch(self, inputs, labels, update=True):
        with _nc.step_scope():
            return self._train_batch(inputs, labels, update)

    def _train_batch(self, inputs, labels, update):
        model = self.model
        net = model.network
        net.train()
        opt = model._optimizer
        named = [(n, p) for n, p in net.named_parameters() if p.requires_grad]
        if self._zero is None:
            opt._ensure_slots({n: p.detach() for n, p in named})
        inputs, labels = self._batch(inputs), self._batch(labels)
        scaler = self._scaler()
        accumulating = (not update) or self._accum_grads is not None
        plan = self._plan(inputs, labels)
        if plan is not None and plan["mode"] == "localsgd" \
                and not accumulating:
            return self._train_batch_localsgd(plan, named, inputs, labels)
        if not accumulating:
            _monitor.stat_add("hapi/train_steps")
            with _trace.span("hapi/train_step"):
                lval, outs, grads = self._grads(named, inputs, labels,
                                                scaler, plan)
                self._apply(named, grads, plan, loss=lval)
            return lval, outs
        lval, outs, grads = self._grads(named, inputs, labels, scaler, plan)
        if self._accum_grads is None:
            self._accum_grads = grads
            self._accum_count = 1
        else:
            keys = list(grads)
            summed = torch._foreach_add([self._accum_grads[k] for k in keys],
                                        [grads[k] for k in keys])
            self._accum_grads = dict(zip(keys, summed))
            self._accum_count += 1
        if update:
            self._apply(named, self._accum_grads, plan, self._accum_count,
                        loss=lval)
            self._accum_grads = None
            self._accum_count = 0
        return lval, outs

    def _grads(self, named, inputs, labels, scaler, plan=None):
        """(loss, outputs, {name: grad}) of one forward and backward; the
        loss is scaled by the scaler's current scale (in the loss's
        dtype) where there is a scaler. Under a plan whose batch ran whole
        on every rank, the ranks but dp index 0 give zeros, so that the
        sum over dp is the whole batch's gradient."""
        loss, outs = self._forward_loss(inputs, labels, plan)
        lv = loss
        if scaler is not None:
            lv = lv * scaler.scale_state()["scale"].to(lv.dtype)
        grads = torch.autograd.grad(lv, [p for _, p in named],
                                    allow_unused=True, materialize_grads=True)
        if plan is not None and plan["mode"] != "localsgd" \
                and not plan["sharded"] and plan["mesh"].axis_index("dp"):
            grads = [torch.zeros_like(g) for g in grads]
        outs = [o.detach() if isinstance(o, torch.Tensor) else o
                for o in outs]
        return loss.detach(), outs, {n: g for (n, _), g in zip(named, grads)}

    @torch.no_grad()
    def _apply(self, named, grads, plan=None, accum_count=None, loss=None):
        """The update from ``grads`` (scaled where there is a scaler; the
        sum of ``accum_count`` micro-batches' where given), summed over dp
        as ``plan`` says. With ``FLAGS_check_nan_inf`` the loss and the
        new parameters are swept before the write-back."""
        opt = self.model._optimizer
        scaler = self._scaler()
        if plan is not None and plan["mode"] == "zero":
            return self._zero_apply(plan, named, grads, accum_count, loss)
        if plan is not None and plan["mode"] == "dp":
            from ..distributed.parallel import sum_over_dp
            sum_over_dp(list(grads.values()), plan["mesh"])
        params = {n: p.detach() for n, p in named}
        slots = {n: opt._slots[n] for n in params}
        opt._step_count += 1
        lr, t = opt.get_lr(), opt._step_count
        if scaler is not None:
            grads, found, state = scaler.apply_pure(grads,
                                                    scaler.scale_state())
        if accum_count is not None:
            dev = next(iter(params.values())).device
            inv = torch.tensor(np.float32(1.0 / accum_count), device=dev)
            grads = {k: g.float() * inv for k, g in grads.items()}
        new_params, new_slots = opt.apply_gradients_pure(
            params, grads, slots, lr, t, param_meta=opt._param_meta(
                dict(named)))
        if scaler is not None:
            new_params = {k: torch.where(found, params[k], v)
                          for k, v in new_params.items()}
            new_slots = {k: {s: torch.where(found, slots[k][s], v)
                             for s, v in sl.items()}
                         for k, sl in new_slots.items()}
            scaler.load_scale_state(state)
        if _flags.flag("FLAGS_check_nan_inf"):
            _nc.sweep({"loss": loss, "params": new_params},
                      "train_batch step")
        torch._foreach_copy_([p for _, p in named],
                             [new_params[n] for n, _ in named])
        opt._slots.update(new_slots)

    # ---- ZeRO --------------------------------------------------------------
    @torch.no_grad()
    def _zero_apply(self, plan, named, grads, accum_count=None, loss=None):
        """The sharded update (``sharding.ZeroStep``): reduce-scatter, this
        rank's chunk of the masters and slots updated, all-gather."""
        from ..distributed.sharding import ZeroStep
        opt = self.model._optimizer
        if self._zero is None:
            if self._scaler() is not None:
                raise NotImplementedError(
                    "ZeRO with a GradScaler (f16 dynamic loss scaling): "
                    "use bf16")
            self._zero = ZeroStep(opt, named, plan["mesh"])
        z = self._zero
        gsh = z.reduce_scatter(grads)
        opt._step_count += 1
        lr, t = opt.get_lr(), opt._step_count
        if accum_count is not None:
            inv = torch.tensor(np.float32(1.0 / accum_count),
                               device=next(iter(gsh.values())).device)
            gsh = {k: g.float() * inv for k, g in gsh.items()}
        new_p = z.update(named, gsh, lr, t)
        if _flags.flag("FLAGS_check_nan_inf"):
            _nc.sweep({"loss": loss, "params": new_p}, "train_batch step")
        z.all_gather(named, new_p)

    def zero_state_bytes(self):
        """Bytes of this rank's optimizer state: its ZeRO chunks, or the
        optimizer's whole slots."""
        if self._zero is not None:
            return self._zero.state_bytes()
        return sum(v.numel() * v.element_size()
                   for sl in self.model._optimizer._slots.values()
                   for v in sl.values())

    def consolidate_zero(self):
        """Gather the ZeRO slot chunks whole into the optimizer (every rank
        calls it); the next sharded step re-shards."""
        if self._zero is None:
            return
        self._zero.consolidate({n: tuple(p.shape) for n, p in
                                self.model.network.named_parameters()})
        self._zero = None

    # ---- LocalSGD ----------------------------------------------------------
    def _localsgd_cfg(self):
        strat = getattr(self.model._optimizer, "_dist_strategy", None)
        cfg = dict(getattr(strat, "localsgd_configs", {}) or {})
        return {"k": max(1, int(cfg.get("k_steps", 4) or 4)),
                "adaptive": bool(getattr(strat, "adaptive_localsgd", False)),
                "max_k": int(cfg.get("max_k_steps", 16) or 16),
                "rel_tol": float(cfg.get("rel_tol", 0.01) or 0.01)}

    def _avg_over_dp(self, tensors, plan):
        """Average ``tensors`` (a list) over dp in place: one flat
        all-reduce a dtype in f32, each cast back."""
        from ..distributed.collective import _all_reduce_
        pg, _ = plan["mesh"].group("dp")
        for group in _flat_groups([(i, t) for i, t in
                                   enumerate(tensors)]).values():
            flat = torch.cat([t.reshape(-1).float() for _, t in group])
            _all_reduce_(flat, pg)
            flat = flat / plan["dp"]
            off = 0
            for _, t in group:
                t.copy_(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
                off += t.numel()

    def _train_batch_localsgd(self, plan, named, inputs, labels):
        """One local step of this rank's replica on its shard; every k-th
        step the parameters and f32 masters averaged over dp."""
        if self._scaler() is not None:
            raise ValueError(
                "strategy.localsgd does not compose with dynamic loss "
                "scaling (the reference's LocalSGDOptimizer is likewise "
                "incompatible with AMP program rewriting); use bf16 O2")
        opt = self.model._optimizer
        if self._localsgd is None:
            cfg = self._localsgd_cfg()
            self._localsgd = dict(cfg, counter=0, last_sync_loss=None,
                                  plan=plan)
        st = self._localsgd
        _monitor.stat_add("hapi/train_steps")
        with _trace.span("hapi/train_step"):
            lval, outs, grads = self._grads(named, inputs, labels, None,
                                            plan)
            self._apply(named, grads, loss=lval)   # the replica's own
        st["counter"] += 1
        with torch.no_grad():
            bufs = [b for b in self.model.network.buffers()
                    if b.is_floating_point()]
            if bufs:
                self._avg_over_dp(bufs, plan)
            lval = lval.float().reshape(1).clone()
            self._avg_over_dp([lval], plan)
            lval = lval[0]
            k = st["k"]
            if st["counter"] % k == 0:
                ps = [p.detach() for _, p in named]
                masters = [opt._slots[n]["master"] for n, _ in named
                           if "master" in opt._slots.get(n, {})]
                self._avg_over_dp(ps + masters, plan)
                _monitor.stat_add("localsgd/syncs")
                if st["adaptive"]:
                    loss = _read_loss(lval)
                    last = st["last_sync_loss"]
                    if last is not None and loss > last * (1 - st["rel_tol"]):
                        st["k"] = min(k + 1, st["max_k"])
                    st["last_sync_loss"] = loss
        return lval, outs

    def finalize_localsgd(self):
        """The replicas' average of parameters and slots written back
        (fit's end, and before evaluate, predict and save)."""
        st = self._localsgd
        if st is None:
            return
        opt = self.model._optimizer
        named = [(n, p) for n, p in self.model.network.named_parameters()
                 if p.requires_grad]
        with torch.no_grad():
            ts = [p.detach() for _, p in named]
            for n, _ in named:
                ts.extend(v for v in opt._slots.get(n, {}).values()
                          if v.is_floating_point())
            self._avg_over_dp(ts, st["plan"])
        self._localsgd = None

    # ---- eval / predict ----------------------------------------------------
    @torch.no_grad()
    def eval_batch(self, inputs, labels):
        self.finalize_localsgd()
        net = self.model.network
        net.eval()
        loss, outs = self._forward_loss(self._batch(inputs),
                                        self._batch(labels) if labels
                                        else None)
        if loss is None:
            loss = torch.zeros((), device=_device(net))
        return loss, outs

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.finalize_localsgd()
        self.model.network.eval()
        _, outs = self._forward_loss(self._batch(inputs), None)
        return outs


def _loader_state(loader):
    """The loader's resume position, or None where it has none."""
    if hasattr(loader, "state_dict"):
        try:
            return loader.state_dict()
        except Exception:
            return None
    return None


def _set_state_dict(module, state):
    """Copy ``state`` (tensors or arrays by name) into ``module``'s
    parameters and persistent buffers, in their dtypes and on their
    devices; a shape mismatch raises, missing and unexpected names warn.
    Returns (missing, unexpected)."""
    own = module.state_dict()
    missing = [n for n in own if n not in state]
    unexpected = [n for n in state if n not in own]
    with torch.no_grad():
        for name, target in own.items():
            if name not in state:
                continue
            src = state[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.asarray(src))
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: checkpoint "
                    f"{tuple(src.shape)} vs model {tuple(target.shape)}")
            target.copy_(src)
    if missing:
        warnings.warn(f"missing keys in state_dict: {missing}")
    if unexpected:
        warnings.warn(f"unexpected keys in state_dict: {unexpected}")
    return missing, unexpected


class Model:
    """``Model(network, inputs, labels)``: ``network`` is a
    ``torch.nn.Module``; ``inputs`` / ``labels`` (InputSpecs) say how many
    leading members of a batch are inputs, the rest being labels."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_configs = None
        self._engine = _Engine(self)
        self.stop_training = False

    # -- setup ---------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be a Layer or callable")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be Metric instances, got {m}")
        self._amp_configs = self._parse_amp(amp_configs)
        self._apply_strategy_recompute()
        return self

    def _apply_strategy_recompute(self):
        """strategy.recompute: ``enable_recompute`` on the layers that
        ``recompute_configs["layers"]`` names (fnmatch patterns over
        ``named_sublayers``), by default every TransformerEncoderLayer /
        TransformerDecoderLayer (the reference's RecomputeOptimizer)."""
        strat = getattr(self._optimizer, "_dist_strategy", None)
        if strat is None or not getattr(strat, "recompute", False):
            return
        cfg = getattr(strat, "recompute_configs", {}) or {}
        policy = cfg.get("policy", "nothing")
        patterns = cfg.get("layers")
        net = self.network
        if patterns:
            import fnmatch
            hits = [sub for name, sub in net.named_sublayers()
                    if any(fnmatch.fnmatch(name, p) for p in patterns)]
        else:
            from ..nn.layer.transformer import (TransformerDecoderLayer,
                                                TransformerEncoderLayer)
            hits = [sub for _, sub in net.named_sublayers()
                    if isinstance(sub, (TransformerEncoderLayer,
                                        TransformerDecoderLayer))]
        for sub in hits:
            sub.enable_recompute(policy=policy)

    def _parse_amp(self, amp_configs):
        """amp_configs: None | 'O1' / 'O2' | dict (a fleet strategy's
        ``amp`` with its ``amp_configs`` where none is given). O2 casts the
        network's parameters to the AMP dtype and turns on the optimizer's
        f32 master weights; f16 (or ``force_loss_scaling``) brings a
        GradScaler whose state lives on the network's device."""
        if amp_configs is None and self._optimizer is not None:
            strat = getattr(self._optimizer, "_dist_strategy", None)
            if strat is not None and getattr(strat, "amp", False):
                amp_configs = dict(strat.amp_configs)
                if amp_configs.pop("use_pure_bf16", False):
                    amp_configs.setdefault("level", "O2")
        if amp_configs is None:
            return None
        from .. import amp as amp_mod
        if isinstance(amp_configs, str):
            amp_configs = {"level": amp_configs}
        cfg = dict(amp_configs)
        level = cfg.get("level", "O1")
        if level == "O0":
            return None
        if level not in ("O1", "O2"):
            raise ValueError(f"amp level must be O0/O1/O2, got {level!r}")
        dtype = cfg.get("dtype", "bfloat16")
        scaler = None
        # loss scaling matters for f16's narrow exponent range; bf16 has
        # f32's range, so it gets no scaler unless one is forced
        want_scaler = (str(dtype) in ("float16", "fp16")
                       and (cfg.get("use_dynamic_loss_scaling", True)
                            or "init_loss_scaling" in cfg)) \
            or cfg.get("force_loss_scaling", False)
        if want_scaler:
            scaler = amp_mod.GradScaler(
                init_loss_scaling=cfg.get("init_loss_scaling", 2.0 ** 15),
                incr_ratio=cfg.get("incr_ratio", 2.0),
                decr_ratio=cfg.get("decr_ratio", 0.5),
                incr_every_n_steps=cfg.get("incr_every_n_steps", 1000),
                decr_every_n_nan_or_inf=cfg.get("decr_every_n_nan_or_inf", 2),
                use_dynamic_loss_scaling=cfg.get(
                    "use_dynamic_loss_scaling", True))
            scaler._to(_device(self.network))
        if level == "O2" and self._optimizer is not None:
            amp_mod.decorate(self.network, self._optimizer, level="O2",
                             dtype=dtype)
        return {"level": level, "dtype": dtype, "scaler": scaler,
                "custom_white_list": cfg.get("custom_white_list"),
                "custom_black_list": cfg.get("custom_black_list")}

    def _compute_loss(self, outputs, labels):
        loss = self._loss
        if isinstance(loss, list):
            vals = [fn(o, l) for fn, o, l in zip(loss, outputs, labels)]
            total = vals[0]
            for v in vals[1:]:
                total = total + v
            return total
        return loss(*(outputs + labels))

    # -- batch-level API -----------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        lval, _ = self._engine.train_batch(_to_list(inputs),
                                           _to_list(labels), update=update)
        return [_read_loss(lval)]

    def eval_batch(self, inputs, labels=None):
        lval, _ = self._engine.eval_batch(_to_list(inputs), _to_list(labels))
        return [_read_loss(lval)]

    def predict_batch(self, inputs):
        outs = self._engine.predict_batch(_to_list(inputs))
        return [to_numpy(o) for o in outs]

    # -- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None,
            auto_checkpoint_dir=None, auto_checkpoint_freq=50,
            keep_checkpoint_max=3):
        from ..io import DataLoader, Dataset

        if self._optimizer is None or self._loss is None:
            raise RuntimeError(
                "call prepare(optimizer=..., loss=...) before fit()")
        if isinstance(train_data, Dataset):
            train_loader = DataLoader(train_data, batch_size=batch_size,
                                      shuffle=shuffle, drop_last=drop_last,
                                      num_workers=num_workers)
        else:
            train_loader = train_data
        if eval_data is not None and isinstance(eval_data, Dataset):
            eval_loader = DataLoader(eval_data, batch_size=batch_size,
                                     num_workers=num_workers)
        else:
            eval_loader = eval_data

        do_eval = eval_loader is not None
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                save_freq=save_freq, save_dir=save_dir,
                                verbose=verbose,
                                metrics=self._metrics_name())
        acp, start_epoch, skip_steps, step_offset = None, 0, 0, 0
        if auto_checkpoint_dir is not None:
            acp, start_epoch, skip_steps, step_offset = self._acp_resume(
                auto_checkpoint_dir, auto_checkpoint_freq,
                keep_checkpoint_max, train_loader, steps)
        self._acp = acp
        guard = contextlib.nullcontext()
        if acp is not None:
            from ..incubate.checkpoint import PreemptionGuard
            self._acp_pos = (start_epoch,
                             max(skip_steps + step_offset - 1, 0))
            # the guard saves the data state of the last completed batch
            # (kept in step with _acp_pos by _run_one_epoch), never the
            # live loader cursor, which a SIGTERM mid-batch would save
            # one batch ahead of the applied optimizer state
            self._acp_data_state = _loader_state(train_loader)
            guard = PreemptionGuard(
                acp, lambda: (self._global_step,
                              acp.capture(self, *self._acp_pos,
                                          self._global_step,
                                          data_state=self._acp_data_state)))
        cbks.on_begin("train")
        logs = {}
        with guard:
            for epoch in range(start_epoch, epochs):
                cbks.on_epoch_begin(epoch)
                logs = self._run_one_epoch(train_loader, cbks, "train",
                                           num_iters=num_iters,
                                           accum=accumulate_grad_batches,
                                           log_freq=log_freq, epoch=epoch,
                                           skip_steps=skip_steps,
                                           step_offset=step_offset)
                skip_steps = step_offset = 0
                cbks.on_epoch_end(epoch, logs)
                if do_eval and epoch % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, callbacks=cbks)
                    logs.update({f"eval_{k}": v
                                 for k, v in eval_logs.items()})
                if self.stop_training:
                    break
        if acp is not None:
            acp.wait()
        self._engine.finalize_localsgd()
        cbks.on_end("train", logs)
        return self

    def _acp_resume(self, directory, freq, keep, train_loader, steps):
        """(checkpoint, start epoch, steps to skip, step offset) of
        ``fit(auto_checkpoint_dir=...)`` (JAX hapi/model.py:833-898): the
        newest verified step restored into the model, and where the loader
        resumes itself (``DataLoader.load_state_dict``), fit only offsets
        its step numbering."""
        from ..incubate.checkpoint import TrainingCheckpoint
        acp = TrainingCheckpoint(directory, keep=keep,
                                 save_interval_steps=freq)
        resumable = train_loader if hasattr(train_loader,
                                            "load_state_dict") else None
        counters = acp.restore_into(self, data_loader=resumable)
        start_epoch = skip_steps = step_offset = 0
        if counters is None:
            self._global_step = 0
            return acp, start_epoch, skip_steps, step_offset
        self._global_step = counters["global_step"]
        start_epoch = counters["epoch"]
        skip_steps = counters["step"] + 1
        if counters.get("data_resumed"):
            step_offset, skip_steps = skip_steps, 0
            # a cursor at the epoch boundary (the loader's end or fit's
            # steps= cap) means that epoch is done: roll fit's epoch label
            # with the loader's own roll
            bounds = [steps]
            try:
                bounds.append(len(train_loader))
            except TypeError:
                pass
            bounds = [b for b in bounds if b is not None]
            epoch_len = min(bounds) if bounds else None
            if epoch_len is not None and step_offset >= epoch_len:
                start_epoch, step_offset = start_epoch + 1, 0
                if hasattr(resumable, "roll_resumed_epoch"):
                    resumable.roll_resumed_epoch()
        elif steps is not None and skip_steps >= steps:
            start_epoch, skip_steps = start_epoch + 1, 0
        return acp, start_epoch, skip_steps, step_offset

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        from ..io import DataLoader, Dataset
        if isinstance(eval_data, Dataset):
            loader = DataLoader(eval_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = eval_data
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            inputs, labels = self._split_batch(batch)
            lval, outs = self._engine.eval_batch(inputs, labels)
            losses.append(_read_loss(lval))
            self._update_metrics(outs, labels)
        logs = {"loss": float(np.mean(losses)) if losses else 0.0}
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            logs.update(dict(zip(names, vals)))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        from ..io import DataLoader, Dataset
        if isinstance(test_data, Dataset):
            loader = DataLoader(test_data, batch_size=batch_size,
                                num_workers=num_workers)
        else:
            loader = test_data
        outputs = []
        for batch in loader:
            inputs, _ = self._split_batch(batch, allow_no_label=True)
            outputs.append(self.predict_batch(inputs))
        if not outputs:
            return []
        # transpose: list of per-batch lists -> per-output lists
        n_out = len(outputs[0])
        merged = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            merged = [np.concatenate(m) for m in merged]
        return merged

    def _run_one_epoch(self, loader, cbks, mode, num_iters=None, accum=1,
                       log_freq=10, epoch=0, skip_steps=0, step_offset=0):
        from collections import deque
        for m in self._metrics:
            m.reset()
        logs = {}
        # With no metrics (an update reads the outputs on the host every
        # batch) and no accumulation, logs["loss"] is a _LazyLoss and up to
        # FLAGS_executor_max_inflight steps stay unread; the window drains
        # at log_freq boundaries, at its bound and wherever a consumer
        # reads a loss. An in-flight failure surfaces at the next drain.
        inflight = int(_flags.flag("FLAGS_executor_max_inflight"))
        async_loop = (mode == "train" and inflight > 0
                      and not self._metrics and accum <= 1)
        window: deque = deque()

        def drain(through=None):
            # through=None retires only past the window bound; a boundary
            # passes `through` to read everything up to that step
            while window and ((through is not None
                               and window[0].step <= through)
                              or len(window) > inflight):
                window.popleft()._materialize()

        acp = getattr(self, "_acp", None)
        for step, batch in enumerate(loader, start=step_offset):
            if step < skip_steps:
                continue  # resumed mid-epoch: skip the consumed batches
            cbks.on_batch_begin(mode, step, logs)
            inputs, labels = self._split_batch(batch)
            update = accum <= 1 or (step + 1) % accum == 0
            lval, outs = self._engine.train_batch(inputs, labels,
                                                  update=update)
            if self._lr_sched_step_on_batch():
                self._optimizer._learning_rate.step()
            if async_loop:
                lazy = _LazyLoss(step, lval, drain)
                window.append(lazy)
                if (step + 1) % max(log_freq, 1) == 0:
                    drain(through=step)  # boundary: window fully retired
                else:
                    drain()  # retire past the window bound only
                logs["loss"] = lazy  # exact for whoever reads it
            else:
                logs["loss"] = _read_loss(lval)
            logs["batch_size"] = int(inputs[0].shape[0])
            logs.update(self._update_metrics(outs, labels))
            if acp is not None and mode == "train":
                # account the completed batch before the callbacks: a
                # SIGTERM raised from a callback saves this step as done
                self._global_step = getattr(self, "_global_step", 0) + 1
                self._acp_pos = (epoch, step)
                self._acp_data_state = _loader_state(loader)
                acp.maybe_save(self, epoch, step, self._global_step,
                               data_state=self._acp_data_state)
            cbks.on_batch_end(mode, step, logs)
            if num_iters is not None and step + 1 >= num_iters:
                break
        if window:  # epoch boundary: read the tail
            drain(through=window[-1].step)
        if async_loop and isinstance(logs.get("loss"), _LazyLoss):
            logs["loss"] = logs["loss"].value()  # plain float leaves fit
        if self._lr_sched_step_on_epoch():
            self._optimizer._learning_rate.step()
        return logs

    def _lr_sched_step_on_batch(self):
        from ..optimizer import lr as lr_mod
        sched = self._optimizer._lr_scheduler if self._optimizer else None
        return isinstance(sched, (lr_mod.NoamDecay, lr_mod.OneCycleLR,
                                  lr_mod.CyclicLR, lr_mod.LinearWarmup))

    def _lr_sched_step_on_epoch(self):
        sched = self._optimizer._lr_scheduler if self._optimizer else None
        return sched is not None and not self._lr_sched_step_on_batch()

    def _update_metrics(self, outs, labels):
        logs = {}
        for m in self._metrics:
            pre = m.compute(outs[0], *[to_numpy(l) for l in labels])
            if isinstance(pre, tuple):
                m.update(*pre)
            else:
                m.update(pre)
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            logs.update(dict(zip(names, vals)))
        return logs

    def _split_batch(self, batch, allow_no_label=False):
        n_in = max(len(self._inputs), 1)
        if isinstance(batch, (list, tuple)):
            batch = list(batch)
            if len(batch) == 1:
                return batch, []
            if allow_no_label and len(batch) <= n_in:
                return batch, []
            return batch[:n_in], batch[n_in:]
        return [batch], []

    def _metrics_name(self):
        out = ["loss"]
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            out.extend(names)
        return out

    # -- persistence ---------------------------------------------------------
    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    def state_dict(self):
        return self.network.state_dict()

    def save(self, path, training=True):
        """path prefix: writes {path}.pdparams (+ {path}.pdopt if training).
        In a data-parallel fit every rank calls it: the LocalSGD replicas
        are averaged and ZeRO's slots gathered first, then rank 0 writes."""
        self._engine.finalize_localsgd()
        self._engine.consolidate_zero()
        from ..distributed import mesh as mesh_mod
        if mesh_mod.world_rank() != 0:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        _set_state_dict(self.network, _load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            self._load_optimizer_state(_load(opt_path))
        self._engine = _Engine(self)
        return self

    def _load_optimizer_state(self, state):
        self._optimizer.set_state_dict(state)
        self._place_slots()

    def _place_slots(self):
        """Each optimizer slot on its parameter's device (the engine keys
        slots by the network's parameter names, which the optimizer's own
        list need not use)."""
        devices = {n: p.device for n, p in self.network.named_parameters()}
        for name, slots in self._optimizer._slots.items():
            if name in devices:
                for s, v in slots.items():
                    slots[s] = v.to(devices[name])

    def summary(self, input_size=None, dtype=None):
        if input_size is not None:
            # the layer table with output shapes (hapi/summary.py)
            from .summary import summary as _summary
            return _summary(self.network, input_size,
                            dtypes=[dtype] if dtype else None)
        rows = []
        total = trainable = 0
        for name, p in self.network.named_parameters():
            rows.append((name, tuple(p.shape), p.numel()))
            total += p.numel()
            if p.requires_grad:
                trainable += p.numel()
        width = max((len(r[0]) for r in rows), default=10) + 2
        lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Params':<12}"]
        for name, shape, size in rows:
            lines.append(f"{name:<{width}}{str(list(shape)):<20}{size:<12}")
        lines.append(f"Total params: {total:,}")
        lines.append(f"Trainable params: {trainable:,}")
        print("\n".join(lines))
        return {"total_params": total, "trainable_params": trainable}
