"""Static-graph Executor (paddle_tpu/static/executor.py).

The JAX Executor lowers a whole Program to one jitted step. Here "one
compiled step" is one prepared replay (``_Prepared``, made once per cache
entry by ``_prepare``): every op's Variable references are resolved to
slots of a flat environment; each run reads the scope's tensors once,
replays the recorded ops on the device in order (every op's raw torch
function, the kernel wrappers among them, with the program-level AMP cast
of ``static/amp.py`` applied per op), and writes the results back.

With a backward section the forward runs with the trained parameters as
leaves that require grad; ``torch.autograd.grad(loss, params,
allow_unused=True)`` gives their gradients (zeros for an unused one, as
under ``jax.grad``), and ``optimizer.apply_gradients_pure`` takes them
with JAX's ``param_meta``. The fetches come from that same forward (JAX's
``has_aux``), so a run's dropout feeds its own gradient. Each run seats
torch's generators from a seed drawn from the port's generator
(``core/rng``), as JAX re-seats its chain on a fresh key, so dropout
masks differ from run to run and follow ``paddle.seed``.

The write-back updates the scope's tensors in place (JAX donates them):
the trained parameters, the state writes (BatchNorm's running
statistics) and, for f16 AMP, the loss-scaling state; the optimizer's
slots are rebound. A fetch returned with ``return_numpy=False`` that
shares storage with a scope tensor is copied, so the next run does not
overwrite it.

No ``torch.compile`` and no CUDA graphs: ``torch.compile`` cannot trace
the kernels' ctypes launches, and graph capture of the replay is host-time
work for later. ``data_parallel`` over more than one device and recompute
(ROADMAP Queue 1 item 7), ``ps_config``, ``train_from_dataset`` /
``infer_from_dataset`` and ``FLAGS_check_nan_inf`` (item 8) raise
NotImplementedError naming the item.

Counters (``core/monitor``): ``executor/lowerings`` (one per prepared
replay), ``executor/runs``, ``executor/cache_evictions``; spans
``executor/lower_program`` and ``executor/run_step`` (``core/trace``).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import flags as _flags
from ..core import monitor as _monitor
from ..core import rng as _rng
from ..core import trace as _trace
from ..ops._dispatch import raw_scope
from .program import (Program, _Ref, default_main_program,
                      default_startup_program, global_scope)

__all__ = ["Executor", "CompiledProgram", "BuildStrategy",
           "ExecutionStrategy"]

_ITEM7 = "ROADMAP Queue 1 item 7 (distributed)"
_ITEM8 = "ROADMAP Queue 1 item 8"


class BuildStrategy:
    """Parity shim for fluid.BuildStrategy: the knobs are recorded."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.reduce_strategy = None


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100


class CompiledProgram:
    """reference fluid/compiler.py CompiledProgram (:88). Data parallelism
    over more than one device is item 7; on one device the program runs
    as it is."""

    def __init__(self, program, build_strategy=None, exec_strategy=None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = exec_strategy or ExecutionStrategy()
        self.data_parallel = False
        self.loss_name = None
        self.places = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        self.data_parallel = True
        self.loss_name = loss_name
        self.places = places
        if build_strategy is not None:
            self.build_strategy = build_strategy
        if exec_strategy is not None:
            self.exec_strategy = exec_strategy
        return self


def cast_vals(name, vals, dt):
    """Program-level AMP's cast point of op ``name``: its floating tensor
    inputs in ``dt`` (the policy the Executor chose for the op when it
    prepared the replay)."""
    return [v.to(dt) if isinstance(v, torch.Tensor) and v.is_floating_point()
            and v.dtype != dt else v for v in vals]


class _Prepared:
    """One prepared replay: ops with their refs resolved to env slots, and
    the host-side metadata of a run."""

    __slots__ = ("steps", "n_slots", "feed_slots", "persist_slots",
                 "fetch_slots", "write_slots", "loss_slot", "grad_slots",
                 "grad_names", "opt", "opt_pnames", "meta", "amp_dyn",
                 "amp_keys", "amp_hp")


class Executor:
    """Runs Programs on ``place`` (default: the current device, the card
    unless ``set_device("cpu")``)."""

    def __init__(self, place=None):
        self.place = place
        self._cache: "OrderedDict" = OrderedDict()

    def _device(self, program):
        if self.place is not None:
            from ..device import resolve_device
            return resolve_device(self.place)
        return program.device

    # -- prepared-replay cache ----------------------------------------------
    def _prepare(self, program, feed_vals, fetch_list, data_parallel):
        """The cached ``_Prepared`` of this program, feed set and fetch
        list, made on a miss. Keyed on program.uid (not id(program)) and
        its version, with an LRU bound (FLAGS_executor_cache_size)."""
        fetch_ids = []
        for f in fetch_list:
            if isinstance(f, str):
                matches = [v for v in program.list_vars() if v.name == f]
                if not matches:
                    raise KeyError(f"fetch '{f}' not found in program")
                fetch_ids.append(matches[0].var_id)
            else:
                fetch_ids.append(f.var_id)
        key = (program.uid, program._version, tuple(sorted(feed_vals)),
               tuple(tuple(v.shape) for _, v in sorted(feed_vals.items())),
               tuple(fetch_ids), data_parallel)
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
            return entry
        with _trace.span("executor/lower_program", program=program.name,
                         ops=len(program.ops),
                         data_parallel=bool(data_parallel)):
            entry = self._compile(program, sorted(feed_vals), fetch_ids)
        self._cache[key] = entry
        cap = max(1, int(_flags.flag("FLAGS_executor_cache_size")))
        while len(self._cache) > cap:
            self._cache.popitem(last=False)
            _monitor.stat_add("executor/cache_evictions")
        _monitor.stat_add("executor/lowerings")
        if _flags.flag("FLAGS_log_memory_estimate"):
            from .shape_infer import analyze_memory
            _monitor.stat_set("executor/estimated_peak_bytes",
                              analyze_memory(program)["peak_bytes"])
        return entry

    @staticmethod
    def _convert_feeds(program, feed, device):
        out = {}
        for name, val in feed.items():
            var = program.data_vars.get(name)
            if var is None:
                raise KeyError(f"feed '{name}' is not a data variable of the "
                               f"program (have {list(program.data_vars)})")
            if isinstance(val, torch.Tensor):
                t = torch.Tensor.detach(val)
            else:
                arr = np.asarray(val)
                if arr.dtype.name == "bfloat16":
                    arr = arr.astype(np.float32)
                t = torch.from_numpy(np.ascontiguousarray(arr))
            out[name] = t.to(device=device, dtype=var.dtype)
        return out

    # -- public API ----------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True):
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        data_parallel = False
        if isinstance(program, CompiledProgram):
            data_parallel = program.data_parallel
            places = program.places
            if data_parallel and (torch.cuda.device_count() > 1
                                  and (places is None or len(places) > 1)):
                raise NotImplementedError(
                    f"data-parallel execution over more than one device is "
                    f"{_ITEM7}")
            program = program.program
        if program is None:
            program = default_main_program()
        if program is default_startup_program() or program.name == "startup":
            # initializers already ran at parameter creation
            return []
        if _flags.flag("FLAGS_check_nan_inf"):
            raise NotImplementedError(
                f"FLAGS_check_nan_inf needs core/numeric_check, {_ITEM8}")
        if getattr(program, "recompute_checkpoints", None):
            raise NotImplementedError(f"recompute segments are {_ITEM7}")
        scope = scope or global_scope()
        device = self._device(program)
        feed_vals = self._convert_feeds(program, feed, device)
        entry = self._prepare(program, feed_vals, fetch_list, data_parallel)
        _monitor.stat_add("executor/runs")
        with _trace.span("executor/run_step", program=program.name):
            fetches = self._run(entry, feed_vals, scope, device)
        if return_numpy:
            return [_numpy(f) for f in fetches]
        return fetches

    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(f"train_from_dataset needs dataset/, "
                                  f"{_ITEM8}")

    def infer_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(f"infer_from_dataset needs dataset/, "
                                  f"{_ITEM8}")

    # -- the replay ----------------------------------------------------------
    def _compile(self, program: Program, feed_names, fetch_ids):
        from .. import amp as amp_mod
        slots = {}

        def slot(vid):
            s = slots.get(vid)
            if s is None:
                s = slots[vid] = len(slots)
            return s

        e = _Prepared()
        e.feed_slots = [(n, slot(program.data_vars[n].var_id))
                        for n in feed_names]
        e.persist_slots = [(n, slot(vid))
                           for n, vid in program.persist_ids.items()]
        amp_level = getattr(program, "amp_level", None)
        amp_dtype = getattr(program, "amp_dtype", torch.bfloat16)
        white, black = getattr(program, "amp_lists", (None, None))
        steps = []
        for op in program.ops:
            refs = [(i, slot(x.var_id)) for i, x in enumerate(op.flat)
                    if isinstance(x, _Ref)]
            kw_leaves = op.flat[op.n_args:]
            cast_dt = amp_mod.policy_dtype(op.name, amp_level, amp_dtype,
                                           white, black) \
                if amp_level else None
            kw_fixed = None
            if not any(isinstance(v, (_Ref, torch.Tensor))
                       for v in kw_leaves):
                kw_fixed = pytree.tree_unflatten(list(kw_leaves), op.kw_tree)
            out_slots = [slot(oid) for oid in op.out_ids]
            steps.append((op.fn, list(op.flat), refs, op.n_args, op.kw_tree,
                          kw_fixed, out_slots, cast_dt, op.name))
        e.steps = steps
        e.fetch_slots = [slot(f) for f in fetch_ids]
        e.write_slots = [(n, slot(vid))
                         for n, vid in program.state_writes.items()]
        bwd = program.backward_section
        opt_sec = program.optimizer_section
        e.opt = opt_sec[0] if (opt_sec and bwd is not None) else None
        e.loss_slot = e.grad_slots = None
        e.grad_names = []
        e.amp_dyn = bool(getattr(program, "amp_dynamic_scaling", False)) \
            and bwd is not None
        e.amp_hp = dict(getattr(program, "amp_scaling_hparams", {}) or {})
        tag = f"{program.name}#{program.uid}"
        e.amp_keys = (f"_amp_loss_scale_@{tag}", f"_amp_good_steps_@{tag}",
                      f"_amp_bad_steps_@{tag}")
        if bwd is not None:
            loss_var, pairs = bwd
            e.loss_slot = slot(loss_var.var_id)
            e.grad_names = [p.scope_name for p, _ in pairs]
            e.grad_slots = [slot(g.var_id) for _, g in pairs]
        e.opt_pnames = [p.scope_name for p, _ in opt_sec[1]] \
            if e.opt is not None else []
        e.meta = None
        if e.opt is not None:
            opt = e.opt
            e.meta = {p.scope_name: {
                "lr_ratio": getattr(p, "optimize_attr", {}).get(
                    "learning_rate", 1.0),
                "regularizer": getattr(p, "regularizer", None)
                or opt._coupled_decay_default(),
                "need_clip": getattr(p, "need_clip", True)}
                for p, _ in opt_sec[1]}
        e.n_slots = len(slots)
        return e

    @staticmethod
    def _replay(entry, env):
        for fn, flat, refs, n_args, kw_tree, kw_fixed, outs, cast_dt, name \
                in entry.steps:
            vals = list(flat)
            for i, s in refs:
                vals[i] = env[s]
            if cast_dt is not None:
                vals = cast_vals(name, vals, cast_dt)
            kw = kw_fixed if kw_fixed is not None else \
                pytree.tree_unflatten(vals[n_args:], kw_tree)
            out = fn(*vals[:n_args], **kw)
            if len(outs) == 1 and not isinstance(out, (tuple, list)):
                env[outs[0]] = out
            else:
                for s, v in zip(outs, out):
                    env[s] = v

    def _run(self, e, feed_vals, scope, device):
        scope_vals = {n: scope.get(n) for n, _ in e.persist_slots}
        env = [None] * e.n_slots
        for n, s in e.feed_slots:
            env[s] = feed_vals[n]
        for n, s in e.persist_slots:
            env[s] = scope_vals[n]
        seed = int(torch.randint(0, 2 ** 62, (),
                                 generator=_rng.generator("cpu")))
        cuda = [device] if device.type == "cuda" else []
        leaves = {}
        with torch.random.fork_rng(devices=cuda, device_type="cuda"), \
                raw_scope():
            torch.manual_seed(seed)
            if e.loss_slot is None:
                with torch.no_grad():
                    self._replay(e, env)
            else:
                slot_of = dict(e.persist_slots)
                with torch.enable_grad():
                    for n in e.grad_names:
                        leaf = scope_vals[n].detach().requires_grad_(True)
                        leaves[n] = leaf
                        env[slot_of[n]] = leaf
                    self._replay(e, env)
                    loss = env[e.loss_slot]
                    if e.amp_dyn:
                        for k, v0 in zip(e.amp_keys, self._amp_init(e,
                                                                     device)):
                            if not scope.has(k):
                                scope.set(k, v0)
                        scale = scope.get(e.amp_keys[0])
                        loss = (loss.float() * scale).to(loss.dtype)
                    grads = torch.autograd.grad(
                        loss, [leaves[n] for n in e.grad_names],
                        allow_unused=True)
                env[e.loss_slot] = env[e.loss_slot].detach()
                grads = {n: (torch.zeros_like(leaves[n]) if g is None else g)
                         for n, g in zip(e.grad_names, grads)}
                self._backward_tail(e, env, grads, scope, scope_vals)
            fetches = [env[s] for s in e.fetch_slots]
            fetches = [f.detach() if isinstance(f, torch.Tensor) else f
                       for f in fetches]
        with torch.no_grad():
            writes = [(scope.get(n), env[s]) for n, s in e.write_slots]
            if writes:
                torch._foreach_copy_([d for d, _ in writes],
                                     [s.detach() for _, s in writes])
        live = {t.untyped_storage().data_ptr() for t in scope_vals.values()}
        return [f.clone() if isinstance(f, torch.Tensor)
                and f.untyped_storage().data_ptr() in live else f
                for f in fetches]

    @staticmethod
    def _amp_init(e, device):
        return (torch.tensor(float(e.amp_hp.get("init", 2.0 ** 15)),
                             dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def _backward_tail(e, env, grads, scope, scope_vals):
        """Loss-scaling, the grad fetches, the optimizer update and the
        parameters' in-place write-back."""
        from .. import amp as amp_mod
        found_inf = None
        if e.amp_dyn:
            sk, gk, bk = e.amp_keys
            scale = scope.get(sk)
            grads, found_inf = amp_mod.check_finite_and_unscale(grads, scale)
            hp = e.amp_hp
            new = amp_mod.update_loss_scaling(
                scale, scope.get(gk), scope.get(bk), found_inf,
                incr_ratio=hp.get("incr_ratio", 2.0),
                decr_ratio=hp.get("decr_ratio", 0.5),
                incr_every_n_steps=hp.get("incr_every_n_steps", 1000),
                decr_every_n_nan_or_inf=hp.get("decr_every_n_nan_or_inf", 2))
            for k, v in zip(e.amp_keys, new):
                scope.set(k, v)
        for n, s in zip(e.grad_names, e.grad_slots):
            env[s] = grads[n]
        opt = e.opt
        if opt is None:
            return
        pvals = {n: scope_vals[n] for n in e.opt_pnames}
        opt._ensure_slots(pvals)
        slots = {n: opt._slots[n] for n in e.opt_pnames}
        opt._step_count += 1
        new_p, new_slots = opt.apply_gradients_pure(
            pvals, {n: grads.get(n) for n in e.opt_pnames}, slots,
            opt.get_lr(), opt._step_count, param_meta=e.meta)
        if found_inf is not None:       # skip the update on overflow
            new_p = {n: torch.where(found_inf, pvals[n], v)
                     for n, v in new_p.items()}
            new_slots = {n: {k: torch.where(found_inf, slots[n][k], v)
                             for k, v in d.items()}
                         for n, d in new_slots.items()}
        with torch.no_grad():
            torch._foreach_copy_([pvals[n] for n in e.opt_pnames],
                                 [new_p[n] for n in e.opt_pnames])
        opt._slots.update(new_slots)


def _numpy(f):
    if not isinstance(f, torch.Tensor):
        return np.asarray(f)
    t = f.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
