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

A step is a function (``Executor._step``): from the feeds, the scope
values, the optimizer's slots, the learning rate, the step count and a
seed it returns the fetches, the new scope values (the trained
parameters, the state writes such as BatchNorm's running statistics and,
for f16 AMP, the loss-scaling state) and the new slots, and writes
nothing. ``run`` then sweeps them for inf / nan (``FLAGS_check_nan_inf``)
before it writes them back: the scope's tensors are updated in place (JAX
donates them) and the optimizer's slots rebound. A fetch returned with
``return_numpy=False`` that shares storage with a scope tensor is copied,
so the next run does not overwrite it; ``return_handles=True`` returns
lazy ``FetchHandle``s that copy to the host only when read.
``static/pipeline_runner.PipelineRunner`` drives the same step with the
scope values kept on the device between steps (the JAX package's
device-resident carry).

No ``torch.compile`` and no CUDA graphs: ``torch.compile`` cannot trace
the kernels' ctypes launches, and graph capture of the replay is host-time
work for later. ``data_parallel`` over more than one device and recompute
(ROADMAP Queue 1 item 7) raise NotImplementedError naming the item.

``train_from_dataset`` / ``infer_from_dataset`` drive a dataset's
batches (``io/fleet_dataset.py``, ``dataset/streaming.py``): through a
``PipelineRunner`` when the in-flight depth is above 0, else one
``run`` a batch. With ``ps_config`` the parameter-server loop
(``_DownpourDriver``: sync Downpour or the online mode) runs one ``run`` a
batch whatever the depth, as the JAX package's does: its pull before and
push after every batch read and write the scope.

Counters (``core/monitor``): ``executor/lowerings`` (one per prepared
replay), ``executor/runs``, ``executor/cache_evictions``,
``executor/dataset_batches``; spans
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


class BuildStrategy:
    """Parity shim for fluid.BuildStrategy: the knobs are recorded."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.reduce_strategy = None


class ExecutionStrategy:
    """``max_inflight`` / ``scan_fuse_steps``: the PipelineRunner's depth
    and megastep size under ``train_from_dataset`` (None: the flags
    ``FLAGS_executor_max_inflight`` / ``FLAGS_executor_scan_steps``)."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100
        self.max_inflight = None
        self.scan_fuse_steps = None


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
                 "amp_keys", "amp_hp", "read_names", "feed_names")

    def amp_init(self, device):
        """{scope name: initial value} of the loss-scaling state (f16
        dynamic scaling), empty without it."""
        if not self.amp_dyn:
            return {}
        return dict(zip(self.amp_keys, (
            torch.tensor(float(self.amp_hp.get("init", 2.0 ** 15)),
                         dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))))


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
    def _convert_feeds(program, feed, device, pin=False):
        """The feeds as tensors on ``device`` in their Variables' dtypes;
        ``pin``: a host array goes through pinned memory and a
        non-blocking copy (the PipelineRunner's prefetch)."""
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
                if pin and device.type == "cuda":
                    t = t.pin_memory()
            out[name] = t.to(device=device, dtype=var.dtype,
                             non_blocking=pin)
        return out

    @staticmethod
    def _resolve(program):
        """(program, data_parallel) of a Program or CompiledProgram."""
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
        if getattr(program, "recompute_checkpoints", None):
            raise NotImplementedError(f"recompute segments are {_ITEM7}")
        return program, data_parallel

    @staticmethod
    def _opt_inputs(e, scope_vals):
        """(slots, lr, t) of the next step: the optimizer's slots (made
        at the first step), its step count advanced, and the rate at it."""
        opt = e.opt
        if opt is None:
            return {}, 0.0, 0
        opt._ensure_slots({n: scope_vals[n] for n in e.opt_pnames})
        opt._step_count += 1
        return ({n: opt._slots[n] for n in e.opt_pnames}, opt.get_lr(),
                opt._step_count)

    @staticmethod
    def _next_seed():
        """The seed of one run's generators, drawn from the port's."""
        return int(torch.randint(0, 2 ** 62, (),
                                 generator=_rng.generator("cpu")))

    # -- public API ----------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, use_program_cache=True,
            return_handles=False):
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        program, data_parallel = self._resolve(program)
        if program is default_startup_program() or program.name == "startup":
            # initializers already ran at parameter creation
            return []
        scope = scope or global_scope()
        device = self._device(program)
        feed_vals = self._convert_feeds(program, feed, device)
        e = self._prepare(program, feed_vals, fetch_list, data_parallel)
        for n, v0 in e.amp_init(device).items():
            if not scope.has(n):
                scope.set(n, v0)
        scope_vals = {n: scope.get(n) for n in e.read_names}
        slots, lr, t = self._opt_inputs(e, scope_vals)
        _monitor.stat_add("executor/runs")
        with _trace.span("executor/run_step", program=program.name):
            fetches, new_scope, new_slots = self._step(
                e, feed_vals, scope_vals, slots, lr, t, self._next_seed(),
                device)
        # the sweep comes before the write-back (never commit a nan
        # state), in return_handles mode too
        if _flags.flag("FLAGS_check_nan_inf"):
            _sweep_step(fetches, new_scope)
        fetches = _unalias(fetches, scope_vals)
        write_back(scope, scope_vals, new_scope)
        if e.opt is not None:
            e.opt._slots.update(new_slots)
        if return_handles:
            from .pipeline_runner import FetchHandle
            idx = int(_monitor.stat_get("executor/runs")) - 1
            return [FetchHandle(f, idx) for f in fetches]
        if return_numpy:
            return [_numpy(f) for f in fetches]
        return fetches

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           ps_config=None, start_batch=0,
                           fetch_handler=None):
        """Train on every batch of ``dataset`` (paddle_tpu/static/
        executor.py:346): an ``io.InMemoryDataset`` / ``QueueDataset``, a
        ``dataset.StreamingDataset`` or any object with ``batches()``.

        With an in-flight depth above 0 (the program's
        ``exec_strategy.max_inflight``, else ``FLAGS_executor_max_inflight``)
        the batches go through a ``PipelineRunner`` (in-flight steps, the
        carry kept on the device, scan-fused megasteps at
        ``exec_strategy.scan_fuse_steps`` / ``FLAGS_executor_scan_steps``)
        and the fetches are read only at ``print_period``; at 0 each batch
        is one ``run``. ``start_batch`` skips the first batches (at the
        dataset's index level where ``batches(start_batch=)`` exists) and
        numbers the steps on from there: with the dataset's and the
        scope's state of that point it resumes a run exactly.
        ``fetch_handler(batch_number, fetches)`` (the reference's
        parameter; the JAX package has none) is called after every batch
        with its fetches: lazy ``FetchHandle``s on the pipelined path, so
        a handler that keeps them adds no sync. Returns None, as the JAX
        package's does.

        ``ps_config`` enables the Downpour loop (reference
        framework/downpour_worker.cc: pull sparse rows before each batch,
        run, push sparse grads after):
          {"client": PSClient, "communicator": Communicator | None,
           "sparse": [{"param": var_name, "slot": feed_slot,
                       "table": table_name}]}
        PS-managed params are pulled into the scope for the batch's ids,
        the rows of their grads are pushed as (ids, rows) pairs, and they
        leave the program's local optimizer section — the server's
        accessor owns the update rule. ``{"mode": "online", ...}`` is the
        continuous variant (docs/online_learning.md): the params keep the
        local optimizer and accumulated deltas flow to a "geo_sparse"
        table through replay-keyed ``push_sparse_delta`` every
        "sync_every" batches under the PADDLE_ONLINE_STALENESS_BATCHES
        bound. Either mode runs one ``run`` a batch."""
        if dataset is None:
            raise ValueError("train_from_dataset requires a dataset")
        program_ = program.program if isinstance(program, CompiledProgram) \
            else program
        dp = _DownpourDriver(program_ or default_main_program(), scope,
                             ps_config) if ps_config else None
        base_fetch = list(fetch_list or [])
        names = fetch_info or [getattr(f, "name", str(f))
                               for f in base_fetch]
        es = program.exec_strategy if isinstance(program, CompiledProgram) \
            else None
        inflight = getattr(es, "max_inflight", None)
        if inflight is None:
            inflight = _flags.flag("FLAGS_executor_max_inflight")
        start_batch = int(start_batch or 0)

        def batches():
            try:
                return dataset.batches(start_batch=start_batch)
            except TypeError:
                import itertools
                return itertools.islice(dataset.batches(), start_batch,
                                        None)

        def report(it, outs):
            if fetch_handler is not None:
                fetch_handler(it, outs)
            if debug or (base_fetch and print_period
                         and it % print_period == 0):
                msg = ", ".join(f"{n}={np.asarray(v).mean():.6f}"
                                for n, v in zip(names, outs))
                print(f"batch {it}: {msg}")

        it = start_batch
        if dp is None and inflight > 0:
            from .pipeline_runner import PipelineRunner
            with PipelineRunner(
                    self, program, fetch_list=base_fetch, scope=scope,
                    max_inflight=inflight,
                    scan_steps=getattr(es, "scan_fuse_steps", None)) \
                    as runner:
                for handles in runner.run(batches()):
                    _monitor.stat_add("executor/dataset_batches")
                    it += 1
                    report(it, handles)
            return None
        for feed in batches():
            if dp is None:
                outs = self.run(program, feed=feed, fetch_list=base_fetch,
                                scope=scope)
            else:
                feed = dp.pre_step(feed)
                outs = self.run(program, feed=feed,
                                fetch_list=base_fetch + dp.grad_fetches,
                                scope=scope, return_numpy=False)
                dp.post_step(outs[len(base_fetch):])
                outs = [_numpy(o) for o in outs[:len(base_fetch)]]
            _monitor.stat_add("executor/dataset_batches")
            it += 1
            report(it, outs)
        if dp is not None:
            dp.flush()
        return None

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """The same loop; the program has no optimizer section."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

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
        e.feed_names = list(feed_names)
        e.read_names = [n for n, _ in e.persist_slots] \
            + (list(e.amp_keys) if e.amp_dyn else [])
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

    def _step(self, e, feed_vals, scope_vals, slots, lr, t, seed, device):
        """One run of the prepared replay as a function: (fetches, new
        scope values {name: tensor}, new optimizer slots). ``scope_vals``
        holds every name of ``e.read_names``; nothing is written."""
        env = [None] * e.n_slots
        for n, s in e.feed_slots:
            env[s] = feed_vals[n]
        for n, s in e.persist_slots:
            env[s] = scope_vals[n]
        cuda = [device] if device.type == "cuda" else []
        new_scope, new_slots = {}, {}
        with torch.random.fork_rng(devices=cuda, device_type="cuda"), \
                raw_scope():
            torch.manual_seed(seed)
            if e.loss_slot is None:
                with torch.no_grad():
                    self._replay(e, env)
            else:
                slot_of = dict(e.persist_slots)
                leaves = {}
                with torch.enable_grad():
                    for n in e.grad_names:
                        leaf = scope_vals[n].detach().requires_grad_(True)
                        leaves[n] = leaf
                        env[slot_of[n]] = leaf
                    self._replay(e, env)
                    loss = env[e.loss_slot]
                    if e.amp_dyn:
                        scale = scope_vals[e.amp_keys[0]]
                        loss = (loss.float() * scale).to(loss.dtype)
                    grads = torch.autograd.grad(
                        loss, [leaves[n] for n in e.grad_names],
                        allow_unused=True)
                env[e.loss_slot] = env[e.loss_slot].detach()
                grads = {n: (torch.zeros_like(leaves[n]) if g is None else g)
                         for n, g in zip(e.grad_names, grads)}
                new_scope, new_slots = self._backward_tail(
                    e, env, grads, scope_vals, slots, lr, t)
            fetches = [env[s] for s in e.fetch_slots]
            fetches = [f.detach() if isinstance(f, torch.Tensor) else f
                       for f in fetches]
        for n, s in e.write_slots:
            new_scope[n] = env[s].detach()
        return fetches, new_scope, new_slots

    @staticmethod
    def _backward_tail(e, env, grads, scope_vals, slots, lr, t):
        """Loss scaling, the grad fetches and the optimizer update:
        (new scope values, new slots)."""
        from .. import amp as amp_mod
        found_inf = None
        new_scope = {}
        if e.amp_dyn:
            sk, gk, bk = e.amp_keys
            scale = scope_vals[sk]
            grads, found_inf = amp_mod.check_finite_and_unscale(grads, scale)
            hp = e.amp_hp
            new = amp_mod.update_loss_scaling(
                scale, scope_vals[gk], scope_vals[bk], found_inf,
                incr_ratio=hp.get("incr_ratio", 2.0),
                decr_ratio=hp.get("decr_ratio", 0.5),
                incr_every_n_steps=hp.get("incr_every_n_steps", 1000),
                decr_every_n_nan_or_inf=hp.get("decr_every_n_nan_or_inf", 2))
            new_scope.update(zip(e.amp_keys, new))
        for n, s in zip(e.grad_names, e.grad_slots):
            env[s] = grads[n]
        opt = e.opt
        if opt is None:
            return new_scope, {}
        pvals = {n: scope_vals[n] for n in e.opt_pnames}
        new_p, new_slots = opt.apply_gradients_pure(
            pvals, {n: grads.get(n) for n in e.opt_pnames}, slots, lr, t,
            param_meta=e.meta)
        if found_inf is not None:       # skip the update on overflow
            new_p = {n: torch.where(found_inf, pvals[n], v)
                     for n, v in new_p.items()}
            new_slots = {n: {k: torch.where(found_inf, slots[n][k], v)
                             for k, v in d.items()}
                         for n, d in new_slots.items()}
        new_scope.update(new_p)
        return new_scope, new_slots


def _sweep_step(fetches, new_scope):
    from ..core.numeric_check import sweep
    sweep({"fetches": list(fetches), "scope": new_scope},
          "Executor.run step")


def write_back(scope, scope_vals, new_scope):
    """The new scope values into the scope: in place into the scope's
    own tensors (``scope_vals``, read before the step), set where the
    scope has none."""
    dst, src = [], []
    for n, v in new_scope.items():
        old = scope_vals.get(n)
        if old is None or old is not scope.get(n) \
                or old.shape != v.shape or old.dtype != v.dtype:
            scope.set(n, v)
        elif v is not old:
            dst.append(old)
            src.append(v)
    if dst:
        with torch.no_grad():
            torch._foreach_copy_(dst, src)


def _unalias(fetches, scope_vals):
    """Fetches that share storage with a scope tensor, copied (the
    write-back updates those in place)."""
    live = {t.untyped_storage().data_ptr() for t in scope_vals.values()
            if isinstance(t, torch.Tensor)}
    return [f.clone() if isinstance(f, torch.Tensor)
            and f.untyped_storage().data_ptr() in live else f
            for f in fetches]


def _numpy(f):
    if not isinstance(f, torch.Tensor):
        return np.asarray(f)
    t = f.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _DownpourDriver:
    """Per-batch sparse pull / push around the step (paddle_tpu/static/
    executor.py:702; reference framework/downpour_worker.cc
    FillSparseValue / push_sparse).

    The PS-managed embedding param stays a scope tensor on the device;
    before each batch the rows the batch touches are pulled from the
    server into it (one host-to-device copy), after the step those rows
    of its gradient are pushed back (one device-to-host copy of just
    those rows), optionally through the async Communicator. The param
    leaves the local optimizer section: the server-side accessor
    (sgd / adagrad / adam) owns the update.

    mode="online" is the CONTINUOUS Downpour / Geo variant that closes
    the serve -> train loop (docs/online_learning.md): the param KEEPS
    its local optimizer, and what flows to the server is the accumulated
    LOCAL DELTA, pushed through `push_sparse_delta` against a
    "geo_sparse" table every `sync_every` batches. Each cut payload
    carries a stable request key ("online", trainer id, flush sequence),
    so a flush retried across transport faults, server failover, or a
    trainer restart (with the client's replay state restored) applies
    EXACTLY ONCE. A failing flush is deferred and retried at the next
    cadence up to the staleness bound (PADDLE_ONLINE_STALENESS_BATCHES),
    then the error propagates (fail-stop). A spec's "prefetcher"
    (EmbeddingPrefetcher) routes pulls through the prefetch / conflict
    machinery and gets `note_pushed` after every acked flush.
    `flush_log` records every cut payload (spec, seq, ids)."""

    def __init__(self, program, scope, ps_config):
        self.scope = scope or global_scope()
        self.client = ps_config["client"]
        self.comm = ps_config.get("communicator")
        self.mode = ps_config.get("mode", "sync")
        if self.mode not in ("sync", "online"):
            raise ValueError(f"ps_config mode {self.mode!r} "
                             f"(want 'sync' or 'online')")
        self.online = self.mode == "online"
        self.specs = [dict(s) for s in ps_config.get("sparse", [])]
        for s in self.specs:
            target = s["param"]
            pv = next((v for v in program.persistable_vars.values()
                       if v.name == target
                       or getattr(v, "scope_name", None) == target), None)
            if pv is None:
                raise ValueError(
                    f"ps_config param {target!r} is not a persistable var "
                    f"of the program")
            s["_name"] = pv.name
            s["_scope"] = getattr(pv, "scope_name", None) or pv.name
        ps_names = {s["_name"] for s in self.specs}
        if program.optimizer_section and not self.online:
            opt, pairs = program.optimizer_section
            keep = [(p, g) for p, g in pairs if p.name not in ps_names]
            if len(keep) != len(pairs):
                program.optimizer_section = (opt, keep)
                program._version += 1
        self.grad_fetches = []
        if not self.online:
            bw = getattr(program, "backward_section", None)
            bw_pairs = bw[1] if bw else []
            for s in self.specs:
                gvar = next((g for p, g in bw_pairs
                             if p.name == s["_name"]), None)
                if gvar is None:
                    raise ValueError(
                        f"ps_config param {s['param']!r} has no grad var "
                        "— run minimize()/append_backward over it")
                self.grad_fetches.append(gvar)
        else:
            self.sync_every = int(
                ps_config.get("sync_every")
                or _flags.flag("PADDLE_ONLINE_SYNC_EVERY"))
            self.staleness = max(
                int(ps_config.get("staleness_batches")
                    or _flags.flag("PADDLE_ONLINE_STALENESS_BATCHES")),
                self.sync_every)
            self.trainer_id = int(ps_config.get("trainer_id", 0))
            self.on_batch = ps_config.get("on_batch")
            self._pending = [{} for _ in self.specs]  # id -> delta row
            self._frozen = [None] * len(self.specs)   # unacked payload
            self._flush_seq = [0] * len(self.specs)
            self._unflushed = 0       # batches past last acked flush
            self._batch_count = 0
            self.flush_log = []       # (spec_idx, seq, ids) of payloads
            if ps_config.get("state"):
                self.load_online_state(ps_config["state"])
        self._pulled = [None] * len(self.specs)
        self._before = [None] * len(self.specs)

    def pre_step(self, feed):
        for i, s in enumerate(self.specs):
            ids = _numpy(feed[s["slot"]]).reshape(-1)
            uniq = np.unique(ids.astype(np.int64))
            w = self.scope.get(s["_scope"])
            pf = s.get("prefetcher")
            if self.online and pf is not None:
                pf.prefetch(uniq)
                rows = pf.get(uniq).to(w.device, torch.float32)
            else:
                rows = torch.from_numpy(np.asarray(
                    self.client.pull_sparse(s["table"], uniq),
                    np.float32)).to(w.device)
            idx = torch.as_tensor(uniq, device=w.device)
            if self.online:
                # local view = server rows + this worker's un-acked
                # progress (pending accumulation, then any frozen payload
                # still in retry) — Downpour: the worker trains on its
                # own freshest rows, the server sees deltas at flush
                rows = self._add_rows(rows, uniq, self._pending[i])
                frozen = self._frozen[i]
                if frozen is not None:
                    rows = self._add_rows(rows, uniq, {
                        int(x): frozen[2][k]
                        for k, x in enumerate(frozen[1])})
                self._before[i] = rows
            with torch.no_grad():
                w[idx] = rows.to(w.dtype)
            self._pulled[i] = uniq
        return feed

    @staticmethod
    def _add_rows(rows, uniq, by_id):
        """rows + by_id's row for each id of uniq that has one (the rest
        untouched, so no -0.0 turns into 0.0), in one host-to-device copy."""
        pos = [j for j, ident in enumerate(uniq.tolist()) if ident in by_id]
        if not pos:
            return rows
        add = torch.from_numpy(np.stack(
            [by_id[int(uniq[j])] for j in pos])).to(rows.device)
        sel = torch.as_tensor(pos, device=rows.device)
        rows = rows.clone()
        rows[sel] = rows[sel] + add
        return rows

    def post_step(self, grad_outs):
        if not self.online:
            for s, uniq, g in zip(self.specs, self._pulled, grad_outs):
                rows_g = _numpy(g[torch.as_tensor(uniq, device=g.device)])
                if self.comm is not None:
                    self.comm.push_sparse(s["table"], uniq, rows_g)
                else:
                    self.client.push_sparse_grad(s["table"], uniq, rows_g)
            return
        for i, s in enumerate(self.specs):
            uniq = self._pulled[i]
            w = self.scope.get(s["_scope"])
            after = w[torch.as_tensor(uniq, device=w.device)].float()
            delta = _numpy(after - self._before[i])
            pend = self._pending[i]
            for j, ident in enumerate(uniq.tolist()):
                d = pend.get(ident)
                pend[ident] = delta[j].copy() if d is None \
                    else d + delta[j]
        self._unflushed += 1
        self._batch_count += 1
        self._maybe_flush()
        if self.on_batch is not None:
            self.on_batch(self)

    # -- online (continuous Downpour) flush machinery -----------------------
    def _maybe_flush(self, force=False):
        if not force and self._unflushed < self.sync_every:
            _monitor.stat_set("ps.online.staleness_batches",
                              self._unflushed)
            return
        try:
            self._push_all()
            self._unflushed = 0
        except (ConnectionError, OSError, RuntimeError):
            # transient PS trouble (chaos, failover in progress): defer
            # to the next cadence — but only inside the staleness bound
            _monitor.stat_add("ps.online.deferred_flushes")
            if force or self._unflushed >= self.staleness:
                raise
        _monitor.stat_set("ps.online.staleness_batches",
                          self._unflushed)

    def _push_all(self):
        for i, s in enumerate(self.specs):
            if self._frozen[i] is not None:
                # retry the frozen payload FIRST, under its original
                # request key — if the failed attempt actually applied
                # server-side, the replay cache swallows this resend
                seq, fids, fdeltas = self._frozen[i]
                self._push_payload(s, seq, fids, fdeltas)
                self._frozen[i] = None
            pend = self._pending[i]
            if not pend:
                continue
            ids = np.fromiter(sorted(pend), np.int64, len(pend))
            deltas = np.stack([pend[int(x)] for x in ids])
            seq = self._flush_seq[i]
            self._flush_seq[i] += 1
            # the payload is CUT here: logged once, then pushed under a
            # stable key until acked — the log IS the delta schedule
            self.flush_log.append((i, seq, tuple(int(x) for x in ids)))
            self._pending[i] = {}
            self._frozen[i] = (seq, ids, deltas)
            self._push_payload(s, seq, ids, deltas)
            self._frozen[i] = None

    def _push_payload(self, s, seq, ids, deltas):
        self.client.push_sparse_delta(
            s["table"], ids, deltas,
            request_key=("online", self.trainer_id, int(seq)))
        pf = s.get("prefetcher")
        if pf is not None:
            pf.note_pushed(ids)
        _monitor.stat_add("ps.online.flushes")
        _monitor.stat_add("ps.online.delta_rows", len(ids))

    def online_state(self):
        """Checkpoint payload of the continuous trainer: un-pushed
        accumulation, any frozen (cut, unacked) payloads with their flush
        sequence numbers, and the client's replay identity — a restarted
        trainer restoring this (plus the dataset's state_dict) resumes
        the EXACT delta schedule, and resent payloads dedupe
        server-side. The same plain-container format as the JAX
        package's."""
        return {
            "flush_seq": list(self._flush_seq),
            "unflushed": int(self._unflushed),
            "batch_count": int(self._batch_count),
            "pending": [{int(k): v.tolist() for k, v in p.items()}
                        for p in self._pending],
            "frozen": [None if f is None else
                       [int(f[0]), np.asarray(f[1]).tolist(),
                        np.asarray(f[2]).tolist()] for f in self._frozen],
            "flush_log": [[i, seq, list(ids)]
                          for i, seq, ids in self.flush_log],
            "replay": self.client.replay_state(),
        }

    def load_online_state(self, state):
        self._flush_seq = [int(x) for x in state["flush_seq"]]
        self._unflushed = int(state["unflushed"])
        self._batch_count = int(state["batch_count"])
        self._pending = [
            {int(k): np.asarray(v, np.float32) for k, v in p.items()}
            for p in state["pending"]]
        self._frozen = [
            None if f is None else
            (int(f[0]), np.asarray(f[1], np.int64),
             np.asarray(f[2], np.float32)) for f in state["frozen"]]
        self.flush_log = [(int(i), int(seq), tuple(ids))
                          for i, seq, ids in state["flush_log"]]
        self.client.load_replay_state(state["replay"])

    def flush(self):
        if self.online:
            # end of stream: push everything, fail-stop on error
            self._maybe_flush(force=True)
            return
        if self.comm is not None:
            self.comm.flush()
