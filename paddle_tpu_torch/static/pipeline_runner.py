"""Async pipelined training loop and the bounded in-flight window
(paddle_tpu/static/pipeline_runner.py).

PyTorch's CUDA stream is already asynchronous: a step enqueues its
kernels and returns. What keeps the card idle between steps is the host:
``Executor.run`` reads the scope name by name, converts the feeds and
reads every fetch back to the host, so each step ends in a sync. The
JAX package's answer is this module, with three mechanisms:

1. **In-flight steps** (``FLAGS_executor_max_inflight``, default 2):
   ``PipelineRunner.submit`` returns lazy ``FetchHandle``s and records a
   CUDA event after the step; at most N steps stay outstanding, the
   runner waiting on the oldest one's event when the window is full.
   Fetches are read only where the caller reads them. A failure inside an
   in-flight step surfaces at the next materialization as a
   ``PipelineStepError`` naming the failing step (in-order verification),
   and leaves a flight-recorder dump (``core/flight_recorder.py``).

2. **Device-resident carry**: between steps the runner keeps the
   prepared replay's scope values (parameters, state writes, the
   loss-scaling state) and the optimizer's slots as the previous step's
   output tensors on the device, and writes the ``Scope`` and the
   optimizer back only at ``sync()`` (or on leaving the ``with`` block).
   Scope writes made by others between submits are not seen by the
   runner. The optimizer's step count advances at every submit, as in
   the serial loop.

3. **Scan-fused megasteps** (``FLAGS_executor_scan_steps`` = K, opt in):
   when the feed shapes are stable, ``run`` stacks K batches on the host
   and makes one host-to-device copy of them, and ``submit_scan`` replays
   the K steps back to back with no host sync between them, with the
   per-step (lr, step, seed) stream drawn first exactly as the serial loop
   draws it. torch has no ``lax.scan``: a megastep is K replays of the
   same step function, so it is bitwise equal to K serial
   ``Executor.run`` steps, not one dispatch.

``run(feeds)`` converts the next batches on a prefetch thread (a pinned
host buffer and a non-blocking copy, in place of ``jax.device_put``),
overlapping the in-flight steps.

``InflightDriver`` is the same window for drivers that are not Programs:
the continuous-batching serve loop (``inference/serving.py``).
``StagedPipelineRunner`` drives a planned pipeline partition
(``spmd_planner.plan_pipeline``) over ``distributed/pipeline``'s
schedules, one process a pp rank. Every dispatched step pulses
``distributed/elastic.notify_step``.

Monitor gauges: ``executor/{step_wall_ms,host_overhead_ms,
inflight_depth}``, counters ``executor/scan_megasteps``,
``executor/retire_waits`` (host waits on a step's event) and
``executor.step_anomalies`` (a sync's mean step time out of family
against the rolling median of ``core/slo.RollingMedianDetector``),
histograms ``executor/step_ms`` and ``executor/host_ms``.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core import monitor as _monitor
from ..core import trace as _trace
from ..core.slo import RollingMedianDetector

__all__ = ["PipelineRunner", "FetchHandle", "PipelineStepError",
           "InflightDriver", "StagedPipelineRunner", "FLOW_NS"]

# Flow-id namespace: each runner or driver takes a disjoint block so step
# flows of two users in one process cannot alias in the Chrome trace.
# The step index rides in the low 40 bits; bit 41 marks prefetch ->
# dispatch flows.
FLOW_NS = itertools.count(1)

# Rolling-median straggler detector over the per-sync mean step time,
# shared by every runner in the process (the counter it feeds is
# process-wide too); min_samples keeps warm-up syncs training the
# baseline instead of paging on it.
_step_anomalies = RollingMedianDetector(window=32, k=3.0, min_samples=8)



def _notify_step(step):
    from ..distributed.elastic import notify_step
    notify_step(step)


class PipelineStepError(RuntimeError):
    """An in-flight step failed; raised at the materialization that first
    observed it, naming the failing step index (a scan megastep names its
    first and last step). Making one writes a flight-recorder dump
    (``PADDLE_TPU_DUMP_DIR``; nothing when unset) and fires the
    recorder's emergency hooks (the checkpoint tier's save)."""

    def __init__(self, step_index, original, last_index=None):
        self.step_index = step_index
        self.last_index = last_index if last_index is not None \
            else step_index
        which = (f"step {step_index}" if self.last_index == step_index
                 else f"scan-fused steps {step_index}..{self.last_index}")
        super().__init__(f"pipelined {which} failed: "
                         f"{type(original).__name__}: {original}")
        self.original = original
        from ..core import flight_recorder as _fr
        _fr.dump("pipeline_step_error", original,
                 extra={"step_index": step_index,
                        "last_index": self.last_index})


def _host(t):
    """numpy of a fetch (bf16 widened to f32, which numpy lacks)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class FetchHandle:
    """Lazy fetch of one step output; ``np.asarray(handle)`` waits for
    the step (in order, through its runner's window) and copies it to the
    host. ``row``: the handle's row of a megastep's stacked fetch."""

    __slots__ = ("_value", "_index", "_runner", "_row")

    def __init__(self, value, step_index, runner=None, row=None):
        self._value = value
        self._index = step_index
        self._runner = runner
        self._row = row

    @property
    def step_index(self):
        return self._index

    def numpy(self):
        runner = self._runner
        sp = _trace.begin("pipeline/materialize", step=self._index,
                          parent=None if runner is None
                          else runner._trace_ctx)
        if runner is not None:
            sp.flow(runner._flow_base + self._index, "f")
        try:
            if runner is not None:
                runner._verify_through(self._index)
            if self._value is None:  # dispatch was skipped: pipeline broken
                raise PipelineStepError(
                    self._index,
                    RuntimeError("step was never dispatched (an earlier "
                                 "in-flight step already failed)"))
            try:
                arr = _host(self._value)
            except RuntimeError as e:   # a device fault of this step
                raise PipelineStepError(self._index, e) from e
        except BaseException as e:
            sp.attrs["error"] = type(e).__name__
            raise
        finally:
            _trace.end(sp)
        if self._row is not None:
            arr = np.asarray(arr[self._row])
        from ..core import flags as _flags
        if _flags.flag("FLAGS_check_nan_inf"):
            from ..core.numeric_check import sweep
            sweep({"fetch": arr}, f"pipelined step {self._index}")
        return arr

    def block_until_ready(self):
        self.numpy()
        return self

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __float__(self):
        return float(self.numpy())

    def __repr__(self):
        return f"FetchHandle(step={self._index}, row={self._row})"


class _Inflight:
    __slots__ = ("first", "last", "event")

    def __init__(self, first, last, event):
        self.first = first
        self.last = last
        self.event = event


def _step_event(tensors, device=None):
    """A CUDA event recorded after the step's work (on ``device``'s or
    the first CUDA tensor's current stream), or None on the CPU. A
    host-side step (a PS pull, distributed/ps/embedding.py) hands in a
    fetch with its own ``synchronize``, which is its event."""
    for f in tensors:
        if not isinstance(f, torch.Tensor) and hasattr(f, "synchronize"):
            return f
    if device is None:
        for f in tensors:
            if isinstance(f, torch.Tensor) and f.is_cuda:
                device = f.device
                break
    if device is None or device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class _InflightWindow:
    """The in-flight window shared by PipelineRunner and InflightDriver:
    bounded retire, in-order verification, the first failure recorded.
    Subclasses provide ``_window``, ``_failure``, ``_flow_base``,
    ``_trace_ctx`` and ``_retire_span``."""

    _retire_span = "pipeline/retire"

    def _record_failure(self, first, last, exc):
        if self._failure is None:
            self._failure = (first, last, exc)

    def _wait(self, e, **attrs):
        """Wait for one entry's event; a failure is recorded, not raised."""
        sp = _trace.begin(self._retire_span, step_first=e.first,
                          step_last=e.last, parent=self._trace_ctx, **attrs)
        for i in range(e.first, e.last + 1):
            sp.flow(self._flow_base + i, "t")
        try:
            if e.event is not None:
                _monitor.stat_add("executor/retire_waits")
                e.event.synchronize()
        except RuntimeError as exc:   # a device fault surfaces here
            sp.attrs["error"] = type(exc).__name__
            self._record_failure(e.first, e.last, exc)
        finally:
            _trace.end(sp)

    def _retire_over(self, depth):
        """Bound the window: wait, in submission order, on the oldest
        steps past ``depth``."""
        while len(self._window) > depth:
            self._wait(self._window.popleft())

    def _verify_through(self, index):
        """Materialization boundary: wait, in order, for every in-flight
        step up to ``index``; raise the first failure at or before it
        (steps before it still materialize)."""
        while self._window and self._window[0].first <= index:
            self._wait(self._window.popleft(), boundary=True)
        if self._failure is not None and self._failure[0] <= index:
            first, last, exc = self._failure
            raise PipelineStepError(first, exc, last)


class InflightDriver(_InflightWindow):
    """Dispatch asynchronous device steps through a bounded window:

    - ``submit(thunk)``: the thunk enqueues a step and returns (carry,
      fetches); the carry comes back as is (tensors the next submit
      consumes), each fetch as a lazy ``FetchHandle``;
    - the window is bounded at ``max_inflight`` by waiting on the oldest
      step's event (a device wait, not host work);
    - a failed step surfaces as ``PipelineStepError`` at the next
      materialization.

    Spans: ``{name}/dispatch`` per submit, ``{name}/retire_wait`` per
    wait on a step."""

    def __init__(self, name="driver", max_inflight=None):
        from ..core import flags as _flags
        self._name = name
        self._retire_span = f"{name}/retire_wait"
        if max_inflight is None:
            max_inflight = _flags.flag("FLAGS_executor_max_inflight")
        self._max_inflight = max(1, int(max_inflight))
        self._window: deque = deque()
        self._next_index = 0
        self._failure = None          # (first index, last index, exception)
        self._depth_peak = 0
        self._flow_base = next(FLOW_NS) << 42
        self._trace_ctx = _trace.current() or (_trace.new_trace_id(), None)

    @property
    def inflight_depth_peak(self):
        return self._depth_peak

    def submit(self, thunk, **attrs):
        """Dispatch thunk() -> (carry, fetches). Returns (carry, handles);
        carry is None when the dispatch itself failed (the failure
        surfaces at the handles' materialization)."""
        idx = self._next_index
        self._next_index += 1
        if self._failure is not None:
            return None, [FetchHandle(None, idx, self)]
        sp = _trace.begin(f"{self._name}/dispatch", parent=self._trace_ctx,
                          step=idx, **attrs)
        sp.flow(self._flow_base + idx, "s")
        try:
            carry, fetches = thunk()
        except Exception as exc:  # noqa: BLE001 — surfaced at the handle
            sp.attrs["error"] = type(exc).__name__
            self._record_failure(idx, idx, exc)
            return None, [FetchHandle(None, idx, self)]
        finally:
            _trace.end(sp)
        if not isinstance(fetches, (tuple, list)):
            fetches = [fetches]
        self._window.append(_Inflight(idx, idx, _step_event(fetches)))
        self._retire_over(self._max_inflight)
        self._depth_peak = max(self._depth_peak, len(self._window))
        return carry, [FetchHandle(f, idx, self) for f in fetches]

    def sync(self):
        """Materialize all in-flight work; raises PipelineStepError naming
        the first failed step, if any."""
        self._verify_through(self._next_index)


class StagedPipelineRunner(InflightDriver):
    """Executes a planned pipeline partition (``static/spmd_planner.
    plan_pipeline`` -> ``PipelinePlan``), paddle_tpu/static/
    pipeline_runner.py:317. The plan's global stages become per-rank
    chunks (global stage g is chunk g // n on pp index g % n, the
    interleaved convention); each step runs the plan's ``num_micro``
    micro-batches through ``distributed/pipeline.pipeline_loss`` ("1f1b"
    for v = 1, "interleaved" for v > 1) over the plan's pp axis, and
    steps dispatch through the inherited bounded in-flight window.

    The model comes as homogeneous units (hidden -> hidden), one per plan
    segment (``plan.n_segments``): ``unit_apply(h, unit_params) -> h``
    and a list of per-unit parameter pytrees. The port runs one process
    a rank, so each rank keeps only its own chunks' units and runs only
    them: no padding slots (the JAX package pads the shallower stages so
    every device traces one program). With a ``dp`` axis in the mesh
    each micro-batch is split over dp, the loss is the dp mean and the
    gradients are averaged over dp before the update.

    Training is SGD (``learning_rate``); ``step(x, y)`` returns a lazy
    loss ``FetchHandle``, ``unit_params()`` gathers the live parameters
    of every segment in plan order, ``sync()`` materializes all
    in-flight steps."""

    def __init__(self, plan, unit_apply, unit_params, loss_fn, mesh=None,
                 learning_rate=0.1, dp_axis="dp", max_inflight=None):
        super().__init__(name="pipeline/staged",
                         max_inflight=max_inflight)
        import torch.utils._pytree as pytree

        from ..distributed import mesh as mesh_mod
        if mesh is None:
            mesh = mesh_mod.get_mesh()
        if mesh is None or plan.axis not in mesh.axis_names:
            have = None if mesh is None else tuple(mesh.axis_names)
            raise ValueError(
                "StagedPipelineRunner needs a mesh with the plan's "
                f"'{plan.axis}' axis (got axes {have}) — a leaked "
                "default mesh does not qualify")
        n, v = plan.num_stages, plan.num_virtual
        if int(mesh.shape[plan.axis]) != n:
            raise ValueError(
                f"the mesh's '{plan.axis}' axis has "
                f"{mesh.shape[plan.axis]} ranks, the plan {n} stages")
        if len(unit_params) != plan.n_segments:
            raise ValueError(
                f"plan has {plan.n_segments} segments but "
                f"{len(unit_params)} unit param pytrees were given")
        self._plan = plan
        self._mesh = mesh
        self._lr = float(learning_rate)
        self._M = plan.num_micro
        self._axis = plan.axis
        self._dp = dp_axis if (dp_axis in mesh.axis_names
                               and int(mesh.shape[dp_axis]) > 1) else None
        self._unit_apply = unit_apply
        self._loss_fn = loss_fn
        self._rank = mesh.axis_index(plan.axis)
        self._seg_owner = {}
        self._chunks = []   # per chunk c: [(segment, params pytree)]
        device = None
        for g, seg_list in enumerate(plan.stage_segments()):
            for seg in seg_list:
                self._seg_owner[seg] = g % n
        for c in range(v):
            g = c * n + self._rank
            units = []
            for seg in plan.stage_segments()[g]:
                tree = pytree.tree_map(
                    lambda a: _param_leaf(a, device), unit_params[seg])
                units.append((seg, tree))
            self._chunks.append(units)
        self._schedule = "interleaved" if v > 1 else \
            (plan.schedule if plan.schedule in ("gpipe", "1f1b")
             else "1f1b")

    @property
    def plan(self):
        return self._plan

    def _leaves(self):
        import torch.utils._pytree as pytree
        return [leaf for units in self._chunks for _, tree in units
                for leaf in pytree.tree_leaves(tree)]

    def _chunk_fn(self, c):
        units = self._chunks[c]

        def f(h):
            for _, tree in units:
                h = self._unit_apply(h, tree)
            return h
        return f

    def _dp_part(self, xm):
        """This dp index's share of each micro-batch ([M, mb, ...])."""
        if self._dp is None:
            return xm
        k = int(self._mesh.shape[self._dp])
        part = xm.shape[1] // k
        return xm.narrow(1, self._mesh.axis_index(self._dp) * part, part)

    def _train_step(self, x, y):
        from ..distributed import mesh as mesh_mod
        from ..distributed import pipeline as pipe
        from ..distributed.collective import ReduceOp, _allreduce_raw
        xm = self._dp_part(pipe.micro_batch(_as_tensor(x), self._M))
        ym = self._dp_part(pipe.micro_batch(_as_tensor(y), self._M))
        fns = [self._chunk_fn(c) for c in range(len(self._chunks))]
        leaves = self._leaves()
        for p in leaves:
            p.grad = None
        with mesh_mod.MeshGuard(self._mesh):
            loss = pipe.pipeline_loss(
                fns if self._schedule == "interleaved" else fns[0],
                self._loss_fn, xm, ym, axis=self._axis,
                schedule=self._schedule)
            loss.backward()
            loss = loss.detach()
            if self._dp is not None:
                k = int(self._mesh.shape[self._dp])
                loss = _allreduce_raw(loss, axis=self._dp,
                                      op=ReduceOp.SUM) / k
                from ..distributed.parallel import sum_over_dp
                grads = [p.grad for p in leaves if p.grad is not None]
                sum_over_dp(grads, self._mesh)
                for g in grads:
                    g.div_(k)
        with torch.no_grad():
            for p in leaves:
                if p.grad is not None:
                    p.sub_(self._lr * p.grad)
        return None, [loss]

    def step(self, x, y):
        """Dispatch one pipelined train step over the plan's num_micro
        micro-batches of (x, y); returns a lazy loss FetchHandle."""
        from ..distributed.elastic import notify_step
        _carry, handles = self.submit(
            lambda: self._train_step(x, y),
            stages=self._plan.num_stages,
            num_virtual=self._plan.num_virtual, micro=self._M)
        notify_step()
        return handles[0]

    def unit_params(self):
        """The live parameters of every segment in plan order, gathered
        from their ranks over the pp axis (materializes in-flight work
        first)."""
        import torch.distributed as dist
        import torch.utils._pytree as pytree
        self.sync()
        mine = {seg: pytree.tree_map(lambda a: a.detach().cpu(), tree)
                for units in self._chunks for seg, tree in units}
        pg, ranks = self._mesh.group(self._axis)
        if len(ranks) > 1:
            got = [None] * len(ranks)
            dist.all_gather_object(got, mine, group=pg)
            for part in got:
                mine.update(part)
        return [mine[seg] for seg in range(self._plan.n_segments)]


def _as_tensor(a):
    if isinstance(a, torch.Tensor):
        return a.as_subclass(torch.Tensor)
    from ..device import resolve_device
    return torch.as_tensor(np.asarray(a), device=resolve_device())


def _param_leaf(a, device):
    t = _as_tensor(a).detach().clone()
    return t.requires_grad_(t.is_floating_point())


class PipelineRunner(_InflightWindow):
    """Drives a static Program's step with in-flight steps and a
    device-resident carry. Use as a context manager; ``sync()`` (or
    leaving the block) materializes all in-flight work and writes the
    Scope and the optimizer's slots back."""

    def __init__(self, executor, program, fetch_list=None, scope=None,
                 max_inflight=None, scan_steps=None, stage_plan=None):
        from ..core import flags as _flags
        from .program import global_scope
        self._exe = executor
        # a planned partition rides on the dispatch spans and the
        # executor/pipeline_stages gauge; running the planned stages is
        # StagedPipelineRunner's work
        self.stage_plan = stage_plan
        if stage_plan is not None:
            from ..core import monitor as _monitor0
            _monitor0.stat_set("executor/pipeline_stages",
                               stage_plan.num_stages
                               * stage_plan.num_virtual)
        self._program, self._data_parallel = executor._resolve(program)
        self._device = executor._device(self._program)
        self._scope = scope or global_scope()
        self._fetch_list = list(fetch_list or [])
        if max_inflight is None:
            max_inflight = _flags.flag("FLAGS_executor_max_inflight")
        self._max_inflight = max(1, int(max_inflight))
        if scan_steps is None:
            scan_steps = _flags.flag("FLAGS_executor_scan_steps")
        self._scan_steps = int(scan_steps or 0)
        self._entry = None
        self._own = None              # the Scope's tensors, read at start
        self._carry = None            # (scope values, slots or None)
        self._window: deque = deque()  # unverified _Inflight entries
        self._next_index = 0
        self._synced_through = 0      # gauges cover [synced_through, next)
        self._failure = None          # (first index, last index, exception)
        self._host_s = 0.0
        self._wall_t0 = None
        self._depth_peak = 0
        self._flow_base = next(FLOW_NS) << 42
        self._prefetch_flow = None    # set by run()'s consumer per item
        self._trace_ctx = _trace.current() or (_trace.new_trace_id(), None)

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.sync()
        else:
            try:  # the body is already failing: do not mask its exception
                self.sync()
            except Exception:
                pass
        return False

    # -- internals -----------------------------------------------------------
    def _ensure(self, feed_vals):
        if self._entry is None:
            e = self._exe._prepare(self._program, feed_vals,
                                   self._fetch_list, self._data_parallel)
            for n, v0 in e.amp_init(self._device).items():
                if not self._scope.has(n):
                    self._scope.set(n, v0)
            self._own = {n: self._scope.get(n) for n in e.read_names}
            self._entry = e
            self._carry = (dict(self._own), None)
            self._wall_t0 = time.perf_counter()
        return self._entry

    def _slots_in(self, scope_vals, prev_slots):
        """The optimizer's slots for the next step: seeded from the
        optimizer at the first, the carried ones after."""
        e = self._entry
        if e.opt is None:
            return {}
        if prev_slots is None:
            e.opt._ensure_slots({n: scope_vals[n] for n in e.opt_pnames})
            return {n: e.opt._slots[n] for n in e.opt_pnames}
        return prev_slots

    def _dead_handles(self, k=1):
        n_fetch = len(self._fetch_list)
        out = []
        for _ in range(k):
            idx = self._next_index
            self._next_index += 1
            out.append([FetchHandle(None, idx, self)
                        for _ in range(n_fetch)])
        return out

    def _feeds(self, feed):
        """A feed dict as device tensors (prefetched ones pass as they
        are)."""
        return self._exe._convert_feeds(self._program, feed, self._device)

    def _one(self, e, feed_vals, scope_vals, slots, lr, t, seed):
        fetches, new_scope, new_slots = self._exe._step(
            e, feed_vals, scope_vals, slots, lr, t, seed, self._device)
        from .executor import _unalias
        return (_unalias(fetches, self._own), {**scope_vals, **new_scope},
                {**slots, **new_slots})

    def _enqueued(self, first, last, t0):
        """Window bookkeeping after a dispatch of steps first..last."""
        self._window.append(_Inflight(first, last,
                                      _step_event((), self._device)))
        r0 = time.perf_counter()
        self._retire_over(self._max_inflight)
        r1 = time.perf_counter()  # a retire waits on the device, not host
        self._depth_peak = max(self._depth_peak, len(self._window))
        self._host_s += (r1 - t0) - (r1 - r0)
        _monitor.stat_add("executor/runs", last - first + 1)

    # -- submission ----------------------------------------------------------
    def submit(self, feed):
        """Dispatch one step (non-blocking); returns a list of
        FetchHandle, one per fetch_list entry."""
        if self._failure is not None:
            return self._dead_handles(1)[0]
        t0 = time.perf_counter()
        sp = _trace.begin("pipeline/dispatch", parent=self._trace_ctx)
        if self.stage_plan is not None:
            sp.attrs["pipeline_stages"] = self.stage_plan.num_stages \
                * self.stage_plan.num_virtual
        pf = self._prefetch_flow
        if pf is not None:        # close the prefetch -> dispatch handoff
            self._prefetch_flow = None
            sp.flow(pf, "f")
        try:
            feed_vals = self._feeds(feed)
            e = self._ensure(feed_vals)
            scope_vals, prev_slots = self._carry
            slots = self._slots_in(scope_vals, prev_slots)
            lr, t = 0.0, 0
            if e.opt is not None:
                e.opt._step_count += 1
                lr, t = e.opt.get_lr(), e.opt._step_count
            seed = self._exe._next_seed()
            idx = self._next_index
            self._next_index += 1
            sp.attrs["step"] = idx
            sp.flow(self._flow_base + idx, "s")
            try:
                fetches, new_scope, new_slots = self._one(
                    e, feed_vals, scope_vals, slots, lr, t, seed)
            except Exception as exc:
                sp.attrs["error"] = type(exc).__name__
                self._record_failure(idx, idx, exc)
                self._host_s += time.perf_counter() - t0
                return [FetchHandle(None, idx, self)
                        for _ in self._fetch_list]
        finally:
            _trace.end(sp)
        self._carry = (new_scope, new_slots)
        self._enqueued(idx, idx, t0)
        _notify_step(idx + 1)
        return [FetchHandle(f, idx, self) for f in fetches]

    def submit_scan(self, stacked_feed, k):
        """Dispatch one scan-fused megastep over ``k`` batches stacked on
        a leading axis of every feed value (one host-to-device copy).
        Returns k FetchHandle lists: rows of the stacked fetches."""
        if self._failure is not None:
            return self._dead_handles(k)
        t0 = time.perf_counter()
        sp = _trace.begin("pipeline/dispatch_scan", k=k,
                          parent=self._trace_ctx)
        pf = self._prefetch_flow
        if pf is not None:
            self._prefetch_flow = None
            sp.flow(pf, "f")
        try:
            stacked = self._feeds(stacked_feed)
            e = self._ensure({n: v[0] for n, v in stacked.items()})
            scope_vals, prev_slots = self._carry
            slots = self._slots_in(scope_vals, prev_slots)
            stream = []
            for _ in range(k):  # the exact per-step stream the serial
                lr, t = 0.0, 0  # loop would have drawn
                if e.opt is not None:
                    e.opt._step_count += 1
                    lr, t = e.opt.get_lr(), e.opt._step_count
                stream.append((lr, t, self._exe._next_seed()))
            first = self._next_index
            self._next_index += k
            last = first + k - 1
            sp.attrs["step_first"], sp.attrs["step_last"] = first, last
            for i in range(first, last + 1):
                sp.flow(self._flow_base + i, "s")
            try:
                rows = []
                for i, (lr, t, seed) in enumerate(stream):
                    fetches, scope_vals, slots = self._one(
                        e, {n: v[i] for n, v in stacked.items()},
                        scope_vals, slots, lr, t, seed)
                    rows.append(fetches)
                fetches = [torch.stack(col)
                           if all(isinstance(f, torch.Tensor) for f in col)
                           else np.stack([_host(f) for f in col])
                           for col in zip(*rows)]
            except Exception as exc:
                sp.attrs["error"] = type(exc).__name__
                self._record_failure(first, last, exc)
                self._host_s += time.perf_counter() - t0
                return [[FetchHandle(None, first + i, self)
                         for _ in self._fetch_list] for i in range(k)]
        finally:
            _trace.end(sp)
        self._carry = (scope_vals, slots)
        self._enqueued(first, last, t0)
        _monitor.stat_add("executor/scan_megasteps")
        _notify_step(last + 1)
        return [[FetchHandle(f, first + i, self, row=i) for f in fetches]
                for i in range(k)]

    # -- the driving loop ----------------------------------------------------
    def run(self, feeds):
        """Drive an iterable of feed dicts through the pipeline, yielding
        one FetchHandle list per step. The feeds are converted and copied
        to the device on a prefetch thread (pinned host memory, a
        non-blocking copy), overlapping the in-flight steps; with scan
        fusion on, groups of K shape-stable batches are stacked there."""
        scan_k = self._scan_steps if self._scan_steps > 1 else 0
        q: queue.Queue = queue.Queue(maxsize=max(2, self._max_inflight + 1))
        stop = threading.Event()
        sentinel = object()
        program, device = self._program, self._device

        def convert(feed):
            return self._exe._convert_feeds(program, feed, device, pin=True)

        def sig(feed):
            return tuple(sorted(
                (n, tuple(np.shape(v)),
                 str(getattr(v, "dtype", None) or np.asarray(v).dtype))
                for n, v in feed.items()))

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        parent_ctx = self._trace_ctx
        flow_seq = itertools.count()

        def convert_traced(feed, stacked=False, k=1):
            fid = self._flow_base | (1 << 41) | next(flow_seq)
            with _trace.span("pipeline/prefetch", stacked=stacked,
                             k=k) as psp:
                psp.flow(fid, "s")
                return convert(feed), fid

        def produce():
            buf, cur_sig = [], None
            for feed in feeds:
                if stop.is_set():
                    return
                if not scan_k:
                    if not put(("one",) + convert_traced(feed)):
                        return
                    continue
                s = sig(feed)
                if buf and s != cur_sig:  # a shape break: no fusion
                    for f in buf:
                        if not put(("one",) + convert_traced(f)):
                            return
                    buf = []
                buf.append(feed)
                cur_sig = s
                if len(buf) == scan_k:
                    stacked = {n: np.stack([np.asarray(f[n]) for f in buf])
                               for n in buf[0]}
                    vals, fid = convert_traced(stacked, True, scan_k)
                    if not put(("scan", vals, scan_k, fid)):
                        return
                    buf = []
            for f in buf:  # a remainder of fewer than K runs unfused
                if not put(("one",) + convert_traced(f)):
                    return

        def producer():
            try:
                with _trace.attach(parent_ctx):
                    produce()
            except BaseException as e:  # surfaced on the consumer side
                put(("error", e))
            finally:
                put(sentinel)

        th = threading.Thread(target=producer, daemon=True,
                              name="pipeline-prefetch")
        th.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if item[0] == "error":
                    raise item[1]
                if item[0] == "one":
                    self._prefetch_flow = item[2]
                    yield self.submit(item[1])
                else:
                    self._prefetch_flow = item[3]
                    for handles in self.submit_scan(item[1], item[2]):
                        yield handles
        finally:
            stop.set()
            try:  # unblock a producer stuck on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            th.join(timeout=5)

    # -- materialization / write-back ---------------------------------------
    def sync(self):
        """Materialize all in-flight work, write the carry back into the
        Scope and the optimizer's slots, and publish the gauges. Raises
        PipelineStepError (naming the failing step) if a step failed;
        then nothing is written back."""
        from ..core import flags as _flags
        if self._entry is None:
            return
        with _trace.span("pipeline/sync", parent=self._trace_ctx,
                         step_first=self._synced_through,
                         step_last=self._next_index - 1):
            self._verify_through(self._next_index)
            new_scope, new_slots = self._carry
            try:
                if self._device.type == "cuda":
                    torch.cuda.current_stream(self._device).synchronize()
            except RuntimeError as exc:
                last = max(self._next_index - 1, 0)
                self._record_failure(last, last, exc)
                first, last, e = self._failure
                raise PipelineStepError(first, e, last)
        if _flags.flag("FLAGS_check_nan_inf"):
            # the serial loop sweeps every step; the runner sweeps the
            # carry at every sync (fetch handles sweep themselves), and
            # before the write-back, so a nan leaves the Scope at its
            # last good state
            from ..core.numeric_check import sweep
            sweep({"scope": new_scope},
                  f"PipelineRunner.sync (steps {self._synced_through}.."
                  f"{self._next_index - 1})")
        from .executor import write_back
        write_back(self._scope, self._own, new_scope)
        e = self._entry
        if e.opt is not None and new_slots:
            e.opt._slots.update(new_slots)
        self._own = {n: self._scope.get(n) for n in e.read_names}
        self._carry = (dict(self._own), new_slots)
        # the gauges cover the interval since the last sync, then reset
        steps = self._next_index - self._synced_through
        if steps > 0:
            wall_ms = ((time.perf_counter() - self._wall_t0) * 1000.0
                       if self._wall_t0 is not None else 0.0)
            _monitor.stat_set_many({
                "executor/step_wall_ms": wall_ms / steps,
                "executor/host_overhead_ms": self._host_s * 1000.0 / steps,
                "executor/inflight_depth": self._depth_peak,
            })
            _monitor.observe("executor/step_ms", wall_ms / steps)
            _monitor.observe("executor/host_ms",
                             self._host_s * 1000.0 / steps)
            if _step_anomalies.observe(wall_ms / steps):
                _monitor.stat_add("executor.step_anomalies")
        self._synced_through = self._next_index
        self._host_s = 0.0
        self._wall_t0 = time.perf_counter()

    close = sync
