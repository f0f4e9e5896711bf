"""Host and device profiler (paddle_tpu/profiler/__init__.py).

- ``RecordEvent``: a scoped host annotation over a ``core/trace`` span
  (reference platform/profiler.h:127). A no-op while the profiler is off.
- ``start_profiler`` / ``stop_profiler`` / ``profiler()``: the host event
  table, its ``summary`` and ``export_chrome_trace`` (reference
  python/paddle/fluid/profiler.py). While the profiler is on, every
  finished ``core/trace`` span lands in the table too (the sink installed
  below), and every eager op records an ``op/<name>`` event
  (``ops/_dispatch.defop``).
- Device capture: ``start_xplane`` / ``stop_xplane`` / ``xplane_trace``
  keep the JAX package's names (XLA's xplane there). Here they run
  ``torch.profiler`` with CPU and, where there is a card, CUDA activity,
  and write its Chrome trace into ``log_dir``; the kernel events name the
  hand-written kernels (``flash_fwd_sm90_kernel`` ...).
- ``cost_analysis(fn, *args)``: ``{"flops", "bytes accessed"}`` of one
  call, from the port's counter (``core/flop_count.py``), where the JAX
  package reads XLA's cost analysis of the compiled function.

The port runs eagerly, so a ``Model.fit`` step's ``op/*`` events repeat
every step; the JAX package's step is one jitted program whose ``op/*``
events appear once, when it is traced. The ``hapi/train_step`` events
agree one for one.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import Optional

from ..core import trace as _trace

__all__ = ["RecordEvent", "profiler", "start_profiler", "stop_profiler",
           "reset_profiler", "summary", "events", "export_chrome_trace",
           "xplane_trace", "start_xplane", "step_xplane", "stop_xplane",
           "cost_analysis",
           "is_profiler_enabled"]

_lock = threading.Lock()
_events: list = []          # (name, t0, t1, tid)
_enabled = False
_t_origin = _trace._t_origin  # shared clock origin with the span tracer


def is_profiler_enabled() -> bool:
    return _enabled


def _trace_sink(sp):
    """Installed into core/trace: while the host profiler is enabled,
    every finished span (a RecordEvent or a ``trace.span`` site such as
    ``hapi/train_step``) also lands in the event table."""
    if _enabled:
        with _lock:
            _events.append((sp.name, sp.t0, sp.t1, sp.tid))


_trace.add_sink(_trace_sink)


class RecordEvent:
    """Scoped host annotation over a detached core/trace span: a context
    manager or explicit begin()/end(). A no-op while the profiler is off;
    use ``core.trace.span`` for always-on sites."""

    __slots__ = ("name", "_span")

    def __init__(self, name: str):
        self.name = name
        self._span = None

    def begin(self):
        if _enabled:
            # detached: a caller that skips end() on an exception loses
            # one sample instead of parenting every later span under it
            self._span = _trace.begin(self.name, _attach=False)
        return self

    def end(self):
        if self._span is not None:
            _trace.end(self._span)  # the sink mirrors it into _events
            self._span = None

    __enter__ = begin

    def __exit__(self, *exc):
        self.end()
        return False


def _set_enabled(on: bool):
    global _enabled
    from ..core import flags as _flags
    from ..ops import _dispatch
    _flags.set_flags({"FLAGS_enable_profiler": on})
    _enabled = on
    _dispatch._profiling = on     # the op layer's one boolean read


def start_profiler(state: str = "All", tracer_option: str = "Default"):
    """reference fluid/profiler.py start_profiler. ``state`` and
    ``tracer_option`` are kept for parity: host events are always
    captured; ``xplane_trace`` captures the device."""
    _set_enabled(True)


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None):
    """Stop; optionally print the summary table and write a Chrome
    trace."""
    _set_enabled(False)
    if profile_path:
        export_chrome_trace(profile_path)
    if sorted_key is not None:
        print(summary(sorted_key=sorted_key))


def reset_profiler():
    with _lock:
        _events.clear()


def events():
    with _lock:
        return list(_events)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None):
    """reference fluid/profiler.py profiler() context manager."""
    reset_profiler()
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key=sorted_key, profile_path=profile_path)


def summary(sorted_key: str = "total") -> str:
    """The aggregate event table (reference profiler summary)."""
    agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])  # n, tot, mn, mx
    for name, t0, t1, _tid in events():
        dt = (t1 - t0) * 1e3
        a = agg[name]
        a[0] += 1
        a[1] += dt
        a[2] = min(a[2], dt)
        a[3] = max(a[3], dt)
    if not agg:
        return "(no profiler events)"
    total_all = sum(a[1] for a in agg.values())
    keyfn = {"total": lambda kv: kv[1][1], "calls": lambda kv: kv[1][0],
             "max": lambda kv: kv[1][3], "min": lambda kv: kv[1][2],
             "ave": lambda kv: kv[1][1] / kv[1][0]}.get(
                 sorted_key, lambda kv: kv[1][1])
    rows = sorted(agg.items(), key=keyfn, reverse=True)
    w = max(len(n) for n in agg) + 2
    out = [f"{'Event':<{w}}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>10}"
           f"{'Min(ms)':>10}{'Max(ms)':>10}{'Ratio':>8}"]
    for name, (n, tot, mn, mx) in rows:
        ratio = tot / total_all if total_all else 0.0
        out.append(f"{name:<{w}}{n:>8}{tot:>12.3f}{tot / n:>10.3f}"
                   f"{mn:>10.3f}{mx:>10.3f}{ratio:>8.2%}")
    return "\n".join(out)


def export_chrome_trace(path: str):
    """The host events as chrome://tracing JSON."""
    trace = [{"name": name, "ph": "X", "pid": 0, "tid": tid,
              "ts": (t0 - _t_origin) * 1e6, "dur": (t1 - t0) * 1e6}
             for name, t0, t1, tid in events()]
    with open(path, "w") as f:
        json.dump({"traceEvents": trace}, f)


# -- device capture (torch.profiler; view in chrome://tracing / Perfetto) --

_device = {"prof": None, "dir": None, "warming": False}
_MARGIN_S = 0.05     # host seconds before a device trace stops


def start_xplane(log_dir: str, warmup: bool = False):
    """Start a torch.profiler capture (CPU, and CUDA where a card is
    present) whose Chrome trace ``stop_xplane`` writes into ``log_dir``.

    With ``warmup`` the capture starts but keeps nothing until
    ``step_xplane()``: torch.profiler's warm-up step. In a process that
    has traced before, the first device records of a new trace can be
    lost (an H100 read: its first 82 kernels, 57 ms); a warm-up step
    before the window takes that loss instead of the window.
    ``ProfilerCallback`` warms up over the step before its window."""
    import torch
    if _device["prof"] is not None:
        raise RuntimeError("a device trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    sched = (torch.profiler.schedule(wait=0, warmup=1, active=1 << 30)
             if warmup else None)
    prof = torch.profiler.profile(activities=acts, schedule=sched)
    prof.__enter__()
    os.makedirs(log_dir, exist_ok=True)
    _device.update(prof=prof, dir=log_dir, warming=warmup)


def step_xplane():
    """End the warm-up of ``start_xplane(..., warmup=True)``: the trace
    keeps what runs from here on."""
    import torch
    if not _device["warming"]:
        raise RuntimeError("no device trace is warming up")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    _device["prof"].step()
    _device["warming"] = False


def stop_xplane():
    """Stop the capture; write ``trace_<pid>_<ns>.json`` into its
    ``log_dir`` and return the path (None if it was still warming up)."""
    import torch
    prof = _device["prof"]
    if prof is None:
        return None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(_MARGIN_S)
    prof.__exit__(None, None, None)
    path = None
    if not _device["warming"]:     # a warm-up alone has kept nothing
        path = os.path.join(_device["dir"],
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
    _device.update(prof=None, dir=None, warming=False)
    return path


@contextlib.contextmanager
def xplane_trace(log_dir: str):
    """Capture a device trace of the block into ``log_dir``."""
    start_xplane(log_dir)
    try:
        yield
    finally:
        stop_xplane()


# -- achieved-FLOPs accounting ---------------------------------------------

def cost_analysis(fn, *args, **kwargs):
    """``{"flops", "bytes accessed"}`` of one call of ``fn`` on the
    example arguments, from ``core/flop_count.py``'s counter (its rules
    are stated there). The JAX package reads XLA's cost analysis of the
    compiled function instead."""
    from ..core import flop_count
    with flop_count.FlopCounter() as c:
        fn(*args, **kwargs)
    return {"flops": float(c.flops), "bytes accessed": float(c.bytes),
            "flops matmul": float(c.matmul_flops)}
