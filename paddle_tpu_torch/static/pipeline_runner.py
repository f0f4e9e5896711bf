"""Bounded in-flight window for a driver of asynchronous device steps
(paddle_tpu/static/pipeline_runner.py ``InflightDriver``, ``FetchHandle``,
``PipelineStepError``).

PyTorch's CUDA stream is already asynchronous: a thunk enqueues its
kernels and returns. ``InflightDriver.submit`` records a CUDA event after
each step and keeps at most ``max_inflight`` steps outstanding, waiting
on the oldest step's event when the window is full. A step's fetches
come back as lazy ``FetchHandle``s that copy to the host only when read.
A failure inside an in-flight step is recorded and surfaces at the next
materialization as ``PipelineStepError`` naming the step; steps before
it still materialize. On the CPU every step is already complete when its
thunk returns, so the window only orders failures.
"""
from __future__ import annotations

import itertools
from collections import deque

import torch

from ..core import trace as _trace

__all__ = ["InflightDriver", "FetchHandle", "PipelineStepError", "FLOW_NS"]

# Flow-id namespace: each driver or loop takes a disjoint block so flows
# of two users in one process cannot alias.
FLOW_NS = itertools.count(1)


class PipelineStepError(RuntimeError):
    """An in-flight step failed; raised at the materialization that first
    observed it, naming the failing step index."""

    def __init__(self, step_index, original):
        self.step_index = step_index
        self.original = original
        super().__init__(f"pipelined step {step_index} failed: "
                         f"{type(original).__name__}: {original}")


class FetchHandle:
    """Lazy fetch of one step output; ``np.asarray(handle)`` waits for
    the step and copies the tensor to the host."""

    __slots__ = ("_value", "_index", "_driver")

    def __init__(self, value, step_index, driver):
        self._value = value
        self._index = step_index
        self._driver = driver

    def numpy(self):
        sp = _trace.begin("pipeline/materialize", step=self._index,
                          parent=self._driver._trace_ctx)
        sp.flow(self._driver._flow_base + self._index, "f")
        try:
            self._driver._verify_through(self._index)
            if self._value is None:  # dispatch was skipped: pipeline broken
                raise PipelineStepError(
                    self._index,
                    RuntimeError("step was never dispatched (an earlier "
                                 "in-flight step already failed)"))
            try:
                return self._value.cpu().numpy()
            except RuntimeError as e:   # a device fault of this step
                raise PipelineStepError(self._index, e) from e
        except BaseException as e:
            sp.attrs["error"] = type(e).__name__
            raise
        finally:
            _trace.end(sp)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return f"FetchHandle(step={self._index})"


class _Inflight:
    __slots__ = ("index", "event")

    def __init__(self, index, event):
        self.index = index
        self.event = event


def _step_event(fetches):
    """A CUDA event recorded after the step's work, or None on the CPU."""
    for f in fetches:
        if isinstance(f, torch.Tensor) and f.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(f.device))
            return ev
    return None


class InflightDriver:
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
        if max_inflight is None:
            max_inflight = _flags.flag("FLAGS_executor_max_inflight")
        self._max_inflight = max(1, int(max_inflight))
        self._window: deque = deque()
        self._next_index = 0
        self._failure = None          # (step index, exception)
        self._flow_base = next(FLOW_NS) << 42
        self._trace_ctx = _trace.current() or (_trace.new_trace_id(), None)

    def _record_failure(self, index, exc):
        if self._failure is None:
            self._failure = (index, exc)

    def _wait(self, entry, **attrs):
        """Wait for one step; a failure is recorded, not raised."""
        sp = _trace.begin(f"{self._name}/retire_wait", step=entry.index,
                          parent=self._trace_ctx, **attrs)
        sp.flow(self._flow_base + entry.index, "t")
        try:
            if entry.event is not None:
                entry.event.synchronize()
        except RuntimeError as exc:   # a device fault surfaces here
            sp.attrs["error"] = type(exc).__name__
            self._record_failure(entry.index, exc)
        finally:
            _trace.end(sp)

    def _retire_over(self, depth):
        while len(self._window) > depth:
            self._wait(self._window.popleft())

    def _verify_through(self, index):
        """Wait, in order, for every in-flight step up to ``index``; raise
        the first failure at or before it."""
        while self._window and self._window[0].index <= index:
            self._wait(self._window.popleft(), boundary=True)
        if self._failure is not None and self._failure[0] <= index:
            raise PipelineStepError(*self._failure)

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
            self._record_failure(idx, exc)
            return None, [FetchHandle(None, idx, self)]
        finally:
            _trace.end(sp)
        if not isinstance(fetches, (tuple, list)):
            fetches = [fetches]
        self._window.append(_Inflight(idx, _step_event(fetches)))
        self._retire_over(self._max_inflight)
        return carry, [FetchHandle(f, idx, self) for f in fetches]
