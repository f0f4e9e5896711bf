"""In-process span tracer — the subset of paddle_tpu/core/trace.py the
serving slice emits (``serve/*`` and ``serve/dispatch`` spans).

A span is a named interval with ids, a parent link, attributes and flow
events (``span.flow(fid, "s"|"t"|"f")`` threads one request through the
spans that touch it). Finished spans go to a bounded ring read with
``recent()``. There is no Chrome-trace export yet.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque

__all__ = ["Span", "span", "begin", "end", "instant", "current",
           "new_trace_id", "recent", "reset"]

_lock = threading.Lock()
_ids = itertools.count(1)
_tls = threading.local()
_ring: deque = deque(maxlen=4096)


def new_trace_id() -> str:
    return f"{os.getpid():x}-{next(_ids):x}"


class Span:
    """One named interval, created by begin()/span()."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "thread", "attrs", "flows")

    def __init__(self, name, trace_id, parent_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = f"{os.getpid():x}.{next(_ids):x}"
        self.parent_id = parent_id
        self.attrs = dict(attrs)
        self.flows = None          # [(flow_id, phase)], lazily allocated
        self.thread = threading.current_thread().name
        self.t0 = time.perf_counter()
        self.t1 = None

    def flow(self, flow_id: int, phase: str):
        """Bind a flow event: 's' starts an arrow, 't' continues it, 'f'
        ends it."""
        if self.flows is None:
            self.flows = []
        self.flows.append((int(flow_id), phase))
        return self

    @property
    def context(self):
        return (self.trace_id, self.span_id)

    def __repr__(self):
        return f"Span({self.name!r}, id={self.span_id})"


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current():
    """Ambient (trace_id, span_id) of the calling thread, or None."""
    st = _stack()
    return st[-1].context if st else None


def begin(name: str, parent=None, **attrs) -> Span:
    """Open a span and push it as the thread's ambient parent. ``parent``
    may be a Span or a (trace_id, span_id) context. Pair with end()."""
    if parent is None:
        parent = current() or (new_trace_id(), None)
    elif isinstance(parent, Span):
        parent = parent.context
    sp = Span(name, parent[0], parent[1], attrs)
    _stack().append(sp)
    return sp


def end(sp: Span, discard: bool = False):
    """Close a span and record it (``discard``: close it unrecorded). A
    second end is a no-op."""
    if sp is None or sp.t1 is not None:
        return
    sp.t1 = time.perf_counter()
    st = _stack()
    if sp in st:
        st.remove(sp)
    if discard:
        return
    with _lock:
        _ring.append(sp)


@contextlib.contextmanager
def span(name: str, parent=None, **attrs):
    """Scoped span; an exception is recorded in its attrs and re-raised."""
    sp = begin(name, parent=parent, **attrs)
    try:
        yield sp
    except BaseException as e:
        sp.attrs.setdefault("error", type(e).__name__)
        raise
    finally:
        end(sp)


def instant(name: str, **attrs) -> Span:
    """Zero-duration marker span."""
    sp = begin(name, **attrs)
    end(sp)
    return sp


def recent(n: int = None):
    """Most recent finished spans, newest last."""
    with _lock:
        out = list(_ring)
    return out if n is None else out[-n:]


def reset():
    with _lock:
        _ring.clear()
