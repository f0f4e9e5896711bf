"""Cross-layer span tracer (paddle_tpu/core/trace.py, whole).

- **Spans**: named intervals with ids, parent links, attributes and the
  owning thread. ``span("serve/decode_step", step=3)`` nests under the
  ambient span of the current thread; ``attach(ctx)`` re-homes a worker
  thread under a context captured elsewhere.
- **Flow events**: ``span.flow(fid, "s"|"t"|"f")`` threads one logical
  object (a request, a pipeline step) through the spans that touch it,
  so the Chrome trace draws arrows across threads.
- **Two sinks**: a bounded always-on ring of finished spans
  (``FLAGS_trace_ring_size``, read with ``recent()``), and a full capture
  buffer while ``start()``-ed, exported with ``export_chrome_trace``
  (chrome://tracing, Perfetto). ``add_sink`` registers more.

A span costs two ``perf_counter`` calls and a deque append, so it stays
on at step granularity. While the host profiler is enabled, every
finished span is also mirrored into ``profiler``'s event table (the sink
that ``profiler/__init__.py`` adds at import), so
``profiler.summary()`` covers every span site.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque

from . import flags as _flags

__all__ = ["Span", "span", "begin", "end", "instant", "attach", "current",
           "new_trace_id", "start", "stop", "enabled", "get_spans",
           "recent", "reset", "set_ring_size", "export_chrome_trace",
           "to_chrome_events", "span_dict"]

_lock = threading.Lock()
_ids = itertools.count(1)
_enabled = False
_buffer: list = []                 # full capture while start()ed
_t_origin = time.perf_counter()
_tls = threading.local()

# Additional finished-span sinks (e.g. core/telemetry.py's shipper
# buffering spans for the hub). Called OUTSIDE _lock on the thread that
# finished the span — sinks must be non-blocking and never raise.
_sinks: list = []


def add_sink(fn):
    """Register fn(span) to be called for every finished span."""
    with _lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn):
    with _lock:
        try:
            _sinks.remove(fn)
        except ValueError:
            pass


def _ring_size():
    try:
        return max(0, int(_flags.flag("FLAGS_trace_ring_size")))
    except KeyError:  # flags not loaded yet
        return 4096


_ring: deque = deque(maxlen=_ring_size() or None)


def set_ring_size(n: int):
    """Re-bound the always-on ring (flight-recorder depth). Existing
    entries are kept up to the new bound."""
    global _ring
    with _lock:
        _ring = deque(_ring, maxlen=max(0, int(n)) or None)


def _sync_ring_size():
    """Pick up a runtime FLAGS_trace_ring_size change. The flag is read
    at import to size the ring; re-reading on every append would tax the
    hot path, so set_flags takes effect at the next start()/reset()
    boundary (or immediately via set_ring_size())."""
    n = _ring_size() or None
    if _ring.maxlen != n:
        set_ring_size(n or 0)


def new_trace_id() -> str:
    """Process-unique trace id; the pid prefix keeps ids distinct across
    the PS server/worker processes whose spans later merge in one dump."""
    return f"{os.getpid():x}-{next(_ids):x}"


def _new_span_id() -> str:
    return f"{os.getpid():x}.{next(_ids):x}"


class Span:
    """One named interval. Created via begin()/span(); finished spans are
    immutable records in the ring (and the capture buffer while tracing).
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "tid", "thread", "attrs", "flows")

    def __init__(self, name, trace_id, parent_id, attrs):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.flows = None          # [(flow_id, phase)], lazily allocated
        th = threading.current_thread()
        self.tid = th.ident
        self.thread = th.name
        self.t0 = time.perf_counter()
        self.t1 = None

    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    def flow(self, flow_id: int, phase: str):
        """Bind a flow event to this span: phase 's' starts an arrow,
        't' continues it, 'f' terminates it (Chrome flow semantics)."""
        if self.flows is None:
            self.flows = []
        self.flows.append((int(flow_id), phase))
        return self

    @property
    def context(self):
        return (self.trace_id, self.span_id)

    @property
    def duration_ms(self):
        return ((self.t1 or time.perf_counter()) - self.t0) * 1e3

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id})")


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current():
    """Ambient (trace_id, span_id) of the calling thread, or None."""
    st = _stack()
    if not st:
        return None
    top = st[-1]
    return top.context if isinstance(top, Span) else top


def _resolve_parent(parent):
    if parent is None:
        ctx = current()
        if ctx is not None:
            return ctx
        return (new_trace_id(), None)
    if isinstance(parent, Span):
        return parent.context
    # remote context off the wire: (trace_id, span_id) tuple/list
    try:
        trace_id, span_id = parent
        return (str(trace_id), None if span_id is None else str(span_id))
    except (TypeError, ValueError):
        return (new_trace_id(), None)


def begin(name: str, parent=None, _attach=True, **attrs) -> Span:
    """Open a span (pushed as the thread's ambient parent). Pair with
    end(); prefer the `span()` context manager where control flow allows.

    `_attach=False` opens a DETACHED span: it still parents under the
    ambient span but is not pushed onto the stack — for legacy
    begin()/end() call sites (profiler.RecordEvent) whose callers may
    skip end() on exception; a missed end then loses one sample instead
    of leaving a dead span as every later span's ancestor."""
    trace_id, parent_id = _resolve_parent(parent)
    sp = Span(name, trace_id, parent_id, attrs)
    if _attach:
        _stack().append(sp)
    return sp


def end(sp: Span, discard: bool = False):
    """Close a span and record it (unless discarded). Idempotent (a
    second end is a no-op, so error paths can end eagerly and leave the
    `finally` as a backstop) and tolerant of out-of-order ends: removes
    `sp` wherever it sits on this thread's stack."""
    if sp is None or sp.t1 is not None:
        return
    sp.t1 = time.perf_counter()
    st = _stack()
    if st and st[-1] is sp:
        st.pop()
    elif sp in st:
        st.remove(sp)
    if discard:
        return
    _record(sp)


def _record(sp: Span):
    with _lock:
        _ring.append(sp)
        if _enabled:
            _buffer.append(sp)
    for fn in _sinks:
        try:
            fn(sp)
        except Exception:
            pass


@contextlib.contextmanager
def span(name: str, parent=None, **attrs):
    """Scoped span. On an exception the span records the exception type
    in its attrs and re-raises."""
    sp = begin(name, parent=parent, **attrs)
    try:
        yield sp
    except BaseException as e:
        sp.attrs.setdefault("error", type(e).__name__)
        raise
    finally:
        end(sp)


def instant(name: str, **attrs) -> Span:
    """Zero-duration marker span (rendered as an instant event)."""
    sp = begin(name, **attrs)
    end(sp)
    return sp


@contextlib.contextmanager
def attach(ctx):
    """Adopt a context captured on another thread (or shipped across a
    process boundary) as this thread's ambient parent — the prefetch
    thread and the PS server's handler threads use this so their spans
    join the originating trace. `ctx` may be None (no-op)."""
    if ctx is None:
        yield
        return
    st = _stack()
    marker = (str(ctx[0]), None if ctx[1] is None else str(ctx[1]))
    st.append(marker)
    try:
        yield
    finally:
        if st and st[-1] == marker:
            st.pop()
        elif marker in st:
            st.remove(marker)


# -- capture control ---------------------------------------------------------

def start():
    """Begin full capture (the ring keeps running regardless)."""
    global _enabled
    _sync_ring_size()
    with _lock:
        _buffer.clear()
        _enabled = True


def stop():
    global _enabled
    with _lock:
        _enabled = False
    return get_spans()


def enabled() -> bool:
    return _enabled


def get_spans():
    with _lock:
        return list(_buffer)


def recent(n: int = None):
    """Most recent finished spans from the always-on ring (flight
    recorder feed); newest last."""
    with _lock:
        out = list(_ring)
    return out if n is None else out[-n:]


def open_spans():
    """Still-open spans of the CALLING thread, outermost first. The
    flight recorder includes these in a dump: the span enclosing the
    failure (e.g. the materialize that raised PipelineStepError) hasn't
    reached the ring yet — it IS the failure's location."""
    return [s for s in _stack() if isinstance(s, Span)]


def reset():
    _sync_ring_size()
    with _lock:
        _buffer.clear()
        _ring.clear()


# -- export ------------------------------------------------------------------

def span_dict(sp: Span) -> dict:
    """JSON-able record (flight-recorder dump schema)."""
    return {
        "name": sp.name, "trace_id": sp.trace_id, "span_id": sp.span_id,
        "parent_id": sp.parent_id, "ts_us": (sp.t0 - _t_origin) * 1e6,
        "dur_us": ((sp.t1 or sp.t0) - sp.t0) * 1e6, "tid": sp.tid,
        "thread": sp.thread, "attrs": sp.attrs, "flows": sp.flows or [],
    }


def to_chrome_events(spans=None, pid=None) -> list:
    """Chrome trace events: one "X" slice per span (args carry the span
    ids + attributes; zero-duration spans render as instants), flow
    events ("s"/"t"/"f") for every span-bound flow, and thread-name
    metadata. Flow timestamps sit at the slice midpoint so Chrome binds
    them to the right slice. Accepts live Span objects OR span_dict()
    records (the flight-recorder dump form, so
    ``python -m paddle_tpu_torch.tools.obs_report DUMP --trace OUT``
    converts dumps with this same encoder); `pid` overrides the emitted
    process id (a dump's spans belong to the dumping process)."""
    spans = get_spans() if spans is None else spans
    pid = os.getpid() if pid is None else pid
    events, threads = [], {}
    for sp in spans:
        if isinstance(sp, dict):                 # span_dict record
            name, ts, dur = sp["name"], sp["ts_us"], sp["dur_us"]
            tid, thread = sp.get("tid", 0), sp.get("thread")
            trace_id, span_id = sp.get("trace_id"), sp.get("span_id")
            parent_id, attrs = sp.get("parent_id"), sp.get("attrs", {})
            flows = sp.get("flows") or ()
        else:
            t1 = sp.t1 if sp.t1 is not None else sp.t0
            ts = (sp.t0 - _t_origin) * 1e6
            dur = (t1 - sp.t0) * 1e6
            name, tid, thread = sp.name, sp.tid, sp.thread
            trace_id, span_id = sp.trace_id, sp.span_id
            parent_id, attrs = sp.parent_id, sp.attrs
            flows = sp.flows or ()
        threads.setdefault(tid, thread)
        args = {"trace_id": trace_id, "span_id": span_id}
        if parent_id:
            args["parent_id"] = parent_id
        args.update({k: v for k, v in attrs.items()
                     if isinstance(v, (str, int, float, bool))
                     or v is None})
        if dur <= 0:
            events.append({"name": name, "ph": "i", "pid": pid,
                           "tid": tid, "ts": ts, "s": "t", "args": args})
        else:
            events.append({"name": name, "ph": "X", "pid": pid,
                           "tid": tid, "ts": ts, "dur": dur,
                           "args": args})
        for fid, phase in flows:
            ev = {"name": "step-flow", "cat": "flow", "ph": phase,
                  "id": fid, "pid": pid, "tid": tid,
                  "ts": ts + max(dur / 2, 0.0)}
            if phase == "f":
                ev["bp"] = "e"
            events.append(ev)
    for tid, tname in threads.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname or str(tid)}})
    return events


def export_chrome_trace(path: str, spans=None):
    """Write the capture buffer (or the given spans) as a Chrome trace."""
    with open(path, "w") as f:
        json.dump({"traceEvents": to_chrome_events(spans),
                   "displayTimeUnit": "ms"}, f)
    return path
