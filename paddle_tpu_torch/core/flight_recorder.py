"""Always-on flight recorder: dump recent spans + metrics on failure
(paddle_tpu/core/flight_recorder.py, copied; the schema is the JAX
package's, so its renderer reads a dump of the port).

The span ring (core/trace.py) and the metric registry (core/monitor.py)
are always recording; this module turns them into a post-mortem artifact.
When `PADDLE_TPU_DUMP_DIR` is set, a failure writes one self-contained
JSON dump there:

- `PipelineStepError` (an in-flight async step failed —
  static/pipeline_runner.py raises at the materialization boundary),
- a corrupt checkpoint step quarantined by incubate/checkpoint.py,
- a fatal signal (SIGTERM by default; SIGUSR1 dumps on demand without
  killing the process) when `maybe_install()` ran at import.

A dump is one JSON object with the keys `SCHEMA_KEYS`: the recent and
open spans, the monitor's snapshot, the flags, the `PADDLE_` / `FLAGS_`
/ `CUDA_` environment and the caller's `extra`.

With `PADDLE_TPU_DUMP_DIR` unset every hook is a no-op — the recorder
costs one env lookup on the failure path and nothing in steady state.
Dumps are rate-limited per reason so a failure storm (every handle of a
broken pipeline raising) cannot fill a disk.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import defaultdict

from . import monitor as _monitor
from . import trace as _trace

__all__ = ["dump", "dump_dir", "enabled", "suppressed", "maybe_install",
           "install_signal_handlers", "register_emergency_hook",
           "unregister_emergency_hook", "register_dump_listener",
           "unregister_dump_listener", "set_identity",
           "SCHEMA_VERSION", "SCHEMA_KEYS"]

SCHEMA_VERSION = 2
# The JAX package's schema, key for key: v2 (cluster telemetry) appended
# incident_id / role / peer_members (core/telemetry.py fills them).
SCHEMA_KEYS = ("schema", "reason", "time", "pid", "argv", "exception",
               "spans", "metrics", "flags", "env", "extra",
               "incident_id", "role", "peer_members")

_lock = threading.Lock()
_dumped = defaultdict(int)
_seq = 0
MAX_DUMPS_PER_REASON = 4

_prev_handlers: dict = {}


def dump_dir() -> str:
    return os.environ.get("PADDLE_TPU_DUMP_DIR", "")


def enabled() -> bool:
    return bool(dump_dir())


_suppress_tls = threading.local()


@contextlib.contextmanager
def suppressed(reason: str):
    """Suppress `reason` dumps on THIS thread for the scope — for outer
    retry layers whose inner layer would otherwise declare death
    prematurely (the Communicator rides out per-call retry exhaustion on
    all but its last send attempt)."""
    active = getattr(_suppress_tls, "reasons", None)
    if active is None:
        active = _suppress_tls.reasons = set()
    novel = reason not in active
    if novel:
        active.add(reason)
    try:
        yield
    finally:
        if novel:
            active.discard(reason)


def _is_suppressed(reason: str) -> bool:
    return reason in getattr(_suppress_tls, "reasons", ())


def _exception_record(exc):
    if exc is None:
        return None
    tb = None
    if getattr(exc, "__traceback__", None) is not None:
        tb = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
    return {"type": type(exc).__name__, "message": str(exc),
            "traceback": tb}


def _flags_snapshot():
    try:
        from . import flags as _flags
        with _flags._LOCK:
            return dict(_flags._REGISTRY)
    except Exception:
        return {}


# Cluster identity (schema v2): a fleet member's role ("serve", "ps0",
# "trainer", ...) and its known peers, stamped into every dump so a
# merged incident can say WHO each record came from. Set once at member
# startup (core/telemetry.py's TelemetryShipper does it for its owner).
_role: str = ""
_peer_members: list = []


def set_identity(role=None, peers=None):
    """Declare this process's fleet identity for future dumps."""
    global _role, _peer_members
    if role is not None:
        _role = str(role)
    if peers is not None:
        _peer_members = [str(p) for p in peers]


def record(reason: str, exc=None, extra=None, incident_id=None) -> dict:
    """The dump payload (also used by obs_report --live). Key set is
    SCHEMA_KEYS, schema version SCHEMA_VERSION."""
    return {
        "schema": SCHEMA_VERSION,
        "reason": reason,
        "time": time.time(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "exception": _exception_record(exc),
        # ring (finished) + this thread's still-open spans — the span
        # enclosing the failure hasn't ended yet and would otherwise be
        # the one span missing from its own post-mortem
        "spans": [_trace.span_dict(s) for s in _trace.recent()]
                 + [dict(_trace.span_dict(s), open=True)
                    for s in _trace.open_spans()],
        "metrics": _monitor.snapshot(),
        "flags": _flags_snapshot(),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(("PADDLE_", "FLAGS_", "CUDA_"))},
        "extra": extra or {},
        "incident_id": incident_id,
        "role": _role,
        "peer_members": list(_peer_members),
    }


# Emergency hooks: callables fired when a dump is requested for one of
# their reasons, INDEPENDENT of PADDLE_TPU_DUMP_DIR — the checkpoint
# tier's emergency synchronous save (incubate/checkpoint.py) rides the
# same trigger points as the recorder (PipelineStepError, SIGTERM)
# whether or not post-mortem dumps are configured. Each hook is
# (reasons, fn); fn(reason, exc) must never raise consequentially —
# failures are swallowed so a broken hook cannot mask the failure that
# fired it.
_emergency_hooks: list = []


def register_emergency_hook(fn, reasons=("pipeline_step_error",
                                         "signal_SIGTERM")):
    """Run `fn(reason, exc)` whenever a dump fires for one of `reasons`
    (even with the dump dir unset). Returns the hook handle for
    unregister_emergency_hook."""
    handle = (tuple(reasons), fn)
    with _lock:
        _emergency_hooks.append(handle)
    return handle


def unregister_emergency_hook(handle):
    with _lock:
        try:
            _emergency_hooks.remove(handle)
        except ValueError:
            pass


def _fire_emergency_hooks(reason, exc):
    with _lock:
        hooks = [fn for reasons, fn in _emergency_hooks
                 if reason in reasons]
    for fn in hooks:
        try:
            fn(reason, exc)
        except Exception:
            pass


# Dump listeners: fn(reason, exc, incident_id) fired for EVERY dump
# trigger regardless of reason and of PADDLE_TPU_DUMP_DIR — the cluster
# telemetry shipper (core/telemetry.py) uses this to report the trigger to the hub so the
# whole fleet dumps under one incident id. Listeners get the incident_id
# the dump was requested with (None for a locally-originated failure)
# so a hub-requested incident dump does not re-report itself.
_dump_listeners: list = []


def register_dump_listener(fn):
    with _lock:
        if fn not in _dump_listeners:
            _dump_listeners.append(fn)
    return fn


def unregister_dump_listener(fn):
    with _lock:
        try:
            _dump_listeners.remove(fn)
        except ValueError:
            pass


def _fire_dump_listeners(reason, exc, incident_id):
    with _lock:
        listeners = list(_dump_listeners)
    for fn in listeners:
        try:
            fn(reason, exc, incident_id)
        except Exception:
            pass


def dump(reason: str, exc=None, extra=None, incident_id=None,
         _fire_hooks=True):
    """Write a flight-recorder dump; returns the path, or None when
    disabled/rate-limited. NEVER raises — a recorder failure must not
    mask the failure being recorded."""
    try:
        if _fire_hooks and not _is_suppressed(reason):
            _fire_emergency_hooks(reason, exc)
        if not _is_suppressed(reason):
            _fire_dump_listeners(reason, exc, incident_id)
        d = dump_dir()
        if not d or _is_suppressed(reason):
            return None
        global _seq
        with _lock:
            if _dumped[reason] >= MAX_DUMPS_PER_REASON:
                return None
            _dumped[reason] += 1
            _seq += 1
            seq = _seq
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"obsdump_{reason}_{os.getpid()}_{seq:03d}.json")
        payload = record(reason, exc=exc, extra=extra,
                         incident_id=incident_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


# -- fatal-signal hook -------------------------------------------------------

def _handler(signum, frame):
    # Python delivers signals on the MAIN thread between bytecodes — the
    # interrupted code may be holding monitor/trace/flags locks (the hot
    # loop bumps counters constantly), and those are not reentrant. A
    # dump from the handler itself could deadlock on them; a side thread
    # either gets the locks when their holders release, or we give up at
    # the timeout and die dump-less. Best-effort by design.
    #
    # Emergency hooks (the checkpoint tier's synchronous grace save) run
    # FIRST, on the main thread, unbounded: the interrupted main thread
    # owns the model/optimizer state they capture, and a save that takes
    # longer than any fixed bound must complete rather than be killed
    # mid-write — delaying death is their entire purpose. Only the
    # metrics/trace dump rides the bounded side thread.
    reason = f"signal_{signal.Signals(signum).name}"
    if not _is_suppressed(reason):
        _fire_emergency_hooks(reason, None)
    th = threading.Thread(target=dump, args=(reason,),
                          kwargs={"_fire_hooks": False}, daemon=True)
    th.start()
    th.join(timeout=10.0)
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif signum != signal.SIGUSR1 and prev != signal.SIG_IGN:
        # SIG_DFL — or None, i.e. a handler installed outside Python we
        # cannot call: restore the default disposition and re-raise so
        # the process still DIES on a fatal signal (a dump hook must
        # never make SIGTERM a no-op for the supervisor)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_signal_handlers(signals=(signal.SIGTERM, signal.SIGUSR1)):
    """Chain a dump in front of the current handlers. SIGUSR1 becomes an
    on-demand dump (process keeps running); SIGTERM dumps then defers to
    whatever was installed (e.g. hapi's PreemptionGuard) or the default
    disposition. Main-thread only (CPython restriction) — silently
    no-ops elsewhere."""
    installed = []
    for sig in signals:
        try:
            prev = signal.signal(sig, _handler)
        except (ValueError, OSError):
            continue  # non-main thread or unsupported signal
        if prev is not _handler:
            _prev_handlers[sig] = prev
        installed.append(sig)
    return installed


def maybe_install():
    """Called from paddle_tpu_torch import: arm the signal hook only when the
    dump dir is configured (and PADDLE_TPU_DUMP_ON_SIGNAL isn't 0)."""
    if not enabled():
        return []
    if os.environ.get("PADDLE_TPU_DUMP_ON_SIGNAL", "1") in ("0", "false"):
        return []
    return install_signal_handlers()
