"""Framed request/response transport for the PS stack
(paddle_tpu/distributed/ps/rpc.py, whole; the port's own copy: the same
frames, restricted unpickler, auth handshake and replay cache, so the
port's peers and the JAX package's talk to each other).

The reference runs its parameter server over brpc (N21
distributed/service/brpc_ps_server.cc) or gRPC (N20
operators/distributed/grpc/). Neither is warranted here: PS traffic is a
handful of large tensors per step between trusted cluster processes, so
the transport is a length-prefixed binary frame over TCP — numpy payloads
ride as raw buffers (zero-copy out of the socket), metadata as a small
pickled header. One thread per live connection on the server; clients
hold one persistent connection per server and serialize calls on it.

Fault tolerance (the reference's brpc channel carries connect_timeout +
timeout_ms + max_retry; HeartBeatMonitor assumes peers churn): every call
runs under a per-call deadline, transient transport failures (RST, EOF,
timeout, garbled frame) tear the socket down, back off exponentially with
jitter, transparently re-dial (re-running the auth handshake) and resend,
up to a retry budget — after which DeadlineExceeded / ConnectionError
propagates naming the method and endpoint. Retrying a MUTATING call is
made safe by idempotent replay: the client stamps such requests with a
(client_id, seq) request id and the server keeps a bounded per-client LRU
of recently applied ids, replaying the cached reply instead of
re-applying — a retry after a lost *response* cannot double-count a
gradient. Frame lengths are bounded by PADDLE_PS_MAX_FRAME on both ends
so one garbled header cannot OOM a peer. Flakiness is visible before it
becomes an outage through core.monitor counters: ps.rpc.retries,
ps.rpc.reconnects, ps.rpc.deadline_exceeded, ps.rpc.replays,
ps.rpc.bad_frames.

Security: deserialization uses a RESTRICTED unpickler that only resolves
numpy array/dtype reconstructors and plain containers — an arbitrary
`__reduce__` gadget from a hostile peer raises UnpicklingError instead of
executing (the reference's protobuf transport has no gadget surface; this
restores that property). Defense in depth: set PADDLE_PS_TOKEN in the job
environment and every connection must open with a matching token
handshake before any request is served (`__ping__` alone is answered
pre-auth so supervisors can health-check without the token). PS endpoints
are still cluster infrastructure — bind them to loopback or a trusted
network, never the open internet.
"""
from __future__ import annotations

import hmac
import importlib
import io
import os
import pickle
import random
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict

from ...core import monitor as _monitor
from ...core import trace as _trace
from ...core.flags import flag as _flag

__all__ = ["send_msg", "recv_msg", "Connection", "serve", "FrameError",
           "AuthError", "DeadlineExceeded", "ConnectRefused", "ReplayCache",
           "set_fault_injector"]

_HDR = struct.Struct("!Q")


class FrameError(ConnectionError):
    """Oversized or garbled frame — the stream is unusable past it, so
    the connection is dropped (ConnectionError subclass: generic
    transport-failure handlers treat it as such)."""


class AuthError(ConnectionError):
    """Token handshake rejected. ConnectionError subclass for callers'
    sake, but never retried — a bad token stays bad."""


class DeadlineExceeded(TimeoutError):
    """A call stalled past PADDLE_PS_CALL_TIMEOUT on every attempt of its
    retry budget. TimeoutError subclass (and therefore OSError), so
    existing `except (ConnectionError, OSError)` cleanup paths catch it.
    """


class ConnectRefused(ConnectionError):
    """The endpoint actively refused the dial — a *dead server* signal,
    distinct from a transient mid-call failure. Raised immediately (no
    retry-budget burn) when the fault injector scripts a PARTITION at
    the dial boundary, or when a real ECONNREFUSED lands on a connection
    with `fail_fast_refused` set (the shard-map client sets it once a
    replicated map is live, so a dead primary triggers failover to the
    promoted backup instead of 30s of redial)."""


# --- fault-injection seam (paddle_tpu_torch.testing.faults) ----------------
# A test-only hook consulted at frame boundaries. None in production; the
# branch is one global load per event, negligible next to a socket op.
_fault_injector = None


def set_fault_injector(injector):
    """Install (or clear, with None) the process-global fault injector.
    Use paddle_tpu_torch.testing.faults.inject(...) rather than calling this
    directly."""
    global _fault_injector
    _fault_injector = injector


def _fault(side, event, method, endpoint=None):
    inj = _fault_injector
    if inj is None:
        return None
    return inj.on_event(side, event, method, endpoint)


# --- restricted deserialization ------------------------------------------

# modules:names the restricted unpickler will resolve — numpy array/dtype
# reconstruction plus the stdlib pieces numpy's reducers reference
_SAFE_GLOBALS = {
    "builtins": {"complex", "slice", "range", "frozenset", "set",
                 "bytearray"},
    "numpy": {"ndarray", "dtype", "matrix", "generic", "bool_", "number",
              "int8", "int16", "int32", "int64", "uint8", "uint16",
              "uint32", "uint64", "float16", "float32", "float64",
              "complex64", "complex128", "longlong", "ulonglong", "intc",
              "uintc", "frombuffer"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
    "numpy.dtypes": None,   # dtype singletons (Float32DType, ...)
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _SAFE_GLOBALS and (
                _SAFE_GLOBALS[module] is None
                or name in _SAFE_GLOBALS[module]):
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"ps rpc: refusing to unpickle global {module}.{name} "
            "(only numpy payloads are allowed on this transport)")


def _loads(data, buffers=None):
    return _RestrictedUnpickler(io.BytesIO(data),
                                buffers=buffers or []).load()


def _pack(obj) -> bytes:
    """Pickle with numpy arrays extracted to raw out-of-band buffers
    (pickle-5 semantics) so big tensors aren't copied through the
    pickler."""
    buffers = []
    payload = pickle.dumps(obj, protocol=5,
                           buffer_callback=lambda b: buffers.append(b))
    parts = [payload] + [bytes(b) for b in buffers]
    head = pickle.dumps([len(p) for p in parts])
    return _HDR.pack(len(head)) + head + b"".join(parts)


def _unpack(data: bytes):
    n = _HDR.unpack_from(data)[0]
    sizes = _loads(data[_HDR.size:_HDR.size + n])
    if not isinstance(sizes, list) \
            or not all(isinstance(s, int) and 0 <= s <= len(data)
                       for s in sizes):
        raise pickle.UnpicklingError("ps rpc: malformed frame header")
    off = _HDR.size + n
    parts = []
    for s in sizes:
        parts.append(data[off:off + s])
        off += s
    return _loads(parts[0], buffers=parts[1:])


def send_msg(sock: socket.socket, obj, max_frame=None) -> None:
    data = _pack(obj)
    limit = _flag("PADDLE_PS_MAX_FRAME") if max_frame is None else max_frame
    if len(data) > limit:
        raise FrameError(
            f"ps rpc: refusing to send a {len(data)}-byte frame "
            f"(PADDLE_PS_MAX_FRAME={limit})")
    sock.sendall(_HDR.pack(len(data)) + data)


def recv_msg(sock: socket.socket, max_frame=None):
    """One framed message, None on clean EOF. Raises FrameError on a
    length prefix over PADDLE_PS_MAX_FRAME (no allocation happens) or a
    payload the restricted unpickler rejects — after either, the stream
    is desynced and the connection must be dropped."""
    head = _recv_exact(sock, _HDR.size)
    if head is None:
        return None
    (n,) = _HDR.unpack(head)
    limit = _flag("PADDLE_PS_MAX_FRAME") if max_frame is None else max_frame
    if n > limit:
        raise FrameError(
            f"ps rpc: peer announced a {n}-byte frame "
            f"(PADDLE_PS_MAX_FRAME={limit}) — dropping connection")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    try:
        return _unpack(data)
    except pickle.UnpicklingError:
        raise
    except (struct.error, ValueError, EOFError, IndexError, KeyError) as e:
        raise FrameError(f"ps rpc: garbled frame: {e}") from e


def _recv_exact(sock, n):
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            return None
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


# --- client side ----------------------------------------------------------

class Connection:
    """Client side: one persistent socket, calls serialized by a lock,
    transparent retry/reconnect under a per-call deadline.

    `timeout` is the per-attempt deadline (socket-level, covers send and
    recv); `max_retries` extra attempts follow a failed one after an
    exponentially growing jittered backoff. Reconnects re-run the
    PADDLE_PS_TOKEN auth handshake. Mutating calls pass _mutating=True so
    a resend carries the same (client_id, seq) request id and the server
    can replay instead of re-applying (see serve/ReplayCache)."""

    def __init__(self, endpoint: str, timeout=None, connect_retry_s=None,
                 max_retries=None, backoff_base=None, backoff_max=None,
                 fail_fast_refused=False, quiet=False):
        self.endpoint = endpoint
        # a quiet connection bumps no ps.rpc.* counters and records no
        # spans: the telemetry shipper (core/telemetry.py) rides one so
        # SHIPPING the observability stream never feeds back into it —
        # the hub's counter totals must equal what the app did, not
        # what the app did plus the act of reporting it
        self._quiet = bool(quiet)
        # a refused connect normally retries within the connect window
        # (workers race the server's bind at job start); with a live
        # replicated shard map the client flips this on so a dead
        # endpoint raises ConnectRefused immediately and failover runs
        self.fail_fast_refused = bool(fail_fast_refused)
        self._timeout = float(_flag("PADDLE_PS_CALL_TIMEOUT")
                              if timeout is None else timeout)
        self._max_retries = int(_flag("PADDLE_PS_MAX_RETRIES")
                                if max_retries is None else max_retries)
        self._backoff_base = float(_flag("PADDLE_PS_BACKOFF_BASE_S")
                                   if backoff_base is None else backoff_base)
        self._backoff_max = float(_flag("PADDLE_PS_BACKOFF_MAX_S")
                                  if backoff_max is None else backoff_max)
        connect_retry_s = float(_flag("PADDLE_PS_CONNECT_RETRY_S")
                                if connect_retry_s is None
                                else connect_retry_s)
        self._lock = threading.Lock()
        self._sock = None
        # request-id namespace for idempotent replay: unique per client
        # connection object, stable across reconnects
        self._client_id = uuid.uuid4().hex
        self._seq = 0
        self._dial(connect_retry_s)

    # ---------------------------------------------------------- transport
    def _dial(self, connect_retry_s):
        """Connect + auth handshake. Only the TCP connect is retried
        within the window (workers routinely race the server's bind at
        job start — the reference's brpc channel does the same via
        connect_timeout + retry policy); an auth REJECTION is final."""
        host, port = self.endpoint.rsplit(":", 1)
        try:
            # testing/faults.py PARTITION boundary: a scripted dead or
            # partitioned endpoint refuses the dial without any real
            # process being killed
            _fault("client", "dial", self.endpoint, self.endpoint)
        except ConnectionRefusedError as e:
            raise ConnectRefused(
                f"ps rpc: endpoint {self.endpoint} refused connection "
                "(injected partition)") from e
        deadline = time.monotonic() + connect_retry_s
        while True:
            try:
                sock = socket.create_connection(
                    (host, int(port)), timeout=self._timeout)
                break
            except ConnectionRefusedError as e:
                if self.fail_fast_refused:
                    raise ConnectRefused(
                        f"ps rpc: endpoint {self.endpoint} refused "
                        "connection") from e
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout)
        token = os.environ.get("PADDLE_PS_TOKEN")
        if token:
            try:
                send_msg(sock, {"method": "__auth__", "token": token})
                reply = recv_msg(sock)
            except OSError:
                sock.close()
                raise
            if not reply or reply.get("error"):
                sock.close()
                raise AuthError(
                    "ps auth handshake rejected: "
                    f"{(reply or {}).get('error', 'closed')}")
        self._sock = sock

    def _teardown(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # --------------------------------------------------------------- calls
    def call(self, method: str, _mutating=False, _key=None, _timeout=None,
             _rid=None, **kwargs):
        """One RPC under the retry/deadline policy. `_mutating` stamps a
        replay id; `_key` (optional, any hashable) pins that id so an
        OUTER retry loop (e.g. the Communicator's send thread) stays
        exactly-once too; `_rid` overrides the stamped (client_id, key)
        pair entirely — the shard-map client mints one rid per LOGICAL
        call so a failover retry to a different server (and a primary's
        forward to its backups) dedupes against the original apply;
        `_timeout` overrides the per-attempt deadline (barriers
        legitimately block longer than data calls)."""
        timeout = self._timeout if _timeout is None else float(_timeout)
        # one span per logical CALL (not per attempt): its context rides
        # in the frame — which is packed once, so every retry/resend
        # carries the SAME trace id and the server's apply/replay spans
        # correlate with this call across the process boundary
        sp = _trace.begin(f"ps.rpc/{method}", endpoint=self.endpoint,
                          mutating=bool(_mutating))
        t0 = time.perf_counter()
        try:
            result = self._call_impl(sp, method, _mutating, _key, _rid,
                                     timeout, kwargs)
            if not self._quiet:
                dt_ms = (time.perf_counter() - t0) * 1e3
                _monitor.observe("ps.rpc/latency_ms", dt_ms)
                # per-endpoint copy feeds the hub's shard-skew /
                # straggler detector (core/slo.py latency_skew)
                _monitor.observe(
                    f"ps.rpc/endpoint_ms/{self.endpoint}", dt_ms)
            return result
        except BaseException as e:
            sp.attrs.setdefault("error", type(e).__name__)
            _trace.end(sp, discard=self._quiet)
            # record BEFORE the dump snapshots the ring
            extra = getattr(e, "_flight_extra", None)
            if extra is not None and not self._quiet:
                # retry budget exhausted: the transport is dead for this
                # call — flight-record the span/metric history
                from ...core import flight_recorder as _fr
                _fr.dump("ps_transport_death", e, extra=extra)
            raise
        finally:
            _trace.end(sp, discard=self._quiet)

    def _call_impl(self, sp, method, _mutating, _key, _rid, timeout, kwargs):
        req = {"method": method, **kwargs}
        with self._lock:
            if _rid is not None:
                req["__rid__"] = tuple(_rid)
            elif _mutating:
                if _key is None:
                    self._seq += 1
                    _key = self._seq
                req["__rid__"] = (self._client_id, _key)
            req["__trace__"] = sp.context
            # pack ONCE, outside the retry loop: an oversized request is
            # a deterministic local error (no retry, nothing hit the
            # wire), and resends reuse the bytes instead of re-pickling
            payload = _pack(req)
            limit = _flag("PADDLE_PS_MAX_FRAME")
            if len(payload) > limit:
                raise FrameError(
                    f"ps rpc: request for {method!r} on {self.endpoint} "
                    f"is {len(payload)} bytes "
                    f"(PADDLE_PS_MAX_FRAME={limit})")
            frame = _HDR.pack(len(payload)) + payload
            if not self._quiet:
                _monitor.stat_add("ps.rpc.bytes_out", len(frame))
            attempts = self._max_retries + 1
            last_err = None
            for attempt in range(attempts):
                if attempt:
                    if not self._quiet:
                        _monitor.stat_add("ps.rpc.retries")
                    delay = min(self._backoff_max,
                                self._backoff_base * (2 ** (attempt - 1)))
                    # full jitter on [delay/2, delay] — decorrelates
                    # thundering-herd retries across workers
                    time.sleep(delay * (0.5 + random.random() / 2))
                try:
                    if self._sock is None:
                        self._dial(timeout)
                        if not self._quiet:
                            _monitor.stat_add("ps.rpc.reconnects")
                    self._sock.settimeout(timeout)
                    _fault("client", "send", method, self.endpoint)
                    self._sock.sendall(frame)
                    _fault("client", "recv", method, self.endpoint)
                    reply = recv_msg(self._sock)
                    if reply is None:
                        raise ConnectionError("peer closed connection")
                except AuthError:
                    self._teardown()
                    raise          # auth rejection is never transient
                except ConnectRefused:
                    # dead/partitioned endpoint: this connection cannot
                    # help — surface immediately so a shard-map client
                    # fails over instead of burning the retry budget
                    self._teardown()
                    raise
                except (OSError, pickle.UnpicklingError) as e:
                    # covers ConnectionError, FrameError, socket timeout
                    last_err = e
                    self._teardown()
                    continue
                sp.attrs["attempts"] = attempt + 1
                if reply.get("error"):
                    if reply["error"] == "ShardMapStale":
                        # structured redirect: the server's map rode
                        # along, the shard-map client re-routes with it
                        from .shard_map import ShardMapStale
                        sp.attrs["error"] = "ShardMapStale"
                        raise ShardMapStale(reply.get("shard_map"),
                                            f"{method!r} redirected by "
                                            f"{self.endpoint}")
                    raise RuntimeError(f"ps server error in {method!r}: "
                                       f"{reply['error']}")
                return reply.get("result")
        # retry budget exhausted: tag the exception so call() writes a
        # flight-recorder dump AFTER the span lands in the ring
        sp.attrs["attempts"] = attempts
        if isinstance(last_err, TimeoutError):
            if not self._quiet:
                _monitor.stat_add("ps.rpc.deadline_exceeded")
            err = DeadlineExceeded(
                f"ps rpc deadline exceeded calling {method!r} on "
                f"{self.endpoint}: {attempts} attempts of {timeout:.1f}s "
                "each (PADDLE_PS_CALL_TIMEOUT / PADDLE_PS_MAX_RETRIES)")
        else:
            err = ConnectionError(
                f"ps rpc failed calling {method!r} on {self.endpoint} "
                f"after {attempts} attempts: {last_err}")
        err._flight_extra = {"method": method, "endpoint": self.endpoint,
                             "attempts": attempts}
        raise err from last_err

    def ping(self, timeout=None):
        """Transport liveness probe; served by the peer before auth, so
        it works for supervisors that don't hold the job token."""
        return self.call("__ping__", _timeout=timeout)

    def close(self):
        self._teardown()


# --- server side ----------------------------------------------------------

class ReplayCache:
    """Bounded per-client LRU of recently applied mutating requests
    (rid -> reply), the correctness keystone that makes retry safe: a
    retry after a lost response replays the cached reply instead of
    re-applying the gradient. Entries in flight (handler still running
    when the retry lands on a fresh connection) park the retry on an
    Event rather than double-executing."""

    _PENDING, _DONE = 0, 1

    def __init__(self, per_client=None, max_clients=1024):
        self._per_client = int(_flag("PADDLE_PS_REPLAY_CACHE")
                               if per_client is None else per_client)
        self._max_clients = int(max_clients)
        self._clients: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def begin(self, rid):
        """-> ("replay", reply) | ("wait", event) | ("run", None)."""
        cid, seq = rid
        with self._lock:
            entries = self._clients.get(cid)
            if entries is None:
                entries = self._clients[cid] = OrderedDict()
                while len(self._clients) > self._max_clients:
                    _, evicted = self._clients.popitem(last=False)
                    # wake any retry parked on an in-flight entry of the
                    # evicted client — a fast "never committed" error
                    # beats a 600s hang on an orphaned Event
                    for state, pay in evicted.values():
                        if state == self._PENDING:
                            pay.set()
            else:
                self._clients.move_to_end(cid)
            entry = entries.get(seq)
            if entry is not None:
                if entry[0] == self._DONE:
                    return "replay", entry[1]
                return "wait", entry[1]
            entries[seq] = (self._PENDING, threading.Event())
            return "run", None

    def commit(self, rid, reply):
        cid, seq = rid
        with self._lock:
            entries = self._clients.get(cid)
            if entries is None:
                return
            entry = entries.get(seq)
            entries[seq] = (self._DONE, reply)
            entries.move_to_end(seq)
            # evict oldest DONE entries only — a pending one belongs to a
            # live handler that will commit into it
            while len(entries) > self._per_client:
                for k, v in entries.items():
                    if v[0] == self._DONE and k != seq:
                        del entries[k]
                        break
                else:
                    break
        if entry is not None and entry[0] == self._PENDING:
            entry[1].set()

    def abort(self, rid):
        """Drop a PENDING entry without caching a reply — used for
        routing rejections (ShardMapStale): the client WILL retry the
        same rid against the right server, and a cached redirect would
        replay forever. Parked retries are woken; begin() then hands
        them 'run'."""
        cid, seq = rid
        with self._lock:
            entries = self._clients.get(cid)
            entry = entries.pop(seq, None) if entries is not None else None
        if entry is not None and entry[0] == self._PENDING:
            entry[1].set()

    def lookup(self, rid):
        cid, seq = rid
        with self._lock:
            entry = self._clients.get(cid, {}).get(seq)
        if entry is not None and entry[0] == self._DONE:
            return entry[1]
        return None


def _trace_ctx_of(req):
    """Pop the client-shipped trace context (trace_id, span_id) from a
    request, validating shape — a peer without the tracer (or a garbled
    field) degrades to a fresh local trace, never an error."""
    ctx = req.pop("__trace__", None)
    try:
        trace_id, span_id = ctx
        return (str(trace_id), None if span_id is None else str(span_id))
    except (TypeError, ValueError):
        return None


def _rid_of(req):
    rid = req.pop("__rid__", None)
    if rid is None:
        return None
    try:
        cid, seq = rid
        hash(seq)
    except (TypeError, ValueError):
        return None
    return str(cid), seq


def serve(endpoint: str, handler, stop_event: threading.Event, replay=None):
    """Accept loop: one daemon thread per connection, each dispatching
    framed requests to handler(method, kwargs) until the peer closes or
    stop_event fires. Returns the bound port (endpoint may say :0).

    Per-connection fault policy: a garbled/oversized frame gets a
    best-effort error reply, bumps ps.rpc.bad_frames, and drops ONLY that
    connection (the stream past it is desynced) — the server and its
    other connections keep running. `__ping__` is answered before auth.
    Requests carrying a replay id go through the shared ReplayCache so a
    retried mutation is applied exactly once; pass `replay` to share the
    cache with other machinery (the replica catch-up path registers
    delta-log rids in it so live forwards dedupe against them).

    A handler declaring a third parameter — handler(method, req, rid) —
    receives the request's replay id so it can thread the SAME id through
    primary->backup forwards (exactly-once across the whole replica
    chain); two-parameter handlers keep working unchanged."""
    host, port = endpoint.rsplit(":", 1)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, int(port)))
    srv.listen(128)
    srv.settimeout(0.2)
    bound = srv.getsockname()[1]

    token = os.environ.get("PADDLE_PS_TOKEN")
    if replay is None:
        replay = ReplayCache()
    try:
        import inspect
        _sig = inspect.signature(handler)
        wants_rid = len(_sig.parameters) >= 3
    except (TypeError, ValueError):
        wants_rid = False

    def _serve_one(conn, method, req):
        """Run the handler (through the replay cache when the request is
        stamped) and send the reply, honoring injected reply faults.
        Returns False when the connection must close. The span parents to
        the trace context the CLIENT shipped in the frame (same bytes on
        every retry), so apply AND replay spans of one logical call share
        its trace id across the process boundary."""
        tctx = _trace_ctx_of(req)
        rid = _rid_of(req)
        sp = _trace.begin(f"ps.server/{method}", parent=tctx,
                          outcome="apply")
        try:
            reply = None
            run = rid is None
            if rid is not None:
                for _round in range(3):
                    state, payload = replay.begin(rid)
                    if state == "run":
                        run = True
                        break
                    if state == "replay":
                        _monitor.stat_add("ps.rpc.replays")
                        sp.attrs["outcome"] = "replay"
                        reply = payload
                        break
                    # the original attempt is still executing on another
                    # connection thread — parking beats double-applying
                    sp.attrs["outcome"] = "wait"
                    payload.wait(timeout=600.0)
                    reply = replay.lookup(rid)
                    if reply is not None:
                        _monitor.stat_add("ps.rpc.replays")
                        break
                    # original aborted (stale-map redirect) or evicted:
                    # loop to re-begin — this retry becomes the runner
                if not run and reply is None:
                    reply = {"error": "ps rpc: in-flight original "
                                      "never committed (server "
                                      "overloaded?)"}
            if run:
                cacheable = True
                try:
                    result = handler(method, req, rid) if wants_rid \
                        else handler(method, req)
                    reply = {"result": result}
                except Exception as e:  # noqa: BLE001 — reported to peer
                    sp.attrs["error"] = type(e).__name__
                    stale = getattr(e, "shard_map_dict", None)
                    if stale is not None:
                        # routing redirect, not an application error:
                        # ship the server's map and DON'T cache — the
                        # same rid must run for real on the right server
                        reply = {"error": "ShardMapStale",
                                 "shard_map": stale}
                        cacheable = False
                    else:
                        reply = {"error": f"{type(e).__name__}: {e}"}
                        if getattr(e, "replay_uncacheable", False):
                            # e.g. a quorum failure: the error must not
                            # poison the rid — the retry re-runs (the
                            # replica layer dedupes the apply itself)
                            cacheable = False
                if rid is not None:
                    # commit BEFORE the reply leaves: if the response is
                    # lost from here on, the retry replays instead of
                    # re-applying
                    if cacheable:
                        replay.commit(rid, reply)
                    else:
                        replay.abort(rid)
        finally:
            _trace.end(sp)
        try:
            act = _fault("server", "reply", method)
        except ConnectionError:
            return False            # injected reset at the reply boundary
        if act == "drop":
            return False            # applied, but the response is lost
        if act == "garble":
            conn.sendall(_HDR.pack(10) + b"\x00" * 10)
            return True
        if act == "oversize":
            conn.sendall(_HDR.pack(1 << 41))
            return False
        send_msg(conn, reply)
        return True

    def _conn_loop(conn):
        conn.settimeout(None)
        authed = not token
        try:
            while not stop_event.is_set():
                try:
                    req = recv_msg(conn)
                except (FrameError, pickle.UnpicklingError) as e:
                    _monitor.stat_add("ps.rpc.bad_frames")
                    try:
                        send_msg(conn, {"error": f"bad frame: {e}"})
                    except OSError:
                        pass
                    break
                # re-check AFTER the blocking recv: a request that raced
                # shutdown must not be applied to a dying server's tables
                # (the client will retry against the restarted one)
                if req is None or stop_event.is_set():
                    break
                if not isinstance(req, dict) or "method" not in req:
                    _monitor.stat_add("ps.rpc.bad_frames")
                    send_msg(conn, {"error": "bad frame: no method"})
                    break
                method = req.pop("method")
                if method == "__ping__":
                    # liveness probe, answered before auth by design
                    send_msg(conn, {"result": "pong"})
                    continue
                if not authed:
                    # first real frame must be the token handshake
                    if method == "__auth__" and hmac.compare_digest(
                            str(req.get("token", "")), token):
                        authed = True
                        send_msg(conn, {"result": "ok"})
                        continue
                    send_msg(conn, {"error": "auth required"})
                    break
                if method == "__auth__":
                    send_msg(conn, {"result": "ok"})
                    continue
                if not _serve_one(conn, method, req):
                    break
        except OSError:
            pass                    # peer vanished mid-reply: their retry
        finally:                    # lands on a fresh connection
            conn.close()

    def _accept_loop():
        with srv:
            while not stop_event.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                threading.Thread(target=_conn_loop, args=(conn,),
                                 daemon=True).start()

    t = threading.Thread(target=_accept_loop, daemon=True)
    t.start()
    return bound, t
