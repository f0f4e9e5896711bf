"""Deterministic fault injection (paddle_tpu/testing/faults.py, whole).

In the port the serve loop consults the process-global injector at its
scheduler beat, ("serve", "beat", "tick") (inference/serving.py): a
scripted STALL there delays one beat, and a RESET there is absorbed.
The PS transport and the streaming dataset, ROADMAP Queue 1 item 8,
consult it at these boundaries once ported:

    ("client", "dial", endpoint) before a (re)connect — note the third
                                 field is the ENDPOINT, not a method, so
                                 rules can target one server
    ("client", "send", method)   before the request frame leaves
    ("client", "recv", method)   after send, before reading the reply
    ("server", "reply", method)  after the handler ran AND the replay
                                 cache committed, before the reply frame

The STREAMING dataset (dataset/streaming.py) consults the same injector
in front of every batch delivery as ("stream", "deliver", <stream
name>): a scripted STALL there is a deterministic BACKLOG BURST —
delivery pauses, the bounded queue fills, watermark/backlog gauges move,
and nothing is dropped (see `backlog_burst()` below); a RESET there is
absorbed by the dataset as a transient delivery fault and retried.

Client-side events additionally carry the peer ENDPOINT, so a rule can
target one shard server across every method: `Fault("client", "send",
STALL, endpoint="127.0.0.1:7001", times=10**9, delay=0.05)` is a
LATENCY-SKEW rule — that one server is slow (every call to it stalls),
the rest of the cluster is healthy. Slow-shard is a different failure
mode than dead-shard: nothing retries, nothing fails over; the tail
latency just lands on whoever waits for that shard synchronously — the
prefetch stage exists to absorb exactly this (tests/
test_ps_sharded_embedding.py proves it absorbs it WITHOUT changing
results).

An injector decides per event whether to fault. Faults are either
SCRIPTED — an ordered list of `Fault` rules with after/times counters, so
a test can say "drop exactly the first push_sparse_grad reply" — or
SEEDED — per-(side, event, method) probability streams keyed off a string
seed (sha-based, independent of PYTHONHASHSEED and thread interleaving
within each stream), for chaos runs.

Actions:
    RESET      raise ConnectionResetError at the boundary (any site
               except dial). Client side it models a TCP RST before/
               after the send; server side the reply path closes the
               connection.
    DROP       server reply only: the request WAS applied, the response
               is lost — the case idempotent replay exists for.
    STALL      sleep `delay` seconds at the boundary (models a hung
               peer; pair with a small PADDLE_PS_CALL_TIMEOUT).
    GARBLE     server reply only: a well-framed garbage payload.
    OVERSIZE   server reply only: a length prefix over the frame bound.
    PARTITION  client dial only: the (re)connect is refused —
               rpc.ConnectRefused — which is how a PERMANENTLY dead or
               partitioned server looks at dial time, distinct from a
               RESET mid-call. Target one endpoint with
               `method="host:port"` (times=N keeps it refused for N
               dials) to script dead-server and split-brain scenarios
               without killing real processes; combine with RESET rules
               on the data methods to sever already-established
               connections too.

Usage:

    from paddle_tpu_torch.testing import faults
    with faults.inject(faults.Fault("server", "reply", faults.DROP,
                                    method="push_sparse_grad")):
        client.push_sparse_grad("emb", ids, grads)   # applied ONCE

    with faults.inject(seed=7, p={faults.RESET: 0.05, faults.DROP: 0.05}):
        train(...)   # chaos mode: seeded random resets + lost replies

Every fired fault is appended to `injector.log` as
(side, event, method, action) for post-run assertions.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import time

from ..distributed.ps import rpc as _rpc

__all__ = ["RESET", "DROP", "STALL", "GARBLE", "OVERSIZE", "PARTITION",
           "Fault", "FaultInjector", "backlog_burst", "inject",
           "install", "uninstall"]

RESET = "reset"
DROP = "drop"
STALL = "stall"
GARBLE = "garble"
OVERSIZE = "oversize"
PARTITION = "partition"

# actions that only make sense where the reply frame is produced
_SERVER_REPLY_ONLY = frozenset({DROP, GARBLE, OVERSIZE})


def _eligible(action, side, event):
    if action in _SERVER_REPLY_ONLY:
        return side == "server" and event == "reply"
    if action == PARTITION:
        return side == "client" and event == "dial"
    if event == "dial":
        # the only fault a dial can exhibit is a refused connect
        return False
    return True


class Fault:
    """One scripted fault rule.

    side/event: which boundary ('client'/'send', 'client'/'recv',
    'server'/'reply'). method: exact RPC method name, or None for any.
    endpoint: restrict a CLIENT-side rule to calls against one peer
    ("host:port") — the per-endpoint latency-skew/slow-shard hook;
    None matches any peer (server-side events carry no endpoint).
    after: let that many matching frames through first. times: how many
    matches fire (then the rule is spent). delay: STALL sleep seconds.
    """

    def __init__(self, side, event, action, method=None, after=0, times=1,
                 delay=1.0, endpoint=None):
        if not _eligible(action, side, event):
            raise ValueError(
                f"action {action!r} is only injectable at server/reply")
        if endpoint is not None and side != "client":
            raise ValueError("endpoint= targeting only exists client-side "
                             "(the server does not know who dialed it)")
        self.side, self.event, self.action = side, event, action
        self.method, self.after, self.times = method, int(after), int(times)
        self.endpoint = endpoint
        self.delay = float(delay)
        self._seen = 0
        self._fired = 0

    def _try_fire(self, side, event, method, endpoint=None):
        if side != self.side or event != self.event:
            return False
        if self.method is not None and method != self.method:
            return False
        if self.endpoint is not None and endpoint != self.endpoint:
            return False
        self._seen += 1
        if self._seen <= self.after or self._fired >= self.times:
            return False
        self._fired += 1
        return True


class FaultInjector:
    """Scripted + seeded-random fault source. Install via `inject(...)`
    (context manager) or `install()`; rpc.py calls `on_event` at each
    frame boundary from whatever thread owns the socket, so all state is
    lock-protected."""

    def __init__(self, faults=(), seed=0, p=None, stall_delay=1.0):
        self.faults = [faults] if isinstance(faults, Fault) else list(faults)
        self.seed = seed
        self.p = dict(p or {})
        self.stall_delay = float(stall_delay)
        self.log = []
        self._counts = {}
        self._lock = threading.Lock()
        for action in self.p:
            if action not in (RESET, DROP, STALL, GARBLE, OVERSIZE,
                              PARTITION):
                raise ValueError(f"unknown fault action {action!r}")

    def _draw(self, side, event, method):
        """Seeded per-stream Bernoulli draw: the n-th event of a given
        (side, event, method) stream always sees the same uniform sample
        for a given seed — deterministic regardless of how server threads
        interleave ACROSS streams, and independent of PYTHONHASHSEED."""
        n = self._counts.get((side, event, method), 0)
        self._counts[(side, event, method)] = n + 1
        digest = hashlib.sha256(
            f"{self.seed}:{side}:{event}:{method}:{n}".encode()).digest()
        u = int.from_bytes(digest[:8], "big") / 2.0 ** 64
        acc = 0.0
        for action in sorted(self.p):
            if not _eligible(action, side, event):
                continue
            acc += self.p[action]
            if u < acc:
                return action
        return None

    def on_event(self, side, event, method, endpoint=None):
        # system frames are never faulted: auth is part of (re)dialing,
        # ping is the health probe the harness itself relies on
        if method in ("__auth__", "__ping__"):
            return None
        with self._lock:
            action = None
            for f in self.faults:
                if f._try_fire(side, event, method, endpoint):
                    action = f.action
                    delay = f.delay
                    break
            else:
                if self.p:
                    action = self._draw(side, event, method)
                    delay = self.stall_delay
            if action is None:
                return None
            self.log.append((side, event, method, action))
        if action == STALL:
            time.sleep(delay)
            return None
        if action == RESET:
            raise ConnectionResetError(
                f"fault injected: reset at {side}/{event} of {method!r}")
        if action == PARTITION:
            # rpc.Connection._dial converts this into ConnectRefused
            raise ConnectionRefusedError(
                f"fault injected: partitioned endpoint {method}")
        return action

    def fired(self, action=None):
        """Count of injected faults (optionally of one action)."""
        with self._lock:
            return sum(1 for rec in self.log
                       if action is None or rec[3] == action)


def backlog_burst(name=None, after=0, times=1, delay=0.2):
    """Scripted backlog burst for the streaming queue: a STALL rule at
    the ("stream", "deliver") boundary. Each firing pauses ONE batch
    delivery for `delay` seconds while producers keep offering — the
    backlog grows, the watermark holds, and every record is delivered
    once the burst passes (pause/resume, never drop). `name` targets
    one StreamingDataset (its `name=`), None matches any; after/times
    script where in the delivery sequence the burst lands, mirroring
    the endpoint-targetable STALL used for slow-shard skew."""
    return Fault("stream", "deliver", STALL, method=name, after=after,
                 times=times, delay=delay)


def install(injector: FaultInjector) -> FaultInjector:
    _rpc.set_fault_injector(injector)
    return injector


def uninstall():
    _rpc.set_fault_injector(None)


@contextlib.contextmanager
def inject(*faults, seed=0, p=None, stall_delay=1.0):
    """Context manager: install a FaultInjector built from scripted
    `Fault` rules and/or seeded probabilities, uninstall on exit, yield
    the injector (inspect `.log` / `.fired()` afterwards)."""
    inj = FaultInjector(faults, seed=seed, p=p, stall_delay=stall_delay)
    install(inj)
    try:
        yield inj
    finally:
        uninstall()
