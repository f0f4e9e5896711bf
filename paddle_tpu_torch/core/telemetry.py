"""Cluster telemetry plane (paddle_tpu/core/telemetry.py, whole; pure
Python, the port's own copy): every process of a job (the serve loop,
trainers, PS servers) ships its monitor registry and finished spans to
one `TelemetryHub`, which merges them, evaluates SLOs, and coordinates
incident capture.

The design rides the PS transport (distributed/ps/rpc.py) instead of
inventing a second one:

  - The hub is an `rpc.serve()` endpoint with a shared `ReplayCache`.
    A `TelemetryShipper` ships each flush as ONE mutating call whose
    replay key is pinned to the shipment's sequence number
    (`(client_id, seq)`), so a batch retried through RESET/DROP chaos
    or a reconnect is applied exactly once — counter deltas are safe to
    sum at the hub, bitwise.
  - Merge semantics by metric type: counters ship as DELTAS against the
    last acked snapshot and the hub sums them; gauges are last-wins;
    histograms ship their full cumulative summary per process and merge
    bucket-wise at read time (core/slo.py merge_hists); spans ship in
    bounded batches.
  - The hot path never blocks on telemetry: finished spans land in a
    bounded in-memory buffer via a trace sink (overflow sheds and
    counts `telemetry.dropped_spans` / `telemetry.dropped_batches`);
    the monitor registry is only read, on the shipper's own thread;
    the shipper's connection is `quiet` so shipping the stream does not
    feed back into it.
  - Incident protocol: a member's flight-recorder trigger (transport
    death, PipelineStepError, signal — register_dump_listener) reports
    to the hub; the hub opens an incident (or joins one open within
    PADDLE_TELEMETRY_INCIDENT_WINDOW_S) and piggybacks the incident id
    on every ship ack, so the WHOLE fleet dumps the same window under
    one id within a flush cadence. Member records merge into
    `incident_<id>.json` (the JAX package's format), which
    `python -m paddle_tpu_torch.tools.obs_report --incident` renders.
    SLO breaches found by the hub's burn-rate engine open incidents the
    same way.

See docs/observability.md "Cluster telemetry" / "SLOs and incidents".
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import OrderedDict, deque

from . import flags as _flags
from . import flight_recorder as _fr
from . import monitor as _monitor
from . import slo as _slo
from . import trace as _trace

__all__ = ["TelemetryHub", "TelemetryShipper", "fetch_snapshot",
           "stitch_incident", "INCIDENT_SCHEMA"]

# merged incident file format version (distinct from the per-process
# flight-recorder schema: an incident file CONTAINS member records)
INCIDENT_SCHEMA = 1

_DEF_RPC_OPTS = dict(timeout=5.0, max_retries=2, backoff_base=0.05,
                     backoff_max=0.5, connect_retry_s=5.0)

# at most this many spans ride one shipment — bounds the frame size;
# the rest stay buffered for the next flush
MAX_SPANS_PER_SHIP = 512


def _flag(name):
    return _flags.flag(name)


def _rpc():
    # lazy: core must stay importable without the ps package loaded
    from ..distributed.ps import rpc
    return rpc


# --------------------------------------------------------------------------
# hub
# --------------------------------------------------------------------------

class TelemetryHub:
    """The aggregation endpoint. Thread-safe; one instance per cluster
    (typically in the supervisor / drill parent process).

    `specs` is a list of slo.SLOSpec evaluated every PADDLE_SLO_EVAL_S
    seconds over the MERGED counters/histograms; breaches append
    structured alerts and open an incident. `dump_dir` (default
    PADDLE_TPU_DUMP_DIR) is where merged `incident_<id>.json` files go.
    """

    def __init__(self, endpoint="127.0.0.1:0", specs=(), dump_dir=None,
                 fast_s=None, slow_s=None, eval_s=None,
                 burn_threshold=1.0, incident_window_s=None,
                 span_capacity=65536, clock=time.time):
        rpc = _rpc()
        self._clock = clock
        self._lock = threading.Lock()
        self._members: OrderedDict = OrderedDict()
        self._counters: dict = {}
        self._member_counters: dict = {}
        self._gauges: dict = {}
        self._member_hists: dict = {}
        self._spans: deque = deque(maxlen=int(span_capacity))
        self.alerts: list = []
        self._incidents: OrderedDict = OrderedDict()
        self._open_incident = None
        self._incident_window_s = float(
            _flag("PADDLE_TELEMETRY_INCIDENT_WINDOW_S")
            if incident_window_s is None else incident_window_s)
        self._dump_dir = (dump_dir if dump_dir is not None
                          else os.environ.get("PADDLE_TPU_DUMP_DIR", ""))
        self._member_id = f"hub-{os.getpid()}"
        self.engine = _slo.SLOEngine(
            specs,
            fast_s=(_flag("PADDLE_SLO_FAST_WINDOW_S")
                    if fast_s is None else fast_s),
            slow_s=(_flag("PADDLE_SLO_SLOW_WINDOW_S")
                    if slow_s is None else slow_s),
            burn_threshold=burn_threshold, now=clock)
        self._eval_s = float(_flag("PADDLE_SLO_EVAL_S")
                             if eval_s is None else eval_s)
        self._stop = threading.Event()
        self._replay = rpc.ReplayCache()
        host = endpoint.rsplit(":", 1)[0]
        port, self._serve_thread = rpc.serve(
            endpoint, self._handle, self._stop, replay=self._replay)
        self.endpoint = f"{host}:{port}"
        # prime the burn-rate series with a t0 baseline so the very
        # first real evaluation has a reference point to diff against
        self.evaluate()
        self._eval_thread = threading.Thread(
            target=self._eval_loop, daemon=True,
            name="telemetry-hub-slo")
        self._eval_thread.start()

    # ------------------------------------------------------------- rpc side
    def _handle(self, method, req, rid):
        if method == "telemetry_ship":
            return self._apply_ship(req)
        if method == "telemetry_incident":
            iid, _ = self._open_or_join(
                req.get("reason", "unknown"),
                trigger=req.get("member"))
            return {"incident_id": iid}
        if method == "telemetry_incident_dump":
            return {"attached": self._attach_record(
                req.get("incident_id"), req.get("member"),
                req.get("record"))}
        if method == "telemetry_snapshot":
            return self.snapshot()
        if method == "telemetry_spans":
            with self._lock:
                return [dict(s, member=m, role=r, pid=p)
                        for m, r, p, s in list(self._spans)]
        raise ValueError(f"telemetry hub: unknown method {method!r}")

    def _apply_ship(self, req):
        member = str(req.get("member"))
        now = self._clock()
        counters = req.get("counters") or {}
        gauges = req.get("gauges") or {}
        hists = req.get("hists") or {}
        spans = req.get("spans") or ()
        with self._lock:
            m = self._members.get(member)
            if m is None:
                m = self._members[member] = {
                    "role": req.get("role", ""),
                    "pid": req.get("pid"),
                    "first": now, "ships": 0, "spans": 0}
            m["last"] = now
            m["ships"] += 1
            mc = self._member_counters.setdefault(member, {})
            for name, d in counters.items():
                self._counters[name] = self._counters.get(name, 0.0) + d
                mc[name] = mc.get(name, 0.0) + d
            for name, v in gauges.items():
                self._gauges[name] = v
            if hists:
                self._member_hists.setdefault(member, {}).update(hists)
            for s in spans:
                self._spans.append((member, m["role"], m["pid"], s))
            m["spans"] += len(spans)
            incident = self._pending_incident_locked(member, now)
        return {"ok": True, "incident": incident}

    def _pending_incident_locked(self, member, now):
        iid = self._open_incident
        if iid is None:
            return None
        inc = self._incidents[iid]
        if now - inc["time"] > self._incident_window_s:
            self._open_incident = None
            return None
        if member in inc["members"]:
            return None
        return {"id": iid, "reason": inc["reason"]}

    # -------------------------------------------------------- incident flow
    def _open_or_join(self, reason, trigger=None, now=None):
        """Returns (incident_id, opened): triggers within the
        coalescing window of an open incident JOIN it."""
        now = self._clock() if now is None else now
        with self._lock:
            iid = self._open_incident
            if iid is not None:
                inc = self._incidents[iid]
                if now - inc["time"] <= self._incident_window_s:
                    if trigger and trigger not in inc["triggers"]:
                        inc["triggers"].append(trigger)
                    return iid, False
            iid = "inc_" + uuid.uuid4().hex[:10]
            inc = self._incidents[iid] = {
                "incident_id": iid, "reason": reason, "time": now,
                "triggers": [trigger] if trigger else [],
                "alerts": [], "members": {}}
            self._open_incident = iid
        self._write_incident(iid)
        return iid, True

    def _attach_record(self, incident_id, member, record):
        with self._lock:
            inc = self._incidents.get(incident_id)
            if inc is None or not member:
                return False
            inc["members"][str(member)] = record
        self._write_incident(incident_id)
        return True

    def _write_incident(self, incident_id):
        d = self._dump_dir
        if not d:
            return None
        with self._lock:
            inc = self._incidents.get(incident_id)
            if inc is None:
                return None
            payload = {"schema": INCIDENT_SCHEMA,
                       "slo_specs": [s.to_dict()
                                     for s in self.engine.specs],
                       **{k: (dict(v) if isinstance(v, dict) else
                              list(v) if isinstance(v, list) else v)
                          for k, v in inc.items()}}
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"incident_{incident_id}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
            return path
        except OSError:
            return None

    # ----------------------------------------------------------- evaluation
    def _eval_loop(self):
        while not self._stop.wait(self._eval_s):
            try:
                self.evaluate()
            except Exception:
                pass

    def merged_hists(self):
        with self._lock:
            per_member = list(self._member_hists.values())
        names = set()
        for h in per_member:
            names.update(h)
        return {n: _slo.merge_hists([h.get(n) for h in per_member])
                for n in names}

    def evaluate(self, now=None):
        """One SLO engine tick over the merged state; returns new breach
        alerts (each also opens/joins an incident)."""
        with self._lock:
            counters = dict(self._counters)
        hists = self.merged_hists()
        skew = _slo.latency_skew(
            {n[len("ps.rpc/endpoint_ms/"):]: s.get("avg")
             for n, s in hists.items()
             if n.startswith("ps.rpc/endpoint_ms/") and s.get("count")})
        with self._lock:
            self._gauges["telemetry.ps_latency_skew"] = \
                (skew[0] if skew else None)
        alerts = self.engine.observe(counters, hists, now=now)
        for alert in alerts:
            iid, opened = self._open_or_join(
                f"slo_breach:{alert['slo']}", trigger=self._member_id,
                now=alert["time"])
            alert["incident_id"] = iid
            with self._lock:
                self.alerts.append(alert)
                inc = self._incidents.get(iid)
                if inc is not None:
                    inc["alerts"].append(alert)
            if opened:
                # the hub contributes its own record so the merged dump
                # carries the alert context even if members are slow
                self._attach_record(
                    iid, self._member_id,
                    _fr.record(f"slo_breach:{alert['slo']}",
                               incident_id=iid))
            else:
                self._write_incident(iid)
        return alerts

    # -------------------------------------------------------------- reading
    def snapshot(self):
        """Aggregated fleet view (also the telemetry_snapshot RPC)."""
        hists = self.merged_hists()
        with self._lock:
            return {
                "members": {m: dict(v)
                            for m, v in self._members.items()},
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "hists": hists,
                "alerts": list(self.alerts),
                "active_slos": self.engine.active(),
                "incidents": [
                    {"incident_id": i["incident_id"],
                     "reason": i["reason"], "time": i["time"],
                     "members": sorted(i["members"])}
                    for i in self._incidents.values()],
                "span_count": len(self._spans),
            }

    def member_counters(self, member):
        with self._lock:
            return dict(self._member_counters.get(member, {}))

    def incidents(self):
        with self._lock:
            return {iid: {"reason": i["reason"], "time": i["time"],
                          "members": dict(i["members"]),
                          "alerts": list(i["alerts"]),
                          "triggers": list(i["triggers"])}
                    for iid, i in self._incidents.items()}

    def chrome_trace(self, path=None):
        """The cluster timeline: every member's spans on its own
        process lane (pid), plus process_name metadata rows naming the
        member roles — serve -> primary -> backup flows render as one
        chain because the trace ids crossed the wire in ps.rpc frames.
        Returns the event list (and writes JSON to `path` if given)."""
        with self._lock:
            spans = list(self._spans)
        lanes = OrderedDict()
        for member, role, pid, s in spans:
            lane = pid if pid is not None else member
            lanes.setdefault(lane, (f"{role or member} ({member})", []))
            lanes[lane][1].append(s)
        events = []
        for lane, (label, lane_spans) in lanes.items():
            events.append({"name": "process_name", "ph": "M",
                           "pid": lane, "args": {"name": label}})
            events.extend(_trace.to_chrome_events(lane_spans, pid=lane))
        if path:
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)
        return events

    def stop(self):
        self._stop.set()
        self._eval_thread.join(timeout=5.0)
        self._serve_thread.join(timeout=5.0)


# --------------------------------------------------------------------------
# shipper
# --------------------------------------------------------------------------

class TelemetryShipper:
    """Background thread that ships this process's telemetry to a hub.

    Exactly-once accounting: each flush snapshots the monitor registry,
    computes counter deltas against the last ACKED snapshot, and ships
    them as one mutating RPC whose replay key is pinned to the shipment
    seq — a retry (chaos, reconnect) replays at the hub instead of
    double-applying, and an un-acked shipment is re-sent with the SAME
    key next cadence. Gauges ship current values; histograms ship their
    full cumulative summaries (last-wins per member at the hub, merged
    across members at read time).

    Span capture is a trace sink appending to a bounded buffer — when
    the hub is slow or dead the buffer sheds (telemetry.dropped_spans
    per span, telemetry.dropped_batches per affected flush) rather than
    ever blocking the thread that finished the span.

    Incident duty: a local flight-recorder trigger is reported to the
    hub (opening/joining an incident); an incident id piggybacked on a
    ship ack makes this member write its own schema-v2 dump and ship
    the record to the merged incident file.
    """

    def __init__(self, hub_endpoint=None, member_id=None, role="",
                 peers=None, snapshot_fn=None, flush_s=None,
                 span_buffer=None, rpc_opts=None, capture_spans=True,
                 report_incidents=True, clock=time.time):
        hub_endpoint = hub_endpoint or _flag("PADDLE_TELEMETRY_HUB")
        if not hub_endpoint:
            raise ValueError("TelemetryShipper needs a hub endpoint "
                             "(arg or PADDLE_TELEMETRY_HUB)")
        self.hub_endpoint = hub_endpoint
        self.role = str(role)
        self.member_id = member_id or (
            f"{role or 'member'}-{os.getpid()}-{uuid.uuid4().hex[:6]}")
        self._snapshot = snapshot_fn or (
            lambda: _monitor.snapshot(include_series=False))
        self._flush_s = float(_flag("PADDLE_TELEMETRY_FLUSH_S")
                              if flush_s is None else flush_s)
        self._span_cap = int(_flag("PADDLE_TELEMETRY_SPAN_BUFFER")
                             if span_buffer is None else span_buffer)
        self._clock = clock
        opts = dict(_DEF_RPC_OPTS)
        opts.update(rpc_opts or {})
        self._rpc_opts = opts
        # the connection dials lazily (first flush): a hub that is down
        # when a member attaches — or dies later — must degrade to
        # dropped batches, never take the member down with it
        self._conn = None
        self._flush_lock = threading.Lock()
        self._last_acked: dict = {}      # counter -> acked cumulative
        self._seq = 0
        self._pending = None             # (key, payload, snap, spans)
        self._spans: deque = deque()
        self._overflowed = False
        self._seen_incidents = set()
        self._stop = threading.Event()
        self._thread = None
        _fr.set_identity(role=self.role or None, peers=peers)
        self._capture_spans = bool(capture_spans)
        if self._capture_spans:
            _trace.add_sink(self._span_sink)
        self._report_incidents = bool(report_incidents)
        if self._report_incidents:
            _fr.register_dump_listener(self._on_dump_trigger)

    def _ensure_conn(self):
        """Dial on first use. A failed dial raises to the caller (flush
        returns False / the beat thread swallows it) and leaves the
        shipper intact for the next attempt."""
        if self._conn is None:
            self._conn = _rpc().Connection(self.hub_endpoint, quiet=True,
                                           **self._rpc_opts)
        return self._conn

    # ------------------------------------------------------------ hot path
    def _span_sink(self, sp):
        """Called for every finished span, on whatever thread finished
        it — must stay O(1) and never block. Telemetry-transport spans
        are excluded for the same reason the shipper's connection is
        quiet: shipping the stream must not generate the stream (an
        in-process hub would otherwise hand every ship's server span
        right back to the shipper, and drains would chase their own
        tail forever)."""
        if sp.name.startswith("ps.server/telemetry_"):
            return
        if len(self._spans) >= self._span_cap:
            self._overflowed = True
            _monitor.stat_add("telemetry.dropped_spans")
            return
        self._spans.append(sp)

    # ---------------------------------------------------------- background
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"telemetry-shipper-{self.member_id}")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self._flush_s):
            try:
                self.flush()
            except Exception:
                pass

    def close(self, drain_timeout=5.0):
        """Stop the background thread, drain what's left, detach."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(drain_timeout, self._flush_s)
                              + 1.0)
            self._thread = None
        drained = self.drain(timeout=drain_timeout)
        if self._capture_spans:
            _trace.remove_sink(self._span_sink)
        if self._report_incidents:
            _fr.unregister_dump_listener(self._on_dump_trigger)
        if self._conn is not None:
            self._conn.close()
        return drained

    # ------------------------------------------------------------- shipping
    def _counter_cum(self, snap):
        """{counter name: cumulative value} from a registry snapshot."""
        values = snap.get("values", {})
        return {n: float(values.get(n, 0.0))
                for n, t in snap.get("types", {}).items()
                if t == "counter"}

    def _collect(self):
        """Build the next shipment from the current registry state."""
        snap = self._snapshot()
        values = snap.get("values", {})
        types = snap.get("types", {})
        cum = self._counter_cum(snap)
        counters = {}
        for name, cur in cum.items():
            delta = cur - self._last_acked.get(name, 0.0)
            if delta:
                counters[name] = delta
        gauges = {n: values.get(n) for n, t in types.items()
                  if t == "gauge"}
        spans = []
        while self._spans and len(spans) < MAX_SPANS_PER_SHIP:
            try:
                spans.append(_trace.span_dict(self._spans.popleft()))
            except IndexError:
                break
        if self._overflowed:
            self._overflowed = False
            _monitor.stat_add("telemetry.dropped_batches")
            # the drop counters themselves are counters and ship on the
            # NEXT flush's delta — nothing special needed here
        payload = {"member": self.member_id, "role": self.role,
                   "pid": os.getpid(), "counters": counters,
                   "gauges": gauges,
                   "hists": dict(snap.get("histograms", {})),
                   "spans": spans}
        return payload, cum

    def flush(self):
        """Ship one batch (or re-ship the pending un-acked one).
        Returns True when the hub acked, False when it is unreachable
        (state kept; next flush retries with the same replay key)."""
        with self._flush_lock:
            if self._pending is None:
                payload, cum = self._collect()
                self._seq += 1
                self._pending = (self._seq, payload, cum)
            key, payload, cum = self._pending
            try:
                reply = self._ensure_conn().call("telemetry_ship",
                                                 _mutating=True, _key=key,
                                                 **payload)
            except Exception:
                return False
            self._pending = None
            self._last_acked = cum
        incident = (reply or {}).get("incident")
        if incident:
            self._join_incident(incident["id"], incident["reason"])
        return True

    def drain(self, timeout=10.0):
        """Flush until nothing unshipped remains (pending acked, no
        counter delta, span buffer empty). Used for final accounting:
        after drain() the hub's per-member totals equal this process's
        stats() bitwise. Returns True on success."""
        deadline = self._clock() + timeout
        while True:
            ok = False
            try:
                ok = self.flush()
            except Exception:
                pass
            if ok and self._pending is None and not self._spans:
                cum = self._counter_cum(self._snapshot())
                if all(cum.get(n, 0.0) == self._last_acked.get(n, 0.0)
                       for n in cum):
                    return True
            if self._clock() >= deadline:
                return False
            time.sleep(min(0.05, self._flush_s))

    def shipped_totals(self):
        """Cumulative counter totals the hub has acked for this member."""
        with self._flush_lock:
            return dict(self._last_acked)

    # ------------------------------------------------------------ incidents
    def _on_dump_trigger(self, reason, exc, incident_id):
        """flight_recorder dump listener: a locally-originated failure
        (incident_id None) is reported to the hub off-thread — the
        failure path must not block on the network."""
        if incident_id is not None:
            return
        threading.Thread(target=self._report_trigger, args=(reason,),
                         daemon=True).start()

    def _report_trigger(self, reason):
        try:
            reply = self._ensure_conn().call("telemetry_incident",
                                             member=self.member_id,
                                             reason=reason, role=self.role,
                                             pid=os.getpid())
            iid = (reply or {}).get("incident_id")
            if iid:
                self._join_incident(iid, reason)
        except Exception:
            pass

    def _join_incident(self, incident_id, reason):
        """Dump locally under the incident id and ship the record into
        the merged incident file. Idempotent per incident."""
        if incident_id in self._seen_incidents:
            return
        self._seen_incidents.add(incident_id)
        try:
            _fr.dump(f"incident_{reason}".replace("/", "_"),
                     incident_id=incident_id)
            record = _fr.record(reason, incident_id=incident_id)
            self._ensure_conn().call("telemetry_incident_dump",
                                     member=self.member_id,
                                     incident_id=incident_id,
                                     record=record)
        except Exception:
            pass


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def fetch_snapshot(endpoint=None, timeout=5.0):
    """One-shot aggregated hub snapshot.
    Raises on an unreachable hub — callers own their degrade policy."""
    rpc = _rpc()
    endpoint = endpoint or _flag("PADDLE_TELEMETRY_HUB")
    conn = rpc.Connection(endpoint, timeout=timeout, max_retries=0,
                          connect_retry_s=timeout, quiet=True)
    try:
        return conn.call("telemetry_snapshot")
    finally:
        conn.close()


def stitch_incident(incident):
    """Cross-process trace chains in a merged incident dump: for every
    trace id seen in >= 2 member records, the members it crossed (in
    first-span time order) and the span names involved. This is what
    proves a serve->primary->backup flow is ONE story."""
    by_trace = {}
    for member, record in (incident.get("members") or {}).items():
        role = (record or {}).get("role", "")
        pid = (record or {}).get("pid")
        for s in (record or {}).get("spans") or ():
            tid = s.get("trace_id")
            if not tid:
                continue
            ent = by_trace.setdefault(tid, {})
            cur = ent.get(member)
            if cur is None:
                cur = ent[member] = {
                    "member": member, "role": role, "pid": pid,
                    "first_ts_us": s.get("ts_us", 0), "spans": 0,
                    "names": set()}
            cur["first_ts_us"] = min(cur["first_ts_us"],
                                     s.get("ts_us", 0))
            cur["spans"] += 1
            cur["names"].add(s.get("name"))
    chains = []
    for tid, members in by_trace.items():
        if len(members) < 2:
            continue
        hops = sorted(members.values(),
                      key=lambda m: m["first_ts_us"])
        chains.append({
            "trace_id": tid,
            "members": [m["member"] for m in hops],
            "roles": [m["role"] for m in hops],
            "pids": [m["pid"] for m in hops],
            "span_names": sorted(set().union(*(m["names"]
                                               for m in hops))),
            "spans": sum(m["spans"] for m in hops)})
    chains.sort(key=lambda c: (-len(c["members"]), -c["spans"]))
    return chains
