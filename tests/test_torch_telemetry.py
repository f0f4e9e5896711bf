"""Cluster telemetry on the port (paddle_tpu_torch/core/telemetry.py,
``traffic/harness.run_spec(hub=...)``) against paddle_tpu/core/telemetry.py.

Parity, exact: a port shipper against the JAX package's hub and a JAX
shipper against the port's hub give the same merged counters, gauges and
histograms as a JAX pair, bitwise; ``stitch_incident`` gives the JAX
package's chains on one merged incident.

The port's own proofs, exact: with the DEFAULT snapshot function (the
real monitor registry), the hub's counters for a member equal the local
monitor's, bitwise, for every shipped name, after real PS work under
RESET / DROP chaos; a hub stopped mid-session makes ``flush()`` return
False (never raise); ``run_spec(hub=...)`` is scored by the hub with the
serve counters the local monitor counted. Then tests/test_telemetry.py's
cases on the port (exactly-once counters through dropped and reset
replies, last-wins gauges, union-exact histogram merge, span
backpressure, the incident protocol, ``fetch_snapshot``).
"""
import copy
import json
import os
import time

import numpy as np
import pytest

from paddle_tpu.core import telemetry as jtelemetry
from paddle_tpu_torch.core import flight_recorder, monitor, telemetry, trace
from paddle_tpu_torch.core.monitor import _Hist
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _cpu_and_no_leftover_injector():
    with device_scope("cpu"):
        yield
    faults.uninstall()


FAST_RPC = dict(timeout=0.5, max_retries=3, backoff_base=0.01,
                backoff_max=0.05, connect_retry_s=1.0)


class _Registry:
    """A fake per-process monitor registry the shipper snapshots."""

    def __init__(self):
        self.values = {}
        self.types = {}
        self.hists = {}

    def counter(self, name, v):
        self.values[name] = self.values.get(name, 0.0) + v
        self.types[name] = "counter"

    def gauge(self, name, v):
        self.values[name] = v
        self.types[name] = "gauge"

    def hist(self, name, summary):
        self.hists[name] = summary
        self.types[name] = "histogram"

    def snapshot(self):
        return copy.deepcopy({"values": self.values, "types": self.types,
                              "histograms": self.hists})


@pytest.fixture
def hub(tmp_path):
    h = telemetry.TelemetryHub(dump_dir=str(tmp_path),
                               incident_window_s=10.0)
    yield h
    h.stop()


def _shipper(hub, member, reg, **kw):
    kw.setdefault("rpc_opts", FAST_RPC)
    kw.setdefault("capture_spans", False)
    kw.setdefault("report_incidents", False)
    return telemetry.TelemetryShipper(
        hub.endpoint, member_id=member, snapshot_fn=reg.snapshot, **kw)


def test_counters_exactly_once_through_drop_and_reset(hub):
    reg = _Registry()
    s = _shipper(hub, "m1", reg, role="worker")
    try:
        reg.counter("c", 5.0)
        # the applied-but-reply-lost case replay keys exist for: the hub
        # applies the delta, the reply is DROPPED, the retried shipment
        # must be a replay (NOT a re-add)
        with faults.inject(faults.Fault("server", "reply", faults.DROP,
                                        method="telemetry_ship",
                                        times=1)) as inj:
            s.flush()
            assert inj.fired(faults.DROP) == 1
        assert hub.member_counters("m1") == {"c": 5.0}
        # connection torn down mid-exchange: the reconnect retry carries
        # the same replay key
        reg.counter("c", 4.0)
        with faults.inject(faults.Fault("server", "reply", faults.RESET,
                                        method="telemetry_ship",
                                        times=1)) as inj:
            s.flush()
            assert inj.fired(faults.RESET) == 1
        assert hub.member_counters("m1") == {"c": 9.0}
        assert hub.snapshot()["counters"] == {"c": 9.0}
        # nothing new: a flush ships nothing and totals stand
        s.flush()
        assert hub.snapshot()["counters"] == {"c": 9.0}
        assert s.shipped_totals()["c"] == 9.0
    finally:
        s.close(drain_timeout=2.0)


def test_gauges_last_wins_and_multi_member_counter_sum(hub):
    ra, rb = _Registry(), _Registry()
    sa = _shipper(hub, "a", ra)
    sb = _shipper(hub, "b", rb)
    try:
        ra.gauge("depth", 3.0)
        ra.counter("n", 2.0)
        sa.flush()
        ra.gauge("depth", 7.0)
        ra.counter("n", 1.0)
        sa.flush()
        rb.counter("n", 10.0)
        sb.flush()
        snap = hub.snapshot()
        assert snap["gauges"]["depth"] == 7.0         # last wins
        assert snap["counters"]["n"] == 13.0          # sum of members
        assert hub.member_counters("a") == {"n": 3.0}
        assert hub.member_counters("b") == {"n": 10.0}
    finally:
        sa.close(drain_timeout=2.0)
        sb.close(drain_timeout=2.0)


def test_hist_merge_across_members_equals_union_stream(hub):
    import numpy as np
    rng = np.random.RandomState(5)
    xs_a = list(rng.uniform(0, 50, 80))
    xs_b = list(rng.uniform(0, 50, 33))
    bounds = (1.0, 5.0, 25.0)

    def _summary(xs):
        h = _Hist(bounds)
        for v in xs:
            h.observe(v)
        return h.summary()

    ra, rb = _Registry(), _Registry()
    ra.hist("lat_ms", _summary(xs_a))
    rb.hist("lat_ms", _summary(xs_b))
    sa = _shipper(hub, "a", ra)
    sb = _shipper(hub, "b", rb)
    try:
        sa.flush()
        sb.flush()
        merged = hub.snapshot()["hists"]["lat_ms"]
        union = _summary(xs_a + xs_b)
        assert merged["buckets"] == union["buckets"]
        assert merged["bounds"] == union["bounds"]
        assert merged["count"] == union["count"]
        assert merged["sum"] == pytest.approx(union["sum"])
    finally:
        sa.close(drain_timeout=2.0)
        sb.close(drain_timeout=2.0)


def test_span_backpressure_never_blocks_and_counts_drops():
    # a DEAD hub: nothing listens on the endpoint. The span sink (the
    # hot-path side) must stay O(1) append/shed; the flush side fails
    # without the sink ever waiting on it.
    reg = _Registry()
    before = monitor.stats("telemetry.")
    s = telemetry.TelemetryShipper(
        "127.0.0.1:9", member_id="dead", snapshot_fn=reg.snapshot,
        span_buffer=8, rpc_opts=dict(timeout=0.2, max_retries=0,
                                     backoff_base=0.01, backoff_max=0.02,
                                     connect_retry_s=0.2,
                                     fail_fast_refused=True),
        report_incidents=False)
    try:
        # 500 spans through a full buffer against a dead hub: the sink
        # sheds them (counted below) instead of waiting on the hub
        for i in range(500):
            with trace.span("unit/backpressure", i=i):
                pass
        reg.counter("c", 1.0)
        # the flush side reports unreachable (the lazy dial fails) —
        # never raises out of a member's beat thread
        assert s.flush() is False
        after = monitor.stats("telemetry.")
        dropped = (after.get("telemetry.dropped_spans", 0)
                   - before.get("telemetry.dropped_spans", 0))
        batches = (after.get("telemetry.dropped_batches", 0)
                   - before.get("telemetry.dropped_batches", 0))
        assert dropped >= 490          # cap 8, the rest shed
        assert batches >= 1            # the affected flush is counted
    finally:
        try:
            s.close(drain_timeout=0.5)
        except Exception:
            pass                       # the hub is dead by design


def test_incident_trigger_joins_and_merges(hub, tmp_path, monkeypatch):
    monkeypatch.setattr(flight_recorder, "dump_dir", lambda: None)
    reg = _Registry()
    s = telemetry.TelemetryShipper(
        hub.endpoint, member_id="w1", role="trainer", peers=["w1"],
        snapshot_fn=reg.snapshot, flush_s=0.05, rpc_opts=FAST_RPC,
        capture_spans=True, report_incidents=True).start()
    try:
        with trace.span("unit/incident_span"):
            pass
        flight_recorder.dump("unit_incident_trigger")
        deadline = time.time() + 10.0
        while time.time() < deadline and not hub.incidents():
            time.sleep(0.05)
        incs = hub.incidents()
        assert len(incs) == 1
        iid = next(iter(incs))
        assert incs[iid]["reason"] == "unit_incident_trigger"
        # a second trigger inside the window JOINS instead of opening
        flight_recorder.dump("unit_incident_second")
        time.sleep(0.3)
        assert len(hub.incidents()) == 1
        # the member's schema-v2 record lands in the merged dump
        path = os.path.join(str(tmp_path), f"incident_{iid}.json")
        deadline = time.time() + 10.0
        rec = None
        while time.time() < deadline:
            with open(path) as f:
                inc = json.load(f)
            rec = inc["members"].get("w1")
            if rec:
                break
            time.sleep(0.05)
        assert rec, f"member record never attached: {inc['members']}"
        assert inc["schema"] == telemetry.INCIDENT_SCHEMA
        assert rec["schema"] == flight_recorder.SCHEMA_VERSION
        assert rec["incident_id"] == iid
        assert rec["role"] == "trainer"
        assert any(sp["name"] == "unit/incident_span"
                   for sp in rec["spans"])
        assert "w1" in incs[iid]["triggers"]
    finally:
        s.close(drain_timeout=2.0)
        flight_recorder.set_identity(role="", peers=[])


def test_fetch_snapshot(hub):
    reg = _Registry()
    reg.counter("k", 3.0)
    s = _shipper(hub, "f1", reg)
    try:
        s.flush()
        snap = telemetry.fetch_snapshot(hub.endpoint)
        assert snap["counters"] == {"k": 3.0}
        assert "f1" in snap["members"]
    finally:
        s.close(drain_timeout=2.0)
    with pytest.raises(Exception):
        telemetry.fetch_snapshot("127.0.0.1:9", timeout=0.3)



# ---------------------------------------------- parity with the JAX package

TELE = {"jax": jtelemetry, "port": telemetry}


def _script(reg):
    """A member's metric history, applied between flushes."""
    bounds = (1.0, 5.0, 25.0)
    rng = np.random.RandomState(9)
    steps = []
    for k in range(3):
        def step(k=k):
            reg.counter("ps.rpc.retries", float(k + 1))
            reg.counter("serve.tokens_generated", 10.0 * k + 0.5)
            reg.gauge("depth", float(7 - k))
            h = _Hist(bounds)
            for v in rng.uniform(0, 40, 20 + k):
                h.observe(float(v))
            reg.hist("lat_ms", h.summary())
        steps.append(step)
    return steps


def _tele_run(hub_pkg, ship_pkg):
    hub = TELE[hub_pkg].TelemetryHub()
    regs = [_Registry(), _Registry()]
    ships = [TELE[ship_pkg].TelemetryShipper(
        hub.endpoint, member_id=f"m{i}", snapshot_fn=r.snapshot,
        rpc_opts=FAST_RPC, capture_spans=False, report_incidents=False)
        for i, r in enumerate(regs)]
    try:
        for steps in zip(*(_script(r) for r in regs)):
            for step, s in zip(steps, ships):
                step()
                s.flush()
        snap = hub.snapshot()
        return ({k: snap[k] for k in ("counters", "gauges", "hists")},
                [hub.member_counters(f"m{i}") for i in range(2)])
    finally:
        for s in ships:
            s.close(drain_timeout=2.0)
        hub.stop()


@pytest.mark.parametrize("hub_pkg,ship_pkg", [("jax", "port"),
                                              ("port", "jax"),
                                              ("port", "port")])
def test_cross_package_hub_and_shipper_merge_as_jax(hub_pkg, ship_pkg):
    want = _tele_run("jax", "jax")
    got = _tele_run(hub_pkg, ship_pkg)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_stitch_incident_equals_jax():
    def span(tid, ts, name):
        return {"trace_id": tid, "ts_us": ts, "name": name}
    inc = {"members": {
        "client": {"role": "trainer", "pid": 1,
                   "spans": [span("t1", 5, "ps.rpc/push_sparse_grad"),
                             span("t2", 9, "ps.rpc/pull_sparse")]},
        "ps0": {"role": "ps", "pid": 2,
                "spans": [span("t1", 7, "ps.server/push_sparse_grad"),
                          span("t2", 11, "ps.server/pull_sparse")]},
        "ps1": {"role": "ps", "pid": 3,
                "spans": [span("t1", 8, "ps.server/replica_forward")]}}}
    assert telemetry.stitch_incident(inc) == \
        jtelemetry.stitch_incident(inc)
    assert telemetry.stitch_incident(inc)[0]["members"] == \
        ["client", "ps0", "ps1"]


# ----------------------------------- the real monitor, bitwise, the port

def test_default_snapshot_counters_bitwise_and_dead_hub_degrades():
    """Real PS work under chaos, shipped with the DEFAULT snapshot
    function: the hub's totals for the member equal the local monitor's
    bitwise for every shipped name; stopping the hub mid-session makes
    flush() return False instead of raising."""
    from paddle_tpu_torch.distributed.ps import PSClient, PSServer
    hub = telemetry.TelemetryHub()
    srv = PSServer(tables={"emb": {"type": "sparse", "dim": 4,
                                   "optimizer": "sgd", "lr": 1.0,
                                   "init": "zeros"}})
    client = PSClient([srv.start()], timeout=5.0, max_retries=5,
                      backoff_base=0.01, backoff_max=0.05)
    ship = telemetry.TelemetryShipper(hub.endpoint, member_id="worker",
                                      role="trainer", rpc_opts=FAST_RPC,
                                      capture_spans=False,
                                      report_incidents=False)
    try:
        fired = 0
        for rnd in range(4):
            with faults.inject(seed=3 + rnd, p={faults.RESET: 0.02,
                                                faults.DROP: 0.02}) as inj:
                for step in range(5):
                    ids = np.arange(step, step + 4, dtype=np.int64)
                    client.pull_sparse("emb", ids)
                    client.push_sparse_grad("emb", ids,
                                            np.ones((4, 4), np.float32))
                    monitor.stat_add("unit.steps")
            fired += inj.fired()
            assert ship.flush() is True
        assert fired >= 1, "the seeds injected nothing"
        local = monitor.stats("")
        got = hub.member_counters("worker")
        shipped = ship.shipped_totals()
        assert got and shipped
        for name, v in got.items():
            assert v == local[name] == shipped[name], name
        assert got["unit.steps"] == 20.0
        hub.stop()                        # the hub dies mid-session
        monitor.stat_add("unit.steps")
        assert ship.flush() is False      # degrade, never raise
    finally:
        ship.close(drain_timeout=0.5)
        client.close()
        srv.shutdown()
        hub.stop()


def test_run_spec_scored_by_the_hub():
    from paddle_tpu_torch.traffic import harness, workload
    hub = telemetry.TelemetryHub()
    try:
        rep = harness.run_spec(workload.builtin_spec("steady",
                                                     duration_s=1.0),
                               seed=0, time_scale=0.05, clients=2, hub=hub)
        snap = hub.snapshot()
    finally:
        hub.stop()
    assert rep.scored_by == "hub"
    assert rep.completed == rep.events > 0 and rep.errors == 0
    assert snap["counters"]["serve.requests_completed"] == \
        monitor.stat_get("serve.requests_completed") == rep.completed
    assert rep.ttft_ms["p50"] is not None
    assert rep.ttft_ms["p99"] >= rep.ttft_ms["p50"]
