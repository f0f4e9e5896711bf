"""Port parity: the metrics registry (paddle_tpu_torch/core/monitor.py)
against paddle_tpu/core/monitor.py.

tests/test_monitor_metrics.py's cases run on both packages (the ``mon``
fixture), and one script of writes goes through both registries: the
Prometheus text must be equal, and the JSONL export equal but for the
series' timestamps.
"""
import json
import threading

import pytest

import paddle_tpu as jpaddle
from paddle_tpu.core import monitor as jmonitor
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import monitor as tmonitor

PKGS = {"jax": (jmonitor, jpaddle.get_flags, jpaddle.set_flags),
        "port": (tmonitor, tflags.get_flags, tflags.set_flags)}


@pytest.fixture(params=list(PKGS))
def mon(request):
    m, get_flags, set_flags = PKGS[request.param]
    m.reset(prefix="tm.")
    yield m, get_flags, set_flags
    m.reset(prefix="tm.")


def test_legacy_surface_unchanged(mon):
    monitor = mon[0]
    monitor.stat_add("tm.c")
    monitor.stat_add("tm.c", 2)
    monitor.stat_set("tm.g", 7.5)
    monitor.stat_set_many({"tm.a": 1, "tm.b": 2})
    assert monitor.stat_get("tm.c") == 3
    assert monitor.stat_get("tm.missing") == 0
    s = monitor.stats("tm.")
    assert s["tm.c"] == 3 and s["tm.g"] == 7.5 and s["tm.a"] == 1
    monitor.reset(name="tm.c")
    assert monitor.stat_get("tm.c") == 0
    assert "tm.c" not in monitor.stats("tm.")


def test_time_series_bounded_and_ordered(mon):
    monitor, get_flags, set_flags = mon
    saved = get_flags(["FLAGS_monitor_series_len"])
    set_flags({"FLAGS_monitor_series_len": 5})
    try:
        for _ in range(12):
            monitor.stat_add("tm.ser")
        ser = monitor.series("tm.ser")
        assert len(ser) == 5
        assert [v for _, v in ser] == [8.0, 9.0, 10.0, 11.0, 12.0]
        ts = [t for t, _ in ser]
        assert ts == sorted(ts)
    finally:
        set_flags(saved)


def test_histogram_observe_and_summary(mon):
    monitor = mon[0]
    h = monitor.histogram("tm.lat", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    s = monitor.histogram_summary("tm.lat")
    assert s["count"] == 4
    assert s["sum"] == pytest.approx(555.5)
    assert s["min"] == 0.5 and s["max"] == 500.0
    assert s["buckets"] == [1, 1, 1, 1]
    flat = monitor.stats("tm.lat")
    assert flat["tm.lat.count"] == 4
    assert flat["tm.lat.avg"] == pytest.approx(555.5 / 4)


def test_ensure_hist_fixes_the_bounds_before_the_first_observe(mon):
    monitor = mon[0]
    monitor.ensure_hist("tm.fine", (1.0, 2.0))
    monitor.observe("tm.fine", 1.5)          # default buckets lose
    assert monitor.histogram_summary("tm.fine")["bounds"] == [1.0, 2.0]
    monitor.ensure_hist("tm.fine", (5.0,))   # a second call keeps them
    assert monitor.histogram_summary("tm.fine")["buckets"] == [0, 1, 0]


def test_typed_handles(mon):
    monitor = mon[0]
    c = monitor.counter("tm.h.c")
    g = monitor.gauge("tm.h.g")
    c.add()
    c.add(4)
    g.set(2.5)
    assert c.value() == 5 and g.value() == 2.5
    snap = monitor.snapshot()
    assert snap["types"]["tm.h.c"] == "counter"
    assert snap["types"]["tm.h.g"] == "gauge"


def test_export_jsonl_and_prometheus(mon, tmp_path):
    monitor = mon[0]
    monitor.stat_add("tm.exp.count", 3)
    monitor.stat_set("tm.exp.gauge", 1.5)
    monitor.observe("tm.exp.hist", 2.0, buckets=(1.0, 10.0))
    path = str(tmp_path / "metrics.jsonl")
    monitor.export_jsonl(path)
    recs = {r["name"]: r for r in map(json.loads, open(path))}
    assert recs["tm.exp.count"]["value"] == 3
    assert recs["tm.exp.count"]["type"] == "counter"
    assert recs["tm.exp.count"]["series"]
    assert recs["tm.exp.hist"]["histogram"]["count"] == 1
    text = monitor.prometheus_text()
    assert "# TYPE tm_exp_count counter" in text
    assert "tm_exp_gauge 1.5" in text
    assert 'tm_exp_hist_bucket{le="10.0"} 1' in text
    assert 'tm_exp_hist_bucket{le="+Inf"} 1' in text
    assert "tm_exp_hist_count 1" in text


def test_snapshot_consistent_under_lock(mon):
    monitor = mon[0]
    monitor.stat_add("tm.snap", 2)
    snap = monitor.snapshot()
    assert snap["values"]["tm.snap"] == 2
    assert snap["series"]["tm.snap"][-1][1] == 2.0


def test_prefix_reset_atomic_with_racing_writers(mon):
    """reset(prefix=...) clears value, series and histogram in one
    critical section: a snapshot never shows a fresh value carrying a
    stale series."""
    monitor = mon[0]
    stop = threading.Event()
    errors = []

    def writer():
        while not stop.is_set():
            monitor.stat_add("tm.race.c")
            monitor.observe("tm.race.h", 1.0, buckets=(10.0,))

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            monitor.reset(prefix="tm.race.")
            snap = monitor.snapshot()
            val = snap["values"].get("tm.race.c")
            ser = snap.get("series", {}).get("tm.race.c", [])
            if val is not None and ser:
                if ser[-1][1] != val or max(v for _, v in ser) > val:
                    errors.append((val, ser[-3:]))
            hist = snap["histograms"].get("tm.race.h")
            hser = snap.get("series", {}).get("tm.race.h", [])
            if hist is not None and len(hser) > hist["count"]:
                errors.append(("hist", hist["count"], len(hser)))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, f"non-atomic prefix reset observed: {errors[:3]}"
    monitor.reset(prefix="tm.race.")
    assert monitor.stats("tm.race.") == {}
    assert monitor.series("tm.race.c") == []
    assert monitor.histogram_summary("tm.race.h") is None


def _script(monitor):
    """One script of writes of every kind."""
    monitor.stat_add("tm.s.req", 3)
    monitor.stat_add("tm.s.req")
    monitor.stat_set("tm.s.depth", 7)
    monitor.stat_set_many({"tm.s.a": 1.5, "tm.s.b": -2})
    monitor.counter("tm.s.typed").add(5)
    monitor.gauge("tm.s.level").set(0.25)
    for v in (0.05, 0.3, 4.0, 12.0, 700.0, 20000.0):
        monitor.observe("tm.s.lat", v)
    h = monitor.histogram("tm.s.fine", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 9.0):
        h.observe(v)
    monitor.ensure_hist("tm.s.pre", (10.0, 100.0))
    monitor.observe("tm.s.pre", 50.0)


def _only(text, prefix="tm_s_"):
    return "\n".join(ln for ln in text.splitlines()
                     if prefix in ln) + "\n"


def test_one_script_of_writes_exports_as_jax(tmp_path):
    out = {}
    for name, (monitor, _g, _s) in PKGS.items():
        monitor.reset(prefix="tm.")
        try:
            _script(monitor)
            path = str(tmp_path / f"{name}.jsonl")
            monitor.export_jsonl(path)
            recs = [r for r in map(json.loads, open(path))
                    if r["name"].startswith("tm.s.")]
            for r in recs:    # the trajectory's values, not its clock
                r["series"] = [v for _, v in r.get("series", [])]
            out[name] = (_only(monitor.prometheus_text()), recs,
                         monitor.stats("tm.s."),
                         monitor.snapshot(include_series=False))
        finally:
            monitor.reset(prefix="tm.")
    jax_text, jax_recs, jax_stats, jax_snap = out["jax"]
    port_text, port_recs, port_stats, port_snap = out["port"]
    assert port_text == jax_text
    assert port_recs == jax_recs
    assert port_stats == jax_stats
    keep = lambda d: {k: v for k, v in d.items()  # noqa: E731
                      if k.startswith("tm.s.")}
    for part in ("values", "types", "histograms"):
        assert keep(port_snap[part]) == keep(jax_snap[part])
