"""Process-wide runtime metrics: counters, gauges, histograms and time
series (paddle_tpu/core/monitor.py, whole).

- **Counters / gauges**: ``stat_add`` / ``stat_set`` / ``stats()``. A
  counter is a name first touched by ``stat_add``, a gauge one first
  touched by ``stat_set``; the kind matters only to the Prometheus
  export.
- **Time series**: every write appends ``(unix_time, value)`` to a
  bounded ring per name (``FLAGS_monitor_series_len``).
- **Histograms**: ``observe(name, v)`` records count / sum / min / max
  and cumulative buckets; ``ensure_hist`` fixes a histogram's bounds
  before its first observation (the traffic harness's fine TTFT and
  token buckets).
- **Export**: ``snapshot()``, ``export_jsonl()`` (one JSON line per
  metric) and ``prometheus_text()`` (the text exposition format).

One lock guards every structure, and ``reset(prefix=...)`` clears values,
types, series and histograms in one critical section, so a concurrent
writer sees either the old world or the new one, never a value without
its series.
"""
from __future__ import annotations

import json
import re
import threading
import time
from collections import defaultdict, deque

from . import flags as _flags

__all__ = ["stat_add", "stat_set", "stat_set_many", "stat_get", "stats",
           "reset", "observe", "ensure_hist", "counter", "gauge",
           "histogram", "series", "histogram_summary", "snapshot",
           "export_jsonl", "prometheus_text", "DEFAULT_BUCKETS",
           "Counter", "Gauge", "Histogram"]

_lock = threading.Lock()
_stats = defaultdict(float)
_types: dict = {}      # name -> "counter" | "gauge" | "histogram"
_series: dict = {}     # name -> deque[(unix_ts, value)]
_hists: dict = {}      # name -> _Hist

# Latency-ish spread in ms; callers with other units pass explicit buckets.
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def _series_len():
    return max(1, int(_flags.flag("FLAGS_monitor_series_len")))


def _sample_locked(name, value):
    s = _series.get(name)
    if s is None:
        s = _series[name] = deque(maxlen=_series_len())
    s.append((time.time(), float(value)))


class _Hist:
    __slots__ = ("count", "sum", "mn", "mx", "bounds", "buckets")

    def __init__(self, bounds):
        self.bounds = tuple(sorted(float(b) for b in bounds))
        self.buckets = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.mn = float("inf")
        self.mx = float("-inf")

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.sum += v
        self.mn = min(self.mn, v)
        self.mx = max(self.mx, v)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.buckets[i] += 1
                return
        self.buckets[-1] += 1

    def summary(self):
        return {"count": self.count, "sum": self.sum,
                "min": self.mn if self.count else 0.0,
                "max": self.mx if self.count else 0.0,
                "avg": (self.sum / self.count) if self.count else 0.0,
                "bounds": list(self.bounds), "buckets": list(self.buckets)}


# -- writers (back-compat surface) -------------------------------------------

def stat_add(name: str, value=1):
    """STAT_ADD analog (reference monitor.h:130)."""
    with _lock:
        _stats[name] += value
        _types.setdefault(name, "counter")
        _sample_locked(name, _stats[name])


def stat_set(name: str, value):
    with _lock:
        _stats[name] = value
        _types.setdefault(name, "gauge")
        _sample_locked(name, value)


def stat_set_many(values: dict):
    """Set a group of gauges atomically (one lock round-trip) — e.g. the
    spmd.{collective_bytes,hbm_estimate,resharding_count} trio published
    by static/spmd_analyzer.py SpmdReport.publish()."""
    with _lock:
        for name, value in values.items():
            _stats[name] = value
            _types.setdefault(name, "gauge")
            _sample_locked(name, value)


def observe(name: str, value, buckets=None):
    """One histogram observation (also sampled into the time series)."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = _Hist(buckets or DEFAULT_BUCKETS)
            _types.setdefault(name, "histogram")
        h.observe(value)
        _sample_locked(name, value)


def ensure_hist(name: str, buckets):
    """Pre-register a histogram with explicit bucket bounds. A histogram's
    bounds are fixed by whoever observes it first; latency consumers that
    need finer resolution than DEFAULT_BUCKETS (the traffic harness scores
    serve/ttft_ms against a ±25% error band) register theirs up front,
    before the serving path's first `observe` wins with the defaults."""
    with _lock:
        if name not in _hists:
            _hists[name] = _Hist(buckets)
            _types.setdefault(name, "histogram")


# -- readers -----------------------------------------------------------------

def stat_get(name: str):
    with _lock:
        return _stats.get(name, 0)


def stats(prefix: str = None) -> dict:
    """Snapshot all counters/gauges (histograms surface as
    `{name}.count/.sum/.min/.max/.avg`); `prefix` filters to one
    subsystem (e.g. stats("ps.rpc.") for the PS transport health
    counters)."""
    with _lock:
        out = dict(_stats)
        for name, h in _hists.items():
            s = h.summary()
            for k in ("count", "sum", "min", "max", "avg"):
                out[f"{name}.{k}"] = s[k]
    if prefix is None:
        return out
    return {k: v for k, v in out.items() if k.startswith(prefix)}


def series(name: str):
    """[(unix_ts, value), ...] ring for one metric (newest last)."""
    with _lock:
        s = _series.get(name)
        return list(s) if s else []


def histogram_summary(name: str):
    with _lock:
        h = _hists.get(name)
        return h.summary() if h else None


def snapshot(include_series: bool = True) -> dict:
    """One consistent structured snapshot of everything — the flight
    recorder's `metrics` section and bench's per-mode metrics line."""
    with _lock:
        out = {"values": dict(_stats),
               "types": dict(_types),
               "histograms": {n: h.summary() for n, h in _hists.items()}}
        if include_series:
            out["series"] = {n: [list(p) for p in s]
                             for n, s in _series.items() if s}
    return out


# -- reset -------------------------------------------------------------------

def reset(name: str = None, prefix: str = None):
    """Drop one counter, every counter under a prefix (e.g.
    reset(prefix="pallas.") between bench modes), or everything.
    Values, types, series, and histograms are cleared in ONE critical
    section, so a concurrent writer observes either the fully-old or the
    fully-new world — never a value without its series or vice versa."""
    with _lock:
        if prefix is not None:
            for store in (_stats, _types, _series, _hists):
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]
        elif name is None:
            _stats.clear()
            _types.clear()
            _series.clear()
            _hists.clear()
        else:
            for store in (_stats, _types, _series, _hists):
                store.pop(name, None)


# -- typed handles -----------------------------------------------------------

class Counter:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name
        with _lock:
            _types.setdefault(name, "counter")

    def add(self, value=1):
        stat_add(self.name, value)

    def value(self):
        return stat_get(self.name)


class Gauge:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name
        with _lock:
            _types.setdefault(name, "gauge")

    def set(self, value):
        stat_set(self.name, value)

    def value(self):
        return stat_get(self.name)


class Histogram:
    __slots__ = ("name", "buckets")

    def __init__(self, name, buckets=None):
        self.name = name
        self.buckets = buckets

    def observe(self, value):
        observe(self.name, value, buckets=self.buckets)

    def summary(self):
        return histogram_summary(self.name)


def counter(name) -> Counter:
    return Counter(name)


def gauge(name) -> Gauge:
    return Gauge(name)


def histogram(name, buckets=None) -> Histogram:
    return Histogram(name, buckets)


# -- export ------------------------------------------------------------------

def export_jsonl(path_or_file, include_series: bool = True):
    """One JSON line per metric: {"name", "type", "value" | histogram
    aggregates, "series": [[ts, v], ...]}. Tailable by any dashboard."""
    snap = snapshot(include_series=include_series)
    own = isinstance(path_or_file, str)
    f = open(path_or_file, "w") if own else path_or_file
    try:
        names = set(snap["values"]) | set(snap["histograms"])
        for name in sorted(names):
            rec = {"name": name,
                   "type": snap["types"].get(name, "gauge")}
            if name in snap["histograms"]:
                rec["histogram"] = snap["histograms"][name]
            else:
                rec["value"] = snap["values"][name]
            if include_series and name in snap.get("series", {}):
                rec["series"] = snap["series"][name]
            f.write(json.dumps(rec) + "\n")
    finally:
        if own:
            f.close()


def _prom_name(name: str) -> str:
    n = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return n if re.match(r"[a-zA-Z_:]", n) else "_" + n


def prometheus_text() -> str:
    """Prometheus text exposition format (counters/gauges/histograms)."""
    snap = snapshot(include_series=False)
    lines = []
    for name in sorted(snap["values"]):
        pn = _prom_name(name)
        kind = snap["types"].get(name, "gauge")
        lines.append(f"# TYPE {pn} {kind}")
        lines.append(f"{pn} {snap['values'][name]}")
    for name in sorted(snap["histograms"]):
        pn = _prom_name(name)
        h = snap["histograms"][name]
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for bound, cnt in zip(h["bounds"], h["buckets"]):
            cum += cnt
            lines.append(f'{pn}_bucket{{le="{bound}"}} {cum}')
        cum += h["buckets"][-1]
        lines.append(f'{pn}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{pn}_sum {h['sum']}")
        lines.append(f"{pn}_count {h['count']}")
    return "\n".join(lines) + "\n"
