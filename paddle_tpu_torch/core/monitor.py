"""Process-wide runtime metrics: counters, gauges and histograms.

The subset of paddle_tpu/core/monitor.py that serving uses, under the
same names: ``stat_add`` / ``stat_set_many`` / ``stat_get`` / ``stats`` /
``reset`` and ``observe`` for histograms (count/sum/min/max plus
cumulative buckets). One lock guards every structure, so ``reset`` clears
values and histograms in one critical section and a concurrent writer
sees either the old world or the new one.
"""
from __future__ import annotations

import threading
from collections import defaultdict

__all__ = ["stat_add", "stat_set_many", "stat_get", "stats", "reset",
           "observe", "histogram_summary", "DEFAULT_BUCKETS"]

_lock = threading.Lock()
_stats = defaultdict(float)
_hists: dict = {}      # name -> _Hist

# Latency-ish spread in ms.
DEFAULT_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


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


def stat_add(name: str, value=1):
    with _lock:
        _stats[name] += value


def stat_set_many(values: dict):
    """Set a group of gauges in one lock round-trip."""
    with _lock:
        for name, value in values.items():
            _stats[name] = value


def observe(name: str, value):
    """One histogram observation (DEFAULT_BUCKETS bounds)."""
    with _lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = _Hist(DEFAULT_BUCKETS)
        h.observe(value)


def stat_get(name: str):
    with _lock:
        return _stats.get(name, 0)


def stats(prefix: str = None) -> dict:
    """Snapshot of counters and gauges (histograms surface as
    ``{name}.count/.sum/.min/.max/.avg``), filtered to ``prefix``."""
    with _lock:
        out = dict(_stats)
        for name, h in _hists.items():
            s = h.summary()
            for k in ("count", "sum", "min", "max", "avg"):
                out[f"{name}.{k}"] = s[k]
    if prefix is None:
        return out
    return {k: v for k, v in out.items() if k.startswith(prefix)}


def histogram_summary(name: str):
    with _lock:
        h = _hists.get(name)
        return h.summary() if h else None


def reset(name: str = None, prefix: str = None):
    """Drop one metric, every metric under a prefix, or everything."""
    with _lock:
        if prefix is not None:
            for store in (_stats, _hists):
                for k in [k for k in store if k.startswith(prefix)]:
                    del store[k]
        elif name is None:
            _stats.clear()
            _hists.clear()
        else:
            _stats.pop(name, None)
            _hists.pop(name, None)
