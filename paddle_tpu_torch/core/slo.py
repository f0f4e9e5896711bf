"""SLO math (paddle_tpu/core/slo.py, whole): the single source for
percentile and histogram estimation and the multi-window burn-rate
engine.

Three layers, bottom-up:

  - estimators: `percentile()` (exact, over raw samples — the one
    implementation every tool's p50/p99 goes through), and
    `hist_quantile()` / `good_count()` (approximate, over
    `monitor._Hist.summary()` dicts — what the hub has once samples
    have been folded into buckets).
  - `merge_hists()`: fold per-process histogram summaries into one
    cluster histogram. Merging is exact (bucket-wise sum) when the
    bucket bounds agree — which they do for any histogram observed with
    the same `buckets=` everywhere — and degrades to count/sum/min/max
    only (no buckets, no quantiles) when they don't.
  - `SLOSpec` + `SLOEngine`: declarative objectives ("99% of serve
    TTFTs under 250ms") evaluated with multi-window burn rates over
    cumulative (bad, total) series. A breach requires EVERY window's
    burn rate over threshold, so a single slow request cannot page but
    a sustained regression pages within the fast window. Breaches emit
    structured alert records; clearing is hysteretic on the fast
    window.

`RollingMedianDetector` (step-time anomaly / straggler detection) and
`latency_skew()` (per-shard PS latency spread) live here too: they are
the same "is this observation out of family" math the SLO engine runs,
applied point-wise.

Pure Python and numpy; the port keeps its own copy of the JAX module.
"""
import math
import threading
import time


def percentile(xs, p, ndigits=None):
    """The single-source percentile estimator (linear interpolation,
    matching numpy's default). Returns None for an empty sample set.

    `ndigits` rounds the result — tools that print pinned output pass
    ndigits=3 so their reports are byte-stable across refactors.
    """
    xs = list(xs)
    if not xs:
        return None
    import numpy as np
    v = float(np.percentile(np.asarray(xs, dtype=np.float64), p))
    return round(v, ndigits) if ndigits is not None else v


def good_count(summary, threshold):
    """How many observations in a histogram summary were <= threshold.

    Conservative: aligns threshold DOWN to the nearest bucket bound, so
    observations in a bucket straddling the threshold count as bad.
    Returns (good, total).
    """
    total = int(summary.get("count", 0))
    bounds = summary.get("bounds")
    buckets = summary.get("buckets")
    if not total or bounds is None or buckets is None:
        return (total if summary.get("max", math.inf) <= threshold
                else 0), total
    good = 0
    for i, b in enumerate(bounds):
        if b <= threshold:
            good += int(buckets[i])
        else:
            break
    return good, total


def hist_quantile(summary, q):
    """Estimate a quantile from a bucketed histogram summary (linear
    interpolation inside the target bucket, prometheus-style). Exact
    min/max are used to clamp the first/last bucket. Returns None for
    an empty histogram or one merged without buckets."""
    total = int(summary.get("count", 0))
    bounds = summary.get("bounds")
    buckets = summary.get("buckets")
    if not total or bounds is None or buckets is None:
        return None
    rank = q / 100.0 * total
    seen = 0.0
    lo = float(summary.get("min", 0.0))
    for i, n in enumerate(buckets):
        if not n:
            continue
        if seen + n >= rank:
            hi = bounds[i] if i < len(bounds) else float(
                summary.get("max", bounds[-1]))
            lo_b = bounds[i - 1] if i > 0 else lo
            frac = (rank - seen) / n
            return min(float(summary.get("max", hi)),
                       max(lo, lo_b + (hi - lo_b) * frac))
        seen += n
    return float(summary.get("max", bounds[-1]))


def merge_hists(summaries):
    """Fold histogram summaries (monitor._Hist.summary() dicts) into
    one. Bucket-exact when every summary shares the same bounds;
    otherwise the merged summary keeps count/sum/min/max but drops the
    buckets (quantile estimation unavailable, by design — a silently
    misaligned bucket merge would lie)."""
    summaries = [s for s in summaries if s and s.get("count")]
    if not summaries:
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "avg": None, "bounds": None, "buckets": None}
    out = {
        "count": sum(int(s["count"]) for s in summaries),
        "sum": sum(float(s["sum"]) for s in summaries),
        "min": min(float(s["min"]) for s in summaries),
        "max": max(float(s["max"]) for s in summaries),
    }
    out["avg"] = out["sum"] / out["count"]
    bounds0 = summaries[0].get("bounds")
    if bounds0 is not None and all(
            list(s.get("bounds") or []) == list(bounds0)
            for s in summaries):
        merged = [0] * (len(bounds0) + 1)
        for s in summaries:
            for i, n in enumerate(s["buckets"]):
                merged[i] += int(n)
        out["bounds"] = list(bounds0)
        out["buckets"] = merged
    else:
        out["bounds"] = None
        out["buckets"] = None
    return out


class SLOSpec:
    """One declarative objective.

    kind="latency": `metric` names a histogram; an observation is good
      when <= `threshold_ms`; `objective` is the max allowed bad
      fraction (0.01 == "99% under threshold").
    kind="rate": `metric` names a counter of bad events; `denominator`
      names the total-events counter (objective = max bad/total
      fraction), or None for a per-second budget (objective = max bad
      events per second).
    """

    __slots__ = ("name", "kind", "metric", "threshold_ms", "objective",
                 "denominator", "description")

    def __init__(self, name, kind, metric, objective, threshold_ms=None,
                 denominator=None, description=""):
        if kind not in ("latency", "rate"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if kind == "latency" and threshold_ms is None:
            raise ValueError(f"latency SLO {name!r} needs threshold_ms")
        self.name = name
        self.kind = kind
        self.metric = metric
        self.threshold_ms = threshold_ms
        self.objective = float(objective)
        self.denominator = denominator
        self.description = description

    def to_dict(self):
        return {"name": self.name, "kind": self.kind,
                "metric": self.metric, "threshold_ms": self.threshold_ms,
                "objective": self.objective,
                "denominator": self.denominator,
                "description": self.description}


class SLOEngine:
    """Multi-window burn-rate evaluation over cumulative series.

    Feed it the CURRENT cumulative state (merged counters + histogram
    summaries) via `observe()`; it appends (ts, bad, total) points per
    spec and computes, for each window w,

        burn(w) = (bad fraction over the last w seconds) / objective

    A spec breaches when burn >= `burn_threshold` in EVERY window and
    at least one new bad event landed inside the fast window; it clears
    (hysteresis) when the fast-window burn drops back under threshold.
    `observe()` returns the NEW breach alerts from this evaluation.
    """

    def __init__(self, specs, fast_s=60.0, slow_s=300.0,
                 burn_threshold=1.0, now=time.time):
        self.specs = list(specs)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.burn_threshold = float(burn_threshold)
        self._now = now
        self._series = {s.name: [] for s in self.specs}
        self._active = set()
        self.alerts = []
        self._lock = threading.Lock()

    def _bad_total(self, spec, counters, hists):
        if spec.kind == "latency":
            good, total = good_count(hists.get(spec.metric) or {},
                                     spec.threshold_ms)
            return float(total - good), float(total)
        bad = float(counters.get(spec.metric, 0.0))
        if spec.denominator is None:
            return bad, None
        return bad, float(counters.get(spec.denominator, 0.0))

    def _window_burn(self, pts, now, window_s, per_second, objective):
        """Burn rate over [now - window_s, now]; None if unevaluable."""
        cur = pts[-1]
        ref = pts[0]
        cutoff = now - window_s
        for p in pts:
            if p[0] <= cutoff:
                ref = p
            else:
                break
        d_bad = cur[1] - ref[1]
        if per_second:
            elapsed = max(cur[0] - ref[0], 1e-9)
            return (d_bad / elapsed) / objective, d_bad, elapsed
        d_total = (cur[2] or 0.0) - (ref[2] or 0.0)
        if d_total <= 0:
            return None, d_bad, 0.0
        return (d_bad / d_total) / objective, d_bad, d_total

    def observe(self, counters, hists, now=None):
        """Evaluate every spec against the current cumulative state;
        returns the list of NEW breach alert records."""
        now = self._now() if now is None else now
        new_alerts = []
        with self._lock:
            for spec in self.specs:
                bad, total = self._bad_total(spec, counters, hists)
                pts = self._series[spec.name]
                pts.append((now, bad, total))
                cutoff = now - self.slow_s * 2
                while len(pts) > 2 and pts[1][0] < cutoff:
                    pts.pop(0)
                per_second = (spec.kind == "rate"
                              and spec.denominator is None)
                burns = {}
                ok = True
                fast_bad = 0.0
                for label, w in (("fast", self.fast_s),
                                 ("slow", self.slow_s)):
                    burn, d_bad, _ = self._window_burn(
                        pts, now, w, per_second, spec.objective)
                    burns[label] = (None if burn is None
                                    else round(burn, 4))
                    if label == "fast":
                        fast_bad = d_bad
                    if burn is None or burn < self.burn_threshold:
                        ok = False
                breached = ok and fast_bad > 0
                if breached and spec.name not in self._active:
                    self._active.add(spec.name)
                    alert = {
                        "type": "slo_breach",
                        "slo": spec.name,
                        "time": now,
                        "burn": burns,
                        "bad": bad,
                        "total": total,
                        "objective": spec.objective,
                        "threshold_ms": spec.threshold_ms,
                        "metric": spec.metric,
                        "windows_s": [self.fast_s, self.slow_s],
                        "description": spec.description,
                    }
                    self.alerts.append(alert)
                    new_alerts.append(alert)
                elif not breached and spec.name in self._active:
                    fast = burns.get("fast")
                    if fast is not None and fast < self.burn_threshold:
                        self._active.discard(spec.name)
        return new_alerts

    def active(self):
        with self._lock:
            return sorted(self._active)


class RollingMedianDetector:
    """Point-wise anomaly detection against a rolling median: an
    observation is anomalous when it exceeds `k` times the median of
    the trailing window (after `min_samples` have been seen, so JIT
    warm-up steps train the baseline instead of paging on it).

    Used for `executor.step_anomalies` (straggler steps) and reusable
    for any strictly-positive latency-like series.
    """

    __slots__ = ("window", "k", "min_samples", "_ring", "anomalies")

    def __init__(self, window=32, k=3.0, min_samples=8):
        self.window = int(window)
        self.k = float(k)
        self.min_samples = int(min_samples)
        self._ring = []
        self.anomalies = 0

    def observe(self, v):
        """Feed one observation; True when it is out of family. The
        observation always joins the baseline (a sustained shift stops
        being anomalous once the median catches up — that is a level
        change, not a straggler)."""
        v = float(v)
        ring = self._ring
        anomalous = False
        if len(ring) >= self.min_samples:
            med = _median(ring)
            if med > 0 and v > self.k * med:
                anomalous = True
                self.anomalies += 1
        ring.append(v)
        if len(ring) > self.window:
            ring.pop(0)
        return anomalous

    def median(self):
        return _median(self._ring) if self._ring else None


def _median(xs):
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def latency_skew(per_shard_avg):
    """Per-shard latency spread: given {shard: avg_latency}, return
    (skew, worst_shard) where skew = worst avg / median avg — the
    straggler signal from the MLPerf pod-scale tuning work. None when
    fewer than two shards report."""
    items = [(k, float(v)) for k, v in per_shard_avg.items()
             if v is not None]
    if len(items) < 2:
        return None
    med = _median([v for _, v in items])
    worst, worst_v = max(items, key=lambda kv: kv[1])
    if med <= 0:
        return None
    return worst_v / med, worst
