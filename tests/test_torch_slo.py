"""Port parity: the SLO math (paddle_tpu_torch/core/slo.py) against
paddle_tpu/core/slo.py.

tests/test_slo.py's cases run on both packages (the ``pkg`` fixture:
slo and the monitor's _Hist of one package), and one script of
observations goes through both: every estimate, merge, alert and
detector reading must be equal.
"""
import numpy as np
import pytest

from paddle_tpu.core import monitor as jmonitor
from paddle_tpu.core import slo as jslo
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.core import slo as tslo

PKGS = {"jax": (jslo, jmonitor._Hist), "port": (tslo, tmonitor._Hist)}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def _hist(hist_cls, values, bounds=(1.0, 10.0, 100.0)):
    h = hist_cls(bounds)
    for v in values:
        h.observe(v)
    return h.summary()


def _lat_summary(good, bad, threshold=100.0):
    return {"count": good + bad, "sum": 0.0, "min": 0.0, "max": 1.0,
            "bounds": [threshold], "buckets": [good, bad]}


def test_percentile_matches_numpy(pkg):
    slo = pkg[0]
    xs = list(np.random.RandomState(3).uniform(0, 100, 257))
    for p in (0, 25, 50, 90, 99, 100):
        assert slo.percentile(xs, p) == pytest.approx(
            float(np.percentile(np.asarray(xs), p)))


def test_percentile_edge_cases(pkg):
    slo = pkg[0]
    assert slo.percentile([], 99) is None
    assert slo.percentile([7.0], 50) == 7.0
    assert slo.percentile([1, 2, 3, 4], 50, ndigits=3) == 2.5
    assert slo.percentile([1.23456, 2.34567], 99, ndigits=3) == round(
        float(np.percentile([1.23456, 2.34567], 99)), 3)


def test_good_count_aligns_threshold_down(pkg):
    slo, hist = pkg
    s = _hist(hist, [0.5, 5.0, 50.0, 500.0])
    assert slo.good_count(s, 10.0) == (2, 4)
    assert slo.good_count(s, 60.0) == (2, 4)
    assert slo.good_count(s, 100.0) == (3, 4)


def test_good_count_without_buckets_uses_max(pkg):
    slo = pkg[0]
    assert slo.good_count({"count": 3, "max": 8.0}, 10.0) == (3, 3)
    assert slo.good_count({"count": 3, "max": 80.0}, 10.0) == (0, 3)
    assert slo.good_count({}, 10.0) == (0, 0)


def test_hist_quantile_interpolates_and_clamps(pkg):
    slo, hist = pkg
    s = _hist(hist, [0.5] * 50 + [5.0] * 50)
    assert 0.5 <= slo.hist_quantile(s, 50) <= 1.0
    assert slo.hist_quantile(s, 100) == 5.0
    assert slo.hist_quantile({"count": 0}, 50) is None
    assert slo.hist_quantile({"count": 5, "sum": 1.0, "min": 0.1,
                              "max": 0.5, "bounds": None,
                              "buckets": None}, 50) is None


def test_merge_hists_equals_union_stream(pkg):
    slo, hist = pkg
    rng = np.random.RandomState(7)
    a = list(rng.uniform(0, 120, 100))
    b = list(rng.uniform(0, 120, 57))
    merged = slo.merge_hists([_hist(hist, a), _hist(hist, b)])
    union = _hist(hist, a + b)
    assert merged["buckets"] == union["buckets"]
    assert merged["bounds"] == union["bounds"]
    assert merged["count"] == union["count"] == 157
    assert merged["sum"] == pytest.approx(union["sum"])
    assert merged["min"] == union["min"]
    assert merged["max"] == union["max"]


def test_merge_hists_mixed_bounds_degrades_honestly(pkg):
    slo, hist = pkg
    a = _hist(hist, [1.0, 20.0], bounds=(1.0, 10.0, 100.0))
    b = _hist(hist, [2.0, 30.0], bounds=(5.0, 50.0))
    m = slo.merge_hists([a, b])
    assert m["bounds"] is None and m["buckets"] is None
    assert m["count"] == 4
    assert m["min"] == 1.0 and m["max"] == 30.0
    assert m["avg"] == pytest.approx((1 + 20 + 2 + 30) / 4)
    z = slo.merge_hists([])
    assert z["count"] == 0 and z["bounds"] is None


def test_latency_slo_breach_and_hysteretic_clear(pkg):
    slo = pkg[0]
    spec = slo.SLOSpec("lat", "latency", "m", objective=0.05,
                       threshold_ms=100.0)
    eng = slo.SLOEngine([spec], fast_s=10.0, slow_s=60.0)
    t0 = 1000.0
    assert eng.observe({}, {"m": _lat_summary(0, 0)}, now=t0) == []
    alerts = eng.observe({}, {"m": _lat_summary(50, 50)}, now=t0 + 5)
    assert [a["slo"] for a in alerts] == ["lat"]
    assert alerts[0]["type"] == "slo_breach"
    assert alerts[0]["burn"]["fast"] >= 1.0
    assert alerts[0]["burn"]["slow"] >= 1.0
    assert eng.active() == ["lat"]
    assert eng.observe({}, {"m": _lat_summary(50, 60)}, now=t0 + 6) == []
    assert eng.active() == ["lat"]
    assert eng.observe({}, {"m": _lat_summary(2000, 60)},
                       now=t0 + 20) == []
    assert eng.active() == []


def test_single_spike_cannot_page(pkg):
    slo = pkg[0]
    spec = slo.SLOSpec("lat", "latency", "m", objective=0.05,
                       threshold_ms=100.0)
    eng = slo.SLOEngine([spec], fast_s=10.0, slow_s=60.0)
    eng.observe({}, {"m": _lat_summary(0, 0)}, now=0.0)
    assert eng.observe({}, {"m": _lat_summary(99, 1)}, now=5.0) == []
    assert eng.active() == []


def test_rate_slo_per_second_budget(pkg):
    slo = pkg[0]
    spec = slo.SLOSpec("errs", "rate", "err_count", objective=2.0)
    eng = slo.SLOEngine([spec], fast_s=10.0, slow_s=60.0)
    eng.observe({"err_count": 0.0}, {}, now=0.0)
    alerts = eng.observe({"err_count": 100.0}, {}, now=10.0)
    assert [a["slo"] for a in alerts] == ["errs"]
    eng.observe({"err_count": 100.0}, {}, now=25.0)
    assert eng.active() == []


def test_rate_slo_with_denominator(pkg):
    slo = pkg[0]
    spec = slo.SLOSpec("bad_frac", "rate", "bad", objective=0.01,
                       denominator="total")
    eng = slo.SLOEngine([spec], fast_s=10.0, slow_s=60.0)
    eng.observe({"bad": 0.0, "total": 0.0}, {}, now=0.0)
    alerts = eng.observe({"bad": 5.0, "total": 100.0}, {}, now=5.0)
    assert [a["slo"] for a in alerts] == ["bad_frac"]
    eng2 = slo.SLOEngine([spec], fast_s=10.0, slow_s=60.0)
    eng2.observe({"bad": 0.0, "total": 0.0}, {}, now=0.0)
    assert eng2.observe({"bad": 0.0, "total": 100.0}, {}, now=5.0) == []


def test_slospec_validation(pkg):
    slo = pkg[0]
    with pytest.raises(ValueError):
        slo.SLOSpec("x", "latency", "m", objective=0.1)
    with pytest.raises(ValueError):
        slo.SLOSpec("x", "weird", "m", objective=0.1)
    d = slo.SLOSpec("x", "rate", "m", objective=0.1).to_dict()
    assert d["name"] == "x" and d["kind"] == "rate"


def test_rolling_median_detector_warmup_spike_and_level_change(pkg):
    slo = pkg[0]
    det = slo.RollingMedianDetector(window=16, k=3.0, min_samples=8)
    for v in (50.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0):
        assert det.observe(v) is False
    assert det.anomalies == 0
    assert det.observe(1.1) is False
    assert det.observe(10.0) is True
    assert det.anomalies == 1
    flags = [det.observe(10.0) for _ in range(20)]
    assert flags[-1] is False
    assert det.median() == pytest.approx(10.0)


def test_latency_skew(pkg):
    slo = pkg[0]
    skew, worst = slo.latency_skew({"s0": 1.0, "s1": 1.0, "s2": 3.0})
    assert worst == "s2" and skew == pytest.approx(3.0)
    assert slo.latency_skew({"s0": 2.0}) is None
    assert slo.latency_skew({"s0": None, "s1": 2.0}) is None
    assert slo.latency_skew({"s0": 0.0, "s1": 0.0}) is None


def _script(slo, hist):
    """One script of observations through every estimator, the engine
    and the detector; every reading, in order."""
    rng = np.random.RandomState(11)
    lat = list(rng.lognormal(3.0, 0.8, 300))
    bounds = tuple(round(0.25 * 1.12 ** i, 4) for i in range(90))
    parts = [_hist(hist, lat[i::3], bounds) for i in range(3)]
    merged = slo.merge_hists(parts)
    out = [slo.percentile(lat, p, ndigits=6) for p in (50, 90, 99)]
    out += [slo.hist_quantile(merged, p) for p in (1, 50, 90, 99, 100)]
    out += [slo.good_count(merged, t) for t in (5.0, 20.0, 80.0)]
    out.append(merged)
    specs = [slo.SLOSpec("ttft", "latency", "serve/ttft_ms", 0.05,
                         threshold_ms=40.0),
             slo.SLOSpec("errors", "rate", "errs", 0.02,
                         denominator="reqs")]
    eng = slo.SLOEngine(specs, fast_s=10.0, slow_s=30.0)
    for step in range(12):
        h = _hist(hist, lat[: 25 * (step + 1)], bounds)
        counters = {"errs": float(step * step), "reqs": 50.0 * step}
        out.append(eng.observe(counters, {"serve/ttft_ms": h},
                               now=100.0 + 5 * step))
    out.append(eng.active())
    det = slo.RollingMedianDetector(window=8, k=2.0, min_samples=4)
    out.append([det.observe(v) for v in lat[:40]] + [det.median()])
    out.append(slo.latency_skew({f"s{i}": v for i, v in
                                 enumerate(lat[:5])}))
    return out


def test_one_script_of_observations_reads_as_jax():
    got = _script(*PKGS["port"])
    want = _script(*PKGS["jax"])
    assert got == want
    assert any(isinstance(r, list) and r and isinstance(r[0], dict)
               for r in got)   # the engine did page
