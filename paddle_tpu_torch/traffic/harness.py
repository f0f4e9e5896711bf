"""Shared load harness (paddle_tpu/traffic/harness.py): one place that
drives traffic at the system.

- `drive_serve`: submit a list of `Submission`s at a ServeLoop from N
  client threads (jittered-delay or schedule-paced arrivals) and collect
  results, latencies and errors.
- `run_worker_pool`: start N worker threads, optionally fire a kill
  mid-run and record the latency until a monitor counter ticks.
- `run_spec`: the closed loop: replay a `workload.WorkloadSpec` schedule
  through a ServeLoop (the tiny GPT's, or the caller's `loop=`) and score
  it from the monitor's histograms with core/slo.py's estimator.

Left to ROADMAP Queue 1 item 8, whose modules they need: `Window` (the
StreamingDataset) and `run_spec(hub=...)` (the TelemetryHub as the
scorekeeper). Both raise NotImplementedError naming it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Submission", "ServeStats", "drive_serve", "run_worker_pool",
           "PoolRun", "Window", "run_spec", "HarnessReport",
           "submissions_from_prompts", "submissions_from_events",
           "TTFT_BUCKETS_MS", "TOKEN_BUCKETS_MS"]

# fine-grained histogram bounds for the hub-scored serve latencies:
# ~12%-wide geometric steps so hub-side hist_quantile p50/p99 estimates
# are apples-to-apples with the capacity model's error band
TTFT_BUCKETS_MS = tuple(round(0.25 * 1.12 ** i, 4) for i in range(90))
TOKEN_BUCKETS_MS = tuple(round(0.05 * 1.12 ** i, 4) for i in range(90))


@dataclass
class Submission:
    """One request for `drive_serve`. Either `delay_s` (sleep before
    submit — the load-test jitter idiom) or `t_arrival` (absolute
    schedule seconds, paced against the drive's t0) may be set."""

    index: int
    prompt: np.ndarray
    new_tokens: int
    delay_s: float = 0.0
    t_arrival: Optional[float] = None


def submissions_from_prompts(prompts, new_tokens, delays=None):
    return [Submission(i, np.asarray(p, np.int64), int(new_tokens),
                       delay_s=float(delays[i]) if delays else 0.0)
            for i, p in enumerate(prompts)]


def submissions_from_events(events, time_scale=1.0):
    """Map a workload schedule onto paced submissions."""
    return [Submission(e.index, e.prompt, e.new_tokens,
                       t_arrival=e.t * float(time_scale))
            for e in events]


@dataclass
class ServeStats:
    """What one `drive_serve` pass observed."""

    requests: List = field(default_factory=list)   # ServeRequest | None
    outs: List = field(default_factory=list)       # np.int64 [n] | None
    tokens: int = 0
    ttfts_ms: List[float] = field(default_factory=list)
    token_ms: List[float] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    wall_s: float = 0.0

    def collect_latencies(self):
        self.ttfts_ms = [r.ttft_s * 1e3 for r in self.requests
                         if r is not None and r.ttft_s is not None]
        self.token_ms = [r.per_token_s * 1e3 for r in self.requests
                         if r is not None and r.per_token_s is not None]
        return self

    def outputs_digest(self) -> str:
        """Byte-identity oracle over the generated tokens (replay
        proofs: same seed => same per-request token draws)."""
        import hashlib
        h = hashlib.sha256()
        for o in self.outs:
            h.update(b"-" if o is None else
                     np.ascontiguousarray(o, np.int64).tobytes())
            h.update(b"\n")
        return h.hexdigest()


def drive_serve(loop, subs, *, clients=1, wait="result",
                result_timeout_s=600.0) -> ServeStats:
    """Submit every Submission (partitioned round-robin across `clients`
    threads, each honoring its submissions' delays/arrival times), then
    wait per `wait`:

      "result":      block on every request future (loop must be
                     started — background-server mode)
      "idle":        loop.run_until_idle() on the caller thread; request
                     futures are left to the caller
      "idle+result": run_until_idle, then collect every result

    Errors are recorded as strings (`submit[i]: ...` / `result[i]: ...`)
    rather than raised — load tools report and count them.
    """
    subs = list(subs)
    n = len(subs)
    stats = ServeStats(requests=[None] * n, outs=[None] * n)
    lock = threading.Lock()
    t0 = time.perf_counter()

    def client(cid):
        for i in range(cid, n, max(1, clients)):
            s = subs[i]
            if s.t_arrival is not None:
                d = (t0 + s.t_arrival) - time.perf_counter()
                if d > 0:
                    time.sleep(d)
            elif s.delay_s:
                time.sleep(s.delay_s)
            try:
                stats.requests[i] = loop.submit(
                    s.prompt, max_new_tokens=s.new_tokens)
            except Exception as e:  # noqa: BLE001 — reported, not raised
                with lock:
                    stats.errors.append(
                        f"submit[{i}]: {type(e).__name__}: {e}")

    if clients <= 1 and wait in ("idle", "idle+result"):
        client(0)             # drill idiom: submit inline, then drive
    else:
        ths = [threading.Thread(target=client, args=(c,))
               for c in range(max(1, clients))]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
    if wait in ("idle", "idle+result"):
        loop.run_until_idle()
    if wait in ("result", "idle+result"):
        for i, r in enumerate(stats.requests):
            if r is None:
                continue
            try:
                stats.outs[i] = r.result(timeout=result_timeout_s)
                stats.tokens += len(stats.outs[i])
            except Exception as e:  # noqa: BLE001 — reported, not raised
                stats.errors.append(
                    f"result[{i}]: {type(e).__name__}: {e}")
    stats.wall_s = time.perf_counter() - t0
    return stats.collect_latencies()


# ---------------------------------------------------------------------------
# worker pools (the ps_load_test loop family)
# ---------------------------------------------------------------------------

@dataclass
class PoolRun:
    wall_s: float = 0.0
    promote_latency_s: Optional[float] = None


def run_worker_pool(worker, n_workers, *, kill_after_s=None, on_kill=None,
                    promotion_stat="ps.replica.promotions",
                    promote_timeout_s=30.0, poll_s=0.005) -> PoolRun:
    """Run `worker(wid)` on `n_workers` threads. If `kill_after_s` is
    set, fire `on_kill()` that long after start and record the latency
    until `promotion_stat` ticks (None if it never does) — the
    kill-and-promote drill loop shared by the PS load modes."""
    from ..core import monitor

    run = PoolRun()
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_workers)]
    base = monitor.stat_get(promotion_stat) if kill_after_s is not None \
        else 0
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if kill_after_s is not None:
        time.sleep(kill_after_s)
        t_kill = time.perf_counter()
        on_kill()
        while time.perf_counter() - t_kill < promote_timeout_s:
            if monitor.stat_get(promotion_stat) > base:
                run.promote_latency_s = time.perf_counter() - t_kill
                break
            time.sleep(poll_s)
    for t in threads:
        t.join()
    run.wall_s = time.perf_counter() - t0
    return run


class Window:
    """A StreamingDataset exposed a fixed number of batches at a time.
    The streaming dataset is ROADMAP Queue 1 item 8."""

    def __init__(self, ds):
        raise NotImplementedError(
            "traffic.Window needs dataset/streaming.py's StreamingDataset, "
            "ROADMAP Queue 1 item 8")


# ---------------------------------------------------------------------------
# closed-loop spec replay, scored by the monitor
# ---------------------------------------------------------------------------

@dataclass
class HarnessReport:
    """Scored observation of one workload-spec replay."""

    spec: str = ""
    seed: int = 0
    events: int = 0
    completed: int = 0
    errors: int = 0
    duration_s: float = 0.0
    wall_s: float = 0.0
    offered_rps: float = 0.0
    throughput_rps: float = 0.0
    tokens_per_s: float = 0.0
    ttft_ms: Dict = field(default_factory=dict)    # {"p50","p99"}
    token_ms: Dict = field(default_factory=dict)
    backpressure_waits: int = 0
    preempted: int = 0
    truncated: int = 0
    schedule_digest: str = ""
    outputs_digest: str = ""
    scored_by: str = "monitor"                      # "hub" | "monitor"

    def as_dict(self) -> Dict:
        return dict(self.__dict__)


def build_tiny_loop(serve_cfg=None, on_complete=None, device=None):
    """The tiny-GPT ServeLoop every closed-loop drill shapes traffic at,
    on `device` (None: the current device). `serve_cfg` maps ServeConfig
    fields; weights come from seed 0, so two builds serve byte-identical
    token streams."""
    from ..inference.serving import ServeConfig, ServeLoop
    from ..text.models.gpt import GPT, GPTConfig

    cfg = GPTConfig.tiny()
    net = GPT(cfg, device=device, seed=0)
    net.eval()
    sc = dict(serve_cfg or {})
    sc.setdefault("max_active", 8)
    sc.setdefault("kv_blocks", 48)
    sc.setdefault("block_size", 8)
    sc.setdefault("max_seq_len", 48)
    return net, ServeLoop(net, ServeConfig(**sc), on_complete=on_complete)


def run_spec(spec, seed=0, *, loop=None, serve_cfg=None, clients=None,
             time_scale=None, hub=None, warm=True,
             result_timeout_s=600.0) -> HarnessReport:
    """Replay one WorkloadSpec schedule through a ServeLoop and score it.

    The schedule is generated deterministically from (spec, seed), paced
    onto the wall clock by `time_scale` (PADDLE_TRAFFIC_TIME_SCALE), and
    submitted from `clients` threads (PADDLE_TRAFFIC_CLIENTS). The local
    monitor registry scores the run. `hub=` (a TelemetryHub as the
    scorekeeper) is ROADMAP Queue 1 item 8 and raises."""
    from ..core import flags as _flags
    from ..core import monitor
    from ..core import slo
    from . import workload as W

    if hub is not None:
        raise NotImplementedError(
            "run_spec(hub=...) needs core/telemetry.py's TelemetryHub, "
            "ROADMAP Queue 1 item 8")

    if clients is None:
        clients = int(_flags.flag("PADDLE_TRAFFIC_CLIENTS"))
    if time_scale is None:
        time_scale = float(_flags.flag("PADDLE_TRAFFIC_TIME_SCALE"))
    gen = W.WorkloadGenerator(spec, seed)
    events = list(gen)
    if loop is None:
        _net, loop = build_tiny_loop(serve_cfg)
    report = HarnessReport(spec=spec.name, seed=int(seed),
                           events=len(events),
                           duration_s=float(spec.duration_s),
                           truncated=int(gen.stats["truncated"]),
                           schedule_digest=W.schedule_digest(events))
    if events and max(e.tokens_total() for e in events) > loop._cap:
        raise ValueError("spec draws exceed the serve cap "
                         f"({loop._cap}); raise max_seq_len or shrink "
                         "the samplers")
    if warm:
        # one prefill per bucket the schedule can land in, outside the
        # scored window (a first launch, or a kernel build, inside the
        # run would be scored as queueing delay)
        buckets = {}
        for e in events:
            b = 8
            while b < e.prompt.size:
                b *= 2
            buckets.setdefault(b, e.prompt)
        for p in buckets.values():
            loop.serve([p], max_new_tokens=2)
    monitor.reset(prefix="serve.")
    monitor.reset(prefix="serve/")
    monitor.ensure_hist("serve/ttft_ms", TTFT_BUCKETS_MS)
    monitor.ensure_hist("serve/token_ms", TOKEN_BUCKETS_MS)

    loop.start()
    try:
        stats = drive_serve(
            loop, submissions_from_events(events, time_scale),
            clients=max(1, int(clients)), wait="result",
            result_timeout_s=result_timeout_s)
    finally:
        loop.stop()

    report.completed = sum(1 for o in stats.outs if o is not None)
    report.errors = len(stats.errors)
    report.wall_s = round(stats.wall_s, 3)
    report.outputs_digest = stats.outputs_digest()
    dur = max(spec.duration_s, 1e-9) * max(time_scale, 1e-9)
    report.offered_rps = round(len(events) / dur, 3)
    report.throughput_rps = round(report.completed
                                  / max(stats.wall_s, 1e-9), 3)
    report.tokens_per_s = round(stats.tokens / max(stats.wall_s, 1e-9), 2)
    # the bucketed estimator (slo.hist_quantile over the monitor's
    # histogram) that the JAX package's hub-scored reports use too

    def q(name, p):
        h = monitor.histogram_summary(name)
        v = slo.hist_quantile(h, p) if h else None
        return None if v is None else round(float(v), 3)

    report.ttft_ms = {"p50": q("serve/ttft_ms", 50),
                      "p99": q("serve/ttft_ms", 99)}
    report.token_ms = {"p50": q("serve/token_ms", 50),
                       "p99": q("serve/token_ms", 99)}
    report.backpressure_waits = int(
        monitor.stat_get("serve.backpressure_waits"))
    report.preempted = int(monitor.stat_get("serve.preempted"))
    report.scored_by = "monitor"
    return report
