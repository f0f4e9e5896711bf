"""Observability report (tools/obs_report.py for the port): render a
flight-recorder dump of the port, or a live run.

Turns the always-on telemetry (core/trace.py span ring + core/monitor
typed metrics) into the answers an operator asks after a failed or slow
run:

  1. per-step TIMELINE — dispatch / retire / materialize spans of the
     async pipeline, with durations and the thread that ran each;
  2. HOST-OVERHEAD breakdown — aggregate span table (the profiler
     summary, but from the flight recorder, so it works post-mortem);
  3. PS HEALTH — retries / reconnects / deadline-exceeded / replays /
     bad frames, plus RPC latency histogram when present;
  4. KERNEL engagement — the JAX package's Pallas hit / fallback /
     gate-reject counters (``pallas.*``), and the port's CUDA kernels'
     (``cuda.hit.*`` / ``cuda.gate_reject.*``) where a dump holds them;
  5. SERVING — the serve loop's gauges, counters and latency histograms.

A dump of the JAX package renders as the JAX tool renders it
(tests/fixtures/obsdump_v1.json, byte for byte).

Usage:
  python -m paddle_tpu_torch.tools.obs_report DUMP.json   # render a dump
  python -m paddle_tpu_torch.tools.obs_report --live      # this process
  python -m paddle_tpu_torch.tools.obs_report DUMP.json --trace out.json
                                # also convert the dump's spans to a
                                # Chrome trace (chrome://tracing) through
                                # core/trace.py's encoder
  python -m paddle_tpu_torch.tools.obs_report --incident incident_<id>.json
                                # render a MERGED incident dump from the
                                # telemetry hub (core/telemetry.py)
  python -m paddle_tpu_torch.tools.obs_report --self-check

``self_check()`` pins the renderer against the port's flight-recorder
schema, the telemetry hub's incident schema, the ring / series flag
defaults and the serve loop's published names.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict

# canonical observability config: the flag DEFAULTS (core/flags.py) must
# match, and the dump schema version must match the recorder's
OBS_CFG = {"ring": 4096, "series": 256, "schema": 2}

# dump keys this renderer reads; self_check pins them against
# flight_recorder.SCHEMA_KEYS so the two cannot drift.  Schema v2 adds
# the cluster-identity fields (incident_id/role/peer_members); render()
# only prints them when present, so committed v1 dumps render unchanged
# (tests/fixtures/obsdump_v1.json pins that).
EXPECTED_KEYS = ("schema", "reason", "time", "pid", "argv", "exception",
                 "spans", "metrics", "flags", "env", "extra",
                 "incident_id", "role", "peer_members")

# merged-incident files (telemetry hub) the --incident mode reads;
# pinned against core.telemetry.INCIDENT_SCHEMA in self_check
INCIDENT_SCHEMA = 1

_STEP_SPANS = ("pipeline/dispatch", "pipeline/dispatch_scan",
               "pipeline/retire", "pipeline/materialize")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def live_record() -> dict:
    """A dump-shaped record of the CURRENT process (no file involved)."""
    from ..core import flight_recorder
    return flight_recorder.record("live")


# -- sections ----------------------------------------------------------------

def _fmt_table(headers, rows):
    if not rows:
        return "  (none)"
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(headers)]
    out = ["  " + "  ".join(f"{h:<{w}}" for h, w in zip(headers, widths))]
    for r in rows:
        out.append("  " + "  ".join(f"{str(c):<{w}}"
                                    for c, w in zip(r, widths)))
    return "\n".join(out)


def _steps_of(span):
    a = span.get("attrs", {})
    if "step" in a:
        return [a["step"]]
    if "step_first" in a:
        return list(range(int(a["step_first"]), int(a["step_last"]) + 1))
    return []


def step_timeline(spans) -> str:
    """Rows: step -> when each pipeline phase touched it, on which
    thread, how long."""
    per_step = defaultdict(dict)
    threads = defaultdict(set)
    for sp in spans:
        name = sp.get("name")
        if name not in _STEP_SPANS:
            continue
        phase = {"pipeline/dispatch": "dispatch",
                 "pipeline/dispatch_scan": "dispatch",
                 "pipeline/retire": "retire",
                 "pipeline/materialize": "materialize"}[name]
        for step in _steps_of(sp):
            cur = per_step[step].get(phase)
            if cur is None or sp["ts_us"] < cur["ts_us"]:
                per_step[step][phase] = sp
            threads[step].add(sp.get("thread"))
    rows = []
    for step in sorted(per_step):
        phases = per_step[step]
        row = [step]
        for ph in ("dispatch", "retire", "materialize"):
            sp = phases.get(ph)
            row.append("-" if sp is None
                       else f"{sp['ts_us'] / 1e3:.2f}+"
                            f"{sp['dur_us'] / 1e3:.2f}ms")
        err = next((p["attrs"]["error"] for p in phases.values()
                    if p.get("attrs", {}).get("error")), "")
        row.append(err)
        row.append(len([t for t in threads[step] if t]))
        rows.append(row)
    return _fmt_table(
        ["step", "dispatch", "retire", "materialize", "error", "threads"],
        rows)


def host_breakdown(spans) -> str:
    agg = defaultdict(lambda: [0, 0.0, 0.0])  # calls, total_ms, max_ms
    for sp in spans:
        ms = sp.get("dur_us", 0) / 1e3
        a = agg[sp.get("name", "?")]
        a[0] += 1
        a[1] += ms
        a[2] = max(a[2], ms)
    rows = [[name, n, f"{tot:.3f}", f"{tot / n:.3f}", f"{mx:.3f}"]
            for name, (n, tot, mx) in
            sorted(agg.items(), key=lambda kv: -kv[1][1])]
    return _fmt_table(["span", "calls", "total_ms", "avg_ms", "max_ms"],
                      rows)


def ps_health(metrics) -> str:
    values = metrics.get("values", {})
    rows = [[k, v] for k, v in sorted(values.items())
            if k.startswith(("ps.rpc.", "ps.communicator."))]
    out = [_fmt_table(["counter", "value"], rows)]
    lat = metrics.get("histograms", {}).get("ps.rpc/latency_ms")
    if lat:
        out.append(f"  rpc latency: n={lat['count']} "
                   f"avg={lat['avg']:.3f}ms min={lat['min']:.3f}ms "
                   f"max={lat['max']:.3f}ms")
    return "\n".join(out)


def pallas_rates(metrics, prefix="pallas") -> str:
    """Per-kernel engagement: {prefix}.hit.K / {prefix}.fallback.K.reason
    / {prefix}.gate_reject.K.reason -> hit/fallback/reject counts + rate
    (``pallas``: the JAX package's kernels; ``cuda``: the port's)."""
    per = defaultdict(lambda: {"hit": 0.0, "fallback": 0.0,
                               "gate_reject": 0.0, "reasons": []})
    for name, v in metrics.get("values", {}).items():
        if not name.startswith(prefix + "."):
            continue
        parts = name.split(".")
        kind = parts[1]
        if kind == "hit" and len(parts) >= 3:
            per[parts[2]]["hit"] += v
        elif kind in ("fallback", "gate_reject") and len(parts) >= 4:
            per[parts[2]][kind] += v
            per[parts[2]]["reasons"].append(
                f"{kind}:{'.'.join(parts[3:])}={int(v)}")
    rows = []
    for k in sorted(per):
        d = per[k]
        total = d["hit"] + d["fallback"]
        rate = (d["fallback"] / total) if total else 0.0
        rows.append([k, int(d["hit"]), int(d["fallback"]),
                     int(d["gate_reject"]), f"{rate:.1%}",
                     " ".join(d["reasons"])])
    return _fmt_table(
        ["kernel", "hits", "fallbacks", "gate_rejects", "fallback_rate",
         "detail"], rows)


# gauge/counter names the serving section renders; self_check pins them
# against inference/serving.py GAUGES/COUNTERS so the two cannot drift
SERVE_GAUGES = ("serve.queue_depth", "serve.active_slots",
                "serve.kv_pool_used_blocks", "serve.kv_pool_free_blocks",
                "serve.model_version")
SERVE_COUNTERS = ("serve.preempted", "serve.tokens_generated",
                  "serve.requests_completed", "serve.requests_errored",
                  "serve.hot_swaps", "serve.completion_log_errors",
                  "serve.backpressure_waits")
_SERVE_SPANS = ("serve/admit", "serve/prefill", "serve/decode_step",
                "serve/retire", "serve/evict", "serve/hot_swap")


def serving_section(metrics, spans) -> str:
    """Continuous-batching serve tier: pool/queue gauges, stream
    counters, TTFT/per-token latency histograms, and the per-phase span
    table (admit/prefill/decode_step/retire/evict)."""
    values = metrics.get("values", {})
    rows = [[k, values[k]] for k in SERVE_GAUGES + SERVE_COUNTERS
            if k in values]
    out = [_fmt_table(["metric", "value"], rows)]
    for hname, label in (("serve/ttft_ms", "ttft"),
                         ("serve/token_ms", "per-token")):
        h = metrics.get("histograms", {}).get(hname)
        if h:
            out.append(f"  {label}: n={h['count']} avg={h['avg']:.3f}ms "
                       f"min={h['min']:.3f}ms max={h['max']:.3f}ms")
    agg = defaultdict(lambda: [0, 0.0])
    for sp in spans:
        if sp.get("name") in _SERVE_SPANS:
            a = agg[sp["name"]]
            a[0] += 1
            a[1] += sp.get("dur_us", 0) / 1e3
    if agg:
        out.append(_fmt_table(
            ["phase", "calls", "total_ms"],
            [[n, c, f"{t:.3f}"] for n, (c, t) in sorted(agg.items())]))
    return "\n".join(out)


def render(dump: dict) -> str:
    out = []
    exc = dump.get("exception")
    out.append("== flight-recorder dump "
               f"(schema {dump.get('schema')}) ==")
    out.append(f"  reason: {dump.get('reason')}  pid: {dump.get('pid')}")
    # schema-2 cluster identity: only printed when present, so v1 dumps
    # (and solo v2 dumps) render byte-identically to before
    if dump.get("role"):
        peers = dump.get("peer_members") or []
        out.append(f"  role: {dump['role']}"
                   + (f"  peers: {', '.join(str(p) for p in peers)}"
                      if peers else ""))
    if dump.get("incident_id"):
        out.append(f"  incident: {dump['incident_id']}")
    if exc:
        out.append(f"  exception: {exc.get('type')}: {exc.get('message')}")
    extra = dump.get("extra") or {}
    if extra:
        out.append(f"  extra: {json.dumps(extra, default=str)}")
    spans = dump.get("spans", [])
    metrics = dump.get("metrics", {})
    out.append(f"\n== step timeline ({len(spans)} spans recorded) ==")
    out.append(step_timeline(spans))
    out.append("\n== host overhead ==")
    out.append(host_breakdown(spans))
    out.append("\n== ps health ==")
    out.append(ps_health(metrics))
    out.append("\n== pallas kernels ==")
    out.append(pallas_rates(metrics))
    if any(k.startswith("cuda.") for k in metrics.get("values", {})):
        out.append("\n== cuda kernels ==")
        out.append(pallas_rates(metrics, "cuda"))
    out.append("\n== serving ==")
    out.append(serving_section(metrics, spans))
    return "\n".join(out)


def render_incident(inc: dict) -> str:
    """A merged incident dump from the telemetry hub: the cluster-level
    story first (alerts, members, stitched cross-process trace chains),
    then every member's full per-process report."""
    from ..core.telemetry import stitch_incident
    out = []
    out.append(f"== incident {inc.get('incident_id')} "
               f"(schema {inc.get('schema')}) ==")
    out.append(f"  reason: {inc.get('reason')}  time: {inc.get('time')}")
    trig = inc.get("triggers") or []
    if trig:
        out.append("  triggers: "
                   + "; ".join(json.dumps(t, default=str, sort_keys=True)
                               for t in trig))
    alerts = inc.get("alerts") or []
    out.append(f"\n== slo alerts ({len(alerts)}) ==")
    out.append(_fmt_table(
        ["slo", "metric", "burn_fast", "burn_slow", "bad/total"],
        [[a.get("slo"), a.get("metric"),
          f"{(a.get('burn') or {}).get('fast', 0.0):.2f}",
          f"{(a.get('burn') or {}).get('slow', 0.0):.2f}",
          f"{a.get('bad')}/{a.get('total')}"] for a in alerts]))
    members = inc.get("members") or {}
    out.append(f"\n== members ({len(members)}) ==")
    out.append(_fmt_table(
        ["member", "role", "pid", "reason", "spans"],
        [[m, (r or {}).get("role", ""), (r or {}).get("pid"),
          (r or {}).get("reason"), len((r or {}).get("spans") or ())]
         for m, r in sorted(members.items())]))
    chains = stitch_incident(inc)
    out.append(f"\n== cross-process trace chains ({len(chains)}) ==")
    rows = []
    for c in chains:
        hops = " -> ".join(f"{r or m}({p})" for m, r, p in
                           zip(c["members"], c["roles"], c["pids"]))
        rows.append([c["trace_id"], hops, c["spans"],
                     " ".join(c["span_names"][:6])])
    out.append(_fmt_table(["trace", "path", "spans", "span_names"], rows))
    for m, record in sorted(members.items()):
        out.append(f"\n{'=' * 12} member {m} {'=' * 12}")
        out.append(render(record or {}))
    return "\n".join(out)


def incident_to_chrome_trace(inc: dict, path: str):
    """Merged cluster timeline: one Chrome-trace lane per member process,
    so a client->primary->backup incident reads as one picture."""
    from ..core import trace as _trace
    events = []
    for m, record in sorted((inc.get("members") or {}).items()):
        pid = (record or {}).get("pid", 0)
        role = (record or {}).get("role", "")
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"{role or 'member'} {m}"}})
        events.extend(_trace.to_chrome_events(
            (record or {}).get("spans") or [], pid=pid))
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


def dump_to_chrome_trace(dump: dict, path: str):
    """Convert a dump's serialized spans into a Chrome trace file, via
    the one encoder in core/trace.py (span_dict records are accepted
    directly, so the slice/flow/instant/thread-name treatment cannot
    drift from live exports)."""
    from ..core import trace as _trace
    events = _trace.to_chrome_events(dump.get("spans", []),
                                     pid=dump.get("pid", 0))
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path


# -- framework_lint cross-check ---------------------------------------------

def self_check():
    problems = []
    from ..core import flags as _flags
    from ..core import flight_recorder, monitor, telemetry
    from ..inference import serving
    # dump schema <-> renderer expectations
    if tuple(flight_recorder.SCHEMA_KEYS) != EXPECTED_KEYS:
        problems.append(
            "obs_report: flight_recorder.SCHEMA_KEYS "
            f"{flight_recorder.SCHEMA_KEYS} != renderer EXPECTED_KEYS "
            f"{EXPECTED_KEYS} — update both together")
    if flight_recorder.SCHEMA_VERSION != OBS_CFG["schema"]:
        problems.append(
            f"obs_report: dump schema v{flight_recorder.SCHEMA_VERSION} "
            f"!= renderer v{OBS_CFG['schema']}")
    # merged-incident files (--incident) <-> the hub's writer
    if telemetry.INCIDENT_SCHEMA != INCIDENT_SCHEMA:
        problems.append(
            f"obs_report: telemetry.INCIDENT_SCHEMA "
            f"{telemetry.INCIDENT_SCHEMA} != renderer {INCIDENT_SCHEMA} — "
            "update both together")
    # flag DECLARED defaults (not live values — a test may have set them)
    defs = _flags._DEFS
    for name, want in (("FLAGS_trace_ring_size", OBS_CFG["ring"]),
                       ("FLAGS_monitor_series_len", OBS_CFG["series"])):
        if name not in defs:
            problems.append(f"obs_report: flag {name} is gone but the "
                            "tracer/monitor depend on it")
        elif int(defs[name][1]) != want:
            problems.append(
                f"obs_report: flag {name} default {defs[name][1]} != "
                f"OBS_CFG {want} — update the canonical config")
    # serving section <-> the serve loop's published names
    if tuple(serving.GAUGES) != SERVE_GAUGES:
        problems.append(
            f"obs_report: serving.GAUGES {serving.GAUGES} != "
            f"renderer SERVE_GAUGES {SERVE_GAUGES} — update both")
    if tuple(serving.COUNTERS) != SERVE_COUNTERS:
        problems.append(
            f"obs_report: serving.COUNTERS {serving.COUNTERS} != "
            f"renderer SERVE_COUNTERS {SERVE_COUNTERS}")
    # monitor export surface the dump format relies on
    for fn in ("snapshot", "export_jsonl", "prometheus_text", "observe"):
        if not callable(getattr(monitor, fn, None)):
            problems.append(f"obs_report: core.monitor.{fn}() is gone "
                            "but the dump/report format depends on it")
    return problems


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-check" in argv:
        problems = self_check()
        for p in problems:
            print(p)
        print("obs_report self-check:",
              "clean" if not problems else f"{len(problems)} problem(s)")
        return 1 if problems else 0
    trace_out = None
    if "--trace" in argv:
        i = argv.index("--trace")
        trace_out = argv[i + 1]
        del argv[i:i + 2]
    if "--incident" in argv:
        i = argv.index("--incident")
        inc = load(argv[i + 1])
        print(render_incident(inc))
        if trace_out:
            incident_to_chrome_trace(inc, trace_out)
            print(f"\nchrome trace written to {trace_out}")
        return 0
    if "--live" in argv:
        dump = live_record()
    elif argv:
        dump = load(argv[0])
    else:
        print(__doc__)
        return 2
    print(render(dump))
    if trace_out:
        dump_to_chrome_trace(dump, trace_out)
        print(f"\nchrome trace written to {trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
