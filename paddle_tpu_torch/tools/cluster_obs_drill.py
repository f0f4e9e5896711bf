"""Cluster observability drill: the telemetry plane's end-to-end proof
(tools/cluster_obs_drill.py for the port).

Spawns a multi-process fleet — 3 replicated PS shard servers (1 backup
each) and a serve + online-train client, each its own process with its
own monitor registry and trace ring — around an in-process TelemetryHub
(core/telemetry.py). Then breaks it on purpose:

  - every member ships metrics and spans to the hub through the
    exactly-once ``(member, seq)``-keyed protocol, the client under
    seeded RESET chaos and the servers under seeded reply-DROP chaos;
  - a scripted STALL at the serve decode beat inflates TTFT past the
    declared ``serve_ttft`` SLO (and only that SLO: a lenient
    error-budget spec rides along to prove silence);
  - the shard-0 primary is killed for good mid-run; the client rides
    the failover while its flight-recorder triggers and the hub's SLO
    breach coalesce into one incident that every member joins, one
    merged ``incident_<id>.json``.

Exits 1 unless: exactly one incident, its dump holding records with
spans from >= 3 processes; >= 1 trace id crossing client -> primary ->
backup; the hub's counter totals bitwise the sum of every member's final
counters; the alerts exactly the scripted breach, the STALL fired.

    python -m paddle_tpu_torch.tools.cluster_obs_drill [--device cpu]
    python -m paddle_tpu_torch.tools.cluster_obs_drill --self-check

The client's tiny GPT serves and trains on ``--device`` (default the
card). Env knobs (defaults are the CPU-sized shape):
  CLUSTER_OBS_REQS=4        serve requests per round (2 rounds)
  CLUSTER_OBS_NEW=4         tokens generated per request
  CLUSTER_OBS_BATCH=2       records per training batch (divides REQS)
  CLUSTER_OBS_SEED=11       chaos seed
  CLUSTER_OBS_STALLS=6      scripted serve-beat STALL count
  CLUSTER_OBS_STALL_S=0.4   seconds per STALL (vs the 250 ms SLO)
  CLUSTER_OBS_DIR=          incident / dump dir (default: a temp dir)
"""
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]

N_SRV = 3
REQS = int(os.environ.get("CLUSTER_OBS_REQS", 4))
NEW = int(os.environ.get("CLUSTER_OBS_NEW", 4))
BATCH = int(os.environ.get("CLUSTER_OBS_BATCH", 2))
SEED = int(os.environ.get("CLUSTER_OBS_SEED", 11))
STALLS = int(os.environ.get("CLUSTER_OBS_STALLS", 6))
STALL_S = float(os.environ.get("CLUSTER_OBS_STALL_S", 0.4))

# the scripted breach: TTFT objective the STALL is sized to violate
TTFT_SLO_MS = 250.0
TTFT_OBJECTIVE = 0.05

# flag defaults the telemetry plane is written against; self_check pins
# them
TELEMETRY_FLAG_DEFAULTS = {
    "PADDLE_TELEMETRY_HUB": "",
    "PADDLE_TELEMETRY_FLUSH_S": 0.5,
    "PADDLE_TELEMETRY_SPAN_BUFFER": 2048,
    "PADDLE_TELEMETRY_INCIDENT_WINDOW_S": 10.0,
    "PADDLE_SLO_EVAL_S": 1.0,
    "PADDLE_SLO_FAST_WINDOW_S": 60.0,
    "PADDLE_SLO_SLOW_WINDOW_S": 300.0,
}

# the incident layout this drill reads (core/telemetry.INCIDENT_SCHEMA)
INCIDENT_SCHEMA = 1

FAST = dict(timeout=2.0, max_retries=2, backoff_base=0.01,
            backoff_max=0.05, connect_retry_s=5.0)
# a 2 s heartbeat deadline (the JAX package's drill uses 0.7 s): under a
# loaded host a live server missed beats that long and was promoted over
HB = dict(heartbeat_s=0.1, heartbeat_timeout_s=2.0)


def _say(obj):
    sys.stdout.write(json.dumps(obj, default=str) + "\n")
    sys.stdout.flush()


def _read_cmd():
    line = sys.stdin.readline()
    if not line:
        return {"cmd": "stop"}          # parent died: shut down clean
    return json.loads(line)


def _final_counters():
    from ..core import monitor
    snap = monitor.snapshot(include_series=False)
    return {n: snap["values"][n] for n, t in snap["types"].items()
            if t == "counter"}


# --------------------------------------------------------------------------
# member processes
# --------------------------------------------------------------------------

def member_server(idx, hub_ep, dim):
    """One replicated PS shard server + telemetry shipper, driven over
    stdin/stdout by the drill parent."""
    from ..core import telemetry
    from ..distributed.ps import PSServer, ShardMap
    from ..testing import faults

    srv = PSServer("127.0.0.1:0", {"wte": {"type": "geo_sparse",
                                           "dim": dim, "init": "zeros"}})
    ep = srv.start()
    _say({"ep": ep})
    cmd = _read_cmd()                                 # {"cmd": "enable"}
    eps = cmd["eps"]
    smap = ShardMap.create(eps, n_backups=1)
    srv.enable_replication(shard_map=smap, peers=eps, n_backups=1,
                           rpc_opts=dict(FAST), **HB)
    _say({"enabled": True})
    _read_cmd()                                       # {"cmd": "arm"}
    # armed only once the fleet is settled and the client is warm:
    # bring-up races must not open the incident — the drill's incident
    # is the scripted mid-traffic breach, with every ring full of the
    # client<->primary<->backup traffic the stitcher needs
    shipper = telemetry.TelemetryShipper(
        hub_ep, member_id=f"server{idx}", role=f"server{idx}",
        peers=eps, flush_s=0.2).start()
    # seeded reply-DROP chaos: the applied-but-lost case replay exists
    # for, fired from the server side of every member's traffic
    inj = faults.FaultInjector(seed=100 + idx, p={faults.DROP: 0.02})
    faults.install(inj)
    _say({"ready": True})
    killed = False
    while True:
        cmd = _read_cmd()
        if cmd["cmd"] == "kill":
            faults.uninstall()
            srv.shutdown()                 # permanent: process survives
            killed = True                  # to drain + report
            _say({"ack": "kill"})
        elif cmd["cmd"] == "stop":
            break
    if not killed:
        faults.uninstall()
        srv.shutdown()
    drained = shipper.close(drain_timeout=20.0)
    _say({"stats": _final_counters(), "drained": drained,
          "dropped_replies": inj.fired(faults.DROP)})
    return 0


def member_client(eps, hub_ep, device="gpu"):
    """The serve + online-train member: a tiny-GPT ServeLoop feeding a
    StreamingDataset feeding the continuous Downpour trainer, run under
    seeded RESET chaos plus the scripted serve-beat STALL, riding the
    shard-0 primary kill mid-run."""
    import paddle_tpu_torch as paddle
    from .. import nn, optimizer, static
    from ..core import monitor, telemetry
    from ..dataset import StreamingDataset
    from ..distributed.ps import EmbeddingPrefetcher, PSClient
    from ..inference import ServeConfig, ServeLoop
    from ..testing import faults
    from ..text.models.gpt import GPT, GPTConfig
    from ..traffic import harness

    paddle.set_device(device)
    paddle.seed(0)
    cfg = GPTConfig.tiny()
    gpt = GPT(cfg)
    gpt.eval()
    vocab, dim = cfg.vocab_size, cfg.hidden_size
    target = np.random.RandomState(77).uniform(
        -0.5, 0.5, (vocab, dim)).astype(np.float32)

    def _collate(recs):
        ids = np.concatenate([np.asarray(r["prompt"] + r["tokens"],
                                         np.int64) for r in recs])
        return {"ids": ids, "target": target[ids]}

    ds = StreamingDataset(batch_size=BATCH, collate=_collate,
                          name="cluster_obs_drill")
    loop = ServeLoop(gpt, ServeConfig(max_active=4, kv_blocks=16,
                                      block_size=16, max_seq_len=64),
                     on_complete=ds.offer)

    paddle.enable_static()
    prog = static.Program("cluster_obs_drill")
    with static.program_guard(prog):
        ids_v = static.data("ids", [-1], "int64")
        tgt_v = static.data("target", [-1, dim], "float32")
        emb = nn.Embedding(vocab, dim)
        diff = emb(ids_v) - tgt_v
        loss = paddle.ops.mean(paddle.ops.sum(diff * diff, axis=-1))
        optimizer.SGD(learning_rate=0.25).minimize(loss)
    emb_name = emb.weight.scope_name
    exe = static.Executor()
    client_t = PSClient(eps, **FAST)
    window = harness.Window(ds)
    holder = {}
    state = None

    def serve_phase(k):
        rng = np.random.RandomState(1000 + k)
        prompts = [rng.randint(0, 48, 4).astype(np.int64)
                   for _ in range(REQS)]
        stats = harness.drive_serve(
            loop, harness.submissions_from_prompts(prompts, NEW),
            wait="idle+result", result_timeout_s=300.0)
        if stats.errors:      # parent records the crash as a violation
            raise RuntimeError("; ".join(stats.errors))

    def train_phase(n_batches):
        nonlocal state
        pf = EmbeddingPrefetcher(client_t, table="wte")
        ps_cfg = {"client": client_t, "mode": "online", "sync_every": 1,
                  "trainer_id": 7,
                  "sparse": [{"param": emb_name, "slot": "ids",
                              "table": "wte", "prefetcher": pf}],
                  "on_batch": lambda d: holder.update(drv=d)}
        if state is not None:
            ps_cfg["state"] = state
        exe.train_from_dataset(
            program=prog, dataset=window.take(n_batches),
            ps_config=ps_cfg,
            start_batch=ds.stats()["delivered_batches"])
        state = holder["drv"].online_state()
        try:
            pf.close()
        except Exception:
            pass

    # warmup outside the measured window: first launches (prefill
    # bucket, decode step, the train step's lowering) would otherwise
    # pollute the TTFT histogram the SLO judges and the counters the hub
    # totals
    serve_phase(99)
    train_phase(REQS // BATCH)
    monitor.reset()

    shipper = telemetry.TelemetryShipper(
        hub_ep, member_id="client", role="client", peers=eps,
        flush_s=0.2).start()
    _say({"ready": True})

    _read_cmd()                    # {"cmd": "go"}: the fleet is armed
    stall = faults.Fault("serve", "beat", faults.STALL, method="tick",
                         after=0, times=STALLS, delay=STALL_S)
    with faults.inject(stall, seed=SEED,
                       p={faults.RESET: 0.02}) as inj:
        # round A: the scripted STALL lands on the first measured beats,
        # so every round-A request's TTFT blows the 250ms objective
        serve_phase(0)
        train_phase(REQS // BATCH)
        _say({"phase_a": True})            # parent kills the primary now
        _read_cmd()                        # {"cmd": "go"}
        # round B: clean-latency traffic THROUGH the failover
        serve_phase(1)
        train_phase(REQS // BATCH)
        stall_fired = inj.fired(faults.STALL)
        reset_fired = inj.fired(faults.RESET)
    client_t.close()
    paddle.disable_static()
    drained = shipper.close(drain_timeout=20.0)
    _say({"stats": _final_counters(), "drained": drained,
          "stall_fired": stall_fired, "reset_fired": reset_fired})
    return 0


# --------------------------------------------------------------------------
# parent / orchestrator
# --------------------------------------------------------------------------

def _spawn(argv, dump_dir):
    env = dict(os.environ, PADDLE_TPU_DUMP_DIR=dump_dir)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.cluster_obs_drill"]
        + argv,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        bufsize=1, env=env)


def _await(proc, key, timeout=300.0, label=""):
    """Read stdout lines until a JSON object with `key` appears."""
    deadline = time.monotonic() + timeout
    out = {}

    def _pump():
        while True:
            line = proc.stdout.readline()
            if not line:
                return
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if key in obj:
                out.update(obj)
                return

    t = threading.Thread(target=_pump, daemon=True)
    t.start()
    t.join(max(0.0, deadline - time.monotonic()))
    if key not in out:
        raise TimeoutError(
            f"cluster_obs_drill: {label or key} not reported within "
            f"{timeout}s (member exited: {proc.poll()})")
    return out


def _send(proc, obj):
    proc.stdin.write(json.dumps(obj) + "\n")
    proc.stdin.flush()


def run(device="gpu"):
    from ..core import slo, telemetry

    dump_dir = os.environ.get("CLUSTER_OBS_DIR") or tempfile.mkdtemp(
        prefix="cluster_obs_")
    specs = [
        slo.SLOSpec("serve_ttft", "latency", "serve/ttft_ms",
                    objective=TTFT_OBJECTIVE, threshold_ms=TTFT_SLO_MS,
                    description="95% of TTFTs under 250ms"),
        # deliberately lenient: proves the engine stays silent on specs
        # the scripted fault does not violate
        slo.SLOSpec("ps_deadline_budget", "rate",
                    "ps.rpc.deadline_exceeded", objective=50.0,
                    description="under 50 deadline-exceeded per second"),
    ]
    hub = telemetry.TelemetryHub(
        specs=specs, dump_dir=dump_dir, fast_s=1.5, slow_s=6.0,
        eval_s=0.2, incident_window_s=90.0)
    violations = []
    servers = []
    client = None
    member_stats = {}
    chains = []
    inc = None
    # the embedding width is GPTConfig.tiny().hidden_size; resolve it
    # here once so every server builds its table with the right dim
    from ..text.models.gpt import GPTConfig
    dim = GPTConfig.tiny().hidden_size
    t0 = time.perf_counter()
    try:
        servers = [_spawn(["--member", f"server{i}", "--hub",
                           hub.endpoint, "--dim", str(dim)], dump_dir)
                   for i in range(N_SRV)]
        eps = [_await(p, "ep", label=f"server{i} endpoint")["ep"]
               for i, p in enumerate(servers)]
        for p in servers:
            _send(p, {"cmd": "enable", "eps": eps})
        for i, p in enumerate(servers):
            _await(p, "enabled", label=f"server{i} replication")
        print(f"# fleet up: {eps} (hub {hub.endpoint})", file=sys.stderr)

        client = _spawn(["--member", "client", "--hub", hub.endpoint,
                         "--eps", ",".join(eps), "--device", device],
                        dump_dir)
        _await(client, "ready", label="client warmup")
        # arm shippers + chaos only now: the incident must open on the
        # scripted breach, with warm rings behind every member record
        for p in servers:
            _send(p, {"cmd": "arm"})
        for i, p in enumerate(servers):
            _await(p, "ready", label=f"server{i} armed")
        _send(client, {"cmd": "go"})
        print("# client warm; round A (scripted STALL) begins",
              file=sys.stderr)
        _await(client, "phase_a", label="round A")
        print("# round A done; killing shard-0 primary", file=sys.stderr)
        _send(servers[0], {"cmd": "kill"})
        _await(servers[0], "ack", label="primary kill")
        _send(client, {"cmd": "go"})
        crep = _await(client, "stats", label="client finish")
        member_stats = {"client": crep}
        for i, p in enumerate(servers):
            _send(p, {"cmd": "stop"})
        for i, p in enumerate(servers):
            member_stats[f"server{i}"] = _await(
                p, "stats", label=f"server{i} finish")
        for p in [client] + servers:
            p.stdin.close()
            p.wait(timeout=60)
    except Exception as e:
        violations.append(f"drill run failed: {type(e).__name__}: {e}")
    finally:
        for p in [c for c in [client] + servers if c is not None]:
            if p.poll() is None:
                p.kill()

    snapshot = hub.snapshot()
    incidents = hub.incidents()
    hub.stop()

    if not violations:
        # ---- every member drained: the accounting below is closed ----
        for m, rep in member_stats.items():
            if not rep.get("drained"):
                violations.append(f"{m} failed to drain its shipper")

        # ---- exactly ONE incident, merged dump from >= 3 processes ----
        if len(incidents) != 1:
            violations.append(
                f"expected exactly 1 incident, got {len(incidents)}: "
                f"{[(i, v['reason']) for i, v in incidents.items()]}")
        inc_path = None
        if incidents:
            iid = next(iter(incidents))
            inc_path = os.path.join(dump_dir, f"incident_{iid}.json")
            try:
                with open(inc_path) as f:
                    inc = json.load(f)
            except OSError as e:
                violations.append(f"merged incident file missing: {e}")
        if inc is not None:
            with_spans = {m: r for m, r in inc["members"].items()
                          if (r or {}).get("spans")}
            pids = {r["pid"] for r in with_spans.values()}
            if len(pids) < 3:
                violations.append(
                    f"incident has span-bearing records from only "
                    f"{len(pids)} process(es): {sorted(with_spans)}")
            # ---- >= 1 trace id crossing client -> primary -> backup ----
            chains = telemetry.stitch_incident(inc)
            crossing = [
                c for c in chains
                if len(c["members"]) >= 3 and "client" in c["roles"]
                and len({r for r in c["roles"]
                         if r.startswith("server")}) >= 2]
            if not crossing:
                violations.append(
                    "no trace id crosses client -> primary -> backup "
                    f"(chains: {[(c['trace_id'], c['roles']) for c in chains[:5]]})")

        # ---- exactly-once: hub totals == sum of member finals ----
        expected = {}
        for m, rep in member_stats.items():
            for name, v in (rep.get("stats") or {}).items():
                expected[name] = expected.get(name, 0.0) + v
        hub_counters = snapshot["counters"]
        for name in sorted(set(expected) | set(hub_counters)):
            want = expected.get(name, 0.0)
            got = hub_counters.get(name, 0.0)
            if want != got:
                violations.append(
                    f"counter {name}: hub total {got!r} != member sum "
                    f"{want!r} — exactly-once shipping broken")

        # ---- the alert stream is exactly the scripted breach ----
        slos_fired = {a["slo"] for a in snapshot["alerts"]}
        if "serve_ttft" not in slos_fired:
            violations.append(
                "the scripted STALL did not breach serve_ttft "
                f"(alerts: {snapshot['alerts']})")
        if slos_fired - {"serve_ttft"}:
            violations.append(
                f"unscripted SLO(s) breached: "
                f"{sorted(slos_fired - {'serve_ttft'})}")
        if not member_stats.get("client", {}).get("stall_fired"):
            violations.append("the scripted serve-beat STALL never fired")

    report = {
        "tool": "paddle_tpu_torch.tools.cluster_obs_drill",
        "servers": N_SRV,
        "hub": hub.endpoint,
        "incidents": len(incidents),
        "incident_members": sorted(
            next(iter(incidents.values()))["members"]) if incidents
        else [],
        "cross_process_chains": len(chains),
        "alerts": [a["slo"] for a in snapshot["alerts"]],
        "hub_counter_names": len(snapshot["counters"]),
        "stall_fired": member_stats.get("client", {}).get("stall_fired"),
        "reset_fired": member_stats.get("client", {}).get("reset_fired"),
        "dump_dir": dump_dir,
        "wall_s": round(time.perf_counter() - t0, 3),
        "violations": len(violations),
    }
    print(json.dumps(report, indent=1))
    for v in violations[:10]:
        print("VIOLATION:", v, file=sys.stderr)
    return 1 if violations else 0


# --------------------------------------------------------------------------
# framework_lint cross-check (TOOL_CROSS_CHECKS)
# --------------------------------------------------------------------------

def self_check():
    """Telemetry / SLO flag defaults against this drill's pins, the
    incident schema, and the serve / window plumbing from the harness.
    Returns violations."""
    problems = []
    from ..core import flags as _flags
    from ..core import telemetry
    for name, want in TELEMETRY_FLAG_DEFAULTS.items():
        defn = _flags._DEFS.get(name)
        if defn is None:
            problems.append(f"cluster_obs_drill: flag {name} is no "
                            "longer defined in core/flags.py")
        elif defn[1] != want:
            problems.append(
                f"cluster_obs_drill: {name} default drifted "
                f"({defn[1]!r} != {want!r}); update "
                "TELEMETRY_FLAG_DEFAULTS")
    if telemetry.INCIDENT_SCHEMA != INCIDENT_SCHEMA:
        problems.append(
            f"cluster_obs_drill: telemetry.INCIDENT_SCHEMA "
            f"{telemetry.INCIDENT_SCHEMA} != {INCIDENT_SCHEMA}, the "
            "schema this drill reads")
    with open(os.path.abspath(__file__)) as f:
        self_src = f.read()
    for token in ("harness.drive_serve", "harness.Window"):
        if token not in self_src:
            problems.append(f"cluster_obs_drill: the serve / window "
                            f"plumbing must come from traffic.harness "
                            f"(`{token}` missing)")
    return problems


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-check" in argv or "--self_check" in argv:
        problems = self_check()
        for p in problems:
            print(p)
        print("cluster_obs_drill self-check:",
              "clean" if not problems else f"{len(problems)} problem(s)")
        return 1 if problems else 0
    if "--member" in argv:
        member = argv[argv.index("--member") + 1]
        hub_ep = argv[argv.index("--hub") + 1]
        if member == "client":
            eps = argv[argv.index("--eps") + 1].split(",")
            return member_client(eps, hub_ep,
                                 argv[argv.index("--device") + 1])
        dim = int(argv[argv.index("--dim") + 1])
        return member_server(int(member.replace("server", "")), hub_ep,
                             dim)
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "gpu"
    return run(device)


if __name__ == "__main__":
    sys.exit(main())
