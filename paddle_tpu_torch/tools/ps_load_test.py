"""PS transport throughput (tools/ps_load_test.py for the port).

N worker threads x M rounds of pull_sparse + push_sparse_grad of
realistic batches against a local PSServer; reports rows/sec per op and
aggregate, and the per-round latency percentiles (core.slo). The servers
are the port's numpy copies (``distributed/ps``), so the numbers measure
the transport, the same frames the JAX package's servers speak.

    python -m paddle_tpu_torch.tools.ps_load_test [--self-check]

Modes (env):
  PS_LOAD_CHAOS=<seed>  throughput under seeded resets + dropped replies
                        (the retry / replay path's overhead).
  PS_LOAD_FAILOVER=1    a 3-server / 1-backup cluster under worker load,
                        one primary killed mid-run: promotion latency,
                        the ps.replica.* counters, rows/sec through the
                        outage; workers must finish with zero errors.
  PS_LOAD_SHARDED=1     workers train through the full engine (batched
                        cross-shard lookups, the HeterPS cache, the async
                        prefetch) against 3 shard servers with 1 backup
                        each, one primary killed mid-run: per-shard
                        rows/s, cache hit rate, prefetch overlap,
                        promotion latency; zero worker errors required.
Sizes: PS_LOAD_DIM (16), PS_LOAD_WORKERS (4), PS_LOAD_ROUNDS (50),
PS_LOAD_BATCH (2048), PS_LOAD_SERVERS (3), PS_LOAD_HB_S (0.1),
PS_LOAD_HB_TIMEOUT_S (0.7), PS_LOAD_CACHE_ROWS (8192), PS_LOAD_DEVICE
(the sharded drill's cache device; default the card).
"""
import os
import sys
import time

import numpy as np

from ..distributed.ps import PSClient, PSServer

VOCAB = 200_000
DIM = int(os.environ.get("PS_LOAD_DIM", 16))
WORKERS = int(os.environ.get("PS_LOAD_WORKERS", 4))
ROUNDS = int(os.environ.get("PS_LOAD_ROUNDS", 50))
BATCH_IDS = int(os.environ.get("PS_LOAD_BATCH", 2048))

# failover-drill knobs (PS_LOAD_FAILOVER mode); the heartbeat pair is
# deliberately faster than the PADDLE_PS_HEARTBEAT_* defaults
FAILOVER_SERVERS = int(os.environ.get("PS_LOAD_SERVERS", 3))
FAILOVER_HB_S = float(os.environ.get("PS_LOAD_HB_S", 0.1))
FAILOVER_HB_TIMEOUT_S = float(os.environ.get("PS_LOAD_HB_TIMEOUT_S", 0.7))

# sharded-embedding-drill cache bound (PS_LOAD_SHARDED mode): small
# enough that the random workload exercises LRU eviction + the host tier
SHARDED_CACHE_ROWS = int(os.environ.get("PS_LOAD_CACHE_ROWS", 8192))
# where the sharded drill's device cache lives (default: the current
# device, the card)
DEVICE = os.environ.get("PS_LOAD_DEVICE") or None

# flag defaults this tool is written against; self_check pins them
REPLICA_FLAG_DEFAULTS = {
    "PADDLE_PS_REPLICA_BACKUPS": 0,
    "PADDLE_PS_REPLICA_QUORUM": 0,
    "PADDLE_PS_REPLICA_DELTA_LOG": 512,
    "PADDLE_PS_HEARTBEAT_S": 0.5,
    "PADDLE_PS_HEARTBEAT_TIMEOUT_S": 3.0,
    "PADDLE_PS_FAILOVER_RETRIES": 8,
    "PADDLE_PS_FAILOVER_BACKOFF_S": 0.25,
    # sharded embedding engine (PS_LOAD_SHARDED drill)
    "PADDLE_PS_FANOUT_THREADS": 4,
    "PADDLE_PS_PREFETCH_DEPTH": 2,
    "PADDLE_PS_HETER_CACHE_ROWS": 65536,
    "PADDLE_PS_HETER_HOST_ROWS": 262144,
}


def run_worker(endpoints, wid, results):
    client = PSClient(endpoints)
    rng = np.random.RandomState(wid)
    pulled = pushed = 0
    round_ms = []
    t0 = time.perf_counter()
    for _ in range(ROUNDS):
        tr = time.perf_counter()
        ids = np.unique(rng.randint(0, VOCAB, BATCH_IDS).astype(np.int64))
        rows = client.pull_sparse("emb", ids)
        pulled += len(ids)
        grads = np.asarray(rows, np.float32) * 0 + 0.01
        client.push_sparse_grad("emb", ids, grads)
        pushed += len(ids)
        round_ms.append((time.perf_counter() - tr) * 1e3)
    dt = time.perf_counter() - t0
    results[wid] = (pulled, pushed, dt, round_ms)
    client.close()


def run_failover():
    """PS_LOAD_FAILOVER: kill-and-promote under load. Reports the
    promotion latency (kill -> ps.replica.promotions tick), replica
    counters, and aggregate rows/sec through the outage."""
    from ..core import monitor
    from ..distributed.ps import ShardMap

    spec = {"emb": {"type": "sparse", "dim": DIM, "optimizer": "sgd",
                    "lr": 0.1, "init": "zeros"}}
    servers = [PSServer("127.0.0.1:0", dict(spec))
               for _ in range(FAILOVER_SERVERS)]
    eps = [s.start() for s in servers]
    smap = ShardMap.create(eps, n_backups=1)
    fast = dict(timeout=5.0, max_retries=2, backoff_base=0.01,
                backoff_max=0.05)
    for s in servers:
        s.enable_replication(shard_map=smap, peers=eps, n_backups=1,
                             heartbeat_s=FAILOVER_HB_S,
                             heartbeat_timeout_s=FAILOVER_HB_TIMEOUT_S,
                             rpc_opts=dict(fast))

    errors = []
    results = {}

    def worker(wid):
        client = PSClient(eps, **fast)
        rng = np.random.RandomState(wid)
        pushed = 0
        t0 = time.perf_counter()
        try:
            for _ in range(ROUNDS):
                ids = np.unique(rng.randint(0, VOCAB, BATCH_IDS)
                                .astype(np.int64))
                rows = client.pull_sparse("emb", ids)
                client.push_sparse_grad(
                    "emb", ids, np.asarray(rows, np.float32) * 0 + 0.01)
                pushed += len(ids)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"worker {wid}: {type(e).__name__}: {e}")
        results[wid] = (pushed, time.perf_counter() - t0)
        client.close()

    from ..traffic import harness
    pool = harness.run_worker_pool(worker, WORKERS, kill_after_s=0.5,
                                   on_kill=servers[0].shutdown)
    promote_latency = pool.promote_latency_s
    wall = pool.wall_s
    for s in servers[1:]:
        s.shutdown()

    total = sum(r[0] for r in results.values())
    replica = {k: int(v) for k, v in
               sorted(monitor.stats("ps.replica.").items())}
    print(f"failover drill: {FAILOVER_SERVERS} servers, 1 backup, "
          f"{WORKERS} workers x {ROUNDS} rounds, primary killed at 0.5s")
    print(f"promotion latency: "
          f"{'NONE RECORDED' if promote_latency is None else f'{promote_latency * 1000:.0f}ms'}"
          f" (heartbeat {FAILOVER_HB_S}s, deadline "
          f"{FAILOVER_HB_TIMEOUT_S}s)")
    print(f"rows pushed through the outage: {total:,} "
          f"({total / wall:,.0f} rows/sec aggregate)")
    print(f"replica counters: {replica}")
    if errors:
        print("worker errors:\n  " + "\n  ".join(errors))
        return 1
    if promote_latency is None:
        print("ERROR: no promotion was recorded")
        return 1
    print("all workers finished with zero errors")
    return 0


def run_sharded():
    """PS_LOAD_SHARDED: the full sharded-embedding engine under load +
    a kill-one-shard-primary drill. Workers pull through
    EmbeddingPrefetcher -> HeterPSCache -> PSClient's cross-shard
    fan-out and push merged grads back; shard 0's primary dies mid-run.
    Reports per-shard rows/s, cache hit rate, prefetch overlap ratio,
    promotion latency, and the replica counters."""
    from ..core import monitor
    from ..distributed.ps import (EmbeddingPrefetcher,
                                           HeterPSCache, ShardMap)

    spec = {"emb": {"type": "sparse", "dim": DIM, "optimizer": "sgd",
                    "lr": 0.1, "init": "uniform", "seed": 7}}
    servers = [PSServer("127.0.0.1:0", dict(spec))
               for _ in range(FAILOVER_SERVERS)]
    eps = [s.start() for s in servers]
    smap = ShardMap.create(eps, n_backups=1)
    fast = dict(timeout=5.0, max_retries=2, backoff_base=0.01,
                backoff_max=0.05)
    for s in servers:
        s.enable_replication(shard_map=smap, peers=eps, n_backups=1,
                             heartbeat_s=FAILOVER_HB_S,
                             heartbeat_timeout_s=FAILOVER_HB_TIMEOUT_S,
                             rpc_opts=dict(fast))

    errors = []
    results = {}

    def worker(wid):
        client = PSClient(eps, **fast)
        cache = HeterPSCache(client, "emb", DIM,
                             capacity=SHARDED_CACHE_ROWS, device=DEVICE)
        pf = EmbeddingPrefetcher(cache)
        rng = np.random.RandomState(wid)
        batches = [np.unique(rng.randint(0, VOCAB, BATCH_IDS)
                             .astype(np.int64)) for _ in range(ROUNDS)]
        pulled = 0
        # per-worker shard tally, merged after join — a shared
        # read-modify-write across worker threads would lose updates
        my_shard_rows = np.zeros(FAILOVER_SERVERS, np.int64)
        t0 = time.perf_counter()
        try:
            pf.prefetch(batches[0])
            for r in range(ROUNDS):
                ids = batches[r]
                rows = pf.get(ids)
                if r + 1 < ROUNDS:
                    pf.prefetch(batches[r + 1])
                pulled += len(ids)
                my_shard_rows += np.bincount(ids % FAILOVER_SERVERS,
                                             minlength=FAILOVER_SERVERS)
                pf.push_grad(ids, np.asarray(rows, np.float32) * 0 + 0.01)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"worker {wid}: {type(e).__name__}: {e}")
        finally:
            stats = pf.stats()
            try:
                pf.close()
            except Exception:
                pass
            client.close()
        results[wid] = (pulled, time.perf_counter() - t0, stats,
                        my_shard_rows)

    from ..traffic import harness
    pool = harness.run_worker_pool(worker, WORKERS, kill_after_s=0.5,
                                   on_kill=servers[0].shutdown)
    promote_latency = pool.promote_latency_s
    wall = pool.wall_s
    for s in servers[1:]:
        s.shutdown()

    total = sum(r[0] for r in results.values())
    shard_rows = np.sum([r[3] for r in results.values()], axis=0) \
        if results else np.zeros(FAILOVER_SERVERS, np.int64)
    hits = monitor.stat_get("ps.heter.hits")
    host_hits = monitor.stat_get("ps.heter.host_hits")
    misses = monitor.stat_get("ps.heter.misses")
    hit_rate = (hits + host_hits) / max(1, hits + host_hits + misses)
    overlaps = [r[2]["overlap_ratio"] for r in results.values()
                if r[2].get("pull_s")]
    print(f"sharded-embedding drill: {FAILOVER_SERVERS} shard servers, "
          f"1 backup each, {WORKERS} workers x {ROUNDS} rounds, shard-0 "
          "primary killed at 0.5s")
    print(f"promotion latency: "
          f"{'NONE RECORDED' if promote_latency is None else f'{promote_latency * 1000:.0f}ms'}"
          f" (heartbeat {FAILOVER_HB_S}s, deadline "
          f"{FAILOVER_HB_TIMEOUT_S}s)")
    print(f"rows pulled through the engine: {total:,} "
          f"({total / wall:,.0f} rows/sec aggregate)")
    for s in range(FAILOVER_SERVERS):
        print(f"  shard {s}: {int(shard_rows[s]):,} rows "
              f"({shard_rows[s] / wall:,.0f} rows/sec)")
    print(f"cache hit rate: {hit_rate:.1%} "
          f"(device {hits:,} + host {host_hits:,} hits, {misses:,} "
          "PS misses)")
    if overlaps:
        print(f"prefetch overlap ratio: {sum(overlaps) / len(overlaps):.2f}"
              f" (mean across {len(overlaps)} workers)")
    replica = {k: int(v) for k, v in
               sorted(monitor.stats("ps.replica.").items())}
    print(f"replica counters: {replica}")
    if errors:
        print("worker errors:\n  " + "\n  ".join(errors))
        return 1
    if promote_latency is None:
        print("ERROR: no promotion was recorded")
        return 1
    print("all workers finished with zero errors")
    return 0


def self_check():
    """Flag defaults against this tool's table; the percentiles and the
    worker pool from the shared modules. Returns a list of violations."""
    problems = []
    from ..core import flags as _flags
    for name, want in REPLICA_FLAG_DEFAULTS.items():
        defn = _flags._DEFS.get(name)
        if defn is None:
            problems.append(f"ps_load_test: flag {name} is no longer "
                            "defined in core/flags.py")
            continue
        if defn[1] != want:
            problems.append(
                f"ps_load_test: {name} default drifted "
                f"({defn[1]!r} != {want!r}); update REPLICA_FLAG_DEFAULTS")
    with open(os.path.abspath(__file__)) as f:
        self_src = f.read()
    if "from ..core.slo import percentile" not in self_src:
        problems.append("ps_load_test: round-latency percentiles must "
                        "come from core.slo.percentile")
    if "harness.run_worker_pool" not in self_src:
        problems.append("ps_load_test: the worker pool / kill-and-promote "
                        "loop must be traffic.harness.run_worker_pool")
    return problems


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--self-check" in argv or "--self_check" in argv:
        problems = self_check()
        for p in problems:
            print(p)
        print("ps_load_test self-check:",
              "clean" if not problems else f"{len(problems)} problem(s)")
        return 1 if problems else 0
    if os.environ.get("PS_LOAD_SHARDED"):
        return run_sharded()
    if os.environ.get("PS_LOAD_FAILOVER"):
        return run_failover()
    srv = PSServer(tables={
        "emb": {"type": "sparse", "dim": DIM, "optimizer": "sgd",
                "lr": 0.1, "init": "zeros"}})
    srv.start()
    # PS_LOAD_CHAOS=<seed> measures throughput UNDER seeded faults
    # (resets + dropped replies), i.e. the retry/replay path's overhead
    chaos_seed = os.environ.get("PS_LOAD_CHAOS")
    if chaos_seed is not None:
        from ..testing import faults
        faults.install(faults.FaultInjector(
            seed=chaos_seed, p={faults.RESET: 0.01, faults.DROP: 0.01}))
    try:
        endpoints = [srv.endpoint]
        results = {}
        from ..traffic import harness
        wall = harness.run_worker_pool(
            lambda wid: run_worker(endpoints, wid, results),
            WORKERS).wall_s
    finally:
        srv.shutdown()

    total_pulled = sum(r[0] for r in results.values())
    total_pushed = sum(r[1] for r in results.values())
    rows_sec = (total_pulled + total_pushed) / wall
    pull_sec = total_pulled / wall
    push_sec = total_pushed / wall
    print(f"workers={WORKERS} rounds={ROUNDS} batch~{BATCH_IDS} dim={DIM}")
    print(f"pull rows/sec: {pull_sec:,.0f}")
    print(f"push rows/sec: {push_sec:,.0f}")
    print(f"aggregate rows/sec: {rows_sec:,.0f} (wall {wall:.2f}s)")
    # per-round (pull+push) latency through the SHARED estimator
    # (core/slo.py) so this line is comparable with serve_load_test's
    # ttft percentiles and online_drill's round percentiles
    from ..core.slo import percentile
    round_ms = [ms for r in results.values() for ms in r[3]]
    print(f"round latency ms: p50={percentile(round_ms, 50, ndigits=3)} "
          f"p99={percentile(round_ms, 99, ndigits=3)} "
          f"(n={len(round_ms)})")
    from ..core import monitor
    health = {k: int(v) for k, v in sorted(monitor.stats("ps.").items())}
    print(f"transport health counters: {health or 'all zero'}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
