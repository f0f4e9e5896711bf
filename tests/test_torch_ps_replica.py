"""Port counterpart of tests/test_ps_replica.py: the replicated PS
storage tier of the port (paddle_tpu_torch/distributed/ps/{shard_map,
replica}.py) survives a permanent server death. Every check is exact
(bitwise tables, exact ``applied`` counters); no tolerance. Contract under
test:

- the default shard map reproduces legacy modulo routing bit-for-bit;
- a primary forwards every mutation to its backups under the client's
  replay id, so promotion + client retry keeps exactly-once;
- a stale-epoch client gets a clean ShardMapStale redirect (one round
  trip, never cached in the replay cache) and re-routes;
- heartbeat loss promotes the first live backup, bumps the epoch, and
  clients transparently re-route (ConnectRefused fails over, not dies);
- a restarted server rejoins via snapshot + replay-keyed delta log;
- THE acceptance proof: training on a 3-server/1-backup cluster with
  one primary killed PERMANENTLY mid-run under seeded RESET/DROP chaos
  ends bitwise-equal to the fault-free run, with >=1 recorded promotion
  and zero double-applies (table.applied exact).
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed.ps import (ConnectRefused, PSClient, PSServer,
                                       ShardMap, rpc)
from paddle_tpu_torch.testing import faults

pytestmark = pytest.mark.chaos

DIM = 4

# tight-but-safe chaos timings + a failover window that outlasts the
# heartbeat deadline below. The deadline is 2 s, not the JAX suite's
# 0.7 s: under a loaded test host a live server can miss beats for most
# of a second, and a false suspicion promotes a backup beside a living
# primary. The client's failover loop (PADDLE_PS_FAILOVER_RETRIES x
# PADDLE_PS_FAILOVER_BACKOFF_S, ~6.5 s) still outlasts it.
FAST = dict(timeout=5.0, max_retries=2, backoff_base=0.01,
            backoff_max=0.05, connect_retry_s=5.0)
HB = dict(heartbeat_s=0.1, heartbeat_timeout_s=2.0)


def _specs(optimizer="sgd", lr=1.0):
    return {"emb": {"type": "sparse", "dim": DIM, "optimizer": optimizer,
                    "lr": lr, "init": "zeros"},
            "dense0": {"type": "dense", "shape": (3, DIM),
                       "optimizer": "sgd", "lr": 0.1, "init": "zeros"}}


def _cluster(n=3, k=1, specs=None, **hb):
    """n replicated in-process servers on ephemeral ports sharing one
    chained shard map (shard i: primary i, backups the next k)."""
    servers = [PSServer("127.0.0.1:0", specs or _specs())
               for _ in range(n)]
    eps = [s.start() for s in servers]
    smap = ShardMap.create(eps, n_backups=k)
    opts = {**HB, **hb}
    for s in servers:
        s.enable_replication(shard_map=smap, peers=eps, n_backups=k,
                             rpc_opts=dict(FAST), **opts)
    return servers, eps


def _teardown(servers, *clients):
    for c in clients:
        try:
            c.close()
        except Exception:
            pass
    for s in servers:
        s.shutdown()


@pytest.fixture(autouse=True)
def _no_leftover_injector():
    yield
    faults.uninstall()


def _delta(before, name):
    return monitor.stat_get(name) - before.get(name, 0)


# ------------------------------------------------------------- shard map

def test_default_map_matches_legacy_modulo_routing():
    eps = ["h:1", "h:2", "h:3"]
    m = ShardMap.default(eps)
    assert m.epoch == 0 and m.n_shards == 3
    import zlib
    for i in range(12):
        assert m.primary(m.shard_of_id(i)) == eps[i % 3]
        assert m.backups(m.shard_of_id(i)) == []
    assert m.shard_of_name("w") == zlib.crc32(b"w") % 3


def test_map_promote_evict_attach_epochs():
    eps = ["h:1", "h:2", "h:3"]
    m = ShardMap.create(eps, n_backups=1)
    assert m.backups(0) == ["h:2"] and m.backups(2) == ["h:1"]
    m2 = m.without("h:1")
    assert m2.epoch == m.epoch + 1
    assert m2.primary(0) == "h:2" and m2.backups(0) == []
    assert m2.backups(2) == []          # h:1 dropped as backup too
    assert "h:1" not in m2.servers
    assert sorted(m2.under_replicated(1)) == [0, 2]
    m3 = m2.with_backup(0, "h:4")
    assert m3.epoch == m2.epoch + 1
    assert m3.backups(0) == ["h:4"] and "h:4" in m3.servers
    # round-trips through the plain-dict wire form
    assert ShardMap.from_dict(m3.to_dict()) == m3


# ----------------------------------------------------------- replication

def test_push_forwards_to_backup_exactly_once():
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    try:
        ids = np.array([0, 3], np.int64)          # shard 0 -> primary 0
        client.pull_sparse("emb", ids)
        before = monitor.stats("ps.replica.")
        client.push_sparse_grad("emb", ids, np.ones((2, DIM), np.float32))
        # applied on the primary AND on its backup (server 1), once each
        assert servers[0].table("emb").applied == 1
        assert servers[1].table("emb").applied == 1
        assert _delta(before, "ps.replica.forwards") >= 1
        np.testing.assert_array_equal(
            servers[1].table("emb").pull(ids),
            -np.ones((2, DIM), np.float32))
    finally:
        _teardown(servers, client)


def test_forward_rides_transport_faults_exactly_once():
    """DROP on the forward's reply: the backup applied, the primary's
    forward retry must replay — not double-apply on the backup."""
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    try:
        ids = np.array([0], np.int64)
        client.pull_sparse("emb", ids)
        with faults.inject(faults.Fault("server", "reply", faults.DROP,
                                        method="push_sparse_grad")) as inj:
            # the FIRST push_sparse_grad reply in the stream is the
            # backup's reply to the primary's forward (the forward runs
            # inside the primary's handler, before its own reply)
            client.push_sparse_grad("emb", ids,
                                    np.ones((1, DIM), np.float32))
        assert inj.fired(faults.DROP) == 1
        assert servers[0].table("emb").applied == 1
        assert servers[1].table("emb").applied == 1
        np.testing.assert_array_equal(
            servers[1].table("emb").pull(ids),
            -np.ones((1, DIM), np.float32))
    finally:
        _teardown(servers, client)


def test_stale_epoch_client_redirect_roundtrip():
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    try:
        ids = np.array([0], np.int64)
        client.pull_sparse("emb", ids)
        # bump the cluster's map behind the client's back: swap shard
        # 0's primary and backup, epoch+1
        old = servers[0].replica.shard_map
        d = old.to_dict()
        s0 = d["shards"][0]
        s0["primary"], s0["backups"] = s0["backups"][0], [s0["primary"]]
        d["epoch"] = old.epoch + 1
        for s in servers:
            s.replica.install(d)
        before = monitor.stats("ps.replica.")
        applied0 = [s.table("emb").applied for s in servers]
        client.push_sparse_grad("emb", ids, np.ones((1, DIM), np.float32))
        # the client was redirected once, adopted the new map, and the
        # push applied exactly once on the NEW primary (old backup)
        assert _delta(before, "ps.replica.stale_maps") >= 1
        assert client.shard_map.epoch == old.epoch + 1
        assert servers[1].table("emb").applied == applied0[1] + 1
        # forwarded back to the demoted server (now the backup)
        assert servers[0].table("emb").applied == applied0[0] + 1
    finally:
        _teardown(servers, client)


# -------------------------------------------------------------- failover

def test_promotion_under_concurrent_pushes_keeps_exactly_once():
    """Kill a primary while 4 threads push to its shard: every acked
    push applies exactly once (table.applied exact, values exact)."""
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    n_threads, n_pushes = 4, 30
    ids = np.array([0], np.int64)                 # shard 0
    client.pull_sparse("emb", ids)
    errors = []
    acked = [0] * n_threads

    def pusher(w):
        c = PSClient(eps, **FAST)
        try:
            for _ in range(n_pushes):
                c.push_sparse_grad("emb", ids,
                                   np.ones((1, DIM), np.float32))
                acked[w] += 1
                time.sleep(0.02)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)
        finally:
            c.close()

    threads = [threading.Thread(target=pusher, args=(w,))
               for w in range(n_threads)]
    try:
        before = monitor.stats("ps.replica.")
        for t in threads:
            t.start()
        time.sleep(0.15)
        servers[0].shutdown()                     # permanent kill
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert all(a == n_pushes for a in acked)
        assert _delta(before, "ps.replica.promotions") >= 1
        # the promoted backup holds EXACTLY sum(acked) applications
        total = n_threads * n_pushes
        assert servers[1].table("emb").applied == total
        np.testing.assert_array_equal(
            servers[1].table("emb").pull(ids),
            -float(total) * np.ones((1, DIM), np.float32))
    finally:
        _teardown(servers, client)


def test_ping_reports_per_server_health_with_dead_endpoint():
    servers, eps = _cluster(n=2)
    client = PSClient(eps, **FAST)
    try:
        assert all(isinstance(x, float) for x in client.ping())
        servers[1].shutdown()
        health = client.ping()                    # must NOT raise
        assert isinstance(health[0], float)
        assert health[1] is None
    finally:
        _teardown(servers, client)


def test_partition_fault_refuses_dial():
    """PARTITION: connect-refused at dial time, distinct from RESET
    mid-call — dead servers are scriptable without killing processes."""
    srv = PSServer(tables=_specs())
    ep = srv.start()
    try:
        with faults.inject(faults.Fault("client", "dial", faults.PARTITION,
                                        method=ep, times=99)) as inj:
            with pytest.raises(ConnectRefused):
                rpc.Connection(ep, connect_retry_s=1.0)
        assert inj.fired(faults.PARTITION) == 1
        # rule spent/uninstalled: the endpoint dials fine again
        c = rpc.Connection(ep, connect_retry_s=2.0)
        c.close()
    finally:
        srv.shutdown()


def test_double_failure_promotes_live_backup_not_corpse():
    """k=2: shard 0's primary AND first backup die together; the
    surviving second backup must converge on a map whose shard-0
    primary is ALIVE (itself) — never a corpse — and keep taking
    writes."""
    servers, eps = _cluster(n=3, k=2)
    client = PSClient(eps, **FAST)
    try:
        ids = np.array([0], np.int64)             # shard 0
        client.pull_sparse("emb", ids)
        client.push_sparse_grad("emb", ids, np.ones((1, DIM), np.float32))
        assert servers[2].table("emb").applied == 1   # k=2: everyone got it
        servers[0].shutdown()
        servers[1].shutdown()
        deadline = time.monotonic() + 10
        m = servers[2].replica.shard_map
        while time.monotonic() < deadline and (
                eps[0] in m.servers or eps[1] in m.servers):
            time.sleep(0.05)
            m = servers[2].replica.shard_map
        assert eps[0] not in m.servers and eps[1] not in m.servers
        assert m.primary(0) == eps[2]
        client.push_sparse_grad("emb", ids, np.ones((1, DIM), np.float32))
        assert servers[2].table("emb").applied == 2
        np.testing.assert_array_equal(
            servers[2].table("emb").pull(ids),
            -2.0 * np.ones((1, DIM), np.float32))
    finally:
        _teardown(servers, client)


def test_quorum_failure_keeps_rid_retryable_exactly_once():
    """PADDLE_PS_REPLICA_QUORUM=2 with a dead backup: the push fails
    WITHOUT poisoning its replay id (the error is never cached). After
    a replacement backup catches up, the retry under the SAME
    request_key succeeds forward-only: the primary never re-applies,
    and the backup — whose snapshot already covers the mutation —
    replays the forward instead of applying it twice."""
    from paddle_tpu_torch.core.flags import set_flags
    servers, eps = _cluster(n=2, k=1)
    client = PSClient(eps, **FAST)
    set_flags({"PADDLE_PS_REPLICA_QUORUM": 2})
    restarted = None
    try:
        ids = np.array([0], np.int64)       # shard 0: primary 0, backup 1
        client.pull_sparse("emb", ids)
        servers[1].shutdown()               # backup dies -> quorum 1/2
        with pytest.raises(RuntimeError, match="quorum not met"):
            client.push_sparse_grad("emb", ids,
                                    np.ones((1, DIM), np.float32),
                                    request_key="push-q")
        assert servers[0].table("emb").applied == 1   # applied locally once
        # an empty replacement joins and catches up (snapshot includes
        # the half-durable push + its rid)
        restarted = PSServer("127.0.0.1:0", _specs())
        restarted.start()
        restarted.enable_replication(peers=[servers[0].endpoint],
                                     n_backups=1, rpc_opts=dict(FAST),
                                     **HB)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and restarted.endpoint \
                not in servers[0].replica.shard_map.servers:
            time.sleep(0.05)
        assert restarted.endpoint in servers[0].replica.shard_map.servers
        # retry of the SAME logical call: quorum now met, exactly-once
        client.push_sparse_grad("emb", ids,
                                np.ones((1, DIM), np.float32),
                                request_key="push-q")
        assert servers[0].table("emb").applied == 1   # no second apply
        assert restarted.table("emb").applied == 0    # forward replayed
        np.testing.assert_array_equal(
            restarted.table("emb").pull(ids),
            servers[0].table("emb").pull(ids))
    finally:
        set_flags({"PADDLE_PS_REPLICA_QUORUM": 0})
        if restarted is not None:
            restarted.shutdown()
        _teardown(servers, client)


# ------------------------------------------------------ rejoin/catch-up

def test_rejoin_catches_up_snapshot_plus_deltas():
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    fresh = None
    try:
        ids = np.array([0, 3, 6], np.int64)       # shard 0
        client.pull_sparse("emb", ids)
        client.push_sparse_grad("emb", ids, np.ones((3, DIM), np.float32))
        # kill shard 0's primary; its backup (server 1) promotes
        servers[0].shutdown()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                eps[0] in servers[1].replica.shard_map.servers:
            time.sleep(0.05)
        assert eps[0] not in servers[1].replica.shard_map.servers
        # keep training against the promoted primary
        client.push_sparse_grad("emb", ids, np.ones((3, DIM), np.float32))
        before = monitor.stats("ps.replica.")
        # a REPLACEMENT server joins with empty tables + just peer
        # endpoints: bootstrap -> fetch snapshot -> attach -> deltas
        fresh = PSServer("127.0.0.1:0", _specs())
        fresh.start()
        live = [s.endpoint for s in servers[1:]]
        fresh.enable_replication(peers=live, n_backups=1,
                                 rpc_opts=dict(FAST), **HB)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and \
                fresh.endpoint not in servers[1].replica.shard_map.servers:
            time.sleep(0.05)
        m = servers[1].replica.shard_map
        assert fresh.endpoint in m.servers
        assert _delta(before, "ps.replica.catchups") >= 1
        # the rejoined backup's shard-0 rows are bitwise the primary's
        np.testing.assert_array_equal(
            fresh.table("emb").pull(ids),
            servers[1].table("emb").pull(ids))
        # and a NEW push forwards to it
        client.push_sparse_grad("emb", ids, np.ones((3, DIM), np.float32))
        np.testing.assert_array_equal(
            fresh.table("emb").pull(ids),
            servers[1].table("emb").pull(ids))
    finally:
        if fresh is not None:
            fresh.shutdown()
        _teardown(servers, client)


# ---------------------------------------- THE acceptance chaos training

N_STEPS = 24
KILL_STEP = 11
VOCAB = 60


def _train_steps(client, start, stop):
    """Deterministic 2-table loop; grads depend on PULLED state, so any
    lost or double-applied update poisons every later step."""
    for step in range(start, stop):
        rng = np.random.RandomState(1000 + step)
        ids = rng.randint(0, VOCAB, size=10).astype(np.int64)
        rows = client.pull_sparse("emb", ids)
        grads = rows * 0.05 + rng.randn(len(ids), DIM).astype(np.float32)
        client.push_sparse_grad("emb", ids, grads)
        dense = client.pull_dense("dense0")
        client.push_dense_grad(
            "dense0", dense * 0.05 + rng.randn(3, DIM).astype(np.float32))


def _final_state(client):
    all_ids = np.arange(VOCAB, dtype=np.int64)
    return (client.pull_sparse("emb", all_ids).copy(),
            client.pull_dense("dense0").copy())


def _expected_applied(eps, dead_idx=None):
    """EXACT per-server table.applied expectation: replay the
    deterministic push schedule against the replica-membership timeline
    (chained map: shard s -> primary eps[s], backup eps[s+1]; after
    KILL_STEP the dead server leaves every chain). A single lost OR
    double-applied mutation anywhere breaks the equality."""
    import zlib
    n = len(eps)
    d = zlib.crc32(b"dense0") % n
    emb = {ep: 0 for ep in eps}
    dense = {ep: 0 for ep in eps}
    for step in range(N_STEPS):
        rng = np.random.RandomState(1000 + step)
        ids = rng.randint(0, VOCAB, size=10).astype(np.int64)
        shards = {int(i) % n for i in ids}
        killed = dead_idx is not None and step >= KILL_STEP
        for s in range(n):
            members = [eps[s], eps[(s + 1) % n]]
            if killed:
                members = [m for m in members if m != eps[dead_idx]]
            for m in members:
                if s in shards:
                    emb[m] += 1
                if s == d:
                    dense[m] += 1
    return emb, dense


def test_chaos_storage_kill_primary_bitwise_equals_fault_free():
    """THE proof: 3-server/1-backup training where shard 0's primary is
    killed PERMANENTLY mid-run (never restarted) under seeded RESET+DROP
    chaos must end bitwise-equal to the fault-free run, with >=1
    promotion and zero double-applies."""
    specs = _specs("adagrad", lr=0.1)

    # ---- fault-free reference run on an identical replicated cluster
    ref_servers, ref_eps = _cluster(specs=specs)
    ref_client = PSClient(ref_eps, **FAST)
    _train_steps(ref_client, 0, N_STEPS)
    ref_sparse, ref_dense = _final_state(ref_client)
    # counter-exact sanity on the fault-free cluster first
    exp_emb, exp_dense = _expected_applied(ref_eps)
    for s in ref_servers:
        assert s.table("emb").applied == exp_emb[s.endpoint]
        assert s.table("dense0").applied == exp_dense[s.endpoint]
    _teardown(ref_servers, ref_client)

    # ---- chaos run: seeded resets + lost replies + a permanent kill
    servers, eps = _cluster(specs=specs)
    client = PSClient(eps, **FAST)
    before = monitor.stats("ps.replica.")
    rpc_before = monitor.stats("ps.rpc.")
    try:
        with faults.inject(seed=11, p={faults.RESET: 0.02,
                                       faults.DROP: 0.02}) as inj:
            _train_steps(client, 0, KILL_STEP)
            servers[0].shutdown()        # permanent: NEVER restarted
            _train_steps(client, KILL_STEP, N_STEPS)
        got_sparse, got_dense = _final_state(client)

        # the chaos actually happened and the tier reported it
        assert inj.fired(faults.RESET) >= 1, "seed injected no resets"
        assert inj.fired(faults.DROP) >= 1, "seed injected no drops"
        assert _delta(rpc_before, "ps.rpc.retries") >= 1
        assert _delta(before, "ps.replica.promotions") >= 1
        assert _delta(before, "ps.replica.forwards") >= 1
        assert client.shard_map.epoch > 0
        assert eps[0] not in client.shard_map.servers

        # ...and not one gradient was lost or double-counted
        np.testing.assert_array_equal(got_sparse, ref_sparse)
        np.testing.assert_array_equal(got_dense, ref_dense)

        # zero double-applies: every LIVE server's counters match the
        # deterministic schedule replayed against the membership
        # timeline, exactly
        exp_emb, exp_dense = _expected_applied(eps, dead_idx=0)
        for s in servers[1:]:
            assert s.table("emb").applied == exp_emb[s.endpoint]
            assert s.table("dense0").applied == exp_dense[s.endpoint]
    finally:
        _teardown(servers, client)
