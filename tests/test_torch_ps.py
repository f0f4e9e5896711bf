"""The port's PS client / server tier, sync Downpour training and the
sharded embedding engine (paddle_tpu_torch/distributed/ps/{client,server,
embedding,heter}.py, ``Executor.train_from_dataset(ps_config=...)``).

Parity with the JAX package:
- sync Downpour (``train_from_dataset`` with ``ps_config``, the server
  owning the sparse param's SGD): tests/test_ps_industrial.py's program
  and batches in both packages from the same weights give the same
  server rows and local head weights to rtol 1e-6 / atol 1e-7 (the sum of
  a duplicated id's gradient rows and the loss's mean reduce in XLA's
  order in one package and torch's in the other: a few values one ulp
  apart after 16 batches), and the same push counts (exact); the
  program's local optimizer section loses the PS param in both.

Then, on the port: tests/test_ps.py's client / server / Communicator
cases (atol 1e-6 as there), tests/test_ps_industrial.py's snapshot and
restart cases (rtol 1e-6), and tests/test_ps_sharded_embedding.py's
chaos proofs (exact: bitwise rows, exact ``applied``), with the
prefetcher's rows as tensors on the trainer's device (the CPU here). The
latency-skew case runs on an unreplicated cluster (the skew on one
server's sends is what it measures; replication heartbeats through a
stalled endpoint only slow it down), and the failover heartbeat deadline
is 2 s, not 0.7 s (see tests/test_torch_ps_replica.py).
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed.ps import (EmbeddingPrefetcher,
                                             HeterPSCache, PSClient,
                                             PSServer, ShardMap)
from paddle_tpu_torch.static.pipeline_runner import PipelineStepError
from paddle_tpu_torch.testing import faults

from test_torch_static_cases import JAX, PORT, static_mode, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 4
VOCAB = 60

FAST = dict(timeout=5.0, max_retries=2, backoff_base=0.01,
            backoff_max=0.05, connect_retry_s=5.0)
HB = dict(heartbeat_s=0.1, heartbeat_timeout_s=2.0)


@pytest.fixture(autouse=True)
def _cpu_and_no_leftover_injector():
    with device_scope("cpu"):
        yield
    faults.uninstall()


def _delta(before, name):
    return monitor.stat_get(name) - before.get(name, 0)


def _specs(optimizer="adagrad", lr=0.1):
    return {"emb": {"type": "sparse", "dim": DIM, "optimizer": optimizer,
                    "lr": lr, "init": "uniform", "seed": 9}}


def _cluster(n=3, k=1, specs=None):
    servers = [PSServer("127.0.0.1:0", specs or _specs())
               for _ in range(n)]
    eps = [s.start() for s in servers]
    if k:
        smap = ShardMap.create(eps, n_backups=k)
        for s in servers:
            s.enable_replication(shard_map=smap, peers=eps, n_backups=k,
                                 rpc_opts=dict(FAST), **HB)
    return servers, eps


def _teardown(servers, *closers):
    for c in closers:
        try:
            c.close()
        except Exception:
            pass
    for s in servers:
        s.shutdown()


# ------------------------------------------ sync Downpour against JAX

IND_VOCAB, IND_DIM = 32, 4


def _downpour_program(P):
    with static_mode(P) as static:
        main = static.Program("downpour")
        with static.program_guard(main, static.Program()):
            ids = static.data("ids", [-1], "int64")
            label = static.data("label", [-1, 1], "float32")
            emb = P.nn.Embedding(IND_VOCAB, IND_DIM)
            head = P.nn.Linear(IND_DIM, 1, bias_attr=False)
            loss = P.ops.mean(
                P.nn.functional.binary_cross_entropy_with_logits(
                    head(emb(ids)), label))
            P.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, loss, emb.weight.scope_name, head.weight.scope_name


class _IdsDataset:
    """{'ids': [b], 'label': [b, 1]} batches (tests/test_ps_industrial.py)."""

    def __init__(self, n_batches=12, b=8, seed=0):
        rng = np.random.RandomState(seed)
        self._batches = []
        for _ in range(n_batches):
            ids = rng.randint(0, IND_VOCAB, (b,)).astype("int64")
            lab = (ids % 2).astype("float32").reshape(b, 1)
            self._batches.append({"ids": ids, "label": lab})

    def batches(self):
        yield from self._batches


def test_downpour_train_from_dataset_equals_jax():
    progs = {P.name: _downpour_program(P) for P in (JAX, PORT)}
    jscope, tscope = JAX.static.global_scope(), PORT.static.global_scope()
    for j, t in zip(progs["jax"][2:], progs["port"][2:]):
        tscope.set(t, torch.tensor(np.asarray(jscope.get(j))))
    out = {}
    for P, ps in ((JAX, jps), (PORT, tps)):
        main, loss, emb_name, head_name = progs[P.name]
        srv = ps.PSServer(tables={"emb": {
            "type": "sparse", "dim": IND_DIM, "optimizer": "sgd",
            "lr": 0.5, "init": "zeros"}})
        srv.start()
        client = ps.PSClient([srv.endpoint])
        try:
            P.static.Executor().train_from_dataset(
                program=main, dataset=_IdsDataset(n_batches=16, b=16),
                fetch_list=[loss], print_period=0,
                ps_config={"client": client,
                           "sparse": [{"param": emb_name, "slot": "ids",
                                       "table": "emb"}]})
            opt_params = [p.name for p, _ in main.optimizer_section[1]]
            assert emb_name not in opt_params
            out[P.name] = (client.pull_sparse("emb", np.arange(IND_VOCAB)),
                           to_np(P.static.global_scope().get(head_name)),
                           srv.table("emb").applied)
        finally:
            client.close()
            srv.shutdown()
    (jr, jh, ja), (tr, th, ta) = out["jax"], out["port"]
    assert np.abs(tr).sum() > 0, "server table never updated"
    np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(th, jh, rtol=1e-6, atol=1e-7)
    assert ta == ja == 16


def test_downpour_with_communicator_pushes_every_batch():
    main, loss, emb_name, _ = _downpour_program(PORT)
    srv = PSServer(tables={"emb": {"type": "sparse", "dim": IND_DIM,
                                   "optimizer": "sgd", "lr": 0.5,
                                   "init": "zeros"}})
    srv.start()
    client = PSClient([srv.endpoint])
    comm = tps.Communicator(client, send_every=1)
    try:
        PORT.static.Executor().train_from_dataset(
            program=main, dataset=_IdsDataset(n_batches=6), fetch_list=[],
            ps_config={"client": client, "communicator": comm,
                       "sparse": [{"param": emb_name, "slot": "ids",
                                   "table": "emb"}]})
        assert srv.table("emb").applied >= 1
        assert np.abs(client.pull_sparse(
            "emb", np.arange(IND_VOCAB))).sum() > 0
    finally:
        comm.stop()
        client.close()
        srv.shutdown()


def test_ps_config_rejects_unknown_mode_and_param():
    main, loss, emb_name, _ = _downpour_program(PORT)
    exe = PORT.static.Executor()
    with pytest.raises(ValueError, match="mode"):
        exe.train_from_dataset(main, _IdsDataset(1), ps_config={
            "client": None, "mode": "geo", "sparse": []})
    with pytest.raises(ValueError, match="not a persistable var"):
        exe.train_from_dataset(main, _IdsDataset(1), ps_config={
            "client": None, "sparse": [{"param": "nope", "slot": "ids",
                                        "table": "emb"}]})


# --------------------------------------------- 2: client/server sharding

@pytest.fixture()
def two_servers():
    specs = {
        "emb": {"type": "sparse", "dim": 4, "optimizer": "sgd", "lr": 1.0,
                "init": "zeros"},
        "w": {"type": "dense", "shape": (2, 2), "optimizer": "sgd",
              "lr": 0.5},
        "bar": {"type": "barrier", "trainer_num": 2},
    }
    servers = [PSServer("127.0.0.1:0", specs) for _ in range(2)]
    eps = [s.start() for s in servers]
    client = PSClient(eps)
    yield client, servers
    client.stop_servers()
    client.close()


def test_pull_push_sparse_sharded(two_servers):
    client, servers = two_servers
    ids = np.array([0, 1, 2, 3, 10, 11], np.int64)  # both parities -> both servers
    rows = client.pull_sparse("emb", ids)
    assert rows.shape == (6, 4)
    client.push_sparse_grad("emb", ids, np.ones((6, 4), np.float32))
    got = client.pull_sparse("emb", ids)
    np.testing.assert_allclose(got, -np.ones((6, 4)), atol=1e-6)
    # rows actually sharded: each server holds only its parity
    even = servers[0].table("emb") if 0 % 2 == 0 else servers[1].table("emb")
    assert len(even) == 3  # ids 0, 2, 10
    # order preservation with duplicates and interleaved owners
    mixed = np.array([3, 0, 3, 2], np.int64)
    got = client.pull_sparse("emb", mixed)
    np.testing.assert_allclose(got[0], got[2], atol=1e-6)


def test_dense_roundtrip_and_update(two_servers):
    client, _ = two_servers
    w0 = client.pull_dense("w")
    np.testing.assert_allclose(w0, np.zeros((2, 2)))
    client.push_dense_grad("w", np.ones((2, 2), np.float32))
    np.testing.assert_allclose(client.pull_dense("w"),
                               -0.5 * np.ones((2, 2)), atol=1e-6)
    client.set_dense("w", np.full((2, 2), 7.0, np.float32))
    np.testing.assert_allclose(client.pull_dense("w"), 7.0)


def test_barrier_across_threads(two_servers):
    client, _ = two_servers
    from paddle_tpu_torch.distributed.ps import PSClient
    results = []

    def other():
        c2 = PSClient(client.endpoints)
        results.append(c2.barrier("bar", 1))
        c2.close()

    t = threading.Thread(target=other)
    t.start()
    assert client.barrier("bar", 0)
    t.join(30)
    assert results == [True]


def test_server_error_propagates(two_servers):
    client, _ = two_servers
    with pytest.raises(RuntimeError, match="ps server error"):
        client.pull_dense("nonexistent_table")


# ------------------------------------------------------- 3: communicator

def test_communicator_merges_and_flushes(two_servers):
    client, _ = two_servers
    from paddle_tpu_torch.distributed.ps import Communicator
    comm = Communicator(client, send_every=100)  # force merge-at-flush
    for _ in range(5):
        comm.push_sparse("emb", [42, 43], np.ones((2, 4), np.float32))
    comm.push_dense("w", np.ones((2, 2), np.float32))
    comm.flush()
    comm.stop()
    got = client.pull_sparse("emb", [42, 43])
    np.testing.assert_allclose(got, -5 * np.ones((2, 4)), atol=1e-6)
    np.testing.assert_allclose(client.pull_dense("w"),
                               -0.5 * np.ones((2, 2)), atol=1e-6)


def test_dense_routing_is_process_stable():
    # hash() is PYTHONHASHSEED-randomized across worker processes; routing
    # must not be (review finding): verify the crc32 rule in a fresh
    # interpreter with a different hash seed
    import zlib
    expect = zlib.crc32(b"w") % 2
    out = subprocess.run(
        [sys.executable, "-c",
         "import zlib; print(zlib.crc32(b'w') % 2)"],
        env={**os.environ, "PYTHONHASHSEED": "12345"},
        capture_output=True, text=True, cwd=REPO)
    assert int(out.stdout) == expect


# ------------------------------- snapshot and restart

@pytest.fixture()
def ind_server():
    srv = PSServer(tables={
        "emb": {"type": "sparse", "dim": DIM, "optimizer": "sgd", "lr": 0.5,
                "init": "zeros"}})
    srv.start()
    yield srv
    srv.shutdown()


def test_snapshot_restore_midtrain(ind_server, tmp_path):
    client = PSClient([ind_server.endpoint])
    rng = np.random.RandomState(0)
    ids = np.arange(8, dtype=np.int64)
    # train the table a bit
    client.pull_sparse("emb", ids)
    client.push_sparse_grad("emb", ids, rng.randn(8, DIM).astype("float32"))
    trained = client.pull_sparse("emb", ids)

    snap = str(tmp_path / "ps_snap")
    client.save_snapshot(snap)
    assert os.path.exists(snap + ".s0")

    # keep training past the snapshot, then "fail" and restore
    client.push_sparse_grad("emb", ids, rng.randn(8, DIM).astype("float32"))
    after = client.pull_sparse("emb", ids)
    assert not np.allclose(after, trained)
    client.load_snapshot(snap)
    restored = client.pull_sparse("emb", ids)
    np.testing.assert_allclose(restored, trained, rtol=1e-6)
    client.close()


def test_server_death_and_restart_with_snapshot(tmp_path):
    """Kill-the-server recovery: state survives via the snapshot file and
    a fresh server process (the elastic-restart contract; reference
    heart_beat_monitor.cc + large_scale_kv checkpointing)."""
    spec = {"emb": {"type": "sparse", "dim": DIM, "optimizer": "sgd",
                    "lr": 0.5, "init": "zeros"}}
    srv = PSServer(tables=spec)
    srv.start()
    client = PSClient([srv.endpoint])
    ids = np.arange(6, dtype=np.int64)
    client.pull_sparse("emb", ids)
    client.push_sparse_grad("emb", ids,
                            np.ones((6, DIM), "float32"))
    trained = client.pull_sparse("emb", ids)
    snap = str(tmp_path / "snap")
    client.save_snapshot(snap)
    client.close()
    srv.shutdown()          # hard stop — the "failure"

    srv2 = PSServer(tables=spec)
    srv2.start()
    c2 = PSClient([srv2.endpoint])
    assert np.abs(c2.pull_sparse("emb", ids)).sum() == 0  # fresh tables
    c2.load_snapshot(snap)
    np.testing.assert_allclose(c2.pull_sparse("emb", ids), trained,
                               rtol=1e-6)
    c2.close()
    srv2.shutdown()


# ------------------------------------------- cross-shard batched lookups

@pytest.mark.chaos
@pytest.mark.parametrize("fanout", [1, 4])
def test_pull_dedupes_across_shards_order_preserving(fanout):
    """[5, 9, 5, ...] spanning all shards with duplicates within AND
    across shard slices: one row per unique id on the wire, result in
    input order, duplicate positions identical."""
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    set_flags({"PADDLE_PS_FANOUT_THREADS": fanout})
    try:
        ids = np.array([5, 9, 5, 1, 3, 2, 2, 59, 9], np.int64)
        before = monitor.stats("ps.client.")
        rows = client.pull_sparse("emb", ids)
        assert rows.shape == (9, DIM)
        # one row per unique id crossed the wire, one RPC per shard
        assert _delta(before, "ps.client.pull_ids") == 9
        assert _delta(before, "ps.client.pull_unique_rows") == 6
        assert _delta(before, "ps.client.pull_rpcs") == 3
        # order-preserving: each position equals its single-id pull
        for pos, i in enumerate(ids):
            np.testing.assert_array_equal(
                rows[pos], client.pull_sparse("emb", np.array([i]))[0])
        # duplicate positions are bitwise the same row
        np.testing.assert_array_equal(rows[0], rows[2])
        np.testing.assert_array_equal(rows[1], rows[8])
        # servers materialized only their own unique ids
        sizes = [len(s.table("emb")) for s in servers]
        assert sizes[0] == 2   # shard 0: {3, 9}  (pulls only touch the
        assert sizes[1] == 1   # shard 1: {1}      primary — no backup
        assert sizes[2] == 3   # shard 2: {2, 5, 59}       materializes)
    finally:
        set_flags({"PADDLE_PS_FANOUT_THREADS": 4})
        _teardown(servers, client)


@pytest.mark.chaos
def test_pull_empty_batch_and_empty_push():
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    try:
        rows = client.pull_sparse("emb", np.zeros((0,), np.int64))
        assert rows.shape == (0, DIM)
        # empty pushes are a no-op, not a wire error
        client.push_sparse_grad("emb", np.zeros((0,), np.int64),
                                np.zeros((0, DIM), np.float32))
        assert all(s.table("emb").applied == 0 for s in servers)
    finally:
        _teardown(servers, client)


@pytest.mark.chaos
def test_batch_during_epoch_bump_order_preserving_exactly_once():
    """A batch arriving with a stale map epoch: the first shard call
    gets a ShardMapStale redirect, the client adopts mid-batch and
    re-routes — rows stay order-preserving, pushes stay exactly-once."""
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    try:
        ids = np.array([0, 1, 2, 4, 0], np.int64)   # all shards + dup
        expect = client.pull_sparse("emb", ids)
        # bump the cluster's epoch behind the client's back (no routing
        # change needed — the epoch check alone trips the redirect)
        old = servers[0].replica.shard_map
        d = old.to_dict()
        d["epoch"] = old.epoch + 1
        for s in servers:
            s.replica.install(d)
        before = monitor.stats("ps.replica.")
        rows = client.pull_sparse("emb", ids)
        np.testing.assert_array_equal(rows, expect)
        assert _delta(before, "ps.replica.stale_maps") >= 1
        assert client.shard_map.epoch == old.epoch + 1
        # a push with dup ids through the bumped map: merged client-side,
        # applied exactly once per member of each touched shard
        applied0 = [s.table("emb").applied for s in servers]
        client.push_sparse_grad("emb", ids, np.ones((5, DIM), np.float32))
        for idx, s in enumerate(servers):
            # chained map: server i is primary of shard i, backup of
            # shard i-1; ids touch shards {0,1,2} -> 2 applies each
            assert s.table("emb").applied == applied0[idx] + 2
    finally:
        _teardown(servers, client)


@pytest.mark.chaos
def test_push_batch_exactly_once_under_dropped_replies():
    """DROP every shard's first push reply: the client retries, the
    replay cache dedupes — applied counters exact, values exact."""
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    try:
        ids = np.arange(6, dtype=np.int64)           # shards {0,1,2}
        client.pull_sparse("emb", ids)
        base = client.pull_sparse("emb", ids)
        # times=2 < the 3-attempt transport budget: both drops can land
        # on ONE forward's replies without exhausting it (3 would evict
        # the backup — a different, also-correct story)
        with faults.inject(faults.Fault("server", "reply", faults.DROP,
                                        method="push_sparse_grad",
                                        times=2)) as inj:
            client.push_sparse_grad("emb", ids,
                                    np.ones((6, DIM), np.float32))
        assert inj.fired(faults.DROP) >= 1
        for s in servers:
            assert s.table("emb").applied == 2   # primary + backup roles
        got = client.pull_sparse("emb", ids)
        # adagrad lr=0.1 single unit push: row -= 0.1/sqrt(1)+eps-ish;
        # exactness vs a clean reference cluster is the real check
        ref_servers, ref_eps = _cluster()
        ref = PSClient(ref_eps, **FAST)
        ref.pull_sparse("emb", ids)
        ref.push_sparse_grad("emb", ids, np.ones((6, DIM), np.float32))
        np.testing.assert_array_equal(got, ref.pull_sparse("emb", ids))
        assert not np.array_equal(base, got)
        _teardown(ref_servers, ref)
    finally:
        _teardown(servers, client)


# ------------------------------------------------- prefetch + slow shard

def _run_workload(eps, n_steps, use_prefetch, compute_s=0.0,
                  cache_rows=None):
    """The shared deterministic loop; returns (final rows, stats)."""
    client = PSClient(eps, **FAST)
    pf = cache = None
    if use_prefetch:
        cache = HeterPSCache(client, "emb", DIM,
                             capacity=cache_rows or 32, host_rows=64)
        pf = EmbeddingPrefetcher(cache)
    try:
        for step in range(n_steps):
            ids = _batch_ids(step)
            if pf is not None:
                rows = pf.get(ids)
                assert isinstance(rows, torch.Tensor)
                rows = rows.numpy()
                if step + 1 < n_steps:
                    pf.prefetch(_batch_ids(step + 1))
            else:
                rows = client.pull_sparse("emb", ids)
            if compute_s:
                time.sleep(compute_s)      # the "dense step"
            grads = rows * 0.05 + np.random.RandomState(
                5000 + step).randn(len(ids), DIM).astype(np.float32)
            if pf is not None:
                pf.push_grad(ids, grads)
            else:
                client.push_sparse_grad("emb", ids, grads)
        final = client.pull_sparse("emb", np.arange(VOCAB, dtype=np.int64))
        stats = pf.stats() if pf is not None else {}
        return final, stats
    finally:
        if pf is not None:
            pf.close()
        client.close()


def _batch_ids(step):
    return np.random.RandomState(1000 + step).randint(
        0, VOCAB, size=10).astype(np.int64)


@pytest.mark.chaos
def test_slow_shard_latency_skew_absorbed_by_prefetch():
    """testing/faults.py endpoint-targetable STALL: ONE shard server is
    slow (never dead — nothing retries or fails over). The prefetch
    stage hides its latency behind the dense step without changing a
    single bit of the result."""
    n_steps = 10
    ref_servers, ref_eps = _cluster(k=0)
    ref, _ = _run_workload(ref_eps, n_steps, use_prefetch=False)
    _teardown(ref_servers)

    servers, eps = _cluster(k=0)
    try:
        skew = faults.Fault("client", "send", faults.STALL,
                            endpoint=eps[1], times=10 ** 9, delay=0.05)
        with faults.inject(skew) as inj:
            got, stats = _run_workload(eps, n_steps, use_prefetch=True,
                                       compute_s=0.03)
        assert inj.fired(faults.STALL) >= n_steps  # the skew was real
        np.testing.assert_array_equal(got, ref)    # ...and invisible
        # every batch after the first was prefetched (how much of the
        # pull time the step hid is a wall-clock reading, not asserted)
        assert stats["prefetched"] == n_steps - 1
    finally:
        _teardown(servers)


@pytest.mark.chaos
def test_prefetch_failure_surfaces_then_recovers():
    """A dead prefetch surfaces as PipelineStepError naming its step —
    and having surfaced, the prefetcher starts a clean window: one
    transient outage must not poison every later prefetch."""
    srv = PSServer(tables=_specs())
    ep = srv.start()
    client = PSClient([ep], **FAST)
    pf = EmbeddingPrefetcher(client, table="emb")
    ids = np.array([1, 2], np.int64)
    try:
        # kill the first prefetch's pull: more RESETs than the
        # transport's 3-attempt budget
        with faults.inject(faults.Fault("client", "send", faults.RESET,
                                        method="pull_sparse", times=5)):
            pf.prefetch(ids)
            with pytest.raises(PipelineStepError) as ei:
                pf.get(ids)
        assert ei.value.step_index == 0
        # recovery: a fresh prefetch on the rebuilt window works, and
        # matches the synchronous path
        pf.prefetch(ids)
        np.testing.assert_array_equal(pf.get(ids),
                                      client.pull_sparse("emb", ids))
        assert pf.stats()["prefetched"] == 2
    finally:
        pf.close()
        client.close()
        srv.shutdown()


@pytest.mark.chaos
def test_prefetch_abandons_skipped_batches_and_bounds_versions():
    """FIFO contract: queued batches the trainer skipped past are
    dropped (not left pinning the window head), and the conflict
    version table resets whenever no snapshot is in flight — bounded by
    the prefetch window, never by the vocab."""
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    pf = EmbeddingPrefetcher(client, table="emb", depth=2)
    try:
        pf.prefetch(np.array([0, 1], np.int64))
        pf.prefetch(np.array([2, 3], np.int64))
        before = monitor.stats("ps.embed.")
        rows = pf.get(np.array([4, 5], np.int64))   # matches neither
        assert _delta(before, "ps.embed.abandoned") == 2
        assert _delta(before, "ps.embed.sync_pulls") == 1
        np.testing.assert_array_equal(rows,
                                      client.pull_sparse("emb", [4, 5]))
        # the window restarts cleanly after the drain
        pf.prefetch(np.array([6], np.int64))
        np.testing.assert_array_equal(pf.get(np.array([6], np.int64)),
                                      client.pull_sparse("emb", [6]))
        # no snapshot in flight -> pushes don't accrete version entries
        pf.push_grad(np.array([6], np.int64), np.ones((1, DIM),
                                                      np.float32))
        assert len(pf._versions) == 0
    finally:
        pf.close()
        _teardown(servers, client)


@pytest.mark.chaos
def test_prefetch_conflict_ids_repulled_bitwise():
    """Overlapping consecutive batches: the prefetched copy of a row
    that the current step then pushes is STALE — get() must re-pull
    exactly those ids and match the synchronous path bitwise."""
    servers, eps = _cluster()
    client = PSClient(eps, **FAST)
    pf = EmbeddingPrefetcher(client, table="emb")
    try:
        a = np.array([0, 1, 2, 3], np.int64)
        b = np.array([2, 3, 4, 5], np.int64)        # overlaps {2, 3}
        pf.get(a)                                   # sync (cold)
        pf.prefetch(b)                              # snapshot pre-push
        pf.sync()                                   # rows of b fetched
        g = np.ones((4, DIM), np.float32)
        pf.push_grad(a, g)                          # {2,3} now stale
        before = monitor.stats("ps.embed.")
        rows_b = pf.get(b)
        assert _delta(before, "ps.embed.conflict_repulls") == 2
        np.testing.assert_array_equal(
            rows_b, client.pull_sparse("emb", b))   # post-push values
    finally:
        pf.close()
        _teardown(servers, client)


# ---------------------------------------- THE acceptance chaos training

N_STEPS = 24
KILL_STEP = 11


def _expected_applied(eps, dead_idx=None):
    """EXACT per-server `emb.applied` expectation: the deterministic
    push schedule replayed against the membership timeline (chained
    map: shard s -> primary eps[s], backup eps[s+1]; after KILL_STEP
    the dead server leaves every chain). One lost OR double-applied
    mutation anywhere breaks the equality."""
    n = len(eps)
    emb = {ep: 0 for ep in eps}
    for step in range(N_STEPS):
        shards = {int(i) % n for i in _batch_ids(step)}
        killed = dead_idx is not None and step >= KILL_STEP
        for s in shards:
            members = [eps[s], eps[(s + 1) % n]]
            if killed:
                members = [m for m in members if m != eps[dead_idx]]
            for m in members:
                emb[m] += 1
    return emb


@pytest.mark.chaos
def test_chaos_sharded_embedding_kill_primary_bitwise_equals_sync():
    """THE proof. Three runs on identical 3-server/1-backup clusters:

    1. synchronous pulls, fault-free            -> reference bits
    2. prefetch + tiered LRU cache, fault-free  -> must equal (1)
    3. prefetch + cache under seeded RESET+DROP chaos + scripted
       PARTITION dials + a PERMANENT mid-run kill of shard 0's
       primary                                  -> must equal (1)

    with >=1 promotion, >=1 cache invalidation, the prefetch/cache path
    live through the outage, and per-server table.applied matching the
    deterministic schedule against the membership timeline exactly."""
    # ---- run 1: synchronous, fault-free
    s1, eps1 = _cluster()
    ref, _ = _run_workload(eps1, N_STEPS, use_prefetch=False)
    exp = _expected_applied(eps1)
    for s in s1:
        assert s.table("emb").applied == exp[s.endpoint]
    _teardown(s1)

    # ---- run 2: the async engine, fault-free — prefetch parity
    s2, eps2 = _cluster()
    got2, stats2 = _run_workload(eps2, N_STEPS, use_prefetch=True)
    np.testing.assert_array_equal(got2, ref)
    assert stats2["prefetched"] == N_STEPS - 1
    exp = _expected_applied(eps2)
    for s in s2:
        assert s.table("emb").applied == exp[s.endpoint]
    _teardown(s2)

    # ---- run 3: chaos + permanent shard-primary kill
    servers, eps = _cluster()
    before = monitor.stats("ps.replica.")
    rpc_before = monitor.stats("ps.rpc.")
    heter_before = monitor.stats("ps.heter.")
    client = PSClient(eps, **FAST)
    try:
        with faults.inject(
                faults.Fault("client", "dial", faults.PARTITION,
                             endpoint=eps[2], times=2),
                seed=11, p={faults.RESET: 0.02, faults.DROP: 0.02}) as inj:
            # the chaos client is BORN inside the injector: its very
            # first dial of eps[2] is refused (scripted PARTITION), so
            # construction-time dead-endpoint tolerance + the failover
            # re-dial path are both on the proof's critical path
            chaos_client = PSClient(eps, **FAST)
            cache = HeterPSCache(chaos_client, "emb", DIM, capacity=32,
                                 host_rows=64)
            pf = EmbeddingPrefetcher(cache)
            try:
                for step in range(N_STEPS):
                    ids = _batch_ids(step)
                    if step == KILL_STEP:
                        servers[0].shutdown()   # permanent: NEVER back
                    rows = pf.get(ids).numpy()
                    if step + 1 < N_STEPS:
                        pf.prefetch(_batch_ids(step + 1))
                    grads = rows * 0.05 + np.random.RandomState(
                        5000 + step).randn(len(ids),
                                           DIM).astype(np.float32)
                    pf.push_grad(ids, grads)
            finally:
                pf.close()
        got3 = client.pull_sparse("emb", np.arange(VOCAB, dtype=np.int64))

        # the chaos actually happened, in every scripted+seeded flavor
        assert inj.fired(faults.RESET) >= 1, "seed injected no resets"
        assert inj.fired(faults.DROP) >= 1, "seed injected no drops"
        assert inj.fired(faults.PARTITION) == 2
        assert _delta(rpc_before, "ps.rpc.retries") >= 1
        assert _delta(before, "ps.replica.promotions") >= 1
        assert chaos_client.shard_map.epoch > 1
        assert eps[0] not in chaos_client.shard_map.servers
        # the cache tier lived through it: hits served, eviction + the
        # membership change invalidated it at least once
        assert _delta(heter_before, "ps.heter.hits") >= 1
        assert _delta(heter_before, "ps.heter.evictions") >= 1
        assert _delta(heter_before, "ps.heter.invalidations") >= 1

        # ...and not one gradient was lost, duplicated or served stale
        np.testing.assert_array_equal(got3, ref)

        # exactly-once, replayed against the membership timeline
        exp = _expected_applied(eps, dead_idx=0)
        for s in servers[1:]:
            assert s.table("emb").applied == exp[s.endpoint]
    finally:
        try:
            chaos_client.close()
        except Exception:
            pass
        _teardown(servers, client)
