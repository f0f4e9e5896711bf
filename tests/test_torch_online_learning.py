"""The online-learning loop on the port: serve -> stream -> train (the
continuous Downpour mode of ``Executor.train_from_dataset``) -> publish
(paddle_tpu_torch/distributed/ps/publish.py) -> hot-swap
(``ServeLoop.publish_weights``), against the JAX package's trainer.

Parity with the JAX package: the online mode (``ps_config`` mode
"online", a "geo_sparse" table, sync_every 2) on the same program, weights
and feeds gives the same flush log (exact), the same per-table
``applied`` (exact) and the same table rows (rtol 1e-6 / atol 1e-7: the
loss's mean reduces in XLA's order in one package and torch's in the
other; bitwise on these inputs as run here, but not promised).

Then tests/test_online_learning.py's proofs on the port (exact: applied
counts, flush logs; values as there), with a 2 s failover heartbeat
deadline (see tests/test_torch_ps_replica.py; THE drill's is 6 s,
``DRILL_HB``), and THE drill twice: a
fault-free run and a run under seeded RESET + DROP chaos with a shard
primary killed for good and the trainer restarted from its checkpoint
onto a fresh client. The killed run's table is bitwise the fault-free
run's (the servers' arithmetic is numpy, the trainer's deltas depend only
on the rows it pulls), every payload is applied exactly once, the served
model moves toward the traffic across three hot swaps, and no request is
dropped.
"""
import contextlib
import itertools
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.dataset import StreamingDataset
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed.ps import (EmbeddingPrefetcher,
                                             EmbeddingSnapshotPublisher,
                                             HeterPSCache, PSClient,
                                             PSServer, ShardMap)
from paddle_tpu_torch.inference.serving import ServeConfig, ServeLoop
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig

from test_torch_static_cases import JAX, PORT, static_mode, to_np

HID = 64          # GPTConfig.tiny() hidden size == PS table dim
VOCAB = 1024      # GPTConfig.tiny() vocab == embedding rows

FAST = dict(timeout=2.0, max_retries=2, backoff_base=0.01,
            backoff_max=0.05, connect_retry_s=5.0)
HB = dict(heartbeat_s=0.1, heartbeat_timeout_s=2.0)
# THE drill runs three servers, a serve loop, a trainer and a publisher in
# one process; on a loaded host (six test workers beside it) a live
# server's heartbeat thread can stall past 2 s and be promoted over, which
# the drill's bitwise and exactly-once checks would then report. The drill
# gives a live server 6 s, waits up to 60 s for the true kill's promotion
# (polling: it returns as soon as the shard map moves) and retries an RPC
# 4 times; every check is the same.
DRILL_HB = dict(heartbeat_s=0.1, heartbeat_timeout_s=6.0)
DRILL_RPC = dict(FAST, max_retries=4)

# the direction serve traffic pulls the embedding: a fixed per-id target
TARGET = np.random.RandomState(77).uniform(
    -0.5, 0.5, (VOCAB, HID)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu_and_no_leftover_injector():
    with device_scope("cpu"):
        yield
    faults.uninstall()


def _geo_specs(dim):
    return {"wte": {"type": "geo_sparse", "dim": dim, "init": "zeros"}}


def _cluster(n=3, k=1, dim=HID, hb=HB, rpc=FAST):
    servers = [PSServer("127.0.0.1:0", _geo_specs(dim)) for _ in range(n)]
    eps = [s.start() for s in servers]
    smap = ShardMap.create(eps, n_backups=k)
    for s in servers:
        s.enable_replication(shard_map=smap, peers=eps, n_backups=k,
                             rpc_opts=dict(rpc), **hb)
    return servers, eps


def _teardown(servers, *closers):
    for c in closers:
        try:
            c.close()
        except Exception:
            pass
    for s in servers:
        s.shutdown()


def _await_promotion(client, dead_ep, deadline=15.0):
    """Poll until the client's shard map adopts the epoch without
    `dead_ep` (heartbeat suspicion -> backup promotion)."""
    t0 = time.perf_counter()
    last = None
    while time.perf_counter() - t0 < deadline:
        try:
            client.refresh_shard_map()
        except Exception as e:  # a dead peer mid-refresh; keep polling
            last = e
        if dead_ep not in client.shard_map.servers:
            return
        time.sleep(0.1)
    raise AssertionError(f"no promotion after {dead_ep} died ({last!r})")


def _delta(before, name):
    return monitor.stat_get(name) - before.get(name, 0)


T_VOCAB, T_DIM = 32, 4
T_TARGET = np.random.RandomState(5).uniform(
    -1.0, 1.0, (T_VOCAB, T_DIM)).astype(np.float32)


def _build_online_program(P, vocab, dim, lr=0.25, name="online"):
    with static_mode(P) as static:
        main = static.Program(name)
        with static.program_guard(main, static.Program()):
            ids = static.data("ids", [-1], "int64")
            target = static.data("target", [-1, dim], "float32")
            emb = P.nn.Embedding(vocab, dim)
            diff = emb(ids) - target
            # mean over tokens, sum over dim: a contraction toward the
            # target for lr < 0.5 however duplicated an id is
            loss = P.ops.mean(P.ops.sum(diff * diff, axis=-1))
            P.optimizer.SGD(learning_rate=lr).minimize(loss)
    return main, loss, emb.weight.scope_name


class _FeedDataset:
    def __init__(self, feeds):
        self._feeds = feeds

    def batches(self, start_batch=0):
        yield from self._feeds[start_batch:]


# ---------------------------------------------------------------------------
# the online trainer against the JAX package's
# ---------------------------------------------------------------------------

def test_online_trainer_equals_jax():
    progs = {P.name: _build_online_program(P, T_VOCAB, T_DIM)
             for P in (JAX, PORT)}
    PORT.static.global_scope().set(progs["port"][2], torch.tensor(
        np.asarray(JAX.static.global_scope().get(progs["jax"][2]))))
    rng = np.random.RandomState(3)
    feeds = []
    for _ in range(7):
        ids = rng.randint(0, T_VOCAB, 10).astype(np.int64)
        feeds.append({"ids": ids, "target": T_TARGET[ids]})
    out = {}
    for P, ps in ((JAX, jps), (PORT, tps)):
        main, _, emb_name = progs[P.name]
        srv = ps.PSServer("127.0.0.1:0", _geo_specs(T_DIM))
        client = ps.PSClient([srv.start()], **FAST)
        holder = {}
        try:
            P.static.Executor().train_from_dataset(
                program=main, dataset=_FeedDataset(feeds),
                ps_config={"client": client, "mode": "online",
                           "sync_every": 2, "trainer_id": 3,
                           "sparse": [{"param": emb_name, "slot": "ids",
                                       "table": "wte"}],
                           "on_batch": lambda d: holder.update(drv=d)})
            out[P.name] = (client.pull_sparse("wte", np.arange(T_VOCAB)),
                           srv.table("wte").applied,
                           holder["drv"].flush_log,
                           holder["drv"].online_state())
        finally:
            _teardown([srv], client)
    (jrows, japp, jlog, jst), (trows, tapp, tlog, tst) = \
        out["jax"], out["port"]
    assert tlog == jlog and len(tlog) == 4     # 3 cadence + 1 end flush
    assert tapp == japp == 4
    np.testing.assert_allclose(trows, jrows, rtol=1e-6, atol=1e-7)
    # the checkpoint payload has the JAX package's layout
    assert sorted(tst) == sorted(jst)
    assert (tst["flush_seq"], tst["unflushed"], tst["batch_count"]) == \
        (jst["flush_seq"], jst["unflushed"], jst["batch_count"])


# ---------------------------------------------------------------------------
# push_sparse_delta dedupes server-side across failover
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_push_delta_dedupes_across_failover_reroute():
    servers, eps = _cluster(3, 1, dim=4)
    client = PSClient(eps, **FAST)
    try:
        ids = np.array([0], np.int64)          # shard 0: eps[0] -> eps[1]
        one = np.ones((1, 4), np.float32)
        applied = lambda j: servers[j].table("wte").applied  # noqa: E731

        client.push_sparse_delta("wte", ids, one, request_key=("t", 0))
        assert (applied(0), applied(1), applied(2)) == (1, 1, 0)

        # lost ack: the reply frame drops AFTER the primary applied and
        # forwarded; the retry replays out of the rid cache on both
        with faults.inject(faults.Fault("server", "reply", faults.DROP,
                                        method="push_sparse_delta")) as inj:
            client.push_sparse_delta("wte", ids, one, request_key=("t", 1))
        assert inj.fired(faults.DROP) == 1
        assert (applied(0), applied(1), applied(2)) == (2, 2, 0)

        # the primary dies; the SAME payload under the SAME key re-routes
        # to the promoted backup, whose replay cache holds the rid
        servers[0].shutdown()
        _await_promotion(client, eps[0])
        client.push_sparse_delta("wte", ids, one, request_key=("t", 1))
        assert applied(1) == 2
        assert np.allclose(client.pull_sparse("wte", ids), 2.0)

        client.push_sparse_delta("wte", ids, one, request_key=("t", 2))
        assert applied(1) == 3 and applied(2) == 0
        assert np.allclose(client.pull_sparse("wte", ids), 3.0)
    finally:
        _teardown(servers[1:], client)


# ---------------------------------------------------------------------------
# continuous Downpour trainer: frozen-payload retry + staleness bound
# ---------------------------------------------------------------------------

def test_online_trainer_frozen_payload_retries_exactly_once():
    srv = PSServer("127.0.0.1:0", _geo_specs(T_DIM))
    client = PSClient([srv.start()], **FAST)
    main, loss, emb_name = _build_online_program(PORT, T_VOCAB, T_DIM)
    scope = PORT.static.global_scope()
    uniq = np.array([0, 1, 2, 3], np.int64)
    feeds = [{"ids": uniq, "target": T_TARGET[uniq]} for _ in range(4)]
    holder = {}
    before = monitor.stats("ps.online.")
    try:
        # every attempt of the first flush resets (1 try + 2 retries):
        # the payload freezes, defers inside the staleness bound and
        # resends next batch under its original request key
        with faults.inject(faults.Fault("client", "send", faults.RESET,
                                        method="push_sparse_delta",
                                        times=3)) as inj:
            PORT.static.Executor().train_from_dataset(
                program=main, dataset=_FeedDataset(feeds),
                ps_config={"client": client, "mode": "online",
                           "sync_every": 1, "staleness_batches": 3,
                           "sparse": [{"param": emb_name, "slot": "ids",
                                       "table": "wte"}],
                           "on_batch": lambda d: holder.update(drv=d)})
        assert inj.fired(faults.RESET) == 3
        drv = holder["drv"]
        assert [seq for _, seq, _ in drv.flush_log] == [0, 1, 2, 3]
        assert _delta(before, "ps.online.deferred_flushes") == 1
        assert srv.table("wte").applied == 4
        # single-trainer invariant: server rows == local trained rows
        local = to_np(scope.get(emb_name))[uniq]
        assert np.allclose(client.pull_sparse("wte", uniq), local,
                           atol=1e-5)
        assert np.square(local - T_TARGET[uniq]).mean() \
            < np.square(T_TARGET[uniq]).mean()
    finally:
        _teardown([srv], client)


def test_online_trainer_staleness_bound_fails_stop():
    srv = PSServer("127.0.0.1:0", _geo_specs(T_DIM))
    client = PSClient([srv.start()], **FAST)
    main, _, emb_name = _build_online_program(PORT, T_VOCAB, T_DIM,
                                              name="online-stale")
    uniq = np.array([4, 5], np.int64)
    feeds = [{"ids": uniq, "target": T_TARGET[uniq]} for _ in range(4)]
    try:
        with faults.inject(faults.Fault("client", "send", faults.RESET,
                                        method="push_sparse_delta",
                                        times=10 ** 9)):
            with pytest.raises((ConnectionError, OSError, RuntimeError)):
                PORT.static.Executor().train_from_dataset(
                    program=main, dataset=_FeedDataset(feeds),
                    ps_config={"client": client, "mode": "online",
                               "sync_every": 1, "staleness_batches": 2,
                               "sparse": [{"param": emb_name,
                                           "slot": "ids",
                                           "table": "wte"}]})
    finally:
        _teardown([srv], client)


# ---------------------------------------------------------------------------
# versioned snapshot publisher
# ---------------------------------------------------------------------------

@pytest.mark.chaos
def test_snapshot_publisher_cursor_failover_and_cache():
    servers, eps = _cluster(3, 1, dim=4)
    client = PSClient(eps, **FAST)
    cache = HeterPSCache(client, "wte", 4, capacity=8, host_rows=0)
    try:
        ids = np.arange(6, dtype=np.int64)
        rows = np.tile(np.arange(1, 7, dtype=np.float32)[:, None], (1, 4))
        client.push_sparse_delta("wte", ids, rows, request_key=("p", 0))
        cache.pull(np.array([4], np.int64))       # warm the cache

        pub = EmbeddingSnapshotPublisher(client, "wte", cache=cache)
        before = monitor.stats("ps.")
        v1, snap1 = pub.publish()
        assert v1 == 1 and len(snap1) == 6
        assert all(np.allclose(snap1[int(i)], rows[i]) for i in ids)

        # untouched cluster: cursors unchanged, nothing refetched
        v2, snap2 = pub.publish()
        assert v2 == 2
        assert _delta(before, "ps.publish.shards_refetched") == 3

        # one id trains -> only the servers that saw the mutation
        # refetch; the attached cache invalidates
        client.push_sparse_delta("wte", np.array([4], np.int64),
                                 np.ones((1, 4), np.float32),
                                 request_key=("p", 1))
        v3, snap3 = pub.publish()
        assert np.allclose(snap3[4], rows[4] + 1.0)
        assert _delta(before, "ps.publish.shards_refetched") == 5
        assert _delta(before, "ps.heter.invalidations") >= 3
        assert np.allclose(cache.pull(np.array([4], np.int64))[0],
                           rows[4] + 1.0)

        # a publish mid-failover rides the re-route to the promoted backup
        servers[0].shutdown()
        _await_promotion(client, eps[0])
        client.push_sparse_delta("wte", np.array([0], np.int64),
                                 np.ones((1, 4), np.float32),
                                 request_key=("p", 2))
        v4, snap4 = pub.publish()
        assert v4 == 4 and np.allclose(snap4[0], rows[0] + 1.0)

        base = np.zeros((8, 4), np.float32)
        dense = pub.materialize(base)
        assert np.allclose(dense[0], rows[0] + 1.0)
        assert np.allclose(dense[6:], 0.0)
    finally:
        _teardown(servers[1:], client)


def test_snapshot_publisher_unreplicated_fallback():
    srv = PSServer("127.0.0.1:0", _geo_specs(4))
    client = PSClient([srv.start()], **FAST)
    try:
        ids = np.array([2, 9], np.int64)
        client.push_sparse_delta("wte", ids,
                                 np.full((2, 4), 3.0, np.float32),
                                 request_key=("u", 0))
        pub = EmbeddingSnapshotPublisher(client, "wte")
        before = monitor.stats("ps.publish.")
        _, snap = pub.publish()
        assert np.allclose(snap[2], 3.0) and np.allclose(snap[9], 3.0)
        pub.publish()
        # no replication gate -> no cutoff cursor: every publish refetches
        assert _delta(before, "ps.publish.shards_refetched") == 2
    finally:
        _teardown([srv], client)


# ---------------------------------------------------------------------------
# THE drill: the closed loop, fault-free and under chaos
# ---------------------------------------------------------------------------

class _Window:
    """The shared streaming generator handed to train_from_dataset a
    fixed number of batches at a time (one trainer session each)."""

    def __init__(self, ds):
        self.ds = ds
        self._gen = None
        self.n = 0

    def take(self, n):
        self.n = int(n)
        return self

    def batches(self, start_batch=0):
        if self._gen is None:
            self._gen = self.ds.batches(start_batch=start_batch)
        else:
            assert int(start_batch) == \
                self.ds.stats()["delivered_batches"]
        return itertools.islice(self._gen, self.n)


def _drill(chaos):
    """serve -> stream -> train -> publish -> hot-swap, three rounds; with
    ``chaos``, seeded RESET + DROP throughout, shard 0's primary killed
    for good and the trainer restarted on a fresh client from its
    checkpoint after round two's first training phase."""
    servers, eps = _cluster(3, 1, dim=HID, hb=DRILL_HB, rpc=DRILL_RPC)
    gpt = GPT(GPTConfig.tiny(), device="cpu", seed=0)
    gpt.eval()
    trained_ids = set()

    def _collate(recs):
        ids = np.concatenate([np.asarray(r["prompt"] + r["tokens"],
                                         np.int64) for r in recs])
        trained_ids.update(int(t) for t in ids)
        return {"ids": ids, "target": TARGET[ids]}

    ds = StreamingDataset(batch_size=3, collate=_collate,
                          name=f"drill-{chaos}")

    def _on_complete(rec):   # at-least-once transport: every record twice
        ds.offer(rec)
        ds.offer(rec)

    loop = ServeLoop(gpt, ServeConfig(max_active=4, kv_blocks=16,
                                      block_size=16, max_seq_len=64),
                     on_complete=_on_complete)
    wte0 = gpt.wte.weight.detach().clone().numpy()
    main, loss, emb_name = _build_online_program(PORT, VOCAB, HID, lr=0.25,
                                                 name=f"drill-{chaos}")
    PORT.static.global_scope().set(emb_name, torch.from_numpy(wte0.copy()))
    exe = PORT.static.Executor()
    window = _Window(ds)
    holder = {}
    all_reqs, snaps, prefetchers = [], [], []
    clients = [PSClient(eps, **DRILL_RPC), PSClient(eps, **DRILL_RPC)]
    client_t, client_p = clients
    cache = HeterPSCache(client_p, "wte", HID, capacity=256, host_rows=0)
    pub = EmbeddingSnapshotPublisher(client_p, "wte", cache=cache)

    def serve_phase(k):
        rng = np.random.RandomState(1000 + k)
        reqs = [loop.submit(rng.randint(0, 48, 4).astype(np.int64),
                            max_new_tokens=6) for _ in range(6)]
        loop.run_until_idle()
        all_reqs.extend(reqs)

    def train_phase(client, n_batches, state):
        pf = EmbeddingPrefetcher(client, table="wte")
        prefetchers.append(pf)
        cfg = {"client": client, "mode": "online", "sync_every": 1,
               "trainer_id": 7,
               "sparse": [{"param": emb_name, "slot": "ids",
                           "table": "wte", "prefetcher": pf}],
               "on_batch": lambda d: holder.update(drv=d)}
        if state is not None:
            cfg["state"] = state
        exe.train_from_dataset(program=main,
                               dataset=window.take(n_batches),
                               ps_config=cfg,
                               start_batch=ds.stats()["delivered_batches"])
        drv = holder["drv"]
        assert all(f is None for f in drv._frozen)  # phase fully acked
        return {"online": drv.online_state(), "ds": ds.state_dict()}

    def publish_and_swap():
        version, _ = pub.publish()
        snap = pub.materialize(gpt.wte.weight.detach().numpy())
        loop.publish_weights(version, {"wte.weight": snap})
        loop.run_until_idle()               # applies between beats
        assert loop.model_version == version
        snaps.append(snap)

    before = monitor.stats("serve.")
    stack = contextlib.ExitStack()
    try:
        inj = stack.enter_context(faults.inject(
            seed=11, p={faults.RESET: 0.02, faults.DROP: 0.02})) \
            if chaos else None
        serve_phase(0)
        ckpt = train_phase(client_t, 2, None)            # flush seq 0, 1
        publish_and_swap()                               # v1
        serve_phase(1)
        ckpt = train_phase(client_t, 1, ckpt["online"])  # seq 2
        k_kill = len(holder["drv"].flush_log)
        # the trainer "dies" at its checkpoint and restarts on a fresh
        # client whose replay identity comes from the checkpoint; under
        # chaos a shard primary dies for real
        if chaos:
            servers[0].shutdown()
        client_t2 = PSClient(eps, **DRILL_RPC)
        clients.append(client_t2)
        if chaos:
            _await_promotion(client_t2, eps[0], deadline=60.0)
        ckpt = train_phase(client_t2, 1, ckpt["online"])  # seq 3
        publish_and_swap()                               # v2
        serve_phase(2)
        train_phase(client_t2, 2, ckpt["online"])        # seq 4, 5
        publish_and_swap()                               # v3
        if inj is not None:
            assert inj.fired(faults.RESET) >= 1
            assert inj.fired(faults.DROP) >= 1
        stack.close()

        # zero dropped serve requests across three hot swaps
        assert len(all_reqs) == 18
        assert all(len(r.result(timeout=0)) == 6 for r in all_reqs)
        assert _delta(before, "serve.requests_completed") == 18
        assert _delta(before, "serve.requests_errored") == 0
        assert _delta(before, "serve.hot_swaps") == 3
        assert loop.model_version == 3
        # exactly-once stream accounting
        st = ds.stats()
        assert st["accepted"] == 18 and st["duplicates"] == 18
        assert st["delivered_records"] == 18
        assert st["delivered_batches"] == 6 and st["backlog"] == 0
        # exactly-once delta accounting: the flush schedule replayed
        # against the membership timeline
        log = holder["drv"].flush_log
        assert [seq for _, seq, _ in log] == [0, 1, 2, 3, 4, 5]
        expected = {ep: 0 for ep in eps}
        for _, seq, ids in log:
            for s in sorted({int(i) % 3 for i in ids}):
                for ep in (eps[s], eps[(s + 1) % 3]):
                    if chaos and seq >= k_kill and ep == eps[0]:
                        continue
                    expected[ep] += 1
        live = servers[1:] if chaos else servers
        for s in live:
            assert s.table("wte").applied == expected[s.endpoint]
        # the served model moved toward the traffic, version by version
        ev = np.fromiter(sorted(trained_ids), np.int64)
        m = [float(np.square(w[ev] - TARGET[ev]).mean())
             for w in [wte0] + snaps]
        assert m[1] < m[0] and m[2] < m[1] and m[3] < m[2], m
        table = client_p.pull_sparse("wte", np.arange(VOCAB,
                                                      dtype=np.int64))
        return table, log, [np.asarray(s) for s in snaps]
    finally:
        stack.close()
        _teardown(servers[1:] if chaos else servers, *clients,
                  *prefetchers)


@pytest.mark.chaos
def test_online_learning_drill_killed_run_bitwise_equals_fault_free():
    ref_table, ref_log, ref_snaps = _drill(chaos=False)
    table, log, snaps = _drill(chaos=True)
    assert log == ref_log
    np.testing.assert_array_equal(table, ref_table)
    for a, b in zip(snaps, ref_snaps):
        np.testing.assert_array_equal(a, b)
