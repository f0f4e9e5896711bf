"""The port's device tier of the PS (paddle_tpu_torch/distributed/ps/
heter.py: ``DeviceHashTable``, ``HeterPSCache``) against
paddle_tpu/distributed/ps/heter.py.

Parity, exact: the same inserts (duplicate ids in one batch, ids past a
removal hole in their probe chain, a ``best_effort`` batch that overflows
its probe windows), removes and lookups leave the port's ``keys``
bitwise equal to the JAX package's, with equal rows, found masks, placed
masks and counts; the splitmix64 slots are the JAX package's for every
int64 id, negative and huge ones too. The table lives on the CPU here;
on the card ``chip_smoke.py`` holds the CUDA table to this CPU path.

Then tests/test_heter_ps.py's cases on the port (rtol 1e-5 / 1e-6 and
exact as there), with a 2 s failover heartbeat deadline (see
tests/test_torch_ps_replica.py).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.ps import heter as jheter
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.distributed.ps import (DeviceHashTable, HeterPSCache,
                                             PSClient, PSServer)
from paddle_tpu_torch.distributed.ps import heter as theter


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def test_slots_are_the_jax_packages():
    ids = np.array([0, 1, -1, 2 ** 62, -(2 ** 63), 2 ** 63 - 1,
                    12345678901234, -987654321], np.int64)
    jt = jheter.DeviceHashTable(capacity=1000, dim=1, max_probes=4)
    tt = theter.DeviceHashTable(capacity=1000, dim=1, max_probes=4)
    np.testing.assert_array_equal(
        tt._slots(torch.from_numpy(ids)).numpy(),
        np.asarray(jt._slots(np.asarray(ids))))
    np.testing.assert_array_equal(theter._np_slots(ids, 1000, 4),
                                  np.asarray(jt._slots(np.asarray(ids))))


def _both(capacity, dim, max_probes):
    return (jheter.DeviceHashTable(capacity, dim, max_probes),
            theter.DeviceHashTable(capacity, dim, max_probes))


def _assert_same(j, t, probe):
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t._keys_host, np.asarray(j.keys))
    assert len(t) == len(j)
    jr, jf = j.lookup(probe)
    tr, tf = t.lookup(probe)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_hashtable_keys_bitwise_equal_jax_through_a_script():
    j, t = _both(64, 3, 4)
    rng = np.random.RandomState(0)
    probe = np.arange(-4, 260, dtype=np.int64)
    # duplicate ids in one batch: the last row of each id stays
    ids = np.array([5, 9, 5, 200, 9, 5], np.int64)
    rows = rng.randn(6, 3).astype(np.float32)
    j.insert(ids, rows)
    t.insert(ids, rows)
    _assert_same(j, t, probe)
    for step in range(12):
        ids = rng.randint(0, 256, size=10).astype(np.int64)
        ids[4] = ids[8]
        rows = rng.randn(10, 3).astype(np.float32)
        pj = j.insert(ids, rows, best_effort=True)
        pt = t.insert(ids, rows, best_effort=True)
        np.testing.assert_array_equal(pt, np.asarray(pj))
        gone = rng.randint(0, 256, size=4).astype(np.int64)
        j.remove(gone)
        t.remove(gone)
        _assert_same(j, t, probe)


def test_hashtable_removal_hole_and_overflow_equal_jax():
    # ids 0, 32, 64 ... collide on one probe chain of a 32-slot table
    j, t = _both(32, 2, 8)
    chain = np.arange(8, dtype=np.int64) * 32
    rows = np.arange(16, dtype=np.float32).reshape(8, 2)
    for tab in (j, t):
        tab.insert(chain[:6], rows[:6])
        tab.remove(chain[1:3])                 # a hole inside the chain
        # an id past the hole updates its slot, not the hole
        tab.insert(chain[3:4], np.full((1, 2), 42.0, np.float32))
    _assert_same(j, t, chain)
    # best_effort over a full window: the placed masks match
    over = np.arange(40, dtype=np.int64) * 32
    vals = np.ones((40, 2), np.float32)
    np.testing.assert_array_equal(t.insert(over, vals, best_effort=True),
                                  np.asarray(j.insert(over, vals,
                                                      best_effort=True)))
    _assert_same(j, t, over)
    with pytest.raises(RuntimeError, match="over capacity"):
        t.insert(np.arange(100, 140, dtype=np.int64) * 32,
                 np.zeros((40, 2), np.float32))


def test_insert_scatters_the_last_write_of_each_slot():
    slots = np.array([4, 7, 4, 9, 7, 4])
    np.testing.assert_array_equal(theter.last_per_slot(slots), [3, 4, 5])


def test_device_hashtable_roundtrip():
    t = DeviceHashTable(capacity=64, dim=3)
    ids = np.array([5, 900, 12345678901234, 7], np.int64)
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    t.insert(ids, rows)
    got, found = t.lookup(np.array([7, 5, 999], np.int64))
    assert list(np.asarray(found)) == [True, True, False]
    np.testing.assert_allclose(np.asarray(got)[0], rows[3])
    np.testing.assert_allclose(np.asarray(got)[1], rows[0])
    np.testing.assert_allclose(np.asarray(got)[2], 0.0)
    # overwrite existing key
    t.insert(np.array([5], np.int64), np.full((1, 3), 9.0, np.float32))
    got, _ = t.lookup(np.array([5], np.int64))
    np.testing.assert_allclose(np.asarray(got)[0], 9.0)
    assert len(t) == 4


def test_device_hashtable_collisions_and_capacity():
    # tiny table forces probing; all 8 inserts must still land
    t = DeviceHashTable(capacity=16, dim=1, max_probes=16)
    ids = np.arange(8, dtype=np.int64) * 16    # adversarial-ish stride
    t.insert(ids, np.arange(8, dtype=np.float32).reshape(8, 1))
    got, found = t.lookup(ids)
    assert np.asarray(found).all()
    np.testing.assert_allclose(np.asarray(got)[:, 0], np.arange(8))
    with pytest.raises(RuntimeError):
        big = DeviceHashTable(capacity=4, dim=1, max_probes=2)
        big.insert(np.arange(16, dtype=np.int64),
                   np.zeros((16, 1), np.float32))


@pytest.fixture()
def ps():
    srv = PSServer(tables={"emb": {"type": "sparse", "dim": 4,
                                   "optimizer": "sgd", "lr": 1.0,
                                   "init": "uniform", "seed": 3}})
    srv.start()
    client = PSClient([srv.endpoint])
    yield client
    client.close()
    srv.shutdown()


def test_heter_cache_read_through_and_hit_tracking(ps):
    cache = HeterPSCache(ps, "emb", dim=4, capacity=256)
    ids = np.array([[1, 2], [2, 3]], np.int64)
    rows, index = cache.pull(ids)
    assert rows.shape == (3, 4) and index.shape == (2, 2)
    assert cache.misses == 3 and cache.hits == 0
    server_rows = np.asarray(ps.pull_sparse("emb", np.array([1, 2, 3])))
    np.testing.assert_allclose(np.asarray(rows), server_rows, rtol=1e-6)
    # second pull: all hits, no RPC needed for those rows
    rows2, _ = cache.pull(ids)
    assert cache.hits == 3 and cache.misses == 3
    np.testing.assert_allclose(np.asarray(rows2), server_rows, rtol=1e-6)


def test_heter_cache_push_refreshes(ps):
    cache = HeterPSCache(ps, "emb", dim=4, capacity=256)
    ids = np.array([10, 11], np.int64)
    before, _ = cache.pull(ids)
    g = np.ones((2, 4), np.float32)
    cache.push_grad(ids, g)
    # server applied sgd lr=1.0: row -= g; cache must match the server
    after, _ = cache.pull(ids)
    np.testing.assert_allclose(np.asarray(after),
                               np.asarray(before) - 1.0, rtol=1e-5)
    srv_rows = np.asarray(ps.pull_sparse("emb", ids))
    np.testing.assert_allclose(np.asarray(after), srv_rows, rtol=1e-6)


def test_heter_cache_duplicate_grad_merge(ps):
    cache = HeterPSCache(ps, "emb", dim=4, capacity=64)
    ids = np.array([20, 20, 21], np.int64)
    cache.pull(ids)
    grads = np.stack([np.full(4, 1.0), np.full(4, 2.0),
                      np.full(4, 5.0)]).astype(np.float32)
    before = np.asarray(ps.pull_sparse("emb", np.array([20, 21])))
    cache.push_grad(ids, grads)
    after = np.asarray(ps.pull_sparse("emb", np.array([20, 21])))
    np.testing.assert_allclose(after[0], before[0] - 3.0, rtol=1e-5)
    np.testing.assert_allclose(after[1], before[1] - 5.0, rtol=1e-5)


def _stat(name):
    from paddle_tpu_torch.core import monitor
    return monitor.stat_get(name)


def test_device_hashtable_remove_then_reinsert():
    t = DeviceHashTable(capacity=32, dim=2)
    ids = np.arange(6, dtype=np.int64) * 32      # force probe collisions
    t.insert(ids, np.arange(12, dtype=np.float32).reshape(6, 2))
    t.remove(ids[:2])
    got, found = t.lookup(ids)
    assert list(np.asarray(found)) == [False, False, True, True, True, True]
    assert len(t) == 4
    # re-inserting a key that still sits PAST a removed hole must update
    # the existing slot, not create a duplicate in the hole
    t.insert(ids[2:3], np.full((1, 2), 42.0, np.float32))
    got, found = t.lookup(ids[2:3])
    np.testing.assert_allclose(np.asarray(got)[0], 42.0)
    t.remove(ids[2:3])
    got, found = t.lookup(ids[2:3])
    assert not bool(np.asarray(found)[0])        # no stale duplicate


def test_heter_cache_lru_evicts_to_host_tier(ps):
    cache = HeterPSCache(ps, "emb", dim=4, capacity=4, host_rows=8)
    first = np.arange(4, dtype=np.int64)
    rows_first, _ = cache.pull(first)
    ev0, hh0 = _stat("ps.heter.evictions"), _stat("ps.heter.host_hits")
    cache.pull(np.arange(4, 8, dtype=np.int64))  # evicts the first 4
    assert _stat("ps.heter.evictions") - ev0 == 4
    assert len(cache) == 4 and cache.host_len == 4
    # evicted ids come back from the HOST tier: correct values, no PS RPC
    rpcs0 = _stat("ps.client.pull_rpcs")
    rows_again, _ = cache.pull(first)
    assert _stat("ps.client.pull_rpcs") == rpcs0
    assert _stat("ps.heter.host_hits") - hh0 == 4
    np.testing.assert_array_equal(np.asarray(rows_again),
                                  np.asarray(rows_first))
    np.testing.assert_array_equal(
        np.asarray(rows_again), np.asarray(ps.pull_sparse("emb", first)))


def test_heter_cache_host_tier_disabled_goes_to_ps(ps):
    cache = HeterPSCache(ps, "emb", dim=4, capacity=2, host_rows=0)
    cache.pull(np.array([1, 2], np.int64))
    cache.pull(np.array([3, 4], np.int64))       # 1, 2 evicted, dropped
    assert cache.host_len == 0
    m0 = _stat("ps.heter.misses")
    rows, _ = cache.pull(np.array([1], np.int64))
    assert _stat("ps.heter.misses") - m0 == 1    # re-read through the PS
    np.testing.assert_array_equal(
        np.asarray(rows), np.asarray(ps.pull_sparse("emb", [1])))


def test_heter_cache_push_keeps_tiers_coherent(ps):
    """A pushed id must never be served from a pre-push host-tier copy:
    push refreshes the device tier and drops the host copy."""
    cache = HeterPSCache(ps, "emb", dim=4, capacity=2, host_rows=8)
    cache.pull(np.array([30, 31], np.int64))
    cache.pull(np.array([32, 33], np.int64))     # 30, 31 -> host tier
    assert cache.host_len == 2
    cache.push_grad(np.array([30], np.int64),
                    np.ones((1, 4), np.float32))
    rows, _ = cache.pull(np.array([30], np.int64))
    np.testing.assert_array_equal(
        np.asarray(rows), np.asarray(ps.pull_sparse("emb", [30])))


def test_heter_cache_empty_push_is_noop(ps):
    cache = HeterPSCache(ps, "emb", dim=4, capacity=16)
    cache.push_grad(np.zeros((0,), np.int64), np.zeros((0, 4), np.float32))
    assert len(cache) == 0          # same no-op contract as the client


def test_promoted_backup_rows_repulled_never_stale():
    """Rows cached before a failover promotion are
    INVALIDATED by the shard-map adoption — the next pull re-reads from
    the promoted backup instead of serving the stale cached copy."""
    import time

    from paddle_tpu_torch.core import monitor
    from paddle_tpu_torch.distributed.ps import ShardMap

    spec = {"emb": {"type": "sparse", "dim": 4, "optimizer": "sgd",
                    "lr": 1.0, "init": "uniform", "seed": 3}}
    fast = dict(timeout=5.0, max_retries=2, backoff_base=0.01,
                backoff_max=0.05)
    servers = [PSServer("127.0.0.1:0", dict(spec)) for _ in range(2)]
    eps = [s.start() for s in servers]
    smap = ShardMap.create(eps, n_backups=1)
    for s in servers:
        s.enable_replication(shard_map=smap, peers=eps, n_backups=1,
                             heartbeat_s=0.1, heartbeat_timeout_s=2.0,
                             rpc_opts=dict(fast))
    client_a = PSClient(eps, **fast)
    client_b = PSClient(eps, **fast)
    cache = HeterPSCache(client_a, "emb", dim=4, capacity=64)
    try:
        ids = np.array([0], np.int64)            # shard 0: primary 0
        cached, _ = cache.pull(ids)
        # an INVISIBLE writer updates the row (cache can't see it)...
        client_b.push_sparse_grad("emb", ids, np.ones((1, 4), np.float32))
        fresh_value = np.asarray(client_b.pull_sparse("emb", ids))
        assert not np.array_equal(np.asarray(cached), fresh_value)
        # ...then the primary dies permanently and the backup promotes
        servers[0].shutdown()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                eps[0] in servers[1].replica.shard_map.servers:
            time.sleep(0.05)
        assert eps[0] not in servers[1].replica.shard_map.servers
        inv0 = monitor.stat_get("ps.heter.invalidations")
        # ANY traffic that re-routes adopts the new map; the adoption
        # pends an invalidation that applies before the next row is read
        cache.pull(np.array([7], np.int64))      # miss -> RPC -> adopt
        rows, _ = cache.pull(ids)                # must NOT be the hit
        assert monitor.stat_get("ps.heter.invalidations") - inv0 >= 1
        np.testing.assert_array_equal(np.asarray(rows), fresh_value)
    finally:
        cache_closers = (client_a, client_b)
        for c in cache_closers:
            try:
                c.close()
            except Exception:
                pass
        for s in servers:
            s.shutdown()
