"""The PS tables of the port (paddle_tpu_torch/distributed/ps/table.py)
against paddle_tpu/distributed/ps/table.py.

Parity, exact: the same pushes (grads, deltas, duplicate ids, a state
round trip, merge loads) give bitwise the same table state in both
packages, for every table type and accessor (sgd / adagrad / adam) and
every splitmix64 initializer, and fresh rows are bitwise equal. Then
tests/test_ps.py's table cases (hand-computed update rules, atol 1e-5
and 1e-6 as there) on the port.
"""
import numpy as np
import pytest

from paddle_tpu.distributed.ps import table as jtable
from paddle_tpu_torch.distributed.ps import table as ttable

DIM = 4


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, np.asarray(tree)


def _assert_same_state(a, b):
    la, lb = dict(_leaves(a.state())), dict(_leaves(b.state()))
    assert sorted(la) == sorted(lb)
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))
    assert a.applied == b.applied


SPARSE = [dict(type="sparse", dim=DIM, optimizer=o, lr=lr, init=i, seed=s)
          for o, lr in (("sgd", 0.5), ("adagrad", 0.05), ("adam", 0.01))
          for i, s in (("zeros", 0), ("uniform", 7), ("normal", 11))]


@pytest.mark.parametrize("spec", SPARSE, ids=lambda s: f"{s['optimizer']}-"
                         f"{s['init']}")
def test_sparse_table_state_bitwise_equals_jax(spec):
    tabs = [jtable.make_table(spec), ttable.make_table(spec)]
    rng = np.random.RandomState(0)
    for step in range(8):
        ids = rng.randint(-5, 300, size=16).astype(np.int64)
        ids[2] = ids[9]                          # duplicates merge
        pulled = [t.pull(ids) for t in tabs]
        np.testing.assert_array_equal(pulled[1], pulled[0])
        g = pulled[0] * 0.1 + rng.randn(16, DIM).astype(np.float32)
        for t in tabs:
            t.push_grad(ids, g)
    _assert_same_state(*tabs)
    # a state round trip (and a merge load) keeps them equal
    st = tabs[0].state()
    fresh = [jtable.make_table(spec), ttable.make_table(spec)]
    for t in fresh:
        t.load_state(st)
    _assert_same_state(*fresh)
    for t in fresh:
        t.load_state(st, merge=True)
        t.push_grad([1, 2], np.ones((2, DIM), np.float32))
    _assert_same_state(*fresh)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("init", ["zeros", "uniform", "normal"])
def test_dense_table_state_bitwise_equals_jax(optimizer, init):
    spec = dict(type="dense", shape=(3, DIM), optimizer=optimizer, lr=0.05,
                init=init, seed=5)
    tabs = [jtable.make_table(spec), ttable.make_table(spec)]
    np.testing.assert_array_equal(tabs[1].pull(), tabs[0].pull())
    rng = np.random.RandomState(1)
    for _ in range(6):
        g = tabs[0].pull() * 0.2 + rng.randn(3, DIM).astype(np.float32)
        for t in tabs:
            t.push_grad(g)
    for t in tabs:
        t.set(np.full((3, DIM), 0.5, np.float32))
        t.push_grad(np.ones((3, DIM), np.float32))
    _assert_same_state(*tabs)


def test_geo_table_deltas_bitwise_equal_jax():
    spec = dict(type="geo_sparse", dim=DIM, init="uniform", seed=2)
    tabs = [jtable.make_table(spec), ttable.make_table(spec)]
    rng = np.random.RandomState(2)
    for _ in range(6):
        ids = rng.randint(0, 50, size=10).astype(np.int64)
        ids[0] = ids[1]
        d = rng.randn(10, DIM).astype(np.float32)
        for t in tabs:
            t.push_delta(ids, d)
    _assert_same_state(*tabs)


def test_barrier_table_releases_like_jax():
    import threading
    for mod in (jtable, ttable):
        t = mod.make_table({"type": "barrier", "trainer_num": 2})
        out = []
        th = threading.Thread(target=lambda: out.append(t.wait(1, 30.0)))
        th.start()
        assert t.wait(0, 30.0)
        th.join(30)
        assert out == [True]
        with pytest.raises(TimeoutError):
            mod.make_table({"type": "barrier", "trainer_num": 2}).wait(
                0, 0.05)


# -------------------------------- tests/test_ps.py's table cases, the port

def test_dense_table_sgd():
    from paddle_tpu_torch.distributed.ps.table import DenseTable
    t = DenseTable((3, 2), optimizer="sgd", lr=0.1)
    g = np.ones((3, 2), np.float32)
    t.push_grad(g)
    np.testing.assert_allclose(t.pull(), -0.1 * g, atol=1e-6)


def test_dense_table_adam_matches_formula():
    from paddle_tpu_torch.distributed.ps.table import DenseTable
    t = DenseTable((4,), optimizer="adam", lr=0.01)
    rng = np.random.RandomState(0)
    p = np.zeros(4, np.float64)
    m = np.zeros(4)
    v = np.zeros(4)
    for step in range(1, 6):
        g = rng.randn(4)
        t.push_grad(g.astype(np.float32))
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** step)
        vh = v / (1 - 0.999 ** step)
        p -= 0.01 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(t.pull(), p, atol=1e-5)


def test_sparse_table_lazy_rows_and_merge():
    from paddle_tpu_torch.distributed.ps.table import SparseTable
    t = SparseTable(dim=3, optimizer="sgd", lr=1.0, init="zeros")
    assert len(t) == 0
    rows = t.pull([5, 9, 5])
    assert rows.shape == (3, 3) and len(t) == 2  # lazy creation, 2 unique
    # duplicate ids in one push must accumulate (MergeAdd) before the rule
    t.push_grad([5, 5, 9], np.ones((3, 3), np.float32))
    got = t.pull([5, 9])
    np.testing.assert_allclose(got[0], -2 * np.ones(3), atol=1e-6)
    np.testing.assert_allclose(got[1], -1 * np.ones(3), atol=1e-6)


def test_sparse_table_adagrad_rule():
    from paddle_tpu_torch.distributed.ps.table import SparseTable
    t = SparseTable(dim=2, optimizer="adagrad", lr=0.1, init="zeros")
    g = np.array([[1.0, 2.0]], np.float32)
    t.push_grad([7], g)
    expect = -0.1 * g / (np.sqrt(g * g) + 1e-6)
    np.testing.assert_allclose(t.pull([7]), expect, atol=1e-5)


def test_geo_table_folds_deltas():
    from paddle_tpu_torch.distributed.ps.table import GeoSparseTable
    t = GeoSparseTable(dim=2, init="zeros")
    t.push_delta([3, 3], np.array([[1, 1], [2, 2]], np.float32))
    np.testing.assert_allclose(t.pull([3]), [[3, 3]], atol=1e-6)


def test_table_state_roundtrip():
    from paddle_tpu_torch.distributed.ps.table import SparseTable
    a = SparseTable(dim=4, optimizer="adagrad", lr=0.05)
    a.push_grad([1, 2, 3], np.random.RandomState(0).randn(3, 4)
                .astype(np.float32))
    b = SparseTable(dim=4, optimizer="adagrad", lr=0.05)
    b.load_state(a.state())
    np.testing.assert_allclose(a.pull([1, 2, 3]), b.pull([1, 2, 3]))
    # slots carried over: identical next update
    g = np.ones((1, 4), np.float32)
    a.push_grad([2], g)
    b.push_grad([2], g)
    np.testing.assert_allclose(a.pull([2]), b.pull([2]), atol=1e-6)
