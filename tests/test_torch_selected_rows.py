"""Port parity: core/selected_rows.py, the sparse embedding gradient
(``nn.functional.embedding(sparse=True)``) and the row-wise optimizer
updates (SGD; Adam / AdamW ``lazy_mode``) against the JAX package's eager
tape on the same table, ids and steps.

The port's table gets a sparse COO gradient of the looked-up rows
(``SelectedRows.of(p.grad)``); coalesced, its rows equal JAX's SelectedRows
rows exactly and its values within rtol 1e-6. After each step the tables
and Adam's moments agree within rtol 1e-6 / atol 1e-7 (f32 arithmetic in
another order), and the rows no id touched are bitwise unchanged in both,
with moments still zero.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR

V, D = 20, 4
TOL = dict(rtol=1e-6, atol=1e-7)
TABLE = np.random.RandomState(0).randn(V, D).astype(np.float32)
IDS = [np.random.RandomState(s).randint(0, 12, (3, 5)).astype(np.int64)
       for s in (1, 2, 3)]
TGT = np.random.RandomState(4).randn(3, 5, D).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def test_selected_rows_add_coalesce_dense_as_jax():
    rows = np.array([3, 1, 3, 0])
    vals = np.random.RandomState(5).randn(4, D).astype(np.float32)
    j = JSR(rows, vals, (V, D)) + JSR(rows[:2], vals[:2], (V, D))
    t = TSR(rows, torch.from_numpy(vals), (V, D)) \
        + TSR(rows[:2], torch.from_numpy(vals[:2]), (V, D))
    jc, tc = j.coalesce(), t.coalesce()
    np.testing.assert_array_equal(tc.rows.numpy(), np.asarray(jc.rows))
    np.testing.assert_allclose(tc.values.numpy(), np.asarray(jc.values),
                               **TOL)
    np.testing.assert_allclose(t.numpy(), j.numpy(), **TOL)
    assert t.height == V and t.shape == (V, D)
    assert t.nbytes == 6 * D * 4 + 6 * 8
    dense = np.ones((V, D), np.float32)
    np.testing.assert_allclose((t + torch.from_numpy(dense)).numpy(),
                               np.asarray(j + dense), **TOL)


def _run(pkg, opt_name, steps, padding_idx=None, **kw):
    emb = pkg.nn.Embedding(V, D, padding_idx=padding_idx, sparse=True)
    emb.weight.set_value(TABLE)
    opt = getattr(pkg.optimizer, opt_name)(
        learning_rate=0.1, parameters=emb.parameters(), **kw)
    grads, tables, moments = [], [], []
    for s in range(steps):
        out = emb(pkg.to_tensor(IDS[s]))
        loss = ((out - pkg.to_tensor(TGT)) ** 2).sum()
        loss.backward()
        g = emb.weight.grad
        if pkg is tp:
            assert g.is_sparse           # never dense on the sparse path
            sr = TSR.of(g).coalesce()
            grads.append((sr.rows.numpy(), sr.values.numpy()))
        else:
            sr = g._value.coalesce()
            grads.append((np.asarray(sr.rows), np.asarray(sr.values)))
        opt.step()
        opt.clear_grad()
        tables.append(np.array(emb.weight.numpy()))
        sl = opt._slots.get(next(iter(opt._slots)), {}) if opt._slots \
            else {}
        moments.append({k: np.array(np.asarray(v.cpu() if hasattr(v, "cpu")
                                               else v))
                        for k, v in sl.items()})
    return grads, tables, moments


@pytest.mark.parametrize("opt_name, kw", [
    ("SGD", {}),
    ("Adam", {"lazy_mode": True}),
    ("AdamW", {"lazy_mode": True}),
    ("Adam", {}),
], ids=["sgd", "adam_lazy", "adamw_lazy", "adam_dense"])
@pytest.mark.parametrize("padding_idx", [None, 2])
def test_sparse_steps_match_jax(opt_name, kw, padding_idx):
    j = _run(jp, opt_name, 3, padding_idx, **kw)
    t = _run(tp, opt_name, 3, padding_idx, **kw)
    for (jr, jv), (tr_, tv) in zip(j[0], t[0]):
        np.testing.assert_array_equal(tr_, jr)
        np.testing.assert_allclose(tv, jv, **TOL)
    for a, b in zip(t[1], j[1]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(t[2], j[2]):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], **TOL)
    if opt_name != "Adam" or kw:
        # the rows no id touched: bitwise the initial table, moments 0
        touched = np.unique(np.concatenate([i.reshape(-1) for i in IDS]))
        untouched = np.setdiff1d(np.arange(V), touched)
        np.testing.assert_array_equal(t[1][-1][untouched], TABLE[untouched])
        for k, m in t[2][-1].items():
            assert not m[untouched].any(), k


def test_lazy_mode_constructs_and_a_dense_grad_takes_the_dense_rule():
    """The former raise point: Adam(lazy_mode=True) builds, and a dense
    gradient on a lazy Adam is the plain Adam step."""
    w = tp.to_tensor(TABLE, stop_gradient=False)
    opt = tp.optimizer.Adam(learning_rate=0.1, parameters=[w],
                            lazy_mode=True)
    (w * w).sum().backward()
    opt.step()
    ref = tp.to_tensor(TABLE, stop_gradient=False)
    opt2 = tp.optimizer.Adam(learning_rate=0.1, parameters=[ref])
    (ref * ref).sum().backward()
    opt2.step()
    np.testing.assert_array_equal(w.numpy(), ref.numpy())


def test_sparse_grads_accumulate_without_densifying():
    emb = tp.nn.Embedding(V, D, sparse=True)
    for ids in IDS[:2]:
        emb(tp.to_tensor(ids)).sum().backward()
    g = emb.weight.grad
    assert g.is_sparse and g._nnz() == IDS[0].size + IDS[1].size
    want = np.zeros((V, D), np.float32)
    for ids in IDS[:2]:
        np.add.at(want, ids.reshape(-1), 1.0)
    np.testing.assert_array_equal(TSR.of(g).numpy(), want)
