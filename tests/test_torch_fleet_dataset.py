"""Port parity: the MultiSlot parser (paddle_tpu_torch/_native) and the
InMemory / Queue datasets (paddle_tpu_torch/io/fleet_dataset.py) against
the JAX package's ``_parse_multislot_py`` and ``io/fleet_dataset.py``.

The files are written here: tests/test_dataset_pipeline.py's dense rows,
a ragged slot, and LMDataset batches (ids and MLM labels, 128 a row).
Values, row splits, orders and batches are compared exactly."""
import os

import numpy as np
import pytest

from paddle_tpu import _native as jnative
from paddle_tpu.io import fleet_dataset as jfd
from paddle_tpu.text.datasets import LMDataset
from paddle_tpu_torch import _native as tnative
from paddle_tpu_torch.io import fleet_dataset as tfd

FD = {"jax": jfd, "port": tfd}


class _Var:
    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def _dense_files(tmp_path, n_files=2, rows=8):
    """tests/test_dataset_pipeline.py's rows: '1 <label> 4 <x0..x3>'."""
    rng = np.random.RandomState(0)
    files = []
    for fi in range(n_files):
        path = os.path.join(str(tmp_path), f"part-{fi:03d}.txt")
        with open(path, "w") as f:
            for _ in range(rows):
                x = rng.rand(4)
                f.write("1 %d 4 %s\n" % (int(x.sum() > 2.0),
                                         " ".join(f"{v:.6f}" for v in x)))
        files.append(path)
    return files


def write_lm_multislot(path, ds, rows):
    """LMDataset rows as MultiSlot lines: the ids slot, then the labels."""
    with open(path, "w") as f:
        for i in rows:
            ids, lab = ds[i]
            f.write(f"{len(ids)} {' '.join(map(str, ids))} "
                    f"{len(lab)} {' '.join(map(str, lab))}\n")
    return path


DENSE_VARS = [_Var("y", [-1, 1], "int64"), _Var("x", [-1, 4], "float32")]


def _lm_files(tmp_path, n=24, seq=128):
    ds = LMDataset(vocab_size=1000, seq_len=seq, n=n, seed=3)
    half = n // 2
    return [write_lm_multislot(os.path.join(str(tmp_path), f"lm-{k}.txt"),
                               ds, range(k * half, (k + 1) * half))
            for k in range(2)], ds


LM_VARS = [_Var("ids", [-1, 128], "int64"), _Var("labels", [-1, 128],
                                                  "int64")]


@pytest.mark.parametrize("kind", ["dense", "ragged", "lm"])
def test_parser_values_and_splits_equal_jax(kind, tmp_path):
    if kind == "dense":
        files, types = _dense_files(tmp_path), ["uint64", "float"]
    elif kind == "ragged":
        path = os.path.join(str(tmp_path), "ragged.txt")
        with open(path, "w") as f:
            f.write("2 5 6 1 0.5\n3 7 8 9 2 1.5 -2.25\n\n0 1 3.0\n")
        files, types = [path], ["uint64", "float"]
    else:
        files, types = _lm_files(tmp_path)[0], ["uint64", "uint64"]
    for path in files:
        jr, jslots = jnative._parse_multislot_py(path, types)
        tr, tslots = tnative.parse_multislot_file(path, types)
        assert jr == tr
        for (jv, js), (tv, ts) in zip(jslots, tslots):
            assert jv.dtype == tv.dtype and js.dtype == ts.dtype
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(ts, js)


def _loaded(P, files, use_var, batch=4, seed=0):
    ds = FD[P].InMemoryDataset()
    ds.init(batch_size=batch, thread_num=2, use_var=use_var)
    ds.set_filelist(files)
    ds._seed = seed
    ds.load_into_memory()
    return ds


def _same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("shuffle", ["none", "local", "global"])
def test_in_memory_orders_and_batches_equal_jax(shuffle, tmp_path):
    files = _dense_files(tmp_path, rows=10)
    got = {}
    for P in FD:
        ds = _loaded(P, files, DENSE_VARS, seed=5)
        if shuffle == "local":
            ds.local_shuffle()
            ds.local_shuffle()
        elif shuffle == "global":
            ds.global_shuffle()
        got[P] = (ds._order.copy(), list(ds.batches()),
                  list(ds.batches(drop_last=False)))
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    _same_batches(got["port"][1], got["jax"][1])
    _same_batches(got["port"][2], got["jax"][2])


def test_global_shuffle_shards_by_rank_as_jax(tmp_path, monkeypatch):
    """Rank 1 of 3: the port reads distributed/env, JAX jax.process_*."""
    import jax
    files = _dense_files(tmp_path, rows=10)
    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    orders = {}
    for P in FD:
        ds = _loaded(P, files, DENSE_VARS)
        ds.global_shuffle()
        orders[P] = ds._order
    assert len(orders["port"]) == 7
    np.testing.assert_array_equal(orders["port"], orders["jax"])


def test_state_dict_resume_equals_jax(tmp_path):
    """A shuffled run cut after 2 batches resumes from the state_dict at
    batch 2 (restored before and after load_into_memory) with JAX's
    batches."""
    files, _ = _lm_files(tmp_path)
    res = {}
    for P in FD:
        ds = _loaded(P, files, LM_VARS)
        ds.local_shuffle()
        full = list(ds.batches())
        sd = ds.state_dict()
        early = FD[P].InMemoryDataset()
        early.init(batch_size=4, use_var=LM_VARS)
        early.set_filelist(files)
        early.load_state_dict(sd)          # deferred to the load
        early.load_into_memory()
        late = _loaded(P, files, LM_VARS)
        late.load_state_dict(sd)
        res[P] = (full, list(early.batches(start_batch=2)),
                  list(late.batches(start_batch=2)), sd)
        _same_batches(res[P][1], full[2:])
        _same_batches(res[P][2], full[2:])
    _same_batches(res["port"][0], res["jax"][0])
    assert res["port"][3]["seed"] == res["jax"][3]["seed"]
    np.testing.assert_array_equal(res["port"][3]["order"],
                                  res["jax"][3]["order"])


def test_lm_batches_shaped_to_the_feed_vars(tmp_path):
    files, lm = _lm_files(tmp_path)
    ds = _loaded("port", files, LM_VARS)
    batches = list(ds.batches())
    assert len(batches) == 6
    ids, lab = lm[0]
    np.testing.assert_array_equal(batches[0]["ids"][0], ids)
    np.testing.assert_array_equal(batches[0]["labels"][0], lab)
    assert batches[0]["ids"].dtype == np.int64
    assert batches[0]["ids"].shape == (4, 128)


def test_ragged_slot_pads_to_declared_width(tmp_path):
    path = os.path.join(str(tmp_path), "ragged.txt")
    with open(path, "w") as f:
        f.write("2 5 6\n3 7 8 9\n")
    got = {}
    for P in FD:
        ds = _loaded(P, [path], [_Var("ids", [-1, 4], "int64")], batch=2)
        (got[P],) = list(ds.batches())
    np.testing.assert_array_equal(got["port"]["ids"],
                                  [[5, 6, 0, 0], [7, 8, 9, 0]])
    _same_batches([got["port"]], [got["jax"]])


def test_queue_dataset_and_factory_equal_jax(tmp_path):
    files = _dense_files(tmp_path)
    got = {}
    for P in FD:
        ds = FD[P].DatasetFactory().create_dataset("QueueDataset")
        ds.init(batch_size=4, thread_num=1, use_var=DENSE_VARS)
        ds.set_filelist(files)
        got[P] = list(ds.batches())
        assert isinstance(FD[P].DatasetFactory().create_dataset(
            "InMemoryDataset"), FD[P].InMemoryDataset)
        with pytest.raises(ValueError):
            FD[P].DatasetFactory().create_dataset("Nope")
    _same_batches(got["port"], got["jax"])


def test_release_memory_and_missing_use_var(tmp_path):
    files = _dense_files(tmp_path)
    ds = _loaded("port", files, DENSE_VARS)
    assert ds.get_memory_data_size() == 16
    ds.release_memory()
    assert ds.get_memory_data_size() == 0
    with pytest.raises(RuntimeError, match="load_into_memory"):
        list(ds.batches())
    bare = tfd.InMemoryDataset()
    bare.set_filelist(files)
    with pytest.raises(ValueError, match="set_use_var"):
        bare.load_into_memory()
