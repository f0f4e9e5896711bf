"""Port parity: datasets, samplers, the DataLoader and save / load
(paddle_tpu_torch/io, paddle_tpu_torch/framework/io.py) against
paddle_tpu.io and paddle_tpu.framework.io.

The batch order is compared exactly (index lists, and batch values
drawn from an index-valued dataset): shuffles are numpy draws in both
packages, so the same seed must give the same order. Saved values must
come back bitwise. No tolerance is used in this file.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import framework as tframework
from paddle_tpu_torch import io as tio

N = 23      # not a multiple of any batch size below: ragged last batches


def _ds(pkg):
    """An index-valued dataset: sample i is (i, [i, -i] as f32)."""
    x = np.arange(N, dtype=np.int64)
    y = np.stack([x, -x], 1).astype(np.float32)
    return pkg.TensorDataset([x, y])


def _ids(batches):
    """The sample indices of each batch, from its first member."""
    return [np.asarray(b[0]).tolist() for b in batches]


def _run(pkg, seed, **kw):
    np.random.seed(seed)
    return _ids(list(pkg.DataLoader(_ds(pkg), **kw)))


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=True),
    dict(batch_size=5, shuffle=True, drop_last=True),
    dict(batch_size=4, shuffle=True, shuffle_seed=7),
    dict(batch_size=3, shuffle=True, num_workers=2),
    dict(batch_size=3, shuffle=True, num_workers=2, use_shared_memory=False),
], ids=["sequential", "shuffle", "drop_last", "shuffle_seed", "workers",
        "threads"])
def test_batch_order_matches_jax(kw):
    want = _run(jio, 11, **kw)
    got = _run(tio, 11, **kw)
    assert got == want
    if kw.get("shuffle"):
        assert got != _run(tio, 12, **kw) or "shuffle_seed" in kw


def test_batches_are_cpu_tensors_with_the_values():
    x, y = next(iter(tio.DataLoader(_ds(tio), batch_size=4,
                                    num_workers=2)))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert x.dtype == torch.int64 and y.dtype == torch.float32
    assert x.tolist() == [0, 1, 2, 3]
    assert y.tolist() == [[i, -i] for i in range(4)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_matches_jax(shuffle, drop_last):
    for rank in range(3):
        order = {}
        for name, pkg in (("jax", jio), ("port", tio)):
            s = pkg.DistributedBatchSampler(_ds(pkg), batch_size=3,
                                            num_replicas=3, rank=rank,
                                            shuffle=shuffle,
                                            drop_last=drop_last)
            epochs = []
            for e in range(3):
                s.set_epoch(e)
                epochs.append(list(s))
            order[name] = (epochs, len(s))
        assert order["port"] == order["jax"]


def test_distributed_batch_sampler_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    s = tio.DistributedBatchSampler(_ds(tio), batch_size=2)
    assert (s.nranks, s.local_rank) == (4, 2)
    j = jio.DistributedBatchSampler(_ds(jio), batch_size=2)
    assert list(s) == list(j)


@pytest.mark.parametrize("kw", [dict(shuffle_seed=3), dict()],
                         ids=["private_stream", "global_stream"])
def test_mid_epoch_resume_equals_the_uninterrupted_run(kw):
    """Two epochs read straight through, against one loader stopped after
    3 batches of epoch 1 whose ``state_dict`` arms a fresh loader: the
    fresh loader's batches are the rest of the uninterrupted run."""
    np.random.seed(5)
    full = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True, **kw)
    want = _ids(list(full)) + _ids(list(full))
    np.random.seed(5)
    first = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True, **kw)
    got = _ids(list(first))
    it = iter(first)
    got += _ids([next(it) for _ in range(3)])
    state = first.state_dict()
    it.close()
    np.random.seed(99)        # the resumed run must not need the seed
    second = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True, **kw)
    second.load_state_dict(state)
    got += _ids(list(second))
    assert got == want
    # the JAX loader's state has the same shape and resumes the same way
    np.random.seed(5)
    jfirst = jio.DataLoader(_ds(jio), batch_size=4, shuffle=True, **kw)
    list(jfirst)
    jit = iter(jfirst)
    [next(jit) for _ in range(3)]
    jstate = jfirst.state_dict()
    jit.close()
    assert jstate["epoch"] == state["epoch"] == 1
    assert jstate["batch"] == state["batch"] == 3


def test_resume_at_the_epoch_end_rolls_to_a_fresh_epoch():
    loader = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True,
                            shuffle_seed=1)
    want = [_ids(list(loader)) for _ in range(2)]
    again = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True,
                           shuffle_seed=1)
    list(again)
    it = iter(again)
    [next(it) for _ in range(2)]
    state = again.state_dict()
    it.close()
    fresh = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True,
                           shuffle_seed=1)
    fresh.load_state_dict(state)
    fresh.roll_resumed_epoch()      # the caller ended that epoch early
    got = _ids(list(fresh))
    assert got != want[1]
    third = tio.DataLoader(_ds(tio), batch_size=4, shuffle=True,
                           shuffle_seed=1)
    assert got == [_ids(list(third)) for _ in range(3)][2]


def _flat(x):
    if isinstance(x, dict):
        return {k: _flat(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_flat(v) for v in x]
    return np.asarray(x).tolist()


def test_default_collate_fn_matches_jax():
    rng = np.random.RandomState(0)
    tuples = [(rng.randn(3).astype(np.float32), int(i), float(i) / 2)
              for i in range(4)]
    dicts = [{"x": rng.randn(2, 2), "y": np.int64(i), "name": f"s{i}"}
             for i in range(3)]
    for batch in (tuples, dicts):
        want = jio.default_collate_fn(batch)
        got = tio.default_collate_fn(batch)
        assert type(got) is type(want)
        assert _flat(got) == _flat(want)
    tensors = [torch.full((2,), float(i)) for i in range(3)]
    assert tio.default_collate_fn(tensors).tolist() == \
        [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]
    # the loader hands dict batches out as CPU tensors (strings as lists)
    loader = tio.DataLoader(dicts, batch_size=3)
    loader_batch = next(iter(loader))
    assert isinstance(loader_batch["x"], torch.Tensor)
    assert loader_batch["name"] == ["s0", "s1", "s2"]


def test_dataset_containers_match_jax():
    a, b = _ds(jio), _ds(tio)
    for jd, td in ((jio.Subset(a, [3, 1, 4]), tio.Subset(b, [3, 1, 4])),
                   (jio.ConcatDataset([a, a]), tio.ConcatDataset([b, b])),
                   (jio.ComposeDataset([a, a]), tio.ComposeDataset([b, b]))):
        assert len(jd) == len(td)
        for i in (0, len(td) - 1):
            assert _flat(td[i]) == _flat(jd[i])
    np.random.seed(3)
    jparts = jio.random_split(a, [10, 13])
    np.random.seed(3)
    tparts = tio.random_split(b, [10, 13])
    assert [p.indices for p in tparts] == [p.indices for p in jparts]
    chained = [x for x in tio.ChainDataset([[1, 2], [3]])]
    assert chained == [1, 2, 3]


def test_weighted_random_sampler_matches_jax():
    w = [0.1, 0.5, 0.2, 0.2]
    np.random.seed(4)
    want = list(jio.WeightedRandomSampler(w, 12))
    np.random.seed(4)
    assert list(tio.WeightedRandomSampler(w, 12)) == want


def _tree():
    return {"w": torch.randn(3, 4), "half": torch.randn(5).half(),
            "bf16": torch.randn(2, 3).to(torch.bfloat16),
            "ids": torch.arange(6), "np": np.arange(4.0),
            "meta": {"step": 7, "names": ["a", "b"], "t": (1, 2.5)}}


def test_save_load_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    path = str(tmp_path / "sub" / "x.pdparams")
    tframework.save(tree, path)
    back = tframework.load(path)
    for k in ("w", "half", "bf16", "ids"):
        assert isinstance(back[k], torch.Tensor)
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k])
    assert isinstance(back["np"], np.ndarray)
    assert back["meta"] == tree["meta"]
    numpy_back = tframework.load(path, return_numpy=True)
    assert isinstance(numpy_back["w"], np.ndarray)
    assert sorted(os.listdir(tmp_path / "sub")) == ["x.pdparams"]


def _jax_file(tmp_path):
    rng = np.random.RandomState(2)
    vals = {"w": rng.randn(3, 4).astype(np.float32),
            "bf16": rng.randn(4).astype(np.float32),
            "half": rng.randn(2).astype(np.float16)}
    tree = {"w": Tensor(jnp.asarray(vals["w"]), _internal=True),
            "bf16": Tensor(jnp.asarray(vals["bf16"], jnp.bfloat16),
                           _internal=True),
            "half": Tensor(jnp.asarray(vals["half"]), _internal=True),
            "arr": np.arange(3), "step": 5}
    path = str(tmp_path / "jax.pdparams")
    paddle.save(tree, path)
    return path, vals


def test_port_reads_a_file_the_jax_package_wrote(tmp_path):
    """The JAX file pickles ``paddle_tpu.framework.io._NDArrayLeaf``; the
    port's loader maps that class to its own, so its leaves come back as
    torch tensors (and as numpy with return_numpy)."""
    path, vals = _jax_file(tmp_path)
    got = tframework.load(path)
    assert isinstance(got["w"], torch.Tensor)
    assert np.array_equal(got["w"].numpy(), vals["w"])
    assert got["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["bf16"],
                       torch.from_numpy(vals["bf16"]).to(torch.bfloat16))
    assert got["half"].dtype == torch.float16
    assert np.array_equal(got["half"].numpy(), vals["half"])
    assert np.array_equal(got["arr"], np.arange(3)) and got["step"] == 5


def test_loading_a_jax_file_imports_neither_jax_nor_the_jax_package(
        tmp_path):
    """In a process where importing jax or paddle_tpu fails, the port
    still reads the JAX-written file."""
    path, vals = _jax_file(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        sys.path.insert(0, {repo!r})
        from paddle_tpu_torch.framework import load
        got = load({path!r})
        print(type(got["w"]).__name__, got["w"].shape[0], got["step"])
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["Tensor", "3", "5"]


NEW_MODULES = (
    "paddle_tpu_torch.core.numeric_check",
    "paddle_tpu_torch.core.flight_recorder",
    "paddle_tpu_torch.static.pipeline_runner",
    "paddle_tpu_torch.static.capi_train",
    "paddle_tpu_torch._native", "paddle_tpu_torch.io.fleet_dataset",
    "paddle_tpu_torch.dataset", "paddle_tpu_torch.dataset.streaming",
    "paddle_tpu_torch.incubate.checkpoint",
    "paddle_tpu_torch.utils.log_writer", "paddle_tpu_torch.hapi.callbacks",
    "paddle_tpu_torch.traffic.harness", "chip_smoke")


def test_new_modules_and_saving_import_neither_jax_nor_the_jax_package(
        tmp_path):
    """In a process where importing jax or paddle_tpu fails, the trainer's
    host-path modules and chip_smoke.py import, and ``save`` writes a file
    whose leaves name the JAX package's class without importing it."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = str(tmp_path / "port.pdparams")
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        sys.path.insert(0, {repo!r})
        for m in {NEW_MODULES!r}:
            importlib.import_module(m)
        import torch
        from paddle_tpu_torch.framework import load, save
        save({{"w": torch.ones(2, dtype=torch.bfloat16)}}, {path!r})
        print(load({path!r})["w"].dtype)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["torch.bfloat16"]


def _crossing_tree(rng):
    return {"f32": rng.randn(3, 4).astype(np.float32),
            "bf16": rng.randn(5).astype(np.float32),
            "i64": rng.randint(-9, 9, (2, 3)).astype(np.int64),
            "arr": rng.randn(2).astype(np.float32)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_cross_both_ways(writer, tmp_path):
    """A dict of f32 / bf16 / int64 tensors and a numpy array, written by
    one package, read by the other (and by its writer): the values and
    kinds come back; the port reads its bf16 leaves back as bf16, JAX
    reads them as their exact f32 values."""
    vals = _crossing_tree(np.random.RandomState(4))
    bf16_exact = torch.from_numpy(vals["bf16"]).to(torch.bfloat16)
    path = str(tmp_path / f"{writer}.pdparams")
    if writer == "port":
        tframework.save({"f32": torch.from_numpy(vals["f32"]),
                         "bf16": bf16_exact,
                         "i64": torch.from_numpy(vals["i64"]),
                         "arr": vals["arr"], "n": 3}, path)
    else:
        paddle.save({"f32": Tensor(jnp.asarray(vals["f32"]), _internal=True),
                     "bf16": Tensor(jnp.asarray(vals["bf16"], jnp.bfloat16),
                                    _internal=True),
                     "i64": Tensor(jnp.asarray(vals["i64"]), _internal=True),
                     "arr": vals["arr"], "n": 3}, path)
    port = tframework.load(path)
    assert port["bf16"].dtype == torch.bfloat16
    assert torch.equal(port["bf16"], bf16_exact)
    assert port["f32"].dtype == torch.float32 \
        and np.array_equal(port["f32"].numpy(), vals["f32"])
    assert port["i64"].dtype == torch.int64 \
        and np.array_equal(port["i64"].numpy(), vals["i64"])
    assert isinstance(port["arr"], np.ndarray) and port["n"] == 3
    jax_side = paddle.load(path)
    assert np.array_equal(np.asarray(jax_side["f32"].numpy()), vals["f32"])
    assert np.array_equal(np.asarray(jax_side["i64"].numpy()), vals["i64"])
    np.testing.assert_array_equal(
        np.asarray(jax_side["bf16"].numpy()).astype(np.float32),
        bf16_exact.float().numpy())
    assert isinstance(jax_side["arr"], np.ndarray) and jax_side["n"] == 3
