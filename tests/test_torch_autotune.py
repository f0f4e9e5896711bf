"""Port parity: the block-size table (paddle_tpu_torch/ops/cuda/autotune.py)
against paddle_tpu/ops/pallas/autotune.py, and the pool's block size
(paddle_tpu_torch/nn/kv_pool.pick_block_size).

tests/test_pallas_autotune.py's semantics with a fake ``measure``
(``FLAGS_pallas_autotune_force`` makes the CPU measure): measured once,
kept in process and on disk, a corrupt cache ignored, nothing measured
off the card without the force flag. The port's key carries the device
name, so a table measured on one card is not read on another, and a
candidate that raises is counted. ``pick_block_size`` gives JAX's
default on the CPU for the same arguments.
"""
import json

import pytest
import torch

from paddle_tpu.nn import kv_pool as jkv_pool
from paddle_tpu.ops.pallas import autotune as jautotune
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.core import flags, monitor
from paddle_tpu_torch.inference import ServeConfig, ServeLoop
from paddle_tpu_torch.nn import kv_pool
from paddle_tpu_torch.ops.cuda import autotune
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture
def tuning(tmp_path, monkeypatch):
    """Measuring forced on the CPU, with a fresh disk cache file."""
    cache = tmp_path / "autotune.json"
    monkeypatch.setenv("PADDLE_TPU_CUDA_AUTOTUNE_CACHE", str(cache))
    autotune.clear()
    flags.set_flags({"FLAGS_pallas_autotune_force": True})
    yield cache
    flags.set_flags({"FLAGS_pallas_autotune_force": False})
    autotune.clear()


@pytest.mark.parametrize("n", [0, 1, 2, 8, 33, 1000, 1024, 1025])
def test_bucketing_equals_jax(n):
    assert autotune.bucket(n) == jautotune.bucket(n)


def test_lookup_measures_once_and_round_trips_disk(tuning):
    calls = []

    def measure(params):
        calls.append(params)
        return 0.001 if params == (64, 64) else 0.5

    cands = [(128, 128), (64, 64)]
    got = autotune.lookup("test_kernel", (128, 128), torch.float32, cands,
                          measure, (128, 128))
    assert got == (64, 64)
    assert sorted(calls) == sorted(cands)
    calls.clear()
    assert autotune.lookup("test_kernel", (128, 128), torch.float32, cands,
                           measure, (128, 128)) == (64, 64)
    assert not calls
    data = json.loads(tuning.read_text())
    (key,) = data["entries"]
    # the key names the device: "cpu" here, the card's name on the card
    assert key == "test_kernel|128,128|float32|cpu"
    assert data["entries"][key]["candidates"] == [[[128, 128], 0.5],
                                                  [[64, 64], 0.001]]
    autotune.clear()
    assert autotune.lookup("test_kernel", (128, 128), torch.float32, cands,
                           measure, (128, 128)) == (64, 64)
    assert not calls
    assert ("test_kernel", (128, 128), "float32", "cpu") in \
        autotune.table_snapshot()


def test_a_table_of_another_device_is_not_read(tuning):
    tuning.write_text(json.dumps({"version": 1, "entries": {
        "k|64|bfloat16|NVIDIA H100 80GB HBM3": {"params": [256],
                                               "seconds": 1e-5}}}))
    autotune.clear()
    got = autotune.lookup("k", (64,), torch.bfloat16, [(256,), (64,)],
                          lambda p: 0.1 if p == (64,) else 0.2, (128,))
    assert got == (64,)               # measured here, not the H100's 256
    snap = autotune.table_snapshot()
    assert snap[("k", (64,), "bfloat16", "NVIDIA H100 80GB HBM3")] == (256,)
    assert snap[("k", (64,), "bfloat16", "cpu")] == (64,)


def test_a_candidate_that_raises_is_counted(tuning):
    monitor.reset("autotune.failed_candidate.k3")

    def measure(params):
        if params == (8,):
            raise RuntimeError("launch refused")
        return 0.1

    assert autotune.lookup("k3", (8,), torch.float32, [(8,), (16,)],
                           measure, (8,)) == (16,)
    assert monitor.stat_get("autotune.failed_candidate.k3") == 1
    assert monitor.stat_get("autotune.measured.k3") == 1
    monitor.reset("autotune.failed_candidate.k3")
    monitor.reset("autotune.measured.k3")


def test_corrupt_disk_cache_is_ignored(tuning):
    tuning.write_text("{not json")
    autotune.clear()
    got = autotune.lookup("k", (8,), torch.float32, [(8,)], lambda p: 0.1,
                          (8,))
    assert got == (8,)


def test_no_measure_off_the_card_without_force(tuning):
    flags.set_flags({"FLAGS_pallas_autotune_force": False})
    autotune.clear()
    calls = []
    got = autotune.lookup("k2", (64, 64), torch.float32,
                          [(64, 64), (32, 32)],
                          lambda p: calls.append(p) or 0.1, (64, 64))
    assert got == (64, 64) and not calls
    flags.set_flags({"FLAGS_pallas_autotune": False,
                     "FLAGS_pallas_autotune_force": True})
    try:
        got = autotune.lookup("k2", (64, 64), torch.float32,
                              [(64, 64), (32, 32)],
                              lambda p: calls.append(p) or 0.1, (64, 64))
        assert got == (64, 64) and not calls
    finally:
        flags.set_flags({"FLAGS_pallas_autotune": True})


def test_time_thunk_on_the_host_clock():
    t = autotune.time_thunk(lambda: torch.ones(4) * 2, repeats=2, inner=3)
    assert 0.0 < t < 1.0


@pytest.mark.parametrize("L,heads,hd,dtype,batch", [
    (48, 2, 32, "float32", 1), (64, 2, 32, "float32", 1),
    (96, 12, 64, "bfloat16", 64), (128, 4, 16, "float32", 8),
    (1000, 12, 64, "bfloat16", 64), (1024, 12, 64, "bfloat16", 64),
    (2048, 16, 128, "float16", 4), (8, 1, 8, "float32", 1)])
def test_pick_block_size_equals_jax_default_on_the_cpu(L, heads, hd, dtype,
                                                       batch):
    autotune.clear()
    assert kv_pool.pick_block_size(L, heads, hd, dtype, batch) == \
        jkv_pool.pick_block_size(L, heads, hd, dtype, batch)


def test_pick_block_size_flag_override_wins(tuning):
    flags.set_flags({"FLAGS_serve_block_size": 24})
    try:
        assert kv_pool.pick_block_size(1024, 12, 64) == 24
        flags.set_flags({"FLAGS_serve_block_size": 20})
        with pytest.raises(ValueError, match="multiple of 8"):
            kv_pool.pick_block_size(1024, 12, 64)
    finally:
        flags.set_flags({"FLAGS_serve_block_size": 0})


def test_pick_block_size_measures_the_paged_kernel_when_forced(tuning):
    """Forced on the CPU the measure runs the paged kernel's plain
    version at each candidate; the winner is one of them and is kept
    under the shape family's key."""
    got = kv_pool.pick_block_size(256, 2, 8, torch.float32, 2)
    assert got in (256, 128, 64)
    assert autotune.table_snapshot() == {
        ("paged_decode_attention", (256, 8), "float32", "cpu"): (got,)}
    entry = json.loads(tuning.read_text())["entries"][
        "paged_decode_attention|256,8|float32|cpu"]
    assert [c[0] for c in entry["candidates"]] == [[256], [128], [64]]


def test_serve_config_resolves_with_the_models_heads(monkeypatch):
    seen = []

    def spy(*a, **k):
        seen.append((a, k))
        return 16

    monkeypatch.setattr(kv_pool, "pick_block_size", spy)
    import paddle_tpu_torch.inference.serving as serving
    monkeypatch.setattr(serving, "pick_block_size", spy)
    net = GPT(GPTConfig.tiny(), device="cpu")
    loop = ServeLoop(net, ServeConfig(max_active=3, kv_blocks=8,
                                      max_seq_len=64))
    assert loop.stats()["block_size"] == 16
    (args, kw), = seen
    assert args == (64, 2, 32, torch.float32, 3)
    assert kw == {"device": net.device}
