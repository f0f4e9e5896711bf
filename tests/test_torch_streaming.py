"""Port parity: the streaming dataset (paddle_tpu_torch/dataset/
streaming.py), ``dataset``'s reader creators and ``traffic.Window``
against the JAX package's.

tests/test_online_learning.py's StreamingDataset bodies run on both
packages (each with its own fault injector), the delivered sequence under
a seeded pattern of re-offers and a checkpoint cut equals JAX's record for
record, a tiny ServeLoop feeds a stream through ``on_complete``, and
``Window`` hands the stream to ``train_from_dataset`` in rounds whose
losses equal JAX's (f32, rtol 1e-5)."""
import threading
import time
import types

import numpy as np
import pytest

import paddle_tpu.dataset as jdataset
import paddle_tpu.testing.faults as jfaults
import paddle_tpu.traffic.harness as jharness
import paddle_tpu_torch.dataset as tdataset
import paddle_tpu_torch.testing.faults as tfaults
import paddle_tpu_torch.traffic.harness as tharness
from paddle_tpu_torch.device import device_scope

from test_torch_static_cases import PKGS, static_mode, to_np

NS = {"jax": types.SimpleNamespace(ds=jdataset, faults=jfaults,
                                   harness=jharness),
      "port": types.SimpleNamespace(ds=tdataset, faults=tfaults,
                                    harness=tharness)}


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


@pytest.fixture(params=list(NS))
def S(request):
    return NS[request.param]


def _rec(rid):
    return {"rid": rid, "prompt": [rid], "tokens": [rid + 1]}


def test_streaming_dedupe_and_checkpoint_cut(S):
    ds = S.ds.StreamingDataset(batch_size=4, name="s-cut")
    for rid in range(10):
        assert ds.offer(_rec(rid))
        assert not ds.offer(_rec(rid))
    st = ds.stats()
    assert (st["accepted"], st["duplicates"], st["watermark"]) == (10, 10, 9)
    gen = ds.batches()
    got = [r["rid"] for r in next(gen)] + [r["rid"] for r in next(gen)]
    assert got == list(range(8))
    snap = ds.state_dict()
    ds2 = S.ds.StreamingDataset(batch_size=4, name="s-cut2")
    ds2.load_state_dict(snap)
    with pytest.raises(ValueError):
        next(ds2.batches(start_batch=0))
    assert not ds2.offer(_rec(3))
    ds2.close()
    tail = [[r["rid"] for r in b] for b in ds2.batches(start_batch=2)]
    assert tail == [[8, 9]]
    assert ds2.stats()["delivered_records"] == 10


def test_streaming_backpressure_bounds_the_queue(S):
    ds = S.ds.StreamingDataset(batch_size=1, capacity=2, name="s-cap")
    assert ds.offer(_rec(0)) and ds.offer(_rec(1))
    t0 = time.perf_counter()
    assert not ds.offer(_rec(2), timeout=0.05)
    assert time.perf_counter() - t0 >= 0.04
    assert ds.stats()["rejected_full"] == 1
    next(ds.batches())
    assert ds.offer(_rec(2), timeout=0.05)


def test_backlog_burst_and_reset_at_the_deliver_gate(S):
    f = S.faults
    ds = S.ds.StreamingDataset(batch_size=1, name="s-burst")
    for rid in range(6):
        ds.offer(_rec(rid))
    ds.close()
    with f.inject(f.backlog_burst(name="s-burst", after=1, times=2,
                                  delay=0.15)) as inj:
        t0 = time.perf_counter()
        got = [b[0]["rid"] for b in ds.batches()]
        burst_s = time.perf_counter() - t0
    assert got == list(range(6))
    assert inj.fired(f.STALL) == 2 and burst_s >= 0.3
    ds2 = S.ds.StreamingDataset(batch_size=2, name="s-reset")
    for rid in range(4):
        ds2.offer(_rec(rid))
    ds2.close()
    with f.inject(f.Fault("stream", "deliver", f.RESET, method="s-reset",
                          times=3)):
        got = [[r["rid"] for r in b] for b in ds2.batches()]
    assert got == [[0, 1], [2, 3]]
    assert ds2.stats()["delivery_faults"] == 3


def _delivered_under_reoffers(S, seed=11):
    """A seeded at-least-once transport: 40 records, each offered 1-3
    times in a shuffled order, a cut after two batches, the rest
    re-offered to the restored instance. The delivered rid sequence."""
    rng = np.random.RandomState(seed)
    offers = [r for r in range(40) for _ in range(rng.randint(1, 4))]
    offers = [offers[i] for i in rng.permutation(len(offers))]
    ds = S.ds.StreamingDataset(batch_size=5, dedupe_window=64, name="re")
    half = len(offers) // 2
    for rid in offers[:half]:
        ds.offer(_rec(rid))
    gen = ds.batches()
    out = [[r["rid"] for r in next(gen)] for _ in range(2)]
    snap = ds.state_dict()
    ds2 = S.ds.StreamingDataset(batch_size=5, dedupe_window=64, name="re2")
    ds2.load_state_dict(snap)
    for rid in offers:                     # the transport replays it all
        ds2.offer(_rec(rid))
    ds2.close()
    out += [[r["rid"] for r in b] for b in ds2.batches(start_batch=2)]
    return out, ds2.stats()


def test_delivered_sequence_under_reoffers_equals_jax():
    got = {k: _delivered_under_reoffers(v) for k, v in NS.items()}
    assert got["port"] == got["jax"]
    flat = [r for b in got["port"][0] for r in b]
    assert sorted(flat) == list(range(40))   # each record exactly once


def test_serve_loop_feeds_the_stream_once():
    """A tiny ServeLoop retires into ``ds.offer``; re-offering every
    record again delivers nothing twice."""
    ds = tdataset.StreamingDataset(batch_size=4, name="serve-feed")
    _, loop = tharness.build_tiny_loop(on_complete=ds.offer, device="cpu")
    loop.start()
    try:
        rng = np.random.RandomState(0)
        handles = [loop.submit(rng.randint(1, 60, (5,)).tolist(),
                               max_new_tokens=4) for _ in range(8)]
        for h in handles:
            h.result(timeout=120)
    finally:
        loop.stop()
    st = ds.stats()
    assert st["accepted"] == 8
    snap = ds.state_dict()
    for rec in snap["buffered"]:
        assert not ds.offer(rec)
    ds.close()
    recs = [r for b in ds.batches() for r in b]
    assert sorted(r["rid"] for r in recs) == sorted({r["rid"]
                                                     for r in recs})
    assert len(recs) == 8 and all(len(r["tokens"]) == 4 for r in recs)


def _collate(recs):
    x = np.asarray([[float(r["rid"] % 7), float(len(r["tokens"])),
                     float(r["rid"] % 3), 1.0] for r in recs], "float32")
    y = np.asarray([[float(r["rid"] % 5)] for r in recs], "float32")
    return {"x": x, "y": y}


def _stream_program(P):
    with static_mode(P) as static:
        P.paddle.seed(0)
        prog = static.Program("stream")
        with static.program_guard(prog, static.Program()):
            x = static.data("x", [4, 4], "float32")
            y = static.data("y", [4, 1], "float32")
            lin = P.nn.Linear(4, 1)
            loss = P.ops.mse_loss(lin(x), y)
            P.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return prog, lin, loss


def test_window_rounds_train_as_jax(capsys):
    """Three rounds of 2 batches from one stream through Window, each a
    train_from_dataset session; the printed losses (print_period 1) and
    the final weight equal JAX's."""
    out = {}
    for name, S in NS.items():
        P = PKGS[name]
        prog, lin, loss = _stream_program(P)
        if name == "port":     # JAX's initial weights
            from paddle_tpu_torch.bridge import load_jax_static_params
            load_jax_static_params(lin, jw)
        else:
            from test_torch_static_cases import jax_static_params
            jw, _ = jax_static_params(lin)
        ds = S.ds.StreamingDataset(batch_size=4, collate=_collate,
                                   name=f"w-{name}")
        for rid in range(24):
            ds.offer(_rec(rid))
        window = S.harness.Window(ds)
        exe = P.static.Executor()
        capsys.readouterr()
        for _ in range(3):
            exe.train_from_dataset(prog, window.take(2), fetch_list=[loss],
                                   print_period=1)
        printed = capsys.readouterr().out.split()
        w = to_np(P.static.global_scope().get(lin.weight.scope_name))
        out[name] = ([float(t.split("=")[1].rstrip(","))
                      for t in printed if "=" in t], w,
                     ds.stats()["delivered_batches"])
    assert out["port"][2] == out["jax"][2] == 6
    assert len(out["port"][0]) == 6
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=1e-5)


def test_reader_creators():
    train = tdataset.mnist.train()
    img, lab = next(train())
    assert img.shape == (784,) and img.dtype == np.float32
    assert -1.0 <= img.min() and img.max() <= 1.0 and 0 <= lab < 10
    jimg, jlab = next(jdataset.mnist.train()())
    np.testing.assert_array_equal(img, jimg)
    assert lab == jlab
    for name in ("uci_housing", "imdb", "imikolov", "movielens"):
        with pytest.raises(NotImplementedError, match="item 9"):
            getattr(tdataset, name).train()


def test_concurrent_producers_deliver_each_once():
    ds = tdataset.StreamingDataset(batch_size=8, name="mt")

    def produce(k):
        for rid in range(100):
            ds.offer(_rec(rid if k % 2 else 99 - rid))

    ts = [threading.Thread(target=produce, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    ds.close()
    rids = [r["rid"] for b in ds.batches() for r in b]
    assert sorted(rids) == list(range(100))
    assert ds.stats()["duplicates"] == 300
