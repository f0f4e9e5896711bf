"""Port parity: metrics (paddle_tpu_torch/metric) against paddle_tpu.metric.

Both packages compute in numpy on the host, top-k by ``np.argsort``, so
on the same arrays the results must be equal (no tolerance): per-batch
values from ``update``, the accumulated values, and the functional
``accuracy``. The port takes torch tensors (bf16 too) as well as arrays.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import metric as jmetric
from paddle_tpu_torch import metric as tmetric


def _batches(seed=0, n_batches=3, b=16, classes=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        pred = rng.rand(b, classes).astype(np.float32)
        pred[0, :2] = 0.5               # a tie: argsort breaks it
        label = rng.randint(0, classes, (b, 1)).astype(np.int64)
        out.append((pred, label))
    return out


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_accuracy_matches_jax(topk, as_tensor):
    jm, tm = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
    assert tm.name() == jm.name()
    for pred, label in _batches():
        tp, tl = (torch.from_numpy(pred), torch.from_numpy(label)) \
            if as_tensor else (pred, label)
        want = jm.update(jm.compute(pred, label))
        got = tm.update(tm.compute(tp, tl))
        assert got == want
    assert tm.accumulate() == jm.accumulate()
    tm.reset()
    assert np.all(tm.count == 0)


def test_accuracy_takes_bf16_predictions():
    pred, label = _batches(1)[0]
    pred = np.round(pred * 8) / 8       # values bf16 holds exactly
    tm = tmetric.Accuracy(topk=(1, 2))
    got = tm.update(tm.compute(torch.from_numpy(pred).to(torch.bfloat16),
                               torch.from_numpy(label)))
    jm = jmetric.Accuracy(topk=(1, 2))
    assert got == jm.update(jm.compute(pred, label))


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_jax(cls):
    rng = np.random.RandomState(3)
    jm, tm = getattr(jmetric, cls)(), getattr(tmetric, cls)()
    for i in range(4):
        if cls == "Auc" and i % 2:
            preds = rng.rand(32, 2).astype(np.float32)   # two-column form
        else:
            preds = rng.rand(32, 1).astype(np.float32)
        labels = rng.randint(0, 2, (32, 1)).astype(np.int64)
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
        assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name()


def test_empty_binary_metrics_are_zero_as_jax():
    for cls in ("Precision", "Recall", "Auc"):
        assert getattr(tmetric, cls)().accumulate() == \
            getattr(jmetric, cls)().accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 2])
def test_functional_accuracy_matches_jax(k):
    pred, label = _batches(2)[0]
    want = float(np.asarray(jmetric.accuracy(pred, label, k=k).numpy()))
    got = tmetric.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                           k=k)
    assert got.dtype == torch.float32 and float(got) == want
