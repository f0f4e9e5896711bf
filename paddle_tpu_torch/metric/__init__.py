"""Metrics (paddle_tpu/metric): ``Metric``, ``Accuracy``, ``Precision``,
``Recall``, ``Auc`` and ``accuracy``, in numpy on the host as in the JAX
package (top-k by ``np.argsort``, so ties break the same way in both).
Tensors are read to the host first.

``ChunkEvaluator``, ``EditDistance`` and ``DetectionMAP`` need ops of
ROADMAP Queue 1 item 9 and wait for them."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.io import to_numpy as _np

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing run on (pred, label); default passthrough."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        correct = idx == label[..., None]
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        n = correct[..., 0].size
        for i, k in enumerate(self.topk):
            c = correct[..., :k].any(-1).sum()
            self.total[i] += c
            self.count[i] += n
            accs.append(float(c) / n)
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        out = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return out[0] if len(out) == 1 else out

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("int64").reshape(-1)
        labels = _np(labels).astype("int64").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("int64").reshape(-1)
        labels = _np(labels).astype("int64").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Histogram AUC, matching the reference's bucketed implementation
    (operators/metrics/auc_op.cc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            scores = preds[:, 1]
        else:
            scores = preds.reshape(-1)
        buckets = np.clip((scores * self.num_thresholds).astype("int64"), 0,
                          self.num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = cum_pos = 0.0
        tot_neg = cum_neg = 0.0
        area = 0.0
        for i in range(self.num_thresholds, -1, -1):
            pos = self._stat_pos[i]
            neg = self._stat_neg[i]
            area += neg * (cum_pos + pos / 2.0)
            cum_pos += pos
            cum_neg += neg
        tot_pos, tot_neg = cum_pos, cum_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1):  # noqa: A002
    """Functional batch accuracy (reference metric/metrics.py accuracy)."""
    pred = _np(input)
    lab = _np(label)
    idx = np.argsort(-pred, axis=-1)[..., :k]
    if lab.ndim == pred.ndim:
        lab = lab.squeeze(-1)
    correct = (idx == lab[..., None]).any(-1)
    return torch.tensor(correct.mean(), dtype=torch.float32)
