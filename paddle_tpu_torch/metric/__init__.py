"""Metrics (paddle_tpu/metric): ``Metric``, ``Accuracy``, ``Precision``,
``Recall``, ``Auc`` and ``accuracy``, in numpy on the host as in the JAX
package (top-k by ``np.argsort``, so ties break the same way in both).
Tensors are read to the host first.

``ChunkEvaluator`` (IOB chunk counts, ``ops.chunk_eval``), ``EditDistance``
(the streaming mean of ``ops.edit_distance``) and ``DetectionMAP`` (VOC
AP, ``"11point"`` or ``"integral"``, over one image's detections a call)
are host accumulators, as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.io import to_numpy as _np

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "ChunkEvaluator", "EditDistance", "DetectionMAP"]


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


class ChunkEvaluator(Metric):
    """Chunk precision / recall / F1 for sequence labelling (reference
    fluid/metrics.py ChunkEvaluator over chunk_eval_op.cc, IOB)."""

    def __init__(self, num_chunk_types=1, chunk_scheme="IOB", name=None):
        self._name = name or "chunk"
        self.num_chunk_types = num_chunk_types
        self.chunk_scheme = chunk_scheme
        self.reset()

    def reset(self):
        self.num_infer = 0
        self.num_label = 0
        self.num_correct = 0

    def update(self, inferences, labels, seq_lengths=None):
        from ..ops import chunk_eval
        *_, ni, nl, nc = chunk_eval(
            inferences, labels, chunk_scheme=self.chunk_scheme,
            num_chunk_types=self.num_chunk_types, seq_lengths=seq_lengths)
        self.num_infer += ni
        self.num_label += nl
        self.num_correct += nc

    def accumulate(self):
        p = self.num_correct / self.num_infer if self.num_infer else 0.0
        r = self.num_correct / self.num_label if self.num_label else 0.0
        f1 = 2 * p * r / (p + r) if (p + r) else 0.0
        return p, r, f1

    def name(self):
        return self._name


class EditDistance(Metric):
    """Streaming mean edit distance (reference fluid/metrics.py
    EditDistance over edit_distance_op.cc)."""

    def __init__(self, normalized=True, name=None):
        self._name = name or "edit_distance"
        self.normalized = normalized
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0

    def update(self, hyps, refs):
        from ..ops import edit_distance
        d, n = edit_distance(hyps, refs, normalized=self.normalized)
        self.total += float(_np(d).sum())
        self.count += n

    def accumulate(self):
        return self.total / self.count if self.count else 0.0

    def name(self):
        return self._name


class DetectionMAP:
    """Mean average precision for detection (reference
    detection_map_op.cc and fluid/metrics.py DetectionMAP), on the host.

    update(detections, gt_boxes, gt_labels, difficult=None) takes ONE
    image: detections [M, 6] rows (label, score, x1, y1, x2, y2),
    gt_boxes [G, 4], gt_labels [G]."""

    def __init__(self, overlap_threshold=0.5, ap_version="integral",
                 evaluate_difficult=False, class_num=None):
        import collections
        self.overlap_threshold = float(overlap_threshold)
        self.ap_version = ap_version
        self.evaluate_difficult = evaluate_difficult
        self._dets = collections.defaultdict(list)  # cls -> [(score, img, box)]
        self._gts = collections.defaultdict(list)   # (img, cls) -> [(box, d)]
        self._npos = collections.defaultdict(int)
        self._img = 0

    def reset(self):
        self._dets.clear()
        self._gts.clear()
        self._npos.clear()
        self._img = 0

    def update(self, detections, gt_boxes, gt_labels, difficult=None):
        det = _np(detections).reshape(-1, 6)
        gb = _np(gt_boxes).reshape(-1, 4)
        gl = _np(gt_labels).reshape(-1).astype(int)
        dif = _np(difficult).reshape(-1).astype(bool) \
            if difficult is not None else np.zeros(len(gl), bool)
        img = self._img
        self._img += 1
        for box, lab, d in zip(gb, gl, dif):
            self._gts[(img, int(lab))].append((box, bool(d)))
            if self.evaluate_difficult or not d:
                self._npos[int(lab)] += 1
        for row in det:
            self._dets[int(row[0])].append((float(row[1]), img, row[2:6]))

    @staticmethod
    def _iou(a, b):
        x1 = np.maximum(a[0], b[:, 0])
        y1 = np.maximum(a[1], b[:, 1])
        x2 = np.minimum(a[2], b[:, 2])
        y2 = np.minimum(a[3], b[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        area_a = max((a[2] - a[0]) * (a[3] - a[1]), 0)
        area_b = np.maximum(b[:, 2] - b[:, 0], 0) \
            * np.maximum(b[:, 3] - b[:, 1], 0)
        return inter / np.maximum(area_a + area_b - inter, 1e-10)

    def _ap(self, rec, prec):
        if self.ap_version == "11point":
            return sum((prec[rec >= t].max() if (rec >= t).any() else 0.0)
                       / 11.0 for t in np.arange(0.0, 1.1, 0.1))
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def accumulate(self):
        aps = []
        for cls, dets in self._dets.items():
            npos = self._npos.get(cls, 0)
            if npos == 0:
                continue
            dets = sorted(dets, key=lambda t: -t[0])
            matched = set()
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, (_score, img, box) in enumerate(dets):
                entries = self._gts.get((img, cls), [])
                if not entries:
                    fp[i] = 1
                    continue
                ious = self._iou(box, np.stack([e[0] for e in entries]))
                j = int(ious.argmax())
                if ious[j] < self.overlap_threshold:
                    fp[i] = 1
                elif entries[j][1] and not self.evaluate_difficult:
                    continue               # a difficult box: neither
                elif (img, cls, j) not in matched:
                    matched.add((img, cls, j))
                    tp[i] = 1
                else:
                    fp[i] = 1
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            aps.append(self._ap(ctp / npos,
                                ctp / np.maximum(ctp + cfp, 1e-10)))
        return float(sum(aps) / len(aps)) if aps else 0.0
