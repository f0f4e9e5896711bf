"""Loss layers (paddle_tpu/nn/layer/loss.py): CrossEntropyLoss, the
criterion behind ``BertPretrainingCriterion``."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    """Softmax cross-entropy (``functional.cross_entropy``); "mean"
    averages over the rows whose label is not ``ignore_index``."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.kw = dict(ignore_index=ignore_index, reduction=reduction,
                       soft_label=soft_label, axis=axis,
                       use_softmax=use_softmax,
                       label_smoothing=label_smoothing)

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, weight=self.weight, **self.kw)
