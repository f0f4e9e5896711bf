"""Loss layers (paddle_tpu/nn/layer/loss.py): CrossEntropyLoss, the
criterion behind ``BertPretrainingCriterion``."""
from __future__ import annotations

import torch

from .. import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(torch.nn.Module):
    """Softmax cross-entropy over the last axis; "mean" averages over the
    rows whose label is not ``ignore_index``."""

    def __init__(self, ignore_index=-100, reduction="mean"):
        super().__init__()
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, ignore_index=self.ignore_index,
                               reduction=self.reduction)
