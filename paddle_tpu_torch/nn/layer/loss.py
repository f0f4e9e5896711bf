"""Loss layers (paddle_tpu/nn/layer/loss.py), each over the functional op
of the same name; ``CTCLoss`` over ``ops.ctc_loss``, ``HSigmoidLoss``
(weight [num_classes - 1, feature]) over ``ops.hsigmoid_loss`` and
``NCELoss`` (weight [classes, dim]) over ``ops.nce``, whose negatives
are the caller's ``sample_ids`` or, without them, drawn from numpy's
global generator as the JAX layer draws them."""
from __future__ import annotations

from ... import ops
from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "HuberLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "TripletMarginLoss",
           "CosineEmbeddingLoss", "CTCLoss", "HSigmoidLoss", "NCELoss"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return ops.mean(loss)
    if reduction == "sum":
        return ops.sum(loss)
    return loss


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


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, weight=self.weight,
                          ignore_index=self.ignore_index,
                          reduction=self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, weight=self.weight,
                                      reduction=self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, weight=self.weight, reduction=self.reduction,
            pos_weight=self.pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class HuberLoss(Layer):
    """The elementwise ``huber_loss`` op, then the reduction."""

    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return _reduce(F.huber_loss(input, label, self.delta),
                       self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__()
        self.kw = dict(margin=margin, p=p, epsilon=epsilon,
                       reduction=reduction)

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, **self.kw)


class CosineEmbeddingLoss(Layer):
    """1 - cos(x1, x2) where the label is 1, else max(cos - margin, 0)
    (cosine over axis 1)."""

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        sim = F.cosine_similarity(input1, input2, axis=1)
        pos = 1.0 - sim
        neg = ops.clip(sim - self.margin, min=0.0)
        return _reduce(ops.where(label == 1, pos, neg), self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return ops.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                            blank=self.blank, reduction=self.reduction,
                            norm_by_times=norm_by_times)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        from .. import initializer as I
        self.num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes - 1], attr=bias_attr, is_bias=True)

    def forward(self, input, label):  # noqa: A002
        return ops.hsigmoid_loss(input, label, self.weight, self.bias,
                                 num_classes=self.num_classes)


class NCELoss(Layer):
    def __init__(self, num_total_classes, dim, num_neg_samples=5,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        from .. import initializer as I
        self.num_total_classes = num_total_classes
        self.num_neg_samples = num_neg_samples
        self.weight = self.create_parameter(
            [num_total_classes, dim], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_total_classes], attr=bias_attr, is_bias=True)

    def forward(self, input, label, sample_ids=None):  # noqa: A002
        import numpy as np

        from ...core.tensor import to_tensor
        if sample_ids is None:
            sample_ids = to_tensor(np.random.randint(
                0, self.num_total_classes,
                self.num_neg_samples).astype("int64"))
        return ops.nce(input, label, self.weight, self.bias,
                       sample_ids=sample_ids,
                       num_neg_samples=self.num_neg_samples,
                       num_total_classes=self.num_total_classes)
