"""Quantization (paddle_tpu/quantization): QAT by fake-quant with a
straight-through gradient, and PTQ calibration.

As in the JAX package, quantization is a layer transform: ``QAT`` /
``PTQ`` replace each ``Linear`` / ``Conv2D`` with ``QuantedLinear`` /
``QuantedConv2D``, which fake-quantize the weight (per output channel,
absmax) and the input activation (an observer's scale). ``fake_quant``
(the registry op) is quantize-dequantize with the straight-through
backward as a ``torch.autograd.Function``: the gradient passes where
``|x| <= scale`` and is 0 elsewhere, and the scale has none (it is
calibration data). ``AbsmaxObserver`` keeps a moving-average absmax in
its ``scale`` buffer; ``HistogramObserver`` keeps a host histogram of
|x| and takes the scale at a percentile. ``weight_quantize`` exports
int8 codes and per-channel scales.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..nn.layer.layers import Layer
from ..ops._dispatch import defop

__all__ = ["fake_quant", "QuantConfig", "QAT", "PTQ", "AbsmaxObserver",
           "HistogramObserver", "QuantedLinear", "QuantedConv2D",
           "weight_quantize"]


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bits):
        qmax = 2 ** (bits - 1) - 1
        s = torch.clamp(scale, min=1e-8)
        ctx.save_for_backward(x, s)
        q = torch.round(torch.clamp(x / s, -1.0, 1.0) * qmax)
        return q / qmax * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        inside = (torch.abs(x) <= s).to(g.dtype)
        return g * inside, torch.zeros_like(s), None


@defop
def fake_quant(x, scale, bits=8):
    """Quantize-dequantize with straight-through gradients (reference
    fake_quantize_dequantize ops, fake_quantize_op.cc)."""
    return _FakeQuant.apply(x, torch.as_tensor(scale, dtype=x.dtype,
                                               device=x.device), bits)


def _per_channel_scale(w, axis):
    red = tuple(i for i in range(w.ndim) if i != axis)
    return torch.amax(torch.abs(w.detach()), red, keepdim=True)


# -- observers --------------------------------------------------------------

class AbsmaxObserver(Layer):
    """Moving-average absmax activation observer (reference
    FakeQuantMovingAverageAbsMax): the first batch sets the scale."""

    def __init__(self, momentum=0.9, bits=8):
        super().__init__()
        self._momentum = momentum
        self.bits = bits
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        self._calibrating = True

    @torch.no_grad()
    def observe(self, x):
        cur = torch.amax(torch.abs(x.detach())).float()
        old = self.scale
        new = torch.where(old == 1.0, cur,
                          self._momentum * old + (1 - self._momentum) * cur)
        self.scale.copy_(new)

    def forward(self, x):
        if self.training or self._calibrating:
            self.observe(x)
        return fake_quant(x, self.scale, bits=self.bits)


class HistogramObserver(Layer):
    """Percentile calibration over an accumulated |x| histogram on the
    host (reference slim PTQ 'hist'): the range doubles by merging bin
    pairs when a batch exceeds it; the scale is the ``percentile``
    quantile of the magnitudes seen."""

    def __init__(self, bins=2048, percentile=0.9999, bits=8):
        super().__init__()
        self.bits = bits
        if int(bins) < 2 or int(bins) % 2:
            raise ValueError(
                f"bins must be even and >= 2 (got {bins}): the histogram "
                "range grows by pair-merging bins")
        self._bins = int(bins)
        self._percentile = float(percentile)
        self._hist = np.zeros(self._bins, np.float64)
        self._hi = None
        self.register_buffer("scale", torch.ones((), dtype=torch.float32))
        self._calibrating = True

    @torch.no_grad()
    def observe(self, x):
        a = np.abs(x.detach().float().cpu().numpy()).reshape(-1)
        amax = float(a.max()) if a.size else 0.0
        if amax == 0.0:
            return
        if self._hi is None:
            self._hi = amax
        while amax > self._hi:
            merged = self._hist.reshape(-1, 2).sum(1)
            self._hist = np.concatenate(
                [merged, np.zeros(self._bins - merged.size, np.float64)])
            self._hi *= 2.0
        h, _ = np.histogram(a, bins=self._bins, range=(0.0, self._hi))
        self._hist += h
        cdf = np.cumsum(self._hist) / self._hist.sum()
        idx = int(np.searchsorted(cdf, self._percentile))
        self.scale.fill_(float(np.float32((idx + 1) / self._bins
                                          * self._hi)))

    def forward(self, x):
        if self.training or self._calibrating:
            self.observe(x)
        return fake_quant(x, self.scale, bits=self.bits)


# -- quantized layers --------------------------------------------------------

def _make_observer(kind, bits):
    if kind == "histogram":
        return HistogramObserver(bits=bits)
    if kind == "absmax":
        return AbsmaxObserver(bits=bits)
    raise ValueError(
        f"unknown act_observer {kind!r}; use 'absmax' or 'histogram'")


class QuantedLinear(Layer):
    """Linear with fake-quant on the weight (per output channel, absmax)
    and the input activation (an observer)."""

    def __init__(self, inner, weight_bits=8, act_bits=8,
                 act_observer="absmax"):
        super().__init__()
        self.inner = inner
        self.weight_bits = weight_bits
        self.act_quanter = _make_observer(act_observer, act_bits)

    def forward(self, x):
        from ..nn import functional as F
        x = self.act_quanter(x)
        w = self.inner.weight
        wq = fake_quant(w, _per_channel_scale(w, 1), bits=self.weight_bits)
        return F.linear(x, wq, self.inner.bias)


class QuantedConv2D(Layer):
    def __init__(self, inner, weight_bits=8, act_bits=8,
                 act_observer="absmax"):
        super().__init__()
        self.inner = inner
        self.weight_bits = weight_bits
        self.act_quanter = _make_observer(act_observer, act_bits)

    def forward(self, x):
        from .. import ops
        x = self.act_quanter(x)
        inner = self.inner
        w = inner.weight
        wq = fake_quant(w, _per_channel_scale(w, 0), bits=self.weight_bits)
        return ops.conv2d(x, wq, inner.bias, stride=inner._stride,
                          padding=inner._padding, dilation=inner._dilation,
                          groups=inner._groups)


# -- user API ---------------------------------------------------------------

class QuantConfig:
    """Which layer types quantize, at what widths."""

    def __init__(self, activation=None, weight=None, weight_bits=8,
                 act_bits=8, act_observer="absmax"):
        from ..nn.layer.common import Linear
        from ..nn.layer.conv import Conv2D
        self.weight_bits = weight_bits
        self.act_bits = act_bits
        self.act_observer = act_observer
        self.layer_map = {Linear: QuantedLinear, Conv2D: QuantedConv2D}

    def add_layer_mapping(self, source_type, quanted_type):
        self.layer_map[source_type] = quanted_type


def _replace_layers(root, config):
    replaced = 0
    for name, child in list(root.named_children()):
        qcls = config.layer_map.get(type(child))
        if qcls is not None:
            setattr(root, name, qcls(child, weight_bits=config.weight_bits,
                                     act_bits=config.act_bits,
                                     act_observer=config.act_observer))
            replaced += 1
        else:
            replaced += _replace_layers(child, config)
    return replaced


def _observers(model):
    return [m for m in model.modules()
            if isinstance(m, (AbsmaxObserver, HistogramObserver))]


class QAT:
    """Quantization-aware training (reference ImperativeQuantAware)."""

    def __init__(self, config=None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        if not inplace:
            model = copy.deepcopy(model)
        if _replace_layers(model, self.config) == 0:
            raise ValueError("no quantizable layers found")
        return model

    def convert(self, model, inplace=True):
        """Freeze the observers (scales stop updating) for deployment."""
        for obs in _observers(model):
            obs._calibrating = False
        model.eval()
        return model


class PTQ(QAT):
    """Post-training quantization: wrap, run calibration batches in eval
    mode (the observers keep observing), then ``convert``."""

    def quantize(self, model, inplace=True):
        model = super().quantize(model, inplace)
        model.eval()
        for obs in _observers(model):
            obs._calibrating = True
        return model

    def calibrate(self, model, sample_data, max_batches=None):
        """Run ``sample_data`` (an iterable of inputs, each a tensor or
        array or a tuple of them) through the wrapped model."""
        from ..core.tensor import to_tensor
        model.eval()
        n = 0
        with torch.no_grad():
            for batch in sample_data:
                args = batch if isinstance(batch, (tuple, list)) else (batch,)
                model(*[a if isinstance(a, torch.Tensor) else to_tensor(
                    np.asarray(a)) for a in args])
                n += 1
                if max_batches is not None and n >= max_batches:
                    break
        if n == 0:
            raise ValueError("calibrate needs at least one sample batch")
        return model


def weight_quantize(model, bits=8):
    """int8 codes and per-channel scales of every quantized layer's weight
    (reference WeightQuantization): ``{layer path: {"int8", "scale",
    "bits"}}``."""
    out = {}
    qmax = 2 ** (bits - 1) - 1
    for name, sub in model.named_modules():
        if isinstance(sub, (QuantedLinear, QuantedConv2D)):
            w = sub.inner.weight.detach()
            scale = _per_channel_scale(w, 1 if isinstance(sub, QuantedLinear)
                                       else 0)
            q = torch.round(torch.clamp(w / torch.clamp(scale, min=1e-8),
                                        -1, 1) * qmax)
            out[name] = {"int8": q.to(torch.int8).cpu().numpy(),
                         "scale": scale.cpu().numpy(), "bits": bits}
    return out
