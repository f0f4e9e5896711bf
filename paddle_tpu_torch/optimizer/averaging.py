"""Weight averaging (paddle_tpu/optimizer/averaging.py):
``ExponentialMovingAverage``, ``ModelAverage`` and ``LookAhead``.

Reference analogs: fluid/optimizer.py ExponentialMovingAverage (:4316),
ModelAverage (:4790), LookaheadOptimizer (:5700). Each is a small state
machine over a layer's parameters: ``update()`` after each optimizer
step, ``apply()`` / ``restore()`` (or ``average_weights()``) to evaluate
with the averaged weights.

The port's parameters are updated in place, so every value kept here
(shadows, sums, backups, slow weights) is a copy; a restore writes the
saved bits back. Under AMP O2 a bf16 / f16 parameter has an f32 master in
its optimizer's slots: as in the JAX package, ``LookAhead`` blends the
parameter and leaves the master alone, so the next inner step re-derives
the parameter from the un-blended master (a reference quirk, held by
``tests/test_torch_averaging.py``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["ExponentialMovingAverage", "ModelAverage", "LookAhead"]


def _named_params(obj):
    """Accept a Layer or an iterable of parameters."""
    if hasattr(obj, "named_parameters"):
        return list(obj.named_parameters())
    return [(getattr(p, "name", None) or f"param_{i}", p)
            for i, p in enumerate(obj)]


def _value(p):
    return p.detach().as_subclass(torch.Tensor)


@torch.no_grad()
def _write(p, v):
    p.copy_(v)


class ExponentialMovingAverage:
    """shadow = decay * shadow + (1 - decay) * param, applied with the
    reference's bias correction shadow / (1 - decay^t); the shadow starts
    at zero, as the correction assumes."""

    def __init__(self, network, decay=0.999):
        self._params = _named_params(network)
        self.decay = float(decay)
        self._t = 0
        self._shadow = {n: torch.zeros_like(_value(p))
                        for n, p in self._params}
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._t += 1
        d = self.decay
        for n, p in self._params:
            self._shadow[n] = d * self._shadow[n] + (1.0 - d) * _value(p)

    def apply(self):
        """Swap the bias-corrected EMA weights in (restore() after)."""
        if self._backup is not None:
            raise RuntimeError("EMA already applied; call restore() first")
        corr = 1.0 - self.decay ** max(self._t, 1)
        self._backup = {n: _value(p).clone() for n, p in self._params}
        for n, p in self._params:
            _write(p, self._shadow[n] / corr)
        return self

    def restore(self):
        if self._backup is None:
            return self
        for n, p in self._params:
            _write(p, self._backup[n])
        self._backup = None
        return self

    @contextlib.contextmanager
    def average_weights(self):
        self.apply()
        try:
            yield
        finally:
            self.restore()

    def state_dict(self):
        return {"shadow": {n: v.cpu().numpy()
                           for n, v in self._shadow.items()},
                "t": self._t, "decay": self.decay}

    def set_state_dict(self, state):
        dev = {n: _value(p).device for n, p in self._params}
        self._shadow = {n: torch.as_tensor(np.asarray(v), device=dev.get(n))
                        for n, v in state["shadow"].items()}
        self._t = int(state["t"])
        self.decay = float(state["decay"])
        return self


class ModelAverage:
    """Running average of the parameters over an update window (the
    reference's ModelAverage: the sum restarts from the current average
    once the window exceeds ``max_average_window``)."""

    def __init__(self, network, average_window_rate=0.15,
                 min_average_window=10000, max_average_window=10000):
        self._params = _named_params(network)
        self.rate = float(average_window_rate)
        self.min_window = int(min_average_window)
        self.max_window = int(max_average_window)
        self._sum = {n: torch.zeros_like(_value(p)) for n, p in self._params}
        self._n = 0
        self._updates = 0
        self._backup = None

    @torch.no_grad()
    def update(self):
        self._updates += 1
        window = max(self.min_window,
                     min(self.max_window,
                         int(self._updates * self.rate) or 1))
        if self._n >= window:
            # restart the accumulator, seeded with the current average
            for n, _ in self._params:
                self._sum[n] = self._sum[n] / self._n
            self._n = 1
        for n, p in self._params:
            self._sum[n] = self._sum[n] + _value(p)
        self._n += 1

    def apply(self):
        if self._backup is not None:
            raise RuntimeError("ModelAverage already applied")
        self._backup = {n: _value(p).clone() for n, p in self._params}
        for n, p in self._params:
            _write(p, self._sum[n] / max(self._n, 1))
        return self

    def restore(self):
        if self._backup is None:
            return self
        for n, p in self._params:
            _write(p, self._backup[n])
        self._backup = None
        return self

    @contextlib.contextmanager
    def average_weights(self):
        self.apply()
        try:
            yield
        finally:
            self.restore()


class LookAhead:
    """Lookahead (Zhang et al. 2019): the inner optimizer takes k fast
    steps, then the slow weights move ``alpha`` of the way toward the fast
    weights and the fast weights are set to them. Wraps any port
    optimizer; its other attributes pass through."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._steps = 0
        self._slow = None
        named = getattr(inner_optimizer, "_named", None) or []
        self._params = [p for _, p in named]

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _ensure_slow(self):
        if self._slow is None:
            self._slow = [_value(p).clone() for p in self._params]

    def step(self):
        self._ensure_slow()
        self.inner.step()
        self._steps += 1
        if self._steps % self.k == 0:
            with torch.no_grad():
                for i, p in enumerate(self._params):
                    # in f32, rounded once to the parameter's dtype, as
                    # XLA's fused elementwise chain rounds a bf16 blend
                    s32 = self._slow[i].float()
                    slow = (s32 + self.alpha * (_value(p).float() - s32)) \
                        .to(self._slow[i].dtype)
                    self._slow[i] = slow
                    _write(p, slow)

    def clear_grad(self, *a, **k):
        return self.inner.clear_grad(*a, **k)
