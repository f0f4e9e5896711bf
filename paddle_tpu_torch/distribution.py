"""Probability distributions (paddle_tpu/distribution.py): ``Normal``,
``Uniform``, ``Categorical``, ``Bernoulli``, ``Beta``, ``Dirichlet`` and
``kl_divergence``.

Reference python/paddle/distribution.py. Tensor in, Tensor out; the
parameters are f32. Draws come from the port's explicit generator of the
parameters' device (``core/rng.generator``, seeded by ``paddle.seed``),
never from torch's global one; they cannot reproduce the JAX package's
``jax.random`` bits, only its distributions. ``rsample`` is
reparameterised (Normal, Uniform; Beta and Dirichlet through torch's
gamma sampler), so its gradient reaches the parameters. The densities,
entropies and divergences are the JAX package's formulas.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .core import rng as _rng
from .core.tensor import Tensor

__all__ = ["Distribution", "Normal", "Uniform", "Categorical", "Bernoulli",
           "Beta", "Dirichlet", "kl_divergence"]


def _raw(x):
    if isinstance(x, torch.Tensor):
        return x.as_subclass(torch.Tensor)
    from .device import resolve_device
    return torch.as_tensor(np.asarray(x), device=resolve_device(None))


def _f32(x):
    return _raw(x).to(torch.float32)


def _wrap(v):
    return v.as_subclass(Tensor)


def _gen(t):
    return _rng.generator(t.device)


def _bshape(*ts):
    return tuple(torch.broadcast_shapes(*(t.shape for t in ts)))


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _gamma(alpha, shape):
    return torch._standard_gamma(alpha.expand(shape).contiguous(),
                                 generator=_gen(alpha))


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return _wrap(torch.exp(_raw(self.log_prob(value))))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


class Normal(Distribution):
    def __init__(self, loc, scale):
        self.loc = _f32(loc)
        self.scale = _f32(scale)

    @property
    def mean(self):
        return _wrap(self.loc)

    @property
    def variance(self):
        return _wrap(self.scale ** 2)

    def sample(self, shape=()):
        return self.rsample(shape)

    def rsample(self, shape=()):
        shp = tuple(shape) + _bshape(self.loc, self.scale)
        eps = torch.randn(shp, generator=_gen(self.loc),
                          device=self.loc.device)
        return _wrap(self.loc + self.scale * eps)

    def log_prob(self, value):
        v = _raw(value)
        var = self.scale ** 2
        return _wrap(-((v - self.loc) ** 2) / (2 * var)
                     - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def entropy(self):
        return _wrap(0.5 + 0.5 * math.log(2 * math.pi)
                     + torch.log(self.scale) + torch.zeros_like(self.loc))


class Uniform(Distribution):
    def __init__(self, low, high):
        self.low = _f32(low)
        self.high = _f32(high)

    def sample(self, shape=()):
        shp = tuple(shape) + _bshape(self.low, self.high)
        u = torch.rand(shp, generator=_gen(self.low), device=self.low.device)
        return _wrap(self.low + (self.high - self.low) * u)

    rsample = sample

    def log_prob(self, value):
        v = _raw(value)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return _wrap(torch.where(inside, lp, torch.full_like(lp, -math.inf)))

    def entropy(self):
        return _wrap(torch.log(self.high - self.low))


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None):
        if (logits is None) == (probs is None):
            raise ValueError("pass exactly one of logits/probs")
        if probs is not None:
            self.logits = torch.log(torch.clamp(_f32(probs), min=1e-30))
        else:
            self.logits = _f32(logits)
        self.logits = self.logits - torch.logsumexp(self.logits, -1,
                                                    keepdim=True)

    @property
    def probs(self):
        return _wrap(torch.exp(self.logits))

    def sample(self, shape=()):
        k = self.logits.shape[-1]
        batch = tuple(self.logits.shape[:-1])
        n = math.prod(shape)
        p = torch.exp(self.logits).reshape(-1, k)
        draws = torch.multinomial(p, n, replacement=True,
                                  generator=_gen(self.logits))  # [B, n]
        return _wrap(draws.T.reshape(*shape, *batch))

    def log_prob(self, value):
        v = _raw(value).long()
        lg = self.logits.expand(*v.shape, self.logits.shape[-1]) \
            if v.dim() >= self.logits.dim() - 1 else self.logits
        return _wrap(torch.gather(lg, -1, v[..., None])[..., 0])

    def entropy(self):
        p = torch.exp(self.logits)
        return _wrap(-torch.sum(p * self.logits, -1))


class Bernoulli(Distribution):
    def __init__(self, probs):
        self.probs_ = torch.clamp(_f32(probs), 1e-7, 1 - 1e-7)

    def sample(self, shape=()):
        shp = tuple(shape) + tuple(self.probs_.shape)
        return _wrap(torch.bernoulli(self.probs_.expand(shp),
                                     generator=_gen(self.probs_)))

    def log_prob(self, value):
        v = _raw(value)
        return _wrap(v * torch.log(self.probs_)
                     + (1 - v) * torch.log1p(-self.probs_))

    def entropy(self):
        p = self.probs_
        return _wrap(-(p * torch.log(p) + (1 - p) * torch.log1p(-p)))


class Beta(Distribution):
    def __init__(self, alpha, beta):
        self.alpha = _f32(alpha)
        self.beta = _f32(beta)

    def sample(self, shape=()):
        shp = tuple(shape) + _bshape(self.alpha, self.beta)
        x = _gamma(self.alpha, shp)
        y = _gamma(self.beta, shp)
        return _wrap(x / (x + y))

    rsample = sample

    def log_prob(self, value):
        v = _raw(value)
        return _wrap((self.alpha - 1) * torch.log(v)
                     + (self.beta - 1) * torch.log1p(-v)
                     - _betaln(self.alpha, self.beta))

    def entropy(self):
        a, b = self.alpha, self.beta
        return _wrap(_betaln(a, b) - (a - 1) * torch.digamma(a)
                     - (b - 1) * torch.digamma(b)
                     + (a + b - 2) * torch.digamma(a + b))


class Dirichlet(Distribution):
    def __init__(self, concentration):
        self.concentration = _f32(concentration)

    def sample(self, shape=()):
        shp = tuple(shape) + tuple(self.concentration.shape)
        g = _gamma(self.concentration, shp)
        return _wrap(g / g.sum(-1, keepdim=True))

    rsample = sample

    def log_prob(self, value):
        a = self.concentration
        v = _raw(value)
        norm = torch.lgamma(a).sum(-1) - torch.lgamma(a.sum(-1))
        return _wrap(((a - 1) * torch.log(v)).sum(-1) - norm)

    def entropy(self):
        a = self.concentration
        a0 = a.sum(-1)
        k = a.shape[-1]
        lnb = torch.lgamma(a).sum(-1) - torch.lgamma(a0)
        return _wrap(lnb + (a0 - k) * torch.digamma(a0)
                     - ((a - 1) * torch.digamma(a)).sum(-1))


def kl_divergence(p, q):
    """Closed-form KL for matching families (reference
    paddle.distribution.kl_divergence)."""
    if isinstance(p, Normal) and isinstance(q, Normal):
        vr = (p.scale / q.scale) ** 2
        return _wrap(0.5 * (vr + ((p.loc - q.loc) / q.scale) ** 2
                            - 1 - torch.log(vr)))
    if isinstance(p, Categorical) and isinstance(q, Categorical):
        pp = torch.exp(p.logits)
        return _wrap(torch.sum(pp * (p.logits - q.logits), -1))
    if isinstance(p, Bernoulli) and isinstance(q, Bernoulli):
        a, b = p.probs_, q.probs_
        return _wrap(a * (torch.log(a) - torch.log(b))
                     + (1 - a) * (torch.log1p(-a) - torch.log1p(-b)))
    if isinstance(p, Uniform) and isinstance(q, Uniform):
        return _wrap(torch.log((q.high - q.low) / (p.high - p.low)))
    if isinstance(p, Beta) and isinstance(q, Beta):
        a1, b1, a2, b2 = p.alpha, p.beta, q.alpha, q.beta
        return _wrap(_betaln(a2, b2) - _betaln(a1, b1)
                     + (a1 - a2) * torch.digamma(a1)
                     + (b1 - b2) * torch.digamma(b1)
                     + (a2 - a1 + b2 - b1) * torch.digamma(a1 + b1))
    if isinstance(p, Dirichlet) and isinstance(q, Dirichlet):
        a, b = p.concentration, q.concentration
        a0 = a.sum(-1, keepdim=True)
        t1 = torch.lgamma(a.sum(-1)) - torch.lgamma(b.sum(-1))
        t2 = (torch.lgamma(b) - torch.lgamma(a)).sum(-1)
        t3 = ((a - b) * (torch.digamma(a) - torch.digamma(a0))).sum(-1)
        return _wrap(t1 + t2 + t3)
    raise NotImplementedError(
        f"no closed-form KL for {type(p).__name__} vs {type(q).__name__}")
