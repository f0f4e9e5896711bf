"""Random state (paddle_tpu/core/rng.py) and token sampling.

``seed(n)`` (``paddle.seed``) seeds the port's ``Generator``: one
``torch.Generator`` per device, made at first use from the seed, and
reseeded by every later ``seed`` call. The creation ops' random draws and
the initializers draw from it, never from torch's global generator.
Dropout is the exception: torch's fused dropout kernel takes no generator,
so it draws from the device's default generator, which ``seed`` seeds as
well (``torch.manual_seed``).

Token sampling is keyed by (request seed, absolute token position).

The JAX package draws each token from ``fold_in(PRNGKey(seed),
position)`` (paddle_tpu/inference/serving.py ``_sampler``). torch cannot
reproduce those bits, so the port keeps the property instead: each row's
draw comes from its own ``torch.Generator`` seeded from (seed, position).
A stream's tokens then do not depend on which batch it rides in, and a
replay after preemption draws the same numbers. ``generate`` and the
serve loop share this sampler, so both give the same stream for the same
seed on one device.
"""
from __future__ import annotations

import torch

__all__ = ["Generator", "default_generator", "seed", "generator",
           "position_seed", "sample_tokens"]


class Generator:
    """The port's random state: a seed and, per device, the
    ``torch.Generator`` drawn from, made from the seed at first use."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens = {}

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self._seed)
        return self

    def get(self, device="cpu") -> torch.Generator:
        """The generator of ``device`` (a torch.device or its name)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        g = self._gens.get(dev)
        if g is None:
            g = self._gens[dev] = torch.Generator(device=dev)
            g.manual_seed(self._seed)
        return g


_default = Generator(0)


def default_generator() -> Generator:
    return _default


def seed(value: int) -> Generator:
    """paddle.seed: the port's generators on every device, and torch's
    default ones (which dropout draws from), restart from ``value``."""
    torch.manual_seed(int(value))
    return _default.manual_seed(value)


def generator(device="cpu") -> torch.Generator:
    """The default Generator's torch.Generator for ``device``."""
    return _default.get(device)

_MASK64 = (1 << 64) - 1


def position_seed(seed: int, position: int) -> int:
    """splitmix64 of (seed, position): a well-mixed generator seed, so
    neighbouring positions and seeds get unrelated streams."""
    z = ((int(seed) << 32) ^ int(position)) & _MASK64
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def sample_tokens(logits, temperature, top_k, seeds, positions):
    """Next token per row of ``logits`` [b, V] -> int64 [b].

    Greedy at temperature 0 (first index of the max, as jnp.argmax).
    Otherwise a Gumbel-max draw over ``logits / temperature`` (top-k
    filtered to -1e9 like the JAX sampler), with row i's noise drawn from
    a generator seeded by ``position_seed(seeds[i], positions[i])``.
    ``seeds`` and ``positions`` are host ints, so sampling never waits on
    the device."""
    if temperature == 0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / float(temperature)
    if top_k is not None:
        kth = torch.topk(lg, int(top_k), dim=-1).values[:, -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e9), lg)
    b, v = lg.shape
    noise = torch.empty_like(lg)
    for i in range(b):
        g = torch.Generator(device=lg.device)
        g.manual_seed(position_seed(seeds[i], positions[i]))
        u = torch.rand(v, generator=g, device=lg.device)
        noise[i] = -torch.log(-torch.log(u))
    return torch.argmax(lg + noise, dim=-1)
