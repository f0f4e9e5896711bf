"""Gradient clipping (paddle_tpu/optimizer/clip.py).

Each clip works on a ``{name: grad}`` dict (``apply``, what the
optimizer's update calls) and on ``[(param, grad)]`` pairs
(``__call__``). The arithmetic mirrors the JAX package's:

- ``ClipGradByValue``: every element into [min, max], in the grad's dtype;
- ``ClipGradByNorm``: per tensor, the norm in the grad's dtype and the
  scale ``clip_norm / max(norm, 1e-12)`` where the norm exceeds
  ``clip_norm``;
- ``ClipGradByGlobalNorm``: one norm over every grad, from f32 squares;
  the scale is applied in f32 and each grad rounded back to its dtype.

The per-tensor work runs as ``torch._foreach_*`` ops over all grads at
once, and the scales stay on the device (no host sync).
"""
from __future__ import annotations

import torch

from .optimizer import _cast

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


class ClipGradBase:
    def apply(self, grads_dict, params_meta=None):
        """grads_dict: {name: grad tensor} -> clipped dict."""
        raise NotImplementedError

    def __call__(self, params_grads):
        """paddle-style [(param, grad)] -> [(param, clipped grad)]."""
        names = [str(i) for i in range(len(params_grads))]
        out = self.apply({n: g for n, (_, g) in zip(names, params_grads)})
        return [(p, out[n]) for n, (p, _) in zip(names, params_grads)]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply(self, grads, params_meta=None):
        if not grads:
            return {}
        with torch.no_grad():
            out = torch._foreach_clamp_max(
                torch._foreach_clamp_min(list(grads.values()), self.min),
                self.max)
        return dict(zip(grads, out))


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply(self, grads, params_meta=None):
        if not grads:
            return {}
        gs = list(grads.values())
        with torch.no_grad():
            # sqrt(sum(g * g)) in the grad's dtype, as jnp on its dtype
            norms = [torch.sqrt(s) for s in
                     (torch.sum(sq) for sq in torch._foreach_mul(gs, gs))]
            scales = [torch.where(n > self.clip_norm,
                                  self.clip_norm / n.clamp_min(1e-12),
                                  torch.ones_like(n)) for n in norms]
            out = torch._foreach_mul(gs, scales)
        return dict(zip(grads, out))


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def apply(self, grads, params_meta=None):
        if not grads:
            return {}
        gs = list(grads.values())
        with torch.no_grad():
            g32 = _cast(gs, [torch.float32] * len(gs))
            norms = torch._foreach_norm(g32)
            global_norm = torch.linalg.vector_norm(torch.stack(norms))
            scale = torch.where(
                global_norm > self.clip_norm,
                self.clip_norm / global_norm.clamp_min(1e-12),
                torch.ones_like(global_norm))
            out = _cast(torch._foreach_mul(g32, scale),
                        [g.dtype for g in gs])
        return dict(zip(grads, out))
