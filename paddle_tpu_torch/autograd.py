"""paddle.autograd (paddle_tpu/autograd.py): ``backward``, ``grad``, the
grad-mode scopes, and ``PyLayer``, a custom op with its own backward.

``PyLayer`` subclasses write static ``forward(ctx, *args)`` and
``backward(ctx, *grads)``; ``apply`` runs them as one
``torch.autograd.Function``. The ctx is Paddle's: ``save_for_backward``
and ``saved_tensor`` (``saved_tensors`` too). ``backward`` returns one
gradient per tensor input (None for an input that needs none).
"""
from __future__ import annotations

import torch

from .core.tape import (backward, enable_grad, grad,  # noqa: F401
                        is_grad_enabled, no_grad, set_grad_enabled)
from .ops._dispatch import wrap

__all__ = ["backward", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "PyLayer", "PyLayerContext"]


class PyLayerContext:
    """What forward leaves for backward."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *tensors):
        self._saved = tensors

    @property
    def saved_tensor(self):
        """The saved tensors (a property, as in the JAX package)."""
        return self._saved

    saved_tensors = saved_tensor


class _Function(torch.autograd.Function):
    """One PyLayer call: (cls, ctx, kwargs, *args)."""

    @staticmethod
    def forward(fctx, cls, pctx, kwargs, *args):
        fctx.cls, fctx.pctx, fctx.n_args = cls, pctx, len(args)
        fctx.tensor_pos = [i for i, a in enumerate(args)
                           if isinstance(a, torch.Tensor)]
        out = cls.forward(pctx, *args, **kwargs)
        fctx.multi = isinstance(out, (tuple, list))
        outs = tuple(out) if fctx.multi else (out,)
        # autograd needs a fresh tensor for an output that is an input
        outs = tuple(o.view_as(o) if any(o is a for a in args) else o
                     for o in outs)
        return outs if fctx.multi else outs[0]

    @staticmethod
    def backward(fctx, *grads):
        cls = fctx.cls
        res = cls.backward(fctx.pctx, *wrap(list(grads)))
        res = res if isinstance(res, (tuple, list)) else (res,)
        if len(res) != len(fctx.tensor_pos):
            raise RuntimeError(
                f"{cls.__name__}.backward returned {len(res)} grads for "
                f"{len(fctx.tensor_pos)} tensor inputs")
        full = [None] * fctx.n_args
        for pos, g in zip(fctx.tensor_pos, res):
            full[pos] = g
        return (None, None, None, *full)


class PyLayer:
    """Custom autograd op (reference python/paddle/autograd/py_layer.py)."""

    @classmethod
    def apply(cls, *args, **kwargs):
        return wrap(_Function.apply(cls, PyLayerContext(), kwargs, *args))

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError
