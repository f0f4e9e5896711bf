"""The public autograd surface of paddle_tpu/core/tape.py on torch autograd.

The JAX package records each eager op through ``jax.vjp`` on its own tape;
the port leaves recording to torch autograd and keeps the tape's public
functions: the grad-mode scopes (``no_grad``, ``enable_grad``,
``set_grad_enabled``, ``is_grad_enabled``; each works as a context manager
and as a decorator), ``backward`` (accumulates into the leaves' ``.grad``)
and ``grad`` (returns gradients without touching ``.grad``).
"""
from __future__ import annotations

import functools

import torch

__all__ = ["no_grad", "enable_grad", "is_grad_enabled", "set_grad_enabled",
           "backward", "grad"]


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class _GradScope:
    """A grad mode usable as context manager and as decorator."""

    def __init__(self, mode: bool):
        self._mode = bool(mode)
        self._old = []

    def __call__(self, func=None):
        if func is None:
            return self

        @functools.wraps(func)
        def inner(*a, **k):
            with _GradScope(self._mode):
                return func(*a, **k)
        return inner

    def __enter__(self):
        self._old.append(torch.is_grad_enabled())
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._old.pop())
        return False


def no_grad(func=None):
    scope = _GradScope(False)
    return scope(func) if func is not None else scope


def enable_grad(func=None):
    scope = _GradScope(True)
    return scope(func) if func is not None else scope


class _SetGradEnabled:
    """The mode is set at construction; as a context manager the old mode
    comes back on exit, as a decorator only the call runs in the mode."""

    def __init__(self, mode):
        self._mode = bool(mode)
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, func):
        torch.set_grad_enabled(self._prev)
        return _GradScope(self._mode)(func)


def set_grad_enabled(mode: bool):
    """Set the grad mode now (paddle.set_grad_enabled); usable as a
    context manager or decorator too."""
    return _SetGradEnabled(mode)


def _as_torch(value, like):
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def backward(tensor, grad_tensor=None, retain_graph=False):
    """Tensor.backward(): accumulate d tensor / d leaf into each leaf's
    ``.grad``. ``grad_tensor`` defaults to ones of the tensor's shape."""
    if not tensor.requires_grad:
        raise RuntimeError("backward() on a tensor with stop_gradient=True")
    g = _as_torch(grad_tensor, tensor)
    if g is None:
        g = torch.ones_like(tensor)
    torch.Tensor.backward(tensor, g, retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False, no_grad_vars=None):
    """paddle.grad: gradients of ``outputs`` with respect to ``inputs``
    (lists or single tensors), ``.grad`` untouched. ``create_graph`` keeps
    the result differentiable; ``allow_unused`` returns None for an input
    the outputs do not reach (else it raises); ``no_grad_vars`` are
    tensors through which no gradient flows (their hooks return zeros for
    this call)."""
    from .tensor import Tensor
    single = not isinstance(inputs, (list, tuple))
    outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    inputs = [inputs] if single else list(inputs)
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    elif not isinstance(grad_outputs, (list, tuple)):
        grad_outputs = [grad_outputs]
    gos = [torch.ones_like(o) if go is None else _as_torch(go, o)
           for o, go in zip(outputs, grad_outputs)]
    retain = create_graph if retain_graph is None else bool(retain_graph)
    handles = []
    if no_grad_vars is not None:
        nvars = no_grad_vars if isinstance(no_grad_vars, (list, tuple)) \
            else [no_grad_vars]
        handles = [v.register_hook(torch.zeros_like) for v in nvars
                   if v.requires_grad]
    try:
        res = torch.autograd.grad(outputs, inputs, gos, retain_graph=retain,
                                  create_graph=bool(create_graph),
                                  allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    out = []
    for g in res:
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    "one of the inputs was not used in the graph (pass "
                    "allow_unused=True to get None)")
            out.append(None)
            continue
        if type(g) is torch.Tensor:
            g.__class__ = Tensor
        out.append(g)
    return out
