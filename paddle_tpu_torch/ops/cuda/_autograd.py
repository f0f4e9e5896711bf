"""``first_order_only``: the backward of a kernel's autograd Function.

A ``jax.custom_vjp`` over Pallas kernels differentiates once: forward
mode raises ``TypeError``, and differentiating its backward raises. The
kernels' Functions keep that contract on every device. Their backward runs
without recording a graph; under ``create_graph`` each gradient it returns
is an alias whose own backward raises. The alias hangs off the Function's
differentiable inputs (an empty slice's sum, an exact 0), so a second
differentiation with respect to them reaches it and raises, where torch's
``once_differentiable`` would hand back constants and the second-order
gradient would drop the kernel's term without a word. A Function without
``jvp`` already raises in forward mode.
"""
from __future__ import annotations

import functools

import torch
from torch._C import _functions

__all__ = ["first_order_only"]

_MESSAGE = (b"a hand-written kernel's backward is not differentiable: "
            b"second-order gradients through it are not supported")


def first_order_only(n_inputs):
    """Decorate a Function's ``backward`` whose first ``n_inputs`` saved
    tensors are its differentiable inputs."""
    def deco(backward):
        @functools.wraps(backward)
        def wrapper(ctx, *grads):
            with torch.no_grad():
                outs = backward(ctx, *grads)
            if not torch.is_grad_enabled():
                return outs
            zero = sum((t.reshape(-1)[:0].sum()
                        for t in ctx.saved_tensors[:n_inputs]
                        if t is not None and t.requires_grad),
                       torch.zeros(()))
            live = [i for i, t in enumerate(outs) if t is not None]
            err = _functions.DelayedError(_MESSAGE, len(live))
            aliased = err(*[outs[i].detach() + zero.to(outs[i])
                            for i in live])
            aliased = aliased if isinstance(aliased, tuple) else (aliased,)
            res = list(outs)
            for i, t in zip(live, aliased):
                res[i] = t
            return tuple(res)
        return wrapper
    return deco
