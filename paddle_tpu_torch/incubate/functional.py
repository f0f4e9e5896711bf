"""Higher-order autodiff over Tensor functions
(paddle_tpu/incubate/functional.py): ``as_raw_fn``, ``grad``,
``value_and_grad``, ``jacobian`` (rev / fwd), ``hessian``, ``vjp`` and
``jvp``.

The JAX package composes ``jax.grad`` / ``jacrev`` / ``jacfwd``. The
port builds on torch autograd, not on ``torch.func``: reverse mode is
``torch.autograd.grad``, forward mode ``torch.autograd.forward_ad``. A
transform called while another one evaluates its function records its
own graph (``create_graph``), so ``grad(grad(f))`` is a double backward
and ``hessian`` is the reverse Jacobian of ``grad``. The kernels' autograd
Functions keep their old-style ``forward(ctx, ...)`` form: first-order
``grad`` / ``vjp`` through a kernel runs its backward kernels, while
forward mode (no ``jvp``) and a second derivative
(``ops/cuda/_autograd.first_order_only``) raise, as a ``jax.custom_vjp``
over Pallas kernels does.

Outputs are the port's ``Tensor``; outside a transform they are
detached.
"""
from __future__ import annotations

import threading

import torch
from torch.autograd import forward_ad as _fwd

from ..core.tensor import Tensor

__all__ = ["as_raw_fn", "grad", "value_and_grad", "jacobian", "hessian",
           "vjp", "jvp"]

_tls = threading.local()


def _nested() -> bool:
    """Is a transform evaluating its function on this thread?"""
    return getattr(_tls, "depth", 0) > 0


class _Evaluating:
    def __enter__(self):
        _tls.depth = getattr(_tls, "depth", 0) + 1

    def __exit__(self, *exc):
        _tls.depth -= 1


def _raw(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, torch.Tensor) else t


def _port(t, keep_graph):
    if not isinstance(t, torch.Tensor):
        return t
    t = t if keep_graph else t.detach()
    return t.as_subclass(Tensor)


def _tree(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree(fn, v) for k, v in x.items()}
    return fn(x)


def as_raw_fn(fn):
    """Lift a Tensor -> Tensor function to plain torch tensors in and out
    (scalars pass through)."""
    def raw(*args):
        out = fn(*[a.as_subclass(Tensor) if isinstance(a, torch.Tensor)
                   else a for a in args])
        return _tree(_raw, out)
    return raw


def _as_tensor(a):
    if isinstance(a, torch.Tensor):
        return a
    from ..core.tensor import to_tensor
    return to_tensor(a)


def _argnums(argnums):
    return (argnums,) if isinstance(argnums, int) else tuple(argnums)


def _leaves(args, nums, nested):
    """The arguments with each differentiated one a tensor that records:
    under another transform the caller's own (its graph continues), else
    a fresh leaf."""
    args = list(args)
    for i in nums:
        a = _as_tensor(args[i])
        if not (nested and a.requires_grad):
            a = a.detach().requires_grad_(True)
        args[i] = a
    return args


def _grads(out, xs, nested, ct=None):
    gs = torch.autograd.grad(out, xs, ct, retain_graph=True,
                             create_graph=nested, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(gs, xs)]


def _value_and_grad(fn, argnums, args):
    nested = _nested()
    nums = _argnums(argnums)
    args = _leaves(args, nums, nested)
    with torch.enable_grad(), _Evaluating():
        out = as_raw_fn(fn)(*args)
    if not isinstance(out, torch.Tensor) or out.numel() != 1:
        raise TypeError("grad requires a function of one scalar output, "
                        f"got {getattr(out, 'shape', type(out))}")
    gs = [_port(g, nested) for g in _grads(out, [args[i] for i in nums],
                                           nested)]
    g = gs[0] if isinstance(argnums, int) else tuple(gs)
    return _port(out, nested), g


def grad(fn, argnums=0):
    """d(scalar fn)/d(args[argnums]). Composes: grad(grad(f)) is a double
    backward."""
    return lambda *args: _value_and_grad(fn, argnums, args)[1]


def value_and_grad(fn, argnums=0):
    return lambda *args: _value_and_grad(fn, argnums, args)


def _jac_rev(fn, argnums, args):
    nested = _nested()
    nums = _argnums(argnums)
    args = _leaves(args, nums, nested)
    with torch.enable_grad(), _Evaluating():
        out = as_raw_fn(fn)(*args)
    xs = [args[i] for i in nums]
    flat = out.reshape(-1)
    rows = [[] for _ in xs]
    for j in range(flat.numel()):
        for r, g in zip(rows, _grads(flat[j], xs, nested)):
            r.append(g)
    jacs = [torch.stack(r).reshape(*out.shape, *x.shape)
            for r, x in zip(rows, xs)]
    return [_port(j, nested) for j in jacs]


def _jac_fwd(fn, argnums, args):
    nums = _argnums(argnums)
    args = [_as_tensor(a) if i in nums else a for i, a in enumerate(args)]
    jacs = []
    for i in nums:
        x = args[i]
        cols = []
        for j in range(x.numel()):
            t = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
            t[j] = 1
            tangents = [torch.zeros_like(args[n]) for n in nums]
            tangents[nums.index(i)] = t.reshape(x.shape)
            _, tan = _jvp(fn, [args[n] for n in nums], tangents, nums, args)
            cols.append(tan)
        out_shape = cols[0].shape
        jac = torch.stack(cols, dim=-1).reshape(*out_shape, *x.shape)
        jacs.append(_port(jac, False))
    return jacs


def jacobian(fn, argnums=0, mode="rev"):
    """d fn / d args[argnums], shaped out.shape + arg.shape; ``mode`` "rev"
    (one backward an output element) or "fwd" (one forward-mode pass an
    input element)."""
    if mode not in ("rev", "fwd"):
        raise ValueError(f"mode must be 'rev' or 'fwd', got {mode!r}")

    def jac(*args):
        js = (_jac_rev if mode == "rev" else _jac_fwd)(fn, argnums, args)
        return js[0] if isinstance(argnums, int) else tuple(js)
    return jac


def hessian(fn, argnums=0):
    """The reverse Jacobian of ``grad(fn)``: in.shape + in.shape for a
    scalar fn."""
    if not isinstance(argnums, int):
        raise TypeError("hessian takes one argnum in the port")
    return jacobian(grad(fn, argnums), argnums, mode="rev")


def vjp(fn, *primals):
    """(fn(*primals), pullback): pullback(cotangent) -> a tuple of one
    cotangent a primal."""
    nested = _nested()
    args = _leaves(primals, range(len(primals)), nested)
    with torch.enable_grad(), _Evaluating():
        out = as_raw_fn(fn)(*args)

    def pullback(ct):
        ct = _raw(_as_tensor(ct)).to(out.dtype)
        return tuple(_port(g, nested) for g in _grads(out, args, nested, ct))
    return _port(out, nested), pullback


def _jvp(fn, primals, tangents, nums=None, args=None):
    nums = tuple(range(len(primals))) if nums is None else nums
    args = list(primals) if args is None else list(args)
    with _fwd.dual_level(), _Evaluating():
        for n, p, t in zip(nums, primals, tangents):
            args[n] = _fwd.make_dual(_raw(_as_tensor(p)),
                                     _raw(_as_tensor(t)).to(p.dtype))
        out = as_raw_fn(fn)(*args)
        primal, tangent = _fwd.unpack_dual(out)
    if tangent is None:
        tangent = torch.zeros_like(primal)
    return primal, tangent


def jvp(fn, primals, tangents):
    """(fn(*primals), the directional derivative along ``tangents``), by
    forward-mode AD."""
    primals = tuple(_as_tensor(p) for p in primals)
    out, tan = _jvp(fn, primals, tuple(tangents))
    return _port(out, False), _port(tan, False)
