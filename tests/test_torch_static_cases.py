"""Shared helper of the port's static-graph parity tests
(``tests/test_torch_static*.py``, ``test_torch_control_flow.py``,
``test_torch_jit.py`` ...): ``PKGS`` holds one namespace per package
(``paddle``, ``nn``, ``ops``, ``optimizer``, ``static``, ``jit``) so a
test body written once runs on the JAX package and on the port, and the
helpers read scopes and copy a JAX program's weights into the port's by
module path (``bridge.load_jax_static_params``). This module holds no
test of its own."""
import contextlib
import types

import numpy as np

import paddle_tpu as jp
import paddle_tpu.jit as jjit
import paddle_tpu.static as jstatic
import paddle_tpu.static.passes  # noqa: F401  static.passes, both
import paddle_tpu.static.program  # noqa: F401
import paddle_tpu_torch as tp
import paddle_tpu_torch.jit as tjit
import paddle_tpu_torch.static as tstatic
import paddle_tpu_torch.static.passes  # noqa: F401
from paddle_tpu_torch.bridge import load_jax_static_params


def _ns(name, pkg, static, jit):
    return types.SimpleNamespace(name=name, paddle=pkg, nn=pkg.nn,
                                 ops=pkg.ops, optimizer=pkg.optimizer,
                                 static=static, jit=jit)


JAX = _ns("jax", jp, jstatic, jjit)
PORT = _ns("port", tp, tstatic, tjit)
PKGS = {"jax": JAX, "port": PORT}


def to_np(x):
    """numpy of a fetch, a tensor of either package or a scope value (a
    copy: the port's Executor updates scope tensors in place)."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):      # torch
        t = x.detach().cpu()
        return (t.float() if str(t.dtype) == "torch.bfloat16"
                else t).numpy().copy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def scope_np(P, var):
    """The scope value of a persistable Variable as numpy."""
    return to_np(P.static.global_scope().get(var.scope_name))


@contextlib.contextmanager
def static_mode(P):
    P.paddle.enable_static()
    try:
        yield P.static
    finally:
        P.paddle.disable_static()


def jax_static_params(jnet):
    """{module path: numpy} of a JAX static layer's parameters (read from
    the JAX scope) and of its scope-backed buffers."""
    scope = jstatic.global_scope()
    params = {k: np.asarray(scope.get(p.scope_name))
              for k, p in jnet.named_parameters()}
    bufs = {k: np.asarray(scope.get(b.scope_name))
            for k, b in jnet.named_buffers()
            if getattr(b, "scope_name", None)}
    return params, bufs


def copy_static(jnet, tnet):
    """The JAX static layer's weights into the port static layer's scope
    entries, by module path."""
    params, bufs = jax_static_params(jnet)
    load_jax_static_params(tnet, params, bufs or None)
    return tnet
