"""Custom operators and C++ extensions (paddle_tpu/utils/cpp_extension.py;
reference python/paddle/utils/cpp_extension/: ``CppExtension`` and
``load()`` JIT-compiling user code, and the PD_BUILD_OP registration).

``load()`` compiles host C++ sources with g++ into
``{build_dir}/lib{name}.so`` and returns the ``ctypes.CDLL``, as the JAX
package's does (no pybind: declare ``argtypes`` / ``restype`` and call).
``register_custom_op`` takes a torch function, an autograd ``Function``
subclass, or a function with a JAX-style ``vjp=(fwd, bwd)`` pair into the
op registry (``ops/_dispatch.defop``): the op then dispatches over
Tensors, records into static Programs and differentiates through torch
autograd. A device kernel of one's own is a CUDA source built as
``ops/cuda/_build.py`` builds the port's and called from such a
function.
"""
from __future__ import annotations

import functools
import os
import subprocess
import threading

import torch

__all__ = ["load", "CppExtension", "register_custom_op"]

_lock = threading.Lock()


def _build_dir():
    d = os.environ.get("PADDLE_EXTENSION_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "paddle_tpu_extensions")
    os.makedirs(d, exist_ok=True)
    return d


class CppExtension:
    """Build spec (reference cpp_extension.CppExtension)."""

    def __init__(self, sources, extra_compile_args=None,
                 include_dirs=None, name=None):
        self.sources = list(sources)
        self.extra_compile_args = list(extra_compile_args or [])
        self.include_dirs = list(include_dirs or [])
        self.name = name


def load(name, sources=None, extra_cxx_cflags=None, include_dirs=None,
         verbose=False, build_directory=None):
    """Compile C++ sources with g++ into ``lib{name}.so`` (again only when
    a source is newer) and load it with ctypes."""
    import ctypes

    if isinstance(name, CppExtension):
        ext = name
        name = ext.name or "ext"
        sources = ext.sources
        extra_cxx_cflags = ext.extra_compile_args
        include_dirs = ext.include_dirs
    if not sources:
        raise ValueError("load() needs C++ sources")
    out_dir = build_directory or _build_dir()
    so = os.path.join(out_dir, f"lib{name}.so")
    srcs = [os.path.abspath(s) for s in sources]
    with _lock:
        stale = (not os.path.exists(so)
                 or any(os.path.getmtime(so) < os.path.getmtime(s)
                        for s in srcs))
        if stale:
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                   *srcs, "-o", so + ".tmp"]
            for inc in include_dirs or []:
                cmd.append(f"-I{inc}")
            cmd += list(extra_cxx_cflags or [])
            if verbose:
                print("[cpp_extension]", " ".join(cmd))
            subprocess.run(cmd, check=True, capture_output=not verbose)
            os.replace(so + ".tmp", so)
    return ctypes.CDLL(so)


def _from_vjp(fn, fwd, bwd):
    """An autograd Function of ``fn``'s tensor arguments from a JAX-style
    pair: ``fwd(*args) -> (out, residuals)``, ``bwd(residuals, ct) -> one
    cotangent an argument``."""
    class _Custom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            out, res = fwd(*args)
            ctx.res = res
            return out

        @staticmethod
        def backward(ctx, ct):
            return tuple(bwd(ctx.res, ct))

    @functools.wraps(fn)
    def raw(*args):
        return _Custom.apply(*args)
    return raw


def register_custom_op(name=None, vjp=None):
    """Register a function as a first-class operator (reference
    PD_BUILD_OP + load_op_library)::

        @register_custom_op(vjp=(fwd, bwd))
        def my_op(x, alpha=1.0): ...

    The decorated object may be a torch function (differentiated by
    autograd), an ``autograd.Function`` subclass (its ``apply``), or a
    function with ``vjp``, a (fwd, bwd) pair with ``jax.custom_vjp``'s
    meaning. Returns the op's wrapper, registered in ``OP_REGISTRY``."""
    from ..ops._dispatch import defop

    def deco(fn):
        raw = fn
        if isinstance(fn, type) and issubclass(fn, torch.autograd.Function):
            apply = fn.apply
            raw = functools.wraps(fn.forward)(lambda *a: apply(*a))
            raw.__name__ = fn.__name__
        elif vjp is not None:
            raw = _from_vjp(fn, *vjp)
        return defop(raw, name=name or raw.__name__)

    return deco
