"""The port's op library (paddle_tpu/ops) and its CUDA kernels
(``ops/cuda``: CUDA C++ built at first use).

Each op module mirrors its JAX counterpart; ``_dispatch.defop`` registers
an op under the JAX op's name and version, and ``_bind`` gives ``Tensor``
its operators and methods. As in the JAX package, the plain functions of
the op modules (creation, random, the host ops) join ``OP_REGISTRY`` too,
without a version.
"""
from ._dispatch import OP_REGISTRY, SHAPE_INFER_REGISTRY, defop  # noqa: F401
from .math import *          # noqa: F401,F403
from .creation import *      # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .reduction import *     # noqa: F401,F403
from .logic import *         # noqa: F401,F403
from .linalg import *        # noqa: F401,F403
from .activation import *    # noqa: F401,F403
from .conv import *          # noqa: F401,F403
from .norm_ops import *      # noqa: F401,F403
from .loss import *          # noqa: F401,F403

from . import _bind  # noqa: F401,E402  attaches Tensor operators/methods

_MODULES = ("math", "creation", "manipulation", "reduction", "logic",
            "linalg", "activation", "conv", "norm_ops", "loss")


def _register_plain_ops():
    """Sweep every public op function into OP_REGISTRY, as the JAX
    package does; defop entries stay authoritative."""
    import inspect
    import sys

    for m in _MODULES:
        mod = sys.modules[f"{__name__}.{m}"]
        for n in mod.__all__:
            fn = getattr(mod, n)
            if not callable(fn) or inspect.isclass(fn):
                continue
            if not hasattr(fn, "raw"):
                fn.raw = fn
            OP_REGISTRY.setdefault(n, fn)


_register_plain_ops()
