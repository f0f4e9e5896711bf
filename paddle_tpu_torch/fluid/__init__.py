"""paddle.fluid of the port: the v1 compatibility namespace
(paddle_tpu/fluid/__init__.py).

The reference's 1.x surface (python/paddle/fluid/__init__.py +
fluid/layers/, ~36k LoC of wrappers) predates the 2.0 API; this module
keeps v1 programs running by mapping the commonly used names onto the
port's 2.0 implementations (``static``, ``nn``, ``ops``, ``device``):
thin adapters over the real ops and layers, not a second op layer.
"""
from __future__ import annotations

from .. import static as _static
from ..static import (Executor, Program, default_main_program,  # noqa: F401
                      default_startup_program, global_scope,
                      program_guard)
from ..static.program import Scope  # noqa: F401
from ..device import CPUPlace, CUDAPlace  # noqa: F401
from ..core import dtype as core  # noqa: F401
from . import layers  # noqa: F401
from . import io  # noqa: F401

__all__ = ["layers", "io", "Executor", "Program", "Scope", "CPUPlace",
           "CUDAPlace", "default_main_program", "default_startup_program",
           "program_guard", "global_scope", "data", "embedding",
           "enable_dygraph", "disable_dygraph"]


def data(name, shape, dtype="float32", lod_level=0):
    return _static.data(name, shape, dtype, lod_level)


def embedding(input, size, is_sparse=False, padding_idx=None,  # noqa: A002
              param_attr=None, dtype="float32"):
    return layers.embedding(input, size, is_sparse=is_sparse,
                            padding_idx=padding_idx, param_attr=param_attr,
                            dtype=dtype)


def enable_dygraph(place=None):
    from .. import disable_static
    disable_static()


def disable_dygraph():
    from .. import enable_static
    enable_static()
