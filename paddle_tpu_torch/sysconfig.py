"""paddle.sysconfig of the port (paddle_tpu/sysconfig.py; reference
python/paddle/sysconfig.py): where the C headers and the shared libraries
are, for building against the framework. ``get_include()`` holds
``paddle_tpu_capi.h``; ``get_lib()`` holds ``libpaddle_tpu_capi.so`` once
``_native.build_capi()`` has built it."""
from __future__ import annotations

import os

__all__ = ["get_include", "get_lib"]

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_native")


def get_include():
    """The directory of the C headers (``_native/include``)."""
    return os.path.join(_NATIVE, "include")


def get_lib():
    """The directory of the shared libraries (``_native/lib``)."""
    return os.path.join(_NATIVE, "lib")
