"""The high-level API (paddle_tpu/hapi): ``Model``, ``InputSpec``, the
callbacks and ``summary``."""
from . import callbacks  # noqa: F401
from .model import InputSpec, Model  # noqa: F401
from .summary import summary  # noqa: F401

__all__ = ["Model", "InputSpec", "summary", "callbacks"]
