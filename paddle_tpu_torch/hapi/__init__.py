"""The high-level API (paddle_tpu/hapi): ``Model``, ``InputSpec``, the
callbacks, ``summary`` and ``flops``."""
from . import callbacks  # noqa: F401
from .model import InputSpec, Model  # noqa: F401
from .summary import flops, summary  # noqa: F401

__all__ = ["Model", "InputSpec", "summary", "flops", "callbacks"]
