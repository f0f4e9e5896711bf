"""Framework utilities of the port (paddle_tpu/framework): ``save`` and
``load`` (``io.py``)."""
from .io import load, save, to_numpy  # noqa: F401

__all__ = ["save", "load", "to_numpy"]
