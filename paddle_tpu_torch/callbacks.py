"""The hapi callbacks under their top-level name (paddle_tpu/callbacks.py)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, CallbackList, EarlyStopping, History, LRSchedulerCallback,
    ModelCheckpoint, ProgBarLogger, VisualDL)

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRSchedulerCallback", "History", "VisualDL"]
