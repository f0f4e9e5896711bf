"""Optimizers of the port (paddle_tpu/optimizer): Adam and AdamW with f32
master weights. lr schedulers, gradient clipping and regularizer objects
are not ported yet."""
from .optimizer import Adam, AdamW, Optimizer  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW"]
