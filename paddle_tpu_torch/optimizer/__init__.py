"""Optimizers of the port (paddle_tpu/optimizer): the twelve update rules
with f32 master weights, the LR schedulers (``lr``) and gradient clipping
(``clip``)."""
from . import lr  # noqa: F401
from .clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                   ClipGradByNorm, ClipGradByValue)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, Dpsgd, Ftrl, Lamb, Lars, Momentum, Optimizer,
                        RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "Ftrl", "Dpsgd",
           "ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "lr"]
