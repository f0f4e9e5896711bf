"""paddle.nn of the port (paddle_tpu/nn): ``Layer`` and its containers,
the layers of ``layer/`` (common, conv, norm, pooling, activation, loss,
rnn, transformer), ``functional``, ``initializer`` and ``utils``.
``decode``'s beam search waits for ROADMAP Queue 1 item 4."""
from . import functional, initializer, utils  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer import Layer, Parameter, ParamAttr  # noqa: F401


def __getattr__(name):
    # the clip classes live in optimizer, and are paddle.nn.* names too
    if name in ("ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"):
        from ..optimizer import clip
        return getattr(clip, name)
    raise AttributeError(
        f"module 'paddle_tpu_torch.nn' has no attribute {name!r}")
