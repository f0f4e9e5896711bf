"""paddle.nn of the port (paddle_tpu/nn): ``Layer`` and its containers,
the layers of ``layer/`` (common, conv, norm, pooling, activation, loss,
rnn, transformer), ``functional``, ``initializer``, ``utils`` and
``decode``'s beam search (``BeamSearchDecoder``, ``dynamic_decode``)."""
from . import functional, initializer, utils  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer import Layer, Parameter, ParamAttr  # noqa: F401


def __getattr__(name):
    # the clip classes live in optimizer, and are paddle.nn.* names too
    if name in ("ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"):
        from ..optimizer import clip
        return getattr(clip, name)
    raise AttributeError(
        f"module 'paddle_tpu_torch.nn' has no attribute {name!r}")
