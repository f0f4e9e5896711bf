"""paddle.nn of the port (paddle_tpu/nn): ``Layer`` and its containers,
the layers of the BERT and GPT paths, ``functional`` and ``initializer``."""
from . import functional, initializer  # noqa: F401
from .layer import (CrossEntropyLoss, Dropout, Embedding,  # noqa: F401
                    Layer, LayerDict, LayerList, LayerNorm, Linear,
                    MultiHeadAttention, ParamAttr, Parameter, ParameterList,
                    Sequential, StaticKVCache, TransformerEncoder,
                    TransformerEncoderLayer)
