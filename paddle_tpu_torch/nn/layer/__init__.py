from .layers import Layer, ParamAttr, Parameter  # noqa: F401
from .container import (LayerDict, LayerList, ParameterList,  # noqa: F401
                        Sequential)
from .common import Dropout, Embedding, Linear  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import (MultiHeadAttention, StaticKVCache,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
