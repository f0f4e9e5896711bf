from .common import Dropout, Embedding, Linear  # noqa: F401
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import (MultiHeadAttention, StaticKVCache,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
