from .common import Dropout, Embedding, Linear  # noqa: F401
from .norm import LayerNorm  # noqa: F401
from .transformer import MultiHeadAttention, StaticKVCache  # noqa: F401
