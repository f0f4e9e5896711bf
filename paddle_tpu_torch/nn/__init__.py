"""Layers of the port (paddle_tpu/nn): torch ``nn.Module``s under the JAX
package's names."""
from .layer import (CrossEntropyLoss, Dropout, Embedding,  # noqa: F401
                    LayerNorm, Linear, MultiHeadAttention, StaticKVCache,
                    TransformerEncoder, TransformerEncoderLayer)
