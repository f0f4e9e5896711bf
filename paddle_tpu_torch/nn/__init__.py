"""Layers of the port (paddle_tpu/nn): torch ``nn.Module``s under the JAX
package's names."""
from .layer import (Dropout, Embedding, LayerNorm, Linear,  # noqa: F401
                    MultiHeadAttention, StaticKVCache)
