"""MultiHeadAttention with the fused qkv projection and its two decode
caches, and the BERT encoder stack (paddle_tpu/nn/layer/transformer.py).

- ``StaticKVCache``: a preallocated [b, h, max_len, d] k/v pair per
  layer, written IN PLACE at ``index`` (the JAX package builds a new
  cache with dynamic_update_slice); attention is the contiguous decode
  kernel.
- ``PagedKVCache`` (nn/kv_pool.py): the serving arena through block
  tables; attention is the block-table kernel.
Both caches are eval-only, as the kernels have no dropout and no
backward. Without a cache, attention is ``F.scaled_dot_product_attention``:
the flash kernels (forward and backward) once ``s >= FLAGS_flash_min_seq``,
else the composite. ``TransformerEncoderLayer`` / ``TransformerEncoder``
pass an additive ``src_mask`` [b, 1, 1, s], which the flash route takes
as its key bias.
"""
from __future__ import annotations

import copy
import typing

import torch

from ...ops.cuda.decode_attention import decode_attention
from .. import functional as F
from ..kv_pool import PagedKVCache, paged_attention, write_kv
from .common import Dropout, Linear
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "StaticKVCache", "TransformerEncoderLayer",
           "TransformerEncoder"]


class StaticKVCache(typing.NamedTuple):
    """Preallocated decode cache: k/v [b, heads, max_len, head_dim] and
    ``index``, the host int count of filled positions."""

    k: torch.Tensor
    v: torch.Tensor
    index: int


def _static_cache_attention(q, kc, vc, index, scale):
    """Attention of q [b,h,s,d] over a partially filled cache [b,h,L,d]:
    position index + row attends to cache cols <= index + row."""
    return decode_attention(q, kc, vc, index, scale)


class MultiHeadAttention(torch.nn.Module):
    """Self-attention with one fused [3E, E] qkv projection."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, device=None,
                 dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim, device=device,
                               dtype=dtype)
        self.out_proj = Linear(embed_dim, embed_dim, device=device,
                               dtype=dtype)

    def _heads(self, x):
        """[b, s, E] -> [b, s, h, d] (a view)."""
        b, s = x.shape[0], x.shape[1]
        (x,) = F.amp_op("reshape", x)
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def _merge(self, out):
        """[b, h, s, d] -> out_proj([b, s, E])."""
        b, s = out.shape[0], out.shape[2]
        (out,) = F.amp_op("transpose", out)
        out = out.transpose(1, 2)
        (out,) = F.amp_op("reshape", out)
        return self.out_proj(out.reshape(b, s, self.embed_dim))

    @staticmethod
    def _to_bhsd(x):
        """[b, s, h, d] -> [b, h, s, d] (a view)."""
        (x,) = F.amp_op("transpose", x)
        return x.transpose(1, 2)

    def forward(self, query, attn_mask=None, cache=None, is_causal=False):
        (qkv,) = F.amp_op("split_op", self.qkv_proj(query))
        q, k, v = qkv.chunk(3, dim=-1)
        scale = self.head_dim ** -0.5
        if cache is None:
            # head-split views of the one qkv projection; the flash route
            # copies them to contiguous [b * h, s, d] (flash_attention),
            # the kernels take no strides
            q, k, v = (self._to_bhsd(self._heads(t)) for t in (q, k, v))
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                is_causal=is_causal, training=self.training)
            return self._merge(out)
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        if attn_mask is not None:
            raise ValueError("attn_mask is not supported with a decode "
                             "cache: causality comes from the cache fill")
        if self.training and self.dropout > 0:
            raise RuntimeError("cache attention is eval-only; call .eval()")
        qh = q.transpose(1, 2).contiguous()                  # [b, h, s, d]
        s = qh.shape[2]
        if isinstance(cache, PagedKVCache):
            # paged (block-table) path: the serving arena shared across
            # requests, indirected per slot
            write_kv(cache.k, cache.block_tables, cache.lengths, k,
                     cache.slots)
            write_kv(cache.v, cache.block_tables, cache.lengths, v,
                     cache.slots)
            out = paged_attention(qh, cache.k, cache.v, cache.block_tables,
                                  cache.lengths, scale)
            return self._merge(out), cache._replace(
                lengths=cache.lengths + s, slots=None)
        if isinstance(cache, StaticKVCache):
            idx = int(cache.index)
            cache.k[:, :, idx:idx + s] = k.transpose(1, 2)
            cache.v[:, :, idx:idx + s] = v.transpose(1, 2)
            out = _static_cache_attention(qh, cache.k, cache.v, idx, scale)
            return self._merge(out), StaticKVCache(cache.k, cache.v,
                                                   idx + s)
        raise TypeError(f"unsupported cache {type(cache).__name__}")

    def gen_static_cache(self, batch_size, max_len, dtype=torch.float32,
                         device=None):
        """Zeroed preallocated decode cache (see StaticKVCache)."""
        device = self.qkv_proj.weight.device if device is None else device
        shape = (batch_size, self.num_heads, max_len, self.head_dim)
        return StaticKVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device),
                             0)


class TransformerEncoderLayer(torch.nn.Module):
    """Self-attention + feed-forward block, post-norm unless
    ``normalize_before``. ``activation`` is a name looked up in the port's
    functional module ("gelu" is the exact erf GELU). Both norms use
    LayerNorm's default epsilon 1e-5, as the JAX layer does, whatever
    epsilon the model uses elsewhere."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = F.add(residual, self.dropout1(src))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = F.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(torch.nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself), then an optional final norm."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
