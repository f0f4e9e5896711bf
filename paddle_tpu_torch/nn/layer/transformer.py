"""MultiHeadAttention with the fused qkv projection and its two decode
caches, the encoder and decoder stacks and the encoder-decoder
``Transformer`` (paddle_tpu/nn/layer/transformer.py).

- ``StaticKVCache``: a preallocated [b, h, max_len, d] k/v pair per
  layer, written IN PLACE at ``index`` (the JAX package builds a new
  cache with dynamic_update_slice). Attention is the contiguous decode
  kernel where ``_decode_kernel_eligible`` admits the call (the JAX gate:
  ``FLAGS_use_decode_attention`` on, not training, a shape the kernel
  takes); each rejection counts under
  ``cuda.gate_reject.decode_attention.{flag_off,training,shape}`` and
  runs ``_static_cache_attention``, the JAX package's plain cache
  attention, with dropout on the probabilities in training.
- ``PagedKVCache`` (nn/kv_pool.py): the serving arena through block
  tables; attention is the block-table kernel, and in training its plain
  version (``training`` rejection, as in the JAX gate).
Without a cache, attention is ``F.scaled_dot_product_attention``: the
flash kernels (forward and backward) once ``s_k >= FLAGS_flash_min_seq``
and the mask is a [b, 1, 1, s_k] key bias, else the composite. So in a
``Transformer`` the encoder's self-attention and the decoder's
cross-attention (``memory_mask`` [b, 1, 1, s_src]) take the kernels, and
the decoder's self-attention, whose ``tgt_mask`` is [s, s], the
composite (gate reason ``shape``); the cached decoder takes no
``tgt_mask``, its causality comes from the cache fill.
"""
from __future__ import annotations

import copy
import typing

import torch

from ... import ops
from ...core import flags as _flags
from ...core import rng as _rng
from ...core.dtype import to_torch_dtype
from ...device import resolve_device
from ...ops._dispatch import raw_scope, wrap
from ...ops.cuda import gate_reject
from ...ops.cuda.decode_attention import (decode_attention,
                                          paged_attention_ref, supported)
from .. import functional as F
from ..kv_pool import PagedKVCache, paged_attention, write_kv
from .common import Dropout, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "StaticKVCache", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


class StaticKVCache(typing.NamedTuple):
    """Preallocated decode cache: k/v [b, heads, max_len, head_dim] and
    ``index``, the host int count of filled positions."""

    k: torch.Tensor
    v: torch.Tensor
    index: int


def _static_cache_attention(q, kc, vc, index, scale, dropout_p, training):
    """Attention of q [b, h, s, d] over a partly filled cache [b, h, L, d]
    (paddle_tpu's ``_static_cache_attention``): row r attends to the
    cache columns <= index + r; scores in f32, -1e9 on the dead columns,
    the probabilities in q's dtype, dropped out in training through the
    port's generator."""
    s, L = q.shape[2], kc.shape[2]
    row = index + torch.arange(s, device=q.device)[:, None]
    live = torch.arange(L, device=q.device)[None, :] <= row
    scores = torch.einsum("bhsd,bhld->bhsl", q.float(), kc.float()) * scale
    scores = scores.masked_fill(~live, -1e9)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_p and training:
        keep = 1.0 - dropout_p
        mask = torch.rand(p.shape, generator=_rng.generator(p.device),
                          device=p.device) < keep
        p = p * mask / keep
    dt = torch.promote_types(p.dtype, vc.dtype)
    return torch.einsum("bhsl,bhld->bhsd", p.to(dt), vc.to(dt))


def _decode_kernel_eligible(q, kc, training):
    """The JAX gate of the contiguous decode kernel
    (paddle_tpu/nn/layer/transformer.py ``_decode_kernel_eligible``), in
    its order; its ``backend`` reason has no counterpart (CPU tensors take
    the kernel's plain version)."""
    if not _flags.flag("FLAGS_use_decode_attention"):
        return gate_reject("decode_attention", "flag_off")
    if training:
        # the kernel has no dropout and no backward: training-time cache
        # attention stays plain even at dropout 0
        return gate_reject("decode_attention", "training")
    if not supported(tuple(q.shape), tuple(kc.shape)):
        return gate_reject("decode_attention", "shape")
    return True


class MultiHeadAttention(Layer):
    """Multi-head attention with the JAX layer's projections: one fused
    [E, 3E] qkv projection for self-attention (``fuse_qkv``, the default
    when the key and value widths are E), else separate q / k / v ones."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, fuse_qkv=True):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.need_weights = need_weights
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self._fuse_qkv = fuse_qkv and self.kdim == embed_dim \
            and self.vdim == embed_dim
        if self._fuse_qkv:
            self.qkv_proj = Linear(embed_dim, 3 * embed_dim,
                                   weight_attr=weight_attr,
                                   bias_attr=bias_attr)
        else:
            self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
            self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
            self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        """[b, s, E] -> [b, h, s, d] (views)."""
        b, s = x.shape[0], x.shape[1]
        x = ops.reshape(x, [b, s, self.num_heads, self.head_dim])
        return ops.transpose(x, [0, 2, 1, 3])

    def _merge(self, out):
        """[b, h, s, d] -> out_proj([b, s, E])."""
        out = ops.transpose(out, [0, 2, 1, 3])
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(ops.reshape(out, [b, s, self.embed_dim]))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None, is_causal=False):
        key = query if key is None else key
        value = query if value is None else value
        if self._fuse_qkv and key is query and value is query:
            q, k, v = ops.split(self.qkv_proj(query), 3, axis=-1)
        elif self._fuse_qkv:
            wq, wk, wv = ops.split(self.qkv_proj.weight, 3, axis=-1)
            bq, bk, bv = ops.split(self.qkv_proj.bias, 3, axis=-1)
            q = F.linear(query, wq, bq)
            k = F.linear(key, wk, bk)
            v = F.linear(value, wv, bv)
        else:
            q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        q, k, v = (self._split_heads(t) for t in (q, k, v))
        if isinstance(cache, (PagedKVCache, StaticKVCache)):
            if attn_mask is not None:
                raise ValueError("attn_mask is not supported with a decode "
                                 "cache: causality comes from the cache "
                                 "fill")
            with raw_scope():
                out, new_cache = self._cache_attention(q, k, v, cache)
            return self._merge(out), new_cache
        if cache is not None:
            k = ops.concat([cache[0], k], axis=2)
            v = ops.concat([cache[1], v], axis=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=is_causal, training=self.training)
        out = self._merge(out)
        return (out, (k, v)) if cache is not None else out

    def _cache_attention(self, q, k, v, cache):
        """q, k, v [b, h, s, d] against a decode cache; (out [b, h, s, d],
        the cache after the write). The k/v chunk is written in place."""
        scale = self.head_dim ** -0.5
        qh = q.contiguous()
        s = qh.shape[2]
        if isinstance(cache, PagedKVCache):
            # the serving arena shared across requests, indirected per slot
            write_kv(cache.k, cache.block_tables, cache.lengths,
                     k.transpose(1, 2), cache.slots)
            write_kv(cache.v, cache.block_tables, cache.lengths,
                     v.transpose(1, 2), cache.slots)
            if self.training:
                gate_reject("paged_decode_attention", "training")
                out = paged_attention_ref(qh, cache.k, cache.v,
                                          cache.block_tables, cache.lengths,
                                          scale)
            else:
                out = paged_attention(qh, cache.k, cache.v,
                                      cache.block_tables, cache.lengths,
                                      scale)
            return out, cache._replace(lengths=cache.lengths + s, slots=None)
        idx = int(cache.index)
        cache.k[:, :, idx:idx + s] = k
        cache.v[:, :, idx:idx + s] = v
        if _decode_kernel_eligible(qh, cache.k, self.training):
            out = decode_attention(qh, cache.k, cache.v, idx, scale)
        else:
            out = _static_cache_attention(qh, cache.k, cache.v, idx, scale,
                                          self.dropout, self.training)
        return out, StaticKVCache(cache.k, cache.v, idx + s)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """An empty (k, v) list cache [b, heads, 0, head_dim] for the
        concatenating path."""
        w = self.qkv_proj.weight if self._fuse_qkv else self.q_proj.weight
        z = torch.zeros(key.shape[0], self.num_heads, 0, self.head_dim,
                        dtype=w.dtype, device=w.device)
        return (z, z)

    def gen_static_cache(self, batch_size, max_len, dtype=torch.float32,
                         device=None):
        """Zeroed preallocated decode cache (see StaticKVCache); ``dtype``
        a torch dtype or a Paddle name."""
        w = self.qkv_proj.weight if self._fuse_qkv else self.q_proj.weight
        device = w.device if device is None else device
        dtype = to_torch_dtype(dtype)
        shape = (batch_size, self.num_heads, max_len, self.head_dim)
        return StaticKVCache(torch.zeros(shape, dtype=dtype, device=device),
                             torch.zeros(shape, dtype=dtype, device=device),
                             0)


class TransformerEncoderLayer(Layer):
    """Self-attention + feed-forward block, post-norm unless
    ``normalize_before``. ``activation`` is a name looked up in the port's
    functional module ("gelu" is the exact erf GELU). Both norms use
    LayerNorm's default epsilon 1e-5, as the JAX layer does, whatever
    epsilon the model uses elsewhere."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself), then an optional final norm."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
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


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and feed-forward,
    post-norm unless ``normalize_before``. With a ``StaticKVCache`` the
    self-attention is the cached decode step (returns (out, new_cache))
    and ``tgt_mask`` is not used."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if isinstance(cache, StaticKVCache):
            tgt, new_cache = self.self_attn(tgt, cache=cache)
        else:
            tgt = self.self_attn(tgt, attn_mask=tgt_mask)
            new_cache = None
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        if new_cache is not None:
            return tgt, new_cache
        return tgt

    def gen_static_cache(self, batch_size, max_len, dtype=torch.float32,
                         device=None):
        return self.self_attn.gen_static_cache(batch_size, max_len, dtype,
                                               device)


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer`` (the first is the layer
    itself), then an optional final norm. ``cache``: a list of per-layer
    StaticKVCache (``gen_static_cache``) for incremental decoding; the
    call then returns (out, new_caches)."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        out = tgt
        new_caches = [] if cache is not None else None
        for i, layer in enumerate(self.layers):
            if cache is not None:
                out, c = layer(out, memory, memory_mask=memory_mask,
                               cache=cache[i])
                new_caches.append(c)
            else:
                out = layer(out, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        if new_caches is not None:
            return out, new_caches
        return out

    def gen_static_cache(self, batch_size, max_len, dtype=torch.float32,
                         device=None):
        """One StaticKVCache per layer."""
        return [layer.gen_static_cache(batch_size, max_len, dtype, device)
                for layer in self.layers]


class Transformer(Layer):
    """The encoder-decoder of Vaswani et al. (JAX reference
    nn/layer/transformer.py:967). Its defaults are their "base" model:
    d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout 0.1, ReLU,
    post-norm (a final norm on each stack only with
    ``normalize_before``)."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            enc_norm = LayerNorm(d_model) if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers,
                                              enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            dec_norm = LayerNorm(d_model) if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers,
                                              dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] float32, 0 on and below the diagonal and -inf
        above it, on the current device."""
        m = torch.full((length, length), float("-inf"),
                       device=resolve_device(device)).triu(1)
        return wrap(m)
