"""Functional ops of the serving slice (paddle_tpu/nn/functional).

``scaled_dot_product_attention`` here is the composite ``_sdpa`` of the
JAX package (nn/functional/__init__.py:72-87): causal positions filled
with ``finfo.min``, softmax by max-subtraction. The JAX package runs that
composite below ``FLAGS_flash_min_seq`` and sends longer sequences to its
flash kernel; the flash kernel is not ported yet, so the port runs the
composite on the CPU and on the card alike (``GPT.forward`` without a
cache). The decode paths do not come here: they use the decode-attention
kernels (ops/cuda/decode_attention.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = ["linear", "gelu", "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """y = x @ W.T (+ b) with torch's [out, in] weight."""
    return tF.linear(x, weight, bias)


def gelu(x):
    """Exact (erf) GELU, as jax.nn.gelu(approximate=False)."""
    return tF.gelu(x, approximate="none")


def _sdpa(q, k, v, mask, scale, is_causal):
    """q, k, v [batch, heads, seq, head_dim]. Causal masking is aligned
    bottom-right (col <= row + s_k - s_q)."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    fill = torch.finfo(logits.dtype).min
    if is_causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        causal = torch.ones((s_q, s_k), dtype=torch.bool,
                            device=q.device).tril(s_k - s_q)
        logits = logits.masked_fill(~causal, fill)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, fill)
        else:
            logits = logits + mask
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True):
    """Attention core; dropout applies to the attention output, not to
    the probabilities, as in the JAX package."""
    scale = query.shape[-1] ** -0.5 if scale is None else scale
    out = _sdpa(query, key, value, attn_mask, scale, is_causal)
    if dropout_p > 0.0 and training:
        out = tF.dropout(out, p=dropout_p, training=True)
    return out
