"""Functional ops of the serving and training slices
(paddle_tpu/nn/functional, paddle_tpu/ops/loss.py).

``scaled_dot_product_attention`` is the JAX package's dispatch site
(nn/functional/__init__.py:146-166): the gate ``_flash_eligible`` sends a
call to the flash kernels (``_flash_sdpa`` -> ops/cuda/flash_attention.py:
the kernels for CUDA tensors, their plain versions for CPU tensors) when
``FLAGS_use_flash_attention`` is on, ``s_k >= FLAGS_flash_min_seq``, the
mask has no gradient and the shapes are ``supported``; else it runs the
composite ``_sdpa`` (:72-87): causal positions filled with ``finfo.min``,
softmax by max-subtraction. Each decision bumps ``cuda.hit.flash_attention``
or ``cuda.gate_reject.flash_attention.{reason}``. The decode paths do not
come here: they use the decode-attention kernels
(ops/cuda/decode_attention.py).

``fused_linear_cross_entropy`` is the loss-head dispatch site
(nn/functional/__init__.py:191): with ``FLAGS_use_fused_ce`` on it runs
the fused CE kernels (ops/cuda/fused_ce.py: the kernels on the card,
their plain versions on the CPU); off, ``_ce_head_composite`` under torch
autograd, the JAX composite ``_ce_head_fallback``: logits formed in the
input dtype (so rounded to bf16 for bf16 inputs), then f32. On the card
there is no shape gate and no fallback: a shape the kernels do not take
raises.

AMP (``paddle_tpu_torch.amp``): the JAX package casts each recorded op's
inputs in ``record_op`` under the op's name. Here ``amp_op(name, ...)``
is that cast point, called at the entry of each function that stands for
a recorded JAX op on the BERT and GPT training paths, under the JAX op's
name (``matmul``, ``add``, ``layer_norm``, ``sdpa`` / ``flash_sdpa``,
``fused_ce_op`` / ``ce_head_fallback`` ...); without AMP it returns its
inputs as they are. ``linear`` is JAX's two recorded ops, ``matmul`` then
``add``, whenever AMP is on: under O1 the gray bias add promotes the
low-precision product back to f32, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

from .. import amp as _amp
from ..core import flags as _flags
from ..ops.cuda import gate_hit, gate_reject
from ..ops.cuda.flash_attention import flash_attention, supported
from ..ops.cuda.fused_ce import _label_hits, fused_ce

__all__ = ["amp_op", "add", "linear", "gelu", "relu", "dropout",
           "scaled_dot_product_attention", "cross_entropy",
           "fused_linear_cross_entropy"]


def amp_op(name, *vals):
    """The AMP cast point of the JAX package's recorded op ``name``:
    ``vals`` with their floating tensors cast per the active policy, as
    they are without AMP."""
    if not _amp.amp_active():
        return vals
    return _amp.cast_inputs(name, list(vals))


def add(x, y):
    """x + y (JAX's recorded ``add``)."""
    x, y = amp_op("add", x, y)
    return x + y


def linear(x, weight, bias=None):
    """y = x @ W.T (+ b) with torch's [out, in] weight: one fused call, or
    under AMP the JAX package's ``matmul`` then ``add``."""
    if not _amp.amp_active():
        return tF.linear(x, weight, bias)
    x, weight = amp_op("matmul", x, weight)
    y = torch.matmul(x, weight.T)
    return y if bias is None else add(y, bias)


def gelu(x):
    """Exact (erf) GELU, as jax.nn.gelu(approximate=False)."""
    (x,) = amp_op("gelu", x)
    return tF.gelu(x, approximate="none")


def relu(x):
    return tF.relu(x)


def dropout(x, p=0.5, training=True):
    """Upscale-in-train dropout; identity when not training or p == 0."""
    if not training or p == 0.0:
        return x
    (x,) = amp_op("dropout_op", x)
    return tF.dropout(x, p=p, training=True)


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
            # an f32 additive mask stays in the logits' dtype (bf16 runs),
            # as the flash route returns q's dtype; the JAX composite
            # promotes to f32 here (ROADMAP Queue 3)
            logits = logits + mask.to(logits.dtype)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _flash_sdpa(q, k, v, mask, scale, is_causal):
    """The flash kernels on [b, h, s, d]: a [b, 1, 1, s_k] mask becomes
    the f32 key bias [b, s_k] (a bool mask: 0 where kept, -1e9 where not)."""
    bias = None
    if mask is not None:
        m = mask.reshape(mask.shape[0], mask.shape[-1])
        if m.dtype == torch.bool:
            bias = torch.where(m, 0.0, -1e9).to(torch.float32)
        else:
            bias = m.to(torch.float32)
    return flash_attention(q, k, v, bias=bias, causal=is_causal, scale=scale)


def _flash_eligible(query, key, value, attn_mask):
    """The gate, in the JAX package's order (its ``backend`` reason has no
    counterpart: CPU tensors take the kernels' plain versions)."""
    if not _flags.flag("FLAGS_use_flash_attention"):
        return gate_reject("flash_attention", "flag_off")
    min_seq = int(_flags.flag("FLAGS_flash_min_seq"))
    if min_seq and key.shape[-2] < min_seq:
        return gate_reject("flash_attention", "min_seq")
    if attn_mask is not None and attn_mask.requires_grad:
        # the kernels treat the bias as data (no mask gradient); a learned
        # additive mask takes the composite, which differentiates it
        return gate_reject("flash_attention", "mask_grad")
    mask_shape = None if attn_mask is None else tuple(attn_mask.shape)
    if not supported(tuple(query.shape), tuple(key.shape),
                     tuple(value.shape), mask_shape):
        return gate_reject("flash_attention", "shape")
    return gate_hit("flash_attention")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False, scale=None,
                                 training=True):
    """Attention core over [batch, heads, seq, head_dim]: the flash
    kernels where the gate admits the call, else the composite. Dropout
    applies to the attention output, not to the probabilities, as in the
    JAX package."""
    scale = query.shape[-1] ** -0.5 if scale is None else scale
    if _flash_eligible(query, key, value, attn_mask):
        query, key, value, attn_mask = amp_op("flash_sdpa", query, key,
                                              value, attn_mask)
        out = _flash_sdpa(query, key, value, attn_mask, scale, is_causal)
    else:
        query, key, value, attn_mask = amp_op("sdpa", query, key, value,
                                              attn_mask)
        out = _sdpa(query, key, value, attn_mask, scale, is_causal)
    return dropout(out, dropout_p, training)


def cross_entropy(input, label, ignore_index=-100,  # noqa: A002
                  reduction="mean"):
    """Softmax cross-entropy over the last axis of ``input`` against int
    ``label`` (paddle_tpu/ops/loss.py:cross_entropy without weights or
    soft labels). A label outside [0, C) selects no class (loss 0); "mean"
    divides by the number of rows whose label is not ``ignore_index``. A
    label with a trailing axis of 1 is squeezed, as JAX's is."""
    (input,) = amp_op("cross_entropy", input)
    if label.ndim == input.ndim and label.shape[-1] == 1:
        label = label[..., 0]
    logp = torch.log_softmax(input, dim=-1)
    label = label.long()
    valid = label != ignore_index
    in_range = (label >= 0) & (label < input.shape[-1])
    safe = torch.where(in_range, label, torch.zeros_like(label))
    picked = logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid & in_range, -picked, torch.zeros_like(picked))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.to(loss.dtype).sum().clamp_min(1e-12)


def _ce_head_composite(h, w, b, y, ignore_index):
    """Per-token f32 losses of the flag-off head, differentiable by
    autograd (paddle_tpu's ``_ce_head_fallback``): ``h @ w.T`` in the
    input dtype, then f32, then ``+ b``, then the lse. The kernels' plain
    version (``fused_ce_fwd_ref``) never rounds the logits: it is their
    oracle, this is the composite. A label outside [0, V) matches no
    column (loss = lse), as in the kernels."""
    dt = torch.promote_types(h.dtype, w.dtype)
    s = (h.to(dt) @ w.to(dt).T).float()
    if b is not None:
        s = s + b.float()
    lse = torch.logsumexp(s, dim=-1)
    in_range, safe = _label_hits(y, w.shape[0])
    tgt = torch.where(in_range, s.gather(1, safe[:, None])[:, 0],
                      torch.zeros_like(lse))
    return torch.where(y.long() != ignore_index, lse - tgt,
                       torch.zeros_like(lse))


def fused_linear_cross_entropy(hidden, weight, bias=None, labels=None,
                               ignore_index=-100, reduction="mean"):
    """Cross-entropy of ``hidden @ weight.T + bias`` against ``labels``
    without materializing the [n_tokens, vocab] logits. hidden [..., H]
    (flattened here), weight [vocab, H], bias [vocab] or None, labels
    [...] int. Per-token losses are f32 and 0 where ignored; "mean"
    divides their sum by max(#valid, 1)."""
    (hidden,) = amp_op("reshape", hidden)
    h2 = hidden.reshape(-1, hidden.shape[-1])
    (labels,) = amp_op("reshape", labels)
    y = labels.reshape(-1)
    if _flags.flag("FLAGS_use_fused_ce"):
        h2, weight, bias, y = amp_op("fused_ce_op", h2, weight, bias, y)
        losses = fused_ce(h2, weight, bias, y, int(ignore_index))
    else:
        h2, weight, bias, y = amp_op("ce_head_fallback", h2, weight, bias,
                                     y)
        losses = _ce_head_composite(h2, weight, bias, y, int(ignore_index))
    if reduction == "none":
        return losses
    (losses,) = amp_op("sum", losses)
    total = losses.sum()
    if reduction == "sum":
        return total
    (y,) = amp_op("not_equal", y)
    (kept,) = amp_op("cast", y != ignore_index)
    (kept,) = amp_op("sum", kept.to(torch.float32))
    valid, one = amp_op("maximum", kept.sum(),
                        torch.ones((), dtype=torch.float32,
                                   device=kept.device))
    total, denom = amp_op("divide", total, torch.maximum(valid, one))
    return total / denom
