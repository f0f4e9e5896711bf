"""Functional ops of the port (paddle_tpu/nn/functional): the op library's
activations, norms, dropout and losses re-exported (with the v1 names
whose ops are ported: ``bpr_loss``, ``pad2d`` ...), plus the functions
with layer-level semantics: ``linear``, ``embedding``, ``bilinear``,
``sequence_mask``, the channelwise and alpha dropouts (drawn from the
port's generator), ``dice_loss``, ``soft_relu``,
``add_position_encoding``, attention and the fused loss head; the conv
family, the pools, ``interpolate`` / ``upsample`` with the v1
``image_resize`` / ``resize_*``, ``pixel_shuffle``, ``unfold`` and the
other names over ``ops/conv.py`` (``avg_pool1d`` and the 1-D adaptive
pools go through the 2-D ops over a unit height, as in the JAX package).
The names over the long-tail ops wait for ROADMAP Queue 1 item 9.

``linear`` is the JAX package's two recorded ops, ``matmul`` then
``add``, whenever AMP is on or a static Program records it (under O1 the gray bias add promotes the
low-precision product back to f32, as in the JAX package); without AMP
it is one call, ``addmm`` (one GEMM with the bias in its epilogue, the
[in, out] weight read by cuBLAS without a copy).

``scaled_dot_product_attention`` is the JAX package's dispatch site
(nn/functional/__init__.py:146-166): the gate ``_flash_eligible`` sends a
call to the flash kernels (the op ``flash_sdpa`` ->
ops/cuda/flash_attention.py: the kernels for CUDA tensors, their plain
versions for CPU tensors) when ``FLAGS_use_flash_attention`` is on,
``s_k >= FLAGS_flash_min_seq``, the mask has no gradient and the shapes
are ``supported``; else it runs the composite op ``sdpa`` (:72-87):
causal positions filled with ``finfo.min``, softmax by max-subtraction.
Each decision bumps ``cuda.hit.flash_attention`` or
``cuda.gate_reject.flash_attention.{reason}``. The decode paths do not
come here: they use the decode-attention kernels
(ops/cuda/decode_attention.py).

``fused_linear_cross_entropy`` is the loss-head dispatch site
(nn/functional/__init__.py:191): with ``FLAGS_use_fused_ce`` on it runs
the op ``fused_ce_op`` (ops/cuda/fused_ce.py: the kernels on the card,
their plain versions on the CPU); off, the op ``ce_head_fallback``, the
JAX composite: logits formed in the input dtype (so rounded to bf16 for
bf16 inputs), then f32. On the card there is no shape gate and no
fallback: a shape the kernels do not take raises.

Each of these ops is a ``defop`` under the JAX op's name, so AMP casts
its inputs as the JAX package's ``record_op`` does.
"""
from __future__ import annotations

import torch

from .. import amp as _amp
from .. import ops
from ..core import flags as _flags
from ..ops import (  # noqa: F401 - re-exported op families
    relu, relu6, leaky_relu, prelu, elu, selu, celu, gelu, sigmoid,
    hardsigmoid, hardswish, hardtanh, hardshrink, softshrink, tanhshrink,
    silu, swish, mish, softplus, softsign, softmax, log_softmax, log_sigmoid,
    gumbel_softmax, maxout, thresholded_relu, glu, normalize, tanh, pad,
    layer_norm, instance_norm, group_norm, rms_norm, local_response_norm,
    dropout, one_hot, cross_entropy, softmax_with_cross_entropy, nll_loss,
    mse_loss, l1_loss, smooth_l1_loss, binary_cross_entropy,
    binary_cross_entropy_with_logits, sigmoid_cross_entropy_with_logits,
    kl_div, margin_ranking_loss, hinge_embedding_loss, cosine_similarity,
    label_smooth, square_error_cost, log_loss, triplet_margin_loss,
    huber_loss)
from ..ops import (  # noqa: F401 - op-backed names of the v1 surface
    bpr_loss, data_norm, hinge_loss, l2_normalize, npair_loss, pad2d, pad3d,
    pad_constant_like, rank_loss, shuffle_channel, sigmoid_focal_loss,
    space_to_depth, teacher_student_sigmoid_loss, temporal_shift)
from ..ops import (  # noqa: F401 - the conv ops (ops/conv.py)
    conv1d, conv2d, conv3d, conv1d_transpose, conv2d_transpose,
    conv3d_transpose, max_pool1d, max_pool2d, max_pool3d, avg_pool2d,
    avg_pool3d, adaptive_avg_pool2d, adaptive_max_pool2d,
    adaptive_avg_pool3d, adaptive_max_pool3d, interpolate, pixel_shuffle,
    unfold, affine_channel, deform_conv2d, deformable_conv, im2sequence,
    psroi_pool, random_crop, row_conv)
from ..ops import embedding as _embedding_op
from ..core import rng as _rng
from ..core.dtype import to_torch_dtype
from ..ops._dispatch import _state as _dispatch_state
from ..ops._dispatch import defop, wrap
from ..ops.cuda import gate_hit, gate_reject
from ..ops.cuda.flash_attention import flash_attention, supported
from ..ops.cuda.fused_ce import _label_hits, fused_ce


def linear(x, weight, bias=None, name=None):
    """y = x @ W (+ b), W [in, out]."""
    if _amp.amp_active() or bias is None or _dispatch_state.static:
        out = ops.matmul(x, weight)
        return out if bias is None else ops.add(out, bias)
    return ops.addmm(bias, x, weight)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the ids ``x`` (Paddle's argument order: ids
    first). ``sparse`` is accepted; the gradient is dense."""
    return _embedding_op(weight, x, padding_idx=padding_idx, sparse=sparse)


def bilinear(x1, x2, weight, bias=None):
    """out[b, o] = x1[b] · weight[o] · x2[b] (+ bias[o])."""
    out = ops.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def sequence_mask(lengths, maxlen=None, dtype="int64"):
    """[..., maxlen] mask, 1 where the position is below the length;
    ``maxlen`` None takes the longest length."""
    m = int(lengths.max()) if maxlen is None else int(maxlen)
    pos = torch.arange(m, device=lengths.device)
    return wrap((pos < lengths[..., None]).to(to_torch_dtype(dtype)))


def _keep_mask(shape, keep, device):
    """Bernoulli(keep) draws of ``shape`` from the port's generator."""
    return torch.rand(shape, generator=_rng.generator(device),
                      device=device) < keep


def alpha_dropout(x, p=0.5, training=True):
    """SELU-preserving dropout: a dropped element becomes alpha' = -alpha *
    scale of SELU, then every element takes the affine fix-up a * x + b
    that keeps the mean and variance of SELU's fixed point."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.7580993408473766
    keep = 1.0 - p
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    mask = _keep_mask(x.shape, keep, x.device)
    out = a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b
    return wrap(out.to(x.dtype))


def _dropout_nd(x, p, training, channels_first, n_spatial):
    if not training or p == 0.0:
        return x
    shape = (x.shape[0], x.shape[1]) + (1,) * n_spatial if channels_first \
        else (x.shape[0],) + (1,) * n_spatial + (x.shape[-1],)
    keep = 1.0 - p
    mask = _keep_mask(shape, keep, x.device)
    return wrap((torch.where(mask, x, torch.zeros_like(x)) / keep)
                .to(x.dtype))


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Channelwise dropout: whole [H, W] feature maps dropped, the rest
    scaled by 1 / (1 - p)."""
    return _dropout_nd(x, p, training, data_format == "NCHW", 2)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    """Channelwise dropout of whole [D, H, W] volumes."""
    return _dropout_nd(x, p, training, data_format == "NCDHW", 3)


def dice_loss(input, label, epsilon=1e-5):  # noqa: A002
    """1 - 2|X ∩ Y| / (|X| + |Y|) over the class axis, averaged: input
    [N, ..., C] probabilities, label ints ([N, ..., 1] or [N, ...])."""
    lab = label.squeeze(-1) if label.shape[-1] == 1 else label
    lab = ops.cast(ops.one_hot(lab, input.shape[-1]), input.dtype)
    dims = list(range(1, input.ndim))
    inter = ops.sum(input * lab, axis=dims)
    union = ops.sum(input, axis=dims) + ops.sum(lab, axis=dims)
    return ops.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


def soft_relu(x, threshold=40.0):
    """log(1 + exp(clip(x, -threshold, threshold)))."""
    return ops.log1p(ops.exp(ops.clip(x, -threshold, threshold)))


def add_position_encoding(x, alpha=1.0, beta=1.0):
    """alpha * x + beta * the sinusoidal encoding (sines of the first half
    of the channels, cosines of the second); x [B, T, D]."""
    _, t, d = x.shape
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32, device=x.device)[:, None]
    div = torch.pow(10000.0, torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = pos / div[None, :]
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if pe.shape[1] < d:
        pe = torch.nn.functional.pad(pe, (0, d - pe.shape[1]))
    return wrap(alpha * x + beta * pe[None].to(x.dtype))


upsample = interpolate


def image_resize(x, out_shape=None, scale=None, resample="BILINEAR",
                 align_corners=True, data_format="NCHW"):
    """The v1 name over ``interpolate`` (TRILINEAR raises KeyError there,
    as in the JAX package)."""
    mode = {"BILINEAR": "bilinear", "NEAREST": "nearest",
            "TRILINEAR": "trilinear"}[resample.upper()]
    return interpolate(x, size=out_shape, scale_factor=scale, mode=mode,
                       data_format=data_format)


def resize_bilinear(x, out_shape=None, scale=None, **kw):
    return image_resize(x, out_shape, scale, "BILINEAR")


def resize_nearest(x, out_shape=None, scale=None, **kw):
    return image_resize(x, out_shape, scale, "NEAREST")


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False):
    """``avg_pool2d`` over a unit height."""
    k = (1, kernel_size if isinstance(kernel_size, int) else kernel_size[0])
    s = (1, (stride if isinstance(stride, int) else
             (stride[0] if stride else k[1])) or k[1])
    p = (0, padding if isinstance(padding, int) else padding[0])
    out = avg_pool2d(ops.unsqueeze(x, [2]), k, stride=s, padding=p,
                     ceil_mode=ceil_mode, exclusive=exclusive)
    return ops.squeeze(out, [2])


def adaptive_avg_pool1d(x, output_size):
    out = adaptive_avg_pool2d(ops.unsqueeze(x, [2]), (1, output_size))
    return ops.squeeze(out, [2])


def adaptive_max_pool1d(x, output_size):
    out = adaptive_max_pool2d(ops.unsqueeze(x, [2]), (1, output_size))
    return ops.squeeze(out, [2])


def unfold_linear(*args, **kwargs):
    """A placeholder of the JAX package's, which raises there too."""
    raise NotImplementedError


@defop
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


@defop
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
        out = _flash_sdpa(query, key, value, attn_mask, scale, is_causal)
    else:
        out = _sdpa(query, key, value, attn_mask, scale, is_causal)
    if dropout_p > 0.0 and training:
        out = dropout(out, p=dropout_p, training=True)
    return out


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


@defop
def _fused_ce_op(hidden, weight, bias, labels, ignore_index):
    return fused_ce(hidden, weight, bias, labels, ignore_index)


@defop
def _ce_head_fallback(hidden, weight, bias, labels, ignore_index):
    return _ce_head_composite(hidden, weight, bias, labels, ignore_index)


def fused_linear_cross_entropy(hidden, weight, bias=None, labels=None,
                               ignore_index=-100, reduction="mean"):
    """Cross-entropy of ``hidden @ weight.T + bias`` against ``labels``
    without materializing the [n_tokens, vocab] logits. hidden [..., H]
    (flattened here), weight [vocab, H], bias [vocab] or None, labels
    [...] int. Per-token losses are f32 and 0 where ignored; "mean"
    divides their sum by max(#valid, 1)."""
    h2 = ops.reshape(hidden, [-1, hidden.shape[-1]])
    y = ops.reshape(labels, [-1])
    if _flags.flag("FLAGS_use_fused_ce"):
        losses = _fused_ce_op(h2, weight, bias, y, int(ignore_index))
    else:
        losses = _ce_head_fallback(h2, weight, bias, y, int(ignore_index))
    if reduction == "none":
        return losses
    total = ops.sum(losses)
    if reduction == "sum":
        return total
    valid = ops.sum(ops.cast(ops.not_equal(y, ignore_index), "float32"))
    one = torch.ones((), dtype=torch.float32, device=valid.device)
    return ops.divide(total, ops.maximum(valid, one))
