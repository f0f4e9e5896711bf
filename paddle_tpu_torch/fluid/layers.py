"""fluid.layers of the port: the v1 functional layer API mapped onto the
2.0 ops and layers (paddle_tpu/fluid/layers.py; reference
python/paddle/fluid/layers/nn.py:181 fc, :389 embedding, loss.py
cross_entropy, tensor.py fill_constant / concat / ..., control_flow).
Layers that create parameters (fc / embedding / conv2d / batch_norm) build
the 2.0 Layer under the hood, so they work the same in dygraph and inside
a static Program being recorded; an unnamed call makes fresh parameters,
a named one reuses the layer of that name and shape."""
from __future__ import annotations

import numpy as np

from .. import ops
from .. import nn as _nn
from ..nn import functional as F

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "dropout",
           "relu", "softmax", "sigmoid", "tanh", "cross_entropy", "mean",
           "reduce_mean", "reduce_sum", "reduce_max", "square", "sqrt",
           "abs", "elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min", "mul",
           "matmul", "concat", "split", "reshape", "transpose", "stack",
           "unsqueeze", "squeeze", "cast", "fill_constant", "zeros",
           "ones", "assign", "shape", "slice", "gather", "scatter",
           "one_hot", "topk", "argmax", "argsort", "accuracy", "auc",
           "l2_normalize", "clip", "clip_by_norm", "label_smooth",
           "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
           "smooth_l1", "log_loss", "lod_reset", "sequence_pool",
           "sequence_softmax", "sequence_expand", "sequence_concat",
           "sequence_reverse", "sequence_pad", "sequence_unpad",
           "increment", "cond", "while_loop"]

_param_layers = {}


def _layer_cached(key, build):
    layer = _param_layers.get(key)
    if layer is None:
        layer = _param_layers[key] = build()
    return layer


def _auto_name(prefix, name):
    """Unnamed v1 layer calls create FRESH parameters per call, named by
    the global unique_name generator exactly like the reference's
    LayerHelper (two anonymous fc() calls are fc_0/fc_1, never shared);
    an explicit name pins and reuses the layer across rebuilds."""
    if name is not None:
        return name
    from ..utils import unique_name
    return unique_name.generate(prefix)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,  # noqa: A002
       act=None, name=None):
    """reference fluid/layers/nn.py:181. Flattens trailing dims, applies a
    Linear (parameters cached per name/shape), optional activation."""
    x = input
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    if len(x.shape) > num_flatten_dims + 1:
        x = ops.reshape(x, list(x.shape[:num_flatten_dims]) + [in_dim])
    name = _auto_name("fc", name)
    layer = _layer_cached(("fc", name, in_dim, size), lambda: _nn.Linear(
        in_dim, size, weight_attr=param_attr, bias_attr=bias_attr))
    out = layer(x)
    if act:
        out = getattr(F, act)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,  # noqa: A002
              param_attr=None, dtype="float32", name=None):
    name = _auto_name("embedding", name)
    layer = _layer_cached(("emb", name, tuple(size)), lambda: _nn.Embedding(
        size[0], size[1], padding_idx=padding_idx, sparse=is_sparse,
        weight_attr=param_attr))
    return layer(input)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,  # noqa: A002
           dilation=1, groups=1, param_attr=None, bias_attr=None, act=None,
           name=None):
    cin = input.shape[1]
    name = _auto_name("conv2d", name)
    layer = _layer_cached(
        ("conv2d", name, cin, num_filters, filter_size),
        lambda: _nn.Conv2D(cin, num_filters, filter_size, stride=stride,
                           padding=padding, dilation=dilation,
                           groups=groups, weight_attr=param_attr,
                           bias_attr=bias_attr))
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1,  # noqa: A002
           pool_padding=0, global_pooling=False, ceil_mode=False):
    if global_pooling:
        pool_size = input.shape[2:]
        pool_stride = pool_size
    if pool_type == "max":
        return F.max_pool2d(input, pool_size, stride=pool_stride,
                            padding=pool_padding, ceil_mode=ceil_mode)
    return F.avg_pool2d(input, pool_size, stride=pool_stride,
                        padding=pool_padding, ceil_mode=ceil_mode)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5,  # noqa: A002
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test=False, name=None):
    c = input.shape[1]
    name = _auto_name("batch_norm", name)
    layer = _layer_cached(("bn", name, c), lambda: _nn.BatchNorm(
        c, momentum=momentum, epsilon=epsilon, weight_attr=param_attr,
        bias_attr=bias_attr, data_format=data_layout))
    if is_test:
        layer.eval()
    out = layer(input)
    if act:
        out = getattr(F, act)(out)
    return out


def dropout(x, dropout_prob=0.5, is_test=False, seed=None):
    return F.dropout(x, p=dropout_prob, training=not is_test)


# -- pure-op aliases -------------------------------------------------------

def _alias(fn):
    return fn


relu = _alias(lambda x: F.relu(x))
softmax = _alias(lambda x, axis=-1: F.softmax(x, axis=axis))
sigmoid = _alias(lambda x: F.sigmoid(x))
tanh = _alias(lambda x: ops.tanh(x))
mean = _alias(lambda x: ops.mean(x))
reduce_mean = _alias(lambda x, dim=None, keep_dim=False:
                     ops.mean(x, axis=dim, keepdim=keep_dim))
reduce_sum = _alias(lambda x, dim=None, keep_dim=False:
                    ops.sum(x, axis=dim, keepdim=keep_dim))
reduce_max = _alias(lambda x, dim=None, keep_dim=False:
                    ops.max(x, axis=dim, keepdim=keep_dim))
square = _alias(lambda x: ops.square(x))
sqrt = _alias(lambda x: ops.sqrt(x))
abs = _alias(lambda x: ops.abs(x))  # noqa: A001
def _elementwise(op):
    """v1 elementwise semantics (reference fluid/layers/nn.py
    elementwise_add: axis aligns y's dims starting at x dim `axis`, act
    applies an activation to the result). axis=-1 means trailing-aligned
    numpy broadcasting; otherwise y is reshaped with trailing singleton
    dims so it broadcasts from dim `axis`."""
    def f(x, y, axis=-1, act=None, name=None):
        xnd = len(x.shape)
        ynd = len(y.shape)
        if axis not in (-1, xnd - 1) and ynd < xnd:
            if axis < 0 or axis + ynd > xnd:
                raise ValueError(
                    f"elementwise axis={axis} invalid for x.ndim={xnd}, "
                    f"y.ndim={ynd}")
            y = ops.reshape(y, list(y.shape) + [1] * (xnd - axis - ynd))
        out = op(x, y)
        if act is not None:
            out = getattr(F, act)(out)
        return out
    return f


elementwise_add = _elementwise(ops.add)
elementwise_sub = _elementwise(ops.subtract)
elementwise_mul = _elementwise(ops.multiply)
elementwise_div = _elementwise(ops.divide)
elementwise_max = _elementwise(ops.maximum)
elementwise_min = _elementwise(ops.minimum)
mul = _alias(lambda x, y: ops.matmul(x, y))
matmul = _alias(lambda x, y, transpose_x=False, transpose_y=False:
                ops.matmul(x, y, transpose_x=transpose_x,
                           transpose_y=transpose_y))
concat = _alias(lambda input, axis=0: ops.concat(input, axis=axis))  # noqa: A002
split = _alias(lambda input, num_or_sections, dim=-1:  # noqa: A002
               ops.split(input, num_or_sections, axis=dim))
reshape = _alias(lambda x, shape: ops.reshape(x, shape))
transpose = _alias(lambda x, perm: ops.transpose(x, perm))
stack = _alias(lambda x, axis=0: ops.stack(x, axis=axis))
unsqueeze = _alias(lambda input, axes: ops.unsqueeze(input, axes))  # noqa: A002
squeeze = _alias(lambda input, axes=None: ops.squeeze(input, axes))  # noqa: A002
cast = _alias(lambda x, dtype: x.astype(dtype))
zeros = _alias(lambda shape, dtype="float32": ops.zeros(shape, dtype))
ones = _alias(lambda shape, dtype="float32": ops.ones(shape, dtype))
assign = _alias(lambda input: ops.assign(input))  # noqa: A002
def shape(input):  # noqa: A002
    from ..core.tensor import to_tensor
    return to_tensor(np.asarray(input.shape, "int32"))
slice = _alias(lambda input, axes, starts, ends:  # noqa: A001,A002
               ops.slice(input, axes, starts, ends))
gather = _alias(lambda input, index: ops.gather(input, index))  # noqa: A002
scatter = _alias(lambda input, index, updates, overwrite=True:  # noqa: A002
                 ops.scatter(input, index, updates, overwrite=overwrite))
one_hot = _alias(lambda input, depth: ops.one_hot(input, depth))  # noqa: A002
topk = _alias(lambda input, k: ops.topk(input, k))  # noqa: A002
argmax = _alias(lambda x, axis=-1: ops.argmax(x, axis=axis))
argsort = _alias(lambda x, axis=-1: ops.argsort(x, axis=axis))
accuracy = _alias(lambda input, label, k=1:  # noqa: A002
                  ops.accuracy(input, label, k=k))
auc = _alias(lambda input, label, num_thresholds=200:  # noqa: A002
             ops.auc(input, label, num_thresholds=num_thresholds))
l2_normalize = _alias(lambda x, axis=-1, epsilon=1e-12:
                      ops.l2_normalize(x, axis=axis, epsilon=epsilon))
clip = _alias(lambda x, min, max: ops.clip(x, min, max))  # noqa: A002
clip_by_norm = _alias(lambda x, max_norm: ops.clip_by_norm(x, max_norm))
label_smooth = _alias(lambda label, epsilon=0.1:
                      ops.label_smooth(label, epsilon=epsilon))
log_loss = _alias(lambda input, label, epsilon=1e-4:  # noqa: A002
                  ops.log_loss(input, label, epsilon))
smooth_l1 = _alias(lambda x, y: ops.smooth_l1_loss(x, y, reduction="none"))
softmax_with_cross_entropy = _alias(
    lambda logits, label, soft_label=False:
    ops.softmax_with_cross_entropy(logits, label, soft_label=soft_label))
sigmoid_cross_entropy_with_logits = _alias(
    lambda x, label: F.binary_cross_entropy_with_logits(
        x, label, reduction="none"))


def fill_constant(shape, dtype, value, name=None):  # noqa: A002
    return ops.full(shape, value, dtype)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):  # noqa: A002
    return ops.cross_entropy(input, label, soft_label=soft_label,
                             ignore_index=ignore_index, reduction="none")


def increment(x, value=1.0, in_place=True):
    out = ops.add(x, ops.full_like(x, value))
    if in_place and hasattr(x, "set_value"):
        x.set_value(out)
        return x
    return out


def lod_reset(x, y=None, target_lod=None):
    """reference sequence_ops lod_reset: reattach row_splits."""
    from ..core.ragged import RaggedTensor
    vals = x.values if isinstance(x, RaggedTensor) else x
    if y is not None and isinstance(y, RaggedTensor):
        return RaggedTensor(vals, y.row_splits)
    splits = np.concatenate([[0], np.cumsum(np.asarray(target_lod))])
    return RaggedTensor(vals, splits.astype(np.int32))


# sequence + control-flow re-exports (same implementations)
from ..ops.sequence import (sequence_concat, sequence_expand,  # noqa: E402,F401
                            sequence_pad, sequence_pool, sequence_reverse,
                            sequence_softmax, sequence_unpad)
from ..static.control_flow import cond, while_loop  # noqa: E402,F401
