"""Top-level v1 / compat names (paddle_tpu/_legacy_api.py): the fluid-era
tensor functions and config helpers that have a 2.0 equivalent, each over
the port's ops. Imported at the bottom of ``paddle_tpu_torch/__init__``.

``LoDTensor`` (the JAX package's RaggedTensor) waits for ``core/ragged``
(ROADMAP Queue 1 item 9). ``get_tensor_from_selected_rows`` returns a
dense tensor as it is: the port has no SelectedRows yet (item 9).
``set_default_dtype`` records the name, which, as in the JAX package, no
other function reads.
"""
from __future__ import annotations

import numpy as _np
import torch as _torch

from . import ops as _ops
from .core.tensor import Tensor as _Tensor

__all__ = ["add_n", "mm", "numel", "rank", "shape", "is_tensor",
           "broadcast_shape", "has_inf", "has_nan", "fill_constant",
           "floor_mod", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_pow",
           "elementwise_mod", "elementwise_floordiv", "reduce_sum",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
           "get_default_dtype", "set_default_dtype", "set_printoptions",
           "get_cudnn_version", "is_compiled_with_xpu",
           "create_parameter", "create_global_var",
           "get_tensor_from_selected_rows", "VarBase", "LoDTensorArray"]


def add_n(inputs):
    """The elementwise sum of a list of tensors."""
    xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    out = xs[0]
    for x in xs[1:]:
        out = _ops.add(out, x)
    return out


def mm(input, mat2):  # noqa: A002
    return _ops.matmul(input, mat2)


def numel(x):
    from .core.tensor import to_tensor
    return to_tensor(_np.asarray(int(_np.prod(x.shape)), _np.int64))


def rank(input):  # noqa: A002
    from .core.tensor import to_tensor
    return to_tensor(_np.asarray(len(input.shape), _np.int32))


def shape(input):  # noqa: A002
    from .core.tensor import to_tensor
    return to_tensor(_np.asarray(input.shape, _np.int32))


def is_tensor(x):
    return isinstance(x, _Tensor)


def broadcast_shape(x_shape, y_shape):
    return list(_np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def has_inf(x):
    return _ops.any(_ops.isinf(x))


def has_nan(x):
    return _ops.any(_ops.isnan(x))


def fill_constant(shape, dtype, value, name=None):  # noqa: A002
    return _ops.full(shape, value, dtype)


def floor_mod(x, y):
    return _ops.remainder(x, y)


elementwise_add = _ops.add
elementwise_sub = _ops.subtract
elementwise_mul = _ops.multiply
elementwise_div = _ops.divide
elementwise_pow = _ops.pow
elementwise_mod = _ops.remainder
elementwise_floordiv = _ops.floor_divide


def reduce_sum(x, dim=None, keep_dim=False):
    return _ops.sum(x, axis=dim, keepdim=keep_dim)


def reduce_mean(x, dim=None, keep_dim=False):
    return _ops.mean(x, axis=dim, keepdim=keep_dim)


def reduce_max(x, dim=None, keep_dim=False):
    return _ops.max(x, axis=dim, keepdim=keep_dim)


def reduce_min(x, dim=None, keep_dim=False):
    return _ops.min(x, axis=dim, keepdim=keep_dim)


def reduce_prod(x, dim=None, keep_dim=False):
    return _ops.prod(x, axis=dim, keepdim=keep_dim)


_default_dtype = ["float32"]


def get_default_dtype():
    return _default_dtype[0]


def set_default_dtype(d):
    _default_dtype[0] = d if isinstance(d, str) else str(_np.dtype(d))
    return _default_dtype[0]


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Tensor print options: a Tensor prints through numpy, so these are
    numpy's."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def get_cudnn_version():
    """cuDNN's version as an int (e.g. 90100), None without cuDNN."""
    return _torch.backends.cudnn.version()


def is_compiled_with_xpu():
    return False


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone trainable Parameter on the current device."""
    from .nn.layer.layers import Layer
    return Layer(dtype=dtype).create_parameter(
        list(shape), attr=attr, is_bias=is_bias,
        default_initializer=default_initializer)


def create_global_var(shape, value, dtype, persistable=False, name=None):
    from .core.tensor import to_tensor
    t = to_tensor(_np.full(tuple(shape), value, _np.dtype(dtype)),
                  dtype=dtype)
    t.persistable = persistable
    return t


def get_tensor_from_selected_rows(x):
    return x


VarBase = _Tensor                       # the dygraph-era name for Tensor

LoDTensorArray = list                   # an array of LoD tensors
