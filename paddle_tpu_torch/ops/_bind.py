"""Operators and Paddle methods of ``Tensor`` (paddle_tpu/ops/_bind.py).

Every operator goes through the op of the JAX binding (``x @ w`` through
``matmul``, ``x + y`` through ``add`` ...), so it has the op's AMP cast
point; inside an op's body it is torch's own operator. A method of the
JAX binding that torch.Tensor lacks (``scale``, ``gather_nd`` ...) is the
Paddle op, and so is one that torch has with the same positional meaning
(``x.add(y)``, ``x.mean(1)``, ``x.exp()``). The few whose positional
meaning differs, or that torch's own Python code calls (``_TORCH_FIRST``:
``split``, ``max``, ``sum``, ``reshape`` ...), keep torch's meaning unless
the call says it is a Paddle call: no arguments, a Paddle-only keyword
(``axis=``, ``perm=`` ...), or a Paddle-only first argument
(``transpose([..])``, ``unsqueeze([..])``, ``gather(index)``). Inside an
op's body every method is torch's. ``core/tensor.py`` lists the known
differences this leaves.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from . import activation, creation, linalg, logic, manipulation, math, \
    reduction
from ._dispatch import _state, raw_scope, retype_in_place

_T = torch.Tensor

_BINARY = {
    "__add__": (math.add, False), "__radd__": (math.add, True),
    "__sub__": (math.subtract, False), "__rsub__": (math.subtract, True),
    "__mul__": (math.multiply, False), "__rmul__": (math.multiply, True),
    "__truediv__": (math.divide, False),
    "__rtruediv__": (math.divide, True),
    "__floordiv__": (math.floor_divide, False),
    "__rfloordiv__": (math.floor_divide, True),
    "__mod__": (math.remainder, False), "__rmod__": (math.remainder, True),
    "__pow__": (math.pow, False), "__rpow__": (math.pow, True),
    "__matmul__": (linalg.matmul, False),
    "__rmatmul__": (linalg.matmul, True),
    "__eq__": (logic.equal, False), "__ne__": (logic.not_equal, False),
    "__lt__": (logic.less_than, False), "__le__": (logic.less_equal, False),
    "__gt__": (logic.greater_than, False),
    "__ge__": (logic.greater_equal, False),
    "__and__": (logic.bitwise_and, False), "__or__": (logic.bitwise_or, False),
    "__xor__": (logic.bitwise_xor, False),
}


def _make_binary(name, fn, reflected):
    base = getattr(_T, name)

    def method(self, other):
        if _state.depth:
            return base(self, other)
        return fn(other, self) if reflected else fn(self, other)
    method.__name__ = name
    return method


for _name, (_fn, _refl) in _BINARY.items():
    setattr(Tensor, _name, _make_binary(_name, _fn, _refl))


def _make_unary(name, fn):
    base = getattr(_T, name)

    def method(self):
        return base(self) if _state.depth else fn(self)
    method.__name__ = name
    return method


Tensor.__neg__ = _make_unary("__neg__", math.neg)
Tensor.__abs__ = _make_unary("__abs__", math.abs)
Tensor.__invert__ = _make_unary("__invert__", logic.bitwise_not)


def _getitem(self, idx):
    if _state.depth:
        return _T.__getitem__(self, idx)
    return manipulation.getitem(self, idx)


Tensor.__getitem__ = _getitem


def _setitem(self, idx, value):
    """torch's in-place write; an index with a negative-step slice (which
    torch refuses) writes the whole of the JAX op's result in place."""
    if not _state.depth and manipulation._positive_steps(self, idx)[0]:
        with raw_scope():
            new = manipulation._setitem(self, value, idx=idx)
            _T.copy_(self, new)
        return
    _T.__setitem__(self, idx, value)


Tensor.__setitem__ = _setitem

# the JAX binding's methods (paddle_tpu/ops/_bind.py), less the
# decompositions not ported yet
_METHODS = dict(
    add=math.add, subtract=math.subtract, multiply=math.multiply,
    divide=math.divide, pow=math.pow, abs=math.abs, sign=math.sign,
    exp=math.exp, log=math.log, log2=math.log2, log10=math.log10,
    log1p=math.log1p, sqrt=math.sqrt, rsqrt=math.rsqrt, square=math.square,
    reciprocal=math.reciprocal, sin=math.sin, cos=math.cos, tan=math.tan,
    tanh=math.tanh, floor=math.floor, ceil=math.ceil, round=math.round,
    clip=math.clip, cumsum=math.cumsum, cumprod=math.cumprod,
    scale=math.scale, neg=math.neg, erf=math.erf, lerp=math.lerp,
    maximum=math.maximum, minimum=math.minimum, remainder=math.remainder,
    mod=math.remainder, floor_divide=math.floor_divide, kron=math.kron,
    trunc=math.trunc, frac=math.frac, conj=math.conj, real=math.real,
    imag=math.imag, angle=math.angle, digamma=math.digamma,
    lgamma=math.lgamma, logit=math.logit, isnan=logic.isnan,
    isinf=logic.isinf, isfinite=logic.isfinite,
    sum=reduction.sum, mean=reduction.mean, max=reduction.max,
    min=reduction.min, prod=reduction.prod, std=reduction.std,
    var=reduction.var, argmax=reduction.argmax, argmin=reduction.argmin,
    all=reduction.all, any=reduction.any, logsumexp=reduction.logsumexp,
    amax=reduction.amax, amin=reduction.amin, median=reduction.median,
    quantile=reduction.quantile, count_nonzero=reduction.count_nonzero,
    kthvalue=reduction.kthvalue, nansum=reduction.nansum,
    nanmean=reduction.nanmean,
    reshape=manipulation.reshape, transpose=manipulation.transpose,
    squeeze=manipulation.squeeze, unsqueeze=manipulation.unsqueeze,
    flatten=manipulation.flatten, expand=manipulation.expand,
    expand_as=manipulation.expand_as, broadcast_to=manipulation.broadcast_to,
    tile=manipulation.tile, flip=manipulation.flip, roll=manipulation.roll,
    gather=manipulation.gather, gather_nd=manipulation.gather_nd,
    index_select=manipulation.index_select, scatter=manipulation.scatter,
    scatter_nd_add=manipulation.scatter_nd_add, split=manipulation.split,
    chunk=manipulation.chunk, unbind=manipulation.unbind,
    topk=manipulation.topk, sort=manipulation.sort,
    argsort=manipulation.argsort, unique=manipulation.unique,
    masked_select=manipulation.masked_select,
    masked_fill=manipulation.masked_fill, tril=manipulation._tril,
    triu=manipulation._triu, diagonal=manipulation.diagonal,
    repeat_interleave=manipulation.repeat_interleave,
    take_along_axis=manipulation.take_along_axis,
    put_along_axis=manipulation.put_along_axis, where=manipulation.where,
    moveaxis=manipulation.moveaxis, swapaxes=manipulation.swapaxes,
    nonzero=manipulation.nonzero, bincount=manipulation.bincount,
    matmul=linalg.matmul, dot=linalg.dot, bmm=linalg.bmm, mv=linalg.mv,
    norm=linalg.norm, dist=linalg.dist, t=manipulation.t,
    outer=linalg.outer, inner=linalg.inner, cross=linalg.cross,
    equal=logic.equal, not_equal=logic.not_equal,
    greater_than=logic.greater_than, greater_equal=logic.greater_equal,
    less_than=logic.less_than, less_equal=logic.less_equal,
    logical_and=logic.logical_and, logical_or=logic.logical_or,
    logical_not=logic.logical_not, logical_xor=logic.logical_xor,
    isclose=logic.isclose, allclose=logic.allclose, equal_all=logic.equal_all,
    bitwise_and=logic.bitwise_and, bitwise_or=logic.bitwise_or,
    bitwise_xor=logic.bitwise_xor, bitwise_not=logic.bitwise_not,
    sigmoid=activation.sigmoid, softmax=activation.softmax,
    zeros_like=creation.zeros_like, ones_like=creation.ones_like,
    full_like=creation.full_like,
)

# shared names whose positional calls mean something else in torch (or
# that torch's own code calls with torch's meaning): these stay torch's
# unless a Paddle-only keyword, a Paddle-only first argument or a call
# without arguments says the call is Paddle's. Every other method of the
# binding is the Paddle op.
_TORCH_FIRST = frozenset({
    "split", "chunk", "max", "min", "median", "sort", "sum", "gather",
    "index_select", "scatter", "where", "equal", "allclose", "transpose",
    "squeeze", "unsqueeze", "reshape", "expand", "unique",
})
_PADDLE_KW = frozenset({
    "axis", "perm", "num_or_sections", "repeat_times", "start_axis",
    "stop_axis", "axis1", "axis2", "overwrite", "updates", "bias_after_scale",
    "transpose_x", "transpose_y",
})


def _list_arg(args):
    return bool(args) and isinstance(args[0], (list, tuple))


def _tensor_arg(args):
    return bool(args) and isinstance(args[0], torch.Tensor)


# the Paddle-only first argument of a shared name
_PADDLE_FORM = {
    "transpose": _list_arg, "squeeze": _list_arg, "unsqueeze": _list_arg,
    "reshape": _list_arg, "expand": _list_arg, "gather": _tensor_arg,
    "index_select": _tensor_arg, "scatter": _tensor_arg,
}


def _make_method(name, fn):
    base = getattr(_T, name, None)
    if base is None:
        def method(self, *args, **kwargs):
            return fn(self, *args, **kwargs)
    elif name not in _TORCH_FIRST:
        def method(self, *args, **kwargs):
            if _state.depth:
                return base(self, *args, **kwargs)
            return fn(self, *args, **kwargs)
    else:
        form = _PADDLE_FORM.get(name)

        def method(self, *args, **kwargs):
            if _state.depth:
                return base(self, *args, **kwargs)
            if ((not args and not kwargs)
                    or not _PADDLE_KW.isdisjoint(kwargs)
                    or (form is not None and form(args))):
                return fn(self, *args, **kwargs)
            return retype_in_place(base(self, *args, **kwargs), self)
    method.__name__ = name
    return method


for _name, _fn in _METHODS.items():
    setattr(Tensor, _name, _make_method(_name, _fn))


def _T_prop(self):
    if _state.depth:
        return _T.T.__get__(self)
    return manipulation.t(self)


Tensor.T = property(_T_prop)

