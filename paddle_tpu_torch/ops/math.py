"""Elementwise and scalar math ops (paddle_tpu/ops/math.py), plus
``addmm`` (paddle_tpu/ops/math_extra.py), the fused form of ``linear``.

One torch call per op where torch has it; where the JAX op is a formula
(``lerp``, ``logit``, ``frac`` ...) the same formula. A Python scalar on
either side of a binary op takes torch's wrapped-number promotion (the
tensor's dtype), as a weak-typed scalar does in jnp.
"""
from __future__ import annotations

import torch

from ._dispatch import defop
from ..core.dtype import as_float, to_torch_dtype

__all__ = ["add", "subtract", "multiply", "divide", "floor_divide",
           "remainder", "mod", "pow", "maximum", "minimum", "fmax", "fmin",
           "scale", "neg", "abs", "sign", "exp", "expm1", "log", "log2",
           "log10", "log1p", "sqrt", "rsqrt", "square", "reciprocal", "sin",
           "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
           "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "floor",
           "ceil", "round", "trunc", "clip", "lerp", "cumsum", "cumprod",
           "logcumsumexp", "logaddexp", "logit", "digamma", "lgamma",
           "multiply_no_nan", "stanh", "cast", "increment", "kron", "diff",
           "angle", "conj", "real", "imag", "frac", "rad2deg", "deg2rad",
           "gcd", "lcm", "heaviside", "nan_to_num", "assign", "addmm"]

_T = torch.Tensor


def _t(v, like):
    """``v`` as a tensor beside ``like`` (a 0-d one for a Python scalar)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=like.dtype if isinstance(
        v, float) and like.is_floating_point() else None).to(like.device)


@defop
def add(x, y):
    return torch.add(x, y) if isinstance(x, torch.Tensor) \
        else torch.add(y, x)


@defop
def subtract(x, y):
    return torch.sub(x, y) if isinstance(x, torch.Tensor) \
        else torch.rsub(y, x)


@defop
def multiply(x, y):
    return torch.mul(x, y) if isinstance(x, torch.Tensor) \
        else torch.mul(y, x)


@defop
def divide(x, y):
    return torch.div(x, y) if isinstance(x, torch.Tensor) \
        else _T.__rtruediv__(y, x)


@defop
def floor_divide(x, y):
    return torch.floor_divide(x, y) if isinstance(x, torch.Tensor) \
        else _T.__rfloordiv__(y, x)


@defop
def remainder(x, y):
    return torch.remainder(x, y)


mod = remainder


@defop
def pow(x, y):  # noqa: A001 - paddle API name
    return torch.pow(x, y)


@defop
def maximum(x, y):
    if not isinstance(y, torch.Tensor):
        return torch.clamp_min(x, y)
    return torch.maximum(_t(x, y), y)


@defop
def minimum(x, y):
    if not isinstance(y, torch.Tensor):
        return torch.clamp_max(x, y)
    return torch.minimum(_t(x, y), y)


@defop
def fmax(x, y):
    return torch.fmax(x, _t(y, x))


@defop
def fmin(x, y):
    return torch.fmin(x, _t(y, x))


@defop
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None):
    if bias_after_scale:
        return torch.add(torch.mul(x, scale), bias)
    return torch.mul(torch.add(x, bias), scale)


@defop
def neg(x):
    return torch.neg(x)


@defop
def abs(x):  # noqa: A001
    return torch.abs(x)


@defop
def sign(x):
    # nan and -0.0 are their own sign, as in jnp (torch gives 0); the
    # kept values carry no gradient, as sign's has none
    keep = torch.eq(x, 0) | torch.isnan(x)
    return torch.where(keep, x.detach(), torch.sign(x))


@defop
def exp(x):
    return torch.exp(x)


@defop
def expm1(x):
    return torch.expm1(x)


@defop
def log(x):
    return torch.log(x)


@defop
def log2(x):
    return torch.log2(x)


@defop
def log10(x):
    return torch.log10(x)


@defop
def log1p(x):
    return torch.log1p(x)


@defop
def sqrt(x):
    return torch.sqrt(x)


@defop
def rsqrt(x):
    return torch.rsqrt(x)


@defop
def square(x):
    return torch.square(x)


@defop
def reciprocal(x):
    return torch.reciprocal(x)


@defop
def sin(x):
    return torch.sin(x)


@defop
def cos(x):
    return torch.cos(x)


@defop
def tan(x):
    return torch.tan(x)


@defop
def asin(x):
    return torch.asin(x)


@defop
def acos(x):
    return torch.acos(x)


@defop
def atan(x):
    return torch.atan(x)


@defop
def atan2(x, y):
    return torch.atan2(x, y)


@defop
def sinh(x):
    return torch.sinh(x)


@defop
def cosh(x):
    return torch.cosh(x)


@defop
def tanh(x):
    return torch.tanh(x)


@defop
def asinh(x):
    return torch.asinh(x)


@defop
def acosh(x):
    return torch.acosh(x)


@defop
def atanh(x):
    return torch.atanh(x)


@defop
def erf(x):
    return torch.erf(x)


@defop
def erfinv(x):
    return torch.erfinv(x)


@defop
def floor(x):
    return torch.floor(x)


@defop
def ceil(x):
    return torch.ceil(x)


@defop
def round(x):  # noqa: A001
    return torch.round(x)


@defop
def trunc(x):
    return torch.trunc(x)


@defop
def clip(x, min=None, max=None):  # noqa: A002
    if min is None and max is None:
        return torch.clone(x)
    return torch.clamp(x, min, max)


@defop
def lerp(x, y, weight):
    return torch.add(x, torch.mul(weight, torch.sub(y, x)))


def _int_keep(x):
    """The dtype a running sum or product keeps: an integer input's own
    (torch widens it to int64, jnp keeps it); None for the rest."""
    return x.dtype if x.dtype in (torch.int8, torch.int16, torch.int32,
                                  torch.uint8) else None


def _flat_axis(x, axis):
    if axis is None:
        return torch.reshape(x, (-1,)), 0
    return x, int(axis)


@defop
def cumsum(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, axis, dtype=_int_keep(x))


@defop
def cumprod(x, dim=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim, dtype=_int_keep(x))


@defop
def logcumsumexp(x, axis=None):
    x, axis = _flat_axis(x, axis)
    return torch.logcumsumexp(x, axis)


@defop
def logaddexp(x, y):
    x = as_float(x)
    return torch.logaddexp(x, as_float(_t(y, x)))


@defop
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(torch.div(x, torch.rsub(x, 1.0)))


@defop
def digamma(x):
    # jnp's digamma is nan at 0 and -0.0, where torch's is -inf / inf
    out = torch.digamma(x)
    return torch.where(torch.eq(x, 0), torch.nan, out)


@defop
def lgamma(x):
    return torch.lgamma(x)


@defop
def multiply_no_nan(x, y):
    x = as_float(x)
    return torch.where(torch.eq(y, 0), torch.zeros((), dtype=x.dtype,
                                                   device=x.device),
                       torch.mul(x, y))


@defop
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return torch.mul(torch.tanh(torch.mul(x, scale_a)), scale_b)


@defop
def cast(x, dtype):
    dt = to_torch_dtype(dtype)
    if not (x.is_floating_point() and dt in _SATURATE):
        return x.to(dt)
    # float -> narrower integer saturates as XLA's convert does: nan -> 0,
    # values past the range (inf too) -> its bound; torch wraps instead
    info = torch.iinfo(dt)
    hi, lo = torch.ge(x, info.max), torch.le(x, info.min)
    safe = torch.where(hi | lo | torch.isnan(x), 0, x.detach())
    out = safe.to(dt)
    out = torch.where(hi, torch.tensor(info.max, dtype=dt, device=x.device),
                      out)
    return torch.where(lo, torch.tensor(info.min, dtype=dt, device=x.device),
                       out)


_SATURATE = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


@defop
def increment(x, value=1.0):
    return torch.add(x, value)


@defop
def kron(x, y):
    return torch.kron(x, y)


@defop
def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


@defop
def angle(x):
    if x.is_complex():
        return torch.angle(x)
    # jnp's angle is atan2(0, x): pi for -0.0 too (torch gives 0)
    x = as_float(x)
    out = torch.where(torch.signbit(x), torch.pi, 0.0).to(x.dtype)
    return torch.where(torch.isnan(x), x, out)


@defop
def conj(x):
    return torch.conj(x)


@defop
def real(x):
    return torch.real(x)


@defop
def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


@defop
def frac(x):
    return torch.sub(x, torch.trunc(x))


@defop
def rad2deg(x):
    return torch.rad2deg(x)


@defop
def deg2rad(x):
    return torch.deg2rad(x)


@defop
def gcd(x, y):
    return torch.gcd(x, y)


@defop
def lcm(x, y):
    return torch.lcm(x, y)


@defop
def heaviside(x, y):
    x = as_float(x)
    return torch.heaviside(x, as_float(_t(y, x)).to(x.dtype))


@defop
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@defop
def assign(x):
    if isinstance(x, torch.Tensor):
        return torch.clone(x)
    return torch.as_tensor(x)


@defop
def addmm(input, x, y, beta=1.0, alpha=1.0):  # noqa: A002
    """beta * input + alpha * (x @ y). A 2-d y and an input that
    broadcasts over x's rows take one GEMM with the add in its epilogue
    (x's leading axes flattened, no copy for a contiguous x); y may be a
    transposed view, which cuBLAS reads without a copy."""
    if y.ndim == 2 and x.ndim >= 2 and input.ndim <= 1:
        lead = x.shape[:-1]
        out = torch.addmm(input, torch.reshape(x, (-1, x.shape[-1])), y,
                          beta=beta, alpha=alpha)
        return torch.reshape(out, (*lead, y.shape[-1]))
    return torch.add(torch.mul(input, beta),
                     torch.mul(torch.matmul(x, y), alpha))
