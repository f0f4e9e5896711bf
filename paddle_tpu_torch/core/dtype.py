"""Dtype registry (paddle_tpu/core/dtype.py).

Paddle's dtype names map to torch dtypes, and the names are the torch
objects themselves: ``paddle_tpu_torch.float32 is torch.float32``. A dtype
spec may be a name ("float32"), a torch dtype, a numpy dtype or a numpy
scalar type; ``convert_dtype`` gives its canonical name and
``to_torch_dtype`` its torch dtype.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "to_torch_dtype", "is_floating", "is_integer",
           "as_float"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
}
_DTYPE_TO_NAME = {v: k for k, v in _NAME_TO_DTYPE.items()}

FLOATING = {"float16", "bfloat16", "float32", "float64"}
INTEGER = {"uint8", "int8", "int16", "int32", "int64"}


def convert_dtype(dtype):
    """Normalize any dtype spec to its canonical name (None stays None)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        if dtype in _NAME_TO_DTYPE:
            return dtype
        raise TypeError(f"unsupported dtype string: {dtype!r}")
    if isinstance(dtype, torch.dtype):
        if dtype in _DTYPE_TO_NAME:
            return _DTYPE_TO_NAME[dtype]
        raise TypeError(f"unsupported dtype: {dtype!r}")
    name = np.dtype(dtype).name
    if name in _NAME_TO_DTYPE:
        return name
    raise TypeError(f"unsupported dtype: {dtype!r}")


def to_torch_dtype(dtype):
    """Any dtype spec -> torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _NAME_TO_DTYPE[convert_dtype(dtype)]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in INTEGER


def as_float(x):
    """``x`` itself when it is floating or complex, else ``x`` as float32:
    where jnp promotes an integer or bool input to its default float (a
    mean, a softmax, a heaviside), the port promotes to Paddle's default
    float32 (the JAX package runs with x64 and gives float64; ROADMAP
    Queue 3 D)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float32)
