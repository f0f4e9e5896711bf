"""save / load (paddle_tpu/framework/io.py).

The JAX package's format: one pickle file holding ``{"magic": _MAGIC,
"data": obj}``, where every tensor or array leaf of ``obj`` is an
``_NDArrayLeaf`` around a numpy array; written to a temporary file and
published with an atomic ``os.replace``.

A torch tensor is saved as numpy and loads back as a CPU torch tensor (a
numpy array that was saved as one loads back as numpy). numpy has no
bfloat16, so a bf16 tensor is saved widened to f32 (exact) with its dtype
named on the leaf, and loads back in bf16.

A file written by the JAX package pickles its leaves as
``paddle_tpu.framework.io._NDArrayLeaf``; ``load`` maps that class path
to this module's ``_NDArrayLeaf`` so that reading it imports nothing of
the JAX package. Its bf16 arrays (ml_dtypes) load as bf16 tensors.
"""
from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

__all__ = ["save", "load", "to_numpy"]

_MAGIC = "paddle_tpu.checkpoint.v1"
_JAX_LEAF = ("paddle_tpu.framework.io", "_NDArrayLeaf")


class _NDArrayLeaf:
    """A saved array; ``was_tensor`` says whether it loads as a tensor,
    ``dtype`` names the tensor's dtype where numpy cannot hold it."""

    __slots__ = ("array", "was_tensor", "dtype")

    def __init__(self, array, was_tensor, dtype=None):
        self.array = array
        self.was_tensor = was_tensor
        self.dtype = dtype


def to_numpy(x):
    """Host numpy of a tensor (bf16 widened to f32, which numpy lacks)
    or of anything ``np.asarray`` takes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        dtype = "bfloat16" if obj.dtype == torch.bfloat16 else None
        return _NDArrayLeaf(to_numpy(obj).copy(), True, dtype)
    if isinstance(obj, (np.ndarray, np.generic)):
        return _NDArrayLeaf(np.asarray(obj), False)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _tensor(arr, dtype=None):
    """A CPU tensor of the numpy array ``arr`` (ml_dtypes bf16 too)."""
    if arr.dtype.name == "bfloat16":
        arr, dtype = arr.astype(np.float32), "bfloat16"
    t = torch.from_numpy(np.array(arr))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, _NDArrayLeaf):
        dtype = getattr(obj, "dtype", None)
        if return_numpy or not obj.was_tensor:
            return obj.array
        return _tensor(obj.array, dtype)
    if isinstance(obj, dict):
        return {k: _from_serializable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_LEAF:
            return _NDArrayLeaf
        return super().find_class(module, name)


def save(obj, path, protocol=4):
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    payload = {"magic": _MAGIC, "data": _to_serializable(obj)}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=protocol)
        os.replace(tmp, path)  # atomic publish
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load(path, return_numpy=False):
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if not (isinstance(payload, dict) and payload.get("magic") == _MAGIC):
        return payload  # foreign pickle; hand back as-is
    return _from_serializable(payload["data"], return_numpy)
