"""save / load (paddle_tpu/framework/io.py).

The JAX package's format: one pickle file holding ``{"magic": _MAGIC,
"data": obj}``, where every tensor or array leaf of ``obj`` is an
``_NDArrayLeaf`` around a numpy array; written to a temporary file and
published with an atomic ``os.replace``.

A torch tensor is saved as numpy and loads back as a CPU torch tensor (a
numpy array that was saved as one loads back as numpy).

The leaves are written as the JAX package's own two-slot leaf class,
``paddle_tpu.framework.io._NDArrayLeaf`` (``array``, ``was_tensor``), so
the JAX package's plain ``pickle.load`` reads a file of the port. The
pickler writes that class path itself (``_Pickler.save_global``) and
never imports it. numpy has no bfloat16, so a bf16 tensor is saved
widened to f32 (exact, and what the JAX package then reads) and its leaf
is listed in the payload's side entry ``"bfloat16"``, which the JAX
package's ``load`` ignores (it reads ``payload["data"]``); the port's
``load`` gives such a leaf back in bf16.

``load`` maps the JAX class path to this module's ``_NDArrayLeaf``, so
reading a file imports nothing of the JAX package. A JAX file's bf16
arrays (ml_dtypes) load as bf16 tensors; files of the port written
before the leaves took the JAX class path (three slots, the dtype on the
leaf) still load.
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
    """A loaded array; ``was_tensor`` says whether it loads as a tensor,
    ``dtype`` (older files of the port only) names the tensor's dtype
    where numpy cannot hold it."""

    __slots__ = ("array", "was_tensor", "dtype")

    def __init__(self, array, was_tensor, dtype=None):
        self.array = array
        self.was_tensor = was_tensor
        self.dtype = dtype


class _Leaf:
    """A leaf as it is written: the JAX package's two slots, pickled under
    its class path (``_Pickler``)."""

    __slots__ = ("array", "was_tensor")

    def __init__(self, array, was_tensor):
        self.array = array
        self.was_tensor = was_tensor


class _Pickler(pickle._Pickler):
    """The standard pickler but for ``_Leaf``, whose class it writes as
    the JAX package's path without importing it (the C pickler and
    ``pickle._Pickler.save_global`` both import the module of a global to
    check it)."""

    def save_global(self, obj, name=None):
        if obj is not _Leaf:
            return super().save_global(obj, name)
        module, qualname = _JAX_LEAF
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n"
                       .encode("utf-8"))
        self.memoize(obj)


def to_numpy(x):
    """Host numpy of a tensor (bf16 widened to f32, which numpy lacks)
    or of anything ``np.asarray`` takes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _to_serializable(obj, bf16):
    """``obj`` with its tensors and arrays as ``_Leaf``s; the leaves of
    bf16 tensors are appended to ``bf16``."""
    if isinstance(obj, torch.Tensor):
        leaf = _Leaf(to_numpy(obj).copy(), True)
        if obj.dtype == torch.bfloat16:
            bf16.append(leaf)
        return leaf
    if isinstance(obj, (np.ndarray, np.generic)):
        return _Leaf(np.asarray(obj), False)
    if isinstance(obj, dict):
        return {k: _to_serializable(v, bf16) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v, bf16) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _tensor(arr, dtype=None):
    """A CPU tensor of the numpy array ``arr`` (ml_dtypes bf16 too)."""
    if arr.dtype.name == "bfloat16":
        arr, dtype = arr.astype(np.float32), "bfloat16"
    t = torch.from_numpy(np.array(arr))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _from_serializable(obj, return_numpy=False, bf16=frozenset()):
    """The loaded tree; ``bf16`` holds the ids of the leaves listed in the
    payload's ``"bfloat16"`` entry."""
    if isinstance(obj, _NDArrayLeaf):
        dtype = getattr(obj, "dtype", None)
        if id(obj) in bf16:
            dtype = "bfloat16"
        if return_numpy or not obj.was_tensor:
            return obj.array
        return _tensor(obj.array, dtype)
    if isinstance(obj, dict):
        return {k: _from_serializable(v, return_numpy, bf16)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, return_numpy, bf16) for v in obj]
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
    bf16 = []
    payload = {"magic": _MAGIC, "data": _to_serializable(obj, bf16)}
    if bf16:
        payload["bfloat16"] = bf16    # the same leaf objects (memoized)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            _Pickler(f, protocol=protocol).dump(payload)
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
    bf16 = frozenset(id(leaf) for leaf in payload.get("bfloat16", ()))
    return _from_serializable(payload["data"], return_numpy, bf16)
