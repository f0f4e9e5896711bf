"""Tensor and to_tensor (paddle_tpu/core/tensor.py).

``Tensor`` is a subclass of ``torch.Tensor`` with torch's per-op hook
turned off (``__torch_function__ = torch._C._disabled_torch_function_impl``):
a torch call on it costs what it costs on a plain tensor and returns a
plain tensor. The port's ops return ``Tensor`` (``ops/_dispatch.py``), and
``ops/_bind.py`` gives it Paddle's operators (each through the op of the
same name, with its AMP cast point) and methods. torch autograd is the
tape: ``stop_gradient`` is ``not requires_grad``.

Paddle defaults of ``to_tensor``: Python floats and float64 numpy data
become float32, Python ints int64, int32 stays int32, bool stays bool. The
tensor lands on the current device (``device.get_device``), unless
``place`` names another.

Methods (``ops/_bind.py``): a method of the JAX binding is the Paddle op,
with its cast point, except where torch's positional meaning differs or
torch's own Python code calls the name; those keep torch's meaning unless
the call says it is Paddle's (no arguments, a Paddle-only keyword such as
``axis=``, or a Paddle-only first argument). ``paddle.<op>(x, ...)`` is
always Paddle's. Known differences, each stated by a test in
``tests/test_torch_tensor.py``:

- ``size`` is torch's method (the shape), not Paddle's property (the
  element count); ``numel()`` returns a Python int, not a Tensor;
- ``split(n)`` / ``split(n, dim)``: torch's, n is a section size; with
  ``axis=`` Paddle's, n is a count of sections;
- ``max`` / ``min`` / ``median`` / ``sort`` with a positional axis return
  torch's (values, indices); with ``axis=`` (or no argument) a tensor;
- ``transpose(d0, d1)`` swaps two axes (torch); ``transpose(perm)`` with a
  list permutes (Paddle); ``squeeze`` / ``unsqueeze`` take a list of axes
  (Paddle) or one axis (both);
- ``sum(1, True)`` is torch's keepdim (Paddle's second argument is the
  dtype); ``reshape(2, 3)``, ``view``, ``dim`` are torch's and record no
  cast point; ``gather`` / ``index_select`` / ``scatter`` with an int
  first are torch's (dim first);
- ``where`` is torch's (``x.where(cond, y)``); Paddle's is
  ``paddle.where(cond, x, y)``; ``equal`` / ``allclose`` are torch's
  (one bool), ``paddle.equal`` is elementwise;
- ``__setitem__`` writes in place (torch) where the JAX package rebinds a
  new value; ``detach``, ``clone`` and ``.grad`` return ``Tensor``.

float64: the JAX package runs with x64 on (``paddle_tpu/__init__.py``), so
it returns float64 where the port returns Paddle's default float32, with
the same values: an int tensor with a float scalar, int / int, ``sqrt`` /
``exp`` and the other float functions of an int tensor, a float-argument
``arange``, ``linspace``, ``logspace``, ``one_hot``, and ``increment`` of
an int tensor (``test_known_difference_x64_floats_are_f32_in_the_port``).

``numpy()`` copies a CUDA tensor or one that needs a gradient to the host,
as Paddle does (torch raises); bfloat16 comes back as float32, since numpy
has no bfloat16 here.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dtype as dtypes

__all__ = ["Tensor", "to_tensor"]

_T = torch.Tensor
_grad_get = _T.grad.__get__
_grad_set = _T.grad.__set__


def _coerce(value, dtype=None, device=None):
    """A plain torch tensor of ``value`` on ``device`` in ``dtype``
    (Paddle's defaults where ``dtype`` is None)."""
    td = dtypes.to_torch_dtype(dtype)
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t.to(device=device if device is not None else t.device,
                    dtype=td if td is not None else t.dtype)
    arr = np.asarray(value)
    if arr.dtype.kind not in "biufc":
        if arr.dtype.name == "bfloat16":        # ml_dtypes, where present
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
            return t.to(device=device, dtype=td or torch.bfloat16)
        raise TypeError(f"to_tensor: unsupported data of dtype {arr.dtype}")
    if td is None and arr.dtype == np.float64:
        td = torch.float32                  # Paddle's default float
    t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=td or t.dtype)


class Tensor(torch.Tensor):
    """The port's tensor: a torch tensor with Paddle's attributes."""

    __torch_function__ = torch._C._disabled_torch_function_impl
    name = None
    persistable = False

    # -- autograd flags -----------------------------------------------------
    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        if value == (not self.requires_grad):
            return
        if not self.is_leaf:
            raise RuntimeError(
                "stop_gradient can only change on a leaf tensor; use "
                "detach() for a copy without gradient")
        if not value and not (self.is_floating_point() or self.is_complex()):
            return                  # integer tensors never carry gradient
        self.requires_grad_(not value)

    @property
    def grad(self):
        g = _grad_get(self)
        if g is not None and type(g) is _T:
            g.__class__ = Tensor
        return g

    @grad.setter
    def grad(self, value):
        _grad_set(self, value)

    @grad.deleter
    def grad(self):
        _grad_set(self, None)

    @property
    def place(self):
        from ..device import CPUPlace, CUDAPlace
        if self.device.type == "cpu":
            return CPUPlace()
        return CUDAPlace(self.device.index or 0)

    # -- host access --------------------------------------------------------
    def numpy(self, *args, **kwargs):
        t = _T.detach(self)
        if t.device.type != "cpu":
            t = t.cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return _T.numpy(t)

    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def __repr__(self, *args, **kwargs):
        name = dtypes.convert_dtype(self.dtype)
        return (f"Tensor(shape={list(self.shape)}, dtype={name}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"{np.array2string(self.numpy())})")

    # -- autograd -----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        from . import tape
        tape.backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        _grad_set(self, None)

    clear_gradient = clear_grad

    def detach(self):
        t = _T.detach(self)
        t.__class__ = Tensor
        return t

    def clone(self, *args, **kwargs):
        t = _T.clone(self, *args, **kwargs)
        t.__class__ = Tensor
        return t

    def register_hook(self, hook):
        """``hook(grad) -> new grad | None``, fired when this tensor's
        gradient is computed; returns a handle with ``remove()``."""
        if not self.requires_grad:
            raise RuntimeError(
                "cannot register a gradient hook on a tensor with "
                "stop_gradient=True")
        return _T.register_hook(self, hook)

    # -- value -------------------------------------------------------------
    def set_value(self, value):
        """Overwrite the values in place (same shape; cast to this dtype)."""
        v = _coerce(value, device=self.device)
        if tuple(v.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch {tuple(v.shape)} vs "
                             f"{tuple(self.shape)}")
        with torch.no_grad():
            _T.copy_(self, v)
        return self

    def astype(self, dtype):
        from .. import ops
        return ops.cast(self, dtype)

    cast = astype


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a new Tensor of ``data`` on ``place`` (default:
    the current device), in ``dtype`` (default: Paddle's, see the module
    docstring)."""
    from ..device import resolve_device
    t = _coerce(data, dtype, resolve_device(place))
    if isinstance(data, torch.Tensor) and t.data_ptr() == data.data_ptr():
        t = _T.clone(t)
    t.__class__ = Tensor
    if not stop_gradient:
        t.stop_gradient = False
    return t
