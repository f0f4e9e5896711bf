"""Layer, Parameter and ParamAttr (paddle_tpu/nn/layer/layers.py).

``Layer`` is a ``torch.nn.Module`` with Paddle's API on top of torch's
machinery: parameters, sublayers and buffers register as torch's do, so
``state_dict``, ``.to()``, ``train()`` / ``eval()``, deep copies and the
forward hooks are torch's, under Paddle's names and signatures:

- ``create_parameter(shape, attr, dtype, is_bias, default_initializer)``:
  Xavier-uniform for a weight and zeros for a bias unless the attr or the
  caller names an initializer, drawn on the CPU from the port's generator
  (``paddle.seed``) and placed on the current device (``device.py``: the
  card unless ``set_device("cpu")``);
- ``add_parameter``, ``add_sublayer``, ``register_buffer(name, tensor,
  persistable)``, ``parameters()`` (a list), ``sublayers``,
  ``named_sublayers``;
- ``register_forward_pre_hook(hook(layer, inputs))`` and
  ``register_forward_post_hook(hook(layer, inputs, output))``: a hook's
  non-None return replaces the inputs or the output;
- ``state_dict()`` and ``set_state_dict(state, use_structured_name)``,
  which takes tensors or numpy arrays and returns (missing, unexpected);
- ``functional_state()`` / ``load_functional_state()``;
- ``to(device="gpu", dtype=...)``, ``astype``, ``full_name``.

In static mode (``paddle.enable_static()``, JAX :133-182)
``create_parameter`` returns a ``static.StaticParam`` whose initial value
is written to the global scope, ``register_buffer`` makes a scope-backed
``Variable``, and ``to(dtype=...)`` casts the scope values. Deep copies of
a layer stack take fresh scope names (``StaticParam.__deepcopy__``).

Assigning a tensor to a parameter's name writes its values into the
parameter, as in the JAX package.
"""
from __future__ import annotations

import itertools
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ... import device as _device
from ...core.dtype import convert_dtype, to_torch_dtype
from ...core.tensor import Tensor
from .. import initializer as I

__all__ = ["Layer", "Parameter", "ParamAttr"]


def _static_mode():
    from ...ops._dispatch import _state
    return _state.static


def _is_static(t):
    from ...static.program import Variable
    return isinstance(t, Variable)

_counters = {}


def _unique(key):
    """``key_N``, N counting up per key (paddle's unique_name)."""
    c = _counters.setdefault(key, itertools.count())
    return f"{key}_{next(c)}"


class Parameter(torch.nn.Parameter, Tensor):
    """A trainable tensor owned by a Layer: a ``torch.nn.Parameter`` and a
    port ``Tensor`` (so ``.grad`` is a ``Tensor``), with Paddle's
    attributes."""

    def __new__(cls, data=None, requires_grad=True, name=None,
                trainable=None, regularizer=None, learning_rate=1.0,
                need_clip=True):
        if trainable is not None:
            requires_grad = bool(trainable)
        if data is None:
            data = torch.empty(0)
        if isinstance(data, Tensor):
            data = data.as_subclass(torch.Tensor)
        return torch.Tensor._make_subclass(cls, data.detach(), requires_grad)

    def __init__(self, data=None, requires_grad=True, name=None,
                 trainable=None, regularizer=None, learning_rate=1.0,
                 need_clip=True):
        self.name = name or _unique("param")
        self._named = name is not None
        self.persistable = True
        self.optimize_attr = {"learning_rate": learning_rate}
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.is_distributed = False

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        out.__dict__.update({k: v for k, v in self.__dict__.items()})
        if not self.__dict__.get("_named", True):
            # a generated name is made anew, so the copies of a layer stack
            # keep distinct names (the JAX package repeats them)
            out.name = _unique("param")
        memo[id(self)] = out
        return out

    def __repr__(self):
        return (f"Parameter(name={self.name}, shape={list(self.shape)}, "
                f"dtype={convert_dtype(self.dtype)}, "
                f"trainable={self.trainable})\n"
                f"{np.array2string(self.numpy())}")


class ParamAttr:
    """Parameter configuration (reference
    python/paddle/fluid/param_attr.py)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"bad ParamAttr spec: {attr!r}")


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype)
        self._full_name = _unique(name_scope or type(self).__name__.lower())

    # -- construction -------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierUniform()
        value = init(shape, dtype or self._dtype)
        if _static_mode():
            from ...static.program import (StaticParam, default_main_program,
                                           global_scope)
            program = default_main_program()
            pname = attr.name or _unique("param")
            sp = StaticParam(shape, value.dtype, name=pname, program=program,
                             trainable=attr.trainable,
                             regularizer=attr.regularizer,
                             learning_rate=attr.learning_rate,
                             need_clip=attr.need_clip,
                             device=_device.resolve_device())
            global_scope().set(pname, value.to(sp.device))
            program.add_persistable(sp)
            return sp
        return Parameter(value.to(_device.resolve_device()), name=attr.name,
                         trainable=attr.trainable,
                         regularizer=attr.regularizer,
                         learning_rate=attr.learning_rate,
                         need_clip=attr.need_clip)

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter, Parameter) \
                and not _is_static(parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor),
                                     device=_device.resolve_device())
        if tensor is not None and _static_mode() and not _is_static(tensor):
            from ...static.program import (Variable, default_main_program,
                                           global_scope)
            program = default_main_program()
            bname = _unique(f"buffer_{name}")
            var = Variable(tensor.shape, tensor.dtype, name=bname,
                           scope_name=bname, program=program,
                           device=tensor.device)
            var.persistable = True
            global_scope().set(bname, torch.Tensor.detach(tensor).clone())
            program.add_persistable(var)
            tensor = var
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    def create_tensor(self, name=None, dtype=None, default_initializer=None):
        init = default_initializer or I.Constant(0.0)
        t = init([1], dtype or self._dtype).to(_device.resolve_device())
        t.__class__ = Tensor
        return t

    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if (params is not None and params.get(name) is not None
                and isinstance(value, torch.Tensor)
                and not isinstance(value, torch.nn.Parameter)):
            params[name].set_value(value)
            return
        super().__setattr__(name, value)

    # -- iteration ----------------------------------------------------------
    # ``recurse`` is torch's name for ``include_sublayers``; torch's own
    # code passes it
    def parameters(self, include_sublayers=True, recurse=None):
        return list(super().parameters(
            recurse=include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, recurse=None):
        return super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return list(super().buffers(
            recurse=include_sublayers if recurse is None else recurse))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, recurse=None):
        return super().named_buffers(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    # -- hooks --------------------------------------------------------------
    def register_forward_pre_hook(self, hook):
        """``hook(layer, inputs)``; a non-None return replaces the inputs."""
        return super().register_forward_pre_hook(hook)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)``; a non-None return replaces the
        output."""
        return super().register_forward_hook(hook)

    # -- state dict ---------------------------------------------------------
    def state_dict(self, *args, include_sublayers=True, use_hook=True,
                   **kwargs):
        """{structured name: tensor} of the parameters and the persistable
        buffers (detached, sharing their storage)."""
        if not include_sublayers:
            out = OrderedDict()
            for n, p in self._parameters.items():
                if p is not None:
                    out[n] = p.detach()
            for n, b in self._buffers.items():
                if b is not None and \
                        n not in self._non_persistent_buffers_set:
                    out[n] = b.detach()
            return out
        return super().state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s values (tensors or numpy arrays) into the
        parameters and buffers in place, each cast to its target's dtype.
        With ``use_structured_name=False`` the keys are the parameters'
        ``name``s. Returns (missing, unexpected) and warns on either."""
        own = self.state_dict(keep_vars=True)
        if not use_structured_name:
            own = OrderedDict((getattr(t, "name", None) or k, t)
                              for k, t in own.items())
        missing, unexpected = [], []
        with torch.no_grad():
            for name, target in own.items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                src = state_dict[name]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src))
                if tuple(src.shape) != tuple(target.shape):
                    raise ValueError(
                        f"shape mismatch for {name}: checkpoint "
                        f"{tuple(src.shape)} vs model {tuple(target.shape)}")
                torch.Tensor.copy_(target, src)
        unexpected = [k for k in state_dict if k not in own]
        if missing:
            warnings.warn(f"missing keys in state_dict: {missing}")
        if unexpected:
            warnings.warn(f"unexpected keys in state_dict: {unexpected}")
        return missing, unexpected

    load_dict = set_state_dict

    # -- functional extraction -----------------------------------------------
    def functional_state(self):
        """({param name: tensor}, {buffer name: tensor}), detached."""
        params = {n: p.detach() for n, p in self.named_parameters()}
        bufs = {n: b.detach() for n, b in self.named_buffers()}
        return params, bufs

    def load_functional_state(self, params=None, buffers=None):
        """Write values into the parameters / buffers of those names, in
        place."""
        with torch.no_grad():
            for store, named in ((params, self.named_parameters()),
                                 (buffers, self.named_buffers())):
                if store is None:
                    continue
                for n, t in named:
                    if n in store:
                        v = store[n]
                        if not isinstance(v, torch.Tensor):
                            v = torch.from_numpy(np.array(v))
                        torch.Tensor.copy_(t, v)
        return self

    # -- dtype / device -------------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None, **kwargs):
        """``to(device="gpu" | "cpu" | ..., dtype=...)``, and torch's forms
        (``to(torch.device)``, ``to(dtype)``, ``to(tensor)``)."""
        if _static_mode():
            return self._static_to(args, dtype)
        args = tuple(_device._parse(a) if isinstance(a, str) else a
                     for a in args)
        if device is not None:
            kwargs["device"] = _device.resolve_device(device)
        if dtype is not None:
            kwargs["dtype"] = to_torch_dtype(dtype)
            self._dtype = convert_dtype(dtype)
        if blocking is not None:
            kwargs["non_blocking"] = not blocking
        return super().to(*args, **kwargs)

    def _static_to(self, args, dtype):
        """``to`` in static mode: a floating dtype casts the scope values
        of the layer's static parameters and buffers (each gets a new
        Variable of that dtype under the same scope name); a device is the
        program's already."""
        from ...static.program import (StaticParam, Variable,
                                       global_scope)
        for a in args:
            if isinstance(a, torch.dtype) or (isinstance(a, str)
                                              and a in ("float16", "bfloat16",
                                                        "float32",
                                                        "float64")):
                dtype = a
        td = to_torch_dtype(dtype)
        if td is None:
            return self
        self._dtype = convert_dtype(dtype)
        scope = global_scope()
        for m in self.modules():
            for store in (m._parameters, m._buffers):
                for k, v in list(store.items()):
                    if not isinstance(v, Variable) or v.scope_name is None \
                            or not v.dtype.is_floating_point or v.dtype == td:
                        continue
                    if isinstance(v, StaticParam):
                        new = StaticParam(
                            v.shape, td, v.scope_name, v.program,
                            trainable=v.trainable, regularizer=v.regularizer,
                            learning_rate=v.optimize_attr["learning_rate"],
                            need_clip=v.need_clip, device=v.device)
                    else:
                        new = Variable(v.shape, td, name=v.name,
                                       scope_name=v.scope_name,
                                       program=v.program, device=v.device)
                        new.persistable = True
                    scope.set(v.scope_name, scope.get(v.scope_name).to(td))
                    v.program.add_persistable(new)
                    store[k] = new
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def full_name(self):
        return self._full_name
