"""paddle.nn.utils (paddle_tpu/nn/utils/__init__.py): the weight
reparameterizations and the parameter utilities.

``weight_norm`` and ``spectral_norm`` replace a layer's parameter by its
pieces and install a forward-pre-hook that recomputes the weight from
them through the port's ops at every call, so autograd carries the
gradient to the pieces. The weight is also computed at once, so a read of
``layer.weight`` before the first call sees it. Every function takes
eager parameters only, as the JAX package's do: a static-graph Variable
(``static.program.Variable``) raises TypeError.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import ops
from ...ops._dispatch import wrap
from ..layer.layers import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _require_eager(p, fn_name):
    from ...static.program import Variable
    if not isinstance(p, torch.Tensor) or isinstance(p, Variable):
        raise TypeError(
            f"nn.utils.{fn_name} operates on eager parameters; got "
            f"{type(p).__name__} — apply the transform to the layer's "
            "parameters before building a static program")


def _norm_except_dim(w, dim):
    if dim is None:
        return torch.sqrt(torch.sum(w * w))
    axes = tuple(i for i in range(w.ndim) if i != dim)
    return torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True))


def weight_norm(layer, name="weight", dim=0):
    """w = g * v / ||v|| (Salimans and Kingma): ``name`` becomes the
    parameters ``{name}_g`` (the norms over every axis but ``dim``, or the
    whole norm for dim None) and ``{name}_v`` (the direction), and the
    hook recomputes ``layer.{name}``."""
    if layer._parameters.get(name) is None:
        raise ValueError(f"layer has no parameter {name!r}")
    _require_eager(layer._parameters[name], "weight_norm")
    w = layer._parameters.pop(name)
    with torch.no_grad():
        g0 = _norm_except_dim(w.detach(), dim)
    layer.add_parameter(name + "_g", Parameter(g0, name=w.name + "_g"))
    layer.add_parameter(name + "_v", Parameter(w.detach().clone(),
                                               name=w.name + "_v"))

    def hook(lyr, inputs):
        g = lyr._parameters[name + "_g"]
        v = lyr._parameters[name + "_v"]
        if dim is None:
            vn = ops.sqrt(ops.sum(v * v))
        else:
            axes = [i for i in range(v.ndim) if i != dim]
            vn = ops.sqrt(ops.sum(v * v, axis=axes, keepdim=True))
        object.__setattr__(lyr, name, g * v / (vn + 1e-12))
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer.__dict__.setdefault("_wn_hooks", {})[name] = (handle, dim)
    hook(layer, ())
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``{name}_g`` and ``{name}_v`` back into one parameter, by the
    hook's formula (so the outputs before and after agree)."""
    hooks = layer.__dict__.get("_wn_hooks", {})
    if name not in hooks:
        raise ValueError(f"{name!r} has no weight_norm applied")
    handle, dim = hooks.pop(name)
    handle.remove()
    g = layer._parameters.pop(name + "_g")
    v = layer._parameters.pop(name + "_v")
    with torch.no_grad():
        w = g * v / (_norm_except_dim(v, dim) + 1e-12)
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w.as_subclass(torch.Tensor)))
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """w / sigma_max(w), sigma estimated by power iteration from the
    buffers ``{name}_u`` / ``{name}_v``, which every call advances and
    keeps. The raw weight becomes the parameter ``{name}_orig``. ``dim``
    defaults to 1 for Linear and the transposed convolutions, else 0.
    The starting u and v are numpy's RandomState(0) draws, as in the JAX
    package, so both start from the same vectors."""
    if layer._parameters.get(name) is None:
        raise ValueError(f"layer has no parameter {name!r}")
    _require_eager(layer._parameters[name], "spectral_norm")
    w = layer._parameters[name]
    if dim is None:
        cls = type(layer).__name__
        dim = 1 if (cls == "Linear" or "Transpose" in cls) else 0
    shape = tuple(w.shape)
    h = shape[dim]
    rest = int(np.prod(shape)) // h
    rng = np.random.RandomState(0)
    u0 = rng.randn(h).astype("float32")
    v0 = rng.randn(rest).astype("float32")
    u0 /= np.linalg.norm(u0) + eps
    v0 /= np.linalg.norm(v0) + eps
    layer.register_buffer(name + "_u", torch.from_numpy(u0).to(w.device))
    layer.register_buffer(name + "_v", torch.from_numpy(v0).to(w.device))
    layer.add_parameter(name + "_orig", layer._parameters.pop(name))
    perm = [dim] + [i for i in range(len(shape)) if i != dim]

    def hook(lyr, inputs):
        worig = lyr._parameters[name + "_orig"]
        u = lyr._buffers[name + "_u"]
        v = lyr._buffers[name + "_v"]
        with torch.no_grad():
            wm = worig.detach().permute(perm).reshape(h, -1).to(u.dtype)
            for _ in range(max(int(n_power_iterations), 1)):
                v = wm.t() @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = wm @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            lyr._buffers[name + "_u"].copy_(u)
            lyr._buffers[name + "_v"].copy_(v)
        wmat = ops.reshape(ops.transpose(worig, perm), [h, -1])
        sigma = ops.sum(wrap(u.clone()) * ops.matmul(wmat, wrap(v.clone())))
        object.__setattr__(lyr, name, worig / (sigma + eps))
        return None

    handle = layer.register_forward_pre_hook(hook)
    layer.__dict__.setdefault("_sn_hooks", {})[name] = handle
    hook(layer, ())
    return layer


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` in place by min(max_norm / (total + 1e-6), 1),
    total the ``norm_type``-norm of all the gradients together. Returns
    the total norm."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return wrap(torch.zeros(()))
    grads = [p.grad for p in params]
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.max(torch.stack([g.abs().max() for g in grads]))
        else:
            total = torch.sum(torch.stack(
                [torch.sum(g.abs().float() ** norm_type)
                 for g in grads])) ** (1.0 / norm_type)
        if error_if_nonfinite and not bool(torch.isfinite(total)):
            raise RuntimeError(
                f"gradient norm is {float(total)}; set "
                "error_if_nonfinite=False to clip anyway")
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for g in grads:
            g.mul_(coef.to(g.dtype))
    return wrap(total)


def clip_grad_value_(parameters, clip_value):
    """Clip every ``.grad`` in place to [-clip_value, clip_value]."""
    cv = abs(float(clip_value))
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad.clamp_(-cv, cv)


def parameters_to_vector(parameters):
    """The parameters flattened into one 1-D tensor, in order."""
    parameters = list(parameters)
    for p in parameters:
        _require_eager(p, "parameters_to_vector")
    if not parameters:
        return wrap(torch.zeros(0))
    return ops.concat([ops.reshape(p, [-1]) for p in parameters], axis=0)


def vector_to_parameters(vec, parameters):
    """Write a flat vector back into the parameters, in order."""
    parameters = list(parameters)
    need = sum(p.numel() for p in parameters)
    if need != vec.numel():
        raise ValueError(f"vector has {vec.numel()} elements; parameters "
                         f"consume {need}")
    off = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            torch.Tensor.copy_(p, vec.detach()[off:off + n].reshape(p.shape))
            off += n
    return parameters
