"""Copy paddle_tpu (JAX) parameters and training state into the port.

``params`` is a JAX layer's ``functional_state()[0]`` converted to numpy:
``{name: array}`` under the same dotted names the port's modules use
(GPT's ``blocks.{i}.attn.qkv_proj.weight``, ``wte.weight`` ...; BERT's
``encoder.layers.{i}.self_attn.qkv_proj.weight``, ``pooler.dense.weight``,
``mlm_bias`` ...; a ResNet's ``layer1.0.conv1.weight``,
``layer1.0.bn1._mean`` ...). The name sets must match one to one. Both
packages' ``Linear`` store the weight [in, out] and compute ``x @ W``,
and both packages' conv layers keep OI<spatial> weights (IO<spatial>
for the transposes), so every parameter copies as it is.

``load_jax_optimizer_state`` carries a JAX ``Optimizer.state_dict()``
(every ``"{param}/{slot}"``, ``_step_count``, ``LR_Scheduler``) and a JAX
``GradScaler.state_dict()`` into a port optimizer and scaler, so a run
started in the JAX package resumes in the port.

``load_jax_checkpoint(model, path)`` reads the ``{path}.pdparams`` /
``{path}.pdopt`` pair that the JAX package's ``Model.save(path)`` wrote
(``paddle.save`` files, read by the port's ``framework/io.load`` without
importing the JAX package) into a port ``hapi.Model``: the parameters
through ``load_jax_params``, the optimizer state through
``load_jax_optimizer_state``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["load_jax_params", "load_jax_static_params",
           "load_jax_optimizer_state", "load_jax_checkpoint"]


def load_jax_params(module: torch.nn.Module, params,
                    buffers=None) -> torch.nn.Module:
    """Copy ``params`` into ``module``'s parameters in place, and, given
    ``buffers`` (``functional_state()[1]``: BatchNorm's ``_mean`` /
    ``_variance``, spectral_norm's ``weight_u`` / ``weight_v`` ...), those
    into its buffers. Both are keyed by module path, which is unique where
    the JAX package's ``Parameter.name``s repeat (the deep-copied layers
    of its encoder and decoder stacks). Raises KeyError on a missing or
    unexpected name and ValueError on a shape mismatch."""
    _copy_named("parameter", dict(module.named_parameters()), params)
    if buffers is not None:
        _copy_named("buffer", dict(module.named_buffers()), buffers)
    return module


def load_jax_static_params(module: torch.nn.Module, params,
                           buffers=None) -> torch.nn.Module:
    """Static mode: write ``params`` (and ``buffers``), keyed by module
    path, into the global-scope entries of ``module``'s static parameters
    and buffers (``static.StaticParam`` / scope-backed ``Variable``s), each
    cast to its variable's dtype. The JAX package's static deep copies
    share scope entries across a stack's layers; its values arrive here by
    path all the same. Raises KeyError on a missing or unexpected name."""
    for what, own, values in (
            ("parameter", dict(module.named_parameters()), params),
            ("buffer", dict(module.named_buffers()), buffers)):
        if values is None:
            continue
        missing = sorted(set(own) - set(values))
        extra = sorted(set(values) - set(own))
        if missing or extra:
            raise KeyError(f"static {what}s: missing {missing}, "
                           f"unexpected {extra}")
        for k, var in own.items():
            var.set_value(_f32_array(values[k]))
    return module


def _copy_named(what, own, values):
    missing = sorted(set(own) - set(values))
    unexpected = sorted(set(values) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_jax_params: {what}s missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, t in own.items():
            arr = _f32_array(values[name])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"load_jax_params: {name} has shape "
                                 f"{arr.shape}, the port wants "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr)))   # a writable copy


def _f32_array(value):
    """numpy array of a JAX / numpy value, ml_dtypes bfloat16 as f32."""
    arr = np.asarray(value)
    if arr.dtype not in (np.float16, np.float32, np.float64) and \
            arr.dtype.kind not in "biu":
        arr = arr.astype(np.float32)
    return arr


def load_jax_optimizer_state(opt, state, name_map=None,
                             scaler=None, scaler_state=None):
    """Load the JAX ``Optimizer.state_dict()`` ``state`` into the port
    optimizer ``opt`` (and, given both, the JAX ``GradScaler.state_dict()``
    ``scaler_state`` into the port ``scaler``). ``name_map`` maps the JAX
    optimizer's parameter names to the port's (the same names when
    None). A slot keeps its dtype (bf16 ones as bf16)."""
    out = {}
    for key, value in state.items():
        if key in ("_step_count", "LR_Scheduler") or "/" not in key:
            out[key] = value
            continue
        pname, slot = key.rsplit("/", 1)
        name = (name_map or {}).get(pname, pname)
        raw = np.asarray(value)
        arr = _f32_array(raw)
        tensor = torch.from_numpy(np.array(arr))
        if raw.dtype.name == "bfloat16":
            tensor = tensor.to(torch.bfloat16)
        out[f"{name}/{slot}"] = tensor
    opt.set_state_dict(out)
    if scaler is not None and scaler_state is not None:
        scaler.set_state_dict(scaler_state)
    return opt


def load_jax_checkpoint(model, path):
    """Load the JAX ``Model.save(path)`` files into the port ``Model``
    ``model`` (prepared, where the ``.pdopt`` file is to be read): the
    parameter names must match the network's one to one; buffers of the
    same names are copied as they are; the optimizer state (slots,
    ``_step_count``, the scheduler's state) lands with each slot on its
    parameter's device. Returns ``model``."""
    from .framework.io import load
    net = model.network
    state = load(path + ".pdparams", return_numpy=True)
    buffers = dict(net.named_buffers())
    load_jax_params(net, {k: v for k, v in state.items()
                          if k not in buffers})
    with torch.no_grad():
        for name, b in buffers.items():
            if name in state:
                b.copy_(torch.from_numpy(_f32_array(state[name])))
    opt_path = path + ".pdopt"
    if model._optimizer is not None and os.path.exists(opt_path):
        load_jax_optimizer_state(model._optimizer,
                                 load(opt_path, return_numpy=True))
        model._place_slots()
    return model
