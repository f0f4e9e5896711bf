"""Copy paddle_tpu (JAX) parameters into a port module.

``params`` is a JAX layer's ``functional_state()[0]`` converted to numpy:
``{name: array}`` under the same dotted names the port's modules use
(GPT's ``blocks.{i}.attn.qkv_proj.weight``, ``wte.weight`` ...; BERT's
``encoder.layers.{i}.self_attn.qkv_proj.weight``, ``pooler.dense.weight``,
``mlm_bias`` ...). The name sets must match one to one. The JAX
``Linear`` stores its weight [in, out] and computes ``x @ W``; the port's
``Linear`` stores [out, in]. So every Linear weight, and only those, is
transposed. Embedding tables, LayerNorm vectors and bare parameters
(``mlm_bias``) copy as they are.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params"]


def load_jax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy ``params`` into ``module``'s parameters in place. Raises
    KeyError on a missing or unexpected name and ValueError on a shape
    mismatch."""
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(params))
    unexpected = sorted(set(params) - set(own))
    if missing or unexpected:
        raise KeyError(f"load_jax_params: missing {missing}, "
                       f"unexpected {unexpected}")
    linear_weights = {f"{n}.weight" for n, m in module.named_modules()
                      if isinstance(m, torch.nn.Linear)}
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(params[name])
            if arr.dtype not in (np.float16, np.float32, np.float64):
                arr = arr.astype(np.float32)    # e.g. ml_dtypes bfloat16
            if name in linear_weights:
                arr = arr.T
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"load_jax_params: {name} has shape "
                                 f"{arr.shape}, the port wants "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))   # a writable copy
    return module
