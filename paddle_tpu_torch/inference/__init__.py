"""paddle.inference of the port (paddle_tpu/inference): the deployment
Predictor over exported artifacts, and the continuous-batching serve
tier (``serving.py``).

The JAX Predictor runs a StableHLO artifact (``jax.export``); the port's
runs a ``torch.export`` artifact, ``{prefix}.pt2`` beside
``{prefix}.pdinfer.json``, as ``jit.save`` and
``text/models/gpt.export_decode`` write it, on the device the JSON names
(where it was exported). The JAX precedence holds: the ``.pt2``
(``{prefix}.pt2.enc`` when ``encrypt_model`` encrypted it, which needs
``Config.set_cipher_key``; without the key a ``PermissionError``) first,
else the ``.pdmodel`` Program through ``jit.load`` on the current device.
Importing this module registers the kernels' custom ops
(``paddle_tpu_torch::decode_attention``,
``paddle_tpu_torch::flash_attention_fwd``) before any artifact is loaded.
"""
from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from ..ops.cuda import decode_attention as _decode_attention  # noqa: F401
from ..ops.cuda import flash_attention as _flash_attention  # noqa: F401
from .serving import (ServeConfig, ServeLoop, ServeRequest,  # noqa: F401
                      build_decode_step)

__all__ = ["Config", "Predictor", "PredictorTensor", "create_predictor",
           "encrypt_model", "ServeConfig", "ServeLoop", "ServeRequest"]


def encrypt_model(prefix, key):
    """Encrypt the weight-bearing artifact at rest: {prefix}.pt2 ->
    {prefix}.pt2.enc (AES-256-GCM, ``framework/crypto.py``), plaintext
    removed. The metadata (names and shapes only) stays readable."""
    from ..framework.crypto import Cipher
    c = Cipher(key)
    src = prefix + ".pt2"
    c.encrypt_file(src, src + ".enc")
    os.remove(src)


class Config:
    """AnalysisConfig analog: the artifact's path prefix. The GPU / IR
    knobs are accepted for API parity and do nothing."""

    def __init__(self, model_path=None, params_path=None):
        self._prefix = None
        self._cipher_key = None
        if model_path is not None:
            self.set_model(model_path, params_path)
        self._ir_optim = True
        self._glog_info = True

    def set_cipher_key(self, key: bytes):
        """Key for encrypted artifacts (``encrypt_model``)."""
        self._cipher_key = key

    def set_model(self, model_path, params_path=None):
        for suffix in (".pt2", ".stablehlo", ".pdmodel", ".pdinfer.json"):
            if model_path.endswith(suffix):
                model_path = model_path[: -len(suffix)]
                break
        self._prefix = model_path

    def model_path(self):
        return self._prefix

    # -- parity no-ops ------------------------------------------------------
    def enable_use_gpu(self, *a, **k):
        pass

    def disable_gpu(self):
        pass

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def disable_glog_info(self):
        self._glog_info = False

    def enable_memory_optim(self):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass


class PredictorTensor:
    """Zero-copy handle (reference api/paddle_api.h ZeroCopyTensor)."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def copy_from_cpu(self, array):
        self._value = np.asarray(array)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def shape(self):
        return list(np.shape(self._value))


class Predictor:
    """Runs a ``jit.save`` / ``export_decode`` artifact: the
    ``torch.export`` program ({prefix}.pt2, or its encrypted .pt2.enc) on
    the device it was exported for, else the ``.pdmodel`` Program."""

    def __init__(self, config):
        if isinstance(config, str):
            config = Config(config)
        prefix = config.model_path()
        if prefix is None:
            raise ValueError("Config has no model path; call set_model()")
        meta_path = prefix + ".pdinfer.json"
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found: save the model with jit.save (or "
                "text.models.gpt.export_decode) first")
        with open(meta_path) as f:
            self._meta = json.load(f)
        self._input_names = list(self._meta["input_names"])
        self._output_names = list(self._meta["output_names"])
        self._inputs = {n: PredictorTensor(n) for n in self._input_names}
        self._outputs = {n: PredictorTensor(n) for n in self._output_names}
        program = prefix + ".pt2"
        key = config._cipher_key
        self._device = torch.device(self._meta.get("device", "cpu"))
        self._program = self._translated = None
        if os.path.exists(program + ".enc"):
            if key is None:
                raise PermissionError(
                    f"{program}.enc is encrypted; pass the key via "
                    "Config.set_cipher_key")
            from ..framework.crypto import Cipher
            blob = Cipher(key).decrypt_from_file(program + ".enc")
            self._program = torch.export.load(io.BytesIO(blob)).module()
        elif os.path.exists(program):
            self._program = torch.export.load(program).module()
        else:
            from ..jit import load as _jit_load
            self._translated = _jit_load(prefix)

    # -- reference predictor API -------------------------------------------
    def get_input_names(self):
        return list(self._input_names)

    def get_output_names(self):
        return list(self._output_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def run(self, inputs=None):
        """Zero-copy style: stage inputs through the handles, then run();
        or pass a list of arrays positionally (legacy Run)."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        args = [self._inputs[n].copy_to_cpu() for n in self._input_names]
        outs = self._call(args)
        for n, o in zip(self._output_names, outs):
            self._outputs[n].copy_from_cpu(o)
        return [self._outputs[n].copy_to_cpu() for n in self._output_names]

    def _call(self, args):
        if self._translated is not None:
            outs = self._translated(*args)
            outs = outs if isinstance(outs, (tuple, list)) else [outs]
            return [o.numpy() for o in outs]
        dtypes = self._meta.get("input_dtypes")
        targs = [torch.as_tensor(np.array(
            a, dtype=dtypes[i] if dtypes else None)).to(self._device)
            for i, a in enumerate(args)]
        with torch.no_grad():
            outs = self._program(*targs)
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        return [(o.float() if o.dtype == torch.bfloat16 else o).cpu().numpy()
                for o in outs]


def create_predictor(config):
    """reference CreatePaddlePredictor (analysis_predictor.cc:1056)."""
    return Predictor(config)
