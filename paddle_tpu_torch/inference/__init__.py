"""paddle.inference of the port (paddle_tpu/inference): the deployment
Predictor over exported artifacts, and the continuous-batching serve
tier (``serving.py``).

The JAX Predictor runs a StableHLO artifact (``jax.export``); the port's
runs a ``torch.export`` artifact, ``{prefix}.pt2`` beside
``{prefix}.pdinfer.json``, as ``text/models/gpt.export_decode`` writes
it, on the device the JSON names (where it was exported). Importing this
module registers the decode kernel's custom op
(``paddle_tpu_torch::decode_attention``) before any artifact is loaded.

Left to ROADMAP Queue 1 item 6 (static graph and jit): artifacts of
``jit.save`` (``.pdmodel`` Programs) and the encrypted ones of
``framework/crypto.py`` (``encrypt_model``, ``Config.set_cipher_key``);
each raises NotImplementedError naming it.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.cuda import decode_attention as _decode_attention  # noqa: F401
from .serving import (ServeConfig, ServeLoop, ServeRequest,  # noqa: F401
                      build_decode_step)

__all__ = ["Config", "Predictor", "PredictorTensor", "create_predictor",
           "encrypt_model", "ServeConfig", "ServeLoop", "ServeRequest"]

_ITEM6 = "ROADMAP Queue 1 item 6 (static graph and jit)"


def encrypt_model(prefix, key):
    """Encrypt an artifact at rest: framework/crypto.py, item 6."""
    raise NotImplementedError(f"encrypt_model needs framework/crypto.py, "
                              f"{_ITEM6}")


class Config:
    """AnalysisConfig analog: the artifact's path prefix. The GPU / IR
    knobs are accepted for API parity and do nothing."""

    def __init__(self, model_path=None, params_path=None):
        self._prefix = None
        if model_path is not None:
            self.set_model(model_path, params_path)
        self._ir_optim = True
        self._glog_info = True

    def set_cipher_key(self, key: bytes):
        raise NotImplementedError(f"encrypted artifacts need "
                                  f"framework/crypto.py, {_ITEM6}")

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
    """Runs a ``torch.export`` artifact ({prefix}.pt2 and its
    {prefix}.pdinfer.json) on the device it was exported for."""

    def __init__(self, config):
        if isinstance(config, str):
            config = Config(config)
        prefix = config.model_path()
        if prefix is None:
            raise ValueError("Config has no model path; call set_model()")
        meta_path = prefix + ".pdinfer.json"
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found: export the model with "
                "text.models.gpt.export_decode first")
        with open(meta_path) as f:
            self._meta = json.load(f)
        self._input_names = list(self._meta["input_names"])
        self._output_names = list(self._meta["output_names"])
        self._inputs = {n: PredictorTensor(n) for n in self._input_names}
        self._outputs = {n: PredictorTensor(n) for n in self._output_names}
        program = prefix + ".pt2"
        if not os.path.exists(program):
            raise NotImplementedError(
                f"{program} not found; artifacts of jit.save (.pdmodel) "
                f"and encrypted ones are {_ITEM6}")
        self._device = torch.device(self._meta.get("device", "cpu"))
        self._program = torch.export.load(program).module()

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
        dtypes = self._meta.get("input_dtypes")
        targs = [torch.as_tensor(np.array(
            a, dtype=dtypes[i] if dtypes else None)).to(self._device)
            for i, a in enumerate(args)]
        with torch.no_grad():
            outs = self._program(*targs)
        outs = outs if isinstance(outs, (tuple, list)) else [outs]
        return [o.cpu().numpy() for o in outs]


def create_predictor(config):
    """reference CreatePaddlePredictor (analysis_predictor.cc:1056)."""
    return Predictor(config)
