"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` is the reference; this package mirrors its
module paths (``nn/kv_pool.py``, ``text/models/gpt.py``,
``inference/serving.py`` ...) so a reader can find each counterpart. It
imports torch and never jax or paddle_tpu.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``). Every TPU Pallas kernel on a ported path is a CUDA
kernel written by hand (``ops/cuda/csrc``), built with nvcc at first use;
on the CPU the kernels' plain PyTorch versions run instead.
"""
from __future__ import annotations

from .device import resolve_device
from .framework.io import load, save
from .hapi import InputSpec, Model

__all__ = ["resolve_device", "save", "load", "Model", "InputSpec"]
