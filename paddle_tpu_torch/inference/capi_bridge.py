"""The Python side of the C-ABI predictor (paddle_tpu/inference/
capi_bridge.py; reference paddle/fluid/inference/capi/ pd_predictor.cc;
go/paddle/predictor.go and r/ bind the same C surface).

The C library (``_native/src/predictor_capi.c``) embeds CPython and calls
the two functions here. Inputs arrive as read-only memoryviews over the
caller's C buffers, which are the caller's only for the length of the
call, so ``run`` copies each into memory of its own before the
Predictor sees it; outputs go back as contiguous float32 arrays and
shapes, which the library holds (and reads in place through the buffer
protocol) until the next run or the delete.
"""
from __future__ import annotations

import numpy as np

__all__ = ["create", "run"]

_DTYPES = {0: np.float32, 1: np.int32, 2: np.int64}


def create(prefix: str, cipher_key_hex: str = ""):
    """The port's Predictor over the artifact at ``prefix`` (``.pt2``, or
    ``.pt2.enc`` with the AES key in hex)."""
    from . import Config, Predictor
    cfg = Config(prefix)
    if cipher_key_hex:
        cfg.set_cipher_key(bytes.fromhex(cipher_key_hex))
    return Predictor(cfg)


def run(predictor, inputs):
    """inputs: a list of (memoryview, dtype code, shape). Returns a list of
    (C-contiguous float32 array, shape)."""
    args = [np.frombuffer(mv, dtype=_DTYPES[int(code)]).reshape(
        tuple(int(s) for s in shape)).copy() for mv, code, shape in inputs]
    packed = []
    for o in predictor.run(args):
        a = np.ascontiguousarray(o, dtype=np.float32)
        packed.append((a, tuple(int(s) for s in a.shape)))
    return packed
