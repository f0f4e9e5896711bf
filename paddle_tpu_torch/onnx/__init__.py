"""paddle.onnx of the port: the model-export surface
(paddle_tpu/onnx/__init__.py; reference python/paddle/onnx/export.py,
which shells into paddle2onnx to emit an ONNX protobuf).

The port's framework-neutral deployment artifact is the ``torch.export``
program that ``jit.save`` writes: ``{path}.pt2`` with ``{path}.pdinfer.json``
(and the ``.pdmodel`` / ``.pdiparams`` Program), which
``inference.Predictor`` and the C, Go and R clients of the C ABI load.
``export`` writes that set and returns its prefix.

An ONNX protobuf additionally needs the ``onnx`` package. Where it
imports, ``export`` also writes ``{path}.onnx``: one custom node whose body
is the serialized ``.pt2`` (as the JAX package carries its StableHLO, and
as paddle2onnx carries custom ops); otherwise it warns.
"""
from __future__ import annotations

import json
import warnings

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=11, **configs):
    """paddle.onnx.export(layer, path, input_spec): ``jit.save`` to the
    prefix (``path`` without a trailing ``.onnx``), plus the ``.onnx``
    wrapper where the ``onnx`` package imports. Returns the prefix."""
    from .. import jit
    prefix = path[:-5] if path.endswith(".onnx") else path
    jit.save(layer, prefix, input_spec=input_spec)
    try:
        import onnx  # noqa: F401
    except ImportError:
        warnings.warn(
            "paddle_tpu_torch.onnx.export wrote the torch.export deployment "
            f"artifact ({prefix}.pt2); writing an ONNX protobuf "
            "additionally requires the optional `onnx` package. Load the "
            ".pt2 artifact with paddle_tpu_torch.inference.Predictor or "
            "the C/Go clients.")
        return prefix
    _write_onnx_wrapper(prefix, opset_version)
    return prefix


def _write_onnx_wrapper(prefix, opset_version):
    import onnx
    from onnx import TensorProto, helper

    with open(prefix + ".pdinfer.json") as f:
        meta = json.load(f)
    with open(prefix + ".pt2", "rb") as f:
        blob = f.read()
    dt_map = {"float32": TensorProto.FLOAT, "int32": TensorProto.INT32,
              "int64": TensorProto.INT64, "bool": TensorProto.BOOL,
              "float16": TensorProto.FLOAT16,
              "bfloat16": TensorProto.BFLOAT16}
    ins = [helper.make_tensor_value_info(n, dt_map.get(d, TensorProto.FLOAT),
                                         None)
           for n, d in zip(meta["input_names"], meta["input_dtypes"])]
    outs = [helper.make_tensor_value_info(n, TensorProto.FLOAT, s)
            for n, s in zip(meta["output_names"], meta["output_shapes"])]
    node = helper.make_node(
        "TorchExportCall", [i.name for i in ins], [o.name for o in outs],
        domain="org.pytorch.export", module=blob)
    graph = helper.make_graph([node], "paddle_tpu_torch_export", ins, outs)
    model = helper.make_model(
        graph, opset_imports=[helper.make_opsetid("", opset_version),
                              helper.make_opsetid("org.pytorch.export", 1)])
    onnx.save(model, prefix + ".onnx")
