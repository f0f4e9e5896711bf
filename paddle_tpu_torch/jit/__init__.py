"""paddle.jit — dygraph-to-static and model export (paddle_tpu/jit).

``to_static`` converts a function's or a Layer's Python control flow over
tensors (``dy2static.py``) and runs the converted callable **eagerly**
under torch autograd, where the JAX package runs ``jax.jit``: values and
gradients are the same, and nothing is compiled. Its cache keys the
converted callable as the JAX one keys its compilations (arrays by shape
and dtype, other arguments, kwargs included, by value); a Layer's buffers
(BatchNorm's running statistics) update in place as in eager mode.

``save(layer, path, input_spec)`` records the eval forward into a static
Program with the parameters baked in as constants and writes
``{path}.pdmodel`` + ``{path}.pdmodel.npz`` (``framework/program_serde``),
``{path}.pdiparams`` (the state dict) and ``{path}.pdinfer.json``, plus
``{path}.pt2``, a ``torch.export`` of the same eval forward, the port's
counterpart of the JAX ``.stablehlo`` (``inference.Predictor`` prefers
it). Under export the flash forward runs as the custom op
``paddle_tpu_torch::flash_attention_fwd`` (``ops/cuda/flash_attention``),
which ``torch.export`` records and the loaded program launches. A forward
that ``torch.export`` cannot trace (a converted ``if`` / ``while`` on a
tensor, which needs a host read) gets no ``.pt2``; the JSON says why, and
the Predictor then runs the ``.pdmodel``. ``save`` undoes the conversion
it installed. ``load`` returns a ``TranslatedLayer`` that drives the
Executor on the current device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.tensor import Tensor
from ..hapi.model import InputSpec  # noqa: F401
from ..nn.layer.layers import Layer

__all__ = ["to_static", "save", "load", "TranslatedLayer", "not_to_static",
           "ignore_module", "StaticFunction"]


class StaticFunction:
    """Converted wrapper over a dygraph callable (reference
    program_translator.py StaticFunction)."""

    def __init__(self, function, input_spec=None):
        from .dy2static import convert_function, convert_layer
        if isinstance(function, Layer):
            self._layer = convert_layer(function)
            self._fn = function
        else:
            self._layer = None
            self._fn = convert_function(function)
        self._input_spec = input_spec
        self._compiled = {}

    @staticmethod
    def _is_arraylike(v):
        return isinstance(v, (torch.Tensor, np.ndarray))

    def _key(self, args, kw_tree, kw_leaves):
        def one(a):
            if self._is_arraylike(a):
                return ("arr", tuple(a.shape), str(a.dtype))
            try:
                hash(a)
                return ("lit", a)
            except TypeError:
                return ("lit", repr(a))
        return (tuple(one(a) for a in args), str(kw_tree),
                tuple(one(v) for v in kw_leaves))

    def __call__(self, *args, **kwargs):
        kw_leaves, kw_tree = pytree.tree_flatten(kwargs)
        key = self._key(args, kw_tree, kw_leaves)
        target = self._compiled.get(key)
        if target is None:
            target = self._layer if self._layer is not None else self._fn
            self._compiled[key] = target
        return target(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._fn, item)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None):
    if function is None:
        def deco(fn):
            return StaticFunction(fn, input_spec)
        return deco
    return StaticFunction(function, input_spec)


def not_to_static(fn):
    return fn


def ignore_module(modules):
    pass


class TranslatedLayer(Layer):
    """A loaded inference program (reference dygraph/io.py
    TranslatedLayer), run by an Executor on the current device."""

    def __init__(self, program, feed_names):
        super().__init__()
        self._program = program
        self._feed_names = feed_names
        from ..static.executor import Executor
        self._exe = Executor()

    def forward(self, *args):
        feed = dict(zip(self._feed_names, args))
        fetch = self._program._jit_fetch_vars
        outs = self._exe.run(self._program, feed=feed, fetch_list=fetch,
                             return_numpy=False)
        outs = [o.as_subclass(Tensor) for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)


def _spec_shape(spec):
    return [1 if (s is None or s == -1) else int(s) for s in spec.shape]


def _spec_dtype(spec):
    from ..core.dtype import convert_dtype
    return convert_dtype(spec.dtype)


def save(layer, path, input_spec=None, **configs):
    """Record ``layer``'s eval forward (parameters baked in) and write the
    artifacts listed in the module docstring."""
    from .. import static as static_mod
    from ..core import tape as _tape
    from ..framework.io import save as _save
    from ..framework.program_serde import save_program
    from ..static.program import Program, program_guard

    if isinstance(layer, StaticFunction):
        input_spec = input_spec or layer._input_spec
        if layer._layer is None:
            raise TypeError(
                "jit.save needs a Layer (or to_static-wrapped Layer); "
                "plain functions have no parameters to export — wrap the "
                "function in a Layer or save its outputs instead")
        layer = layer._layer
    if input_spec is None:
        raise ValueError("jit.save requires input_spec on first save")

    from .dy2static import convert_layer
    installed = []
    was_static = static_mod.in_static_mode()
    try:
        convert_layer(layer, installed=installed)
        was_training = layer.training
        layer.eval()
        program = Program("inference")
        static_mod.enable_static_()
        try:
            with program_guard(program):
                feeds = [static_mod.data(spec.name or f"x{i}",
                                         _spec_shape(spec),
                                         _spec_dtype(spec))
                         for i, spec in enumerate(input_spec)]
                with _tape.no_grad():
                    out = layer(*feeds)
        finally:
            if not was_static:
                static_mod.disable_static_()
            if was_training:
                layer.train()
        outs = out if isinstance(out, (tuple, list)) else [out]
        program._jit_fetch_vars = list(outs)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        feed_names = [v.name for v in feeds]
        save_program(program, path, feed_names=feed_names)
        _save(layer.state_dict(), path + ".pdiparams")
        _export_pt2(layer, input_spec, feed_names, path)
    finally:
        # export must not permanently change the caller's model
        for lyr in installed:
            lyr.__dict__.pop("forward", None)


class _EvalForward(torch.nn.Module):
    """The layer's forward with a tuple of outputs, for torch.export."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *xs):
        out = self.layer(*xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _export_pt2(layer, input_spec, feed_names, path):
    """``torch.export`` of the eval forward, parameters baked in, to
    ``{path}.pt2``, and the ``{path}.pdinfer.json`` the Predictor reads;
    a symbolic batch dim where the spec left it open, if the trace allows
    it."""
    from ..core.dtype import to_torch_dtype
    device = next((p.device for p in layer.parameters()),
                  torch.device("cpu"))
    open_batch = [bool(s.shape) and s.shape[0] in (None, -1)
                  for s in input_spec]
    # an open batch is traced at 2: export specializes a size-1 dim
    example = tuple(torch.zeros([2] + _spec_shape(s)[1:] if o
                                else _spec_shape(s),
                                dtype=to_torch_dtype(_spec_dtype(s)),
                                device=device)
                    for s, o in zip(input_spec, open_batch))
    module = _EvalForward(layer)
    was_training = layer.training
    layer.eval()
    exported, reason = None, None
    try:
        with torch.no_grad():
            if any(open_batch):
                batch = torch.export.Dim("batch")
                dyn = tuple({0: batch} if o else None for o in open_batch)
                try:
                    exported = torch.export.export(
                        module, example, dynamic_shapes=(dyn,),
                        strict=False)
                except Exception:
                    exported = None
            if exported is None:
                exported = torch.export.export(module, example,
                                               strict=False)
    except Exception as e:  # a host read (converted control flow)
        exported, reason = None, f"{type(e).__name__}: {e}"[:500]
    finally:
        if was_training:
            layer.train()
    meta = {"input_names": list(feed_names),
            "input_dtypes": [_spec_dtype(s) for s in input_spec],
            "format": "pt2+torch.export",
            "device": device.type}
    if exported is not None:
        torch.export.save(exported, path + ".pt2")
        outs = [n for n in exported.graph.nodes if n.op == "output"][0]
        vals = outs.args[0]
        meta["output_names"] = [f"fetch_{i}" for i in range(len(vals))]
        meta["output_shapes"] = [
            [int(d) if isinstance(d, int) else None
             for d in v.meta["val"].shape] for v in vals]
    else:
        if os.path.exists(path + ".pt2"):
            os.remove(path + ".pt2")
        with open(path + ".pdmodel") as f:
            n_out = len(json.load(f)["fetch_ids"])
        meta["output_names"] = [f"fetch_{i}" for i in range(n_out)]
        meta["pt2_skipped"] = reason
    with open(path + ".pdinfer.json", "w") as f:
        json.dump(meta, f)


def load(path, **configs):
    """The ``.pdmodel`` artifact at ``path`` as a ``TranslatedLayer``."""
    from ..framework.program_serde import load_program
    program, feed_names = load_program(path)
    return TranslatedLayer(program, feed_names)
