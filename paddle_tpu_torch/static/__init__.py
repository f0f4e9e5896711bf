"""paddle.static — static graph mode (paddle_tpu/static).

Build a Program under ``paddle.enable_static()`` and ``program_guard``,
train and serve it through ``Executor.run``::

    paddle.enable_static()
    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [-1, 4], "float32")
        loss = paddle.mean(nn.Linear(4, 1)(x))
        optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = static.Executor()
    (lv,) = exe.run(main, feed={"x": xv}, fetch_list=[loss])

``program.py`` holds the Program and its ``Variable``s, ``executor.py``
the replay on the device, ``shape_infer.py`` the abstract shapes,
``amp.py`` program-level AMP, ``control_flow.py`` ``cond`` /
``while_loop``, ``verifier.py`` / ``passes.py`` the structural checks and
rewrites; ``pipeline_runner.py`` the ``PipelineRunner`` (in-flight
steps, the carry kept on the device, scan-fused megasteps) and the
serve loop's window, ``capi_train.py`` the training artifact of the C
ABI trainer.

Values computed at record time are baked into the Program, as in the JAX
package: a ``data`` dim given as -1 (or None) records as 1, and a constant
that layer code derives from a shape while the program is built (a
position range of ``x.shape[1]``, a reshape target) keeps the recorded
value. The Executor re-keys its cache on the fed shapes, so a feed of
another size replays the same ops; ops whose constants came from the -1
dim need the program built at the size they will be fed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hapi.model import InputSpec  # noqa: F401
from . import amp  # noqa: F401
from .executor import (BuildStrategy, CompiledProgram,  # noqa: F401
                       ExecutionStrategy, Executor)
from .pipeline_runner import (FetchHandle, InflightDriver,  # noqa: F401
                              PipelineRunner, PipelineStepError,
                              StagedPipelineRunner)
from .program import (Program, StaticParam, Variable,  # noqa: F401
                      default_main_program, default_startup_program,
                      disable_static_, enable_static_, global_scope,
                      in_static_mode, name_scope, program_guard)
from .shape_infer import (ShapeInferError, analyze_memory,  # noqa: F401
                          infer_program, register_infer_rule)
from .verifier import ProgramVerifyError, verify_program  # noqa: F401

__all__ = ["data", "InputSpec", "Program", "Variable", "Executor",
           "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
           "program_guard", "name_scope", "default_main_program",
           "default_startup_program", "global_scope", "append_backward",
           "gradients", "save", "load", "set_program_state", "nn",
           "save_inference_model", "load_inference_model",
           "cpu_places", "cuda_places", "verify_program",
           "ProgramVerifyError", "infer_program", "ShapeInferError",
           "register_infer_rule", "analyze_memory", "InflightDriver",
           "FetchHandle", "PipelineStepError", "PipelineRunner",
           "StagedPipelineRunner"]


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed variable (reference python/paddle/static/input.py).
    A dim of None or -1 records as 1; the Executor runs the fed size."""
    shape = [(-1 if s is None else int(s)) for s in shape]
    aval_shape = [1 if s == -1 else s for s in shape]
    program = default_main_program()
    var = Variable(aval_shape, dtype, name=name, is_data=True,
                   program=program)
    var.stop_gradient = True
    program.add_data_var(var)
    return var


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Mark the backward section (reference fluid/backward.py:1288): no
    grad ops are woven into the program; the Executor differentiates the
    replayed forward with torch autograd. Returns [(param, grad_var)]."""
    program = loss.program or default_main_program()
    if parameter_list:
        params = list(parameter_list)
    else:
        params = [p for p in program.persistable_vars.values()
                  if getattr(p, "is_parameter", False)
                  and getattr(p, "trainable", True)]
    pairs = []
    for p in params:
        g = Variable(p.shape, p.dtype, name=f"{p.name}@GRAD",
                     program=program)
        pairs.append((p, g))
    program.backward_section = (loss, pairs)
    program._version += 1
    return pairs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference fluid/backward.py:1741 calc_gradient, with respect to
    scope-backed parameters (grads of activations or data raise, as in
    the JAX package)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    scoped = [i for i in inputs if getattr(i, "scope_name", None)]
    if len(scoped) != len(inputs):
        bad = [getattr(i, "name", i) for i in inputs
               if not getattr(i, "scope_name", None)]
        raise NotImplementedError(
            f"static gradients() w.r.t. non-parameter variables {bad} is not "
            "supported yet; use dygraph paddle.grad for activation grads")
    pairs = append_backward(targets[0], parameter_list=scoped)
    return [g for _, g in pairs]


def set_program_state(program, state_dict):
    for name, var in program.persistable_vars.items():
        if name in state_dict:
            var.set_value(state_dict[name])


def save(program, path, protocol=4):
    """Persist the program's persistables from the scope (reference
    fluid/io.py:620 save_persistables)."""
    from ..framework.io import save as _save
    scope = global_scope()
    state = {n: scope.get(n) for n in program.persistable_vars
             if scope.has(n)}
    _save(state, path + ".pdparams" if not path.endswith(".pdparams")
          else path)


def load(program, path, executor=None, var_list=None):
    from ..framework.io import load as _load
    p = path + ".pdparams" if not path.endswith(".pdparams") else path
    set_program_state(program, _load(p))


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         program=None):
    """Freeze the feed -> fetch subgraph (reference fluid/io.py:1198):
    ``{prefix}.pdmodel`` (+ ``.npz``), the program pruned by
    ``eliminate_dead_ops`` and ``fold_constants``, and ``{prefix}
    .pdiparams``, the persistables. Returns the pruned program."""
    import copy

    if program is None:
        program = next((v.program for v in fetch_vars
                        if getattr(v, "program", None) is not None),
                       None) or default_main_program()
    prog = copy.copy(program)
    prog._jit_fetch_vars = list(fetch_vars)
    prog.backward_section = None
    prog.optimizer_section = None
    from .passes import apply_pass
    pruned = apply_pass(prog, ["eliminate_dead_ops", "fold_constants"])
    from ..framework.program_serde import save_program
    save_program(pruned, path_prefix, feed_names=[v.name for v in feed_vars])
    save(program, path_prefix + ".pdiparams")
    return pruned


def load_inference_model(path_prefix, executor=None):
    """reference fluid/io.py load_inference_model: [program, feed_names,
    fetch_vars]."""
    from ..framework.program_serde import load_program
    program, feed_names = load_program(path_prefix)
    load(program, path_prefix + ".pdiparams")
    return [program, feed_names,
            list(getattr(program, "_jit_fetch_vars", []))]


def cpu_places(device_count=None):
    from ..device import CPUPlace
    return [CPUPlace()] * int(device_count or 1)


def cuda_places(device_ids=None):
    from ..device import CUDAPlace
    if device_ids is None:
        device_ids = range(max(torch.cuda.device_count(), 1))
    return [CUDAPlace(i) for i in device_ids]


class _StaticNN:
    """paddle.static.nn builders (reference fluid/layers/nn.py
    LayerHelper builders): each creates its layer's parameters in the
    current program and applies the layer at once."""

    @staticmethod
    def fc(x, size, num_flatten_dims=1, activation=None, name=None,
           weight_attr=None, bias_attr=None):
        from .. import nn, ops
        in_features = int(np.prod(tuple(x.shape)[num_flatten_dims:]))
        layer = nn.Linear(in_features, size, weight_attr=weight_attr,
                          bias_attr=bias_attr)
        h = x if x.ndim == 2 else ops.flatten(x, num_flatten_dims)
        out = layer(h)
        if activation:
            out = getattr(nn.functional, activation)(out)
        return out

    @staticmethod
    def batch_norm(input, momentum=0.9, epsilon=1e-5,  # noqa: A002
                   data_layout="NCHW", is_test=False, name=None):
        from .. import nn
        c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
        layer = nn.BatchNorm2D(c, momentum=momentum, epsilon=epsilon)
        layer.training = not is_test
        return layer(input)

    @staticmethod
    def conv2d(input, num_filters, filter_size, stride=1,  # noqa: A002
               padding=0, dilation=1, groups=1, param_attr=None,
               bias_attr=None, name=None):
        from .. import nn
        layer = nn.Conv2D(input.shape[1], num_filters, filter_size,
                          stride=stride, padding=padding, dilation=dilation,
                          groups=groups, weight_attr=param_attr,
                          bias_attr=bias_attr)
        return layer(input)

    @staticmethod
    def embedding(input, size, is_sparse=False,  # noqa: A002
                  padding_idx=None, param_attr=None, dtype="float32"):
        from .. import nn
        layer = nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                             sparse=is_sparse, weight_attr=param_attr)
        return layer(input)


nn = _StaticNN()

from .control_flow import cond, while_loop  # noqa: E402,F401

nn.while_loop = while_loop
nn.cond = cond
