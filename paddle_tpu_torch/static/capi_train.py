"""The Python side of the C-ABI trainer (paddle_tpu/static/capi_train.py;
reference ``train/demo/demo_trainer.cc``): load a saved training Program,
step it with caller-fed batches, persist its parameters.

The artifact of ``save_train_program(program, path)`` is the port's
versioned ``.pdmodel`` format (``framework/program_serde.py``:
``{path}.pdmodel`` and ``{path}.pdmodel.npz``) with the training section
in the document's ``extra["train"]``: the loss, the trained parameters,
the program-level AMP policy and the optimizer (its class and settings,
pickled without its parameters). The scope's values and the optimizer's
state (slots, step count) go to ``{path}.pdiparams``
(``framework/io.py``, which the JAX package's ``load`` reads too).
``create`` rebuilds the backward and optimizer sections on the loaded
program with ``append_backward``, as ``minimize`` records them, so
``run_step`` is ``Executor.run`` on the same replay.

The JAX package pickles its whole Program (its ops, Variables, jax tree
definitions and optimizer object) and its state into one file. ``create``
reads such a file too, without importing jax or the JAX package: every
class of the JAX package, jax or jaxlib in it unpickles as a stand-in
that keeps its pickled state (``_Shim``), and ``_from_jax`` rebuilds the
program from those states (ops by registry name, control flow's
``cond`` / ``while_loop`` ops with their sub-blocks as the port's
``static/control_flow.py`` ones, the kwargs' jax tree definitions
unflattened, the optimizer by class name with its settings: the weight
decay, the gradient clip, an ``lr.LRScheduler`` with its state, and the
parameters' ``ParamAttr`` regularizers come across as the port's objects
of the same class and attributes, ``_rebuild``).
The JAX package cannot read the port's artifact: it would need the
port to write jax's private pickled objects. The C ABI's trainer
(``_native/src/train_capi.c``, ``PD_NewTrainer`` / ``PD_TrainerRunStep``
/ ``PD_TrainerSave``) embeds CPython and calls ``create``, ``run_step``
and ``save_params`` here.
"""
from __future__ import annotations

import base64
import copy
import pickle

import numpy as np

__all__ = ["save_train_program", "create", "feed_names", "run_step",
           "save_params"]

_DTYPES = {0: np.float32, 1: np.int32, 2: np.int64}
_AMP_ATTRS = ("amp_level", "amp_dtype", "amp_lists", "amp_dynamic_scaling",
              "amp_scaling_hparams")


def _optimizer_blob(opt):
    """The optimizer's class and settings, pickled without its parameters
    and state (those go to the .pdiparams)."""
    clone = copy.copy(opt)
    clone._named = None
    clone._slots = {}
    clone._step_count = 0
    return base64.b64encode(pickle.dumps(clone, protocol=4)).decode()


def save_train_program(program, path, scope=None):
    """Persist a training program (its backward and optimizer sections
    ride along) and its current persistable values."""
    import torch

    from ..framework.io import save
    from ..framework.program_serde import save_program
    from .program import global_scope
    scope = scope or global_scope()
    bwd = program.backward_section
    if bwd is None:
        raise ValueError("train program has no backward section")
    loss, pairs = bwd
    opt_sec = program.optimizer_section
    amp = {}
    for a in _AMP_ATTRS:
        v = getattr(program, a, None)
        if isinstance(v, torch.dtype):
            v = str(v).replace("torch.", "")
        elif isinstance(v, tuple):
            v = [sorted(x) for x in v]
        amp[a] = v
    train = {"loss_id": loss.var_id,
             "params": [p.scope_name for p, _ in pairs],
             "amp": amp,
             "optimizer": None if opt_sec is None
             else _optimizer_blob(opt_sec[0])}
    fetch_vars = getattr(program, "_jit_fetch_vars", None)
    program._jit_fetch_vars = [loss]
    try:
        save_program(program, path, feed_names=list(program.data_vars),
                     extra={"train": train})
    finally:
        program._jit_fetch_vars = fetch_vars
    state = {"scope": {n: scope.get(n) for n in program.persistable_vars
                       if scope.has(n)}}
    if opt_sec is not None:
        state["optimizer"] = opt_sec[0].state_dict()
    save(state, path + ".pdiparams")
    return path


def create(path, device=None):
    """Load a train artifact (the port's, or the JAX package's pickle)
    into a fresh handle: the program (with its backward and optimizer
    sections), an Executor and its own Scope, on ``device`` (default: the
    current device)."""
    import json
    import os

    import torch

    from ..device import resolve_device
    if not os.path.exists(path + ".pdmodel"):
        return _from_jax(path, resolve_device(device))
    from ..framework.io import load
    from ..framework.program_serde import load_program
    from .executor import Executor
    from .program import Scope
    from . import append_backward
    device = resolve_device(device)
    program, feeds = load_program(path, device=device)
    with open(path + ".pdmodel") as f:
        train = json.load(f)["extra"]["train"]
    by_id = {v.var_id: v for v in program._jit_fetch_vars}
    loss = by_id[train["loss_id"]]
    params = [program.persistable_vars[n] for n in train["params"]]
    for p in params:
        p.is_parameter = True
    pairs = append_backward(loss, parameter_list=params)
    for a, v in train["amp"].items():
        if a == "amp_dtype" and v is not None:
            v = getattr(torch, v)
        elif a == "amp_lists" and v is not None:
            v = tuple(frozenset(x) for x in v)
        if v is not None:
            setattr(program, a, v)
    state = load(path + ".pdiparams")
    if train["optimizer"] is not None:
        opt = pickle.loads(base64.b64decode(train["optimizer"]))
        opt.set_state_dict({k: (v.to(device) if isinstance(v, torch.Tensor)
                                else v)
                            for k, v in state["optimizer"].items()})
        for name, slots in opt._slots.items():
            opt._slots[name] = {k: v.to(device) for k, v in slots.items()}
        program.optimizer_section = (opt, pairs)
    program._version += 1
    scope = Scope()
    for name, val in state["scope"].items():
        scope.set(name, val.to(device) if isinstance(val, torch.Tensor)
                  else torch.as_tensor(val, device=device))
    return {"program": program, "exe": Executor(), "scope": scope,
            "feed_names": list(feeds or program.data_vars), "loss": loss}


def feed_names(handle):
    return list(handle["feed_names"])


def run_step(handle, inputs, fetch_name=None):
    """inputs: (buffer, dtype code, shape) per feed, in feed_names order
    (codes: 0 float32, 1 int32, 2 int64). Returns the mean of the fetch
    (the loss by default) as a float."""
    feed = {}
    for name, (mv, code, shape) in zip(handle["feed_names"], inputs):
        feed[name] = np.frombuffer(mv, dtype=_DTYPES[int(code)]).reshape(
            tuple(int(s) for s in shape))
    fetch = [fetch_name] if fetch_name else [handle["loss"]]
    outs = handle["exe"].run(handle["program"], feed=feed, fetch_list=fetch,
                             scope=handle["scope"])
    return float(np.asarray(outs[0]).mean())


def save_params(handle, path):
    """The scope's persistable values to ``{path}.pdparams``."""
    from ..framework.io import save
    state = {n: handle["scope"].get(n)
             for n in handle["program"].persistable_vars
             if handle["scope"].has(n)}
    save(state, path if path.endswith(".pdparams") else path + ".pdparams")
    return path


# -- the JAX package's artifact ------------------------------------------------

_JAX_ROOTS = ("paddle_tpu", "jax", "jaxlib")
_PLAIN_ROOTS = ("numpy", "builtins", "copyreg", "collections", "_codecs",
                "ml_dtypes")


class _Shim:
    """A pickled object of the JAX package, jax or jaxlib: its
    constructor arguments and its state, as pickled."""

    qual = ""

    def __init__(self, *args):
        self.args = args
        self.state = None

    def __setstate__(self, state):
        self.state = state

    def fields(self):
        st = self.state
        if isinstance(st, tuple) and len(st) == 2 and st[0] is None:
            st = st[1]
        return st if isinstance(st, dict) else {}


class _JaxUnpickler(pickle.Unpickler):
    def __init__(self, f):
        super().__init__(f)
        self._classes = {}

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in _PLAIN_ROOTS:
            return super().find_class(module, name)
        if root not in _JAX_ROOTS:
            raise pickle.UnpicklingError(
                f"unexpected global {module}.{name} in a train artifact")
        key = f"{module}.{name}"
        cls = self._classes.get(key)
        if cls is None:
            cls = self._classes[key] = type(name, (_Shim,), {"qual": key})
        return cls


def _array(x):
    """numpy of a pickled jax array (``_reconstruct_array``'s stand-in)
    or of a numpy value."""
    if isinstance(x, _Shim) and x.qual.endswith("_reconstruct_array"):
        fun, args, arr_state = x.args[0], x.args[1], x.args[2]
        arr = fun(*args)
        arr.__setstate__(arr_state)
        return arr
    return np.asarray(x)


def _unflatten(nodes, leaves):
    """A jax tree definition's post-order node list (kind, arity,
    node data, ...) over ``leaves``: kinds 0 leaf, 1 None, 2 tuple, 4
    list, 5 dict (node data: its sorted keys)."""
    it, stack = iter(leaves), []
    for kind, arity, data, *_ in nodes:
        kids = stack[len(stack) - arity:] if arity else []
        del stack[len(stack) - arity:]
        if kind == 0:
            stack.append(next(it))
        elif kind == 1:
            stack.append(None)
        elif kind == 2:
            stack.append(tuple(kids))
        elif kind == 4:
            stack.append(list(kids))
        elif kind == 5:
            stack.append(dict(zip(data, kids)))
        else:
            raise NotImplementedError(
                f"a jax tree node of kind {kind} in a train artifact")
    (tree,) = stack
    return tree


def _from_jax(path, device):
    """A handle over the JAX package's train artifact at ``path``."""
    import torch
    import torch.utils._pytree as pytree

    from .. import optimizer as optim
    from ..core.dtype import to_torch_dtype
    from ..ops import OP_REGISTRY
    from . import control_flow as cf
    from .executor import Executor
    from .program import OpNode, Program, Scope, Variable, _Ref
    with open(path, "rb") as f:
        payload = _JaxUnpickler(f).load()
    pf = payload["program"].fields()
    program = Program(pf.get("name", "jax_train"))
    program._device = device
    by_id = {}

    def var(shim):
        f = shim.fields()
        vid = f["var_id"]
        if vid not in by_id:
            aval = f["aval"].fields()
            v = Variable(list(aval["shape"]), str(np.dtype(aval["dtype"])),
                         program=program, device=device)
            v.var_id, v.name, v.program = vid, f["name"], program
            v.is_data = f.get("is_data", False)
            v.scope_name = f.get("scope_name")
            for k in ("is_parameter", "trainable", "optimize_attr",
                      "need_clip"):
                if k in f:
                    setattr(v, k, f[k])
            if f.get("regularizer") is not None:
                v.regularizer = _rebuild(f["regularizer"])
            by_id[vid] = v
        return by_id[vid]

    def value(x):
        if isinstance(x, _Shim) and x.qual.endswith("._Ref"):
            r = _Ref.__new__(_Ref)
            r.var_id, r.name = x.fields()["var_id"], x.fields()["name"]
            return r
        if isinstance(x, _Shim):
            x = _array(x)
        if isinstance(x, np.dtype) or (isinstance(x, type)
                                       and issubclass(x, np.generic)):
            return to_torch_dtype(str(np.dtype(x)))
        if isinstance(x, np.ndarray):
            return _tensor(x, device)
        if isinstance(x, np.generic):
            return x.item()
        if isinstance(x, (tuple, list)):
            return type(x)(value(v) for v in x)
        if isinstance(x, dict):
            return {k: value(v) for k, v in x.items()}
        return x

    def block(shim):
        f = shim.fields()
        return cf.SubBlock([node(o) for o in f["ops"]], f["in_ids"],
                           f["free_ids"], f["out_ids"])

    def kernel(name, fn):
        if isinstance(fn, tuple) and fn[0] == "opreg":
            return OP_REGISTRY[fn[1]].raw
        qual = getattr(fn, "qual", "")
        if qual.endswith("control_flow._CondFn"):
            f = fn.fields()
            return cf._CondFn(block(f["true_block"]), block(f["false_block"]))
        if qual.endswith("control_flow._WhileFn"):
            f = fn.fields()
            return cf._WhileFn(block(f["cond_block"]), block(f["body_block"]),
                               f["n_loop"], f.get("max_trip"))
        raise NotImplementedError(
            f"op '{name}' of a JAX train artifact is neither a registry op "
            f"nor cond / while_loop ({qual or type(fn).__name__})")

    def node(shim):
        f = shim.state
        flat = [value(x) for x in f["flat"]]
        n = f["n_args"]
        kwargs = _unflatten(f["kw_tree"].state[1], flat[n:])
        leaves, kw_tree = pytree.tree_flatten(kwargs)
        op = OpNode.__new__(OpNode)
        op.fn, op.name = kernel(f["name"], f["fn"]), f["name"]
        op.flat, op.n_args, op.kw_tree = flat[:n] + leaves, n, kw_tree
        op.out_vars = [var(v) for v in f["out_vars"]]
        op.out_ids = list(f["out_ids"])
        return op

    program.ops.extend(node(shim) for shim in pf["ops"])
    program.data_vars = {k: var(v) for k, v in pf["data_vars"].items()}
    program.persistable_vars = {k: var(v) for k, v in
                                pf["persistable_vars"].items()}
    program.persist_ids = dict(pf["persist_ids"])
    program.state_writes = dict(pf.get("state_writes", {}))
    loss_shim, pair_shims = pf["backward_section"]
    pairs = [(var(p), var(g)) for p, g in pair_shims]
    loss = var(loss_shim)
    program.backward_section = (loss, pairs)
    program._jit_fetch_vars = [loss]
    for a in _AMP_ATTRS:
        if pf.get(a) is not None:
            v = pf[a]
            setattr(program, a, to_torch_dtype(str(np.dtype(v)))
                    if a == "amp_dtype" else v)
    opt_sec = pf.get("optimizer_section")
    if opt_sec is not None:
        oshim = opt_sec[0]
        cls = getattr(optim, type(oshim).__name__)
        of = oshim.fields()
        opt = cls(learning_rate=_rebuild(of["_learning_rate"]))
        for k, v in of.items():
            if k in opt.__dict__ and (v is None or isinstance(
                    v, (bool, int, float, str, _Shim))):
                setattr(opt, k, _rebuild(v))
        opt._slots = {n: {k: _tensor(_array(x), device)
                          for k, x in d.items()}
                      for n, d in of.get("_slots", {}).items()}
        program.optimizer_section = (opt, pairs)
    with Variable._lock:
        Variable._counter[0] = max(Variable._counter[0], max(by_id) + 1)
    scope = Scope()
    for name, val in payload["state"].items():
        scope.set(name, _tensor(_array(val), device))
    return {"program": program, "exe": Executor(), "scope": scope,
            "feed_names": list(program.data_vars), "loss": loss}


# The JAX package's modules whose pickled objects (weight decay, gradient
# clips, LR schedulers) the port rebuilds as its own: plain attribute bags
# with the same attributes in both packages.
_REBUILT = ("paddle_tpu.regularizer", "paddle_tpu.optimizer.lr",
            "paddle_tpu.optimizer.clip")


def _rebuild(x):
    """A pickled regularizer, gradient clip or LR scheduler of the JAX
    package (a ``_Shim``) as the port's object of the same class, its
    attributes (a scheduler's state among them) copied; nested ones too
    (``LinearWarmup``'s inner scheduler). Anything else as it is."""
    import importlib
    if isinstance(x, (list, tuple)):
        return type(x)(_rebuild(v) for v in x)
    if not isinstance(x, _Shim):
        return x
    module, _, name = x.qual.rpartition(".")
    if module not in _REBUILT:
        raise NotImplementedError(
            f"{x.qual} in a JAX train artifact's optimizer")
    cls = getattr(importlib.import_module(
        "paddle_tpu_torch" + module[len("paddle_tpu"):]), name)
    obj = cls.__new__(cls)
    obj.__dict__.update({k: _rebuild(v) for k, v in x.fields().items()})
    return obj


def _tensor(arr, device):
    import torch
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)
