"""Static graph Program (paddle_tpu/static/program.py).

A Program is a flat SSA list of recorded ops (``OpNode``) over symbolic
``Variable``s, with a name -> tensor ``Scope`` holding the parameters and
the other persistables. The Executor (``executor.py``) replays the op list
on the device.

``Variable`` is a ``torch.Tensor`` subclass with no storage
(``torch.Tensor._make_wrapper_subclass``): it reports its shape, its dtype
and the device the program runs on, so ``isinstance`` checks and
``device=x.device`` factories in layer code keep working. Its Paddle
operators and methods go through the ops (``ops/_dispatch.defop``), which
record an ``OpNode`` instead of computing. It turns torch's per-op hook
back on for itself (the port's ``Tensor`` turns it off), and that hook
lets only metadata through (shape, dtype, device ...):

- ``torch.Tensor.copy_`` into a scope-backed Variable writes the scope (an
  eager source: a parameter initializer) or records a state write (a
  Variable source: BatchNorm's running statistics), as JAX's ``_rebind``;
- any other torch function raises ``TypeError`` naming it, since a
  Program holds registry ops only, or it could not be saved; inside an
  op's body in dynamic mode it raises the JAX package's ``RuntimeError``
  (a Variable reached an op outside static mode).

``__bool__``, ``__int__``, ``__float__`` and ``__index__`` raise the JAX
package's message: Python control flow cannot branch on graph values.
"""
from __future__ import annotations

import copy
import threading
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.dtype import convert_dtype, to_torch_dtype
from ..core.tensor import Tensor
from ..ops import _dispatch

__all__ = ["Variable", "OpNode", "Program", "Scope", "global_scope",
           "program_guard", "default_main_program", "default_startup_program",
           "name_scope", "StaticParam", "in_static_mode", "enable_static_",
           "disable_static_", "force_program", "forced_program"]


class Scope:
    """name -> device tensor store (reference framework/scope.h)."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}

    def set(self, name, value):
        self._vars[name] = value

    def get(self, name):
        return self._vars[name]

    def has(self, name):
        return name in self._vars

    def find_var(self, name):
        return _ScopeVarView(self, name) if name in self._vars else None

    def var_names(self):
        return list(self._vars)

    def drop_kids(self):
        pass


class _ScopeVarView:
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return self._scope.get(self._name)

    def set(self, value, place=None):
        self._scope.set(self._name, value)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _current_device():
    from ..device import resolve_device
    return resolve_device()


def _is_getter(func, names):
    owner = getattr(func, "__self__", None)
    return getattr(func, "__name__", "") == "__get__" \
        and getattr(owner, "__name__", None) in names


# metadata a Variable answers without a value
_META_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "requires_grad", "is_leaf",
    "grad_fn", "is_cuda", "is_meta", "is_cpu", "layout", "is_sparse",
    "is_quantized", "is_nested", "names", "_base", "is_mkldnn", "output_nr",
    "_version", "grad", "itemsize", "nbytes", "is_mps", "is_xpu"})
_T = torch.Tensor
_META_FNS = {_T.dim, _T.size, _T.numel, _T.is_floating_point, _T.is_complex,
             _T.__len__, _T.element_size, _T.nelement, _T.ndimension,
             _T.get_device, _T.is_contiguous, _T.stride, _T.__hash__,
             _T.storage_offset, _T.is_signed,
             _T.is_inference, _T.__format__}

_DYNAMIC_MSG = ("an op received static-graph Variables while dynamic mode is "
                "active; run the program through paddle.static.Executor, or "
                "re-enter paddle.enable_static() before building more graph")


class Variable(Tensor):
    """Symbolic SSA value (reference framework.py:976 Variable): fed
    (data), scope-backed (persistable parameters and buffers) or an op's
    output."""

    _counter = [0]
    _lock = threading.Lock()

    @staticmethod
    def __new__(cls, shape, dtype, name=None, is_data=False, scope_name=None,
                program=None, device=None):
        if device is None:
            device = program.device if program is not None \
                else _current_device()
        return _T._make_wrapper_subclass(
            cls, tuple(int(s) for s in shape), dtype=to_torch_dtype(dtype),
            device=device, requires_grad=False)

    def __init__(self, shape, dtype, name=None, is_data=False,
                 scope_name=None, program=None, device=None):
        with Variable._lock:
            Variable._counter[0] += 1
            self.var_id = Variable._counter[0]
        self.name = name or f"_var_{self.var_id}"
        self.is_data = is_data
        self.scope_name = scope_name
        self.program = program
        if program is not None and program._device is None:
            program._device = _T.device.__get__(self)
        self.__dict__["_stop_gradient"] = True

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _META_FNS or _is_getter(func, _META_ATTRS):
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **kwargs)
        if func is _T.copy_ and args and isinstance(args[0], Variable):
            return args[0]._assign(args[1])
        if _dispatch._state.depth and not in_static_mode():
            raise RuntimeError(_DYNAMIC_MSG)
        name = getattr(func, "__qualname__", None) or repr(func)
        raise TypeError(
            f"torch function {name} reached a static-graph Variable outside "
            "a port op; a Program records registry ops only (use the "
            "paddle ops, or run the code in dynamic mode)")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise TypeError(f"the aten op {func} reached a static-graph "
                        "Variable, which holds no value")

    # -- attributes --------------------------------------------------------
    @property
    def aval(self):
        """(shape, dtype), the JAX package's ShapeDtypeStruct."""
        return _Aval(tuple(self.shape), self.dtype)

    @property
    def stop_gradient(self):
        return self.__dict__.get("_stop_gradient", True)

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.__dict__["_stop_gradient"] = bool(value)

    def numpy(self):
        if self.scope_name is not None and global_scope().has(self.scope_name):
            return _to_numpy(global_scope().get(self.scope_name))
        raise RuntimeError(
            f"Variable {self.name} has no materialized value; fetch it via "
            "Executor.run(fetch_list=[...])")

    def set_value(self, value):
        if self.scope_name is None:
            raise RuntimeError("only persistable variables can set_value")
        global_scope().set(self.scope_name, _scope_value(value, self))
        return self

    def detach(self):
        return self

    def _no_concrete(self, what):
        raise TypeError(
            f"{what} of symbolic Variable {self.name!r} is undefined at "
            "graph-build time — Python control flow cannot branch on graph "
            "values (the reference raises the same way, framework.py "
            "Variable.__bool__). Use paddle.static.nn.cond / "
            "paddle.static.nn.while_loop, or decorate the function with "
            "@paddle.jit.to_static so the branch converts automatically "
            "(jit/dy2static.py)")

    def __bool__(self):
        self._no_concrete("the truth value")

    def __float__(self):
        self._no_concrete("float()")

    def __int__(self):
        self._no_concrete("int()")

    def __index__(self):
        self._no_concrete("index()")

    def clone(self):
        from .. import ops
        return ops.assign(self)

    def __repr__(self, *args, **kwargs):
        kind = "data" if self.is_data else (
            "persist" if self.scope_name else "tmp")
        return (f"Variable(name={self.name}, shape={list(self.shape)}, "
                f"dtype={convert_dtype(self.dtype)}, kind={kind})")

    def __deepcopy__(self, memo):
        # a scope-backed buffer's copy gets a scope entry of its own;
        # other Variables are SSA values and copy as themselves
        if id(self) in memo:
            return memo[id(self)]
        if self.scope_name is None or self.program is None:
            return self
        new = Variable(self.shape, self.dtype,
                       name=_unique_scope_name(self.scope_name),
                       program=self.program, device=self.device)
        new.scope_name = new.name
        new.persistable = True
        scope = global_scope()
        if scope.has(self.scope_name):
            scope.set(new.scope_name, scope.get(self.scope_name).clone())
        self.program.add_persistable(new)
        memo[id(self)] = new
        return new

    def __reduce_ex__(self, proto):
        raise TypeError("a static-graph Variable is not picklable; save the "
                        "Program with framework.program_serde.save_program")

    def _assign(self, src):
        """``torch.Tensor.copy_(self, src)`` in static mode: a Variable
        source rebinds this SSA name (a scope-backed one records a state
        write, how BN running stats persist across runs); an eager one
        writes the scope."""
        if isinstance(src, Variable):
            if tuple(src.shape) != tuple(self.shape):
                raise ValueError(
                    f"static write to {self.name}: shape {tuple(src.shape)} "
                    f"!= {tuple(self.shape)}")
            if self.scope_name is not None and self.program is not None:
                if src.dtype != self.dtype:
                    from .. import ops
                    src = ops.cast(src, self.dtype)
                self.program.state_writes[self.scope_name] = src.var_id
            self.var_id = src.var_id
            return self
        if self.scope_name is None:
            raise TypeError(
                f"in-place write of an eager value into the non-persistable "
                f"Variable {self.name}")
        global_scope().set(self.scope_name, _scope_value(src, self))
        return self


class _Aval:
    """(shape, dtype) under the JAX ShapeDtypeStruct's attribute names."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    def __eq__(self, other):
        return isinstance(other, _Aval) and self.shape == other.shape \
            and self.dtype == other.dtype

    def __hash__(self):
        return hash((self.shape, self.dtype))

    def __repr__(self):
        return f"_Aval({self.shape}, {self.dtype})"


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _scope_value(value, var):
    """``value`` as a plain tensor of ``var``'s dtype on its device."""
    if isinstance(value, torch.Tensor):
        t = _T.detach(value).as_subclass(_T) if isinstance(value, Tensor) \
            else value.detach()
    else:
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr))
    return t.to(device=var.device, dtype=var.dtype).clone()


_scope_names: Dict[str, int] = {}


def _unique_scope_name(base):
    n = _scope_names.get(base, 0) + 1
    _scope_names[base] = n
    return f"{base}_copy_{n}"


class _Ref:
    """Snapshot of a Variable's SSA id at record time (ids on scope-backed
    Variables change when layers rebind them, e.g. BN running stats)."""

    __slots__ = ("var_id", "name")

    def __init__(self, var: "Variable"):
        self.var_id = var.var_id
        self.name = var.name


class OpNode:
    """One recorded op: ``fn`` (the op's raw torch function) over a flat
    list (positional args, then the kwargs' pytree leaves); the kwargs are
    rebuilt from ``kw_tree`` when the op runs."""

    __slots__ = ("fn", "name", "flat", "n_args", "kw_tree", "out_vars",
                 "out_ids")

    def __init__(self, fn, name, flat, n_args, kw_tree, out_vars):
        self.fn = fn
        self.name = name
        self.flat = [(_Ref(a) if isinstance(a, Variable) else a)
                     for a in flat]
        self.n_args = n_args
        self.kw_tree = kw_tree
        self.out_vars = out_vars
        self.out_ids = [o.var_id for o in out_vars]


class Program:
    """Recorded op list + feed / persistable registry
    (reference framework.py Program; ProgramDesc proto)."""

    _uid_counter = [0]

    def __init__(self, name="main"):
        self.name = name
        with Variable._lock:
            Program._uid_counter[0] += 1
            self.uid = Program._uid_counter[0]
        self.ops: List[OpNode] = []
        self.data_vars: Dict[str, Variable] = {}
        self.persistable_vars: Dict[str, Variable] = {}
        self.persist_ids: Dict[str, int] = {}
        self.state_writes: Dict[str, int] = {}  # scope_name -> var_id
        self.backward_section = None   # (loss_var, [(param_var, grad_var)])
        self.optimizer_section = None  # (optimizer, [(param_var, grad_var)])
        self.random_seed = None
        self.amp_level = None
        self._version = 0
        self._device = None

    @property
    def device(self):
        """The device the program's Variables report: the current device
        when its first Variable was made."""
        if self._device is None:
            self._device = _current_device()
        return self._device

    # -- recording ----------------------------------------------------------
    def append_op(self, fn, name, flat, n_args, kw_tree, out_avals):
        outs = [Variable(shape, dtype, program=self)
                for shape, dtype in out_avals]
        self.ops.append(OpNode(fn, name, flat, n_args, kw_tree, outs))
        self._version += 1
        return outs

    def add_data_var(self, var: Variable):
        self.data_vars[var.name] = var

    def add_persistable(self, var: Variable):
        self.persistable_vars[var.scope_name] = var
        self.persist_ids[var.scope_name] = var.var_id

    # -- introspection ------------------------------------------------------
    def list_vars(self):
        seen = {}
        for v in list(self.data_vars.values()) \
                + list(self.persistable_vars.values()):
            seen[v.var_id] = v
        for op in self.ops:
            for v in op.out_vars:
                seen[v.var_id] = v
        return list(seen.values())

    def global_block(self):
        return self

    def all_parameters(self):
        return list(self.persistable_vars.values())

    @property
    def num_blocks(self):
        return 1

    def to_string(self, throw_on_error=False, with_details=False):
        lines = [f"Program<{self.name}> ({len(self.ops)} ops)"]
        for v in self.data_vars.values():
            lines.append(f"  data  {v.name}: {list(v.shape)} "
                         f"{convert_dtype(v.dtype)}")
        for v in self.persistable_vars.values():
            lines.append(f"  persist {v.scope_name}: {list(v.shape)} "
                         f"{convert_dtype(v.dtype)}")
        for op in self.ops:
            ins = ", ".join(a.name if isinstance(a, _Ref)
                            else (f"const{list(a.shape)}"
                                  if isinstance(a, torch.Tensor)
                                  else repr(a))
                            for a in op.flat[:op.n_args])
            outs = ", ".join(o.name for o in op.out_vars)
            lines.append(f"  {op.name}({ins}) -> {outs}")
        if self.backward_section:
            loss, pairs = self.backward_section
            lines.append(f"  [backward] d{loss.name} -> "
                         f"{[p.name for p, _ in pairs]}")
        if self.optimizer_section:
            opt, pairs = self.optimizer_section
            lines.append(f"  [optimize] {type(opt).__name__} on "
                         f"{len(pairs)} params")
        return "\n".join(lines)

    __str__ = to_string

    def clone(self, for_test=False):
        p = Program(self.name + ("_test" if for_test else "_clone"))
        p._device = self._device
        p.ops = ([self._op_for_test(op) for op in self.ops] if for_test
                 else list(self.ops))
        p.data_vars = dict(self.data_vars)
        p.persistable_vars = dict(self.persistable_vars)
        p.persist_ids = dict(self.persist_ids)
        # test programs must not advance running statistics
        p.state_writes = {} if for_test else dict(self.state_writes)
        for attr in ("amp_level", "amp_dtype", "amp_lists"):
            if hasattr(self, attr):
                setattr(p, attr, getattr(self, attr))
        if not for_test:
            p.backward_section = self.backward_section
            p.optimizer_section = self.optimizer_section
            for attr in ("amp_dynamic_scaling", "amp_scaling_hparams"):
                if hasattr(self, attr):
                    setattr(p, attr, getattr(self, attr))
        return p

    @staticmethod
    def _op_for_test(op: "OpNode") -> "OpNode":
        """Rewrite train-mode ops for inference (JAX :323-361): BN to its
        eval form, dropout to the identity."""
        import torch.utils._pytree as pytree
        if op.name == "batch_norm":
            kw = pytree.tree_unflatten(op.flat[op.n_args:], op.kw_tree)
            if kw.get("training", False):
                kw = dict(kw, training=False)
                leaves, tree = pytree.tree_flatten(kw)
                new = copy.copy(op)
                new.flat = op.flat[:op.n_args] + leaves
                new.kw_tree = tree
                return new
        if op.name in ("dropout_op", "alpha_dropout"):
            new = copy.copy(op)
            new.fn = _identity
            new.name = f"{op.name}_identity"
            return new
        return op


def _identity(x, *args, **kwargs):
    return x


class StaticParam(Variable):
    """Scope-backed trainable parameter in static mode (reference
    framework.py Parameter under static graph). ``_is_param`` makes
    ``isinstance(p, torch.nn.Parameter)`` true, so a Layer registers it as
    a parameter."""

    _is_param = True

    @staticmethod
    def __new__(cls, shape, dtype, name=None, program=None, *args,
                device=None, **kwargs):
        return Variable.__new__(cls, shape, dtype, program=program,
                                device=device)

    def __init__(self, shape, dtype, name, program, trainable=True,
                 regularizer=None, learning_rate=1.0, need_clip=True,
                 device=None):
        super().__init__(shape, dtype, name=name, scope_name=name,
                         program=program, device=device)
        self.persistable = True
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": learning_rate}
        self.regularizer = regularizer
        self.need_clip = need_clip
        self.is_parameter = True

    @property
    def trainable(self):
        return not self.stop_gradient

    @trainable.setter
    def trainable(self, value):
        self.stop_gradient = not bool(value)

    def __deepcopy__(self, memo):
        # the port's copies take fresh scope names: the layers of a
        # deep-copied stack own distinct parameters (the JAX package's
        # static copies share one scope entry)
        if id(self) in memo:
            return memo[id(self)]
        name = _unique_scope_name(self.scope_name)
        new = StaticParam(self.shape, self.dtype, name, self.program,
                          trainable=self.trainable,
                          regularizer=self.regularizer,
                          learning_rate=self.optimize_attr["learning_rate"],
                          need_clip=self.need_clip, device=self.device)
        scope = global_scope()
        if scope.has(self.scope_name):
            scope.set(name, scope.get(self.scope_name).clone())
        if self.program is not None:
            self.program.add_persistable(new)
        memo[id(self)] = new
        return new


# -- default program stack ---------------------------------------------------

class _StaticState(threading.local):
    def __init__(self):
        self.main = Program("main")
        self.startup = Program("startup")
        self.forced = None  # sub-block tracing override (control_flow.py)
        self.cf_parents = []  # enclosing sub-block traces (control_flow.py)


_state = _StaticState()


def forced_program():
    """The program a control-flow sub-block trace pins (overrides the
    per-arg program inference of the recording: an op mixing outer
    Variables with sub-block placeholders records into the sub-block)."""
    return _state.forced


class force_program:
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self._old = _state.forced
        _state.forced = self.program
        return self

    def __exit__(self, *exc):
        _state.forced = self._old
        return False


def in_static_mode() -> bool:
    return _dispatch._state.static


def enable_static_():
    _dispatch._state.static = True


def disable_static_():
    _dispatch._state.static = False


def default_main_program() -> Program:
    return _state.main


def default_startup_program() -> Program:
    return _state.startup


def switch_main_program(program):
    old = _state.main
    _state.main = program
    return old


class program_guard:
    """with program_guard(main, startup): ... (reference framework.py)."""

    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program or Program("startup")

    def __enter__(self):
        self._old_main = _state.main
        self._old_startup = _state.startup
        _state.main = self.main
        _state.startup = self.startup
        return self

    def __exit__(self, *exc):
        _state.main = self._old_main
        _state.startup = self._old_startup
        return False


class name_scope:
    def __init__(self, prefix=None):
        self.prefix = prefix

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
