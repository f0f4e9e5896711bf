"""Op definition layer (paddle_tpu/ops/_dispatch.py).

``defop`` lifts a plain torch function into a port op: the wrapper applies
the AMP cast point under the op's name, as the JAX package's ``record_op``
does (paddle_tpu/core/tape.py), calls the function, and returns its tensor
outputs as the port's ``Tensor``. torch autograd records the gradient, so
there is no tape here. ``OP_REGISTRY`` maps each op's name to its wrapper,
and each wrapper carries ``op_name``, ``op_version`` and ``raw`` under the
JAX package's names and versions, which ``static/`` and
``framework/program_serde.py`` look ops up by. ``SHAPE_INFER_REGISTRY``
holds the abstract shape rules of ``static/shape_infer.py``.

Static mode (``paddle.enable_static()``, the JAX package's
``tape._record_static``): when an argument is a static-graph ``Variable``
the wrapper appends an ``OpNode`` of the op's raw function to the
argument's Program (or to the sub-block a control-flow trace forces) and
returns symbolic outputs, their shapes and dtypes inferred by
``static/shape_infer.infer_op``; an eager ``Tensor`` argument becomes a
captured constant. A call without Variables runs eagerly, in static mode
too (a creation op's result is a constant of the program). The eager path
pays one flag test for this (``_state.static``); a Variable that reaches
an op in dynamic mode raises there, from the Variable's own torch hook.

An op's body runs on torch's own meaning: while one runs, the ``Tensor``
operators and the methods whose Paddle meaning differs from torch's fall
through to torch, and a port op called from inside another is a plain call
(no second cast point, no re-wrapping). ``raw_scope()`` gives code outside
an op (a kernel wrapper called from a layer) the same treatment. The
wrapper catches nothing.

With ``FLAGS_check_nan_inf`` on, the wrapper checks the op's floating
outputs after its kernel (``core/numeric_check.check_op_outputs``, the
JAX package's ``record_op`` hook) and raises naming the op; off, the hot
path pays one flag read.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

from .. import amp as _amp
from ..core import numeric_check as _nc
from ..core.flags import _REGISTRY as _FLAGS
from ..core.tensor import Tensor

_T = torch.Tensor

__all__ = ["OP_REGISTRY", "SHAPE_INFER_REGISTRY", "defop", "wrap",
           "raw_scope"]

OP_REGISTRY = {}
SHAPE_INFER_REGISTRY = {}


class _State(threading.local):
    def __init__(self):
        self.depth = 0
        self.static = False     # instance attributes: one dict hit each


_state = _State()


@contextlib.contextmanager
def raw_scope():
    """Run the block on torch's own meaning, as an op's body runs."""
    _state.depth += 1
    try:
        yield
    finally:
        _state.depth -= 1


def _retype(t, args):
    """Make a fresh plain torch output a port ``Tensor`` in place (no copy,
    no autograd node); an output that is one of ``args`` gets a new alias
    instead, so an input's Python type never changes."""
    if type(t) is not _T:
        return t
    for a in args:
        if a is t:
            return t.as_subclass(Tensor)
    t.__class__ = Tensor
    return t


def wrap(out, args=()):
    """The port's view of an op's outputs: tensors become ``Tensor``,
    tuples and lists keep their structure."""
    if isinstance(out, (tuple, list)):
        return type(out)(_retype(o, args) for o in out) \
            if type(out) in (tuple, list) else tuple(
                _retype(o, args) for o in out)
    return _retype(out, args)


def retype_in_place(out, src):
    """``out`` (a tensor or a tuple of them, torch's named tuples too)
    with its fresh plain tensors made ``Tensor`` in place; one that is
    ``src`` stays as it is."""
    for t in (out if isinstance(out, tuple) else (out,)):
        if type(t) is _T and t is not src:
            t.__class__ = Tensor
    return out


def _cast(name, args, kwargs):
    n = len(args)
    keys = list(kwargs)
    vals = _amp.cast_inputs(name, list(args) + [kwargs[k] for k in keys])
    return tuple(vals[:n]), dict(zip(keys, vals[n:]))


_EAGER = object()


def _record_static(f, name, args, kwargs):
    """Record ``f`` into a Program when an argument is a Variable (else
    ``_EAGER``: the call runs eagerly)."""
    import torch.utils._pytree as pytree

    from ..static.program import (Variable, default_main_program,
                                  forced_program)
    kw_leaves, kw_tree = pytree.tree_flatten(kwargs)
    flat = list(args) + kw_leaves
    program = forced_program()
    found = False
    for a in flat:
        if isinstance(a, Variable):
            found = True
            if program is None:
                program = a.program
            break
    if not found:
        return _EAGER
    program = program or default_main_program()
    from ..static.shape_infer import infer_op
    avals, multi = infer_op(f, name, flat, len(args), kw_tree)
    rec = [_T.detach(a) if isinstance(a, _T) and not isinstance(a, Variable)
           else a for a in flat]
    outs = program.append_op(f, name, rec, len(args), kw_tree, avals)
    return tuple(outs) if multi else outs[0]


def defop(raw_fn=None, *, name=None, version=1):
    """Register ``raw_fn`` (a torch function of its inputs) as the op
    ``name`` (default: the function's name without leading underscores)
    at schema ``version``, and return its wrapper."""
    def deco(f):
        opname = name or f.__name__.lstrip("_")
        amp_state = _amp._state

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            st = _state
            if st.depth:
                return f(*args, **kwargs)
            if st.static:
                out = _record_static(f, opname, args, kwargs)
                if out is not _EAGER:
                    return out
            if amp_state.enabled:
                args, kwargs = _cast(opname, args, kwargs)
            st.depth = 1
            try:
                out = f(*args, **kwargs)
            finally:
                st.depth = 0
            if _FLAGS["FLAGS_check_nan_inf"] and _nc.op_checks_on():
                _nc.check_op_outputs(opname, out)
            if type(out) is not _T:
                return wrap(out, args)
            for a in args:                 # _retype, inlined: the hot path
                if a is out:
                    return out.as_subclass(Tensor)
            out.__class__ = Tensor
            return out

        wrapper.raw = f
        wrapper.op_name = opname
        wrapper.op_version = int(version)
        f.op_name = opname
        f.op_version = int(version)
        OP_REGISTRY[opname] = wrapper
        return wrapper

    return deco(raw_fn) if raw_fn is not None else deco
