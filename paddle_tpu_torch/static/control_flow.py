"""Static-graph control flow: ``while_loop`` / ``cond`` with Program
sub-blocks (paddle_tpu/static/control_flow.py; reference
operators/controlflow/while_op.cc, conditional_block_op.cc,
fluid/layers/control_flow.py while_loop :1096, cond :2334).

A sub-block is a traced op list (``SubBlock``) closed over by one recorded
op whose kernel (``_WhileFn``, ``_CondFn``) runs it; free outer variables
are promoted to explicit op inputs. The JAX kernels lower to
``lax.while_loop`` / ``lax.cond``; here the replay reads each predicate on
the host, as the reference's interpreter does (one sync per branch or
iteration), and runs the block taken, so ``cond`` differentiates through
the branch taken and a ``while_loop`` through the iterations it ran
(``maximum_trip_count`` bounds them, the JAX masked-scan form's trip
count). The build-time shape checks and their messages are the JAX
package's.
"""
from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from .program import (Program, Variable, _Aval, _Ref, default_main_program,
                      force_program, in_static_mode, program_guard)

__all__ = ["while_loop", "cond", "SubBlock"]


class SubBlock:
    """A traced sub-program: op list + placeholder / free / output ids
    (the reference's BlockDesc owned by a control-flow op)."""

    def __init__(self, ops, in_ids, free_ids, out_ids):
        self.ops = list(ops)
        self.in_ids = list(in_ids)
        self.free_ids = list(free_ids)
        self.out_ids = list(out_ids)

    def run(self, carry_vals, free_vals):
        env = dict(zip(self.in_ids, carry_vals))
        env.update(zip(self.free_ids, free_vals))
        for op in self.ops:
            vals = [env[x.var_id] if isinstance(x, _Ref) else x
                    for x in op.flat]
            kw = pytree.tree_unflatten(vals[op.n_args:], op.kw_tree)
            out = op.fn(*vals[:op.n_args], **kw)
            if len(op.out_ids) == 1 and not isinstance(out, (tuple, list)):
                env[op.out_ids[0]] = out
            else:
                for oid, v in zip(op.out_ids, out):
                    env[oid] = v
        return [env[i] for i in self.out_ids]

    def out_avals(self, carry_avals, free_avals):
        env = dict(zip(self.in_ids, carry_avals))
        env.update(zip(self.free_ids, free_avals))
        for op in self.ops:
            for oid, v in zip(op.out_ids, op.out_vars):
                env[oid] = v.aval
        return [env[i] for i in self.out_ids]


def _aval(v):
    """Shape/dtype of a loop var: a Variable or an eager initial value
    (constants such as ops.zeros run eagerly in static mode too)."""
    if isinstance(v, (Variable, _Aval)):
        return v.aval if isinstance(v, Variable) else v
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return _Aval(tuple(t.shape), t.dtype)


def _parent_programs():
    from .program import _state
    return _state.cf_parents


def _trace_subblock(fn, arg_vars, name):
    """Trace ``fn`` over fresh placeholders into its own Program; returns
    (ops, placeholder_ids, out_vars, free_ids)."""
    sub = Program(name)
    parent = default_main_program()
    sub._device = parent.device
    ph = [Variable(_aval(v).shape, _aval(v).dtype, program=sub)
          for v in arg_vars]
    sub._cf_placeholders = ph
    parents = _parent_programs()
    parents.append(parent)
    try:
        with program_guard(sub), force_program(sub):
            out = fn(*ph)
    finally:
        parents.pop()
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    for o in outs:
        if not isinstance(o, Variable):
            raise TypeError(
                f"{name}: sub-block functions must return static Variables "
                f"(got {type(o).__name__}); return values must be computed "
                "from the loop variables / captured Variables")
    produced = {oid for op in sub.ops for oid in op.out_ids}
    produced |= {p.var_id for p in ph}
    seen = {}
    for op in sub.ops:
        for x in op.flat:
            if isinstance(x, _Ref) and x.var_id not in produced:
                seen[x.var_id] = x.name
    for o in outs:
        if o.var_id not in produced:
            seen[o.var_id] = o.name
    return sub.ops, [p.var_id for p in ph], outs, seen


def _resolve_free(free_map):
    """free var_id -> the outer Variable objects, searched in the current
    program and every enclosing sub-block trace."""
    progs = [default_main_program()] + list(reversed(_parent_programs()))
    by_id = {}
    for main in progs:
        for v in main.data_vars.values():
            by_id.setdefault(v.var_id, v)
        for v in main.persistable_vars.values():
            by_id.setdefault(v.var_id, v)
        for op in main.ops:
            for v in op.out_vars:
                by_id.setdefault(v.var_id, v)
        for ph in getattr(main, "_cf_placeholders", ()):
            by_id.setdefault(ph.var_id, ph)
    missing = [name for vid, name in free_map.items() if vid not in by_id]
    if missing:
        raise ValueError(
            f"control-flow sub-block captured variables not visible in the "
            f"current program: {missing}; pass them through loop_vars or "
            "build them in the same program")
    return [by_id[vid] for vid in free_map]


def _check_scalar_bool(var, what):
    size = 1
    for s in var.aval.shape:
        size *= s
    if size != 1:
        raise ValueError(
            f"{what} must produce a scalar boolean, got shape "
            f"{tuple(var.aval.shape)}")


def _truth(t):
    return bool(t.reshape(()).item()) if isinstance(t, torch.Tensor) \
        else bool(t)


class _WhileFn:
    """Kernel of a recorded while op: the body while the predicate holds,
    at most ``max_trip`` times when that is set."""

    def __init__(self, cond_block, body_block, n_loop, max_trip=None):
        self.cond_block = cond_block
        self.body_block = body_block
        self.n_loop = n_loop
        self.max_trip = max_trip

    def __call__(self, *vals):
        carry = list(vals[:self.n_loop])
        free = list(vals[self.n_loop:])
        trips = 0
        while (self.max_trip is None or trips < self.max_trip) \
                and _truth(self.cond_block.run(carry, free)[0]):
            outs = self.body_block.run(carry, free)
            carry = [torch.as_tensor(o, device=i.device).to(i.dtype)
                     .reshape(i.shape) for o, i in zip(outs, carry)]
            trips += 1
        return tuple(carry)

    def abstract(self, *avals):
        return tuple(avals[:self.n_loop])


class _CondFn:
    def __init__(self, true_block, false_block):
        self.true_block = true_block
        self.false_block = false_block

    def __call__(self, pred, *free):
        blk = self.true_block if _truth(pred) else self.false_block
        return tuple(blk.run([], list(free)))

    def abstract(self, pred, *free):
        return tuple(self.true_block.out_avals([], list(free)))


def _record(fn, name, args):
    from ..ops._dispatch import _record_static
    return _record_static(fn, name, tuple(args), {})


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None,
               maximum_trip_count=None):
    """reference fluid/layers/control_flow.py:1096 while_loop. Static
    mode records one op; dygraph runs a plain Python loop."""
    loop_vars = list(loop_vars)
    if not loop_vars:
        raise ValueError("loop_vars must be non-empty")
    if not (in_static_mode() and any(isinstance(v, Variable)
                                     for v in loop_vars)):
        vals = loop_vars
        while _truth(cond_fn(*vals)):
            out = body_fn(*vals)
            vals = list(out) if isinstance(out, (tuple, list)) else [out]
        return vals

    c_ops, c_ph, c_outs, c_free = _trace_subblock(cond_fn, loop_vars,
                                                  "while_cond")
    if len(c_outs) != 1:
        raise ValueError("while_loop cond must return exactly one value")
    _check_scalar_bool(c_outs[0], "while_loop cond")
    b_ops, b_ph, b_outs, b_free = _trace_subblock(body_fn, loop_vars,
                                                  "while_body")
    if len(b_outs) != len(loop_vars):
        raise ValueError(
            f"while_loop body returned {len(b_outs)} values for "
            f"{len(loop_vars)} loop_vars")
    for i, (lv, bo) in enumerate(zip(loop_vars, b_outs)):
        la = _aval(lv)
        if tuple(bo.aval.shape) != tuple(la.shape) \
                or bo.aval.dtype != la.dtype:
            raise ValueError(
                f"while_loop shape invariant violated for loop_var {i}: "
                f"carry is {tuple(la.shape)}/{la.dtype} but body "
                f"returns {tuple(bo.aval.shape)}/{bo.aval.dtype} (XLA "
                "While requires a fixed carry shape — pad or restructure)")

    free_map = dict(c_free)
    free_map.update(b_free)
    free_vars = _resolve_free(free_map)
    free_ids = list(free_map)
    fn = _WhileFn(SubBlock(c_ops, c_ph, free_ids, [c_outs[0].var_id]),
                  SubBlock(b_ops, b_ph, free_ids,
                           [o.var_id for o in b_outs]),
                  len(loop_vars), maximum_trip_count)
    out = _record(fn, "while_loop", tuple(loop_vars) + tuple(free_vars))
    return list(out) if isinstance(out, (tuple, list)) else [out]


def cond(pred, true_fn=None, false_fn=None, name=None):
    """reference fluid/layers/control_flow.py:2334 cond."""
    if true_fn is None or false_fn is None:
        raise ValueError("cond requires both true_fn and false_fn (they "
                         "must return the same structure)")
    if not (in_static_mode() and isinstance(pred, Variable)):
        return true_fn() if _truth(pred) else false_fn()

    _check_scalar_bool(pred, "cond pred")
    t_ops, _, t_outs, t_free = _trace_subblock(lambda: true_fn(), [],
                                               "cond_true")
    f_ops, _, f_outs, f_free = _trace_subblock(lambda: false_fn(), [],
                                               "cond_false")
    if len(t_outs) != len(f_outs):
        raise ValueError(
            f"cond branches return different numbers of values: "
            f"{len(t_outs)} vs {len(f_outs)}")
    for i, (t, f) in enumerate(zip(t_outs, f_outs)):
        if tuple(t.aval.shape) != tuple(f.aval.shape) \
                or t.aval.dtype != f.aval.dtype:
            raise ValueError(
                f"cond branch output {i} mismatch: true is "
                f"{tuple(t.aval.shape)}/{t.aval.dtype}, false is "
                f"{tuple(f.aval.shape)}/{f.aval.dtype}")

    free_map = dict(t_free)
    free_map.update(f_free)
    free_vars = _resolve_free(free_map)
    free_ids = list(free_map)
    fn = _CondFn(SubBlock(t_ops, [], free_ids, [o.var_id for o in t_outs]),
                 SubBlock(f_ops, [], free_ids, [o.var_id for o in f_outs]))
    out = _record(fn, "cond", (pred,) + tuple(free_vars))
    if isinstance(out, (tuple, list)) and len(out) == 1:
        return out[0]
    return out
