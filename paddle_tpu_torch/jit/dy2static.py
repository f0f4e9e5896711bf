"""Dygraph-to-static conversion of Python control flow
(paddle_tpu/jit/dy2static.py).

A function decorated with ``@to_static`` (or a Layer that ``jit.save``
records) gets its ``if`` / ``while`` / ``for range(...)`` statements
rewritten so that branching on tensor values works in both regimes of the
port:

- eager values     -> plain Python control flow (semantics unchanged);
- static Variables -> ``static.control_flow.cond`` / ``while_loop``,
                      recorded into the Program as sub-block ops, so
                      ``jit.save`` serializes them and the Executor
                      replays them.

The JAX package has a third regime, jax tracers under ``jax.jit``
(``lax.cond`` / ``lax.while_loop``); the port's ``to_static`` runs the
converted function eagerly, so it has no tracer regime. The AST rewriter
below (from "AST analysis" on) is the JAX package's pure-Python code, kept
as the port's own copy; only the runtime helpers above it differ.

Restrictions (each falls back to untransformed Python, which still works
for non-tensor predicates): bare ``break``/``continue`` inside a converted
loop body (returns lift via the early-return fold), ``global``/``nonlocal``
in the function, and functions whose source is unavailable.
``convert_layer`` recurses into sublayers, so control flow anywhere in a
Layer call tree converts; plain helper functions called from a forward
are not rewritten.
"""
from __future__ import annotations

import ast
import functools
import inspect
import sys
import textwrap
import types
import warnings

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = ["convert_function", "convert_layer", "Dy2StaticError"]

_PREFIX = "__jst"


class Dy2StaticError(TypeError):
    pass


class _Undefined:
    """Placeholder for a local that is not yet bound when a branch/loop
    starts (the reference's UndefinedVar, return_transformer.py)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined local>"


UNDEF = _Undefined()


# ---------------------------------------------------------------------------
# runtime value helpers
# ---------------------------------------------------------------------------

def _variable_cls():
    from ..static.program import Variable
    return Variable


def _is_symbolic_static(v):
    return isinstance(v, _variable_cls())


def _is_carry(v):
    """Values that can ride a static carry: tensors, arrays, numbers;
    None / UNDEF / other objects are aux."""
    if isinstance(v, _Undefined) or v is None:
        return False
    return isinstance(v, (torch.Tensor, np.ndarray, bool, int, float,
                          np.number, np.bool_))


def _truthy(v):
    if isinstance(v, torch.Tensor):
        return bool(v.reshape(-1).item()) if v.numel() == 1 else bool(v)
    if isinstance(v, (np.ndarray, np.generic)):
        return bool(np.asarray(v))
    return bool(v)          # Python values and containers: their own truth


def _aux_equal(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x is y:
            continue
        try:
            if bool(np.asarray(x == y).all()):
                continue
        except Exception:
            return False
        return False
    return True


def pack(*getters):
    """Snapshot current values of the threaded locals; unbound locals
    become UNDEF (they may be bound inside a branch)."""
    out = []
    for g in getters:
        try:
            out.append(g())
        except (NameError, UnboundLocalError):
            out.append(UNDEF)
    return tuple(out)


# ---------------------------------------------------------------------------
# runtime converters
# ---------------------------------------------------------------------------

def convert_ifelse(pred, true_fn, false_fn, args):
    args = tuple(args)
    if _is_symbolic_static(pred):
        return _static_ifelse(pred, true_fn, false_fn, args)
    return tuple(true_fn(args)) if _truthy(pred) else tuple(false_fn(args))


class _StaticSpec:
    """Partition a tuple of locals into carry leaves (pytrees whose leaves
    are all tensors / arrays / numbers; each becomes a sub-block Variable,
    eager constants through a recorded assign) and opaque aux values."""

    def __init__(self, values):
        from .. import ops
        self.slots = []
        self.vars = []
        for v in values:
            leaves, td = pytree.tree_flatten(v)
            if leaves and all(_is_carry(l) for l in leaves):
                self.slots.append(("P", td, len(leaves)))
                for l in leaves:
                    self.vars.append(
                        l if _is_symbolic_static(l)
                        else ops.assign(l if isinstance(l, torch.Tensor)
                                        else torch.as_tensor(np.asarray(l))))
            else:
                self.slots.append(("X", v))

    def aux(self):
        return [s[1] for s in self.slots if s[0] == "X"]

    def signature(self):
        return [(s[0], str(s[1]), s[2]) if s[0] == "P" else "X"
                for s in self.slots]

    def rebuild(self, variables):
        out, it = [], iter(variables)
        for slot in self.slots:
            if slot[0] == "X":
                out.append(slot[1])
            else:
                _, td, n = slot
                out.append(pytree.tree_unflatten(
                    [next(it) for _ in range(n)], td))
        return tuple(out)


def _static_ifelse(pred, true_fn, false_fn, args):
    from ..static.control_flow import (SubBlock, _CondFn, _check_scalar_bool,
                                       _record, _resolve_free,
                                       _trace_subblock)
    rec = {}

    def mk(fn, tag):
        def g():
            spec = _StaticSpec(list(fn(args)))
            rec[tag] = spec
            return tuple(spec.vars)
        return g

    _check_scalar_bool(pred, "converted `if` predicate")
    t_ops, _, t_outs, t_free = _trace_subblock(mk(true_fn, "t"), [],
                                               "dy2st_true")
    f_ops, _, f_outs, f_free = _trace_subblock(mk(false_fn, "f"), [],
                                               "dy2st_false")
    st, sf = rec["t"], rec["f"]
    if st.signature() != sf.signature():
        raise Dy2StaticError(
            "converted `if` on a static Variable: branches disagree on "
            "which locals are graph values; bind each assigned local as a "
            "tensor in both branches")
    if not _aux_equal(st.aux(), sf.aux()):
        raise Dy2StaticError(
            "converted `if` on a static Variable assigns different "
            f"non-tensor Python values per branch "
            f"({st.aux()!r} vs {sf.aux()!r})")
    if not t_outs:  # nothing graph-valued changes: branches were no-ops
        return st.rebuild([])
    for i, (t, f) in enumerate(zip(t_outs, f_outs)):
        if tuple(t.aval.shape) != tuple(f.aval.shape) \
                or t.aval.dtype != f.aval.dtype:
            raise Dy2StaticError(
                f"converted `if` branch output {i}: true branch is "
                f"{tuple(t.aval.shape)}/{t.aval.dtype} but false branch is "
                f"{tuple(f.aval.shape)}/{f.aval.dtype}")
    free_map = dict(t_free)
    free_map.update(f_free)
    free_vars = _resolve_free(free_map)
    free_ids = list(free_map)
    fn = _CondFn(SubBlock(t_ops, [], free_ids, [o.var_id for o in t_outs]),
                 SubBlock(f_ops, [], free_ids, [o.var_id for o in f_outs]))
    res = _record(fn, "cond", (pred,) + tuple(free_vars))
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    return st.rebuild(res)


def convert_while(cond_fn, body_fn, args):
    args = tuple(args)
    # sniff the regime from the carried values first: evaluating the test
    # in static mode would record its ops into the outer Program as dead
    # code (they are traced again into the while op's own sub-block)
    leaves = [l for v in args for l in pytree.tree_flatten(v)[0]]
    if any(_is_symbolic_static(l) for l in leaves):
        return _static_while(cond_fn, body_fn, args)
    first = cond_fn(args)
    if _is_symbolic_static(first):
        return _static_while(cond_fn, body_fn, args)
    vals = args
    ok = _truthy(first)
    while ok:
        vals = tuple(body_fn(vals))
        if len(vals) != len(args):
            raise Dy2StaticError("loop body changed the number of locals")
        ok = _truthy(cond_fn(vals))
    return vals


def _static_while(cond_fn, body_fn, args):
    from ..static import control_flow as cf

    in_spec = _StaticSpec(args)
    if not in_spec.vars:
        raise Dy2StaticError(
            "converted `while` with a graph-value predicate carries no "
            "tensor locals — the loop would be unobservable; thread a "
            "tensor through it")

    def c(*vs):
        return cond_fn(in_spec.rebuild(vs))

    def b(*vs):
        out = list(body_fn(in_spec.rebuild(vs)))
        spec = _StaticSpec(out)
        if spec.signature() != in_spec.signature():
            raise Dy2StaticError(
                "converted `while` in static mode: a loop-carried local "
                "changed its tensor structure inside the body")
        if not _aux_equal(spec.aux(), in_spec.aux()):
            raise Dy2StaticError(
                "converted `while` in static mode mutates a non-tensor "
                f"Python value per iteration ({in_spec.aux()!r} -> "
                f"{spec.aux()!r})")
        return tuple(spec.vars)

    res = cf.while_loop(c, b, list(in_spec.vars))
    return in_spec.rebuild(res)


def unpack_range(*rargs):
    if len(rargs) == 1:
        return 0, rargs[0], 1
    if len(rargs) == 2:
        return rargs[0], rargs[1], 1
    return rargs


def range_cond(i, stop, step):
    if isinstance(step, (int, float)) or isinstance(step, np.number):
        return i < stop if step > 0 else i > stop
    from .. import ops
    return ops.where(step > 0, i < stop, i > stop)


def _symbolic(v):
    return _is_symbolic_static(v)


def and_(*fns):
    val = fns[0]()
    for f in fns[1:]:
        if _symbolic(val):
            from .. import ops
            val = ops.logical_and(val, f())
        elif not _truthy(val):
            return val
        else:
            val = f()
    return val


def or_(*fns):
    val = fns[0]()
    for f in fns[1:]:
        if _symbolic(val):
            from .. import ops
            val = ops.logical_or(val, f())
        elif _truthy(val):
            return val
        else:
            val = f()
    return val


def not_(v):
    if _symbolic(v):
        from .. import ops
        return ops.logical_not(v)
    return not _truthy(v)


# ---------------------------------------------------------------------------
# AST analysis
# ---------------------------------------------------------------------------

_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                   ast.ClassDef, ast.ListComp, ast.SetComp, ast.DictComp,
                   ast.GeneratorExp)


def _assigned_names(stmts):
    """Names bound at statement level (descending into compound statements
    but not into nested scopes). Generated helper names are excluded."""
    names = set()

    def walk(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
            return
        if isinstance(node, _SCOPE_BARRIERS):
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                     (ast.Store, ast.Del)):
            names.add(node.id)
        for child in ast.iter_child_nodes(node):
            walk(child)

    for st in stmts:
        walk(st)
    return names


def _loads(node_or_stmts):
    """All Name loads, including inside nested scopes (conservative for
    liveness)."""
    names = set()
    nodes = node_or_stmts if isinstance(node_or_stmts, list) \
        else [node_or_stmts]
    for n in nodes:
        if n is None:
            continue
        for sub in ast.walk(n):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                names.add(sub.id)
    return names


def _reads_before_write(stmts):
    """Names read before any definite write along a straight-line walk of
    `stmts` (loop-carried dependencies). Conservative: branch writes only
    count when both branches write; loop bodies contribute reads but no
    definite writes."""
    rbw = set()

    def expr_reads(node, written):
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id not in written:
                rbw.add(sub.id)

    def targets_of(t, acc):
        if isinstance(t, ast.Name):
            acc.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                targets_of(e, acc)
        elif isinstance(t, ast.Starred):
            targets_of(t.value, acc)

    def walk(sts, written):
        for st in sts:
            if isinstance(st, ast.Assign):
                expr_reads(st.value, written)
                for t in st.targets:
                    if isinstance(t, (ast.Subscript, ast.Attribute)):
                        expr_reads(t, written)
                    else:
                        targets_of(t, written)
            elif isinstance(st, ast.AugAssign):
                expr_reads(st.value, written)
                expr_reads(st.target, written)
                targets_of(st.target, written)
            elif isinstance(st, ast.AnnAssign):
                expr_reads(st.value, written)
                if st.value is not None:
                    targets_of(st.target, written)
            elif isinstance(st, ast.If):
                expr_reads(st.test, written)
                wb, wo = set(written), set(written)
                walk(st.body, wb)
                walk(st.orelse, wo)
                written |= (wb & wo)
            elif isinstance(st, ast.While):
                expr_reads(st.test, written)
                walk(st.body, set(written))
                walk(st.orelse, set(written))
            elif isinstance(st, ast.For):
                expr_reads(st.iter, written)
                inner = set(written)
                targets_of(st.target, inner)
                walk(st.body, inner)
                walk(st.orelse, set(written))
            elif isinstance(st, ast.With):
                for item in st.items:
                    expr_reads(item.context_expr, written)
                    if item.optional_vars is not None:
                        targets_of(item.optional_vars, written)
                walk(st.body, written)
            elif isinstance(st, ast.Try):
                walk(st.body, set(written))
                for h in st.handlers:
                    walk(h.body, set(written))
                walk(st.orelse, set(written))
                walk(st.finalbody, written)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                expr_reads(ast.Module(body=[st], type_ignores=[]), written)
                written.add(st.name)
            else:
                expr_reads(st, written)
        return written

    walk(list(stmts), set())
    return rbw


def _has_nodes(stmts, kinds, *, loop_level=False):
    """Whether `kinds` appear in stmts, not descending into nested scopes;
    with loop_level=True, also not into nested loops (break/continue bind
    to the nearest loop)."""
    barrier = _SCOPE_BARRIERS + ((ast.For, ast.While, ast.AsyncFor)
                                 if loop_level else ())

    def walk(node):
        if isinstance(node, kinds):
            return True
        if isinstance(node, barrier):
            # barrier applies to the node itself too: generated helper
            # FunctionDefs sit at statement level, and their internal
            # returns must not count as the enclosing function's
            return False
        for child in ast.iter_child_nodes(node):
            if walk(child):
                return True
        return False

    return any(walk(st) for st in stmts)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _make_fdef(name, params, body):
    """Version-portable FunctionDef construction (py3.12 adds
    type_params as a required compile-time field)."""
    kw = {}
    if sys.version_info >= (3, 12):
        kw["type_params"] = []
    return ast.FunctionDef(
        name=name,
        args=ast.arguments(posonlyargs=[],
                           args=[ast.arg(arg=p) for p in params],
                           kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=body, decorator_list=[], **kw)


def _jst_call(fn, *args):
    return ast.Call(
        func=ast.Attribute(value=_name("__jst__"), attr=fn, ctx=ast.Load()),
        args=list(args), keywords=[])


def _lambda0(body):
    return ast.Lambda(
        args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                           kw_defaults=[], defaults=[]),
        body=body)


def _pack_call(varnames):
    return _jst_call("pack", *[_lambda0(_name(v)) for v in varnames])


def _unpack_stmt(varnames, src_name):
    return ast.Assign(
        targets=[ast.Tuple(elts=[_name(v, ast.Store()) for v in varnames],
                           ctx=ast.Store())],
        value=_name(src_name))


class _CtrlFlowTransformer:
    def __init__(self):
        self.n = 0
        self.changed = False

    def _fresh(self, tag):
        self.n += 1
        return f"{_PREFIX}_{tag}_{self.n}"

    # -- statement blocks ---------------------------------------------------
    def visit_block(self, stmts, live_after, at_func_tail=False):
        out = []
        stmts = list(stmts)
        i = 0
        while i < len(stmts):
            st = stmts[i]
            rest = stmts[i + 1:]
            # early-return folding (reference return_transformer.py): when
            # an `if` body ends in `return`, the trailing statements are the
            # de-facto else branch — fold them in so the both-branches-
            # return lift applies
            if (isinstance(st, ast.If) and st.body
                    and isinstance(st.body[-1], ast.Return)):
                if rest:
                    st = ast.If(test=st.test, body=st.body,
                                orelse=list(st.orelse) + rest)
                    out.extend(self._visit_stmt(st, live_after))
                    return out  # rest moved inside the else
                if not st.orelse and at_func_tail:
                    st = ast.If(test=st.test, body=st.body,
                                orelse=[ast.Return(
                                    value=ast.Constant(value=None))])
            live = _loads(rest) | live_after
            out.extend(self._visit_stmt(st, live))
            i += 1
        return out

    def _visit_stmt(self, st, live):
        if isinstance(st, ast.If):
            return self._transform_if(st, live)
        if isinstance(st, ast.While):
            return self._transform_while(st, live)
        if isinstance(st, ast.For):
            return self._transform_for(st, live)
        if isinstance(st, ast.With):
            st.body = self.visit_block(st.body, live)
        elif isinstance(st, ast.Try):
            st.body = self.visit_block(st.body, live)
            for h in st.handlers:
                h.body = self.visit_block(h.body, live)
            st.orelse = self.visit_block(st.orelse, live)
            st.finalbody = self.visit_block(st.finalbody, live)
        return [st]

    # -- `if` ---------------------------------------------------------------
    def _transform_if(self, node, live):
        # names a branch reads before assigning, in the source as written
        # (before the nested rewrites add their own reads)
        rbw = _reads_before_write(node.body) | _reads_before_write(
            node.orelse)
        node.body = self.visit_block(node.body, live)
        node.orelse = self.visit_block(node.orelse, live)
        return self._transform_if_visited(node, live, rbw)

    def _transform_if_visited(self, node, live, rbw=frozenset()):
        # lift `if c: ...; return e1 else: ...; return e2` into an
        # assignment + single return, so tensor-pred branches that return
        # still convert (reference return_transformer.py, the common case)
        if (node.body and isinstance(node.body[-1], ast.Return)
                and node.orelse and isinstance(node.orelse[-1], ast.Return)
                and not _has_nodes(node.body[:-1] + node.orelse[:-1],
                                   (ast.Return,))):
            rname = self._fresh("ret")

            def lift(stmts):
                val = stmts[-1].value
                if val is None:
                    val = ast.Constant(value=None)
                return stmts[:-1] + [ast.Assign(
                    targets=[_name(rname, ast.Store())], value=val)]

            new_if = ast.If(test=node.test, body=lift(node.body),
                            orelse=lift(node.orelse))
            out = self._transform_if_visited(new_if, set(live) | {rname},
                                             rbw)
            return out + [ast.Return(value=_name(rname))]
        both = node.body + node.orelse
        if _has_nodes(both, (ast.Return,)) \
                or _has_nodes(both, (ast.Break, ast.Continue),
                              loop_level=True):
            return [node]
        assigned = _assigned_names(node.body) | _assigned_names(node.orelse)
        # a name a branch assigns is local to the branch function, so one
        # it also reads before assigning must come in through the args
        # (the JAX rewriter threads only the names live after the `if`,
        # and a folded early return that rebinds an outer local reads it
        # unbound)
        thread = sorted(assigned & (set(live) | rbw))
        self.changed = True
        test = self._convert_test(node.test)
        tname, tdef = self._branch_fn(self._fresh("true"), node.body, thread)
        fname, fdef = self._branch_fn(self._fresh("false"), node.orelse,
                                      thread)
        args_name = self._fresh("args")
        if not thread:
            # branches assign nothing observable: keep the call for its
            # eager side effects; traced/static regimes no-op it
            return [tdef, fdef, ast.Expr(value=_jst_call(
                "convert_ifelse", test, _name(tname), _name(fname),
                ast.Tuple(elts=[], ctx=ast.Load())))]
        return [
            tdef, fdef,
            ast.Assign(targets=[_name(args_name, ast.Store())],
                       value=_pack_call(thread)),
            ast.Assign(
                targets=[ast.Tuple(
                    elts=[_name(v, ast.Store()) for v in thread],
                    ctx=ast.Store())],
                value=_jst_call("convert_ifelse", test, _name(tname),
                                _name(fname), _name(args_name))),
        ]

    def _branch_fn(self, name, body, thread):
        """def name(__jst_a): (v1,..) = __jst_a; <body>; return pack(..)
        For thread == [] returns a lambda-form function taking and
        returning an empty tuple."""
        param = self._fresh("a")
        stmts = ([_unpack_stmt(thread, param)] if thread else [])
        stmts += list(body)
        stmts.append(ast.Return(value=_pack_call(thread)))
        fdef = _make_fdef(name, [param], stmts)
        return name, fdef

    # -- `while` ------------------------------------------------------------
    def _transform_while(self, node, live):
        body_live = _loads(node.body) | _loads(node.test) | live
        node.body = self.visit_block(node.body, body_live)
        if _has_nodes(node.body, (ast.Break, ast.Continue), loop_level=True) \
                or _has_nodes(node.body, (ast.Return,)):
            node.orelse = self.visit_block(node.orelse, live)
            return [node]
        assigned = _assigned_names(node.body)
        thread = sorted(assigned & (_loads(node.test) | live
                                    | _reads_before_write(node.body)))
        if not thread:
            node.orelse = self.visit_block(node.orelse, live)
            return [node]
        self.changed = True
        param_c, param_b = self._fresh("a"), self._fresh("a")
        cname, bname = self._fresh("cond"), self._fresh("body")
        cdef = _make_fdef(cname, [param_c],
                          [_unpack_stmt(thread, param_c),
                           ast.Return(value=self._convert_test(node.test))])
        bdef = _make_fdef(bname, [param_b],
                          [_unpack_stmt(thread, param_b)] + list(node.body)
                          + [ast.Return(value=_pack_call(thread))])
        args_name = self._fresh("args")
        out = [
            cdef, bdef,
            ast.Assign(targets=[_name(args_name, ast.Store())],
                       value=_pack_call(thread)),
            ast.Assign(
                targets=[ast.Tuple(
                    elts=[_name(v, ast.Store()) for v in thread],
                    ctx=ast.Store())],
                value=_jst_call("convert_while", _name(cname), _name(bname),
                                _name(args_name))),
        ]
        out.extend(self.visit_block(node.orelse, live))
        return out

    # -- `for i in range(...)` ---------------------------------------------
    def _transform_for(self, node, live):
        is_range = (isinstance(node.iter, ast.Call)
                    and isinstance(node.iter.func, ast.Name)
                    and node.iter.func.id == "range"
                    and not node.iter.keywords
                    and 1 <= len(node.iter.args) <= 3
                    and isinstance(node.target, ast.Name))
        if not is_range \
                or _has_nodes(node.body, (ast.Break, ast.Continue),
                              loop_level=True) \
                or _has_nodes(node.body, (ast.Return,)):
            body_live = _loads(node.body) | _loads(node.iter) | live
            node.body = self.visit_block(node.body, body_live)
            node.orelse = self.visit_block(node.orelse, live)
            return [node]
        i = node.target.id
        stop_n, step_n = self._fresh("stop"), self._fresh("step")
        start_n, ctr = self._fresh("start"), self._fresh("ctr")
        setup = ast.Assign(
            targets=[ast.Tuple(elts=[_name(start_n, ast.Store()),
                                     _name(stop_n, ast.Store()),
                                     _name(step_n, ast.Store())],
                               ctx=ast.Store())],
            value=_jst_call("unpack_range", *node.iter.args))
        # dedicated counter: the loop variable is assigned from it at the
        # top of each iteration, so body reassignment of `i` doesn't change
        # iteration, and post-loop `i` holds the last iterate (Python for
        # semantics)
        init = ast.Assign(targets=[_name(ctr, ast.Store())],
                          value=_name(start_n))
        bind = ast.Assign(targets=[_name(i, ast.Store())],
                          value=_name(ctr))
        incr = ast.Assign(
            targets=[_name(ctr, ast.Store())],
            value=ast.BinOp(left=_name(ctr), op=ast.Add(),
                            right=_name(step_n)))
        wh = ast.While(
            test=_jst_call("range_cond", _name(ctr), _name(stop_n),
                           _name(step_n)),
            body=[bind] + list(node.body) + [incr],
            orelse=list(node.orelse))
        return [setup, init] + self._transform_while(wh, live)

    # -- predicates ---------------------------------------------------------
    def _convert_test(self, e):
        if isinstance(e, ast.BoolOp):
            fn = "and_" if isinstance(e.op, ast.And) else "or_"
            return _jst_call(fn, *[_lambda0(self._convert_test(v))
                                   for v in e.values])
        if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not):
            return _jst_call("not_", self._convert_test(e.operand))
        return e


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def convert_function(fn):
    """Return a control-flow-converted version of `fn` (cached); `fn`
    itself when there is nothing to convert or conversion is unsupported."""
    cached = getattr(fn, "__dy2st_fn__", None)
    if cached is not None:
        return cached
    if getattr(fn, "__dy2st_is_converted__", False):
        return fn
    try:
        converted = _convert(fn)
    except (OSError, TypeError, SyntaxError, IndentationError, ValueError):
        # source unavailable (builtins, REPL, C ext) or empty closure
        # cells (self-referential nested defs) — run unconverted
        converted = fn
    try:
        fn.__dy2st_fn__ = converted
    except (AttributeError, TypeError):
        pass
    return converted


def _convert(fn):
    """AST-rewrite `fn`'s control flow; returns the converted function.

    Globals semantics (deliberate, pinned by
    tests/test_dy2static.py::test_monkeypatch_after_convert): the
    converted function executes against `fn.__globals__` ITSELF — the
    live module dict, not a snapshot — so monkeypatching a module global
    after conversion is seen by the converted function exactly as it
    would be by the original (reference program_translator.py builds its
    StaticFunction over the original function object for the same
    reason). The `__jst__` helper module is therefore NOT injected into
    the user's globals; it is passed as the first parameter of the
    compiled factory, so the rewritten body resolves `__jst__` through
    the factory's closure and a user global named `__jst__` is never
    read nor shadowed (see docs/dy2static.md)."""
    if not isinstance(fn, types.FunctionType):
        return fn
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
        return fn
    if not any(isinstance(n, (ast.If, ast.While, ast.For))
               for n in ast.walk(fdef)):
        return fn
    if any(isinstance(n, (ast.Global, ast.Nonlocal, ast.Yield,
                          ast.YieldFrom, ast.Await))
           for n in ast.walk(fdef)):
        return fn
    fdef.decorator_list = []
    tr = _CtrlFlowTransformer()
    fdef.body = tr.visit_block(fdef.body, frozenset(), at_func_tail=True)
    if not tr.changed:
        return fn
    freevars = fn.__code__.co_freevars
    if "__jst__" in freevars:
        return fn  # would collide with the helper parameter; run as-is
    factory = ast.FunctionDef(
        name="__jst_factory__",
        args=ast.arguments(posonlyargs=[],
                           args=[ast.arg(arg="__jst__")]
                           + [ast.arg(arg=v) for v in freevars],
                           kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=[fdef, ast.Return(value=_name(fdef.name))],
        decorator_list=[])
    mod = ast.Module(body=[factory], type_ignores=[])
    ast.fix_missing_locations(mod)
    code = compile(mod, f"<dy2static:{getattr(fn, '__qualname__', '?')}>",
                   "exec")
    # exec against the LIVE globals (separate locals keep __jst_factory__
    # out of the user's module namespace)
    ns = {}
    exec(code, fn.__globals__, ns)
    cells = [c.cell_contents for c in (fn.__closure__ or ())]
    new_fn = ns["__jst_factory__"](sys.modules[__name__], *cells)
    new_fn.__defaults__ = fn.__defaults__
    new_fn.__kwdefaults__ = fn.__kwdefaults__
    functools.update_wrapper(new_fn, fn, updated=())
    new_fn.__dy2st_is_converted__ = True
    return new_fn


def convert_layer(layer, recursive=True, installed=None):
    """Convert `layer`'s forward in place (instance-level override, so
    hooks/recompute in Layer.__call__ still apply), and — like the
    reference's convert_call (program_translator.py) — recurse into
    sublayers so control flow anywhere in the call tree converts.
    Conversion is semantics-preserving for concrete predicates, so
    converting every forward is safe; per-class function results are
    cached, so repeat conversions are free.

    `installed`: optional list collecting every (sub)layer that received
    an instance-level forward here — jit.save uses it to undo the
    overrides after tracing so export does not permanently mutate the
    caller's model."""
    targets = (layer.sublayers(include_self=True) if recursive
               else [layer])
    for lyr in targets:
        cls_fwd = type(lyr).forward
        conv = convert_function(cls_fwd)
        if conv is not cls_fwd and "forward" not in lyr.__dict__:
            object.__setattr__(lyr, "forward",
                               types.MethodType(conv, lyr))
            if installed is not None:
                installed.append(lyr)
    return layer
