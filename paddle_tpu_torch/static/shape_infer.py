"""Abstract shape and dtype propagation over static Programs
(paddle_tpu/static/shape_infer.py).

The counterpart of ``jax.eval_shape``: an op's output shapes and dtypes
come from its registered rule (``register_infer_rule``, kept in
``ops/_dispatch.SHAPE_INFER_REGISTRY``) or else from its raw torch
function run on ``device="meta"`` tensors; an op neither can infer raises
``ShapeInferError`` naming it. The recording of a static op
(``ops/_dispatch._record_static``) and ``infer_program`` both go through
``infer_op``.

Rules take avals (``_Aval``: a (shape, dtype) pair with the JAX
ShapeDtypeStruct's attribute names) for tensor inputs and the Python
values of the rest, and return an aval or a tuple of them. The ops whose
raw function cannot run on meta tensors have rules: the kernel wrappers
of ``flash_sdpa`` and ``fused_ce_op`` take CPU or CUDA tensors only, and
the ops with data-dependent shapes (``masked_select``, ``bincount``)
raise by name; ``nonzero`` and ``unique`` read the host before any op
and raise there.

``analyze_memory`` is the JAX package's liveness-based peak-memory
estimate over the propagated avals.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..ops._dispatch import SHAPE_INFER_REGISTRY, raw_scope
from .program import Program, Variable, _Aval, _Ref

__all__ = ["ShapeInferError", "register_infer_rule", "infer_program",
           "analyze_memory", "infer_op", "SHAPE_INFER_REGISTRY"]


class ShapeInferError(RuntimeError):
    """Shape/dtype propagation found an inconsistency: ``op_name`` /
    ``op_index`` name the op, ``var`` the output variable."""

    def __init__(self, message, *, op_name=None, op_index=None, var=None):
        self.op_name = op_name
        self.op_index = op_index
        self.var = var
        where = ""
        if op_name is not None:
            where = f" [op #{op_index} '{op_name}']" \
                if op_index is not None else f" [op '{op_name}']"
        super().__init__(f"shape-infer{where}: {message}")


def register_infer_rule(*names):
    """Register an abstract rule for the named ops."""
    def deco(fn):
        for n in names:
            SHAPE_INFER_REGISTRY[n] = fn
        return fn
    return deco


def _is_aval(x):
    return isinstance(x, _Aval)


def _aval_of(x):
    if isinstance(x, torch.Tensor):
        return _Aval(tuple(x.shape), x.dtype)
    return x


def _nbytes(aval) -> int:
    n = int(np.prod(aval.shape, dtype=np.int64)) if aval.shape else 1
    return n * torch.empty((), dtype=aval.dtype).element_size()


def _meta(v):
    if _is_aval(v):
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    if isinstance(v, torch.Tensor):
        return torch.Tensor.detach(v).to("meta")
    return v


def _run(fn, vals, n_args, kw_tree):
    kw = pytree.tree_unflatten(vals[n_args:], kw_tree)
    return fn(*vals[:n_args], **kw)


def infer_op(fn, name, flat, n_args, kw_tree):
    """([(shape, dtype)] of ``fn``'s outputs, whether it returns a tuple)
    for the inputs ``flat`` (Variables, tensors, avals or Python values)."""
    vals = [_aval_of(v) for v in flat]
    rule = getattr(fn, "abstract", None) or SHAPE_INFER_REGISTRY.get(name)
    try:
        if rule is not None:
            out = _run(rule, vals, n_args, kw_tree)
        else:
            with raw_scope():
                out = _run(fn, [_meta(v) for v in vals], n_args, kw_tree)
    except ShapeInferError:
        raise
    except Exception as e:
        raise ShapeInferError(f"{type(e).__name__}: {e}",
                              op_name=name) from e
    multi = isinstance(out, (tuple, list))
    outs = list(out) if multi else [out]
    avals = []
    for o in outs:
        if isinstance(o, torch.Tensor) or _is_aval(o):
            a = _aval_of(o)
            avals.append((tuple(int(s) for s in a.shape), a.dtype))
        else:
            raise ShapeInferError(
                f"output of type {type(o).__name__} is not a tensor; a "
                "static op must return tensors", op_name=name)
    return avals, multi


# ---------------------------------------------------------------------------
# propagation
# ---------------------------------------------------------------------------

def _seed_env(program: Program) -> Dict[int, _Aval]:
    env = {}
    for v in program.data_vars.values():
        env[v.var_id] = v.aval
    for scope_name, vid in program.persist_ids.items():
        pv = program.persistable_vars.get(scope_name)
        if pv is not None:
            env[vid] = pv.aval
    return env


def _amp_cast(program, op_name, in_vals):
    """The Executor's program-level AMP cast on avals, and whether a
    gray-zone op receives mixed float dtypes."""
    from .. import amp as amp_mod
    white, black = getattr(program, "amp_lists", (None, None))
    dt = amp_mod.policy_dtype(op_name, program.amp_level,
                              getattr(program, "amp_dtype", torch.bfloat16),
                              white, black)
    float_dtypes = {v.dtype for v in in_vals
                    if _is_aval(v) and v.dtype.is_floating_point}
    mixed = len(float_dtypes) > 1
    if dt is None:
        return in_vals, mixed, float_dtypes
    out = [_Aval(v.shape, dt) if _is_aval(v) and v.dtype.is_floating_point
           and v.dtype != dt else v for v in in_vals]
    return out, False, float_dtypes


def infer_program(program: Program, check: bool = True,
                  amp_check: bool = True) -> Dict[int, _Aval]:
    """Propagate avals through the program; returns {var_id: aval}.

    ``check`` compares each op's inferred outputs with the recorded ones
    (shape always; dtype unless program-level AMP changes dtypes when the
    program runs) and raises ``ShapeInferError`` on a mismatch.
    ``amp_check`` also flags a gray-list op of an AMP program that
    receives mixed float dtypes (a silent promotion)."""
    env = _seed_env(program)
    amp_on = bool(getattr(program, "amp_level", None))
    violations: List[str] = []
    for i, op in enumerate(program.ops):
        in_vals = []
        for x in op.flat:
            if isinstance(x, _Ref):
                if x.var_id not in env:
                    raise ShapeInferError(
                        f"input '{x.name}' (id {x.var_id}) has no known "
                        "aval — the program is structurally broken (run "
                        "verify_program for the structural diagnosis)",
                        op_name=op.name, op_index=i, var=x.name)
                in_vals.append(env[x.var_id])
            else:
                in_vals.append(_aval_of(x))
        if amp_on:
            in_vals, mixed, float_dtypes = _amp_cast(program, op.name,
                                                     in_vals)
            if mixed and amp_check:
                violations.append(
                    f"op #{i} '{op.name}' mixes float dtypes "
                    f"{sorted(str(d) for d in float_dtypes)} in the AMP "
                    "gray zone — the promotion is silent; add the op to a "
                    "white/black list or cast explicitly")
        try:
            avals, _ = infer_op(op.fn, op.name, in_vals, op.n_args,
                                op.kw_tree)
        except ShapeInferError as e:
            e.op_index = i
            raise ShapeInferError(str(e).split("]: ", 1)[-1],
                                  op_name=op.name, op_index=i) from e
        if len(avals) != len(op.out_ids):
            raise ShapeInferError(
                f"kernel yields {len(avals)} outputs but the op records "
                f"{len(op.out_ids)}", op_name=op.name, op_index=i)
        for (shape, dtype), oid, ovar in zip(avals, op.out_ids,
                                             op.out_vars):
            if check:
                if tuple(shape) != tuple(ovar.shape):
                    raise ShapeInferError(
                        f"output '{ovar.name}' records shape "
                        f"{tuple(ovar.shape)} but propagation infers "
                        f"{tuple(shape)}", op_name=op.name,
                        op_index=i, var=ovar.name)
                if not amp_on and dtype != ovar.dtype:
                    raise ShapeInferError(
                        f"output '{ovar.name}' records dtype {ovar.dtype} "
                        f"but propagation infers {dtype}",
                        op_name=op.name, op_index=i, var=ovar.name)
            env[oid] = _Aval(shape, dtype)
    if violations:
        raise ShapeInferError("AMP boundary check failed:\n  "
                              + "\n  ".join(violations))
    return env


# ---------------------------------------------------------------------------
# liveness-based peak-memory estimate
# ---------------------------------------------------------------------------

def analyze_memory(program: Program, env: Optional[dict] = None,
                   shard_divisors: Optional[Dict[int, int]] = None,
                   op_range: Optional[Tuple[int, int]] = None) -> dict:
    """Estimate the replayed step's peak residency from inferred avals
    (the JAX package's liveness analysis, letter for letter): an
    intermediate is live from the op that defines it to its last reader,
    or to the end when it is fetched, state-written or the loss;
    persistables and feeds are resident throughout. ``shard_divisors``
    ({var_id: divisor}) divides a var's bytes; ``op_range`` = (lo, hi)
    restricts the estimate to that op slice.

    Returns {"peak_bytes", "param_bytes", "feed_bytes",
    "activation_peak_bytes", "timeline": [(op_name, live_bytes)],
    "peak_op"}. Autograd's saved tensors for the backward are not
    counted."""
    if env is None:
        env = infer_program(program, check=False, amp_check=False)
    divs = shard_divisors or {}

    def _nb(vid, aval):
        return _nbytes(aval) // max(int(divs.get(vid, 1)), 1)

    n = len(program.ops)
    lo, hi = (0, n) if op_range is None else op_range
    lo, hi = max(0, int(lo)), min(n, int(hi))

    last_use: Dict[int, int] = {}
    defined_at: Dict[int, int] = {}
    for i, op in enumerate(program.ops):
        for x in op.flat:
            if isinstance(x, _Ref):
                last_use[x.var_id] = i
        for oid in op.out_ids:
            defined_at[oid] = i

    used_in_range = None
    if op_range is not None:
        used_in_range = set()
        for op in program.ops[lo:hi]:
            for x in op.flat:
                if isinstance(x, _Ref):
                    used_in_range.add(x.var_id)

    param_bytes = 0
    param_ids = set()
    for scope_name, vid in program.persist_ids.items():
        pv = program.persistable_vars.get(scope_name)
        if pv is not None and (used_in_range is None
                               or vid in used_in_range):
            param_bytes += _nb(vid, pv.aval)
            param_ids.add(vid)
    feed_bytes = 0
    feed_ids = set()
    for v in program.data_vars.values():
        if used_in_range is None or v.var_id in used_in_range:
            feed_bytes += _nb(v.var_id, v.aval)
            feed_ids.add(v.var_id)
    if used_in_range is not None:
        for vid in used_in_range:
            if vid in param_ids or vid in feed_ids:
                continue
            if defined_at.get(vid, lo) < lo and vid in env:
                feed_bytes += _nb(vid, env[vid])
                feed_ids.add(vid)

    roots = set(program.state_writes.values())
    if program.backward_section is not None:
        loss, pairs = program.backward_section
        roots.add(loss.var_id)
    for v in getattr(program, "_jit_fetch_vars", []) or []:
        roots.add(v.var_id)
    for vid in roots:
        last_use[vid] = n
    if op_range is not None:
        roots = {vid for vid in roots if lo <= defined_at.get(vid, -1) < hi}

    timeline = []
    peak = param_bytes + feed_bytes
    peak_op = None
    live_bytes = 0
    live_now: Dict[int, int] = {}
    for i in range(lo, hi):
        op = program.ops[i]
        for oid in op.out_ids:
            if oid in env and last_use.get(oid, -1) >= i:
                b = _nb(oid, env[oid])
                live_now[oid] = b
                live_bytes += b
        total = param_bytes + feed_bytes + live_bytes
        timeline.append((op.name, total))
        if total > peak:
            peak, peak_op = total, (i, op.name)
        for vid in [v for v, last in list(live_now.items())
                    if last_use.get(v, -1) <= i and v not in roots]:
            live_bytes -= live_now.pop(vid)
    return {"peak_bytes": int(peak),
            "param_bytes": int(param_bytes),
            "feed_bytes": int(feed_bytes),
            "activation_peak_bytes": int(peak - param_bytes - feed_bytes),
            "timeline": timeline,
            "peak_op": peak_op}


# ---------------------------------------------------------------------------
# the rules: the JAX package's closed forms under torch's promotion (the
# port's float default is float32 where the JAX package runs with x64),
# then the kernel wrappers' and the host-reading ops'
# ---------------------------------------------------------------------------

def _result_dtype(*vals):
    """torch's promotion of the operands (avals as meta tensors of their
    shapes, so a 0-d tensor promotes as torch promotes it)."""
    parts = [_meta(v) for v in vals]
    if len(parts) == 2:
        x, y = parts
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            return torch.result_type(x, y)
        return torch.tensor(x + y).dtype
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return dt


def _float_dtype(v):
    dt = v.dtype if _is_aval(v) else torch.tensor(v).dtype
    if dt.is_floating_point or dt.is_complex:
        return dt
    return torch.get_default_dtype()


def _shape(x):
    return tuple(x.shape) if _is_aval(x) else ()


@register_infer_rule("add", "subtract", "multiply", "maximum", "minimum")
def _ew_binary(x, y, **kw):
    try:
        shape = np.broadcast_shapes(_shape(x), _shape(y))
    except ValueError:
        raise ValueError(
            f"elementwise operands do not broadcast: {_shape(x)} vs "
            f"{_shape(y)}") from None
    return _Aval(shape, _result_dtype(x, y))


@register_infer_rule("matmul")
def _matmul_rule(x, y, transpose_x=False, transpose_y=False, **kw):
    """The JAX package's matmul rule (ops/linalg.py ``_matmul_infer``):
    rank and contraction-dim errors with a named diagnostic."""
    xs, ys = list(x.shape), list(y.shape)
    if not xs or not ys:
        raise ValueError(
            f"matmul requires rank >= 1 operands, got {tuple(x.shape)} @ "
            f"{tuple(y.shape)}")
    if transpose_x and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    vec_x, vec_y = len(xs) == 1, len(ys) == 1
    if vec_x:
        xs = [1] + xs
    if vec_y:
        ys = ys + [1]
    if xs[-1] != ys[-2]:
        raise ValueError(
            f"matmul contraction mismatch: {tuple(x.shape)} @ "
            f"{tuple(y.shape)} contracts {xs[-1]} against {ys[-2]}"
            + (" (with transpose flags applied)"
               if transpose_x or transpose_y else ""))
    batch = np.broadcast_shapes(tuple(xs[:-2]), tuple(ys[:-2]))
    out = list(batch) + [xs[-2], ys[-1]]
    if vec_y:
        out = out[:-1]
    if vec_x:
        out = out[:-2] + out[-1:] if not vec_y else out[:-1]
    return _Aval(tuple(out), torch.promote_types(x.dtype, y.dtype))


@register_infer_rule("relu", "relu6", "leaky_relu", "silu", "gelu",
                     "hardswish", "softplus", "exp", "log", "sqrt",
                     "sigmoid", "tanh")
def _ew_unary_float(x, *a, **kw):
    return _Aval(_shape(x), _float_dtype(x))


@register_infer_rule("softmax", "log_softmax")
def _softmax_rule(x, axis=-1, **kw):
    nd = len(x.shape)
    if not -nd <= axis < nd:
        raise ValueError(f"softmax axis {axis} out of range for rank {nd}")
    return _Aval(tuple(x.shape), _float_dtype(x))


def _norm_axes(axis, nd):
    if axis is None:
        return tuple(range(nd))
    axes = axis if isinstance(axis, (tuple, list)) else [axis]
    out = []
    for a in axes:
        a = int(a)
        if not -nd <= a < nd:
            raise ValueError(f"reduce axis {a} out of range for rank {nd}")
        out.append(a % nd if nd else 0)
    return tuple(out)


def _reduce_shape(x, axis, keepdim):
    nd = len(x.shape)
    axes = set(_norm_axes(axis, nd))
    if keepdim:
        return tuple(1 if i in axes else s for i, s in enumerate(x.shape))
    return tuple(s for i, s in enumerate(x.shape) if i not in axes)


def _int_of(dt):
    return torch.int64 if dt == torch.bool else dt


@register_infer_rule("sum")
def _sum_rule(x, axis=None, dtype=None, keepdim=False, **kw):
    from ..core.dtype import to_torch_dtype
    dt = to_torch_dtype(dtype) if dtype is not None else (
        torch.int64 if not (x.dtype.is_floating_point or x.dtype.is_complex)
        else x.dtype)
    return _Aval(_reduce_shape(x, axis, keepdim), dt)


@register_infer_rule("prod")
def _prod_rule(x, axis=None, keepdim=False, dtype=None, **kw):
    from ..core.dtype import to_torch_dtype
    dt = to_torch_dtype(dtype) if dtype is not None else (
        torch.int64 if not (x.dtype.is_floating_point or x.dtype.is_complex)
        else x.dtype)
    return _Aval(_reduce_shape(x, axis, keepdim), dt)


@register_infer_rule("mean")
def _mean_rule(x, axis=None, keepdim=False, **kw):
    return _Aval(_reduce_shape(x, axis, keepdim), _float_dtype(x))


@register_infer_rule("max", "min")
def _minmax_rule(x, axis=None, keepdim=False, **kw):
    return _Aval(_reduce_shape(x, axis, keepdim), x.dtype)


@register_infer_rule("all", "any")
def _bool_reduce_rule(x, axis=None, keepdim=False, **kw):
    return _Aval(_reduce_shape(x, axis, keepdim), torch.bool)


@register_infer_rule("reshape")
def _reshape_rule(x, shape, **kw):
    size = int(np.prod(x.shape, dtype=np.int64))
    shape = [int(s) for s in shape]
    if shape.count(-1) > 1:
        raise ValueError(f"reshape shape {shape} has more than one -1")
    shape = [x.shape[i] if s == 0 and i < len(x.shape) else s
             for i, s in enumerate(shape)]
    if -1 in shape:
        rest = int(np.prod([s for s in shape if s != -1], dtype=np.int64))
        if rest == 0 or size % rest:
            raise ValueError(
                f"cannot infer -1 in reshape {tuple(x.shape)} -> {shape}")
        shape[shape.index(-1)] = size // rest
    if int(np.prod(shape, dtype=np.int64)) != size:
        raise ValueError(
            f"reshape size mismatch: {tuple(x.shape)} ({size} elements) "
            f"-> {tuple(shape)}")
    return _Aval(tuple(shape), x.dtype)


@register_infer_rule("transpose")
def _transpose_rule(x, perm=None, **kw):
    nd = len(x.shape)
    if perm is None:
        perm = list(range(nd))[::-1]
    if sorted(int(p) % nd if nd else 0 for p in perm) != list(range(nd)):
        raise ValueError(
            f"transpose perm {list(perm)} is not a permutation of rank "
            f"{nd}")
    return _Aval(tuple(x.shape[int(p)] for p in perm), x.dtype)


@register_infer_rule("concat")
def _concat_rule(*xs, axis=0, **kw):
    avals = [v for v in xs if _is_aval(v)]
    if not avals:
        raise ValueError("concat needs at least one tensor input")
    nd = len(avals[0].shape)
    ax = int(axis) % nd if nd else 0
    base = list(avals[0].shape)
    total = 0
    for v in avals:
        if len(v.shape) != nd:
            raise ValueError(
                f"concat rank mismatch: {tuple(avals[0].shape)} vs "
                f"{tuple(v.shape)}")
        for i, (a, b) in enumerate(zip(base, v.shape)):
            if i != ax and a != b:
                raise ValueError(
                    f"concat dim {i} mismatch: {tuple(avals[0].shape)} vs "
                    f"{tuple(v.shape)} (axis={ax})")
        total += v.shape[ax]
    base[ax] = total
    return _Aval(tuple(base), _result_dtype(*avals))


@register_infer_rule("cast")
def _cast_rule(x, dtype, **kw):
    from ..core.dtype import to_torch_dtype
    return _Aval(tuple(x.shape), to_torch_dtype(dtype))


@register_infer_rule("one_hot")
def _one_hot_rule(x, num_classes, **kw):
    return _Aval(tuple(x.shape) + (int(num_classes),), torch.float32)


@register_infer_rule("embedding")
def _embedding_rule(weight, ids, padding_idx=None, sparse=False, **kw):
    if len(weight.shape) != 2:
        raise ValueError(
            f"embedding weight must be [vocab, dim], got "
            f"{tuple(weight.shape)}")
    return _Aval(tuple(ids.shape) + (weight.shape[1],), weight.dtype)


@register_infer_rule("conv2d")
def _conv2d_rule(x, weight, bias=None, stride=1, padding=0, dilation=1,
                 groups=1, data_format="NCHW", **kw):
    if len(x.shape) != 4 or len(weight.shape) != 4:
        raise ValueError(
            f"conv2d wants 4-D input and weight, got {tuple(x.shape)} and "
            f"{tuple(weight.shape)}")
    if x.dtype != weight.dtype:
        raise ValueError(
            f"conv2d input dtype {x.dtype} != weight dtype {weight.dtype}")
    st = (stride, stride) if isinstance(stride, int) else tuple(stride)
    dil = (dilation, dilation) if isinstance(dilation, int) \
        else tuple(dilation)
    if data_format == "NCHW":
        n, cin, h, w = x.shape
    else:
        n, h, w, cin = x.shape
    cout, cin_w, kh, kw_ = weight.shape
    if cin_w * int(groups) != cin:
        raise ValueError(
            f"conv2d channel mismatch: input has {cin} channels but "
            f"weight expects {cin_w} x groups={groups}")
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            oh = -(-h // st[0])
            ow = -(-w // st[1])
        else:
            oh = (h - dil[0] * (kh - 1) - 1) // st[0] + 1
            ow = (w - dil[1] * (kw_ - 1) - 1) // st[1] + 1
    else:
        ph, pw = (padding, padding) if isinstance(padding, int) \
            else tuple(padding)[:2]
        oh = (h + 2 * ph - dil[0] * (kh - 1) - 1) // st[0] + 1
        ow = (w + 2 * pw - dil[1] * (kw_ - 1) - 1) // st[1] + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"conv2d output collapses to {oh}x{ow} for input {h}x{w}, "
            f"kernel {kh}x{kw_}, stride {st}, padding {padding}")
    shape = (n, cout, oh, ow) if data_format == "NCHW" \
        else (n, oh, ow, cout)
    return _Aval(shape, x.dtype)


# the kernel wrappers take CPU or CUDA tensors only: their ops need rules

@register_infer_rule("flash_sdpa")
def _flash_sdpa_rule(q, k, v, mask, scale, is_causal, **kw):
    """Attention's output has q's shape and dtype."""
    if len(q.shape) != 4 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[-1] != q.shape[-1] or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"flash_sdpa: q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} are not [b, h, s, d] alike")
    return _Aval(tuple(q.shape), q.dtype)


@register_infer_rule("fused_ce_op")
def _fused_ce_rule(hidden, weight, bias, labels, ignore_index, **kw):
    """Per-token losses: [n] f32."""
    if len(hidden.shape) != 2 or len(weight.shape) != 2 \
            or weight.shape[1] != hidden.shape[1]:
        raise ValueError(f"fused_ce_op: hidden {tuple(hidden.shape)} and "
                         f"weight {tuple(weight.shape)} are not [n, H] and "
                         "[V, H]")
    return _Aval((hidden.shape[0],), torch.float32)


def _host_read(name):
    def rule(*args, **kw):
        raise ValueError(
            f"{name} has a data-dependent output shape (it reads values on "
            "the host); it cannot be recorded into a static Program")
    return rule


# the host-reading ops that are ops; nonzero / unique read the host
# outside an op and raise there (ops/manipulation._host)
for _n in ("masked_select", "bincount"):
    register_infer_rule(_n)(_host_read(_n))
