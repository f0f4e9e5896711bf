"""The per-op FLOPs model of the SPMD analyzer
(paddle_tpu/static/spmd_analyzer.py:1240-1382): closed forms over a
static ``Program``'s recorded shapes, exact for the matmul-class ops and
at the element count of the largest operand for everything else. Forward
FLOPs; the capacity model (``static/capacity.py``) prices a prefill with
them.

The rest of the analyzer (sharding-spec propagation, the implied
collectives, the per-device memory estimate, the diagnostics and the
verify hook) waits for ROADMAP Queue 1 item 7b: its names raise
``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch.utils._pytree as pytree

from .program import Program, _Aval, _Ref

__all__ = ["analyze_flops", "register_flop_rule", "FLOP_RULES"]

_ITEM_7B = ("the SPMD analyzer's spec propagation, collectives, memory "
            "estimate and diagnostics wait for ROADMAP Queue 1 item 7b")

# keyed by op name: the port records every op under the JAX package's
# name, so the rules carry over as they are
FLOP_RULES: Dict[str, Any] = {}


def register_flop_rule(*names):
    """Register a FLOPs rule: fn(in_avals, kw, out_avals) -> float.
    ``in_avals`` are the op's positional inputs (avals or raw literals),
    ``kw`` the kwargs dict with tensor leaves as avals."""
    def deco(fn):
        for n in names:
            FLOP_RULES[n] = fn
        return fn
    return deco


def _numel(aval) -> int:
    if aval is None or not hasattr(aval, "shape"):
        return 0
    n = 1
    for s in aval.shape:
        n *= int(s)
    return n


def _is_shaped(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _aval_of(x):
    if _is_shaped(x):
        return _Aval(tuple(x.shape), x.dtype)
    return None


def _lit(v, default=None):
    """A literal kwarg value (a tensor in an attribute slot: the
    default)."""
    return default if isinstance(v, _Aval) else v


@register_flop_rule("matmul")
def _matmul_flops(ins, kw, out_avals):
    x = ins[0] if ins and _is_shaped(ins[0]) else None
    if x is None or not x.shape:
        return float(_numel(out_avals[0]))
    k = x.shape[-2] if (kw.get("transpose_x", False) and len(x.shape) > 1) \
        else x.shape[-1]
    return 2.0 * _numel(out_avals[0]) * int(k)


@register_flop_rule("sdpa")
def _sdpa_flops(ins, kw, out_avals):
    q = ins[0] if ins and _is_shaped(ins[0]) else None
    k = ins[1] if len(ins) > 1 and _is_shaped(ins[1]) else None
    if q is None:
        return float(_numel(out_avals[0]))
    s_kv = int(k.shape[-2]) if k is not None and len(k.shape) >= 2 \
        else int(q.shape[-2])
    return 4.0 * _numel(q) * s_kv  # QK^T + AV, 2 flops/MAC each


@register_flop_rule("fused_ce_op", "ce_head_fallback")
def _ce_flops(ins, kw, out_avals):
    hidden = ins[0] if ins and _is_shaped(ins[0]) else None
    w = ins[1] if len(ins) > 1 and _is_shaped(ins[1]) else None
    if hidden is None or w is None:
        return float(_numel(out_avals[0]))
    rows = _numel(hidden) // max(int(hidden.shape[-1]), 1)
    vocab = int(w.shape[0])
    return 2.0 * rows * int(hidden.shape[-1]) * vocab


@register_flop_rule("embedding")
def _embedding_flops(ins, kw, out_avals):
    return float(_numel(out_avals[0]))  # a gather: ~1 op per element


def _moe_capacity(xv_aval, kw, e_total) -> int:
    tokens = 1
    for s in xv_aval.shape[:-1]:
        tokens *= int(s)
    cap_factor = float(_lit(kw.get("cap_factor", 1.25), 1.25))
    return int(cap_factor * tokens / max(int(e_total), 1)) + 1


@register_flop_rule("moe_layer")
def _moe_flops(ins, kw, out_avals):
    xv = ins[0] if ins and _is_shaped(ins[0]) else None
    w_up = ins[2] if len(ins) > 2 and _is_shaped(ins[2]) else None
    if xv is None or w_up is None:
        return float(_numel(out_avals[0]))
    d = int(xv.shape[-1])
    tokens = _numel(xv) // max(d, 1)
    e_total = int(_lit(kw.get("e_total", 0), 0)) or int(w_up.shape[0])
    h = int(w_up.shape[-1])
    cap = _moe_capacity(xv, kw, e_total)
    gate = 2.0 * tokens * d * e_total
    route = 2.0 * 2.0 * tokens * e_total * cap * d  # dispatch + combine
    ffn = 2.0 * 2.0 * e_total * cap * d * h         # up + down
    return gate + route + ffn


def analyze_flops(program: Program) -> dict:
    """Per-top-level-op forward FLOPs from the recorded shapes.

    Returns {"per_op": [float, one per program.ops entry], "total"}. Ops
    without a rule price at the element count of their largest operand or
    output (the elementwise and normalization scale)."""
    env: Dict[int, Any] = {}
    for v in program.data_vars.values():
        env[v.var_id] = v.aval
    for scope_name, vid in program.persist_ids.items():
        pv = program.persistable_vars.get(scope_name)
        if pv is not None:
            env[vid] = pv.aval

    per_op: List[float] = []
    for op in program.ops:
        vals = []
        for x in op.flat:
            if isinstance(x, _Ref):
                vals.append(env.get(x.var_id))
            else:
                aval = _aval_of(x)
                vals.append(aval if aval is not None else x)
        ins = vals[:op.n_args]
        try:
            kw = pytree.tree_unflatten(vals[op.n_args:], op.kw_tree)
        except Exception:
            kw = {}
        if not isinstance(kw, dict):
            kw = {}
        out_avals = [v.aval for v in op.out_vars]
        rule = FLOP_RULES.get(op.name)
        if rule is not None:
            fl = float(rule(ins, kw, out_avals))
        else:
            ops_scale = [_numel(a) for a in out_avals]
            ops_scale += [_numel(v) for v in ins if _is_shaped(v)]
            fl = float(max(ops_scale or [0]))
        per_op.append(fl)
        for oid, oaval in zip(op.out_ids, out_avals):
            env[oid] = oaval
    return {"per_op": per_op, "total": float(sum(per_op))}


_UNPORTED = ("SpmdLintError", "SpmdDiagnostic", "Collective", "SpmdReport",
             "analyze_program", "analyze_params", "register_spmd_rule",
             "SPMD_RULES", "DIAGNOSTIC_CODES", "verify_spmd_enabled",
             "set_verify_spmd", "maybe_verify_spmd")


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(f"spmd_analyzer.{name}: {_ITEM_7B}")
    raise AttributeError(
        f"module 'paddle_tpu_torch.static.spmd_analyzer' has no attribute "
        f"{name!r}")
