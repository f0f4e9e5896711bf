"""Auto-sharding planner — search PartitionSpec plans against the SPMD
analyzer's cost model.

PR 3's analyzer (`spmd_analyzer.analyze_program`) can price any candidate
layout on any `{axis: size}` mesh without devices: the implied collective
set with per-device payload bytes, a per-device peak-HBM estimate, and a
hard diagnostic catalogue. This module INVERTS it — instead of asking
users to hand-write `COLUMN_PARALLEL`/`ROW_PARALLEL` regexes ("Scale
MLPerf-0.6 models on Google TPU-v3 Pods" describes exactly the layout
search engineers do by hand today), it derives the plan:

  * **Candidate generation** comes from the analyzer's per-op rules: a
    matmul contraction dim admits row-parallel, a matmul output dim
    admits column-parallel, an embedding/vocab-head weight admits
    vocab-parallel on dim 0, elementwise partners (biases) admit the
    matching 1-D sharding, data feeds admit batch-`dp` (and seq-`sp`)
    sharding, and — opt-in — every remaining param admits ZeRO-style
    `dp` on dim 0. Candidates that cannot divide their dim are never
    generated.
  * **Template grouping**: parameters sharing a name template (digit
    runs collapsed to `\\d+`, e.g. `blocks\\.\\d+\\.fc2\\.weight`) are
    planned as ONE group, so the search space is per-template, not
    per-tensor, and the emitted plan is a compact, human-auditable rule
    list (SNIPPETS `match_partition_rules` idiom, produced instead of
    consumed).
  * **Search**: grouped beam search in dataflow order with analyzer
    re-pricing per candidate. States are ranked by
    `(diagnostic_count, objective)` — intermediate states MAY carry
    diagnostics (column-parallel qkv is illegal until the row-parallel
    out-proj closes the Megatron chain two groups later), but only
    zero-diagnostic final states can win; all-replicated is the always-
    legal fallback. A bounded coordinate-descent sweep then polishes the
    winner. Objective = `coll_weight * collective_bytes/step +
    hbm_weight * peak_per_device_HBM` (flag-tunable).
  * **Emission**, three ways: `plan.param_specs` for
    `Program.spmd_param_specs` / `analyze_program`; `plan.rules` as
    `(template, ndim, PartitionSpec)` records installable via
    `sharding.add_tp_rule` (`plan.install_rules()`); and
    `plan.as_strategy()` — a `fleet.DistributedStrategy` with
    `auto_shard = True` that `fleet.distributed_optimizer` tags onto the
    Program so the Executor resolves the plan at compile
    (`resolve_auto_shard`).

CLI: `python -m paddle_tpu_torch.tools.spmd_plan --tp 4 [--dp 2 --sp 2]
[--json]` plans the GPT workload and prints the plan next to the
hand-written preset and the replicated baseline.

The port (paddle_tpu/static/spmd_planner.py) keeps the JAX package's
search and objective; its analyzer prices with torch dtypes (f32 where
the JAX package's x64 mode records f64, ROADMAP Queue 3 D).
`StagedPipelineRunner` (static/pipeline_runner.py) executes a
`PipelinePlan`'s stages, and `Model.fit` takes a plan's rules through
`plan.install_rules()`.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch.utils._pytree as pytree

from ..distributed.mesh import PartitionSpec as P
from .program import Program, _Ref
from .spmd_analyzer import (SpmdReport, _entries as _spec_entries,
                            _mesh_axes, _mesh_topology, _nbytes,
                            analyze_program)

__all__ = ["ShardingPlan", "PlanRule", "plan_program", "resolve_auto_shard",
           "name_template", "PipelinePlan", "StageCost", "plan_pipeline",
           "legal_cut_points"]


# how many diagnostic-count strata the beam carries (lowest first): a
# chain opener sits one stratum per still-open block above the legal
# states, so this bounds how deep an opener→closer chain may nest
_DIAG_STRATA = 4


def name_template(name: str) -> str:
    """Anchored regex template for a parameter name: all-digit dotted
    components (LayerList indices) collapse to `\\d+`, so
    `blocks.3.fc2.weight` and `blocks.11.fc2.weight` share one rule
    (`^blocks\\.\\d+\\.fc2\\.weight$`). Digits embedded in an identifier
    (`fc1` vs `fc2` — different modules) stay literal."""
    body = r"\.".join(r"\d+" if comp.isdigit() else re.escape(comp)
                      for comp in name.split("."))
    return "^" + body + "$"


def _to_p(entries) -> P:
    return P(*[None if not e else (e[0] if len(e) == 1 else tuple(e))
               for e in entries])


def _spec_key(entries) -> tuple:
    return tuple(tuple(e) for e in entries)


@dataclass
class PlanRule:
    """One emitted rule: params matching `template` (of rank `ndim`)
    take `spec`. The human-auditable unit of the plan."""
    template: str
    ndim: int
    spec: P

    def matches(self, name: str, ndim: int) -> bool:
        return ndim == self.ndim and re.search(self.template, name) \
            is not None


@dataclass(eq=False)  # identity hash: groups key search assignments
class PlanGroup:
    """One search unit: all params (or one data feed) sharing a name
    template, rank and shape; `candidates` are the normalized spec
    tuples the role scan admits (index 0 is always replicated)."""
    template: str
    kind: str                    # "param" | "data"
    members: List[str]           # scope names (program keys)
    display: List[str]           # display (dotted) names for the rules
    ndim: int = 0
    shape: tuple = ()
    nbytes: int = 0
    first_use: int = 1 << 30
    roles: set = field(default_factory=set)
    candidates: List[tuple] = field(default_factory=list)


@dataclass
class ShardingPlan:
    """A searched layout plus its predicted costs, consumable three ways
    (specs dict, rule list, fleet strategy) — see module docstring."""
    mesh_axes: Dict[str, int]
    param_specs: Dict[str, P]          # scope_name -> spec
    data_specs: Dict[str, P]           # data var name -> spec
    rules: List[PlanRule]
    names: Dict[str, str]              # scope_name -> display name
    report: Optional[SpmdReport] = None
    objective: float = 0.0
    predicted: Dict[str, Any] = field(default_factory=dict)
    baseline: Dict[str, Any] = field(default_factory=dict)  # replicated
    evaluations: int = 0
    pipeline: Optional["PipelinePlan"] = None  # stage cuts (plan_pipeline)
    mesh_tiers: Dict[str, dict] = field(default_factory=dict)
    # ^ per-axis link metadata; empty on a flat (single-tier) mesh
    grad_sync: Optional[dict] = None
    # ^ SpmdReport.hierarchical_sync() of the winning layout: the priced
    #   flat/hierarchical/localsgd dp sync schemes + recommendation

    # -- consumption ---------------------------------------------------------
    def spec_for(self, name: str, ndim: int) -> P:
        """Spec for a (display) param name by the emitted rule list —
        the planner-made analog of `sharding.param_spec_for`. Most
        specific rule wins (fewest `\\d+` wildcards first), so an
        exact-name rule beats a template it also matches."""
        for rule in sorted(self.rules,
                           key=lambda r: r.template.count(r"\d+")):
            if rule.matches(name, ndim):
                return rule.spec
        return P()

    def apply(self, program: Program) -> "ShardingPlan":
        """Pin the plan on a Program for `analyze_program` / the
        PADDLE_TPU_VERIFY_SPMD hook / `FLAGS_log_spmd_estimate`."""
        program.spmd_param_specs = dict(self.param_specs)
        program.spmd_data_specs = dict(self.data_specs)
        return self

    def install_rules(self):
        """Register every rule via `sharding.add_tp_rule` (callable
        builders, so a template only fires for its rank); returns the
        installed patterns for later `sharding.remove_tp_rule`."""
        from ..distributed import sharding as sharding_mod
        patterns = []
        for rule in self.rules:
            def build(ndim, _r=rule):
                return _r.spec if ndim == _r.ndim else P()
            sharding_mod.add_tp_rule(rule.template, build)
            patterns.append(rule.template)
        return patterns

    def as_strategy(self, strategy=None):
        """A `fleet.DistributedStrategy` carrying this plan:
        `fleet.distributed_optimizer(opt, plan.as_strategy())` makes
        `minimize` tag the Program and the Executor resolve the plan at
        compile (`auto_shard = True`). A plan carrying pipeline stage
        cuts (`plan_pipeline`) additionally flips `strategy.pipeline` on
        and writes the planned stage assignment into the existing
        `pipeline_configs` knob surface (`schedule_mode: "1F1B"`,
        `accumulate_steps` = the priced microbatch count, plus the
        planner-owned `num_virtual`/`stage_op_ranges` keys)."""
        if strategy is None:
            from ..distributed.fleet import DistributedStrategy
            strategy = DistributedStrategy()
        strategy.auto_shard = True
        strategy.auto_shard_configs = {"plan": self}
        pp = self.pipeline
        if pp is not None:
            strategy.pipeline = True
            strategy.pipeline_configs.update({
                "accumulate_steps": pp.num_micro,
                "schedule_mode": "1F1B",
                "num_virtual": pp.num_virtual,
                "pp_degree": pp.num_stages,
                "stage_op_ranges": [tuple(s.op_range) for s in pp.stages],
            })
        gs = self.grad_sync
        if gs and gs.get("outer", {}).get("size", 1) > 1:
            # two-tier mesh: pick the dp sync mode the cost model chose —
            # the three-phase decomposition by default, LocalSGD when
            # even the decomposed DCN leg dominates
            if gs.get("recommendation") == "localsgd":
                strategy.localsgd = True
                strategy.localsgd_configs = dict(
                    strategy.localsgd_configs or {},
                    k_steps=int(gs.get("localsgd_k", 4)))
            elif gs.get("recommendation") == "hierarchical":
                strategy.hierarchical_allreduce = True
                strategy.hierarchical_allreduce_configs = {
                    "inner_axes": list(gs["inner"]["axes"]),
                    "outer_axes": list(gs["outer"]["axes"])}
        return strategy

    def build_param_shardings(self, params: Dict[str, Any], mesh):
        """`{name: DTensor placements}` for a (dotted-name) param tree
        (`sharding.to_placements` of each planned spec)."""
        from ..distributed import sharding as sharding_mod
        return {name: sharding_mod.to_placements(
            self.spec_for(name, len(getattr(v, "shape", ()))), mesh,
            tuple(getattr(v, "shape", ()))) for name, v in params.items()}

    # -- reporting -----------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        """Stable (sorted, primitive-typed) form for CI consumption.
        Flat-mesh plans keep the pre-topology key set; the `topology`
        block appears only when the mesh declares link tiers."""
        out = self._base_json()
        if self.mesh_tiers:
            out["topology"] = {
                "tiers": {ax: {"tier": str(m["tier"]),
                               "gbps": float(m["gbps"])}
                          for ax, m in sorted(self.mesh_tiers.items())},
                "grad_sync": self.grad_sync,
            }
        return out

    def _base_json(self) -> Dict[str, Any]:
        return {
            "mesh": dict(sorted(self.mesh_axes.items())),
            "rules": [{"template": r.template, "ndim": r.ndim,
                       "spec": [None if e is None else list(e)
                                if isinstance(e, tuple) else e
                                for e in tuple(r.spec)]}
                      for r in sorted(self.rules,
                                      key=lambda r: (r.template, r.ndim))],
            "data_specs": {k: [None if e is None else e
                               for e in tuple(v)]
                           for k, v in sorted(self.data_specs.items())},
            "predicted": dict(sorted(self.predicted.items())),
            "baseline_replicated": dict(sorted(self.baseline.items())),
            "objective": self.objective,
            "evaluations": self.evaluations,
        }

    def render(self) -> str:
        lines = ["spmd plan: mesh {" + ", ".join(
            f"{a}:{s}" for a, s in self.mesh_axes.items()) + "}"]
        if self.mesh_tiers:
            by_tier: Dict[tuple, List[str]] = {}
            for ax, m in self.mesh_tiers.items():
                by_tier.setdefault(
                    (str(m["tier"]), float(m["gbps"])), []).append(ax)
            lines.append("link tiers: " + "; ".join(
                f"{','.join(axs)}={t}@{g:g}GB/s"
                for (t, g), axs in sorted(by_tier.items())))
        lines.append("rules:")
        for r in sorted(self.rules, key=lambda r: (r.template, r.ndim)):
            lines.append(f"  {r.template:<44} -> {r.spec}")
        if not self.rules:
            lines.append("  (everything replicated)")
        for name, spec in sorted(self.data_specs.items()):
            lines.append(f"  data {name:<39} -> {spec}")
        p, b = self.predicted, self.baseline
        lines.append(
            f"predicted: collective {p.get('collective_bytes', 0)} B/step, "
            f"peak HBM/device {p.get('hbm_peak', 0)} B "
            f"(replicated baseline: {b.get('collective_bytes', 0)} B, "
            f"{b.get('hbm_peak', 0)} B)")
        gs = self.grad_sync
        if gs:
            red = gs.get("inter_pod_reduction_x", 1)
            lines.append(
                f"dp grad sync: {gs.get('recommendation')} "
                f"(inner {'x'.join(map(str, gs['inner']['axes'])) or '-'}"
                f":{gs['inner']['size']}, outer "
                f"{'x'.join(map(str, gs['outer']['axes'])) or '-'}"
                f":{gs['outer']['size']}, hierarchical cuts inter-pod "
                f"bytes {red:.1f}x)")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# role scan — which shardings does each persistable/feed admit?
# ---------------------------------------------------------------------------

def _kw_of(op) -> dict:
    try:
        kw = pytree.tree_unflatten(list(op.flat[op.n_args:]), op.kw_tree)
    except Exception:
        return {}
    return kw if isinstance(kw, dict) else {}


_EW_OPS = ("add", "subtract", "multiply", "divide", "maximum", "minimum",
           "where")


def _scan_roles(program: Program):
    """Walk the op list (and control-flow sub-blocks): for every
    persistable, record how it is consumed — the role set drives
    candidate generation. Also records each var's first-use op index so
    the search runs in dataflow order (Megatron chains close as soon as
    possible after they open)."""
    from .control_flow import _CondFn, _WhileFn

    id2scope = {vid: scope for scope, vid in program.persist_ids.items()}
    roles: Dict[str, set] = {s: set() for s in program.persist_ids}
    first: Dict[str, int] = {}

    def note(ref, idx):
        scope = id2scope.get(ref.var_id) if isinstance(ref, _Ref) else None
        if scope is not None:
            first.setdefault(scope, idx)
        return scope

    def walk(ops, base):
        for i, op in enumerate(ops):
            idx = base + i
            if isinstance(op.fn, (_CondFn, _WhileFn)):
                blocks = [op.fn.true_block, op.fn.false_block] \
                    if isinstance(op.fn, _CondFn) else [op.fn.body_block]
                for blk in blocks:
                    walk(blk.ops, idx)
                for x in op.flat:
                    note(x, idx)
                continue
            args = op.flat[:op.n_args]
            kw = _kw_of(op)
            for x in op.flat:
                note(x, idx)
            if op.name == "matmul" and len(args) >= 2:
                ty = bool(kw.get("transpose_y", False))
                tx = bool(kw.get("transpose_x", False))
                lhs, rhs = note(args[0], idx), note(args[1], idx)
                if rhs is not None:
                    roles[rhs].add(("matmul_rhs", ty))
                if lhs is not None:
                    roles[lhs].add(("matmul_lhs", tx))
            elif op.name == "embedding" and args:
                w = note(args[0], idx)
                if w is not None:
                    roles[w].add(("vocab", None))
            elif op.name in ("fused_ce_op", "ce_head_fallback") \
                    and len(args) >= 2:
                w = note(args[1], idx)
                if w is not None:
                    roles[w].add(("vocab", None))
            elif op.name == "moe_layer" and len(args) >= 6:
                # stacked expert weights (w_up, b_up, w_down, b_down):
                # dim 0 is the expert dim, shardable over the layer's
                # `axis` kwarg (conventionally 'ep')
                ax = kw.get("axis", "ep")
                ax = ax if isinstance(ax, str) else "ep"
                for x in args[2:6]:
                    s = note(x, idx)
                    if s is not None:
                        roles[s].add(("expert", ax))
            elif op.name in _EW_OPS:
                for x in args:
                    s = note(x, idx)
                    if s is not None:
                        roles[s].add(("elementwise", None))

    walk(program.ops, 0)
    return roles, first


def _param_candidates(g: PlanGroup, axes: Dict[str, int],
                      zero_dp: bool) -> List[tuple]:
    nd, shape = g.ndim, g.shape
    cands: List[tuple] = [((),) * nd]

    def add(dim, ax):
        if 0 <= dim < nd and shape[dim] % axes[ax] == 0:
            spec = [()] * nd
            spec[dim] = (ax,)
            if tuple(spec) not in cands:
                cands.append(tuple(spec))

    for role, flag in g.roles:
        if role == "matmul_rhs" and nd >= 2:
            cdim = nd - 1 if flag else nd - 2   # contraction: row-parallel
            odim = nd - 2 if flag else nd - 1   # output: column-parallel
            for ax in axes:
                add(cdim, ax)
                add(odim, ax)
        elif role == "vocab":
            for ax in axes:
                add(0, ax)
        elif role == "expert":
            # expert placement: the stacked expert dim shards over the
            # MoE layer's own axis only (all-to-all dispatch/combine is
            # priced by the analyzer's moe_layer rule)
            if flag in axes:
                add(0, flag)
        elif role == "elementwise" and nd == 1:
            # a bias/scale riding an elementwise op can mirror its
            # partner's output sharding
            for ax in axes:
                add(0, ax)
    if zero_dp and "dp" in axes:
        add(0, "dp")
    return cands


def _data_candidates(g: PlanGroup, axes: Dict[str, int],
                     tiers: Optional[Dict[str, dict]] = None) -> List[tuple]:
    """Feeds admit batch-dp (dim 0) and sequence-sp (dim 1) sharding —
    the repo's mesh-axis conventions (fleet hybrid degrees). On a
    two-tier mesh the slow-tier axes also join the batch dim (alone or
    outside `dp`, DCN-major), so the beam can push pure data
    parallelism — and only that — across the pod boundary."""
    nd, shape = g.ndim, g.shape
    cands: List[tuple] = [((),) * nd]
    top = max((float(m.get("gbps", 0.0))
               for m in (tiers or {}).values()), default=0.0)
    slow = [ax for ax, m in (tiers or {}).items()
            if ax in axes and 0 < float(m.get("gbps", 0.0)) < top]

    batch_entries: List[tuple] = []
    if "dp" in axes:
        batch_entries.append(("dp",))
    for ax in sorted(slow):
        batch_entries.append((ax,))
        if "dp" in axes:
            batch_entries.append((ax, "dp"))

    combos = []
    for ent in batch_entries:
        size = 1
        for ax in ent:
            size *= axes[ax]
        if nd >= 1 and shape[0] % size == 0:
            combos.append({0: ent})
    sp_ok = "sp" in axes and nd >= 2 and shape[1] % axes["sp"] == 0
    base = list(combos)
    if sp_ok:
        combos.append({1: ("sp",)})
        for c in base:
            combos.append({**c, 1: ("sp",)})
    for combo in combos:
        spec = [combo.get(d, ()) for d in range(nd)]
        if tuple(spec) not in cands:
            cands.append(tuple(spec))
    return cands


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

class _Oracle:
    """Memoized analyzer pricing of a full assignment.

    `mesh_desc` preserves the full topology grammar (per-axis link
    tiers) so the analyzer prices slow-tier traffic at its real weight;
    it defaults to the bare axes, which is the flat single-tier case."""

    def __init__(self, program, axes, coll_w, hbm_w, mesh_desc=None):
        self.program = program
        self.axes = axes
        self.mesh_desc = mesh_desc if mesh_desc is not None else axes
        self.coll_w = coll_w
        self.hbm_w = hbm_w
        self.cache: Dict[tuple, tuple] = {}
        self.evaluations = 0

    def price(self, param_assign: Dict[str, tuple],
              data_assign: Dict[str, tuple]):
        """-> (n_diags, score, optimistic_score, report). The optimistic
        score drops the all-gather bytes: a zero-diagnostic plan implies
        none (every gather the analyzer emits rides a diagnostic), so it
        is the value an open Megatron chain would have once its closer
        removes the reshard — the ranking that keeps chain-opening
        states alive inside the infeasible beam strata."""
        key = (tuple(sorted((k, _spec_key(v))
                            for k, v in param_assign.items())),
               tuple(sorted((k, _spec_key(v))
                            for k, v in data_assign.items())))
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        self.evaluations += 1
        report = analyze_program(
            self.program, mesh=self.mesh_desc,
            param_specs={k: _to_p(v) for k, v in param_assign.items()},
            data_specs={k: _to_p(v) for k, v in data_assign.items()})
        hbm = report.hbm["peak_bytes"] if report.hbm else \
            sum(_nbytes(pv.aval)
                for pv in self.program.persistable_vars.values())
        # tier-weighted bytes == plain bytes on a flat mesh, so the
        # single-tier goldens price (and rank) exactly as before
        score = self.coll_w * report.weighted_collective_bytes() \
            + self.hbm_w * hbm
        ar_bytes = report.weighted_collective_bytes("all_reduce")
        opt = self.coll_w * ar_bytes + self.hbm_w * hbm
        out = (len(report.diagnostics), float(score), float(opt), report)
        self.cache[key] = out
        return out


def _build_groups(program: Program, axes, names, zero_dp,
                  fixed_data_specs, tiers=None) -> List[PlanGroup]:
    roles, first = _scan_roles(program)
    names = dict(names or {})
    by_tmpl: Dict[tuple, PlanGroup] = {}

    for scope, pv in program.persistable_vars.items():
        display = names.get(scope, scope)
        shape = tuple(pv.aval.shape)
        # same-template params with different shapes/roles cannot share
        # one rule — the shape in the key splits them apart (their
        # templates then collide; _emit falls back to exact names)
        key = (name_template(display), shape,
               frozenset(roles.get(scope, ())))
        g = by_tmpl.get(key)
        if g is None:
            g = by_tmpl[key] = PlanGroup(
                template=key[0], kind="param", members=[], display=[],
                ndim=len(shape), shape=shape, roles=set(roles.get(scope,
                                                                  ())))
        g.members.append(scope)
        g.display.append(display)
        g.nbytes += _nbytes(pv.aval)
        g.first_use = min(g.first_use, first.get(scope, 1 << 30))

    groups = list(by_tmpl.values())
    for g in groups:
        g.candidates = _param_candidates(g, axes, zero_dp)

    if fixed_data_specs is None:
        for name, v in program.data_vars.items():
            g = PlanGroup(template=name_template(name), kind="data",
                          members=[name], display=[name],
                          ndim=len(v.aval.shape),
                          shape=tuple(v.aval.shape),
                          nbytes=_nbytes(v.aval), first_use=-1)
            g.candidates = _data_candidates(g, axes, tiers)
            groups.append(g)

    # dataflow order: feeds first (they enter at op 0), then params by
    # first use — a Megatron chain's opener and closer sit adjacently,
    # so the infeasible intermediate survives at most a few beam steps
    groups.sort(key=lambda g: (g.first_use, -g.nbytes, g.template))
    return [g for g in groups if len(g.candidates) > 1 or g.kind == "param"]


def plan_program(program: Program, mesh=None, *, layer=None, names=None,
                 data_specs=None, coll_weight=None, hbm_weight=None,
                 beam=None, sweeps=None, zero_dp=False) -> ShardingPlan:
    """Search a PartitionSpec plan for `program` on `mesh`.

    mesh: a Mesh or `{axis: size}` dict (device-free), or None for the
    registered default. `layer`/`names` supply display (dotted) names
    for the rule templates (`names` = {scope_name: dotted_name}; a
    `layer` is walked via `named_parameters()`); without them the rules
    fall back to scope-name templates. `data_specs` pins the feed specs
    instead of searching them. `zero_dp=True` adds ZeRO-style dim-0 `dp`
    candidates for every param the oracle will accept. Weights/beam
    default from `FLAGS_spmd_plan_*`.
    """
    from ..core import monitor
    from ..core.flags import flag as _flag

    axes, tiers = _mesh_topology(mesh)
    # rebuild the device-free grammar form so every oracle pricing run
    # carries the per-axis tiers (and the search stays Mesh-object-free)
    mesh_desc = {ax: ({"size": n, **tiers[ax]} if ax in tiers else n)
                 for ax, n in axes.items()} if tiers else dict(axes)
    coll_w = float(_flag("FLAGS_spmd_plan_coll_weight")
                   if coll_weight is None else coll_weight)
    hbm_w = float(_flag("FLAGS_spmd_plan_hbm_weight")
                  if hbm_weight is None else hbm_weight)
    beam_w = max(1, int(_flag("FLAGS_spmd_plan_beam")
                        if beam is None else beam))
    n_sweeps = max(0, int(_flag("FLAGS_spmd_plan_sweeps")
                          if sweeps is None else sweeps))

    if layer is not None and names is None:
        names = {}
        for dotted, p in layer.named_parameters():
            scope = getattr(p, "scope_name", None) or getattr(
                p, "name", dotted)
            names[scope] = dotted
    names = dict(names or {})

    fixed_data = None if data_specs is None else \
        {k: _spec_entries(v) for k, v in data_specs.items()}
    oracle = _Oracle(program, axes, coll_w, hbm_w, mesh_desc=mesh_desc)

    repl_param = {s: ((),) * len(pv.aval.shape)
                  for s, pv in program.persistable_vars.items()}
    repl_data = dict(fixed_data) if fixed_data is not None else \
        {n: ((),) * len(v.aval.shape)
         for n, v in program.data_vars.items()}

    def price(assign):
        pa = dict(repl_param)
        da = dict(repl_data)
        for g, cand in assign.items():
            tgt = pa if g.kind == "param" else da
            for m in g.members:
                tgt[m] = cand
        return oracle.price(pa, da)

    if not axes:
        # no mesh axes — the trivial (replicated) plan, no search
        groups: List[PlanGroup] = []
        best_assign: Dict[PlanGroup, tuple] = {}
        n_d, best_score, _opt, best_rep = price(best_assign)
        base_score, base_rep = best_score, best_rep
    else:
        groups = _build_groups(program, axes, names, zero_dp, fixed_data,
                               tiers=tiers)
        _, base_score, _opt, base_rep = price({})

        # beam over groups in dataflow order, STRATIFIED by diagnostic
        # count: the top `beam` states of each of the lowest diag levels
        # survive. A flat (diags, score) ranking would evict every
        # chain-opening state (column-parallel qkv carries a reshard
        # diagnostic per block until the row-parallel out-proj closes
        # the chain) as soon as `beam` fully-legal states exist; keeping
        # a few diag>0 strata carries the opener to its closer.
        states: List[tuple] = [(0, base_score, base_score, {})]
        for g in groups:
            nxt: List[tuple] = []
            for st in states:
                for cand in g.candidates:
                    a2 = dict(st[3])
                    a2[g] = cand
                    d2, s2, o2, _ = price(a2)
                    nxt.append((d2, s2, o2, a2))
            buckets: Dict[int, list] = {}
            for t in nxt:
                buckets.setdefault(t[0], []).append(t)
            states = []
            for lvl in sorted(buckets)[:_DIAG_STRATA]:
                # legal states rank by the real objective; open-chain
                # states by the optimistic one (gathers assumed closed)
                rank = (lambda t: t[1]) if lvl == 0 else (lambda t: t[2])
                states.extend(sorted(buckets[lvl], key=rank)[:beam_w])

        feasible = [(s, a) for d, s, _o, a in states if d == 0]
        if feasible:
            best_score, best_assign = min(feasible, key=lambda t: t[0])
        else:
            best_score, best_assign = base_score, {}

        # coordinate-descent polish: re-try every candidate of every
        # group against the current winner (feasible moves only)
        for _ in range(n_sweeps):
            improved = False
            for g in groups:
                for cand in g.candidates:
                    if best_assign.get(g, g.candidates[0]) == cand:
                        continue
                    a2 = dict(best_assign)
                    a2[g] = cand
                    d2, s2, _o2, _ = price(a2)
                    if d2 == 0 and s2 < best_score:
                        best_score, best_assign = s2, a2
                        improved = True
            if not improved:
                break

        n_d, best_score, _opt, best_rep = price(best_assign)

    # -- emit ----------------------------------------------------------------
    def chosen(g):
        return best_assign.get(g, g.candidates[0] if g.candidates
                               else ((),) * g.ndim)

    # (template, ndim) -> distinct chosen specs, REPLICATED INCLUDED: a
    # replicated group must veto its template too, or a sibling group's
    # template rule would claim its members through spec_for /
    # install_rules and shard what the search left replicated
    tmpl_specs: Dict[tuple, set] = {}
    for g in groups:
        if g.kind == "param":
            tmpl_specs.setdefault((g.template, g.ndim), set()).add(
                _spec_key(chosen(g)))

    param_specs: Dict[str, P] = {}
    data_plan: Dict[str, P] = {}
    rules: List[PlanRule] = []
    emitted: set = set()
    for g in groups:
        cand = chosen(g)
        if g.kind == "data":
            if any(cand):
                data_plan[g.members[0]] = _to_p(cand)
            continue
        for m in g.members:
            param_specs[m] = _to_p(cand)
        if not any(cand):
            continue  # replicated members need no rule (spec_for -> P())
        if len(tmpl_specs[(g.template, g.ndim)]) > 1:
            # template collision (same name shape, different tensor
            # shape/role): exact-name rules disambiguate; colliding
            # replicated members stay ruleless and default to P()
            for disp in g.display:
                rules.append(PlanRule("^" + re.escape(disp) + "$",
                                      g.ndim, _to_p(cand)))
            continue
        if (g.template, g.ndim) not in emitted:
            emitted.add((g.template, g.ndim))
            rules.append(PlanRule(g.template, g.ndim, _to_p(cand)))
    if fixed_data is not None:
        data_plan = {k: _to_p(v) for k, v in fixed_data.items()}

    predicted = {
        "collective_bytes": best_rep.collective_bytes(),
        "hbm_peak": best_rep.hbm["peak_bytes"] if best_rep.hbm else 0,
        "diagnostics": len(best_rep.diagnostics),
    }
    if tiers:
        predicted["weighted_collective_bytes"] = \
            best_rep.weighted_collective_bytes()
        predicted["tier_bytes"] = dict(sorted(
            best_rep.tier_bytes().items()))
    plan = ShardingPlan(
        mesh_axes=dict(axes), param_specs=param_specs,
        data_specs=data_plan, rules=rules, names=names, report=best_rep,
        objective=float(best_score), evaluations=oracle.evaluations,
        mesh_tiers=dict(tiers), grad_sync=best_rep.hierarchical_sync(),
        predicted=predicted,
        baseline={
            "collective_bytes": base_rep.collective_bytes(),
            "hbm_peak": base_rep.hbm["peak_bytes"] if base_rep.hbm else 0,
            "objective": float(base_score),
        })
    monitor.stat_add("spmd.plans_resolved")
    monitor.stat_set_many({
        "spmd.plan_objective": plan.objective,
        "spmd.plan_collective_bytes": plan.predicted["collective_bytes"],
        "spmd.plan_hbm": plan.predicted["hbm_peak"],
        "spmd.plan_evaluations": oracle.evaluations,
    })
    return plan


# ---------------------------------------------------------------------------
# pipeline stage-cut + expert-placement planner. The search space is the
# program ITSELF: where to cut the dataflow into pipeline stages (and,
# through the inner SPMD plan, where to place MoE experts on the 'ep'
# axis). Every pricing ingredient is the static analysis the repo
# already trusts: analyze_flops for compute balance, analyze_memory
# restricted to each stage's op range for per-stage HBM,
# pipeline.schedule_collectives for the ppermute wire, and
# bubble_fraction for schedule idle cost.
# ---------------------------------------------------------------------------

@dataclass
class CutPoint:
    """A legal stage boundary: the op index the cut falls BEFORE, and
    the single activation var crossing it (the def-use live set at the
    boundary, persistables and feeds excluded, must be exactly one
    tensor — the pipeline forwards ONE hidden per tick)."""
    boundary: int
    frontier_id: int
    frontier_name: str
    aval: Any


@dataclass
class StageCost:
    """One global pipeline stage's predicted costs."""
    index: int
    op_range: Tuple[int, int]
    flops: float
    hbm_peak: int
    param_bytes: int
    diagnostics: int = 0

    def to_json(self):
        return {"stage": self.index, "op_range": list(self.op_range),
                "flops": self.flops, "hbm_peak": self.hbm_peak,
                "param_bytes": self.param_bytes,
                "diagnostics": self.diagnostics}


def legal_cut_points(program: Program) -> List[CutPoint]:
    """Enumerate the op boundaries where the crossing live set is a
    single activation (the verifier's def-use chains, inverted into cut
    legality): a var is live across boundary `b` when it is defined
    before `b` and read at-or-after `b`. Persistables never cross (each
    stage holds its own params) and feeds enter at stage 0 by
    convention; what remains must be exactly ONE tensor — the narrow
    activation frontier a ppermute can carry."""
    ops = program.ops
    persist = set(program.persist_ids.values())
    data_ids = {v.var_id for v in program.data_vars.values()}
    defined_at: Dict[int, int] = {}
    last_use: Dict[int, int] = {}
    avals: Dict[int, Any] = {}
    names: Dict[int, str] = {}
    for i, op in enumerate(ops):
        for x in op.flat:
            if isinstance(x, _Ref):
                last_use[x.var_id] = i
        for oid, ov in zip(op.out_ids, op.out_vars):
            defined_at[oid] = i
            avals[oid] = ov.aval
            names[oid] = ov.name
    for v in getattr(program, "_jit_fetch_vars", []) or []:
        last_use[v.var_id] = len(ops)
    # state-write values and the backward loss survive to step end
    # exactly as analyze_memory pins them: a mid-program state update
    # CROSSES every later boundary (the stage must forward it), so a
    # cut there is not a single-tensor frontier
    for vid in program.state_writes.values():
        last_use[vid] = len(ops)
    if program.backward_section is not None:
        bw_loss, _pairs = program.backward_section
        last_use[bw_loss.var_id] = len(ops)

    # sweep the boundary left to right, maintaining the live set
    live: set = set()
    cuts: List[CutPoint] = []
    for b in range(1, len(ops)):
        op = ops[b - 1]
        for oid in op.out_ids:
            if oid not in persist and oid not in data_ids \
                    and last_use.get(oid, -1) >= b:
                live.add(oid)
        live = {vid for vid in live if last_use.get(vid, -1) >= b}
        if len(live) == 1:
            (vid,) = live
            cuts.append(CutPoint(b, vid, names.get(vid, str(vid)),
                                 avals.get(vid)))
    return cuts


@dataclass
class PipelinePlan:
    """A searched pipeline partition: `num_stages * num_virtual` global
    stages over the program's op list (stage g runs ops
    `stages[g].op_range`; under interleaved 1F1B, global stage g lives
    on rank `g % num_stages` as chunk `g // num_stages`), priced by the
    per-stage objective and carrying the inner (non-pp) SPMD plan —
    expert placement included — as `inner`."""
    mesh_axes: Dict[str, int]
    axis: str
    num_stages: int
    num_virtual: int
    num_micro: int
    schedule: str
    cuts: List[int]
    stages: List[StageCost]
    frontier_bytes_per_tick: int
    wire: Dict[str, Any]
    bubble: float
    objective: float
    diagnostics: List[str] = field(default_factory=list)
    inner: Optional[ShardingPlan] = None
    cut_points: List[CutPoint] = field(default_factory=list)
    hand: Dict[str, Any] = field(default_factory=dict)
    expert: Dict[str, Any] = field(default_factory=dict)
    evaluations: int = 0

    # -- consumption ---------------------------------------------------------
    @property
    def n_segments(self) -> int:
        """Atomic segments between consecutive legal boundaries (the
        unit a cut vector partitions)."""
        return len(self.cut_points) + 1

    def stage_of_op(self, op_index: int) -> int:
        for s in self.stages:
            if s.op_range[0] <= op_index < s.op_range[1]:
                return s.index
        return 0 if op_index < self.stages[0].op_range[0] \
            else len(self.stages) - 1

    def stage_segments(self) -> List[List[int]]:
        """Segment indices per global stage: segment k spans
        [boundary k-1, boundary k) over the LEGAL boundary list — the
        execution-side unit (StagedPipelineRunner maps one chunk
        parameter pytree per segment)."""
        bounds = [0] + [c.boundary for c in self.cut_points] \
            + [1 << 30]
        out: List[List[int]] = [[] for _ in self.stages]
        for k in range(len(bounds) - 1):
            mid = bounds[k]
            out[self.stage_of_op(mid)].append(k)
        return out

    def param_stages(self, program: Program) -> Dict[str, int]:
        """{scope_name: global stage} by each persistable's first use —
        the stage that must HOLD the param (resolved onto the Program by
        `resolve_auto_shard` before the VERIFY_SPMD hook runs)."""
        _roles, first = _scan_roles(program)
        return {scope: self.stage_of_op(first.get(scope, 0))
                for scope in program.persist_ids}

    # -- reporting -----------------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        out = {
            "mesh": dict(sorted(self.mesh_axes.items())),
            "axis": self.axis,
            "num_stages": self.num_stages,
            "num_virtual": self.num_virtual,
            "num_micro": self.num_micro,
            "schedule": self.schedule,
            "cuts": list(self.cuts),
            "stages": [s.to_json() for s in self.stages],
            "frontier_bytes_per_tick": self.frontier_bytes_per_tick,
            "wire": dict(self.wire),
            "bubble": self.bubble,
            "objective": self.objective,
            "diagnostics": list(self.diagnostics),
            "hand": dict(self.hand),
            "expert": dict(self.expert),
            "evaluations": self.evaluations,
        }
        if self.inner is not None:
            out["inner"] = self.inner.to_json()
        return out

    def stage_table(self) -> str:
        """Human-readable per-stage table (tools/spmd_plan.py
        --pipeline)."""
        lines = [
            "pipeline plan: mesh {" + ", ".join(
                f"{a}:{s}" for a, s in self.mesh_axes.items())
            + f"}} axis={self.axis} stages={self.num_stages}"
              f" v={self.num_virtual} micro={self.num_micro}"
              f" schedule={self.schedule}",
            f"  {'stage':<7}{'ops':<12}{'flops':>14}{'peak HBM':>12}"
            f"{'params':>12}{'diags':>7}"]
        for s in self.stages:
            lines.append(
                f"  {s.index:<7}{f'[{s.op_range[0]},{s.op_range[1]})':<12}"
                f"{s.flops:>14.0f}{s.hbm_peak:>12}{s.param_bytes:>12}"
                f"{s.diagnostics:>7}")
        lines.append(
            f"wire: {self.wire.get('count', 0)} ppermute x "
            f"{self.frontier_bytes_per_tick} B = "
            f"{self.wire.get('total_bytes', 0)} B/step; bubble "
            f"{self.bubble:.3f}; objective {self.objective:.0f}")
        if self.expert.get("all_to_all_count"):
            lines.append(
                f"experts: {self.expert.get('rules')} over axis "
                f"'{self.expert.get('axis')}' — "
                f"{self.expert['all_to_all_count']} all-to-all, "
                f"{self.expert.get('all_to_all_bytes', 0)} B/step")
        if self.hand:
            lines.append(
                f"hand (equal-segments) cut: objective "
                f"{self.hand.get('objective', 0):.0f} at cuts "
                f"{self.hand.get('cuts')}")
        if self.diagnostics:
            lines.append(f"diagnostics ({len(self.diagnostics)}):")
            lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)


def plan_pipeline(program: Program, mesh=None, *, axis="pp",
                  num_micro=None, num_virtual=1, schedule=None,
                  layer=None, names=None, data_specs=None, cuts=None,
                  boundaries=None, beam=None, flops_weight=None,
                  wire_weight=None, hbm_weight=None, bubble_weight=None,
                  zero_dp=False, inner_beam=None, coll_weight=None,
                  inner_hbm_weight=None) -> PipelinePlan:
    """Search pipeline stage cuts (and, through the inner SPMD plan,
    MoE expert placement) for `program` on `mesh`.

    The `axis` (default 'pp') mesh dimension is the pipeline; all OTHER
    axes go to the inner per-stage SPMD plan (`plan_program` — dp/tp/sp
    layouts plus 'ep' expert placement), so a dp/pp/ep mesh is planned
    as one joint objective. `cuts=[op_index, ...]` prices a GIVEN cut
    vector instead of searching (the hand-baseline seam);
    `boundaries=[op_index, ...]` restricts the CANDIDATE boundaries to
    a subset of the legal ones (e.g. layer boundaries, so plan segments
    align 1:1 with the units `StagedPipelineRunner` executes).
    `schedule` defaults to "1f1b" for `num_virtual == 1`, "interleaved"
    otherwise.

    Objective per candidate partition (flags `FLAGS_spmd_plan_pp_*`):

        flops_w  * max(stage FLOPs) * num_micro     # pipeline-full compute
      + bubble_w * bubble_fraction * total FLOPs    # schedule idle cost
      + wire_w   * ppermute wire bytes/step         # schedule_collectives
      + hbm_w    * max(stage peak HBM)              # analyze_memory slice

    Only partitions whose per-stage SPMD sub-plans are zero-diagnostic
    can win (the stage's slice of the inner analyzer report must be
    clean) — the same hard-constraint discipline as the layout search.
    """
    from ..core import monitor
    from ..core.flags import flag as _flag
    from ..distributed.pipeline import (bubble_fraction,
                                        schedule_collectives)
    from .shape_infer import analyze_memory
    from .spmd_analyzer import analyze_flops

    axes, tiers = _mesh_topology(mesh)
    pp = int(axes.get(axis, 1))
    v = max(1, int(num_virtual))
    n_global = pp * v
    if schedule is None:
        schedule = "interleaved" if v > 1 else "1f1b"
    M = int(_flag("FLAGS_spmd_plan_pp_micro")
            if num_micro is None else num_micro)
    beam_w = max(1, int(_flag("FLAGS_spmd_plan_pp_beam")
                        if beam is None else beam))
    fl_w = float(_flag("FLAGS_spmd_plan_pp_flops_weight")
                 if flops_weight is None else flops_weight)
    wi_w = float(_flag("FLAGS_spmd_plan_pp_wire_weight")
                 if wire_weight is None else wire_weight)
    hb_w = float(_flag("FLAGS_spmd_plan_pp_hbm_weight")
                 if hbm_weight is None else hbm_weight)
    bu_w = float(_flag("FLAGS_spmd_plan_pp_bubble_weight")
                 if bubble_weight is None else bubble_weight)

    # inner SPMD plan over everything that is NOT the pipeline axis —
    # dp/tp/sp layouts AND 'ep' expert placement ride the same search
    # (inner_beam/coll_weight/inner_hbm_weight tune that inner search;
    # `beam`/`hbm_weight` above are the STAGE-CUT search's knobs)
    inner_axes = {a: ({"size": s, **tiers[a]} if a in tiers else s)
                  for a, s in axes.items() if a != axis}
    inner = plan_program(program, inner_axes, layer=layer, names=names,
                         data_specs=data_specs, zero_dp=zero_dp,
                         beam=inner_beam, coll_weight=coll_weight,
                         hbm_weight=inner_hbm_weight)
    inner_rep = inner.report
    diagnostics: List[str] = [str(d) for d in inner_rep.diagnostics] \
        if inner_rep is not None else []

    # shared pricing state: per-op flops, avals, per-var shard divisors
    flops = analyze_flops(program)["per_op"]
    total_flops = float(sum(flops))
    env_aval: Dict[int, Any] = {}
    for dv in program.data_vars.values():
        env_aval[dv.var_id] = dv.aval
    for scope, vid in program.persist_ids.items():
        pv = program.persistable_vars.get(scope)
        if pv is not None:
            env_aval[vid] = pv.aval
    for op in program.ops:
        for oid, ov in zip(op.out_ids, op.out_vars):
            env_aval[oid] = ov.aval
    divs: Dict[int, int] = {}
    if inner_rep is not None:
        for vid, spec in inner_rep.specs.items():
            d = 1
            for e in spec:
                for ax in e:
                    d *= axes.get(ax, 1)
            divs[vid] = d
    diag_ops = sorted(d.op_index for d in (inner_rep.diagnostics
                                           if inner_rep else [])
                      if d.op_index is not None)

    # legal boundaries, filtered to the dominant frontier aval so the
    # chosen stages stay homogeneous (hidden -> hidden, the
    # pipeline.py contract)
    all_cuts = legal_cut_points(program)
    shape_votes: Dict[tuple, int] = {}
    for c in all_cuts:
        if c.aval is not None:
            key = (tuple(c.aval.shape), str(c.aval.dtype))
            shape_votes[key] = shape_votes.get(key, 0) + 1
    frontier_key = max(shape_votes, key=shape_votes.get) \
        if shape_votes else None
    if boundaries is not None:
        # the caller defines the unit grid: validate against the FULL
        # legal set (a requested boundary may carry a non-dominant
        # frontier shape — the caller owns that homogeneity choice)
        allowed = {int(b) for b in boundaries}
        illegal = allowed - {c.boundary for c in all_cuts
                             if c.aval is not None}
        if illegal:
            diagnostics.append(
                "pipeline-cut: requested candidate boundaries "
                f"{sorted(illegal)} are not legal single-tensor cut "
                "points")
        cand = [c for c in all_cuts
                if c.aval is not None and c.boundary in allowed]
    else:
        cand = [c for c in all_cuts
                if c.aval is not None
                and (tuple(c.aval.shape),
                     str(c.aval.dtype)) == frontier_key]
    bmap = {c.boundary: c for c in cand}
    bset = [c.boundary for c in cand]
    n_ops = len(program.ops)

    if schedule == "interleaved" and M % max(pp, 1) != 0:
        diagnostics.append(
            f"pipeline-cut: interleaved schedule needs num_micro ({M}) "
            f"divisible by the pp size ({pp})")
    if len(bset) < n_global - 1:
        diagnostics.append(
            f"pipeline-cut: only {len(bset)} legal single-tensor cut "
            f"boundaries for {n_global} stages — the program cannot be "
            f"partitioned this deep")

    evaluations = 0
    stage_cache: Dict[Tuple[int, int], StageCost] = {}

    def _bisect(lst, x):
        import bisect
        return bisect.bisect_left(lst, x)

    def stage_cost(lo: int, hi: int, idx: int = 0) -> StageCost:
        nonlocal evaluations
        hit = stage_cache.get((lo, hi))
        if hit is not None:
            return StageCost(idx, (lo, hi), hit.flops, hit.hbm_peak,
                             hit.param_bytes, hit.diagnostics)
        evaluations += 1
        est = analyze_memory(program, env=env_aval, shard_divisors=divs,
                             op_range=(lo, hi))
        n_diag = _bisect(diag_ops, hi) - _bisect(diag_ops, lo)
        sc = StageCost(idx, (lo, hi), float(sum(flops[lo:hi])),
                       int(est["peak_bytes"]), int(est["param_bytes"]),
                       n_diag)
        stage_cache[(lo, hi)] = sc
        return sc

    def build_stages(cut_vec: List[int]) -> List[StageCost]:
        bounds = [0] + list(cut_vec) + [n_ops]
        return [stage_cost(bounds[k], bounds[k + 1], k)
                for k in range(len(bounds) - 1)]

    def frontier_tick_bytes(cut_vec: List[int]) -> int:
        """Per-tick ppermute payload: one MICROBATCH of the (possibly
        dp/sp-sharded) hidden frontier."""
        if not cut_vec:
            return 0
        per = []
        for b in cut_vec:
            c = bmap.get(b)
            if c is None or c.aval is None:
                continue
            per.append(_nbytes(c.aval)
                       // max(divs.get(c.frontier_id, 1), 1))
        if not per:
            return 0
        return max(per) // max(M, 1)

    def objective_of(stages: List[StageCost], cut_vec: List[int]):
        max_fl = max((s.flops for s in stages), default=0.0)
        max_hbm = max((s.hbm_peak for s in stages), default=0)
        bub = bubble_fraction(M, pp, schedule, v)
        tick_b = frontier_tick_bytes(cut_vec)
        wire = schedule_collectives(M, pp, tick_b, schedule, v,
                                    axis=axis, tiers=tiers or None)
        obj = (fl_w * max_fl * M + bu_w * bub * total_flops
               + wi_w * wire["total_bytes"] + hb_w * max_hbm)
        return obj, bub, wire, tick_b

    need = n_global - 1
    if cuts is not None:
        best_cuts = sorted(int(c) for c in cuts)
        for b in best_cuts:
            if b not in bmap:
                diagnostics.append(
                    f"pipeline-cut: requested cut at op {b} is not a "
                    "legal single-tensor boundary")
    elif need <= 0 or len(bset) < need:
        best_cuts = bset[:max(need, 0)]
    else:
        # diagnostic-stratified beam over boundaries in dataflow order
        # (the PR 10 machinery, re-aimed at cut vectors): a state is a
        # partial cut prefix; closing a stage prices it; states bucket
        # by the diagnostics their CLOSED stages carry and the top
        # `beam` of each of the lowest strata survive. Ranking inside a
        # stratum is the closed-stage imbalance against the ideal
        # flops/n_global split — the optimistic completion score.
        ideal = total_flops / n_global
        # states: (diags, score, n_cuts, cuts_tuple)
        states: List[tuple] = [(0, 0.0, 0, ())]
        for pos, b in enumerate(bset):
            remaining = len(bset) - pos - 1
            nxt: List[tuple] = []
            for dg, sc, k, cv in states:
                if k + remaining >= need:   # skipping b can still finish
                    nxt.append((dg, sc, k, cv))
                if k < need:                # cut at b: close a stage
                    lo = cv[-1] if cv else 0
                    st = stage_cost(lo, b)
                    nxt.append((dg + st.diagnostics,
                                sc + abs(st.flops - ideal), k + 1,
                                cv + (b,)))
            buckets: Dict[int, list] = {}
            for t in nxt:
                buckets.setdefault(t[0], []).append(t)
            states = []
            for lvl in sorted(buckets)[:_DIAG_STRATA]:
                states.extend(sorted(buckets[lvl],
                                     key=lambda t: t[1])[:beam_w])
        finals = [t for t in states if t[2] == need]
        scored = []
        for dg, _sc, _k, cv in finals:
            stages = build_stages(list(cv))
            dg_full = sum(s.diagnostics for s in stages)
            obj, _b, _w, _t = objective_of(stages, list(cv))
            scored.append((dg_full, obj, list(cv)))
        scored.sort(key=lambda t: (t[0], t[1]))
        best_cuts = scored[0][2] if scored else bset[:need]
        if scored and scored[0][0] > 0:
            diagnostics.append(
                f"pipeline-cut: every {n_global}-stage partition "
                "carries per-stage SPMD diagnostics — no clean cut "
                "exists for this layout")

    stages = build_stages(best_cuts)
    obj, bub, wire, tick_b = objective_of(stages, best_cuts)

    # hand baseline: the equal-segments cut (what an engineer writes by
    # hand — `layers // pp` per stage), priced with the SAME objective
    hand: Dict[str, Any] = {}
    n_seg = len(bset) + 1
    if need > 0 and len(bset) >= need:
        hand_cuts = sorted({bset[min(len(bset) - 1,
                                     (k * n_seg) // n_global - 1)]
                            for k in range(1, n_global)})
        if len(hand_cuts) == need:
            h_stages = build_stages(hand_cuts)
            h_obj, _hb, _hw, _ht = objective_of(h_stages, hand_cuts)
            hand = {"cuts": hand_cuts, "objective": float(h_obj),
                    "max_stage_flops": max(s.flops for s in h_stages),
                    "diagnostics": sum(s.diagnostics
                                       for s in h_stages)}

    # expert placement summary (the inner plan's 'ep' work)
    expert: Dict[str, Any] = {}
    if inner_rep is not None:
        a2a = [c for c in inner_rep.collectives if c.kind == "all_to_all"]
        if a2a:
            ep_axes = sorted({c.axis for c in a2a})
            expert = {
                "axis": ",".join(ep_axes),
                "all_to_all_count": len(a2a),
                "all_to_all_bytes": int(sum(c.bytes for c in a2a)),
                "rules": sorted(r.template for r in inner.rules
                                if any(ax in ep_axes
                                       for e in _spec_entries(r.spec)
                                       for ax in e)),
            }

    plan = PipelinePlan(
        mesh_axes=dict(axes), axis=axis, num_stages=pp, num_virtual=v,
        num_micro=M, schedule=schedule, cuts=list(best_cuts),
        stages=stages, frontier_bytes_per_tick=int(tick_b),
        wire=dict(wire), bubble=float(bub), objective=float(obj),
        diagnostics=diagnostics, inner=inner,
        # the FULL candidate list, not just the chosen cuts: segments
        # (the execution-side unit grid) are defined between candidate
        # boundaries, so stage_segments() needs them all
        cut_points=cand,
        hand=hand, expert=expert, evaluations=evaluations)
    inner.pipeline = plan
    monitor.stat_add("spmd.pipeline_plans")
    monitor.stat_set_many({
        "spmd.pipeline_objective": plan.objective,
        "spmd.pipeline_stages": n_global,
        "spmd.pipeline_wire_bytes": wire["total_bytes"],
    })
    return plan


# ---------------------------------------------------------------------------
# the strategy.auto_shard seam (fleet.distributed_optimizer -> Executor)
# ---------------------------------------------------------------------------

def resolve_auto_shard(program: Program, cfg=None) -> Optional[ShardingPlan]:
    """Resolve a Program tagged `auto_shard` (by
    `fleet.DistributedOptimizer.minimize` under a strategy with
    `auto_shard = True`) into concrete `spmd_param_specs` /
    `spmd_data_specs`. Called from the Executor's compile path; a
    no-mesh environment resolves to None (nothing to shard).

    A mesh with a pipeline axis ('pp' by default, override via
    cfg["pipeline_axis"]) routes through `plan_pipeline` instead, and a
    plan carrying stage cuts pins them as `program._pipeline_stages`
    (stage op ranges + per-param stage map) — resolved HERE, before the
    VERIFY_SPMD hook reads the program, so the analyzer and the stage
    assignment always describe the same plan."""
    cfg = dict(cfg if cfg is not None
               else getattr(program, "_auto_shard", None) or {})
    plan = cfg.get("plan")
    if plan is None:
        mesh = cfg.get("mesh")
        if mesh is None:
            from ..distributed import mesh as mesh_mod
            mesh = mesh_mod.get_mesh()
        axes = _mesh_axes(mesh)
        if not axes:
            return None
        pp_axis = cfg.get("pipeline_axis", "pp")
        if axes.get(pp_axis, 1) > 1:
            pp_plan = plan_pipeline(
                program, mesh=mesh, axis=pp_axis,
                num_micro=cfg.get("num_micro"),
                num_virtual=int(cfg.get("num_virtual", 1)),
                schedule=cfg.get("schedule"), names=cfg.get("names"),
                data_specs=cfg.get("data_specs"),
                zero_dp=bool(cfg.get("zero_dp", False)),
                inner_beam=cfg.get("beam"),
                coll_weight=cfg.get("coll_weight"),
                inner_hbm_weight=cfg.get("hbm_weight"))
            plan = pp_plan.inner
        else:
            plan = plan_program(
                program, mesh=mesh, names=cfg.get("names"),
                data_specs=cfg.get("data_specs"),
                zero_dp=bool(cfg.get("zero_dp", False)),
                coll_weight=cfg.get("coll_weight"),
                hbm_weight=cfg.get("hbm_weight"), beam=cfg.get("beam"))
        cfg["plan"] = plan
        program._auto_shard = cfg  # memoize: compile may re-enter
    plan.apply(program)
    pp = getattr(plan, "pipeline", None)
    if pp is not None:
        program._pipeline_stages = {
            "axis": pp.axis,
            "num_stages": pp.num_stages,
            "num_virtual": pp.num_virtual,
            "num_micro": pp.num_micro,
            "schedule": pp.schedule,
            "stage_op_ranges": [tuple(s.op_range) for s in pp.stages],
            "param_stages": pp.param_stages(program),
        }
    return plan
