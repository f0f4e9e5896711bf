"""The SPMD sharding analyzer: static PartitionSpec propagation over a
static ``Program`` (paddle_tpu/static/spmd_analyzer.py).

Parallelism is declared as PartitionSpecs (``distributed/mesh.py``'s
``PartitionSpec``, ``distributed/sharding.py``'s rule tables) and this
module computes its consequences from the recorded avals, with no
tracing and no devices:

  * per-op spec propagation rules (elementwise merge, matmul contraction
    with its implied all-reduce, reshape / transpose / concat / split
    remapping, the vocab-parallel embedding gather, reductions, the
    fused CE head, MoE's all-to-alls), with ``register_spmd_rule``;
  * the implied collectives: kind, mesh axis and payload bytes a rank
    (``Collective``), priced against the mesh's link tiers when it
    declares them;
  * a peak-memory estimate a rank (``shape_infer.analyze_memory`` with
    the sharded dims divided);
  * the diagnostic catalogue (``DIAGNOSTIC_CODES``) as
    ``SpmdDiagnostic`` records or a raised ``SpmdLintError``, and the
    collective-order check across cond branches;
  * the per-op forward FLOPs model (``analyze_flops``), which the
    capacity model (``static/capacity.py``) prices a prefill with.

The port's ops are recorded under the JAX package's names, so the rules
carry over as they are. Dtypes are torch's; a collective names its
element type by the same name numpy uses (``float32``, ``bfloat16``).
The JAX package's x64 mode records f64 where the port records f32
(ROADMAP Queue 3 D), so such a var's bytes are half the JAX package's.

Exposure: ``tools/spmd_lint.py``, the ``PADDLE_TPU_VERIFY_SPMD`` hook in
the Executor's compile path (``maybe_verify_spmd``), and the
``core/monitor`` gauges ``spmd.{collective_bytes,hbm_estimate,
resharding_count}``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .program import Program, _Aval, _Ref

__all__ = ["SpmdLintError", "SpmdDiagnostic", "Collective", "SpmdReport",
           "analyze_program", "analyze_params", "analyze_flops",
           "register_spmd_rule", "register_flop_rule", "SPMD_RULES",
           "FLOP_RULES", "DIAGNOSTIC_CODES", "verify_spmd_enabled",
           "set_verify_spmd", "maybe_verify_spmd"]

# Every named finding the analyzer can produce. Each code has a dedicated
# broken-program test in tests/test_spmd_analyzer.py (the negative corpus,
# mirroring the PR-1 verifier corpus).
DIAGNOSTIC_CODES = (
    "unbound-axis",     # spec names an axis the mesh does not declare
    "duplicate-axis",   # one spec uses the same axis on two dims
    "non-divisible",    # dim not divisible by its axis size (silent
                        # replication in sharding._validate_divisible)
    "spec-rank",        # spec has more entries than the tensor has dims
                        # (trailing axes silently zip-truncated before)
    "reshard",          # spec conflict forcing an implicit all-gather
    "collective-divergence",  # cond branches imply different collective
                              # sequences (single-program SPMD invariant)
    "cross-tier",       # a recurring collective rides a slow-tier (DCN)
                        # link — model parallelism left crossing the pod
                        # boundary; only the dp gradient sync should
                        # cross, and hierarchically (hierarchical_sync)
)


class SpmdLintError(RuntimeError):
    """A sharding finding, raised in strict mode (the VERIFY_SPMD hook).

    `code` is one of DIAGNOSTIC_CODES; `op_name`/`op_index`, `var` and
    `axis` pinpoint the offending op, variable and mesh axis. The message
    lists every finding of the analysis run, not just the first.
    """

    def __init__(self, message, *, code=None, op_name=None, op_index=None,
                 var=None, axis=None):
        self.code = code
        self.op_name = op_name
        self.op_index = op_index
        self.var = var
        self.axis = axis
        super().__init__(message)


@dataclass
class SpmdDiagnostic:
    code: str
    message: str
    op_name: Optional[str] = None
    op_index: Optional[int] = None
    var: Optional[str] = None
    axis: Optional[str] = None

    def __str__(self):
        where = ""
        if self.op_name is not None:
            where = (f" [op #{self.op_index} '{self.op_name}']"
                     if self.op_index is not None
                     else f" [op '{self.op_name}']")
        return f"{self.code}{where}: {self.message}"


def _wire_dtype(dtype) -> torch.dtype:
    """The torch dtype of a dtype or its name ('float32', 'bfloat16',
    'int8', 'float8_e4m3fn', ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype)).replace("torch.", "")
    t = getattr(torch, name, None)
    if not isinstance(t, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return t


def _dtype_name(dtype) -> str:
    """A dtype's name as numpy spells it ('float32', 'bfloat16')."""
    return str(_wire_dtype(dtype)).replace("torch.", "")


@dataclass
class Collective:
    """One implied collective. `bytes` is the per-device payload: the
    tensor's logical nbytes divided by the shard divisor of the dims NOT
    taking part in the communication. `dtype` is the element type riding
    the wire (numpy name), so quantized-collective analysis can re-price
    the payload under a narrower cast without re-walking the program.
    `tier`/`cost_us` price the payload against the two-tier topology
    model when the mesh declares per-axis link tiers (mesh.axis_tiers);
    on a flat mesh they stay at the defaults."""
    kind: str          # all_reduce | all_gather
    axis: str          # mesh axis (comma-joined when a dim carries several)
    bytes: int
    op_index: Optional[int] = None
    op_name: Optional[str] = None
    var: Optional[str] = None
    dtype: Optional[str] = None
    tier: str = "ici"  # slowest link tier the payload rides
    cost_us: float = 0.0  # bytes / (link GB/s * 1e3); 0 on flat meshes

    def bytes_if(self, dtype) -> int:
        """Per-device payload bytes if the wire format were `dtype`
        (the EQuARX quantized-AllReduce seam: int8/fp8 block-scaled
        collectives keep the element COUNT, shrink the element size)."""
        if self.dtype is None:
            return self.bytes
        old = _wire_dtype(self.dtype).itemsize
        new = _wire_dtype(dtype).itemsize
        return (self.bytes * new) // max(old, 1)

    @property
    def is_float(self) -> bool:
        if self.dtype is None:
            return False
        return _wire_dtype(self.dtype).is_floating_point


def _spec_str(entries) -> str:
    parts = []
    for e in entries:
        if not e:
            parts.append("None")
        elif len(e) == 1:
            parts.append(f"'{e[0]}'")
        else:
            parts.append("(" + ",".join(f"'{a}'" for a in e) + ")")
    return "P(" + ", ".join(parts) + ")"


@dataclass
class SpmdReport:
    mesh_axes: Dict[str, int]
    specs: Dict[int, tuple] = field(default_factory=dict)
    var_names: Dict[int, str] = field(default_factory=dict)
    collectives: List[Collective] = field(default_factory=list)
    diagnostics: List[SpmdDiagnostic] = field(default_factory=list)
    hbm: Optional[dict] = None             # analyze_memory, per-device
    hbm_replicated: Optional[dict] = None  # same program, no sharding
    unknown_ops: set = field(default_factory=set)
    mesh_tiers: Dict[str, dict] = field(default_factory=dict)
    # ^ axis -> {"tier", "gbps"}; empty on a flat (single-tier) mesh
    dp_axes: Tuple[str, ...] = ()
    # ^ pure data-parallel axes: shard a feed but no persistable — the
    #   axes whose gradient sync the hierarchical decomposition targets

    def collective_bytes(self) -> int:
        return sum(c.bytes for c in self.collectives)

    def tier_bytes(self) -> Dict[str, int]:
        """Wire bytes per link tier (a collective counts toward the
        slowest tier it touches)."""
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c.tier] = out.get(c.tier, 0) + c.bytes
        return out

    def _axis_gbps(self, axis) -> float:
        gs = [float(self.mesh_tiers[ax]["gbps"])
              for ax in str(axis).split(",")
              if ax in self.mesh_tiers
              and float(self.mesh_tiers[ax].get("gbps", 0)) > 0]
        return min(gs) if gs else 0.0

    def weighted_collective_bytes(self, kind=None) -> float:
        """Collective bytes with each payload scaled by how much slower
        its link is than the fastest declared tier — the planner's
        topology-aware objective term. Equals collective_bytes() on a
        flat mesh, so single-tier plans and goldens are unchanged.
        `kind` restricts to one collective kind (e.g. "all_reduce")."""
        cs = [c for c in self.collectives
              if kind is None or c.kind == kind]
        if not self.mesh_tiers:
            return float(sum(c.bytes for c in cs))
        top = max((float(m.get("gbps", 0.0))
                   for m in self.mesh_tiers.values()), default=0.0)
        if top <= 0:
            return float(sum(c.bytes for c in cs))
        total = 0.0
        for c in cs:
            g = self._axis_gbps(c.axis)
            total += c.bytes * (top / g if g > 0 else 1.0)
        return total

    def hierarchical_sync(self, grad_bytes=None, k_steps=None
                          ) -> Optional[dict]:
        """Price the pure-dp gradient sync three ways over the two-tier
        mesh: a flat all-reduce over every dp axis, the hierarchical
        decomposition (reduce-scatter intra-pod -> inter-pod all-reduce
        over the 1/n shard -> all-gather intra-pod), and LocalSGD (flat
        sync every k steps). Per-device ring wire model: an all-reduce
        of B bytes over an axis of size s moves 2*B*(s-1)/s per device.
        `grad_bytes` defaults to the per-device param bytes from the HBM
        estimate. Returns None on a flat mesh or when no pure-dp axis
        exists."""
        from ..core.flags import flag as _flag
        tiers = self.mesh_tiers or {}
        if not tiers:
            return None
        dp = [a for a in self.dp_axes if a in self.mesh_axes]
        if not dp:
            return None
        if grad_bytes is None:
            grad_bytes = int((self.hbm or {}).get("param_bytes", 0))
        if k_steps is None:
            k_steps = int(_flag("FLAGS_topology_localsgd_k"))

        def meta(ax):
            return tiers.get(ax) or {
                "tier": "ici",
                "gbps": float(_flag("FLAGS_topology_ici_gbps"))}

        top = max((float(m.get("gbps", 0.0)) for m in tiers.values()),
                  default=0.0)
        slow = [a for a in dp if 0 < float(meta(a)["gbps"]) < top]
        fast = [a for a in dp if a not in slow]
        n = 1
        for a in fast:
            n *= self.mesh_axes[a]
        pods = 1
        for a in slow:
            pods *= self.mesh_axes[a]

        def ring(b, size):
            return 0 if size <= 1 else (2 * int(b) * (size - 1)) // size

        B = int(grad_bytes)
        flat = {"ici": ring(B, n), "dcn": ring(B, pods)}
        hier = {"ici": ring(B, n), "dcn": ring(B // max(n, 1), pods)}
        local = {t: b // max(int(k_steps), 1) for t, b in flat.items()}
        gs_fast = [float(meta(a)["gbps"]) for a in fast]
        gs_slow = [float(meta(a)["gbps"]) for a in slow]
        ici_g = min(gs_fast) if gs_fast else \
            float(_flag("FLAGS_topology_ici_gbps"))
        dcn_g = min(gs_slow) if gs_slow else \
            float(_flag("FLAGS_topology_dcn_gbps"))

        def cost(wire):
            return {"ici": wire["ici"] / (ici_g * 1e3) if ici_g else 0.0,
                    "dcn": wire["dcn"] / (dcn_g * 1e3) if dcn_g else 0.0}

        schemes = {}
        raw_costs = {}
        for name, wire in (("flat", flat), ("hierarchical", hier),
                           ("localsgd", local)):
            c = cost(wire)
            raw_costs[name] = c
            schemes[name] = {
                "wire_bytes": dict(wire),
                "cost_us": {k: round(v, 3) for k, v in c.items()},
                "total_cost_us": round(sum(c.values()), 3)}
        reduction = (flat["dcn"] / hier["dcn"]) if hier["dcn"] \
            else float(n if pods > 1 else 1)
        hc = raw_costs["hierarchical"]
        ratio = (hc["dcn"] / hc["ici"]) if hc["ici"] > 0 else None
        if pods <= 1 or n <= 1:
            # no slow boundary to hide, or no inner axis to shard the
            # inter-pod payload over — the decomposition buys nothing
            rec = "flat"
        elif ratio is not None and \
                ratio > float(_flag("FLAGS_topology_localsgd_ratio")):
            rec = "localsgd"
        else:
            rec = "hierarchical"
        return {"grad_bytes": B, "dp_axes": list(dp),
                "inner": {"axes": fast, "size": n},
                "outer": {"axes": slow, "size": pods},
                "schemes": schemes,
                "inter_pod_reduction_x": round(float(reduction), 3),
                "dcn_over_ici_cost":
                    round(ratio, 3) if ratio is not None else None,
                "recommendation": rec,
                "localsgd_k": int(k_steps)}

    def resharding_count(self) -> int:
        return sum(1 for d in self.diagnostics if d.code == "reshard")

    def spec_of(self, var) -> tuple:
        vid = getattr(var, "var_id", var)
        return self.specs.get(vid, ())

    def publish(self):
        """Export the spmd.* gauges (reference STAT_ADD dashboards)."""
        from ..core import monitor
        monitor.stat_set_many({
            "spmd.collective_bytes": self.collective_bytes(),
            "spmd.hbm_estimate":
                self.hbm["peak_bytes"] if self.hbm else 0,
            "spmd.resharding_count": self.resharding_count(),
        })

    def raise_on_findings(self):
        if not self.diagnostics:
            return self
        first = self.diagnostics[0]
        lines = [f"spmd-lint: {len(self.diagnostics)} finding(s):"]
        lines += [f"  {d}" for d in self.diagnostics]
        raise SpmdLintError("\n".join(lines), code=first.code,
                            op_name=first.op_name, op_index=first.op_index,
                            var=first.var, axis=first.axis)

    def quantized_savings(self, dtype="int8") -> Dict[str, dict]:
        """Per-mesh-axis wire-byte savings if every FLOAT collective were
        cast to `dtype` on the wire (EQuARX-style quantized AllReduce;
        integer payloads — index gathers etc. — are left untouched).
        Returns {axis: {bytes, bytes_quantized, saved}}."""
        out: Dict[str, dict] = {}
        for c in self.collectives:
            row = out.setdefault(c.axis, {"bytes": 0, "bytes_quantized": 0,
                                          "saved": 0})
            q = c.bytes_if(dtype) if c.is_float else c.bytes
            row["bytes"] += c.bytes
            row["bytes_quantized"] += q
            row["saved"] += c.bytes - q
        return out

    def render(self) -> str:
        """Human-readable report (tools/spmd_lint.py)."""
        lines = ["spmd analysis: mesh {" + ", ".join(
            f"{a}:{s}" for a, s in self.mesh_axes.items()) + "}"]
        if self.mesh_tiers:
            by_tier: Dict[tuple, List[str]] = {}
            for ax, m in self.mesh_tiers.items():
                by_tier.setdefault(
                    (str(m["tier"]), float(m["gbps"])), []).append(ax)
            lines.append("link tiers: " + "; ".join(
                f"{','.join(axs)}={t}@{g:g}GB/s"
                for (t, g), axs in sorted(by_tier.items())))
        if self.collectives:
            by_key: Dict[tuple, List[Collective]] = {}
            for c in self.collectives:
                by_key.setdefault((c.kind, c.axis), []).append(c)
            lines.append("collectives per step:")
            hdr = f"  {'kind':<12}{'axis':<8}{'count':>6}{'bytes':>14}"
            if self.mesh_tiers:
                hdr += f"{'tier':>6}{'cost_us':>10}"
            lines.append(hdr)
            for (kind, axis), cs in sorted(by_key.items()):
                row = (f"  {kind:<12}{axis:<8}{len(cs):>6}"
                       f"{sum(c.bytes for c in cs):>14}")
                if self.mesh_tiers:
                    row += (f"{cs[0].tier:>6}"
                            f"{sum(c.cost_us for c in cs):>10.1f}")
                lines.append(row)
            lines.append(f"collective bytes/step: {self.collective_bytes()}")
            if self.mesh_tiers:
                lines.append("wire bytes per tier: " + ", ".join(
                    f"{t}={b}" for t, b in sorted(
                        self.tier_bytes().items())))
            savings = self.quantized_savings("int8")
            if any(row["saved"] for row in savings.values()):
                lines.append("int8/fp8 quantized collectives would save "
                             "(per mesh axis, float payloads only):")
                for axis, row in sorted(savings.items()):
                    if not row["saved"]:
                        continue
                    ratio = row["bytes"] / max(row["bytes_quantized"], 1)
                    lines.append(
                        f"  axis {axis}: {row['bytes']} B -> "
                        f"{row['bytes_quantized']} B "
                        f"(saves {row['saved']} B, {ratio:.1f}x)")
        else:
            lines.append("collectives per step: none")
        if self.mesh_tiers:
            hs = self.hierarchical_sync()
            if hs:
                lines.append(
                    f"dp gradient sync ({'+'.join(hs['dp_axes'])}, "
                    f"{hs['grad_bytes']} B grads, per device):")
                for name in ("flat", "hierarchical", "localsgd"):
                    s = hs["schemes"][name]
                    lines.append(
                        f"  {name:<14}ici {s['wire_bytes']['ici']:>12} B"
                        f"  dcn {s['wire_bytes']['dcn']:>12} B"
                        f"  {s['total_cost_us']:>12.1f} us")
                lines.append(
                    "  hierarchical cuts inter-pod bytes "
                    f"{hs['inter_pod_reduction_x']:.1f}x vs flat; "
                    f"recommended: {hs['recommendation']}")
        if self.hbm:
            lines.append(
                f"per-device HBM estimate: peak {self.hbm['peak_bytes']} "
                f"(params {self.hbm['param_bytes']}, activations "
                f"{self.hbm['activation_peak_bytes']})")
            if self.hbm_replicated:
                lines.append("unsharded (replicated) peak: "
                             f"{self.hbm_replicated['peak_bytes']}")
        if self.unknown_ops:
            lines.append("ops with no spmd rule (sharded inputs dropped "
                         "to replicated): " + ", ".join(sorted(
                             self.unknown_ops)))
        if self.diagnostics:
            lines.append(f"diagnostics ({len(self.diagnostics)}):")
            lines += [f"  {d}" for d in self.diagnostics]
        else:
            lines.append("diagnostics: none")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# spec plumbing. Internally a spec is a tuple with one entry per dim, each
# entry a tuple of mesh-axis names (empty = replicated) — the normalized
# form of a PartitionSpec.
# ---------------------------------------------------------------------------

def _mesh_topology(mesh) -> Tuple[Dict[str, int], Dict[str, dict]]:
    """(axes, tiers) from a Mesh, an {axis: size-or-tier-dict} dict (no
    devices needed — lint a pod layout from a laptop), or the registered
    default. `tiers` is {} when the mesh is flat — every axis on the
    default tier at the default bandwidth — so single-tier reports stay
    byte-identical to pre-topology output."""
    from ..distributed import mesh as mesh_mod
    if mesh is None:
        mesh = mesh_mod.get_mesh()
    if mesh is None:
        return {}, {}
    if isinstance(mesh, dict):
        axes = mesh_mod.axis_sizes(mesh)
    else:
        axes = {str(n): int(mesh.shape[n]) for n in mesh.axis_names}
    tiers = mesh_mod.axis_tiers(mesh)
    base = mesh_mod._tier_gbps(mesh_mod.DEFAULT_TIER)
    if all(m["tier"] == mesh_mod.DEFAULT_TIER and
           float(m["gbps"]) == base for m in tiers.values()):
        tiers = {}
    return axes, tiers


def _mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size (the size half of _mesh_topology)."""
    return _mesh_topology(mesh)[0]


def _norm_entry(e) -> tuple:
    if e is None:
        return ()
    if isinstance(e, str):
        return (e,)
    return tuple(e)


def _entries(spec) -> tuple:
    if spec is None:
        return ()
    return tuple(_norm_entry(e) for e in tuple(spec))


class _AV:
    """Abstract value during propagation: spec + aval (aval None for
    non-array literals)."""

    __slots__ = ("spec", "aval")

    def __init__(self, spec, aval):
        self.spec = spec
        self.aval = aval


def _aval_of(x):
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return _Aval(tuple(x.shape), x.dtype)
    return None


def _nbytes(aval) -> int:
    n = 1
    for s in aval.shape:
        n *= int(s)
    return n * _wire_dtype(aval.dtype).itemsize


def _lit(v, default=None):
    """Literal kwarg value (an _AV or an aval means a tensor slipped into
    an attr slot — fall back to the default)."""
    return default if isinstance(v, (_AV, _Aval)) else v


class _Ctx:
    """Propagation context: mesh axes + the report being filled. Sub-block
    walks get a child with its OWN collective list (so branch sequences
    can be compared) but the shared diagnostic list."""

    def __init__(self, axes: Dict[str, int], report: SpmdReport,
                 collectives: Optional[list] = None, label: str = ""):
        self.axes = axes
        self.report = report
        self.collectives = report.collectives if collectives is None \
            else collectives
        self.label = label  # "cond#5/true/" inside sub-block walks
        self.op_index: Optional[int] = None
        self.op_name: Optional[str] = None
        self.tiers = report.mesh_tiers or {}
        gs = [float(m.get("gbps", 0.0)) for m in self.tiers.values()
              if float(m.get("gbps", 0.0)) > 0]
        self._top_gbps = max(gs, default=0.0)
        self.slow_axes = {ax for ax, m in self.tiers.items()
                          if 0 < float(m.get("gbps", 0.0)) < self._top_gbps}

    def child(self, label: str = ""):
        return _Ctx(self.axes, self.report, collectives=[],
                    label=self.label + label)

    def div(self, entry: tuple) -> int:
        d = 1
        for ax in entry:
            d *= self.axes.get(ax, 1)
        return d

    def spec_div(self, spec: tuple) -> int:
        d = 1
        for e in spec:
            d *= self.div(e)
        return d

    def payload(self, aval, spec, exclude=()) -> int:
        """Per-device payload bytes of `aval` under `spec`, not counting
        the axes in `exclude` (the axes doing the communicating)."""
        if aval is None:
            return 0
        d = 1
        for e in spec:
            for ax in e:
                if ax not in exclude:
                    d *= self.axes.get(ax, 1)
        return _nbytes(aval) // max(d, 1)

    def collective(self, kind, entry, bytes_, var=None, aval=None,
                   dtype=None):
        if dtype is None and aval is not None:
            dtype = _dtype_name(aval.dtype)
        axes = tuple(entry.split(",")) if isinstance(entry, str) \
            else tuple(entry)
        tier, cost = "ici", 0.0
        if self.tiers:
            metas = [self.tiers[ax] for ax in axes if ax in self.tiers]
            if metas:
                slowest = min(
                    metas, key=lambda m: float(m.get("gbps", 0.0)) or
                    float("inf"))
                tier = str(slowest.get("tier", tier))
                g = float(slowest.get("gbps", 0.0))
                cost = float(bytes_) / (g * 1e3) if g > 0 else 0.0
        self.collectives.append(Collective(
            kind=kind, axis=",".join(axes), bytes=int(bytes_),
            op_index=self.op_index, op_name=self.op_name, var=var,
            dtype=dtype, tier=tier, cost_us=cost))

    def diag(self, code, message, var=None, axis=None):
        self.report.diagnostics.append(SpmdDiagnostic(
            code=code, message=message, op_name=self.op_name,
            op_index=self.op_index, var=var, axis=axis))


def _validate_spec(ctx: _Ctx, spec_like, shape, var) -> tuple:
    """Normalize + validate a user/rule-supplied spec against a shape:
    rank, axis existence, duplicate axes, divisibility. Invalid entries
    degrade to replicated, each with a named diagnostic — the loud form
    of what sharding._validate_divisible used to do silently."""
    ents = list(_entries(spec_like))
    if len(ents) > len(shape):
        ctx.diag(
            "spec-rank",
            f"PartitionSpec {_spec_str(tuple(ents))} has {len(ents)} "
            f"entries for rank-{len(shape)} '{var}' — trailing axes "
            "would be silently dropped", var=var)
        ents = ents[:len(shape)]
    ents += [()] * (len(shape) - len(ents))
    seen: Dict[str, int] = {}
    out = []
    for d, ent in enumerate(ents):
        keep = []
        for ax in ent:
            if ax not in ctx.axes:
                ctx.diag(
                    "unbound-axis",
                    f"spec of '{var}' names axis '{ax}' but the mesh "
                    f"declares only {sorted(ctx.axes) or '(no axes)'}",
                    var=var, axis=ax)
                continue
            if ax in seen:
                ctx.diag(
                    "duplicate-axis",
                    f"axis '{ax}' appears on dims {seen[ax]} and {d} of "
                    f"the spec of '{var}' — one axis cannot shard two "
                    "dims", var=var, axis=ax)
                continue
            seen[ax] = d
            keep.append(ax)
        ent = tuple(keep)
        if ent and shape[d] % ctx.div(ent):
            ctx.diag(
                "non-divisible",
                f"dim {d} of '{var}' has size {shape[d]}, not divisible "
                f"by the size {ctx.div(ent)} of axis "
                f"{','.join(ent)} — GSPMD would pad and "
                "sharding._validate_divisible falls back to replication",
                var=var, axis=",".join(ent))
            ent = ()
        out.append(ent)
    return tuple(out)


# ---------------------------------------------------------------------------
# per-op propagation rules
# ---------------------------------------------------------------------------

SPMD_RULES: Dict[str, Any] = {}


def register_spmd_rule(*names):
    """Register a propagation rule: fn(ctx, ins, kw, out_avals, var) ->
    [spec, ...] (one per output). `ins` are the op's positional inputs as
    _AV (tensors) or raw literals; `kw` is the kwargs dict with tensor
    leaves as _AV."""
    def deco(fn):
        for n in names:
            SPMD_RULES[n] = fn
        return fn
    return deco


def _tensors(ins) -> List[_AV]:
    return [v for v in ins if isinstance(v, _AV) and v.aval is not None]


def _repl(aval) -> tuple:
    return ((),) * len(aval.shape)


def _merge_elementwise(ctx, ins, out_aval, var):
    """Right-aligned broadcast merge. A dim where two inputs carry
    different shardings is a conflict: the later operand is implicitly
    all-gathered (reported) and the dim stays with the first sharding."""
    nd = len(out_aval.shape)
    out = [()] * nd
    used: Dict[str, int] = {}
    for v in _tensors(ins):
        vnd = len(v.aval.shape)
        gathered = False
        for k in range(1, vnd + 1):
            ent = v.spec[vnd - k]
            if not ent or v.aval.shape[vnd - k] == 1:
                continue
            d = nd - k
            if out[d] == ent:
                continue
            if not out[d] and all(used.get(ax, d) == d for ax in ent):
                out[d] = ent
                for ax in ent:
                    used[ax] = d
            elif not gathered:
                gathered = True
                ctx.diag(
                    "reshard",
                    f"elementwise operands of '{ctx.op_name}' carry "
                    f"conflicting shardings on dim {d} "
                    f"({_spec_str((out[d],))} vs {_spec_str((ent,))}) — "
                    "an implicit all-gather reshard is required",
                    var=var, axis=",".join(ent))
                ctx.collective("all_gather", ent,
                               ctx.payload(v.aval, v.spec, exclude=ent),
                               var=var, aval=v.aval)
    return tuple(out)


@register_spmd_rule("add", "subtract", "multiply", "divide", "maximum",
                    "minimum", "floor_divide", "pow", "remainder", "where")
def _ew_rule(ctx, ins, kw, out_avals, var):
    return [_merge_elementwise(ctx, ins, out_avals[0], var)]


@register_spmd_rule("matmul")
def _matmul_rule(ctx, ins, kw, out_avals, var):
    x, y = ins[0], ins[1]
    out_aval = out_avals[0]
    if not isinstance(x, _AV) or not isinstance(y, _AV) \
            or x.aval is None or y.aval is None:
        return [_repl(out_aval)]
    xs, xsh = list(x.spec), list(x.aval.shape)
    ys, ysh = list(y.spec), list(y.aval.shape)
    if _lit(kw.get("transpose_x", False), False) and len(xsh) > 1:
        xsh[-1], xsh[-2] = xsh[-2], xsh[-1]
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if _lit(kw.get("transpose_y", False), False) and len(ysh) > 1:
        ysh[-1], ysh[-2] = ysh[-2], ysh[-1]
        ys[-1], ys[-2] = ys[-2], ys[-1]
    vec_x, vec_y = len(xsh) == 1, len(ysh) == 1
    if vec_x:
        xsh, xs = [1] + xsh, [()] + xs
    if vec_y:
        ysh, ys = ysh + [1], ys + [()]
    xc, yc = xs[-1], ys[-2]

    # assemble the full (padded) out spec: broadcast batch + row + col
    nb = max(len(xsh), len(ysh)) - 2
    batch = [()] * nb
    for spec, sh in ((xs, xsh), (ys, ysh)):
        bnd = len(sh) - 2
        for k in range(1, bnd + 1):
            ent = spec[bnd - k]
            if ent and sh[bnd - k] != 1 and not batch[nb - k]:
                batch[nb - k] = ent
    full = batch + [xs[-2], ys[-1]]

    if xc and yc and xc == yc:
        # true contraction sharding: partial sums -> all-reduce of the out
        out_spec_final = _finalize(ctx, full, vec_x, vec_y, out_aval,
                                   var=var)
        ctx.collective("all_reduce", xc,
                       ctx.payload(out_aval, out_spec_final), var=var,
                       aval=out_aval)
        return [out_spec_final]
    if xc or yc:
        if xc and yc:
            ctx.diag(
                "reshard",
                f"matmul contraction dim is sharded on DIFFERENT axes "
                f"({','.join(xc)} on x vs {','.join(yc)} on y) — both "
                "operands must be implicitly all-gathered before the "
                "matmul", var=var, axis=",".join(xc + yc))
        else:
            ent = xc or yc
            which, other = ("x", "y") if xc else ("y", "x")
            ctx.diag(
                "reshard",
                f"matmul contraction dim is sharded ({','.join(ent)}) on "
                f"operand {which} but replicated on {other} — an "
                "implicit all-gather reshard precedes the matmul",
                var=var, axis=",".join(ent))
        for side, ent in ((x, xc), (y, yc)):
            if ent:
                ctx.collective("all_gather", ent,
                               ctx.payload(side.aval, side.spec,
                                           exclude=ent), var=var,
                               aval=side.aval)
    return [_finalize(ctx, full, vec_x, vec_y, out_aval, var=var)]


def _finalize(ctx, full, vec_x, vec_y, out_aval, var=None):
    """Drop the padded vector dims and de-duplicate axes across dims (an
    axis cannot shard two output dims — e.g. a dp-sharded batch meeting
    a dp-column-sharded weight). The drop is NOT free: the operand that
    loses its sharding must be re-laid-out, so each dropped axis is
    PRICED as a reshard + all-gather of the output over that axis —
    otherwise a layout search against this cost model would "win" by
    sharding every weight on the batch axis at no modeled cost."""
    if vec_y:
        full = full[:-1]
    if vec_x:
        full = full[:-2] + full[-1:] if not vec_y else full[:-1]
    seen: set = set()
    out = []
    dropped: list = []
    for d, ent in enumerate(full):
        kept = tuple(ax for ax in ent if ax not in seen)
        seen.update(kept)
        out.append(kept)
        dropped += [(d, ax) for ax in ent if ax not in kept]
    out = (out + [()] * len(out_aval.shape))[:len(out_aval.shape)]
    out = tuple(out)
    for d, ax in dropped:
        ctx.diag(
            "reshard",
            f"matmul output dim {d} would reuse axis '{ax}', already "
            "sharding an earlier output dim — one axis cannot shard two "
            "dims, so the conflicting operand sharding is implicitly "
            "all-gathered", var=var, axis=ax)
        ctx.collective("all_gather", (ax,),
                       ctx.payload(out_aval, out, exclude=(ax,)),
                       var=var, aval=out_aval)
    return out


@register_spmd_rule("embedding")
def _embedding_rule(ctx, ins, kw, out_avals, var):
    w, ids = ins[0], ins[1]
    out_aval = out_avals[0]
    if not isinstance(w, _AV) or w.aval is None:
        return [_repl(out_aval)]
    v_ent = w.spec[0] if w.spec else ()
    d_ent = w.spec[1] if len(w.spec) > 1 else ()
    ids_spec = ids.spec if isinstance(ids, _AV) and ids.aval is not None \
        else ((),) * (len(out_aval.shape) - 1)
    used = {ax for e in ids_spec for ax in e}
    if v_ent and any(ax in used for ax in v_ent):
        # vocab-parallel over an axis that ALSO shards the ids: the
        # masked-partial all-reduce would mix different batch rows —
        # GSPMD must all-gather the table instead
        drop = tuple(ax for ax in v_ent if ax in used)
        ctx.diag(
            "reshard",
            f"embedding weight '{var}' is vocab-sharded on axis "
            f"{','.join(drop)} which also shards the ids — the "
            "vocab-parallel gather cannot reduce across it; the table "
            "is implicitly all-gathered", var=var, axis=",".join(drop))
        ctx.collective("all_gather", drop,
                       ctx.payload(w.aval, w.spec, exclude=drop),
                       var=var, aval=w.aval)
        v_ent = tuple(ax for ax in v_ent if ax not in drop)
    if d_ent and any(ax in used for ax in d_ent):
        # the embed-dim sharding collides with an id-batch axis: the
        # gather result cannot carry one axis on two dims — priced like
        # the matmul _finalize drop, not silently free
        drop = tuple(ax for ax in d_ent if ax in used)
        ctx.diag(
            "reshard",
            f"embedding output embed dim would reuse axis "
            f"{','.join(drop)}, already sharding the id batch — the "
            "weight's embed-dim sharding is implicitly all-gathered",
            var=var, axis=",".join(drop))
        d_ent = tuple(ax for ax in d_ent if ax not in used)
        out_probe = tuple(ids_spec) + (d_ent,)
        ctx.collective("all_gather", drop,
                       ctx.payload(out_aval, out_probe, exclude=drop),
                       var=var, aval=out_aval)
    out_spec = tuple(ids_spec) + (d_ent,)
    out_spec = (out_spec + ((),) * len(out_aval.shape))[
        :len(out_aval.shape)]
    if v_ent:
        # vocab-parallel gather: each shard contributes its rows, the
        # masked partial results sum across the vocab axis
        ctx.collective("all_reduce", v_ent,
                       ctx.payload(out_aval, out_spec), var=var,
                       aval=out_aval)
    return [out_spec]


def _dim_groups(in_shape, out_shape):
    """Decompose a reshape into (in_dims, out_dims) groups of equal
    element count — the standard composition used for sharding remap."""
    groups = []
    i = j = 0
    ni, nj = len(in_shape), len(out_shape)
    while i < ni or j < nj:
        gi, gj = [], []
        pi = pj = 1
        if i < ni:
            gi.append(i)
            pi = in_shape[i]
            i += 1
        if j < nj:
            gj.append(j)
            pj = out_shape[j]
            j += 1
        while pi != pj:
            if pi < pj and i < ni:
                pi *= in_shape[i]
                gi.append(i)
                i += 1
            elif pj < pi and j < nj:
                pj *= out_shape[j]
                gj.append(j)
                j += 1
            else:
                break
        # absorb trailing size-1 dims into the current group
        while i < ni and in_shape[i] == 1 and (pi == pj):
            gi.append(i)
            i += 1
        while j < nj and out_shape[j] == 1 and (pi == pj):
            gj.append(j)
            j += 1
        groups.append((gi, gj))
    return groups


def _reshape_like_rule(ctx, ins, kw, out_avals, var):
    """reshape/flatten/squeeze/unsqueeze: a sharded in-dim survives when
    it leads its factor group and the group's leading out-dim stays
    divisible; otherwise the tensor is implicitly all-gathered."""
    x = ins[0]
    out_aval = out_avals[0]
    if not isinstance(x, _AV) or x.aval is None:
        return [_repl(out_aval)]
    in_shape = tuple(x.aval.shape)
    out_shape = tuple(out_aval.shape)
    out = [()] * len(out_shape)
    for gi, gj in _dim_groups(in_shape, out_shape):
        sharded = [(d, x.spec[d]) for d in gi if x.spec[d]]
        if not sharded:
            continue
        nontrivial = [d for d in gi if in_shape[d] != 1]
        lead = nontrivial[0] if nontrivial else gi[0]
        ent = tuple(ax for _, e in sharded for ax in e)
        ok = (len(sharded) == 1 and sharded[0][0] == lead) or \
            all(d == nontrivial[k] for k, (d, _) in enumerate(sharded))
        if ok and gj and out_shape[gj[0]] % ctx.div(ent) == 0:
            out[gj[0]] = ent
        else:
            ctx.diag(
                "reshard",
                f"'{ctx.op_name}' {in_shape} -> {out_shape} cannot carry "
                f"the sharding {_spec_str(x.spec)} through (sharded dim "
                "does not map to a divisible output dim) — implicit "
                "all-gather", var=var, axis=",".join(ent))
            ctx.collective("all_gather", ent,
                           ctx.payload(x.aval, x.spec, exclude=ent),
                           var=var, aval=x.aval)
    return [tuple(out)]


for _n in ("reshape", "flatten", "squeeze", "unsqueeze"):
    SPMD_RULES[_n] = _reshape_like_rule


@register_spmd_rule("transpose")
def _transpose_rule(ctx, ins, kw, out_avals, var):
    x = ins[0]
    out_aval = out_avals[0]
    if not isinstance(x, _AV) or x.aval is None:
        return [_repl(out_aval)]
    nd = len(x.aval.shape)
    perm = kw.get("perm", None)
    if perm is None and len(ins) > 1:
        perm = _lit(ins[1])
    if perm is None:
        perm = list(range(nd))[::-1]
    return [tuple(x.spec[int(p) % nd] for p in perm)]


@register_spmd_rule("concat", "stack")
def _concat_rule(ctx, ins, kw, out_avals, var):
    out_aval = out_avals[0]
    tens = _tensors(ins)
    if not tens:
        return [_repl(out_aval)]
    nd_out = len(out_aval.shape)
    axis = int(_lit(kw.get("axis", 0), 0)) % max(nd_out, 1)
    stacked = ctx.op_name == "stack"
    out = [()] * nd_out
    used: Dict[str, int] = {}
    for v in tens:
        for d_in, ent in enumerate(v.spec):
            if not ent:
                continue
            d = d_in + 1 if stacked and d_in >= axis else d_in
            if not stacked and d == axis:
                ctx.diag(
                    "reshard",
                    f"concat along sharded dim {d} ({','.join(ent)}) — "
                    "the pieces must be all-gathered to concatenate",
                    var=var, axis=",".join(ent))
                ctx.collective("all_gather", ent,
                               ctx.payload(v.aval, v.spec, exclude=ent),
                               var=var, aval=v.aval)
                continue
            if not out[d] and all(used.get(ax, d) == d for ax in ent):
                out[d] = ent
                for ax in ent:
                    used[ax] = d
            elif out[d] != ent:
                ctx.diag(
                    "reshard",
                    f"'{ctx.op_name}' inputs disagree on dim {d} sharding "
                    f"({_spec_str((out[d],))} vs {_spec_str((ent,))}) — "
                    "implicit all-gather", var=var, axis=",".join(ent))
                ctx.collective("all_gather", ent,
                               ctx.payload(v.aval, v.spec, exclude=ent),
                               var=var, aval=v.aval)
    return [tuple(out)]


@register_spmd_rule("split_op", "unbind_op")
def _split_rule(ctx, ins, kw, out_avals, var):
    x = ins[0]
    if not isinstance(x, _AV) or x.aval is None:
        return [_repl(oa) for oa in out_avals]
    nd = len(x.aval.shape)
    axis = ins[2] if len(ins) > 2 else kw.get("axis", 0)
    axis = int(_lit(axis, 0)) % max(nd, 1)
    outs = []
    for oa in out_avals:
        spec = list(x.spec)
        if ctx.op_name == "unbind_op":
            spec = spec[:axis] + spec[axis + 1:]
        elif spec[axis]:
            ent = spec[axis]
            if len(oa.shape) > axis and oa.shape[axis] % ctx.div(ent):
                ctx.diag(
                    "non-divisible",
                    f"split section of size {oa.shape[axis]} on dim "
                    f"{axis} is not divisible by axis {','.join(ent)} "
                    f"(size {ctx.div(ent)})", var=var, axis=",".join(ent))
                spec[axis] = ()
        spec = (spec + [()] * len(oa.shape))[:len(oa.shape)]
        outs.append(tuple(spec))
    return outs


@register_spmd_rule("sum", "mean", "max", "min", "prod", "all", "any")
def _reduce_rule(ctx, ins, kw, out_avals, var):
    x = ins[0]
    out_aval = out_avals[0]
    if not isinstance(x, _AV) or x.aval is None:
        return [_repl(out_aval)]
    nd = len(x.aval.shape)
    axis = _lit(kw.get("axis", None))
    keepdim = bool(_lit(kw.get("keepdim", False), False))
    if axis is None:
        axes = tuple(range(nd))
    else:
        axes = axis if isinstance(axis, (tuple, list)) else [axis]
        axes = tuple(int(a) % nd for a in axes)
    red = set(axes)
    comm = tuple(ax for d in red for ax in (x.spec[d] if d < nd else ()))
    out = []
    for d in range(nd):
        if d in red:
            if keepdim:
                out.append(())
        else:
            out.append(x.spec[d])
    out = (out + [()] * len(out_aval.shape))[:len(out_aval.shape)]
    if comm:
        ctx.collective("all_reduce", comm,
                       ctx.payload(out_aval, tuple(out)), var=var,
                       aval=out_aval)
    return [tuple(out)]


@register_spmd_rule("softmax", "log_softmax")
def _softmax_rule(ctx, ins, kw, out_avals, var):
    x = ins[0]
    out_aval = out_avals[0]
    if not isinstance(x, _AV) or x.aval is None:
        return [_repl(out_aval)]
    nd = len(x.aval.shape)
    axis = int(_lit(kw.get("axis", -1), -1)) % max(nd, 1)
    spec = list(x.spec)
    if spec[axis]:
        # the online max/sum reduce across the sharded softmax dim
        ctx.collective("all_reduce", spec[axis],
                       ctx.payload(out_aval, tuple(
                           e for d, e in enumerate(spec) if d != axis)),
                       var=var, aval=out_aval)
    return [tuple(spec)]


@register_spmd_rule("layer_norm")
def _layer_norm_rule(ctx, ins, kw, out_avals, var):
    x = ins[0]
    out_aval = out_avals[0]
    if not isinstance(x, _AV) or x.aval is None:
        return [_repl(out_aval)]
    nd = len(x.aval.shape)
    bna = int(_lit(kw.get("begin_norm_axis", -1), -1))
    axes = tuple(range(bna % nd, nd)) if bna != -1 else (nd - 1,)
    spec = list(x.spec)
    for d in axes:
        if spec[d]:
            ctx.diag(
                "reshard",
                f"layer_norm normalizes over sharded dim {d} "
                f"({','.join(spec[d])}) — the moments need an implicit "
                "all-gather/all-reduce", var=var, axis=",".join(spec[d]))
            ctx.collective("all_gather", spec[d],
                           ctx.payload(x.aval, x.spec, exclude=spec[d]),
                           var=var, aval=x.aval)
            spec[d] = ()
    return [tuple(spec)]


@register_spmd_rule("sdpa")
def _sdpa_rule(ctx, ins, kw, out_avals, var):
    q = ins[0]
    if isinstance(q, _AV) and q.aval is not None:
        return [tuple(q.spec)]
    return [_repl(out_avals[0])]


@register_spmd_rule("fused_ce_op", "ce_head_fallback")
def _fused_ce_rule(ctx, ins, kw, out_avals, var):
    hidden, weight = ins[0], ins[1]
    out_aval = out_avals[0]
    out_spec = _repl(out_aval)
    if isinstance(hidden, _AV) and hidden.aval is not None:
        out_spec = (tuple(hidden.spec[:len(out_aval.shape)])
                    + ((),) * len(out_aval.shape))[:len(out_aval.shape)]
    if isinstance(weight, _AV) and weight.aval is not None \
            and weight.spec and weight.spec[0]:
        # vocab-parallel head: the logsumexp reduces across the vocab axis
        ctx.collective("all_reduce", weight.spec[0],
                       ctx.payload(out_aval, out_spec), var=var,
                       aval=out_aval)
    return [out_spec]


def _moe_capacity(xv_aval, kw, e_total) -> int:
    """The capacity moe.MoELayer computes at run time, re-derived from
    the recorded avals: int(cap_factor * tokens / num_experts) + 1."""
    tokens = 1
    for s in xv_aval.shape[:-1]:
        tokens *= int(s)
    cap_factor = float(_lit(kw.get("cap_factor", 1.25), 1.25))
    return int(cap_factor * tokens / max(int(e_total), 1)) + 1


@register_spmd_rule("moe_layer")
def _moe_rule(ctx, ins, kw, out_avals, var):
    """Expert parallelism (distributed/moe.py MoELayer): the stacked
    expert weights ([E, d, h] / [E, h] — dim 0 is the expert dim) may
    shard over the layer's `axis` kwarg (conventionally 'ep'); routed
    tokens then move through TWO all-to-alls (dispatch and combine) of
    the [E, capacity, d] dispatch tensor. Tokens/output keep the input's
    sharding. Expert weights disagreeing on the expert-dim axis, or an
    expert axis that also shards the tokens, are conflicts (reshard)."""
    out_aval = out_avals[0]
    if len(ins) < 6 or not isinstance(ins[0], _AV) or ins[0].aval is None:
        return [_repl(out_aval)]
    xv, gate_w = ins[0], ins[1]
    experts = [v for v in ins[2:6] if isinstance(v, _AV)
               and v.aval is not None]
    x_spec = tuple(xv.spec)
    token_axes = {ax for e in x_spec for ax in e}

    # the expert-dim sharding all four stacked weights must agree on
    ep_ent: tuple = ()
    for w in experts:
        ent = w.spec[0] if w.spec else ()
        if ent and not ep_ent:
            ep_ent = ent
        elif ent and ent != ep_ent:
            ctx.diag(
                "reshard",
                f"moe expert weights disagree on the expert-dim sharding "
                f"({_spec_str((ep_ent,))} vs {_spec_str((ent,))}) — the "
                "divergent weight is implicitly all-gathered", var=var,
                axis=",".join(ent))
            ctx.collective("all_gather", ent,
                           ctx.payload(w.aval, w.spec, exclude=ent),
                           var=var, aval=w.aval)
    if ep_ent and any(ax in token_axes for ax in ep_ent):
        drop = tuple(ax for ax in ep_ent if ax in token_axes)
        ctx.diag(
            "reshard",
            f"moe expert axis {','.join(drop)} also shards the tokens — "
            "the all-to-all dispatch cannot route across it; the expert "
            "stacks are implicitly all-gathered", var=var,
            axis=",".join(drop))
        for w in experts:
            if w.spec and w.spec[0]:
                ctx.collective("all_gather", drop,
                               ctx.payload(w.aval, w.spec, exclude=drop),
                               var=var, aval=w.aval)
        ep_ent = ()
    if isinstance(gate_w, _AV) and gate_w.aval is not None \
            and any(gate_w.spec):
        gent = tuple(ax for e in gate_w.spec for ax in e)
        ctx.diag(
            "reshard",
            "moe gate weight is sharded — the router runs replicated, so "
            "the gate is implicitly all-gathered", var=var,
            axis=",".join(gent))
        ctx.collective("all_gather", gent,
                       ctx.payload(gate_w.aval, gate_w.spec, exclude=gent),
                       var=var, aval=gate_w.aval)

    if ep_ent:
        # dispatch + combine: each device exchanges its slice of the
        # [E, capacity, d] routed-token tensor with every peer on the
        # expert axis — per-device wire bytes = tensor * (ep-1)/ep
        e_total = int(_lit(kw.get("e_total", 0), 0)) \
            or int(experts[0].aval.shape[0])
        cap = _moe_capacity(xv.aval, kw, e_total)
        d_model = int(xv.aval.shape[-1])
        payload = _Aval((e_total, cap, d_model), xv.aval.dtype)
        ep = ctx.div(ep_ent)
        wire = (_nbytes(payload) * max(ep - 1, 0)) // max(ep, 1)
        for _ in ("dispatch", "combine"):
            ctx.collective("all_to_all", ep_ent, wire, var=var,
                           aval=payload)
    out_spec = (x_spec + ((),) * len(out_aval.shape))[:len(out_aval.shape)]
    return [out_spec]


def _default_rule(ctx, ins, kw, out_avals, var):
    """Shape-matching pass-through: each output adopts the spec of the
    first input with the same shape (covers unary/activation/cast/dropout
    ops without bespoke rules); otherwise replicated, and the op is noted
    when that silently drops a sharding."""
    tens = _tensors(ins) + [v for v in kw.values() if isinstance(v, _AV)
                            and v.aval is not None]
    outs = []
    for oa in out_avals:
        pick = None
        for v in tens:
            if tuple(v.aval.shape) == tuple(oa.shape):
                pick = tuple(v.spec)
                if any(v.spec):
                    break
        if pick is None:
            pick = _repl(oa)
            if any(any(e) for v in tens for e in v.spec):
                ctx.report.unknown_ops.add(ctx.op_name)
        outs.append(pick)
    return outs


# ---------------------------------------------------------------------------
# the per-op forward FLOPs model (the capacity model prices a prefill with it)
# ---------------------------------------------------------------------------

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


def _walk(ops, env_spec, env_aval, ctx: _Ctx, names: Dict[int, str]):
    from .control_flow import _CondFn, _WhileFn

    for i, op in enumerate(ops):
        # inside a sub-block, op_index counts WITHIN the block and the
        # label carries the path ("cond#5/true/matmul"), so a finding
        # points at the actual inner op, not the enclosing cond
        ctx.op_index = i
        ctx.op_name = ctx.label + op.name if ctx.label else op.name
        vals = []
        for x in op.flat:
            if isinstance(x, _Ref):
                aval = env_aval.get(x.var_id)
                spec = env_spec.get(x.var_id,
                                    _repl(aval) if aval is not None else ())
                vals.append(_AV(spec, aval))
            else:
                aval = _aval_of(x)
                vals.append(_AV(_repl(aval), aval) if aval is not None
                            else x)
        out_avals = [v.aval for v in op.out_vars]
        out_var_names = [v.name for v in op.out_vars]
        var0 = out_var_names[0] if out_var_names else None

        if isinstance(op.fn, (_CondFn, _WhileFn)):
            out_specs = _control_flow(ctx, op, vals, env_aval, names)
        else:
            ins = vals[:op.n_args]
            kw_leaves = vals[op.n_args:]
            try:
                kw = pytree.tree_unflatten(kw_leaves, op.kw_tree)
            except Exception:
                kw = {}
            if not isinstance(kw, dict):
                kw = {}
            rule = SPMD_RULES.get(op.name, _default_rule)
            out_specs = rule(ctx, ins, kw, out_avals, var0)

        for oid, oname, oaval, ospec in zip(op.out_ids, out_var_names,
                                            out_avals, out_specs):
            # rule outputs re-validated: divisibility of the produced
            # sharding against the actual output shape
            ospec = tuple(ospec) + ((),) * (len(oaval.shape) - len(ospec))
            checked = []
            for d, ent in enumerate(ospec[:len(oaval.shape)]):
                ent = _norm_entry(ent)
                if ent and oaval.shape[d] % ctx.div(ent):
                    ctx.diag(
                        "non-divisible",
                        f"dim {d} of '{oname}' (size {oaval.shape[d]}) "
                        f"is not divisible by axis {','.join(ent)} "
                        f"(size {ctx.div(ent)})", var=oname,
                        axis=",".join(ent))
                    ent = ()
                checked.append(ent)
            env_spec[oid] = tuple(checked)
            env_aval[oid] = oaval
            names[oid] = oname


def _control_flow(ctx: _Ctx, op, vals, env_aval, names):
    """cond / while_loop: propagate into the sub-blocks and enforce the
    single-program-SPMD invariant — both cond branches must imply the
    SAME collective sequence (pipeline.py documents this; GSPMD cannot
    partition rank-divergent collective orders)."""
    from .control_flow import _CondFn, _WhileFn
    fn = op.fn
    out_avals = [v.aval for v in op.out_vars]

    def run_block(blk, carried, label):
        es: Dict[int, tuple] = {}
        ea: Dict[int, Any] = {}
        for vid, av in zip(blk.in_ids, carried):
            # a carry initial may be a plain Python literal (int step
            # counters are legal loop vars) — not an _AV
            es[vid] = av.spec if isinstance(av, _AV) \
                and av.aval is not None else ()
            ea[vid] = av.aval if isinstance(av, _AV) else None
        n_free = len(blk.free_ids)
        free = vals[op.n_args - n_free:op.n_args] if n_free else []
        for vid, av in zip(blk.free_ids, free):
            if isinstance(av, _AV):
                es[vid] = av.spec
                ea[vid] = av.aval
        sub = ctx.child(label=label)
        _walk(blk.ops, es, ea, sub, names)
        out_specs = [es.get(oid, ()) for oid in blk.out_ids]
        return sub.collectives, out_specs

    if isinstance(fn, _CondFn):
        t_coll, t_out = run_block(fn.true_block, [],
                                  f"{op.name}#{ctx.op_index}/true/")
        f_coll, f_out = run_block(fn.false_block, [],
                                  f"{op.name}#{ctx.op_index}/false/")
        t_sig = [(c.kind, c.axis) for c in t_coll]
        f_sig = [(c.kind, c.axis) for c in f_coll]
        if t_sig != f_sig:
            ctx.op_name = op.name
            ctx.diag(
                "collective-divergence",
                "cond branches imply different collective sequences "
                f"(true: {t_sig or '[]'}, false: {f_sig or '[]'}) — under "
                "single-program SPMD every rank traces ONE program, so "
                "branch-divergent collectives cannot be partitioned",
                var=op.out_vars[0].name if op.out_vars else None)
        ctx.op_name = op.name
        ctx.collectives.extend(t_coll)
        out_specs = []
        for ts, fs, oa in zip(t_out, f_out, out_avals):
            ts = tuple(ts) + ((),) * (len(oa.shape) - len(ts))
            fs = tuple(fs) + ((),) * (len(oa.shape) - len(fs))
            out_specs.append(tuple(t if t == f else ()
                                   for t, f in zip(ts, fs)))
        return out_specs

    # while_loop: body collectives repeat per iteration (count them once
    # — trip counts are dynamic); the carry spec must be loop-stable
    carried = vals[:fn.n_loop]
    b_coll, b_out = run_block(fn.body_block, carried,
                              f"{op.name}#{ctx.op_index}/body/")
    ctx.op_name = op.name
    ctx.collectives.extend(b_coll)
    out_specs = []
    for av, bs, oa in zip(carried, b_out, out_avals):
        ins = av.spec if isinstance(av, _AV) and av.aval is not None else ()
        ins = tuple(ins) + ((),) * (len(oa.shape) - len(ins))
        bs = tuple(bs) + ((),) * (len(oa.shape) - len(bs))
        out_specs.append(tuple(i if i == b else ()
                               for i, b in zip(ins, bs)))
    return out_specs


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _derive_param_specs(program: Program, axes: Dict[str, int]):
    """Fallback spec source: the sharding-rule name patterns applied to
    each persistable's var name (sharding.named_param_specs supplies
    dotted-name specs when a Layer is available)."""
    if not axes:
        return {}
    from ..distributed import sharding as sharding_mod
    meshlike = sharding_mod.mesh_like(dict(axes))
    out = {}
    for scope_name, pv in program.persistable_vars.items():
        out[scope_name] = sharding_mod.param_spec_for(
            pv.name, len(pv.aval.shape), meshlike)
    return out


def analyze_program(program: Program, mesh=None, param_specs=None,
                    data_specs=None) -> SpmdReport:
    """Propagate PartitionSpecs over a static Program.

    mesh: a Mesh, an {axis: size} dict (device-free — lint a pod
    layout anywhere), or None for the registered default mesh.
    param_specs: {scope_name | var name: PartitionSpec} for persistables
    (default: sharding-rule patterns against var names).
    data_specs: {data var name: PartitionSpec} for feeds (default
    replicated; shard the batch dim along 'dp' for dp analysis).

    Returns an SpmdReport: resolved specs per var, the implied collective
    set, the diagnostic list, and per-device/replicated HBM estimates.
    """
    axes, tiers = _mesh_topology(mesh)
    report = SpmdReport(mesh_axes=dict(axes), mesh_tiers=tiers)
    ctx = _Ctx(axes, report)
    if param_specs is None:
        param_specs = _derive_param_specs(program, axes)
    param_specs = dict(param_specs or {})
    data_specs = dict(data_specs or {})

    env_spec: Dict[int, tuple] = {}
    env_aval: Dict[int, Any] = {}
    names: Dict[int, str] = {}
    for name, v in program.data_vars.items():
        ctx.op_name = None
        ctx.op_index = None
        spec = data_specs.get(name)
        env_spec[v.var_id] = _validate_spec(ctx, spec, v.aval.shape, name) \
            if spec is not None else _repl(v.aval)
        env_aval[v.var_id] = v.aval
        names[v.var_id] = name
    for scope_name, vid in program.persist_ids.items():
        pv = program.persistable_vars.get(scope_name)
        if pv is None:
            continue
        ctx.op_name = None
        ctx.op_index = None
        spec = param_specs.get(scope_name, param_specs.get(pv.name))
        env_spec[vid] = _validate_spec(ctx, spec, pv.aval.shape,
                                       scope_name) \
            if spec is not None else _repl(pv.aval)
        env_aval[vid] = pv.aval
        names[vid] = scope_name

    _walk(program.ops, env_spec, env_aval, ctx, names)

    report.specs = env_spec
    report.var_names = names

    # Pure data-parallel axes: shard a feed but no persistable. Their
    # steady-state traffic is the gradient sync — the one flow that MAY
    # cross a slow tier (hierarchically); everything else that touches a
    # slow-tier link every step is a layout mistake, flagged below.
    data_axes: set = set()
    persist_axes: set = set()
    for v in program.data_vars.values():
        for e in env_spec.get(v.var_id, ()):
            data_axes.update(e)
    for vid in program.persist_ids.values():
        for e in env_spec.get(vid, ()):
            persist_axes.update(e)
    report.dp_axes = tuple(sorted(data_axes - persist_axes))

    if ctx.slow_axes:
        exempt = set(report.dp_axes)
        for c in report.collectives:
            for ax in str(c.axis).split(","):
                if ax in ctx.slow_axes and ax not in exempt:
                    report.diagnostics.append(SpmdDiagnostic(
                        code="cross-tier",
                        message=f"{c.kind} of '{c.var}' rides slow-tier "
                                f"axis '{ax}' "
                                f"({ctx.tiers[ax]['tier']}) every step — "
                                "keep model parallelism intra-pod; only "
                                "the dp gradient sync should cross the "
                                "slow tier, and hierarchically",
                        op_name=c.op_name, op_index=c.op_index,
                        var=c.var, axis=ax))

    divisors = {vid: ctx.spec_div(spec) for vid, spec in env_spec.items()}
    from .shape_infer import analyze_memory
    try:
        report.hbm = analyze_memory(program, env=env_aval,
                                    shard_divisors=divisors)
        report.hbm_replicated = analyze_memory(program, env=env_aval)
    except Exception:
        report.hbm = None  # memory estimate is best-effort decoration
    return report


def analyze_params(params, mesh=None, specs=None, tokens_per_step=None,
                   zero_dp=False) -> SpmdReport:
    """The dygraph/hapi half: validate a param tree's specs and estimate
    the TP collective set from the sharding-rule name patterns, without a
    recorded Program.

    params: {dotted_name: array | aval | Variable} (e.g. from
    `dict(layer.named_parameters())`). specs: {dotted_name:
    PartitionSpec} (default: sharding.param_spec_for per name).
    tokens_per_step: activation row count (batch*seq) for the step —
    prices each row-parallel all-reduce / vocab-parallel gather; bytes
    are 0 when omitted (counts still reported).
    """
    from ..distributed import sharding as sharding_mod

    axes, tiers = _mesh_topology(mesh)
    report = SpmdReport(mesh_axes=dict(axes), mesh_tiers=tiers)
    ctx = _Ctx(axes, report)
    meshlike = sharding_mod.mesh_like(dict(axes))
    param_bytes = 0
    for name, p in params.items():
        aval = _aval_of(p) or _aval_of(getattr(p, "aval", None))
        if aval is None:
            continue
        spec = (specs or {}).get(name)
        if spec is None:
            spec = sharding_mod.param_spec_for(name, len(aval.shape),
                                               meshlike, zero_dp=zero_dp)
        ctx.op_name = None
        norm = _validate_spec(ctx, spec, aval.shape, name)
        report.specs[id(p)] = norm
        report.var_names[id(p)] = name
        param_bytes += _nbytes(aval) // max(ctx.spec_div(norm), 1)
        itemsize = _wire_dtype(aval.dtype).itemsize
        rows = int(tokens_per_step or 0)
        if len(aval.shape) >= 2 and norm[0]:
            if sharding_mod._match(name, sharding_mod.VOCAB_PARALLEL):
                ctx.collective("all_reduce", norm[0],
                               rows * aval.shape[1] * itemsize, var=name,
                               aval=aval)
            elif sharding_mod._match(name, sharding_mod.ROW_PARALLEL):
                ctx.collective("all_reduce", norm[0],
                               rows * aval.shape[1] * itemsize, var=name,
                               aval=aval)
    report.hbm = {"peak_bytes": param_bytes, "param_bytes": param_bytes,
                  "feed_bytes": 0, "activation_peak_bytes": 0,
                  "timeline": [], "peak_op": None}
    return report


# ---------------------------------------------------------------------------
# the PADDLE_TPU_VERIFY_SPMD hook (mirrors passes.py VERIFY_PASSES)
# ---------------------------------------------------------------------------

_verify_override = None


def verify_spmd_enabled() -> bool:
    if _verify_override is not None:
        return _verify_override
    return os.environ.get("PADDLE_TPU_VERIFY_SPMD", "0").strip().lower() \
        not in ("0", "false", "off", "")


def set_verify_spmd(enabled):
    """Force the hook on/off from code (None restores the env-var
    default); returns the previous override."""
    global _verify_override
    old = _verify_override
    _verify_override = None if enabled is None else bool(enabled)
    return old


def maybe_verify_spmd(program: Program, mesh=None) -> Optional[SpmdReport]:
    """Run the analyzer when PADDLE_TPU_VERIFY_SPMD is on; raise
    SpmdLintError on any finding, before the program is prepared, where
    the same mistake would surface as a shape error deep in a replay or a
    silent replication. Publishes the spmd.* monitor gauges either way."""
    if not verify_spmd_enabled():
        return None
    param_specs = getattr(program, "spmd_param_specs", None)
    if mesh is None:
        from ..distributed import mesh as mesh_mod
        mesh = mesh_mod.get_mesh()
    if mesh is None and not param_specs:
        return None  # nothing declares sharding; nothing to lint
    report = analyze_program(
        program, mesh=mesh, param_specs=param_specs,
        data_specs=getattr(program, "spmd_data_specs", None))
    report.publish()
    if report.diagnostics:
        report.raise_on_findings()
    return report
