"""Auto-sharding plan CLI, the command line of static/spmd_planner.py
(tools/spmd_plan.py for the port).

Plans the GPT workload (the program ``spmd_lint`` prices) for a given
`{axis: size}` mesh, with no process group, and prints the searched plan
as a rule list next to a predicted-cost table: planned layout against
the hand-written `sharding.py` preset and full replication. Exit 1 when
the plan carries diagnostics or loses to the preset on either predicted
metric.

  python -m paddle_tpu_torch.tools.spmd_plan             # tiny GPT, tp 2
  python -m paddle_tpu_torch.tools.spmd_plan --tp 4 --dp 2 --layers 12 \
      --hidden 768
  python -m paddle_tpu_torch.tools.spmd_plan --json      # stable output
  python -m paddle_tpu_torch.tools.spmd_plan --pipeline --pp 4
  python -m paddle_tpu_torch.tools.spmd_plan --topology --pods 2 --dp 2

`--topology` plans the same GPT on a nested two-tier mesh (a `pod` axis
on the slow between-node tier over the within-node axes) and renders the
per-tier wire bytes of the dp sync: flat all-reduce against the
hierarchical decomposition and LocalSGD. Exit 1 if the plan leaves tp /
sp crossing the slow tier or the hierarchical scheme cuts the
between-node bytes less than 2x. The tiers' bandwidths are the H100's
(``FLAGS_topology_{ici,dcn}_gbps``: NVLink 4 and InfiniBand).

`self_check()` pins the golden rediscovery: on a tp-only mesh the
search reproduces the Megatron layout (qkv / fc1 column-parallel,
out-proj / fc2 row-parallel, wte vocab-parallel) with zero diagnostics
at preset-or-better predicted cost, a dp x tp mesh shards the
`input_ids` feed on dp, a {pp: 4} pipeline plan is clean, and the
two-tier `{pod: 2, dp: 2, tp: 2}` mesh keeps tp within a pod with the
hierarchical dp sync recommended.
"""
from __future__ import annotations

import argparse
import json
import sys


def build_plan(tp=2, dp=1, sp=1, layers=2, hidden=64, heads=2, vocab=1024,
               batch=2, seq=16, beam=None, coll_weight=None,
               hbm_weight=None, zero_dp=False):
    """Plan the GPT workload. Returns (plan, preset_report,
    replicated_report, program, net, logits)."""
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.static import spmd_analyzer as spmd
    from paddle_tpu_torch.static import spmd_planner
    from paddle_tpu_torch.tools.spmd_lint import build_gpt_program

    mesh = {}
    if dp > 1:
        mesh["dp"] = dp
    if tp > 1:
        mesh["tp"] = tp
    if sp > 1:
        mesh["sp"] = sp
    program, net, logits = build_gpt_program(
        layers=layers, hidden=hidden, heads=heads, vocab=vocab,
        batch=batch, seq=seq, name="spmd_plan_gpt")
    plan = spmd_planner.plan_program(
        program, mesh, layer=net, beam=beam, coll_weight=coll_weight,
        hbm_weight=hbm_weight, zero_dp=zero_dp)
    preset_specs = sharding.named_param_specs(net, mesh)
    preset_data = {"input_ids": P("dp")} if dp > 1 else None
    preset = spmd.analyze_program(program, mesh=mesh,
                                  param_specs=preset_specs,
                                  data_specs=preset_data)
    replicated = spmd.analyze_program(program, mesh=mesh, param_specs={})
    return plan, preset, replicated, program, net, logits


def _metrics(report):
    return {"collective_bytes": report.collective_bytes(),
            "hbm_peak": report.hbm["peak_bytes"] if report.hbm else 0,
            "diagnostics": len(report.diagnostics)}


def build_topology_plan(pods=2, dp=2, tp=2, sp=1, layers=2, hidden=64,
                        heads=2, vocab=1024, batch=8, seq=16, beam=None,
                        coll_weight=None, hbm_weight=None):
    """Plan the GPT workload on a nested two-tier mesh: a `pod` axis on
    the slow DCN tier over the usual ICI axes. Returns (plan, program,
    net); the plan carries `mesh_tiers`/`grad_sync` (the priced
    flat/hierarchical/localsgd dp sync schemes)."""
    from paddle_tpu_torch.static import spmd_planner
    from paddle_tpu_torch.tools.spmd_lint import build_gpt_program

    mesh = {"pod": {"size": pods, "tier": "dcn"}}
    if dp > 1:
        mesh["dp"] = dp
    if tp > 1:
        mesh["tp"] = tp
    if sp > 1:
        mesh["sp"] = sp
    program, net, _logits = build_gpt_program(
        layers=layers, hidden=hidden, heads=heads, vocab=vocab,
        batch=batch, seq=seq, name="spmd_plan_topo_gpt")
    plan = spmd_planner.plan_program(
        program, mesh, layer=net, beam=beam, coll_weight=coll_weight,
        hbm_weight=hbm_weight)
    return plan, program, net


def topology_json(plan) -> dict:
    """Stable JSON for CI: the plan (with its `topology` block) + the
    acceptance verdict — zero diagnostics (so no tp/sp collective
    crosses the slow tier), a dp sync priced hierarchically, and the
    hierarchical scheme cutting inter-pod wire bytes >= 2x vs flat."""
    out = plan.to_json()
    rep = plan.report
    out["cross_tier"] = sum(1 for d in (rep.diagnostics if rep else [])
                            if d.code == "cross-tier")
    gs = plan.grad_sync or {}
    hier_2x = False
    if gs:
        flat_dcn = gs["schemes"]["flat"]["wire_bytes"]["dcn"]
        hier_dcn = gs["schemes"]["hierarchical"]["wire_bytes"]["dcn"]
        hier_2x = hier_dcn * 2 <= flat_dcn
    out["ok"] = bool(
        out["predicted"]["diagnostics"] == 0
        and out["cross_tier"] == 0
        and gs and hier_2x
        and gs.get("recommendation") in ("hierarchical", "localsgd"))
    return out


def render_topology(plan) -> str:
    lines = [plan.render()]
    tb = plan.predicted.get("tier_bytes") or {}
    if tb:
        lines.append("step collectives per tier: " + ", ".join(
            f"{t}={b} B" for t, b in sorted(tb.items())))
    gs = plan.grad_sync
    if not gs:
        lines.append("dp gradient sync: n/a (no pure-dp axis)")
        return "\n".join(lines)
    lines.append("per-tier wire bytes (dp gradient sync, per device):")
    lines.append(f"  {'scheme':<14}{'ici B':>14}{'dcn B':>14}"
                 f"{'cost us':>12}")
    for name in ("flat", "hierarchical", "localsgd"):
        s = gs["schemes"][name]
        lines.append(f"  {name:<14}{s['wire_bytes']['ici']:>14}"
                     f"{s['wire_bytes']['dcn']:>14}"
                     f"{s['total_cost_us']:>12.1f}")
    lines.append(
        f"recommendation: {gs['recommendation']} (hierarchical cuts "
        f"inter-pod bytes {gs['inter_pod_reduction_x']:.1f}x, localsgd "
        f"amortizes 1/{gs['localsgd_k']})")
    return "\n".join(lines)


def build_moe_program(layers=4, hidden=64, experts=4, d_hidden=None,
                      batch=4, seq=16, name="spmd_plan_moe"):
    """A dense+MoE stack (the expert-parallel workload): `layers` blocks
    of Linear -> tanh -> MoELayer. Returns (program, names) with
    dotted display names for the rule templates."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, ops, static
    from paddle_tpu_torch.device import device_scope
    from paddle_tpu_torch.distributed.moe import MoELayer

    was_static = static.in_static_mode()
    paddle.enable_static()
    try:
        main = static.Program(name)
        names = {}
        with static.program_guard(main, static.Program()), \
                device_scope("cpu"):
            x = static.data("x", [batch, seq, hidden], "float32")
            h = x
            for i in range(layers):
                lin = nn.Linear(hidden, hidden)
                moe = MoELayer(hidden, d_hidden or 2 * hidden, experts,
                               axis="ep")
                h = ops.tanh(lin(h))
                h = moe(h)
                for suffix, p in (("fc.weight", lin.weight),
                                  ("fc.bias", lin.bias),
                                  ("moe.gate.weight", moe.gate.weight),
                                  ("moe.w_up", moe.w_up),
                                  ("moe.b_up", moe.b_up),
                                  ("moe.w_down", moe.w_down),
                                  ("moe.b_down", moe.b_down)):
                    names[p.scope_name] = f"blocks.{i}.{suffix}"
        main._jit_fetch_vars = [h]
        return main, names
    finally:
        if not was_static:
            paddle.disable_static()


def build_pipeline_plan(pp=4, dp=1, tp=1, ep=1, micro=8, virtual=1,
                        layers=None, hidden=64, heads=2, vocab=1024,
                        batch=8, seq=16, experts=4):
    """Plan a pipeline partition of the golden workload: the GPT
    program (spmd_lint's) for dense meshes, the MoE stack when an `ep`
    axis is requested. Returns the PipelinePlan (its `.inner` carries
    the non-pp SPMD plan, expert placement included)."""
    from paddle_tpu_torch.static import spmd_planner
    from paddle_tpu_torch.tools.spmd_lint import build_gpt_program

    mesh = {}
    if pp > 1:
        mesh["pp"] = pp
    if dp > 1:
        mesh["dp"] = dp
    if tp > 1:
        mesh["tp"] = tp
    if ep > 1:
        mesh["ep"] = ep
    if ep > 1:
        program, names = build_moe_program(
            layers=layers or 4, hidden=hidden, experts=experts,
            batch=batch, seq=seq)
        return spmd_planner.plan_pipeline(
            program, mesh, num_micro=micro, num_virtual=virtual,
            names=names)
    program, net, _logits = build_gpt_program(
        layers=layers or 4, hidden=hidden, heads=heads, vocab=vocab,
        batch=batch, seq=seq, name="spmd_plan_pp_gpt")
    return spmd_planner.plan_pipeline(
        program, mesh, num_micro=micro, num_virtual=virtual, layer=net)


def pipeline_json(plan) -> dict:
    """Stable JSON for CI: the stage table + wire/bubble/objective and
    the acceptance verdict — zero diagnostics AND the planner's cut
    matches-or-beats the hand (equal-segments) cut on the weighted
    objective."""
    out = plan.to_json()
    hand_obj = plan.hand.get("objective")
    out["ok"] = bool(
        not plan.diagnostics
        and all(s.diagnostics == 0 for s in plan.stages)
        and (hand_obj is None or plan.objective <= hand_obj + 1e-9))
    return out


def plan_json(plan, preset, replicated) -> dict:
    """Stable JSON for CI: the plan's rule list + the three-way cost
    table + the acceptance verdict."""
    out = plan.to_json()
    out["preset"] = _metrics(preset)
    out["replicated"] = _metrics(replicated)
    p = out["predicted"]
    out["ok"] = bool(
        p["diagnostics"] == 0
        and p["collective_bytes"] <= out["preset"]["collective_bytes"]
        and p["hbm_peak"] <= out["preset"]["hbm_peak"])
    return out


def render_table(plan, preset, replicated) -> str:
    rows = [("planned", plan.predicted),
            ("preset", _metrics(preset)),
            ("replicated", _metrics(replicated))]
    lines = ["predicted cost (collective B/step, peak HBM B/device, "
             "diagnostics):"]
    lines.append(f"  {'layout':<12}{'collective':>14}{'peak HBM':>14}"
                 f"{'diags':>8}")
    for name, m in rows:
        lines.append(f"  {name:<12}{m['collective_bytes']:>14}"
                     f"{m['hbm_peak']:>14}{m['diagnostics']:>8}")
    return "\n".join(lines)


def self_check():
    """Violation strings of the golden plans (see the module's
    docstring)."""
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    try:
        plan, preset, replicated, _prog, _net, logits = build_plan(tp=2)
    except Exception as e:  # noqa: BLE001 - reported as a violation
        return [f"spmd_plan self-check failed to build/plan: {e!r}"]
    problems = []
    pm, bm = plan.predicted, _metrics(preset)
    if pm["diagnostics"]:
        problems.append("spmd_plan golden TP config: plan carries "
                        f"{pm['diagnostics']} diagnostic(s)")
    if pm["collective_bytes"] > bm["collective_bytes"]:
        problems.append(
            "spmd_plan golden TP config: planned collective bytes "
            f"{pm['collective_bytes']} exceed the hand-written preset's "
            f"{bm['collective_bytes']}")
    if pm["hbm_peak"] > bm["hbm_peak"]:
        problems.append(
            "spmd_plan golden TP config: planned peak HBM "
            f"{pm['hbm_peak']} exceeds the hand-written preset's "
            f"{bm['hbm_peak']}")
    megatron = {
        "blocks.0.attn.qkv_proj.weight": P(None, "tp"),
        "blocks.1.attn.out_proj.weight": P("tp", None),
        "blocks.0.fc1.weight": P(None, "tp"),
        "blocks.1.fc2.weight": P("tp", None),
        "wte.weight": P("tp", None),
    }
    for name, want in megatron.items():
        got = plan.spec_for(name, 2)
        if got != want:
            problems.append(
                f"spmd_plan golden TP config: {name} planned as {got}, "
                f"the Megatron layout is {want}")
    ar = [c for c in plan.report.collectives if c.kind == "all_reduce"]
    if len(ar) != 5 or any(c.axis != "tp" for c in ar):
        problems.append(
            "spmd_plan golden TP config: expected 2L+1=5 tp all-reduces, "
            f"planner's layout implies {len(ar)}")
    try:
        plan2, _, _, _, _, _ = build_plan(tp=2, dp=2)
    except Exception as e:  # noqa: BLE001
        return problems + [f"spmd_plan dp x tp self-check crashed: {e!r}"]
    ids_spec = tuple(plan2.data_specs.get("input_ids", P()))
    if not ids_spec or ids_spec[0] != "dp":
        problems.append(
            "spmd_plan dp x tp config: input_ids not sharded on dp "
            f"(got {ids_spec})")
    # the pipeline golden: {pp: 4} on the GPT workload must produce a
    # clean 4-stage partition that matches-or-beats the hand
    # (equal-segments) cut on the weighted objective
    try:
        pplan = build_pipeline_plan(pp=4)
    except Exception as e:  # noqa: BLE001
        return problems + [f"spmd_plan --pipeline self-check crashed: "
                           f"{e!r}"]
    payload = pipeline_json(pplan)
    if not payload["ok"]:
        problems.append(
            "spmd_plan pipeline golden {pp:4}: plan not ok — "
            f"diagnostics {pplan.diagnostics}, objective "
            f"{pplan.objective} vs hand {pplan.hand.get('objective')}")
    if len(pplan.stages) != 4:
        problems.append(
            f"spmd_plan pipeline golden {{pp:4}}: {len(pplan.stages)} "
            "stages planned, expected 4")
    # the topology golden: {pod:2(dcn), dp:2, tp:2} must keep tp
    # intra-pod from cost alone (zero cross-tier diagnostics), shard the
    # batch over (pod, dp), and price the hierarchical dp sync at >= 2x
    # less inter-pod wire than the flat all-reduce
    try:
        tplan, _tprog, _tnet = build_topology_plan(pods=2, dp=2, tp=2,
                                                   batch=8)
    except Exception as e:  # noqa: BLE001
        return problems + [f"spmd_plan --topology self-check crashed: "
                           f"{e!r}"]
    tpayload = topology_json(tplan)
    if not tpayload["ok"]:
        problems.append(
            "spmd_plan topology golden {pod:2,dp:2,tp:2}: plan not ok — "
            f"diagnostics {tpayload['predicted']['diagnostics']}, "
            f"cross-tier {tpayload['cross_tier']}, grad_sync "
            f"{tplan.grad_sync and tplan.grad_sync.get('recommendation')}")
    gs = tplan.grad_sync or {}
    if gs.get("recommendation") != "hierarchical":
        problems.append(
            "spmd_plan topology golden: expected the hierarchical dp "
            f"sync recommendation, got {gs.get('recommendation')!r}")
    if float(gs.get("inter_pod_reduction_x", 0)) < 2.0:
        problems.append(
            "spmd_plan topology golden: hierarchical sync cuts inter-pod "
            f"bytes only {gs.get('inter_pod_reduction_x')}x, need >= 2x")
    tids = tuple(tplan.data_specs.get("input_ids", P()))
    if not tids or tids[0] != ("pod", "dp"):
        problems.append(
            "spmd_plan topology golden: input_ids batch dim not sharded "
            f"over (pod, dp) (got {tids})")
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="auto-sharding planner (search PartitionSpec plans "
                    "against the SPMD analyzer's cost model) for the GPT "
                    "workload")
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--sp", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="transformer layers (default: 2, or 4 in "
                         "--pipeline mode)")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--beam", type=int, default=None,
                    help="beam width (default FLAGS_spmd_plan_beam)")
    ap.add_argument("--coll-weight", type=float, default=None,
                    help="objective weight on collective bytes/step")
    ap.add_argument("--hbm-weight", type=float, default=None,
                    help="objective weight on peak per-device HBM")
    ap.add_argument("--zero-dp", action="store_true",
                    help="offer ZeRO-style dim-0 dp sharding candidates")
    ap.add_argument("--json", action="store_true",
                    help="stable JSON on stdout (CI consumption)")
    ap.add_argument("--pipeline", action="store_true",
                    help="plan pipeline stage cuts (and MoE expert "
                         "placement with --ep) instead of a single-SPMD "
                         "layout; --pp sets the stage count")
    ap.add_argument("--topology", action="store_true",
                    help="plan on a nested two-tier mesh (--pods on the "
                         "slow DCN tier over the ICI axes) and render "
                         "the per-tier wire-bytes table: flat vs "
                         "hierarchical vs localsgd dp sync")
    ap.add_argument("--pods", type=int, default=2,
                    help="slow-tier (DCN) pod count (--topology mode)")
    ap.add_argument("--pp", type=int, default=4,
                    help="pipeline stages (--pipeline mode)")
    ap.add_argument("--ep", type=int, default=1,
                    help="expert-parallel degree: >1 plans the MoE "
                         "workload with experts sharded over 'ep'")
    ap.add_argument("--micro", type=int, default=8,
                    help="microbatches priced per step")
    ap.add_argument("--virtual", type=int, default=1,
                    help="virtual chunks per rank (interleaved 1F1B)")
    args = ap.parse_args(argv)

    if args.pipeline:
        plan = build_pipeline_plan(
            pp=args.pp, dp=args.dp, tp=args.tp, ep=args.ep,
            micro=args.micro, virtual=args.virtual, layers=args.layers,
            hidden=args.hidden, heads=args.heads, vocab=args.vocab,
            batch=max(args.batch, args.micro), seq=args.seq)
        payload = pipeline_json(plan)
        if args.json:
            print(json.dumps(payload, sort_keys=True, indent=1))
        else:
            print(plan.stage_table())
            print(f"search: {plan.evaluations} stage evaluations, "
                  f"{plan.inner.evaluations if plan.inner else 0} "
                  "layout evaluations")
        return 0 if payload["ok"] else 1

    if args.topology:
        dp = args.dp if args.dp > 1 else 2
        batch = args.batch if args.batch % (args.pods * dp) == 0 \
            else 2 * args.pods * dp
        plan, _prog, _net = build_topology_plan(
            pods=args.pods, dp=dp, tp=args.tp, sp=args.sp,
            layers=2 if args.layers is None else args.layers,
            hidden=args.hidden, heads=args.heads, vocab=args.vocab,
            batch=batch, seq=args.seq, beam=args.beam,
            coll_weight=args.coll_weight, hbm_weight=args.hbm_weight)
        payload = topology_json(plan)
        if args.json:
            print(json.dumps(payload, sort_keys=True, indent=1))
        else:
            print(render_topology(plan))
            print(f"search: {plan.evaluations} analyzer evaluations")
        return 0 if payload["ok"] else 1

    plan, preset, replicated, _prog, _net, _logits = build_plan(
        tp=args.tp, dp=args.dp, sp=args.sp,
        layers=2 if args.layers is None else args.layers,
        hidden=args.hidden, heads=args.heads, vocab=args.vocab,
        batch=args.batch, seq=args.seq, beam=args.beam,
        coll_weight=args.coll_weight, hbm_weight=args.hbm_weight,
        zero_dp=args.zero_dp)
    payload = plan_json(plan, preset, replicated)
    if args.json:
        print(json.dumps(payload, sort_keys=True, indent=1))
    else:
        print(plan.render())
        print(render_table(plan, preset, replicated))
        print(f"search: {plan.evaluations} analyzer evaluations")
    return 0 if payload["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
