"""Port parity: the auto-sharding planner and the pipeline stage-cut
planner (paddle_tpu_torch/static/spmd_planner.py) against the JAX
package's, the ``auto_shard`` / ``recompute`` tags through the static
Executor, and ``StagedPipelineRunner`` over gloo ranks.

The same Program recorded in both packages plans to the same rules, data
specs, cut points and stage tables; the objective agrees within 1e-9
relative (the counterparts of ``tests/test_spmd_planner.py`` and
``tests/test_pipeline_planner.py``). The staged runner trains a planned
pp 2 partition (and pp 2 with v 2) of a tanh MLP on 2 gloo ranks over 3
SGD steps: its losses and unit weights equal JAX's runner on its 8-device
CPU mesh within rtol 1e-5 (atol 1e-6 on the weights). Known difference:
the two-tier mesh's link bandwidths are the H100's in the port, so a
tiered plan's ``cost_us`` / ``grad_sync`` costs differ while its rules,
data specs and wire bytes agree.
"""
import json
import re

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.static import spmd_planner as JPL
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import sharding as tsharding
from paddle_tpu_torch.distributed.mesh import PartitionSpec as TP
from paddle_tpu_torch.static import spmd_planner as TPL
from paddle_tpu_torch.testing import spmd, spmd_static

from test_torch_spmd_analyzer import _both
from test_torch_static_cases import JAX, PORT, static_mode

TIERED = {"pod": {"size": 2, "tier": "dcn"}, "dp": 2, "tp": 2}


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _mod(P):
    return JPL if P is JAX else TPL


def _gpt4(layers=2, vocab=1024, batch=2, hidden=64):
    def body(P, static):
        from importlib import import_module
        g = import_module(("paddle_tpu" if P is JAX else "paddle_tpu_torch")
                          + ".text.models.gpt")
        ids = static.data("input_ids", [batch, 16], "int64")
        net = g.GPT(g.GPTConfig(vocab_size=vocab, hidden_size=hidden,
                                num_layers=layers, num_heads=2,
                                intermediate_size=4 * hidden,
                                max_seq_len=16))
        return net, net(ids), None
    return body


def _mlp(widths, batch=16):
    def body(P, static):
        x = static.data("x", [batch, 32], "float32")
        h = x
        for w in widths:
            if w == 1:
                h = P.ops.tanh(P.nn.Linear(32, 32, bias_attr=False)(h))
            else:
                a = P.nn.Linear(32, 32 * w, bias_attr=False)
                b = P.nn.Linear(32 * w, 32, bias_attr=False)
                h = P.ops.tanh(b(a(h)))
        return None, h, None
    return body


def _plans(progs, mesh, layer=True, **kw):
    return {P.name: _mod(P).plan_program(
        progs[P.name][0], mesh, layer=progs[P.name][1] if layer else None,
        **kw) for P in (JAX, PORT)}


def _same_plan(plans):
    j, t = plans["jax"].to_json(), plans["port"].to_json()
    jo, to = j.pop("objective"), t.pop("objective")
    assert to == pytest.approx(jo, rel=1e-9)
    j.pop("topology", None)
    t.pop("topology", None)
    assert t == j
    return plans["port"]


# ---------------------------------------------------------------------------
# golden plans
# ---------------------------------------------------------------------------

def test_tp_only_rediscovers_megatron_layout_as_jax():
    progs = _both("plan", _gpt4())
    plan = _same_plan(_plans(progs, {"tp": 2}))
    for name, want in {"blocks.0.attn.qkv_proj.weight": TP(None, "tp"),
                       "blocks.1.attn.out_proj.weight": TP("tp", None),
                       "blocks.0.fc1.weight": TP(None, "tp"),
                       "blocks.1.fc2.weight": TP("tp", None),
                       "wte.weight": TP("tp", None)}.items():
        assert plan.spec_for(name, 2) == want, name
    assert plan.predicted["diagnostics"] == 0


def test_dp_tp_mesh_shards_input_ids_on_dp_as_jax():
    progs = _both("plan_dp", _gpt4(batch=4))
    plan = _same_plan(_plans(progs, {"dp": 2, "tp": 2}))
    assert tuple(plan.data_specs["input_ids"])[0] == "dp"


def test_non_divisible_vocab_falls_back_as_jax():
    progs = _both("plan_nd", _gpt4(vocab=1023))
    plan = _same_plan(_plans(progs, {"tp": 2}))
    assert plan.spec_for("wte.weight", 2) == TP()
    assert plan.report.diagnostics == []


def test_no_mesh_trivial_plan_as_jax():
    progs = _both("plan_0", _gpt4())
    plan = _same_plan(_plans(progs, {}))
    assert plan.rules == [] and plan.data_specs == {}


def test_plan_monitor_gauges():
    progs = _both("plan_g", _gpt4())
    before = tmonitor.stat_get("spmd.plans_resolved")
    plan = TPL.plan_program(progs["port"][0], {"tp": 2},
                            layer=progs["port"][1])
    assert tmonitor.stat_get("spmd.plans_resolved") == before + 1
    assert tmonitor.stat_get("spmd.plan_evaluations") == plan.evaluations


def test_name_template_equals_jax():
    for name in ("blocks.11.fc2.weight", "wte.weight", "a.0.b1.c"):
        assert TPL.name_template(name) == JPL.name_template(name)
    t = TPL.name_template("blocks.11.fc2.weight")
    assert re.search(t, "blocks.3.fc2.weight")
    assert not re.search(t, "blocks.3.fc1.weight")


def test_rules_install_via_add_tp_rule():
    progs = _both("plan_r", _gpt4())
    plan = TPL.plan_program(progs["port"][0], {"tp": 2},
                            layer=progs["port"][1])
    patterns = plan.install_rules()
    try:
        meshlike = tsharding.mesh_like({"tp": 2})
        assert tsharding.param_spec_for("blocks.7.attn.qkv_proj.weight",
                                        2, meshlike) == TP(None, "tp")
        assert tsharding.param_spec_for("blocks.7.attn.qkv_proj.weight",
                                        3, meshlike) == TP()
    finally:
        for pat in patterns:
            tsharding.remove_tp_rule(pat)


def test_plan_specs_feed_analyze_program():
    from paddle_tpu_torch.static.spmd_analyzer import analyze_program
    progs = _both("plan_f", _gpt4())
    plan = TPL.plan_program(progs["port"][0], {"tp": 2},
                            layer=progs["port"][1])
    rep = analyze_program(progs["port"][0], mesh={"tp": 2},
                          param_specs=plan.param_specs,
                          data_specs=plan.data_specs)
    assert rep.collective_bytes() == plan.predicted["collective_bytes"]
    assert rep.hbm["peak_bytes"] == plan.predicted["hbm_peak"]


def test_auto_shard_strategy_resolves_at_compile():
    from paddle_tpu_torch import optimizer as opt_mod
    from paddle_tpu_torch.distributed import fleet
    m = tmesh.Mesh({"tp": 2})
    tmesh.set_mesh(m, "_planner_strategy_test")
    try:
        with static_mode(PORT) as static:
            main = static.Program("auto_shard")
            with static.program_guard(main, static.Program()):
                x = static.data("x", [4, 8], "float32")
                net = PORT.nn.Linear(8, 4)
                loss = PORT.ops.mean(net(x))
                strategy = fleet.DistributedStrategy()
                strategy.auto_shard = True
                opt = fleet.distributed_optimizer(
                    opt_mod.SGD(learning_rate=0.1,
                                parameters=net.parameters()), strategy)
                opt.minimize(loss)
            assert main._auto_shard == {}
            (out,) = static.Executor().run(
                main, feed={"x": np.ones((4, 8), "float32")},
                fetch_list=[loss])
        assert np.isfinite(out)
        assert set(main.spmd_param_specs) == set(main.persistable_vars)
        assert isinstance(main._auto_shard["plan"], TPL.ShardingPlan)
    finally:
        tmesh.reset_mesh("_planner_strategy_test")


def test_as_strategy_carries_plan():
    progs = _both("plan_s", _gpt4())
    main = progs["port"][0]
    plan = TPL.plan_program(main, {"tp": 2}, layer=progs["port"][1])
    strategy = plan.as_strategy()
    assert strategy.auto_shard is True
    assert strategy.auto_shard_configs["plan"] is plan
    main._auto_shard = dict(strategy.auto_shard_configs)
    assert TPL.resolve_auto_shard(main) is plan
    assert main.spmd_param_specs == plan.param_specs


def test_template_collision_keeps_exact_rules_as_jax():
    def body(P, static):
        x = static.data("x", [4, 64], "float32")
        a = P.nn.Linear(64, 30, bias_attr=False)
        b = P.nn.Linear(64, 64, bias_attr=False)
        y = P.ops.matmul(a(x), P.ops.transpose(b.weight, [0, 1])[:30, :])
        return (a, b), y, None
    progs = _both("collide", body)
    plans = {}
    for P in (JAX, PORT):
        a, b = progs[P.name][1]
        names = {a.weight.scope_name: "blocks.0.fc.weight",
                 b.weight.scope_name: "blocks.1.fc.weight"}
        plans[P.name] = _mod(P).plan_program(progs[P.name][0], {"tp": 4},
                                             names=names)
    plan = _same_plan(plans)
    assert r"^blocks\.\d+\.fc\.weight$" not in [r.template
                                                for r in plan.rules]


def test_topology_plan_keeps_tp_in_a_pod_as_jax():
    progs = _both("topo", _gpt4(batch=8, hidden=32))
    plans = _plans(progs, TIERED)
    plan = _same_plan(plans)
    assert tuple(plan.data_specs["input_ids"])[0] == ("pod", "dp")
    gs, jgs = plan.grad_sync, plans["jax"].grad_sync
    for name in ("flat", "hierarchical", "localsgd"):
        assert gs["schemes"][name]["wire_bytes"] == \
            jgs["schemes"][name]["wire_bytes"]
    assert gs["recommendation"] == jgs["recommendation"] == "hierarchical"
    strat = plan.as_strategy()
    assert strat.hierarchical_allreduce_configs == {
        "inner_axes": ["dp"], "outer_axes": ["pod"]}


# ---------------------------------------------------------------------------
# the CLI (tools/spmd_plan for the port)
# ---------------------------------------------------------------------------

def _jtool():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import spmd_plan
    return spmd_plan


def test_cli_tp2_json_gives_the_jax_tools_plan(capsys):
    from paddle_tpu_torch.tools import spmd_plan
    assert spmd_plan.main(["--tp", "2", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _jtool().main(["--tp", "2", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got.pop("objective") == pytest.approx(want.pop("objective"),
                                                 rel=1e-9)
    assert got == want and got["ok"] is True


def test_cli_human_output(capsys):
    from paddle_tpu_torch.tools import spmd_plan
    assert spmd_plan.main([]) == 0
    out = capsys.readouterr().out
    assert "rules:" in out and "preset" in out and "replicated" in out


def test_cli_self_check_is_green():
    from paddle_tpu_torch.tools import spmd_plan
    assert spmd_plan.self_check() == []


def test_cli_pipeline_json_as_jax(capsys):
    from paddle_tpu_torch.tools import spmd_plan
    assert spmd_plan.main(["--pipeline", "--pp", "4", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _jtool().main(["--pipeline", "--pp", "4", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    for d in (got, want):
        d.pop("objective")
        d.pop("inner")
        d["hand"].pop("objective", None)
    assert got == want and got["ok"] is True


def test_known_difference_topology_costs_are_the_h100s(capsys):
    from paddle_tpu_torch.tools import spmd_plan
    assert spmd_plan.main(["--topology", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert _jtool().main(["--topology", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["rules"] == want["rules"]
    assert got["data_specs"] == want["data_specs"]
    gs, jgs = got["topology"]["grad_sync"], want["topology"]["grad_sync"]
    assert gs["schemes"]["flat"]["wire_bytes"] == \
        jgs["schemes"]["flat"]["wire_bytes"]
    assert got["topology"]["tiers"]["pod"]["gbps"] == 50.0
    assert want["topology"]["tiers"]["pod"]["gbps"] == 6.25


# ---------------------------------------------------------------------------
# the pipeline planner
# ---------------------------------------------------------------------------

def _pplans(progs, mesh, **kw):
    return {P.name: _mod(P).plan_pipeline(progs[P.name][0], mesh, **kw)
            for P in (JAX, PORT)}


def _same_pp(plans):
    j, t = plans["jax"].to_json(), plans["port"].to_json()
    for d in (j, t):
        d.pop("inner", None)
    assert t.pop("objective") == pytest.approx(j.pop("objective"), rel=1e-9)
    if t["hand"]:
        assert t["hand"].pop("objective") == pytest.approx(
            j["hand"].pop("objective"), rel=1e-9)
    assert t == j
    p = plans["port"]
    assert [(c.boundary, tuple(c.aval.shape)) for c in p.cut_points] == \
        [(c.boundary, tuple(c.aval.shape))
         for c in plans["jax"].cut_points]
    return p


def test_legal_cut_points_equal_jax():
    progs = _both("cuts", _gpt4(layers=4, batch=8))
    j = JPL.legal_cut_points(progs["jax"][0])
    t = TPL.legal_cut_points(progs["port"][0])
    assert [(c.boundary, tuple(c.aval.shape)) for c in t] == \
        [(c.boundary, tuple(c.aval.shape)) for c in j]
    assert len([c for c in t if tuple(c.aval.shape) == (8, 16, 64)]) >= 4


def test_pp4_gpt_golden_stage_cut_equals_jax():
    progs = _both("pp4", _gpt4(layers=4, batch=8))
    plan = _same_pp(_pplans(progs, {"pp": 4}))
    assert plan.diagnostics == [] and len(plan.stages) == 4
    assert plan.objective <= plan.hand["objective"] + 1e-9


def test_heterogeneous_stack_beats_equal_cut_as_jax():
    progs = _both("het", _mlp([4, 4, 1, 1, 1, 1, 1, 1]))
    plan = _same_pp(_pplans(progs, {"pp": 4}, num_micro=8))
    assert plan.objective < plan.hand["objective"]


def test_per_stage_hbm_prices_op_ranges():
    from paddle_tpu_torch.static.shape_infer import analyze_memory
    progs = _both("hbm", _gpt4(layers=4, batch=8))
    plan = TPL.plan_pipeline(progs["port"][0], {"pp": 4})
    full = analyze_memory(progs["port"][0])
    for s in plan.stages:
        assert 0 < s.hbm_peak < full["peak_bytes"]


def _bounds(progs, n):
    opl = len(progs["port"][0].ops) // n
    return opl, [k * opl for k in range(1, n)]


def test_explicit_cuts_and_boundaries_equal_jax():
    progs = _both("ex", _mlp([1] * 8))
    opl, bounds = _bounds(progs, 8)
    plan = _same_pp(_pplans(progs, {"pp": 4}, num_micro=8,
                            boundaries=bounds))
    assert plan.cuts == [2 * opl, 4 * opl, 6 * opl]
    assert plan.stage_segments() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    bad = _same_pp(_pplans(progs, {"pp": 4}, num_micro=8,
                           boundaries=bounds,
                           cuts=[opl + 1, 2 * opl, 3 * opl]))
    assert any("not a legal" in d for d in bad.diagnostics)


def test_interleaved_plan_round_robin_equals_jax():
    progs = _both("il", _mlp([1] * 8))
    _, bounds = _bounds(progs, 8)
    plan = _same_pp(_pplans(progs, {"pp": 4}, num_micro=8, num_virtual=2,
                            boundaries=bounds))
    assert plan.schedule == "interleaved"
    assert plan.stage_segments() == [[k] for k in range(8)]


def _moe(P, static, layers=4, hidden=16, experts=4):
    from importlib import import_module
    moe_mod = import_module(("paddle_tpu" if P is JAX else "paddle_tpu_torch")
                            + ".distributed.moe")
    x = static.data("x", [4, 8, hidden], "float32")
    h, names = x, {}
    for i in range(layers):
        lin = P.nn.Linear(hidden, hidden)
        moe = moe_mod.MoELayer(hidden, 2 * hidden, experts, axis="ep")
        h = moe(P.ops.tanh(lin(h)))
        for suffix, p in (("fc.weight", lin.weight), ("fc.bias", lin.bias),
                          ("moe.gate.weight", moe.gate.weight),
                          ("moe.w_up", moe.w_up), ("moe.b_up", moe.b_up),
                          ("moe.w_down", moe.w_down),
                          ("moe.b_down", moe.b_down)):
            names[p.scope_name] = f"blocks.{i}.{suffix}"
    return names, h, None


def test_ep_mesh_places_experts_as_jax():
    progs = _both("ep", _moe)
    plans = {P.name: _mod(P).plan_pipeline(
        progs[P.name][0], {"pp": 2, "ep": 2}, names=progs[P.name][1])
        for P in (JAX, PORT)}
    plan = _same_pp(plans)
    assert plan.inner.spec_for("blocks.0.moe.w_up", 3) == \
        TP("ep", None, None)
    assert plan.expert["all_to_all_count"] == 8


def test_ep_conflicts_are_diagnosed_as_jax():
    from paddle_tpu.static import spmd_analyzer as JA
    from paddle_tpu_torch.static import spmd_analyzer as TA
    progs = _both("epc", lambda P, s: _moe(P, s, layers=1))
    codes = {}
    for P in (JAX, PORT):
        inv = {v: k for k, v in progs[P.name][1].items()}
        S = JP if P is JAX else TP
        rep = (JA if P is JAX else TA).analyze_program(
            progs[P.name][0], mesh={"ep": 2, "other": 2},
            param_specs={inv["blocks.0.moe.w_up"]: S("ep"),
                         inv["blocks.0.moe.w_down"]: S("other")})
        codes[P.name] = [d.code for d in rep.diagnostics]
    assert codes["port"] == codes["jax"] and "reshard" in codes["port"]


def test_schedule_math_degenerate_edges_equal_jax():
    from paddle_tpu.distributed import pipeline as jp
    from paddle_tpu_torch.distributed import pipeline as tp
    for args in ((8, 1), (2, 4), (0, 4), (0, 1), (8, 4, "interleaved", 2)):
        assert tp.bubble_fraction(*args) == jp.bubble_fraction(*args)
        assert tp.schedule_ticks(*args) == jp.schedule_ticks(*args)
    assert tp.schedule_collectives(8, 1, 4096) == \
        jp.schedule_collectives(8, 1, 4096)


def test_as_strategy_pipeline_round_trip_resolves_stages():
    from paddle_tpu_torch import optimizer as opt_mod
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.static import spmd_analyzer
    progs = _both("spp", _mlp([1] * 4, batch=8))
    _, bounds = _bounds(progs, 4)
    plan = TPL.plan_pipeline(progs["port"][0], {"pp": 2}, num_micro=4,
                             boundaries=bounds)
    strategy = plan.inner.as_strategy()
    cfgs = strategy.pipeline_configs
    assert strategy.pipeline and cfgs["pp_degree"] == 2
    assert cfgs["stage_op_ranges"] == [tuple(s.op_range)
                                       for s in plan.stages]
    with static_mode(PORT) as static:
        main2 = static.Program("strategy_pp_run")
        with static.program_guard(main2, static.Program()):
            x = static.data("x", [8, 32], "float32")
            h = x
            lins = []
            for _ in range(4):
                lins.append(PORT.nn.Linear(32, 32, bias_attr=False))
                h = PORT.ops.tanh(lins[-1](h))
            loss = PORT.ops.mean(h)
            opt = fleet.distributed_optimizer(
                opt_mod.SGD(learning_rate=0.1, parameters=[
                    p for lin in lins for p in lin.parameters()]),
                strategy)
            opt.minimize(loss)
        main2._auto_shard = {"mesh": {"pp": 2}, "num_micro": 4}
        old = spmd_analyzer.set_verify_spmd(True)
        try:
            (out,) = static.Executor().run(
                main2, feed={"x": np.ones((8, 32), "float32")},
                fetch_list=[loss])
        finally:
            spmd_analyzer.set_verify_spmd(old)
    assert np.isfinite(out)
    st = main2._pipeline_stages
    assert st["num_stages"] == 2 and st["schedule"] == "1f1b"
    assert set(st["param_stages"]) == set(main2.persist_ids)


def test_resolve_auto_shard_pp_mesh_routes_to_pipeline():
    progs = _both("rpp", _mlp([1] * 4, batch=8))
    main = progs["port"][0]
    main._auto_shard = {"mesh": {"pp": 2}, "num_micro": 4}
    plan = TPL.resolve_auto_shard(main)
    assert plan.pipeline is not None
    assert main._pipeline_stages["num_stages"] == 2
    assert TPL.resolve_auto_shard(main) is plan


def test_pipeline_runner_takes_a_stage_plan():
    from paddle_tpu_torch.static.pipeline_runner import PipelineRunner
    progs = _both("srp", _mlp([1] * 4, batch=8))
    _, bounds = _bounds(progs, 4)
    plan = TPL.plan_pipeline(progs["port"][0], {"pp": 2}, num_micro=4,
                             boundaries=bounds)
    with static_mode(PORT) as static:
        runner = PipelineRunner(static.Executor(), progs["port"][0],
                                fetch_list=[progs["port"][2]],
                                stage_plan=plan)
        (h,) = runner.submit({"x": np.ones((8, 32), "float32")})
        runner.sync()
    assert runner.stage_plan is plan
    assert tmonitor.stat_get("executor/pipeline_stages") == 2
    assert np.asarray(h.numpy()).shape == (8, 32)


# ---------------------------------------------------------------------------
# StagedPipelineRunner over gloo ranks against JAX's runner
# ---------------------------------------------------------------------------

L, D, B = 8, 32, 16


def _data(seed):
    rng = np.random.RandomState(seed)
    ws = [(rng.randn(D, D) / np.sqrt(D)).astype("float32")
          for _ in range(L)]
    return ws, rng.randn(B, D).astype("float32"), \
        rng.randn(B, D).astype("float32")


def _jax_staged(ws, x, y, pp, v, num_micro=4, steps=3, lr=0.1):
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu import nn, ops, static
    from paddle_tpu.static.pipeline_runner import StagedPipelineRunner
    paddle.enable_static()
    try:
        main = static.Program(f"staged_{pp}_{v}")
        with static.program_guard(main):
            h = static.data("x", [B, D], "float32")
            for _ in range(L):
                h = ops.tanh(nn.Linear(D, D, bias_attr=False)(h))
        main._jit_fetch_vars = [h]
        opl = len(main.ops) // L
        plan = JPL.plan_pipeline(main, {"pp": pp}, num_micro=num_micro,
                                 num_virtual=v,
                                 boundaries=[k * opl for k in range(1, L)])
    finally:
        paddle.disable_static()
    mesh = jmesh.init_mesh({"pp": pp}, name="_staged_parity",
                           devices=jax.devices()[:pp])
    try:
        runner = StagedPipelineRunner(
            plan, lambda h, w: jnp.tanh(h @ w),
            [jnp.asarray(w) for w in ws],
            lambda h, t: jnp.mean((h - t) ** 2), mesh=mesh,
            learning_rate=lr)
        losses = [float(runner.step(x, y)) for _ in range(steps)]
        return plan.cuts, losses, [np.asarray(w)
                                   for w in runner.unit_params()]
    finally:
        jmesh.reset_mesh("_staged_parity")


@pytest.mark.parametrize("v", [1, 2])
def test_staged_runner_trains_as_jax(v, tmp_path):
    ws, x, y = _data(2 + v)
    cuts, jl, jw = _jax_staged(ws, x, y, 2, v)
    res = spmd.run_ranks(spmd_static.staged_mlp_case, 2, ws, x, y, 2, 4, v,
                         tmp_path=tmp_path)
    for r in res:
        assert r["cuts"] == cuts
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        for a, b in zip(r["weights"], jw):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert res[0]["depth_peak"] >= 1


def test_staged_runner_validates_the_mesh_and_units():
    from paddle_tpu_torch.static.pipeline_runner import StagedPipelineRunner
    ws, _x, _y = _data(4)
    main, opl = spmd_static.mlp_program(L, B, D)
    plan = TPL.plan_pipeline(main, {"pp": 2}, num_micro=4,
                             boundaries=[k * opl for k in range(1, L)])
    with pytest.raises(ValueError, match="'pp' axis"):
        StagedPipelineRunner(plan, None, ws, None, mesh=tmesh.Mesh({"dp": 1}))
    m = tmesh.Mesh({"pp": 2})
    with pytest.raises(ValueError, match="segments"):
        StagedPipelineRunner(plan, None, ws[:3], None, mesh=m)


def test_moe_layer_records_in_a_static_program_as_jax():
    """G8: the port's switch_route read the dropped-token count on the
    host during a static Program's shape inference (meta tensors) and
    the recording raised ShapeInferError; JAX skips the count under
    tracing. The recorded MoE op now prices JAX's two all-to-alls."""
    from paddle_tpu.static import spmd_analyzer as JA
    from paddle_tpu_torch.static import spmd_analyzer as TA
    progs = _both("moe_rec", lambda P, s: _moe(P, s, layers=1))
    assert [o.name for o in progs["port"][0].ops] == \
        [o.name for o in progs["jax"][0].ops]
    a2a = {}
    for P in (JAX, PORT):
        inv = {v: k for k, v in progs[P.name][1].items()}
        S = JP if P is JAX else TP
        rep = (JA if P is JAX else TA).analyze_program(
            progs[P.name][0], mesh={"ep": 2},
            param_specs={inv[f"blocks.0.moe.{n}"]: S("ep")
                         for n in ("w_up", "b_up", "w_down", "b_down")})
        a2a[P.name] = [(c.kind, c.axis, c.bytes) for c in rep.collectives]
    assert a2a["port"] == a2a["jax"] and len(a2a["port"]) == 2
