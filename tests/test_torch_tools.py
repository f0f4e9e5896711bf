"""The port's tools (paddle_tpu_torch/tools), each run through its
``main`` at its smallest size on the CPU, and each self-check:

- ``capacity_plan``: the analytic report of the tiny loop at the H100's
  peaks (the GPT-2 report and ``--validate`` run on the card; the CPU
  ``--validate`` is test_torch_capacity.py's slow test);
- ``ps_load_test``: the plain throughput mode and the sharded-embedding
  drill (device cache on the CPU, a 2 s heartbeat deadline as the port's
  PS chaos tests use), 2 workers x 3 rounds, which end before the drill
  kills a primary at 0.5 s: the promotion is checked, not pushes in
  flight across it (with pushes in flight a forward to the dead backup
  can evict it first and no promotion follows, in the reference's
  protocol too; ROADMAP Queue 3 states it);
- ``cluster_obs_drill``: the whole drill (3 shard servers, the
  serve + train client, chaos, the primary kill; ~15 s), its report
  checked as tests/test_cluster_telemetry.py checks the JAX package's;
- ``spmd_plan --tp 2 --json`` gives the JAX tool's plan, ``spmd_lint``
  flags what the JAX tool flags (the rest of both tools' cases are in
  test_torch_spmd_analyzer.py and test_torch_spmd_planner.py);
- ``elastic_drill`` at 8 steps (a checkpoint every 3): the trainer
  SIGKILLed mid-epoch and restarted ends with its parameters and every
  server's ``table.applied`` bitwise the uninterrupted run's.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, *args, env=None, timeout=240):
    e = dict(os.environ, **(env or {}))
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m",
                           f"paddle_tpu_torch.tools.{module}", *args],
                          env=e, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("tool", ["capacity_plan", "ps_load_test",
                                  "cluster_obs_drill"])
def test_tool_self_check(tool):
    proc = _run(tool, "--self-check", timeout=120)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "OK" in proc.stdout or "clean" in proc.stdout


def test_capacity_plan_report_is_deterministic():
    from paddle_tpu_torch.tools import capacity_plan
    a = capacity_plan.report(config="tiny")
    assert a == capacity_plan.report(config="tiny")
    assert a["profile"]["source"] == "analytic-h100-sxm"
    assert a["knee_rps"] > 0 and len(a["sweep"]) == 6
    rho = [p["rho"] for p in a["sweep"]]
    assert rho == sorted(rho) and a["sweep"][-1]["over_knee"]
    assert all(p["completed"] == p["events"] > 0 for p in a["sweep"])
    ev = a["evidence"]
    assert ev["flops"] > 0 and ev["bytes_accessed"] > 0


@pytest.mark.parametrize("mode", ["plain", "sharded"])
def test_ps_load_test_runs_clean(mode):
    env = {"PS_LOAD_WORKERS": "2", "PS_LOAD_ROUNDS": "3",
           "PS_LOAD_BATCH": "256", "PS_LOAD_DEVICE": "cpu",
           "PS_LOAD_HB_TIMEOUT_S": "2.0"}
    if mode == "sharded":
        env["PS_LOAD_SHARDED"] = "1"
    proc = _run("ps_load_test", env=env)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    if mode == "plain":
        assert "aggregate rows/sec" in proc.stdout
        assert "round latency ms: p50=" in proc.stdout
    else:
        assert "all workers finished with zero errors" in proc.stdout
        assert "promotion latency: NONE" not in proc.stdout


def test_cluster_obs_drill_end_to_end(tmp_path):
    proc = _run("cluster_obs_drill", "--device", "cpu",
                env={"CLUSTER_OBS_DIR": str(tmp_path)})
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-2000:],
                                  proc.stderr[-4000:])
    report = json.loads(proc.stdout)
    assert report["violations"] == 0
    assert report["incidents"] == 1
    assert set(report["alerts"]) == {"serve_ttft"}
    assert report["stall_fired"] >= 1
    assert len(report["incident_members"]) >= 4
    assert report["cross_process_chains"] >= 1
    assert any(f.startswith("incident_") and f.endswith(".json")
               for f in os.listdir(str(tmp_path)))


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import importlib
    return importlib.import_module(name)


def test_spmd_plan_tp2_json_gives_the_jax_tools_plan():
    out = _run("spmd_plan", "--tp", "2", "--json")
    got = json.loads(out.stdout)
    from paddle_tpu_torch.tools import spmd_plan as tplan
    jplan = _jax_tool("spmd_plan")
    plan, preset, repl, _p, _n, _l = jplan.build_plan(tp=2)
    want = jplan.plan_json(plan, preset, repl)
    assert got.pop("objective") == pytest.approx(want.pop("objective"),
                                                 rel=1e-9)
    assert got == json.loads(json.dumps(want))
    assert tplan.self_check() == []


@pytest.mark.parametrize("inject", [None, "unbound-axis", "cross-tier"])
def test_spmd_lint_flags_what_the_jax_tool_flags(inject):
    args = [] if inject is None else ["--inject", inject]
    out = _run("spmd_lint", *args)
    jlint = _jax_tool("spmd_lint")
    rep, _, _ = jlint.build_report(inject=inject)
    assert out.returncode == (1 if rep.diagnostics else 0)
    for d in rep.diagnostics:
        assert d.code in out.stdout
    assert ("diagnostics: none" in out.stdout) == (not rep.diagnostics)


def test_elastic_drill_sigkill_resume_is_bitwise(tmp_path):
    from paddle_tpu_torch.tools import elastic_drill as drill
    assert drill.self_check() == []
    ref = drill.run_supervised(str(tmp_path), kill=False, steps=8,
                               save_every=3)
    chaos = drill.run_supervised(str(tmp_path), kill=True, steps=8,
                                 save_every=3)
    assert chaos[4], "the supervisor recorded no restart"
    for k in ref[0]:
        assert (ref[0][k] == chaos[0][k]).all(), k
    assert (ref[1] == chaos[1]).all() and (ref[2] == chaos[2]).all()
    assert ref[3] == chaos[3]
