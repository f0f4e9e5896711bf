"""Port parity: the SPMD analyzer's spec propagation, collectives, memory
estimate and diagnostics (paddle_tpu_torch/static/spmd_analyzer.py)
against the JAX package's, and the port's ``tools/spmd_lint``.

Each case records the same static Program in both packages (GPT tiny,
a Linear, a cond, a while loop ...) and analyzes it on the same
{axis: size} mesh with the same specs; the reports agree exactly: every
collective's kind, axis, bytes, dtype, op and variable, every
diagnostic's code, op, variable and axis, the propagated specs of every
variable and the memory estimates (the counterparts of
``tests/test_spmd_analyzer.py`` and ``tests/test_spmd_lint.py``). Known
difference: the two-tier mesh's link bandwidths are the H100's in the
port (``FLAGS_topology_{ici,dcn}_gbps`` 450 / 50 GB/s against the JAX
package's 90 / 6.25), so ``cost_us`` differs while the tiers and the
bytes agree.
"""
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import sharding as jsharding
from paddle_tpu.static import spmd_analyzer as JA
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import sharding as tsharding
from paddle_tpu_torch.distributed.mesh import PartitionSpec as TP
from paddle_tpu_torch.static import spmd_analyzer as TA

from test_torch_static_cases import JAX, PORT, static_mode

MESH = {"dp": 2, "tp": 2}
TIERED = {"pod": {"size": 2, "tier": "dcn"}, "dp": 2, "tp": 2}


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _P(P, *entries):
    return (JP if P is JAX else TP)(*entries)


def _sharding(P):
    return jsharding if P is JAX else tsharding


def _record(P, name, body):
    """body(P, static) -> (net or None, fetch var, extra) recorded into a
    fresh Program of package P; returns (program, net, fetch, extra)."""
    with static_mode(P) as static:
        main = static.Program(name)
        with static.program_guard(main, static.Program()):
            P.paddle.seed(0)
            net, out, extra = body(P, static)
        main._jit_fetch_vars = [out]
    return main, net, out, extra


def _linear(in_f=8, out_f=4, batch=4):
    def body(P, static):
        x = static.data("x", [batch, in_f], "float32")
        net = P.nn.Linear(in_f, out_f)
        return net, net(x), None
    return body


def _gpt(layers=2, batch=2, seq=16, tiny=False):
    def body(P, static):
        from importlib import import_module
        g = import_module(("paddle_tpu" if P is JAX else "paddle_tpu_torch")
                          + ".text.models.gpt")
        ids = static.data("input_ids", [batch, seq], "int64")
        cfg = g.GPTConfig.tiny() if tiny else g.GPTConfig(
            vocab_size=1024, hidden_size=64, num_layers=layers,
            num_heads=2, intermediate_size=128, max_seq_len=32)
        net = g.GPT(cfg)
        return net, net(ids), None
    return body


def _both(name, body):
    """The program in both packages, each numbering its variables from the
    same counter value (the larger of the two): the control-flow cases
    compare sub-block variables by their raw names, and files that ran
    before in the same worker may have moved one counter further."""
    from paddle_tpu.static.program import Variable as JVar
    from paddle_tpu_torch.static.program import Variable as TVar
    JVar._counter[0] = TVar._counter[0] = max(JVar._counter[0],
                                              TVar._counter[0])
    return {P.name: _record(P, name, body) for P in (JAX, PORT)}


def _names(program):
    """Program-order names of a program's variables: the packages number
    their variables from counters that drift apart over a test session,
    so persistables are p0, p1 ... and op outputs v0, v1 ... in order."""
    out = {}
    for i, name in enumerate(program.persistable_vars):
        out[name] = f"p{i}"
        out[program.persistable_vars[name].name] = f"p{i}"
    k = 0
    for op in program.ops:
        for v in op.out_vars:
            out.setdefault(v.name, f"v{k}")
            k += 1
    return out


def _rename(text, names):
    import re
    if text is None or not names:
        return text
    rx = re.compile("|".join(re.escape(n) for n in
                             sorted(names, key=len, reverse=True)))
    return rx.sub(lambda m: names[m.group(0)], text)


def _summary(rep, program):
    nm = _names(program)
    out = {
        "mesh": dict(rep.mesh_axes),
        "collectives": [(c.kind, c.axis, c.bytes, c.op_index, c.op_name,
                         nm.get(c.var, c.var), c.dtype, c.tier)
                        for c in rep.collectives],
        "diagnostics": [(d.code, d.op_name, d.op_index, nm.get(d.var, d.var),
                         d.axis, _rename(d.message, nm))
                        for d in rep.diagnostics],
        "specs": {nm.get(rep.var_names.get(k, k), rep.var_names.get(k, k)):
                  v for k, v in rep.specs.items()},
        "unknown": sorted(rep.unknown_ops), "dp_axes": rep.dp_axes,
        "tiers": {a: m["tier"] for a, m in rep.mesh_tiers.items()},
    }
    for key in ("hbm", "hbm_replicated"):
        h = getattr(rep, key)
        out[key] = None if h is None else (
            h["peak_bytes"], h["param_bytes"], h["activation_peak_bytes"])
    return out


def _analyze(progs, mesh, param_specs=None, data_specs=None, named=False):
    """Both packages' reports; ``param_specs`` / ``data_specs``: a
    function (P, net) -> {name: spec entries tuple} or None."""
    reps = {}
    for P in (JAX, PORT):
        main, net, _, _ = progs[P.name]
        ps = None
        if named:
            ps = _sharding(P).named_param_specs(
                net, {a: (m["size"] if isinstance(m, dict) else m)
                      for a, m in mesh.items()})
        elif param_specs is not None:
            ps = {k: _P(P, *v) for k, v in param_specs(P, net).items()}
        ds = None if data_specs is None else \
            {k: _P(P, *v) for k, v in data_specs.items()}
        mod = JA if P is JAX else TA
        reps[P.name] = mod.analyze_program(main, mesh=mesh, param_specs=ps,
                                           data_specs=ds)
    return reps


def _assert_same(reps, progs):
    j = _summary(reps["jax"], progs["jax"][0])
    t = _summary(reps["port"], progs["port"][0])
    assert t == j
    return reps["port"]


# ---------------------------------------------------------------------------
# golden paths
# ---------------------------------------------------------------------------

def test_gpt_tp_golden_path_equals_jax():
    progs = _both("gpt", _gpt())
    rep = _assert_same(_analyze(progs, {"tp": 2}, named=True), progs)
    assert rep.diagnostics == []
    ar = [c for c in rep.collectives if c.kind == "all_reduce"]
    assert len(ar) == 5 and ar[0].op_name == "embedding"
    assert rep.spec_of(progs["port"][2]) == ((), (), ("tp",))
    assert rep.hbm["peak_bytes"] < rep.hbm_replicated["peak_bytes"]


def test_gpt_block_qkv_column_then_row_equals_jax():
    def body(P, static):
        from importlib import import_module
        g = import_module(("paddle_tpu" if P is JAX else "paddle_tpu_torch")
                          + ".text.models.gpt")
        x = static.data("x", [2, 16, 64], "float32")
        blk = g.GPTBlock(g.GPTConfig.tiny())
        return blk, blk(x), None
    progs = _both("blk", body)
    rep = _assert_same(_analyze(progs, {"tp": 2}, named=True), progs)
    ar = [c for c in rep.collectives if c.kind == "all_reduce"]
    assert len(ar) == 2 and all(c.op_name == "matmul" for c in ar)
    assert rep.spec_of(progs["port"][2]) == ((), (), ())


def test_dp_batch_sharding_propagates_equals_jax():
    progs = _both("lin", _linear())
    rep = _assert_same(_analyze(progs, MESH, data_specs={"x": ("dp",)}),
                       progs)
    assert rep.collectives == [] and rep.diagnostics == []
    assert rep.spec_of(progs["port"][2])[0] == ("dp",)


def test_analyze_params_dygraph_gpt_equals_jax():
    from paddle_tpu.text.models import gpt as jg
    from paddle_tpu_torch.text.models import gpt as tg
    jnet, tnet = jg.GPT(jg.GPTConfig.tiny()), tg.GPT(tg.GPTConfig.tiny())
    jr = JA.analyze_params(dict(jnet.named_parameters()), mesh={"tp": 2},
                           tokens_per_step=32)
    tr = TA.analyze_params(dict(tnet.named_parameters()), mesh={"tp": 2},
                           tokens_per_step=32)
    key = lambda r: [(c.kind, c.axis, c.bytes, c.var, c.dtype)  # noqa: E731
                     for c in r.collectives]
    assert key(tr) == key(jr) and len(key(tr)) == 5
    assert tr.hbm["param_bytes"] == jr.hbm["param_bytes"]
    assert sorted(tr.var_names.values()) == sorted(jr.var_names.values())
    assert tr.diagnostics == jr.diagnostics == []


# ---------------------------------------------------------------------------
# the broken corpus: one program a diagnostic, the same finding in both
# ---------------------------------------------------------------------------

CORPUS = {
    "unbound-axis": (_linear(), lambda P, n: {n.weight.scope_name:
                                               ("mp", None)}, None),
    "duplicate-axis": (_linear(), lambda P, n: {n.weight.scope_name:
                                                 ("tp", "tp")}, None),
    "non-divisible": (_linear(in_f=7), lambda P, n: {n.weight.scope_name:
                                                      ("tp", None)}, None),
    "spec-rank": (_linear(), lambda P, n: {n.bias.scope_name:
                                            (None, "tp")}, None),
    "reshard": (_linear(), None, {"x": (None, "tp")}),
}


@pytest.mark.parametrize("code", sorted(CORPUS))
def test_corpus_diagnostic_equals_jax(code):
    body, ps, ds = CORPUS[code]
    progs = _both(f"c_{code}", body)
    rep = _assert_same(_analyze(progs, MESH, param_specs=ps,
                                data_specs=ds), progs)
    assert code in [d.code for d in rep.diagnostics]


def test_corpus_reshard_prices_the_gather_as_jax():
    progs = _both("rs", _linear())
    rep = _assert_same(_analyze(progs, MESH,
                                data_specs={"x": (None, "tp")}), progs)
    ag = [c for c in rep.collectives if c.kind == "all_gather"]
    assert len(ag) == 1 and ag[0].bytes == 4 * 8 * 4


def _cond(P, static):
    x = static.data("x", [4, 8], "float32")
    yv = static.data("y", [4, 4], "float32")
    w = P.nn.Linear(8, 4, bias_attr=False)
    pred = P.ops.less_than(P.ops.sum(yv), P.ops.full([], 100.0, "float32"))
    out = static.nn.cond(pred, lambda: P.ops.matmul(x, w.weight),
                         lambda: P.ops.exp(yv))
    return w, out, None


def test_corpus_collective_divergence_across_cond_equals_jax():
    progs = _both("cf", _cond)
    rep = _assert_same(_analyze(
        progs, MESH, param_specs=lambda P, n: {n.weight.scope_name:
                                               ("tp", None)},
        data_specs={"x": (None, "tp")}), progs)
    d = next(x for x in rep.diagnostics
             if x.code == "collective-divergence")
    assert d.op_name == "cond" and "all_reduce" in d.message


def test_corpus_reshard_contraction_on_different_axes_equals_jax():
    def body(P, static):
        x = static.data("x", [4, 8], "float32")
        w = P.nn.Linear(8, 4, bias_attr=False)
        return w, P.ops.matmul(x, w.weight), None
    progs = _both("xx", body)
    rep = _assert_same(_analyze(
        progs, MESH, param_specs=lambda P, n: {n.weight.scope_name:
                                               ("tp", None)},
        data_specs={"x": (None, "dp")}), progs)
    assert "DIFFERENT axes" in rep.diagnostics[0].message
    assert sorted(c.axis for c in rep.collectives
                  if c.kind == "all_gather") == ["dp", "tp"]


def test_while_loop_literal_carry_inner_collective_equals_jax():
    def body(P, static):
        x = static.data("x", [4, 8], "float32")
        w = P.nn.Linear(8, 8, bias_attr=False)
        n = P.ops.full([], 3, "int32")
        _, acc = static.nn.while_loop(
            lambda i, a: P.ops.less_than(i, n),
            lambda i, a: (i + 1, P.ops.matmul(a, w.weight)),
            [P.ops.zeros([], "int32"), x])
        return w, acc, None
    progs = _both("wl", body)
    rep = _assert_same(_analyze(
        progs, MESH, param_specs=lambda P, n: {n.weight.scope_name:
                                               ("tp", None)},
        data_specs={"x": (None, "tp")}), progs)
    ar = [c for c in rep.collectives if c.kind == "all_reduce"]
    assert len(ar) == 1 and "while_loop#" in ar[0].op_name


def test_diagnostic_catalogue_equals_jax():
    assert TA.DIAGNOSTIC_CODES == JA.DIAGNOSTIC_CODES
    src = open(__file__).read()
    for code in TA.DIAGNOSTIC_CODES:
        assert f'"{code}"' in src


# ---------------------------------------------------------------------------
# the PADDLE_TPU_VERIFY_SPMD hook and the monitor gauges
# ---------------------------------------------------------------------------

@pytest.fixture()
def tp_mesh():
    m = tmesh.Mesh({"tp": 2})
    tmesh.set_mesh(m, "_spmd_hook_test")
    try:
        yield m
    finally:
        tmesh.reset_mesh("_spmd_hook_test")


def test_verify_spmd_env_flag_as_jax(monkeypatch):
    TA.set_verify_spmd(None)
    for v, want in (("0", False), ("1", True), ("off", False)):
        monkeypatch.setenv("PADDLE_TPU_VERIFY_SPMD", v)
        assert TA.verify_spmd_enabled() is want
        JA.set_verify_spmd(None)
        assert JA.verify_spmd_enabled() is want
    old = TA.set_verify_spmd(True)
    try:
        monkeypatch.setenv("PADDLE_TPU_VERIFY_SPMD", "0")
        assert TA.verify_spmd_enabled()
    finally:
        TA.set_verify_spmd(old)


@pytest.mark.parametrize("bad,code", [(("mp", None), "unbound-axis"),
                                      (("tp", None), "non-divisible")])
def test_hook_fails_the_compile_before_the_replay(tp_mesh, monkeypatch,
                                                  bad, code):
    monkeypatch.setenv("PADDLE_TPU_VERIFY_SPMD", "1")
    main, net, y, _ = _record(PORT, "hook", _linear(in_f=7))
    main.spmd_param_specs = {net.weight.scope_name: TP(*bad)}
    before = tmonitor.stat_get("executor/lowerings")
    with static_mode(PORT) as static:
        with pytest.raises(TA.SpmdLintError) as e:
            static.Executor().run(
                main, feed={"x": np.ones((4, 7), "float32")},
                fetch_list=[y])
    assert e.value.code == code
    assert tmonitor.stat_get("executor/lowerings") == before


def test_hook_in_apply_pass(tp_mesh, monkeypatch):
    from paddle_tpu_torch.static.passes import apply_pass
    monkeypatch.setenv("PADDLE_TPU_VERIFY_SPMD", "1")
    main, net, _, _ = _record(PORT, "hook_pass", _linear())
    main.spmd_param_specs = {net.weight.scope_name: TP("zz", None)}
    with pytest.raises(TA.SpmdLintError, match="unbound-axis"):
        apply_pass(main, "eliminate_dead_ops")


def test_hook_clean_program_runs_and_publishes_gauges(tp_mesh, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VERIFY_SPMD", "1")
    main, net, y, _ = _record(PORT, "hook_ok", _linear())
    main.spmd_param_specs = {net.weight.scope_name: TP(None, "tp"),
                             net.bias.scope_name: TP("tp")}
    with static_mode(PORT) as static:
        (out,) = static.Executor().run(
            main, feed={"x": np.ones((4, 8), "float32")}, fetch_list=[y])
    assert out.shape == (4, 4)
    g = tmonitor.stats("spmd.")
    assert g["spmd.hbm_estimate"] > 0 and g["spmd.resharding_count"] == 0


def test_log_spmd_estimate_publishes_at_compile(tp_mesh):
    from paddle_tpu_torch.core import flags
    main, net, y, _ = _record(PORT, "log_est", _linear())
    main.spmd_param_specs = {net.weight.scope_name: TP("tp", None)}
    main.spmd_data_specs = {"x": TP(None, "tp")}
    tmonitor.stat_set("spmd.collective_bytes", -1)
    flags.set_flags({"FLAGS_log_spmd_estimate": True})
    try:
        with static_mode(PORT) as static:
            static.Executor().run(main, feed={"x": np.ones((4, 8),
                                                           "float32")},
                                  fetch_list=[y])
    finally:
        flags.set_flags({"FLAGS_log_spmd_estimate": False})
    assert tmonitor.stat_get("spmd.collective_bytes") == 4 * 4 * 4


def test_gauges_reflect_collective_bytes_as_jax():
    progs = _both("g", _linear())
    reps = _analyze(progs, MESH, param_specs=lambda P, n: {
        n.weight.scope_name: ("tp", None)}, data_specs={"x": (None, "tp")})
    rep = _assert_same(reps, progs)
    rep.publish()
    assert tmonitor.stat_get("spmd.collective_bytes") \
        == reps["jax"].collective_bytes() > 0


def test_fleet_spmd_report_equals_jax():
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu_torch.distributed import fleet as tfleet
    progs = _both("fr", _gpt())
    jr = jfleet.spmd_report(program=progs["jax"][0], layer=progs["jax"][1],
                            mesh={"tp": 2})
    tr = tfleet.spmd_report(program=progs["port"][0],
                            layer=progs["port"][1], mesh={"tp": 2})
    _assert_same({"jax": jr, "port": tr}, progs)
    from paddle_tpu.text.models import gpt as jg
    from paddle_tpu_torch.text.models import gpt as tg
    jd = jfleet.spmd_report(layer=jg.GPT(jg.GPTConfig.tiny()),
                            mesh={"tp": 2}, tokens_per_step=32)
    td = tfleet.spmd_report(layer=tg.GPT(tg.GPTConfig.tiny()),
                            mesh={"tp": 2}, tokens_per_step=32)
    assert [c.bytes for c in td.collectives] == \
        [c.bytes for c in jd.collectives]
    with pytest.raises(ValueError, match="program or a layer"):
        tfleet.spmd_report()


# ---------------------------------------------------------------------------
# satellites: the rule tables, the mesh, the schedule accounting
# ---------------------------------------------------------------------------

def test_validate_divisible_counts_and_rejects_long_specs_as_jax():
    mesh = tmesh.Mesh({"dp": 2})
    before = tmonitor.stat_get("sharding.nondivisible_fallback")
    assert tuple(tsharding._validate_divisible(TP("dp"), (5,), mesh)) \
        == tuple(jsharding._validate_divisible(
            JP("dp"), (5,), jmesh.init_mesh({"dp": 2}, name="_vd"))) \
        == (None,)
    jmesh.reset_mesh("_vd")
    assert tmonitor.stat_get("sharding.nondivisible_fallback") == before + 1
    assert tuple(tsharding._validate_divisible(TP("dp"), (6,), mesh)) \
        == ("dp",)
    with pytest.raises(ValueError, match="entries"):
        tsharding._validate_divisible(TP(None, "dp"), (6,), mesh, name="w")


def test_meshguard_without_mesh_names_the_registry():
    tmesh.reset_mesh("definitely_absent")
    with pytest.raises(RuntimeError) as e:
        tmesh.MeshGuard(name="definitely_absent").__enter__()
    assert "definitely_absent" in str(e.value)


def test_meshguard_with_mesh_binds_it():
    m = tmesh.Mesh({"dp": 1})
    tmesh.set_mesh(m, "mg_ok")
    try:
        with tmesh.MeshGuard(name="mg_ok") as got:
            assert got is m
            assert tmesh.in_spmd_region("dp") and \
                not tmesh.in_spmd_region("zz")
        assert not tmesh.in_spmd_region("dp")
    finally:
        tmesh.reset_mesh("mg_ok")


def test_pipeline_schedule_collectives_equal_jax():
    from paddle_tpu.distributed import pipeline as jpl
    from paddle_tpu_torch.distributed import pipeline as tpl
    for args, kw in (((8, 4, 1024), {}),
                     ((8, 4, 1024), {"schedule": "interleaved",
                                     "num_virtual": 2})):
        assert tpl.schedule_collectives(*args, **kw) == \
            jpl.schedule_collectives(*args, **kw)
    assert tpl.schedule_collectives(8, 4, 1024)["count"] == 11


def test_collective_dtype_and_bytes_if_equal_jax():
    progs = _both("dt", _linear())
    rep = _assert_same(_analyze(progs, MESH, param_specs=lambda P, n: {
        n.weight.scope_name: ("tp", None)}, data_specs={"x": (None, "tp")}),
        progs)
    (ar,) = rep.collectives
    (jar,) = [c for c in _analyze(progs, MESH, param_specs=lambda P, n: {
        n.weight.scope_name: ("tp", None)},
        data_specs={"x": (None, "tp")})["jax"].collectives]
    assert ar.dtype == "float32" and ar.is_float
    for dt in ("int8", "float16", "float32", "bfloat16", "float8_e4m3fn",
               "float8_e5m2"):
        assert ar.bytes_if(dt) == jar.bytes_if(dt)


def test_quantized_savings_and_render_equal_jax():
    progs = _both("q", _gpt(tiny=True))
    reps = _analyze(progs, {"tp": 2}, named=True)
    rep = _assert_same(reps, progs)
    assert rep.quantized_savings("int8") == \
        reps["jax"].quantized_savings("int8")
    assert rep.render() == reps["jax"].render()
    assert "int8/fp8 quantized collectives would save" in rep.render()


def test_matmul_output_axis_collision_is_priced_as_jax():
    progs = _both("mc", _linear())
    rep = _assert_same(_analyze(progs, MESH, param_specs=lambda P, n: {
        n.weight.scope_name: (None, "dp")}, data_specs={"x": ("dp",)}),
        progs)
    assert "cannot shard two" in rep.diagnostics[0].message
    assert rep.spec_of(progs["port"][2]) == (("dp",), ())


def test_embedding_vocab_axis_colliding_with_ids_equals_jax():
    def body(P, static):
        ids = static.data("ids", [4, 8], "int64")
        emb = P.nn.Embedding(16, 6)
        return emb, emb(ids), None
    progs = _both("emb", body)
    rep = _assert_same(_analyze(progs, MESH, param_specs=lambda P, n: {
        n.weight.scope_name: ("dp", None)}, data_specs={"ids": ("dp",)}),
        progs)
    assert [d.code for d in rep.diagnostics] == ["reshard"]
    assert "vocab-sharded" in rep.diagnostics[0].message


def test_add_tp_rule_callable_and_rank_check_as_jax():
    meshlike = tsharding.mesh_like({"tp": 2})
    tsharding.add_tp_rule(r"my_head\.weight$",
                          lambda ndim: TP(*([None] * (ndim - 1) + ["tp"])))
    try:
        assert tsharding.param_spec_for("my_head.weight", 3, meshlike) \
            == TP(None, None, "tp")
    finally:
        assert tsharding.remove_tp_rule(r"my_head\.weight$") == 1
    tsharding.add_tp_rule(r"tiny\.bias$", TP("tp", None))
    try:
        with pytest.raises(ValueError, match="rank-1 param 'tiny.bias'"):
            tsharding.param_spec_for("tiny.bias", 1, meshlike)
    finally:
        assert tsharding.remove_tp_rule(r"tiny\.bias$") == 1


# ---------------------------------------------------------------------------
# the two-tier topology
# ---------------------------------------------------------------------------

def test_tiered_mesh_prices_per_link_as_jax():
    progs = _both("tier", _gpt(batch=4))
    reps = {}
    for P in (JAX, PORT):
        net = progs[P.name][1]
        specs = _sharding(P).named_param_specs(net, TIERED)
        mod = JA if P is JAX else TA
        reps[P.name] = mod.analyze_program(
            progs[P.name][0], mesh=TIERED, param_specs=specs,
            data_specs={"input_ids": _P(P, ("pod", "dp"))})
    rep = _assert_same(reps, progs)
    assert rep.diagnostics == [] and rep.mesh_tiers["pod"]["tier"] == "dcn"
    assert rep.tier_bytes() == reps["jax"].tier_bytes()


def test_cross_tier_diagnostic_equals_jax():
    progs = _both("xt", _gpt(batch=4))
    reps = {}
    for P in (JAX, PORT):
        net = progs[P.name][1]
        specs = _sharding(P).named_param_specs(net, TIERED)
        specs[net.wte.weight.scope_name] = _P(P, "pod", None)
        mod = JA if P is JAX else TA
        reps[P.name] = mod.analyze_program(
            progs[P.name][0], mesh=TIERED, param_specs=specs,
            data_specs={"input_ids": _P(P, "dp")})
    rep = _assert_same(reps, progs)
    assert any(d.code == "cross-tier" and d.axis == "pod"
               for d in rep.diagnostics)


def test_hierarchical_sync_wire_bytes_equal_jax():
    progs = _both("hs", _gpt(batch=4))
    gs = {}
    for P in (JAX, PORT):
        net = progs[P.name][1]
        mod = JA if P is JAX else TA
        rep = mod.analyze_program(
            progs[P.name][0], mesh=TIERED,
            param_specs=_sharding(P).named_param_specs(net, TIERED),
            data_specs={"input_ids": _P(P, ("pod", "dp"))})
        gs[P.name] = rep.hierarchical_sync(grad_bytes=4096)
    for name in ("flat", "hierarchical", "localsgd"):
        assert gs["port"]["schemes"][name]["wire_bytes"] == \
            gs["jax"]["schemes"][name]["wire_bytes"]
    for k in ("inner", "outer", "inter_pod_reduction_x", "dp_axes",
              "grad_bytes", "localsgd_k"):
        assert gs["port"][k] == gs["jax"][k]
    assert gs["port"]["recommendation"] == "hierarchical"


def test_known_difference_tier_bandwidths_are_the_h100s():
    """The tiers and the bytes agree; the link rates are the H100's
    (NVLink 4 and InfiniBand: FLAGS_topology_{ici,dcn}_gbps 450 / 50 in
    the port, 90 / 6.25 in the JAX package), so cost_us differs."""
    progs = _both("bw", _gpt(batch=4))
    costs = {}
    for P in (JAX, PORT):
        net = progs[P.name][1]
        mod = JA if P is JAX else TA
        rep = mod.analyze_program(
            progs[P.name][0], mesh=TIERED,
            param_specs=_sharding(P).named_param_specs(net, TIERED),
            data_specs={"input_ids": _P(P, ("pod", "dp"))})
        costs[P.name] = [(c.bytes, c.tier, c.cost_us)
                         for c in rep.collectives]
    assert [c[:2] for c in costs["port"]] == [c[:2] for c in costs["jax"]]
    for (b, _, tc), (_, _, jc) in zip(costs["port"], costs["jax"]):
        assert tc == pytest.approx(b / (450.0 * 1e3))
        assert jc == pytest.approx(b / (90.0 * 1e3))


def test_flops_half_unchanged_by_the_rest():
    """analyze_flops stays what PR 17 ported: the same per-op list as
    the JAX package's on GPT."""
    progs = _both("fl", _gpt())
    assert TA.analyze_flops(progs["port"][0]) == \
        JA.analyze_flops(progs["jax"][0])


# ---------------------------------------------------------------------------
# tools/spmd_lint (the counterparts of tests/test_spmd_lint.py)
# ---------------------------------------------------------------------------

def _jlint():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import spmd_lint
    return spmd_lint


def test_spmd_lint_golden_config_is_clean(capsys):
    from paddle_tpu_torch.tools import spmd_lint
    assert spmd_lint.self_check() == []
    assert spmd_lint.main([]) == 0
    out = capsys.readouterr().out
    assert "all_reduce" in out and "diagnostics: none" in out


def test_spmd_lint_report_equals_jax():
    from paddle_tpu_torch.tools import spmd_lint
    t, tprog, _ = spmd_lint.build_report(tp=2, layers=2)
    j, jprog, _ = _jlint().build_report(tp=2, layers=2)
    assert t.render() == j.render()
    assert len([c for c in t.collectives if c.kind == "all_reduce"]) == 5


@pytest.mark.parametrize("inject", ["unbound-axis", "non-divisible",
                                    "duplicate-axis", "spec-rank",
                                    "cross-tier"])
def test_spmd_lint_injection_flags_what_jax_flags(inject, capsys):
    from paddle_tpu_torch.tools import spmd_lint
    assert spmd_lint.INJECTIONS == _jlint().INJECTIONS
    assert spmd_lint.main(["--inject", inject]) == 1
    out = capsys.readouterr().out
    assert inject in out
    t, _, _ = spmd_lint.build_report(inject=inject)
    j, _, _ = _jlint().build_report(inject=inject)
    assert [d.code for d in t.diagnostics] == [d.code for d in j.diagnostics]


def test_spmd_lint_pp_wire_cost(capsys):
    from paddle_tpu_torch.tools import spmd_lint
    assert spmd_lint.main(["--pp", "4", "--micro", "8"]) == 0
    out = capsys.readouterr().out
    assert "ppermute" in out and "11" in out


def test_spmd_lint_inject_nondivisible_leaves_the_program_whole():
    from paddle_tpu_torch.tools import spmd_lint
    report, program, _ = spmd_lint.build_report(inject="non-divisible")
    assert any(d.code == "non-divisible" for d in report.diagnostics)
    report2, program2, _ = spmd_lint.build_report()
    assert report2.diagnostics == []
    assert spmd_lint.self_check() == []
