"""Port parity: the async pipelined loop (paddle_tpu_torch/static/
pipeline_runner.py) against paddle_tpu/static/pipeline_runner.py.

- tests/test_pipeline_runner.py's bitwise cases on the port: the
  PipelineRunner in flight (1, 2, 4) and scan-fused (K 2, 3, 4) equals
  the serial ``Executor.run`` loop bitwise in fetches, parameters, the
  optimizer's slots and the f16 loss-scaling state;
- a one-layer static BERT (dropout 0.1, weights copied from JAX's by
  module path): the port's runner in flight 0 / 2 and scan K 2 / 4 is
  bitwise equal to the port's serial loop, and its losses equal JAX's
  ``PipelineRunner`` on JAX's program (f32, rtol 1e-5, dropout 0 there);
- a failing step names its index, as JAX's runner does, and a failing
  megastep its first and last step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.static import executor as texecutor
from paddle_tpu_torch.static.pipeline_runner import (
    PipelineRunner, PipelineStepError, StagedPipelineRunner)
from paddle_tpu_torch.text.models import bert as tbert

from paddle_tpu_torch.bridge import load_jax_static_params
from test_torch_static_cases import (JAX, PKGS, PORT, jax_static_params,
                                     static_mode, to_np)

B, S = 4, 16


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _mlp(P, name, amp=False):
    """tests/test_pipeline_runner.py's program: a 2-layer MLP, mse, Adam;
    optionally f16 O1 with dynamic loss scaling."""
    with static_mode(P) as static:
        P.paddle.seed(0)
        prog = static.Program(name)
        with static.program_guard(prog):
            x = static.data("x", [-1, 4], "float32")
            y = static.data("y", [-1, 1], "float32")
            h = P.ops.relu(P.nn.Linear(4, 8)(x))
            loss = P.ops.mse_loss(P.nn.Linear(8, 1)(h), y)
            opt = P.optimizer.Adam(learning_rate=0.05)
            if amp:
                opt = static.amp.decorate(opt, level="O1", dtype="float16",
                                          init_loss_scaling=2.0 ** 8,
                                          incr_every_n_steps=3)
            opt.minimize(loss)
    return prog, loss, opt


def _mlp_feeds(n, batch=8, shape_break=None):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        b = batch if shape_break is None or i < shape_break else batch // 2
        out.append({"x": rng.rand(b, 4).astype("float32"),
                    "y": rng.rand(b, 1).astype("float32")})
    return out


def _state(P, prog, opt):
    scope = P.static.global_scope()
    params = [to_np(scope.get(n)) for n in prog.persist_ids]
    slots = [to_np(v) for _, s in opt._slots.items()
             for _, v in sorted(s.items())]
    amp = {k.split("@")[0]: to_np(scope.get(k)) for k in scope.var_names()
           if "@" in k and k.rsplit("#", 1)[-1] == str(prog.uid)}
    return params, slots, amp


def _run(P, prog, loss, opt, feeds, inflight=None, scan=0, seed=123):
    exe = P.static.Executor()
    P.paddle.seed(seed)
    if inflight is None:
        vals = [to_np(exe.run(prog, feed=f, fetch_list=[loss])[0])
                for f in feeds]
    else:
        runner = PKGS[P.name].static.PipelineRunner
        with runner(exe, prog, fetch_list=[loss], max_inflight=inflight,
                    scan_steps=scan) as r:
            handles = [h[0] for h in r.run(iter(feeds))]
            vals = [np.asarray(h) for h in handles]
    return vals, _state(P, prog, opt)


def _bitwise(a, b, what):
    (va, (pa, sa, aa)), (vb, (pb, sb, ab)) = a, b
    assert len(va) == len(vb)
    for i, (x, y) in enumerate(zip(va, vb)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: fetch {i}")
    assert len(pa) == len(pb) > 0 and len(sa) == len(sb) > 0
    for i, (x, y) in enumerate(zip(pa + sa, pb + sb)):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: state {i}")
    assert sorted(aa) == sorted(ab)
    for k in aa:
        np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{what}: {k}")


MODES = [(1, 0), (2, 0), (4, 0), (2, 2), (2, 3), (2, 4)]


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "f16_dynamic"])
@pytest.mark.parametrize("inflight,scan", MODES,
                         ids=[f"inflight{i}_scan{k}" for i, k in MODES])
def test_runner_bitwise_equals_serial(inflight, scan, amp):
    feeds = _mlp_feeds(7)   # 7 steps at K 3: 2 megasteps + 1 unfused
    serial = _run(PORT, *_mlp(PORT, "serial", amp), feeds)
    before = tmonitor.stat_get("executor/scan_megasteps")
    pipe = _run(PORT, *_mlp(PORT, f"pipe{inflight}{scan}", amp), feeds,
                inflight=inflight, scan=scan)
    _bitwise(serial, pipe, f"inflight={inflight} scan={scan} amp={amp}")
    if scan:
        assert tmonitor.stat_get("executor/scan_megasteps") - before \
            == 7 // scan
    if amp:
        assert serial[1][2], "no loss-scaling state in the scope"


def test_mlp_runner_losses_equal_jax_runner():
    """The same program in both packages (JAX's weights copied), through
    each package's PipelineRunner with scan K 2: f32 losses to 1e-5."""
    feeds = _mlp_feeds(6)
    got = {P.name: _mlp(P, "parity") for P in (JAX, PORT)}
    scope_j, scope_t = JAX.static.global_scope(), PORT.static.global_scope()
    for nj, nt in zip(got["jax"][0].persist_ids, got["port"][0].persist_ids):
        scope_t.get(nt).copy_(torch.from_numpy(to_np(scope_j.get(nj))
                                               .copy()))
    vals = {k: _run(PKGS[k], *v, feeds, inflight=2, scan=2)[0]
            for k, v in got.items()}
    np.testing.assert_allclose(np.asarray(vals["port"]).ravel(),
                               np.asarray(vals["jax"]).ravel(), rtol=1e-5)


def test_scan_handles_shape_change_unfused():
    feeds = _mlp_feeds(6, shape_break=3)
    serial = _run(PORT, *_mlp(PORT, "s_shape"), feeds)
    pipe = _run(PORT, *_mlp(PORT, "p_shape"), feeds, inflight=2, scan=2)
    _bitwise(serial, pipe, "shape break")


# -- a one-layer static BERT ------------------------------------------------

def _bert(P, dropout):
    m = jbert if P is JAX else tbert
    cfg = m.BertConfig.tiny()
    cfg.num_hidden_layers = 1
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    with static_mode(P) as static:
        main = static.Program("bert_runner")
        with static.program_guard(main, static.Program()):
            P.paddle.seed(0)
            ids = static.data("ids", [B, S], "int64")
            lab = static.data("labels", [B, S], "int64")
            net = m.Bert(cfg)
            loss = net(ids, masked_lm_labels=lab)
            opt = P.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                    parameters=net.parameters())
            opt.minimize(loss)
    return main, net, loss, opt, cfg


def _bert_feeds(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randint(4, vocab, (B, S)).astype("int64")
        y = np.where(rng.rand(B, S) < 0.15, x, -100).astype("int64")
        y[0, 0] = x[0, 0]
        out.append({"ids": x, "labels": y})
    return out


BERT_MODES = [(None, 0), (2, 0), (2, 2), (2, 4)]


def test_tiny_bert_runner_modes_bitwise_and_equal_to_jax():
    jmain, jnet, jloss, jopt, cfg = _bert(JAX, 0.0)
    weights = jax_static_params(jnet)      # before JAX trains them
    feeds = _bert_feeds(cfg.vocab_size, 8)
    tmain, tnet, tloss, topt, _ = _bert(PORT, 0.0)
    load_jax_static_params(tnet, *weights)
    # JAX's runner on JAX's program and the port's on the port's, dropout 0
    jvals, _ = _run(JAX, jmain, jloss, jopt, feeds, inflight=2, scan=2)
    tvals, _ = _run(PORT, tmain, tloss, topt, feeds, inflight=2, scan=2)
    np.testing.assert_allclose(np.ravel(tvals), np.ravel(jvals), rtol=1e-5)
    # the port's modes with dropout on, from the same weights
    runs = {}
    for inflight, scan in BERT_MODES:
        main, net, loss, opt, _ = _bert(PORT, 0.1)
        load_jax_static_params(net, *weights)
        runs[(inflight, scan)] = _run(PORT, main, loss, opt, feeds,
                                      inflight=inflight, scan=scan)
    for mode, res in runs.items():
        _bitwise(runs[(None, 0)], res, f"bert {mode}")


# -- failures ----------------------------------------------------------------

def _bomb(monkeypatch, at):
    """Make the ``at``-th replay after the patch raise."""
    orig = texecutor.Executor._step
    calls = {"n": 0}

    def step(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == at:
            raise RuntimeError("injected chaos")
        return orig(self, *a, **k)
    monkeypatch.setattr(texecutor.Executor, "_step", step)


def _jax_failing_run():
    """JAX's runner with its third dispatch failing: the error raised."""
    prog, loss, _ = _mlp(JAX, "chaos_jax")
    runner = JAX.static.PipelineRunner(JAX.static.Executor(), prog,
                                       fetch_list=[loss], max_inflight=4)
    feeds = _mlp_feeds(4)
    runner.submit(feeds[0])
    entry = runner._entry
    orig, calls = entry.jitted, {"n": 0}

    def bomb(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected chaos")
        return orig(*a, **k)
    entry.jitted = bomb
    try:
        for f in feeds[1:]:
            runner.submit(f)
        with pytest.raises(jp.static.PipelineStepError) as ei:
            runner.sync()
    finally:
        entry.jitted = orig
    return ei.value


def test_failing_step_names_its_index_as_jax(monkeypatch):
    jerr = _jax_failing_run()
    prog, loss, _ = _mlp(PORT, "chaos")
    runner = PipelineRunner(PORT.static.Executor(), prog, fetch_list=[loss],
                            max_inflight=4)
    feeds = _mlp_feeds(4)
    h0 = runner.submit(feeds[0])[0]
    _bomb(monkeypatch, 2)
    h1 = runner.submit(feeds[1])[0]
    h2 = runner.submit(feeds[2])[0]   # fails in flight, not raised here
    h3 = runner.submit(feeds[3])[0]   # the pipeline is broken: skipped
    assert float(h0) > 0 and float(h1) > 0
    with pytest.raises(PipelineStepError, match="step 2"):
        h2.numpy()
    with pytest.raises(PipelineStepError, match="step 2"):
        h3.numpy()
    with pytest.raises(PipelineStepError) as ei:
        runner.sync()
    assert ei.value.step_index == jerr.step_index == 2
    assert ei.value.last_index == jerr.last_index == 2
    assert str(ei.value) == str(jerr)


def test_failing_megastep_names_its_steps(monkeypatch):
    prog, loss, _ = _mlp(PORT, "chaos_scan")
    feeds = _mlp_feeds(6)
    _bomb(monkeypatch, 4)     # the second megastep's second replay
    with pytest.raises(PipelineStepError,
                       match=r"scan-fused steps 2\.\.3 failed") as ei:
        with PipelineRunner(PORT.static.Executor(), prog, fetch_list=[loss],
                            max_inflight=2, scan_steps=2) as r:
            for handles in r.run(iter(feeds)):
                handles[0].numpy()
    assert (ei.value.step_index, ei.value.last_index) == (2, 3)


def test_return_handles_and_gauges():
    prog, loss, _ = _mlp(PORT, "handles")
    exe = PORT.static.Executor()
    feeds = _mlp_feeds(3)
    (h,) = exe.run(prog, feed=feeds[0], fetch_list=[loss],
                   return_handles=True)
    assert np.isfinite(float(h)) and h.step_index >= 0
    with PipelineRunner(exe, prog, fetch_list=[loss], max_inflight=2) as r:
        for _ in r.run(iter(feeds)):
            pass
    stats = tmonitor.stats("executor/")
    for k in ("executor/step_wall_ms", "executor/host_overhead_ms",
              "executor/inflight_depth"):
        assert k in stats, k
    assert stats["executor/inflight_depth"] >= 1


def test_train_from_dataset_scan_via_exec_strategy():
    """train_from_dataset through a CompiledProgram's exec_strategy (the
    runner at K 2) leaves the scope where the serial loop leaves it."""
    class DS:
        def __init__(self, feeds):
            self.feeds = feeds

        def batches(self, start_batch=0):
            return iter(self.feeds[start_batch:])

    feeds = _mlp_feeds(6)
    serial = _run(PORT, *_mlp(PORT, "tfd_serial"), feeds)
    prog, loss, opt = _mlp(PORT, "tfd")
    es = PORT.static.ExecutionStrategy()
    es.max_inflight, es.scan_fuse_steps = 2, 2
    cp = PORT.static.CompiledProgram(prog, exec_strategy=es)
    PORT.paddle.seed(123)
    before = tmonitor.stat_get("executor/scan_megasteps")
    PORT.static.Executor().train_from_dataset(cp, DS(feeds),
                                              fetch_list=[loss])
    assert tmonitor.stat_get("executor/scan_megasteps") - before == 3
    p_s, s_s, _ = serial[1]
    p_t, s_t, _ = _state(PORT, prog, opt)
    for a, b in zip(p_s + s_s, p_t + s_t):
        np.testing.assert_array_equal(a, b)


def test_staged_runner_and_stage_plan_raise_naming_item_7():
    """Item 7 is ported (tests/test_torch_spmd_planner.py): the staged
    runner refuses a mesh without the plan's pp axis, and the runner
    takes a stage plan and names it on its gauge."""
    from paddle_tpu_torch.core import monitor as tmonitor
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.static.spmd_planner import plan_pipeline
    prog, loss, _ = _mlp(PORT, "staged")
    plan = plan_pipeline(prog, {"pp": 2}, num_micro=2)
    with pytest.raises(ValueError, match="'pp' axis"):
        StagedPipelineRunner(plan, None, [], None,
                             mesh=tmesh.Mesh({"dp": 1}))
    runner = PipelineRunner(PORT.static.Executor(), prog, fetch_list=[loss],
                            stage_plan=plan)
    assert runner.stage_plan is plan
    assert tmonitor.stat_get("executor/pipeline_stages") == 2
