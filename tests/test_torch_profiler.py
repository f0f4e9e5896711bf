"""Port parity: the profiler (paddle_tpu_torch/profiler), its trace sink
(core/trace.py) and ``hapi`` ``ProfilerCallback``, against
paddle_tpu.profiler on the CPU.

- An eager tiny model under ``profiler()``: the ``op/<name>`` events and
  their counts equal JAX's, op for op. Known difference: the port's
  ``Linear`` is one fused ``addmm`` op where JAX's is ``matmul`` + ``add``.
- ``Model.fit`` with ``ProfilerCallback(start_step=2, stop_step=4)``: the
  window holds 3 ``hapi/train_step`` events in both, reached through the
  trace sink. Known difference: the port runs eagerly, so its ``op/*``
  events repeat every step of the window; JAX's step is one jitted
  program traced before the window, so it records none there.
- The table's layout, the Chrome export, ``RecordEvent`` off and on, the
  flag and the op layer's switch, and the device capture on the CPU.
"""
import collections
import json

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import profiler as jprof
from paddle_tpu.distributed import mesh as JM
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.core import trace as ttrace
from paddle_tpu_torch.ops import _dispatch
from test_torch_jax_mesh import keeps_default_mesh


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


def _counts(prof):
    return collections.Counter(e[0] for e in prof.events())


def _data():
    rng = np.random.RandomState(0)
    return (rng.randn(4, 8).astype("float32"),
            rng.randn(8, 16).astype("float32"),
            rng.randn(16).astype("float32"),
            rng.randn(4, 16).astype("float32"))


def _functional_run(P, prof):
    """Three eager steps of paddle functions only."""
    x, w, b, y = (P.to_tensor(a) for a in _data())
    with prof.profiler(sorted_key=None):
        for _ in range(3):
            h = P.tanh(P.add(P.matmul(x, w), b))
            loss = P.mean(P.pow(P.subtract(h, y), 2.0))
            P.exp(P.multiply(loss, 0.5))
    return _counts(prof)


def test_op_events_and_counts_equal_jax():
    t, j = _functional_run(tp, tprof), _functional_run(jp, jprof)
    assert t == j
    assert t["op/matmul"] == 3 and len(t) == 8


def _linear_run(P, prof):
    P.seed(0)
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 2))
    x = P.to_tensor(_data()[0])
    with prof.profiler(sorted_key=None):
        for _ in range(2):
            net(x).mean()
    return _counts(prof)


def test_known_difference_linear_is_one_addmm_event():
    t, j = _linear_run(tp, tprof), _linear_run(jp, jprof)
    assert t["op/addmm"] == j["op/matmul"] == j["op/add"] == 4
    rest = {k: v for k, v in t.items() if k != "op/addmm"}
    assert rest == {k: v for k, v in j.items()
                    if k not in ("op/matmul", "op/add")}


@keeps_default_mesh
def _fit(P, prof, window):
    """Model.fit of an MLP with the callback; JAX's under no device mesh
    (a mesh left by an earlier file would partition its step), the meshes
    found put back after."""
    if P is jp:
        JM.reset_mesh()
    P.seed(0)
    net = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 2))
    model = P.Model(net)
    model.prepare(P.optimizer.SGD(learning_rate=0.1,
                                  parameters=net.parameters()),
                  P.nn.CrossEntropyLoss())
    rng = np.random.RandomState(1)
    x = rng.randn(24, 8).astype("float32")
    y = rng.randint(0, 2, (24, 1)).astype("int64")
    cb = P.callbacks.ProfilerCallback(*window)
    model.fit(list(zip(x, y)), batch_size=4, epochs=1, verbose=0,
              shuffle=False, callbacks=[cb])
    assert not prof.is_profiler_enabled()
    return _counts(prof)


def test_profiler_callback_counts_train_steps_as_jax(capsys):
    t, j = _fit(tp, tprof, (2, 4)), _fit(jp, jprof, (2, 4))
    assert t["hapi/train_step"] == j["hapi/train_step"] == 3
    assert "hapi/train_step" in capsys.readouterr().out
    # known difference: eager op events repeat each step of the window
    assert not [k for k in j if k.startswith("op/")]
    ops = {k: v for k, v in t.items() if k.startswith("op/")}
    assert ops and all(v % 3 == 0 for v in ops.values())


def test_summary_table_and_chrome_export(tmp_path):
    _functional_run(tp, tprof)
    t = tprof.summary("calls").splitlines()
    _functional_run(jp, jprof)
    j = jprof.summary("calls").splitlines()
    assert t[0].split() == j[0].split() == [
        "Event", "Calls", "Total(ms)", "Avg(ms)", "Min(ms)", "Max(ms)",
        "Ratio"]
    assert sorted((r.split()[0], r.split()[1]) for r in t[1:]) == \
        sorted((r.split()[0], r.split()[1]) for r in j[1:])
    path = tmp_path / "host.json"
    tprof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    assert len(ev) == 24 and {e["ph"] for e in ev} == {"X"}
    tprof.reset_profiler()
    assert tprof.summary() == "(no profiler events)"


def test_trace_sink_record_event_and_switches():
    tprof.reset_profiler()
    with ttrace.span("outside/off"):
        pass
    with tprof.RecordEvent("ignored"):
        tp.add(tp.ones([2]), tp.ones([2]))
    assert tprof.events() == []
    assert not _dispatch._profiling
    assert not tp.get_flags("FLAGS_enable_profiler")[
        "FLAGS_enable_profiler"]
    tprof.start_profiler()
    try:
        assert _dispatch._profiling and tprof.is_profiler_enabled()
        assert tp.get_flags("FLAGS_enable_profiler")["FLAGS_enable_profiler"]
        with ttrace.span("sink/step"):
            ev = tprof.RecordEvent("user/region").begin()
            tp.add(tp.ones([2]), tp.ones([2]))
            ev.end()
    finally:
        tprof.stop_profiler()
    names = [e[0] for e in tprof.events()]
    assert sorted(names) == ["op/add", "sink/step", "user/region"]
    assert not _dispatch._profiling
    # a span's parent is the ambient one; RecordEvent's spans are detached
    sp = [s for s in ttrace.recent(5) if s.name == "user/region"][-1]
    outer = [s for s in ttrace.recent(5) if s.name == "sink/step"][-1]
    assert sp.parent_id == outer.span_id


def test_op_that_raises_records_no_event_as_jax():
    def run(P, prof):
        with prof.profiler(sorted_key=None):
            with pytest.raises(Exception):
                P.matmul(P.ones([2, 3]), P.ones([2, 3]))
        return [e[0] for e in prof.events()]
    assert run(tp, tprof) == run(jp, jprof) == []


def test_device_trace_on_the_cpu(tmp_path):
    with tprof.xplane_trace(str(tmp_path / "ctx")):
        tp.matmul(tp.ones([8, 8]), tp.ones([8, 8]))
    assert len(list((tmp_path / "ctx").iterdir())) == 1
    tprof.start_xplane(str(tmp_path / "dev"))
    tp.matmul(tp.ones([8, 8]), tp.ones([8, 8]))
    path = tprof.stop_xplane()
    assert path.startswith(str(tmp_path / "dev"))
    assert tprof.stop_xplane() is None
    events = json.loads(open(path).read())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with pytest.raises(RuntimeError, match="already running"):
        tprof.start_xplane(str(tmp_path))
        tprof.start_xplane(str(tmp_path))
    tprof.stop_xplane()


def test_device_trace_warm_up_keeps_only_what_follows_the_step(tmp_path):
    tprof.start_xplane(str(tmp_path), warmup=True)
    tp.matmul(tp.ones([8, 8]), tp.ones([8, 8]))       # warm-up: not kept
    tprof.step_xplane()
    tp.add(tp.ones([8]), tp.ones([8]))
    path = tprof.stop_xplane()
    names = [e.get("name", "") for e in
             json.loads(open(path).read())["traceEvents"]]
    assert "aten::add" in names
    assert not [n for n in names if "mm" in n or "matmul" in n]
    with pytest.raises(RuntimeError, match="warming"):
        tprof.step_xplane()
    tprof.start_xplane(str(tmp_path), warmup=True)
    assert tprof.stop_xplane() is None      # a warm-up alone keeps nothing


def test_profiler_callback_device_trace_holds_the_window(tmp_path):
    """Window 2-4 of six steps: step 1 warms the trace up, and the trace
    holds the window's three steps: one ReLU forward each."""
    tp.seed(0)
    net = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.ReLU(),
                           tp.nn.Linear(16, 2))
    model = tp.Model(net)
    model.prepare(tp.optimizer.SGD(learning_rate=0.1,
                                   parameters=net.parameters()),
                  tp.nn.CrossEntropyLoss())
    rng = np.random.RandomState(1)
    x = rng.randn(24, 8).astype("float32")
    y = rng.randint(0, 2, (24, 1)).astype("int64")
    cb = tp.callbacks.ProfilerCallback(2, 4, xplane_dir=str(tmp_path))
    model.fit(list(zip(x, y)), batch_size=4, epochs=1, verbose=0,
              shuffle=False, callbacks=[cb])
    names = [e.get("name", "") for e in
             json.loads(open(cb.trace_path).read())["traceEvents"]]
    assert names.count("aten::relu") == 3
    assert tprof._device["prof"] is None


def test_cost_analysis_counts_as_xla_on_a_product():
    import jax
    import jax.numpy as jnp
    a = np.random.RandomState(0).randn(16, 32).astype("float32")
    b = np.random.RandomState(1).randn(32, 8).astype("float32")
    j = jprof.cost_analysis(jax.jit(lambda x, y: jnp.tanh(x @ y) + 1.0),
                            jnp.asarray(a), jnp.asarray(b))
    t = tprof.cost_analysis(lambda x, y: tp.tanh(tp.matmul(x, y)) + 1.0,
                            tp.to_tensor(a), tp.to_tensor(b))
    assert t["flops matmul"] == 2 * 16 * 32 * 8
    # XLA: the product, tanh as a transcendental (not a FLOP), the add
    assert t["flops"] == j["flops"] == 2 * 16 * 32 * 8 + 16 * 8
    assert t["bytes accessed"] > 0
