"""Port parity: the flight recorder (paddle_tpu_torch/core/
flight_recorder.py) against paddle_tpu/core/flight_recorder.py.

The JAX suite's unit cases run on both packages (a dump's keys are the
shared ``SCHEMA_KEYS``, the per-reason rate limit, the per-thread
suppression, the emergency hooks), a ``PipelineStepError`` of the port's
runner leaves a dump naming the failing step, and a SIGUSR1 to a process
that imported the port with ``PADDLE_TPU_DUMP_DIR`` set dumps and lives.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import paddle_tpu.core.flight_recorder as jfr
import paddle_tpu.core.monitor as jmonitor
import paddle_tpu.core.trace as jtrace
import paddle_tpu_torch.core.flight_recorder as tfr
import paddle_tpu_torch.core.monitor as tmonitor
import paddle_tpu_torch.core.trace as ttrace
from paddle_tpu_torch.device import device_scope

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = {"jax": types.SimpleNamespace(fr=jfr, monitor=jmonitor, trace=jtrace),
      "port": types.SimpleNamespace(fr=tfr, monitor=tmonitor, trace=ttrace)}


@pytest.fixture(params=list(NS))
def R(request):
    ns = NS[request.param]
    ns.fr._dumped.clear()
    ns.trace.reset()
    yield ns
    ns.fr._dumped.clear()


@pytest.fixture()
def dump_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "dumps")
    monkeypatch.setenv("PADDLE_TPU_DUMP_DIR", d)
    return d


def _dumps(d, reason=None):
    if not os.path.isdir(d):
        return []
    names = sorted(n for n in os.listdir(d)
                   if reason is None or f"_{reason}_" in n)
    return [os.path.join(d, n) for n in names]


def test_schema_keys_and_version_equal_jax():
    assert tfr.SCHEMA_KEYS == jfr.SCHEMA_KEYS
    assert tfr.SCHEMA_VERSION == jfr.SCHEMA_VERSION
    assert tfr.MAX_DUMPS_PER_REASON == jfr.MAX_DUMPS_PER_REASON


def test_dump_noop_without_env(R, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DUMP_DIR", raising=False)
    assert not R.fr.enabled()
    assert R.fr.dump("whatever", ValueError("x")) is None


def test_dump_schema_and_rate_limit(R, dump_dir):
    R.trace.instant("marker", step=7)
    R.monitor.stat_add("tm.fr.counter", 3)
    paths = [R.fr.dump("unit", ValueError("boom"), extra={"k": 1})
             for _ in range(R.fr.MAX_DUMPS_PER_REASON + 2)]
    written = [p for p in paths if p]
    assert len(written) == R.fr.MAX_DUMPS_PER_REASON
    rec = json.load(open(written[0]))
    assert tuple(rec.keys()) == R.fr.SCHEMA_KEYS
    assert rec["reason"] == "unit" and rec["extra"] == {"k": 1}
    assert rec["exception"]["type"] == "ValueError"
    assert any(s["name"] == "marker" and s["attrs"].get("step") == 7
               for s in rec["spans"])
    assert rec["metrics"]["values"]["tm.fr.counter"] == 3
    assert "FLAGS_executor_max_inflight" in rec["flags"]
    R.monitor.reset(prefix="tm.fr.")


def test_suppressed_scope_and_emergency_hooks(R, dump_dir):
    with R.fr.suppressed("quiet"):
        assert R.fr.dump("quiet") is None
        assert R.fr.dump("other") is not None
    assert R.fr.dump("quiet") is not None
    fired = []
    h = R.fr.register_emergency_hook(lambda r, e: fired.append(r),
                                     reasons=("pipeline_step_error",))
    try:
        R.fr.dump("pipeline_step_error", RuntimeError("x"))
        R.fr.dump("unrelated")
    finally:
        R.fr.unregister_emergency_hook(h)
    assert fired == ["pipeline_step_error"]


def test_pipeline_step_error_dumps_naming_the_step(dump_dir, monkeypatch):
    from paddle_tpu_torch.static import executor as texecutor
    from paddle_tpu_torch.static.pipeline_runner import (PipelineRunner,
                                                         PipelineStepError)
    from test_torch_static_cases import PORT, static_mode
    tfr._dumped.clear()
    with device_scope("cpu"):
        with static_mode(PORT) as static:
            prog = static.Program("fr")
            with static.program_guard(prog, static.Program()):
                x = static.data("x", [2, 4], "float32")
                loss = PORT.ops.mean(PORT.nn.Linear(4, 1)(x))
                PORT.optimizer.SGD(learning_rate=0.1).minimize(loss)
        orig, calls = texecutor.Executor._step, {"n": 0}

        def step(self, *a, **k):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("planted")
            return orig(self, *a, **k)
        monkeypatch.setattr(texecutor.Executor, "_step", step)
        feeds = [{"x": np.ones((2, 4), "float32")}] * 4
        with pytest.raises(PipelineStepError, match="step 2"):
            with PipelineRunner(static.Executor(), prog, fetch_list=[loss],
                                max_inflight=2) as r:
                for h in r.run(iter(feeds)):
                    pass
    (path,) = _dumps(dump_dir, "pipeline_step_error")
    rec = json.load(open(path))
    assert rec["extra"] == {"step_index": 2, "last_index": 2}
    assert rec["exception"]["message"] == "planted"
    assert any(s["name"] == "pipeline/dispatch" for s in rec["spans"])


def test_signal_dump_in_subprocess(tmp_path):
    d = str(tmp_path / "sigdumps")
    code = ("import os, signal, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import paddle_tpu_torch\n"
            "os.kill(os.getpid(), signal.SIGUSR1)\n"
            "print('alive')\n")
    env = dict(os.environ, PADDLE_TPU_DUMP_DIR=d)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "alive" in out.stdout
    (path,) = _dumps(d, "signal_SIGUSR1")
    assert json.load(open(path))["reason"] == "signal_SIGUSR1"
