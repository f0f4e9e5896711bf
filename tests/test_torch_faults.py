"""Port parity: fault injection (paddle_tpu_torch/testing/faults.py and
the seam distributed/ps/rpc._fault) against paddle_tpu/testing/faults.py,
and the serve loop's scheduler-beat seam (inference/serving.py).

- One script of events through a JAX and a port injector built from the
  same scripted rules and seed gives the same ``log`` (scripted rules
  first, then the seeded sha256 draws).
- At ("serve", "beat"): a STALL delays one beat and a RESET is absorbed;
  either way the serve completes with the fault-free run's tokens, as the
  JAX ServeLoop does on the same weights.
"""
import time

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.distributed.ps import rpc as jrpc
from paddle_tpu.inference import ServeConfig as JServeConfig
from paddle_tpu.inference import ServeLoop as JServeLoop
from paddle_tpu.testing import faults as jfaults
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.distributed.ps import rpc as trpc
from paddle_tpu_torch.inference import ServeConfig, ServeLoop
from paddle_tpu_torch.testing import faults as tfaults
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig

PKGS = {"jax": (jfaults, jrpc), "port": (tfaults, trpc)}


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def _rules(F):
    return [F.Fault("client", "send", F.RESET, method="push", after=1),
            F.Fault("server", "reply", F.DROP, method="pull", times=2),
            F.Fault("serve", "beat", F.STALL, method="tick", after=2,
                    delay=0.0),
            F.Fault("client", "dial", F.PARTITION, method="h:1", times=3),
            F.Fault("client", "send", F.STALL, endpoint="h:2", times=2,
                    delay=0.0),
            F.backlog_burst("s0", after=1, times=1, delay=0.0)]


# side, event, method, endpoint: a script of boundary events
EVENTS = ([("client", "send", "push", None)] * 3
          + [("server", "reply", "pull", None)] * 3
          + [("serve", "beat", "tick", None)] * 4
          + [("client", "dial", "h:1", None)] * 4
          + [("client", "send", "get", "h:2")] * 3
          + [("stream", "deliver", "s0", None)] * 3
          + [("client", "recv", m, None) for m in ("a", "b", "c", "d")] * 6
          + [("server", "reply", m, None) for m in ("a", "b")] * 6
          + [("client", "dial", "h:9", None)] * 5
          + [("client", "send", "__ping__", None)] * 3)


def _drive(F, rpc, inj):
    """Every EVENT through the seam with ``inj`` installed: what each
    returned or raised, and the injector's log."""
    seen = []
    F.install(inj)
    try:
        for side, event, method, endpoint in EVENTS:
            try:
                seen.append(rpc._fault(side, event, method, endpoint))
            except (ConnectionResetError, ConnectionRefusedError) as e:
                seen.append(type(e).__name__)
    finally:
        F.uninstall()
    assert rpc._fault_injector is None
    return seen, list(inj.log)


def test_scripted_and_seeded_draws_equal_jax():
    out = {}
    for name, (F, rpc) in PKGS.items():
        inj = F.FaultInjector(_rules(F), seed="chaos-7",
                              p={F.RESET: 0.2, F.DROP: 0.1,
                                 F.GARBLE: 0.05, F.PARTITION: 0.3},
                              stall_delay=0.0)
        out[name] = (*_drive(F, rpc, inj), inj.fired(),
                     inj.fired(F.RESET))
    assert out["port"] == out["jax"]
    seen, log, fired, resets = out["port"]
    assert fired == len(log) > 10 and resets > 0
    assert "ConnectionRefusedError" in seen and "garble" in seen


def test_seeded_draws_repeat_and_change_with_the_seed(pkg):
    F, rpc = pkg
    logs = []
    for seed in (3, 3, 4):
        inj = F.FaultInjector(seed=seed, p={F.RESET: 0.3, F.DROP: 0.3},
                              stall_delay=0.0)
        logs.append(_drive(F, rpc, inj))
    assert logs[0] == logs[1] != logs[2]


def test_rule_validation(pkg):
    F, _ = pkg
    with pytest.raises(ValueError):
        F.Fault("client", "send", F.DROP)       # reply-only action
    with pytest.raises(ValueError):
        F.Fault("client", "send", F.PARTITION)  # dial-only action
    with pytest.raises(ValueError):
        F.Fault("server", "reply", F.STALL, endpoint="h:1")
    with pytest.raises(ValueError):
        F.FaultInjector(p={"melt": 0.5})
    f = F.backlog_burst("s", after=2, times=3, delay=0.5)
    assert (f.side, f.event, f.action, f.method, f.after, f.times,
            f.delay) == ("stream", "deliver", F.STALL, "s", 2, 3, 0.5)


def test_inject_installs_and_uninstalls(pkg):
    F, rpc = pkg
    with F.inject(F.Fault("serve", "beat", F.RESET)) as inj:
        assert rpc._fault_injector is inj
        with pytest.raises(ConnectionResetError):
            rpc._fault("serve", "beat", "tick")
        assert rpc._fault("serve", "beat", "tick") is None  # spent
    assert rpc._fault_injector is None
    assert rpc._fault("serve", "beat", "tick") is None
    assert inj.log == [("serve", "beat", "tick", F.RESET)]


@pytest.fixture(scope="module")
def nets():
    jpaddle.seed(0)
    jnet = JGPT(JGPTConfig.tiny())
    jnet.eval()
    with tdevice.device_scope("cpu"):
        tnet = GPT(GPTConfig.tiny(), device="cpu")
    tnet.eval()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    return jnet, tnet


PROMPTS = [np.random.RandomState(4).randint(1, 1024, (n,)).astype(np.int64)
           for n in (5, 9, 3, 12)]
CFG = dict(max_active=2, kv_blocks=32, block_size=16, max_seq_len=64)


def _serve(loop_cls, cfg_cls, net):
    loop = loop_cls(net, cfg_cls(**CFG))
    return [np.asarray(o) for o in loop.serve(PROMPTS, max_new_tokens=6)]


def test_beat_stall_delays_one_beat_and_keeps_the_tokens(nets,
                                                        monkeypatch):
    jnet, tnet = nets
    clean = _serve(ServeLoop, ServeConfig, tnet)
    stall = 0.2
    beats, slept = [], []
    real_sleep = time.sleep

    def sleep(s):
        slept.append((len(beats), s))
        real_sleep(s)

    monkeypatch.setattr(tfaults.time, "sleep", sleep)
    with tfaults.inject(tfaults.Fault("serve", "beat", tfaults.STALL,
                                      after=3, delay=stall)) as inj:
        loop = ServeLoop(tnet, ServeConfig(**CFG))
        reqs = [loop.submit(p, max_new_tokens=6) for p in PROMPTS]
        while loop._has_work():
            t0 = time.perf_counter()
            loop._tick()
            beats.append(time.perf_counter() - t0)
        loop._drain()
    monkeypatch.undo()
    assert inj.log == [("serve", "beat", "tick", tfaults.STALL)]
    # one sleep, in the fourth beat, which waited it out
    assert slept == [(3, stall)]
    assert beats[3] >= stall
    got = [r.result(timeout=0) for r in reqs]
    for a, b in zip(got, clean):
        np.testing.assert_array_equal(a, b)
    # the JAX loop under the same rule: the same log and tokens
    with jfaults.inject(jfaults.Fault("serve", "beat", jfaults.STALL,
                                      after=3, delay=stall)) as jinj:
        jgot = _serve(JServeLoop, JServeConfig, jnet)
    assert jinj.log == inj.log
    for a, b in zip(got, jgot):
        np.testing.assert_array_equal(a, b)


def test_beat_reset_is_absorbed(nets):
    jnet, tnet = nets
    clean = _serve(ServeLoop, ServeConfig, tnet)
    rule = dict(after=1, times=3)
    with tfaults.inject(tfaults.Fault("serve", "beat", tfaults.RESET,
                                      **rule)) as inj:
        got = _serve(ServeLoop, ServeConfig, tnet)
    with jfaults.inject(jfaults.Fault("serve", "beat", jfaults.RESET,
                                      **rule)) as jinj:
        jgot = _serve(JServeLoop, JServeConfig, jnet)
    assert inj.log == jinj.log == [("serve", "beat", "tick",
                                    tfaults.RESET)] * 3
    for a, b, c in zip(got, clean, jgot):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
