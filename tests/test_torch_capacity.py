"""Port parity: the analytic capacity model (paddle_tpu_torch/static/
capacity.py) against the JAX package's. The beat simulation, the
closed forms, the knee and the profile round trip are host math over a
seeded schedule: the port's results equal JAX's exactly on the same
spec, seed and profile (the counterparts of tests/test_capacity.py's
deterministic tests). The closed-loop ``--validate`` (a CPU calibration
plus three live replays scored by a hub, ~1-2 min) is marked slow, as
the JAX package's is."""
import json

import pytest

from paddle_tpu.static import capacity as JC
from paddle_tpu.traffic import workload as JW
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.static import capacity as TC
from paddle_tpu_torch.traffic import workload as TW


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _profile(C, **kw):
    d = dict(source="test", beat_ms_base=2.0, beat_ms_per_active=0.5,
             prefill_ms={8: 4.0, 16: 7.0}, admit_ms=1.0,
             admit_serial_ms=0.5, ttft_tail_ms=3.0, token_tail_ms=0.2)
    d.update(kw)
    return C.DeviceProfile(**d)


def _spec(W, rate=40.0, duration_s=2.0, new=6, prompt=6):
    return W.WorkloadSpec(
        name="cap", duration_s=duration_s,
        arrival={"kind": "poisson", "rate": rate},
        tenants=({"name": "t", "weight": 1.0, "kind": "llm",
                  "prompt": {"kind": "fixed", "value": prompt},
                  "new": {"kind": "fixed", "value": new}},),
        max_seq_len=48)


def test_bucket_mirrors_the_serve_pad_ladder():
    ns = (1, 7, 8, 9, 16, 17, 33, 100, 1000)
    assert [TC._bucket(n) for n in ns] == [JC._bucket(n) for n in ns] == \
        [8, 8, 8, 16, 16, 32, 64, 128, 1024]


def test_device_profile_round_trips_and_extrapolates_as_jax():
    t, j = _profile(TC), _profile(JC)
    assert t.as_dict() == j.as_dict()
    q = TC.DeviceProfile.from_dict(json.loads(json.dumps(j.as_dict())))
    assert q.as_dict() == t.as_dict()
    for n in (0, 1, 4, 64):
        assert t.beat_ms(n) == j.beat_ms(n)
    for n in (1, 7, 12, 30, 100):
        assert t.prefill_cost_ms(n) == j.prefill_cost_ms(n)
    assert TC.DeviceProfile("x", 1.0, 0.0).prefill_cost_ms(9) == \
        JC.DeviceProfile("x", 1.0, 0.0).prefill_cost_ms(9)


def test_queueing_closed_forms_equal_jax():
    for args in ((10.0, 1.0, 10), (2.0, 1.0, 8), (6.0, 1.0, 8),
                 (0.5, 2.0, 1)):
        assert TC._erlang_c(*args) == JC._erlang_c(*args)
    for args in ((0.0, 0.1, 1.0, 4), (50.0, 0.1, 1.0, 4),
                 (20.0, 0.1, 1.0, 4), (30.0, 0.1, 1.0, 4),
                 (20.0, 0.1, 3.0, 4)):
        assert TC.queue_wait_ms(*args) == JC.queue_wait_ms(*args)


def test_knee_equals_jax():
    for kw in (dict(slots=8, mean_new=4.0, mean_prompt=8.0),
               dict(slots=8, mean_new=16.0, mean_prompt=8.0),
               dict(slots=16, mean_new=4.0, mean_prompt=30.0)):
        assert TC.knee_rps(_profile(TC), **kw) == \
            JC.knee_rps(_profile(JC), **kw)


@pytest.mark.parametrize("case", ["plain", "backpressure", "preempt"])
def test_simulate_equals_jax(case):
    rate, dur, new, prompt, kw = {
        "plain": (40.0, 2.0, 6, 6, dict(slots=4, kv_blocks=24,
                                        block_size=8)),
        "backpressure": (80.0, 1.0, 6, 6, dict(slots=8, kv_blocks=2,
                                               block_size=8)),
        "preempt": (60.0, 1.0, 14, 6, dict(slots=6, kv_blocks=6,
                                           block_size=8))}[case]
    je = JW.schedule(_spec(JW, rate, dur, new, prompt), seed=3)
    te = TW.schedule(_spec(TW, rate, dur, new, prompt), seed=3)
    assert len(te) == len(je) > 0
    t = TC.simulate(te, _profile(TC), **kw)
    assert t == JC.simulate(je, _profile(JC), **kw)
    assert t["completed"] > 0
    if case == "backpressure":
        assert t["backpressure_ticks"] > 0
    if case == "preempt":
        assert t["preempted"] > 0


@pytest.mark.parametrize("rate", [30.0, 120.0])
def test_predict_equals_jax(rate):
    kw = dict(slots=8, kv_blocks=48, block_size=8)
    t = TC.predict(_spec(TW, rate=rate), 7, _profile(TC), **kw)
    j = JC.predict(_spec(JW, rate=rate), 7, _profile(JC), **kw)
    assert t == j
    assert t["completed"] == t["events"] > 0
    assert t == TC.predict(_spec(TW, rate=rate), 7, _profile(TC), **kw)


def test_publish_wire_ms_prices_the_between_node_tier():
    from paddle_tpu_torch.core import flags
    gbps = flags.flag("FLAGS_topology_dcn_gbps")
    assert TC.publish_wire_ms(1e9, 4) == pytest.approx(4e9 / (gbps * 1e9)
                                                       * 1e3)


@pytest.mark.slow
def test_validate_closed_loop_on_the_cpu(tmp_path):
    """Calibrate a CPU profile, predict the builtin trio, replay each
    through the harness with a live hub, hold every metric to its band,
    and write the section to the evidence path given."""
    from paddle_tpu_torch.tools import capacity_plan
    out = tmp_path / "evidence.json"
    section = capacity_plan.validate(str(out), device="cpu")
    assert section["ok"], json.dumps(section, indent=1)
    assert section["profile"]["source"] == "calibrated-cpu"
    with open(out) as f:
        assert json.load(f)["graphs"]["capacity_validation"]["ok"]
