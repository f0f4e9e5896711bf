"""Port parity: the traffic lab (paddle_tpu_torch/traffic) against
paddle_tpu/traffic.

- Schedules: ``schedule_digest`` equals JAX's for every builtin spec at
  seeds 0, 1 and 7, and tests/test_traffic.py's generator cases run on
  both packages (the ``W`` fixture).
- The closed loop: ``run_spec`` of the steady spec through the port's
  tiny loop, with the JAX tiny loop's weights copied in, gives JAX's
  ``completed`` and ``outputs_digest`` (greedy, f32, CPU).
- The harness cases of tests/test_traffic.py on the port: same-seed
  replay, the flash crowd, the serve-cap check, submit errors.
"""
import json
import threading

import numpy as np
import pytest

from paddle_tpu.traffic import harness as jharness
from paddle_tpu.traffic import workload as jworkload
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.traffic import harness
from paddle_tpu_torch.traffic import workload as tworkload

PKGS = {"jax": jworkload, "port": tworkload}


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture(params=list(PKGS))
def W(request):
    return PKGS[request.param]


def _mixed_spec(W, duration_s=2.0, rate=40.0):
    return W.WorkloadSpec(
        name="mixed", duration_s=duration_s,
        arrival={"kind": "poisson", "rate": rate},
        tenants=(
            {"name": "chat", "weight": 0.6, "kind": "llm",
             "prompt": {"kind": "lognormal", "median": 6, "sigma": 0.5,
                        "lo": 2},
             "new": {"kind": "uniform", "lo": 2, "hi": 6}},
            {"name": "rec", "weight": 0.4, "kind": "hybrid",
             "prompt": {"kind": "uniform", "lo": 2, "hi": 8},
             "new": {"kind": "fixed", "value": 3}, "lookups": 4}),
        vocab=512, max_seq_len=48)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", list(jworkload.BUILTIN_SPECS))
def test_schedule_digest_equals_jax(name, seed):
    assert tworkload.BUILTIN_SPECS == jworkload.BUILTIN_SPECS
    tspec = tworkload.builtin_spec(name)
    jspec = jworkload.builtin_spec(name)
    assert tspec.digest() == jspec.digest()
    tgen = tworkload.WorkloadGenerator(tspec, seed)
    jgen = jworkload.WorkloadGenerator(jspec, seed)
    tev, jev = list(tgen), list(jgen)
    assert len(tev) == len(jev) > 50
    assert tworkload.schedule_digest(tev) == jworkload.schedule_digest(jev)
    assert tgen.stats == jgen.stats
    assert tgen.state_dict() == jgen.state_dict()


def test_stream_draws_equal_jax():
    t, j = tworkload.Stream(5, "x/y"), jworkload.Stream(5, "x/y")
    for i in (0, 1, 17, 2 ** 40):
        assert t.bits(i) == j.bits(i)
        assert t.u01(i) == j.u01(i)
        assert t.normal(i) == j.normal(i)
        assert t.exp(i, 3.0) == j.exp(i, 3.0)
        assert t.randint(i, 2, 90) == j.randint(i, 2, 90)


def test_zero_rate_window_emits_nothing(W):
    spec = W.WorkloadSpec(
        name="win", duration_s=3.0,
        arrival={"kind": "windows",
                 "windows": [[1.0, 30.0], [1.0, 0.0], [1.0, 30.0]]},
        max_seq_len=32)
    events = W.schedule(spec, seed=3)
    assert any(e.t < 1.0 for e in events)
    assert any(e.t >= 2.0 for e in events)
    assert [e for e in events if 1.0 <= e.t < 2.0] == []
    assert [e.index for e in events] == list(range(len(events)))


def test_all_zero_windows_is_an_empty_schedule(W):
    spec = W.WorkloadSpec(
        name="dead", duration_s=2.0,
        arrival={"kind": "windows", "windows": [[2.0, 0.0]]})
    assert W.schedule(spec, seed=0) == []


def test_pareto_heavy_tail_truncates_at_the_cap(W):
    spec = W.WorkloadSpec(
        name="tail", duration_s=2.0,
        arrival={"kind": "poisson", "rate": 50.0},
        tenants=({"name": "t", "weight": 1.0, "kind": "llm",
                  "prompt": {"kind": "pareto", "alpha": 1.1, "scale": 6,
                             "lo": 2, "hi": 4096},
                  "new": {"kind": "fixed", "value": 4}},),
        max_seq_len=32)
    gen = W.WorkloadGenerator(spec, seed=1)
    events = list(gen)
    assert len(events) > 20
    assert gen.stats["truncated"] > 0
    for e in events:
        assert 2 <= e.prompt.size <= spec.max_seq_len - 1
        assert e.tokens_total() <= spec.max_seq_len


def test_state_dict_resume_is_byte_identical(W):
    spec = _mixed_spec(W)
    ref = W.schedule(spec, seed=9)
    assert len(ref) > 10
    gen = W.WorkloadGenerator(spec, 9)
    head = [gen.next_event() for _ in range(7)]
    state = json.loads(json.dumps(gen.state_dict()))
    resumed = W.WorkloadGenerator(spec, 9).load_state_dict(state)
    tail = list(resumed)
    assert W.schedule_digest(head + tail) == W.schedule_digest(ref)
    assert resumed.stats["events"] == len(ref)
    with pytest.raises(ValueError):
        W.WorkloadGenerator(spec, 8).load_state_dict(state)
    other = W.WorkloadSpec(name="other", duration_s=1.0,
                           arrival={"kind": "poisson", "rate": 1.0})
    with pytest.raises(ValueError):
        W.WorkloadGenerator(other, 9).load_state_dict(state)


def test_resume_state_crosses_packages():
    """A JAX generator's state_dict resumes a port generator (and the
    schedule it finishes is JAX's, byte for byte)."""
    jgen = jworkload.WorkloadGenerator(_mixed_spec(jworkload), 9)
    head = [jgen.next_event() for _ in range(5)]
    state = json.loads(json.dumps(jgen.state_dict()))
    tgen = tworkload.WorkloadGenerator(_mixed_spec(tworkload), 9)
    tail = list(tgen.load_state_dict(state))
    ref = jworkload.schedule(_mixed_spec(jworkload), 9)
    assert tworkload.schedule_digest(head + tail) == \
        jworkload.schedule_digest(ref)


def test_hybrid_tenant_events_carry_lookups(W):
    events = W.schedule(_mixed_spec(W, duration_s=1.0), seed=4)
    rec = [e for e in events if e.tenant == "rec"]
    assert rec
    for e in rec:
        assert e.kind == "hybrid"
        assert e.lookup_ids is not None and e.lookup_ids.size == 4
    for e in events:
        if e.tenant == "chat":
            assert e.lookup_ids is None


@pytest.fixture(scope="module")
def tiny_loops():
    """JAX's tiny loop, and the port's with JAX's weights copied in."""
    jnet, jloop = jharness.build_tiny_loop()
    with tdevice.device_scope("cpu"):
        tnet, tloop = harness.build_tiny_loop()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    return jloop, tloop


def test_run_spec_steady_gives_jax_completed_and_outputs(tiny_loops):
    jloop, tloop = tiny_loops
    jrep = jharness.run_spec(jworkload.builtin_spec("steady", duration_s=2.0),
                             seed=0, loop=jloop, time_scale=0.05, clients=2)
    trep = harness.run_spec(tworkload.builtin_spec("steady", duration_s=2.0),
                            seed=0, loop=tloop, time_scale=0.05, clients=2)
    assert trep.events == jrep.events > 30
    assert trep.schedule_digest == jrep.schedule_digest
    assert trep.completed == jrep.completed == trep.events
    assert trep.errors == jrep.errors == 0
    assert trep.outputs_digest == jrep.outputs_digest
    assert trep.truncated == jrep.truncated
    assert trep.scored_by == "monitor"
    for rep in (trep.ttft_ms, trep.token_ms):
        assert rep["p50"] is not None and rep["p99"] >= rep["p50"]
    # the report is scored on the harness's fine buckets
    assert tmonitor.histogram_summary("serve/ttft_ms")["bounds"] == \
        list(harness.TTFT_BUCKETS_MS)


def test_same_seed_replay_is_byte_identical_through_harness():
    spec = _mixed_spec(tworkload, duration_s=1.0, rate=30.0)
    a = harness.run_spec(spec, seed=5, time_scale=0.05, clients=2)
    b = harness.run_spec(spec, seed=5, time_scale=0.05, clients=2)
    assert a.events > 0
    assert a.schedule_digest == b.schedule_digest
    assert a.outputs_digest == b.outputs_digest
    assert a.completed == a.events and a.errors == 0
    assert b.completed == b.events and b.errors == 0
    assert tworkload.schedule_digest(tworkload.schedule(spec, 6)) != \
        a.schedule_digest


def test_flash_crowd_backpressure_drops_nothing():
    spec = tworkload.WorkloadSpec(
        name="flashlet", duration_s=0.8,
        arrival={"kind": "flash", "base": 5.0, "burst_rate": 150.0,
                 "burst_at_s": 0.1, "burst_len_s": 0.3},
        tenants=({"name": "chat", "weight": 1.0, "kind": "llm",
                  "prompt": {"kind": "fixed", "value": 6},
                  "new": {"kind": "fixed", "value": 6}},),
        vocab=256, max_seq_len=32)
    events = tworkload.schedule(spec, seed=2)
    burst = [e for e in events if 0.1 <= e.t < 0.4]
    assert len(burst) > 20
    rep = harness.run_spec(
        spec, seed=2, time_scale=0.25, clients=4,
        serve_cfg={"max_active": 2, "kv_blocks": 8, "block_size": 8,
                   "max_seq_len": 32})
    assert rep.backpressure_waits > 0
    assert rep.completed == rep.events == len(events)
    assert rep.errors == 0


def test_run_spec_rejects_specs_that_overflow_the_serve_cap():
    spec = tworkload.WorkloadSpec(
        name="toolong", duration_s=0.5,
        arrival={"kind": "poisson", "rate": 20.0},
        tenants=({"name": "t", "weight": 1.0, "kind": "llm",
                  "prompt": {"kind": "fixed", "value": 40},
                  "new": {"kind": "fixed", "value": 40}},),
        max_seq_len=96)
    with pytest.raises(ValueError, match="serve cap"):
        harness.run_spec(spec, seed=0, time_scale=0.0)


class _Boom:
    def submit(self, *a, **k):
        raise RuntimeError("full")

    def run_until_idle(self):
        pass


@pytest.mark.parametrize("mod", [jharness, harness], ids=["jax", "port"])
def test_drive_serve_collects_submit_errors_instead_of_raising(mod):
    subs = mod.submissions_from_prompts(
        [np.arange(1, 5, dtype=np.int64)] * 3, 2)
    stats = mod.drive_serve(_Boom(), subs, clients=2, wait="idle")
    assert sorted(stats.errors) == [f"submit[{i}]: RuntimeError: full"
                                    for i in range(3)]
    assert stats.outs == [None] * 3 and stats.tokens == 0


def test_run_worker_pool_records_the_promotion_latency():
    tmonitor.reset("tm.promotions")
    done = []

    def worker(wid):
        done.append(wid)

    def on_kill():
        threading.Timer(0.05, tmonitor.stat_add,
                        args=("tm.promotions",)).start()

    run = harness.run_worker_pool(worker, 3, kill_after_s=0.01,
                                  on_kill=on_kill,
                                  promotion_stat="tm.promotions",
                                  promote_timeout_s=10.0)
    assert sorted(done) == [0, 1, 2]
    assert run.promote_latency_s is not None
    assert 0.04 <= run.promote_latency_s < 10.0
    tmonitor.reset("tm.promotions")


def test_item8_pieces_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="item 8"):
        harness.Window(object())
    with pytest.raises(NotImplementedError, match="item 8"):
        harness.run_spec(tworkload.builtin_spec("steady"), hub=object())


def test_port_traffic_lab_draws_from_named_streams_only():
    """tools/framework_lint.py's determinism lint over the port's copy:
    no wall clock, global PRNG or unseeded numpy generator in the data."""
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "tools"))
    import framework_lint
    assert framework_lint.check_traffic_determinism(
        os.path.join(repo, "paddle_tpu_torch", "traffic")) == []
