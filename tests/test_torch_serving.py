"""Port parity: the continuous-batching server
(paddle_tpu_torch/inference/serving.py) against the JAX ServeLoop, with
the same weights copied across by ``load_jax_params``.

Greedy tokens of the port's ServeLoop must be identical to the JAX
ServeLoop's in the scenarios of tests/test_serving.py: ragged admission,
EOS retirement, pool-exhaustion backpressure and preemption replay. The
port cannot reproduce JAX's sampling bits, so for temperature > 0 the
tests hold its property instead: a request's tokens do not depend on its
batch or on preemption. Tiny config, f32, CPU.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ServeConfig as JServeConfig
from paddle_tpu.inference import ServeLoop as JServeLoop
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.core import monitor, trace
from paddle_tpu_torch.inference import ServeConfig, ServeLoop
from paddle_tpu_torch.static.pipeline_runner import (InflightDriver,
                                                     PipelineStepError)
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig


@pytest.fixture(scope="module")
def nets():
    paddle.seed(0)
    jnet = JGPT(JGPTConfig.tiny())
    jnet.eval()
    tnet = GPT(GPTConfig.tiny(), device="cpu")
    tnet.eval()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    return jnet, tnet


def _generate(tnet, prompt, n, eos=None, **kw):
    """The port's sequential single-request run, truncated at the first
    eos as the serve loop retires."""
    out = tnet.generate(np.asarray(prompt)[None], max_new_tokens=n,
                        temperature=kw.pop("temperature", 0),
                        **kw)[0, len(prompt):].numpy()
    if eos is None:
        return out
    hits = np.nonzero(out == eos)[0]
    return out[: hits[0] + 1] if hits.size else out


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 1024, (n,)).astype(np.int64) for n in lengths]


# name -> (prompt seed, lengths, ServeConfig kwargs, max_new, eos?)
SCENARIOS = {
    "ragged_admission": (0, (5, 9, 3, 17, 7, 12),
                         dict(max_active=3, kv_blocks=32, block_size=16,
                              max_seq_len=64), 8, False),
    "eos_retire": (1, (6,), dict(max_active=2, kv_blocks=16, block_size=16,
                                 max_seq_len=64), 10, True),
    "pool_exhaustion": (2, (10, 10, 10),
                        dict(max_active=4, kv_blocks=2, block_size=16,
                             max_seq_len=32), 12, False),
    "preemption_replay": (3, (6, 6, 6),
                          dict(max_active=4, kv_blocks=3, block_size=8,
                               max_seq_len=16), 8, False),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_serve_tokens_identical_to_jax_serve(nets, name):
    jnet, tnet = nets
    seed, lengths, cfg, new, use_eos = SCENARIOS[name]
    prompts = _prompts(seed, lengths)
    kw = {"max_new_tokens": new}
    if use_eos:
        kw["eos_token_id"] = int(_generate(tnet, prompts[0], new)[0])
    want = JServeLoop(jnet, JServeConfig(**cfg)).serve(prompts, **kw)
    monitor.reset(prefix="serve.")
    loop = ServeLoop(tnet, ServeConfig(**cfg))
    peak = [0]
    orig = loop._dispatch_decode

    def spying_dispatch():
        peak[0] = max(peak[0], sum(s is not None for s in loop._slots))
        return orig()

    loop._dispatch_decode = spying_dispatch
    got = loop.serve(prompts, **kw)
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            g, _generate(tnet, p, new, kw.get("eos_token_id")))
    st = loop.stats()
    assert st["kv_pool_used_blocks"] == 0 and st["active_slots"] == 0
    assert monitor.stat_get("serve.requests_completed") == len(prompts)
    if name == "eos_retire":
        assert len(got[0]) < new, "eos must retire the stream early"
    if name == "pool_exhaustion":
        assert peak[0] == 1, "a pool for one stream serializes admissions"
    if name == "preemption_replay":
        assert monitor.stat_get("serve.preempted") > 0


SAMPLED = dict(temperature=0.8, top_k=50)


def test_sampling_independent_of_batch(nets):
    """temperature > 0: a request's tokens are the same alone, inside a
    mixed batch, and from generate with the same seed."""
    _, tnet = nets
    target, *others = _prompts(9, (7, 4, 11, 6))
    alone = ServeLoop(tnet, ServeConfig(max_active=4, kv_blocks=32,
                                        block_size=16, max_seq_len=64,
                                        **SAMPLED))
    solo = alone.serve([target], max_new_tokens=10, seed=11)[0]
    mixed = ServeLoop(tnet, ServeConfig(max_active=4, kv_blocks=32,
                                        block_size=16, max_seq_len=64,
                                        **SAMPLED))
    reqs = [mixed.submit(p, max_new_tokens=10, seed=100 + i)
            for i, p in enumerate(others[:2])]
    reqs.append(mixed.submit(target, max_new_tokens=10, seed=11))
    reqs.append(mixed.submit(others[2], max_new_tokens=10, seed=7))
    mixed.run_until_idle()
    np.testing.assert_array_equal(reqs[2].result(timeout=0), solo)
    np.testing.assert_array_equal(
        _generate(tnet, target, 10, seed=11, **SAMPLED), solo)
    # different seeds draw different streams
    assert not np.array_equal(reqs[0].result(timeout=0),
                              reqs[2].result(timeout=0)[:10])


def test_sampling_replays_exactly_after_preemption(nets):
    _, tnet = nets
    prompts = _prompts(10, (6, 6, 6))
    cfg = dict(block_size=8, max_seq_len=16, **SAMPLED)
    free = ServeLoop(tnet, ServeConfig(max_active=4, kv_blocks=12, **cfg))
    want = [free.serve([p], max_new_tokens=8, seed=5 + i)[0]
            for i, p in enumerate(prompts)]
    monitor.reset(prefix="serve.")
    tight = ServeLoop(tnet, ServeConfig(max_active=4, kv_blocks=3, **cfg))
    reqs = [tight.submit(p, max_new_tokens=8, seed=5 + i)
            for i, p in enumerate(prompts)]
    tight.run_until_idle()
    assert monitor.stat_get("serve.preempted") > 0
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.result(timeout=0), w)


def test_threaded_concurrent_clients(nets):
    _, tnet = nets
    loop = ServeLoop(tnet, ServeConfig(max_active=4, kv_blocks=32,
                                       block_size=16,
                                       max_seq_len=64)).start()
    prompts = _prompts(4, [4 + i % 5 for i in range(8)])
    outs = {}

    def client(i):
        outs[i] = loop.submit(prompts[i], max_new_tokens=6).result(
            timeout=120)

    ts = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    loop.stop()
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(outs[i], _generate(tnet, p, 6))


def test_spans_gauges_and_completion_records(nets):
    _, tnet = nets
    trace.reset()
    monitor.reset(prefix="serve.")
    monitor.reset(prefix="serve/")
    records = []
    loop = ServeLoop(tnet, ServeConfig(max_active=2, kv_blocks=16,
                                       block_size=16, max_seq_len=64),
                     on_complete=records.append)
    prompts = _prompts(7, (5, 5))
    out = loop.serve(prompts, max_new_tokens=4)
    names = {sp.name for sp in trace.recent()}
    for want in ("serve/admit", "serve/prefill", "serve/decode_step",
                 "serve/retire", "serve/dispatch", "serve/retire_wait"):
        assert want in names, f"missing span {want} (have {names})"
    stats = monitor.stats("serve.")
    for g in ("serve.queue_depth", "serve.active_slots",
              "serve.kv_pool_used_blocks", "serve.kv_pool_free_blocks",
              "serve.tokens_generated", "serve.requests_completed"):
        assert g in stats, f"missing gauge {g}"
    assert monitor.stat_get("serve.tokens_generated") == 8
    assert monitor.histogram_summary("serve/ttft_ms")["count"] == 2
    assert [r["tokens"] for r in records] == [o.tolist() for o in out]
    assert records[0]["version"] == 0 and records[0]["ttft_s"] > 0


def test_hook_error_is_counted_not_fatal(nets):
    _, tnet = nets
    monitor.reset(prefix="serve.")

    def boom(_record):
        raise RuntimeError("logging bug")

    loop = ServeLoop(tnet, ServeConfig(max_active=2, kv_blocks=16,
                                       block_size=16, max_seq_len=64),
                     on_complete=boom)
    assert len(loop.serve(_prompts(12, (5,)), max_new_tokens=3)[0]) == 3
    assert monitor.stat_get("serve.completion_log_errors") == 1


def test_publish_weights_hot_swap(nets):
    _, tnet = nets
    net = GPT(GPTConfig.tiny(), device="cpu", seed=1)
    net.load_state_dict(tnet.state_dict())
    loop = ServeLoop(net, ServeConfig(max_active=2, kv_blocks=16,
                                      block_size=16, max_seq_len=64))
    p = _prompts(13, (6,))[0]
    before = loop.serve([p], max_new_tokens=5)[0]
    with pytest.raises(KeyError, match="unknown param"):
        loop.publish_weights(1, {"nope": np.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        loop.publish_weights(1, {"ln_f.bias": np.zeros(3)})
    wte = net.wte.weight.detach().clone().numpy()
    loop.publish_weights(1, {"wte.weight": wte[::-1].copy()})
    assert loop.stats()["swap_staged"]
    after = loop.serve([p], max_new_tokens=5)[0]
    assert loop.model_version == 1 and not loop.stats()["swap_staged"]
    assert torch.equal(net.wte.weight, torch.from_numpy(wte[::-1].copy()))
    assert not np.array_equal(before, after)


def test_step_failure_errors_inflight_and_keeps_serving(nets):
    _, tnet = nets
    monitor.reset(prefix="serve.")
    loop = ServeLoop(tnet, ServeConfig(max_active=2, kv_blocks=16,
                                       block_size=16, max_seq_len=64))
    real = loop._step
    calls = [0]

    def failing_once(*a):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected device fault")
        return real(*a)

    loop._step = failing_once
    p, q = _prompts(14, (5, 7))
    bad = loop.submit(p, max_new_tokens=4)
    loop.run_until_idle()
    with pytest.raises(PipelineStepError, match="injected device fault"):
        bad.result(timeout=0)
    assert monitor.stat_get("serve.requests_errored") == 1
    assert loop.stats()["kv_pool_used_blocks"] == 0
    np.testing.assert_array_equal(loop.serve([q], max_new_tokens=4)[0],
                                  _generate(tnet, q, 4))


def test_inflight_driver_surfaces_failure_at_materialization():
    drv = InflightDriver("t", max_inflight=2)
    _, h0 = drv.submit(lambda: (None, [torch.tensor([1])]))
    _, h1 = drv.submit(lambda: (_ for _ in ()).throw(ValueError("bad")))
    carry, h2 = drv.submit(lambda: (None, [torch.tensor([3])]))
    assert carry is None, "no dispatch after a failure"
    assert np.asarray(h0[0]).tolist() == [1], "earlier steps materialize"
    with pytest.raises(PipelineStepError, match="step 1 failed"):
        np.asarray(h1[0])
    with pytest.raises(PipelineStepError):
        np.asarray(h2[0])


def test_submit_rejects_over_cap(nets):
    _, tnet = nets
    loop = ServeLoop(tnet, ServeConfig(max_active=2, kv_blocks=4,
                                       block_size=16, max_seq_len=32))
    with pytest.raises(ValueError, match="serving cap"):
        loop.submit(np.arange(1, 30), max_new_tokens=10)


def test_config_takes_flag_defaults(nets):
    from paddle_tpu_torch.core import flags
    _, tnet = nets
    flags.set_flags({"FLAGS_serve_max_active": 3, "FLAGS_serve_kv_blocks": 7})
    try:
        a, blocks, bs, cap, inflight = ServeConfig().resolve(tnet)
    finally:
        flags.set_flags({"FLAGS_serve_max_active": 64,
                         "FLAGS_serve_kv_blocks": 512})
    assert (a, blocks, bs, cap, inflight) == (3, 7, 128, 128, 2)
