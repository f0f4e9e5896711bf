"""Port parity: the per-op FLOPs model (paddle_tpu_torch/static/
spmd_analyzer.py analyze_flops) and capacity.prefill_flops against the
JAX package's, exactly, over GPT and BERT Programs recorded by each
package at two configs and the prefill buckets 8 / 16 / 32; the op names
the rules key on are the same in both Programs."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import static as jstatic
from paddle_tpu.static import capacity as JC
from paddle_tpu.static.spmd_analyzer import analyze_flops as j_flops
from paddle_tpu.text.models import bert as jbert, gpt as jgpt
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.static import capacity as TC
from paddle_tpu_torch.static.spmd_analyzer import (FLOP_RULES,
                                                   analyze_flops as t_flops)
from paddle_tpu_torch.text.models import bert as tbert, gpt as tgpt

GPT_CFGS = {"tiny": {}, "wide": dict(vocab_size=2000, hidden_size=96,
                                     num_layers=3, num_heads=4,
                                     intermediate_size=320,
                                     max_seq_len=64)}
BERT_CFGS = {"tiny": {}, "wide": dict(vocab_size=2000, hidden_size=96,
                                      num_hidden_layers=3,
                                      num_attention_heads=4,
                                      intermediate_size=320,
                                      max_position_embeddings=64)}


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def _cfg(mod_cfg, table, name):
    return mod_cfg.tiny() if not table[name] else mod_cfg(**table[name])


def _record(pkg, static, build, seq):
    pkg.enable_static()
    try:
        main = static.Program("flops")
        with static.program_guard(main, static.Program()):
            ids = static.data("input_ids", [1, seq], "int64")
            build()(ids)
        return main
    finally:
        pkg.disable_static()


@pytest.mark.parametrize("bucket", [8, 16, 32])
@pytest.mark.parametrize("cfg", list(GPT_CFGS))
def test_prefill_flops_equal_jax(cfg, bucket):
    j = JC.prefill_flops(bucket, _cfg(jgpt.GPTConfig, GPT_CFGS, cfg))
    t = TC.prefill_flops(bucket, _cfg(tgpt.GPTConfig, GPT_CFGS, cfg))
    assert t == j > 0


@pytest.mark.parametrize("seq", [8, 16, 32])
@pytest.mark.parametrize("cfg", list(BERT_CFGS))
def test_bert_program_flops_equal_jax_op_for_op(cfg, seq):
    jm = _record(jp, jstatic, lambda: jbert.Bert(
        _cfg(jbert.BertConfig, BERT_CFGS, cfg)), seq)
    tm = _record(tp, tstatic, lambda: tbert.Bert(
        _cfg(tbert.BertConfig, BERT_CFGS, cfg)), seq)
    assert [o.name for o in tm.ops] == [o.name for o in jm.ops]
    j, t = j_flops(jm), t_flops(tm)
    assert t["per_op"] == j["per_op"]
    assert t["total"] == j["total"] > 0


def test_gpt_program_names_and_rules():
    jm = _record(jp, jstatic, lambda: jgpt.GPT(jgpt.GPTConfig.tiny()), 16)
    tm = _record(tp, tstatic, lambda: tgpt.GPT(tgpt.GPTConfig.tiny()), 16)
    names = [o.name for o in tm.ops]
    assert names == [o.name for o in jm.ops]
    # the matmul-class rules carry the total: the head is 2 * 16 * 64 * V
    per = t_flops(tm)["per_op"]
    assert {"matmul", "sdpa", "embedding"} <= set(names) & set(FLOP_RULES)
    assert per[len(names) - 1 - names[::-1].index("matmul")] == \
        2.0 * 16 * 64 * 1024
    assert np.isclose(sum(per), t_flops(tm)["total"])


def test_serve_evidence_and_analytic_profile_equal_jax(monkeypatch):
    """One evidence dict (the port's, GPT-2-shaped at the tiny width)
    priced by both packages' analytic_profile at the H100's peaks (the
    JAX module gets the entry for the test only)."""
    monkeypatch.setitem(JC.DEVICE_PEAKS, "h100-sxm",
                        dict(TC.DEVICE_PEAKS["h100-sxm"]))
    cfg_t, cfg_j = tgpt.GPTConfig.tiny(), jgpt.GPTConfig.tiny()
    ev = TC.serve_evidence(cfg_t, 8, fill=20, block_size=8, blocks=48,
                           max_seq_len=48, dtype="float32")
    sd = ev["graphs"]["serve_decode"]
    # the decode step is a [slots, 1] forward; its KV read whole blocks
    assert sd["cost_analysis"]["flops"] == t_flops(
        TC._record_gpt("d", (8, 1), cfg_t))["total"]
    kv = sd["kv_bytes_per_step"]
    assert kv["typical_live_cols"] == 24
    assert kv["typical_kv_bytes_per_step"] == 8 * 24 * 2 * 2 * 64 * 4
    assert sd["cost_analysis"]["bytes_accessed"] == \
        sd["param_bytes"] + kv["typical_kv_bytes_per_step"]
    t = TC.analytic_profile(ev, device="h100-sxm", gpt_cfg=cfg_t)
    j = JC.analytic_profile(ev, device="h100-sxm", gpt_cfg=cfg_j)
    assert t.as_dict() == j.as_dict()
    assert t.source == "analytic-h100-sxm"
    with pytest.raises(ValueError, match="no peaks"):
        TC.analytic_profile(ev, device="tpu-v3")
    assert set(TC.DEVICE_PEAKS) == {"h100-sxm"}
