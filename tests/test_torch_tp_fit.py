"""Port parity: ``Model.fit`` under meshes with a ``tp`` axis
(paddle_tpu_torch/hapi/model.py, ``fleet.meta_parallel.tensor_parallel``)
against the JAX engine's GSPMD step on the same mesh.

GPT tiny (dropout 0) with the JAX weights, wrapped so that its forward
takes (ids, labels) and returns the fused CE loss, fits 2 steps of a b4
s16 batch with SGD (lr 0.5; AdamW divides a tiny gradient by its own
root, which magnifies the summation order's last bits in the few
elements a step barely reaches): in the JAX package on its 8-device CPU
mesh under {"tp": 2}, {"dp": 2, "tp": 2} and {"tp": 2, "pp": 2}, in the
port on as many gloo ranks. The losses agree within rtol 1e-5 and the
whole parameters after the 2 steps (the port's shards gathered) within
rtol 1e-5 atol 1e-6 (f32). Under {"tp": 2} the planner's rules
(``plan_program(...).install_rules()``) give the preset's result bitwise
(the plan equals the preset on GPT). A pp axis is a replica, as GSPMD
replicates over it.
"""
import numpy as np
import pytest

import jax

import paddle_tpu as jp
from paddle_tpu import hapi as jhapi
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.io import TensorDataset as JTD
from paddle_tpu.text.models import gpt as jgpt
from paddle_tpu_torch.testing import spmd
from test_torch_jax_mesh import keeps_default_mesh

CFG = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_seq_len=16, dropout=0.0)
B, S = 4, 16
LR = 0.5
FIT = {"opt": "SGD", "lr": LR}


class JGPTLM(jnn.Layer):
    def __init__(self, cfg):
        super().__init__()
        self.gpt = jgpt.GPT(cfg)

    def forward(self, ids, labels):
        return self.gpt(ids, labels=labels)


def _data():
    rng = np.random.RandomState(0)
    return (rng.randint(0, CFG["vocab_size"], (B, S)).astype("int64"),
            rng.randint(0, CFG["vocab_size"], (B, S)).astype("int64"))


@keeps_default_mesh
def _jax_fit(mesh_shape, steps=2):
    X, Y = _data()
    n = int(np.prod(list(mesh_shape.values())))
    jmesh.init_mesh(mesh_shape, devices=jax.devices()[:n])
    jp.seed(0)
    net = JGPTLM(jgpt.GPTConfig(**CFG))
    params = {k: np.asarray(v._value) for k, v in net.named_parameters()}
    model = jhapi.Model(net, inputs=[jhapi.InputSpec([None], "int64"),
                                     jhapi.InputSpec([None], "int64")])
    model.prepare(jopt.SGD(learning_rate=LR, parameters=net.parameters()),
                  loss=lambda loss: loss)
    losses = []

    class Rec(jhapi.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(float(logs["loss"]))

    model.fit(JTD([X, Y]), batch_size=B, epochs=steps, verbose=0,
              shuffle=False, callbacks=[Rec()])
    after = {k: np.asarray(v._value) for k, v in net.named_parameters()}
    return params, losses, after


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_fit(shape) for name, shape in (
        ("tp", {"tp": 2}), ("dp_tp", {"dp": 2, "tp": 2}),
        ("tp_pp", {"tp": 2, "pp": 2}))}


@pytest.fixture(scope="module")
def two_ranks(jax_runs, tmp_path_factory):
    from paddle_tpu_torch.testing import spmd_static
    from paddle_tpu_torch.tools.spmd_plan import build_plan
    X, Y = _data()
    p0 = jax_runs["tp"][0]
    plan = build_plan(tp=2, layers=CFG["num_layers"],
                      hidden=CFG["hidden_size"], heads=CFG["num_heads"],
                      vocab=CFG["vocab_size"], batch=B, seq=S)[0]
    rules = [(r.template.replace("^", r"^gpt\."), r.ndim, tuple(r.spec))
             for r in plan.rules]
    cases = {"preset": ("gpt_fit_case", (CFG, p0, X, Y, {"tp": 2}), FIT),
             "plan": ("gpt_fit_case", (CFG, p0, X, Y, {"tp": 2}),
                      dict(FIT, rules=rules))}
    return spmd.run_ranks(spmd_static.suite, 2, cases,
                          tmp_path=tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def four_ranks(jax_runs, tmp_path_factory):
    from paddle_tpu_torch.testing import spmd_static
    X, Y = _data()
    cases = {name: ("gpt_fit_case", (CFG, jax_runs[name][0], X, Y, shape),
                    FIT)
             for name, shape in (("dp_tp", {"dp": 2, "tp": 2}),
                                 ("tp_pp", {"tp": 2, "pp": 2}))}
    return spmd.run_ranks(spmd_static.suite, 4, cases,
                          tmp_path=tmp_path_factory.mktemp("tp4"))


def _hold(rec, jax_run):
    _, jl, jafter = jax_run
    np.testing.assert_allclose(rec["losses"], jl, rtol=1e-5)
    for k, v in jafter.items():
        np.testing.assert_allclose(rec["params"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_fit_under_tp2_matches_jax_gspmd(two_ranks, jax_runs):
    for r in two_ranks:
        _hold(r["preset"], jax_runs["tp"])


def test_fit_under_dp2_tp2_matches_jax_gspmd(four_ranks, jax_runs):
    for r in four_ranks:
        _hold(r["dp_tp"], jax_runs["dp_tp"])


def test_fit_under_tp2_pp2_replicates_over_pp_as_jax(four_ranks, jax_runs):
    for r in four_ranks:
        _hold(r["tp_pp"], jax_runs["tp_pp"])
    for k in four_ranks[0]["tp_pp"]["params"]:
        np.testing.assert_array_equal(four_ranks[0]["tp_pp"]["params"][k],
                                      four_ranks[2]["tp_pp"]["params"][k])


def test_plan_rules_fit_bitwise_the_preset(two_ranks):
    for r in two_ranks:
        assert r["plan"]["losses"] == r["preset"]["losses"]
        for k, v in r["preset"]["params"].items():
            np.testing.assert_array_equal(r["plan"]["params"][k], v,
                                          err_msg=k)


def test_tp_shards_the_state_and_counts_the_chain(two_ranks):
    """Each rank holds its shards (the state bytes below the whole); a
    step runs the chain's collectives: the embedding's and 2 a block
    forward, 2 a block backward (all-reduces of [b, s, d] f32), and the
    head's all-gather of the vocab-parallel table."""
    r = two_ranks[0]["preset"]
    whole = sum(v.size * 4 for v in r["params"].values())
    assert r["state_bytes"] < whole          # SGD keeps no slots
    act = B * S * CFG["hidden_size"] * 4
    per_step = (1 + 4 * CFG["num_layers"]) * act
    assert r["all_reduce_bytes"] == 2 * per_step
    head = CFG["vocab_size"] // 2 * CFG["hidden_size"] * 4
    assert r["all_gather_bytes"] == 2 * head
