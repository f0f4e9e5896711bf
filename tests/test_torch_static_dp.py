"""Port parity: the static Executor over the dp ranks of a mesh and its
recompute segments (paddle_tpu_torch/static/executor.py) against the JAX
package's ``with_data_parallel`` and ``_recompute_segments``.

A one-layer tiny BERT MLM program (dropout 0), the JAX weights copied in
by module path, runs 2 steps of a b4 global batch: in the JAX package
under ``CompiledProgram(...).with_data_parallel()`` on a {"dp": 2} mesh of
its 8-device CPU mesh, in the port on 2 gloo ranks (each runs its 2 rows,
the gradients are summed). The losses agree within rtol 1e-5 and, with
SGD, the parameters after the 2 steps within rtol 1e-5 atol 1e-6 (f32;
AdamW divides tiny gradients by their own root, so its updates of the
embedding rows a batch barely reaches magnify the summation order's last
bits: its losses are held, its parameters are not). The same program
under ``strategy.recompute`` (one segment an encoder layer) gives
gradients bitwise those of the program without it, on each rank.
"""
import numpy as np
import pytest

import jax

from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.testing import spmd

from test_torch_static_cases import (JAX, PORT, jax_static_params,
                                     static_mode)

B, S = 4, 16
CFG = dict(jbert.BertConfig.tiny().__dict__)
CFG.update(num_hidden_layers=1, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _batches(n=2, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randint(4, CFG["vocab_size"], (B, S)).astype("int64")
        y = np.where(rng.rand(B, S) < 0.3, x, -100).astype("int64")
        y[0, 0], y[3, 1] = x[0, 0], x[3, 1]   # labels in both halves
        out.append((x, y))
    return out


def _jax_run(opt, lr, batches, dp=True, recompute=False):
    """(initial weights by module path, losses, weights after) of the JAX
    static BERT under with_data_parallel on {"dp": 2} (or one device)."""
    cfg = jbert.BertConfig(**CFG)
    with static_mode(JAX) as static:
        main = static.Program("bert_dp")
        with static.program_guard(main, static.Program()):
            JAX.paddle.seed(0)
            ids = static.data("ids", [B, S], "int64")
            lab = static.data("labels", [B, S], "int64")
            net = jbert.Bert(cfg)
            outs = []
            for layer in net.encoder.layers:
                layer.register_forward_post_hook(
                    lambda _l, _i, o: outs.append(o))
            loss = net(ids, masked_lm_labels=lab)
            kw = {"weight_decay": 0.01} if opt == "AdamW" else {}
            getattr(JAX.optimizer, opt)(learning_rate=lr,
                                        parameters=net.parameters(),
                                        **kw).minimize(loss)
        if recompute:
            main.recompute_checkpoints = [o.name for o in outs]
        params, _ = jax_static_params(net)
        prog = main
        prev = jmesh.get_mesh("default")
        if dp:
            jmesh.init_mesh({"dp": 2}, devices=jax.devices()[:2])
            prog = static.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
        try:
            exe = static.Executor()
            losses = [float(exe.run(prog, feed={"ids": x, "labels": y},
                                    fetch_list=[loss])[0])
                      for x, y in batches]
        finally:
            if dp and prev is None:
                jmesh.reset_mesh("default")
            elif dp:
                jmesh.set_mesh(prev, "default")
    after, _ = jax_static_params(net)
    return params, losses, after


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    batches = _batches()
    jax_sgd = _jax_run("SGD", 0.5, batches)
    jax_adamw = _jax_run("AdamW", 1e-3, batches)
    p0 = jax_sgd[0]
    cases = {
        "sgd": ("static_bert_dp_case", (CFG, p0, batches),
                {"opt": "SGD", "lr": 0.5, "fetch_grads": True}),
        "sgd_recompute": ("static_bert_dp_case", (CFG, p0, batches),
                          {"opt": "SGD", "lr": 0.5, "fetch_grads": True,
                           "recompute": True}),
        "adamw": ("static_bert_dp_case", (CFG, jax_adamw[0], batches),
                  {"opt": "AdamW", "lr": 1e-3}),
    }
    from paddle_tpu_torch.testing import spmd_static
    res = spmd.run_ranks(spmd_static.suite, 2, cases,
                         tmp_path=tmp_path_factory.mktemp("dp"))
    return {"jax_sgd": jax_sgd, "jax_adamw": jax_adamw, "port": res,
            "batches": batches}


def test_with_data_parallel_bert_sgd_matches_jax(ranks):
    _, jl, jafter = ranks["jax_sgd"]
    for r in ranks["port"]:
        np.testing.assert_allclose(r["sgd"]["losses"], jl, rtol=1e-5)
        for k, v in jafter.items():
            np.testing.assert_allclose(r["sgd"]["params"][k], v, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_with_data_parallel_bert_adamw_losses_match_jax(ranks):
    _, jl, _ = ranks["jax_adamw"]
    for r in ranks["port"]:
        np.testing.assert_allclose(r["adamw"]["losses"], jl, rtol=1e-5)


def test_each_rank_runs_its_shard_and_sums_the_gradients(ranks):
    for r in ranks["port"]:
        assert r["sgd"]["rows"] == B // 2
        assert r["sgd"]["allreduce_bytes"] > 0
    g0, g1 = ranks["port"][0]["sgd"]["grads"], \
        ranks["port"][1]["sgd"]["grads"]
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])


def test_recompute_gradients_bitwise_the_plain_programs(ranks):
    for r in ranks["port"]:
        plain, rc = r["sgd"], r["sgd_recompute"]
        assert plain["losses"] == rc["losses"]
        for k in plain["grads"]:
            np.testing.assert_array_equal(rc["grads"][k],
                                          plain["grads"][k], err_msg=k)
        for k in plain["params"]:
            np.testing.assert_array_equal(rc["params"][k],
                                          plain["params"][k], err_msg=k)


def test_recompute_over_dp_matches_jax(ranks):
    _, jl, jafter = _jax_run("SGD", 0.5, ranks["batches"], recompute=True)
    np.testing.assert_allclose(jl, ranks["jax_sgd"][1], rtol=1e-6)
    r = ranks["port"][0]["sgd_recompute"]
    np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
    for k, v in jafter.items():
        np.testing.assert_allclose(r["params"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_recompute_segments_in_one_process_match_jax():
    from paddle_tpu_torch.bridge import load_jax_static_params
    from paddle_tpu_torch.testing.spmd_static import static_bert
    from paddle_tpu_torch.text.models import bert as tbert
    batches = _batches(seed=3)
    p0, jl, jafter = _jax_run("SGD", 0.5, batches, dp=False, recompute=True)
    main, net, loss = static_bert(tbert.BertConfig(**CFG), B, S, opt="SGD",
                                  lr=0.5, recompute=True)
    assert len(main.recompute_checkpoints) == 1
    assert main.recompute_policy == "nothing"
    load_jax_static_params(net, p0)
    with static_mode(PORT) as static:
        exe = static.Executor()
        tl = [float(exe.run(main, feed={"ids": x, "labels": y},
                            fetch_list=[loss])[0]) for x, y in batches]
        e = next(iter(exe._cache.values()))
    assert e.segments is not None and len(e.segments[1]) == 2
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    from test_torch_static_cases import scope_np
    for k, p in net.named_parameters():
        np.testing.assert_allclose(scope_np(PORT, p), jafter[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_recompute_keeps_only_the_live_values():
    from paddle_tpu_torch.static.executor import _recompute_segments
    from paddle_tpu_torch.testing.spmd_static import static_bert
    from paddle_tpu_torch.text.models import bert as tbert
    cfg = dict(CFG, num_hidden_layers=2)
    main, _net, loss = static_bert(tbert.BertConfig(**cfg), B, S,
                                   recompute=True)
    ids = {}
    policy, ranges = _recompute_segments(
        main, lambda v: ids.setdefault(v, v), [loss.var_id])
    assert policy == "nothing" and len(ranges) == 3
    lo_hi = [(lo, hi) for lo, hi, _, _ in ranges]
    assert lo_hi[0][0] == 0 and lo_hi[-1][1] == len(main.ops)
    ck = {v.var_id for v in main.list_vars()
          if v.name in set(main.recompute_checkpoints)}
    # each segment before the last hands on its checkpoint and little else
    for (_lo, _hi, _ins, keep), cid in zip(ranges, sorted(ck)):
        assert cid in keep


def test_fleet_minimize_tags_recompute_and_auto_shard():
    from paddle_tpu_torch.distributed import fleet
    with static_mode(PORT) as static:
        main = static.Program("tags")
        with static.program_guard(main, static.Program()):
            x = static.data("x", [4, 8], "float32")
            net = PORT.nn.Linear(8, 4)
            h = net(x)
            loss = PORT.ops.mean(h)
            st = fleet.DistributedStrategy()
            st.recompute = True
            st.recompute_configs = {"checkpoints": [h], "policy": "dots"}
            st.auto_shard = True
            st.auto_shard_configs = {"beam": 2}
            fleet.distributed_optimizer(
                PORT.optimizer.SGD(learning_rate=0.1,
                                   parameters=net.parameters()),
                st).minimize(loss)
    assert main.recompute_checkpoints == (h.name,)
    assert main.recompute_policy == "dots"
    assert main._auto_shard == {"beam": 2}
