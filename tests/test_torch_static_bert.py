"""Port parity: BASELINE config 3 (BERT pretraining in static-graph mode)
at tiny size, the port's Program and Executor against the JAX package's.

- At one encoder layer (where JAX ties nothing) JAX's and the port's
  static BERT with AdamW agree over 6 steps: the loss to 1e-5 (f32,
  dropout 0, JAX's scope values copied into the port's by module path,
  the same seeded LMDataset-style batches).
- The port's static step equals the port's dygraph step from the same
  weights on the same batches.
- The reference quirk: JAX's static deep copies keep their parameters'
  scope names, so the encoder layers of its static BERT share one set of
  weights (36 parameters on 24 scope entries at 2 layers); the port's
  copies take fresh names (36 on 36). Given JAX's tied values, the
  port's two layers give JAX's first loss.
- ``static.amp.decorate`` at O1 and O2 in bf16 casts at the same op names
  to the same dtypes as JAX (a trace of each Executor's cast point).
- f16 with dynamic loss scaling skips the same steps as JAX and its scale
  follows JAX's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.amp as jamp
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.static import executor as texecutor
from paddle_tpu_torch.text.models import bert as tbert

from test_torch_static_cases import (JAX, PORT, copy_static,
                                     jax_static_params, scope_np,
                                     static_mode, to_np)

B, S = 4, 16


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _cfg(P, layers, dropout=0.0):
    m = jbert if P is JAX else tbert
    cfg = m.BertConfig.tiny()
    cfg.num_hidden_layers = layers
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    return m, cfg


def _batches(vocab, n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randint(4, vocab, (B, S)).astype("int64")
        y = np.where(rng.rand(B, S) < 0.15, x, -100).astype("int64")
        y[0, 0] = x[0, 0]                  # at least one label a batch
        out.append((x, y))
    return out


def _program(P, layers=1, opt="AdamW", amp=None, **amp_kw):
    m, cfg = _cfg(P, layers)
    with static_mode(P) as static:
        main = static.Program("bert")
        with static.program_guard(main, static.Program()):
            P.paddle.seed(0)
            ids = static.data("ids", [B, S], "int64")
            lab = static.data("labels", [B, S], "int64")
            net = m.Bert(cfg)
            loss = net(ids, masked_lm_labels=lab)
            o = getattr(P.optimizer, opt)(learning_rate=1e-3,
                                          parameters=net.parameters(),
                                          **({"weight_decay": 0.01}
                                             if opt == "AdamW" else {}))
            if amp is not None:
                o = static.amp.decorate(o, level=amp[0], dtype=amp[1],
                                        **amp_kw)
            o.minimize(loss)
    return main, net, loss, cfg


def _run(P, main, loss, batches):
    exe = P.static.Executor()
    return [float(exe.run(main, feed={"ids": x, "labels": y},
                          fetch_list=[loss])[0]) for x, y in batches]


def test_one_layer_static_bert_adamw_matches_jax_over_6_steps():
    progs = {P.name: _program(P) for P in (JAX, PORT)}
    copy_static(progs["jax"][1], progs["port"][1])
    batches = _batches(progs["jax"][3].vocab_size, 6)
    losses = {P.name: _run(P, progs[P.name][0], progs[P.name][2], batches)
              for P in (JAX, PORT)}
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    jparams, _ = jax_static_params(progs["jax"][1])
    for k, p in progs["port"][1].named_parameters():
        np.testing.assert_allclose(scope_np(PORT, p), jparams[k],
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    assert np.isfinite(losses["port"]).all()


def test_static_step_equals_dygraph_step():
    main, snet, loss, cfg = _program(PORT, layers=2)
    net = tbert.Bert(cfg, device="cpu", seed=3)
    params = {k: scope_np(PORT, p) for k, p in snet.named_parameters()}
    from paddle_tpu_torch.bridge import load_jax_params
    load_jax_params(net, params)
    net.train()
    opt = PORT.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                               parameters=net.parameters())
    batches = _batches(cfg.vocab_size, 3, seed=1)
    static_losses = _run(PORT, main, loss, batches)
    dy = []
    for x, y in batches:
        lv = net(PORT.paddle.to_tensor(x),
                 masked_lm_labels=PORT.paddle.to_tensor(y))
        lv.backward()
        for p in net.parameters():        # zeros where jax.grad gives them
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        opt.clear_grad()
        dy.append(float(lv))
    np.testing.assert_allclose(static_losses, dy, rtol=1e-6)
    for k, p in snet.named_parameters():
        np.testing.assert_allclose(scope_np(PORT, p),
                                   dict(net.named_parameters())[k]
                                   .detach().numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_quirk_jax_static_bert_ties_encoder_layers():
    progs = {P.name: _program(P, layers=2) for P in (JAX, PORT)}
    jnet, tnet = progs["jax"][1], progs["port"][1]
    n_params = len(list(jnet.named_parameters()))
    assert n_params == len(list(tnet.named_parameters())) == 36
    assert len(progs["jax"][0].persistable_vars) == 24
    assert len(progs["port"][0].persistable_vars) == 36
    jnames = {k: p.scope_name for k, p in jnet.named_parameters()}
    assert jnames["encoder.layers.0.linear1.weight"] == \
        jnames["encoder.layers.1.linear1.weight"]
    tnames = {k: p.scope_name for k, p in tnet.named_parameters()}
    assert tnames["encoder.layers.0.linear1.weight"] != \
        tnames["encoder.layers.1.linear1.weight"]
    copy_static(jnet, tnet)           # layer 1 takes layer 0's values
    (x, y), = _batches(progs["jax"][3].vocab_size, 1, seed=2)
    first = {P.name: _run(P, progs[P.name][0], progs[P.name][2],
                          [(x, y)])[0] for P in (JAX, PORT)}
    np.testing.assert_allclose(first["port"], first["jax"], rtol=1e-5)


def _trace_casts(monkeypatch):
    log = {"jax": [], "port": []}
    inner_j = jamp.cast_vals

    def jrec(name, vals, level, dtype, white=None, black=None):
        dt = jamp.policy_dtype(name, level, dtype, white, black)
        if dt is not None:
            log["jax"].append((name, np.dtype(dt).name))
        return inner_j(name, vals, level, dtype, white, black)

    inner_t = texecutor.cast_vals

    def trec(name, vals, dt):
        log["port"].append((name, str(dt).replace("torch.", "")))
        return inner_t(name, vals, dt)

    monkeypatch.setattr(jamp, "cast_vals", jrec)
    monkeypatch.setattr(texecutor, "cast_vals", trec)
    return log


# the JAX package's CPU head is its composite (its gate's backend reason);
# the port's is the fused op with the kernels' plain version
_HEAD = {"ce_head_fallback": "fused_ce_op"}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_static_amp_bf16_casts_at_jax_op_names(level, monkeypatch):
    log = _trace_casts(monkeypatch)
    progs = {P.name: _program(P, amp=(level, "bfloat16"))
             for P in (JAX, PORT)}
    copy_static(progs["jax"][1], progs["port"][1])
    batches = _batches(progs["jax"][3].vocab_size, 2, seed=3)
    losses = {}
    for P in (JAX, PORT):
        log[P.name].clear()
        losses[P.name] = _run(P, progs[P.name][0], progs[P.name][2],
                              batches[:1])
        n = len(log[P.name])
        losses[P.name] += _run(P, progs[P.name][0], progs[P.name][2],
                               batches[1:])
        if P is PORT:
            assert len(log["port"]) == 2 * n   # one cast point a run
        log[P.name] = log[P.name][:n]
    jtrace = [(_HEAD.get(k, k), d) for k, d in log["jax"]]
    assert log["port"] == jtrace
    assert all(d in ("bfloat16", "float32") for _, d in log["port"])
    if level == "O1":
        assert ("matmul", "bfloat16") in log["port"]
        assert ("layer_norm", "float32") in log["port"]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=2e-2)


def _loss_scale_keys(P):
    return sorted(k for k in P.static.global_scope().var_names()
                  if k.startswith("_amp_"))


def test_static_amp_f16_dynamic_scaling_matches_jax():
    """An initial scale of 2^30 overflows f16 on the first steps: each
    package skips them (parameters unchanged) and halves the scale at
    every overflow (decr_every_n_nan_or_inf=1) until steps go through;
    after two finite steps in a row the scale doubles."""
    kw = dict(init_loss_scaling=2.0 ** 30, decr_every_n_nan_or_inf=1,
              incr_every_n_steps=2)
    progs = {P.name: _program(P, opt="SGD", amp=("O1", "float16"), **kw)
             for P in (JAX, PORT)}
    copy_static(progs["jax"][1], progs["port"][1])
    batches = _batches(progs["jax"][3].vocab_size, 24, seed=4)
    traj = {}
    for P in (JAX, PORT):
        main, net, loss, _ = progs[P.name]
        exe = P.static.Executor()
        w = net.mlm_transform.weight
        scales, skipped = [], []
        for x, y in batches:
            before = scope_np(P, w)
            exe.run(main, feed={"ids": x, "labels": y}, fetch_list=[loss])
            keys = [k for k in _loss_scale_keys(P) if "loss_scale" in k
                    and k.endswith(f"#{main.uid}")]
            scales.append(float(to_np(P.static.global_scope().get(
                keys[0]))))
            skipped.append(bool(np.array_equal(before, scope_np(P, w))))
        traj[P.name] = (scales, skipped)
    assert traj["port"][1] == traj["jax"][1]
    assert traj["port"][0] == traj["jax"][0]
    assert traj["port"][1][0] and not traj["port"][1][-1]
    assert max(traj["port"][0][-4:]) > min(traj["port"][0])
