"""Port parity: ``Executor.train_from_dataset`` / ``infer_from_dataset``
(paddle_tpu_torch/static/executor.py) against the JAX package's.

A one-layer static BERT (weights copied from JAX's by module path) reads
LMDataset batches written as MultiSlot files through an InMemoryDataset.
- The port's synchronous loop (in-flight 0), in-flight 2 and scan K 2 give
  JAX's printed losses (print_period 1, six decimals: rtol 1e-5) and
  parameters (rtol 2e-4, atol 2e-5, the static BERT test's bound), and
  are bitwise equal to each other with dropout on.
- ``start_batch`` after a restore of the scope, the optimizer and the
  generator at that batch gives the uninterrupted trail's tail bitwise.
"""
import os
import re

import numpy as np
import pytest

from paddle_tpu.io import InMemoryDataset as JInMemory
from paddle_tpu.text.datasets import LMDataset
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch.bridge import load_jax_static_params
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.device import device_scope
from paddle_tpu_torch.io import InMemoryDataset as TInMemory
from paddle_tpu_torch.text.models import bert as tbert

from test_torch_fleet_dataset import write_lm_multislot
from test_torch_static_cases import (JAX, PORT, jax_static_params,
                                     static_mode, to_np)

B, S, N = 4, 16, 8


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


def _bert(P, dropout):
    m = jbert if P is JAX else tbert
    cfg = m.BertConfig.tiny()
    cfg.num_hidden_layers = 1
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    with static_mode(P) as static:
        main = static.Program("bert_tfd")
        with static.program_guard(main, static.Program()):
            P.paddle.seed(0)
            ids = static.data("ids", [B, S], "int64")
            lab = static.data("labels", [B, S], "int64")
            net = m.Bert(cfg)
            loss = net(ids, masked_lm_labels=lab)
            opt = P.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                    parameters=net.parameters())
            opt.minimize(loss)
    return main, net, loss, opt, (ids, lab)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    lm = LMDataset(vocab_size=tbert.BertConfig.tiny().vocab_size, seq_len=S,
                   n=N * B, seed=2)
    return [write_lm_multislot(os.path.join(str(d), f"part-{k}.txt"), lm,
                               range(k * N * B // 2, (k + 1) * N * B // 2))
            for k in range(2)]


@pytest.fixture(scope="module")
def jax_weights():
    """``jax_weights(dropout)``: the JAX program's initial weights
    (``jax_static_params``), each dropout rate's built once a module: the
    JAX BERT's eager initialisation is most of a test's time."""
    cache = {}

    def get(dropout):
        if dropout not in cache:
            _, net, *_ = _bert(JAX, dropout)
            cache[dropout] = jax_static_params(net)
        return cache[dropout]
    return get


def _dataset(P, files, feed_vars):
    ds = (JInMemory if P is JAX else TInMemory)()
    ds.init(batch_size=B, thread_num=2, use_var=list(feed_vars))
    ds.set_filelist(files)
    ds.load_into_memory()
    ds.local_shuffle()
    return ds


def _losses(text):
    return [float(v) for v in re.findall(r"loss=(-?[0-9.]+)", text)]


def _train(P, files, weights, dropout, inflight, scan=0, capsys=None,
           start_batch=0):
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu.core import flags as jflags
    main, net, loss, opt, feeds = _bert(P, dropout)
    if P is JAX:
        weights = jax_static_params(net)
    else:
        load_jax_static_params(net, *weights)
    ds = _dataset(P, files, feeds)
    prog = main
    if scan:
        es = P.static.ExecutionStrategy()
        es.max_inflight, es.scan_fuse_steps = inflight, scan
        prog = P.static.CompiledProgram(main, exec_strategy=es)
    flags = jflags if P is JAX else tflags
    old = flags.flag("FLAGS_executor_max_inflight")
    flags.set_flags({"FLAGS_executor_max_inflight": inflight})
    P.paddle.seed(7)
    capsys.readouterr()
    try:
        P.static.Executor().train_from_dataset(
            prog, ds, fetch_list=[loss], fetch_info=["loss"],
            print_period=1, start_batch=start_batch)
    finally:
        flags.set_flags({"FLAGS_executor_max_inflight": old})
    params = {k: to_np(P.static.global_scope().get(p.scope_name))
              for k, p in net.named_parameters()}
    return _losses(capsys.readouterr().out), params, weights


def test_losses_equal_jax_in_every_mode(files, capsys):
    jl, jp_, weights = _train(JAX, files, None, 0.0, 2, capsys=capsys)
    assert len(jl) == N
    for inflight, scan in ((0, 0), (2, 0), (2, 2)):
        tl, tp, _ = _train(PORT, files, weights, 0.0, inflight, scan,
                           capsys=capsys)
        np.testing.assert_allclose(tl, jl, rtol=1e-5,
                                   err_msg=f"{inflight}/{scan}")
        for k in tp:
            np.testing.assert_allclose(tp[k], jp_[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)


def test_modes_bitwise_with_dropout(files, capsys, jax_weights):
    weights = jax_weights(0.1)
    runs = [_train(PORT, files, weights, 0.1, i, k, capsys=capsys)
            for i, k in ((0, 0), (2, 0), (2, 2), (2, 4))]
    for losses, params, _ in runs[1:]:
        assert losses == runs[0][0]
        for k in params:
            np.testing.assert_array_equal(params[k], runs[0][1][k])


def test_start_batch_resume_is_bitwise(files, capsys, jax_weights):
    """The uninterrupted run's state at batch 4 (scope, optimizer,
    generator) restored into a fresh program, ``start_batch=4`` gives its
    last 4 losses and its final parameters bitwise (dropout 0.1)."""
    weights = jax_weights(0.1)
    full = _train(PORT, files, weights, 0.1, 0, capsys=capsys)
    # the state at batch 4: the first 4 batches, serially
    main, net, loss, opt, feeds = _bert(PORT, 0.1)
    load_jax_static_params(net, *weights)
    ds = _dataset(PORT, files, feeds)
    PORT.paddle.seed(7)
    exe = PORT.static.Executor()
    first = []
    for i, feed in enumerate(ds.batches()):
        if i == 4:
            break
        first.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0]))
    np.testing.assert_allclose(first, full[0][:4], rtol=1e-5)
    scope = PORT.static.global_scope()
    state = {p.scope_name: scope.get(p.scope_name).clone()
             for p in net.parameters()}
    opt_state = opt.state_dict()
    gen_state = trng.generator("cpu").get_state()
    # a fresh program restored to that state, resumed at batch 4
    main2, net2, loss2, opt2, feeds2 = _bert(PORT, 0.1)
    for p2, p in zip(net2.parameters(), net.parameters()):
        scope.get(p2.scope_name).copy_(state[p.scope_name])
    opt2.set_state_dict(_renamed(opt_state, net, net2))
    trng.generator("cpu").set_state(gen_state)
    ds2 = _dataset(PORT, files, feeds2)
    capsys.readouterr()
    exe.train_from_dataset(main2, ds2, fetch_list=[loss2],
                           fetch_info=["loss"], print_period=1,
                           start_batch=4)
    assert _losses(capsys.readouterr().out) == full[0][4:]
    for k, p in net2.named_parameters():
        np.testing.assert_array_equal(to_np(scope.get(p.scope_name)),
                                      full[1][k])


def _renamed(opt_state, net, net2):
    """An optimizer state_dict with net's parameter names put as net2's."""
    names = {p.scope_name: p2.scope_name
             for p, p2 in zip(net.parameters(), net2.parameters())}
    out = {}
    for k, v in opt_state.items():
        if isinstance(k, str) and "/" in k:
            pname, slot = k.rsplit("/", 1)
            k = f"{names.get(pname, pname)}/{slot}"
        out[k] = v
    return out


def test_infer_from_dataset_counts_batches(files, capsys):
    main, net, loss, opt, feeds = _bert(PORT, 0.0)
    test_prog = main.clone(for_test=True)
    ds = _dataset(PORT, files, feeds)
    before = tmonitor.stat_get("executor/dataset_batches")
    w = to_np(PORT.static.global_scope().get(
        net.parameters()[0].scope_name))
    PORT.static.Executor().infer_from_dataset(test_prog, ds,
                                              fetch_list=[loss],
                                              fetch_info=["loss"],
                                              print_period=2)
    assert tmonitor.stat_get("executor/dataset_batches") - before == N
    assert len(_losses(capsys.readouterr().out)) == N // 2
    np.testing.assert_array_equal(
        to_np(PORT.static.global_scope().get(
            net.parameters()[0].scope_name)), w)


def test_dataset_required_and_ps_config_raises():
    main, *_ = _bert(PORT, 0.0)
    exe = PORT.static.Executor()
    with pytest.raises(ValueError, match="requires a dataset"):
        exe.train_from_dataset(main, None)
    # the parameter-server modes are ported (tests/test_torch_ps.py,
    # tests/test_torch_online_learning.py); without a client, as in JAX
    with pytest.raises(KeyError, match="client"):
        exe.train_from_dataset(main, object(), ps_config={"mode": "online"})


@pytest.mark.parametrize("inflight,scan", [(0, 0), (2, 0), (2, 4)])
def test_fetch_handler_sees_every_batch(files, inflight, scan,
                                       jax_weights):
    """``fetch_handler(batch, fetches)``: every batch in order, lazy
    handles on the pipelined path (read after the run), host arrays on
    the synchronous one; the values are the serial loop's. The runner's
    megastep size may also come from FLAGS_executor_scan_steps."""
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu_torch.static.pipeline_runner import FetchHandle
    weights = jax_weights(0.0)
    got = []
    for use_handler in (True, False):
        main, net, loss, opt, feeds = _bert(PORT, 0.0)
        load_jax_static_params(net, *weights)
        ds = _dataset(PORT, files, feeds)
        seen = []
        old = {k: tflags.flag(k) for k in ("FLAGS_executor_max_inflight",
                                           "FLAGS_executor_scan_steps")}
        tflags.set_flags({"FLAGS_executor_max_inflight": inflight,
                          "FLAGS_executor_scan_steps": scan})
        try:
            PORT.paddle.seed(7)
            PORT.static.Executor().train_from_dataset(
                main, ds, fetch_list=[loss], print_period=0,
                fetch_handler=(lambda it, outs: seen.append((it, outs[0])))
                if use_handler else None)
        finally:
            tflags.set_flags(old)
        got.append((seen, {k: to_np(PORT.static.global_scope().get(
            p.scope_name)) for k, p in net.named_parameters()}))
    seen, params = got[0]
    assert [it for it, _ in seen] == list(range(1, N + 1))
    kinds = {type(h) for _, h in seen}
    assert kinds == ({FetchHandle} if inflight else {np.ndarray})
    assert all(np.isfinite(float(np.asarray(h))) for _, h in seen)
    for k in params:                      # the handler changes nothing
        np.testing.assert_array_equal(params[k], got[1][1][k])
