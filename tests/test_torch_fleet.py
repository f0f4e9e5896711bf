"""Port parity: fleet (``init``, ``DistributedStrategy``, role makers,
``util``, ``distributed_optimizer``), ``Model.fit`` under a dp mesh
(plain, ZeRO through ``strategy.sharding``, LocalSGD) and
``distributed.localsgd`` against the JAX package's
(tests/test_distributed.py, test_round4_fixes.py:49-90,
test_baseline_configs.py::test_collective_dp_convnet_fit and
test_ps.py::test_fleet_ps_end_to_end are the models).

The JAX package fits on a dp 4 mesh of its CPU devices (GSPMD); the port
runs 4 gloo ranks (``testing.spmd.run_ranks``, one spawn for the fit
cases), each rank calling ``fit`` with the same global batches and
starting from the JAX network's parameters (through the bridge).
Tolerances (f32): History losses rtol 1e-5, parameters and slots rtol
1e-5 atol 1e-6 after the fit (the ranks' gradient sums in another order
than XLA's batch reduction); LocalSGD's replicas and losses rtol 1e-5
atol 1e-6 a step; ZeRO against plain DP atol 1e-6 (4 ranks: the
reduce-scatter's sums may round apart from the all-reduce's); the
strategy's knobs, the fleet mesh and the accounting exactly.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import localsgd as JL
from paddle_tpu.distributed import mesh as JM
from paddle_tpu.hapi.callbacks import History as JHistory
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.testing import spmd, spmd_train

N = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = dict(rtol=1e-5, atol=1e-6)


def _np_params(net):
    return {k: np.asarray(v) for k, v in net.functional_state()[0].items()}


def _data():
    rng = np.random.RandomState(6)
    X = rng.rand(64, 8).astype("float32")
    Y = (X @ rng.rand(8, 1)).astype("float32")
    Xc = rng.rand(64, 3, 8, 8).astype("float32")
    Yc = rng.randint(0, 4, (64,)).astype("int64")
    xl = rng.randn(16, 4).astype("float32")
    yl = rng.randn(16, 4).astype("float32")
    return X, Y, Xc, Yc, xl, yl


def _jax_nets():
    """The JAX networks of each fit kind, seeded."""
    jp.seed(6)
    lin = jnn.Linear(8, 1)
    jp.seed(3)
    conv = jnn.Sequential(jnn.Conv2D(3, 8, 3, padding=1), jnn.ReLU(),
                          jnn.AdaptiveAvgPool2D(1), jnn.Flatten(),
                          jnn.Linear(8, 4))
    jp.seed(0)
    small = jnn.Linear(4, 4)
    return lin, conv, small


def _lsgd_inputs():
    rng = np.random.RandomState(9)
    return ((rng.randn(4, 2) * 0.5).astype("float32"),
            rng.randn(16, 4).astype("float32"),
            rng.randn(16, 2).astype("float32"))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    X, Y, Xc, Yc, xl, yl = _data()
    lin, conv, small = _jax_nets()
    tmp = tmp_path_factory.mktemp("ranks")
    fit = {name: dict(kind=c["kind"], X=X[:c["rows"]], Y=Y[:c["rows"]],
                      init=_np_params(lin), wrap=c["wrap"],
                      drop_last=c["drop_last"])
           for name, c in FIT_CASES.items() if c["kind"] != "convnet"}
    fit["convnet"] = dict(kind="convnet", X=Xc, Y=Yc,
                          init=_np_params(conv))
    fit["localsgd"] = dict(kind="localsgd", X=xl, Y=yl,
                           init=_np_params(small), lr=0.1,
                           save_to=str(tmp / "lsgd" / "final"))
    fit["adaptive"] = dict(kind="adaptive", X=xl, Y=yl,
                           init=_np_params(small), lr=1e-8)
    return spmd.run_ranks(spmd_train.fleet_suite, N, _lsgd_inputs(), fit,
                          tmp_path=tmp)


def _case(kind, rows=64, wrap=False, drop_last=True):
    return dict(kind=kind, rows=rows, wrap=wrap, drop_last=drop_last)


# fit cases: plain DP, ZeRO, the convnet (BASELINE config 4),
# fleet.distributed_model's DataParallel network, and a last batch of 14
# rows that does not divide over dp 4 (drop_last=False), plain and ZeRO.
# The JAX engine on a dp mesh raises on that last batch (its step's input
# shardings come from the first batch:
# test_jax_dp_fit_raises_on_a_last_batch_that_does_not_divide), so those
# two hold the port against the JAX engine's fit on one device, which a
# data-parallel fit equals
FIT_CASES = {"dp": _case("dp"), "zero": _case("zero"),
             "convnet": _case("convnet"),
             "dp_model": _case("dp", wrap=True),
             "dp_odd": _case("dp", rows=62, drop_last=False),
             "zero_odd": _case("zero", rows=62, drop_last=False)}


def _jax_fit(name, dp=None):
    c = FIT_CASES[name]
    kind = c["kind"]
    X, Y, Xc, Yc, *_ = _data()
    lin, conv, _ = _jax_nets()
    if dp is None:
        dp = N if c["drop_last"] else 1
    JM.init_mesh({"dp": dp}, name="default")
    strategy = jfleet.DistributedStrategy()
    if kind == "zero":
        strategy.sharding = True
    if kind == "convnet":
        net, data = conv, (Xc, Yc)
        opt = jopt.Momentum(learning_rate=0.05, parameters=net.parameters())
        loss = jnn.CrossEntropyLoss()
    else:
        net, data = lin, (X[:c["rows"]], Y[:c["rows"]])
        opt = jopt.Adam(learning_rate=0.05, parameters=net.parameters())
        loss = jnn.MSELoss()
    model = jp.Model(jfleet.distributed_model(net) if c["wrap"] else net)
    model.prepare(optimizer=jfleet.distributed_optimizer(opt, strategy),
                  loss=loss)
    h = JHistory()
    model.fit(JTensorDataset(list(data)), batch_size=16, epochs=2,
              verbose=0, shuffle=False, callbacks=[h],
              drop_last=c["drop_last"])
    out = {"losses": np.asarray(h.history["loss"]),
           "params": _np_params(net),
           "slots": {f"{n}/{s}": np.asarray(v)
                     for n, sl in opt._slots.items() for s, v in sl.items()}}
    JM.init_mesh({"dp": 8})
    return out


@pytest.mark.parametrize("kind", list(FIT_CASES))
def test_fleet_fit_matches_jax(port, kind):
    ref = _jax_fit(kind)
    for r in range(N):
        got = port[r][f"fit_{kind}"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        for k, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][k], v, **FIT_TOL,
                                       err_msg=k)
        for k, v in ref["slots"].items():
            np.testing.assert_allclose(got["slots"][k], v, **FIT_TOL,
                                       err_msg=k)
    assert ref["losses"][-1] < ref["losses"][0]


def test_jax_dp_fit_raises_on_a_last_batch_that_does_not_divide():
    """A reference quirk: the JAX engine builds its step's input shardings
    from the first batch, so on a dp 4 mesh a last batch of 14 rows
    raises (the port runs it whole on every rank)."""
    with pytest.raises(ValueError, match="divisible by 4"):
        try:
            _jax_fit("dp_odd", dp=N)
        finally:
            JM.init_mesh({"dp": 8})


def test_zero_shards_the_optimizer_state(port):
    for r in range(N):
        dp, zero = port[r]["fit_dp"], port[r]["fit_zero"]
        # Adam's two f32 moments of Linear(8, 1): 72 bytes whole; a rank's
        # chunks are 2 of the weight's 8 and 1 of the bias's (padded) 1
        assert dp["state_bytes"] == 72 and zero["state_bytes"] == 24
        for k in dp["params"]:
            np.testing.assert_allclose(zero["params"][k], dp["params"][k],
                                       rtol=0, atol=1e-6)


def test_localsgd_fit_replicas_match_jax(port):
    """strategy.localsgd k 2 through Model.train_batch: each rank's replica
    after each step against the JAX engine's replica of that dp index,
    the logged loss (the ranks' mean), and the average at the end."""
    *_, xl, yl = _data()
    _, _, small = _jax_nets()
    JM.init_mesh({"dp": N}, name="default")
    strat = jfleet.DistributedStrategy()
    strat.localsgd = True
    strat.localsgd_configs = {"k_steps": 2}
    opt = jfleet.distributed_optimizer(
        jopt.SGD(learning_rate=0.1, parameters=small.parameters()), strat)
    model = jp.Model(small)
    model.prepare(optimizer=opt, loss=jnn.MSELoss())
    for step in range(3):
        loss = float(np.asarray(model.train_batch([xl], [yl])[0]))
        reps = np.asarray(model._engine._localsgd["params"]["weight"])
        for r in range(N):
            rec = port[r]["fit_localsgd"]["steps"][step]
            np.testing.assert_allclose(rec["loss"], loss, rtol=1e-5)
            np.testing.assert_allclose(rec["w"], reps[r], **FIT_TOL)
        spread = np.ptp(np.stack([port[r]["fit_localsgd"]["steps"][step]["w"]
                                  for r in range(N)]), 0).max()
        assert (spread == 0) == (step == 1), (step, spread)
    model._engine.finalize_localsgd()
    for r in range(N):
        np.testing.assert_allclose(port[r]["fit_localsgd"]["params"]["weight"],
                                   np.asarray(small.weight._value), **FIT_TOL)
    JM.init_mesh({"dp": 8})


def test_localsgd_save_writes_the_replicas_average(port):
    """Model.save on every rank averages the replicas first (as
    ``finalize_localsgd``), then rank 0 writes."""
    saved = port[0]["fit_localsgd"]["saved"]
    assert set(saved) == set(port[0]["fit_localsgd"]["params"])
    for k, v in port[0]["fit_localsgd"]["params"].items():
        np.testing.assert_array_equal(saved[k], v)
        for r in range(1, N):
            np.testing.assert_array_equal(port[r]["fit_localsgd"]["params"][k],
                                          v)
    assert all("saved" not in port[r]["fit_localsgd"] for r in range(1, N))


def test_adaptive_localsgd_grows_k_as_jax(port):
    *_, xl, yl = _data()
    _, _, small = _jax_nets()
    JM.init_mesh({"dp": N}, name="default")
    strat = jfleet.DistributedStrategy()
    strat.adaptive_localsgd = True
    strat.localsgd_configs = {"k_steps": 1}
    opt = jfleet.distributed_optimizer(
        jopt.SGD(learning_rate=1e-8, parameters=small.parameters()), strat)
    model = jp.Model(small)
    model.prepare(optimizer=opt, loss=jnn.MSELoss())
    for _ in range(4):
        model.train_batch([xl], [yl])
    k = model._engine._localsgd["k"]
    JM.init_mesh({"dp": 8})
    assert k > 1
    assert [port[r]["fit_adaptive"]["k"] for r in range(N)] == [k] * N


def test_strategy_recompute_and_amp_reach_the_engine():
    """strategy.recompute recomputes the Transformer layers (the same
    loss and gradients as without), strategy.amp becomes the Model's AMP;
    one process, no mesh."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.device import device_scope
    rng = np.random.RandomState(8)
    x = rng.randn(4, 6, 16).astype("float32")
    y = rng.randn(4, 6, 16).astype("float32")
    out = {}
    for rc in (False, True):
        with device_scope("cpu"):
            tpt.seed(1)
            net = tnn.Sequential(tnn.TransformerEncoderLayer(16, 2, 32,
                                                             dropout=0.0))
            strategy = tfleet.DistributedStrategy()
            strategy.recompute = rc
            strategy.amp = rc
            strategy.amp_configs = {"level": "O1", "dtype": "bfloat16"}
            opt = tfleet.distributed_optimizer(
                topt.SGD(learning_rate=0.1, parameters=net.parameters()),
                strategy)
            model = tpt.Model(net)
            model.prepare(opt, loss=tnn.MSELoss())
            assert getattr(net[0], "_recompute", False) == rc
            assert (model._amp_configs or {}).get("level") == \
                ("O1" if rc else None)
            out[rc] = model.train_batch([x], [y])[0]
    np.testing.assert_allclose(out[True], out[False], rtol=2e-2)


def test_localsgd_trainer_matches_jax(port):
    w0, x, y = _lsgd_inputs()
    JM.init_mesh({"dp": N}, name="default")

    def step_fn(params, batch):
        def loss(w):
            return jnp.mean((batch[:, :4] @ w - batch[:, 4:]) ** 2)
        lv, g = jax.value_and_grad(loss)(params["w"])
        return lv, {"w": params["w"] - 0.1 * g}

    tr = JL.LocalSGD(step_fn, {"w": jnp.asarray(w0)}, k_steps=2)
    batch = jnp.asarray(np.concatenate([x, y], 1))
    losses, reps = [], []
    for _ in range(5):
        losses.append(tr.step(batch))
        reps.append(np.asarray(tr.params["w"]))
    avg = np.asarray(tr.averaged_params()["w"])
    JM.init_mesh({"dp": 8})
    for r in range(N):
        got = port[r]["localsgd"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for s in range(5):
            np.testing.assert_allclose(got["replicas"][s], reps[s][r],
                                       **FIT_TOL)
        np.testing.assert_allclose(got["averaged"], avg, **FIT_TOL)


def test_fleet_init_hybrid_mesh_and_util(port):
    for r in range(N):
        got = port[r]["fleet_init"]
        assert got["axes"] == ["dp", "tp"] and got["shape"] == {"dp": 2,
                                                                "tp": 2}
        assert got["sizes"] == [2, 2, 1]
        assert got["ranks"] == [r // 2, r % 2, 0]      # row-major
        assert got["worker"] == [r, N, r == 0]
        np.testing.assert_array_equal(got["util_sum"], [6.0, 4.0])
        np.testing.assert_array_equal(got["util_max"], [3, 0])
        assert got["util_gather"] == [{"rank": i} for i in range(N)]


def test_strategy_knobs_and_role_makers_equal_jax():
    js, ts = jfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    assert ts.to_dict() == js.to_dict()
    for s in (js, ts):
        s.hybrid_configs = {"mp_degree": 2}
    assert ts.hybrid_configs == js.hybrid_configs
    assert repr(ts) == repr(js)
    for mod in (jfleet, tfleet):
        rm = mod.UserDefinedRoleMaker(current_id=3, worker_num=5,
                                      server_endpoints=["a:1", "b:2"])
        assert (rm.worker_index(), rm.worker_num(), rm.server_num(),
                rm.get_pserver_endpoints(), rm.is_worker()) == \
            (3, 5, 2, ["a:1", "b:2"], True)
        assert mod.Role.SERVER == 2


def test_fleet_util_fs_and_single_process_facade(tmp_path):
    fs = tfleet.util.LocalFS()
    d = tmp_path / "a" / "b"
    fs.mkdirs(str(d))
    fs.touch(str(d / "f"))
    assert fs.ls_dir(str(tmp_path / "a")) == (["b"], [])
    assert fs.is_file(str(d / "f")) and fs.is_dir(str(d))
    fs.delete(str(tmp_path / "a"))
    assert not fs.is_exist(str(d))
    util = tfleet.util.UtilBase()
    np.testing.assert_array_equal(util.all_reduce([1.0, 2.0]), [1.0, 2.0])
    assert util.all_gather(7) == [7]
    with pytest.raises(RuntimeError, match="hadoop"):
        tfleet.util.HDFSClient(hadoop_home=str(tmp_path)).is_exist("/x")
    # the optimizer marks the strategy reads
    net = torch.nn.Linear(2, 2)
    from paddle_tpu_torch import optimizer as topt
    strategy = tfleet.DistributedStrategy()
    strategy.sharding = True
    strategy.amp = True
    strategy.amp_configs = {"level": "O2"}
    opt = tfleet.distributed_optimizer(
        topt.AdamW(parameters=list(net.named_parameters())), strategy)
    assert opt._zero_dp and opt._multi_precision and \
        opt._dist_strategy is strategy
    with pytest.raises(NotImplementedError, match="7c"):
        tfleet.spmd_report(layer=net)
    assert isinstance(tfleet.distributed_model(torch.nn.Linear(2, 2)),
                      torch.nn.Module)


_SERVER = textwrap.dedent("""
    import paddle_tpu_torch.distributed.fleet as fleet
    fleet.init(is_collective=False)
    assert fleet.is_server()
    fleet.init_server(tables={
        "emb": {"type": "sparse", "dim": 8, "optimizer": "adagrad",
                "lr": 0.2, "init": "uniform", "seed": 3},
        "bar": {"type": "barrier", "trainer_num": 2},
    })
    fleet.run_server()
""")

_WORKER = textwrap.dedent("""
    import os
    import numpy as np
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed.fleet as fleet
    from paddle_tpu_torch.distributed import ps

    paddle.set_device("cpu")
    strategy = fleet.DistributedStrategy()
    strategy.a_sync = True
    fleet.init(is_collective=False, strategy=strategy)
    assert fleet.is_worker() and not fleet.is_server()
    fleet.init_worker()
    client = fleet.ps_client()
    comm = fleet.ps_communicator()
    assert comm is not None  # a_sync selected the async path

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    emb = ps.SparseEmbedding(client, "emb", dim=8, communicator=comm)
    rng = np.random.RandomState(100 + rank)
    head = paddle.to_tensor(rng.randn(8).astype(np.float32) * 0.1,
                            stop_gradient=False)
    losses = []
    for step in range(40):
        ids = rng.randint(0, 64, size=(16,))
        labels = (ids % 2).astype(np.float32)
        rows, index = emb.pull(ids)
        feats = paddle.gather(rows, index)
        logits = paddle.matmul(feats, head)
        y = paddle.to_tensor(labels)
        loss = paddle.nn.functional.binary_cross_entropy_with_logits(
            logits, y)
        loss.backward()
        emb.push_grad(rows)
        head = paddle.to_tensor(head.numpy() - 0.1 * head.grad.numpy(),
                                stop_gradient=False)
        losses.append(float(loss.numpy()))
    comm.flush()
    client.barrier("bar", rank)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"worker {rank}: loss {first:.4f} -> {last:.4f}")
    assert last < first - 0.05, (first, last)
    fleet.stop_worker()
""")


def test_fleet_ps_end_to_end(tmp_path):
    """fleet.init(is_collective=False) over the PS tier: one server and two
    async workers in their own processes, the workers' loss falling (the
    JAX test's script on the port)."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port_no = s.getsockname()[1]
    s.close()
    env_base = {**os.environ,
                "PADDLE_PSERVERS_IP_PORT_LIST": f"127.0.0.1:{port_no}",
                "PADDLE_TRAINERS_NUM": "2", "PYTHONPATH": REPO}
    server = subprocess.Popen(
        [sys.executable, "-c", _SERVER],
        env={**env_base, "TRAINING_ROLE": "PSERVER",
             "PADDLE_PSERVER_ID": "0"},
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    workers = [subprocess.Popen(
        [sys.executable, "-c", _WORKER],
        env={**env_base, "TRAINING_ROLE": "TRAINER",
             "PADDLE_TRAINER_ID": str(i)},
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for w in workers:
            out, _ = w.communicate(timeout=300)
            outs.append(out)
        for w, out in zip(workers, outs):
            assert w.returncode == 0, f"worker failed:\n{out}"
        server_out, _ = server.communicate(timeout=60)
        assert server.returncode == 0, f"server failed:\n{server_out}"
    finally:
        for p in workers + [server]:
            if p.poll() is None:
                p.kill()
