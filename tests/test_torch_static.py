"""Port parity: the static graph (paddle_tpu_torch/static) against
paddle_tpu/static.

The cases of tests/test_static.py and tests/test_static_review_fixes.py
run on both packages (the ``P`` fixture), and the numeric ones compare the
port's fetches with JAX's: the same program built in each package, the
JAX scope's weights copied into the port's by module path, the same
seeded numpy feeds, f32 to 1e-5 (relative) unless stated.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.device import device_scope

from test_torch_static_cases import (JAX, PKGS, PORT, copy_static,
                                     scope_np, static_mode, to_np)


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


def _linear_program(P):
    with static_mode(P) as static:
        main = static.Program("main")
        with static.program_guard(main):
            x = static.data("x", [-1, 4], "float32")
            net = P.nn.Linear(4, 3)
            y = net(x)
            assert isinstance(y, static.Variable)
    return main, net, y


def test_static_forward_linear(P):
    main, net, y = _linear_program(P)
    exe = P.static.Executor()
    exe.run(P.static.default_startup_program())
    xv = np.random.RandomState(0).rand(5, 4).astype("float32")
    (out,) = exe.run(main, feed={"x": xv}, fetch_list=[y])
    assert out.shape == (5, 3)
    np.testing.assert_allclose(out, xv @ scope_np(P, net.weight)
                               + scope_np(P, net.bias), rtol=1e-5)


def test_linear_forward_matches_jax():
    jmain, jnet, jy = _linear_program(JAX)
    tmain, tnet, ty = _linear_program(PORT)
    copy_static(jnet, tnet)
    xv = np.random.RandomState(1).rand(5, 4).astype("float32")
    (want,) = JAX.static.Executor().run(jmain, feed={"x": xv},
                                        fetch_list=[jy])
    (got,) = PORT.static.Executor().run(tmain, feed={"x": xv},
                                        fetch_list=[ty])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_program_to_string_lists_ops(P):
    with static_mode(P) as static:
        main = static.Program("m")
        with static.program_guard(main):
            x = static.data("x", [2, 2])
            P.ops.exp(x) + 1.0
    s = str(main)
    assert "exp" in s and "data" in s and "add" in s


def test_to_string_op_names_match_jax():
    names = {}
    for P in (JAX, PORT):
        with static_mode(P) as static:
            main = static.Program("m")
            with static.program_guard(main):
                x = static.data("x", [2, 3])
                y = P.ops.exp(x) * 2.0 - 1.0
                P.ops.mean(P.ops.tanh(y))
        names[P.name] = [op.name for op in main.ops]
    assert names["port"] == names["jax"]


def _regression_program(P, opt_cls, lr):
    with static_mode(P) as static:
        main = static.Program("train")
        with static.program_guard(main):
            x = static.data("x", [-1, 3], "float32")
            label = static.data("y", [-1, 1], "float32")
            net = P.nn.Linear(3, 1, bias_attr=False)
            loss = P.ops.mse_loss(net(x), label)
            opt_cls(P)(learning_rate=lr).minimize(loss)
    return main, net, loss


def _xy():
    rng = np.random.RandomState(0)
    X = rng.rand(64, 3).astype("float32")
    W = np.array([[1.0], [2.0], [3.0]], dtype="float32")
    return X, X @ W, W


def test_static_training_converges(P):
    main, net, loss = _regression_program(
        P, lambda P: P.optimizer.SGD, 0.1)
    exe = P.static.Executor()
    X, Y, W = _xy()
    losses = [float(exe.run(main, feed={"x": X, "y": Y},
                            fetch_list=[loss])[0]) for _ in range(200)]
    assert losses[-1] < losses[0] * 0.01, losses[-1]
    np.testing.assert_allclose(scope_np(P, net.weight), W, atol=0.2)


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_convergence_matches_jax_over_6_steps(opt):
    runs = {}
    progs = {P.name: _regression_program(
        P, lambda P: getattr(P.optimizer, opt), 0.1) for P in (JAX, PORT)}
    copy_static(progs["jax"][1], progs["port"][1])
    X, Y, _ = _xy()
    for P in (JAX, PORT):
        main, net, loss = progs[P.name]
        exe = P.static.Executor()
        runs[P.name] = ([float(exe.run(main, feed={"x": X, "y": Y},
                                       fetch_list=[loss])[0])
                         for _ in range(6)], scope_np(P, net.weight))
    np.testing.assert_allclose(runs["port"][0], runs["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(runs["port"][1], runs["jax"][1], rtol=1e-5)
    assert runs["port"][0][-1] < runs["port"][0][0]


def test_append_backward_grads_fetchable(P):
    with static_mode(P) as static:
        main = static.Program("bwd")
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            net = P.nn.Linear(2, 1, bias_attr=False)
            loss = P.ops.mean(net(x))
            pairs = static.append_backward(loss)
            assert len(pairs) == 1
    exe = P.static.Executor()
    (g,) = exe.run(main, feed={"x": np.ones((2, 2), "float32")},
                   fetch_list=[pairs[0][1]])
    np.testing.assert_allclose(g, np.full((2, 1), 1.0), rtol=1e-5)


def test_static_batchnorm_state_persists(P):
    with static_mode(P) as static:
        main = static.Program("bn")
        with static.program_guard(main):
            x = static.data("x", [8, 4], "float32")
            bn = P.nn.BatchNorm1D(4, momentum=0.5)
            out = bn(x)
    exe = P.static.Executor()
    xv = np.random.RandomState(0).rand(8, 4).astype("float32") + 5.0
    exe.run(main, feed={"x": xv}, fetch_list=[out])
    m1 = scope_np(P, bn._mean)
    exe.run(main, feed={"x": xv}, fetch_list=[out])
    m2 = scope_np(P, bn._mean)
    assert not np.allclose(m1, 0.0)
    assert not np.allclose(m1, m2)


def test_batchnorm_running_stats_match_jax():
    stats = {}
    for P in (JAX, PORT):
        with static_mode(P) as static:
            main = static.Program("bn")
            with static.program_guard(main):
                x = static.data("x", [8, 4], "float32")
                bn = P.nn.BatchNorm1D(4, momentum=0.5)
                out = bn(x)
        exe = P.static.Executor()
        xv = np.random.RandomState(0).rand(8, 4).astype("float32") + 5.0
        outs = [exe.run(main, feed={"x": xv * (i + 1)},
                        fetch_list=[out])[0] for i in range(2)]
        stats[P.name] = (outs, scope_np(P, bn._mean),
                         scope_np(P, bn._variance))
    for a, b in zip(stats["port"][0], stats["jax"][0]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stats["port"][1], stats["jax"][1], rtol=1e-5)
    # the JAX formula's variance, E[x^2] - E[x]^2 at means near 5-10 in
    # f32, keeps ~4 digits whatever the summation order
    np.testing.assert_allclose(stats["port"][2], stats["jax"][2], rtol=1e-4)


def test_executor_program_cache(P):
    with static_mode(P) as static:
        main = static.Program("cache")
        with static.program_guard(main):
            x = static.data("x", [4, 4], "float32")
            y = P.ops.exp(x)
    exe = P.static.Executor()
    xv = np.zeros((4, 4), "float32")
    exe.run(main, feed={"x": xv}, fetch_list=[y])
    n = len(exe._cache)
    exe.run(main, feed={"x": xv}, fetch_list=[y])
    assert len(exe._cache) == n


def test_executor_counts_one_lowering_and_evicts():
    from paddle_tpu_torch.core import flags, monitor
    with static_mode(PORT) as static:
        main = static.Program("cache")
        with static.program_guard(main):
            x = static.data("x", [-1, 4], "float32")
            y = PORT.ops.exp(x)
    exe = static.Executor()
    low0 = monitor.stat_get("executor/lowerings")
    runs0 = monitor.stat_get("executor/runs")
    for _ in range(3):
        exe.run(main, feed={"x": np.zeros((2, 4), "float32")},
                fetch_list=[y])
    assert monitor.stat_get("executor/lowerings") - low0 == 1
    assert monitor.stat_get("executor/runs") - runs0 == 3
    flags.set_flags({"FLAGS_executor_cache_size": 1})
    try:
        ev0 = monitor.stat_get("executor/cache_evictions")
        exe.run(main, feed={"x": np.zeros((3, 4), "float32")},
                fetch_list=[y])        # a new fed shape: a new entry
        assert monitor.stat_get("executor/cache_evictions") - ev0 == 1
    finally:
        flags.set_flags({"FLAGS_executor_cache_size": 32})


def test_static_save_load(P, tmp_path):
    with static_mode(P) as static:
        main = static.Program("sv")
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            net = P.nn.Linear(2, 2)
            net(x)
    path = str(tmp_path / "model")
    P.static.save(main, path)
    old = scope_np(P, net.weight)
    P.static.global_scope().set(net.weight.scope_name,
                                torch.zeros(2, 2) if P is PORT
                                else np.zeros((2, 2), "float32"))
    P.static.load(main, path)
    np.testing.assert_allclose(scope_np(P, net.weight), old)


def test_static_nn_fc(P):
    with static_mode(P) as static:
        main = static.Program("fc")
        with static.program_guard(main):
            x = static.data("x", [3, 5], "float32")
            y = static.nn.fc(x, size=7, activation="relu")
    exe = P.static.Executor()
    (out,) = exe.run(main, feed={"x": np.random.rand(3, 5).astype(
        "float32")}, fetch_list=[y])
    assert out.shape == (3, 7)
    assert (out >= 0).all()


def test_static_dropout_mask_differs_per_run(P):
    with static_mode(P) as static:
        main = static.Program("drop")
        with static.program_guard(main):
            x = static.data("x", [4, 64], "float32")
            out = P.nn.functional.dropout(x, p=0.5, training=True)
    exe = P.static.Executor()
    xv = np.ones((4, 64), "float32")
    (a,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    (b,) = exe.run(main, feed={"x": xv}, fetch_list=[out])
    assert not np.allclose(a, b), "dropout mask must differ across runs"


def test_dropout_masks_follow_the_seed():
    with static_mode(PORT) as static:
        main = static.Program("drop")
        with static.program_guard(main):
            x = static.data("x", [4, 64], "float32")
            out = PORT.nn.functional.dropout(x, p=0.5, training=True)
    xv = np.ones((4, 64), "float32")
    runs = []
    for _ in range(2):
        PORT.paddle.seed(7)
        exe = static.Executor()
        runs.append([exe.run(main, feed={"x": xv}, fetch_list=[out])[0]
                     for _ in range(2)])
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_clone_for_test_freezes_bn_and_drops_dropout(P):
    with static_mode(P) as static:
        main = static.Program("cft")
        with static.program_guard(main):
            x = static.data("x", [8, 4], "float32")
            bn = P.nn.BatchNorm1D(4)
            out = P.nn.functional.dropout(bn(x), p=0.9, training=True)
    test_prog = main.clone(for_test=True)
    assert test_prog.state_writes == {}
    exe = P.static.Executor()
    xv = np.random.RandomState(0).rand(8, 4).astype("float32") + 3.0
    m_before = scope_np(P, bn._mean)
    (o1,) = exe.run(test_prog, feed={"x": xv}, fetch_list=[out])
    (o2,) = exe.run(test_prog, feed={"x": xv}, fetch_list=[out])
    np.testing.assert_allclose(m_before, scope_np(P, bn._mean))
    np.testing.assert_allclose(o1, o2)


def test_nontrained_persistable_survives_a_run(P):
    with static_mode(P) as static:
        main = static.Program("frozen")
        with static.program_guard(main):
            x = static.data("x", [4, 4], "float32")
            frozen = P.nn.Linear(4, 4)
            for p in frozen.parameters():
                p.trainable = False
                p.stop_gradient = True
            head = P.nn.Linear(4, 2)
            loss = P.ops.mean(head(frozen(x)))
            P.optimizer.SGD(learning_rate=0.1).minimize(
                loss, parameters=head.parameters())
    exe = P.static.Executor()
    xv = np.random.rand(4, 4).astype("float32")
    w0 = scope_np(P, frozen.weight).copy()
    h0 = scope_np(P, head.weight).copy()
    for _ in range(3):
        exe.run(main, feed={"x": xv}, fetch_list=[loss])
    np.testing.assert_allclose(w0, scope_np(P, frozen.weight))
    assert not np.allclose(h0, scope_np(P, head.weight))


def test_static_vars_in_dynamic_mode_raise(P):
    with static_mode(P) as static:
        main = static.Program("err")
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            net = P.nn.Linear(2, 2)
            net(x)
    with pytest.raises(RuntimeError, match="static-graph Variables"):
        net(P.paddle.randn([2, 2]))


def test_variable_truth_value_raises(P):
    with static_mode(P) as static:
        main = static.Program("b")
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            for fn in (bool, float, int):
                with pytest.raises(TypeError, match="graph-build time"):
                    fn(P.ops.sum(x))


def test_torch_function_on_a_variable_raises_by_name():
    with static_mode(PORT) as static:
        main = static.Program("t")
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            with pytest.raises(TypeError, match="sin"):
                torch.sin(x)
            assert tuple(x.shape) == (2,) and x.dtype == torch.float32
            assert x.device.type == "cpu"


def test_static_gradients_rejects_data_vars(P):
    with static_mode(P) as static:
        main = static.Program("g")
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            net = P.nn.Linear(2, 1)
            loss = P.ops.mean(net(x))
            with pytest.raises(NotImplementedError):
                static.gradients(loss, [x])


def test_static_gradients_of_parameters(P):
    with static_mode(P) as static:
        main = static.Program("g")
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            net = P.nn.Linear(2, 1, bias_attr=False)
            loss = P.ops.mean(net(x))
            (g,) = static.gradients(loss, [net.weight])
    (gv,) = P.static.Executor().run(
        main, feed={"x": np.full((2, 2), 3.0, "float32")}, fetch_list=[g])
    np.testing.assert_allclose(gv, np.full((2, 1), 3.0), rtol=1e-6)


def test_unused_parameter_gets_a_zero_gradient():
    """An unused parameter's gradient is zeros, as under jax.grad, and
    AdamW still decays it, as in the JAX package."""
    vals = {}
    progs = {}
    for P in (JAX, PORT):
        with static_mode(P) as static:
            main = static.Program("u")
            with static.program_guard(main):
                x = static.data("x", [2, 2], "float32")
                used, unused = P.nn.Linear(2, 1), P.nn.Linear(2, 1)
                loss = P.ops.mean(used(x))
                opt = P.optimizer.AdamW(
                    learning_rate=0.1, weight_decay=0.5,
                    parameters=used.parameters() + unused.parameters())
                _, pairs = opt.minimize(loss)
        progs[P.name] = (main, used, unused, loss, pairs)
    copy_static(progs["jax"][1], progs["port"][1])
    copy_static(progs["jax"][2], progs["port"][2])
    for P in (JAX, PORT):
        main, used, unused, loss, pairs = progs[P.name]
        g = [gv for p, gv in pairs if p.name == unused.weight.name][0]
        (gw,) = P.static.Executor().run(
            main, feed={"x": np.ones((2, 2), "float32")}, fetch_list=[g])
        vals[P.name] = (gw, scope_np(P, unused.weight))
    np.testing.assert_array_equal(vals["port"][0], 0.0)
    np.testing.assert_allclose(vals["port"][1], vals["jax"][1], rtol=1e-6)


def test_executor_raises_for_the_later_items():
    from paddle_tpu_torch.core import flags
    with static_mode(PORT) as static:
        main = static.Program("n")
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            y = PORT.ops.exp(x)
    exe = static.Executor()
    # the parameter-server modes of train_from_dataset are ported
    # (tests/test_torch_ps.py): a ps_config without its client is refused
    # as the JAX package refuses it
    with pytest.raises(KeyError, match="client"):
        exe.train_from_dataset(main, dataset=object(), ps_config={"x": 1})
    flags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        (got,) = exe.run(main, feed={"x": np.ones(2, "float32")},
                         fetch_list=[y])
        np.testing.assert_allclose(got, np.exp(np.ones(2)), rtol=1e-6)
        with pytest.raises(RuntimeError, match="Executor.run step"):
            exe.run(main, feed={"x": np.full(2, 1e30, "float32")},
                    fetch_list=[y])
    finally:
        flags.set_flags({"FLAGS_check_nan_inf": False})
    # recompute segments are ported (tests/test_torch_static_dp.py): a
    # checkpointed program runs as the plain one
    main.recompute_checkpoints = [y.name]
    (got,) = exe.run(main, feed={"x": np.ones(2, "float32")},
                     fetch_list=[y])
    np.testing.assert_allclose(got, np.exp(np.ones(2)), rtol=1e-6)


def test_fetch_without_numpy_does_not_alias_the_scope():
    with static_mode(PORT) as static:
        main = static.Program("alias")
        with static.program_guard(main):
            x = static.data("x", [2, 2], "float32")
            net = PORT.nn.Linear(2, 2)
            loss = PORT.ops.mean(net(x))
            PORT.optimizer.SGD(learning_rate=0.5).minimize(loss)
    exe = static.Executor()
    feed = {"x": np.ones((2, 2), "float32")}
    (w,) = exe.run(main, feed=feed, fetch_list=[net.weight],
                   return_numpy=False)
    before = w.clone()
    exe.run(main, feed=feed, fetch_list=[loss])
    torch.testing.assert_close(w, before)
    assert not torch.equal(static.global_scope().get(
        net.weight.scope_name), before)


def test_save_inference_model_round_trip(P, tmp_path):
    with static_mode(P) as static:
        main = static.Program("inf")
        with static.program_guard(main):
            x = static.data("x", [3, 4], "float32")
            net = P.nn.Linear(4, 2)
            y = P.ops.tanh(net(x))
            loss = P.ops.mean(y)
            P.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = P.static.Executor()
    xv = np.random.RandomState(3).rand(3, 4).astype("float32")
    (want,) = exe.run(main.clone(for_test=True), feed={"x": xv},
                      fetch_list=[y])
    prefix = str(tmp_path / "inf")
    P.static.save_inference_model(prefix, [x], [y], exe, program=main)
    prog, feeds, fetches = P.static.load_inference_model(prefix, exe)
    assert feeds == ["x"]
    (got,) = exe.run(prog, feed={"x": xv}, fetch_list=fetches)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_enable_static_switches(P):
    assert P.paddle.in_dynamic_mode()
    P.paddle.enable_static()
    try:
        assert not P.paddle.in_dynamic_mode()
    finally:
        P.paddle.disable_static()
    assert P.paddle.in_dynamic_mode()


def test_layer_to_dtype_in_static_mode_casts_the_scope():
    with static_mode(PORT) as static:
        main = static.Program("cast")
        with static.program_guard(main):
            net = PORT.nn.Linear(2, 2)
            w0 = scope_np(PORT, net.weight)
            b0 = scope_np(PORT, net.bias)
            net.to(dtype="bfloat16")
            x = static.data("x", [1, 2], "bfloat16")
            y = net(x)
    assert net.weight.dtype == torch.bfloat16
    assert main.persistable_vars[net.weight.scope_name] is net.weight
    assert static.global_scope().get(net.weight.scope_name).dtype \
        == torch.bfloat16
    (out,) = static.Executor().run(main, feed={"x": np.ones((1, 2),
                                                            "float32")},
                                   fetch_list=[y])
    np.testing.assert_allclose(out, w0.sum(0, keepdims=True) + b0,
                               rtol=2e-2, atol=2e-2)
