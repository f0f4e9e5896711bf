"""Port parity: static control flow (paddle_tpu_torch/static/control_flow.py)
against paddle_tpu/static/control_flow.py.

tests/test_control_flow.py's cases run on both packages (the ``P``
fixture). The cond case with a backward section also holds the port's
losses and updated weights to JAX's (weights copied by module path, f32
to 1e-5), so the gradient through the taken branch agrees; the bounded
while loop trains to JAX's losses. The JAX case that pickles a Program
becomes, in the port, a round trip through ``program_serde`` (a port
Program does not pickle).
"""
import numpy as np
import pytest

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


def test_while_loop_executor_run(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4], "float32")
            i = ops.zeros([], "int32")
            n = ops.full([], 5, "int32")
            _, acc = static.nn.while_loop(
                lambda i, acc: ops.less_than(i, n),
                lambda i, acc: (i + 1, acc * 2.0), [i, x])
    xs = np.array([1, 2, 3, 4], "float32")
    out = P.static.Executor().run(main, feed={"x": xs}, fetch_list=[acc])[0]
    np.testing.assert_allclose(out, xs * 32.0)


def test_while_loop_shape_invariant_error(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4], "float32")
            i = ops.zeros([], "int32")
            with pytest.raises(ValueError, match="shape invariant"):
                static.nn.while_loop(
                    lambda i, a: ops.less_than(i, ops.full([], 3, "int32")),
                    lambda i, a: (i + 1, ops.concat([a, a])),
                    [i, x])


def _cond_program(P):
    ops = P.ops
    with static_mode(P) as static:
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [4], "float32")
            lin = P.nn.Linear(4, 4)
            h = lin(x)
            flag = ops.sum(h) > 0.0
            loss = static.nn.cond(flag, lambda: ops.sum(h * 2.0),
                                  lambda: ops.sum(h * -3.0))
            P.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, lin, loss


def test_cond_executor_run_and_grad(P):
    main, lin, loss = _cond_program(P)
    exe = P.static.Executor()
    xs = np.ones(4, "float32")
    w0 = scope_np(P, lin.weight)
    l0 = exe.run(main, feed={"x": xs}, fetch_list=[loss])[0]
    assert not np.allclose(w0, scope_np(P, lin.weight))
    l1 = exe.run(main, feed={"x": xs}, fetch_list=[loss])[0]
    assert float(l1) != float(l0)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cond_gradient_matches_jax(sign):
    progs = {P.name: _cond_program(P) for P in (JAX, PORT)}
    copy_static(progs["jax"][1], progs["port"][1])
    xs = np.full(4, sign, "float32") * np.arange(1, 5, dtype="float32")
    runs = {}
    for P in (JAX, PORT):
        main, lin, loss = progs[P.name]
        exe = P.static.Executor()
        losses = [float(exe.run(main, feed={"x": xs}, fetch_list=[loss])[0])
                  for _ in range(3)]
        runs[P.name] = (losses, scope_np(P, lin.weight),
                        scope_np(P, lin.bias))
    for a, b in zip(runs["port"], runs["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_cond_branch_mismatch_error(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [4], "float32")
            p = ops.sum(x) > 0.0
            with pytest.raises(ValueError, match="mismatch"):
                static.nn.cond(p, lambda: ops.sum(x),
                               lambda: ops.reshape(x, [2, 2]))


def _bounded_program(P):
    ops = P.ops
    with static_mode(P) as static:
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [1], "float32")
            lin = P.nn.Linear(1, 1, bias_attr=False)
            w = lin(x)
            i = ops.zeros([], "int32")
            three = ops.full([], 3, "int32")
            _, out = static.nn.while_loop(
                lambda i, v: ops.less_than(i, three),
                lambda i, v: (i + 1, v * 2.0), [i, w],
                maximum_trip_count=4)
            loss = ops.mean((out - 8.0) ** 2)
            P.optimizer.SGD(learning_rate=0.005).minimize(loss)
    return main, lin, loss


def test_while_loop_bounded_differentiable(P):
    main, lin, loss = _bounded_program(P)
    exe = P.static.Executor()
    xs = np.ones((1, 1), "float32")
    losses = [float(exe.run(main, feed={"x": xs}, fetch_list=[loss])[0])
              for _ in range(40)]
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])


def test_bounded_while_training_matches_jax():
    progs = {P.name: _bounded_program(P) for P in (JAX, PORT)}
    copy_static(progs["jax"][1], progs["port"][1])
    xs = np.ones((1, 1), "float32")
    runs = {}
    for P in (JAX, PORT):
        main, lin, loss = progs[P.name]
        exe = P.static.Executor()
        runs[P.name] = [float(exe.run(main, feed={"x": xs},
                                      fetch_list=[loss])[0])
                        for _ in range(10)]
    np.testing.assert_allclose(runs["port"], runs["jax"], rtol=1e-5)


def test_beam_search_style_decode(P):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program()
        with static.program_guard(main):
            logits = static.data("logits", [6, 8], "float32")
            i = ops.zeros([], "int32")
            steps = ops.full([], 6, "int32")
            chosen = ops.zeros([6], "int64")
            score = ops.zeros([], "float32")

            def body_fn(i, chosen, score):
                row = ops.gather(logits, ops.reshape(i, [1]))
                tok = ops.reshape(ops.argmax(row, axis=-1), [])
                s = ops.reshape(ops.max(row), [])
                onehot = (ops.arange(6, dtype="int32") ==
                          ops.reshape(i, [1])).astype("int64")
                return (i + 1, chosen + onehot * tok.astype("int64"),
                        score + s)

            _, chosen_f, score_f = static.nn.while_loop(
                lambda i, c, s: ops.less_than(i, steps), body_fn,
                [i, chosen, score])
    L = np.random.RandomState(0).randn(6, 8).astype("float32")
    toks, sc = P.static.Executor().run(main, feed={"logits": L},
                                       fetch_list=[chosen_f, score_f])
    np.testing.assert_array_equal(toks, L.argmax(-1))
    np.testing.assert_allclose(sc, L.max(-1).sum(), rtol=1e-5)


def test_while_program_round_trips_through_serde(P, tmp_path):
    ops = P.ops
    with static_mode(P) as static:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [2], "float32")
            i = ops.zeros([], "int32")
            lim = ops.full([], 4, "int32")
            _, y = static.nn.while_loop(
                lambda i, v: ops.less_than(i, lim),
                lambda i, v: (i + 1, v + 1.0), [i, x])
    main._jit_fetch_vars = [y]
    serde = __import__(P.paddle.__name__ + ".framework.program_serde",
                       fromlist=["save_program"])
    path = str(tmp_path / "w")
    serde.save_program(main, path, feed_names=["x"])
    main2, feeds = serde.load_program(path)
    out = P.static.Executor().run(main2, feed={"x": np.zeros(2, "float32")},
                                  fetch_list=main2._jit_fetch_vars)[0]
    np.testing.assert_allclose(out, [4.0, 4.0])


def test_dygraph_fallback(P):
    i = P.paddle.to_tensor(np.int32(0))
    x = P.paddle.to_tensor(np.float32(1.0))
    i_f, x_f = P.static.nn.while_loop(
        lambda i, v: i < 3, lambda i, v: (i + 1, v * 2.0), [i, x])
    assert float(to_np(x_f)) == 8.0
    assert P.static.nn.cond(P.paddle.to_tensor(True), lambda: 1,
                            lambda: 2) == 1
