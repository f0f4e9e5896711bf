"""Port parity: ``FLAGS_check_nan_inf`` (paddle_tpu_torch/core/
numeric_check.py) against paddle_tpu/core/numeric_check.py: the same
raise points and messages (the op's name, each bad entry's tree path,
the counts), and the state left unwritten.

- the op layer (``ops/_dispatch.defop``, JAX's ``core/tape.record_op``);
- ``Executor.run``: the sweep before the scope write-back (the scope is
  unchanged after the raise), in ``return_handles`` mode too;
- the PipelineRunner's sync: the carry swept before the write-back;
- ``Model``'s step: JAX's step is jitted (its ops see tracers and skip
  the check), so the port's runs without per-op checks and raises at the
  step's sweep, naming the loss and the parameters as JAX does.
"""
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import numeric_check as tnc
from paddle_tpu_torch.device import device_scope

from test_torch_static_cases import JAX, PKGS, PORT, static_mode, to_np


@pytest.fixture(autouse=True)
def _cpu_and_flag():
    with device_scope("cpu"):
        for f in (jflags, tflags):
            f.set_flags({"FLAGS_check_nan_inf": True})
        try:
            yield
        finally:
            for f in (jflags, tflags):
                f.set_flags({"FLAGS_check_nan_inf": False})


def _raised(fn):
    with pytest.raises(RuntimeError) as ei:
        fn()
    return str(ei.value)


@pytest.mark.parametrize("op,x", [
    ("log", [1.0, 0.0, -1.0]), ("sqrt", [4.0, -1.0]),
    ("exp", [1.0, 1000.0]), ("divide", [1.0, 0.0])])
def test_op_layer_names_the_op_as_jax(op, x):
    msgs = {}
    for name, P in PKGS.items():
        t = P.paddle.to_tensor(np.asarray(x, "float32"))
        if op == "divide":
            fn = lambda: P.paddle.divide(t, t * 0.0)          # noqa: E731
        else:
            fn = lambda: getattr(P.ops, op)(t)                # noqa: E731
        msgs[name] = _raised(fn)
    assert msgs["port"] == msgs["jax"]
    assert msgs["port"].startswith("[FLAGS_check_nan_inf] op '")


def test_op_layer_off_by_default_and_for_finite_values():
    t = PORT.paddle.to_tensor(np.asarray([0.0], "float32"))
    assert np.isfinite(to_np(PORT.ops.exp(t))).all()
    tflags.set_flags({"FLAGS_check_nan_inf": False})
    assert np.isneginf(to_np(PORT.ops.log(t))).all()


def _mlp(P):
    with static_mode(P) as static:
        P.paddle.seed(0)
        prog = static.Program("nan")
        with static.program_guard(prog, static.Program()):
            x = static.data("x", [2, 4], "float32")
            lin = P.nn.Linear(4, 1)
            loss = P.ops.mean(lin(x))
            P.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return prog, lin, loss


def _scope_vals(P, lin):
    return [to_np(P.static.global_scope().get(p.scope_name))
            for p in (lin.weight, lin.bias)]


def _paths(msg):
    """The bad entries' paths, a scope entry's name (numbered by each
    package's own counter) cut."""
    return [re.sub(r"\['scope'\]\['[^']*'\]", "['scope'][P]",
                   line.split(":")[0].strip())
            for line in msg.splitlines()[1:]]


@pytest.mark.parametrize("handles", [False, True])
def test_executor_sweeps_before_the_write_back_as_jax(handles):
    msgs = {}
    for name, P in PKGS.items():
        prog, lin, loss = _mlp(P)
        exe = P.static.Executor()
        feed = {"x": np.full((2, 4), np.inf, "float32")}
        before = _scope_vals(P, lin)
        msgs[name] = _raised(lambda: exe.run(prog, feed=feed,
                                             fetch_list=[loss],
                                             return_handles=handles))
        for a, b in zip(before, _scope_vals(P, lin)):
            np.testing.assert_array_equal(a, b)     # nothing written
        # a finite feed still trains
        exe.run(prog, feed={"x": np.ones((2, 4), "float32")},
                fetch_list=[loss])
        assert not np.array_equal(before[0], _scope_vals(P, lin)[0])
    head = "[FLAGS_check_nan_inf] non-finite values after Executor.run step:"
    assert msgs["port"].splitlines()[0] == msgs["jax"].splitlines()[0] == head
    assert _paths(msgs["port"]) == _paths(msgs["jax"])
    assert "['fetches'][0]" in msgs["port"]


def test_runner_sync_sweeps_the_carry_before_the_write_back():
    prog, lin, loss = _mlp(PORT)
    before = _scope_vals(PORT, lin)
    runner = PORT.static.PipelineRunner(PORT.static.Executor(), prog,
                                        fetch_list=[loss], max_inflight=2)
    tflags.set_flags({"FLAGS_check_nan_inf": False})   # the step itself
    runner.submit({"x": np.full((2, 4), np.inf, "float32")})
    tflags.set_flags({"FLAGS_check_nan_inf": True})
    msg = _raised(runner.sync)
    assert msg.startswith("[FLAGS_check_nan_inf] non-finite values after "
                          "PipelineRunner.sync (steps 0..0)")
    for a, b in zip(before, _scope_vals(PORT, lin)):
        np.testing.assert_array_equal(a, b)


class _JNet(jp.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jp.nn.Linear(4, 2)

    def forward(self, x):
        return self.fc(x)


def test_model_step_raises_at_its_sweep_as_jax():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.bridge import load_jax_params
    jp.seed(0)
    jnet = _JNet()
    tnet = torch.nn.Sequential()
    tnet.fc = pt.nn.Linear(4, 2)
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    x = np.ones((3, 4), "float32")
    x[1, 2] = np.inf
    y = np.zeros((3, 1), "int64")
    msgs = {}
    for name, (P, net) in {"jax": (JAX, jnet), "port": (PORT, tnet)}.items():
        m = P.paddle.Model(net)
        m.prepare(P.optimizer.SGD(learning_rate=0.1,
                                  parameters=m.parameters()),
                  loss=P.nn.CrossEntropyLoss())
        before = [to_np(p) for p in m.parameters()]
        msgs[name] = _raised(lambda: m.train_batch([x], [y]))
        if P is PORT:   # (JAX's raise leaves its parameters traced)
            for a, p in zip(before, m.parameters()):
                np.testing.assert_array_equal(a, to_np(p))
    head = ("[FLAGS_check_nan_inf] non-finite values after train_batch "
            "step:")
    assert msgs["port"].splitlines()[0] == msgs["jax"].splitlines()[0] \
        == head
    assert msgs["port"].splitlines()[1] == msgs["jax"].splitlines()[1]
    assert msgs["port"].splitlines()[1].startswith("  ['loss']: ")


def test_sweep_paths_are_keystr_paths():
    tree = {"b": [torch.tensor([1.0]), torch.tensor([np.nan, np.inf])],
            "a": {"w": np.asarray([np.inf], "float32")},
            "i": torch.tensor([1, 2])}
    msg = _raised(lambda: tnc.sweep(tree, "ctx"))
    assert msg.splitlines()[1:] == [
        "  ['a']['w']: 0 nan / 1 inf (shape=(1,))",
        "  ['b'][1]: 1 nan / 1 inf (shape=(2,))"]
    from paddle_tpu.core import numeric_check as jnc
    jmsg = _raised(lambda: jnc.sweep(
        {"b": [np.asarray([1.0]), np.asarray([np.nan, np.inf])],
         "a": {"w": np.asarray([np.inf], "float32")}}, "ctx"))
    assert msg == jmsg


def test_complex_values_are_not_checked_as_jax():
    """Queue 3 F2: both packages check floating dtypes only; a complex
    nan passes the op layer and the sweep."""
    x = np.asarray([np.nan + 1j, 1 + 2j], "complex64")
    for P in PKGS.values():
        t = P.paddle.to_tensor(x)
        out = to_np(P.paddle.multiply(t, t))
        assert np.isnan(out[0]) and out.dtype == np.complex64
    from paddle_tpu.core import numeric_check as jnc
    jnc.sweep({"c": x}, "ctx")
    tnc.sweep({"c": torch.from_numpy(x)}, "ctx")


def test_namedtuple_leaves_are_named_by_field_as_jax():
    """Queue 3 F2: a namedtuple's leaves carry their field names, as
    ``jax.tree_util.keystr`` writes them."""
    import collections
    from paddle_tpu.core import numeric_check as jnc
    NT = collections.namedtuple("NT", ["loss", "w"])
    jmsg = _raised(lambda: jnc.sweep(
        {"a": NT(loss=np.asarray(1.0, "float32"),
                 w=[np.asarray([np.nan], "float32")])}, "ctx"))
    msg = _raised(lambda: tnc.sweep(
        {"a": NT(loss=torch.tensor(1.0), w=[torch.tensor([np.nan])])},
        "ctx"))
    assert msg == jmsg
    assert msg.splitlines()[1].startswith("  ['a'].w[0]: ")
