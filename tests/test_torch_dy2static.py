"""Port parity: dygraph-to-static (paddle_tpu_torch/jit/dy2static.py)
against paddle_tpu/jit/dy2static.py.

tests/test_dy2static.py's cases run on both packages (the ``P``
fixture) with the same inputs and expected values; the layer cases also
hold the port's loaded outputs to JAX's (weights copied by module path,
f32 to 1e-5). The JAX package's ``to_static`` runs ``jax.jit``, the
port's runs the converted function eagerly: where JAX's trace refuses a
branch that assigns different Python values (a string), the port's eager
run takes the branch (``test_known_difference_...``).
"""
import os

import numpy as np
import pytest

from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.device import device_scope

from test_torch_static_cases import JAX, PKGS, PORT, to_np


@pytest.fixture(autouse=True)
def _cpu():
    with device_scope("cpu"):
        yield


@pytest.fixture(params=list(PKGS))
def P(request):
    return PKGS[request.param]


def _t(P, a):
    return P.paddle.to_tensor(np.asarray(a))


def _convert(P):
    return __import__(P.jit.__name__ + ".dy2static",
                      fromlist=["convert_function"]).convert_function


def test_if_data_dependent(P):
    def branchy(x):
        if x.mean() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y

    pos, neg = np.full((2, 3), 2.0, "float32"), np.full((2, 3), -2.0,
                                                       "float32")
    st = P.jit.to_static(branchy)
    conv = _convert(P)(branchy)
    for x, want in ((pos, pos * 2), (neg, neg - 1)):
        np.testing.assert_allclose(to_np(branchy(_t(P, x))), want)
        np.testing.assert_allclose(to_np(st(_t(P, x))), want)
        np.testing.assert_allclose(to_np(conv(_t(P, x))), want)


def test_while_static_bound_unchanged(P):
    def loopy(x):
        s = P.paddle.to_tensor(np.zeros((), "float32"))
        i = 0
        while i < x.shape[0]:
            s = s + x[i].sum()
            i += 1
        return s

    x = _t(P, np.arange(6, dtype="float32").reshape(3, 2))
    np.testing.assert_allclose(to_np(_convert(P)(loopy)(x)),
                               to_np(loopy(x)))


def test_while_data_dependent(P):
    def data_dep_loop(x):
        n = P.paddle.to_tensor(np.zeros((), "int32"))
        while x.sum() < 100.0:
            x = x * 2.0
            n = n + 1
        return x, n

    x0 = np.full((4,), 1.0, "float32")
    out, n = P.jit.to_static(data_dep_loop)(_t(P, x0))
    eo, en = data_dep_loop(_t(P, x0))
    np.testing.assert_allclose(to_np(out), to_np(eo))
    assert int(to_np(n)) == int(to_np(en)) == 5


def test_for_range_semantics_preserved(P):
    def f(x):
        acc = x * 0.0
        for i in range(3):
            acc = acc + x * float(i + 1)
        return acc, i

    out, i = _convert(P)(f)(_t(P, np.ones((2,), "float32")))
    np.testing.assert_allclose(to_np(out), np.full((2,), 6.0, "float32"))
    assert i == 2


def test_bool_ops_on_tensors(P):
    def f(x):
        if (x.mean() > 0) and (x.max() < 10):
            return x + 1.0
        else:
            return x - 1.0

    st = P.jit.to_static(f)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((3,), 2.0,
                                                      "float32")))), 3.0)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((3,), 50.0,
                                                      "float32")))), 49.0)


def test_early_return_no_else(P):
    def f(x):
        if x.mean() > 0:
            return x + 1.0
        return x - 1.0

    st = P.jit.to_static(f)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((3,), 2.0,
                                                      "float32")))), 3.0)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((3,), -2.0,
                                                      "float32")))), -3.0)


def test_early_return_with_trailing_code(P):
    def f(x):
        if x.mean() > 0:
            y = x * 2.0
            return y
        z = x * 3.0
        z = z + 1.0
        return z

    st = P.jit.to_static(f)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((3,), 2.0,
                                                      "float32")))), 4.0)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((3,), -2.0,
                                                      "float32")))), -5.0)


def test_early_return_rebinding_an_outer_local(P):
    """A folded early return whose trailing code rebinds a local assigned
    before the `if` (MultiHeadAttention.forward's shape): the port threads
    the local into the branch function; JAX's rewriter leaves it unbound
    there and converts only where the branch is not taken."""
    def f(x, cache=None):
        k = x * 2.0
        if cache is not None:
            return k
        if x.mean() > 100.0:
            k = k + 1.0
        return k * 3.0

    conv = _convert(PORT)(f)
    x = _t(PORT, np.ones((2,), "float32"))
    np.testing.assert_allclose(to_np(conv(x)), 6.0)
    np.testing.assert_allclose(to_np(conv(x, cache=1)), 2.0)


def test_static_python_branch_still_works(P):
    def f(x, flag=True):
        if flag:
            return x * 3.0
        return x

    conv = _convert(P)(f)
    x = _t(P, np.ones((2,), "float32"))
    np.testing.assert_allclose(to_np(conv(x)), 3.0)
    np.testing.assert_allclose(to_np(conv(x, flag=False)), 1.0)


def test_nested_if_in_while(P):
    def f(x):
        i = 0
        s = x * 0.0
        while i < 4:
            if x.mean() > 0:
                s = s + x
            else:
                s = s - x
            i += 1
        return s

    st = P.jit.to_static(f)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((2,), 1.0,
                                                      "float32")))), 4.0)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((2,), -1.0,
                                                      "float32")))), 4.0)


def test_branch_with_python_values():
    def f(x):
        if x.mean() > 0:
            tag = "pos"
        else:
            tag = "neg"
        return x, tag

    with pytest.raises(Exception, match="non-tensor|structure|branch"):
        JAX.jit.to_static(f)(_t(JAX, np.ones((2,), "float32")))


def test_known_difference_port_to_static_runs_python_branches_eagerly():
    def f(x):
        if x.mean() > 0:
            tag = "pos"
        else:
            tag = "neg"
        return x, tag

    _, tag = PORT.jit.to_static(f)(_t(PORT, np.ones((2,), "float32")))
    assert tag == "pos"


def _dynamic_net(P):
    class DynamicNet(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.mean() > 0:
                h = P.ops.relu(h)
            else:
                h = h * 0.5
            i = 0
            while i < 3:
                h = h + 0.1
                i += 1
            return h
    return DynamicNet()


def _loop_net(P):
    class LoopNet(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.scale = self.create_parameter(
                [1], default_initializer=P.nn.initializer.Constant(2.0))

        def forward(self, x):
            s = x
            while s.sum() < 50.0:
                s = s * self.scale
            return s
    return LoopNet()


def _elif_net(P):
    class ElifNet(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.mean() > 1.0:
                return h * 10.0
            elif h.mean() > 0.0:
                return h + 100.0
            return h - 1000.0
    return ElifNet()


def _outer_net(P):
    class GatedBlock(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.mean() > 0:
                return h * 2.0
            return h * 0.5

    class OuterNet(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.block = GatedBlock()
            self.head = P.nn.Linear(4, 2)

        def forward(self, x):
            return self.head(self.block(x))
    return OuterNet()


NETS = {"dynamic": (_dynamic_net, [np.random.RandomState(s).randn(2, 4)
                                   .astype("float32") * sign
                                   for s, sign in ((0, 1.0), (1, -1.0))]),
        "loop": (_loop_net, [np.full((2, 2), 1.0, "float32"),
                             np.full((2, 2), 4.0, "float32")]),
        "elif": (_elif_net, [np.full((2, 4), v, "float32")
                             for v in (5.0, 0.05, -5.0)]),
        "sublayer": (_outer_net, [
            np.random.RandomState(0).randn(2, 4).astype("float32"),
            -np.abs(np.random.RandomState(1).randn(2, 4)).astype("float32")
            * 3.0])}


@pytest.mark.parametrize("kind", list(NETS))
def test_layer_save_load_matches_eager_and_jax(kind, tmp_path):
    make, xs = NETS[kind]
    loaded_out = {}
    jnet = make(JAX)
    tnet = make(PORT)
    params, bufs = jnet.functional_state()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in params.items()})
    for P, net in ((JAX, jnet), (PORT, tnet)):
        net.eval()
        want = [to_np(net(_t(P, x))) for x in xs]
        st = P.jit.to_static(net)
        for x, w in zip(xs, want):
            np.testing.assert_allclose(to_np(st(_t(P, x))), w, rtol=1e-5,
                                       atol=1e-6)
        net2 = make(P)
        if P is PORT:
            load_jax_params(net2, {k: np.asarray(v)
                                   for k, v in params.items()})
        else:
            net2.load_functional_state(params, bufs)
        net2.eval()
        path = str(tmp_path / f"{kind}_{P.name}")
        shape = list(xs[0].shape)
        P.jit.save(net2, path,
                   input_spec=[P.jit.InputSpec(shape, "float32", "x")])
        assert all("forward" not in m.__dict__
                   for m in net2.sublayers(include_self=True))
        loaded = P.jit.load(path)
        outs = [to_np(loaded(_t(P, x))) for x in xs]
        for o, w in zip(outs, want):
            np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-5)
        loaded_out[P.name] = outs
    for a, b in zip(loaded_out["port"], loaded_out["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_tuple_valued_local_through_branch(P):
    def f(x):
        if x.mean() > 0:
            pair = (x * 2.0, x + 1.0)
        else:
            pair = (x * 3.0, x - 1.0)
        return pair[0] + pair[1]

    st = P.jit.to_static(f)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((2,), 1.0,
                                                      "float32")))), 4.0)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((2,), -1.0,
                                                      "float32")))), -5.0)


def test_closure_capture_preserved(P):
    scale = 3.0
    offset = _t(P, np.full((2,), 10.0, "float32"))

    def f(x):
        if x.mean() > 0:
            y = x * scale + offset
        else:
            y = x * scale - offset
        return y

    np.testing.assert_allclose(
        to_np(P.jit.to_static(f)(_t(P, np.full((2,), 2.0, "float32")))),
        16.0)


def test_super_call_survives_conversion(P):
    class Base(P.nn.Layer):
        def forward(self, x):
            return x * 2.0

    class Child(Base):
        def forward(self, x):
            h = super().forward(x)
            if h.mean() > 0:
                h = h + 1.0
            else:
                h = h - 1.0
            return h

    st = P.jit.to_static(Child())
    np.testing.assert_allclose(to_np(st(_t(P, np.full((2,), 1.0,
                                                      "float32")))), 3.0)
    np.testing.assert_allclose(to_np(st(_t(P, np.full((2,), -1.0,
                                                      "float32")))), -3.0)


def test_while_tensor_accumulator_with_aux_string(P):
    def f(x):
        tag = "iter"
        i = 0
        while i < 3:
            x = x + 1.0
            i += 1
        assert tag == "iter"
        return x

    np.testing.assert_allclose(to_np(P.jit.to_static(f)(
        _t(P, np.zeros((2,), "float32")))), 3.0)


def test_for_else_clause(P):
    def f(x):
        for i in range(2):
            x = x + 1.0
        else:
            x = x * 10.0
        return x

    np.testing.assert_allclose(to_np(_convert(P)(f)(
        _t(P, np.zeros((2,), "float32")))), 20.0)


_GLOBAL_SCALE = 2.0


def _scaled_branch(x):
    if x.mean() > 0:
        y = x * _GLOBAL_SCALE
    else:
        y = x - _GLOBAL_SCALE
    return y


def test_monkeypatch_after_convert(P):
    global _GLOBAL_SCALE
    conv = _convert(P)(_scaled_branch)
    assert conv is not _scaled_branch
    x = _t(P, np.ones((2, 2), "float32"))
    np.testing.assert_allclose(to_np(conv(x)), np.full((2, 2), 2.0))
    old = _GLOBAL_SCALE
    try:
        _GLOBAL_SCALE = 5.0
        np.testing.assert_allclose(to_np(conv(x)), np.full((2, 2), 5.0))
    finally:
        _GLOBAL_SCALE = old
    assert "__jst__" not in globals()
    assert "__jst_factory__" not in globals()


def test_port_dy2static_imports_no_jax():
    import paddle_tpu_torch.jit.dy2static as d
    src = open(d.__file__).read()
    assert "import jax" not in src and "paddle_tpu." not in src
    assert os.path.basename(d.__file__) == "dy2static.py"
