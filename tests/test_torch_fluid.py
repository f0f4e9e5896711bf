"""Port parity: ``paddle_tpu_torch.fluid`` (the v1 names over the port's
static, nn, ops and device) and ``paddle_tpu_torch.onnx`` against the JAX
package's.

tests/test_fluid_compat.py's five cases, each run on both packages: a
v1 layer call creates its parameters in each package (``fluid.layers``
keeps the layer of a name), the JAX layer's weights are copied into the
port's by module path, and the port's call of the same name is held to
JAX's output (f32, rtol 1e-5, atol 1e-6); the pure ops are compared
exactly; the static program runs through ``fluid.Executor`` with copied
weights; ``fluid.io``'s save and load round-trip bitwise; anonymous calls
make fresh parameters in the port too.

``onnx.export`` of one MLP (JAX's weights carried across) writes the
port's ``.pt2`` artifact and warns that an ``.onnx`` protobuf needs the
``onnx`` package, as JAX's does; the port's Predictor on it gives JAX's
Predictor's outputs on JAX's export (rtol 1e-6, atol 1e-7).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import fluid as jfluid
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.device import device_scope

import test_torch_nn_cases as C
from test_torch_static_cases import copy_static

RTOL, ATOL = 1e-5, 1e-6
PKG = {"jax": (jp, jfluid), "port": (tp, tfluid)}


@pytest.fixture(autouse=True)
def _cpu():
    jfluid.layers._param_layers.clear()
    tfluid.layers._param_layers.clear()
    with device_scope("cpu"):
        yield


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _cached(fluid, kind, name):
    """The layer ``fluid.layers`` keeps for the call named ``name``."""
    (layer,) = [v for k, v in fluid.layers._param_layers.items()
                if k[0] == kind and k[1] == name]
    return layer


def test_fluid_layer_functions_eager():
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 2).astype("float32")
    ids = np.array([1, 2, 3], "int64")
    img = rng.rand(2, 3, 8, 8).astype("float32")

    def calls(pkg, fluid):
        L = fluid.layers
        out = L.fc(pkg.to_tensor(x), size=5, act="relu", name="fc1")
        emb = L.embedding(pkg.to_tensor(ids), size=[10, 4], name="emb1")
        conv = L.conv2d(pkg.to_tensor(img), num_filters=4, filter_size=3,
                        padding=1, act="relu", name="c1")
        pooled = L.pool2d(conv, pool_size=2, pool_stride=2)
        bn = L.batch_norm(conv, name="bn1")
        return [_np(t) for t in (out, emb, conv, pooled, bn)]
    want = calls(*PKG["jax"])
    calls(*PKG["port"])                       # the port's layers, built
    for kind, name in (("fc", "fc1"), ("emb", "emb1"), ("conv2d", "c1"),
                       ("bn", "bn1")):
        C.copy_state(_cached(jfluid, kind, name), _cached(tfluid, kind, name))
    got = calls(*PKG["port"])
    assert [g.shape for g in got] == [(4, 5), (3, 4), (2, 4, 8, 8),
                                      (2, 4, 4, 4), (2, 4, 8, 8)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # the same name reuses the same parameters
    again = tfluid.layers.fc(tp.to_tensor(x), size=5, act="relu", name="fc1")
    assert _np(again).tobytes() == got[0].tobytes()


def test_fluid_op_aliases():
    a = np.array([[1.0, 2], [3, 4]], "float32")
    b = np.array([[5.0, 6], [7, 8]], "float32")
    x4 = np.arange(24, dtype="float32").reshape(2, 3, 2, 2)
    yc = np.array([10.0, 20, 30], "float32")
    neg = np.array([[-5.0, 2]], "float32")
    logits = np.array([[2.0, 0.1]], "float32")
    lab = np.array([0], "int64")

    def calls(pkg, fluid):
        L, T = fluid.layers, pkg.to_tensor
        return [_np(t) for t in (
            L.elementwise_add(T(a), T(b)), L.mul(T(a), T(b)),
            L.elementwise_add(T(x4), T(yc), axis=1),
            L.elementwise_mul(T(x4), T(yc), axis=1, act="relu"),
            L.elementwise_add(T(neg), T(np.zeros_like(neg)), act="relu"),
            L.reduce_mean(T(a), dim=1), L.reduce_sum(T(a), dim=0),
            L.fill_constant([2, 2], "float32", 3.0), L.shape(T(a)),
            L.cross_entropy(L.softmax(T(logits)), T(lab)),
            L.softmax_with_cross_entropy(T(logits), T(lab)))]
    got, want = calls(*PKG["port"]), calls(*PKG["jax"])
    np.testing.assert_array_equal(got[2], x4 + yc.reshape(1, 3, 1, 1))
    np.testing.assert_array_equal(got[4], [[0, 2]])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert float(got[9].reshape(-1)[0]) > 0


def _static_fc(pkg, fluid, size_h=8, name=("h", "out")):
    main = fluid.Program("fluid_v1")
    with fluid.program_guard(main):
        x = fluid.data("x", [-1, 4], "float32")
        h = fluid.layers.fc(x, size=size_h, act="relu", name=name[0])
        out = fluid.layers.fc(h, size=1, name=name[1])
    return main, out


def test_fluid_static_program():
    feed = {"x": np.random.RandomState(1).rand(3, 4).astype("float32")}
    res = {}
    for P in ("jax", "port"):
        pkg, fluid = PKG[P]
        pkg.enable_static()
        try:
            main, out = _static_fc(pkg, fluid)
        finally:
            pkg.disable_static()
        if P == "port":
            for name in ("h", "out"):
                copy_static(_cached(jfluid, "fc", name),
                            _cached(tfluid, "fc", name))
        exe = fluid.Executor()
        pkg.enable_static()
        try:
            (res[P],) = exe.run(main, feed=feed, fetch_list=[out])
        finally:
            pkg.disable_static()
    assert np.asarray(res["port"]).shape == (3, 1)
    np.testing.assert_allclose(np.asarray(res["port"]), np.asarray(
        res["jax"]), rtol=RTOL, atol=ATOL)


def test_fluid_io_roundtrip(tmp_path):
    tp.enable_static()
    try:
        main = tfluid.Program("fluid_io")
        with tfluid.program_guard(main):
            x = tfluid.data("x", [-1, 2], "float32")
            out = tfluid.layers.fc(x, size=2, name="io_fc")
    finally:
        tp.disable_static()
    exe = tfluid.Executor()
    feed = {"x": np.ones((1, 2), "float32")}

    def run():
        tp.enable_static()
        try:
            return np.array(exe.run(main, feed=feed, fetch_list=[out])[0])
        finally:
            tp.disable_static()
    before = run()
    path = tfluid.io.save_persistables(exe, str(tmp_path), main)
    layer = _cached(tfluid, "fc", "io_fc")
    scope = tp.static.global_scope()
    scope.set(layer.weight.scope_name,
              scope.get(layer.weight.scope_name) * 0)
    assert not np.array_equal(run(), before)
    tfluid.io.load_persistables(exe, str(tmp_path), main)
    assert run().tobytes() == before.tobytes()
    assert path == str(tmp_path / "params")


def test_unnamed_layers_do_not_share_params():
    x = tp.to_tensor(np.random.RandomState(3).rand(2, 4).astype("float32"))
    a = tfluid.layers.fc(x, size=3)
    b = tfluid.layers.fc(x, size=3)
    assert not np.allclose(_np(a), _np(b)), \
        "anonymous fc calls shared parameters"
    c1 = tfluid.layers.fc(x, size=3, name="pinned")
    c2 = tfluid.layers.fc(x, size=3, name="pinned")
    assert _np(c1).tobytes() == _np(c2).tobytes()
    assert set(tfluid.layers.__all__) == set(jfluid.layers.__all__)
    assert set(tfluid.__all__) == set(jfluid.__all__)
    for name in tfluid.layers.__all__:
        assert callable(getattr(tfluid.layers, name)), name


def test_onnx_export_runs_in_the_predictor_as_jax(tmp_path):
    jp.seed(3)
    jnet = jp.nn.Sequential(jp.nn.Linear(6, 16), jp.nn.Tanh(),
                            jp.nn.Linear(16, 2))
    tnet = C.copy_state(jnet, tp.nn.Sequential(
        tp.nn.Linear(6, 16), tp.nn.Tanh(), tp.nn.Linear(16, 2)))
    x = np.random.RandomState(4).randn(3, 6).astype("float32")
    outs = {}
    for P, net in (("jax", jnet), ("port", tnet)):
        pkg = PKG[P][0]
        net.eval()
        with pytest.warns(UserWarning, match="onnx"):
            prefix = pkg.onnx.export(
                net, str(tmp_path / P / "model.onnx"),
                input_spec=[pkg.static.InputSpec([3, 6], "float32")])
        assert prefix == str(tmp_path / P / "model")
        (outs[P],) = pkg.inference.create_predictor(
            pkg.inference.Config(prefix)).run([x])
    assert (tmp_path / "port" / "model.pt2").exists()
    assert not (tmp_path / "port" / "model.onnx").exists()
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-6,
                               atol=1e-7)
