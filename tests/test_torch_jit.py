"""Port parity: paddle.jit (paddle_tpu_torch/jit) against paddle_tpu/jit.

tests/test_jit.py's cases and the jit cases of
tests/test_static_review_fixes.py run on both packages; the saved and
loaded models also hold the port's outputs to JAX's (weights copied by
module path, f32 to 1e-5). The port's ``to_static`` runs eagerly under
torch autograd (JAX's under ``jax.jit``), so its outputs carry
gradients; the values are the same.
"""
import json
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


def _mlp(P):
    net = P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(), P.nn.Linear(8, 2))
    net.eval()
    return net


def _pair(make):
    jnet, tnet = make(JAX), make(PORT)
    params, bufs = jnet.functional_state()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in params.items()},
                    {k: np.asarray(v) for k, v in bufs.items()})
    return jnet, tnet


def test_to_static_layer_matches_eager(P):
    net = _mlp(P)
    x = P.paddle.randn([3, 4])
    eager = to_np(net(x))
    snet = P.jit.to_static(net)
    np.testing.assert_allclose(to_np(snet(x)), eager, rtol=1e-5)
    np.testing.assert_allclose(to_np(snet(x)), eager, rtol=1e-5)


def test_to_static_function_decorator(P):
    @P.jit.to_static
    def f(a, b):
        return P.ops.exp(a) + b

    a, b = P.paddle.randn([4]), P.paddle.randn([4])
    np.testing.assert_allclose(to_np(f(a, b)),
                               np.exp(to_np(a)) + to_np(b), rtol=1e-5)


def test_to_static_keeps_gradients_in_the_port():
    net = _mlp(PORT)
    x = PORT.paddle.randn([3, 4])
    loss = PORT.ops.mean(PORT.jit.to_static(net)(x))
    loss.backward()
    assert all(p.grad is not None for p in net.parameters())


def test_jit_save_load_roundtrip(P, tmp_path):
    net = _mlp(P)
    path = str(tmp_path / "exported" / "model")
    P.jit.save(net, path,
               input_spec=[P.jit.InputSpec([None, 4], "float32", "x")])
    loaded = P.jit.load(path)
    x = np.random.rand(1, 4).astype("float32")
    np.testing.assert_allclose(to_np(loaded(P.paddle.to_tensor(x))),
                               to_np(net(P.paddle.to_tensor(x))), rtol=1e-5)


def test_saved_mlp_matches_jax_and_runs_any_batch(tmp_path):
    jnet, tnet = _pair(_mlp)
    outs = {}
    for P, net in ((JAX, jnet), (PORT, tnet)):
        path = str(tmp_path / P.name)
        P.jit.save(net, path,
                   input_spec=[P.jit.InputSpec([None, 4], "float32", "x")])
        x = np.random.RandomState(0).rand(1, 4).astype("float32")
        outs[P.name] = to_np(P.jit.load(path)(P.paddle.to_tensor(x)))
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-5,
                               atol=1e-6)
    x5 = np.random.RandomState(1).rand(5, 4).astype("float32")
    np.testing.assert_allclose(
        to_np(PORT.jit.load(str(tmp_path / "port"))(
            PORT.paddle.to_tensor(x5))),
        to_np(tnet(PORT.paddle.to_tensor(x5))), rtol=1e-5)


def test_jit_save_load_conv_model(P, tmp_path):
    from importlib import import_module
    lenet = import_module(P.paddle.__name__ + ".vision.models").LeNet
    net = lenet()
    net.eval()
    path = str(tmp_path / "lenet")
    P.jit.save(net, path,
               input_spec=[P.jit.InputSpec([1, 1, 28, 28], "float32",
                                           "img")])
    loaded = P.jit.load(path)
    x = np.random.rand(1, 1, 28, 28).astype("float32")
    np.testing.assert_allclose(to_np(loaded(P.paddle.to_tensor(x))),
                               to_np(net(P.paddle.to_tensor(x))),
                               rtol=1e-4, atol=1e-5)


def test_saved_lenet_matches_jax(tmp_path):
    from importlib import import_module

    def make(P):
        net = import_module(P.paddle.__name__ + ".vision.models").LeNet()
        net.eval()
        return net

    jnet, tnet = _pair(make)
    x = np.random.RandomState(2).rand(1, 1, 28, 28).astype("float32")
    outs = {}
    for P, net in ((JAX, jnet), (PORT, tnet)):
        path = str(tmp_path / P.name)
        P.jit.save(net, path,
                   input_spec=[P.jit.InputSpec([1, 1, 28, 28], "float32",
                                               "img")])
        outs[P.name] = to_np(P.jit.load(path)(P.paddle.to_tensor(x)))
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-4,
                               atol=1e-5)


def test_to_static_updates_bn_buffers(P):
    net = P.nn.Sequential(P.nn.BatchNorm1D(4))
    snet = P.jit.to_static(net)
    snet(P.paddle.to_tensor(np.random.rand(16, 4).astype("float32") + 5.0))
    assert not np.allclose(to_np(net[0]._mean), 0.0)


def test_to_static_kwargs_in_cache_key(P):
    @P.jit.to_static
    def f(a, scale=1.0):
        return a * scale

    x = P.paddle.ones([2])
    np.testing.assert_allclose(to_np(f(x, scale=2.0)), [2, 2])
    np.testing.assert_allclose(to_np(f(x, scale=3.0)), [3, 3])
    assert len(f._compiled) == 2


def test_jit_save_plain_function_raises(P, tmp_path):
    sf = P.jit.to_static(lambda x: x * 2)
    with pytest.raises(TypeError, match="Layer"):
        P.jit.save(sf, str(tmp_path / "nope"),
                   input_spec=[P.jit.InputSpec([1], "float32")])


def test_jit_save_requires_input_spec(P, tmp_path):
    with pytest.raises(ValueError, match="input_spec"):
        P.jit.save(_mlp(P), str(tmp_path / "x"))


def test_port_artifacts_and_pt2(tmp_path):
    """The port writes JAX's files plus the .pt2 export, whose JSON names
    the inputs, dtypes, outputs and the open batch dim."""
    net = _mlp(PORT)
    path = str(tmp_path / "m")
    PORT.jit.save(net, path,
                  input_spec=[PORT.jit.InputSpec([None, 4], "float32", "x")])
    for ext in (".pdmodel", ".pdmodel.npz", ".pdiparams", ".pdinfer.json",
                ".pt2"):
        assert os.path.exists(path + ext), ext
    with open(path + ".pdinfer.json") as f:
        meta = json.load(f)
    assert meta["input_names"] == ["x"] and meta["input_dtypes"] == [
        "float32"]
    assert meta["output_shapes"] == [[None, 2]]
    assert meta["format"] == "pt2+torch.export" and meta["device"] == "cpu"
