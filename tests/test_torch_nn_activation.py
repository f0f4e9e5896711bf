"""Port parity: the activation layers (paddle_tpu_torch/nn/layer/
activation.py), every one of the JAX module's, forward and input
gradients (and PReLU's weight gradient) on the same seeded input, within
1e-5 (f32)."""
import numpy as np
import pytest
import torch

import test_torch_nn_cases as C
from paddle_tpu_torch import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


X = C.f32(2, 4, 3, 3, seed=1, scale=2.0)

LAYERS = {
    "ReLU": {}, "ReLU6": {}, "Sigmoid": {}, "Tanh": {}, "Silu": {},
    "Swish": {}, "Mish": {}, "Softsign": {}, "LogSigmoid": {},
    "Hardswish": {}, "Hardsigmoid": {}, "Tanhshrink": {},
    "LeakyReLU": {"negative_slope": 0.2}, "ELU": {"alpha": 0.7},
    "SELU": {}, "CELU": {"alpha": 1.5}, "GELU": {"approximate": True},
    "Hardtanh": {"min": -0.5, "max": 2.0}, "Hardshrink": {"threshold": 0.3},
    "Softshrink": {"threshold": 0.3},
    "Softplus": {"beta": 2.0, "threshold": 3.0}, "Softmax": {"axis": 1},
    "LogSoftmax": {}, "ThresholdedReLU": {"threshold": 0.5},
    "Maxout": {"groups": 2}, "GLU": {"axis": 1},
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_activation_layer_matches_jax(name):
    C.check(lambda pkg: getattr(pkg.nn, name)(**LAYERS[name]), [X])


@pytest.mark.parametrize("num", [1, 4])
def test_prelu_matches_jax(num):
    C.check(lambda pkg: pkg.nn.PReLU(num, init=0.1), [X])


def test_every_jax_activation_layer_is_ported():
    import paddle_tpu.nn.layer.activation as jact

    import paddle_tpu_torch.nn.layer.activation as tact
    assert tact.__all__ == jact.__all__
    assert set(jact.__all__) == set(LAYERS) | {"PReLU"}
    assert np.all([hasattr(tact, n) for n in jact.__all__])


@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_gelu_special_values_match_jax(n, dtype, approximate):
    """gelu at {+inf, -inf, nan, 0, -0.0}, alone and tiled into 5 and 64
    elements (torch's vectorized CPU kernel gave nan for +inf from 8 on:
    ROADMAP Queue 3 C7), against jax.nn.gelu: +inf -> inf, -inf -> nan,
    and the sign of a zero kept."""
    import paddle_tpu as jp
    import paddle_tpu_torch as tp
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)
    x = special[:1] if n == 1 else np.resize(special, n)
    j = np.asarray(jp.nn.functional.gelu(
        jp.to_tensor(x, dtype=dtype), approximate=approximate)
        .astype("float32").numpy())
    t = tp.nn.functional.gelu(tp.to_tensor(x, dtype=dtype),
                              approximate=approximate).float().numpy()
    assert j[0] == np.inf
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(np.signbit(t[~np.isnan(t)]),
                                  np.signbit(j[~np.isnan(j)]))
