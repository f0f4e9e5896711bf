"""Port parity: paddle_tpu_torch/nn/utils against paddle_tpu/nn/utils:
``weight_norm`` (forward and the gradients of g and v, then
``remove_weight_norm``'s round trip), ``spectral_norm`` (the power
iteration from the same starting vectors, the buffers it advances, the
weight's gradient), ``clip_grad_norm_`` / ``clip_grad_value_`` and
``parameters_to_vector`` / ``vector_to_parameters``. f32, within 1e-5
(1e-4 relative for the power iteration)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
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


X = C.f32(4, 6, seed=1)


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    def make(pkg):
        return pkg.nn.utils.weight_norm(pkg.nn.Linear(6, 3), dim=dim)
    jl, tl = C.check(make, [X])
    names = [k for k, _ in tl.named_parameters()]
    assert set(names) == {"bias", "weight_g", "weight_v"}
    # the Layer's forward reads self.weight, which the hook computes
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.asarray(jl.weight.numpy()), atol=1e-6)


def test_weight_norm_round_trip():
    lin = tp.nn.Linear(6, 3)
    x = tp.to_tensor(X)
    before = lin(x).detach().numpy()
    w0 = lin.weight.detach().numpy().copy()
    tp.nn.utils.weight_norm(lin)
    np.testing.assert_allclose(lin(x).detach().numpy(), before, atol=1e-6)
    tp.nn.utils.remove_weight_norm(lin)
    assert isinstance(lin.weight, tp.Parameter)
    assert {k for k, _ in lin.named_parameters()} == {"bias", "weight"}
    np.testing.assert_allclose(lin.weight.detach().numpy(), w0, atol=1e-6)
    np.testing.assert_allclose(lin(x).detach().numpy(), before, atol=1e-6)
    with pytest.raises(ValueError, match="no weight_norm"):
        tp.nn.utils.remove_weight_norm(lin)


def test_weight_norm_state_crosses_the_bridge():
    """g / v load by path into a port layer built the same way."""
    jp.seed(0)
    jl = jp.nn.utils.weight_norm(jp.nn.Linear(6, 3))
    tl = C.copy_state(jl, tp.nn.utils.weight_norm(tp.nn.Linear(6, 3)))
    jout = np.asarray(jl(jp.to_tensor(X)).numpy())
    np.testing.assert_allclose(tl(tp.to_tensor(X)).detach().numpy(), jout,
                               atol=1e-5)


def test_spectral_norm_matches_jax():
    def make(pkg):
        return pkg.nn.utils.spectral_norm(pkg.nn.Linear(6, 3),
                                          n_power_iterations=2)
    jl, tl = C.check(make, [X], rtol=1e-4)
    for name in ("weight_u", "weight_v"):
        np.testing.assert_allclose(
            tl._buffers[name].numpy(),
            np.asarray(jl._buffers[name].numpy()), rtol=1e-4, atol=1e-6)


def _grads(pkg, seed):
    """Three parameters with seeded grads (one without)."""
    ps = []
    for i, shape in enumerate([(3, 4), (5,), (2, 2)]):
        p = pkg.create_parameter(list(shape), "float32")
        if i < 2:
            p.grad = pkg.to_tensor(C.f32(*shape, seed=seed + i, scale=3.0))
        ps.append(p)
    return ps


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    jps, tps = _grads(jp, 5), _grads(tp, 5)
    jt = jp.nn.utils.clip_grad_norm_(jps, 1.5, norm_type)
    tt = tp.nn.utils.clip_grad_norm_(tps, 1.5, norm_type)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    for j, t in zip(jps[:2], tps[:2]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(
            j.grad.numpy()), rtol=1e-6, atol=1e-7)
    assert tps[2].grad is None


def test_clip_grad_norm_nonfinite_raises():
    ps = _grads(tp, 7)
    ps[0].grad[0, 0] = float("inf")
    with pytest.raises(RuntimeError, match="gradient norm"):
        tp.nn.utils.clip_grad_norm_(ps, 1.0, error_if_nonfinite=True)


def test_clip_grad_value_matches_jax():
    jps, tps = _grads(jp, 9), _grads(tp, 9)
    jp.nn.utils.clip_grad_value_(jps, 0.5)
    tp.nn.utils.clip_grad_value_(tps, 0.5)
    for j, t in zip(jps[:2], tps[:2]):
        np.testing.assert_array_equal(t.grad.numpy(),
                                      np.asarray(j.grad.numpy()))


def test_parameters_vector_round_trip_matches_jax():
    jp.seed(0)
    jl = jp.nn.Linear(4, 3)
    tl = C.copy_state(jl, tp.nn.Linear(4, 3))
    jv = np.asarray(jp.nn.utils.parameters_to_vector(jl.parameters())
                    .numpy())
    tv = tp.nn.utils.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(tv.detach().numpy(), jv)
    tp.nn.utils.vector_to_parameters(tv * 2.0, tl.parameters())
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               2.0 * np.asarray(jl.weight.numpy()))
    with pytest.raises(ValueError, match="consume"):
        tp.nn.utils.vector_to_parameters(tv[:3], tl.parameters())


def test_utils_take_eager_parameters_only():
    """The JAX utilities' eager-only check: a value that is not an eager
    parameter raises TypeError."""
    with pytest.raises(TypeError, match="eager"):
        tp.nn.utils.parameters_to_vector([np.zeros(3)])
