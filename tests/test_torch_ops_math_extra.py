"""Port parity: the math extra ops' sweep cases (``MATH_EXTRA`` in
tests/test_torch_ops_long_tail_cases.py), the JAX op and the port's of
the same registry name on the same seeded inputs, forward and gradients.
"""
import pytest
import torch

import test_torch_ops_cases as P
import test_torch_ops_long_tail_cases as L
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


@pytest.mark.parametrize("case", L.MATH_EXTRA, ids=str)
def test_op_matches_jax(case):
    P.run(case)


# -- the random draws and the host callback ---------------------------------

import numpy as np  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402


@pytest.mark.parametrize("draw, lo, mean, sd", [
    (lambda p: p.ops.standard_gamma(p.full([4000], 2.0)), 0.0, 2.0,
     2.0 ** 0.5),
    (lambda p: p.ops.binomial(p.full([4000], 10.0), p.full([4000], 0.3)),
     0.0, 3.0, 2.1 ** 0.5),
    (lambda p: p.ops.log_normal(0.0, 0.5, [4000]), 0.0, np.exp(0.125),
     ((np.exp(0.25) - 1) * np.exp(0.25)) ** 0.5),
], ids=["standard_gamma", "binomial", "log_normal"])
def test_random_draws_match_jax_in_distribution(draw, lo, mean, sd):
    """The numbers are not JAX's (jax.random bits have no torch
    counterpart): both packages' draws are held to the support and to the
    mean within 4 standard errors, the port to its seed."""
    jp.seed(0)
    tp.seed(0)
    for a in (np.asarray(draw(jp).numpy()), draw(tp).numpy()):
        assert a.shape == (4000,) and a.dtype.kind == "f"
        assert a.min() >= lo
        assert abs(a.mean() - mean) <= 4 * sd / np.sqrt(a.size)
    tp.seed(7)
    first = draw(tp).numpy()
    tp.seed(7)
    np.testing.assert_array_equal(draw(tp).numpy(), first)


def test_py_func_runs_on_the_host_with_a_backward_as_jax():
    x = P.f32(3, 4)

    def fwd(a):
        return np.tanh(a) * 2

    def bwd(a, g):
        return g * 2 * (1 - np.tanh(a) ** 2)

    outs = []
    for pkg in (jp, tp):
        xt = pkg.to_tensor(x, stop_gradient=False)
        y = pkg.ops.py_func(fwd, xt, backward_func=bwd)
        (y * pkg.to_tensor(x)).sum().backward()
        outs.append((np.asarray(y.numpy()), np.asarray(xt.grad.numpy())))
    for a, b in zip(outs[1], outs[0]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # two outputs of given shapes and dtypes, no backward
    two = tp.ops.py_func(lambda a: (a.sum(1), (a > 0).astype("int64")),
                         tp.to_tensor(x), out_shapes=[[3], [3, 4]],
                         out_dtypes=["float32", "int64"])
    np.testing.assert_allclose(two[0].numpy(), x.sum(1), rtol=1e-6)
    assert two[1].numpy().dtype == np.int64
