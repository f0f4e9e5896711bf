"""Port parity: the linalg tail ops' sweep cases (``LINALG_TAIL`` in
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


@pytest.mark.parametrize("case", L.LINALG_TAIL, ids=str)
def test_op_matches_jax(case):
    P.run(case)


# -- the decompositions unique only up to signs and order -------------------

import numpy as np  # noqa: E402

import paddle_tpu as jp  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402

A = P.f32(5, 3, seed=60)
S4 = L.SYM


def _both(name, *args, **kw):
    return [[np.asarray(o.numpy()) for o in pkg.ops.OP_REGISTRY[name](
        *[pkg.to_tensor(a) for a in args], **kw)] for pkg in (jp, tp)]


@pytest.mark.parametrize("full", [False, True])
def test_svd_reconstructs_and_singular_values_match_jax(full):
    (ju, js, jv), (tu, ts, tv) = _both("svd", A, full_matrices=full)
    assert (tu.shape, ts.shape, tv.shape) == (ju.shape, js.shape, jv.shape)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    k = ts.shape[0]
    np.testing.assert_allclose(tu[:, :k] * ts @ tv[:k], A, atol=1e-5)
    np.testing.assert_allclose(tu.T @ tu, np.eye(tu.shape[1]), atol=1e-5)
    np.testing.assert_allclose(tv @ tv.T, np.eye(tv.shape[0]), atol=1e-5)


@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_reconstructs_as_jax(mode):
    (jq, jr), (tq, tr_) = _both("qr", A, mode=mode)
    assert (tq.shape, tr_.shape) == (jq.shape, jr.shape)
    np.testing.assert_allclose(tq @ tr_, A, atol=1e-5)
    np.testing.assert_allclose(tq.T @ tq, np.eye(tq.shape[1]), atol=1e-5)
    np.testing.assert_array_equal(np.tril(tr_, -1), 0)
    # R's rows up to sign: |R| is unique for a full-rank A
    np.testing.assert_allclose(np.abs(tr_), np.abs(jr), rtol=1e-4,
                               atol=1e-5)


def test_qr_r_mode_is_rows_of_r_as_jax():
    j = jp.ops.qr(jp.to_tensor(A), mode="r")
    t = tp.ops.qr(tp.to_tensor(A), mode="r")
    assert isinstance(t, tuple) and len(t) == len(j) == 3
    for a, b in zip(j, t):
        np.testing.assert_allclose(np.abs(b.numpy()), np.abs(np.asarray(
            a.numpy())), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_reconstructs_and_eigenvalues_match_jax(uplo):
    (jw, jv), (tw, tv) = _both("eigh", S4, UPLO=uplo)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv * tw @ tv.T, S4, atol=1e-5)
    # each eigenvector up to sign (the eigenvalues are distinct)
    np.testing.assert_allclose(np.abs(tv.T @ jv), np.eye(4), atol=1e-4)


def test_decomposition_gradients_match_jax_where_unique():
    """The singular values' and eigenvalues' gradients (sign-free)."""
    import jax
    import jax.numpy as jnp
    a = tp.to_tensor(A, stop_gradient=False)
    tp.ops.svd(a)[1].sum().backward()
    jg = jax.grad(lambda x: jnp.linalg.svd(x, full_matrices=False)[1]
                  .sum())(jnp.asarray(A))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg), atol=1e-5)
    s = tp.to_tensor(S4, stop_gradient=False)
    (tp.ops.eigh(s)[0] * tp.to_tensor(np.arange(4.0, dtype=np.float32))) \
        .sum().backward()
    jg = jax.grad(lambda x: (jnp.linalg.eigh(x)[0] * jnp.arange(4.0))
                  .sum())(jnp.asarray(S4))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), atol=1e-5)
