"""Port parity: probability distributions (paddle_tpu_torch/
distribution.py) against paddle_tpu.distribution, on the CPU.

- ``log_prob``, ``prob``, ``entropy``, ``mean``, ``variance``,
  ``probs`` and ``kl_divergence`` of the six families equal JAX's by
  value on the same numpy parameters and values (``TOL``: f32, the
  lgamma / digamma / logsumexp of the two libraries differ in the last
  bits; readings up to 2e-6).
- Gradients of ``log_prob`` with respect to the parameters, taken by
  ``incubate.functional.grad`` in both, equal JAX's.
- ``rsample`` is reparameterised in both: d sum(x) / d loc is the number
  of draws and d sum(x) / d scale is sum((x - loc) / scale).
- Draws cannot match JAX's PRNG bits; they are held in distribution:
  20,000 draws from the port's seeded CPU generator, each moment within
  ``Z`` standard errors of the exact one, and two draws after the same
  ``paddle.seed`` bitwise equal.
"""
import math

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import distribution as JD
from paddle_tpu.incubate import functional as JF
from paddle_tpu_torch import distribution as TD
from paddle_tpu_torch.incubate import functional as TF

TOL = dict(rtol=2e-5, atol=2e-6)
Z = 5.0
N = 20000


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


RNG = np.random.RandomState(0)
LOC = RNG.randn(3).astype("float32")
SCALE = (RNG.rand(3) + 0.5).astype("float32")
LOW = RNG.randn(3).astype("float32")
HIGH = LOW + (RNG.rand(3) + 0.5).astype("float32")
LOGITS = RNG.randn(2, 5).astype("float32")
PROBS = RNG.rand(4).astype("float32")
ALPHA = (RNG.rand(3) * 2 + 0.5).astype("float32")
BETA = (RNG.rand(3) * 2 + 0.5).astype("float32")
CONC = (RNG.rand(2, 4) * 2 + 0.5).astype("float32")


def _make(D):
    return {
        "normal": (D.Normal(LOC, SCALE), D.Normal(LOC * 0.5, SCALE * 2)),
        "uniform": (D.Uniform(LOW, HIGH), D.Uniform(LOW - 1, HIGH + 1)),
        "categorical": (D.Categorical(logits=LOGITS),
                        D.Categorical(probs=np.exp(LOGITS[::-1]))),
        "bernoulli": (D.Bernoulli(PROBS), D.Bernoulli(PROBS[::-1].copy())),
        "beta": (D.Beta(ALPHA, BETA), D.Beta(BETA, ALPHA)),
        "dirichlet": (D.Dirichlet(CONC), D.Dirichlet(CONC[::-1].copy())),
    }


VALUES = {
    "normal": RNG.randn(4, 3).astype("float32"),
    "uniform": np.stack([LOW + 0.3 * (HIGH - LOW), HIGH + 1.0]),
    "categorical": np.array([4, 2]),
    "bernoulli": np.array([[0, 1, 1, 0], [1, 1, 0, 0]], np.float32),
    "beta": RNG.rand(2, 3).astype("float32") * 0.9 + 0.05,
    "dirichlet": RNG.dirichlet([1.0] * 4, size=(3, 2)).astype("float32"),
}


def _np(t):
    return np.asarray(t.numpy(), dtype=np.float64)


@pytest.mark.parametrize("name", sorted(VALUES))
def test_densities_entropies_and_kl_match_jax(name):
    (tp_, tq), (jp_, jq) = _make(TD)[name], _make(JD)[name]
    tv, jv = tp.to_tensor(VALUES[name]), jp.to_tensor(VALUES[name])
    for meth in ("log_prob", "prob"):
        a, b = _np(getattr(tp_, meth)(tv)), _np(getattr(jp_, meth)(jv))
        np.testing.assert_allclose(a, b, **TOL, err_msg=meth)
    np.testing.assert_allclose(_np(tp_.entropy()), _np(jp_.entropy()),
                               **TOL)
    np.testing.assert_allclose(_np(TD.kl_divergence(tp_, tq)),
                               _np(JD.kl_divergence(jp_, jq)), **TOL)
    np.testing.assert_allclose(_np(tp_.kl_divergence(tq)),
                               _np(jp_.kl_divergence(jq)), **TOL)
    for attr in ("mean", "variance", "probs"):
        if hasattr(type(jp_), attr):
            np.testing.assert_allclose(_np(getattr(tp_, attr)),
                                       _np(getattr(jp_, attr)), **TOL)
    with pytest.raises(NotImplementedError, match="closed-form"):
        TD.kl_divergence(tp_, TD.Normal(0.0, 1.0) if name != "normal"
                         else TD.Uniform(0.0, 1.0))


def test_log_prob_gradients_match_jax():
    v = VALUES["normal"]

    def f(P, D):
        return lambda loc, scale: P.sum(D.Normal(loc, scale).log_prob(
            P.to_tensor(v)))
    t = TF.grad(f(tp, TD), argnums=(0, 1))(tp.to_tensor(LOC),
                                           tp.to_tensor(SCALE))
    j = JF.grad(f(jp, JD), argnums=(0, 1))(jp.to_tensor(LOC),
                                           jp.to_tensor(SCALE))
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)

    def g(P, D):
        return lambda a, b: P.sum(D.Beta(a, b).log_prob(
            P.to_tensor(VALUES["beta"])))
    t = TF.grad(g(tp, TD), argnums=(0, 1))(tp.to_tensor(ALPHA),
                                           tp.to_tensor(BETA))
    j = JF.grad(g(jp, JD), argnums=(0, 1))(jp.to_tensor(ALPHA),
                                           jp.to_tensor(BETA))
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_rsample_is_reparameterised(pkg):
    P, D, F = (tp, TD, TF) if pkg == "port" else (jp, JD, JF)
    P.seed(3)
    draws = {}

    def f(loc, scale):
        x = D.Normal(loc, scale).rsample((50,))
        draws["x"] = x
        return P.sum(x)
    gl, gs = F.grad(f, argnums=(0, 1))(P.to_tensor(LOC),
                                       P.to_tensor(SCALE))
    np.testing.assert_allclose(_np(gl), np.full(3, 50.0), rtol=1e-6)
    if pkg == "port":   # JAX's recorded draws are tracers
        x = _np(draws["x"].detach())
        np.testing.assert_allclose(
            _np(gs), ((x - LOC) / SCALE).sum(0), rtol=1e-4, atol=1e-4)


def _moments(name, x):
    """(sample means, exact means, standard errors of the means)."""
    if name == "normal":
        return x.mean(0), LOC, SCALE / math.sqrt(N)
    if name == "uniform":
        return x.mean(0), (LOW + HIGH) / 2, \
            (HIGH - LOW) / math.sqrt(12 * N)
    if name == "bernoulli":
        p = np.clip(PROBS, 1e-7, 1 - 1e-7)
        return x.mean(0), p, np.sqrt(p * (1 - p) / N)
    if name == "beta":
        m = ALPHA / (ALPHA + BETA)
        var = ALPHA * BETA / ((ALPHA + BETA) ** 2 * (ALPHA + BETA + 1))
        return x.mean(0), m, np.sqrt(var / N)
    if name == "dirichlet":
        a0 = CONC.sum(-1, keepdims=True)
        m = CONC / a0
        return x.mean(0), m, np.sqrt(m * (1 - m) / (a0 + 1) / N)
    p = np.exp(LOGITS) / np.exp(LOGITS).sum(-1, keepdims=True)
    freq = np.stack([(x == k).mean(0) for k in range(5)], -1)
    return freq, p, np.sqrt(p * (1 - p) / N)


@pytest.mark.parametrize("name", sorted(VALUES))
def test_draws_hold_their_distribution(name):
    tp.seed(11)
    d = _make(TD)[name][0]
    x = _np(d.sample((N,)))
    want_shape = (N,) + {"categorical": (2,), "dirichlet": (2, 4),
                         "bernoulli": (4,)}.get(name, (3,))
    assert x.shape == want_shape
    got, exact, se = _moments(name, x)
    assert np.all(np.abs(got - exact) <= Z * se), (got, exact, se)
    tp.seed(11)
    assert np.array_equal(_np(_make(TD)[name][0].sample((N,))), x)
    if name in ("normal", "beta"):   # the variance too
        var = x.var(0)
        if name == "normal":
            exact_var = SCALE ** 2
        else:
            exact_var = ALPHA * BETA / ((ALPHA + BETA) ** 2
                                        * (ALPHA + BETA + 1))
        assert np.all(np.abs(var - exact_var) <= Z * exact_var
                      * math.sqrt(2.0 / N) * 2)
