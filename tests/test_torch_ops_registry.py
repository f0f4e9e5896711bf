"""Port parity: the op registry (paddle_tpu_torch/ops/_dispatch.py) and the
ops that the sweep (tests/test_torch_ops_cases.py) does not take: creation,
random draws, dropout, the host ops and the list-taking ops.

- Every name in the port's OP_REGISTRY is in the JAX registry with the
  same op_version, and every one of them has a parity case: in the sweep,
  or here.
- Creation and host ops: values equal to JAX's on the same inputs.
- Random ops: the numbers are not JAX's (jax.random bits have no torch
  counterpart), so both packages are held to the same shape, dtype kind
  and support, the port to its seed (the same seed repeats a draw) and
  to the distribution's mean within 4 standard errors.
- The wrapper: the AMP cast point under the op's name, a second op called
  inside an op's body records none, no exception is caught.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_torch_ops_cases as P
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.ops import _dispatch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes: one intra-op thread leaves the other cores to the
    timing-sensitive tests that run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu():
    with tdevice.device_scope("cpu"):
        yield


def test_every_port_op_is_a_jax_op_of_the_same_version():
    jreg, treg = jp.ops.OP_REGISTRY, tp.ops.OP_REGISTRY
    assert len(treg) > 250
    missing = sorted(n for n in treg if n not in jreg)
    assert not missing, missing
    differ = {n: (getattr(treg[n], "op_version", None),
                  getattr(jreg[n], "op_version", None))
              for n in treg if getattr(treg[n], "op_version", None)
              != getattr(jreg[n], "op_version", None)}
    assert not differ, differ
    assert tp.ops.SHAPE_INFER_REGISTRY == {}


def test_every_port_op_has_a_parity_case():
    covered = {c.name for cases in P.GROUPS.values() for c in cases}
    covered |= P.OWN_TESTS
    assert set(tp.ops.OP_REGISTRY) - covered == set()
    assert covered - set(tp.ops.OP_REGISTRY) == set()


def _same(fn, rtol=1e-6):
    j, t = fn(jp), fn(tp)
    j = [j] if not isinstance(j, (tuple, list)) else list(j)
    t = [t] if not isinstance(t, (tuple, list)) else list(t)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a, b = np.asarray(a.numpy()), np.asarray(b.numpy())
        assert a.shape == b.shape
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=rtol)


@pytest.mark.parametrize("fn", [
    lambda p: p.zeros([2, 3]), lambda p: p.ones([3], "int32"),
    lambda p: p.full([2, 2], 1.5), lambda p: p.arange(2, 11, 3),
    lambda p: p.arange(0.0, 1.0, 0.25), lambda p: p.linspace(0, 1, 5),
    lambda p: p.logspace(0, 2, 3), lambda p: p.eye(3, 4),
    lambda p: p.empty([2, 2]), lambda p: p.empty_like(p.ones([3])),
    lambda p: p.zeros_like(p.ones([2, 3])),
    lambda p: p.ones_like(p.zeros([2])),
    lambda p: p.full_like(p.zeros([2, 2]), 7.0),
    lambda p: p.diag(p.to_tensor(P.V)),
    lambda p: p.diag(p.to_tensor(P.V), offset=1, padding_value=9.0),
    lambda p: p.diag(p.to_tensor(P.X)),
    lambda p: p.diagflat(p.to_tensor(P.X)),
    lambda p: p.meshgrid(p.to_tensor(P.V), p.to_tensor(P.V[:3])),
    lambda p: p.nonzero(p.to_tensor(P.bools(3, 4))),
    lambda p: p.nonzero(p.to_tensor(P.bools(3, 4)), as_tuple=True),
    lambda p: p.unique(p.to_tensor(P.ints(9)), return_counts=True),
    lambda p: p.unique(p.to_tensor(P.ints(9)), return_inverse=True,
                       return_index=True),
    lambda p: p.unique_consecutive(p.to_tensor(np.array([1, 1, 2, 2, 3, 1])),
                                   return_counts=True, return_inverse=True),
    lambda p: p.scatter_nd(p.to_tensor(P.ints(4, 1, hi=5)),
                           p.to_tensor(P.f32(4, 2)), [5, 2]),
    lambda p: p.equal_all(p.to_tensor(P.X), p.to_tensor(P.X)),
    lambda p: p.equal_all(p.to_tensor(P.X), p.to_tensor(P.Y)),
    lambda p: p.partial_concat([p.to_tensor(P.X), p.to_tensor(P.Y)],
                               start_index=1, length=2),
    lambda p: p.partial_sum([p.to_tensor(P.X), p.to_tensor(P.Y)],
                            start_index=0, length=3),
])
def test_creation_and_host_ops_match_jax(fn):
    # rtol 1e-5: JAX's padded diag adds and then subtracts the padding
    # value, an f32 rounding the port's does not make (3.3e-6 at 9.0)
    _same(fn, rtol=1e-5)


@pytest.mark.parametrize("draw, lo, hi, mean, sd", [
    (lambda p: p.uniform([4000], min=-2.0, max=3.0), -2.0, 3.0, 0.5,
     5 / 12 ** 0.5),
    (lambda p: p.rand([4000]), 0.0, 1.0, 0.5, 12 ** -0.5),
    (lambda p: p.normal(1.0, 2.0, [4000]), -np.inf, np.inf, 1.0, 2.0),
    (lambda p: p.randn([4000]), -np.inf, np.inf, 0.0, 1.0),
    (lambda p: p.standard_normal([4000]), -np.inf, np.inf, 0.0, 1.0),
    (lambda p: p.randint(2, 9, [4000]), 2, 8, 5.0, (63 / 12) ** 0.5),
    (lambda p: p.randperm(50), 0, 49, 24.5, 0.0),
    (lambda p: p.bernoulli(p.full([4000], 0.3)), 0, 1, 0.3, 0.21 ** 0.5),
    (lambda p: p.poisson(p.full([4000], 3.0)), 0, np.inf, 3.0, 3 ** 0.5),
    (lambda p: p.multinomial(p.to_tensor([0.1, 0.2, 0.7]), 4000,
                             replacement=True), 0, 2, 1.6, 0.66 ** 0.5),
    (lambda p: p.multinomial(p.full([1000, 4], 0.25), 2), 0, 3, 1.5,
     1.25 ** 0.5),
])
def test_random_ops_match_jax_in_distribution(draw, lo, hi, mean, sd):
    jp.seed(0)
    tp.seed(0)
    j, t = np.asarray(draw(jp).numpy()), draw(tp).numpy()
    assert j.shape == t.shape and j.dtype.kind == t.dtype.kind
    for a in (j, t):
        assert a.min() >= lo and a.max() <= hi
        se = sd / np.sqrt(a.size)
        assert abs(a.mean() - mean) <= 4 * se + 1e-9
    tp.seed(7)
    first = draw(tp).numpy()
    tp.seed(7)
    np.testing.assert_array_equal(draw(tp).numpy(), first)


def test_randperm_is_a_permutation():
    for p in (jp, tp):
        np.testing.assert_array_equal(np.sort(p.randperm(50).numpy()),
                                      np.arange(50))


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax_in_distribution(hard):
    jp.seed(0)
    tp.seed(0)
    x = P.f32(2000, 4)
    j = jp.ops.OP_REGISTRY["gumbel_softmax"](jp.to_tensor(x), hard=hard)
    t = tp.ops.OP_REGISTRY["gumbel_softmax"](tp.to_tensor(x), hard=hard)
    for a in (np.asarray(j.numpy()), t.numpy()):
        assert a.shape == (2000, 4)
        np.testing.assert_allclose(a.sum(1), 1.0, rtol=1e-5)
        if hard:
            assert set(np.unique(a)) <= {0.0, 1.0}
    # argmax frequencies follow softmax(x) in both
    want = np.exp(x) / np.exp(x).sum(1, keepdims=True)
    for a in (np.asarray(j.numpy()), t.numpy()):
        hits = np.eye(4)[a.argmax(1)]
        assert abs((hits - want).mean(0)).max() < 0.05


@pytest.mark.parametrize("name", ["dropout", "dropout_op"])
@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_matches_jax_in_distribution(name, mode):
    jp.seed(0)
    tp.seed(0)
    x = np.ones((4000,), np.float32)
    outs = []
    for pkg in (jp, tp):
        op = pkg.ops.OP_REGISTRY[name]
        kw = {"p": 0.3, "mode": mode} if name == "dropout_op" else \
            {"p": 0.3, "mode": mode, "training": True}
        outs.append(np.asarray(op(pkg.to_tensor(x), **kw).numpy()))
        kept = 1 / 0.7 if mode == "upscale_in_train" else 1.0
        assert set(np.unique(outs[-1])) <= {0.0, np.float32(kept)}
        assert abs((outs[-1] > 0).mean() - 0.7) < 4 * (0.21 / 4000) ** 0.5
    ident = tp.ops.OP_REGISTRY["dropout"](tp.to_tensor(x), p=0.3,
                                          training=False)
    np.testing.assert_array_equal(ident.numpy(), x)
    zero = tp.ops.OP_REGISTRY["dropout_op"](tp.to_tensor(x), p=1.0,
                                            mode=mode)
    np.testing.assert_array_equal(zero.numpy(), 0 * x)


def test_dropout_gradient_follows_the_mask():
    x = tp.to_tensor(np.ones(1000, np.float32), stop_gradient=False)
    y = tp.nn.functional.dropout(x, 0.5)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), y.detach().numpy())


def _cast_log(monkeypatch):
    log = []
    inner = tamp.cast_inputs

    def wrapped(name, vals):
        log.append(name)
        return inner(name, vals)

    monkeypatch.setattr(tamp, "cast_inputs", wrapped)
    return log


def test_defop_casts_under_the_op_name_and_nested_ops_record_none(
        monkeypatch):
    log = _cast_log(monkeypatch)
    x = tp.to_tensor(P.X)
    w = tp.to_tensor(P.f32(4, 3))
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        y = tp.matmul(x, w)
        z = tp.nn.functional.cross_entropy(y, tp.to_tensor([0, 1, 2]))
        q = x @ w
    assert log == ["matmul", "cross_entropy", "matmul"]
    assert y.dtype == torch.bfloat16 and q.dtype == torch.bfloat16
    assert z.dtype == torch.float32          # black list: f32
    log.clear()
    tp.matmul(x, w)
    assert log == []                         # no AMP, no cast point


def test_defop_catches_nothing_and_restores_its_state():
    with pytest.raises(RuntimeError):
        tp.matmul(tp.to_tensor(P.X), tp.to_tensor(P.X))   # 3x4 @ 3x4
    assert _dispatch._state.depth == 0
    out = tp.add(tp.to_tensor(P.X), 1.0)
    assert isinstance(out, tp.Tensor)


def test_defop_outputs_are_tensors_and_inputs_keep_their_type():
    plain = torch.from_numpy(P.X.copy())
    out = tp.cast(plain, "float32")          # torch returns the input
    assert isinstance(out, tp.Tensor) and type(plain) is torch.Tensor
    parts = tp.split(tp.to_tensor(P.X), 2, axis=1)
    assert all(isinstance(t, tp.Tensor) for t in parts)
    vals, idx = tp.topk(tp.to_tensor(P.X), 2)
    assert isinstance(vals, tp.Tensor) and isinstance(idx, tp.Tensor)
