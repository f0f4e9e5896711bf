"""Port parity: the Tensor and its Paddle surface (paddle_tpu_torch/core,
ops/_bind.py) against paddle_tpu, case by case after tests/test_tensor.py
and tests/test_tensor_hooks.py; then the names where Paddle's meaning and
torch's differ, each stated as the port keeps it (core/tensor.py lists
them), and the default device.

Every case builds the same inputs from numpy and runs them through both
packages; values are compared exactly where the op is exact, else within
f32 rounding (rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice


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
    """The port's tensors land on the card by default: these run on the
    CPU."""
    with tdevice.device_scope("cpu"):
        yield


def both(fn):
    """fn(paddle module) for each package, as numpy."""
    return np.asarray(fn(jp).numpy()), np.asarray(fn(tp).numpy())


def same(fn, rtol=0.0):
    a, b = both(fn)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=rtol, atol=0)


def test_to_tensor_basic():
    data = [[1.0, 2.0], [3.0, 4.0]]
    t = tp.to_tensor(data)
    assert isinstance(t, tp.Tensor) and t.shape == (2, 2)
    assert t.dtype == tp.float32 and tp.float32 is torch.float32
    same(lambda p: p.to_tensor(data))


@pytest.mark.parametrize("value, name", [
    (1.5, "float32"), (3, "int64"), (True, "bool"),
    (np.float64(2.0), "float32"), (np.array([1], "int32"), "int32")])
def test_default_dtypes(value, name):
    j = jp.to_tensor(value)
    t = tp.to_tensor(value)
    assert np.dtype(j.dtype).name == name
    assert t.dtype == getattr(tp, name if name != "bool" else "bool_")


def test_creation_ops():
    same(lambda p: p.zeros([2, 3]))
    assert tp.ones([4], dtype="int32").dtype == torch.int32
    same(lambda p: p.full([2], 7.0))
    same(lambda p: p.arange(5))
    same(lambda p: p.eye(3))
    same(lambda p: p.zeros_like(p.ones([2, 2])))


A = np.array([1.0, 2.0, 3.0], np.float32)
B = np.array([4.0, 5.0, 6.0], np.float32)


@pytest.mark.parametrize("expr", [
    lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
    lambda a, b: b / a, lambda a, b: a ** 2, lambda a, b: 2.0 + a,
    lambda a, b: -a, lambda a, b: abs(a - b), lambda a, b: 1.0 - a,
    lambda a, b: 6.0 / a, lambda a, b: a @ b, lambda a, b: a > b,
    lambda a, b: a == b, lambda a, b: a != b, lambda a, b: a <= 2.0])
def test_operators(expr):
    same(lambda p: expr(p.to_tensor(A), p.to_tensor(B)), rtol=1e-6)


def test_operators_return_tensor():
    a = tp.to_tensor(A)
    for out in (a + 1.0, 1.0 - a, a * a, a @ a, -a, a[1:], a > 0):
        assert isinstance(out, tp.Tensor)


def test_comparison_and_logic():
    same(lambda p: p.to_tensor(A) > p.to_tensor([2.0, 2.0, 2.0]))
    assert bool(tp.ops.allclose(tp.to_tensor(A), tp.to_tensor(A)))


def test_matmul():
    a = np.arange(6, dtype="float32").reshape(2, 3)
    b = np.arange(12, dtype="float32").reshape(3, 4)
    same(lambda p: p.to_tensor(a) @ p.to_tensor(b))
    same(lambda p: p.matmul(p.to_tensor(a), p.to_tensor(b)))


@pytest.mark.parametrize("index", [
    lambda p: 0, lambda p: (slice(None), 1), lambda p: (0, 1, 2),
    lambda p: (Ellipsis, -1), lambda p: p.to_tensor([0, 1])])
def test_indexing(index):
    x = np.arange(24, dtype="float32").reshape(2, 3, 4)
    same(lambda p: p.to_tensor(x)[index(p)])


def test_setitem():
    for p in (jp, tp):
        x = p.zeros([3, 3])
        x[1] = 5.0
        x[0, 0] = 1.0
        np.testing.assert_allclose(x.numpy()[1], [5, 5, 5])
        assert x[0, 0].item() == 1.0


@pytest.mark.parametrize("fn", [
    lambda x: x.reshape([3, 4]), lambda x: x.reshape([3, -1]),
    lambda x: x.reshape([3, 4]).transpose([1, 0]),
    lambda x: x.reshape([1, 12, 1]).squeeze(),
    lambda x: x.unsqueeze(0), lambda x: x.reshape([3, 4]).flatten()])
def test_reshape_and_friends(fn):
    x = np.arange(12, dtype="float32")
    same(lambda p: fn(p.to_tensor(x)))


def test_concat_stack_split():
    x = np.arange(12, dtype="float32")
    same(lambda p: p.concat([p.to_tensor(x), p.to_tensor(x)]))
    same(lambda p: p.stack([p.to_tensor(x), p.to_tensor(x)]))
    for sec in (2, [1, 3], [1, -1]):
        j = jp.split(jp.to_tensor(x.reshape(3, 4)), sec, axis=1)
        t = tp.split(tp.to_tensor(x.reshape(3, 4)), sec, axis=1)
        assert len(j) == len(t)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), a.numpy())


@pytest.mark.parametrize("fn", [
    lambda x: x.sum(), lambda x: x.sum(axis=0), lambda x: x.mean(),
    lambda x: x.max(), lambda x: x.argmax(), lambda x: x.min(axis=1),
    lambda x: x.prod(axis=1), lambda x: x.mean(axis=-1, keepdim=True)])
def test_reductions(fn):
    x = np.arange(6, dtype="float32").reshape(2, 3)
    same(lambda p: fn(p.to_tensor(x)), rtol=1e-6)


def test_cast():
    x = tp.to_tensor([1.5, 2.5])
    y = x.astype("int32")
    assert y.dtype == torch.int32 and y.stop_gradient
    assert x.astype(tp.bfloat16).dtype == torch.bfloat16
    assert x.cast("float16").dtype == torch.float16
    same(lambda p: p.to_tensor([1.5, 2.5, -0.5]).astype("int32"))


def test_topk_sort():
    x = [3.0, 1.0, 4.0, 1.0, 5.0]
    jv, ji = jp.topk(jp.to_tensor(x), 2)
    tv, ti = tp.topk(tp.to_tensor(x), 2)
    np.testing.assert_array_equal(tv.numpy(), jv.numpy())
    np.testing.assert_array_equal(ti.numpy(), ji.numpy())
    same(lambda p: p.sort(p.to_tensor(x)))


def test_where_gather_scatter():
    x = [1.0, 2.0, 3.0, 4.0]
    cond = [True, False, True, False]
    same(lambda p: p.where(p.to_tensor(cond), p.to_tensor(x),
                           -p.to_tensor(x)))
    same(lambda p: p.gather(p.to_tensor(x), p.to_tensor([2, 0])))
    same(lambda p: p.scatter(p.to_tensor(x), p.to_tensor([0, 1]),
                             p.to_tensor([10.0, 20.0])))


def test_random_reproducible():
    tp.seed(42)
    a = tp.randn([4])
    tp.seed(42)
    b = tp.randn([4])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    u = tp.uniform([1000], min=0.0, max=1.0)
    assert 0.0 <= float(u.min()) and float(u.max()) <= 1.0


def test_einsum():
    rng = np.random.RandomState(0)
    a = rng.rand(2, 3).astype("float32")
    b = rng.rand(3, 4).astype("float32")
    same(lambda p: p.einsum("ij,jk->ik", p.to_tensor(a), p.to_tensor(b)),
         rtol=1e-6)


def test_detach_and_clone():
    x = tp.to_tensor([1.0], stop_gradient=False)
    d = x.detach()
    assert d.stop_gradient and isinstance(d, tp.Tensor)
    c = x.clone()
    assert not c.stop_gradient and isinstance(c, tp.Tensor)


# -- hooks (tests/test_tensor_hooks.py) -------------------------------------

def test_hook_observes_and_replaces_grad():
    res = {}
    for p in (jp, tp):
        x = p.to_tensor(np.array([1.0, 2.0], "float32"), stop_gradient=False)
        y = x * 2.0
        seen = []
        y.register_hook(lambda g: seen.append(np.asarray(g.numpy()))
                        or (g * 10.0))
        y.sum().backward()
        res[p] = (seen[0], x.grad.numpy())
    for a, b in zip(res[jp], res[tp]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(res[tp][1], [20.0, 20.0])


def test_leaf_hook_and_remove():
    x = tp.to_tensor(np.ones(3, "float32"), stop_gradient=False)
    seen = []
    h = x.register_hook(lambda g: seen.append(1))
    (x * 3.0).sum().backward()
    assert seen == [1]
    h.remove()
    x.clear_gradient()
    assert x.grad is None
    (x * 3.0).sum().backward()
    assert seen == [1]


def test_observer_hook_keeps_grad():
    x = tp.to_tensor(np.ones(2, "float32"), stop_gradient=False)
    y = x * 5.0
    y.register_hook(lambda g: None)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0, 5.0])


def test_hook_on_stop_gradient_raises():
    for p in (jp, tp):
        with pytest.raises(RuntimeError, match="stop_gradient"):
            p.to_tensor(np.ones(2, "float32")).register_hook(lambda g: g)


def test_multiple_hooks_chain_in_order():
    x = tp.to_tensor(np.ones(2, "float32"), stop_gradient=False)
    y = x * 1.0
    y.register_hook(lambda g: g + 1.0)
    y.register_hook(lambda g: g * 2.0)
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 4.0])


# -- where Paddle's meaning and torch's differ --------------------------------

X = np.arange(12, dtype="float32").reshape(3, 4)


def test_clash_numpy_copies_a_tensor_that_needs_grad():
    t = tp.to_tensor(X, stop_gradient=False)
    with pytest.raises(RuntimeError):
        torch.Tensor.numpy(t)               # torch refuses
    np.testing.assert_array_equal(t.numpy(), X)


def test_clash_numpy_of_bf16_is_f32():
    t = tp.to_tensor([1.5, -2.25]).astype("bfloat16")
    a = t.numpy()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, [1.5, -2.25])


def test_clash_max_min_median():
    t = tp.to_tensor(X)
    # Paddle's meaning through the function and the keyword
    same(lambda p: p.max(p.to_tensor(X), axis=1))
    same(lambda p: p.to_tensor(X).max(axis=1))
    same(lambda p: p.to_tensor(X).min(axis=0))
    same(lambda p: p.median(p.to_tensor(X), axis=1))
    same(lambda p: p.to_tensor(X[:, :3]).median(axis=1))
    # known difference: a positional axis is torch's (values, indices)
    values, indices = t.max(1)
    np.testing.assert_array_equal(values.numpy(), X.max(1))
    np.testing.assert_array_equal(indices.numpy(), X.argmax(1))


def test_clash_split():
    j = jp.to_tensor(X).split(2, axis=1)
    t = tp.to_tensor(X).split(2, axis=1)
    assert len(j) == len(t) == 2
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    # known difference: without axis= the int is torch's section size
    assert len(tp.to_tensor(X).split(1, 1)) == 4
    assert len(tp.split(tp.to_tensor(X), 1, 1)) == 1


def test_clash_transpose():
    same(lambda p: p.to_tensor(X).transpose([1, 0]))
    same(lambda p: p.transpose(p.to_tensor(X), [1, 0]))
    # known difference: two ints swap two axes, torch's form
    assert tp.to_tensor(X).transpose(0, 1).shape == (4, 3)


def test_clash_squeeze_unsqueeze_with_lists():
    same(lambda p: p.to_tensor(X).unsqueeze([0, 2]))
    same(lambda p: p.unsqueeze(p.to_tensor(X), [0, 3]))
    same(lambda p: p.to_tensor(X).reshape([1, 3, 1, 4]).squeeze([0, 2]))


def test_clash_size_is_torch_method():
    t = tp.to_tensor(X)
    assert jp.to_tensor(X).size == 12            # Paddle: the element count
    assert t.size() == (3, 4) and t.numel() == 12      # known difference


def test_clash_sum_positional_keepdim_is_torch():
    t = tp.to_tensor(X)
    assert t.sum(1, True).shape == (3, 1)        # torch's keepdim
    same(lambda p: p.to_tensor(X).sum(axis=1, keepdim=True))


def test_clash_where_equal_allclose():
    cond = X > 5
    t = tp.to_tensor(X)
    # torch's x.where(cond, y); paddle.where(cond, x, y) is Paddle's
    np.testing.assert_array_equal(
        t.where(tp.to_tensor(cond), tp.to_tensor(-X)).numpy(),
        np.where(cond, X, -X))
    same(lambda p: p.where(p.to_tensor(cond), p.to_tensor(X),
                           p.to_tensor(-X)))
    assert t.equal(t) is True                      # torch: one bool
    same(lambda p: p.equal(p.to_tensor(X), p.to_tensor(X.T.T)))


def test_clash_attributes():
    t = tp.to_tensor(X, stop_gradient=False)
    assert t.stop_gradient is False
    t.stop_gradient = True
    assert t.requires_grad is False
    t.set_value(np.ones((3, 4), np.float32))
    np.testing.assert_array_equal(t.numpy(), np.ones((3, 4)))
    t.stop_gradient = False
    (t * 2.0).sum().backward()
    assert isinstance(t.grad, tp.Tensor)
    np.testing.assert_array_equal(t.gradient(), np.full((3, 4), 2.0))
    t.clear_grad()
    assert t.grad is None and t.gradient() is None
    assert t.astype("float16").dtype == torch.float16
    assert t.cast("int64").dtype == torch.int64


def test_parameter_grad_is_tensor():
    lin = tp.nn.Linear(3, 2)
    lin(tp.to_tensor(X[:, :3])).sum().backward()
    assert isinstance(lin.weight.grad, tp.Tensor)
    assert isinstance(lin.weight, torch.nn.Parameter)


def test_known_difference_reshape_view_dim_are_torch():
    t = tp.to_tensor(X)
    assert t.reshape(2, 6).shape == (2, 6)
    assert t.view(4, 3).shape == (4, 3) and t.dim() == 2


def test_o1_bf16_matmul_of_f32_returns_bf16_as_jax():
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    w = np.random.RandomState(1).randn(8, 3).astype(np.float32)
    with jp.amp.auto_cast(level="O1", dtype="bfloat16"):
        j = jp.to_tensor(x) @ jp.to_tensor(w)
        j_add = jp.to_tensor(x) + jp.to_tensor(x)
    with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
        t = tp.to_tensor(x) @ tp.to_tensor(w)
        t_add = tp.to_tensor(x) + tp.to_tensor(x)
    assert np.dtype(j.dtype).name == "bfloat16" and t.dtype == torch.bfloat16
    assert t_add.dtype == torch.float32 and \
        np.dtype(j_add.dtype).name == "float32"
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j.astype("float32").numpy()),
                               rtol=1e-2, atol=1e-2)


# -- the default device -------------------------------------------------------

def test_tensors_and_layers_default_to_the_card():
    with tdevice.device_scope("cpu"):
        pass
    prev = tdevice._current
    tdevice._current = None
    try:
        if torch.cuda.is_available():
            assert tp.to_tensor([1.0]).device.type == "cuda"
            return
        for make in (lambda: tp.to_tensor([1.0]), lambda: tp.zeros([2]),
                     lambda: tp.nn.Linear(4, 4),
                     lambda: tp.nn.LayerNorm(4)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        assert tp.get_device() == "gpu:0"
        assert tp.set_device("cpu") == "cpu"
        assert tp.to_tensor([1.0]).device.type == "cpu"
        assert tp.to_tensor([1.0], place="cpu").place == tp.CPUPlace()
    finally:
        tdevice._current = prev


# -- negative-step slices (ROADMAP Queue 3 C1) --------------------------------

def test_negative_step_slices_read_and_write_as_jax():
    for idx in (slice(None, None, -1), (slice(None), slice(None, None, -2)),
                (slice(2, 0, -1), slice(None, None, -3))):
        same(lambda p: p.to_tensor(X)[idx])
    t = tp.to_tensor(X)
    v = np.arange(6, dtype="float32").reshape(3, 2) * 10
    t[:, ::-2] = tp.to_tensor(v)
    want = jp.to_tensor(X)
    want[:, ::-2] = jp.to_tensor(v)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want.numpy()))


# -- float64 (ROADMAP Queue 3 D) ----------------------------------------------

_X64 = {
    "int_with_float_scalar": lambda p: p.to_tensor(np.array([1, 2, 3])) * 1.5,
    "int_divide_int": lambda p: p.to_tensor(np.array([1, 2, 3])) / p.to_tensor(
        np.array([2, 2, 2])),
    "sqrt_of_int": lambda p: p.sqrt(p.to_tensor(np.array([1, 4, 9]))),
    "exp_of_int": lambda p: p.exp(p.to_tensor(np.array([0, 1, 2]))),
    "arange_float": lambda p: p.arange(0.0, 2.0, 0.5),
    "linspace": lambda p: p.linspace(0.0, 1.0, 5),
    "logspace": lambda p: p.logspace(0.0, 2.0, 3),
    "one_hot": lambda p: p.one_hot(p.to_tensor(np.array([0, 2])), 3),
    "increment_int": lambda p: p.increment(p.to_tensor(np.array([1, 2]))),
}


@pytest.mark.parametrize("name", sorted(_X64))
def test_known_difference_x64_floats_are_f32_in_the_port(name):
    """The JAX package runs with x64 on, so these give float64 there; the
    port gives Paddle's default float32, with the same values."""
    j, t = _X64[name](jp), _X64[name](tp)
    assert np.asarray(j.numpy()).dtype == np.float64
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=1e-6)
