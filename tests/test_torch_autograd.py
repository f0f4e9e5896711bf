"""Port parity: the autograd surface (paddle_tpu_torch/core/tape.py,
autograd.py) against paddle_tpu, case by case after tests/test_autograd.py:
the same numpy inputs through both packages, gradients compared (exact
where the arithmetic is, else rtol 1e-6 in f32).
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
    with tdevice.device_scope("cpu"):
        yield


def grads(fn, *arrays, rtol=1e-6):
    """fn(paddle, *tensors) -> a scalar to backward from; the inputs'
    .grad in both packages, compared."""
    out = {}
    for p in (jp, tp):
        ts = [p.to_tensor(a, stop_gradient=False) for a in arrays]
        fn(p, *ts).backward()
        out[p] = [t.grad.numpy() for t in ts]
    for a, b in zip(out[jp], out[tp]):
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol)
    return out[tp]


def test_simple_backward():
    g = grads(lambda p, x: (x * x).sum(), np.array([2.0, 3.0], np.float32))
    np.testing.assert_allclose(g[0], [4.0, 6.0])


def test_chain():
    grads(lambda p, x: (p.exp(x) * 2.0).sum(),
          np.array([1.0, 2.0], np.float32))


def test_grad_accumulation_multiple_uses():
    g = grads(lambda p, x: (x * x + x).sum(), np.array([3.0], np.float32))
    np.testing.assert_allclose(g[0], [7.0])


def test_grad_accumulates_across_backwards():
    for p in (jp, tp):
        x = p.to_tensor([1.0], stop_gradient=False)
        (x * 2).backward()
        (x * 3).backward()
        np.testing.assert_allclose(x.grad.numpy(), [5.0])
        x.clear_grad()
        assert x.grad is None


def test_stop_gradient_blocks():
    for p in (jp, tp):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = p.to_tensor([2.0], stop_gradient=True)
        (x * y).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.0])
        assert y.grad is None


def test_detach_cuts_graph():
    g = grads(lambda p, x: ((x * x).detach() * x).sum(),
              np.array([2.0], np.float32))
    np.testing.assert_allclose(g[0], [4.0])


@pytest.mark.parametrize("form", ["context", "decorator", "bare_decorator"])
def test_no_grad(form):
    x = tp.to_tensor([1.0], stop_gradient=False)

    def f(v):
        return v * 3

    if form == "context":
        with tp.no_grad():
            y = f(x)
    elif form == "decorator":
        y = tp.no_grad()(f)(x)
    else:
        y = tp.no_grad(f)(x)
    assert y.stop_gradient and y.grad_fn is None
    assert tp.is_grad_enabled()


def test_enable_grad_inside_no_grad_and_set_grad_enabled():
    x = tp.to_tensor([1.0], stop_gradient=False)
    with tp.no_grad():
        with tp.enable_grad():
            y = x * 2
        z = x * 2
    assert not y.stop_gradient and z.stop_gradient
    with tp.set_grad_enabled(False):
        assert not tp.is_grad_enabled()
    assert tp.is_grad_enabled()
    assert jp.is_grad_enabled()


def test_matmul_grad():
    rng = np.random.RandomState(0)
    grads(lambda p, a, b: p.matmul(a, b).sum(),
          rng.rand(3, 4).astype("float32"), rng.rand(4, 5).astype("float32"))


def test_broadcast_grad():
    g = grads(lambda p, x, b: ((x + b) * 2).sum(),
              np.ones((3, 4), "float32"), np.ones(4, "float32"))
    np.testing.assert_allclose(g[1], [6, 6, 6, 6])


def test_softmax_ce_grad_matches_softmax_minus_onehot():
    logits = np.array([[1.0, 2.0, 3.0]], dtype="float32")
    out = {}
    for p in (jp, tp):
        t = p.to_tensor(logits, stop_gradient=False)
        p.ops.cross_entropy(t, p.to_tensor(np.array([2]))).backward()
        out[p] = t.grad.numpy()
    np.testing.assert_allclose(out[tp], np.asarray(out[jp]), rtol=1e-6,
                               atol=1e-7)


def test_paddle_grad_api():
    for p in (jp, tp):
        x = p.to_tensor([2.0], stop_gradient=False)
        (gx,) = p.grad(x * x * x, x)
        np.testing.assert_allclose(gx.numpy(), [12.0])
        assert x.grad is None


def test_paddle_grad_unused():
    for p in (jp, tp):
        x = p.to_tensor([1.0], stop_gradient=False)
        z = p.to_tensor([1.0], stop_gradient=False)
        with pytest.raises(RuntimeError):
            p.grad(x * 2, [x, z])
        gx, gz = p.grad(x * 2, [x, z], allow_unused=True)
        assert gz is None and np.allclose(gx.numpy(), [2.0])


def test_paddle_grad_create_graph_second_order():
    for p in (jp, tp):
        x = p.to_tensor([2.0], stop_gradient=False)
        (gx,) = p.grad(x * x * x, x, create_graph=True)      # 3 x^2
        (ggx,) = p.grad(gx, x)                                # 6 x
        np.testing.assert_allclose(ggx.numpy(), [12.0])


def test_paddle_grad_outputs_and_retain_graph():
    x = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * x
    (g,) = tp.grad(y, x, grad_outputs=tp.to_tensor([1.0, 10.0]),
                   retain_graph=True)
    np.testing.assert_allclose(g.numpy(), [2.0, 40.0])
    (g2,) = tp.grad(y.sum(), x)
    np.testing.assert_allclose(g2.numpy(), [2.0, 4.0])


def test_paddle_grad_no_grad_vars():
    x = tp.to_tensor([3.0], stop_gradient=False)
    a = x * 2
    b = x * 5
    (g,) = tp.grad(a + b, x, no_grad_vars=[b])
    np.testing.assert_allclose(g.numpy(), [2.0])      # nothing through b


def test_retain_graph():
    for p in (jp, tp):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = (x * x).sum()
        y.backward(retain_graph=True)
        y.backward()
        np.testing.assert_allclose(x.grad.numpy(), [4.0])


def test_freed_graph_raises():
    for p in (jp, tp):
        x = p.to_tensor([1.0], stop_gradient=False)
        y = (x * x).sum()
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()


def test_backward_of_stop_gradient_raises():
    with pytest.raises(RuntimeError, match="stop_gradient"):
        tp.to_tensor([1.0]).backward()


def test_setitem_grad():
    x = tp.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    y = x * 2
    y[0] = 0.0
    y.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 2.0, 2.0])


def test_getitem_grad():
    g = grads(lambda p, x: x[1:].sum(), np.array([1.0, 2.0, 3.0], "float32"))
    np.testing.assert_allclose(g[0], [0.0, 1.0, 1.0])


def test_multi_output_split_grad():
    def f(p, x):
        a, b = p.split(x, 2)
        return a.sum() * 2 + b.sum() * 3
    g = grads(f, np.arange(4, dtype="float32"))
    np.testing.assert_allclose(g[0], [2, 2, 3, 3])


def test_backward_non_scalar_with_grad_tensor():
    for p in (jp, tp):
        x = p.to_tensor([1.0, 2.0], stop_gradient=False)
        (x * 3).backward(p.to_tensor([1.0, 10.0]))
        np.testing.assert_allclose(x.grad.numpy(), [3.0, 30.0])


def _double(p):
    class Double(p.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    return Double


def test_pylayer():
    for p in (jp, tp):
        x = p.to_tensor([1.5], stop_gradient=False)
        y = _double(p).apply(x)
        np.testing.assert_allclose(y.numpy(), [3.0])
        y.backward()
        np.testing.assert_allclose(x.grad.numpy(), [2.0])


def test_pylayer_ctx_saves_tensors_and_takes_two_inputs():
    class Mul(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensor
            return g * b, g * a

    a = tp.to_tensor([2.0, 3.0], stop_gradient=False)
    b = tp.to_tensor([5.0, 7.0], stop_gradient=False)
    out = Mul.apply(a, b)
    assert isinstance(out, tp.Tensor)
    out.sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), [5.0, 7.0])
    np.testing.assert_allclose(b.grad.numpy(), [2.0, 3.0])


def test_pylayer_wrong_grad_count_raises():
    class Bad(tp.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            return x * 1.0

        @staticmethod
        def backward(ctx, g):
            return g, g

    x = tp.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="2 grads for 1 tensor"):
        Bad.apply(x).sum().backward()


def test_autograd_namespace_matches_jax():
    for name in ("backward", "grad", "no_grad", "enable_grad",
                 "is_grad_enabled", "set_grad_enabled", "PyLayer"):
        assert hasattr(jp.autograd, name) and hasattr(tp.autograd, name)
    assert isinstance(torch.is_grad_enabled(), bool)
