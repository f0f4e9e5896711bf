"""Port parity: higher-order autodiff (paddle_tpu_torch/incubate/
functional.py) against paddle_tpu.incubate.functional, on the CPU.

- On plain ops, every transform (``grad`` over two arguments,
  ``value_and_grad``, ``jacobian`` rev and fwd, ``hessian``, ``vjp``,
  ``jvp``, ``grad`` of ``grad``) gives JAX's values in f32 (``TOL``: the
  packages evaluate tanh, sin and the reductions in other orders;
  readings up to 2e-6).
- Through a hand-written kernel (flash attention, the fused CE head):
  first-order ``grad`` and ``vjp`` equal JAX's through its Pallas kernels
  (interpret mode); forward mode and a second derivative raise in both,
  as ``jax.custom_vjp`` does.
- Known difference: JAX's guarded dispatch
  (``nn.functional.scaled_dot_product_attention``) demotes a kernel that
  fails under a transform to its jnp composite and runs; the port has no
  fallback, so the same call raises.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.incubate import functional as JF
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jflash
from paddle_tpu.ops.pallas.fused_ce import fused_linear_cross_entropy as jce
from paddle_tpu_torch.incubate import functional as TF
from paddle_tpu_torch.ops.cuda import flash_attention as tflash
from paddle_tpu_torch.ops.cuda import fused_ce as tce

TOL = dict(rtol=1e-5, atol=5e-6)


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


def _x():
    return np.random.RandomState(0).randn(3, 4).astype("float32")


def _w():
    return np.random.RandomState(1).randn(4, 2).astype("float32")


def _loss(P):
    return lambda x, w: (P.tanh(P.matmul(x, w)) ** 2).sum() \
        + (x * x).mean()


def _vec(P):
    return lambda x: P.tanh(x) * 2.0 + x ** 3


CASES = {
    "grad_two_args": (lambda P, F: F.grad(_loss(P), argnums=(0, 1)), 2),
    "grad_one_arg": (lambda P, F: F.grad(_loss(P), argnums=1), 2),
    "value_and_grad": (lambda P, F: F.value_and_grad(_loss(P)), 2),
    "jacobian_rev": (lambda P, F: F.jacobian(_vec(P)), 1),
    "jacobian_fwd": (lambda P, F: F.jacobian(_vec(P), mode="fwd"), 1),
    "hessian": (lambda P, F: F.hessian(
        lambda x: _loss(P)(x, P.to_tensor(_w()))), 1),
    "grad_of_grad": (lambda P, F: F.grad(
        lambda x: F.grad(lambda y: (P.sin(y) ** 3).sum())(x).sum()), 1),
}


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _leaves(o)]
    return [np.asarray(out.numpy())]


@pytest.mark.parametrize("case", sorted(CASES))
def test_transforms_on_plain_ops_match_jax(case):
    make, nargs = CASES[case]
    args = [_x(), _w()][:nargs]
    t = make(tp, TF)(*[tp.to_tensor(a) for a in args])
    j = make(jp, JF)(*[jp.to_tensor(a) for a in args])
    tl, jl = _leaves(t), _leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    for o in (t if isinstance(t, tuple) else (t,)):
        assert isinstance(o, tp.Tensor) and not o.requires_grad


def test_vjp_and_jvp_match_jax():
    x, ct = _x(), np.random.RandomState(2).randn(3, 4).astype("float32")
    to, pb = TF.vjp(_vec(tp), tp.to_tensor(x))
    jo, jpb = JF.vjp(_vec(jp), jp.to_tensor(x))
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    (tg,), (jg,) = pb(tp.to_tensor(ct)), jpb(jp.to_tensor(ct))
    np.testing.assert_allclose(tg.numpy(), jg.numpy(), **TOL)
    t = TF.jvp(_vec(tp), (tp.to_tensor(x),), (tp.to_tensor(ct),))
    j = JF.jvp(_vec(jp), (jp.to_tensor(x),), (jp.to_tensor(ct),))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_as_raw_fn_and_errors():
    raw = TF.as_raw_fn(lambda a, k: tp.multiply(a, k))
    out = raw(torch.ones(2), 3.0)
    assert type(out) is torch.Tensor and out.tolist() == [3.0, 3.0]
    with pytest.raises(TypeError, match="scalar"):
        TF.grad(_vec(tp))(tp.to_tensor(_x()))
    with pytest.raises(ValueError, match="mode"):
        TF.jacobian(_vec(tp), mode="sideways")


def _qkv():
    rng = np.random.RandomState(3)
    return rng.randn(1, 2, 8, 16).astype("float32")


def _ce_inputs():
    rng = np.random.RandomState(4)
    return (rng.randn(8, 16).astype("float32"),
            rng.randn(11, 16).astype("float32"),
            np.array([1, 3, -100, 10, 0, 5, 7, -100]))


def _flash_fn(P):
    if P is jp:
        return lambda q: jflash(q, q * 0.5, q).sum()
    return lambda q: tflash(q, q * 0.5, q).sum()


def _ce_fn(P, w, y):
    if P is jp:
        return lambda h: jce(h, jnp.asarray(w), None, jnp.asarray(y)).sum()
    return lambda h: tce(h, torch.as_tensor(w), None,
                         torch.as_tensor(y)).sum()


def test_first_order_through_the_kernels_matches_jax():
    """The port's Functions on the CPU (the kernels' plain versions)
    against jax.grad through the Pallas kernels in interpret mode."""
    q = _qkv()
    jg = jax.grad(_flash_fn(jp))(jnp.asarray(q))
    tg = TF.grad(_flash_fn(tp))(tp.to_tensor(q))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)
    h, w, y = _ce_inputs()
    jg = jax.grad(_ce_fn(jp, w, y))(jnp.asarray(h))
    out, pb = TF.vjp(_ce_fn(tp, w, y), tp.to_tensor(h))
    (tg,) = pb(tp.to_tensor(np.float32(1.0)))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


RAISES = {
    "jvp": (lambda F, f, x: F(f, (x,), (x,)), "jvp"),
    "jacobian_fwd": (lambda F, f, x: F(f)(x), "jacfwd"),
    "grad_of_grad": (lambda F, f, x: F(f)(x), "grad2"),
    "hessian": (lambda F, f, x: F(f)(x), "hessian"),
}


def _jax_transform(kind, f):
    return {"jvp": lambda x: jax.jvp(f, (x,), (x,)),
            "jacobian_fwd": jax.jacfwd(f),
            "grad_of_grad": jax.grad(lambda x: jax.grad(f)(x).sum()),
            "hessian": jax.hessian(f)}[kind]


def _port_transform(kind, f):
    return {"jvp": lambda x: TF.jvp(f, (x,), (x,)),
            "jacobian_fwd": TF.jacobian(f, mode="fwd"),
            "grad_of_grad": TF.grad(lambda x: TF.grad(f)(x).sum()),
            "hessian": TF.hessian(f)}[kind]


@pytest.mark.parametrize("kernel", ["flash", "fused_ce"])
@pytest.mark.parametrize("kind", sorted(RAISES))
def test_forward_mode_and_second_order_through_a_kernel_raise_as_jax(
        kind, kernel):
    if kernel == "flash":
        x = _qkv()[:, :, :4, :4].copy()
        jf, tf = _flash_fn(jp), _flash_fn(tp)
    else:
        h, w, y = _ce_inputs()
        x, jf, tf = h, _ce_fn(jp, w, y), _ce_fn(tp, w, y)
    with pytest.raises((TypeError, AssertionError)):
        _jax_transform(kind, jf)(jnp.asarray(x))
    with pytest.raises(RuntimeError):
        _port_transform(kind, tf)(tp.to_tensor(x))


def test_known_difference_jax_dispatch_demotes_where_the_port_raises():
    q = _qkv()
    jflags = jp.get_flags(["FLAGS_flash_attention_interpret",
                           "FLAGS_flash_min_seq"])
    tflags = tp.get_flags(["FLAGS_flash_min_seq"])
    jp.set_flags({"FLAGS_flash_attention_interpret": True,
                  "FLAGS_flash_min_seq": 0})
    tp.set_flags({"FLAGS_flash_min_seq": 0})
    try:
        def model(P):
            sdpa = P.nn.functional.scaled_dot_product_attention
            return lambda x: sdpa(x, x, x).sum()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = JF.jvp(model(jp), (jp.to_tensor(q),), (jp.to_tensor(q),))
        assert np.isfinite(out[1].numpy()).all()
        assert any("demoted" in str(w.message) for w in caught)
        with pytest.raises(RuntimeError):
            TF.jvp(model(tp), (tp.to_tensor(q),), (tp.to_tensor(q),))
        # first order runs through the kernel path in both
        tg = TF.grad(model(tp))(tp.to_tensor(q))
        jg = JF.grad(model(jp))(jp.to_tensor(q))
        np.testing.assert_allclose(tg.numpy(), jg.numpy(), rtol=1e-4,
                                   atol=1e-5)
    finally:
        jp.set_flags(jflags)
        tp.set_flags(tflags)
