"""Shared helper of the port's layer parity tests
(``tests/test_torch_nn_*.py``): one layer built in each package, the JAX
layer's state copied into the port's by module path
(``bridge.load_jax_params``, parameters and buffers), the same seeded
numpy inputs through both, and the outputs, the input gradients and the
parameter gradients of sum(out * c) for a seeded cotangent c compared
within the stated tolerance. This module holds no test of its own."""
import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.bridge import load_jax_params


def rs(seed):
    return np.random.RandomState(seed)


def f32(*shape, seed=0, scale=1.0):
    return (rs(seed).randn(*shape) * scale).astype(np.float32)


def _np(x):
    return np.asarray(x.numpy())


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def copy_state(jlayer, tlayer):
    """The JAX layer's parameters and buffers into the port layer."""
    params, buffers = jlayer.functional_state()
    load_jax_params(tlayer, {k: np.asarray(v) for k, v in params.items()},
                    {k: np.asarray(v) for k, v in buffers.items()})
    return tlayer


def run(pkg, layer, inputs, train=False, grad=True):
    """(outputs, input grads, {param path: grad}) of ``layer`` on
    ``inputs`` (numpy; float ones differentiated when ``grad``)."""
    layer.train() if train else layer.eval()
    args = [pkg.to_tensor(x, stop_gradient=not (
        grad and x.dtype.kind == "f")) if isinstance(x, np.ndarray) else x
        for x in inputs]
    outs = _flat(layer(*args))
    params = dict(layer.named_parameters())
    if not grad:
        return [_np(o) for o in outs], [], {}
    loss = None
    for i, o in enumerate(outs):
        c = pkg.to_tensor(rs(100 + i).uniform(-1, 1, tuple(o.shape))
                          .astype(np.float32))
        term = (o * c).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    in_grads = [None if a.stop_gradient or a.grad is None else _np(a.grad)
                for a in args if hasattr(a, "stop_gradient")]
    p_grads = {k: None if p.grad is None else _np(p.grad)
               for k, p in params.items()}
    return [_np(o) for o in outs], in_grads, p_grads


def check(make, inputs, train=False, grad=True, rtol=1e-5, atol=1e-5):
    """``make(pkg)`` builds the layer in either package; both run
    ``inputs`` and agree. Returns the two layers."""
    jp.seed(0)
    jlayer = make(jp)
    tlayer = copy_state(jlayer, make(tp))
    jo, jig, jpg = run(jp, jlayer, inputs, train, grad)
    to, tig, tpg = run(tp, tlayer, inputs, train, grad)
    assert len(jo) == len(to)
    for k, (a, b) in enumerate(zip(jo, to)):
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_allclose(b.astype(np.float64),
                                   a.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=f"output {k}")
    assert set(jpg) == set(tpg)
    for what, a, b in [(f"input grad {k}", a, b)
                       for k, (a, b) in enumerate(zip(jig, tig))] + \
            [(n, jpg[n], tpg[n]) for n in jpg]:
        if a is None or b is None:
            # no gradient on one side: none, or zeros, on the other
            assert not np.any(b if a is None else a), what
            continue
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=what)
    return jlayer, tlayer
