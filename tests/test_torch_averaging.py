"""Port parity: weight averaging (paddle_tpu_torch/optimizer/averaging.py
and its ``incubate.optimizer`` re-export) against the JAX package's, on
the CPU.

An MLP built in both packages from the same numpy weights takes the same
steps on the same data (SGD or AdamW); after each k-step run the
parameters, the EMA shadows and the averages must match JAX's to f32
rounding (``TOL``: the packages sum in other orders). ``restore()`` puts
back the exact bits. Under AMP O2 (bf16 parameters, f32 masters) the JAX
``LookAhead`` blends the parameter and leaves its master alone, so the
next step re-derives the parameter from the un-blended master; the port
keeps that quirk (``test_quirk_*``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.optimizer import averaging as javg
from paddle_tpu_torch.optimizer import averaging as tavg

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


def _weights():
    rng = np.random.RandomState(0)
    return [rng.randn(6, 12).astype("float32") * 0.3,
            rng.randn(12).astype("float32") * 0.1,
            rng.randn(12, 3).astype("float32") * 0.3,
            rng.randn(3).astype("float32") * 0.1]


def _batches(n):
    rng = np.random.RandomState(1)
    return [(rng.randn(8, 6).astype("float32"),
             rng.randn(8, 3).astype("float32")) for _ in range(n)]


def _net(P):
    net = P.nn.Sequential(P.nn.Linear(6, 12), P.nn.Tanh(),
                          P.nn.Linear(12, 3))
    for p, a in zip(net.parameters(), _weights()):
        assert tuple(p.shape) == a.shape
        p.set_value(a)
    return net


def _params(net):
    """Copies of the parameters in f32 (the port's numpy() shares the
    parameter's memory)."""
    return [np.array(p.astype("float32").numpy(), copy=True)
            for p in net.parameters()]


def _step(P, net, opt, x, y):
    loss = ((net(P.to_tensor(x)) - P.to_tensor(y)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def _run(P, A, steps, opt_name="SGD", k=3, alpha=0.5, o2=False):
    """(parameters after each step, EMA / ModelAverage applied weights,
    the net and the optimizer)."""
    net = _net(P)
    kw = {"weight_decay": 0.01} if opt_name == "AdamW" else {}
    opt = getattr(P.optimizer, opt_name)(learning_rate=0.05,
                                         parameters=net.parameters(), **kw)
    if o2:
        net, opt = P.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    look = A.LookAhead(opt, alpha=alpha, k=k)
    ema = A.ExponentialMovingAverage(net, decay=0.9)
    avg = A.ModelAverage(net, average_window_rate=0.5,
                         min_average_window=2, max_average_window=3)
    trail = []
    for x, y in _batches(steps):
        if o2:
            with P.amp.auto_cast(level="O2", dtype="bfloat16"):
                loss = ((net(P.to_tensor(x)) - P.to_tensor(y)) ** 2).mean()
            loss.backward()
            look.step()
            look.clear_grad()
        else:
            _step(P, net, look, x, y)
        ema.update()
        avg.update()
        trail.append(_params(net))
    out = {"trail": trail}
    with ema.average_weights():
        out["ema"] = _params(net)
    with avg.average_weights():
        out["avg"] = _params(net)
    out["after"] = _params(net)
    return out, net, opt, look, ema


@pytest.mark.parametrize("opt_name,k,steps", [("SGD", 3, 7),
                                              ("AdamW", 2, 6),
                                              ("SGD", 1, 3)])
def test_k_step_runs_match_jax(opt_name, k, steps):
    t = _run(tp, tavg, steps, opt_name, k)[0]
    j = _run(jp, javg, steps, opt_name, k)[0]
    for key in ("ema", "avg", "after"):
        for a, b in zip(t[key], j[key]):
            np.testing.assert_allclose(a, b, **TOL, err_msg=key)
    for i, (ts, js) in enumerate(zip(t["trail"], j["trail"])):
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a, b, **TOL, err_msg=f"step {i}")


def test_blend_is_the_slow_fast_interpolation():
    """After step k the parameters are slow + alpha (fast - slow): the
    fast weights from the same k steps of the bare optimizer, the slow
    ones the initial weights (worked out again here)."""
    def steps(wrap):
        net = _net(tp)
        opt = tp.optimizer.SGD(learning_rate=0.05,
                               parameters=net.parameters())
        opt = wrap(opt)
        for x, y in _batches(2):
            _step(tp, net, opt, x, y)
        return _params(net)
    slow = [np.asarray(a) for a in _weights()]
    fast = steps(lambda o: o)
    got = steps(lambda o: tavg.LookAhead(o, alpha=0.25, k=2))
    for g, s, f in zip(got, slow, fast):
        np.testing.assert_allclose(g, s + 0.25 * (f - s), rtol=0,
                                   atol=1e-7)


def test_restore_is_bitwise_and_state_round_trips():
    t, net, opt, look, ema = _run(tp, tavg, 4)
    before = [p.detach().clone() for p in net.parameters()]
    ema.apply()
    with pytest.raises(RuntimeError, match="already applied"):
        ema.apply()
    ema.restore()
    for a, b in zip(before, net.parameters()):
        assert torch.equal(a, b.detach())
    st = ema.state_dict()
    fresh = tavg.ExponentialMovingAverage(net, decay=0.5)
    fresh.set_state_dict(st)
    with fresh.average_weights():
        got = _params(net)
    for a, b in zip(got, t["ema"]):
        np.testing.assert_array_equal(a, b)
    assert look.get_lr() == opt.get_lr() == 0.05   # passes through


def test_quirk_o2_blend_is_overwritten_by_the_master():
    """bf16 O2, k = 2: after step 2 the bf16 parameters are the blend;
    step 3 re-derives them from the f32 master, which the blend never
    touched: each parameter is its master rounded to bf16, in both
    packages. Against JAX's: 2^-7 relative or 5e-4 absolute, since the
    bf16 forward and backward round in other places in each package
    (readings: up to 4.9e-4 on 7 of 123 entries, from step 1, before any
    blend)."""
    t = _run(tp, tavg, 3, k=2, o2=True)
    j = _run(jp, javg, 3, k=2, o2=True)
    for step in range(3):
        for a, b in zip(t[0]["trail"][step], j[0]["trail"][step]):
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=5e-4)
    # the slots are in parameter order (their keys are generated names)
    for p, sl in zip(t[1].parameters(), t[2]._slots.values()):
        assert torch.equal(p.detach(), sl["master"].to(torch.bfloat16))
    for p, sl in zip(j[1].parameters(), j[2]._slots.values()):
        m = np.asarray(sl["master"])
        np.testing.assert_array_equal(
            np.asarray(p.astype("float32").numpy()),
            np.asarray(jp.to_tensor(m).astype("bfloat16")
                       .astype("float32").numpy()))


def test_incubate_optimizer_reexports():
    from paddle_tpu.incubate import optimizer as jinc
    from paddle_tpu_torch.incubate import optimizer as tinc
    assert sorted(tinc.__all__) == sorted(jinc.__all__)
    assert tinc.LookAhead is tavg.LookAhead
    assert tp.optimizer.ModelAverage is tavg.ModelAverage
    assert tp.incubate.optimizer.ExponentialMovingAverage is \
        tavg.ExponentialMovingAverage
