"""Port parity: the twelve optimizers (paddle_tpu_torch/optimizer) against
the JAX package's ``apply_gradients_pure``.

Three steps (t = 1, 2, 3) from equal params, grads and fresh slots, over
a case list that covers every rule (SGD, Momentum and Nesterov, Adam,
AdamW, Adamax, Adagrad, Adadelta, RMSProp plain and centered, Lamb, Lars,
Ftrl, Dpsgd at sigma 0), f32 parameters and bf16 ones with and without f32
master weights, a float / ``L1Decay`` / ``L2Decay`` weight decay, no clip
or ``ClipGradByGlobalNorm``, an LR scheduler, and per-parameter
``lr_ratio`` / ``need_clip`` / ``regularizer`` (``param_meta``). f32
values (params without a master, f32 masters, slots) agree to 1e-6
absolute: both run the same f32 expressions in the same order; powers,
square roots and norms may differ in the last bit. A bf16 parameter is
compared at one bf16 ulp (rtol 2**-8): it is an f32 value rounded to
bf16, and a difference in the last f32 bit can flip that rounding; for
the same reason the slots fed by clipped bf16 grads hold to two bf16
ulps. Dpsgd's noise is checked by its mean and spread.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import optimizer as topt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are tiny: one intra-op thread is enough, and it leaves
    the other cores to the timing-sensitive tests that run beside this
    file in a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-6
# Ftrl's slots and parameters go through two square roots a step (lr_power
# -0.5), and torch's CPU sqrt is not correctly rounded on every host: on
# 100,000 f32 values in [0, 1e4) torch 2.13's sqrt differs from np.sqrt on
# ~15.5% of them by one ulp (JAX's power on 56). One ulp of a root moves
# the linear slot by 1.5e-5 at magnitudes near 240, above TOL, so the f32
# Ftrl comparisons add a relative term of a few ulps (ROADMAP Queue 3 C8)
FTRL_F32_RTOL = 2 ** -21
NAMES = ("enc.weight", "enc.bias", "head.weight", "unused.weight")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"enc.weight": (6, 5), "enc.bias": (5,),
              "head.weight": (4, 6), "unused.weight": (3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


def _rule(pkg, base, lr, wd, clip, decay_fun):
    """The optimizer ``base`` of ``pkg`` with the case's options."""
    kw = dict(learning_rate=lr, grad_clip=clip)
    if base == "adamw":
        return pkg.AdamW(weight_decay=wd, apply_decay_param_fun=decay_fun,
                         **kw)
    if base == "lamb":
        # the exclude function is stored and never applied (the reference
        # quirk the port keeps)
        return pkg.Lamb(lamb_weight_decay=0.01,
                        exclude_from_weight_decay_fn=lambda n: True, **kw)
    if base == "lars":
        return pkg.Lars(momentum=0.9, lars_coeff=0.01,
                        lars_weight_decay=0.0005, **kw)
    if base == "dpsgd":
        return pkg.Dpsgd(learning_rate=lr, clip=1.0, batch_size=4.0,
                         sigma=0.0, seed=3)
    kw["weight_decay"] = wd
    return {
        "adam": lambda: pkg.Adam(**kw),
        "sgd": lambda: pkg.SGD(**kw),
        "momentum": lambda: pkg.Momentum(momentum=0.9, **kw),
        "nesterov": lambda: pkg.Momentum(momentum=0.9, use_nesterov=True,
                                         **kw),
        "adamax": lambda: pkg.Adamax(**kw),
        "adagrad": lambda: pkg.Adagrad(initial_accumulator_value=0.1, **kw),
        "adadelta": lambda: pkg.Adadelta(rho=0.9, **kw),
        "rmsprop": lambda: pkg.RMSProp(momentum=0.5, **kw),
        "rmsprop_centered": lambda: pkg.RMSProp(momentum=0.5, centered=True,
                                                **kw),
        "ftrl": lambda: pkg.Ftrl(l1=0.01, l2=0.02, **kw),
    }[base]()


def _make(pkg, kind, wd, decay_fun, multi_precision):
    """``kind``: an optimizer name, then "+"-joined options: "clip"
    (ClipGradByGlobalNorm(1.0)), "sched" (a StepDecay learning rate),
    "l1" / "l2" (the decay as an L1Decay / L2Decay object; a bare float
    is L2). Returns (optimizer, scheduler or None)."""
    base, *opts = kind.split("+")
    regularizer = importlib.import_module(f"{pkg.__name__.split('.')[0]}"
                                          ".regularizer")
    if "l1" in opts:
        wd = regularizer.L1Decay(wd)
    elif "l2" in opts:
        wd = regularizer.L2Decay(wd)
    sched = pkg.lr.StepDecay(1e-2, step_size=1, gamma=0.5) \
        if "sched" in opts else None
    clip = pkg.ClipGradByGlobalNorm(1.0) if "clip" in opts else None
    opt = _rule(pkg, base, sched or 1e-2, wd or None if base != "adamw"
                else wd, clip, decay_fun)
    opt._multi_precision = multi_precision
    return opt, sched


CASES = [
    # kind, param dtype, weight decay, decay filter, drop a grad
    ("adam", "f32", 0.0, False, False),
    ("adam", "f32", 0.1, False, False),        # coupled L2 term
    ("adam", "bf16", 0.0, False, False),
    ("adamw", "f32", 0.0, False, False),
    ("adamw", "f32", 0.01, False, False),
    ("adamw", "f32", 0.05, True, False),
    ("adamw", "bf16", 0.01, False, False),
    ("adamw", "bf16", 0.05, True, True),
    ("adamw", "f32", 0.01, False, True),
    # the other ten rules; "bf16-raw": bf16 params without a master
    ("sgd", "f32", 0.0, False, False),
    ("sgd+clip", "bf16-raw", 0.01, False, False),
    ("sgd+sched+l1", "bf16", 0.01, False, True),
    ("momentum", "f32", 0.01, False, False),
    ("momentum+clip+l1", "bf16", 0.01, False, False),
    ("nesterov+sched", "bf16-raw", 0.0, False, False),
    ("adam+clip+sched+l2", "f32", 0.01, False, False),
    ("adamw+clip+sched", "bf16", 0.01, False, False),
    ("adamax", "f32", 0.0, False, False),
    ("adamax+clip+l1", "bf16", 0.01, False, True),
    ("adagrad", "f32", 0.01, False, False),
    ("adagrad+sched", "bf16-raw", 0.0, False, False),
    ("adadelta", "f32", 0.0, False, False),
    ("adadelta+clip+l2", "bf16", 0.01, False, False),
    ("rmsprop", "f32", 0.0, False, False),
    ("rmsprop_centered+clip", "bf16", 0.01, False, False),
    ("lamb", "f32", 0.0, False, False),
    ("lamb+clip+sched", "bf16", 0.0, False, True),
    ("lars", "f32", 0.0, False, False),
    ("lars+clip", "bf16-raw", 0.0, False, False),
    ("ftrl", "f32", 0.0, False, False),
    ("ftrl+clip+l1", "bf16", 0.01, False, False),
    ("dpsgd", "f32", 0.0, False, False),
    ("dpsgd", "bf16", 0.0, False, True),
]

# per-parameter options (JAX's _param_meta), for the "+meta" pass of
# every case: a half learning rate, a parameter outside the clip with its
# own L1 term, one with no regularizer at all
META = {"enc.weight": {"lr_ratio": 0.5},
        "enc.bias": {"need_clip": False, "regularizer": "l1"},
        "head.weight": {"regularizer": None}}


def _meta(pkg):
    regularizer = importlib.import_module(f"{pkg.__name__.split('.')[0]}"
                                          ".regularizer")
    out = {}
    for k, m in META.items():
        m = dict(m)
        if m.get("regularizer") == "l1":
            m["regularizer"] = regularizer.L1Decay(0.02)
        out[k] = m
    return out


@pytest.mark.parametrize("kind,dtype,wd,filtered,missing", CASES)
def test_three_pure_steps_match_jax(kind, dtype, wd, filtered, missing):
    for with_meta in (False, True):
        _three_pure_steps(kind, dtype, wd, filtered, missing, with_meta)


def _three_pure_steps(kind, dtype, wd, filtered, missing, with_meta):
    params, grads = _data()
    bf16 = dtype.startswith("bf16")
    master = dtype == "bf16"
    decay_fun = (lambda k: not k.endswith("bias")) if filtered else None
    jo, jsched = _make(jopt, kind, wd, decay_fun, master)
    to, tsched = _make(topt, kind, wd, decay_fun, master)
    jmeta = _meta(jopt) if with_meta else None
    tmeta = _meta(topt) if with_meta else None
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
    f32_rtol = FTRL_F32_RTOL if kind.startswith("ftrl") and not bf16 else 0
    jp = {k: jnp.asarray(v, jd) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(td) for k, v in params.items()}
    jo._ensure_slots(jp)
    to._ensure_slots(tp)
    js, ts = dict(jo._slots), dict(to._slots)
    assert set(js["enc.weight"]) == set(ts["enc.weight"])
    for t, g in enumerate(grads, start=1):
        jg = {k: jnp.asarray(v, jd) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(td) for k, v in g.items()}
        if missing:
            # JAX's pure update takes a gradient for every parameter (zeros
            # from jax.grad); the port counts an absent one as zero
            jg["unused.weight"] = jnp.zeros_like(jg["unused.weight"])
            del tg["unused.weight"]
        assert to.get_lr() == jo.get_lr()
        jp, js = jo.apply_gradients_pure(jp, jg, js,
                                         jnp.float32(jo.get_lr()),
                                         jnp.int32(t), jmeta)
        tp, ts = to.apply_gradients_pure(tp, tg, ts, to.get_lr(), t, tmeta)
        for sched in (jsched, tsched):
            if sched is not None:
                sched.step()
    for k in NAMES:
        want = np.asarray(jp[k].astype(jnp.float32))
        got = tp[k].float().numpy()
        assert tp[k].dtype == td
        if bf16:
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=f32_rtol, atol=TOL,
                                       err_msg=k)
        assert set(ts[k]) == set(js[k])
        # bf16 grads through a clip are rounded to bf16 after the scale,
        # and a scale that differs in its last f32 bit can flip that
        # rounding: their slots hold to two bf16 ulps of the grad
        rtol = 2 ** -7 if bf16 and "clip" in kind else f32_rtol
        for slot, v in js[k].items():
            np.testing.assert_allclose(ts[k][slot].float().numpy(),
                                       np.asarray(v).astype(np.float32),
                                       rtol=rtol, atol=TOL,
                                       err_msg=f"{k}/{slot}")
    if missing and kind.startswith("adamw"):
        # the gradient-less parameter still takes AdamW's decay (on the
        # master where there is one: the decay is below bf16's resolution)
        start = torch.from_numpy(params["unused.weight"]).to(td).float()
        now = ts["unused.weight"]["master"] if master \
            else tp["unused.weight"]
        assert not torch.equal(now, start)


def test_every_rule_is_covered():
    bases = {c[0].split("+")[0] for c in CASES}
    names = {"nesterov": "Momentum", "rmsprop_centered": "RMSProp",
             "sgd": "SGD"}
    covered = {names.get(b, {"adamw": "AdamW", "rmsprop": "RMSProp"}.get(
        b, b.capitalize())) for b in bases}
    assert covered == set(topt.optimizer.__all__) - {"Optimizer"}
    assert topt.optimizer.__all__ == jopt.optimizer.__all__


def test_dpsgd_noise_mean_and_spread():
    """Dpsgd at sigma 2: with zero grads and lr 1 a step moves each entry
    by minus its noise, N(0, (sigma * clip / batch)^2), in both packages
    (mean within 3 standard errors, spread within 2%). The port's draw is
    repeatable from (seed, step, parameter index); JAX keys on a hash that
    Python randomizes per process (ROADMAP Queue 3), so the two draws
    differ and only their distribution is compared."""
    shape = (200, 200)
    amp = 2.0 * 1.5 / 3.0
    zeros = np.zeros(shape, np.float32)
    moves = []
    for pkg, arr, t in ((jopt, jnp.asarray, jnp.int32(1)),
                        (topt, torch.from_numpy, 1)):
        opt = pkg.Dpsgd(learning_rate=1.0, clip=1.5, batch_size=3.0,
                        sigma=2.0, seed=5)
        lr = jnp.float32(1.0) if pkg is jopt else 1.0
        new, _ = opt.apply_gradients_pure({"w": arr(zeros)}, {"w": arr(zeros)},
                                          {"w": {}}, lr, t)
        moves.append(-np.asarray(new["w"], np.float64))
    for m in moves:
        assert abs(m.mean()) <= 3 * amp / np.sqrt(m.size)
        assert abs(m.std() / amp - 1) <= 0.02
    again, _ = topt.Dpsgd(learning_rate=1.0, clip=1.5, batch_size=3.0,
                          sigma=2.0, seed=5).apply_gradients_pure(
        {"w": torch.from_numpy(zeros)}, {"w": torch.from_numpy(zeros)},
        {"w": {}}, 1.0, 1)
    np.testing.assert_array_equal(-again["w"].numpy(), moves[1])


def test_eager_step_equals_pure_and_keeps_parameters():
    """step() over .grad equals the pure update over the parameters that
    have a grad; a parameter whose grad is None keeps its value and its
    slots; parameters are updated in place."""
    params, grads = _data(1)
    mods = {k: torch.nn.Parameter(torch.from_numpy(v).clone())
            for k, v in params.items()}
    opt = topt.AdamW(learning_rate=1e-2, parameters=list(mods.items()),
                     weight_decay=0.01)
    ref = topt.AdamW(learning_rate=1e-2, weight_decay=0.01)
    rp = {k: torch.from_numpy(v) for k, v in params.items()}
    ref._ensure_slots(rp)
    rs = dict(ref._slots)
    ids = {k: id(p) for k, p in mods.items()}
    for t, g in enumerate(grads, start=1):
        for k, p in mods.items():
            p.grad = None if k == "unused.weight" \
                else torch.from_numpy(g[k])
        opt.step()
        opt.clear_grad()
        rg = {k: torch.from_numpy(v) for k, v in g.items()
              if k != "unused.weight"}
        new_p, new_s = ref.apply_gradients_pure(
            {k: rp[k] for k in rg}, rg, {k: rs[k] for k in rg}, 1e-2, t)
        rp.update(new_p)
        rs.update(new_s)
    assert opt._step_count == 3
    assert "unused.weight" not in opt._slots
    for k, p in mods.items():
        assert id(p) == ids[k] and p.grad is None
        torch.testing.assert_close(p.detach(), rp[k], rtol=0, atol=0)
    assert torch.equal(mods["unused.weight"].detach(),
                       torch.from_numpy(params["unused.weight"]))


def test_eager_step_skips_a_missing_grad_as_jax():
    """Two AdamW steps through each package's eager step(), with a [4, 3]
    parameter that has a gradient and a [3] one whose grad is None. JAX's
    step() skips the second (``_collect``): its value stays exactly as it
    was and it gets no slots; so must the port's. The first parameter and
    its moments agree to TOL (the same f32 expressions)."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    rng = np.random.RandomState(5)
    w0 = rng.randn(4, 3).astype(np.float32)
    u0 = rng.randn(3).astype(np.float32)
    gs = [rng.randn(4, 3).astype(np.float32) for _ in range(2)]
    jw, ju = jnn.Parameter(w0.copy()), jnn.Parameter(u0.copy())
    jo = jopt.AdamW(learning_rate=0.1, weight_decay=0.01,
                    parameters=[jw, ju])
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tu = torch.nn.Parameter(torch.from_numpy(u0.copy()))
    to = topt.AdamW(learning_rate=0.1, weight_decay=0.01,
                    parameters=[("w", tw), ("u", tu)])
    for g in gs:
        (jw * paddle.to_tensor(g)).sum().backward()
        assert ju.grad is None
        jo.step()
        jo.clear_grad()
        tw.grad = torch.from_numpy(g)
        to.step()
        to.clear_grad()
    np.testing.assert_array_equal(np.asarray(ju.numpy()), u0)
    np.testing.assert_array_equal(tu.detach().numpy(), u0)
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw.numpy()),
                               atol=TOL)
    assert to._step_count == jo._step_count == 2
    assert list(to._slots) == ["w"] and len(jo._slots) == 1
    (js,) = jo._slots.values()
    assert set(js) == set(to._slots["w"])
    for slot, v in js.items():
        np.testing.assert_allclose(to._slots["w"][slot].numpy(),
                                   np.asarray(v), atol=TOL, err_msg=slot)


def test_master_weights_for_bf16_params():
    params, grads = _data(2)
    p = torch.nn.Parameter(torch.from_numpy(params["enc.weight"])
                           .to(torch.bfloat16))
    opt = topt.AdamW(learning_rate=1e-2, parameters=[p],
                     multi_precision=True)
    p.grad = torch.from_numpy(grads[0]["enc.weight"]).to(torch.bfloat16)
    opt.step()
    slots = opt._slots["param_0"]
    assert slots["master"].dtype == torch.float32
    assert slots["moment1"].dtype == torch.float32
    assert torch.equal(p.detach(), slots["master"].to(torch.bfloat16))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="lazy_mode"):
        topt.Adam(lazy_mode=True)


def test_eager_step_reads_parameter_attributes_as_jax():
    """Two eager Momentum steps with ClipGradByGlobalNorm, a float weight
    decay and per-parameter options set as attributes: a half learning
    rate (``optimize_attr``), no clip with an L1 term (``need_clip``,
    ``regularizer``). The port's ``step()`` reads them from the torch
    Parameters as JAX's ``_param_meta`` reads them from its Parameters;
    values and velocities agree to TOL."""
    from paddle_tpu import nn as jnn
    from paddle_tpu import regularizer as jreg
    from paddle_tpu_torch import regularizer as treg
    rng = np.random.RandomState(9)
    w0, b0 = rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(
        np.float32)
    gs = [(rng.randn(4, 3).astype(np.float32),
           rng.randn(3).astype(np.float32)) for _ in range(2)]
    jw = jnn.Parameter(w0.copy(), name="w", learning_rate=0.5)
    jb = jnn.Parameter(b0.copy(), name="b", regularizer=jreg.L1Decay(0.1),
                       need_clip=False)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    tb = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    tw.optimize_attr = {"learning_rate": 0.5}
    tb.regularizer, tb.need_clip = treg.L1Decay(0.1), False
    kw = dict(learning_rate=0.1, momentum=0.9, weight_decay=0.01)
    jo = jopt.Momentum(parameters=[jw, jb], **kw,
                       grad_clip=jopt.ClipGradByGlobalNorm(0.5))
    to = topt.Momentum(parameters=[("w", tw), ("b", tb)], **kw,
                       grad_clip=topt.ClipGradByGlobalNorm(0.5))
    import paddle_tpu as paddle
    for gw, gb in gs:
        ((jw * paddle.to_tensor(gw)).sum()
         + (jb * paddle.to_tensor(gb)).sum()).backward()
        jo.step()
        jo.clear_grad()
        tw.grad, tb.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        to.step()
        to.clear_grad()
    for jp, tp, k in ((jw, tw, "w"), (jb, tb, "b")):
        np.testing.assert_allclose(tp.detach().numpy(),
                                   np.asarray(jp.numpy()), atol=TOL)
        np.testing.assert_allclose(to._slots[k]["velocity"].numpy(),
                                   np.asarray(jo._slots[k]["velocity"]),
                                   atol=TOL)


def test_lr_scheduler_and_state_dict_keys_follow_jax():
    """An LRScheduler learning rate: ``get_lr`` reads it, ``set_lr``
    refuses; ``state_dict`` uses JAX's keys (``_step_count``,
    ``"{param}/{slot}"``, ``LR_Scheduler``) and a fresh optimizer restored
    from it takes the same next step."""
    params, grads = _data(4)
    mods = {k: torch.nn.Parameter(torch.from_numpy(v).clone())
            for k, v in params.items()}

    def make(ps):
        sched = topt.lr.StepDecay(0.05, step_size=2, gamma=0.5)
        return topt.Adam(learning_rate=sched, parameters=list(ps.items())), \
            sched

    opt, sched = make(mods)
    assert opt._lr_scheduler is sched
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    for g in grads[:2]:
        for k, p in mods.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        sched.step()
    state = opt.state_dict()
    assert state["_step_count"] == 2 and "LR_Scheduler" in state
    assert "enc.weight/moment1" in state
    jo = jopt.Adam(learning_rate=jopt.lr.StepDecay(0.05, step_size=2,
                                                  gamma=0.5))
    assert {"_step_count", "LR_Scheduler"} <= set(jo.state_dict())
    copies = {k: torch.nn.Parameter(p.detach().clone())
              for k, p in mods.items()}
    other, other_sched = make(copies)
    other.set_state_dict(state)
    assert other.get_lr() == opt.get_lr() and other._step_count == 2
    for o, ps in ((opt, mods), (other, copies)):
        for k, p in ps.items():
            p.grad = torch.from_numpy(grads[2][k])
        o.step()
    for k in mods:
        assert torch.equal(mods[k].detach(), copies[k].detach())


def test_minimize_is_backward_then_step():
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.SGD(learning_rate=0.5, parameters=[p])
    opt.minimize((p * torch.tensor([1.0, 2.0, 3.0])).sum())
    assert torch.equal(p.detach(), torch.tensor([0.5, 0.0, -0.5]))


def test_resume_a_jax_run_in_the_port():
    """Two GradScaler + AdamW steps of a tiny GPT (f32, dropout 0, a
    LinearWarmup rate, ClipGradByGlobalNorm) in the JAX package; then its
    parameters (``load_jax_params``), optimizer state and scaler state
    (``load_jax_optimizer_state``) carried into the port, and the next two
    steps taken by both: the losses agree to 1e-5, the parameters and
    slots to 1e-5 (readings about 1e-6: XLA's and torch's CPU matmuls sum
    in different orders), the scale and step count exactly."""
    import paddle_tpu as paddle
    import paddle_tpu.amp as jamp
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.text.models.gpt import GPT as JGPT
    from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
    from paddle_tpu_torch import amp as tamp
    from paddle_tpu_torch.bridge import (load_jax_optimizer_state,
                                         load_jax_params)
    from paddle_tpu_torch.text.models import GPT, GPTConfig

    cfg = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2,
               intermediate_size=64, max_seq_len=32, dropout=0.0)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 256, (4, 2, 16))
    paddle.seed(1)
    jnet = JGPT(JGPTConfig(**cfg))
    jnet.train()
    state = jnet.functional_state()[0]
    for param, name in zip(jnet.parameters(), state):
        param.name = name          # the port's names, as slot keys

    def make(pkg, params):
        sched = pkg.lr.LinearWarmup(
            pkg.lr.PolynomialDecay(3e-3, decay_steps=8, end_lr=0.0),
            warmup_steps=2, start_lr=1e-3, end_lr=3e-3)
        opt = pkg.AdamW(learning_rate=sched, parameters=params,
                        weight_decay=0.01,
                        grad_clip=pkg.ClipGradByGlobalNorm(0.5))
        return opt, sched

    jo, jsched = make(jopt, list(jnet.parameters()))
    jsc = jamp.GradScaler(init_loss_scaling=256.0, incr_every_n_steps=3)

    def jstep(batch):
        x = Tensor(jnp.asarray(batch), _internal=True)
        y = Tensor(jnp.asarray(np.roll(batch, -1, axis=1)), _internal=True)
        loss = jnet(x, labels=y)
        jsc.scale(loss).backward()
        jsc.step(jo)
        jsc.update()
        jo.clear_grad()
        jsched.step()
        return float(np.asarray(loss._value))

    for batch in ids[:2]:
        jstep(batch)
    tnet = GPT(GPTConfig(**cfg), device="cpu")
    tnet.train()
    load_jax_params(tnet, {k: np.asarray(v) for k, v in
                           jnet.functional_state()[0].items()})
    to, tsched = make(topt, list(tnet.named_parameters()))
    tsc = tamp.GradScaler(init_loss_scaling=1.0, incr_every_n_steps=3)
    load_jax_optimizer_state(to, jo.state_dict(), scaler=tsc,
                             scaler_state=jsc.state_dict())
    assert to._step_count == jo._step_count == 2
    assert tsched.last_epoch == jsched.last_epoch == 2
    assert tsc.get_loss_scaling() == jsc.get_loss_scaling()
    for batch in ids[2:]:
        jl = jstep(batch)
        x = torch.from_numpy(batch)
        loss = tnet(x, labels=torch.from_numpy(np.roll(batch, -1, axis=1)))
        tsc.scale(loss).backward()
        tsc.step(to)
        tsc.update()
        to.clear_grad()
        tsched.step()
        assert abs(float(loss.detach()) - jl) <= 1e-5
    assert tsc.get_loss_scaling() == jsc.get_loss_scaling() == 512.0
    assert to._step_count == jo._step_count == 4
    tparams = dict(tnet.named_parameters())
    for name, value in jnet.functional_state()[0].items():
        got = tparams[name].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(value), atol=1e-5,
                                   err_msg=name)
        for slot, v in jo._slots[name].items():
            got = to._slots[name][slot].numpy()
            np.testing.assert_allclose(got, np.asarray(v), atol=1e-5,
                                       err_msg=f"{name}/{slot}")
