"""Port parity: Adam / AdamW (paddle_tpu_torch/optimizer) against the JAX
package's ``apply_gradients_pure``.

Three steps (t = 1, 2, 3) from equal params, grads and zero slots. f32
values (params without a master, f32 masters, moments) agree to 1e-6
absolute: both run the same f32 expressions in the same order; the bias
corrections' powers may differ in the last bit. A bf16 parameter is
compared at one bf16 ulp (rtol 2**-8): it is its master rounded to bf16,
and a master difference in the last f32 bit can flip that rounding.
"""
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
NAMES = ("enc.weight", "enc.bias", "head.weight", "unused.weight")


def _data(seed=0):
    rng = np.random.RandomState(seed)
    shapes = {"enc.weight": (6, 5), "enc.bias": (5,),
              "head.weight": (4, 6), "unused.weight": (3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


def _make(pkg, kind, wd, decay_fun, multi_precision):
    if kind == "adam":
        return pkg.Adam(learning_rate=1e-2, weight_decay=wd or None,
                        multi_precision=multi_precision)
    return pkg.AdamW(learning_rate=1e-2, weight_decay=wd,
                     apply_decay_param_fun=decay_fun,
                     multi_precision=multi_precision)


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
]


@pytest.mark.parametrize("kind,dtype,wd,filtered,missing", CASES)
def test_three_pure_steps_match_jax(kind, dtype, wd, filtered, missing):
    params, grads = _data()
    bf16 = dtype == "bf16"
    decay_fun = (lambda k: not k.endswith("bias")) if filtered else None
    jo = _make(jopt, kind, wd, decay_fun, bf16)
    to = _make(topt, kind, wd, decay_fun, bf16)
    jd = jnp.bfloat16 if bf16 else jnp.float32
    td = torch.bfloat16 if bf16 else torch.float32
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
        jp, js = jo.apply_gradients_pure(jp, jg, js, jnp.float32(1e-2),
                                         jnp.int32(t))
        tp, ts = to.apply_gradients_pure(tp, tg, ts, 1e-2, t)
    for k in NAMES:
        want = np.asarray(jp[k].astype(jnp.float32))
        got = tp[k].float().numpy()
        assert tp[k].dtype == td
        if bf16:
            np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
        else:
            np.testing.assert_allclose(got, want, atol=TOL)
        for slot, v in js[k].items():
            np.testing.assert_allclose(ts[k][slot].numpy(), np.asarray(v),
                                       atol=TOL, err_msg=f"{k}/{slot}")
    if missing:
        # the gradient-less parameter still takes AdamW's decay (on the
        # master where there is one: the decay is below bf16's resolution)
        start = torch.from_numpy(params["unused.weight"]).to(td).float()
        now = ts["unused.weight"]["master"] if bf16 else tp["unused.weight"]
        assert not torch.equal(now, start)


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
    with pytest.raises(NotImplementedError, match="clip"):
        topt.Adam(grad_clip=object())
    with pytest.raises(NotImplementedError, match="lazy_mode"):
        topt.Adam(lazy_mode=True)
