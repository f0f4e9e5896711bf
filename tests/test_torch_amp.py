"""Port parity: AMP (paddle_tpu_torch/amp) against paddle_tpu.amp.

- The dtype trace: ``monkeypatch`` wraps each package's ``cast_inputs``
  to record (op name, the dtypes of its tensor inputs before and after
  the cast) through a 2-layer BERT and GPT training forward under O1/O2 x
  bf16/f16, on the kernels' route (flash attention at every s, the fused
  CE head; JAX's kernels in interpret mode). The port's sequence must
  equal JAX's: the same cast points, in the same order, under the same
  names, on the same dtypes. Nothing in the JAX package changes.
- ``check_finite_and_unscale``, ``update_loss_scaling`` and GradScaler's
  scale / good / bad counts over a scripted found-inf sequence, equal to
  JAX's; parameters and slots untouched on the skipped steps.
- Two whole O2 f16 training steps of a 2-layer BERT (GradScaler, AdamW
  with master weights, LinearWarmup over PolynomialDecay,
  ClipGradByGlobalNorm) against JAX's, with the kernels' plain versions
  on the port side and JAX's kernels in interpret mode; no attention
  mask, as the flagship step (``bench.py``) passes none.
- BERT's f16 O2 mask: -inf on right-padded keys through both packages'
  flash attention; and the reference quirk that JAX forms it as
  ``0 * -inf`` = nan on the kept keys (ROADMAP Queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.text.models.bert import Bert as JBert
from paddle_tpu.text.models.bert import BertConfig as JBertConfig
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.text.models import GPT, Bert, BertConfig, GPTConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are tiny: one intra-op thread is enough, and it leaves
    the other cores to the timing-sensitive tests that run beside this
    file in a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def kernels_everywhere():
    """Both packages send attention to the flash kernels at any s and the
    loss head to the fused CE kernels (JAX's in interpret mode)."""
    min_seq = tflags.flag("FLAGS_flash_min_seq")
    paddle.set_flags({"FLAGS_pallas_interpret": True,
                      "FLAGS_flash_attention_interpret": True,
                      "FLAGS_flash_min_seq": 0})
    tflags.set_flags({"FLAGS_flash_min_seq": 0})
    yield
    paddle.set_flags({"FLAGS_pallas_interpret": False,
                      "FLAGS_flash_attention_interpret": False,
                      "FLAGS_flash_min_seq": 1024})
    tflags.set_flags({"FLAGS_flash_min_seq": min_seq})


def _j(x):
    return Tensor(jnp.asarray(x), _internal=True)


def _dtype_name(v):
    return str(v.dtype).replace("torch.", "")


def _recorder(module, monkeypatch, log):
    """Wrap ``module.cast_inputs`` to append (name, input dtypes, output
    dtypes) of its tensor arguments to ``log``."""
    inner = module.cast_inputs

    def wrapped(name, vals):
        out = inner(name, vals)
        log.append((name,
                    tuple(_dtype_name(v) for v in vals if hasattr(v, "dtype")),
                    tuple(_dtype_name(v) for v in out if hasattr(v, "dtype"))))
        return out

    monkeypatch.setattr(module, "cast_inputs", wrapped)


def _tiny_batch(b=2, s=16, vocab=1024, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s))
    labels = np.where(rng.rand(b, s) < 0.3, ids, -100)
    labels[0, 0] = ids[0, 0]
    mask = np.ones((b, s), np.int64)
    mask[1, s - 5:] = 0                         # right padding
    return ids, labels, mask


@pytest.mark.parametrize("model", ["bert", "gpt"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_dtype_trace_matches_jax(model, level, dtype, monkeypatch,
                                 kernels_everywhere):
    ids, labels, mask = _tiny_batch()
    paddle.seed(0)
    if model == "bert":
        jnet = JBert(JBertConfig.tiny())
        tnet = Bert(BertConfig.tiny(), device="cpu")
    else:
        jnet = JGPT(JGPTConfig.tiny())
        tnet = GPT(GPTConfig.tiny(), device="cpu")
    jnet.train()
    tnet.train()
    if level == "O2":
        jamp.decorate(jnet, level="O2", dtype=dtype)
        tamp.decorate(tnet, level="O2", dtype=dtype)
    jlog, tlog = [], []
    _recorder(jamp, monkeypatch, jlog)
    _recorder(tamp, monkeypatch, tlog)
    with jamp.auto_cast(level=level, dtype=dtype):
        if model == "bert":
            jloss = jnet(_j(ids), attention_mask=_j(mask),
                         masked_lm_labels=_j(labels))
        else:
            jloss = jnet(_j(ids), labels=_j(labels))
    with tamp.auto_cast(level=level, dtype=dtype):
        if model == "bert":
            tloss = tnet(torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(mask),
                         masked_lm_labels=torch.from_numpy(labels))
        else:
            tloss = tnet(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels))
    names = [r[0] for r in jlog]
    assert "flash_sdpa" in names and "fused_ce_op" in names
    assert len(tlog) == len(jlog)
    for i, (want, got) in enumerate(zip(jlog, tlog)):
        assert got == want, f"cast point {i}: port {got}, JAX {want}"
    assert _dtype_name(tloss) == _dtype_name(jloss._value)


def test_check_finite_and_unscale_matches_jax():
    rng = np.random.RandomState(3)
    arrays = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float16)}
    for poison in (None, ("a", np.inf), ("b", np.nan)):
        vals = {k: v.copy() for k, v in arrays.items()}
        if poison:
            vals[poison[0]][1] = poison[1]
        jg, jfound = jamp.check_finite_and_unscale(
            {k: jnp.asarray(v) for k, v in vals.items()}, jnp.float32(512.0))
        tg, tfound = tamp.check_finite_and_unscale(
            {k: torch.from_numpy(v) for k, v in vals.items()}, 512.0)
        assert bool(tfound) == bool(jfound) == (poison is not None)
        for k in vals:
            assert _dtype_name(tg[k]) == _dtype_name(jg[k])
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))


def _scaler_pair(**kw):
    return jamp.GradScaler(**kw), tamp.GradScaler(**kw)


def test_update_loss_scaling_matches_jax():
    kw = dict(incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    js, jg, jb = jnp.float32(4.0), jnp.int32(0), jnp.int32(0)
    ts, tg, tb = (torch.tensor(4.0), torch.tensor(0, dtype=torch.int32),
                  torch.tensor(0, dtype=torch.int32))
    for found in (0, 0, 1, 0, 1, 1, 1, 1, 1, 0, 0, 0):
        js, jg, jb = jamp.update_loss_scaling(js, jg, jb, jnp.bool_(found),
                                              **kw)
        ts, tg, tb = tamp.update_loss_scaling(ts, tg, tb,
                                              torch.tensor(bool(found)), **kw)
        assert (float(ts), int(tg), int(tb)) == (float(js), int(jg), int(jb))
        assert ts.dtype == torch.float32 and tg.dtype == tb.dtype \
            == torch.int32


# found-inf pattern of the scripted scaler run: grows after 2 clean steps,
# halves after 2 bad ones, and steps are skipped exactly on the bad ones
FOUND = (0, 0, 1, 0, 1, 1, 0, 0, 0, 1)


def test_grad_scaler_follows_jax_and_skips_bad_steps():
    """Eager GradScaler steps of SGD and Adam on a [4, 3] parameter whose
    upstream gradient holds an inf on the scripted steps: the scale and
    its good / bad counts equal JAX's after every update, the parameter
    equals JAX's after every step, and on a skipped step the parameter and
    every optimizer slot stay bitwise as they were."""
    from paddle_tpu import nn as jnn
    rng = np.random.RandomState(7)
    w0 = rng.randn(4, 3).astype(np.float32)
    for kind in ("SGD", "Adam"):
        jw = jnn.Parameter(w0.copy())
        tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        jo = getattr(jopt, kind)(learning_rate=0.1, parameters=[jw])
        to = getattr(topt, kind)(learning_rate=0.1, parameters=[tw])
        jsc, tsc = _scaler_pair(init_loss_scaling=1024.0,
                                incr_every_n_steps=2,
                                decr_every_n_nan_or_inf=2)
        for found in FOUND:
            g = rng.randn(4, 3).astype(np.float32)
            if found:
                g[2, 1] = np.inf
            before = (tw.detach().clone(),
                      {k: v.clone() for k, v in to._slots.get("param_0",
                                                                {}).items()})
            jsc.scale((jw * paddle.to_tensor(g)).sum()).backward()
            jsc.step(jo)
            jsc.update()
            jo.clear_grad()
            tsc.scale((tw * torch.from_numpy(g)).sum()).backward()
            tsc.step(to)
            tsc.update()
            to.clear_grad()
            assert tsc.get_loss_scaling() == jsc.get_loss_scaling()
            assert tsc.state_dict()["incr_count"] == \
                jsc.state_dict()["incr_count"]
            assert tsc.state_dict()["decr_count"] == \
                jsc.state_dict()["decr_count"]
            np.testing.assert_allclose(tw.detach().numpy(),
                                       np.asarray(jw.numpy()), atol=1e-6)
            if found:
                assert torch.equal(tw.detach(), before[0])
                for k, v in before[1].items():
                    assert torch.equal(to._slots["param_0"][k], v)
        assert to._step_count == jo._step_count == FOUND.count(0)


def test_grad_scaler_state_dict_round_trip():
    _, tsc = _scaler_pair(init_loss_scaling=64.0)
    tsc._found_inf = torch.tensor(False)
    tsc.update()
    state = tsc.state_dict()
    other = tamp.GradScaler()
    other.set_state_dict(state)
    assert other.state_dict()["incr_count"] == 1
    assert other.get_loss_scaling() == 64.0


def test_decorate_o2_casts_parameters_and_turns_on_masters():
    net = Bert(BertConfig.tiny(), device="cpu")
    ids = {id(p) for p in net.parameters()}
    opt = topt.AdamW(parameters=list(net.named_parameters()))
    out = tamp.decorate(net, opt, level="O2", dtype="float16")
    assert out == (net, opt)
    assert all(p.dtype == torch.float16 for p in net.parameters())
    assert {id(p) for p in net.parameters()} == ids
    assert opt._multi_precision
    with pytest.raises(ValueError):
        tamp.decorate(net, level="O3")


def test_autocast_gives_f32_leaves_f32_grads():
    """The casts sit inside autograd: an f32 weight used by a white-list
    op in f16 gets an f32 gradient (as tests/test_amp.py:59 holds for the
    JAX package)."""
    from paddle_tpu_torch.nn import functional as F
    w = torch.randn(3, 4, requires_grad=True)       # [in, out]
    x = torch.randn(2, 3)
    with tamp.auto_cast(level="O1", dtype="float16"):
        y = F.linear(x, w)
    assert y.dtype == torch.float16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32


def _f16_bert_pair():
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jc = JBertConfig.tiny()
    tc = BertConfig.tiny()
    for k, v in cfg.items():
        setattr(jc, k, v)
        setattr(tc, k, v)
    paddle.seed(0)
    jnet = JBert(jc)
    tnet = Bert(tc, device="cpu")
    state = jnet.functional_state()[0]
    load_jax_params(tnet, {k: np.asarray(v) for k, v in state.items()})
    # the JAX optimizer keys parameters by name, and BERT's deep-copied
    # encoder layers share theirs (ROADMAP Queue 3): give each its dotted
    # name, the port's
    for param, name in zip(jnet.parameters(), state):
        param.name = name
    jnet.train()
    tnet.train()
    return jnet, tnet


def _f16_o2_setup(pkg_opt, pkg_amp, net, params):
    sched = pkg_opt.lr.LinearWarmup(
        pkg_opt.lr.PolynomialDecay(1e-3, decay_steps=10, end_lr=0.0),
        warmup_steps=2, start_lr=1e-4, end_lr=1e-3)
    opt = pkg_opt.AdamW(learning_rate=sched, parameters=params,
                        weight_decay=0.01,
                        grad_clip=pkg_opt.ClipGradByGlobalNorm(1.0),
                        multi_precision=True)
    pkg_amp.decorate(net, opt, level="O2", dtype="float16")
    scaler = pkg_amp.GradScaler(init_loss_scaling=2.0 ** 15)
    return sched, opt, scaler


# f16 O2 step limits, set from this test's readings: the loss to one f16
# ulp at its size (equal in the readings); each unscaled gradient, and
# each first moment after two steps, to 1% of its largest entry
# (readings: 3.2e-3 and 3.1e-3 of it at worst; f16
# products summed in another order, the kernels' plain versions against
# the Pallas kernels); the f32 masters to 1e-5 on all but 1% of all their
# elements (readings: 0.57%, most in the tied word embedding, whose
# entries get gradients near f16's underflow), and every element to twice
# the summed learning rates: where a gradient entry is near zero an f16
# rounding can flip its sign, and Adam's first steps move by about
# lr * sign(g).
F16_STEP_TOL = {"loss_ulps": 1, "grad": 1e-2, "master": 1e-5,
                "master_outliers": 1e-2}


def test_o2_f16_training_step_matches_jax(kernels_everywhere):
    """Two O2 f16 steps of a 2-layer BERT (dropout 0, no attention mask)
    with GradScaler, AdamW (master weights, decoupled decay 0.01),
    LinearWarmup over PolynomialDecay and ClipGradByGlobalNorm(1.0): the
    loss, the unscaled gradients, the scaler state and the f32 masters
    match JAX's."""
    ids, labels, _ = _tiny_batch(s=16)
    jnet, tnet = _f16_bert_pair()
    jparams = list(jnet.parameters())
    names = list(jnet.functional_state()[0])
    tparams = dict(tnet.named_parameters())
    jsched, jo, jsc = _f16_o2_setup(jopt, jamp, jnet, jparams)
    tsched, to, tsc = _f16_o2_setup(topt, tamp, tnet,
                                    list(tnet.named_parameters()))
    for step in range(2):
        with jamp.auto_cast(level="O2", dtype="float16"):
            jloss = jnet(_j(ids), masked_lm_labels=_j(labels))
        jsc.scale(jloss).backward()
        jsc.unscale_(jo)
        with tamp.auto_cast(level="O2", dtype="float16"):
            tloss = tnet(torch.from_numpy(ids),
                         masked_lm_labels=torch.from_numpy(labels))
        tsc.scale(tloss).backward()
        tsc.unscale_(to)
        assert tloss.dtype == torch.float16
        jl = np.float16(np.asarray(jloss._value))
        ulp = np.spacing(np.abs(jl))
        assert abs(float(tloss.detach()) - float(jl)) <= \
            F16_STEP_TOL["loss_ulps"] * ulp
        for jp, name in zip(jparams, names):
            tp = tparams[name]
            if jp.grad is None:
                assert tp.grad is None, name
                continue
            jgr = np.asarray(jp.grad._value).astype(np.float32)
            tgr = tp.grad.float().numpy()
            scale = max(float(np.abs(jgr).max()), 1e-30)
            assert np.abs(tgr - jgr).max() <= F16_STEP_TOL["grad"] * scale, \
                name
        for sc, opt in ((jsc, jo), (tsc, to)):
            sc.step(opt)
            sc.update()
            opt.clear_grad()
        jsched.step()
        tsched.step()
        assert tsc.state_dict()["incr_count"] == \
            jsc.state_dict()["incr_count"]
        assert tsc.get_loss_scaling() == jsc.get_loss_scaling()
    jslots = {name: jo._slots[name] for name in names if name in jo._slots}
    assert set(jslots) == set(to._slots)
    lr_sum = 1e-4 + 5.5e-4      # the two steps' learning rates
    outliers = total = 0
    for name, js in jslots.items():
        want = np.asarray(js["master"])
        got = to._slots[name]["master"].numpy()
        diff = np.abs(got - want)
        outliers += int((diff > F16_STEP_TOL["master"]).sum())
        total += diff.size
        assert diff.max() <= 2 * lr_sum, name
        m_want = np.asarray(js["moment1"])
        m_got = to._slots[name]["moment1"].numpy()
        assert np.abs(m_got - m_want).max() <= \
            F16_STEP_TOL["grad"] * np.abs(m_want).max(), name
        assert tparams[name].dtype == torch.float16
    assert outliers <= F16_STEP_TOL["master_outliers"] * total


def test_right_padded_neg_inf_key_bias_matches_jax():
    """BERT's f16 O2 mask is (1 - m) * -1e9 formed in f16: -inf on the
    padded keys, and the flash route's f32 key bias holds -inf. With right
    padding every row's first key tile has a finite key, and the port's
    flash attention (the kernels' plain version here) gives JAX's kernel
    output; a row whose first tile were all -inf would give nan in an
    online softmax, which right padding never asks for."""
    from paddle_tpu.ops.pallas import flash_attention as jflash
    from paddle_tpu_torch.ops.cuda import flash_attention as tflash
    rng = np.random.RandomState(11)
    b, h, s, d = 2, 2, 24, 16
    q, k, v = (rng.randn(b, h, s, d).astype(np.float16) for _ in range(3))
    keep = np.array([s, s - 7])
    bias = np.where(np.arange(s)[None] < keep[:, None], 0.0,
                    -np.inf).astype(np.float32)
    paddle.set_flags({"FLAGS_pallas_interpret": True})
    try:
        jo = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               bias=jnp.asarray(bias)))
    finally:
        paddle.set_flags({"FLAGS_pallas_interpret": False})
    to = tflash(*(torch.from_numpy(x) for x in (q, k, v)),
                bias=torch.from_numpy(bias)).numpy()
    assert to.dtype == np.float16 and np.isfinite(to).all()
    np.testing.assert_allclose(to.astype(np.float32), jo.astype(np.float32),
                               atol=2e-3)


def test_quirk_f16_o2_bert_mask_is_nan_in_jax():
    """Reference quirk (ROADMAP Queue 3): under O2 f16, JAX's BERT forms
    its mask ``(1.0 - m) * -1e9`` in f16 with -1e9 rounded to f16 first,
    so a kept key's ``0 * -inf`` is nan and the loss is nan. The port has
    the same cast points (the mask is f16), but torch multiplies in f32
    before rounding: 0 on kept keys, -inf on padded ones, and a finite
    loss within f16 rounding of the f32 model's."""
    ids, labels, mask = _tiny_batch(s=16)
    jnet, tnet = _f16_bert_pair()
    jamp.decorate(jnet, level="O2", dtype="float16")
    with jamp.auto_cast(level="O2", dtype="float16"):
        jloss = jnet(_j(ids), attention_mask=_j(mask),
                     masked_lm_labels=_j(labels))
    assert np.isnan(np.asarray(jloss._value))
    args = (torch.from_numpy(ids),)
    kw = dict(attention_mask=torch.from_numpy(mask),
              masked_lm_labels=torch.from_numpy(labels))
    with torch.no_grad():
        f32 = float(tnet(*args, **kw))
        tamp.decorate(tnet, level="O2", dtype="float16")
        with tamp.auto_cast(level="O2", dtype="float16"):
            f16 = tnet(*args, **kw)
    assert f16.dtype == torch.float16 and torch.isfinite(f16)
    assert abs(float(f16) - f32) <= 1e-2 * abs(f32)


def test_quirk_jax_bert_layers_share_parameter_names():
    """Reference quirk (ROADMAP Queue 3): JAX's TransformerEncoder deep-
    copies its first layer, so BERT's encoder layers share parameter
    names, and the JAX eager step (``_collect``, keyed by name) updates
    one parameter of each such pair. The port names parameters by module
    path: every one is distinct, and every one with a grad is updated."""
    paddle.seed(0)
    jnames = [p.name for p in JBert(JBertConfig.tiny()).parameters()]
    assert len(set(jnames)) < len(jnames)
    tnames = [k for k, _ in Bert(BertConfig.tiny(),
                                 device="cpu").named_parameters()]
    assert len(set(tnames)) == len(tnames) == len(jnames)
