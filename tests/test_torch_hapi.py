"""Port parity: the high-level API (paddle_tpu_torch/hapi) against
paddle_tpu.hapi, on the CPU.

Three networks, each built once in each package from the same weights
(``bridge.load_jax_params``) and fed the same data through each
package's own DataLoader (numpy shuffles under the same seed):

- a 2-layer BERT through a ``forward(ids, labels)`` MLM wrapper with an
  identity loss (the fused CE head: its plain version in the port, JAX's
  composite on the CPU), ``LMDataset`` batches;
- a 2-layer GPT through its own ``forward(ids, labels)`` (causal
  attention; the LM head as BERT's);
- an MLP classifier with ``CrossEntropyLoss`` and ``Accuracy``.

Dropout is 0 everywhere. ``Model.fit`` runs AdamW with LinearWarmup over
PolynomialDecay and a global-norm clip, in f32, bf16 O2 and f16 O2 (with
its GradScaler); the per-batch losses, the learning rates, the step
count, the final parameters and the f32 masters must match JAX's within
``TOL``. Then ``evaluate``, ``predict``, ``summary()``, a
``Model.save`` -> ``load`` resume and ``bridge.load_jax_checkpoint`` of a
JAX ``Model.save``. The engine's semantics (unused and frozen
parameters, the forced-overflow step, accumulation, the schedulers'
cadence, EarlyStopping, the async loss window, the branches that raise)
are in ``test_torch_hapi_engine.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.text.datasets import LMDataset as JLMDataset
from paddle_tpu.text.models.bert import Bert as JBert
from paddle_tpu.text.models.bert import BertConfig as JBertConfig
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
import paddle_tpu_torch as pt
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.bridge import load_jax_checkpoint, load_jax_params
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.io import TensorDataset as TTensorDataset
from paddle_tpu_torch.nn.layer import CrossEntropyLoss, Linear
from paddle_tpu_torch.text.datasets import LMDataset as TLMDataset
from paddle_tpu_torch.text.models import GPT, Bert, BertConfig, GPTConfig

# Limits, set from this file's readings (2-layer models, 12 AdamW steps,
# learning rates summing to 8.8e-3):
# - per-batch loss: f32 1e-5 absolute (readings up to 1e-6: the two
#   packages sum in other orders); bf16 / f16 one ulp of the loss's dtype
#   at its size (readings: equal).
# - final parameters and f32 masters: f32 1e-5 absolute (readings
#   2.4e-7). bf16 / f16: every master within twice the summed learning
#   rates (an entry whose gradient is near zero can take Adam's +-lr step
#   either way after a 16-bit rounding); all but "outliers" of all the
#   entries within "master" (readings above 1e-4: bf16 0.51% BERT, 1.04%
#   GPT, 0 MLP; f16 0.14%, 0.02%, 0; the 16-bit backward rounds in other
#   places in each package); each parameter its master rounded to its
#   dtype.
TOL = {
    "float32": {"loss_abs": 1e-5, "param": 1e-5},
    "bfloat16": {"loss_ulps": 1, "master": 1e-4, "outliers": 0.03},
    "float16": {"loss_ulps": 1, "master": 1e-4, "outliers": 0.005},
}
AMP = {"float32": None,
       "bfloat16": {"level": "O2", "dtype": "bfloat16"},
       "float16": {"level": "O2", "dtype": "float16"}}
VOCAB, SEQ, N, BATCH = 1024, 16, 24, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: one intra-op thread leaves the other cores to the
    tests that run beside this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device():
    """Layers land on the current device, the card by default: the
    networks of these tests are built on the CPU."""
    from paddle_tpu_torch import device as tdevice
    with tdevice.device_scope("cpu"):
        yield


@pytest.fixture(autouse=True)
def _no_mesh():
    """A device mesh left by another test would turn JAX's step into a
    partitioned one."""
    jmesh.reset_mesh()
    yield


class JMLM(jnn.Layer):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, ids, labels):
        return self.bert(ids, masked_lm_labels=labels)


class TMLM(torch.nn.Module):
    def __init__(self, bert):
        super().__init__()
        self.bert = bert

    def forward(self, ids, labels):
        return self.bert(ids, masked_lm_labels=labels)


def identity(loss):
    return loss


def _mlp_data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 4, (n,)).astype(np.int64))


def pair(kind, seed=0):
    """(jax net, port net, jax dataset, port dataset, number of inputs,
    jax loss, port loss, metric classes) for ``kind``; the port net holds
    the JAX net's weights."""
    paddle.seed(seed)
    if kind == "bert":
        jc, tc = JBertConfig.tiny(), BertConfig.tiny()
        for c in (jc, tc):
            c.hidden_dropout_prob = c.attention_probs_dropout_prob = 0.0
        jnet, tnet = JMLM(JBert(jc)), TMLM(Bert(tc, device="cpu"))
        kw = dict(vocab_size=VOCAB, seq_len=SEQ, n=N, seed=seed)
        data = (JLMDataset(**kw), TLMDataset(**kw))
        spec = (2, identity, identity, None)
    elif kind == "gpt":
        jc, tc = JGPTConfig.tiny(), GPTConfig.tiny()
        jc.dropout = tc.dropout = 0.0
        jnet, tnet = JGPT(jc), GPT(tc, device="cpu")
        kw = dict(vocab_size=VOCAB, seq_len=SEQ + 1, n=N, mode="causal",
                  seed=seed)
        data = (JLMDataset(**kw), TLMDataset(**kw))
        spec = (2, identity, identity, None)
    else:
        jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                              jnn.Linear(16, 4))
        tnet = torch.nn.Sequential(Linear(8, 16), torch.nn.ReLU(),
                                   Linear(16, 4))
        x, y = _mlp_data(seed)
        data = (JTensorDataset([x, y]), TTensorDataset([x, y]))
        spec = (1, jnn.CrossEntropyLoss(), CrossEntropyLoss(), "Accuracy")
    load_jax_params(tnet, {k: np.asarray(v)
                           for k, v in jnet.functional_state()[0].items()})
    return (jnet, tnet) + data + spec


def warmup_adamw(pkg, params, lr=1e-3, clip=True, wd=0.01):
    sched = pkg.lr.LinearWarmup(
        pkg.lr.PolynomialDecay(lr, decay_steps=20, end_lr=0.0),
        warmup_steps=2, start_lr=lr / 10, end_lr=lr)
    return pkg.AdamW(learning_rate=sched, weight_decay=wd, parameters=params,
                     grad_clip=pkg.ClipGradByGlobalNorm(1.0) if clip
                     else None)


def models(kind, amp=None, opt=warmup_adamw, seed=0):
    """Prepared (jax Model, port Model, jax data, port data)."""
    jnet, tnet, jdata, tdata, n_in, jloss, tloss, metric = pair(kind, seed)
    jm = paddle.Model(jnet, inputs=[None] * n_in)
    tm = pt.Model(tnet, inputs=[None] * n_in)
    jm.prepare(opt(jopt, jnet.parameters()), loss=jloss,
               metrics=getattr(jmetric, metric)() if metric else None,
               amp_configs=amp)
    tm.prepare(opt(topt, tm.parameters()), loss=tloss,
               metrics=getattr(tmetric, metric)() if metric else None,
               amp_configs=amp)
    return jm, tm, jdata, tdata


def recorder(base):
    """A callback keeping every batch's loss (read on the host) and the
    learning rate after the batch."""
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses, self.lrs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"]))
            self.lrs.append(self.model._optimizer.get_lr())
    return Recorder()


def fit_both(jm, tm, jdata, tdata, seed=5, **kw):
    """``fit`` in each package from the same numpy seed: (jax recorder,
    port recorder)."""
    kw = dict(dict(batch_size=BATCH, epochs=2, verbose=0), **kw)
    jextra, textra = kw.pop("jcallbacks", []), kw.pop("tcallbacks", [])
    jr, tr = recorder(jcb.Callback), recorder(tcb.Callback)
    np.random.seed(seed)
    jm.fit(jdata, callbacks=[jr] + jextra, **kw)
    np.random.seed(seed)
    tm.fit(tdata, callbacks=[tr] + textra, **kw)
    return jr, tr


def jax_layout(tnet):
    """{name: f32 numpy} of the port's parameters (JAX's layout: both
    keep Linear's weight [in, out])."""
    return {k: p.detach().float().numpy()
            for k, p in tnet.named_parameters()}


def check_losses(jr, tr, dtype):
    jl, tl = np.asarray(jr.losses), np.asarray(tr.losses)
    assert jl.shape == tl.shape and np.isfinite(tl).all()
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=TOL[dtype]["loss_abs"])
    else:
        npd = np.float16 if dtype == "float16" else np.float32
        ulp = np.spacing(np.abs(jl).astype(npd)).astype(np.float64)
        if dtype == "bfloat16":
            ulp = np.abs(jl) * 2.0 ** -7
        assert (np.abs(tl - jl) <= TOL[dtype]["loss_ulps"] * ulp).all(), \
            (jl, tl)
    assert tr.lrs == pytest.approx(jr.lrs, rel=1e-6)


def check_params(jm, tm, dtype, lr_sum):
    """The port's parameters (and masters) against JAX's after fit."""
    tnet = tm.network
    got = jax_layout(tnet)
    want = {k: np.asarray(v).astype(np.float32)
            for k, v in jm.network.functional_state()[0].items()}
    assert set(got) == set(want)
    assert tm._optimizer._step_count == jm._optimizer._step_count
    if dtype == "float32":
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=TOL[dtype]["param"], err_msg=k)
        return
    tol = TOL[dtype]
    eps = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -11
    outliers = total = 0
    for k, p in tnet.named_parameters():
        tmaster = tm._optimizer._slots[k]["master"].numpy()
        jmaster = np.asarray(jm._optimizer._slots[k]["master"])
        diff = np.abs(tmaster - jmaster)
        assert diff.max() <= 2 * lr_sum, k
        outliers += int((diff > tol["master"]).sum())
        total += diff.size
        # each parameter is its master rounded to the 16-bit dtype
        assert (np.abs(got[k] - tmaster) <= eps * np.abs(tmaster)
                + 2.0 ** -24).all(), k
        assert str(p.dtype) == f"torch.{dtype}"
    assert outliers <= tol["outliers"] * total, (outliers, total)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["bert", "gpt", "mlp"])
def test_fit_matches_jax(kind, dtype):
    """Two epochs of ``Model.fit`` (shuffled, 12 steps): every batch's
    loss, the learning rates, the step count, History's epoch losses and
    the final parameters and masters."""
    jm, tm, jdata, tdata = models(kind, AMP[dtype])
    jh, th = jcb.History(), tcb.History()
    jr, tr = fit_both(jm, tm, jdata, tdata, jcallbacks=[jh],
                      tcallbacks=[th])
    check_losses(jr, tr, dtype)
    assert th.history["loss"] == [tr.losses[5], tr.losses[11]]
    if kind == "mlp":
        np.testing.assert_allclose(th.history["acc"], jh.history["acc"],
                                   atol=1e-6)
    check_params(jm, tm, dtype, lr_sum=sum(tr.lrs) + 1e-4)


@pytest.mark.parametrize("kind", ["bert", "mlp"])
def test_evaluate_and_predict_match_jax(kind):
    """After one epoch: ``evaluate`` (loss and metric) and ``predict``
    (one array per batch) against JAX's on held-out data. The BERT
    wrapper takes its labels as an input, so ``evaluate`` splits no
    labels off and its loss is 0 in both packages; ``predict`` returns
    each batch's MLM loss."""
    jm, tm, jdata, tdata = models(kind)
    fit_both(jm, tm, jdata, tdata, epochs=1)
    if kind == "mlp":
        x, y = _mlp_data(seed=9, n=10)
        jeval, teval = JTensorDataset([x, y]), TTensorDataset([x, y])
    else:
        kw = dict(vocab_size=VOCAB, seq_len=SEQ, n=10, seed=9)
        jeval, teval = JLMDataset(**kw), TLMDataset(**kw)
    jlogs = jm.evaluate(jeval, batch_size=4, verbose=0)
    tlogs = tm.evaluate(teval, batch_size=4, verbose=0)
    assert set(tlogs) == set(jlogs)
    for k in jlogs:
        assert tlogs[k] == pytest.approx(jlogs[k], abs=1e-5), k
    jout = jm.predict(jeval, batch_size=4)
    tout = tm.predict(teval, batch_size=4)
    assert len(tout) == len(jout) == 1 and len(tout[0]) == 3
    for t, j in zip(tout[0], jout[0]):
        assert isinstance(t, np.ndarray) and t.shape == np.shape(j)
        np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=1e-5)
    stacked = tm.predict(teval, batch_size=4, stack_outputs=kind == "mlp")
    if kind == "mlp":
        assert stacked[0].shape == (10, 4)


@pytest.mark.parametrize("kind", ["bert", "gpt", "mlp"])
def test_summary_counts_match_jax(kind, capsys):
    jm, tm, _, _ = models(kind)
    assert tm.summary() == jm.summary()
    if kind == "mlp":
        size = (2, 8)
        assert tm.summary(input_size=size) == jm.summary(input_size=size)
        table = capsys.readouterr().out
        assert "Linear-0" in table and "[2, 16]" in table


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_save_load_resume_equals_the_uninterrupted_run(dtype, tmp_path):
    """One epoch, ``Model.save``, a fresh Model (other initial weights)
    ``load``-ed from it, a second epoch: bitwise the run that never
    stopped, and within ``TOL`` of JAX's two epochs."""
    amp = AMP[dtype]
    jm, tm, jdata, tdata = models("bert", amp)
    jr, tr = fit_both(jm, tm, jdata, tdata)       # 2 epochs, unbroken
    _, first, _, data = models("bert", amp)
    np.random.seed(5)
    first.fit(data, batch_size=BATCH, epochs=1, verbose=0)
    epoch2_order = np.random.get_state()
    path = str(tmp_path / "ckpt" / "m")
    first.save(path)
    _, second, _, _ = models("bert", amp, seed=1)
    second.load(path)
    assert second._optimizer._step_count == 6
    resumed = recorder(tcb.Callback)
    np.random.set_state(epoch2_order)
    second.fit(data, batch_size=BATCH, epochs=1, verbose=0,
               callbacks=[resumed])
    assert resumed.losses == tr.losses[6:]
    for (k, a), b in zip(second.network.named_parameters(),
                         tm.network.parameters()):
        assert torch.equal(a, b), k
    for k, sl in tm._optimizer._slots.items():
        for s, v in sl.items():
            assert torch.equal(second._optimizer._slots[k][s], v), (k, s)
    check_params(jm, second, dtype, lr_sum=sum(tr.lrs) + 1e-4)


def test_load_jax_checkpoint_of_a_jax_model_save(tmp_path):
    """JAX trains one epoch and saves; the port loads the pair through
    ``bridge.load_jax_checkpoint`` (parameters, every slot, the step
    count and the scheduler), then both train a second epoch and end
    within ``TOL``."""
    jm, tm, jdata, tdata = models("bert")
    np.random.seed(5)
    jm.fit(jdata, batch_size=BATCH, epochs=1, verbose=0)
    order = np.random.get_state()
    path = str(tmp_path / "jax" / "m")
    jm.save(path)
    load_jax_checkpoint(tm, path)
    got = jax_layout(tm.network)
    for k, v in jm.network.functional_state()[0].items():
        assert np.array_equal(got[k], np.asarray(v)), k
    for k, sl in jm._optimizer._slots.items():
        for s, v in sl.items():
            t = tm._optimizer._slots[k][s].numpy()
            assert np.array_equal(t, np.asarray(v))
    assert tm._optimizer._step_count == jm._optimizer._step_count == 6
    assert tm._optimizer.get_lr() == pytest.approx(jm._optimizer.get_lr())
    jr, tr = recorder(jcb.Callback), recorder(tcb.Callback)
    np.random.set_state(order)
    jm.fit(jdata, batch_size=BATCH, epochs=1, verbose=0, callbacks=[jr])
    np.random.set_state(order)
    tm.fit(tdata, batch_size=BATCH, epochs=1, verbose=0, callbacks=[tr])
    check_losses(jr, tr, "float32")
    check_params(jm, tm, "float32", lr_sum=1.0)


# -- the engine's semantics, each against JAX's --------------------------------

class JSpare(jnn.Layer):
    """The MLP with a Linear its forward never calls."""

    def __init__(self):
        super().__init__()
        self.body = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                                   jnn.Linear(16, 4))
        self.spare = jnn.Linear(4, 4)

    def forward(self, x):
        return self.body(x)


class TSpare(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.body = torch.nn.Sequential(Linear(8, 16), torch.nn.ReLU(),
                                        Linear(16, 4))
        self.spare = Linear(4, 4)

    def forward(self, x):
        return self.body(x)


def spare_models(opt, amp=None, freeze=False):
    paddle.seed(0)
    jnet, tnet = JSpare(), TSpare()
    load_jax_params(tnet, {k: np.asarray(v)
                           for k, v in jnet.functional_state()[0].items()})
    if freeze:
        jnet.body[0].bias.stop_gradient = True
        tnet.body[0].bias.requires_grad_(False)
    jm, tm = paddle.Model(jnet), pt.Model(tnet)
    jm.prepare(opt(jopt, jnet.parameters()), loss=jnn.CrossEntropyLoss(),
               amp_configs=amp)
    tm.prepare(opt(topt, tm.parameters()), loss=CrossEntropyLoss(),
               amp_configs=amp)
    x, y = _mlp_data()
    return jm, tm, JTensorDataset([x, y]), TTensorDataset([x, y])


def decaying_adamw(pkg, params):
    return pkg.AdamW(learning_rate=0.1, weight_decay=0.1, parameters=params)


def test_unused_and_frozen_parameters_match_jax():
    """Trap: a parameter the loss does not reach gets a zero gradient
    (``jax.value_and_grad``'s zeros), so AdamW decays it and gives it
    slots; a frozen one (``requires_grad=False`` / ``stop_gradient``)
    stays as it was, with no slots."""
    jm, tm, jdata, tdata = spare_models(decaying_adamw, freeze=True)
    spare0 = tm.network.spare.weight.detach().clone()
    frozen0 = tm.network.body[0].bias.detach().clone()
    fit_both(jm, tm, jdata, tdata)
    check_params(jm, tm, "float32", lr_sum=1.0)
    spare = tm.network.spare.weight.detach()
    # decoupled decay: 12 steps of p * (1 - lr * wd)
    torch.testing.assert_close(spare, spare0 * 0.99 ** 12, rtol=1e-5,
                               atol=0)
    assert float(tm._optimizer._slots["spare.weight"]["moment1"]
                 .abs().max()) == 0.0
    assert torch.equal(tm.network.body[0].bias.detach(), frozen0)
    assert "body.0.bias" not in tm._optimizer._slots
    assert "body.0.bias" not in jm._optimizer._slots


def _state(m, jax):
    """(parameters, slots) as f32 numpy in JAX's layout."""
    if jax:
        params = {k: np.asarray(v).astype(np.float32)
                  for k, v in m.network.functional_state()[0].items()}
        slots = {(k, s): np.asarray(v).astype(np.float32)
                 for k, sl in m._optimizer._slots.items()
                 for s, v in sl.items()}
        return params, slots
    def lay(t):
        return t.detach().float().numpy()
    return ({k: lay(p) for k, p in m.network.named_parameters()},
            {(k, s): lay(v) for k, sl in m._optimizer._slots.items()
             for s, v in sl.items()})


def test_forced_overflow_step_matches_jax():
    """Trap: f16 O2 with the loss scale at 2^40 (inf in f16): the step
    finds an inf, keeps every parameter and slot as it was, and still
    advances ``_step_count``, as JAX's compiled step does (the eager
    ``GradScaler.step`` would not advance it). With ``decr_ratio`` 2^-30
    and one bad step to shrink, the scale drops to 2^10 and the next step
    updates; both packages agree after each step."""
    amp = {"level": "O2", "dtype": "float16", "init_loss_scaling": 2.0 ** 40,
           "decr_ratio": 2.0 ** -30, "decr_every_n_nan_or_inf": 1}
    jm, tm, _, _ = spare_models(decaying_adamw, amp)
    x, y = _mlp_data()
    batch = ([x[:8]], [y[:8]])
    p0, _ = _state(tm, jax=False)           # the initial weights
    for step, overflow in ((1, True), (2, False), (3, False)):
        if overflow:
            _, before_s = _state(tm, jax=False)
        jl = jm.train_batch(*batch)
        tl = tm.train_batch(*batch)
        assert tm._optimizer._step_count == jm._optimizer._step_count == step
        jsc = jm._amp_configs["scaler"].get_loss_scaling()
        tsc = tm._amp_configs["scaler"].get_loss_scaling()
        assert tsc == jsc == 2.0 ** 10
        (tp, ts), (jp, js) = _state(tm, jax=False), _state(jm, jax=True)
        assert np.isfinite(tl[0]) and abs(tl[0] - jl[0]) <= 2e-3
        if overflow:
            for k, v in tp.items():
                assert np.array_equal(v, p0[k]), k
            for k, v in ts.items():
                if k in before_s:
                    assert np.array_equal(v, before_s[k]), k
                else:   # created this step: zeros, or the master itself
                    want = p0[k[0]] if k[1] == "master" else 0 * v
                    assert np.array_equal(v, want), k
        else:
            assert not all(np.array_equal(v, p0[k]) for k, v in tp.items())
        assert set(ts) == set(js)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=2e-3,
                                       err_msg=str(k))
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, atol=1e-4,
                                       err_msg=str(k))


def sgd(pkg, params):
    return pkg.SGD(learning_rate=0.1, parameters=params)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_accumulate_grad_batches_matches_jax(dtype):
    """Trap: with ``accumulate_grad_batches=2`` the scaled gradients of
    two micro-batches are summed, unscaled once and halved at the update,
    and the step count advances on updates only (6 of 12 batches). SGD,
    so that the gradient's scale shows in the step."""
    jm, tm, jdata, tdata = spare_models(sgd, AMP[dtype])
    jr, tr = fit_both(jm, tm, jdata, tdata, accumulate_grad_batches=2)
    assert tm._optimizer._step_count == jm._optimizer._step_count == 6
    check_losses(jr, tr, dtype)
    tp, ts = _state(tm, jax=False)
    jp, js = _state(jm, jax=True)
    tol = 1e-6 if dtype == "float32" else 2e-3
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=tol,
                                   err_msg=k)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=0, atol=tol / 4,
                                   err_msg=str(k))


def warmup_sgd(pkg, params):
    sched = pkg.lr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0,
                                end_lr=0.1)
    return pkg.SGD(learning_rate=sched, parameters=params)


def step_decay_sgd(pkg, params):
    return pkg.SGD(learning_rate=pkg.lr.StepDecay(0.1, step_size=1,
                                                  gamma=0.5),
                   parameters=params)


@pytest.mark.parametrize("opt", [warmup_sgd, step_decay_sgd],
                         ids=["per_batch", "per_epoch"])
def test_scheduler_cadence_matches_jax(opt):
    """Trap: ``fit`` steps LinearWarmup (and NoamDecay, OneCycleLR,
    CyclicLR) after every batch and any other scheduler after every
    epoch; the learning rate of a step is read before its scheduler
    steps."""
    jm, tm, jdata, tdata = spare_models(opt)
    jr, tr = fit_both(jm, tm, jdata, tdata, epochs=3)
    assert tr.lrs == pytest.approx(jr.lrs, rel=1e-7)
    if opt is step_decay_sgd:
        assert tr.lrs[:6] == [0.1] * 6 and tr.lrs[6] == 0.05
    else:
        assert tr.lrs[:4] == pytest.approx([0.025, 0.05, 0.075, 0.1])
    check_losses(jr, tr, "float32")
    check_params(jm, tm, "float32", lr_sum=1.0)


def test_early_stopping_stops_at_the_jax_epoch():
    def slow_sgd(pkg, params):
        return pkg.SGD(learning_rate=0.02, parameters=params)

    jm, tm, jdata, tdata = spare_models(slow_sgd)
    jh, th = jcb.History(), tcb.History()
    kw = dict(monitor="loss", patience=1, min_delta=0.043, verbose=0)
    fit_both(jm, tm, jdata, tdata, epochs=10, shuffle=False,
             jcallbacks=[jh, jcb.EarlyStopping(**kw)],
             tcallbacks=[th, tcb.EarlyStopping(**kw)])
    assert tm.stop_training and jm.stop_training
    assert len(th.history["loss"]) == len(jh.history["loss"]) < 10
    np.testing.assert_allclose(th.history["loss"], jh.history["loss"],
                               atol=1e-5)


class LazyKeeper:
    """Mixin of a callback that keeps ``logs["loss"]`` without reading
    it, and notes after each batch which kept losses are already read."""

    def __init__(self):
        super().__init__()
        self.kept, self.read_at = [], []

    def on_train_batch_end(self, step, logs=None):
        self.kept.append(logs["loss"])
        self.read_at.append([getattr(v, "_val", 0) is not None
                             for v in self.kept])


def test_async_loss_window_matches_the_synced_loop_and_jax():
    """No metrics, no accumulation: ``logs["loss"]`` is a lazy loss; after
    batch i the window holds the FLAGS_executor_max_inflight (2) newest
    losses unread, and all up to i at a ``log_freq`` (4) boundary; read
    later, every loss equals the synced loop's (the window off) bitwise,
    and JAX's lazy losses within ``TOL``. Each loss is read on the host
    once."""
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu_torch.core import monitor as tmonitor

    def run(inflight):
        jm, tm, jdata, tdata = models("bert")
        jk = type("J", (LazyKeeper, jcb.Callback), {})()
        tk = type("T", (LazyKeeper, tcb.Callback), {})()
        tflags.set_flags({"FLAGS_executor_max_inflight": inflight})
        tmonitor.reset(prefix="hapi/")
        try:
            np.random.seed(5)
            jm.fit(jdata, batch_size=BATCH, epochs=1, verbose=0,
                   log_freq=4, callbacks=[jk])
            np.random.seed(5)
            tm.fit(tdata, batch_size=BATCH, epochs=1, verbose=0,
                   log_freq=4, callbacks=[tk])
        finally:
            tflags.set_flags({"FLAGS_executor_max_inflight": 2})
        return jk, tk, tmonitor.stat_get("hapi/loss_reads")

    jk, tk, reads = run(2)
    for i, flags_read in enumerate(tk.read_at):
        boundary = (i + 1) // 4 * 4 - 1      # the last log_freq boundary
        want = [j <= max(i - 2, boundary) for j in range(i + 1)]
        assert flags_read == want, i
    assert reads == 6
    lazy = [float(v) for v in tk.kept]
    _, synced, sync_reads = run(0)
    assert all(isinstance(v, float) for v in synced.kept)
    assert lazy == synced.kept and sync_reads == 6
    np.testing.assert_allclose(lazy, [float(v) for v in jk.kept], rtol=0,
                               atol=TOL["float32"]["loss_abs"])


def test_fit_with_worker_processes_equals_the_serial_run():
    x, y = _mlp_data()
    losses = []
    for workers in (0, 2):
        _, tm, _, tdata = spare_models(sgd)
        r = recorder(tcb.Callback)
        np.random.seed(5)
        tm.fit(tdata, batch_size=BATCH, epochs=1, verbose=0,
               num_workers=workers, callbacks=[r])
        losses.append(r.losses)
    assert losses[0] == losses[1]


def test_grad_scaler_apply_pure_matches_jax():
    """``apply_pure`` on the same scaled grads and state as JAX's: the
    unscaled grads, found_inf and the new state, over a clean step and an
    inf step; the state's tensors stay 0-d f32 / int32."""
    import jax.numpy as jnp
    from paddle_tpu import amp as jamp
    from paddle_tpu_torch import amp as tamp
    rng = np.random.RandomState(1)
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=1,
              decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jst, tst = js.scale_state(), ts.scale_state()
    for poison in (False, True):
        g = {"a": rng.randn(3, 2).astype(np.float16),
             "b": rng.randn(4).astype(np.float32)}
        if poison:
            g["a"][0, 0] = np.inf
        jg, jf, jst = js.apply_pure({k: jnp.asarray(v) for k, v in g.items()},
                                    jst)
        tg, tf, tst = ts.apply_pure({k: torch.from_numpy(v)
                                     for k, v in g.items()}, tst)
        assert bool(tf) == bool(jf) == poison
        for k in g:
            assert np.array_equal(tg[k].numpy(), np.asarray(jg[k]))
        assert float(tst["scale"]) == float(jst["scale"])
        assert int(tst["good"]) == int(jst["good"])
        assert int(tst["bad"]) == int(jst["bad"])
        assert tst["scale"].dtype == torch.float32
        assert tst["good"].dtype == torch.int32
    ts.load_scale_state(tst)
    assert ts.get_loss_scaling() == 1024.0   # x2, then x0.5


def test_unported_branches_raise():
    """What needs a module the port does not have raises
    NotImplementedError naming its ROADMAP item; nothing passes
    silently."""
    from paddle_tpu_torch.core import flags as tflags
    _, tm, _, tdata = spare_models(sgd)
    # auto_checkpoint_dir and FLAGS_check_nan_inf are ported
    # (tests/test_torch_checkpoint.py, test_torch_numeric_check.py): a
    # finite fit passes the sweep
    tflags.set_flags({"FLAGS_check_nan_inf": True})
    try:
        tm.fit(tdata, batch_size=BATCH, verbose=0)
    finally:
        tflags.set_flags({"FLAGS_check_nan_inf": False})
    # a fleet strategy and ZeRO are ported (tests/test_torch_fleet.py): in
    # a world of one they prepare and fit as the plain step; Model.fit
    # under a tp or pp mesh (the JAX engine's GSPMD presets) raises naming
    # item 7c
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.distributed import mesh as tmesh
    net = TSpare()
    opt = topt.SGD(learning_rate=0.1, parameters=net.parameters())
    opt._dist_strategy = tfleet.DistributedStrategy()
    net._zero_dp = True
    model = pt.Model(net)
    model.prepare(opt, loss=CrossEntropyLoss())
    model.fit(tdata, batch_size=BATCH, verbose=0)
    tmesh.set_mesh(tmesh.Mesh({"dp": 1, "tp": 2}), "tp_only")
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 7c"):
            model.fit(tdata, batch_size=BATCH, verbose=0)
    finally:
        tmesh.reset_mesh("tp_only")
