"""Port parity: the training slice. BERT (paddle_tpu_torch/text/models/
bert.py) and GPT's ``labels`` loss against the JAX models with the same
weights (``bridge.load_jax_params``), ``LMDataset``, and three whole
AdamW training steps against a JAX step built by ``bench.py:_build``.

Tiny configs, f32, dropout off. The JAX fused head runs its Pallas
kernels in interpret mode. Tolerances: outputs 1e-4 absolute (XLA's and
torch's CPU matmuls sum in different orders; measured ~1e-7 here);
gradients 1e-5 absolute; per-step losses 1e-5 relative and parameters
after three steps 1e-5 absolute (the AdamW updates are lr-sized, 1e-3).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import tape as _tape
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.text.datasets import LMDataset as JLMDataset
from paddle_tpu.text.models.bert import Bert as JBert
from paddle_tpu.text.models.bert import BertConfig as JBertConfig
from paddle_tpu.text.models.bert import \
    BertPretrainingCriterion as JCriterion
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.datasets import LMDataset
from paddle_tpu_torch.text.models import (GPT, Bert, BertConfig,
                                          BertPretrainingCriterion,
                                          GPTConfig)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are tiny: one intra-op thread is enough, and it leaves
    the other cores to the timing-sensitive tests that run beside this
    file in a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4
GRAD_TOL = 1e-5


@pytest.fixture
def interpret():
    paddle.set_flags({"FLAGS_pallas_interpret": True})
    yield
    paddle.set_flags({"FLAGS_pallas_interpret": False})


def jax_params(jnet):
    return {k: np.asarray(v) for k, v in jnet.functional_state()[0].items()}


def _pair(with_nsp=False):
    paddle.seed(0)
    jnet = JBert(JBertConfig.tiny(), with_nsp=with_nsp)
    jnet.eval()
    tnet = Bert(BertConfig.tiny(), with_nsp=with_nsp, device="cpu")
    tnet.eval()
    load_jax_params(tnet, jax_params(jnet))
    return jnet, tnet


@pytest.fixture(scope="module")
def bert():
    return _pair()


def _batch(seed, b=2, s=9, vocab=1024):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s))
    labels = np.where(rng.rand(b, s) < 0.3, ids, -100)
    labels[0, 0] = ids[0, 0]                    # at least one valid row
    tt = rng.randint(0, 2, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, s - 3:] = 0                         # a padded tail
    return ids, labels, tt, mask


def _j(x):
    return Tensor(jnp.asarray(x), _internal=True)


def test_bridge_takes_every_bert_name(bert):
    jnet, tnet = bert
    p = jax_params(jnet)
    own = dict(tnet.named_parameters())
    assert len(p) == 36 and set(p) == set(own)
    sd = tnet.state_dict()
    np.testing.assert_array_equal(sd["mlm_bias"].numpy(), p["mlm_bias"])
    np.testing.assert_array_equal(
        sd["embeddings.word_embeddings.weight"].numpy(),
        p["embeddings.word_embeddings.weight"])
    for name in ("encoder.layers.1.self_attn.qkv_proj.weight",
                 "pooler.dense.weight", "mlm_transform.weight"):
        np.testing.assert_array_equal(sd[name].numpy(), p[name])


def test_encoder_norms_keep_default_epsilon(bert):
    """norm1/norm2 of every encoder layer use 1e-5; only the embedding
    norm and mlm_norm take the config's 1e-12."""
    _, tnet = bert
    for layer in tnet.encoder.layers:
        assert layer.norm1._epsilon == 1e-5 and layer.norm2._epsilon == 1e-5
    assert tnet.embeddings.layer_norm._epsilon == 1e-12
    assert tnet.mlm_norm._epsilon == 1e-12


def test_logits_with_mask_and_token_types_match(bert):
    jnet, tnet = bert
    ids, _, tt, mask = _batch(0)
    jfwd = jax.jit(lambda a, b, c: jnet(_j(a), token_type_ids=_j(b),
                                        attention_mask=_j(c))._value)
    jl = np.asarray(jfwd(ids, tt, mask))
    with torch.no_grad():
        tl = tnet(torch.from_numpy(ids), token_type_ids=torch.from_numpy(tt),
                  attention_mask=torch.from_numpy(mask)).numpy()
    assert tl.shape == (2, 9, 1024)
    np.testing.assert_allclose(tl, jl, atol=ATOL)


def test_nsp_outputs_and_criterion_match():
    jnet, tnet = _pair(with_nsp=True)
    ids, labels, tt, mask = _batch(1)
    jm, jn = jax.jit(lambda a, b, c: tuple(
        o._value for o in jnet(_j(a), token_type_ids=_j(b),
                               attention_mask=_j(c))))(ids, tt, mask)
    jm = Tensor(jm, _internal=True)
    jn = Tensor(jn, _internal=True)
    tm, tn = tnet(torch.from_numpy(ids), token_type_ids=torch.from_numpy(tt),
                  attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tm.detach().numpy(), np.asarray(jm._value),
                               atol=ATOL)
    np.testing.assert_allclose(tn.detach().numpy(), np.asarray(jn._value),
                               atol=ATOL)
    jc = JCriterion(1024)(jm, _j(labels))
    tc = BertPretrainingCriterion(1024)(tm, torch.from_numpy(labels))
    np.testing.assert_allclose(float(tc.detach()), float(jc._value),
                               atol=ATOL)
    with pytest.raises(ValueError, match="with_nsp"):
        tnet(torch.from_numpy(ids), masked_lm_labels=torch.from_numpy(labels))


def test_fused_loss_and_every_grad_match(interpret, bert):
    jnet, tnet = bert
    ids, labels, tt, mask = _batch(2)
    params, buffers = jnet.functional_state()

    def loss_of(p):
        jnet.load_functional_state(p, buffers)
        return jnet(_j(ids), token_type_ids=_j(tt), attention_mask=_j(mask),
                    masked_lm_labels=_j(labels))._value

    try:
        with _tape.no_grad():
            jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    finally:
        jnet.load_functional_state(params, buffers)
    tnet.zero_grad()
    tloss = tnet(torch.from_numpy(ids), token_type_ids=torch.from_numpy(tt),
                 attention_mask=torch.from_numpy(mask),
                 masked_lm_labels=torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=ATOL)
    checked = 0
    for name, p in tnet.named_parameters():
        g = np.asarray(jgrads[name])
        ours = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(ours, g, atol=GRAD_TOL, err_msg=name)
        checked += 1
    assert checked == 36


def test_gpt_labels_loss_and_wte_grad_match(interpret):
    """GPT.forward(ids, labels) returns the fused LM loss (no bias), as the
    JAX model does."""
    paddle.seed(0)
    jnet = JGPT(JGPTConfig.tiny())
    jnet.eval()
    tnet = GPT(GPTConfig.tiny(), device="cpu")
    tnet.eval()
    load_jax_params(tnet, jax_params(jnet))
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 1024, (2, 12))
    labels = np.where(rng.rand(2, 12) < 0.2, -100, rng.randint(0, 1024,
                                                                (2, 12)))
    params, buffers = jnet.functional_state()

    def loss_of(p):
        jnet.load_functional_state(p, buffers)
        return jnet(_j(ids), labels=_j(labels))._value

    try:
        with _tape.no_grad():
            jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(params)
    finally:
        jnet.load_functional_state(params, buffers)
    tloss = tnet(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tloss.backward()
    assert tloss.shape == ()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=ATOL)
    np.testing.assert_allclose(tnet.wte.weight.grad.numpy(),
                               np.asarray(jgrads["wte.weight"]),
                               atol=GRAD_TOL)


def test_lm_dataset_is_byte_identical():
    for mode in ("mlm", "causal"):
        j = JLMDataset(vocab_size=1024, seq_len=16, n=8, mode=mode, seed=3)
        t = LMDataset(vocab_size=1024, seq_len=16, n=8, mode=mode, seed=3)
        np.testing.assert_array_equal(t.inputs, j.inputs)
        np.testing.assert_array_equal(t.labels, j.labels)
        assert len(t) == len(j) == 8
        np.testing.assert_array_equal(t[5][1], j[5][1])


def _bench_module():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_three_training_steps_track_bench_build(interpret, monkeypatch):
    """The port's eager step (fused loss, backward, AdamW.step) against
    the jitted step of ``bench.py:_build`` (f32, fused head), from the
    same weights on the same LMDataset batches."""
    bench = _bench_module()
    monkeypatch.setattr(bench, "DTYPE", "float32")
    cfg = JBertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    step, jp, js, n_params = bench._build(cfg, use_fused_head=True)
    start = {k: np.asarray(v) for k, v in jp.items()}
    tcfg = BertConfig.tiny()
    tcfg.hidden_dropout_prob = tcfg.attention_probs_dropout_prob = 0.0
    tnet = Bert(tcfg, device="cpu")
    load_jax_params(tnet, start)
    tnet.train()
    assert tnet.num_params() == n_params
    opt = AdamW(learning_rate=1e-3, parameters=tnet.named_parameters())
    ds = LMDataset(vocab_size=1024, seq_len=16, n=6, mode="mlm", seed=0)
    ids = ds.inputs.reshape(3, 2, 16)
    lab = ds.labels.reshape(3, 2, 16)
    for i in range(3):
        jl, jp, js = step(jp, js, jnp.asarray(ids[i], jnp.int32),
                          jnp.asarray(lab[i], jnp.int32),
                          jnp.float32(1e-3), jnp.int32(i + 1),
                          jax.random.PRNGKey(i))
        tl = tnet(torch.from_numpy(ids[i]),
                  masked_lm_labels=torch.from_numpy(lab[i]))
        tl.backward()
        for p in tnet.parameters():     # jax.grad's zeros for unused ones
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    moved = 0
    for name, p in tnet.named_parameters():
        want = np.asarray(jp[name])
        np.testing.assert_allclose(p.detach().numpy(), want, atol=1e-5,
                                   err_msg=name)
        moved += not np.array_equal(np.asarray(jp[name]), start[name])
    # every parameter but the pooler's zero bias (no gradient, nothing to
    # decay) moved; the unused pooler weight moved by AdamW's decay alone
    assert moved == 35
    assert not np.array_equal(np.asarray(jp["pooler.dense.weight"]),
                              start["pooler.dense.weight"])
