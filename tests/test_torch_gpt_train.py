"""Port parity: GPT causal training through the flash-attention route.

The tiny GPT (2 layers, s 64, f32, dropout 0) with ``FLAGS_flash_min_seq=0``
in both packages, so every attention call takes the flash kernels: the JAX
package's Pallas kernels in interpret mode (``FLAGS_flash_attention_
interpret``; the fused CE head under ``FLAGS_pallas_interpret``), the
port's plain versions through the kernels' ``torch.autograd.Function``.
The loss and every parameter's gradient against ``jax.value_and_grad``
of the JAX model, and three whole AdamW steps against a jitted JAX step
built as ``bench.py:bench_longseq`` builds it, from the same weights
(``bridge.load_jax_params``) on the same batches.

Tolerances, as tests/test_torch_bert.py: loss 1e-4 and gradients 1e-5
absolute (both run the same f32 math, XLA's and torch's CPU matmuls sum
in different orders); per-step losses 1e-5 relative and parameters after
three steps 1e-5 absolute (the AdamW updates are lr-sized, 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.core import monitor as jmonitor
from paddle_tpu.core import rng as _rng
from paddle_tpu.core import tape as _tape
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import monitor as tmonitor
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig

ATOL = 1e-4
GRAD_TOL = 1e-5
LR = 1e-3
STEPS = 3
B, S = 2, 64
TINY = dict(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
            intermediate_size=128, max_seq_len=128, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes are tiny: one intra-op thread is enough, and it leaves
    the other cores to the timing-sensitive tests that run beside this
    file in a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flash_everywhere():
    """Both packages send every attention call to the flash kernels."""
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


def _batches():
    """bench_longseq's batches: ids in [4, V), labels the ids rolled by
    -1; one label per batch ignored."""
    rng = np.random.RandomState(0)
    ids = rng.randint(4, TINY["vocab_size"], (STEPS, B, S))
    labels = np.roll(ids, -1, axis=2)
    labels[:, 0, -1] = -100
    return ids, labels


@pytest.fixture(scope="module")
def jax_run(flash_everywhere):
    """The JAX side, one jitted step run three times: start weights,
    per-step losses, the first step's gradients, the weights after."""
    paddle.seed(0)
    jnet = JGPT(JGPTConfig(**TINY))
    jnet.train()
    opt = jopt.AdamW(learning_rate=LR, parameters=jnet.parameters())
    params, buffers = jnet.functional_state()
    opt._ensure_slots(params)
    slots = dict(opt._slots)
    meta = opt._param_meta(dict(jnet.named_parameters()))
    start = {k: np.asarray(v) for k, v in params.items()}

    def train_step(params, slots, ids, labels, lr, t, key):
        with _rng.rng_state(key), _tape.no_grad():
            def loss_of(p):
                jnet.load_functional_state(p, buffers)
                loss = jnet(Tensor(ids, _internal=True),
                            labels=Tensor(labels, _internal=True))
                return loss._value.astype(jnp.float32)

            loss, grads = jax.value_and_grad(loss_of)(params)
            new_params, new_slots = opt.apply_gradients_pure(
                params, grads, slots, lr, t, param_meta=meta)
        return loss, grads, new_params, new_slots

    step = jax.jit(train_step)
    hits = jmonitor.stat_get("pallas.hit.flash_attention")
    ids, labels = _batches()
    losses, first_grads = [], None
    try:
        for i in range(STEPS):
            loss, grads, params, slots = step(
                params, slots, jnp.asarray(ids[i], jnp.int32),
                jnp.asarray(labels[i], jnp.int32), jnp.float32(LR),
                jnp.int32(i + 1), jax.random.PRNGKey(i))
            losses.append(float(loss))
            if first_grads is None:
                first_grads = {k: np.asarray(v) for k, v in grads.items()}
    finally:
        jnet.load_functional_state(params, buffers)
    # the jitted step traced each block's attention through the kernel
    assert jmonitor.stat_get("pallas.hit.flash_attention") - hits \
        >= TINY["num_layers"]
    return {"start": start, "losses": losses, "grads": first_grads,
            "params": {k: np.asarray(v) for k, v in params.items()}}


def _port_net(start):
    tnet = GPT(GPTConfig(**TINY), device="cpu")
    load_jax_params(tnet, start)
    tnet.train()
    return tnet


def test_loss_and_every_grad_match_jax(jax_run):
    tnet = _port_net(jax_run["start"])
    ids, labels = _batches()
    tmonitor.reset(prefix="cuda.")
    loss = tnet(torch.from_numpy(ids[0]), labels=torch.from_numpy(labels[0]))
    loss.backward()
    assert tmonitor.stats("cuda.") == {
        "cuda.hit.flash_attention": TINY["num_layers"]}
    np.testing.assert_allclose(float(loss.detach()), jax_run["losses"][0],
                               atol=ATOL)
    checked = 0
    for name, p in tnet.named_parameters():
        g = jax_run["grads"][name]
        np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_TOL,
                                   err_msg=name)
        checked += 1
    assert checked == len(jax_run["grads"]) == 28


def test_three_adamw_steps_track_jax(jax_run):
    tnet = _port_net(jax_run["start"])
    opt = AdamW(learning_rate=LR, parameters=tnet.named_parameters())
    ids, labels = _batches()
    for i in range(STEPS):
        loss = tnet(torch.from_numpy(ids[i]),
                    labels=torch.from_numpy(labels[i]))
        loss.backward()
        for p in tnet.parameters():     # jax.grad's zeros for unused ones
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(float(loss.detach()),
                                   jax_run["losses"][i], rtol=1e-5)
    for name, p in tnet.named_parameters():
        want = jax_run["params"][name]
        np.testing.assert_allclose(p.detach().numpy(), want, atol=1e-5,
                                   err_msg=name)
        assert not np.array_equal(jax_run["params"][name],
                                  jax_run["start"][name]), name
