"""Port parity: GPT (paddle_tpu_torch/text/models/gpt.py) against the JAX
GPT with the same weights, copied across by
``paddle_tpu_torch.bridge.load_jax_params``; plus the port's ground rules
(no jax or paddle_tpu import, CUDA unless the CPU is asked for).

Tiny config, f32, eval mode (dropout off). Logits tolerance 1e-4 abs:
both run the same f32 math, with XLA's and torch's CPU matmuls summing
in different orders (measured ~1e-6 at this size). Greedy tokens must be
identical.
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import kv_pool as jpool
from paddle_tpu.text.models.gpt import GPT as JGPT
from paddle_tpu.text.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.nn import kv_pool as tpool
from paddle_tpu_torch.text.models.gpt import GPT, GPTConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4


def jax_params(jnet):
    return {k: np.asarray(v) for k, v in jnet.functional_state()[0].items()}


@pytest.fixture(scope="module")
def nets():
    paddle.seed(0)
    jnet = JGPT(JGPTConfig.tiny())
    jnet.eval()
    tnet = GPT(GPTConfig.tiny(), device="cpu")
    tnet.eval()
    load_jax_params(tnet, jax_params(jnet))
    return jnet, tnet


def test_forward_logits_match(nets):
    jnet, tnet = nets
    ids = np.random.RandomState(0).randint(0, 1024, (2, 11))
    jfwd = jax.jit(lambda x: jnet(Tensor(x, _internal=True))._value)
    jl = np.asarray(jfwd(jnp.asarray(ids)))
    with torch.no_grad():
        tl = tnet(torch.from_numpy(ids)).numpy()
    assert tl.shape == (2, 11, 1024)
    np.testing.assert_allclose(tl, jl, atol=ATOL)


def test_forward_cached_matches(nets):
    """Prefill then two one-token steps over StaticKVCaches."""
    jnet, tnet = nets
    rng = np.random.RandomState(1)
    b, L = 2, 32
    ids = rng.randint(0, 1024, (b, 6))
    jc = [blk.attn.gen_static_cache(b, L, jnp.float32)
          for blk in jnet.blocks]
    tc = [blk.attn.gen_static_cache(b, L) for blk in tnet.blocks]
    # jit: one compiled JAX pass per chunk shape instead of op-by-op
    jfwd = jax.jit(jnet._forward_cached)
    index = 0
    with torch.no_grad():
        for chunk in (ids, rng.randint(0, 1024, (b, 1)),
                      rng.randint(0, 1024, (b, 1))):
            jl, jc = jfwd(jnp.asarray(chunk), jc, jnp.int32(index))
            tl, tc = tnet._forward_cached(torch.from_numpy(chunk), tc,
                                          index)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=ATOL)
            index += chunk.shape[1]
    assert tc[0].index == index
    np.testing.assert_allclose(tc[0].k[:, :, :index].numpy(),
                               np.asarray(jc[0].k)[:, :, :index], atol=ATOL)


def test_forward_paged_matches(nets):
    """A bucket-padded prefill (logits at the real last token) and a
    ragged one-token decode step over the paged arenas."""
    jnet, tnet = nets
    rng = np.random.RandomState(2)
    cfg = tnet.config
    bs, MB, NB, b = 8, 4, 12, 2
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    bt = np.asarray([[3, 7, 0, 0], [5, 1, 9, 0]], np.int32)
    lens = np.zeros((b,), np.int32)
    ids = rng.randint(0, 1024, (b, 16))
    real = np.asarray([11, 16], np.int32)
    ja = [(jnp.zeros((NB + 1, h, bs, d)), jnp.zeros((NB + 1, h, bs, d)))
          for _ in range(cfg.num_layers)]
    ta = [(torch.zeros(NB + 1, h, bs, d), torch.zeros(NB + 1, h, bs, d))
          for _ in range(cfg.num_layers)]
    jcs = [jpool.PagedKVCache(k, v, jnp.asarray(bt), jnp.asarray(lens))
           for k, v in ja]
    tcs = [tpool.PagedKVCache(k, v, torch.from_numpy(bt),
                              torch.from_numpy(lens)) for k, v in ta]
    jfwd = jax.jit(jnet._forward_paged)
    with torch.no_grad():
        jl, jcs = jfwd(jnp.asarray(ids), jcs, jnp.asarray(real - 1))
        tl, _ = tnet._forward_paged(torch.from_numpy(ids), tcs,
                                    last_index=torch.from_numpy(real - 1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        step = rng.randint(0, 1024, (b, 1))
        jcs = [c._replace(lengths=jnp.asarray(real)) for c in jcs]
        tcs = [tpool.PagedKVCache(k, v, torch.from_numpy(bt),
                                  torch.from_numpy(real)) for k, v in ta]
        jl, _ = jfwd(jnp.asarray(step), jcs, None)
        tl, _ = tnet._forward_paged(torch.from_numpy(step), tcs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_generate_token_identical(nets, use_cache):
    jnet, tnet = nets
    ids = np.random.RandomState(3).randint(0, 1024, (3, 5)).astype(np.int64)
    jg = np.asarray(jnet.generate(paddle.to_tensor(ids), max_new_tokens=10,
                                  temperature=0, use_cache=True).numpy())
    tg = tnet.generate(ids, max_new_tokens=10, temperature=0,
                       use_cache=use_cache).numpy()
    np.testing.assert_array_equal(tg, jg)


def test_generate_eos_freeze_matches(nets):
    """Per-row EOS: a finished row stays frozen at eos, as in JAX."""
    jnet, tnet = nets
    ids = np.random.RandomState(8).randint(1, 1024, (3, 5)).astype(np.int64)
    first = tnet.generate(ids[:1], max_new_tokens=3, temperature=0).numpy()
    eos = int(first[0, 6])
    jg = np.asarray(jnet.generate(paddle.to_tensor(ids), max_new_tokens=10,
                                  temperature=0, eos_token_id=eos).numpy())
    tg = tnet.generate(ids, max_new_tokens=10, temperature=0,
                       eos_token_id=eos).numpy()
    np.testing.assert_array_equal(tg, jg)
    assert (tg[0, 7:] == eos).all()


def test_sampled_generate_is_seeded_and_in_vocab(nets):
    _, tnet = nets
    ids = np.random.RandomState(4).randint(0, 1024, (2, 4))
    a = tnet.generate(ids, max_new_tokens=6, temperature=1.0, top_k=5,
                      seed=7)
    b = tnet.generate(ids, max_new_tokens=6, temperature=1.0, top_k=5,
                      seed=7)
    c = tnet.generate(ids, max_new_tokens=6, temperature=1.0, top_k=5,
                      seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 1024


def test_generate_rejects_over_max_seq_len(nets):
    _, tnet = nets
    with pytest.raises(ValueError, match="max_seq_len"):
        tnet.generate(np.zeros((1, 100), np.int64), max_new_tokens=29)


def test_cache_attention_is_eval_only():
    """The decode kernel is eval-only: in train mode the JAX gate rejects
    it as ``training`` and the cache attention runs plain (with dropout on
    the probabilities); generate no longer raises there."""
    from paddle_tpu_torch.core import monitor
    net = GPT(GPTConfig.tiny(), device="cpu")
    net.train()
    key = "cuda.gate_reject.decode_attention.training"
    before = monitor.stats("").get(key, 0)
    out = net.generate(np.zeros((1, 3), np.int64), max_new_tokens=2,
                       temperature=0)
    assert out.shape == (1, 5)
    assert monitor.stats("").get(key, 0) > before


# --------------------------------------------------------------------------
# the weight bridge
# --------------------------------------------------------------------------

def test_bridge_transposes_linear_weights_only(nets):
    jnet, tnet = nets
    p = jax_params(jnet)
    sd = tnet.state_dict()
    np.testing.assert_array_equal(sd["wte.weight"].numpy(), p["wte.weight"])
    # Linear weights keep the JAX layout [in, out]: nothing is transposed
    np.testing.assert_array_equal(sd["blocks.0.attn.qkv_proj.weight"]
                                  .numpy(),
                                  p["blocks.0.attn.qkv_proj.weight"])
    np.testing.assert_array_equal(sd["blocks.1.fc2.weight"].numpy(),
                                  p["blocks.1.fc2.weight"])
    np.testing.assert_array_equal(sd["blocks.1.ln2.weight"].numpy(),
                                  p["blocks.1.ln2.weight"])


def test_bridge_rejects_missing_and_unexpected_names(nets):
    jnet, _ = nets
    net = GPT(GPTConfig.tiny(), device="cpu")
    p = jax_params(jnet)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(net, {k: v for k, v in p.items()
                              if k != "ln_f.bias"})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(net, dict(p, extra=np.zeros(1)))
    bad = dict(p)
    bad["wpe.weight"] = bad["wpe.weight"][:3]
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(net, bad)


def test_seeded_init_is_deterministic_and_bert_style():
    a = GPT(GPTConfig.tiny(), device="cpu", seed=3)
    b = GPT(GPTConfig.tiny(), device="cpu", seed=3)
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    w = a.wte.weight
    assert float(w.detach().abs().max()) <= 0.04 + 1e-6   # 2 std cut
    assert torch.equal(a.ln_f.weight, torch.ones_like(a.ln_f.weight))
    assert torch.equal(a.blocks[0].fc1.bias,
                       torch.zeros_like(a.blocks[0].fc1.bias))


# --------------------------------------------------------------------------
# ground rules
# --------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "paddle_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_device_defaults_to_cuda_and_cpu_on_request():
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import device as tdevice

    def made():
        return (tp.nn.Linear(4, 4).weight, tp.nn.LayerNorm(4).weight,
                tp.to_tensor([1.0]), tp.zeros([2]))

    assert resolve_device("cpu").type == "cpu"
    net = GPT(GPTConfig.tiny(), device="cpu")
    assert net.device.type == "cpu"
    with tdevice.device_scope("cpu"):
        assert {t.device.type for t in made()} == {"cpu"}
        assert GPT(GPTConfig.tiny()).device.type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert {t.device.type for t in made()} == {"cuda"}
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(GPTConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(GPTConfig.tiny(), device="cuda")
    for make in (lambda: tp.nn.Linear(4, 4), lambda: tp.nn.LayerNorm(4),
                 lambda: tp.to_tensor([1.0]), lambda: tp.zeros([2]),
                 lambda: tp.set_device("gpu")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
